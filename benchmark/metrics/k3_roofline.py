"""k3_roofline: K3's share of its roofline in the t-ops round trips, %.

Sum of K3's bounds over its device time (csrc/conv3d.cu's
conv3d_s1_kernel) in the traced round trips. The launches come from the
plain reference VAE on meta tensors (benchmark/reference/vae.py:k3_shapes:
every stride-1 3x3x3 conv with 128+ channels of a round trip under its
t-ops config); their number over the traced round trips must equal the
instances in the trace and the launches `conv3d_stride1` counted. A
launch's bound: 2*outputs*27*C_in operations at 989 TFLOP/s against the
padded input, the weights and the output read or written once (fp16) at
3.35 TB/s. Moves roundtrip_s.
"""
import functools
import json

from benchmark.reference.vae import k3_shapes
from benchmark.yardstick import bound

NAME = "conv3d_s1_kernel"

# the program's wrapper whose LAUNCHES the trace is tied to
COUNTERS = {"conv3d_stride1": "hunyuanvideo_efficiency_tpu_torch.ops."
                              "conv3d_cuda:conv3d_stride1"}


def launch_bound_ms(shape):
    b, t, h, w, cin, cout = shape
    out = b * t * h * w * cout
    nbytes = 2 * (b * (t + 2) * (h + 2) * (w + 2) * cin + 27 * cin * cout
                  + out)
    return bound(2.0 * out * 27 * cin, nbytes)[0]


@functools.lru_cache(maxsize=None)
def trip_bound(vae_json, tops_name, frames, height, width):
    from benchmark.drivers.vae_tops import tops_config

    shapes = k3_shapes(json.loads(vae_json), tops_config(tops_name), frames,
                       height, width)
    return len(shapes), sum(launch_bound_ms(s) for s in shapes)


def read(run):
    span = run.span
    if not span or run.trace is None or "trips" not in run.shapes:
        return None
    t0, t1 = span["t0"], span["t1"]
    n = run.trace.count(lambda k: NAME in k, t0, t1)
    if n == 0:
        return None
    tr = run.traffic
    per = [trip_bound(json.dumps(run.cfg["vae"], sort_keys=True), name,
                      tr["frames"], tr["height"], tr["width"])
           for name in run.shapes["trips"]]
    want = span["launches"]["conv3d_stride1"]
    if not n == want == sum(c for c, _ in per):
        raise RuntimeError(f"k3_roofline: {n} K3 kernels in the trace, "
                           f"{want} launches counted, "
                           f"{sum(c for c, _ in per)} in the round trips")
    secs = run.trace.seconds(lambda k: NAME in k, t0, t1)
    return 100.0 * sum(b for _, b in per) / 1e3 / secs
