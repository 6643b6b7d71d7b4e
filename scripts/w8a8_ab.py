"""Time the W8A8 linear B9 of one checkout of the port at the smoke's shapes.

    python3 scripts/w8a8_ab.py --tree DIR --label NAME

Imports `hunyuanvideo_efficiency_tpu_torch` from DIR (a checkout of this
repository, e.g. a parent commit unpacked with `git archive`), builds its
`csrc/w8a8_linear.cu` and times `ops.int8_matmul.w8a8_linear` at the
shapes of chip_smoke.py's check_w8a8 and the single block's modulation
[2, 3072] -> 9216, bf16, bias, random int8 weights from a fixed seed. Two
times a shape: the device time of a call (20 calls captured in one CUDA
graph and replayed) and the eager time (20 back-to-back calls, the host's
cost included). One JSON line a shape, tagged with NAME and the card.
Run it for two checkouts in turns (parent, change, change, parent) on
one card to compare them. Needs CUDA.
"""
import argparse
import json
import os
import subprocess
import sys

SHAPES = ((8064, 3072, 9216, None, None),
          (8064, 3072, 12288, "gelu_tanh", None),
          (2, 3072, 18432, None, None),
          (512, 3072, 9216, None, None),
          (8576, 12288, 3072, None, 3072),
          (2, 3072, 9216, None, None))


def events_ms(run, reps):
    import torch

    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    start.record()
    run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def graph_ms(fn, reps):
    """Mean device time of a call: `reps` calls in one CUDA graph."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    return events_ms(graph.replay, reps)


def eager_ms(fn, reps):
    import torch

    fn()
    torch.cuda.synchronize()

    def run():
        for _ in range(reps):
            fn()
    return events_ms(run, reps)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--tree", required=True)
    ap.add_argument("--label", required=True)
    ap.add_argument("--reps", type=int, default=20)
    args = ap.parse_args(argv)
    sys.path.insert(0, os.path.abspath(args.tree))
    import torch

    if not torch.cuda.is_available():
        raise SystemExit("the W8A8 A/B timing needs a CUDA device")
    from hunyuanvideo_efficiency_tpu_torch.ops import int8_matmul
    from hunyuanvideo_efficiency_tpu_torch.ops.quantization import (
        quantize_tensor_int8)

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(dev).manual_seed(2)
    for m, k, n, act, k_slice in SHAPES:
        x = torch.randn(m, k, generator=g, device=dev).bfloat16()
        w8, so = quantize_tensor_int8(torch.randn(
            n, k + (k_slice or 0), generator=g, device=dev))
        if k_slice:
            w8 = w8[:, k_slice:]
        bias = torch.randn(n, generator=g, device=dev).bfloat16()

        def call():
            int8_matmul.w8a8_linear(x, w8, so, bias, act)
        print(json.dumps(dict(
            label=args.label, shape=f"[{m},{k}]->{n}", act=act,
            graph_ms=graph_ms(call, args.reps),
            eager_ms=eager_ms(call, args.reps), card=card)), flush=True)
        del x, w8, so, bias
        torch.cuda.empty_cache()


if __name__ == "__main__":
    main()
