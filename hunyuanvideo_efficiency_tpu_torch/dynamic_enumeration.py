"""t-ops experiment config generator (JAX counterpart: the root
dynamic_enumeration.py, dynamic_enumeration_stride.py and
dynamic_enumeration_stride_2.py; reference: the same three scripts).

    python -m hunyuanvideo_efficiency_tpu_torch.dynamic_enumeration \
        [--mode pool|stride|stride2] [--output-dir DIR] [--cap N]

pool: one-hot encoder pool x decoder interp; stride: encoder temporal
stride doubling x decoder interp; stride2: choose-2 of each. Writes
exp_1.json .. exp_N.json. Needs no device.
"""
import argparse

from .experiments import write_configs

DEFAULT_DIRS = {"pool": "exp_configs", "stride": "exp_configs_stride",
                "stride2": "exp_configs_stride_2"}


def main(argv=None):
    """Runs the entry on `argv` (default: sys.argv); returns the paths."""
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("base_config", nargs="?", default=None,
                   help="accepted for reference CLI parity; schema is "
                        "built in")
    p.add_argument("--mode", default="pool",
                   choices=["pool", "stride", "stride2"])
    p.add_argument("--output-dir", default=None,
                   help="default: exp_configs, exp_configs_stride or "
                        "exp_configs_stride_2 by mode")
    p.add_argument("--cap", type=int, default=384)
    a = p.parse_args(argv)
    out = a.output_dir or DEFAULT_DIRS[a.mode]
    paths = write_configs(out, mode=a.mode, cap=a.cap)
    print(f"Wrote {len(paths)} configs to {out}")
    return paths


if __name__ == "__main__":
    main()
