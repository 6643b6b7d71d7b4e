"""Console entry points (JAX counterpart: cli.py), installed through
pyproject's [project.scripts]: `hyvideo-torch-sample` and
`hyvideo-torch-collect-env`."""
from __future__ import annotations


def sample_main(argv=None):
    """`hyvideo-torch-sample`: the packaged `sample_video` (the same flags;
    under torchrun, sequence-parallel). Returns the mp4 paths."""
    from .sample_video import main

    return main(argv)


if __name__ == "__main__":
    sample_main()
