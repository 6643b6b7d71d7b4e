"""Structured logging (JAX counterpart: utils/logging.py): loguru when
available (the reference's logger, e.g. hyvideo/inference.py:8), the
standard library's otherwise."""
from __future__ import annotations

try:
    from loguru import logger  # type: ignore
except ImportError:  # depends on the environment
    import logging
    import sys

    _l = logging.getLogger("hunyuanvideo_efficiency_tpu_torch")
    if not _l.handlers:
        h = logging.StreamHandler(sys.stderr)
        h.setFormatter(logging.Formatter(
            "%(asctime)s | %(levelname)-7s | %(message)s"))
        _l.addHandler(h)
        _l.setLevel(logging.INFO)

    class _Shim:
        def __getattr__(self, name):
            if name in ("info", "warning", "error", "debug", "critical",
                        "exception"):
                return getattr(_l, name)
            if name == "success":
                return _l.info
            raise AttributeError(name)

    logger = _Shim()

__all__ = ["logger"]
