"""HTTP server for text-to-video generation (JAX counterpart: the root
serve.py; the reference ships only a Gradio UI, gradio_server.py:14-140).

    python -m hunyuanvideo_efficiency_tpu_torch.serve --model-base TREE ...
    torchrun --nproc_per_node 4 -m hunyuanvideo_efficiency_tpu_torch.serve \\
        --ulysses-degree 4 --model-base TREE ...

  POST /generate {"prompt": ..., "width": ..., "height": ...,
                  "video_length": ..., "seed": ..., "infer_steps": ...,
                  "guidance_scale": ..., "flow_shift": ...,
                  "embedded_guidance_scale": ..., "negative_prompt": ...,
                  "num_videos": ...}
    -> video/mp4 bytes with X-Seed and X-Gen-Time, or a JSON error: 400
       for a bad request or bad arguments, 500 when generation or the mp4
       encode fails (the error names the exception, e.g. the missing
       writer: the mp4 needs imageio with ffmpeg, or cv2)
  GET /healthz -> {"status": "ok", "model": ..., "devices": N, ...}

One request runs at a time, under a lock. Under a process group of more
than one rank, rank 0 serves HTTP and broadcasts each request's predict
arguments (`dist.broadcast_object_list`), so that every rank runs
`predict` in lockstep: the counterpart of JAX's one controller driving the
whole mesh (serve.py:14-15). Server address: SERVER_NAME / SERVER_PORT
(default 0.0.0.0:8081).
"""
from __future__ import annotations

import json
import os
import tempfile
import threading
from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer

import torch
import torch.distributed as dist

from .config import parse_args
from .utils.file_utils import save_videos_grid
from .utils.logging import logger

_GEN_LOCK = threading.Lock()


def request_kwargs(req: dict) -> dict:
    """predict's arguments for a /generate body (its defaults as JAX's)."""
    return dict(
        prompt=req["prompt"], height=int(req.get("height", 192)),
        width=int(req.get("width", 336)),
        video_length=int(req.get("video_length", 33)),
        seed=req.get("seed"), negative_prompt=req.get("negative_prompt"),
        infer_steps=int(req.get("infer_steps", 50)),
        guidance_scale=float(req.get("guidance_scale", 1.0)),
        flow_shift=float(req.get("flow_shift", 7.0)),
        embedded_guidance_scale=float(req.get("embedded_guidance_scale",
                                              6.0)),
        num_videos_per_prompt=int(req.get("num_videos", 1)))


def _multi_rank() -> bool:
    return dist.is_initialized() and dist.get_world_size() > 1


def _broadcast(obj, sampler):
    """Rank 0's `obj` on every rank (over the sampler's device)."""
    box = [obj]
    dev = sampler.device if sampler.device.type == "cuda" else None
    dist.broadcast_object_list(box, src=0, device=dev)
    return box[0]


def run_predict(sampler, kwargs: dict):
    """predict on this rank, and on every other rank of the group first
    told to run it with the same arguments."""
    if _multi_rank():
        _broadcast(kwargs, sampler)
    return sampler.predict(**kwargs)


def follow(sampler) -> None:
    """A rank other than 0: run predict on each request rank 0 broadcasts,
    until it broadcasts None. Argument errors raise on every rank alike,
    and rank 0 answers them."""
    while True:
        kwargs = _broadcast(None, sampler)
        if kwargs is None:
            return
        try:
            sampler.predict(**kwargs)
        except Exception:  # rank 0 answers the request with the error
            logger.exception("generation failed")


def make_handler(sampler):
    class Handler(BaseHTTPRequestHandler):
        def _json(self, code: int, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Type", "application/json")
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            if self.path == "/healthz":
                self._json(200, {
                    "status": "ok", "model": sampler.args.model,
                    "devices": torch.cuda.device_count(),
                    "device": str(sampler.device),
                    "ranks": dist.get_world_size() if _multi_rank() else 1})
            else:
                self._json(404, {"error": "unknown path"})

        def do_POST(self):
            if self.path != "/generate":
                self._json(404, {"error": "unknown path"})
                return
            try:
                n = int(self.headers.get("Content-Length", "0"))
                kwargs = request_kwargs(json.loads(self.rfile.read(n)
                                                   or b"{}"))
            except (KeyError, TypeError, ValueError) as e:
                self._json(400, {"error": f"bad request: {e!r}"})
                return
            try:
                with _GEN_LOCK:
                    out = run_predict(sampler, kwargs)
            except (ValueError, TypeError) as e:
                self._json(400, {"error": str(e)})
                return
            except Exception as e:  # generation failure -> structured 500
                logger.exception("generation failed")
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            with tempfile.NamedTemporaryFile(suffix=".mp4", delete=False) as f:
                path = f.name
            try:
                save_videos_grid(out["samples"][0:1], path, fps=24)
                with open(path, "rb") as f:
                    data = f.read()
            except Exception as e:
                logger.exception("encode failed")
                self._json(500, {"error": f"{type(e).__name__}: {e}"})
                return
            finally:
                os.unlink(path)
            self.send_response(200)
            self.send_header("Content-Type", "video/mp4")
            self.send_header("Content-Length", str(len(data)))
            self.send_header("X-Seed", str(out["seeds"][0]))
            self.send_header("X-Gen-Time", f"{out['gen_time']:.2f}")
            self.end_headers()
            self.wfile.write(data)

        def log_message(self, fmt, *args):  # route through our logger
            logger.info("%s - %s" % (self.address_string(), fmt % args))

    return Handler


def serve(sampler, host: str = "0.0.0.0", port: int = 8081):
    """Serves on rank 0 (every rank of a group calls this); the others
    follow rank 0's requests."""
    if _multi_rank() and dist.get_rank() != 0:
        follow(sampler)
        return
    httpd = ThreadingHTTPServer((host, port), make_handler(sampler))
    logger.info(f"Serving {sampler.args.model} on {host}:{port}")
    try:
        httpd.serve_forever()
    finally:
        httpd.server_close()
        if _multi_rank():
            with _GEN_LOCK:
                _broadcast(None, sampler)


def main(argv=None):
    from .inference import HunyuanVideoSampler
    from .parallel.multihost import initialize_multihost

    args = parse_args(argv)
    args.device = initialize_multihost(args.device)
    sampler = HunyuanVideoSampler.from_pretrained(args.model_base, args=args)
    serve(sampler, host=os.getenv("SERVER_NAME", "0.0.0.0"),
          port=int(os.getenv("SERVER_PORT", "8081")))


if __name__ == "__main__":
    main()
