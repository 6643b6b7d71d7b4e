"""VAE-only batch round trip with a t-ops config (JAX counterpart: the root
infer.py; reference: infer.py:28-123, the fork's experiment objective path).

    python -m hunyuanvideo_efficiency_tpu_torch.infer --tensor-dir IN \
        --output-dir OUT [--config-json exp_1.json] [--enable-tiling] \
        [--random-init] [--vae-precision fp16] [--mp4] [--device cpu]

Reads `.pt` video tensors ([C, T, H, W] in [-1, 1]), runs encode + decode
through the causal-3D VAE with an optional temporal-ops experiment config
(JSON, the schema of the reference's t_ops_config.json), and saves the
reconstructions as fp32 `.pt` (+ mp4 with --mp4, which needs OpenCV).
The posterior's mode is decoded (`sample_posterior=False`) and the VAE runs
in fp16 by default, as in the reference (:53-60, :104-112). Runs on the
card unless `--device cpu` is passed.

`--data-parallel` (JAX infer.py:71-81): under torchrun (`torchrun
--nproc_per_node N -m hunyuanvideo_efficiency_tpu_torch.infer ...
--data-parallel --enable-tiling`) the tiles of each tiled encode and decode
spread over the ranks (models/vae.py; the result equals one rank's bit for
bit), each rank on cuda:LOCAL_RANK (gloo with --device cpu), and only rank
0 writes files; in one process the flag changes nothing.
"""
import argparse
import logging
import os
import time

import torch
import torch.distributed as dist

from .constants import PRECISION_TO_TYPE
from .data.dataset_loader import VideoTensorDataset, save_tensor
from .models.vae import build_vae
from .models.vae_config import TOpsConfig, load_vae_config
from .parallel.comm import GroupComm
from .parallel.multihost import initialize_multihost, is_primary

logger = logging.getLogger("hyvideo")

# the seed of --random-init's weights
RANDOM_INIT_SEED = 0


def parse_args(argv=None):
    p = argparse.ArgumentParser(
        description="VAE inference script for video tensors.")
    p.add_argument("--tensor-dir", type=str, required=True)
    p.add_argument("--output-dir", type=str, required=True)
    p.add_argument("--vae-path", type=str,
                   default="ckpts/hunyuan-video-t2v-720p/vae")
    p.add_argument("--vae-type", type=str, default="884-16c-hy")
    p.add_argument("--vae-precision", type=str, default="fp16",
                   choices=sorted(PRECISION_TO_TYPE))
    p.add_argument("--config-json", type=str, default=None,
                   help="t-ops config JSON (reference t_ops_config.json "
                        "schema)")
    p.add_argument("--max-files", type=int, default=None)
    p.add_argument("--mp4", action="store_true",
                   help="also write mp4s (needs OpenCV)")
    p.add_argument("--enable-tiling", action="store_true")
    p.add_argument("--data-parallel", action="store_true",
                   help="spread tiled encode/decode tiles over the ranks "
                        "(under torchrun; one process: no-op)")
    p.add_argument("--random-init", action="store_true",
                   help="random VAE weights (smoke tests, no checkpoint)")
    p.add_argument("--device", type=str, default="cuda")
    return p.parse_args(argv)


def load_vae(vae_type, vae_precision, vae_path, t_ops_config_path=None,
             test=False, random_init=False, logger=None, data_parallel=False,
             device="cuda"):
    """(reference: hyvideo/vae/__init__.py:70-127). `vae_path` holds
    `pytorch_model.pt` (its `vae.` key prefix stripped where present); with
    `random_init` and no checkpoint the weights are drawn in fp32 from a
    generator on `device` seeded RANDOM_INIT_SEED and then cast, so every
    precision holds the same weights. The t-ops config applies only with
    `test`, as in the reference. `data_parallel` spreads tiled calls' tiles
    over the ranks of a started process group of more than one rank (else
    nothing changes). Returns (vae, path, spatial_ratio, time_ratio)."""
    cfg = load_vae_config(vae_type)
    tops = None
    if t_ops_config_path and test:
        tops = TOpsConfig.from_json(t_ops_config_path)
        if logger:
            logger.info(f"Applied t-ops config from {t_ops_config_path}")
    dtype = PRECISION_TO_TYPE[vae_precision]
    ckpt = os.path.join(vae_path, "pytorch_model.pt")
    if os.path.exists(ckpt):
        from .utils.checkpoint import load_torch_state_dict

        vae = build_vae(cfg, device, dtype, tops=tops)
        vae.load_state_dict(load_torch_state_dict(ckpt, prefix="vae."))
    elif random_init:
        gen = torch.Generator(device).manual_seed(RANDOM_INIT_SEED)
        vae = build_vae(cfg, device, torch.float32, gen, tops=tops).to(dtype)
    else:
        raise FileNotFoundError(f"No VAE checkpoint at {ckpt}")
    if data_parallel and dist.is_initialized() and \
            dist.get_world_size() > 1:
        vae.tile_comm = GroupComm()
        if logger:
            logger.info(f"VAE tiles spread over {dist.get_world_size()} "
                        f"ranks")
    return vae, vae_path, cfg.spatial_compression_ratio, \
        cfg.time_compression_ratio


def infer_vae(vae, dataset, output_dir, max_files=None, mp4=False,
              write=True):
    """Round-trip each video of `dataset` on the VAE's device and save the
    fp32 reconstruction [C, T, H, W] as `<name>.pt` (and `<name>.mp4`);
    write=False runs the round trips only (the ranks after 0)."""
    dev = vae.post_quant_conv.weight.device
    if write:
        os.makedirs(output_dir, exist_ok=True)
    for idx, (video, file_name) in enumerate(dataset):
        if max_files is not None and idx >= max_files:
            break
        name = file_name.replace(".pt", "")
        x = video[None].to(dev)  # [1, C, T, H, W]
        logger.info(f"Processing {name}, video shape: {tuple(x.shape)}")
        t0 = time.time()
        recon = vae(x, sample_posterior=False)[0].float().cpu()
        logger.info(f"  round-trip {time.time() - t0:.2f}s -> "
                    f"{tuple(recon.shape)}")
        if not write:
            continue
        save_tensor(os.path.join(output_dir, f"{name}.pt"), recon)
        if mp4:
            from .data.mp42tensor import tensor_to_video

            tensor_to_video(recon, os.path.join(output_dir, f"{name}.mp4"))
    if write:
        logger.info(f"Saved reconstructions to {output_dir}")


def main(argv=None):
    """Runs the entry on `argv` (default: sys.argv)."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    logger.info(f"Running inference with args: {args}")
    if args.mp4:
        try:
            import cv2  # noqa: F401
        except ImportError as e:
            raise SystemExit("--mp4 needs OpenCV (cv2), which is not "
                             "installed; the .pt reconstructions need "
                             "nothing more") from e
    device = args.device
    if args.data_parallel:
        device = initialize_multihost(device)
    vae, _, _, _ = load_vae(
        args.vae_type, args.vae_precision, args.vae_path,
        t_ops_config_path=args.config_json, test=True,
        random_init=args.random_init, logger=logger,
        data_parallel=args.data_parallel, device=device)
    if args.enable_tiling:
        vae.enable_tiling()
    infer_vae(vae, VideoTensorDataset(args.tensor_dir), args.output_dir,
              max_files=args.max_files, mp4=args.mp4, write=is_primary())


if __name__ == "__main__":
    main()
