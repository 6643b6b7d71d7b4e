"""Text-to-video sampling (reference: sample_video.py:12-58).

    python -m hunyuanvideo_efficiency_tpu_torch.sample_video --prompt "..." \
        --video-size 720 1280 --video-length 129 --infer-steps 50

Same flags as the reference script; writes one mp4 per video. Under
sequence parallelism one process a GPU, as the reference runs:

    torchrun --nproc_per_node 4 -m hunyuanvideo_efficiency_tpu_torch.sample_video \
        --ulysses-degree 2 --ring-degree 2 --prompt "..."

Every rank computes; only rank 0 writes the mp4 (reference
sample_video.py:49).
"""
import logging
import os
from datetime import datetime
from pathlib import Path

from .config import parse_args
from .inference import HunyuanVideoSampler
from .parallel.multihost import initialize_multihost, is_primary
from .utils.file_utils import save_videos_grid

logger = logging.getLogger("hyvideo")


def main(argv=None):
    """Runs the CLI on `argv` (default: sys.argv); returns the mp4 paths
    (none on the ranks that do not write)."""
    logging.basicConfig(level=logging.INFO)
    args = parse_args(argv)
    args.device = initialize_multihost(args.device)
    models_root = Path(args.model_base)
    if not models_root.exists():
        raise ValueError(f"`models_root` not exists: {models_root}")
    save_path = (args.save_path if args.save_path_suffix == ""
                 else f"{args.save_path}_{args.save_path_suffix}")
    os.makedirs(save_path, exist_ok=True)

    sampler = HunyuanVideoSampler.from_pretrained(
        str(models_root), args=args, logger=logger)
    outputs = sampler.predict(
        prompt=args.prompt, height=args.video_size[0],
        width=args.video_size[1], video_length=args.video_length,
        seed=args.seed, negative_prompt=args.neg_prompt,
        infer_steps=args.infer_steps, guidance_scale=args.cfg_scale,
        num_videos_per_prompt=args.num_videos, flow_shift=args.flow_shift,
        batch_size=args.batch_size,
        embedded_guidance_scale=args.embedded_cfg_scale)
    samples = outputs["samples"]
    paths = []
    if not is_primary():
        return paths
    for i in range(samples.shape[0]):
        stamp = datetime.now().strftime("%Y-%m-%d-%H:%M:%S")
        prompt_tag = outputs["prompts"][0][:100].replace("/", "")
        path = (f"{save_path}/{stamp}_seed{outputs['seeds'][i]}_{prompt_tag}"
                f"{args.name_suffix}.mp4")
        save_videos_grid(samples[i:i + 1], path, fps=24)
        logger.info(f"Sample save to: {path}")
        paths.append(path)
    return paths


if __name__ == "__main__":
    main()
