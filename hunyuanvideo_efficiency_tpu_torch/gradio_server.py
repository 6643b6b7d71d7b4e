"""Gradio web UI for text-to-video sampling (JAX counterpart: the root
gradio_server.py; reference: gradio_server.py:14-140).

    python -m hunyuanvideo_efficiency_tpu_torch.gradio_server --model-base TREE

The reference's UI: resolution presets, video length 65/129, a steps
slider and an advanced accordion (seed, guidance, flow shift, embedded
guidance). `gradio` is imported only when the UI is built; `serve` is the
dependency-free server. One process, one device.
"""
import os
from datetime import datetime

from .config import parse_args
from .inference import HunyuanVideoSampler
from .utils.file_utils import save_videos_grid


def initialize_model(model_path, args=None):
    args = args or parse_args([])
    return HunyuanVideoSampler.from_pretrained(model_path, args=args)


def generate_video(model, prompt, resolution, video_length, seed,
                   num_inference_steps, guidance_scale, flow_shift,
                   embedded_guidance_scale, save_dir="./gradio_outputs"):
    """One video for the UI's inputs ("WxH" resolution, seed -1 for a
    random one); returns the mp4's path."""
    seed = None if seed == -1 else int(seed)
    width, height = resolution.split("x")
    outputs = model.predict(
        prompt=prompt, height=int(height), width=int(width),
        video_length=int(video_length), seed=seed,
        infer_steps=int(num_inference_steps),
        guidance_scale=float(guidance_scale),
        flow_shift=float(flow_shift),
        embedded_guidance_scale=float(embedded_guidance_scale))
    os.makedirs(save_dir, exist_ok=True)
    time_flag = datetime.now().strftime("%Y-%m-%d-%H:%M:%S")
    path = (f"{save_dir}/{time_flag}_seed{outputs['seeds'][0]}_"
            f"{outputs['prompts'][0][:100].replace('/', '')}.mp4")
    save_videos_grid(outputs["samples"][0:1], path, fps=24)
    return path


RESOLUTIONS = [
    # the reference's 10 presets, gradio_server.py:30-52
    "1280x720", "720x1280", "1104x832", "832x1104", "960x960",
    "960x544", "544x960", "832x624", "624x832", "720x720",
]


def create_demo(model_path, args=None):
    import gradio as gr

    model = initialize_model(model_path, args)

    with gr.Blocks() as demo:
        gr.Markdown("# HunyuanVideo (PyTorch/CUDA) text-to-video")
        with gr.Row():
            with gr.Column():
                prompt = gr.Textbox(label="Prompt",
                                    value="A cat walks on the grass.")
                resolution = gr.Dropdown(RESOLUTIONS, value="1280x720",
                                         label="Resolution (WxH)")
                video_length = gr.Dropdown([65, 129], value=129,
                                           label="Video length (frames)")
                steps = gr.Slider(1, 100, value=50, step=1,
                                  label="Inference steps")
                with gr.Accordion("Advanced", open=False):
                    seed = gr.Number(value=-1, label="Seed (-1 random)")
                    guidance = gr.Slider(1.0, 20.0, value=1.0,
                                         label="CFG scale")
                    flow_shift = gr.Slider(0.0, 25.0, value=7.0,
                                           label="Flow shift")
                    embedded = gr.Slider(1.0, 20.0, value=6.0,
                                         label="Embedded guidance scale")
                btn = gr.Button("Generate")
            with gr.Column():
                video = gr.Video(label="Result")
        btn.click(
            fn=lambda *a: generate_video(model, *a),
            inputs=[prompt, resolution, video_length, seed, steps, guidance,
                    flow_shift, embedded],
            outputs=video)
    return demo


if __name__ == "__main__":
    args = parse_args()
    demo = create_demo(args.model_base, args)
    demo.launch(server_name=os.getenv("SERVER_NAME", "0.0.0.0"),
                server_port=int(os.getenv("SERVER_PORT", "8081")))
