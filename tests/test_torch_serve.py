"""The port's serving entries and tools on the CPU, as their JAX
counterparts behave (tests/test_serve.py's tiny sampler, built with the
port): the HTTP server's /healthz, /generate (mp4 bytes where a writer is
installed, else the structured 500 naming it), 400 and 404; the Gradio
module's generate_video; the scheduler's step API against JAX's;
--profile-dir writing a trace; collect_env; prompt_rewrite; the cli entry.
Sequence-parallel lockstep serving (rank 0 broadcasting each request) runs
in tests/test_torch_sp.py's world of 2.
"""
import json
import threading
import urllib.error
import urllib.request
from http.server import ThreadingHTTPServer
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu import prompt_rewrite as jax_rewrite
from hunyuanvideo_efficiency_tpu.diffusion.scheduler import (
    FlowMatchDiscreteScheduler as JScheduler)
from hunyuanvideo_efficiency_tpu_torch import (cli, gradio_server,
                                               prompt_rewrite, sample_video,
                                               serve)
from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs
from hunyuanvideo_efficiency_tpu_torch.diffusion.scheduler import (
    FlowMatchDiscreteScheduler)
from hunyuanvideo_efficiency_tpu_torch.inference import HunyuanVideoSampler
from hunyuanvideo_efficiency_tpu_torch.models.dit import build_dit
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.models.text import (
    CLIPTextConfig, LlamaConfig, build_text_encoders)
from hunyuanvideo_efficiency_tpu_torch.models.vae import build_vae
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import VAEConfig
from hunyuanvideo_efficiency_tpu_torch.utils.collect_env import collect_env

GEN = {"prompt": "a cat", "width": 32, "height": 32, "video_length": 5,
       "infer_steps": 1, "seed": 3}


def tiny_sampler():
    """JAX tests/test_serve.py's tiny sampler, random weights from seeds."""
    g = torch.Generator().manual_seed(0)
    cfg = DiTConfig(hidden_size=128, heads_num=4, mm_double_blocks_depth=1,
                    mm_single_blocks_depth=1, rope_dim_list=(8, 12, 12),
                    text_states_dim=64, text_states_dim_2=48)
    llm, clip = build_text_encoders(
        llm_config=LlamaConfig(vocab_size=256, hidden_size=64,
                               intermediate_size=96, num_hidden_layers=2,
                               num_attention_heads=4, num_key_value_heads=2),
        clip_config=CLIPTextConfig(vocab_size=96, hidden_size=48,
                                   intermediate_size=96, num_hidden_layers=2,
                                   num_attention_heads=4,
                                   max_position_embeddings=77,
                                   eos_token_id=95),
        text_len=10, text_len_2=16, hidden_state_skip_layer=1,
        device="cpu", dtype=torch.float32, generator=g)
    vae = build_vae(VAEConfig(block_out_channels=(32, 32, 64, 64),
                              layers_per_block=1), "cpu", torch.float32, g)
    args = InferenceArgs(text_states_dim=64, text_states_dim_2=48,
                         vae_tiling=False, device="cpu")
    return HunyuanVideoSampler(args, vae, llm, clip,
                               build_dit(cfg, "cpu", torch.float32, g))


@pytest.fixture(scope="module")
def sampler():
    return tiny_sampler()


@pytest.fixture(scope="module")
def server(sampler):
    httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(sampler))
    t = threading.Thread(target=httpd.serve_forever, daemon=True)
    t.start()
    yield f"http://127.0.0.1:{httpd.server_address[1]}"
    httpd.shutdown()
    httpd.server_close()


def _post(url, body: bytes):
    req = urllib.request.Request(url, data=body,
                                 headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req) as r:
            return r.status, dict(r.headers), r.read()
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), e.read()


def _writer_missing():
    for mod in ("imageio", "cv2"):
        try:
            __import__(mod)
        except ImportError:
            continue
        return False
    return True


def test_healthz_and_404(server):
    with urllib.request.urlopen(f"{server}/healthz") as r:
        body = json.loads(r.read())
    assert body == {"status": "ok", "model": "HYVideo-T/2-cfgdistill",
                    "devices": torch.cuda.device_count(), "device": "cpu",
                    "ranks": 1}
    with pytest.raises(urllib.error.HTTPError) as e:
        urllib.request.urlopen(f"{server}/nope")
    assert e.value.code == 404
    assert _post(f"{server}/nope", b"{}")[0] == 404


def test_generate_returns_mp4_or_names_the_writer(server):
    code, headers, data = _post(f"{server}/generate",
                                json.dumps(GEN).encode())
    if code == 500:   # no mp4 writer on this host: the structured error
        assert "cv2" in json.loads(data)["error"] and _writer_missing()
        return
    assert code == 200, data[:500]
    assert headers["Content-Type"] == "video/mp4"
    assert headers["X-Seed"] == "3" and float(headers["X-Gen-Time"]) > 0
    assert len(data) > 500   # a real mp4 container


@pytest.mark.parametrize("body,match", [
    (b'{"no_prompt": 1}', "prompt"),
    (b"not json", "bad request"),
    (json.dumps({**GEN, "height": "tall"}).encode(), "bad request"),
    (json.dumps({**GEN, "video_length": 6}).encode(), "multiple of 4"),
])
def test_generate_bad_requests(server, body, match):
    code, _, data = _post(f"{server}/generate", body)
    assert code == 400 and match in json.loads(data)["error"]


def test_gradio_generate_video(sampler, tmp_path):
    try:
        path = gradio_server.generate_video(
            sampler, "a dog", "32x32", 5, 7, 1, 1.0, 7.0, 6.0,
            save_dir=str(tmp_path))
    except ModuleNotFoundError as e:
        assert "cv2" in str(e) and _writer_missing()
        return
    assert Path(path).parent == tmp_path and "_seed7_a dog" in path
    assert Path(path).stat().st_size > 500
    assert gradio_server.RESOLUTIONS[0] == "1280x720"


def test_scheduler_step_api_matches_jax():
    """A loop of `step` over the timesteps equals JAX's stateful
    FlowMatchDiscreteScheduler.step and the pipeline's Euler update."""
    rng = np.random.default_rng(0)
    for kw in (dict(shift=7.0), dict(shift=5.0, reverse=False),
               dict(use_linear_quadratic_schedule=True,
                    linear_schedule_end=3)):
        sch, jsch = FlowMatchDiscreteScheduler(**kw), JScheduler(**kw)
        assert len(sch) == len(jsch) == 1000 and sch.order == 1
        sch.set_timesteps(6)
        jsch.set_timesteps(6)
        assert sch.step_index is None
        x = rng.standard_normal((1, 4, 2, 3, 3)).astype(np.float32)
        tx, jx = torch.from_numpy(x), jnp.asarray(x)
        for i, t in enumerate(sch.timesteps):
            v = rng.standard_normal(x.shape).astype(np.float32)
            assert sch.index_for_timestep(t) == jsch.index_for_timestep(t)
            assert sch.scale_model_input(tx, t) is tx
            tx = sch.step(torch.from_numpy(v), t, tx)[0]
            jx = jsch.step(jnp.asarray(v), t, jx)[0]
            assert sch.step_index == jsch.step_index == i + 1
            np.testing.assert_allclose(tx.numpy(), np.asarray(jx),
                                       rtol=1e-6, atol=1e-6)
        # a bf16-rounded timestep still finds its step (nearest)
        t_bf = float(torch.tensor(sch.timesteps[2]).bfloat16())
        assert sch.index_for_timestep(t_bf) == 2


def test_profile_dir_writes_a_trace(sampler, tmp_path):
    sampler.args.profile_dir = str(tmp_path / "prof")
    try:
        out = sampler.predict("a cat", height=32, width=32, video_length=5,
                              seed=1, infer_steps=1, guidance_scale=1.0)
    finally:
        sampler.args.profile_dir = None
    assert out["samples"].shape == (1, 3, 5, 32, 32)
    traces = list((tmp_path / "prof").glob("trace_rank0_*.json"))
    assert len(traces) == 1
    names = {e.get("name") for e in json.loads(traces[0].read_text())[
        "traceEvents"]}
    assert "flash_static" in names


def test_collect_env_and_prompt_rewrite(capsys):
    env = collect_env()
    for key in ("Python", "torch", "torch CUDA", "CUDA available",
                "Device count", "nvcc", "NCCL"):
        assert key in env
    assert env["torch"] == torch.__version__
    assert env["Device count"] == str(torch.cuda.device_count())
    from hunyuanvideo_efficiency_tpu_torch.utils import collect_env as ce

    ce.main()
    assert "torch: " in capsys.readouterr().out
    for mode in ("Normal", "Master"):
        assert prompt_rewrite.get_rewrite_prompt("一只猫", mode) == \
            jax_rewrite.get_rewrite_prompt("一只猫", mode)
    with pytest.raises(Exception, match="Only supports"):
        prompt_rewrite.get_rewrite_prompt("x", "Other")


def test_cli_sample_main_arguments(monkeypatch, tmp_path):
    """`hyvideo-torch-sample` is sample_video's main on the given argv."""
    with pytest.raises(ValueError, match="models_root"):
        cli.sample_main(["--model-base", str(tmp_path / "none"),
                         "--device", "cpu"])
    seen = []
    monkeypatch.setattr(sample_video, "main", lambda argv=None: seen.append(
        argv) or ["x.mp4"])
    assert cli.sample_main(["--prompt", "p"]) == ["x.mp4"]
    assert seen == [["--prompt", "p"]]
    assert serve.request_kwargs({"prompt": "p"}) == dict(
        prompt="p", height=192, width=336, video_length=33, seed=None,
        negative_prompt=None, infer_steps=50, guidance_scale=1.0,
        flow_shift=7.0, embedded_guidance_scale=6.0,
        num_videos_per_prompt=1)
