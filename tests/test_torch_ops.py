"""The port's plain ops against the JAX package on the CPU: norms, rotary
embedding, the attention paths and masks, the flow-match schedule and the
argument parser.

Inputs come from numpy and reach both packages unchanged. fp32; tolerances
are stated per test (fp32 sums taken in another order).
"""
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu import config as jconfig
from hunyuanvideo_efficiency_tpu.diffusion import pipeline as jpipeline
from hunyuanvideo_efficiency_tpu.diffusion import scheduler as jsched
from hunyuanvideo_efficiency_tpu.ops import norms as jnorms
from hunyuanvideo_efficiency_tpu.ops import rope as jrope
from hunyuanvideo_efficiency_tpu_torch import config as tconfig
from hunyuanvideo_efficiency_tpu_torch.diffusion import pipeline as tpipeline
from hunyuanvideo_efficiency_tpu_torch.diffusion import scheduler as tsched
from hunyuanvideo_efficiency_tpu_torch.ops import attention as tattn
from hunyuanvideo_efficiency_tpu_torch.ops import norms as tnorms
from hunyuanvideo_efficiency_tpu_torch.ops import rope as trope

# the JAX package's ops/__init__.py exports a function of the module's name
jattn = importlib.import_module("hunyuanvideo_efficiency_tpu.ops.attention")

ATOL = 1e-5


def _rand(seed, *shape):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _close(out, ref, atol=ATOL):
    np.testing.assert_allclose(out.numpy(), np.asarray(ref), atol=atol,
                               rtol=1e-5)


@pytest.mark.parametrize("name", ["rms", "layer", "group"])
def test_norms_match_jax(name):
    x = _rand(0, 2, 3, 4, 5, 64) * 3 + 1
    w, b = _rand(1, 64), _rand(2, 64)
    t = {k: torch.from_numpy(v) for k, v in dict(x=x, w=w, b=b).items()}
    j = {k: jnp.asarray(v) for k, v in dict(x=x, w=w, b=b).items()}
    if name == "rms":
        out, ref = (tnorms.rms_norm(t["x"], t["w"]),
                    jnorms.rms_norm(j["x"], j["w"]))
    elif name == "layer":
        out, ref = (tnorms.layer_norm(t["x"], t["w"], t["b"]),
                    jnorms.layer_norm(j["x"], j["w"], j["b"]))
    else:
        out, ref = (tnorms.group_norm(t["x"], 8, t["w"], t["b"]),
                    jnorms.group_norm(j["x"], 8, j["w"], j["b"]))
    _close(out, ref, atol=2e-5)


def test_apply_rotary_emb_matches_jax():
    sizes, dims = (2, 3, 4), (8, 12, 12)
    jc, js = jrope.get_nd_rotary_pos_embed(dims, sizes, theta=256.0)
    tc, ts = trope.get_nd_rotary_pos_embed(dims, sizes, theta=256.0,
                                           device="cpu")
    q, k = _rand(3, 2, 24, 3, 32), _rand(4, 2, 24, 3, 32)
    ref = jrope.apply_rotary_emb(jnp.asarray(q), jnp.asarray(k), (jc, js))
    out = trope.apply_rotary_emb(torch.from_numpy(q), torch.from_numpy(k),
                                 (tc, ts))
    for o, r in zip(out, ref):
        _close(o, r)


def test_masks_match_jax():
    mask = np.ones((2, 7), np.int32)
    mask[1, 4:] = 0
    tm, jm = torch.from_numpy(mask), jnp.asarray(mask)
    np.testing.assert_array_equal(tattn.text_key_bias(tm).numpy(),
                                  np.asarray(jattn.text_key_bias(jm)))
    pad = tattn.padding_key_bias(tm, 5)
    np.testing.assert_array_equal(pad.numpy(),
                                  np.asarray(jattn.padding_key_bias(jm, 5)))
    np.testing.assert_array_equal(
        tattn.joint_key_bias(tattn.text_key_bias(tm), 5).numpy(), pad.numpy())
    assert tattn.joint_key_bias(None, 5) is None


@pytest.mark.parametrize("mode", ["sdpa", "chunked", "flash"])
def test_joint_attention_matches_jax(mode):
    img = [_rand(10 + i, 2, 20, 2, 32) for i in range(3)]
    txt = [_rand(20 + i, 2, 6, 2, 32) for i in range(3)]
    mask = np.ones((2, 6), np.int32)
    mask[0, 3:] = 0
    jbias = jattn.text_key_bias(jnp.asarray(mask))
    ref = jattn.joint_attention(*map(jnp.asarray, img + txt), jbias,
                                mode=mode)
    out = tattn.joint_attention(*map(torch.from_numpy, img + txt),
                                tattn.text_key_bias(torch.from_numpy(mask)),
                                mode=mode)
    for o, r in zip(out, ref):
        assert o.shape == r.shape
        _close(o, r)


@pytest.mark.parametrize("device", ["cuda", "cpu"])
@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float16,
                                   torch.float32])
@pytest.mark.parametrize("head_dim", [32, 64, 128])
def test_resolve_auto_mode(device, dtype, head_dim):
    """mode="auto": on CUDA tensors flash only inside the kernels' reach
    (bf16/fp16, head_dim 64 or 128), else sdpa, or chunked from 8192
    queries; on the CPU the flash path (its plain versions) as before."""
    flash = dtype != torch.float32 and head_dim in (64, 128)
    want = "flash" if device == "cpu" or flash else "sdpa"
    assert tattn.resolve_auto_mode(device, dtype, head_dim) == want
    assert tattn.resolve_auto_mode(device, dtype, head_dim, 4096) == want
    assert tattn.resolve_auto_mode(device, dtype, head_dim, 8192) == (
        "chunked" if want == "sdpa" else want)


def test_auto_mode_on_cpu_is_the_flash_path():
    """On CPU tensors "auto" equals "flash" exactly (fp32, head_dim 32:
    outside the kernels' reach on the card, the plain flash path here)."""
    q, k, v = (torch.from_numpy(_rand(30 + i, 2, 24, 2, 32)) for i in
               range(3))
    torch.testing.assert_close(tattn.attention(q, k, v, mode="auto"),
                               tattn.attention(q, k, v, mode="flash"),
                               rtol=0, atol=0)


@pytest.mark.parametrize("kw", [
    dict(shift=7.0), dict(shift=5.0, reverse=False),
    dict(use_linear_quadratic_schedule=True, linear_schedule_end=3)])
def test_schedule_matches_jax(kw):
    ref = jsched.FlowMatchDiscreteScheduler(**kw)
    out = tsched.FlowMatchDiscreteScheduler(**kw)
    ref.set_timesteps(7, n_tokens=1024)
    out.set_timesteps(7, n_tokens=1024)
    np.testing.assert_array_equal(out.sigmas, np.asarray(ref.sigmas))
    np.testing.assert_array_equal(out.timesteps, np.asarray(ref.timesteps))
    with pytest.raises(ValueError, match="Solver"):
        tsched.FlowMatchDiscreteScheduler(solver="heun")


def test_euler_step_and_rescale_cfg_match_jax():
    x, v, vt = (_rand(40 + i, 2, 4, 3, 5) for i in range(3))
    _close(tsched.euler_step(torch.from_numpy(x), torch.from_numpy(v),
                             0.75, 0.5),
           jsched.euler_step(jnp.asarray(x), jnp.asarray(v),
                             jnp.float32(0.75), jnp.float32(0.5)))
    _close(tpipeline.rescale_noise_cfg(torch.from_numpy(v),
                                       torch.from_numpy(vt), 0.7),
           jpipeline.rescale_noise_cfg(jnp.asarray(v), jnp.asarray(vt), 0.7))


def test_parse_args_matches_jax():
    argv = ["--model", "HYVideo-T/2", "--video-size", "544", "960",
            "--video-length", "65", "--infer-steps", "30", "--flow-shift",
            "5", "--no-vae-tiling", "--seed", "7", "--prompt", "a cat"]
    ref, out = jconfig.parse_args(argv), tconfig.parse_args(argv)
    for name in ("model", "video_size", "video_length", "infer_steps",
                 "flow_shift", "vae_tiling", "seed", "prompt", "vae",
                 "precision", "vae_precision", "text_len",
                 "hidden_state_skip_layer", "embedded_cfg_scale"):
        assert getattr(out, name) == getattr(ref, name), name
    assert tconfig.parse_args(["--video-size", "512"]).video_size == \
        (512, 512)
    info = tconfig.parse_vae_name("884-16c-hy")
    assert (info.time_ratio, info.spatial_ratio, info.latent_channels) == \
        (4, 8, 16) and info.latent_frames(129) == 33
    with pytest.raises(ValueError, match="VAE name"):
        tconfig.parse_vae_name("88x-16c-hy")


def test_constants_match_jax():
    from hunyuanvideo_efficiency_tpu import constants as jconst
    from hunyuanvideo_efficiency_tpu_torch import constants as tconst

    assert tconst.PROMPT_TEMPLATE == jconst.PROMPT_TEMPLATE
    assert tconst.NEGATIVE_PROMPT == jconst.NEGATIVE_PROMPT
    assert set(tconst.PRECISION_TO_TYPE) <= set(jconst.PRECISION_TO_TYPE)


def _qk_rope_case(seed, b=2, s=24, h=3, d=32, dtype=torch.float32):
    """q, k as column views of one fused [B, S, 3*H*D] projection, norm
    weights near 1 and the (2, 3, 4)-grid tables (24 rows)."""
    x = torch.from_numpy(_rand(seed, b, s, 3 * h * d) * 2 + 0.5).to(dtype)
    q, k = (x[..., i * h * d:(i + 1) * h * d].unflatten(-1, (h, d))
            for i in range(2))
    w = [torch.from_numpy(1 + 0.3 * _rand(seed + 1 + i, d)).to(dtype)
         for i in range(2)]
    freqs = trope.get_nd_rotary_pos_embed((8, 12, 12), (2, 3, 4),
                                          theta=256.0, device="cpu")
    return q, k, w, freqs


@pytest.mark.parametrize("rows,weighted", [(24, True), (24, False),
                                           (10, True), (0, True),
                                           (None, True)])
def test_qk_norm_rope_plain_is_the_composition(rows, weighted):
    """qk_norm_rope (its plain version on CPU tensors) equals rms_norm then
    rotate_tokens bit for bit in bf16; tokens past the table's rows (all
    of them with a 0-row table or freqs=None) equal rms_norm alone."""
    q, k, w, freqs = _qk_rope_case(5, dtype=torch.bfloat16)
    w = w if weighted else [None, None]
    freqs = None if rows is None else (freqs[0][:rows], freqs[1][:rows])
    n = rows or 0
    out = trope.qk_norm_rope(q, k, *w, freqs)
    for x, wx, o in zip((q, k), w, out):
        assert o.dtype == torch.bfloat16 and o.shape == x.shape
        normed = tnorms.rms_norm(x, wx)
        if n:
            head = trope.rotate_tokens(
                x[:, :n], freqs, pre=lambda t: tnorms.rms_norm(t, wx))
            assert torch.equal(o[:, :n], head)
        assert torch.equal(o[:, n:], normed[:, n:])


def test_qk_norm_rope_matches_jax():
    """QK-RMSNorm + RoPE against JAX's norms.rms_norm and
    rope.apply_rotary_emb on the same inputs, fp32."""
    q, k, w, _ = _qk_rope_case(7)
    jc, js = jrope.get_nd_rotary_pos_embed((8, 12, 12), (2, 3, 4),
                                           theta=256.0)
    tc, ts = trope.get_nd_rotary_pos_embed((8, 12, 12), (2, 3, 4),
                                           theta=256.0, device="cpu")
    ref = jrope.apply_rotary_emb(
        jnorms.rms_norm(jnp.asarray(q.numpy()), jnp.asarray(w[0].numpy())),
        jnorms.rms_norm(jnp.asarray(k.numpy()), jnp.asarray(w[1].numpy())),
        (jc, js))
    out = trope.qk_norm_rope(q, k, *w, (tc, ts))
    for o, r in zip(out, ref):
        _close(o, r)


@pytest.mark.parametrize("wants", [(True, False, False, False),
                                   (False, True, False, True),
                                   (True, True, True, True)],
                         ids=["q", "k_and_its_weight", "all"])
def test_qk_norm_rope_gradients(wants):
    """Under grad qk_norm_rope goes through its autograd.Function (the
    kernel's entry; the backward recomputes the plain version): the
    gradients of each input asked for equal autograd through the plain
    composition, with 10 of the 24 tokens past the table."""
    q, k, w, freqs = _qk_rope_case(9)
    freqs = (freqs[0][:14], freqs[1][:14])
    grads = []
    for fn in (trope.qk_norm_rope, trope.qk_norm_rope_plain):
        ins = [t.detach().clone().requires_grad_(f)
               for t, f in zip((q, k, *w), wants)]
        oq, ok = fn(*ins, freqs)
        if fn is trope.qk_norm_rope:
            assert type(oq.grad_fn).__name__ == "_QKNormRopeBackward"
        loss = (oq * torch.linspace(-1, 1, oq.shape[-1])).sum() \
            + (ok * ok).sum()
        grads.append(torch.autograd.grad(
            loss, [t for t, f in zip(ins, wants) if f]))
    for got, want in zip(*grads):
        torch.testing.assert_close(got, want, rtol=0, atol=0)


@pytest.mark.parametrize("dtype,d,wdtype,why", [
    (torch.bfloat16, 128, None, None), (torch.float16, 64, None, None),
    (torch.float32, 128, None, "dtype"), (torch.bfloat16, 32, None,
                                          "head_dim"),
    (torch.bfloat16, 128, torch.float32, "weight dtype")])
def test_qk_norm_rope_gate(dtype, d, wdtype, why):
    """The kernel's reach: bf16/fp16, head_dim 64/128, a weight of the
    values' type; the wrapper raises on CUDA tensors outside it."""
    x = torch.zeros(1, 2, 3, d, dtype=dtype)
    w = torch.ones(d, dtype=wdtype) if wdtype else None
    got = trope._refusal(x, w)
    assert (got is None) if why is None else got.startswith(why)
