"""The port's causal-3D VAE against the JAX package on the CPU.

Small VAEConfig (channels (32, 32, 64, 64), one layer per block): its
channels fall outside the K3 gate, so this covers the plain conv path;
tests/test_torch_conv3d.py covers K3. Weights from init_vae_params reach
the port through utils/weights.py. fp32; tolerance 1e-4 relative to the
output scale.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.vae import (
    AutoencoderKLCausal3D as JVAE, init_vae_params)
from hunyuanvideo_efficiency_tpu.models.vae_config import VAEConfig as JCfg
from hunyuanvideo_efficiency_tpu.ops.attention import (
    chunked_attention as jax_chunked,
    frame_causal_block_bias as jax_frame_causal)
from hunyuanvideo_efficiency_tpu_torch.models.vae import (
    AutoencoderKLCausal3D, DiagonalGaussian)
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import VAEConfig
from hunyuanvideo_efficiency_tpu_torch.ops.attention import (
    chunked_attention, frame_causal_block_bias, sdpa_attention)
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    vae_state_dict_from_jax)

SMALL = dict(block_out_channels=(32, 32, 64, 64), layers_per_block=1,
             sample_size=32, sample_tsize=8)


@pytest.fixture(scope="module")
def pair():
    jcfg = JCfg(**SMALL)
    init = jax.jit(init_vae_params, static_argnums=1)  # one compile
    params = jax.tree.map(np.asarray, init(jax.random.PRNGKey(0), jcfg))
    cfg = VAEConfig(**SMALL)
    vae = AutoencoderKLCausal3D(cfg)
    vae.load_state_dict(vae_state_dict_from_jax(params))
    return JVAE(jcfg, jax.tree.map(jnp.asarray, params)), vae.eval()


def _close(out, ref, rel=1e-4):
    ref = np.asarray(ref)
    assert out.shape == ref.shape
    np.testing.assert_allclose(out.numpy(), ref,
                               atol=rel * np.abs(ref).max(), rtol=rel)


@pytest.mark.parametrize("tiling,shape", [
    ((False, False), (1, 16, 3, 5, 5)),
    ((True, False), (1, 16, 2, 5, 5)),   # 4-pixel latent tiles, 2 x 2
    ((False, True), (1, 16, 4, 3, 3)),   # 2(+1)-frame latent tiles
])
def test_decode_matches_jax(pair, tiling, shape):
    """Untiled, spatially tiled and temporally tiled decode, each blending
    its tiles as the reference does."""
    jvae, vae = pair
    z = np.random.default_rng(0).standard_normal(shape).astype(np.float32)
    jvae.use_spatial_tiling, jvae.use_temporal_tiling = tiling
    vae.use_spatial_tiling, vae.use_temporal_tiling = tiling
    ref = jvae.decode(jnp.asarray(z))
    out = vae.decode(torch.from_numpy(z))
    _close(out, ref)


def test_encode_matches_jax(pair):
    jvae, vae = pair
    jvae.use_spatial_tiling = jvae.use_temporal_tiling = False
    vae.disable_tiling()
    x = np.random.default_rng(1).standard_normal((1, 3, 5, 16, 16)
                                                 ).astype(np.float32)
    ref = jvae.encode_moments(jnp.asarray(x))
    out = vae.encode_moments(torch.from_numpy(x))
    _close(out, ref)
    post = vae.encode(torch.from_numpy(x))
    assert isinstance(post, DiagonalGaussian)
    torch.testing.assert_close(post.mode(), out.movedim(1, -1)[..., :16])


def test_frame_causal_chunked_matches_sdpa_and_jax():
    """The mid-block's two attention forms (explicit mask below 4096
    tokens, chunked with a block-bias function above) agree."""
    rng = np.random.default_rng(2)
    q, k, v = (rng.standard_normal((1, 48, 1, 16)).astype(np.float32)
               for _ in range(3))
    n_hw = 12
    tq, tk, tv = (torch.from_numpy(a) for a in (q, k, v))
    idx = torch.arange(48) // n_hw
    bias = torch.where(idx[None] <= idx[:, None], 0.0, -1e30)[None, None]
    full = sdpa_attention(tq, tk, tv, bias=bias)
    chunk = chunked_attention(tq, tk, tv,
                              block_bias_fn=frame_causal_block_bias(n_hw),
                              q_chunk=16, k_chunk=16)
    ref = jax_chunked(jnp.asarray(q), jnp.asarray(k), jnp.asarray(v),
                      block_bias_fn=jax_frame_causal(n_hw), q_chunk=16,
                      k_chunk=16)
    np.testing.assert_allclose(chunk.numpy(), full.numpy(), atol=1e-5)
    np.testing.assert_allclose(chunk.numpy(), np.asarray(ref), atol=1e-5)


def test_config_copy_matches_jax():
    assert dataclasses.asdict(VAEConfig()) == dataclasses.asdict(JCfg())
    cfg = VAEConfig()
    assert [cfg.upsample_factor(i) for i in range(4)] == \
        [JCfg().upsample_factor(i) for i in range(4)]
