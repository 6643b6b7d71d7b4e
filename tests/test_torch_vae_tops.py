"""The port's temporal-ops VAE (TOpsConfig and its hooks, the round trip,
slicing, the posterior's kl / nll) against the JAX package on the CPU.

The tiny VAEConfig of tests/test_vae.py (channels (8, 16, 16, 16), one
layer a block, 4 norm groups) with random weights in JAX's parameter tree
carried across by utils/weights.py; fp32. Tolerance 1e-4 relative to the
output's scale. Each JAX VAE compiles its encoder and decoder once per
config and shape, so the JAX side is built once per config and shared.
"""
import dataclasses
import json
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.models.vae import (
    AutoencoderKLCausal3D as JVAE, DiagonalGaussian as JGaussian,
    init_vae_params)
from hunyuanvideo_efficiency_tpu.models.vae_config import (
    TOpsConfig as JTOps, VAEConfig as JCfg)
from hunyuanvideo_efficiency_tpu_torch.experiments.enumeration import (
    enumerate_configs)
from hunyuanvideo_efficiency_tpu_torch.models.vae import (
    AutoencoderKLCausal3D, DiagonalGaussian)
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (
    DownBlockTOps, MidBlockTOps, TOpsConfig, UpBlockTOps, VAEConfig)
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    vae_state_dict_from_jax)

ROOT = Path(__file__).resolve().parent.parent
TINY = dict(latent_channels=4, block_out_channels=(8, 16, 16, 16),
            layers_per_block=1, norm_num_groups=4, sample_size=32,
            sample_tsize=16)


@pytest.fixture(scope="module")
def params():
    """init_vae_params's tree, drawn with numpy: kernels N(0, 1/fan_in) as
    JAX draws them, norm scales and biases perturbed around 1 and 0 so that
    they count too (tracing the tree's shapes costs no compile)."""
    rng = np.random.default_rng(0)
    shapes = jax.eval_shape(lambda k: init_vae_params(k, JCfg(**TINY)),
                            jax.random.PRNGKey(0))

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        name = path[-1].key
        if name == "kernel":
            return x / np.sqrt(np.prod(leaf.shape[:-1]))
        return (name == "scale") + 0.1 * x

    return jax.tree_util.tree_map_with_path(draw, shapes)


@pytest.fixture(scope="module")
def port_vae(params):
    vae = AutoencoderKLCausal3D(VAEConfig(**TINY))
    vae.load_state_dict(vae_state_dict_from_jax(params))
    return vae.eval()


_JAX_VAES = {}


def _pair(params, port_vae, tops):
    """The JAX VAE under `tops` (its own config type, one a config for the
    module) and the port's."""
    port_vae.tops = None if tops is None else TOpsConfig.from_dict(tops)
    port_vae.use_slicing = False
    port_vae.disable_tiling()
    key = json.dumps(tops, sort_keys=True)
    if key not in _JAX_VAES:
        _JAX_VAES[key] = JVAE(JCfg(**TINY), jax.tree.map(jnp.asarray, params),
                              tops=None if tops is None else
                              JTOps.from_dict(tops))
    jvae = _JAX_VAES[key]
    jvae.disable_tiling()
    return jvae


def _close(out, ref, rel=1e-4):
    ref = np.asarray(ref)
    assert tuple(out.shape) == ref.shape
    np.testing.assert_allclose(out.detach().numpy(), ref,
                               atol=rel * np.abs(ref).max(), rtol=rel)


def _video(shape, seed):
    return np.random.default_rng(seed).standard_normal(shape).astype(
        np.float32)


def _tops(down=(), mid_enc=None, up=(), mid_dec=None):
    """A t-ops JSON dict for the tiny VAE (1 resnet a down block, 2 an up
    block), in the t_ops_config.json schema."""
    def pool(k, s, before, after, **extra):
        return {"pool_t_kernel": k, "pool_t_stride": s,
                "enable_t_pool_before_block": before,
                "enable_t_pool_after_block": after, **extra}

    enc = {"down_blocks": [pool(*d[:4], **d[4]) if d else None
                           for d in down] if down else []}
    if mid_enc:
        enc["mid_block"] = pool(*mid_enc)
    dec = {"up_blocks": [{"interp_t_scale_factor": u[0],
                          "interp_mode": "nearest",
                          "enable_t_interp_before_block": u[1],
                          "enable_t_interp_after_block": u[2]} if u else None
                         for u in up]}
    if mid_dec:
        dec["mid_block"] = pool(*mid_dec)
    return {"encoder": enc, "decoder": dec}


# pool_before and interp_before share one config, each case checking only
# its own side; the forward and tiled cases reuse it, so that its compiled
# JAX encoder and decoder serve them all (a 9-frame clip is also the last
# encode tile of a tiled 33-frame one, a 3-frame latent the last decode
# tile)
POOL_INTERP_BEFORE = _tops(down=[(3, 2, [True], [False], {})],
                           up=[(2, [True, False], [False, False])])
HOOKS = {
    "pool_before": POOL_INTERP_BEFORE,
    "pool_after": _tops(down=[None, (2, 2, [False], [True], {})]),
    "mid_pool": _tops(mid_enc=(3, 2, [False, True], [False, False]),
                      mid_dec=(2, 2, [False, False], [True, False])),
    "stride_override": _tops(down=[(3, 2, [False], [False],
                                    {"downsample_stride": [2, 2, 2]}),
                                   (3, 2, [False], [False],
                                    {"downsample_stride": [4, 2, 2]})]),
    "interp_before": POOL_INTERP_BEFORE,
    "interp_after": _tops(up=[None, (2, [False, False], [False, True])]),
    "combined": _tops(down=[(3, 2, [True], [False], {}),
                            (2, 2, [False], [True],
                             {"downsample_stride": [1, 2, 2]})],
                      mid_enc=(2, 2, [True, False], [False, False]),
                      up=[(2, [False, True], [False, False]), None,
                          (3, [False, False], [True, False])],
                      mid_dec=(2, 2, [False, False], [False, True])),
}


def test_tops_json_matches_jax():
    """The repo's own t_ops_config.json parses to the same config."""
    path = str(ROOT / "t_ops_config.json")
    tops = TOpsConfig.from_json(path)
    assert dataclasses.asdict(tops) == dataclasses.asdict(
        JTOps.from_json(path))
    assert len(tops.down_blocks) == 4 and tops.down(1).downsample_stride \
        == (2, 2, 2) and tops.up(4) is None
    hash(tops)


@pytest.mark.parametrize("mode", ["pool", "stride", "stride2"])
def test_tops_from_dict_matches_jax(mode):
    for raw in enumerate_configs(mode, cap=12):
        assert dataclasses.asdict(TOpsConfig.from_dict(raw)) == \
            dataclasses.asdict(JTOps.from_dict(raw))
    assert TOpsConfig.from_dict({}) == TOpsConfig()
    assert TOpsConfig.from_dict(HOOKS["combined"]).down(0) == DownBlockTOps(
        3, 2, (True,), (False,))
    assert TOpsConfig.from_dict(HOOKS["mid_pool"]).encoder_mid_block == \
        MidBlockTOps(3, 2, (False, True), (False, False))
    assert TOpsConfig.from_dict(HOOKS["interp_after"]).up(1) == UpBlockTOps(
        2, "nearest", (False, False), (False, True))


# the side(s) each config changes; without hooks a side is the plain
# forward that test_torch_vae.py holds to JAX
SIDES = {"pool_before": "encode", "pool_after": "encode",
         "mid_pool": "encode decode", "stride_override": "encode",
         "interp_before": "decode", "interp_after": "decode",
         "combined": "encode decode"}


@pytest.mark.parametrize("hook", list(HOOKS))
def test_tops_hooks_match_jax(params, port_vae, hook):
    """The encoder and the decoder under each hook against JAX's
    encoder_forward / decoder_forward with the same config."""
    jvae = _pair(params, port_vae, HOOKS[hook])
    if "encode" in SIDES[hook]:
        x = _video((1, 3, 9, 16, 16), 1)
        _close(port_vae.encode_moments(torch.from_numpy(x)),
               jvae.encode_moments(jnp.asarray(x)))
    if "decode" in SIDES[hook]:
        z = _video((1, 4, 3, 2, 2), 2)
        _close(port_vae.decode(torch.from_numpy(z)),
               jvae.decode(jnp.asarray(z)))


def test_forward_and_posterior_match_jax(params, port_vae):
    """forward (the posterior's mode, return_posterior) against JAX
    __call__, kl (to N(0, I) and to another posterior) and nll; a sample
    needs a generator."""
    jvae = _pair(params, port_vae, POOL_INTERP_BEFORE)
    x = _video((1, 3, 9, 16, 16), 3)
    jdec, jpost = jvae(jnp.asarray(x), return_posterior=True)
    dec, post = port_vae(torch.from_numpy(x), return_posterior=True)
    _close(dec, jdec)
    _close(post.mean, jpost.mean)
    _close(post.kl(), jpost.kl())
    other = _video(tuple(jpost.mean.shape[:-1]) + (8,), 4)
    _close(post.kl(DiagonalGaussian(torch.from_numpy(other))),
           jpost.kl(JGaussian(jnp.asarray(other))))
    sample = _video(tuple(jpost.mean.shape), 5)
    _close(post.nll(torch.from_numpy(sample)),
           jpost.nll(jnp.asarray(sample)))
    with pytest.raises(ValueError, match="Generator"):
        port_vae(torch.from_numpy(x), sample_posterior=True)
    drawn = port_vae(torch.from_numpy(x), sample_posterior=True,
                     generator=torch.Generator().manual_seed(0))
    assert drawn.shape == dec.shape and not torch.equal(drawn, dec)


def test_sliced_matches_unsliced(params, port_vae):
    _pair(params, port_vae, HOOKS["combined"])
    x = torch.from_numpy(_video((2, 3, 5, 16, 16), 6))
    whole = port_vae(x)
    port_vae.enable_slicing()
    sliced = port_vae(x)
    port_vae.enable_slicing(False)
    _close(sliced, whole.numpy())


def test_tiled_round_trip_under_tops_matches_jax(params, port_vae):
    """Tiling under a pooling + interpolation config: the temporal tiles
    assume the x4 temporal ratio the config breaks, and the port gives what
    JAX gives (spatial tiling is untouched by t-ops; test_torch_vae.py
    holds it to JAX)."""
    jvae = _pair(params, port_vae, POOL_INTERP_BEFORE)
    jvae.enable_tiling()
    port_vae.enable_tiling()
    x = _video((1, 3, 33, 16, 16), 7)
    ref = jvae(jnp.asarray(x))
    out = port_vae(torch.from_numpy(x))
    port_vae.disable_tiling()
    _close(out, ref)


def test_vae_config_from_json(tmp_path):
    path = tmp_path / "config.json"
    path.write_text(json.dumps({"_class_name": "AutoencoderKLCausal3D",
                                "block_out_channels": [32, 64],
                                "latent_channels": 8}))
    assert dataclasses.asdict(VAEConfig.from_json(str(path))) == \
        dataclasses.asdict(JCfg.from_json(str(path)))
