"""The port's sequence parallelism (parallel/, diffusion/pipeline.py
:_denoise_sharded) against the JAX package's single-device functions on
the CPU.

Every input and weight is made with numpy from a seed (the JAX
initializers' trees by `jax.eval_shape`, filled with fan-in scaled normals,
which costs no compile), the weights carried across by utils/weights.py;
one tiny DiT serves every model case, dense and under STA. Two gloo
worlds, of 2 and of 4 ranks, are spawned once for the module as processes that import
no JAX (tests/torch_sp_worker.py, one thread each); each runs every case of
its size and writes its ranks' outputs, which are put back together here by
the layout (dp outermost, then ulysses, then ring; ring-major token
blocks) and held against JAX computed in this process meanwhile:

* `usp_joint_attention` for (u, r) in (2, 1), (1, 2), (2, 2), (1, 4) in the
  flash, sdpa and STA modes (JAX tests/test_parallel.py:31, :217, :325;
  the ring x STA halo at r = 2 and 4) against JAX's single-device
  `joint_attention` (dense) and `sta_gathered_attention` (STA, the XLA form
  JAX holds its STA kernels to), to 1e-3; and the ring under "flash_int8"
  (int8 Q.K^T, a state a hop, the keys smoothed by the ring's one mean),
  running and static, against the same exact attention to JAX's own int8
  tolerance (max error 3e-2 of the output's scale, tests/test_flash_quant.py
  :273);
* the token-sharded DiT forward (:87), dense and under STA (the ring halo
  and Ulysses, :248, :276), against `dit_forward`; the denoise loop with
  CFG and guidance_rescale, dp = 2 among its layouts (:137), against
  `denoise_latents`; `predict` through the port's sampler (:406) against
  the JAX pipeline on the latents predict draws, also as serve.py runs it
  (rank 0 broadcasting the request, the other rank following), and with
  the stand-in tokenizer's per-process salted hash against rank 0 alone
  (every rank conditions on rank 0's text); all to 2e-3.

Plus the layout's arithmetic, `check_sp_compat`'s errors, the
`--mesh-shape` parse and `cfg_reorder_for_dp` against JAX.
"""
import concurrent.futures
import dataclasses
import functools
import json
import math
import os
import socket
import subprocess
import sys
import zlib
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from hunyuanvideo_efficiency_tpu.diffusion.pipeline import denoise_latents
from hunyuanvideo_efficiency_tpu.diffusion.scheduler import (
    get_sigmas as jax_sigmas)
from hunyuanvideo_efficiency_tpu.models.dit import dit_forward
from hunyuanvideo_efficiency_tpu.models.text import encoder as jax_encoder
from hunyuanvideo_efficiency_tpu.ops.attention import (
    joint_attention as jax_joint_attention, text_key_bias as jax_key_bias)
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu.ops.sta import sta_gathered_attention
from hunyuanvideo_efficiency_tpu.parallel import (
    ParallelConfig as JParallelConfig, cfg_reorder_for_dp as jax_reorder,
    check_sp_compat as jax_check_sp_compat)
from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs, parse_args
from hunyuanvideo_efficiency_tpu_torch.constants import NEGATIVE_PROMPT
from hunyuanvideo_efficiency_tpu_torch.models.dit import (patchify_raw,
                                                          unpatchify)
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.parallel import (
    ParallelConfig, cfg_reorder_for_dp, cfg_unreorder_for_dp,
    check_sp_compat, make_groups, parse_mesh_shape)
from test_torch_dit import TINY, dit_inputs
from test_torch_pipeline import CLIP, DIT, LLAMA, TPL, VAE, build_pipelines

WORKER = Path(__file__).with_name("torch_sp_worker.py")
ATTN_TOL, MODEL_TOL = 1e-3, 2e-3
INT8_TOL = 3e-2     # int8 Q.K^T against exact attention, relative to max
GRID, TILE, WINDOW = (8, 8, 6), (2, 4, 4), (3, 3, 3)   # attention cases
STA_GRID = (4, 8, 6)                                    # STA DiT cases
STA = dict(attn_mode="sta", sta_tile=TILE, sta_window=WINDOW)
PREDICT = dict(prompt="a cat walks", height=32, width=64, video_length=5,
               seed=11, infer_steps=2, guidance_scale=2.0, flow_shift=7.0,
               num_videos_per_prompt=2)


def _case(kind, world, dp, u, r, **kw):
    tag = "_".join(str(v) for v in kw.values() if isinstance(v, str))
    name = f"{kind}_dp{dp}u{u}r{r}" + (f"_{tag}" if tag else "")
    return dict(name=name, kind=kind, world=world, dp=dp, u=u, r=r, **kw)


CASES = (
    [_case("attn", w, 1, u, r, mode=m, grid=GRID, tile=TILE, window=WINDOW)
     for w, u, r in ((2, 2, 1), (2, 1, 2), (4, 2, 2), (4, 1, 4))
     for m in ("flash", "sdpa", "sta")]
    + [_case("attn", w, 1, u, r, mode="flash_int8", bound=bnd, grid=GRID,
             tile=TILE, window=WINDOW)
       for w, u, r, bnd in ((2, 1, 2, "running"), (2, 1, 2, "static"),
                            (4, 2, 2, "running"), (4, 1, 4, "static"))]
    + [_case("dit", w, dp, u, r, model="dense", grid=(3, 4, 3))
       for w, dp, u, r in ((2, 1, 1, 2), (4, 1, 2, 2), (4, 2, 1, 2))]
    + [_case("dit", w, 1, u, r, model="sta", grid=STA_GRID)
       for w, u, r in ((2, 1, 2), (4, 2, 2), (4, 4, 1))]
    + [_case("denoise", w, dp, u, r, steps=2, guidance_scale=6.0,
             guidance_rescale=0.7) for w, dp, u, r in ((2, 1, 1, 2),
                                                       (4, 2, 2, 1))]
    + [_case("predict", w, dp, u, r, predict=PREDICT)
       for w, dp, u, r in ((2, 1, 2, 1), (4, 2, 1, 2))]
    + [_case("serve", 2, 1, 1, 2, predict=PREDICT),
       _case("salted", 2, 1, 2, 1, predict=PREDICT)])


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _filled_init(fn, seed, *args):
    """fn's parameter tree (by jax.eval_shape) filled from numpy: norm
    scales 1, biases and embeddings N(0, 0.02), kernels N(0, 1/fan_in)
    (stacked [depth, in, out] kernels by their `in`)."""
    rng = np.random.default_rng(seed)
    tree = jax.eval_shape(functools.partial(fn, jax.random.PRNGKey(seed),
                                            *args))

    def leaf(path, a):
        name = path[-1].key
        if name == "scale":
            return np.ones(a.shape, np.float32)
        if name in ("bias", "embedding"):
            return (0.02 * rng.standard_normal(a.shape)).astype(np.float32)
        fan = a.shape[-2] if a.ndim == 3 else math.prod(a.shape[:-1])
        return (rng.standard_normal(a.shape) / math.sqrt(fan)).astype(
            np.float32)
    return jax.tree_util.tree_map_with_path(leaf, tree)


def _np_state(model):
    return {k: v.detach().clone() for k, v in model.state_dict().items()}


def _crc32(w):
    return zlib.crc32(w.encode())


@pytest.fixture(scope="module")
def sp_runs(tmp_path_factory):
    """Writes the inputs and weights, starts both worlds, computes the JAX
    references while they run; returns (references, outputs by world and
    rank)."""
    d = tmp_path_factory.mktemp("sp")
    rng = np.random.default_rng(0)
    inp, ref, models = {}, {}, {}
    b, s, h, hd, lt = 2, int(np.prod(GRID)), 4, 32, 16
    for n in ("q", "k", "v"):
        inp[f"attn_{n}"] = rng.standard_normal((b, s, h, hd), np.float32)
        inp[f"attn_t{n}"] = rng.standard_normal((b, lt, h, hd), np.float32)
    mask = (rng.random((b, lt)) > 0.4).astype(np.int32)
    mask[:, 0] = 1
    inp["attn_mask"] = mask

    jpipe, tpipe = build_pipelines(init=_filled_init)
    params, jcfg = jpipe.transformer_params, jpipe.transformer_cfg
    jax_models, spec = {}, {"cases": CASES}
    for m, over, grid, b_m in (("dense", dict(attn_mode="sdpa"),
                                (3, 8, 6), 2),
                               ("sta", STA, (4, 16, 12), 1)):
        x, t, txt, mask_m, txt2 = dit_inputs(4, b=b_m, grid=grid, cfg=DIT)
        sizes = (grid[0], grid[1] // 2, grid[2] // 2)
        cos, sin = jax_rope(jcfg.rope_dim_list, sizes, theta=jcfg.rope_theta)
        jax_models[m] = (dataclasses.replace(jcfg, **over), x, t, txt,
                         mask_m, txt2, cos, sin)
        inp.update({f"{m}_tokens": patchify_raw(
            torch.from_numpy(x), (1, 2, 2)).numpy(), f"{m}_t": t,
            f"{m}_txt": txt, f"{m}_mask": mask_m, f"{m}_txt2": txt2,
            f"{m}_cos": np.asarray(cos), f"{m}_sin": np.asarray(sin)})
    # the port runs "auto" (the flash path) where JAX runs sdpa
    spec.update(dit_dense=dict(DIT), dit_sta={**DIT, **STA},
                dit_pipe=dict(DIT), llama=LLAMA, clip=CLIP, vae=VAE,
                template=TPL)
    # the denoise loop: CFG batches [neg(2) | pos(2)]
    inp.update(den_x=rng.standard_normal((2, 16, 3, 8, 6), np.float32),
               den_txt=rng.standard_normal((4, 8, 64), np.float32),
               den_mask=np.ones((4, 8), np.int32),
               den_txt2=rng.standard_normal((4, 48), np.float32),
               den_cos=inp["dense_cos"], den_sin=inp["dense_sin"])
    inp["den_mask"][1, 5:] = 0
    models = {"dit": _np_state(tpipe.transformer),
              "llama": _np_state(tpipe.text_encoder.model),
              "clip": _np_state(tpipe.text_encoder_2.model),
              "vae": _np_state(tpipe.vae)}
    np.savez(d / "inputs.npz", **inp)
    torch.save(models, d / "models.pt")
    (d / "spec.json").write_text(json.dumps(spec))

    env = {**os.environ, "OMP_NUM_THREADS": "1"}
    procs = []
    for world in (2, 4):
        port = _free_port()
        procs += [(world, rank, subprocess.Popen(
            [sys.executable, str(WORKER), str(d), str(world), str(rank),
             str(port)], env=env, stdout=subprocess.PIPE,
            stderr=subprocess.STDOUT, text=True))
            for rank in range(world)]
    try:
        ref.update(_jax_references(inp, params, jax_models, jpipe))
        logs = {}
        for world, rank, p in procs:
            logs[(world, rank)] = p.communicate(timeout=600)[0]
    finally:
        for _, _, p in procs:
            p.kill()
    outs = {}
    for world, rank, p in procs:
        assert p.returncode == 0, logs[(world, rank)][-4000:]
        outs[(world, rank)] = dict(np.load(d / f"out_w{world}_r{rank}.npz"))
    return ref, outs


def _jax_references(inp, params, jax_models, jpipe):
    # the predict reference compiles in a thread of its own meanwhile
    with concurrent.futures.ThreadPoolExecutor(1) as pool:
        predicted = pool.submit(_predict_reference, jpipe)
        ref = _model_references(inp, params, jax_models)
        ref["predict"] = predicted.result()
    return ref


def _model_references(inp, params, jax_models):
    ref = {}
    j = {k: jnp.asarray(v) for k, v in inp.items()
         if k.startswith("attn_")}
    bias = jax_key_bias(j["attn_mask"])
    qkv = [j[f"attn_{n}"] for n in "qkv"] + [j[f"attn_t{n}"] for n in "qkv"]
    ref["attn_dense"] = [np.asarray(x) for x in jax_joint_attention(
        *qkv, bias, mode="sdpa")]
    ref["attn_sta"] = [np.asarray(x) for x in sta_gathered_attention(
        *qkv, bias, grid=GRID, tile=TILE, window=WINDOW)]
    forward = jax.jit(dit_forward, static_argnames=("cfg",))
    for m, (jcfg, *xs, cos, sin) in jax_models.items():
        ref[f"dit_{m}"] = np.asarray(forward(
            params, *map(jnp.asarray, xs), cos, sin, cfg=jcfg))
    jcfg = jax_models["dense"][0]
    sig, ts = jax_sigmas(2, shift=7.0)
    ref["denoise"] = np.asarray(denoise_latents(
        params, jnp.asarray(inp["den_x"]), jnp.asarray(sig), jnp.asarray(ts),
        jnp.asarray(inp["den_txt"]), jnp.asarray(inp["den_mask"]),
        jnp.asarray(inp["den_txt2"]), jnp.asarray(inp["den_cos"]),
        jnp.asarray(inp["den_sin"]), cfg=jcfg, do_cfg=True,
        guidance_scale=6.0, embedded_guidance_scale=None,
        guidance_rescale=0.7))
    return ref


def _predict_reference(jpipe):
    """The JAX pipeline on the latents predict draws (one generator a
    video, seeds 11, 12), the stand-in tokenizer hashing with crc32."""
    p = PREDICT
    shape = (16, (p["video_length"] - 1) // 4 + 1, p["height"] // 8,
             p["width"] // 8)
    latents = torch.stack([torch.randn(shape, generator=torch.Generator(
    ).manual_seed(p["seed"] + i)) for i in range(2)]).numpy()
    jax_encoder.hash = _crc32
    try:
        return np.asarray(jpipe(
            p["prompt"], height=p["height"], width=p["width"],
            video_length=p["video_length"],
            num_inference_steps=p["infer_steps"],
            guidance_scale=p["guidance_scale"],
            negative_prompt=NEGATIVE_PROMPT,
            num_videos_per_prompt=p["num_videos_per_prompt"],
            latents=jnp.asarray(latents),
            freqs_cis=jax_rope(DIT["rope_dim_list"], shape[1:2] + (
                shape[2] // 2, shape[3] // 2), theta=256.0),
            scan_denoise=True).videos)
    finally:
        del jax_encoder.hash


def _assemble(parts, pcfg, n_batch, n_tok):
    """Each rank's [B_loc, L_loc, ...] block into [B, L, ...]."""
    rows = []
    for d in range(pcfg.dp_degree):
        blocks = [None] * pcfg.sp_degree
        for i in range(pcfg.ulysses_degree):
            for j in range(pcfg.ring_degree):
                blocks[pcfg.token_block(i, j)] = parts[pcfg.rank_of(d, i, j)]
        rows.append(np.concatenate(blocks, axis=1))
    out = np.concatenate(rows, axis=0)
    assert out.shape[:2] == (n_batch, n_tok)
    return out


def _close(out, want, tol):
    np.testing.assert_allclose(out, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("case", CASES, ids=[c["name"] for c in CASES])
def test_sp_matches_single_device_jax(sp_runs, case):
    ref, outs = sp_runs
    w, name = case["world"], case["name"]
    pcfg = ParallelConfig(case["dp"], case["u"], case["r"])
    ranks = [outs[(w, k)] for k in range(w)]
    kind = case["kind"]
    if kind == "attn":
        want_img, want_txt = ref["attn_sta" if case["mode"] == "sta"
                                 else "attn_dense"]
        img = _assemble([o[f"{name}/img"] for o in ranks], pcfg,
                        *want_img.shape[:2])
        if case["mode"] == "flash_int8":
            for got in [img] + [o[f"{name}/txt"] for o in ranks]:
                want = want_img if got is img else want_txt
                err = np.abs(got - want).max() / np.abs(want).max()
                assert err < INT8_TOL, (name, err)
            return
        _close(img, want_img, ATTN_TOL)
        for o in ranks:
            _close(o[f"{name}/txt"], want_txt, ATTN_TOL)
    elif kind == "dit":
        want = ref[f"dit_{case['model']}"]
        tok = _assemble([o[f"{name}/tokens"] for o in ranks], pcfg,
                        want.shape[0], int(np.prod(case["grid"])))
        out = unpatchify(torch.from_numpy(tok), *case["grid"], 16,
                         (1, 2, 2)).numpy()
        assert np.abs(want).max() > 1e-2     # not the zero-init identity
        _close(out, want, MODEL_TOL)
    elif kind == "serve":   # rank 0 answered; the other ran in lockstep
        _close(ranks[0][f"{name}/samples"], ref["predict"], MODEL_TOL)
    elif kind == "salted":
        # each process salts the stand-in tokenizer's hash its own way;
        # every rank conditions on rank 0's text all the same
        for o in ranks:
            _close(o[f"{name}/samples"], ranks[0][f"{name}/single"],
                   MODEL_TOL)
    else:
        key = "latents" if kind == "denoise" else "samples"
        want = ref[kind]
        assert want.std() > 1e-3
        for o in ranks:    # every rank holds the whole result
            _close(o[f"{name}/{key}"], want, MODEL_TOL)


def test_layout_and_mesh_shape():
    """dp outermost, then ulysses, then ring (JAX mesh.py:66-68); token
    blocks ring-major; --mesh-shape with `sp` for ulysses."""
    pcfg = parse_mesh_shape("dp:2,sp:2,ring:2")
    assert pcfg == ParallelConfig(2, 2, 2)
    assert (pcfg.sp_degree, pcfg.world_size) == (4, 8)
    assert [pcfg.coords(k) for k in (0, 1, 2, 5, 7)] == [
        (0, 0, 0), (0, 0, 1), (0, 1, 0), (1, 0, 1), (1, 1, 1)]
    assert all(pcfg.rank_of(*pcfg.coords(k)) == k for k in range(8))
    # the u blocks of one ring index are adjacent: a contiguous t-slab
    assert [pcfg.token_block(i, j) for j in range(2) for i in range(2)] == [
        0, 1, 2, 3]
    with pytest.raises(ValueError, match="Unknown mesh axis"):
        parse_mesh_shape("tp:2")
    args = parse_args(["--mesh-shape", "dp:2,ulysses:2", "--ring-degree",
                       "4", "--profile-dir", "traces"])
    assert (args.mesh_shape, args.ring_degree, args.profile_dir) == (
        "dp:2,ulysses:2", 4, "traces")
    with pytest.raises(ValueError, match="not ported yet.*A5b"):
        parse_args(["--ulysses-degree", "2", "--shard-dit-weights"])
    with pytest.raises(RuntimeError, match="torchrun"):
        make_groups(ParallelConfig(ulysses_degree=2))


@pytest.mark.parametrize("dp,u,r,grid,batch,mode,match", [
    (1, 2, 2, (3, 3, 3), 1, "flash", "not divisible by the sequence"),
    (1, 3, 1, (3, 4, 6), 1, "flash", "heads_num"),
    (2, 1, 1, (3, 4, 6), 1, "flash", "dp degree"),
    (1, 1, 4, (4, 8, 6), 1, "sta", "halo"),
    (1, 1, 2, (6, 8, 6), 1, "sta", "halo"),
    (1, 2, 2, (8, 8, 6), 2, "sta", None),
])
def test_check_sp_compat_matches_jax(dp, u, r, grid, batch, mode, match):
    """The same shapes pass or fail with the same message as JAX's."""
    from hunyuanvideo_efficiency_tpu.models.dit_config import DiTConfig as J

    kw = dict(TINY, attn_mode=mode, sta_tile=TILE, sta_window=WINDOW)
    msgs = []
    for check, cfg, pc in ((check_sp_compat, DiTConfig(**kw),
                            ParallelConfig(dp, u, r)),
                           (jax_check_sp_compat, J(**kw),
                            JParallelConfig(dp, u, r))):
        try:
            check(cfg, pc, grid, batch)
            msgs.append(None)
        except ValueError as e:
            msgs.append(str(e))
    assert msgs[0] == msgs[1]
    assert (msgs[0] is None) == (match is None)
    if match:
        assert match in msgs[0]


@pytest.mark.parametrize("grid,r,warns", [
    ((16, 8, 6), 2, False),    # slab 8 planes, halos 2 x 2
    ((8, 8, 6), 2, True),      # slab 4 planes: the halos cover it
])
def test_ring_sta_halo_overlap_warns(grid, r, warns):
    """Ring x STA whose two halos are no smaller than a slab passes, with a
    warning that names the pure-Ulysses layout."""
    import warnings

    cfg = DiTConfig(**dict(TINY, attn_mode="sta", sta_tile=TILE,
                           sta_window=WINDOW))
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        check_sp_compat(cfg, ParallelConfig(1, 1, r), grid, 1)
    msgs = [str(w.message) for w in caught]
    assert any("pure-Ulysses" in m for m in msgs) == warns, msgs


def test_local_batch_slice_without_a_group():
    """One process: the whole batch is this rank's."""
    from hunyuanvideo_efficiency_tpu_torch.parallel import local_batch_slice

    assert local_batch_slice(6) == slice(0, 6)


def test_cfg_reorder_for_dp_matches_jax():
    x = np.arange(8 * 3).reshape(8, 3)   # [neg(4) | pos(4)], dp = 2
    y = cfg_reorder_for_dp(torch.from_numpy(x), 2)
    np.testing.assert_array_equal(y.numpy(), np.asarray(
        jax_reorder(jnp.asarray(x), 2)))
    np.testing.assert_array_equal(y[:, 0].numpy(),
                                  [0, 3, 12, 15, 6, 9, 18, 21])
    np.testing.assert_array_equal(cfg_unreorder_for_dp(y, 2).numpy(), x)
    assert cfg_reorder_for_dp(y, 1) is y
