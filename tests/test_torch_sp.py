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

Training (the same worlds, the same tiny DiT's weights): two steps of the
port's sharded SGD step (`make_train_step(sp=)`) at (dp, u, r) = (1,2,1),
(1,1,2), (2,1,1) on 2 ranks and (1,2,2), (1,1,4), (2,2,1) on 4 ranks under
"flash" with QK-norm (the ring's hops through `flash_attention_state`,
Ulysses through the flash VJP), "sdpa" and a model without QK-norm on a
ring (the plain recurrence), STA under Ulysses and the ring x STA halo,
and AdamW + EMA at (1,2,2), each against JAX's `make_sp_train_step` /
`make_sp_train_step_optax` on one device (which JAX's own
tests/test_training.py holds its sharded steps to; for STA the same SGD
step written around JAX's `dit_forward_tokens` with the grid, which JAX's
step does not pass): both losses and every parameter after two steps to
2e-3, for SGD also each tensor's update to 2e-3 of its own scale, every
rank's parameters equal to rank 0's bit for bit. Also each new collective's adjoint (<f(x), y> against
<x, f^T(y)> summed over the ranks), `train.main` over (1,2,1) with a
resume against the one-rank CLI, and `local_batch_slice` (by global rank)
against the loader's `batch_range` (by dp index) on (1,2,1).

The memory tiers (the same worlds): the weight-sharded DiT
(`parallel/weight_shard.py` over the sp group) forward at (u, r) = (2, 1),
(1, 2) on 2 ranks and (2, 2), (4, 1) on 4, with the 2-step denoise, under
STA at (2, 2) and in int8 at (1, 2), each equal bit for bit to the same
layout with replicated weights (in the worker) and held to JAX's
`dit_forward` / `denoise_latents` (int8: JAX's int8 DiT, 2e-3 of the output
scale), one gather a chunk a dtype; the tensor-parallel Llama tower over 2
and 4 ranks, fp32 within 1e-4 of JAX's one-device `llama_encode` (JAX's own
sharded test holds 2e-5), int8 equal to the one-rank int8 tower bit for
bit and within 2e-3 of the output scale of JAX's int8 encode, and under the
salted stand-in tokenizer every rank encoding rank 0's tokens; the
tile-sharded VAE decode and encode over 2 and 4 ranks equal to rank 0's
one-rank tiled calls bit for bit and within 1e-4 of the output scale of
JAX's mesh VAE (tests/test_torch_vae.py's tolerance: JAX's own 1e-5 holds
JAX against itself); `predict` at (1, 2, 2) with all three tiers against the
JAX pipeline with a tiled decode (2e-3); `infer.main --data-parallel` on 2
ranks against the one-rank entry (bit for bit, rank 0 alone writing). The
tower under test divides 2 and 4 (8 query and 4 key-value heads, the
tensor-parallel split's rule): the predict cases use it too, since every
world larger than 1 now runs the tower tensor-parallel.

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
import optax
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.diffusion.pipeline import denoise_latents
from hunyuanvideo_efficiency_tpu.diffusion.scheduler import (
    get_sigmas as jax_sigmas)
from hunyuanvideo_efficiency_tpu.models.dit import (
    dit_forward, dit_forward_tokens as jax_forward_tokens,
    patchify_raw as jax_patchify)
from hunyuanvideo_efficiency_tpu.models.dit_config import DiTConfig as JCfg
from hunyuanvideo_efficiency_tpu.models.text import encoder as jax_encoder
from hunyuanvideo_efficiency_tpu.models.text import (
    LlamaConfig as JLlamaCfg, llama_encode)
from hunyuanvideo_efficiency_tpu.models.text.llama import (
    quantize_llama_params_int8)
from hunyuanvideo_efficiency_tpu.models.vae import AutoencoderKLCausal3D as JVAE
from hunyuanvideo_efficiency_tpu.models.vae_config import VAEConfig as JVAECfg
from hunyuanvideo_efficiency_tpu.ops import quantization as jq
from hunyuanvideo_efficiency_tpu.ops.attention import (
    joint_attention as jax_joint_attention, text_key_bias as jax_key_bias)
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu.ops.sta import sta_gathered_attention
from hunyuanvideo_efficiency_tpu.parallel import (
    ParallelConfig as JParallelConfig, cfg_reorder_for_dp as jax_reorder,
    check_sp_compat as jax_check_sp_compat, make_mesh)
from hunyuanvideo_efficiency_tpu.training import (make_sp_train_step,
                                                  make_sp_train_step_optax)
from hunyuanvideo_efficiency_tpu_torch import infer as infer_cli
from hunyuanvideo_efficiency_tpu_torch import train as train_cli
from hunyuanvideo_efficiency_tpu_torch.data.dataset_loader import save_tensor
from hunyuanvideo_efficiency_tpu_torch.config import InferenceArgs, parse_args
from hunyuanvideo_efficiency_tpu_torch.constants import NEGATIVE_PROMPT
from hunyuanvideo_efficiency_tpu_torch.models.dit import (patchify_raw,
                                                          unpatchify)
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (VAE_CONFIGS,
                                                                 VAEConfig)
from hunyuanvideo_efficiency_tpu_torch.parallel import (
    ParallelConfig, cfg_reorder_for_dp, cfg_unreorder_for_dp,
    check_sp_compat, make_groups, parse_mesh_shape)
from test_torch_dit import TINY, dit_inputs
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    dit_state_dict_from_jax)
from test_torch_memory_tiers import LLAMA_TP, VAE_SMALL
from test_torch_pipeline import CLIP, DIT, TPL, VAE, build_pipelines

WORKER = Path(__file__).with_name("torch_sp_worker.py")
ATTN_TOL, MODEL_TOL = 1e-3, 2e-3
INT8_TOL = 3e-2     # int8 Q.K^T against exact attention, relative to max
GRID, TILE, WINDOW = (8, 8, 6), (2, 4, 4), (3, 3, 3)   # attention cases
STA_GRID = (4, 8, 6)                                    # STA DiT cases
STA = dict(attn_mode="sta", sta_tile=TILE, sta_window=WINDOW)
PREDICT = dict(prompt="a cat walks", height=32, width=64, video_length=5,
               seed=11, infer_steps=2, guidance_scale=2.0, flow_shift=7.0,
               num_videos_per_prompt=2)
TRAIN_GRID = (3, 4, 4)          # the dense train cases' patch grid, B = 2
SGD = dict(lr=0.05)
ADAMW = dict(lr=1e-3, weight_decay=1e-4, grad_clip=1.0, ema_decay=0.5)
CLI_ARGV = ["--toy", "--latents", "--device", "cpu", "--lr", "1e-3",
            "--seed", "3", "--ema-decay", "0.9", "--batch-size", "2"]
WSHARD_DENOISE = dict(steps=2, guidance_scale=6.0, guidance_rescale=0.7)
INT8_LIN_TOL = 2e-3  # int8 linears against JAX's (test_torch_quant_dit)
TP_TOL = 1e-4       # the fp32 tensor-parallel tower against JAX's
# the port's VAE against JAX's (tests/test_torch_vae.py): JAX's own 1e-5
# (tests/test_vae.py:141-170) holds its mesh VAE to its one-device VAE, and
# the port's one-rank decode already differs from JAX's by up to 1.2e-5 in
# a few elements (fp32 sums in other orders)
VAE_TOL = 1e-4


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
       _case("salted", 2, 1, 2, 1, predict=PREDICT)]
    + [_case("train", w, dp, u, r, model="flash", opt=SGD, steps=2)
       for w, dp, u, r in ((2, 1, 2, 1), (2, 1, 1, 2), (2, 2, 1, 1),
                           (4, 1, 2, 2), (4, 1, 1, 4), (4, 2, 2, 1))]
    + [_case("train", w, 1, u, r, model=m, opt=SGD, steps=2)
       for w, u, r, m in ((2, 1, 2, "sdpa"), (4, 2, 2, "sdpa"),
                          (4, 2, 2, "noqk"), (2, 2, 1, "sta"),
                          (2, 1, 2, "sta"))]
    + [_case("train", 4, 1, 2, 2, model="flash", optimizer="adamw",
             opt=ADAMW, steps=2),
       _case("adjoint", 2, 1, 1, 2), _case("adjoint", 4, 1, 2, 2),
       _case("adjoint", 4, 1, 1, 4),
       _case("cli", 2, 1, 2, 1,
             argv=CLI_ARGV + ["--mesh-shape", "dp:1,ulysses:2,ring:1"]),
       _case("batch_slice", 2, 1, 2, 1, batch=2)]
    + [_case("wshard", w, 1, u, r, model="dense", grid=(3, 4, 3),
             **WSHARD_DENOISE)
       for w, u, r in ((2, 2, 1), (2, 1, 2), (4, 2, 2), (4, 4, 1))]
    + [_case("wshard", 4, 1, 2, 2, model="sta", grid=STA_GRID),
       _case("wshard", 2, 1, 1, 2, model="int8", grid=(3, 4, 3))]
    + [_case("tp", w, 1, w, 1) for w in (2, 4)]
    + [_case("tiles", w, 1, w, 1) for w in (2, 4)]
    + [_case("tiers", 4, 1, 2, 2, predict=PREDICT),
       _case("infer", 2, 1, 2, 1, vae=VAE_SMALL)])


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

    jpipe, tpipe = build_pipelines(init=_filled_init, llama=LLAMA_TP)
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
                dit_pipe=dict(DIT), llama=LLAMA_TP, clip=CLIP, vae=VAE,
                vae_small=VAE_SMALL, template=TPL)
    # the memory tiers: token ids for the tower, a latent and a video for
    # the tiled VAE, a video for the infer entry
    ids = rng.integers(2, LLAMA_TP["vocab_size"] - 1, (2, 12))
    tp_mask = np.ones((2, 12), np.int32)
    tp_mask[1, 7:] = 0
    inp.update(tp_ids=ids.astype(np.int32), tp_mask=tp_mask,
               tile_z=(0.5 * rng.standard_normal((1, 16, 2, 5, 5))).astype(
                   np.float32),
               tile_x=rng.uniform(-1, 1, (1, 3, 5, 48, 48)).astype(
                   np.float32))
    (d / "infer_data").mkdir()
    torch.save(torch.from_numpy(rng.uniform(-1, 1, (3, 5, 48, 48)).astype(
        np.float32)), d / "infer_data" / "clip.pt")
    # the denoise loop: CFG batches [neg(2) | pos(2)]
    inp.update(den_x=rng.standard_normal((2, 16, 3, 8, 6), np.float32),
               den_txt=rng.standard_normal((4, 8, 64), np.float32),
               den_mask=np.ones((4, 8), np.int32),
               den_txt2=rng.standard_normal((4, 48), np.float32),
               den_cos=inp["dense_cos"], den_sin=inp["dense_sin"])
    inp["den_mask"][1, 5:] = 0
    # training: the dense cases' batch (B = 2, dp up to 2) and the STA
    # cases' (B = 1)
    for tag, grid, b_t in (("tdense", TRAIN_GRID, 2), ("tsta", STA_GRID, 1)):
        x0, _, txt, mask_t, txt2 = dit_inputs(
            7, b=b_t, grid=(grid[0], 2 * grid[1], 2 * grid[2]), cfg=DIT)
        cos, sin = (np.asarray(a).reshape(*grid, -1) for a in jax_rope(
            DIT["rope_dim_list"], grid, theta=256.0))
        inp.update({f"{tag}_x0": x0, f"{tag}_noise": rng.standard_normal(
            x0.shape).astype(np.float32), f"{tag}_t": np.array(
            [0.3, 0.8][:b_t], np.float32), f"{tag}_pe": txt,
            f"{tag}_mask": mask_t, f"{tag}_pe2": txt2, f"{tag}_cos": cos,
            f"{tag}_sin": sin})
    spec.update(train_flash={**DIT, "attn_mode": "flash"},
                train_sdpa={**DIT, "attn_mode": "sdpa"},
                train_noqk={**DIT, "attn_mode": "flash", "qk_norm": False},
                train_sta={**DIT, **STA})
    (d / "cli_data").mkdir()
    for i in range(3):
        save_tensor(str(d / "cli_data" / f"v{i}.pt"),
                    rng.standard_normal((16, 3, 8, 6)).astype(np.float32))
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
    ref["case_dir"] = d
    ref["init"] = {k: v.numpy() for k, v in models["dit"].items()}
    return ref, outs


def _jax_references(inp, params, jax_models, jpipe):
    # the predict and the train references compile in threads meanwhile
    with concurrent.futures.ThreadPoolExecutor(3) as pool:
        predicted = pool.submit(_predict_reference, jpipe)
        trained = {f"train_{key}": pool.submit(
            _train_reference, key, over, tag, inp, params)
            for key, over, tag in TRAIN_MODELS}
        tiers = pool.submit(_tier_references, inp, jpipe)
        ref = _model_references(inp, params, jax_models)
        ref.update(predicted.result())
        ref.update({k: f.result() for k, f in trained.items()})
        ref.update(tiers.result())
    return ref


def _tier_references(inp, jpipe):
    """JAX's one-device Llama encode of the tower under test, fp32 and
    int8, and its mesh VAE (4 devices) tiling the tile cases' latent and
    video."""
    lcfg = JLlamaCfg(**LLAMA_TP)
    lp = jpipe.text_encoder.params
    ids, mask = jnp.asarray(inp["tp_ids"]), jnp.asarray(inp["tp_mask"])
    ref = {f"tp_{name}": np.asarray(llama_encode(
        p, ids, mask, lcfg, hidden_state_skip_layer=1, dtype=jnp.float32))
        for name, p in (("fp32", lp),
                        ("int8", quantize_llama_params_int8(lp)))}
    vae = JVAE(JVAECfg(**VAE_SMALL), jpipe.vae.params,
               mesh=make_mesh(JParallelConfig(1, 4, 1)))
    vae.enable_spatial_tiling(True)
    ref["tile_dec"] = np.asarray(vae.decode(jnp.asarray(inp["tile_z"])))
    ref["tile_enc"] = np.asarray(vae.encode_moments(
        jnp.asarray(inp["tile_x"])))
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
    jcfg, *xs, cos, sin = jax_models["dense"]
    ref["dit_int8"] = np.asarray(forward(
        jq.quantize_dit_params_int8(params), *map(jnp.asarray, xs), cos,
        sin, cfg=jcfg))
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


TRAIN_MODELS = (("dense", dict(attn_mode="sdpa"), "tdense"),
                ("noqk", dict(attn_mode="sdpa", qk_norm=False), "tdense"),
                ("sta", STA, "tsta"),
                ("adamw", dict(attn_mode="sdpa"), "tdense"))


def _train_reference(key, over, tag, inp, params):
    """JAX's sharded step on one device for one model: the losses of two
    steps and the parameters after them (the port's names)."""
    pcfg = JParallelConfig(1, 1, 1)
    mesh = make_mesh(pcfg)
    jcfg = JCfg(**{**DIT, **over})
    data = [jnp.asarray(inp[f"{tag}_{n}"]) for n in (
        "x0", "noise", "t", "pe", "mask", "pe2", "cos", "sin")]
    jp, losses = params, []
    if key == "sta":
        for _ in range(2):
            jp, loss = _jax_sta_step(jp, *data, cfg=jcfg)
            losses.append(float(loss))
    elif key == "adamw":
        step, init = make_sp_train_step_optax(
            mesh, jcfg, pcfg, optax.chain(
                optax.clip_by_global_norm(ADAMW["grad_clip"]),
                optax.adamw(ADAMW["lr"], weight_decay=ADAMW["weight_decay"])),
            ema_decay=ADAMW["ema_decay"])
        state = init(jp)
        for _ in range(2):
            jp, state, loss = step(jp, state, *data)
            losses.append(float(loss))
    else:
        step = make_sp_train_step(mesh, jcfg, pcfg, lr=SGD["lr"])
        for _ in range(2):
            jp, loss = step(jp, *data)
            losses.append(float(loss))
    sd = dit_state_dict_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jp),
        DiTConfig(**DIT))
    return (np.array(losses, np.float32),
            {n: v.numpy() for n, v in sd.items()})


@functools.partial(jax.jit, static_argnames=("cfg",))
def _jax_sta_step(params, x0, noise, t, pe, mask, pe2, cos_g, sin_g, cfg):
    """`make_sp_train_step`'s one-device SGD step with the global patch
    grid reaching the blocks: JAX's flow_match_loss passes dit_forward_tokens
    no token_grid, so its step cannot run STA; the same loss and update,
    the grid given."""
    grid, d = cos_g.shape[:3], cos_g.shape[-1]

    def loss_fn(p):
        sigma = t[:, None, None]
        x0_t = jax_patchify(x0, cfg.patch_size)
        n_t = jax_patchify(noise, cfg.patch_size)
        v = jax_forward_tokens(p, (1.0 - sigma) * x0_t + sigma * n_t,
                               t * 1000.0, pe, mask, pe2,
                               cos_g.reshape(-1, d), sin_g.reshape(-1, d),
                               None, cfg=cfg, token_grid=grid)
        return jnp.mean((v - (n_t - x0_t)) ** 2)

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return jax.tree.map(lambda p, g: p - SGD["lr"] * g, params,
                        grads), loss


def _predict_reference(jpipe):
    """The JAX pipeline on the latents predict draws (one generator a
    video, seeds 11, 12), the stand-in tokenizer hashing with crc32; and
    again with the VAE of small tiles, tiling the decode."""
    p = PREDICT
    shape = (16, (p["video_length"] - 1) // 4 + 1, p["height"] // 8,
             p["width"] // 8)
    latents = torch.stack([torch.randn(shape, generator=torch.Generator(
    ).manual_seed(p["seed"] + i)) for i in range(2)]).numpy()
    jax_encoder.hash = _crc32
    vae = jpipe.vae

    def run(tiled):
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
            scan_denoise=True, enable_tiling=tiled).videos)
    try:
        out = {"predict": run(False)}
        jpipe.vae = JVAE(JVAECfg(**VAE_SMALL), vae.params)
        out["predict_tiled"] = run(True)
        return out
    finally:
        del jax_encoder.hash
        jpipe.vae = vae


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
    elif kind == "train":
        _check_train(ref, ranks, case)
    elif kind == "adjoint":
        names = [k.split("/", 1)[1] for k in ranks[0] if k.startswith(
            name + "/")]
        assert len(names) == (2 if case["u"] == 1 or case["r"] == 1 else 5)
        for n in names:
            for o in ranks:     # every rank holds the world's sums
                lhs, rhs = o[f"{name}/{n}"]
                np.testing.assert_allclose(lhs, rhs, rtol=1e-12,
                                           err_msg=n)
                assert abs(lhs) > 1e-3
    elif kind == "cli":
        _check_cli(ref["case_dir"], ranks, case)
    elif kind == "wshard":
        _check_wshard(ref, ranks, case, pcfg)
    elif kind == "tp":
        for o in ranks:
            _close_scaled(o[f"{name}/fp32"], ref["tp_fp32"], TP_TOL)
            assert o[f"{name}/int8_equal"] == 1.0
            _close_scaled(o[f"{name}/int8"], ref["tp_int8"], INT8_LIN_TOL)
            # one collective forward on rank 0's tokens, whatever each
            # process's salted hash gave it
            np.testing.assert_array_equal(o[f"{name}/salted"],
                                          ranks[0][f"{name}/salted"])
        _close_scaled(ranks[0][f"{name}/salted"],
                      ranks[0][f"{name}/salted_own"], 1e-5)
    elif kind == "tiles":
        for o in ranks:
            for key in ("dec", "enc"):
                np.testing.assert_array_equal(o[f"{name}/{key}"],
                                              ranks[0][f"{name}/one_{key}"])
                _close_scaled(o[f"{name}/{key}"], ref[f"tile_{key}"],
                              VAE_TOL)
    elif kind == "tiers":
        want = ref["predict_tiled"]
        assert want.std() > 1e-3
        assert not np.allclose(want, ref["predict"], atol=1e-3)
        for o in ranks:
            assert o[f"{name}/tiers_on"] == 1.0
            _close(o[f"{name}/samples"], want, MODEL_TOL)
    elif kind == "infer":
        _check_infer(ref["case_dir"], case)
    elif kind == "batch_slice":
        # local_batch_slice splits the batch by global rank, JAX's
        # per-process slice: under ulysses it would feed the two sp ranks
        # of one dp shard different rows; the loader's batch_range gives
        # both the dp shard's rows
        assert [tuple(o[f"{name}/local_batch_slice"]) for o in ranks] == [
            (0, 1), (1, 2)]
        assert [tuple(o[f"{name}/batch_range"]) for o in ranks] == [
            (0, 2), (0, 2)]
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


def _check_train(ref, ranks, case):
    """Both steps' world-mean losses on every rank and rank 0's parameters
    against JAX's one-device step, to MODEL_TOL; every rank's parameters
    equal rank 0's bit for bit; the steps moved the parameters."""
    name = case["name"]
    key = {"flash": "dense", "sdpa": "dense"}.get(case["model"],
                                                  case["model"])
    adam = case.get("optimizer") == "adamw"
    if adam:
        key = "adamw"
    losses, want = ref[f"train_{key}"]
    for o in ranks:
        _close(o[f"{name}/losses"], losses, MODEL_TOL)
        assert o[f"{name}/equal_to_rank0"] == 1.0
    moved = 0.0
    for n, w in want.items():
        got = ranks[0][f"{name}/param/{n}"]
        np.testing.assert_allclose(got, w, rtol=MODEL_TOL, atol=MODEL_TOL,
                                   err_msg=f"{name}: {n}")
        # SGD: the update itself (lr times the gradients), against the
        # scale of this tensor's update: the parameters alone hide a wrong
        # gradient of lr's size. (Adam's first steps move an element by
        # about lr whatever its gradient, so there it is held above.)
        step, step_want = got - ref["init"][n], w - ref["init"][n]
        scale = float(np.abs(step_want).max())
        assert adam or np.abs(step - step_want).max() <= (
            MODEL_TOL * scale + 1e-6), (
            name, n, float(np.abs(step - step_want).max()), scale)
        moved = max(moved, scale)
    assert moved > 1e-3


def _close_scaled(out, want, tol):
    """Within tol of want's scale, and tol relative."""
    scale = float(np.abs(want).max())
    assert scale > 1e-2
    np.testing.assert_allclose(out, want, rtol=tol, atol=tol * scale)


def _check_wshard(ref, ranks, case, pcfg):
    """The weight-sharded forward (and denoise) against JAX and, bit for
    bit, against the same layout with replicated weights; each rank a
    gather a chunk a dtype and its 1/sp of the stack bytes."""
    name, m = case["name"], case["model"]
    want = ref[f"dit_{m}"]
    tok = _assemble([o[f"{name}/tokens"] for o in ranks], pcfg,
                    want.shape[0], int(np.prod(case["grid"])))
    out = unpatchify(torch.from_numpy(tok), *case["grid"], 16,
                     (1, 2, 2)).numpy()
    if m == "int8":
        _close_scaled(out, want, INT8_LIN_TOL)
    else:
        _close(out, want, MODEL_TOL)
    sp = pcfg.sp_degree
    for o in ranks:
        assert o[f"{name}/equal"] == 1.0
        assert o[f"{name}/gathers"] == o[f"{name}/chunks_x_dtypes"] >= 2
        stack, shard = o[f"{name}/stack_bytes"], o[f"{name}/shard_bytes"]
        assert stack / sp <= shard < stack / sp + 64 * 256
        if case.get("steps"):
            assert o[f"{name}/equal_denoise"] == 1.0
            _close(o[f"{name}/latents"], ref["denoise"], MODEL_TOL)


def _check_infer(case_dir, case):
    """infer.main --data-parallel over 2 ranks wrote rank 0's
    reconstruction only, equal bit for bit to the one-rank entry's."""
    base = case_dir / case["name"]
    old = VAE_CONFIGS["884-16c-hy"]
    VAE_CONFIGS["884-16c-hy"] = VAEConfig(**{
        k: tuple(v) if isinstance(v, list) else v
        for k, v in case["vae"].items()})
    try:
        infer_cli.main(["--tensor-dir", str(case_dir / "infer_data"),
                        "--output-dir", str(base / "single"),
                        "--random-init", "--device", "cpu",
                        "--enable-tiling"])
    finally:
        VAE_CONFIGS["884-16c-hy"] = old
    want = torch.load(base / "single" / "clip.pt", weights_only=True)
    got = torch.load(base / "out_r0" / "clip.pt", weights_only=True)
    assert want.shape == (3, 5, 48, 48) and torch.equal(got, want)
    assert not (base / "out_r1").exists()


def _check_cli(case_dir, ranks, case):
    """`train.main` over the world: the losses of two steps and a resumed
    third against the one-rank CLI here, to MODEL_TOL; rank 0 alone wrote,
    one checkpoint directory a save."""
    base = case_dir / case["name"]
    single = base / "single"
    argv = CLI_ARGV + ["--data-dir", str(case_dir / "cli_data"),
                       "--output-dir", str(single)]
    want = train_cli.main(argv + ["--steps", "2"])
    want += train_cli.main(argv + ["--steps", "3", "--resume",
                                   str(single / "step_0000002")])
    for o in ranks:
        _close(o[f"{case['name']}/losses"], np.array(want, np.float32),
               MODEL_TOL)
    assert sorted(p.name for p in (base / "out_r0").iterdir()) == [
        "step_0000002", "step_0000003"]
    assert not (base / "out_r1").exists()


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
    assert parse_args(["--ulysses-degree", "2",
                       "--shard-dit-weights"]).shard_dit_weights
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
