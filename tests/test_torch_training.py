"""The port's train steps (training.py) and `train` entry against the JAX
package's (1, 1, 1)-mesh steps on the CPU.

Both sides start from the same weights (init_dit_params with the
zero-initialized layers randomized, through utils/weights.py) and see the
same latents, noise and t (numpy draws from a seed), fp32, attn_mode
"sdpa". Tolerances: losses rtol 1e-4; parameters, Adam moments and EMA atol
1e-5 after 3 steps (fp32 sums in other orders, and optax's update order).
The AdamW comparison runs at lr 1e-3: Adam's first steps move an element by
about lr whatever its gradient's size, so an element whose gradient is
mostly cancellation carries its relative error (~1e-3) times lr.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from hunyuanvideo_efficiency_tpu.models.dit import init_dit_params
from hunyuanvideo_efficiency_tpu.models.dit_config import DiTConfig as JCfg
from hunyuanvideo_efficiency_tpu.ops.rope import (
    get_nd_rotary_pos_embed as jax_rope)
from hunyuanvideo_efficiency_tpu.parallel import ParallelConfig, make_mesh
from hunyuanvideo_efficiency_tpu.training import (make_sp_train_step,
                                                  make_sp_train_step_optax)
from hunyuanvideo_efficiency_tpu_torch import train as train_cli
from hunyuanvideo_efficiency_tpu_torch.data.dataset_loader import (
    VideoTensorDataset, save_tensor)
from hunyuanvideo_efficiency_tpu_torch.models.dit import HYVideoDiT, build_dit
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.ops.quantization import quantize_dit
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from hunyuanvideo_efficiency_tpu_torch.training import (make_train_step,
                                                        make_train_step_adamw)
from hunyuanvideo_efficiency_tpu_torch.utils.checkpoint import (
    load_torch_state_dict)
from hunyuanvideo_efficiency_tpu_torch.utils.train_io import (load_tree,
                                                              save_tree)
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    dit_state_dict_from_jax)

# TINY of tests/test_training.py
TINY = dict(hidden_size=64, heads_num=4, mm_double_blocks_depth=1,
            mm_single_blocks_depth=1, rope_dim_list=(4, 6, 6),
            text_states_dim=32, text_states_dim_2=16, guidance_embed=True,
            attn_mode="sdpa")
GRID = (3, 4, 3)


def _data(b=2, seed=0):
    rng = np.random.default_rng(seed)
    x0 = rng.standard_normal((b, 16, 3, 8, 6)).astype(np.float32)
    noise = rng.standard_normal(x0.shape).astype(np.float32)
    t = np.full((b,), 0.5, np.float32)
    pe = rng.standard_normal((b, 8, 32)).astype(np.float32)
    mask = np.ones((b, 8), np.int32)
    pe2 = rng.standard_normal((b, 16)).astype(np.float32)
    return x0, noise, t, pe, mask, pe2


def _params(seed=1):
    """JAX init with every zero leaf (adaLN, final layer, biases) given
    random values: all gradients are non-zero from the first step."""
    rng = np.random.default_rng(seed)
    tree = init_dit_params(jax.random.PRNGKey(seed), JCfg(**TINY))
    return jax.tree.map(
        lambda a: (np.asarray(a, np.float32) if np.any(np.asarray(a))
                   else rng.standard_normal(np.shape(a)).astype(np.float32)
                   * 0.05), tree)


def _model(params, dtype=torch.float32):
    cfg = DiTConfig(**TINY)
    model = HYVideoDiT(cfg)
    model.load_state_dict(dit_state_dict_from_jax(params, cfg))
    return model.to(dtype).eval()


def _jax_side():
    pcfg = ParallelConfig(1, 1, 1)
    jc, js = jax_rope(TINY["rope_dim_list"], GRID, theta=256.0)
    d = jc.shape[-1]
    return (make_mesh(pcfg), pcfg, jc.reshape(*GRID, d),
            js.reshape(*GRID, d))


def _torch_rope():
    tc, ts = get_nd_rotary_pos_embed(TINY["rope_dim_list"], GRID,
                                     theta=256.0, device="cpu")
    d = tc.shape[-1]
    return tc.reshape(*GRID, d), ts.reshape(*GRID, d)


def _assert_tree_close(sd, jax_tree, what, atol=1e-5):
    want = dit_state_dict_from_jax(
        jax.tree.map(lambda a: np.asarray(a, np.float32), jax_tree),
        DiTConfig(**TINY))
    assert set(want) == set(sd)
    for name, ref in want.items():
        np.testing.assert_allclose(
            sd[name].detach().float().numpy(), ref.numpy(), atol=atol,
            rtol=0, err_msg=f"{what}: {name}")


def test_sgd_steps_match_jax():
    params = _params()
    data = _data()
    mesh, pcfg, jcg, jsg = _jax_side()
    jstep = make_sp_train_step(mesh, JCfg(**TINY), pcfg, lr=0.05)
    jp = jax.tree.map(jnp.asarray, params)
    want = []
    for _ in range(3):
        jp, loss = jstep(jp, *map(jnp.asarray, data), jcg, jsg)
        want.append(float(loss))

    model = _model(params)
    step = make_train_step(model, lr=0.05)
    assert model.cfg.remat_blocks and model.double_blocks[0].cfg.remat_blocks
    tcg, tsg = _torch_rope()
    got = [float(step(*map(torch.from_numpy, data), tcg, tsg))
           for _ in range(3)]
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[2] < got[1] < got[0]
    _assert_tree_close(model.state_dict(), jp, "params")
    assert all(p.grad is None for p in model.parameters())


def test_adamw_ema_steps_match_jax():
    params = _params()
    data = _data()
    mesh, pcfg, jcg, jsg = _jax_side()
    optimizer = optax.chain(optax.clip_by_global_norm(1.0),
                            optax.adamw(1e-3, weight_decay=1e-4))
    jstep, jinit = make_sp_train_step_optax(mesh, JCfg(**TINY), pcfg,
                                            optimizer, ema_decay=0.5)
    jp = jax.tree.map(jnp.asarray, params)
    jstate = jinit(jp)
    want = []
    for _ in range(3):
        jp, jstate, loss = jstep(jp, jstate, *map(jnp.asarray, data), jcg,
                                 jsg)
        want.append(float(loss))

    model = _model(params)
    step, init_fn = make_train_step_adamw(model, lr=1e-3, weight_decay=1e-4,
                                          grad_clip=1.0, ema_decay=0.5)
    state = init_fn()
    assert state["master"] is None      # fp32 parameters need no master
    tcg, tsg = _torch_rope()
    got = []
    for _ in range(3):
        state, loss = step(state, *map(torch.from_numpy, data), tcg, tsg)
        got.append(float(loss))
    np.testing.assert_allclose(got, want, rtol=1e-4)
    assert got[-1] < got[0]
    assert state["step"] == 3 == int(jstate["step"])
    adam = jstate["opt_state"][1][0]
    assert int(adam.count) == state["opt_state"]["count"] == 3
    _assert_tree_close(model.state_dict(), jp, "params")
    _assert_tree_close(state["ema"], jstate["ema"], "ema")
    _assert_tree_close(state["opt_state"]["mu"], adam.mu, "mu", atol=1e-6)
    _assert_tree_close(state["opt_state"]["nu"], adam.nu, "nu", atol=1e-6)
    # the EMA trails the live parameters
    sd = model.state_dict()
    assert max(float((sd[n] - e).abs().max())
               for n, e in state["ema"].items()) > 1e-6


def test_clip_is_optax_form():
    """Below the threshold the gradients pass unscaled, above it they are
    scaled by max_norm / norm: one step with a huge and one with a tiny
    threshold differ, and the huge one equals no clipping."""
    data = [torch.from_numpy(x) for x in _data()]
    tcg, tsg = _torch_rope()
    after = {}
    for clip in (None, 1e9, 1e-3):
        model = _model(_params())
        step, init_fn = make_train_step_adamw(model, lr=1e-2, grad_clip=clip,
                                              ema_decay=None)
        state, _ = step(init_fn(), *data, tcg, tsg)
        assert state["ema"] is None
        after[clip] = (model.state_dict(), state["opt_state"]["mu"])
    for n, p in after[None][0].items():
        torch.testing.assert_close(after[1e9][0][n], p, rtol=0, atol=0)
    name = "double_blocks.0.img_attn_qkv.weight"
    ratio = (after[1e-3][1][name].norm() / after[None][1][name].norm())
    assert 0 < float(ratio) < 0.1


def test_bf16_params_train_via_fp32_master():
    """bf16 parameters and a tiny lr: the fp32 master accumulates drift
    below bf16's resolution, and the parameters are the master's bf16
    rounding bit for bit (JAX test of the same name)."""
    model = _model(_params(), torch.bfloat16)
    step, init_fn = make_train_step_adamw(model, lr=1e-5, ema_decay=0.99)
    state = init_fn()
    assert state["master"] is not None
    assert all(m.dtype == torch.float32 for m in state["master"].values())
    m0 = {n: m.clone() for n, m in state["master"].items()}
    data = [torch.from_numpy(x) for x in _data()]
    tcg, tsg = _torch_rope()
    for _ in range(4):
        state, loss = step(state, *data, tcg, tsg)
    assert np.isfinite(float(loss)) and state["step"] == 4
    moved = [float((m - m0[n]).abs().max())
             for n, m in state["master"].items()]
    assert sum(mv > 0 for mv in moved) >= 0.5 * len(moved)
    assert max(float((m - m.bfloat16().float()).abs().max())
               for m in state["master"].values()) > 0.0
    for n, p in model.named_parameters():
        assert p.dtype == torch.bfloat16
        assert torch.equal(p.detach(), state["master"][n].bfloat16()), n
    assert all(torch.isfinite(e).all() for e in state["ema"].values())


def test_training_rejects_inference_only_models():
    model = _model(_params())
    with pytest.raises(NotImplementedError, match="flash_int8"):
        bad = _model(_params())
        bad.cfg = dataclasses.replace(bad.cfg, attn_mode="flash_int8")
        make_train_step(bad)
    frozen = _model(_params()).requires_grad_(False)
    with pytest.raises(ValueError, match="trainable"):
        make_train_step(frozen)
    quantize_dit(model, int8=True)
    with pytest.raises(NotImplementedError, match="inference only"):
        make_train_step_adamw(model)


def test_train_io_roundtrip(tmp_path):
    tree = {"a": {"w": torch.arange(6.0).reshape(2, 3)}, "count": 3,
            "none": None}
    save_tree(str(tmp_path / "sub" / "tree"), tree)
    back = load_tree(str(tmp_path / "sub" / "tree"))
    assert back["count"] == 3 and back["none"] is None
    assert torch.equal(back["a"]["w"], tree["a"]["w"])


def _toy_dataset(path, n=3):
    path.mkdir()
    rng = np.random.RandomState(0)
    for i in range(n):
        save_tensor(str(path / f"v{i}.pt"),
                    rng.randn(16, 3, 8, 6).astype(np.float32))


def test_dataset_loader(tmp_path):
    _toy_dataset(tmp_path / "data")
    (tmp_path / "data" / "notes.txt").write_text("ignored")
    ds = VideoTensorDataset(str(tmp_path / "data"))
    assert len(ds) == 3 and [name for _, name in ds] == ["v0.pt", "v1.pt",
                                                         "v2.pt"]
    x, _ = ds[1]
    assert x.shape == (16, 3, 8, 6) and x.dtype == torch.float32


def test_train_entry_saves_resumes_and_loads(tmp_path):
    """The `train` entry on a toy latent dataset: two steps and a
    checkpoint, a resumed third step, and `module`/`ema` read back through
    the sampler's loader into a DiT."""
    _toy_dataset(tmp_path / "data")
    out = tmp_path / "run"
    common = ["--data-dir", str(tmp_path / "data"), "--latents", "--toy",
              "--batch-size", "2", "--ema-decay", "0.9", "--lr", "1e-3",
              "--output-dir", str(out), "--seed", "3", "--device", "cpu"]
    losses = train_cli.main(common + ["--steps", "2", "--save-every", "2"])
    assert len(losses) == 2 and all(np.isfinite(losses))
    ck = out / "step_0000002"
    for name in ("module", "ema", "opt_state", "master", "meta.json"):
        assert (ck / name).exists(), name
    assert json.loads((ck / "meta.json").read_text())["step"] == 2

    more = train_cli.main(common + ["--steps", "3", "--save-every", "10",
                                    "--resume", str(ck)])
    assert len(more) == 1 and np.isfinite(more[0])
    assert (out / "step_0000003" / "module").exists()
    opt = load_tree(str(out / "step_0000003" / "opt_state"))
    assert opt["count"] == 3

    args = train_cli.parse_args(common)
    cfg = train_cli.build_cfg(args)
    module = load_torch_state_dict(ck / "module", "module")
    ema = load_torch_state_dict(ck / "ema", "ema")
    master = load_tree(str(ck / "master"))
    assert set(module) == set(ema) == set(master)
    model = build_dit(cfg, "cpu", torch.bfloat16)
    model.load_state_dict(module)
    name = "double_blocks.0.img_attn_qkv.weight"
    assert module[name].dtype == torch.bfloat16
    assert torch.equal(module[name], master[name].bfloat16())
    assert ema[name].dtype == torch.float32
    assert not torch.equal(ema[name], master[name])
    model.load_state_dict(ema)      # an fp32 set loads into the bf16 model


def test_train_entry_sgd_saves_module_only_and_resumes(tmp_path):
    """`--optimizer sgd` (bf16 weights and gradients, no optimizer state):
    the checkpoint holds `module` and `meta.json` only, a resumed run
    continues from it, and the loss on the one-sample dataset falls."""
    _toy_dataset(tmp_path / "data", n=1)
    out = tmp_path / "run"
    common = ["--data-dir", str(tmp_path / "data"), "--latents", "--toy",
              "--optimizer", "sgd", "--lr", "1e-2", "--output-dir", str(out),
              "--seed", "5", "--device", "cpu"]
    losses = train_cli.main(common + ["--steps", "2"])
    ck = out / "step_0000002"
    assert sorted(p.name for p in ck.iterdir()) == ["meta.json", "module"]
    meta = json.loads((ck / "meta.json").read_text())
    assert meta["step"] == 2 and meta["optimizer"] == "sgd"
    more = train_cli.main(common + ["--steps", "3", "--resume", str(ck)])
    assert len(losses) == 2 and len(more) == 1
    assert all(np.isfinite(losses + more))
    before = load_torch_state_dict(ck / "module", "module")
    after = load_torch_state_dict(out / "step_0000003" / "module", "module")
    name = "final_layer.linear.weight"    # the zero-initialized output layer
    assert before[name].dtype == torch.bfloat16
    assert before[name].abs().max() > 0
    assert not torch.equal(before[name], after[name])


def test_train_entry_blocks_cut_the_depth():
    args = train_cli.parse_args(["--data-dir", "x", "--blocks", "1", "2"])
    cfg = train_cli.build_cfg(args)
    full = train_cli.build_cfg(train_cli.parse_args(["--data-dir", "x"]))
    assert (cfg.mm_double_blocks_depth, cfg.mm_single_blocks_depth) == (1, 2)
    assert (full.mm_double_blocks_depth, full.mm_single_blocks_depth) == (20,
                                                                           40)
    assert cfg.hidden_size == full.hidden_size == 3072
    toy = train_cli.build_cfg(train_cli.parse_args(
        ["--data-dir", "x", "--toy", "--blocks", "1", "1"]))
    assert (toy.mm_double_blocks_depth, toy.mm_single_blocks_depth) == (1, 1)


def test_train_entry_flags():
    args = train_cli.parse_args(["--data-dir", "x"])
    assert args.device == "cuda" and args.model == "HYVideo-T/2-cfgdistill"
    assert args.optimizer == "adamw" and args.blocks is None
    train_cli.check_mesh_shape(None)
    train_cli.check_mesh_shape("dp:1,ulysses:1,ring:1")
    with pytest.raises(NotImplementedError, match="not ported"):
        train_cli.check_mesh_shape("dp:2,ulysses:2,ring:2")
    with pytest.raises(NotImplementedError, match="not ported"):
        train_cli.main(["--data-dir", "x", "--mesh-shape", "ulysses:4"])
