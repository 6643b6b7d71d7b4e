"""The port's spans (utils/profiling.py) on the CPU: the shared no-op with
no profiler recording; under torch.profiler the log's names, parents, host
times and self times, `span_at`, and the log's bound; the span sites of a
tiny DiT forward (dense and the STA split path) and of a tiny VAE round
trip, counted as the benchmark's readers count them; the DiT rows a
denoise step counts; a `--profile-dir` trace holding a span's range."""
import json
import time

import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)
from torch.profiler import ProfilerActivity, profile

from hunyuanvideo_efficiency_tpu_torch.diffusion import pipeline
from hunyuanvideo_efficiency_tpu_torch.models.dit import build_dit
from hunyuanvideo_efficiency_tpu_torch.models.dit_config import DiTConfig
from hunyuanvideo_efficiency_tpu_torch.models.vae import build_vae
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import VAEConfig
from hunyuanvideo_efficiency_tpu_torch.ops.rope import get_nd_rotary_pos_embed
from hunyuanvideo_efficiency_tpu_torch.utils import profiling
from hunyuanvideo_efficiency_tpu_torch.utils.profiling import (
    clear_spans, maybe_trace, span, span_at, spans)

ALL = (0, 2 ** 63 - 1)


@pytest.fixture(autouse=True)
def empty_log():
    clear_spans()
    yield
    clear_spans()


def recording():
    return profile(activities=[ProfilerActivity.CPU])


def counts(recs):
    out = {}
    for r in recs:
        out[r.name] = out.get(r.name, 0) + 1
    return out


def test_off_is_one_shared_noop():
    assert not torch.autograd._profiler_enabled()
    a, b = span("a"), span("b")
    assert a is b
    with a, b:
        pass
    assert spans(*ALL) == []


def test_nested_spans_record_parent_times_and_self_time():
    t0 = time.time_ns()
    with recording():
        with span("outer"):
            time.sleep(0.01)
            with span("inner"):
                time.sleep(0.02)
            time.sleep(0.005)
        with span("after"):
            pass
    t1 = time.time_ns()
    recs = spans(*ALL)
    assert [r.name for r in recs] == ["outer", "inner", "after"]
    outer, inner, after = recs
    assert outer.parent is None and after.parent is None
    assert inner.parent is outer
    assert t0 <= outer.start_ns < inner.start_ns < inner.end_ns \
        < outer.end_ns <= after.start_ns <= after.end_ns <= t1
    # on the CPU the host times stand in for the device's
    assert outer.device_ms == pytest.approx(
        (outer.end_ns - outer.start_ns) / 1e6)
    assert inner.device_ms >= 20.0
    assert outer.self_device_ms == pytest.approx(
        outer.device_ms - inner.device_ms)
    assert inner.self_device_ms == pytest.approx(inner.device_ms)
    assert [r.name for r in spans(*ALL, name="inner")] == ["inner"]
    assert spans(inner.start_ns, inner.start_ns + 1) == [inner]
    assert spans(0, outer.start_ns) == []


def test_span_at_is_the_innermost_open_span():
    with recording():
        with span("outer"):
            with span("inner"):
                time.sleep(0.002)
            time.sleep(0.002)
        time.sleep(0.002)
        with span("next"):
            time.sleep(0.002)
    outer, inner, nxt = spans(*ALL)
    assert span_at((inner.start_ns + inner.end_ns) // 2) is inner
    assert span_at((inner.end_ns + outer.end_ns) // 2) is outer
    assert span_at((outer.end_ns + nxt.start_ns) // 2) is None
    assert span_at((nxt.start_ns + nxt.end_ns) // 2) is nxt
    assert span_at(outer.start_ns - 1) is None
    assert span_at(nxt.end_ns + 1) is None


def test_the_log_keeps_the_newest_spans_up_to_its_bound(monkeypatch):
    monkeypatch.setattr(profiling, "SPAN_LOG_LIMIT", 50)
    with recording():
        for i in range(120):
            with span(f"s{i}"):
                pass
    recs = spans(*ALL)
    assert len(recs) == 50
    assert [r.name for r in recs] == [f"s{i}" for i in range(70, 120)]


def tiny_dit(**kw):
    cfg = DiTConfig(hidden_size=64, heads_num=2, mm_double_blocks_depth=2,
                    mm_single_blocks_depth=2, rope_dim_list=(8, 12, 12),
                    text_states_dim=32, text_states_dim_2=24, **kw)
    return build_dit(cfg, "cpu", torch.float32,
                     generator=torch.Generator().manual_seed(0))


def dit_args(model, grid=(2, 4, 4), txt_len=6):
    cfg = model.cfg
    g = torch.Generator().manual_seed(1)
    t, h, w = grid
    x = torch.randn(1, cfg.in_channels, t, 2 * h, 2 * w, generator=g)
    mask = torch.ones(1, txt_len, dtype=torch.int64)
    mask[:, -2:] = 0
    cos, sin = get_nd_rotary_pos_embed(cfg.rope_dim_list, grid,
                                       theta=cfg.rope_theta, device="cpu")
    return (x, torch.tensor([500.0]),
            torch.randn(1, txt_len, cfg.text_states_dim, generator=g), mask,
            torch.randn(1, cfg.text_states_dim_2, generator=g), cos, sin)


# a forward of d double and s single blocks: 8 adaLN sites a double block,
# 2 a single block, 1 in the final layer; one QK-norm + RoPE and one joint
# attention a block
@pytest.mark.parametrize("mode", ["flash", "sta"])
def test_dit_forward_spans(mode):
    kw = dict(attn_mode=mode)
    if mode == "sta":       # image-only RoPE rows: the blocks' split path
        kw.update(sta_tile=(2, 2, 2), sta_window=(1, 3, 3))
    model = tiny_dit(**kw)
    args = dit_args(model)
    with torch.no_grad():
        want = model(*args)
        with recording():
            got = model(*args)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    c = counts(spans(*ALL))
    assert c["dit.embed"] == 1
    assert c["dit.adaln"] == 2 * 8 + 2 * 2 + 1
    assert c["dit.qk_rope"] == c["dit.attention"] == 4
    wrappers = {k: v for k, v in c.items() if not k.startswith("dit.")}
    if mode == "flash":
        assert wrappers == {"flash_static": 4}
    else:
        # each block's image queries, and its text queries' two flash
        # calls (over the image keys, then the text keys)
        assert wrappers == {"sta_direct": 4, "flash_static": 8}
    for r in spans(*ALL):
        if r.name in wrappers:
            assert r.parent.name == "dit.attention"
        else:
            assert r.parent is None
    attn = spans(*ALL, name="dit.attention")
    assert all(0.0 <= r.self_device_ms <= r.device_ms for r in attn)


@pytest.mark.parametrize("do_cfg", [False, True], ids=["distilled", "cfg"])
def test_denoise_step_counts_dit_rows(do_cfg):
    """denoise_step.LAUNCHES adds the DiT's batch rows: 1 a guidance-
    distilled step, 2 a CFG step; either is one forward, one dit.embed."""
    model = tiny_dit(guidance_embed=True)
    x, t, txt, mask, txt2, cos, sin = dit_args(model)
    if do_cfg:
        txt, mask, txt2 = (torch.cat([a, a]) for a in (txt, mask, txt2))
    before = pipeline.denoise_step.LAUNCHES
    with recording():
        pipeline.denoise_step(model, x, 1.0, 0.9, 999.0, txt, mask, txt2,
                              cos, sin, do_cfg, 6.0 if do_cfg else 1.0, 6.0,
                              0.0)
    assert pipeline.denoise_step.LAUNCHES - before == (2 if do_cfg else 1)
    assert counts(spans(*ALL))["dit.embed"] == 1


def test_vae_round_trip_spans():
    cfg = VAEConfig(block_out_channels=(32, 32, 64, 64), layers_per_block=1)
    vae = build_vae(cfg, "cpu", torch.float32,
                    generator=torch.Generator().manual_seed(0))
    x = torch.randn(1, 3, 5, 32, 32,
                    generator=torch.Generator().manual_seed(1))
    with torch.no_grad(), recording():
        vae(x)
    recs = spans(*ALL)
    c = counts(recs)
    assert c["vae.encoder"] == c["vae.decoder"] == 1
    # every conv but the 1x1x1 shortcuts pads; every resnet norms twice,
    # the mid attention once, each side's output once
    assert c["vae.pad"] == (1 + 4 * 2 + 3 + 4 + 1) + (1 + 4 + 4 * 2 * 2
                                                       + 3 + 1)
    assert c["vae.norm_act"] == (4 * 2 + 5 + 1) + (5 + 4 * 2 * 2 + 1)
    roots = {r.name for r in recs if r.parent is None}
    assert roots == {"vae.encoder", "vae.decoder"}
    for r in recs:
        if r.parent is not None:
            assert r.parent.name in ("vae.encoder", "vae.decoder")


def test_profile_dir_trace_holds_a_span(tmp_path):
    model = tiny_dit()
    args = dit_args(model)
    with torch.no_grad(), maybe_trace(str(tmp_path)):
        model(*args)
    (trace,) = tmp_path.glob("trace_rank0_*.json")
    names = {e.get("name") for e in json.loads(trace.read_text())[
        "traceEvents"]}
    assert {"dit.qk_rope", "dit.adaln", "dit.attention"} <= names
