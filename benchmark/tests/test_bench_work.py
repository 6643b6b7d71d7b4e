"""The yardstick's counts against hand counts at small shapes: sliding-tile
pairs against a brute-force mask, one step's operations, and each roofline
reader's bound of one launch."""
import itertools
import json
from pathlib import Path

import numpy as np
import pytest

from benchmark import work
from benchmark.yardstick import PEAK_BYTES, PEAK_FLOPS, PEAK_INT8, bound

ROOT = Path(__file__).resolve().parents[2]
TINY = Path(__file__).resolve().parent / "tiny"


def load_metric(name):
    from benchmark.run import load_module

    return load_module(ROOT / "benchmark" / "metrics" / f"{name}.py",
                       f"benchmark.metrics.{name.replace('.', '_')}")


def brute_pairs(grid, tile, window):
    coords = list(itertools.product(*[range(n) for n in grid]))
    n = 0
    for q in coords:
        tq = [c // t for c, t in zip(q, tile)]
        for k in coords:
            tk = [c // t for c, t in zip(k, tile)]
            n += all(abs(a - b) <= w // 2 for a, b, w in zip(tq, tk, window))
    return n


@pytest.mark.parametrize("grid,tile,window", [
    ((3, 4, 6), (2, 2, 2), (3, 3, 3)),
    ((5, 5, 7), (2, 2, 3), (3, 3, 3)),
    ((4, 6, 6), (4, 2, 2), (1, 3, 5)),
])
def test_sta_pairs_against_brute_force(grid, tile, window):
    assert work.sta_image_pairs(grid, tile, window) == brute_pairs(
        grid, tile, window)


def test_sta_pairs_against_reference_layout():
    """The reference's tile layout sees the same pairs."""
    import torch

    from benchmark.reference.dit import tile_layout

    grid, tile, window = (5, 6, 7), (2, 4, 4), (3, 3, 3)
    tokens, nbr = tile_layout(grid, tile, window, "cpu")
    rows = (tokens >= 0).sum(1)
    keys = torch.where(nbr >= 0, rows[nbr.clamp_min(0)], 0).sum(1)
    assert int((rows * keys).sum()) == work.sta_image_pairs(grid, tile,
                                                            window)


def tiny(name):
    return json.loads((TINY / name).read_text())


def test_step_operations_hand_count():
    cfg = tiny("tiny-bf16.json")
    grid, lt, valid = (3, 4, 6), 16, [0, 15]
    d = cfg["dit"]
    h, m = 64, 256
    n = 72
    b = 2
    gemm = 2 * (b * n * h * 64 + b * (h * 256 + h * h + h * 32 + h * h)
                + b * lt * h * 64 + b * (h * 256 + h * h + h * 64 + h * h))
    gemm += 2 * 2 * (b * 2 * h * h + b * lt * (3 * h * h + h * h
                                               + 8 * h * h))
    for rows in (b * n, b * lt):
        gemm += 2 * 2 * (b * 6 * h * h + rows * (3 * h * h + h * h
                                                      + 2 * m * h))
    gemm += 2 * 2 * (b * 3 * h * h + b * (n + lt) * (3 * h * h + m * h
                                                     + h * h + m * h))
    gemm += 2 * (b * 2 * h * h + b * n * 64 * h)
    pairs = 2 * (lt * 1 + lt * 15) + 4 * sum((n + lt) * (n + v)
                                             for v in valid)
    want = gemm + 4 * 32 * 2 * pairs
    assert d["refiner_depth"] == 2
    assert work.step_operations(cfg, grid, lt, valid) == pytest.approx(want)


def test_patch_grid():
    cfg = tiny("tiny-bf16.json")
    assert work.patch_grid(cfg, tiny("tiny-t2v.json")) == (3, 4, 6)
    full = json.loads((ROOT / "benchmark/configs/hyvideo-t2-bf16.json")
                      .read_text())
    traffic = json.loads((ROOT / "benchmark/traffic/t2v-540p65.json")
                         .read_text())
    assert work.patch_grid(full, traffic) == (17, 34, 60)


def test_k1_bound():
    cfg = tiny("tiny-bf16.json")
    k1 = load_metric("k1_roofline")
    ms = k1.launch_bound_ms(cfg, 72, 16, [3, 9])
    ops = 4 * 32 * 2 * 88 * (75 + 81)
    nbytes = 4 * 2 * 88 * 64 * 2
    assert ms == pytest.approx(max(ops / PEAK_FLOPS,
                                   nbytes / PEAK_BYTES) * 1e3)


def test_sta_bound():
    cfg = tiny("tiny-sta-int8.json")
    sta = load_metric("sta_roofline")
    grid = (3, 4, 6)
    pairs = brute_pairs(grid, (2, 2, 2), (3, 3, 3))
    ms = sta.launch_bound_ms(cfg, grid, 16, [3, 9])
    t = (2 * 32 * 2 * 2 * pairs + 4 * 32 * 2 * 72 * 12) / PEAK_FLOPS \
        + 2 * 32 * 2 * 2 * pairs / PEAK_INT8
    nbytes = (4 * 72 + 2 * 16) * 2 * 64 * 2
    assert ms == pytest.approx(max(t, nbytes / PEAK_BYTES) * 1e3)


def test_w8a8_calls_and_bound():
    cfg = tiny("tiny-sta-int8.json")
    w8 = load_metric("w8a8_roofline")
    calls = w8.block_calls(cfg, 72, 16, 2)
    assert len(calls) == 10 * 2 + 5 * 2
    assert calls[0] == (2, 6 * 64, 64) and calls[1] == (144, 192, 64)
    assert calls[20:25] == [(2, 192, 64), (176, 192, 64), (176, 256, 64),
                            (176, 64, 64), (176, 64, 256)]
    m, n, k = 176, 256, 64
    assert bound(0.0, m * k * 2 + n * k + m * n * 2, 2.0 * m * n * k)[0] \
        == pytest.approx(max(2 * m * n * k / PEAK_INT8,
                             (m * k * 2 + n * k + m * n * 2) / PEAK_BYTES)
                         * 1e3)


def test_k3_shapes_and_bound():
    """The reference VAE's K3 convs of a round trip, listed on meta
    tensors, against the channel widths of the decoder's stages."""
    from benchmark.reference.vae import k3_shapes

    cfg = json.loads((ROOT / "benchmark/configs/hyvideo-t2-bf16.json")
                     .read_text())["vae"]
    base = json.loads((ROOT / "benchmark/tops/base.json").read_text())
    shapes = k3_shapes(cfg, base, 9, 64, 64)
    assert all(s[4] % 128 == 0 and s[5] % 128 == 0 for s in shapes)
    assert (1, 9, 64, 64, 128, 128) in shapes
    k3 = load_metric("k3_roofline")
    s = (1, 9, 64, 64, 128, 128)
    ops = 2.0 * 9 * 64 * 64 * 128 * 27 * 128
    nbytes = 2 * (11 * 66 * 66 * 128 + 27 * 128 * 128 + 9 * 64 * 64 * 128)
    assert k3.launch_bound_ms(s) == pytest.approx(
        max(ops / PEAK_FLOPS, nbytes / PEAK_BYTES) * 1e3)


def test_tile_rows():
    r = work.tile_rows((5, 6, 7), (2, 4, 4))
    assert r.shape == (3, 2, 2)
    assert r[0, 0, 0] == 32 and r[2, 1, 1] == 1 * 2 * 3
    assert r.sum() == 5 * 6 * 7
    assert np.all(r > 0)
