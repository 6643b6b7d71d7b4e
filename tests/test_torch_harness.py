"""The port's t-ops experiment harness against the JAX package on the CPU:
the metric suite (PSNR / SSIM / MS-SSIM / Frechet distance, LPIPS, FVD,
FVMD), the directory and CSV runners, the data readers, the config
enumeration, the analysis, and the `infer` / `run_experiments` /
`compute_metrics` / `dynamic_enumeration` entries.

Tolerances: PSNR, SSIM and MS-SSIM are float64 in both packages, summed in
another order: 1e-9 relative. LPIPS is fp32 in both: 1e-5 relative. FVD
resizes with F.interpolate where JAX uses cv2.INTER_LINEAR: the resized
frames agree within 1e-5, the FVD within 1e-3 relative.
"""
import csv
import dataclasses
import json
import math
import os

import jax
import numpy as np
import pytest
import torch
import thread_budget  # noqa: F401  (this worker's share of the cores)

from hunyuanvideo_efficiency_tpu.data import mp42tensor as jmp4
from hunyuanvideo_efficiency_tpu.data.video_bit_rate import (
    video_bit_rate as jax_bit_rate)
from hunyuanvideo_efficiency_tpu.data import yuv_tensor as jyuv
from hunyuanvideo_efficiency_tpu.evaluation import compute_metrics as jcm
from hunyuanvideo_efficiency_tpu.evaluation.fvmd import (
    fvmd as jax_fvmd, video_motion_features as jax_motion_features)
from hunyuanvideo_efficiency_tpu.evaluation import fvd as jfvd
from hunyuanvideo_efficiency_tpu.evaluation import lpips as jlpips
from hunyuanvideo_efficiency_tpu.evaluation import metrics as jm
from hunyuanvideo_efficiency_tpu.evaluation import run_metrics as jrun
from hunyuanvideo_efficiency_tpu.experiments import analysis as janalysis
from hunyuanvideo_efficiency_tpu.experiments import enumeration as jenum
from hunyuanvideo_efficiency_tpu_torch import (compute_metrics, dynamic_enumeration,
                                               infer, run_experiments)
from hunyuanvideo_efficiency_tpu_torch.data import mp42tensor
from hunyuanvideo_efficiency_tpu_torch.data.video_bit_rate import (
    video_bit_rate)
from hunyuanvideo_efficiency_tpu_torch.data import yuv_tensor
from hunyuanvideo_efficiency_tpu_torch.evaluation import compute_metrics as cm
from hunyuanvideo_efficiency_tpu_torch.evaluation import fvd, lpips
from hunyuanvideo_efficiency_tpu_torch.evaluation import metrics as m
from hunyuanvideo_efficiency_tpu_torch.evaluation.fvmd import (
    fvmd, video_motion_features)
from hunyuanvideo_efficiency_tpu_torch.evaluation import run_metrics
from hunyuanvideo_efficiency_tpu_torch.experiments import analysis, enumeration
from hunyuanvideo_efficiency_tpu_torch.models.vae_config import (
    VAE_CONFIGS, VAEConfig)
from hunyuanvideo_efficiency_tpu_torch.utils.weights import (
    lpips_state_dict_from_jax)

REL = 1e-9


def _same(x, y, rel=REL):
    if math.isnan(x) or math.isinf(x):
        assert x == y or (math.isnan(x) and math.isnan(y)), (x, y)
    else:
        assert abs(x - y) <= rel * abs(y), (x, y)


def _videos(seed, shape, noise=12):
    """A uint8 video and a perturbed copy whose frame 1 is identical."""
    rng = np.random.default_rng(seed)
    a = rng.integers(0, 256, shape, dtype=np.uint8)
    b = np.clip(a.astype(int) + rng.integers(-noise, noise + 1, shape), 0,
                255).astype(np.uint8)
    b[1] = a[1]
    return a, b


@pytest.fixture(scope="module")
def lpips_pair():
    """Random LPIPS parameters in the JAX package's tree, drawn with numpy
    as its random_lpips_params draws them (conv kernels N(0, 0.1^2), here
    with random biases as well, |N(0, 0.01^2)| heads; eager jax.random
    would compile a program per shape), and the port's module holding
    them."""
    rng = np.random.default_rng(1)
    shapes = jax.eval_shape(jlpips.random_lpips_params)

    def draw(path, leaf):
        x = rng.standard_normal(leaf.shape).astype(np.float32)
        if path[0].key == "lins":
            return np.abs(0.01 * x)
        return 0.1 * x

    params = jax.tree_util.tree_map_with_path(draw, shapes)
    return params, lpips.lpips_from_state_dict(
        lpips_state_dict_from_jax(params), device="cpu")


@pytest.fixture(scope="module")
def tiny_i3d(tmp_path_factory):
    """A scripted stand-in with the I3D TorchScript's call signature:
    [N, 3, T, H, W] -> [N, 4] features."""
    class TinyI3D(torch.nn.Module):
        def __init__(self):
            super().__init__()
            torch.manual_seed(0)
            self.proj = torch.nn.Linear(12, 4)

        def forward(self, x, rescale: bool = False, resize: bool = False,
                    return_features: bool = True):
            pooled = torch.nn.functional.adaptive_avg_pool3d(x, (1, 2, 2))
            return self.proj(pooled.flatten(1))

    path = tmp_path_factory.mktemp("i3d") / "i3d_torchscript.pt"
    torch.jit.script(TinyI3D()).save(str(path))
    return str(path)


@pytest.mark.parametrize("size", [(4, 40, 56), (2, 112, 120)])
def test_frame_metrics_match_jax(size):
    """uint8 videos (a frame identical: inf PSNR, left out of the mean;
    MS-SSIM nan below 112 pixels in both), one float frame at data range
    1, a gray frame, and an all-identical video."""
    a, b = _videos(0, size + (3,))
    for name in ("psnr_video", "ssim_video", "ms_ssim_video"):
        _same(getattr(m, name)(a, b), getattr(jm, name)(a, b))
        _same(getattr(m, name)(torch.from_numpy(a), torch.from_numpy(b)),
              getattr(jm, name)(a, b))
    af, bf = a[0].astype(np.float32) / 255, b[0].astype(np.float32) / 255
    for name in ("psnr", "ssim", "ms_ssim"):
        _same(getattr(m, name)(af, bf, 1.0), getattr(jm, name)(af, bf, 1.0))
    _same(m.ssim(af[..., 0], bf[..., 0], 1.0),
          jm.ssim(af[..., 0], bf[..., 0], 1.0))
    assert m.psnr_video(a, a) == jm.psnr_video(a, a) == float("inf")
    _same(m.ssim_video(a, a), 1.0)


def test_frechet_and_stats_match_jax():
    rng = np.random.default_rng(2)
    f1, f2 = rng.standard_normal((64, 6)), rng.standard_normal((64, 6)) + 0.3
    mu1, s1 = m.gaussian_stats(torch.from_numpy(f1))
    jmu1, js1 = jm.gaussian_stats(f1)
    np.testing.assert_array_equal(mu1, jmu1)
    np.testing.assert_array_equal(s1, js1)
    mu2, s2 = m.gaussian_stats(f2)
    _same(m.frechet_distance(mu1, s1, mu2, s2),
          jm.frechet_distance(jmu1, js1, *jm.gaussian_stats(f2)))
    assert abs(m.frechet_distance(mu1, s1, mu1, s1)) < 1e-9


def test_lpips_matches_jax(lpips_pair):
    params, model = lpips_pair
    a, b = _videos(3, (3, 64, 72, 3))
    _same(lpips.lpips_video(model, a, b, batch=2),
          jlpips.lpips_video(params, a, b, batch=2), rel=1e-5)
    af, bf = (x.astype(np.float32) / 127.5 - 1.0 for x in (a, b))
    np.testing.assert_allclose(
        lpips.lpips_pair(model, *(torch.from_numpy(x).permute(0, 3, 1, 2)
                                  for x in (af, bf))).numpy(),
        np.asarray(jlpips.lpips_pair(params, *(x.transpose(0, 3, 1, 2)
                                               for x in (af, bf)))),
        rtol=1e-5)


def test_lpips_weight_conversion(lpips_pair):
    """A torchvision-layout AlexNet + lpips `lin` state dict converts to the
    same module state as the JAX converter's tree carried across; random
    parameters have the AlexNet shapes and non-negative heads."""
    params, _ = lpips_pair
    alex = {f"features.{j}.{k}": (np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
                                  if k == "weight" else np.asarray(p["bias"]))
            for j, p in zip((0, 3, 6, 8, 10), params["features"])
            for k in ("weight", "bias")}
    lins = {f"lin{i}.model.1.weight":
            np.asarray(p["kernel"]).transpose(3, 2, 0, 1)
            for i, p in enumerate(params["lins"])}
    ours = lpips.convert_lpips_weights(alex, lins)
    ref = lpips_state_dict_from_jax(jlpips.convert_lpips_weights(alex, lins))
    assert ours.keys() == ref.keys()
    for k in ours:
        torch.testing.assert_close(ours[k], ref[k], rtol=0, atol=0)
    model = lpips.random_lpips_params(torch.Generator().manual_seed(0))
    assert model.state_dict().keys() == ours.keys()
    assert all(model.state_dict()[k].shape == v.shape for k, v in ours.items())
    assert all((lin.weight >= 0).all() for lin in model.lins)


def test_fvd_matches_jax(tiny_i3d):
    rng = np.random.default_rng(4)
    real = rng.random((6, 4, 40, 48, 3), dtype=np.float32)
    fake = np.clip(real + 0.1 * rng.standard_normal(real.shape), 0, 1
                   ).astype(np.float32)
    np.testing.assert_allclose(fvd._resize_video(torch.from_numpy(real[0]))
                               .numpy(), jfvd._resize_video(real[0]),
                               atol=1e-5)
    np.testing.assert_allclose(fvd.i3d_features(real, tiny_i3d, device="cpu"),
                               jfvd.i3d_features(real, tiny_i3d), atol=1e-5)
    _same(fvd.compute_fvd(real, fake, tiny_i3d, device="cpu"),
          jfvd.compute_fvd(real, fake, tiny_i3d), rel=1e-3)
    with pytest.raises(ValueError, match="i3d_path"):
        fvd.compute_fvd(real, fake, device="cpu")


def _moving_videos(n=3, t=20, size=48, seed=5):
    """Smooth blobs drifting a pixel or two a frame: trackable motion."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:size, :size]
    out = np.empty((n, t, size, size, 3), np.uint8)
    for i in range(n):
        vx, vy = rng.uniform(-2, 2, 2)
        for f in range(t):
            cx, cy = size / 2 + vx * f, size / 2 + vy * f
            g = np.exp(-((xx - cx) ** 2 + (yy - cy) ** 2) / 60.0)
            out[i, f] = (255 * g)[..., None].astype(np.uint8)
    return out


def test_fvmd_matches_jax():
    a, b = _moving_videos(seed=5), _moving_videos(seed=6)
    assert fvmd(a, b) == jax_fvmd(a, b)
    np.testing.assert_array_equal(video_motion_features(a),
                                  jax_motion_features(a))


def _write_pt_pairs(root, seed=7):
    """orig/ and recon/ `.pt` dirs ([C, T, H, W] in [-1, 1]); values sit on
    and next to the uint8 cut points, so the truncation shows."""
    rng = np.random.default_rng(seed)
    orig, recon = root / "orig", root / "recon"
    orig.mkdir()
    recon.mkdir()
    for i, (t, h, w) in enumerate(((3, 64, 72), (4, 72, 64))):
        levels = rng.integers(0, 256, (3, t, h, w)).astype(np.float32)
        x = levels / 127.5 - 1.0
        y = (levels + rng.choice([0.0, 0.49, 0.51, 0.99, -0.5],
                                 levels.shape)) / 127.5 - 1.0
        torch.save(torch.from_numpy(x.astype(np.float32)),
                   orig / f"v{i}.pt")
        torch.save(torch.from_numpy(y.astype(np.float32))[None],
                   recon / f"v{i}.pt")
    torch.save(torch.zeros(3, 2, 8, 8), recon / "unpaired.pt")
    return str(orig), str(recon)


def test_compute_metrics_dir_matches_jax(tmp_path, lpips_pair):
    """The uint8 frames of each `.pt` (truncated, not rounded), the pairs'
    metrics and the report against JAX's."""
    params, model = lpips_pair
    orig, recon = _write_pt_pairs(tmp_path)
    for d in (orig, recon):
        for f in sorted(os.listdir(d)):
            frames = cm.load_video_frames(os.path.join(d, f))
            np.testing.assert_array_equal(
                frames.numpy(), jcm.load_video_frames(os.path.join(d, f)))
    ours = cm.compute_metrics_dir(orig, recon, lpips_params=model,
                                  out_txt=str(tmp_path / "ours.txt"),
                                  device="cpu")
    ref = jcm.compute_metrics_dir(orig, recon, lpips_params=params,
                                  out_txt=str(tmp_path / "ref.txt"))
    assert [p.name for p in ours.pairs] == [p.name for p in ref.pairs] == \
        ["v0", "v1"]
    for p, q in zip(ours.pairs, ref.pairs):
        _same(p.psnr, q.psnr)
        _same(p.ssim, q.ssim)
        _same(p.lpips, q.lpips, rel=1e-5)
    assert (tmp_path / "ours.txt").read_text().splitlines()[:2] == \
        (tmp_path / "ref.txt").read_text().splitlines()[:2]
    assert analysis.parse_metrics_txt(str(tmp_path / "ours.txt")) == \
        pytest.approx(janalysis.parse_metrics_txt(str(tmp_path / "ref.txt")),
                      rel=1e-5)


def test_per_video_metrics_csv_matches_jax(tmp_path, lpips_pair, tiny_i3d):
    params, model = lpips_pair
    a, b = _videos(8, (2, 4, 40, 48, 3))
    ours = run_metrics.per_video_metrics(
        a, b, lpips_params=model, i3d_path=tiny_i3d, with_fvmd=True,
        out_csv=str(tmp_path / "ours.csv"), device="cpu")
    jrun.per_video_metrics(a, b, lpips_params=params, i3d_path=tiny_i3d,
                           with_fvmd=True, out_csv=str(tmp_path / "ref.csv"))
    with open(tmp_path / "ours.csv") as f1, open(tmp_path / "ref.csv") as f2:
        rows, ref_rows = list(csv.reader(f1)), list(csv.reader(f2))
    assert rows[0] == ref_rows[0] == ["video", "psnr", "ssim", "ms_ssim",
                                      "lpips", "fvd", "fvmd"]
    assert len(rows) == len(ref_rows) == 4 and ours[-1]["video"] == "set"
    tol = {"lpips": 1e-5, "fvd": 1e-3}
    for row, ref_row in zip(rows[1:], ref_rows[1:]):
        for key, x, y in zip(rows[0], row, ref_row):
            if key == "video" or not y:
                assert x == y
            else:
                _same(float(x), float(y), tol.get(key, REL))
    demo, jdemo = run_metrics.demo(
        n=2, frames=3, size=16, device="cpu"), jrun.demo(
        n=2, frames=3, size=16)
    assert demo.keys() == jdemo.keys()
    for k in demo:
        _same(demo[k], jdemo[k])


def test_video_io_matches_jax(tmp_path):
    """mp4 and raw-YUV readers, the mp4 writer and the bitrate tool (cv2
    on the host) against the JAX package's copies."""
    rng = np.random.default_rng(9)
    video = rng.uniform(-1, 1, (3, 4, 32, 48)).astype(np.float32)
    jmp4.tensor_to_video(video, str(tmp_path / "ref.mp4"), fps=8)
    mp42tensor.tensor_to_video(torch.from_numpy(video),
                               str(tmp_path / "ours.mp4"), fps=8)
    np.testing.assert_array_equal(
        cm.load_video_frames(str(tmp_path / "ours.mp4")).numpy(),
        jcm.load_video_frames(str(tmp_path / "ref.mp4")))
    for short in (None, 24):
        np.testing.assert_array_equal(
            mp42tensor.video_to_tensor(str(tmp_path / "ref.mp4"),
                                       short).numpy(),
            jmp4.video_to_tensor(str(tmp_path / "ref.mp4"), short))
    assert video_bit_rate(str(tmp_path / "ref.mp4")) == \
        jax_bit_rate(str(tmp_path / "ref.mp4"))
    yuv = tmp_path / "clip_32x16_25.yuv"
    yuv.write_bytes(rng.integers(0, 256, 3 * 32 * 16 * 3 // 2,
                                 dtype=np.uint8).tobytes())
    for fmt in ("I420", "NV12"):
        np.testing.assert_array_equal(
            yuv_tensor.read_yuv(str(yuv), fmt=fmt).numpy(),
            jyuv.read_yuv(str(yuv), fmt=fmt))
    np.testing.assert_array_equal(
        yuv_tensor.yuv_to_tensor(str(yuv), resize_short=8).numpy(),
        jyuv.yuv_to_tensor(str(yuv), resize_short=8))


@pytest.mark.parametrize("mode", ["pool", "stride", "stride2"])
def test_enumeration_json_matches_jax(tmp_path, mode):
    """Every config file of each mode equal to JAX's, byte for byte, through
    the dynamic_enumeration entry."""
    ours = dynamic_enumeration.main(["--mode", mode, "--output-dir",
                                     str(tmp_path / "ours")])
    ref = jenum.write_configs(str(tmp_path / "ref"), mode)
    assert len(ours) == len(ref) == {"pool": 384, "stride": 72,
                                     "stride2": 384}[mode]
    for p, q in zip(ours, ref):
        assert os.path.basename(p) == os.path.basename(q)
        with open(p) as f1, open(q) as f2:
            assert f1.read() == f2.read()
    assert enumeration.base_config() == jenum.base_config()


def test_analysis_matches_jax(tmp_path):
    base = tmp_path / "exps"
    for i, (p, s, lp) in enumerate(((30.5, 0.91, 0.2), (28.0, 0.95, 0.1),
                                    (31.0, 0.88, None))):
        d = base / f"exp_{i + 1}"
        d.mkdir(parents=True)
        text = f"Average PSNR: {p:.6f}\nAverage SSIM: {s:.6f}\n"
        if lp is not None:
            text += f"Average LPIPS: {lp:.6f}\n"
        (d / "metrics_2026-01-01.txt").write_text(text + "\nx: psnr=1\n")
    (base / "other").mkdir()
    rows = analysis.collect_experiment_metrics(str(base))
    assert rows == janalysis.collect_experiment_metrics(str(base))
    for key in ("psnr", "ssim", "lpips"):
        assert analysis.rank_table(rows, key, top=2) == \
            janalysis.rank_table(rows, key, top=2)
    frames, _ = _videos(10, (5, 16, 16, 3))
    np.testing.assert_array_equal(analysis.frame_entropy(frames),
                                  janalysis.frame_entropy(frames))
    assert analysis.temporal_entropy_rate(frames) == \
        janalysis.temporal_entropy_rate(frames)


def test_entries_round_trip_on_the_cpu(tmp_path, monkeypatch):
    """infer.main with random weights under a t-ops config writes the
    reconstruction (the first pool config: 9 frames pool to 5 in the
    first down block, giving 2 latent frames, which the first up block
    interpolates to 4: 13 frames out); --data-parallel in one process is
    a no-op (the same reconstruction);
    run_experiments ranks a one-config stride sweep and compute_metrics
    scores it. The registry's 884-16c-hy is narrowed to channels (32, 32,
    64, 64) with its block structure kept: its 246M random parameters
    take minutes on a shared CPU, and chip_smoke.py's `[harness_path]`
    runs the entries at full width on the card."""
    monkeypatch.setitem(VAE_CONFIGS, "884-16c-hy",
                        VAEConfig(block_out_channels=(32, 32, 64, 64)))
    tensors = tmp_path / "tensors"
    tensors.mkdir()
    video = torch.rand(3, 9, 16, 16, generator=torch.Generator().manual_seed(
        0)) * 2 - 1
    torch.save(video, tensors / "clip.pt")
    cfg = enumeration.write_configs(str(tmp_path / "cfg"), "pool", cap=1)[0]
    args = ["--tensor-dir", str(tensors), "--random-init", "--device", "cpu",
            "--config-json", cfg]
    infer.main(args + ["--output-dir", str(tmp_path / "out")])
    recon = torch.load(tmp_path / "out" / "clip.pt", weights_only=True)
    assert recon.dtype == torch.float32 and recon.shape == (3, 13, 16, 16)
    assert torch.isfinite(recon).all()
    # one process: --data-parallel changes nothing
    infer.main(args + ["--output-dir", str(tmp_path / "dp"),
                       "--data-parallel"])
    assert torch.equal(torch.load(tmp_path / "dp" / "clip.pt",
                                  weights_only=True), recon)
    table = run_experiments.main([
        "--tensor-dir", str(tensors), "--orig-dir", str(tensors),
        "--out-base", str(tmp_path / "sweep"), "--mode", "stride", "--cap",
        "1", "--random-init", "--device", "cpu"])
    assert [r["name"] for r in table] == ["exp_1"]
    assert json.loads((tmp_path / "sweep" / "ranking_psnr.json").read_text()
                      ) == table
    dm = compute_metrics.main(["--orig-dir", str(tensors), "--recon-dir",
                               str(tmp_path / "sweep" / "exp_1"),
                               "--device", "cpu"])
    assert dataclasses.astuple(dm.pairs[0])[1:3] == pytest.approx(
        (table[0]["psnr"], table[0]["ssim"]), rel=REL)
