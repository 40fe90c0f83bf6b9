"""The port's CLIs (``depth_estimation_tpu_torch/cli/tools.py`` and
``cli/test_radial.py``) on the CPU at small sizes, and the confidence masks
of ``ops/extract.py`` that the video tool needs, against the JAX package.

  * ``tools stream`` (synchronous and ``--pipeline 2``), ``video`` (3
    frames, and one with the entropy gate), ``rectify`` and ``export`` run
    with ``--device cpu`` on a small sequence and write what they write;
  * ``test_radial``'s panels against the JAX CLI's on the same forward
    scene, the same weights (``-w``) and the same RANSAC draw: at least
    0.95 of the pixels within one 8-bit level, and the mean difference
    within one level. The epipoles of the two LAPACK builds part by
    ~1e-3 px (2.1e-3 on the second pair; ROADMAP C26), which moves the
    polar images by as much, and the radial WTA flips at polar pixels
    whose two best costs lie closer than that: 0.977 of the second
    panel's pixels agree within a level;
  * ``tools video``'s panels against the JAX CLI's on that scene, the
    same weights and the same RANSAC draw, at the same two limits on each
    of the nine panels (a depth panel over its lit pixels);
  * the download tool's menus (host code) equal to JAX's;
  * ``extract_output_marginalized``, ``mean_head_confidences``,
    ``middle_disc_mask`` and ``entropy_mask`` equal to JAX's.
"""

import dataclasses
import os

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.cli import test_radial as jtest_radial
from depth_estimation_tpu.cli import tools as jtools
from depth_estimation_tpu.flow.celiu import bilinear_sample, gaussian_smooth
from depth_estimation_tpu.geometry3d import calibration as jcal
from depth_estimation_tpu.models.radial import RadialFlowNetwork as JRadial
from depth_estimation_tpu.ops import extract as jextract
from depth_estimation_tpu_torch.cli import (depth_estimation, opticalflow,
                                            test_radial, tools, train_radial,
                                            train_v2)
from depth_estimation_tpu_torch.data import images as timages
from depth_estimation_tpu_torch.geometry import Geometry, Learning
from depth_estimation_tpu_torch.geometry3d import calibration as tcal
from depth_estimation_tpu_torch.geometry3d import egomotion as tego
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.models.flow import FlowModel
from depth_estimation_tpu_torch.ops import extract as textract
from depth_estimation_tpu_torch.robotics import drone_api
from torch_parity import ransac_noise

REPO_ROOT = os.path.join(os.path.dirname(os.path.abspath(__file__)), "..")
H, W = 64, 80
# radial scene: tests/test_torch_polar_data.py's forward step (seed 8)
RH, RW, RPOINTS = 96, 128, 200
# test_radial panels, JAX vs port: the share of pixels within one 8-bit
# level, and the mean difference in levels
PANEL_SHARE = 0.95
PANEL_MEAN = 1.0
# tools video, JAX vs port: the gain on the seeded weights, and the least
# share of lit pixels in each depth panel (0.09-0.10 on this scene)
VIDEO_GAIN = 20.0
VIDEO_DEPTH_SHARE = 0.05


def calibration(mod, name, h, w, f, points):
    base = mod.RECTIFIED_GOPRO_SMALL
    return dataclasses.replace(
        base, name=name, wImg=w, hImg=h, fx=f, fy=f, cx=w / 2, cy=h / 2,
        sfm=dataclasses.replace(base.sfm, max_points=points,
                                points_quality=0.001))


@pytest.fixture(autouse=True)
def presets():
    names = {"t64x80": (H, W, 60.0, 64), "t96x128": (RH, RW, 120.0, RPOINTS)}
    for name, (h, w, f, n) in names.items():
        for mod in (tcal, jcal):
            mod.PRESETS[name] = calibration(mod, name, h, w, f, n)
    yield
    for name in names:
        for mod in (tcal, jcal):
            mod.PRESETS.pop(name, None)


def write_sequence(root, frames):
    os.makedirs(os.path.join(root, "images"))
    for i, f in enumerate(frames):
        with open(os.path.join(root, "images", f"{i:09d}.png"), "wb") as fh:
            fh.write(timages.encode_png((np.clip(f, 0, 1) * 255).astype(np.uint8)))
    return root


@pytest.fixture(scope="module")
def flow_case(tmp_path_factory):
    """A 4-frame sideways pan (2 px a frame) over smooth noise and a
    single-scale model dir of seeded weights."""
    tmp = tmp_path_factory.mktemp("tools")
    rng = np.random.RandomState(0)
    big = timages.scale_np(rng.rand(24, 28, 3).astype(np.float32), H + 30, W + 30)
    seq = write_sequence(str(tmp / "seq"), [big[10:10 + H, 10 + 2 * i:10 + W + 2 * i]
                                            for i in range(4)])
    g = Geometry(hImg=H, wImg=W, layers=((3, 5, 5, 8),), maxh=6, maxw=6)
    model = FlowModel(g, device="cpu").init(torch.Generator().manual_seed(0))
    mdir = tio.save_model(str(tmp / "model"), g, Learning(), model)
    return seq, mdir


@pytest.mark.parametrize("pipeline", ["0", "2"])
def test_stream_runs_every_frame(flow_case, capsys, pipeline):
    seq, mdir = flow_case
    assert tools.main(["stream", mdir, seq, "--calibration", "t64x80",
                       "--num", "3", "--pipeline", pipeline,
                       "--device", "cpu"]) == 0
    out = capsys.readouterr().out
    assert "frame 3:" in out and "total: 3 frames" in out
    if pipeline == "0":
        assert "frame=" in out


def test_video_writes_panels(flow_case, tmp_path, monkeypatch):
    seq, mdir = flow_case
    monkeypatch.setenv("DE_TPU_HEADLESS", "1")
    out = str(tmp_path / "video")
    assert tools.main(["video", mdir, seq, "--calibration", "t64x80",
                       "--output-dir", out, "--num", "3", "--show",
                       "--device", "cpu"]) == 0
    pngs = sorted(f for f in os.listdir(out) if f.endswith(".png"))
    assert len(pngs) == 3
    panel = timages.load_image(os.path.join(out, pngs[0]))
    assert panel.shape == (3 * H, 3 * W, 3)
    # the first row is [previous | warped previous | current]
    assert panel[:H].std() > 0.05
    out2 = str(tmp_path / "gated")
    assert tools.main(["video", mdir, seq, "--calibration", "t64x80",
                       "--output-dir", out2, "--num", "1",
                       "--entropy-thr", "1e-4", "--device", "cpu"]) == 0
    gated = timages.load_image(os.path.join(out2, "000000000.png"))
    # a near-zero entropy threshold masks every pixel: the depth panels of
    # rows 2 and 3 have no confident pixel, and HSL at lightness 0 is black
    assert gated[H:, 2 * W:].max() == 0
    assert (gated[:H] == panel[:H]).all()


def test_video_matches_jax_cli(tmp_path, monkeypatch):
    """Both packages' ``tools video`` on the radial tester's forward scene
    (3 panels), the same seeded weights (the port's save_model, which the
    JAX reader loads) and the same RANSAC draw: every panel within the
    radial tester's PANEL_SHARE / PANEL_MEAN limits, panel by panel. The
    weights are scaled by VIDEO_GAIN so that the window distributions peak
    enough for the k=2 extraction to keep pixels, and the depth panels are
    not blank."""
    seq = write_sequence(str(tmp_path / "seq"), forward_sequence(8, n=4))
    g = Geometry(hImg=RH // 2, wImg=RW // 2, layers=((3, 5, 5, 8),), maxh=6,
                 maxw=6)
    model = FlowModel(g, device="cpu").init(torch.Generator().manual_seed(0))
    with torch.no_grad():
        for p in model.parameters():
            p.mul_(VIDEO_GAIN)
    mdir = tio.save_model(str(tmp_path / "model"), g, Learning(), model)
    monkeypatch.setattr(tego, "gumbel_noise", lambda s, n, dev, generator=None:
                        torch.as_tensor(ransac_noise(s, n), device=dev))
    argv = ["video", mdir, seq, "--calibration", "t96x128", "--num", "3"]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert tools.main(argv + ["--output-dir", ours, "--device", "cpu"]) == 0
    assert jtools.main(argv + ["--output-dir", ref]) == 0
    names = sorted(f for f in os.listdir(ref) if f.endswith(".png"))
    assert sorted(f for f in os.listdir(ours) if f.endswith(".png")) == names
    assert len(names) == 3
    from PIL import Image
    for name in names:
        with open(os.path.join(ours, name), "rb") as fh:
            a = timages.decode_png(fh.read()).astype(int)
        b = np.asarray(Image.open(os.path.join(ref, name)).convert("RGB")).astype(int)
        assert a.shape == b.shape == (3 * g.hImg, 3 * g.wImg, 3)
        # each of the 3x3 panels on its own; a depth panel (rows 2 and 3,
        # column 3) over the pixels either output lights, which must be
        # at least VIDEO_DEPTH_SHARE of it
        for r in range(3):
            for col in range(3):
                sl = (slice(r * g.hImg, (r + 1) * g.hImg),
                      slice(col * g.wImg, (col + 1) * g.wImg))
                pa, pb = a[sl], b[sl]
                keep = np.ones(pa.shape[:2], bool)
                if r > 0 and col == 2:
                    keep = (pa.max(-1) > 0) | (pb.max(-1) > 0)
                    assert keep.mean() >= VIDEO_DEPTH_SHARE, (name, r, keep.mean())
                d = np.abs(pa - pb).max(-1)[keep]
                assert (d <= 1).mean() >= PANEL_SHARE, (name, r, col, (d <= 1).mean())
                assert d.mean() <= PANEL_MEAN, (name, r, col, d.mean())


def test_rectify_and_export_write_their_files(flow_case, tmp_path):
    seq, mdir = flow_case
    assert tools.main(["rectify", seq, "--calibration", "t64x80", "--num",
                       "2", "--device", "cpu"]) == 0
    for sub in ("undistorted_images", "rectified_images"):
        assert sorted(os.listdir(os.path.join(seq, sub))) == [
            "000000000.png", "000000001.png"]
    assert tools.main(["export", mdir, "--device", "cpu"]) == 0
    assert os.path.getsize(os.path.join(mdir, "serving.pt2")) > 0


def test_entry_points_default_to_the_card(flow_case):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the default device is usable")
    seq, mdir = flow_case
    with pytest.raises(RuntimeError, match="cuda"):
        tools.main(["export", mdir, "--out", os.devnull])
    with pytest.raises(RuntimeError, match="cuda"):
        test_radial.main(["-rd", seq, "-cal", "t64x80", "-ni", "1"])
    for main in (opticalflow.main, train_radial.main, train_v2.main,
                 depth_estimation.main):
        with pytest.raises(RuntimeError, match="cuda"):
            main(["-rd", seq])
    with pytest.raises(RuntimeError, match="cuda"):
        drone_api.FifoDroneAPI(os.devnull, "")
    with pytest.raises(RuntimeError, match="cuda"):
        textract.middle_disc_mask(8, 8)


def test_time_wrappers_needs_a_card(capsys):
    if torch.cuda.is_available():
        pytest.skip("a card is visible: the script would time it")
    from depth_estimation_tpu_torch.cli import time_wrappers
    assert time_wrappers.main(["--root", REPO_ROOT]) == 2
    assert "no CUDA card" in capsys.readouterr().err


def test_download_menus_match_jax():
    entries = [("a", "2026-10-17"), ("b", "2026-10-16"), ("c", "2025-01-01")]
    for mod in (tools, jtools):
        assert [mod._recency_star(d, "2026-10-17") for _, d in entries] == \
            [" **", " *", ""]
    for name in ("e12", "model_of__e3", "e4.bin", "x1", "e"):
        assert tools._epoch_number(name) == jtools._epoch_number(name)
    answers = iter(["9", "x", "2"])
    assert tools._select_menu(entries, "2026-10-17", lambda: next(answers)) \
        == entries[1]
    eps = [("e0", "", 0), ("e1", "", 1)]
    assert tools._select_epoch(eps, lambda: "") == jtools._select_epoch(eps, lambda: "")


# ---------------------------------------------------------------------------
# the radial tester against the JAX CLI
# ---------------------------------------------------------------------------

def forward_sequence(seed, n=3, s_top=1.03, s_bottom=1.10):
    rng = np.random.RandomState(seed)
    base = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(RH, RW, 3).astype(np.float32)), 0.8, 2))
    frames = [np.clip(base * 1.5, 0, 1).astype(np.float32)]
    yy, xx = np.mgrid[0:RH, 0:RW].astype(np.float32)
    s = np.where(yy < RH / 2, s_top, s_bottom)
    xs = jnp.asarray(RW / 2 + (xx - RW / 2) / s)
    ys = jnp.asarray(RH / 2 + (yy - RH / 2) / s)
    for _ in range(n - 1):
        frames.append(np.asarray(bilinear_sample(jnp.asarray(frames[-1]), xs, ys)))
    return frames


def test_radial_tester_matches_jax_cli(tmp_path, monkeypatch):
    seq = write_sequence(str(tmp_path / "seq"), forward_sequence(8))
    layers = ((3, 5, 5, 8),)
    weights = tmp_path / "w.msgpack"
    weights.write_bytes(flax.serialization.to_bytes(
        JRadial(layers, 5).init(jax.random.PRNGKey(3))))
    # RANSAC gets the JAX package's own draw (key 1)
    monkeypatch.setattr(tego, "gumbel_noise", lambda s, n, dev, generator=None:
                        torch.as_tensor(ransac_noise(s, n), device=dev))
    argv = ["-rd", seq, "-cal", "t96x128", "-net", "[[3,5,5,8]]", "-w",
            str(weights), "-hwin", "5", "-hi", "64", "-wi", "64", "-ni", "2"]
    ours, ref = str(tmp_path / "ours"), str(tmp_path / "ref")
    assert test_radial.main(argv + ["-o", ours, "--device", "cpu"]) == 0
    assert jtest_radial.main(argv + ["-o", ref]) == 0
    names = sorted(os.listdir(ref))
    assert sorted(os.listdir(ours)) == names == ["000000000.png", "000000001.png"]
    from PIL import Image
    for name in names:
        with open(os.path.join(ours, name), "rb") as fh:
            a = timages.decode_png(fh.read()).astype(int)
        b = np.asarray(Image.open(os.path.join(ref, name)).convert("RGB")).astype(int)
        assert a.shape == b.shape and a.shape[2] == 3
        d = np.abs(a - b).max(-1)
        assert (d <= 1).mean() >= PANEL_SHARE, (name, (d <= 1).mean())
        assert d.mean() <= PANEL_MEAN, (name, d.mean())
        assert a.std() > 0


def test_radial_tester_dense_baseline(tmp_path):
    seq = write_sequence(str(tmp_path / "seq"), forward_sequence(3, n=2))
    out = str(tmp_path / "panels")
    assert test_radial.main(["-rd", seq, "-cal", "t96x128", "-net",
                             "[[3,5,5,8],'tanh',[8,3,3,8]]", "-hwin", "5",
                             "-hi", "48", "-wi", "48", "-ni", "1", "-o", out,
                             "-cmp", "--device", "cpu"]) == 0
    assert sorted(os.listdir(out)) == ["000000000.png", "000000000_dense.png"]
    with open(os.path.join(out, "000000000_dense.png"), "rb") as fh:
        assert timages.decode_png(fh.read()).shape == (48, 48, 3)


# ---------------------------------------------------------------------------
# the video tool's confidence masks
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dists():
    rng = np.random.RandomState(4)
    return rng.dirichlet(np.full(20, 0.3), size=(6, 7)).astype(np.float32)


def test_mean_head_confidences_and_entropy_mask_match_jax(dists):
    t, j = torch.from_numpy(dists), jnp.asarray(dists)
    for thr in (0.05, 0.11, 0.3):
        np.testing.assert_array_equal(
            textract.mean_head_confidences(t, 4, 5, thr).numpy(),
            np.asarray(jextract.mean_head_confidences(j, 4, 5, thr)))
    for thr in (0.5, 1.5, 2.5):
        np.testing.assert_array_equal(textract.entropy_mask(t, thr).numpy(),
                                      np.asarray(jextract.entropy_mask(j, thr)))


@pytest.mark.parametrize("thr,acc", [(0.11, 0.0), (0.11, 0.6), (0.25, 1.0)])
def test_extract_output_marginalized_matches_jax(dists, thr, acc):
    idx, good = textract.extract_output_marginalized(torch.from_numpy(dists),
                                                     thr, acc)
    jidx, jgood = jextract.extract_output_marginalized(jnp.asarray(dists), thr, acc)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(good.numpy(), np.asarray(jgood))
    assert good.dtype == torch.int32


@pytest.mark.parametrize("feather", [0.0, 4.0])
def test_middle_disc_mask_matches_jax(feather):
    np.testing.assert_array_equal(
        textract.middle_disc_mask(45, 61, 12.5, feather,
                                  device="cpu").numpy(),
        np.asarray(jextract.middle_disc_mask(45, 61, 12.5, feather)))
