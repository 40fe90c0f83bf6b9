"""The batched radial estimator (``api_radial.BatchedRadialEstimator``, the
radial tester's chain, BASELINE config4) on the CPU at a small size:
against the benchmark's plain reference ``h100bench/reference/radial.py``
step by step, its counters, the batched EMA, P2C grid and flow2depth
against their per-pair forms, and ``cli/test_radial`` writing the
estimator's depth.

Size: B = 2 streams of 3 frames (two steps), 90x160 frames of the
benchmark's forward walks (1-3% zoom a frame), polar 48x48, hWin 7, the
trunk [[3,3,3,4],'tanh',[4,3,3,4]] on seeded weights, 200 corners.

Tolerance, everywhere: none. On one device the estimator and the
reference run the same float32 operations in the same order (the reference
is a frozen copy of that arithmetic; the P2C grid's centre and rmax in
float64 as the per-pair tester's Python floats), so the WTA index, the
depths, the confidences and the epipoles are equal bit for bit (a WTA
index could part only where two costs tie exactly and the sides broke the
tie apart; both take the first least, so equal costs give equal
indices)."""

import dataclasses

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch import api_radial
from depth_estimation_tpu_torch.cli import test_radial
from depth_estimation_tpu_torch.data import datasets
from depth_estimation_tpu_torch.data import images as timages
from depth_estimation_tpu_torch.geometry3d import calibration
from depth_estimation_tpu_torch.geometry3d import polar
from depth_estimation_tpu_torch.models import radial
from depth_estimation_tpu_torch.utils import timer
from depth_estimation_tpu_torch.utils.viz import save_image
from h100bench import traffic
from h100bench.reference import radial as ref
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

H, W = 90, 160
HI = WI = 48
H_WIN = 7
SPEC = ((3, 3, 3, 4), "tanh", (4, 3, 3, 4))
B, N_FRAMES = 2, 3
CAL = dataclasses.replace(
    calibration.GOPRO, name="t90x160", wImg=W, hImg=H,
    fx=calibration.GOPRO.fx / 8, fy=calibration.GOPRO.fy / 8,
    cx=calibration.GOPRO.cx / 8, cy=calibration.GOPRO.cy / 8,
    sfm=dataclasses.replace(calibration.GOPRO.sfm, max_points=200))


def _net(seed=5):
    return radial.RadialFlowNetwork(SPEC, H_WIN, device="cpu").init(
        torch.Generator().manual_seed(seed))


def _frames(seed=2 ** 35 + 1):
    """(N_FRAMES, B, H, W, 3) uint8: the benchmark's forward walks."""
    return traffic.camera_streams(traffic.device_generator(seed, "cpu"), B,
                                  N_FRAMES, (H, W), (23, 40), (3, 4),
                                  (0.01, 0.03))


def _ref_config(net):
    K = torch.as_tensor(CAL.K, dtype=torch.float32)
    weights = [(getattr(net.filter, f"layer{i}").weight.detach(),
                getattr(net.filter, f"layer{i}").bias.detach())
               for i in (1, 2)]
    return ref.Radial(W, H, K, CAL.sfm.max_points, CAL.sfm.points_quality,
                      CAL.bad_image_threshold, HI, WI, SPEC, weights, H_WIN,
                      1.0)


@pytest.fixture(scope="module")
def stream():
    """The estimator over the walks, each step's outputs and the EMA's
    state before it, and the counters' moves."""
    net = _net()
    frames = _frames()
    noise = traffic.device_generator(7, "cpu")
    noise = -torch.log(-torch.log(torch.rand(
        (64, 8, CAL.sfm.max_points), generator=noise).clamp(1e-30, 1 - 2 ** -24)))
    est = api_radial.BatchedRadialEstimator(net, CAL, HI, WI, device="cpu",
                                            ransac_noise=noise)
    before = dict(timer.COUNTERS)
    est.reset(frames[0])
    steps = []
    for k in range(1, N_FRAMES):
        last = est.e2
        steps.append((k, last, est.next_frames(frames[k])))
    moved = {n: timer.COUNTERS[n] - before.get(n, 0) for n in
             ("radial.pairs", "radial.bad_pairs", "radial.epipole_kept")}
    return net, frames, noise, steps, moved


def test_estimator_equals_the_reference(stream):
    net, frames, noise, steps, _ = stream
    cfg = _ref_config(net)
    for k, last, out in steps:
        want = ref.pairs(cfg, frames[k - 1], frames[k], noise, last)
        assert out.flow.dtype == torch.int32
        assert out.flow.shape == (B, HI - 4 - H_WIN + 1, WI)
        hw = int(HI * polar.get_k_output(HI, net.h_kernel, H_WIN))
        assert out.depth.shape == out.confs.shape == (B, hw, hw)
        for name in ("flow", "depth", "confs", "e2", "good"):
            torch.testing.assert_close(getattr(out, name), want[name],
                                       rtol=0, atol=0, msg=name)
    # the walks drive the whole chain: the gate passes, the flow moves
    # outward and the depth has confident pixels
    out = steps[-1][2]
    assert out.good.all()
    assert out.flow.max() > 0 and out.confs.sum() > 0


def test_counters_and_state(stream):
    _, _, _, steps, moved = stream
    bad = sum(int((~out.good).sum()) for _, _, out in steps)
    # an epipole kept from the step before is that step's, bit for bit
    kept = sum(int((out.e2 == last).all(-1).sum()) for _, last, out in steps
               if last is not None)
    assert moved == {"radial.pairs": B * len(steps), "radial.bad_pairs": bad,
                     "radial.epipole_kept": kept}
    # no smoothed epipole before the first step; the state after each step
    # is its output
    assert steps[0][1] is None
    torch.testing.assert_close(steps[1][1], steps[0][2].e2, rtol=0, atol=0)


@pytest.mark.parametrize("prev,e2", [
    (None, [[10.0, 5.0], [3.0, 4.0]]),
    ([[12.0, 6.0], [1.5, 2.5]], [[10.0, 5.0], [30.25, 40.5]]),
    ([[12.0, 6.0], [1.5, 2.5]], [[-1.0, 5.0], [10.0, 48.0]]),
    ([[12.0, 6.0], [1.5, 2.5]], [[64.0, 5.0], [10.0, -0.5]]),
])
def test_batched_ema_is_the_per_pair_one(prev, e2):
    e2 = np.asarray(e2, np.float32)
    prev_t = None if prev is None else torch.tensor(prev)
    got, kept = polar.smooth_epipole_batched(prev_t, torch.from_numpy(e2),
                                             48, 64)
    for i in range(2):
        p = None if prev is None else np.asarray(prev[i], np.float32)
        want = datasets.smooth_epipole(p, e2[i], 48, 64)
        np.testing.assert_array_equal(got[i].numpy(), want)
        inside = 0 <= e2[i][0] < 64 and 0 <= e2[i][1] < 48
        assert bool(kept[i]) == (prev is not None and not inside)


def test_batched_p2c_grid_and_flow2depth_are_the_per_pair_ones():
    """Centres and rmax in float64, as the estimator hands them; the
    per-pair forms take the same numbers as Python floats."""
    k_out = 0.91
    e2s = torch.tensor([[100.3, 56.25], [20.7, 180.1], [199.5, 0.4]])
    c = e2s.double() * k_out
    rmax = polar.get_rmax_batched(200, 200, e2s.double()) * k_out
    grids = polar.get_p2c_grid_batched(200, 178, 182, 182, c[:, 0].float(),
                                       c[:, 1].float(), rmax)
    rng = np.random.RandomState(3)
    flow = torch.from_numpy(rng.randint(0, 15, (3, 182, 182)).astype(np.float32))
    flow[:, :20] = 0.0
    infty = polar.get_rmax_batched(182, 182, c)
    depth, confs = polar.flow2depth_batched(flow, c.float(),
                                            (infty * 0.7).float())
    for i in range(3):
        ex, ey = float(e2s[i, 0]) * k_out, float(e2s[i, 1]) * k_out
        g = polar.get_p2c_grid(200, 178, 182, 182, ex, ey,
                               rmax=polar.get_rmax(200, 200, e2s[i].numpy())
                               * k_out, device="cpu")
        torch.testing.assert_close(grids[i], g, rtol=0, atol=0)
        d, cf = polar.flow2depth(182, 182, flow[i], (ex, ey), 0.7)
        torch.testing.assert_close(depth[i], d, rtol=0, atol=0)
        torch.testing.assert_close(confs[i], cf, rtol=0, atol=0)


def test_tester_writes_the_estimators_depth(tmp_path, monkeypatch):
    monkeypatch.setitem(calibration.PRESETS, CAL.name, CAL)
    frames = _frames(seed=11)[:, 0]
    seq = tmp_path / "seq"
    (seq / "images").mkdir(parents=True)
    for i, f in enumerate(frames.numpy()):
        (seq / "images" / f"{i:09d}.png").write_bytes(timages.encode_png(f))
    out_dir = tmp_path / "out"
    assert test_radial.main(["-rd", str(seq), "-cal", CAL.name, "-net",
                             "[[3,3,3,4],'tanh',[4,3,3,4]]", "-hwin",
                             str(H_WIN), "-hi", str(HI), "-wi", str(WI),
                             "-ni", "2", "-o", str(out_dir),
                             "--device", "cpu"]) == 0
    # the same frames through the estimator at B = 1, the tester's weights
    est = api_radial.BatchedRadialEstimator(
        radial.RadialFlowNetwork(SPEC, H_WIN, device="cpu").init(
            torch.Generator().manual_seed(0)), CAL, HI, WI, device="cpu")
    loader = timages.ImageLoader(str(seq), H, W)
    est.reset(torch.from_numpy(loader.get_next_frame()[None]))
    written = sorted(p.name for p in out_dir.iterdir())
    assert written == ["000000000.png", "000000001.png"]
    for name in written:
        out = est.next_frames(torch.from_numpy(loader.get_next_frame()[None]))
        assert bool(out.good[0])
        mine = tmp_path / f"mine_{name}"
        save_image(str(mine), polar.depth2color(out.depth[0], out.confs[0]))
        assert (out_dir / name).read_bytes() == mine.read_bytes()
