"""PyTorch port vs the JAX package: the polar part of ``data/datasets.py``
and the batched polar grid of ``geometry3d/polar.py`` — the host numpy
pieces (``flow_norm``, ``project_groundtruth``, ``saturate_groundtruth``,
``smooth_epipole``, ``generate_polar_training_patches``), the grid and
rmax of a tensor epipole, the GT projection and polar warp, the batched
loader ``load_polar_pairs_batched`` (with and without ``max_flow`` and
``pixel_frames``), ``load_polar_pair`` and ``load_polar_pair_reference``.

Frames: a forward camera step over two depth planes (top plane zoom 1.03,
bottom 1.10, about the centre) on Gaussian-smoothed noise at 96x128, as
tests/test_datasets.py builds them; RANSAC gets the reference's own draws.
Tolerances:
  * the numpy pieces, rmax, and the samples drawn from the same pairs:
    bit-equal;
  * the grid of the same epipole within 3e-5 px (sin and cos of the two
    libraries part by an ulp, times radii up to 160), and the GT
    projected and warped from the same inputs within 1e-4 polar rows
    (5.2e-5 read: that grid difference across the GT's unit steps) with
    its mask equal on >= 0.999 of the pixels;
  * the loaders: the essential matrix comes from a QR and an SVD of the
    winning 8 points in LAPACK builds that round apart, and on these
    small forward-motion scenes the epipole K T / T_z moves by up to a
    few 1e-3 px for a 1e-5 change of T (seeds 8 and 3 are the scenes
    whose winners keep it under 1e-3 px: e2 within 1e-3 px). The polar
    images follow the epipole: within 1.5e-3 (JAX's own batched against
    per-pair bound is 2e-3); masks and GT masks equal on >= 0.999 of the
    pixels (JAX's: 0.995); the GT, a bilinear interpolation of integer
    projections, within 1e-2 polar rows at every pixel and its rounded
    targets floor(gt + 0.5) equal on >= 0.99 of the valid pixels (JAX's:
    equal on 0.95, |diff| <= 1).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.data import datasets as jds
from depth_estimation_tpu.flow.celiu import bilinear_sample, gaussian_smooth
from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.geometry3d import calibration as jcal
from depth_estimation_tpu.geometry3d import polar as jpolar
from depth_estimation_tpu_torch.data import datasets as tds
from depth_estimation_tpu_torch.geometry import Geometry as TGeometry
from depth_estimation_tpu_torch.geometry3d import calibration as tcal
from depth_estimation_tpu_torch.geometry3d import polar as tpolar
from torch_parity import ransac_noise

H, W, NPTS = 96, 128, 200
HI = WI = 64
WK = 5
GT = dict(hImg=H, wImg=W, layers=((3, 8, 8, 8),), maxh=8, maxw=8,
          maxhGT=8, maxwGT=8, hKernelGT=8, wKernelGT=8)
JG, TG = JGeometry(**GT), TGeometry(**GT)
NOISE = ransac_noise(64, NPTS)
TOL_E2 = 1e-3
TOL_IMG = 1.5e-3
SHARE_MASK = 0.999
TOL_GT = 1e-2
SHARE_TARGET = 0.99


def calibration(mod):
    return dataclasses.replace(
        mod.RECTIFIED_GOPRO_SMALL, wImg=W, hImg=H, fx=120.0, fy=120.0,
        cx=W / 2, cy=H / 2,
        sfm=dataclasses.replace(mod.RECTIFIED_GOPRO_SMALL.sfm,
                                max_points=NPTS, points_quality=0.001))


JC, TC = calibration(jcal), calibration(tcal)


def forward_sequence(seed, n=2, s_top=1.03, s_bottom=1.10):
    """n frames of a forward step over two depth planes."""
    rng = np.random.RandomState(seed)
    base = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(H, W, 3).astype(np.float32)), 0.8, 2))
    frames = [np.clip(base * 1.5, 0, 1).astype(np.float32)]
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    s = np.where(yy < H / 2, s_top, s_bottom)
    xs = jnp.asarray(W / 2 + (xx - W / 2) / s)
    ys = jnp.asarray(H / 2 + (yy - H / 2) / s)
    for _ in range(n - 1):
        frames.append(np.asarray(bilinear_sample(jnp.asarray(frames[-1]),
                                                 xs, ys)))
    return frames


@pytest.fixture(scope="module")
def frames():
    """Two scenes interleaved, so delta=2 pairs each scene's frames."""
    a, b = forward_sequence(8), forward_sequence(3)
    return [a[0], b[0], a[1], b[1]]


@pytest.fixture(scope="module")
def noisy(frames):
    rng = np.random.RandomState(11)
    return [np.clip(f + rng.randn(*f.shape).astype(np.float32) * 0.1, 0, 1)
            for f in frames]


def assert_polar_pairs(ours, ref, gt=True):
    assert len(ours) == len(ref)
    for o, r in zip(ours, ref):
        assert o.good == r.good
        np.testing.assert_allclose(o.e2, np.asarray(r.e2), rtol=0, atol=TOL_E2)
        if not r.good:
            continue
        for k in ("polar_image", "polar_prev_image"):
            a, b = getattr(o, k), np.asarray(getattr(r, k))
            assert a.shape == b.shape
            np.testing.assert_allclose(a, b, rtol=0, atol=TOL_IMG)
        assert (o.polar_mask == r.polar_mask).mean() >= SHARE_MASK
        if not gt:
            assert o.polar_gt is None and r.polar_gt is None
            continue
        assert (o.polar_gt_mask == r.polar_gt_mask).mean() >= SHARE_MASK
        np.testing.assert_allclose(o.polar_gt, np.asarray(r.polar_gt), rtol=0,
                                   atol=TOL_GT)
        valid = np.asarray(r.polar_gt_mask) > 0.5
        assert valid.mean() > 0.05
        same = (np.floor(o.polar_gt + 0.5)
                == np.floor(np.asarray(r.polar_gt) + 0.5))[valid]
        assert same.mean() >= SHARE_TARGET


# ---------------------------------------------------------------------------
# host numpy pieces
# ---------------------------------------------------------------------------

def test_projection_and_saturation_are_bit_equal():
    rng = np.random.RandomState(0)
    flow = (rng.randn(2, 20, 30) * 3).astype(np.float32)
    gds = (rng.rand(20, 30) > 0.2).astype(np.float32)
    e2 = np.array([13.3, 8.7], np.float32)
    np.testing.assert_array_equal(tds.flow_norm(flow), jds.flow_norm(flow))
    ours = tds.project_groundtruth(flow, gds, e2)
    ref = jds.project_groundtruth(flow, gds, e2)
    for a, b in zip(ours + tds.saturate_groundtruth(*ours, 2.5),
                    ref + jds.saturate_groundtruth(*ref, 2.5)):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("prev,e2", [
    (None, (10.0, 5.0)),
    ((12.0, 6.0), (10.0, 5.0)),
    ((12.0, 6.0), (-1.0, 5.0)),
    ((12.0, 6.0), (10.0, 48.0)),
])
def test_smooth_epipole_is_bit_equal(prev, e2):
    prev = None if prev is None else np.asarray(prev, np.float32)
    e2 = np.asarray(e2, np.float32)
    np.testing.assert_array_equal(tds.smooth_epipole(prev, e2, 48, 64),
                                  jds.smooth_epipole(prev, e2, 48, 64))


@pytest.mark.parametrize("with_gt", [False, True])
def test_polar_patch_sampler_is_bit_equal(with_gt):
    rng = np.random.RandomState(1)
    kw = dict(polar_image=rng.rand(40, 36, 3).astype(np.float32),
              polar_prev_image=rng.rand(40, 36, 3).astype(np.float32),
              polar_mask=(rng.rand(40, 36) > 0.02).astype(np.float32),
              e2=np.zeros(2, np.float32), good=True)
    if with_gt:
        kw.update(polar_gt=(rng.rand(40, 36) * 7).astype(np.float32),
                  polar_gt_mask=(rng.rand(40, 36) > 0.3).astype(np.float32))
    ours = tds.generate_polar_training_patches(
        tds.PolarPair(**kw), 11, 5, 5, 50, np.random.RandomState(2))
    ref = jds.generate_polar_training_patches(
        jds.PolarPair(**kw), 11, 5, 5, 50, np.random.RandomState(2))
    assert len(ours[2]) == 50
    for a, b in zip(ours, ref):
        assert a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
    assert tds.generate_polar_training_patches(
        tds.PolarPair(**dict(kw, polar_mask=np.zeros((40, 36), np.float32))),
        11, 5, 5, 3, np.random.RandomState(0)) is None


# ---------------------------------------------------------------------------
# the traced grid and the GT projection on the same inputs
# ---------------------------------------------------------------------------

E2S = np.array([[60.3, 45.9], [20.7, 80.1], [-3.2, 50.0]], np.float32)


def test_batched_grid_and_rmax_match_the_traced_reference():
    def one(e2):
        rmax = jds._rmax_traced(H, W, e2[0], e2[1])
        return rmax, jpolar.get_c2p_grid(W, H, WI, HI, e2[0], e2[1],
                                         lpadding=2, rpadding=2, rmax=rmax)
    jr, jgrid = jax.jit(jax.vmap(one))(jnp.asarray(E2S))
    e2 = torch.from_numpy(E2S)
    rmax = tpolar.get_rmax_batched(H, W, e2)
    grid = tpolar.get_c2p_grid_batched(W, H, WI, HI, e2[:, 0], e2[:, 1],
                                       rmax, lpadding=2, rpadding=2)
    np.testing.assert_array_equal(rmax.numpy(), np.asarray(jr))
    assert grid.shape == (3, 2, HI, WI + 4)
    np.testing.assert_allclose(grid.numpy(), np.asarray(jgrid), rtol=0,
                               atol=3e-5)
    # the float API on the same epipole
    for k in range(3):
        f = tpolar.get_c2p_grid(W, H, WI, HI, float(E2S[k, 0]),
                                float(E2S[k, 1]), 2, 2,
                                tpolar.get_rmax(H, W, E2S[k]), device="cpu")
        np.testing.assert_allclose(grid[k].numpy(), f.numpy(), rtol=0,
                                   atol=3e-5)


@pytest.mark.parametrize("max_flow", [6.0, float("inf")])
def test_polar_gt_projection_matches_jax(max_flow):
    """The GT of forward motion (radial flow k (p - c) from a centre near
    each epipole, quantized), with unconfident blocks and a masked border."""
    B = 3
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    k = np.array([0.05, 0.08, 0.12], np.float32)[:, None, None]
    fy = np.floor(k * (yy - E2S[:, 1, None, None] - 1.5) + 0.5)
    fx = np.floor(k * (xx - E2S[:, 0, None, None] + 2.5) + 0.5)
    conf = np.ones((B, H, W), np.float32)
    conf[:, 10:30, 40:70] = 0
    mask = np.zeros((B, H, W), np.float32)
    mask[:, 3:-3, 4:-4] = 1
    jgt, jm = jds._polar_gt_batch_device(
        *(jnp.asarray(a) for a in (fy, fx, conf, mask, E2S)), H, W, HI, WI,
        WK, max_flow)
    gt, m = tds.polar_gt_batch(*(torch.from_numpy(a) for a in
                                 (fy, fx, conf, mask, E2S)),
                               H, W, HI, WI, WK, max_flow)
    assert np.isfinite(gt.numpy()).all()
    np.testing.assert_allclose(gt.numpy(), np.asarray(jgt), rtol=0, atol=1e-4)
    assert (m.numpy() == np.asarray(jm)).mean() >= 0.999
    assert m.numpy().mean() > 0.05


# ---------------------------------------------------------------------------
# the loaders
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("max_flow", [6.0, None])
@pytest.mark.parametrize("pixels", [False, True])
def test_batched_polar_loader_matches_jax(frames, noisy, max_flow, pixels):
    pix = noisy if pixels else None
    ref = jds.load_polar_pairs_batched(JC, frames, H, W, HI, WI, WK,
                                       geom_gt=JG, max_flow=max_flow,
                                       delta=2, pixel_frames=pix)
    ours = tds.load_polar_pairs_batched(TC, frames, H, W, HI, WI, WK,
                                        geom_gt=TG, max_flow=max_flow,
                                        delta=2, pixel_frames=pix,
                                        noise=NOISE, device="cpu")
    assert len(ours) == 2 and all(p.good for p in ours)
    assert_polar_pairs(ours, ref)


def test_polar_loader_without_gt_and_one_pair(frames):
    ours = tds.load_polar_pairs_batched(TC, frames, H, W, HI, WI, WK,
                                        delta=2, noise=NOISE, device="cpu")
    ref = jds.load_polar_pairs_batched(JC, frames, H, W, HI, WI, WK, delta=2)
    assert_polar_pairs(ours, ref, gt=False)
    one = tds.load_polar_pair(TC, frames[0], frames[2], H, W, HI, WI, WK,
                              noise=NOISE, device="cpu")
    for k in ("polar_image", "polar_prev_image", "polar_mask", "e2"):
        np.testing.assert_array_equal(getattr(one, k), getattr(ours[0], k))
    with pytest.raises(ValueError, match="index-aligned"):
        tds.load_polar_pairs_batched(TC, frames, H, W, HI, WI, WK,
                                     pixel_frames=frames[:3], noise=NOISE,
                                     device="cpu")


def test_per_pair_reference_matches_jax(frames):
    ref = jds.load_polar_pair_reference(JC, frames[1], frames[3], H, W, HI,
                                        WI, WK, geom_gt=JG, max_flow=6.0)
    ours = tds.load_polar_pair_reference(TC, frames[1], frames[3], H, W, HI,
                                         WI, WK, geom_gt=TG, max_flow=6.0,
                                         noise=NOISE, device="cpu")
    assert ours.good
    assert_polar_pairs([ours], [ref])
