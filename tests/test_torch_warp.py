"""PyTorch port vs the JAX package: the banded warp's plain twin (kernel
B3's CPU path) against the Pallas kernel in interpret mode and the XLA
shift-sum, and the resampling, undistortion and rotation-compensation ops
around it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.data import images as jimages
from depth_estimation_tpu.flow import celiu as jceliu
from depth_estimation_tpu.geometry3d import calibration as jcal
from depth_estimation_tpu.geometry3d import undistort as jund
from depth_estimation_tpu.models import multiscale as jms
from depth_estimation_tpu.ops import warp as jwarp
from depth_estimation_tpu_torch.data import images as timages
from depth_estimation_tpu_torch.flow import celiu as tceliu
from depth_estimation_tpu_torch.geometry3d import undistort as tund
from depth_estimation_tpu_torch.models import multiscale as tms
from depth_estimation_tpu_torch.ops import warp as twarp

D = 3


def _t(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def _rot(ay, az):
    cy, sy, cz, sz = np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
    Ry = np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
    Rz = np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])
    return (Ry @ Rz).astype(np.float32)


def _field(rng, shape):
    """Displacements at the band's edges, at integers, and random ones."""
    special = np.array([0.0, 0.5, -0.5, 1.0, -1.0, 2.0, -4.0, D, -D, D + 0.5,
                        -D - 0.5, D + 1, -D - 1, D + 1.5, -D - 1.5, D + 2,
                        -D - 2, 0.25, -0.75], np.float32)
    f = rng.uniform(-D - 2.5, D + 2.5, size=shape).astype(np.float32)
    pick = rng.rand(*shape) < 0.5
    f[pick] = rng.choice(special, size=pick.sum())
    return f


@pytest.fixture(scope="module")
def warp_case():
    rng = np.random.RandomState(0)
    Bn, Hn, Wn, C = 2, 12, 16, 3
    imgs = rng.rand(Bn, Hn, Wn, C).astype(np.float32)
    ys = np.arange(Hn, dtype=np.float32)[None, :, None] + _field(rng, (Bn, Hn, Wn))
    xs = np.arange(Wn, dtype=np.float32)[None, None, :] + _field(rng, (Bn, Hn, Wn))
    ref = np.asarray(jwarp.banded_bilinear_warp(
        jnp.asarray(imgs), jnp.asarray(xs), jnp.asarray(ys), D, 16, True))
    return imgs, xs, ys, ref


def test_banded_plain_matches_pallas_interpret(warp_case):
    imgs, xs, ys, ref = warp_case
    ours = twarp.banded_bilinear_warp(_t(imgs), _t(xs), _t(ys), D).numpy()
    assert ours.shape == ref.shape and ours.dtype == np.float32
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)


def test_banded_plain_bf16_storage(warp_case):
    imgs, xs, ys, _ = warp_case
    ours = twarp.banded_bilinear_warp(_t(imgs).bfloat16(), _t(xs), _t(ys), D)
    q = _t(imgs).bfloat16().float().numpy()
    ref = np.asarray(jwarp.banded_bilinear_warp(
        jnp.asarray(q), jnp.asarray(xs), jnp.asarray(ys), D, 16, True))
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_banded_plain_f16_storage_matches_pallas_interpret():
    """f16 image storage: the twin against the Pallas kernel run in
    interpret mode on the f16 image itself (its scratch in the image's
    type, each tap upcast before the multiply), to f32 rounding."""
    rng = np.random.RandomState(5)
    Bn, Hn, Wn, C = 2, 24, 32, 6
    imgs = rng.rand(Bn, Hn, Wn, C).astype(np.float16)
    ys = np.arange(Hn, dtype=np.float32)[None, :, None] + _field(rng, (Bn, Hn, Wn))
    xs = np.arange(Wn, dtype=np.float32)[None, None, :] + _field(rng, (Bn, Hn, Wn))
    ref = np.asarray(jwarp.banded_bilinear_warp(
        jnp.asarray(imgs), jnp.asarray(xs), jnp.asarray(ys), D, 16, True))
    n0 = twarp.banded_bilinear_warp.launches
    ours = twarp.banded_bilinear_warp(_t(imgs), _t(xs), _t(ys), D)
    assert twarp.banded_bilinear_warp.launches == n0      # CPU: plain twin
    assert ours.dtype == torch.float32
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


K_SMALL = np.array([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]], np.float32)
ROTS = np.stack([_rot(0.02, 0.01), _rot(-0.06, 0.03), _rot(0.15, -0.05)])


@pytest.mark.parametrize("dtype", [None, "bf16", "f16"])
def test_remove_ego_motion_banded_matches_xla_form(dtype):
    rng = np.random.RandomState(1)
    imgs = rng.rand(3, 24, 32, 4).astype(np.float32)
    jdt = {None: None, "bf16": jnp.bfloat16, "f16": jnp.float16}[dtype]
    tdt = {None: None, "bf16": torch.bfloat16, "f16": torch.float16}[dtype]
    ref = np.asarray(jund._remove_ego_motion_banded_xla(
        jnp.asarray(imgs), K_SMALL, jnp.asarray(ROTS), D, jdt))
    ours = tund.remove_ego_motion_banded(_t(imgs), K_SMALL, _t(ROTS), D, tdt)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


def test_bilinear_sample_matches_jax():
    rng = np.random.RandomState(2)
    img = rng.rand(2, 9, 11, 3).astype(np.float32)
    x = rng.uniform(-2, 13, size=(2, 5, 7)).astype(np.float32)
    y = rng.uniform(-2, 11, size=(2, 5, 7)).astype(np.float32)
    x[0, 0, :3] = [0.0, 10.0, 4.0]
    ours = tceliu.bilinear_sample(_t(img), _t(x), _t(y)).numpy()
    ref = np.asarray(jceliu.bilinear_sample(jnp.asarray(img), jnp.asarray(x),
                                            jnp.asarray(y)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)
    ours1 = tceliu.bilinear_sample(_t(img[0]), _t(x[0]), _t(y[0])).numpy()
    np.testing.assert_allclose(ours1, ref[0], rtol=0, atol=1e-6)


def test_undistort_image_matches_jax():
    rng = np.random.RandomState(3)
    cal = jcal.ARDRONE
    img = rng.rand(2, 48, 64, 3).astype(np.float32)
    Ks = cal.K.copy()
    Ks[0] *= 64 / cal.wImg
    Ks[1] *= 48 / cal.hImg
    ours = tund.undistort_image(_t(img), Ks, cal.distortion).numpy()
    for b in range(2):
        ref = np.asarray(jund.undistort_image(jnp.asarray(img[b]), Ks,
                                              cal.distortion))
        np.testing.assert_allclose(ours[b], ref, rtol=0, atol=1e-5)


def test_remove_ego_motion_forms_match_jax():
    rng = np.random.RandomState(4)
    imgs = rng.rand(3, 24, 32, 4).astype(np.float32)
    ours = tund.remove_ego_motion_batched(_t(imgs), K_SMALL, _t(ROTS)).numpy()
    ref = np.asarray(jund.remove_ego_motion_batched(
        jnp.asarray(imgs), K_SMALL, jnp.asarray(ROTS)))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    ours_bf = tund.remove_ego_motion_batched(_t(imgs), K_SMALL, _t(ROTS),
                                             torch.bfloat16).numpy()
    ref_bf = np.asarray(jund.remove_ego_motion_batched(
        jnp.asarray(imgs), K_SMALL, jnp.asarray(ROTS), jnp.bfloat16))
    np.testing.assert_allclose(ours_bf, ref_bf, rtol=0, atol=1e-5)
    one = tund.remove_ego_motion(_t(imgs[1]), K_SMALL, _t(ROTS[1])).numpy()
    np.testing.assert_allclose(
        one, np.asarray(jund.remove_ego_motion(jnp.asarray(imgs[1]), K_SMALL,
                                               jnp.asarray(ROTS[1]))),
        rtol=0, atol=1e-5)


@pytest.mark.parametrize("band", [0, D])
def test_homography_grid_and_masks_match_jax(band):
    xs, ys = tund.homography_grid(K_SMALL, _t(ROTS), 24, 32)
    jxs, jys = jund.homography_grid(K_SMALL, jnp.asarray(ROTS), 24, 32)
    np.testing.assert_allclose(xs.numpy(), np.asarray(jxs), rtol=1e-6, atol=1e-4)
    np.testing.assert_allclose(ys.numpy(), np.asarray(jys), rtol=1e-6, atol=1e-4)
    m = tund.ego_motion_valid_mask(K_SMALL, _t(ROTS), 24, 32, band).numpy()
    jm = np.asarray(jund.ego_motion_valid_mask(K_SMALL, jnp.asarray(ROTS), 24,
                                               32, band))
    np.testing.assert_array_equal(m, jm)
    for r in ROTS:
        assert bool(tund.warp_in_band(K_SMALL, _t(r[None]), 24, 32, D)) == \
            bool(jund.warp_in_band(K_SMALL, jnp.asarray(r[None]), 24, 32, D))


def test_remove_ego_motion_exact_takes_both_branches():
    """In-band rotations go through the banded warp, out-of-band ones
    through the gather; both agree with the reference's lax.cond."""
    rng = np.random.RandomState(5)
    imgs = rng.rand(2, 24, 32, 4).astype(np.float32)
    for rots, covered in ((ROTS[:1].repeat(2, 0), True), (ROTS[1:], False)):
        assert bool(tund.warp_in_band(K_SMALL, _t(rots), 24, 32, D)) is covered
        ours = tund.remove_ego_motion_exact(_t(imgs), K_SMALL, _t(rots), D)
        ref = np.asarray(jund.remove_ego_motion_exact(
            jnp.asarray(imgs), K_SMALL, jnp.asarray(rots), D))
        np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)


@pytest.mark.parametrize("size", [(7, 10), (30, 41), (48, 64)])
def test_scale_matches_jax(size):
    rng = np.random.RandomState(6)
    frames = rng.rand(2, 24, 32, 3).astype(np.float32)
    h, w = size
    ours = timages.scale_batched_device(_t(frames), h, w).numpy()
    ref = np.asarray(jimages.scale_batched_device(jnp.asarray(frames), h, w))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
    one = timages.scale(_t(frames[0]), h, w).numpy()
    np.testing.assert_allclose(
        one, np.asarray(jimages.scale(jnp.asarray(frames[0]), h, w)),
        rtol=1e-5, atol=1e-5)


def test_avg_downsample_matches_jax():
    rng = np.random.RandomState(7)
    img = rng.rand(2, 13, 17, 3).astype(np.float32)
    for r in (1, 2, 4):
        np.testing.assert_allclose(
            tms.avg_downsample(_t(img), r).numpy(),
            np.asarray(jms.avg_downsample(jnp.asarray(img), r)),
            rtol=1e-6, atol=1e-7)
