"""PyTorch port vs the JAX package: the offline ego-motion pieces of
``geometry3d/egomotion.py`` — the full-image pyramidal LK (``track_lk``)
with its bilinear patch sampler, ``get_ego_motion(tracker="full")``, the
4-DoF least-squares model with its RANSAC, the nearest-neighbour affine
warp, and the epipolar helpers. RANSAC is fed the reference's own draws
(Gumbel noise at key 1, sample indices at key 0).

Tolerances: patches within 1e-6 (the reference blends through selection
products, which may fuse a multiply-add); LK tracks within 1e-3 px; the
4-DoF fit within 1e-5; the affine warp bit-equal; R and T within 1e-4 on
scenes whose RANSAC winner is 8 distinct points (seeds 3 and 5, as in
tests/test_torch_egomotion.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.geometry3d import egomotion as jego
from depth_estimation_tpu_torch.geometry3d import egomotion as tego
from torch_parity import parallax_frames, ransac_noise, shift_x, texture

H, W, F, NPTS = 96, 128, 100.0, 200
K = np.array([[F, 0, W / 2], [0, F, H / 2], [0, 0, 1]], np.float32)


def t(x):
    return torch.from_numpy(np.array(x))


@pytest.fixture(scope="module")
def scenes():
    return [parallax_frames(np.random.RandomState(s), H, W) for s in (3, 5)]


@pytest.fixture(scope="module")
def corners(scenes):
    pts, valid = jego.good_features_to_track(jnp.asarray(scenes[0][0]), 60,
                                             0.001)
    return np.asarray(pts), np.asarray(valid)


def test_sample_patches_match_jax(scenes, corners):
    img = scenes[0][0][..., 1]
    pts = corners[0] + np.float32(0.37)
    pts[:3] = [[-4.2, 7.5], [W + 3.0, 1.0], [W - 1.0, H - 1.0]]  # clamped
    ref = np.asarray(jego._sample_patches(jnp.asarray(img), jnp.asarray(pts), 15))
    ours = tego._sample_patches(t(img)[None], t(pts)[None], 15)[0].numpy()
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_track_lk_recovers_a_known_shift():
    """A smooth texture moved by (+1.5, -2.25) px: interior tracks recover
    it to 0.05 px."""
    rng = np.random.RandomState(0)
    img = texture(rng, H + 16, W + 16)
    dy, dx = -2.25, 1.5
    yy, xx = np.meshgrid(np.arange(H) + 8.0, np.arange(W) + 8.0, indexing="ij")
    warped = np.stack([
        np.asarray(jax.scipy.ndimage.map_coordinates(
            jnp.asarray(img[..., c]), [yy - dy, xx - dx], order=1))
        for c in range(3)], -1).astype(np.float32)
    first = img[8:8 + H, 8:8 + W]
    pts, valid = tego.good_features_to_track(t(first), 40, 0.001)
    pts2, status = tego.track_lk(t(first), t(warped), pts)
    ok = (valid & status).numpy()
    assert ok.sum() >= 20
    d = (pts2 - pts).numpy()[ok]
    np.testing.assert_allclose(np.median(d, axis=0), [dx, dy], atol=0.05)


def test_track_lk_matches_jax(scenes, corners):
    f1, f2 = scenes[1][0], scenes[1][1]
    pts = corners[0]
    jp2, js = jego.track_lk(jnp.asarray(f1), jnp.asarray(f2), jnp.asarray(pts))
    tp2, ts = tego.track_lk(t(f1), t(f2), t(pts))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    np.testing.assert_allclose(tp2.numpy(), np.asarray(jp2), rtol=0, atol=1e-3)


def test_track_lk_batched_equals_per_pair(scenes, corners):
    f1 = np.stack([s[0] for s in scenes])
    f2 = np.stack([s[1] for s in scenes])
    pts = np.stack([corners[0], corners[0][::-1].copy()])
    bp, bs = tego.track_lk_batched(t(f1), t(f2), t(pts))
    for k in range(2):
        p, s = tego.track_lk(t(f1[k]), t(f2[k]), t(pts[k]))
        np.testing.assert_array_equal(bs[k].numpy(), s.numpy())
        np.testing.assert_allclose(bp[k].numpy(), p.numpy(), rtol=0, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1])
def test_get_ego_motion_full_tracker_matches_jax(scenes, seed):
    f1, f2 = scenes[seed][0], scenes[seed][1]
    jem = jego.get_ego_motion(jnp.asarray(f1), jnp.asarray(f2), K, NPTS,
                              tracker="full")
    tem = tego.get_ego_motion(t(f1), t(f2), K, NPTS,
                              noise=t(ransac_noise(64, NPTS)), tracker="full")
    assert int(tem.n_found) == int(jem.n_found)
    assert int(tem.n_inliers) == int(jem.n_inliers)
    np.testing.assert_allclose(tem.R.numpy(), np.asarray(jem.R), atol=1e-4)
    np.testing.assert_allclose(tem.T.numpy(), np.asarray(jem.T), atol=1e-3)


def test_get_ego_motion_rejects_unknown_tracker(scenes):
    with pytest.raises(ValueError, match="tracker"):
        tego.get_ego_motion(t(scenes[0][0]), t(scenes[0][1]), K, 20,
                            tracker="sparse")


def _mc_points(seed, n=40, noise=0.3):
    rng = np.random.RandomState(seed)
    pin = (rng.rand(n, 2) * [W, H]).astype(np.float32)
    th = 0.03
    c, s = np.cos(th), np.sin(th)
    ctr = np.array([W / 2, H / 2], np.float32)
    rot = (pin - ctr) @ np.array([[c, -s], [s, c]], np.float32).T + ctr
    pout = (rot * 1.01 + [2.0, -1.0] + noise * rng.randn(n, 2)).astype(np.float32)
    pout[:6] += (20 * rng.randn(6, 2)).astype(np.float32)    # outliers
    return pin, pout


@pytest.mark.parametrize("weighted", [False, True])
def test_lsq_trans_matches_jax(weighted):
    pin, pout = _mc_points(0)
    w = np.random.RandomState(1).rand(len(pin)).astype(np.float32)
    kw = {"weights": w} if weighted else {}
    jH, jx = jego.lsq_trans(jnp.asarray(pin), jnp.asarray(pout), W / 2, H / 2,
                            **{k: jnp.asarray(v) for k, v in kw.items()})
    tH, tx = tego.lsq_trans(t(pin), t(pout), W / 2, H / 2,
                            **{k: t(v) for k, v in kw.items()})
    np.testing.assert_allclose(tx.numpy(), np.asarray(jx), rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_lsq_trans_ransac_matches_jax_on_its_draw(seed):
    pin, pout = _mc_points(seed, noise=0.05)
    idx = np.asarray(jax.random.randint(jax.random.PRNGKey(0), (64, 5), 0,
                                        len(pin)))
    jH, jn = jego.lsq_trans_ransac(jnp.asarray(pin), jnp.asarray(pout),
                                   W / 2, H / 2)
    tH, tn = tego.lsq_trans_ransac(t(pin), t(pout), W / 2, H / 2,
                                   sample_idx=idx)
    assert int(tn) == int(jn)
    np.testing.assert_allclose(tH.numpy(), np.asarray(jH), rtol=1e-5, atol=1e-5)


def test_lsq_trans_ransac_default_draw_is_seeded():
    pin, pout = _mc_points(0, noise=0.05)
    a = tego.lsq_trans_ransac(t(pin), t(pout), W / 2, H / 2)
    b = tego.lsq_trans_ransac(t(pin), t(pout), W / 2, H / 2)
    np.testing.assert_array_equal(a[0].numpy(), b[0].numpy())
    assert int(a[1]) >= len(pin) - 6 - 4


@pytest.mark.parametrize("channels", [None, 3])
def test_warp_affine_bit_equal(channels):
    rng = np.random.RandomState(4)
    img = rng.rand(*((H, W) if channels is None else (H, W, channels)))
    img = img.astype(np.float32)
    th = 0.05
    Hm = np.array([[np.cos(th), np.sin(th), 3.3],
                   [-np.sin(th), np.cos(th), -2.7]], np.float32)
    ref = np.asarray(jego.warp_affine(jnp.asarray(img), jnp.asarray(Hm)))
    ours = tego.warp_affine(t(img), t(Hm)).numpy()
    np.testing.assert_array_equal(ours, ref)
    assert (ours == 0).any()


def test_epipolar_helpers_match_jax():
    rng = np.random.RandomState(5)
    q, _ = np.linalg.qr(rng.randn(3, 3))
    R = (q * np.sign(np.linalg.det(q))).astype(np.float32)
    T = np.array([0.1, -0.2, 0.97], np.float32)
    E = np.asarray(jego.essential_from_rt(jnp.asarray(R), jnp.asarray(T)))
    np.testing.assert_allclose(tego.essential_from_rt(t(R), t(T)).numpy(), E,
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(
        tego.fundamental_from_essential(t(E), K).numpy(),
        np.asarray(jego.fundamental_from_essential(jnp.asarray(E), K)),
        rtol=1e-5, atol=1e-9)
    np.testing.assert_allclose(tego.epipole(K, t(T)).numpy(),
                               np.asarray(jego.epipole(K, jnp.asarray(T))),
                               rtol=1e-6)
