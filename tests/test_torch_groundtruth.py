"""PyTorch port vs the JAX package: the flow ground-truth generators
(``data/groundtruth.py``) and the decode they share with the model
(``models/flow.process_output``, ``soft_argmax``).

The exhaustive GT in both heads on a small geometry, ``process_output`` in
its four branches, ``liu_flow`` (kernel B4's path; its plain twin here) at
the trainer's parameters, and the disk caches read across packages.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.data import groundtruth as jgt
from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.models import flow as jflow
from depth_estimation_tpu_torch.data import groundtruth as tgt
from depth_estimation_tpu_torch.geometry import Geometry as TGeometry
from depth_estimation_tpu_torch.models import flow as tflow
from test_torch_celiu import SOLVE_TOL, shifted_pair

H, W = 24, 32
GT_KW = dict(hImg=H, wImg=W, layers=((3, 5, 5, 8),), maxh=6, maxw=6,
             maxhGT=6, maxwGT=6, hKernelGT=5, wKernelGT=5)
# patch SSD sums 5x5x3 squared differences; the packages add them in other
# orders (separable box sum here, XLA's window sum there), which moves a
# cost by a few 1e-6, so a WTA index may differ only where the two best
# costs are that close
TIE = 1e-4


def geometries(**over):
    kw = dict(GT_KW, **over)
    return JGeometry(**kw), TGeometry(**kw)


def gt_pair(seed=0, n=None):
    """Smooth frames and the same frames moved by (1, 2) px plus noise."""
    rng = np.random.RandomState(seed)
    lead = () if n is None else (n,)
    a = rng.rand(*lead, H + 4, W + 4, 3).astype(np.float32)
    a = (a + np.roll(a, 1, -2) + np.roll(a, 1, -3)) / 3
    img1 = a[..., 2:2 + H, 2:2 + W, :]
    img2 = a[..., 1:1 + H, 0:W, :] + 0.02 * rng.rand(*lead, H, W, 3)
    return (np.ascontiguousarray(img1, np.float32),
            np.ascontiguousarray(img2, np.float32))


def _near_tie(costs):
    s = np.sort(costs, axis=-1)
    return (s[..., 1] - s[..., 0]) < TIE


def test_gt_geometry_matches_jax():
    jg, tg = geometries()
    assert dataclasses.asdict(tgt.gt_geometry(tg)) == \
        dataclasses.asdict(jgt.gt_geometry(jg))


def test_patch_ssd_costs_match_jax():
    img1, img2 = gt_pair(1)
    ref = np.asarray(jgt.patch_ssd_costs(jnp.asarray(img1), jnp.asarray(img2),
                                         5, 5, 6, 6))
    ours = tgt.patch_ssd_costs(torch.from_numpy(img1), torch.from_numpy(img2),
                               5, 5, 6, 6).numpy()
    assert ours.shape == ref.shape == (H - 6 - 5 + 2, W - 6 - 5 + 2, 36)
    np.testing.assert_allclose(ours, ref, rtol=1e-6, atol=1e-5)


@pytest.mark.parametrize("method", ["max", "mean"])
def test_exhaustive_flow_matches_jax(method):
    jg, tg = geometries()
    img1, img2 = gt_pair(2)
    ref = jgt.exhaustive_flow(jg, img1, img2, method)
    ours = tgt.exhaustive_flow(tg, img1, img2, method, device="cpu")
    for o, r in zip(ours, ref):
        assert isinstance(o, np.ndarray) and o.shape == r.shape == (H, W)
    costs = tgt.patch_ssd_costs(torch.from_numpy(img1), torch.from_numpy(img2),
                                5, 5, 6, 6).numpy()
    h0, w0 = (H - costs.shape[0]) // 2, (W - costs.shape[1]) // 2
    tie = np.zeros((H, W), bool)
    tie[h0:h0 + costs.shape[0], w0:w0 + costs.shape[1]] = _near_tie(costs)
    if method == "max":
        for o, r in zip(ours[:2], ref[:2]):
            assert (o != r)[~tie].sum() == 0
        assert (ours[1] == 2).mean() > 0.3 and (ours[0] == 1).mean() > 0.3
    else:
        for o, r in zip(ours[:2], ref[:2]):
            np.testing.assert_allclose(o, r, rtol=0, atol=1e-5)
    np.testing.assert_array_equal(ours[2], ref[2])


def test_exhaustive_flow_batched_matches_single():
    """Chunks of 2 over 3 pairs (a ragged tail): every item equals the
    single-pair generator; the port drops the reference's mesh argument."""
    _, tg = geometries()
    imgs1, imgs2 = gt_pair(3, n=3)
    for method in ("max", "mean"):
        fy, fx, conf = tgt.exhaustive_flow_batched(tg, imgs1, imgs2, chunk=2,
                                                   method=method, device="cpu")
        assert fy.shape == fx.shape == conf.shape == (3, H, W)
        for b in range(3):
            one = tgt.exhaustive_flow(tg, imgs1[b], imgs2[b], method,
                                      device="cpu")
            for got, want in zip((fy[b], fx[b], conf[b]), one):
                np.testing.assert_allclose(got, want, rtol=0, atol=1e-6)


DIST_SHAPE = (5, 7, 36)


def _dist(seed=4):
    rng = np.random.RandomState(seed)
    d = rng.dirichlet(np.full(36, 0.2), size=DIST_SHAPE[:2]).astype(np.float32)
    d[0, 0] = 1.0 / 36                               # all tie: middle cell wins
    return d


@pytest.mark.parametrize("method", ["max", "mean"])
@pytest.mark.parametrize("threshold", [None, 0.3])
def test_process_output_matches_jax(method, threshold):
    jg, tg = geometries(hImg=9, wImg=11)
    dist = _dist()
    ref = jflow.process_output(jgt.gt_geometry(jg), jnp.asarray(dist), True,
                               threshold, method)
    ours = tflow.process_output(tgt.gt_geometry(tg), torch.from_numpy(dist),
                                True, threshold, method)
    for name in ("index", "y", "x", "confidences", "full", "full_confidences"):
        r, o = getattr(ref, name), getattr(ours, name)
        if r is None:
            assert o is None, name
            continue
        np.testing.assert_allclose(o.numpy().astype(np.float64),
                                   np.asarray(r).astype(np.float64),
                                   rtol=0, atol=1e-6, err_msg=name)
    assert tuple(ours.full.shape) == (2, 9, 11)
    # leading dims pass through: a batch decodes like its items
    batch = tflow.process_output(tgt.gt_geometry(tg),
                                 torch.from_numpy(np.stack([dist, _dist(5)])),
                                 True, threshold, method)
    assert tuple(batch.full.shape) == (2, 2, 9, 11)
    np.testing.assert_allclose(batch.full[0].numpy(), ours.full.numpy(),
                               rtol=0, atol=1e-6)


def test_soft_argmax_matches_jax():
    jg, tg = geometries()
    dist = _dist(6)
    ref = jflow.soft_argmax(jgt.gt_geometry(jg), jnp.asarray(dist))
    ours = tflow.soft_argmax(tgt.gt_geometry(tg), torch.from_numpy(dist))
    for o, r in zip(ours, ref):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0, atol=1e-6)


def test_liu_flow_matches_jax(monkeypatch):
    """The 'liu' GT at the trainer's parameters (0.005, 0.75, 30, 5/1/40),
    48x64 (2 levels): the JAX liu_flow with its solver jitted (eager ops
    compile per shape, which is slow on the CPU), the port through the plain
    SOR twin."""
    from depth_estimation_tpu.flow import celiu as jcel
    monkeypatch.setattr(jcel, "coarse2fine_flow", jax.jit(
        jcel.coarse2fine_flow, static_argnames=(
            "alpha", "ratio", "min_width", "n_outer", "n_inner", "n_sor",
            "noise_model", "interpolation")))
    im1, im2 = shifted_pair(48, 64, 3, 8, dy=1, dx=2)
    ref = jgt.liu_flow(jnp.asarray(im1), jnp.asarray(im2))
    fy, fx = tgt.liu_flow(im1, im2, device="cpu")
    assert fy.shape == fx.shape == (48, 64)
    np.testing.assert_allclose(fy, ref[0], rtol=SOLVE_TOL, atol=SOLVE_TOL)
    np.testing.assert_allclose(fx, ref[1], rtol=SOLVE_TOL, atol=SOLVE_TOL)
    assert abs(np.median(fx[8:-8, 8:-8]) - 2) < 0.25
    assert abs(np.median(fy[8:-8, 8:-8]) - 1) < 0.25


def test_caches_read_across_packages(tmp_path):
    """Files written by either package read in the other, for both caches,
    at the same parameter-encoded paths."""
    jg, tg = geometries()
    root = str(tmp_path)
    rng = np.random.RandomState(9)
    fy, fx, conf = (rng.randn(H, W).astype(np.float32) for _ in range(3))
    assert tgt._cache_path(root, tg, 2, "a", "mean") == \
        jgt._cache_path(root, jg, 2, "a", "mean")
    assert tgt.liu_cache_path(root, tg, 2, "a") == \
        jgt.liu_cache_path(root, jg, 2, "a")
    # cross-correlation cache, both directions and both heads
    tgt.store_cached_flow(root, tg, 1, "p", fy, fx, conf, "max")
    for a, b in zip(jgt.load_cached_flow(root, jg, 1, "p", "max"), (fy, fx, conf)):
        np.testing.assert_array_equal(a, b)
    jgt.store_cached_flow(root, jg, 3, "q", fx, fy, conf, "mean")
    for a, b in zip(tgt.load_cached_flow(root, tg, 3, "q", "mean"), (fx, fy, conf)):
        np.testing.assert_array_equal(a, b)
    assert tgt.load_cached_flow(root, tg, 3, "q", "max") is None
    # liu cache, both directions; a hit is served without a solve
    tgt.store_cached_liu_flow(root, tg, 1, "p", fy, fx)
    for a, b in zip(jgt.cached_liu_flow(root, jg, 1, "p", None, None), (fy, fx)):
        np.testing.assert_array_equal(a, b)
    jgt.store_cached_liu_flow(root, jg, 2, "q", fx, fy)
    for a, b in zip(tgt.cached_liu_flow(root, tg, 2, "q", None, None), (fx, fy)):
        np.testing.assert_array_equal(a, b)
    # a wrong-shape entry is recomputed (and the result stored)
    tgt.store_cached_flow(root, tg, 4, "r", fy[:3], fx[:3], conf[:3])
    img1, img2 = gt_pair(10)
    got = tgt.cached_exhaustive_flow(root, tg, 4, "r", img1, img2, device="cpu")
    want = tgt.exhaustive_flow(tg, img1, img2, device="cpu")
    for a, b in zip(got, want):
        np.testing.assert_array_equal(a, b)
    for a, b in zip(jgt.load_cached_flow(root, jg, 4, "r"), want):
        np.testing.assert_array_equal(a, b)


def test_generators_default_to_the_card(monkeypatch):
    """Without a device named the generators run on the card; with none
    visible they raise instead of carrying on on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    _, tg = geometries()
    img1, img2 = gt_pair(11)
    for call in (lambda: tgt.exhaustive_flow(tg, img1, img2),
                 lambda: tgt.exhaustive_flow_batched(tg, img1[None], img2[None]),
                 lambda: tgt.liu_flow(img1, img2)):
        with pytest.raises(RuntimeError, match="cuda"):
            call()
