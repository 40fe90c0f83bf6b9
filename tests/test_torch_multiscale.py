"""PyTorch port vs the JAX package: the multiscale model (mirroring
tests/test_multiscale.py). The same numpy images and the same weights,
carried across from the JAX ``init`` through
``models.io.multiscale_state_from_jax``, go through both packages."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.models import multiscale as jms
from depth_estimation_tpu_torch import codecs as tcodecs
from depth_estimation_tpu_torch.geometry import Geometry as TGeometry
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.models import multiscale as tms

RATIOS = [(1, 2), (1, 2, 4)]
DTYPES = {"none": (None, None), "f16": (jnp.float16, torch.float16)}


def geometries(ratios, **kw):
    g = dict(hImg=32, wImg=40, layers=((3, 5, 5, 6),), maxh=4, maxw=4,
             multiscale=True, ratios=ratios)
    g.update(kw)
    return JGeometry(**g), TGeometry(**g)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def models(ratios, decode=None, seed=1, **kw):
    """(JAX model, JAX params, port model) on the same weights."""
    jg, tg = geometries(ratios, **kw)
    jdt, tdt = DTYPES[decode] if decode else (None, None)
    jm = jms.MultiscaleFlowModel(jg, decode_dtype=jdt)
    params = jm.init(jax.random.PRNGKey(seed))
    tm = tms.MultiscaleFlowModel(tg, decode_dtype=tdt, device="cpu")
    tm.load_state_dict(tio.multiscale_state_from_jax(tg, numpy_tree(params)))
    return jm, params, tm


def images(seed, shape=(32, 40, 3)):
    rng = np.random.RandomState(seed)
    return (rng.rand(*shape).astype(np.float32),
            rng.rand(*shape).astype(np.float32))


@pytest.mark.parametrize("window", [(8, 8), (4, 6), (5, 5)])
@pytest.mark.parametrize("ratios", RATIOS)
def test_cascade_maps_and_band_indices_match_jax(window, ratios):
    maxh, maxw = window
    for r in (2, 3, 4):
        np.testing.assert_array_equal(tms._cascade_map(maxh, maxw, r),
                                      jms._cascade_map(maxh, maxw, r))
    if (maxh * (ratios[-1] - 1)) % 2 == 0:
        jg, tg = geometries(ratios, maxh=maxh, maxw=maxw)
        np.testing.assert_array_equal(tms._band_indices(tg),
                                      jms._band_indices(jg))
        assert tms._band_indices(tg).shape == (tcodecs.n_indices(tg),)


@pytest.mark.parametrize("ratios", RATIOS)
def test_cascade_matches_jax(ratios):
    jg, tg = geometries(ratios)
    rng = np.random.RandomState(0)
    D = tg.maxh * tg.maxw
    dists = [rng.rand(3, D).astype(np.float32) for _ in ratios]
    ours = tms.cascade(tg, [torch.from_numpy(d) for d in dists])
    ref = jms.cascade(jg, [jnp.asarray(d) for d in dists])
    for a, b in zip(ours, ref):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)
    raw = tms.cascade(tg, [torch.from_numpy(d) for d in dists], normalize=False)
    for a, b in zip(raw, jms.cascade(jg, [jnp.asarray(d) for d in dists], False)):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("single_beta", [False, True])
def test_cascade_beta_matches_jax(single_beta):
    jg, tg = geometries((1, 2, 4), single_beta=single_beta)
    rng = np.random.RandomState(1)
    D = tg.maxh * tg.maxw
    dists = [rng.rand(3, D).astype(np.float32) + 0.1 for _ in range(3)]
    betas = (np.array([1.5, 0.5], np.float32) if single_beta
             else np.array([[1.0, 4.0], [0.5, 2.0]], np.float32))
    for b in (betas, np.asarray(jms.init_cascade_betas(jg))):
        np.testing.assert_array_equal(tms.init_cascade_betas(tg).numpy(),
                                      np.asarray(jms.init_cascade_betas(jg)))
        ours = tms.cascade_beta(tg, [torch.from_numpy(d) for d in dists],
                                torch.tensor(b), single_beta)
        ref = jms.cascade_beta(jg, [jnp.asarray(d) for d in dists],
                               jnp.asarray(b), single_beta)
        for a, r in zip(ours, ref):
            np.testing.assert_allclose(a.numpy(), np.asarray(r), rtol=1e-6,
                                       atol=1e-6)


def test_cascade_beta_power_is_a_constant_for_the_gradient():
    """pow = -1/sqrt(w1 w2) is detached: the betas' gradient is that of the
    power law at a frozen exponent."""
    _, tg = geometries((1, 2))
    rng = np.random.RandomState(2)
    D = tg.maxh * tg.maxw
    d0, d1 = (torch.from_numpy(rng.rand(2, D).astype(np.float32) + 0.2)
              for _ in range(2))
    betas = torch.tensor([[1.5, 0.7]], requires_grad=True)
    out = tms.cascade_beta(tg, [d0, d1], betas)[0]
    out.sum().backward()
    pw = -1.0 / np.sqrt(1.5 * 0.7)
    s = (1.5 * d0 + 0.7 * tms._coarse_to_fine(d1, 4, 4, 2)).numpy()
    g_w1 = (pw * s ** (pw - 1) * d0.numpy()).sum()
    np.testing.assert_allclose(betas.grad[0, 0].item(), g_w1, rtol=1e-4)


@pytest.mark.parametrize("ratios", RATIOS)
def test_forward_full_matches_jax(ratios):
    jm, params, tm = models(ratios)
    im1, im2 = images(3)
    lin = tm.forward_full(torch.from_numpy(im1), torch.from_numpy(im2))
    ref = np.asarray(jm.forward_full(params, jnp.asarray(im1), jnp.asarray(im2)))
    assert tuple(lin.shape) == ref.shape == (32, 40, tcodecs.n_indices(tm.geometry))
    np.testing.assert_allclose(lin.detach().numpy(), ref, rtol=0, atol=1e-6)
    lg = tm.forward_full(torch.from_numpy(im1), torch.from_numpy(im2), log=True)
    jlg = np.asarray(jm.forward_full(params, jnp.asarray(im1), jnp.asarray(im2),
                                     log=True))
    big = ref > 1e-6
    np.testing.assert_allclose(lg.detach().numpy()[big], jlg[big], rtol=0,
                               atol=1e-4)


@pytest.mark.parametrize("decode", list(DTYPES))
@pytest.mark.parametrize("ratios", RATIOS)
def test_decode_full_matches_jax_and_forward_full(ratios, decode):
    jm, params, tm = models(ratios, decode)
    im1, im2 = images(4)
    t1, t2 = torch.from_numpy(im1), torch.from_numpy(im2)
    idx, pmax = tm.decode_full(t1, t2)
    jidx, jpmax = (np.asarray(a) for a in jm.decode_full(
        params, jnp.asarray(im1), jnp.asarray(im2)))
    assert idx.dtype == torch.int32 and tuple(idx.shape) == (32, 40)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(pmax.numpy(), jpmax, rtol=0, atol=1e-6)
    if decode == "none":
        # the reference's invariant: argmax (middle tie-break) and max of
        # the full distribution
        dist = tm.forward_full(t1, t2).detach().numpy()
        mid = tcodecs.middle_index(tm.geometry)
        bm = dist.max(-1)
        tie = dist[..., mid] >= bm
        np.testing.assert_array_equal(idx.numpy(),
                                      np.where(tie, mid, dist.argmax(-1)))
        np.testing.assert_allclose(
            pmax.numpy(), np.where(tie, dist[..., mid], bm) / dist.sum(-1),
            rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("decode", list(DTYPES))
@pytest.mark.parametrize("ratios", RATIOS)
def test_decode_full_staged_matches_jax(ratios, decode):
    jm, params, tm = models(ratios, decode, seed=2)
    a1, a2 = images(5, (2, 32, 40, 3))
    idx, pmax = tm.decode_full_staged(torch.from_numpy(a1), torch.from_numpy(a2))
    jidx, jpmax = (np.asarray(a) for a in jm.decode_full_staged(
        params, jnp.asarray(a1), jnp.asarray(a2)))
    assert tuple(idx.shape) == (2, 32, 40)
    np.testing.assert_array_equal(idx.numpy(), jidx)
    np.testing.assert_allclose(pmax.numpy(), jpmax, rtol=0, atol=1e-6)
    one, _ = tm.decode_full(torch.from_numpy(a1[1]), torch.from_numpy(a2[1]))
    np.testing.assert_array_equal(one.numpy(), idx[1].numpy())


@pytest.mark.parametrize("ratios", RATIOS)
def test_fovea_paths_match_jax(ratios):
    jm, params, tm = models(ratios, seed=3)
    jg, tg = jm.geometry, tm.geometry
    im1, im2 = images(6)
    Hm, Wm = tg.rmax * tg.hPatch2, tg.rmax * tg.wPatch2
    y_lo, x_lo = (Hm + 1) // 2 - 1, (Wm + 1) // 2 - 1
    y_hi, x_hi = tg.hImg - (Hm - y_lo), tg.wImg - (Wm - x_lo)
    # the last two lie off the coarsest footprint's range: a negative slice
    # start counts from the end, then the slice is clamped into the frame
    foveas = [(y_lo, x_lo), (y_hi, x_hi), (2, 39), (30, 1)]
    for y, x in foveas:
        for log in (True, False):
            ours = tm.forward_fovea(torch.from_numpy(im1), torch.from_numpy(im2),
                                    y, x, log).detach().numpy()
            ref = np.asarray(jm.forward_fovea(params, jnp.asarray(im1),
                                              jnp.asarray(im2), y, x, log))
            assert ours.shape == (tcodecs.n_indices(tg),)
            np.testing.assert_allclose(ours, ref, rtol=0,
                                       atol=1e-4 if log else 1e-6)
    inner = foveas[:2]
    c1 = np.stack([im1[y - y_lo:y - y_lo + Hm, x - x_lo:x - x_lo + Wm]
                   for y, x in inner])
    c2 = np.stack([im2[y - y_lo:y - y_lo + Hm, x - x_lo:x - x_lo + Wm]
                   for y, x in inner])
    ours = tm.forward_fovea_batch(torch.from_numpy(c1), torch.from_numpy(c2))
    ref = np.asarray(jm.forward_fovea_batch(params, jnp.asarray(c1),
                                            jnp.asarray(c2)))
    np.testing.assert_allclose(ours.detach().numpy(), ref, rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        tm.forward_fovea_batch(torch.from_numpy(c1[:, 1:]), torch.from_numpy(c2))


@pytest.mark.parametrize("ratios", RATIOS)
def test_unshared_filters_and_trainable_betas_match_jax(ratios):
    """share_filters=False: one trunk per scale; trainable betas: the power
    cascade, whose decode_full materializes the distribution."""
    jm, params, tm = models(ratios, seed=4, share_filters=False,
                            cascad_trainable_weights=True)
    assert len(tm.filters) == len(ratios)
    assert set(params["scales"]) == {f"scale{s}" for s in range(len(ratios))}
    im1, im2 = images(7)
    t1, t2 = torch.from_numpy(im1), torch.from_numpy(im2)
    # the initial weights (-1, a reciprocal cascade), then positive ones
    for betas in (None, np.linspace(0.5, 2.0, 2 * (len(ratios) - 1))):
        if betas is not None:
            params = dict(params, cascade={"betas": jnp.asarray(
                betas.reshape(-1, 2), jnp.float32)})
            tm.load_state_dict(tio.multiscale_state_from_jax(
                tm.geometry, numpy_tree(params)))
        ours = tm.forward_full(t1, t2).detach().numpy()
        ref = np.asarray(jm.forward_full(params, jnp.asarray(im1),
                                         jnp.asarray(im2)))
        np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-6)
        idx, pmax = tm.decode_full(t1, t2)
        jidx, jpmax = jm.decode_full(params, jnp.asarray(im1), jnp.asarray(im2))
        np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
        np.testing.assert_allclose(pmax.numpy(), np.asarray(jpmax), rtol=1e-5,
                                   atol=1e-7)
    fov = tm.forward_fovea(t1, t2, 16, 20).detach().numpy()
    np.testing.assert_allclose(
        fov, np.asarray(jm.forward_fovea(params, jnp.asarray(im1),
                                         jnp.asarray(im2), 16, 20)),
        rtol=0, atol=1e-4)
    with pytest.raises(ValueError):
        tm.decode_full_staged(t1[None], t2[None])
    # the betas train
    tm.forward_fovea(t1, t2, 16, 20, log=False).sum().backward()
    assert torch.isfinite(tm.betas.grad).all() and tm.betas.grad.abs().max() > 0


def test_shared_tree_fills_unshared_trunks_and_load_model(tmp_path):
    """A shared trunk under an unshared geometry fills every scale (the
    reference reads it so), and ``load_model`` of a JAX-written multiscale
    checkpoint rebuilds the model; an unshared meta over a shared tree comes
    back as shared filters."""
    from depth_estimation_tpu.geometry import Learning
    from depth_estimation_tpu.models import io as jio
    jm, params, tm = models((1, 2), seed=5)
    im1, im2 = images(8)
    want = tm.forward_full(torch.from_numpy(im1), torch.from_numpy(im2))
    _, tg_un = geometries((1, 2), share_filters=False)
    un = tms.MultiscaleFlowModel(tg_un, device="cpu")
    un.load_state_dict(tio.multiscale_state_from_jax(tg_un, numpy_tree(params)))
    torch.testing.assert_close(
        un.forward_full(torch.from_numpy(im1), torch.from_numpy(im2)), want,
        rtol=0, atol=0)
    jg_un = dataclasses.replace(jm.geometry, share_filters=False)
    for name, g in (("shared", jm.geometry), ("legacy", jg_un)):
        path = jio.save_model(str(tmp_path / name), g, Learning(), params)
        geom, _, tree, _ = tio.load_model(path)
        assert geom.multiscale and geom.share_filters
        m = tms.MultiscaleFlowModel(geom, device="cpu")
        m.load_state_dict(tio.multiscale_state_from_jax(geom, tree))
        torch.testing.assert_close(
            m.forward_full(torch.from_numpy(im1), torch.from_numpy(im2)), want,
            rtol=0, atol=0)


def test_init_from_a_generator_is_seeded():
    _, tg = geometries((1, 2, 4), share_filters=False,
                       cascad_trainable_weights=True)
    a = tms.MultiscaleFlowModel(tg, device="cpu").init(
        torch.Generator().manual_seed(0))
    b = tms.MultiscaleFlowModel(tg, device="cpu").init(
        torch.Generator().manual_seed(0))
    for (k, x), (_, y) in zip(a.state_dict().items(), b.state_dict().items()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    w = a.filters[0].layer1.weight
    assert 0.5 < w.std().item() * np.sqrt(75) < 1.2   # lecun scale, fan_in 75
    assert not torch.equal(a.filters[0].layer1.weight, a.filters[1].layer1.weight)
    assert (a.betas == -1).all()
