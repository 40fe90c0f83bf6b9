"""PyTorch port vs the JAX package: Ce Liu's variational solver
(``flow/celiu.py``, ``flow/sor_kernel.py``, ``flow/__init__.py``).

The image helpers, pyramid, features and noise models against the JAX
functions; the plain twin of kernel B4 (``sor_plain``) against the XLA SOR
loop and the Pallas kernel in interpret mode; and the coarse-to-fine solve
end to end in three configurations. The JAX solver is slow to start on the
CPU (eager ops compile per shape), so each JAX solve is jitted and computed
once per module.

Inputs are smooth random textures made from numpy seeds. On white noise the
solver is ill-conditioned: a 1-ulp change of one input moves u by 4e-3 px
at 48x64 (alpha 0.005), so only smooth textures can hold the packages to
1e-4. The 'gmm' noise model amplifies any rounding difference: XLA's and
torch's exp differ in the last bit, and a 1-ulp input change alone moves u
by up to 4 px at single pixels (32x40, 2 outer steps), so the gmm solve is
held against the JAX solver's own response to a 1-ulp input change and by
the recovered shift; its pieces are held tightly.
"""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu import flow as jflow
from depth_estimation_tpu.flow import celiu as jc
from depth_estimation_tpu.flow.sor_kernel import sor_pallas
from depth_estimation_tpu_torch import flow as tflow
from depth_estimation_tpu_torch.flow import celiu as tc
from depth_estimation_tpu_torch.flow import sor_kernel as tsor

ATOL = 1e-6
# coarse-to-fine solve: the tolerance the JAX package holds between its
# batched and single-pair solvers (tests/test_celiu.py)
SOLVE_TOL = 1e-4


def _np(x):
    return x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)


def smooth_texture(h, w, c, seed):
    """Random texture smoothed with a sigma-1.5 Gaussian (numpy seed)."""
    base = np.random.RandomState(seed).rand(h, w, c).astype(np.float32)
    return np.asarray(jc.gaussian_smooth(jnp.asarray(base), 1.5, 4))


def shifted_pair(h, w, c, seed, dy=0, dx=2):
    """(im1, im2) where im2 is im1's scene moved by (dy, dx) px: a feature at
    im1 (y, x) appears in im2 at (y + dy, x + dx)."""
    base = smooth_texture(h + abs(dy), w + abs(dx), c, seed)
    y1, x1 = max(dy, 0), max(dx, 0)
    im1 = base[y1:y1 + h, x1:x1 + w]
    im2 = base[y1 - dy:y1 - dy + h, x1 - dx:x1 - dx + w]
    return np.ascontiguousarray(im1), np.ascontiguousarray(im2)


# ---------------------------------------------------------------------------
# helpers
# ---------------------------------------------------------------------------

RNG = np.random.RandomState(0)
IMG = RNG.rand(2, 13, 17, 3).astype(np.float32)
IMG2 = RNG.rand(2, 13, 17, 3).astype(np.float32)
GRAY = RNG.rand(13, 17, 1).astype(np.float32)
VX = (3 * RNG.randn(2, 13, 17)).astype(np.float32)
VY = (3 * RNG.randn(2, 13, 17)).astype(np.float32)

HELPERS = {
    "dx_advanced": lambda m, a: m.dx_advanced(a(IMG)),
    "dy_advanced": lambda m, a: m.dy_advanced(a(IMG)),
    "dx_forward": lambda m, a: m.dx_forward(a(IMG)),
    "dy_forward": lambda m, a: m.dy_forward(a(IMG)),
    "gaussian_smooth": lambda m, a: m.gaussian_smooth(a(IMG), 1.3, 3),
    "im2feature_rgb": lambda m, a: m.im2feature(a(IMG)),
    "im2feature_gray": lambda m, a: m.im2feature(a(GRAY)),
    "imresize": lambda m, a: m.imresize(a(IMG), 9, 11),
    "imresize_up": lambda m, a: m.imresize(a(GRAY), 20, 23),
    "warp_image": lambda m, a: m.warp_image(a(IMG), a(IMG2), a(VX), a(VY)),
    "warp_image_bicubic": lambda m, a: m.warp_image_bicubic(
        a(IMG), a(IMG2), a(VX), a(VY)),
    "warp_image_unbatched": lambda m, a: m.warp_image(
        a(IMG[0]), a(IMG2[0]), a(VX[0]), a(VY[0])),
    "get_dxs": lambda m, a: m.get_dxs(a(IMG), a(IMG2)),
    "neighbor_weights": lambda m, a: m._neighbor_weights(a(VX)),
    "nsum": lambda m, a: m._nsum(a(VY), *m._neighbor_weights(a(VX))),
    "gaussian_mixture_init": lambda m, a: (
        m.gaussian_mixture_init(5) if m is jc
        else m.gaussian_mixture_init(5, "cpu")),
}


def _to_jax(x):
    return jnp.asarray(x)


@pytest.mark.parametrize("name", list(HELPERS))
def test_helper_matches_jax(name):
    ref = HELPERS[name](jc, _to_jax)
    ours = HELPERS[name](tc, torch.from_numpy)
    if not isinstance(ref, tuple):
        ref, ours = (ref,), (ours,)
    assert len(ref) == len(ours)
    for r, o in zip(ref, ours):
        assert _np(o).shape == _np(r).shape
        np.testing.assert_allclose(_np(o), _np(r), rtol=0, atol=ATOL)


def test_pyramid_matches_jax():
    for ratio, min_width in ((0.75, 5), (0.5, 4), (0.99, 8)):
        assert tc.pyramid_shapes(40, 52, ratio, min_width) == \
            jc.pyramid_shapes(40, 52, ratio, min_width)
        ref = jc.build_pyramid(jnp.asarray(IMG), ratio, min_width)
        ours = tc.build_pyramid(torch.from_numpy(IMG), ratio, min_width)
        assert len(ours) == len(ref) > 1
        for r, o in zip(ref, ours):
            np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=0,
                                       atol=ATOL)


def test_noise_models_match_jax():
    """gmm_psi and the EM update (psi reaches 1/(2 sigma^2) = 200, so it is
    held relatively), and the Laplacian estimate of the solver's tail."""
    gm = tuple(jnp.asarray(np.array(v, np.float32))
               for v in ([0.9, 0.95, 0.97], [0.04, 0.05, 0.1], [0.5, 0.4, 0.6]))
    tgm = tuple(torch.tensor(np.asarray(p)) for p in gm)
    temp = IMG - 0.5
    np.testing.assert_allclose(
        tc.gmm_psi(torch.from_numpy(temp), tgm).numpy(),
        np.asarray(jc.gmm_psi(jnp.asarray(temp), gm)), rtol=1e-6, atol=ATOL)
    warp = IMG + 0.05 * IMG2
    ref = jc.est_gaussian_mixture(jnp.asarray(IMG), jnp.asarray(warp), gm)
    ours = tc.est_gaussian_mixture(torch.from_numpy(IMG),
                                   torch.from_numpy(warp), tgm)
    for r, o in zip(ref, ours):
        np.testing.assert_allclose(o.numpy(), np.asarray(r), rtol=1e-6)
    # the reference computes the Laplacian estimate inline in smooth_flow_sor
    warp[0, :3] = IMG[0, :3]                      # zero differences drop out
    diff = jnp.abs(jnp.asarray(IMG) - jnp.asarray(warp))
    valid = (diff > 0) & (diff < 1e6)
    want = (diff * valid).sum(axis=(-3, -2)) / jnp.maximum(
        valid.sum(axis=(-3, -2)), 1)
    np.testing.assert_allclose(
        tc.laplacian_noise(torch.from_numpy(IMG), torch.from_numpy(warp)).numpy(),
        np.asarray(want), rtol=1e-6)


@pytest.mark.parametrize("shape", [(7, 9, 3), (2, 7, 9, 5), (13, 17, 1)])
def test_packed_bilinear_matches_four_tap_and_jax(shape):
    """The packed-tap form against the four-tap form (<= 1e-6) and against
    the JAX packed form, over interior, fractional-edge, exactly-on-edge and
    far out-of-range coordinates."""
    rng = np.random.RandomState(7)
    img = rng.rand(*shape).astype(np.float32)
    H, W = shape[-3], shape[-2]
    lead = shape[:-3]
    x = (rng.rand(*lead, 20, 30) * (W + 6) - 3).astype(np.float32)
    y = (rng.rand(*lead, 20, 30) * (H + 6) - 3).astype(np.float32)
    x[..., 0, 0], x[..., 0, 1] = W - 1.0, 0.0
    y[..., 0, 0], y[..., 0, 1] = H - 1.0, 0.0
    ti, tx, ty = (torch.from_numpy(a) for a in (img, x, y))
    four = tc.bilinear_sample(ti, tx, ty).numpy()
    packed = tc.bilinear_sample(ti, tx, ty, packed=True).numpy()
    np.testing.assert_allclose(packed, four, atol=1e-6)
    ref = jc.bilinear_sample(jnp.asarray(img), jnp.asarray(x), jnp.asarray(y),
                             packed=True)
    np.testing.assert_allclose(packed, np.asarray(ref), rtol=0, atol=ATOL)


# ---------------------------------------------------------------------------
# SOR: the plain twin of kernel B4
# ---------------------------------------------------------------------------

def _sor_inputs(lead, H, W, seed=3):
    rng = np.random.RandomState(seed)
    shape = tuple(lead) + (H, W)
    phi = rng.rand(*shape).astype(np.float32) + 0.1
    imdxy = ((rng.rand(*shape) - 0.5) * 0.1).astype(np.float32)
    b1 = rng.randn(*shape).astype(np.float32)
    b2 = rng.randn(*shape).astype(np.float32)
    alpha = 0.3
    w = [np.asarray(p) for p in jc._neighbor_weights(jnp.asarray(phi))]
    coeff = alpha * (w[0] + w[1] + w[2] + w[3])
    denom_u = (rng.rand(*shape) + 0.5 + coeff).astype(np.float32)
    denom_v = (rng.rand(*shape) + 0.5 + coeff).astype(np.float32)
    return [*w, denom_u, denom_v, b1, b2, imdxy], alpha


@pytest.mark.parametrize("lead", [(2,), ()])
def test_sor_plain_matches_xla_and_pallas(lead):
    """sor_plain against _sor_xla and sor_pallas (interpret mode) at
    13x22 (both of the TPU kernel's padding paths), n_sor = 9."""
    planes, alpha = _sor_inputs(lead, 13, 22)
    shape = planes[0].shape
    zeros = jnp.zeros(shape, jnp.float32)
    want = jc._sor_xla(zeros, zeros, *planes, alpha=alpha, n_sor=9)
    pallas = sor_pallas(*planes, alpha=alpha, n_sor=9, interpret=True)
    n0 = tsor.sor_redblack.launches
    ours = tsor.sor_redblack(*[torch.from_numpy(p) for p in planes],
                             alpha=alpha, n_sor=9)
    assert tsor.sor_redblack.launches == n0      # CPU tensors: plain twin
    for o, w, p in zip(ours, want, pallas):
        assert o.shape == shape
        np.testing.assert_allclose(o.numpy(), np.asarray(w), atol=1e-5)
        np.testing.assert_allclose(o.numpy(), np.asarray(p), atol=1e-5)


def test_sor_plain_warm_start_matches_xla():
    """The warm du/dv start the solver takes when n_inner > 1."""
    planes, alpha = _sor_inputs((2,), 9, 11, seed=4)
    rng = np.random.RandomState(5)
    du0 = (0.1 * rng.randn(2, 9, 11)).astype(np.float32)
    dv0 = (0.1 * rng.randn(2, 9, 11)).astype(np.float32)
    want = jc._sor_xla(jnp.asarray(du0), jnp.asarray(dv0), *planes,
                       alpha=alpha, n_sor=6)
    ours = tc.sor_plain(*[torch.from_numpy(p) for p in planes], alpha=alpha,
                        n_sor=6, du=torch.from_numpy(du0),
                        dv=torch.from_numpy(dv0))
    for o, w in zip(ours, want):
        np.testing.assert_allclose(o.numpy(), np.asarray(w), atol=1e-5)
    with pytest.raises(ValueError):
        tsor.sor_redblack(*[torch.from_numpy(p) for p in planes[:-1]],
                          torch.zeros(2, 9, 10), alpha=alpha, n_sor=2)


# ---------------------------------------------------------------------------
# the solver end to end
# ---------------------------------------------------------------------------

SOLVES = {
    # (a) lap / bilinear, 3 channels, 3 levels
    "lap_bilinear_rgb": (shifted_pair(36, 48, 3, 1, dx=2),
                         dict(alpha=0.02, ratio=0.75, min_width=16, n_outer=2,
                              n_inner=1, n_sor=10)),
    # (b) the two switches, 1 channel; lap / bicubic is held at SOLVE_TOL,
    # gmm / bicubic by percentiles (module docstring)
    "lap_bicubic_gray": (shifted_pair(32, 40, 1, 2, dx=2),
                         dict(alpha=0.02, ratio=0.75, min_width=16, n_outer=2,
                              n_inner=1, n_sor=8, interpolation="bicubic")),
    "gmm_bicubic_gray": (shifted_pair(32, 40, 1, 2, dx=2),
                         dict(alpha=0.02, ratio=0.75, min_width=16, n_outer=2,
                              n_inner=1, n_sor=8, noise_model="gmm",
                              interpolation="bicubic")),
    # (c) liu_flow's own parameters (2 levels at 48x64)
    "liu_params": (shifted_pair(48, 64, 3, 3, dy=1, dx=-1),
                   dict(alpha=0.005, ratio=0.75, min_width=30, n_outer=5,
                        n_inner=1, n_sor=40)),
}


@functools.lru_cache(maxsize=None)
def _jax_solver(name):
    return jax.jit(functools.partial(jc.coarse2fine_flow, **SOLVES[name][1]))


@pytest.fixture(scope="module")
def jax_solves():
    """Jitted JAX coarse2fine_flow outputs, computed once per configuration
    (and per input, for the 1-ulp probe)."""
    cache = {}

    def get(name, ulp=False):
        if (name, ulp) not in cache:
            im1, im2 = SOLVES[name][0]
            if ulp:
                im1 = np.nextafter(im1, np.float32(2)).astype(np.float32)
            cache[name, ulp] = [np.asarray(x) for x in _jax_solver(name)(
                jnp.asarray(im1), jnp.asarray(im2))]
        return cache[name, ulp]
    return get


def _port_solve(name):
    (im1, im2), kw = SOLVES[name]
    return [x.numpy() for x in tc.coarse2fine_flow(
        torch.from_numpy(im1), torch.from_numpy(im2), **kw)]


@pytest.mark.parametrize("name", ["lap_bilinear_rgb", "lap_bicubic_gray",
                                  "liu_params"])
def test_coarse2fine_matches_jax(jax_solves, name):
    ref = jax_solves(name)
    ours = _port_solve(name)
    for o, r in zip(ours[:2], ref[:2]):                     # u, v
        assert o.shape == r.shape
        np.testing.assert_allclose(o, r, rtol=SOLVE_TOL, atol=SOLVE_TOL)
    np.testing.assert_allclose(ours[2], ref[2], rtol=0, atol=SOLVE_TOL)
    assert np.isfinite(ours[0]).all() and np.isfinite(ours[1]).all()


def test_coarse2fine_gmm_follows_jax(jax_solves):
    """gmm / bicubic: at the median and the 90th percentile the port is as
    far from the JAX solve as the JAX solve is from itself after a 1-ulp
    change of one input, within a factor of 10 (port and 1-ulp probe read
    6e-3 / 2.5e-3 px at the median and 0.13 / 0.04 px at the 90th
    percentile of u here); and both recover the 2 px shift."""
    ref = jax_solves("gmm_bicubic_gray")
    probe = jax_solves("gmm_bicubic_gray", ulp=True)
    ours = _port_solve("gmm_bicubic_gray")
    for o, r, p in zip(ours, ref, probe):
        d, self_d = np.abs(o - r), np.abs(p - r)
        for q in (50, 90):
            assert np.percentile(d, q) <= 10 * np.percentile(self_d, q) + 1e-4, \
                (q, np.percentile(d, q), np.percentile(self_d, q))
    for u in (ours[0], ref[0]):
        assert abs(np.median(u[6:-6, 6:-6]) - 2) < 0.25


def test_batched_solver_matches_single():
    """The port's explicit-batch solve against its single-pair solve."""
    pairs = [shifted_pair(36, 48, 3, 10 + b, dx=b + 1) for b in range(3)]
    kw = dict(alpha=0.02, ratio=0.75, min_width=16, n_outer=2, n_inner=1,
              n_sor=10)
    ub, vb, wb = tc.coarse2fine_flow_batched(
        torch.from_numpy(np.stack([p[0] for p in pairs])),
        torch.from_numpy(np.stack([p[1] for p in pairs])), **kw)
    assert ub.shape == (3, 36, 48) and wb.shape == (3, 36, 48, 3)
    for b, (im1, im2) in enumerate(pairs):
        us, vs, ws = tc.coarse2fine_flow(torch.from_numpy(im1),
                                         torch.from_numpy(im2), **kw)
        np.testing.assert_allclose(ub[b].numpy(), us.numpy(),
                                   rtol=SOLVE_TOL, atol=SOLVE_TOL)
        np.testing.assert_allclose(vb[b].numpy(), vs.numpy(),
                                   rtol=SOLVE_TOL, atol=SOLVE_TOL)
        np.testing.assert_allclose(wb[b].numpy(), ws.numpy(), atol=SOLVE_TOL)
    with pytest.raises(ValueError):
        tc.coarse2fine_flow_batched(torch.zeros(36, 48), torch.zeros(36, 48))


def test_solver_dispatches_sor_by_inner_step(monkeypatch):
    """The first inner step (zero start) goes through sor_redblack, later
    ones (warm start) through sor_plain, as the reference dispatches; and
    n_inner = 2 matches the JAX solve."""
    calls = []
    real_rb, real_plain = tc.sor_redblack, tc.sor_plain
    monkeypatch.setattr(tc, "sor_redblack",
                        lambda *a, **k: calls.append("rb") or real_rb(*a, **k))
    monkeypatch.setattr(tc, "sor_plain",
                        lambda *a, **k: calls.append("plain") or real_plain(*a, **k))
    im1, im2 = shifted_pair(24, 40, 3, 6, dx=1)
    kw = dict(alpha=0.02, ratio=0.75, min_width=30, n_outer=2, n_inner=2,
              n_sor=5)
    u, v, _ = tc.coarse2fine_flow(torch.from_numpy(im1), torch.from_numpy(im2),
                                  **kw)
    # 1 level, 2 outer steps; on the CPU sor_redblack runs sor_plain itself
    assert calls == ["rb", "plain", "plain"] * 2, calls
    ju, jv, _ = jax.jit(functools.partial(jc.coarse2fine_flow, **kw))(
        jnp.asarray(im1), jnp.asarray(im2))
    np.testing.assert_allclose(u.numpy(), np.asarray(ju), rtol=SOLVE_TOL,
                               atol=SOLVE_TOL)
    np.testing.assert_allclose(v.numpy(), np.asarray(jv), rtol=SOLVE_TOL,
                               atol=SOLVE_TOL)


def test_get_optical_flow_matches_jax():
    """The radial tester's baseline: the solver with its fast parameters
    (one pyramid level at 36x48)."""
    im1, im2 = SOLVES["lap_bilinear_rgb"][0]
    vx, vy = tflow.get_optical_flow(torch.from_numpy(im1), torch.from_numpy(im2))
    jvx, jvy = jax.jit(jflow.get_optical_flow)(jnp.asarray(im1),
                                                jnp.asarray(im2))
    np.testing.assert_allclose(vx.numpy(), np.asarray(jvx), rtol=SOLVE_TOL,
                               atol=SOLVE_TOL)
    np.testing.assert_allclose(vy.numpy(), np.asarray(jvy), rtol=SOLVE_TOL,
                               atol=SOLVE_TOL)


def test_numpy_input_goes_to_the_card(monkeypatch):
    """Numpy input is solved on the card unless the caller names the CPU:
    without a card that raises."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    im1, im2 = shifted_pair(24, 40, 3, 6, dx=1)
    kw = dict(alpha=0.02, ratio=0.75, min_width=30, n_outer=1, n_sor=2)
    with pytest.raises(RuntimeError, match="cuda"):
        tc.coarse2fine_flow(im1, im2, **kw)
    u, _, _ = tc.coarse2fine_flow(im1, im2, device="cpu", **kw)
    assert u.device.type == "cpu"
    with pytest.raises(ValueError):
        tc.coarse2fine_flow(im1, im2, noise_model="gauss", device="cpu", **kw)
