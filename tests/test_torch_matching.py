"""PyTorch port vs the JAX package: the fused matcher's plain twin (kernel
B1's CPU path) against the Pallas kernel in interpret mode, and the matcher
reference ops and confidence extraction around it."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.ops import extract as jextract
from depth_estimation_tpu.ops import matching as jmatching
from depth_estimation_tpu_torch.ops import extract as textract
from depth_estimation_tpu_torch.ops import matching as tmatching

B, H, W, K = 2, 10, 18, 8
WINDOWS = [(4, 4), (5, 3), (6, 6)]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16),
          "f16": (jnp.float16, torch.float16)}
MODES = ("plain", "marg", "conf")
THR = 0.11


def _inputs(maxh, maxw, seed=0):
    rng = np.random.RandomState(seed)
    f1 = (0.5 * rng.randn(B, H, W, K)).astype(np.float32)
    f2 = (0.5 * rng.randn(B, H + maxh - 1, W + maxw - 1, K)).astype(np.float32)
    return f1, f2


@pytest.fixture(scope="module")
def jax_fused():
    """JAX reference outputs, computed once per (window, dtype, mode)."""
    cache = {}

    def get(maxh, maxw, dt, mode):
        key = (maxh, maxw, dt, mode)
        if key not in cache:
            f1, f2 = _inputs(maxh, maxw)
            jdt = DTYPES[dt][0]
            if dt == "f16":
                # storage-only f16: the JAX kernel at f32 on f16-stored
                # values (its own f16 form rounds each channel's
                # difference to f16 on the CPU, see test_f16_twins_*)
                f1, f2 = (a.astype(np.float16).astype(np.float32)
                          for a in (f1, f2))
                jdt = jnp.float32
            outs = jmatching.match_flow_fused(
                jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, 8, True,
                mode == "marg", jdt, mode == "conf", THR)
            cache[key] = [np.asarray(o) for o in outs]
        return cache[key]
    return get


def _second_best_gap(costs):
    """Per-pixel gap between the best and second-best logit."""
    s = np.sort(-costs, axis=-1)
    return s[..., -1] - s[..., -2]


@pytest.mark.parametrize("maxh,maxw", WINDOWS)
@pytest.mark.parametrize("dt", list(DTYPES))
@pytest.mark.parametrize("mode", MODES)
def test_fused_plain_matches_jax(jax_fused, maxh, maxw, dt, mode):
    f1, f2 = _inputs(maxh, maxw)
    ref = jax_fused(maxh, maxw, dt, mode)
    ours = [o.numpy() for o in tmatching.match_flow_fused(
        torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw, 8,
        mode == "marg", DTYPES[dt][1], mode == "conf", THR)]
    assert len(ours) == len(ref) == (4 if mode == "plain" else 5)
    assert ours[0].dtype == np.int32 and ours[0].shape == (B, H, W)
    costs = tmatching.match_ssd(torch.from_numpy(f1), torch.from_numpy(f2),
                                maxh, maxw, DTYPES[dt][1]).numpy()
    # WTA index: equal except where the two best logits are within 1e-5
    diff = ours[0] != ref[0]
    assert (_second_best_gap(costs)[diff] < 1e-5).all(), diff.sum()
    for a, b in zip(ours[1:4], ref[1:4]):          # ey, ex, pmax
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    if mode == "marg":
        assert ours[4].shape == (B, maxh, H, W)
        np.testing.assert_allclose(ours[4], ref[4], rtol=0, atol=1e-6)
    if mode == "conf":
        marg = tmatching.match_flow_fused(
            torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw, 8, True,
            DTYPES[dt][1])[4].numpy()
        off = ours[4] != ref[4]
        assert (np.abs(marg.max(axis=1) - THR)[off] <= 1e-5).all(), off.sum()


@pytest.mark.parametrize("dt", list(DTYPES))
def test_match_ssd_matches_jax(dt):
    f1, f2 = _inputs(5, 3, seed=1)
    ours = tmatching.match_ssd(torch.from_numpy(f1), torch.from_numpy(f2), 5, 3,
                               DTYPES[dt][1]).numpy()
    for b in range(B):
        ref = np.asarray(jmatching.match_ssd(jnp.asarray(f1[b]),
                                             jnp.asarray(f2[b]), 5, 3,
                                             DTYPES[dt][0]))
        np.testing.assert_allclose(ours[b], ref, rtol=1e-6, atol=1e-6)


def test_wta_and_softmax_match_jax():
    rng = np.random.RandomState(2)
    costs = rng.randint(0, 6, size=(7, 9, 16)).astype(np.float32)  # many ties
    mid = 5
    np.testing.assert_array_equal(
        tmatching.wta_from_costs(torch.from_numpy(costs), mid).numpy(),
        np.asarray(jmatching.wta_from_costs(jnp.asarray(costs), mid)))
    np.testing.assert_allclose(
        tmatching.softmax_scores(torch.from_numpy(costs)).numpy(),
        np.asarray(jmatching.softmax_scores(jnp.asarray(costs))),
        rtol=1e-6, atol=1e-7)


def test_conf_gate_equals_confidences_from_marginal():
    """want_conf's gate equals the thresholded extraction on want_marg's
    marginal, in the port and in the reference."""
    f1, f2 = _inputs(6, 6, seed=3)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    marg = tmatching.match_flow_fused(t1, t2, 6, 6, 8, True)[4]
    conf = tmatching.match_flow_fused(t1, t2, 6, 6, 8, False, torch.float32,
                                      True, THR)[4]
    gate = textract.confidences_from_marginal(marg.permute(0, 2, 3, 1), THR)
    np.testing.assert_array_equal(conf.numpy() > 0.5, gate.numpy())
    ref = jextract.confidences_from_marginal(
        jnp.asarray(marg.permute(0, 2, 3, 1).numpy()), THR)
    np.testing.assert_array_equal(gate.numpy(), np.asarray(ref))


@pytest.mark.parametrize("threshold", [0.11, 0.25])
def test_extract_output_matches_jax(threshold):
    rng = np.random.RandomState(4)
    dist = rng.dirichlet(np.full(12, 0.3), size=(6, 7)).astype(np.float32)
    idx, score = textract.extract_output(torch.from_numpy(dist), threshold)
    jidx, jscore = jextract.extract_output(jnp.asarray(dist), threshold)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_allclose(score.numpy(), np.asarray(jscore), rtol=1e-6)


def test_enlarge_mask_matches_jax():
    rng = np.random.RandomState(5)
    m = rng.rand(3, 20, 26) > 0.2
    ours = textract.enlarge_mask_batched(torch.from_numpy(m), 5, 4).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jextract.enlarge_mask_batched(jnp.asarray(m), 5, 4)))
    np.testing.assert_array_equal(
        textract.enlarge_mask(torch.from_numpy(m[0]), 3, 6).numpy(),
        np.asarray(jextract.enlarge_mask(jnp.asarray(m[0]), 3, 6)))


# ---------------------------------------------------------------------------
# Kernel B2: the norm-decomposed matcher's plain twin against the Pallas
# kernel in interpret mode
# ---------------------------------------------------------------------------

FAST_SHAPE = (2, 10, 12, 5)     # B, H, W, K
FAST_WINDOW = (6, 4)            # non-square: the dx-major visit order shows
# WTA index: the decomposition rounds near ties apart, so equal on >= 99% of
# pixels. ey/ex/pmax: both packages round the features to the storage type
# once and do the arithmetic in f32; only the summation order of the norms
# and cross terms differs, so both storage types are held at 1e-5 (bf16
# storage changes the inputs, not the f32 arithmetic on them).
FAST_TOL = {"f32": 1e-5, "bf16": 1e-5, "f16": 1e-5}


def _fast_inputs(scale=0.5, seed=8):
    B, Hf, Wf, Kf = FAST_SHAPE
    maxh, maxw = FAST_WINDOW
    rng = np.random.RandomState(seed)
    f1 = (scale * rng.randn(B, Hf, Wf, Kf)).astype(np.float32)
    f2 = (scale * rng.randn(B, Hf + maxh - 1, Wf + maxw - 1, Kf)).astype(np.float32)
    return f1, f2


@pytest.mark.parametrize("dt", list(DTYPES))
def test_fast_plain_matches_jax(dt):
    f1, f2 = _fast_inputs()
    maxh, maxw = FAST_WINDOW
    ref = [np.asarray(o) for o in jmatching.match_flow_fast(
        jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, 8, True, DTYPES[dt][0])]
    n0 = tmatching.match_flow_fast.launches
    ours = [o.numpy() for o in tmatching.match_flow_fast(
        torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw, 8,
        DTYPES[dt][1])]
    assert tmatching.match_flow_fast.launches == n0     # CPU: plain twin
    assert ours[0].dtype == np.int32 and ours[0].shape == FAST_SHAPE[:3]
    assert (ours[0] == ref[0]).mean() >= 0.99
    for a, b in zip(ours[1:], ref[1:]):                 # ey, ex, pmax
        np.testing.assert_allclose(a, b, rtol=0, atol=FAST_TOL[dt])
    # unbatched inputs give the first item
    one = tmatching.match_flow_fast(torch.from_numpy(f1[0]),
                                    torch.from_numpy(f2[0]), maxh, maxw, 8,
                                    DTYPES[dt][1])
    for a, b in zip(one, ours):
        np.testing.assert_array_equal(a.numpy(), b[0])


def test_f16_twins_match_jax_interpret():
    """f16 storage at the JAX package's own f16 test size (24x32x6, 8x8
    window): B1's and B2's twins against the Pallas kernels in interpret
    mode. B2's reference upcasts before every product, as the twin does:
    equal to f32 rounding. B1's reference writes each channel difference
    in the storage type, (f1 - f2).astype(f32), and the CPU backend
    rounds that difference to f16 (it keeps bf16 differences in f32), so
    it carries one rounding of |f1 - f2| * 2^-11 that the storage-only
    twin (f32 subtraction of the stored values, as the reference's
    match_ssd) does not: the twin is held to the JAX kernel at f32 on the
    f16-stored values to f32 rounding, and to its f16 form within 1e-3."""
    rng = np.random.RandomState(7)
    maxh = maxw = 8
    h, w, k = 24, 32, 6
    f1 = rng.rand(h, w, k).astype(np.float32)
    f2 = rng.rand(h + maxh - 1, w + maxw - 1, k).astype(np.float32)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    gap = _second_best_gap(tmatching.match_ssd(t1, t2, maxh, maxw,
                                               torch.float16).numpy())
    fused = [o.numpy() for o in tmatching.match_flow_fused(
        t1, t2, maxh, maxw, 8, False, torch.float16)]
    fast = [o.numpy() for o in tmatching.match_flow_fast(
        t1, t2, maxh, maxw, 8, torch.float16)]
    q1, q2 = (jnp.asarray(a.astype(np.float16).astype(np.float32))
              for a in (f1, f2))
    cases = (
        (fused, jmatching.match_flow_fused(q1, q2, maxh, maxw, 8, True), 1e-5),
        (fused, jmatching.match_flow_fused(
            jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, 16, True, False,
            jnp.float16), 1e-3),
        (fast, jmatching.match_flow_fast(
            jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, 16, True,
            jnp.float16), 1e-5))
    for ours, ref, tol in cases:
        ref = [np.asarray(o) for o in ref]
        diff = ours[0] != ref[0]
        assert (gap[diff] < tol).all(), diff.sum()
        for a, b in zip(ours[1:4], ref[1:4]):          # ey, ex, pmax
            np.testing.assert_allclose(a, b, rtol=0, atol=tol)


def test_fast_plain_dx_major_tie_break():
    """Exact ties: the first cell in dx-major order wins (not B1's dy-major
    first), unless the middle cell ties the best."""
    maxh, maxw = FAST_WINDOW
    f1 = np.zeros((1, 1, 1, 2), np.float32)
    f2 = np.full((1, maxh, maxw, 2), 5.0, np.float32)
    f2[0, 0, 3] = 0.0          # cell (dy=0, dx=3): d = 3, dx-major rank 18
    f2[0, 2, 0] = 0.0          # cell (dy=2, dx=0): d = 8, dx-major rank 2
    args = (torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw)
    assert tmatching.match_flow_fast(*args)[0].item() == 8
    assert tmatching.match_flow_fused(*args)[0].item() == 3
    ref = jmatching.match_flow_fast(jnp.asarray(f1), jnp.asarray(f2), maxh,
                                    maxw, 8, True)
    assert int(np.asarray(ref[0]).ravel()[0]) == 8
    f2[0, 2, 1] = 0.0          # the middle cell (dy=2, dx=1) ties: it wins
    assert tmatching.match_flow_fast(*args)[0].item() == 2 * maxw + 1


def test_fast_plain_large_magnitude_features():
    """Features scaled x30 (costs in the tens of thousands): the running-max
    softmax keeps every output finite, and the twin still follows the fused
    matcher (the check the JAX package holds its kernel to)."""
    f1, f2 = _fast_inputs(scale=30.0, seed=13)
    maxh, maxw = FAST_WINDOW
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    fast = tmatching.match_flow_fast(t1, t2, maxh, maxw)
    for o in fast[1:]:
        assert torch.isfinite(o).all()
    ref = tmatching.match_flow_fused(t1, t2, maxh, maxw)
    assert (fast[0] == ref[0]).float().mean().item() > 0.99
    for a, b in zip(fast[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-3)
    jref = jmatching.match_flow_fast(jnp.asarray(f1), jnp.asarray(f2), maxh,
                                     maxw, 8, True)
    for a, b in zip(fast[1:], jref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-3)


def _match_ssd_per_cell(f1, f2, maxh, maxw, dtype=None):
    """match_ssd one window cell at a time, each cell's channels summed in
    k order: the form the port had before it computed the cells together."""
    Hc, Wc = f2.shape[-3] - maxh + 1, f2.shape[-2] - maxw + 1
    if dtype is not None:
        f1, f2 = f1.to(dtype), f2.to(dtype)
    cells = []
    for dy in range(maxh):
        for dx in range(maxw):
            d = f1.float() - f2[..., dy:dy + Hc, dx:dx + Wc, :].float()
            sq = d * d
            acc = sq[..., 0]
            for k in range(1, sq.shape[-1]):
                acc = acc + sq[..., k]
            cells.append(acc)
    return torch.stack(cells, dim=-1)


@pytest.mark.parametrize("lead,maxh,maxw,Kc,dt", [
    ((2,), 6, 7, 5, None), ((), 4, 4, 1, None), ((3, 2), 5, 3, 10, torch.bfloat16),
    ((), 15, 1, 10, None), ((1,), 17, 17, 32, None)])
def test_match_ssd_equals_the_per_cell_loop(lead, maxh, maxw, Kc, dt):
    """The cost volume is bit-equal to the per-cell loop (the same sums in
    the same order); its gradients only re-associate their sums over the
    cells: within 1e-6 of their largest value in f32."""
    g = torch.Generator().manual_seed(maxh * 100 + Kc)
    f1 = torch.randn(*lead, 9, 11, Kc, generator=g, requires_grad=True)
    f2 = torch.randn(*lead, 9 + maxh - 1, 11 + maxw - 1, Kc, generator=g,
                     requires_grad=True)
    ours = tmatching.match_ssd(f1, f2, maxh, maxw, dt)
    ref = _match_ssd_per_cell(f1, f2, maxh, maxw, dt)
    assert torch.equal(ours, ref)
    if dt is not None:
        return
    w = torch.randn(ours.shape, generator=g)
    ga = torch.autograd.grad((ours * w).sum(), (f1, f2))
    gb = torch.autograd.grad((ref * w).sum(), (f1, f2))
    for a, b in zip(ga, gb):
        assert (a - b).abs().max() <= 1e-6 * b.abs().max()
