"""PyTorch port vs the JAX package: the study matchers. Kernel B5's plain
twin (its CPU path) against the Pallas throughput kernel in interpret mode
and against the port's B2 twin, and the band-matmul matcher against the
reference in f32 and bf16."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.ops import matching_experimental as jexp
from depth_estimation_tpu_torch.ops import matching as tmatching
from depth_estimation_tpu_torch.ops import matching_experimental as texp

# (B, H, W, K, maxh, maxw): the reference's contract-test shape, and an odd
# shape with a non-square window
CASES = [(3, 11, 13, 5, 4, 4), (2, 9, 7, 3, 3, 5)]


def _inputs(B, H, W, K, maxh, maxw, seed=9):
    rng = np.random.RandomState(seed)
    f1 = rng.rand(B, H, W, K).astype(np.float32)
    f2 = rng.rand(B, H + maxh - 1, W + maxw - 1, K).astype(np.float32)
    return f1, f2


def _gap(f1, f2, maxh, maxw):
    """Per-pixel gap between the best and the second-best logit."""
    costs = tmatching.match_ssd(torch.from_numpy(f1), torch.from_numpy(f2),
                                maxh, maxw).numpy()
    s = np.sort(-costs, axis=-1)
    return s[..., -1] - s[..., -2]


def _assert_contract(ours, ref, gap, atol):
    """idx equal on >= 99.9% of pixels and apart only where the two best
    logits are within 1e-5; ey, ex, pmax within ``atol``."""
    assert ours[0].dtype == np.int32
    diff = ours[0] != ref[0]
    assert diff.mean() <= 1e-3 or diff.sum() <= 1, diff.sum()
    assert (gap[diff] < 1e-5).all(), diff.sum()
    for a, b in zip(ours[1:], ref[1:]):
        assert a.shape == b.shape
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


@pytest.mark.parametrize("case", CASES)
def test_throughput_plain_matches_jax(case):
    B, H, W, K, maxh, maxw = case
    f1, f2 = _inputs(*case)
    ref = [np.asarray(o) for o in jexp.match_flow_throughput(
        jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, 8, 8, True)]
    n0 = texp.match_flow_throughput.launches
    ours = [o.numpy() for o in texp.match_flow_throughput(
        torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw, 8, 8)]
    assert texp.match_flow_throughput.launches == n0       # CPU: plain twin
    assert ours[0].shape == (B, H, W)
    _assert_contract(ours, ref, _gap(f1, f2, maxh, maxw), 1e-5)


@pytest.mark.parametrize("case", CASES)
def test_throughput_plain_matches_fast_plain(case):
    _, _, _, _, maxh, maxw = case
    f1, f2 = _inputs(*case, seed=10)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    ours = [o.numpy() for o in texp.match_flow_throughput(t1, t2, maxh, maxw)]
    fast = [o.numpy() for o in tmatching.match_flow_fast(t1, t2, maxh, maxw)]
    _assert_contract(ours, fast, _gap(f1, f2, maxh, maxw), 1e-5)


def test_throughput_dy_major_tie_break():
    """Exact ties: the first cell in flat (dy-major) order wins, where B2's
    dx-major order picks another, unless the middle cell ties the best."""
    maxh, maxw = 6, 4
    f1 = np.zeros((1, 1, 1, 2), np.float32)
    f2 = np.full((1, maxh, maxw, 2), 5.0, np.float32)
    f2[0, 0, 3] = 0.0          # cell (dy=0, dx=3): d = 3
    f2[0, 2, 0] = 0.0          # cell (dy=2, dx=0): d = 8, first in dx-major
    args = (torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw)
    assert texp.match_flow_throughput(*args)[0].item() == 3
    assert tmatching.match_flow_fast(*args)[0].item() == 8
    ref = jexp.match_flow_throughput(jnp.asarray(f1), jnp.asarray(f2), maxh,
                                     maxw, 8, 8, True)
    assert int(np.asarray(ref[0]).ravel()[0]) == 3
    f2[0, 2, 1] = 0.0          # the middle cell (dy=2, dx=1) ties: it wins
    assert texp.match_flow_throughput(*args)[0].item() == 2 * maxw + 1


def test_throughput_unbatched_and_block_cols():
    case = CASES[1]
    _, _, _, _, maxh, maxw = case
    f1, f2 = _inputs(*case, seed=11)
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    batched = texp.match_flow_throughput(t1, t2, maxh, maxw)
    one = texp.match_flow_throughput(t1[1], t2[1], maxh, maxw, 4, 16)
    for a, b in zip(one, batched):
        assert a.shape == b.shape[1:]
        np.testing.assert_array_equal(a.numpy(), b[1].numpy())
    with pytest.raises(ValueError, match="block_cols"):
        texp.match_flow_throughput(t1, t2, maxh, maxw, 8, 12)
    with pytest.raises(ValueError):
        texp.match_flow_throughput(t1, t2[:, 1:], maxh, maxw)


@pytest.mark.parametrize("dt", ["f32", "bf16"])
@pytest.mark.parametrize("block_rows", [8, 5])
def test_mxu_matches_jax(dt, block_rows):
    """The band-matmul matcher against the reference (16x24x5, 6x6 window,
    as the reference's contract test, and 4x3 at B=2)."""
    jdt, tdt = {"f32": (jnp.float32, torch.float32),
                "bf16": (jnp.bfloat16, torch.bfloat16)}[dt]
    rng = np.random.RandomState(9)
    for B, H, W, K, maxh, maxw in ((None, 16, 24, 5, 6, 6), (2, 7, 9, 3, 4, 3)):
        lead = () if B is None else (B,)
        f1 = rng.rand(*lead, H, W, K).astype(np.float32)
        f2 = rng.rand(*lead, H + maxh - 1, W + maxw - 1, K).astype(np.float32)
        ref = [np.asarray(o) for o in jexp.match_flow_mxu(
            jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, block_rows, jdt)]
        ours = [o.numpy() for o in texp.match_flow_mxu(
            torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw,
            block_rows, tdt)]
        assert ours[0].shape == lead + (H, W)
        # WTA may differ only at near-ties of the costs on the rounded
        # inputs (the norms are f32 on both sides, so bf16 moves the gap)
        q1 = torch.from_numpy(f1).to(tdt).float().numpy()
        q2 = torch.from_numpy(f2).to(tdt).float().numpy()
        gap = _gap(q1.reshape((-1,) + q1.shape[-3:]),
                   q2.reshape((-1,) + q2.shape[-3:]), maxh, maxw).reshape(
                       ours[0].shape)
        diff = ours[0] != ref[0]
        assert diff.mean() <= 1e-3 or diff.sum() <= 1, diff.sum()
        assert (gap[diff] < 1e-4).all(), diff.sum()
        for a, b in zip(ours[1:], ref[1:]):
            np.testing.assert_allclose(a, b, rtol=0, atol=1e-4)


def test_band_from_gram_matches_jax():
    rng = np.random.RandomState(3)
    G = rng.rand(2, 3, 5, 9).astype(np.float32)
    ours = texp._band_from_gram(torch.from_numpy(G), 5).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jexp._band_from_gram(jnp.asarray(G), 5)))
    for x in range(5):
        for dx in range(5):
            np.testing.assert_array_equal(ours[..., x, dx], G[..., x, x + dx])
