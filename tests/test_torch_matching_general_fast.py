"""PyTorch port vs the JAX package at shapes beyond the decomposed
kernels' first channel bounds (ROADMAP C24): more than 16 window rows and
more than 32 channels, which the card takes through B2's and B5's K = 64
and run-time channel paths. The plain twins (B2's and B5's CPU paths)
against the Pallas kernels in interpret mode."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.ops import matching as jmatching
from depth_estimation_tpu.ops import matching_experimental as jexp
from depth_estimation_tpu_torch.ops import matching as tmatching
from depth_estimation_tpu_torch.ops import matching_experimental as texp

B, H, W = 2, 5, 9
WINDOWS = [(17, 5), (24, 3)]
CHANNELS = [33, 40]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


def _inputs(maxh, maxw, K):
    """Features whose costs have the magnitude of the K=8 tests'
    (test_torch_matching.py), whose tolerances these are: the two packages
    sum the channels in different orders, and that rounding grows with the
    cost."""
    rng = np.random.RandomState(maxh * 100 + maxw + K + 1)
    scale = 0.5 * np.sqrt(8 / K)
    f1 = (scale * rng.randn(B, H, W, K)).astype(np.float32)
    f2 = (scale * rng.randn(B, H + maxh - 1, W + maxw - 1, K)).astype(
        np.float32)
    return f1, f2


def _assert_contract(ours, ref, f1, f2, maxh, maxw, dt=torch.float32):
    """idx equal except where the two best logits are within 1e-5; ey, ex,
    pmax within 1e-5."""
    costs = tmatching.match_ssd(torch.from_numpy(f1), torch.from_numpy(f2),
                                maxh, maxw, dt).numpy()
    s = np.sort(-costs, axis=-1)
    gap = s[..., -1] - s[..., -2]
    assert ours[0].dtype == np.int32 and ours[0].shape == (B, H, W)
    diff = ours[0] != ref[0]
    assert (gap[diff] < 1e-5).all(), diff.sum()
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


@pytest.mark.parametrize("maxh,maxw,K,dt", [
    (17, 5, 33, "f32"), (24, 3, 40, "f32"), (17, 5, 40, "f32"),
    (24, 3, 33, "f32"), (17, 5, 33, "bf16"), (24, 3, 40, "bf16")])
def test_fast_plain_matches_jax_above_32_channels(maxh, maxw, K, dt):
    f1, f2 = _inputs(maxh, maxw, K)
    jdt, tdt = DTYPES[dt]
    assert tmatching.channel_bound(K) == 64
    ref = [np.asarray(o) for o in jmatching.match_flow_fast(
        jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, 8, True, jdt)]
    n0 = tmatching.match_flow_fast.launches
    ours = [o.numpy() for o in tmatching.match_flow_fast(
        torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw, 8, tdt)]
    assert tmatching.match_flow_fast.launches == n0     # CPU: plain twin
    _assert_contract(ours, ref, f1, f2, maxh, maxw, tdt)


@pytest.mark.parametrize("maxh,maxw,K", [(17, 5, 33), (24, 3, 40),
                                         (17, 5, 40), (24, 3, 33)])
def test_throughput_plain_matches_jax_above_32_channels(maxh, maxw, K):
    f1, f2 = _inputs(maxh, maxw, K)
    ref = [np.asarray(o) for o in jexp.match_flow_throughput(
        jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, 8, 8, True)]
    n0 = texp.match_flow_throughput.launches
    ours = [o.numpy() for o in texp.match_flow_throughput(
        torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw)]
    assert texp.match_flow_throughput.launches == n0    # CPU: plain twin
    _assert_contract(ours, ref, f1, f2, maxh, maxw)
