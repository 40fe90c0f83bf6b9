"""PyTorch port vs the JAX package at the shapes beyond the unblocked
fused kernel (ROADMAP C24): more than 16 window rows and more than 32
channels, which the card takes through B1's general kernel. The port's
plain twin (B1's CPU path) against the Pallas kernel in interpret mode, in
plain, marginal and gate modes."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.ops import matching as jmatching
from depth_estimation_tpu_torch.ops import matching as tmatching

B, H, W = 2, 5, 9
WINDOWS = [(17, 5), (24, 3)]
CHANNELS = [33, 40]
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}
THR = 0.11


def _inputs(maxh, maxw, K):
    """Features whose costs have the magnitude of the K=8 tests'
    (test_torch_matching.py), whose tolerances these are: the two packages
    sum the channels in different orders, and that rounding grows with the
    cost."""
    rng = np.random.RandomState(maxh * 100 + maxw + K)
    scale = 0.5 * np.sqrt(8 / K)
    f1 = (scale * rng.randn(B, H, W, K)).astype(np.float32)
    f2 = (scale * rng.randn(B, H + maxh - 1, W + maxw - 1, K)).astype(
        np.float32)
    return f1, f2


def _gap(f1, f2, maxh, maxw, dt):
    """Per-pixel gap between the best and the second-best logit."""
    costs = tmatching.match_ssd(torch.from_numpy(f1), torch.from_numpy(f2),
                                maxh, maxw, dt).numpy()
    s = np.sort(-costs, axis=-1)
    return s[..., -1] - s[..., -2]


@pytest.mark.parametrize("mode,dt", [("plain", "f32"), ("marg", "f32"),
                                     ("conf", "f32"), ("plain", "bf16")])
@pytest.mark.parametrize("K", CHANNELS)
@pytest.mark.parametrize("maxh,maxw", WINDOWS)
def test_fused_plain_matches_jax_beyond_the_unblocked_kernel(maxh, maxw, K,
                                                             mode, dt):
    assert tmatching.fused_plan(maxh, maxw, K).general
    f1, f2 = _inputs(maxh, maxw, K)
    jdt, tdt = DTYPES[dt]
    ref = [np.asarray(o) for o in jmatching.match_flow_fused(
        jnp.asarray(f1), jnp.asarray(f2), maxh, maxw, 8, True,
        mode == "marg", jdt, mode == "conf", THR)]
    n0 = tmatching.match_flow_fused.launches
    ours = [o.numpy() for o in tmatching.match_flow_fused(
        torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw, 8,
        mode == "marg", tdt, mode == "conf", THR)]
    assert tmatching.match_flow_fused.launches == n0      # CPU: plain twin
    assert len(ours) == len(ref) == (4 if mode == "plain" else 5)
    assert ours[0].dtype == np.int32 and ours[0].shape == (B, H, W)
    # WTA index: equal except where the two best logits are within 1e-5
    diff = ours[0] != ref[0]
    assert (_gap(f1, f2, maxh, maxw, tdt)[diff] < 1e-5).all(), diff.sum()
    for a, b in zip(ours[1:4], ref[1:4]):                # ey, ex, pmax
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)
    if mode == "marg":
        assert ours[4].shape == (B, maxh, H, W)
        np.testing.assert_allclose(ours[4], ref[4], rtol=0, atol=1e-6)
    if mode == "conf":
        # the gate may differ only where the marginal's peak sits on the
        # threshold
        marg = tmatching.match_flow_fused(
            torch.from_numpy(f1), torch.from_numpy(f2), maxh, maxw, 8,
            True)[4].numpy()
        off = ours[4] != ref[4]
        assert (np.abs(marg.max(axis=1) - THR)[off] <= 1e-5).all(), off.sum()
