"""PyTorch port vs the JAX package: the flow post-processing filters and the
local normalizations."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.models import legacy_depth as jlegacy
from depth_estimation_tpu.ops import normalization as jnorm
from depth_estimation_tpu.ops import postprocess as jpost
from depth_estimation_tpu_torch.models import legacy_depth as tlegacy
from depth_estimation_tpu_torch.ops import normalization as tnorm
from depth_estimation_tpu_torch.ops import postprocess as tpost


def _flow(seed, H=21, W=26, span=6.0):
    rng = np.random.RandomState(seed)
    flow = rng.uniform(-span, span, (2, H, W)).astype(np.float32)
    flow[:, 5:12, 4:15] = np.round(flow[:, 5:12, 4:15] / 3)   # a mode to find
    mask = (rng.rand(H, W) > 0.3).astype(np.float32)
    return flow, mask


@pytest.mark.parametrize("k", [3, 5])
@pytest.mark.parametrize("span", [3.0, 6.0, 14.0])
@pytest.mark.parametrize("method", ["max", "med"])
def test_post_process_matches_jax(k, span, method):
    """Flow spans of 6, 12 and 28 px: at 28 px the combined bin x + 16 y
    runs past 256 and those pixels count nowhere (the reference's one-hot
    drops them), and x bins past 16 alias into the next row."""
    flow, mask = _flow(int(span) * 10 + k, span=span)
    v = (np.floor(flow[1] + 0.5) - np.floor(np.floor(flow + 0.5).min())
         + 16 * (np.floor(flow[0] + 0.5) - np.floor(np.floor(flow + 0.5).min())))
    if span > 8:
        assert (v >= 256).mean() > 0.1
    ours = tpost.post_process_image(torch.from_numpy(flow),
                                    torch.from_numpy(mask), k, method).numpy()
    ref = np.asarray(jpost.post_process_image(jnp.asarray(flow),
                                              jnp.asarray(mask), k, method))
    assert ours.shape == ref.shape == flow.shape
    np.testing.assert_array_equal(ours, ref)


def test_median_filter_empty_windows():
    flow, mask = _flow(3)
    mask[:8] = 0.0                      # windows with no valid pixel give 0
    ours = tpost.median_filter(torch.from_numpy(flow), torch.from_numpy(mask),
                               3).numpy()
    np.testing.assert_array_equal(
        ours, np.asarray(jpost.median_filter(jnp.asarray(flow),
                                             jnp.asarray(mask), 3)))
    assert (ours[:, 1:7] == 0).all()


@pytest.mark.parametrize("k", [1, 4, 17])
def test_gaussian1d_matches_jax(k):
    np.testing.assert_array_equal(tnorm.gaussian1d(k), jnorm.gaussian1d(k))


@pytest.mark.parametrize("k,C", [(17, 3), (7, 1), (9, 2)])
def test_contrastive_normalization_matches_jax(k, C):
    rng = np.random.RandomState(k + C)
    img = rng.rand(23, 31, C).astype(np.float32)
    ours = tnorm.spatial_contrastive_normalization(torch.from_numpy(img), k)
    ref = np.asarray(jnorm.spatial_contrastive_normalization(jnp.asarray(img), k))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-5)
    # a leading batch normalizes each image on its own
    both = tnorm.spatial_contrastive_normalization(
        torch.from_numpy(np.stack([img, 2 * img + 1])), k)
    np.testing.assert_allclose(both[0].numpy(), ours.numpy(), rtol=0, atol=1e-6)


@pytest.mark.parametrize("k", [15, 5])
def test_subtractive_normalization_matches_jax(k):
    rng = np.random.RandomState(k)
    img = rng.rand(2, 19, 24, 2).astype(np.float32)
    ours = tlegacy.subtractive_normalization(torch.from_numpy(img), k).numpy()
    ref = np.asarray(jlegacy.subtractive_normalization(jnp.asarray(img), k))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    one = tlegacy.subtractive_normalization(torch.from_numpy(img[1]), k).numpy()
    np.testing.assert_allclose(
        one, np.asarray(jlegacy.subtractive_normalization(jnp.asarray(img[1]), k)),
        rtol=0, atol=1e-5)
