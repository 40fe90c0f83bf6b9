"""Confidence extraction, confidence masks and mask erosion (port of
``depth_estimation_tpu.ops.extract``).

``extract_output`` scans each pixel's distribution, keeps the first (in
scan order) ``max_highs`` values above the threshold, and returns the
argmax among the kept values and the rank-weighted score
``sum_k (max_highs - k) * v_sorted[k]`` (0 where nothing clears the
threshold; then the index is the plain argmax).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn.functional as F

from ..utils.device import resolve


def extract_output(dist: torch.Tensor, threshold: float = 0.11,
                   max_highs: Optional[int] = None) -> Tuple[torch.Tensor, torch.Tensor]:
    """dist (..., D) -> (idx int32 (...), score (...))."""
    if max_highs is None:
        max_highs = 8 if threshold < 0.2 else 4
    k_eff = min(max_highs, dist.shape[-1])
    above = dist > threshold
    kept = above & (torch.cumsum(above.int(), dim=-1) <= max_highs)
    v = torch.where(kept, dist, torch.zeros_like(dist))
    vals = torch.sort(v, dim=-1, descending=True, stable=True)[0][..., :k_eff]
    weights = torch.arange(max_highs, max_highs - k_eff, -1,
                           dtype=dist.dtype, device=dist.device)
    score = torch.einsum("...k,k->...", vals, weights)
    any_kept = kept.any(dim=-1)
    idx = torch.where(any_kept, torch.argmax(v, dim=-1),
                      torch.argmax(dist, dim=-1)).to(torch.int32)
    return idx, score


def extract_output_marginalized(
    dist: torch.Tensor, threshold: float = 0.11, threshold_acc: float = 0.0,
    max_highs: Optional[int] = None,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The same scan as ``extract_output``, gated on the accumulated score:
    (idx, good) with good = 1 (int32) where the rank-weighted score clears
    ``threshold_acc``, else 0. The caller marginalizes the window
    distribution first (sums over the x axis)."""
    idx, score = extract_output(dist, threshold, max_highs)
    return idx, (score >= threshold_acc).to(torch.int32)


def confidences_from_marginal(marg: torch.Tensor,
                              threshold: float = 0.11) -> torch.Tensor:
    """Thresholded extraction on a y-marginal (..., maxh) -> bool (...):
    score > 0 (the 'mean' head's gate)."""
    _, score = extract_output(marg, threshold)
    return score > 0


def mean_head_confidences(dist: torch.Tensor, maxh: int, maxw: int,
                          threshold: float = 0.11) -> torch.Tensor:
    """The 'mean' head's confidence gate: marginalize the window
    distribution over x (a maxh-long y-marginal), run the thresholded
    extraction on it, keep pixels with score > 0. dist (..., maxh*maxw) ->
    bool (...)."""
    marg = dist.reshape(dist.shape[:-1] + (maxh, maxw)).sum(dim=-1)
    return confidences_from_marginal(marg, threshold)


def middle_disc_mask(h: int, w: int, radius: float = 25.0,
                     feather: float = 0.0, device="cuda") -> torch.Tensor:
    """Mask out a disc around the image center, where forward-motion flow
    vanishes and carries no depth signal, with optional linear feathering
    (the offline video pipeline's maskmiddle). (h, w) f32 on ``device``
    (the card by default; raises where there is none unless given
    ``device="cpu"``)."""
    device = resolve(device)
    ii = torch.arange(h, dtype=torch.float32, device=device)[:, None] - h / 2
    jj = torch.arange(w, dtype=torch.float32, device=device)[None, :] - w / 2
    d = torch.sqrt(ii * ii + jj * jj)
    if feather > 0:
        return torch.clamp((d - radius) / feather, 0.0, 1.0)
    return (d >= radius).float()


def entropy_mask(dist: torch.Tensor, threshold: float) -> torch.Tensor:
    """Uncertainty gate: False where the window distribution's entropy
    exceeds ``threshold``. dist (..., D) softmax scores -> bool (...)."""
    p = torch.clamp(dist, 1e-12, 1.0)
    return -torch.sum(p * torch.log(p), dim=-1) <= threshold


def enlarge_mask(mask: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """Erode a validity mask by the matcher footprint: a pixel stays valid
    only if the whole (kh, kw) window around it is valid (out of frame is
    invalid). (H, W) -> (H, W) bool."""
    return enlarge_mask_batched(mask[None], kh, kw)[0]


def enlarge_mask_batched(mask: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """enlarge_mask over a batch: (B, H, W) -> (B, H, W) bool; a min-pool as
    a max-pool of the complement, zero padded."""
    inv = 1.0 - mask.float()
    inv = F.pad(inv, (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2),
                value=1.0)
    eroded = 1.0 - F.max_pool2d(inv[:, None], (kh, kw), stride=1)[:, 0]
    return eroded > 0.5
