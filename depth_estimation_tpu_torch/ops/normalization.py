"""Local contrastive normalization (port of
``depth_estimation_tpu.ops.normalization``), as torch's
nn.SpatialContrastiveNormalization computes it: a separable gaussian
window normalized over kernel-sum x channels gives a cross-channel local
mean (subtracted) and local std (divided, floored by its spatial mean), with
border renormalization by the convolved coefficient map. The version2
network normalizes its inputs with it; the legacy CNN's subtractive
normalization (``models.legacy_depth``) is its first half."""

from __future__ import annotations

import numpy as np
import torch


def gaussian1d(k: int, sigma: float = 0.25) -> np.ndarray:
    """torch image.gaussian1D: size k, sigma relative to size, amplitude 1,
    centered."""
    x = np.arange(k, dtype=np.float64)
    center = (k - 1) / 2
    g = np.exp(-((x - center) / (sigma * k)) ** 2 / 2)
    return g.astype(np.float32)


def _sep_conv_same(x: torch.Tensor, f: np.ndarray) -> torch.Tensor:
    """Separable 'same' correlation with zero padding over the last two
    dims of x (..., H, W), the taps summed in order (rows, then columns)."""
    r = len(f) // 2
    H, W = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (0, 0, r, r))
    out = torch.zeros_like(x)
    for i, w in enumerate(f):
        out = out + float(w) * xp[..., i:i + H, :]
    xp = torch.nn.functional.pad(out, (r, r))
    out2 = torch.zeros_like(x)
    for i, w in enumerate(f):
        out2 = out2 + float(w) * xp[..., i:i + W]
    return out2


def _channel_sum(x: torch.Tensor, f: np.ndarray) -> torch.Tensor:
    """sum_c _sep_conv_same(x[..., c], f) for x (..., H, W, C): every
    channel convolved at once (the same taps in the same order on each),
    then summed in c order."""
    conv = _sep_conv_same(x.movedim(-1, -3), f)          # (..., C, H, W)
    acc = conv[..., 0, :, :]
    for c in range(1, conv.shape[-3]):
        acc = acc + conv[..., c, :, :]
    return acc


def _local_mean(img: torch.Tensor, f: np.ndarray):
    """The border-renormalization map and the cross-channel local mean of
    img (..., H, W, C) under the normalized window f."""
    C = img.shape[-1]
    ones = torch.ones(img.shape[-3:-1], dtype=img.dtype, device=img.device)
    coef = torch.clamp(_sep_conv_same(ones, f) * C, min=1e-8)
    return coef, _channel_sum(img, f) / coef


def _window(k: int, C: int) -> np.ndarray:
    f = gaussian1d(k)
    return f / (f.sum() * C)          # torch kernel normalization


def spatial_contrastive_normalization(img: torch.Tensor, k: int = 17) -> torch.Tensor:
    """img (..., H, W, C) -> same shape, gaussian window of size k; each
    leading index is one image (the std floor is that image's mean std)."""
    C = img.shape[-1]
    f = _window(k, C)
    coef, mean = _local_mean(img, f)
    v = img - mean[..., None]
    sq = v * v
    local_var = _channel_sum(sq, f)
    local_std = torch.sqrt(torch.clamp(local_var / coef, min=0.0))
    thresh = torch.maximum(local_std, local_std.mean(dim=(-2, -1), keepdim=True))
    thresh = torch.clamp(thresh, min=1e-4)
    return v / thresh[..., None]
