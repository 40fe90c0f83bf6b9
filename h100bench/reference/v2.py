"""The plain reference of the version2 net's batched flow, BASELINE config1,
in float32 plain PyTorch.

A frozen copy of the arithmetic, independent of the program it judges: it
imports nothing of the port, of ``jax`` or of the JAX package, and takes
nothing the program made. The benchmark hands it the same frames and
weights it hands the program. Every operation acts on each pair alone; a
leading axis holds a block of independent pairs.

Per pair of (H, W, 3) f32 frames, after ``version2/network.lua:5-39``:
  1. nn.SpatialContrastiveNormalization(3, image.gaussian1D(17)) on each
     frame: the 1-D gaussian of size k and sigma 0.25 k, amplitude 1,
     normalised over its sum times the channels; its outer product is one
     k x k kernel over every channel (``F.conv2d``, zero padding k // 2),
     so a convolution gives the cross-channel local mean; the same
     convolution of a frame of ones is the border coefficient each local
     sum is divided by (the border renormalisation); the local std is the
     square root of the convolved squared deviations over the coefficient,
     floored at the frame's mean local std and at 1e-4; the deviation over
     it is the output;
  2. the siamese 17x17 conv, 3 -> 32 features, VALID (``F.conv2d``);
  3. frame 1's features cropped by the window's asymmetric halves
     (ceil(h / 2) - 1 rows at the top, floor(h / 2) at the bottom; the same
     for columns), so that the match is centred;
  4. SpatialMatching's direct SSD: for each window cell (dy, dx) the sum
     over channels of (f1 - f2 shifted)^2 (``online.match_ssd``);
  5. the matching core's heads: p = softmax(-cost) over the window; the
     WTA, the first argmin in (dy, dx) order, replaced by the middle cell
     where it attains the minimum; ey, ex the soft-argmax of the centred
     displacement (dy - halfh1, dx - halfw1) under p; pmax the largest p.

Where it departs from ``version2/network.lua``:
  * the local std of step 1 is sqrt(S / coef), S the convolved squared
    deviations; nn.SpatialDivisiveNormalization takes sqrt(S) / coef.
    With version2's 1-D gaussian the coefficient is 1 / C inside the
    frame, so nn's std is sqrt(C) times this one there (its output
    1 / sqrt(C) of this one's), and the two part further towards the
    borders, where the coefficient falls;
  * the std is floored at the frame's mean local std (as torch's
    image.lcn does) besides 1e-4; nn floors it at 1e-4 alone
    (Threshold(1e-4, 1e-4)). Both choices are the JAX package's
    ``ops/normalization.spatial_contrastive_normalization``, which the
    port follows;
  * the heads of step 5 are the port's matching-core contract (idx, ey,
    ex, pmax), not version2's trainer head (Reshape, Minus, LogSoftMax,
    :41-47); the cost volume they read is the network's;
  * frame 1 is cropped after the conv, not padded negatively before it:
    the same features, as the convolution is VALID;
  * a batch of pairs, in float32 throughout, with seeded weights (no
    trained version2 checkpoint is at hand).

``flow`` turns TF32 off in cuDNN and cuBLAS (``tf32=True``, the
benchmark's control, turns it on), the previous flags restored after, and
works in blocks of ``block`` pairs so that the cost volume fits.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch
import torch.nn.functional as F

from h100bench.reference.online import match_ssd, tf32 as tf32_flags

SIGMA = 0.25            # image.gaussian1D's default, relative to the size
STD_FLOOR = 1e-4        # nn.SpatialDivisiveNormalization's threshold


class V2(NamedTuple):
    """The configuration: the normalisation's kernel size, the trunk's
    (32, 3, 17, 17) weight and (32,) bias on the device, and the window."""
    norm_k: int
    weight: torch.Tensor
    bias: torch.Tensor
    h_win: int
    w_win: int


def gaussian1d(k: int, device=None) -> torch.Tensor:
    """image.gaussian1D(k): exp(-((x - centre) / (sigma k))^2 / 2) over
    x = 0 .. k - 1, in float64, then float32."""
    x = torch.arange(k, dtype=torch.float64)
    g = torch.exp(-((x - (k - 1) / 2) / (SIGMA * k)) ** 2 / 2)
    return g.to(torch.float32).to(device)


def contrastive_normalize(img: torch.Tensor, k: int) -> torch.Tensor:
    """(N, H, W, C) -> (N, H, W, C), each frame on its own (step 1)."""
    N, H, W, C = img.shape
    g = gaussian1d(k, img.device)
    g = g / (g.sum() * C)
    ker = torch.outer(g, g).expand(1, C, k, k).contiguous()
    x = img.permute(0, 3, 1, 2)
    ones = torch.ones((1, C, H, W), device=img.device)
    coef = F.conv2d(ones, ker, padding=k // 2).clamp(min=1e-8)
    mean = F.conv2d(x, ker, padding=k // 2) / coef
    v = x - mean
    var = F.conv2d(v * v, ker, padding=k // 2) / coef
    std = torch.sqrt(var.clamp(min=0.0))
    floor = torch.maximum(std, std.mean(dim=(-2, -1), keepdim=True))
    out = v / floor.clamp(min=STD_FLOOR)
    return out.permute(0, 2, 3, 1)


def features(m: V2, img: torch.Tensor) -> torch.Tensor:
    """(N, H, W, 3) frames -> (N, H - 16, W - 16, 32) features."""
    n = contrastive_normalize(img, m.norm_k).permute(0, 3, 1, 2)
    return F.conv2d(n, m.weight, m.bias).permute(0, 2, 3, 1)


def heads(cost: torch.Tensor, h_win: int, w_win: int) -> dict:
    """The matching core's (idx, ey, ex, pmax) from the cost volume."""
    h1, w1 = math.ceil(h_win / 2) - 1, math.ceil(w_win / 2) - 1
    mid = h1 * w_win + w1
    best = cost.argmin(-1)
    cmin = cost.amin(-1)
    idx = torch.where(cost[..., mid] <= cmin, torch.full_like(best, mid),
                      best).to(torch.int32)
    p = torch.softmax(-cost, dim=-1)
    cells = torch.arange(h_win * w_win, device=cost.device)
    dy = (cells // w_win - h1).to(torch.float32)
    dx = (cells % w_win - w1).to(torch.float32)
    return {"idx": idx, "ey": (p * dy).sum(-1), "ex": (p * dx).sum(-1),
            "pmax": p.amax(-1)}


@torch.no_grad()
def flow(m: V2, img1: torch.Tensor, img2: torch.Tensor, tf32: bool = False,
         block: int = 8) -> dict:
    """B pairs of (B, H, W, 3) f32 frames -> {idx, ey, ex, pmax}, each
    (B, H - 16 - h_win + 1, W - 16 - w_win + 1), computed ``block`` pairs
    at a time."""
    h1, h2 = math.ceil(m.h_win / 2) - 1, m.h_win // 2
    w1, w2 = math.ceil(m.w_win / 2) - 1, m.w_win // 2
    parts = []
    with tf32_flags(tf32):
        for a in range(0, img1.shape[0], block):
            f1 = features(m, img1[a:a + block].float())
            f2 = features(m, img2[a:a + block].float())
            f1 = f1[:, h1:f1.shape[1] - h2, w1:f1.shape[2] - w2]
            parts.append(heads(match_ssd(f1, f2, m.h_win, m.w_win), m.h_win,
                               m.w_win))
    return {k: torch.cat([p[k] for p in parts]) for k in parts[0]}
