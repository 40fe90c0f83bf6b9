"""Lens undistortion and rotation compensation (port of
``depth_estimation_tpu.geometry3d.undistort``).

Undistortion maps each output pixel through the Brown 5-coefficient model
and samples the distorted source bilinearly; rotation compensation warps by
the infinite homography K R K^-1, out(x) = img(K R K^-1 x). Samples that
fall out of frame (beyond a 1e-3 px tolerance for the f32 round trip) are
zeroed.

The compensation forms of the online program:
  * ``remove_ego_motion(_batched)`` — the unconditional clamped 4-tap gather;
  * ``remove_ego_motion_banded`` — the banded warp (kernel B3 on CUDA,
    ``ops/warp.py``), exact within ``band`` and band-masked beyond;
  * ``remove_ego_motion_exact`` — the banded warp when every in-frame
    displacement is in band, the gather otherwise. Under a trace
    (torch.export) the choice is ``torch.cond``, as the reference chooses
    with ``lax.cond``, so the program keeps both branches; run eagerly it
    is one read of the predicate back to the host (eager ``torch.cond``
    reads it all the same, and adds Dynamo's guards).
"""

from __future__ import annotations

from functools import lru_cache
from typing import Tuple

import torch

from ..flow.celiu import bilinear_sample
from ..ops.warp import banded_bilinear_warp

EPS = 1e-3


def _as_f32(a, device) -> torch.Tensor:
    return torch.as_tensor(a, dtype=torch.float32, device=device)


def _in_frame(xs, ys, H: int, W: int) -> torch.Tensor:
    return ((xs >= -EPS) & (xs <= W - 1 + EPS)
            & (ys >= -EPS) & (ys <= H - 1 + EPS))


def distort_points(x: torch.Tensor, y: torch.Tensor, dist) -> Tuple[torch.Tensor, torch.Tensor]:
    """Apply the forward Brown model to normalized coords."""
    k1, k2, p1, p2, k3 = [float(d) for d in dist]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    return xd, yd


def undistort_image(img: torch.Tensor, K, dist) -> torch.Tensor:
    """img (..., H, W, C); K 3x3 intrinsics shared by every item; dist 5
    coefficients. Out-of-range samples are zero."""
    K = _as_f32(K, img.device)
    H, W = img.shape[-3], img.shape[-2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    j = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    i = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    xn = (j - cx) / fx * torch.ones((H, 1), device=img.device)
    yn = (i - cy) / fy * torch.ones((1, W), device=img.device)
    xd, yd = distort_points(xn, yn, dist)
    xs = xd * fx + cx
    ys = yd * fy + cy
    lead = img.shape[:-3]
    out = bilinear_sample(img, xs.expand(lead + (H, W)), ys.expand(lead + (H, W)))
    return out * _in_frame(xs, ys, H, W)[..., None]


def homography_grid(K, R: torch.Tensor, H: int, W: int):
    """Sample coordinates of out(x) = img(K R K^-1 x). K (3, 3) shared;
    R (..., 3, 3). Returns (xs, ys) (..., H, W)."""
    R = _as_f32(R, R.device if torch.is_tensor(R) else None)
    K = _as_f32(K, R.device)
    # inv_ex: the same inverse, without the error check's read to the host
    Hm = K @ R @ torch.linalg.inv_ex(K).inverse          # (..., 3, 3)
    xx = torch.arange(W, dtype=torch.float32, device=R.device)[None, :]
    yy = torch.arange(H, dtype=torch.float32, device=R.device)[:, None]
    h = [[Hm[..., a, c, None, None] for c in range(3)] for a in range(3)]
    q = [h[a][0] * xx + h[a][1] * yy + h[a][2] for a in range(3)]
    return q[0] / q[2], q[1] / q[2]


def remove_ego_motion(img: torch.Tensor, K, R) -> torch.Tensor:
    """Rotation compensation of one image (H, W, C) by R (3, 3): the
    unconditional clamped 4-tap gather, out-of-frame samples zeroed."""
    H, W = img.shape[0], img.shape[1]
    xs, ys = homography_grid(K, _as_f32(R, img.device), H, W)
    out = bilinear_sample(img, xs, ys)
    return out * _in_frame(xs, ys, H, W)[..., None]


def remove_ego_motion_batched(imgs: torch.Tensor, K, R, dtype=None) -> torch.Tensor:
    """remove_ego_motion over B items with per-item rotations: imgs
    (B, H, W, C), R (B, 3, 3). ``dtype``: optional storage type of the
    gathered values (weights stay f32; the result is f32)."""
    H, W = imgs.shape[1], imgs.shape[2]
    if dtype is not None:
        imgs = imgs.to(dtype)
    xs, ys = homography_grid(K, _as_f32(R, imgs.device), H, W)
    out = bilinear_sample(imgs, xs, ys).float()
    return out * _in_frame(xs, ys, H, W)[..., None]


def warp_in_band(K, R, H: int, W: int, band: int) -> torch.Tensor:
    """Bool tensor: does every in-frame sample of the homography warp
    displace by at most ``band`` on both axes (over every item of R)?"""
    xs, ys = homography_grid(K, R, H, W)
    jj = torch.arange(W, dtype=torch.float32, device=xs.device)[None, :]
    ii = torch.arange(H, dtype=torch.float32, device=xs.device)[:, None]
    banded = (torch.abs(xs - jj) <= band) & (torch.abs(ys - ii) <= band)
    return torch.all(~_in_frame(xs, ys, H, W) | banded)


def ego_motion_valid_mask(K, R, H: int, W: int, band: int = 0) -> torch.Tensor:
    """The warp-validity mask, computed from the homography grid alone:
    R (..., 3, 3) -> (..., H, W) float. ``band`` > 0 also excludes pixels
    whose displacement exceeds it."""
    xs, ys = homography_grid(K, R, H, W)
    ok = _in_frame(xs, ys, H, W)
    if band > 0:
        jj = torch.arange(W, dtype=torch.float32, device=xs.device)[None, :]
        ii = torch.arange(H, dtype=torch.float32, device=xs.device)[:, None]
        ok = ok & (torch.abs(xs - jj) <= band) & (torch.abs(ys - ii) <= band)
    return ok.float()


def remove_ego_motion_banded(imgs: torch.Tensor, K, R, band: int = 8,
                             dtype=None) -> torch.Tensor:
    """Banded warp of imgs (B, H, W, C) by R (B, 3, 3), masked by the
    band-limited validity mask: exact wherever the displacement is within
    ``band``, zero elsewhere. ``dtype``: optional storage type of the
    sampled values (bf16 halves the reads; accumulation is f32)."""
    H, W = imgs.shape[1], imgs.shape[2]
    if dtype is not None:
        imgs = imgs.to(dtype)
    R = _as_f32(R, imgs.device)
    xs, ys = homography_grid(K, R, H, W)
    out = banded_bilinear_warp(imgs, xs, ys, band)
    return out * ego_motion_valid_mask(K, R, H, W, band=band)[..., None]


def remove_ego_motion_exact(imgs: torch.Tensor, K, R, band: int = 8,
                            dtype=None) -> torch.Tensor:
    """The unconditional 4-tap warp: through the banded warp when
    ``warp_in_band`` holds for the whole batch (then it equals the gather on
    every pixel the validity mask keeps), through the gather otherwise.
    Under a trace the choice is ``torch.cond`` on the 0-d predicate, as the
    reference's ``lax.cond``, so that torch.export keeps both branches in
    the program; run eagerly it costs one device-to-host read of the
    predicate."""
    H, W = imgs.shape[1], imgs.shape[2]
    R = _as_f32(R, imgs.device)
    K = _as_f32(K, imgs.device)
    pred = warp_in_band(K, R, H, W, band)
    banded, gather = _exact_branches(band, dtype)
    if torch.compiler.is_compiling():
        return torch.cond(pred, banded, gather, (imgs, K, R))
    return (banded if bool(pred) else gather)(imgs, K, R)


@lru_cache(maxsize=None)
def _exact_branches(band: int, dtype):
    """The two branches of ``remove_ego_motion_exact``, made once per
    (band, dtype) so that torch.cond meets the same functions each call."""
    def banded(imgs, K, R):
        return remove_ego_motion_banded(imgs, K, R, band=band, dtype=dtype)

    def gather(imgs, K, R):
        return remove_ego_motion_batched(imgs, K, R, dtype=dtype)

    return banded, gather
