"""Ego-motion from a frame pair (port of
``depth_estimation_tpu.geometry3d.egomotion``): Shi-Tomasi corners,
pyramidal Lucas-Kanade (window-cached for the online program, full-image
for the offline loaders), an 8-point essential-matrix RANSAC, the 4-DoF
(pan, tilt, zoom, roll) least-squares model with its RANSAC and
nearest-neighbour affine warp (the 'mc' motion correction), and the
epipolar helpers (F from E, E from (R, T), the epipole).

Everything is batched over a leading B axis; the per-pair functions add and
drop it. Shapes are static as in the reference: always ``max_points``
corners with a validity mask.

Where the port differs from the JAX module, on purpose:
  * RANSAC draws its Gumbel noise (n_samples, 8, n) from an explicit
    ``torch.Generator`` (seed 1 by default), shared by every batch item as
    the reference shares its key. Torch cannot reproduce ``jax.random``'s
    stream, so every entry point also takes the noise as an argument.
  * Corner ranking sorts stably (``torch.sort(..., stable=True)``), which
    reproduces ``lax.top_k``'s lower-index-first order on the many exact
    ties at score 0; ``torch.topk`` leaves tie order unspecified on CUDA.
  * ``_gather_window`` reads the image rounded to bf16, as the reference's
    one-hot matmuls at ``Precision.DEFAULT`` do on every backend, but by
    integer indexing. The full tracker's bilinear patches
    (``_sample_patches``) are four gathers blended rows first, then
    columns, the order of the reference's separable selection products.
  * ``lsq_trans_ransac`` takes its (n_samples, 5) sample indices as an
    argument (default: a CPU ``torch.Generator`` seeded 0), as RANSAC's
    noise above.

Gray levels and corner scores stay in the input's dtype (bf16 for a bf16
stream state), rounded where the reference rounds them; LK's windows and
RANSAC run in float32.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..models.multiscale import avg_downsample
from ..utils.timer import profiled_span
from . import qr_graph


class EgoMotion(NamedTuple):
    R: torch.Tensor          # (..., 3, 3) rotation prev->curr
    T: torch.Tensor          # (..., 3) unit translation
    n_inliers: torch.Tensor  # (...,) int
    n_found: torch.Tensor    # (...,) int


# ---------------------------------------------------------------------------
# Shi-Tomasi corners
# ---------------------------------------------------------------------------

def _to_gray_batched(imgs: torch.Tensor) -> torch.Tensor:
    """(B, H, W[, 3 or 1]) -> (B, H, W) in the input's floating dtype: luma
    weights rounded to that dtype, the channel-order sum of the products
    in float32, one rounding at the end (the reference's fused reduce).
    The reference's products stay in float32 for f32 and bf16 input, and
    are rounded to f16 for f16 input (XLA keeps excess precision for bf16
    only), so they are here too."""
    if not imgs.is_floating_point():
        imgs = imgs.float()
    if imgs.ndim == 4 and imgs.shape[-1] == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=imgs.dtype).tolist()
        p = imgs.float()
        prods = [p[..., c] * w[c] for c in range(3)]
        if imgs.dtype == torch.float16:
            prods = [q.half().float() for q in prods]
        return ((prods[0] + prods[1]) + prods[2]).to(imgs.dtype)
    return imgs[..., 0] if imgs.ndim == 4 else imgs


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """k x k box sum over the last two dims with zero padding (k//2 before,
    k-1-k//2 after), accumulated window position by position in row-major
    order from 0 — the reduction order of the reference's reduce_window."""
    H, W = x.shape[-2:]
    p = F.pad(x, (k // 2, k - 1 - k // 2, k // 2, k - 1 - k // 2))
    acc = torch.zeros_like(x)
    for i in range(k):
        for j in range(k):
            acc = acc + p[..., i:i + H, j:j + W]
    return acc


@lru_cache(maxsize=None)
def _grid_dims(max_points: int, H: int, W: int) -> Tuple[int, int]:
    """The (gh, gw) cell grid whose aspect best matches the image, with
    gh * gw == max_points when a near-aspect factoring exists, else the
    near-square grid with gh * gw >= max_points."""
    target = (max_points * H / max(W, 1)) ** 0.5
    gh = min((d for d in range(1, max_points + 1) if max_points % d == 0),
             key=lambda d: abs(d - target))
    if target / 2 <= gh <= target * 2:
        return gh, max_points // gh
    gh = max(int(round(target)), 1)
    return gh, -(-max_points // gh)


def _grid_select(score: torch.Tensor, max_points: int, quality: float):
    """Sort-free selection: per-cell argmax (first pixel in row-major order
    on ties) over a grid of ~max_points cells. score (B, H, W) non-negative
    peak map. Returns (pts (B, N, 2) as (x, y), valid (B, N))."""
    B, H, W = score.shape
    gh, gw = _grid_dims(max_points, H, W)
    ch, cw = -(-H // gh), -(-W // gw)
    Hp, Wp = gh * ch, gw * cw
    s = F.pad(score, (0, Wp - W, 0, Hp - H)).reshape(B, gh, ch, gw, cw)
    m = s.amax(dim=(2, 4))                                    # (B, gh, gw)
    me = m[:, :, None, :, None]
    lin = (torch.arange(Hp, device=score.device)[:, None] * Wp
           + torch.arange(Wp, device=score.device)[None, :]).reshape(1, gh, ch, gw, cw)
    hit = (s == me) & (me > 0)
    idx = torch.where(hit, lin, torch.full_like(lin, Hp * Wp)).amin(dim=(2, 4))
    ys = torch.div(idx, Wp, rounding_mode="floor").float()
    xs = (idx % Wp).float()
    best = m.amax(dim=(1, 2))                                 # (B,)
    valid = (m > 0) & (m > quality * best.clamp(min=1e-20)[:, None, None])
    pts = torch.stack([xs, ys], dim=-1).reshape(B, gh * gw, 2)
    valid = valid.reshape(B, gh * gw)
    return torch.where(valid[..., None], pts, torch.zeros_like(pts)), valid


def corner_count(max_points: int, H: int, W: int,
                 selector: str = "topk") -> int:
    """N, the number of corners ``good_features_to_track_batched`` returns
    for (H, W) frames: the length of RANSAC's noise."""
    if selector == "grid":
        gh, gw = _grid_dims(max_points, H, W)
        return gh * gw
    return min(max_points, H * W)


def good_features_to_track_batched(
    imgs: torch.Tensor, max_points: int, quality: float = 0.01,
    min_dist: int = 8, block: int = 5, selector: str = "topk",
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Batched Shi-Tomasi: imgs (B, H, W[, 3]) -> (pts (B, N, 2) as (x, y),
    valid (B, N) bool). Min-eigenvalue score, border suppression, non-max
    suppression by a max-pool, quality gate relative to the best corner.
    ``selector``: 'topk' (global top max_points) or 'grid' (per cell)."""
    g = _to_gray_batched(imgs)
    gx = (F.pad(g[:, :, 2:], (0, 2)) - F.pad(g[:, :, :-2], (2, 0))) / 2
    gy = (F.pad(g[:, 2:, :], (0, 0, 0, 2)) - F.pad(g[:, :-2, :], (0, 0, 2, 0))) / 2
    ixx = _box_sum(gx * gx, block)
    iyy = _box_sum(gy * gy, block)
    ixy = _box_sum(gx * gy, block)
    tr = ixx + iyy
    if g.dtype == torch.float16:
        # the reference's f16 determinant is one fused multiply-add on the
        # CPU backend: ixx iyy - round(ixy ixy), rounded once
        det = (ixx.float() * iyy.float() - (ixy * ixy).float()).half()
    else:
        det = ixx * iyy - ixy * ixy
    lam_min = tr / 2 - torch.sqrt(torch.clamp(tr * tr / 4 - det, min=0.0))
    B, H, W = g.shape
    b = max(block, 3)
    border = torch.zeros((H, W), dtype=torch.bool, device=g.device)
    border[b:-b, b:-b] = True
    lam = torch.where(border, lam_min, torch.zeros_like(lam_min))
    k = max(int(min_dist) | 1, 3)
    p = F.pad(lam, (k // 2, k - 1 - k // 2, k // 2, k - 1 - k // 2),
              value=float("-inf"))
    mx = F.max_pool2d(p[:, None], k, stride=1)[:, 0]
    is_peak = (lam >= mx) & (lam > 0)
    # the quality gate runs in float32, as the reference's does under
    # get_ego_motion_batched (a float32 quality times the best score)
    score = torch.where(is_peak, lam, torch.zeros_like(lam)).float()
    if selector == "grid":
        return _grid_select(score, max_points, quality)
    if selector != "topk":
        raise ValueError(f"unknown corner selector {selector!r}")
    vals, flat = torch.sort(score.reshape(B, H * W), dim=-1, descending=True,
                            stable=True)
    vals, flat = vals[:, :max_points], flat[:, :max_points]
    ys = torch.div(flat, W, rounding_mode="floor").float()
    xs = (flat % W).float()
    valid = vals > quality * vals[:, :1].clamp(min=1e-20)
    return torch.stack([xs, ys], dim=-1), valid


def good_features_to_track(img: torch.Tensor, max_points: int,
                           quality: float = 0.01, min_dist: int = 8,
                           block: int = 5, selector: str = "topk"):
    """Per-image form: img (H, W[, 3]) -> (pts (N, 2), valid (N,))."""
    pts, valid = good_features_to_track_batched(
        img[None], max_points, quality, min_dist, block, selector)
    return pts[0], valid[0]


# ---------------------------------------------------------------------------
# Window-cached pyramidal Lucas-Kanade
# ---------------------------------------------------------------------------

def _gather_window(img: torch.Tensor, by: torch.Tensor, bx: torch.Tensor,
                   s: int) -> torch.Tensor:
    """(s, s) integer-aligned windows of img (B, H, W) at top-left (by, bx)
    (B, N) with clamped (replicate) indices, read from the bf16-rounded
    image as the reference's DEFAULT-precision one-hot matmuls read it.
    Returns (B, N, s, s) float32."""
    B, H, W = img.shape
    img = img.to(torch.bfloat16).float()
    k = torch.arange(s, device=img.device)
    rows = (by.long()[..., None] + k).clamp(0, H - 1)           # (B, N, s)
    cols = (bx.long()[..., None] + k).clamp(0, W - 1)
    lin = rows[..., :, None] * W + cols[..., None, :]           # (B, N, s, s)
    N = by.shape[1]
    out = torch.gather(img.reshape(B, H * W), 1, lin.reshape(B, N * s * s))
    return out.reshape(B, N, s, s)


def _bilin4(w: torch.Tensor, fy: torch.Tensor, fx: torch.Tensor) -> torch.Tensor:
    """Per-point 4-tap bilinear combine of an (..., M+1, M+1) integer-grid
    window at fractional offset (fy, fx) (...) -> (..., M, M)."""
    fy = fy[..., None, None]
    fx = fx[..., None, None]
    return ((1 - fy) * (1 - fx) * w[..., :-1, :-1]
            + (1 - fy) * fx * w[..., :-1, 1:]
            + fy * (1 - fx) * w[..., 1:, :-1]
            + fy * fx * w[..., 1:, 1:])


def _axis_weights(coords: torch.Tensor, n: int) -> torch.Tensor:
    """Bilinear selection matrix S[..., i] = weight of source index i for
    each continuous coordinate (clamped corners). (...) -> (..., n)."""
    c = coords.clamp(0.0, n - 1.0)
    c0 = torch.floor(c)
    w = c - c0
    ii = torch.arange(n, dtype=torch.float32, device=coords.device)
    return ((1.0 - w)[..., None] * (ii == c0[..., None])
            + w[..., None] * (ii == c0[..., None] + 1.0))


def track_lk_windowed_batched(
    imgs1: torch.Tensor, imgs2: torch.Tensor, pts: torch.Tensor,
    win: int = 15, n_levels: int = 3, n_iters: int = 10, search: int = 32,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """LK with window caching and correlation surfaces, batched: per pyramid
    level the template and the search window are read once per point; the
    Gauss-Newton loop then samples two per-point cross-correlation surfaces
    (window x template gradient, one grouped conv per level).
    imgs (B, H, W[, C]), pts (B, N, 2) -> (pts2 (B, N, 2), status (B, N))."""
    g1 = _to_gray_batched(imgs1)
    g2 = _to_gray_batched(imgs2)
    pyr1, pyr2 = [g1], [g2]
    for _ in range(n_levels - 1):
        pyr1.append(avg_downsample(pyr1[-1][..., None], 2)[..., 0])
        pyr2.append(avg_downsample(pyr2[-1][..., None], 2)[..., 0])

    B, N = pts.shape[:2]
    half = (win - 1) / 2.0
    kw = win - 2
    P = search - kw + 1
    lim = float(search - win - 1)
    d = torch.zeros_like(pts)
    for lvl in range(n_levels - 1, -1, -1):
        scale = 2.0 ** lvl
        p_lvl = pts / scale
        i1, i2 = pyr1[lvl], pyr2[lvl]

        ty0 = p_lvl[..., 1] - half
        tx0 = p_lvl[..., 0] - half
        tby = torch.floor(ty0)
        tbx = torch.floor(tx0)
        wt = _gather_window(i1, tby, tbx, win + 1)
        t = _bilin4(wt, ty0 - tby, tx0 - tbx)                  # (B, N, win, win)
        tx = ((t[..., :, 2:] - t[..., :, :-2]) / 2)[..., 1:-1, :]
        ty = ((t[..., 2:, :] - t[..., :-2, :]) / 2)[..., :, 1:-1]
        a11 = (tx * tx).sum((-2, -1))
        a12 = (tx * ty).sum((-2, -1))
        a22 = (ty * ty).sum((-2, -1))
        det = a11 * a22 - a12 * a12

        c0 = p_lvl + d / scale
        bx = torch.floor(c0[..., 0]).long() - search // 2
        by = torch.floor(c0[..., 1]).long() - search // 2
        wnd = _gather_window(i2, by, bx, search)              # (B, N, S, S)

        # per-point cross-correlation surfaces: N*B groups of one channel
        def corr_with(k):
            out = F.conv2d(wnd.reshape(1, B * N, search, search),
                           k.reshape(B * N, 1, kw, kw), groups=B * N)
            return out.reshape(B, N, P, P)
        corr_x = corr_with(tx)
        corr_y = corr_with(ty)
        t_in = t[..., 1:-1, 1:-1]
        tdx = (t_in * tx).sum((-2, -1))
        tdy = (t_in * ty).sum((-2, -1))
        byf, bxf = by.float(), bx.float()
        det_c = det.clamp(min=1e-8)

        for _ in range(n_iters):
            ly = (p_lvl[..., 1] + d[..., 1] / scale - half - byf).clamp(0.0, lim)
            lx = (p_lvl[..., 0] + d[..., 0] / scale - half - bxf).clamp(0.0, lim)
            oy = _axis_weights(ly + 1.0, P)                    # (B, N, P)
            ox = _axis_weights(lx + 1.0, P)
            cyx = torch.einsum("bnpq,bnq->bnp", corr_x, ox)
            b1 = torch.einsum("bnp,bnp->bn", cyx, oy) - tdx
            cyy = torch.einsum("bnpq,bnq->bnp", corr_y, ox)
            b2 = torch.einsum("bnp,bnp->bn", cyy, oy) - tdy
            ddx = -(a22 * b1 - a12 * b2) / det_c
            ddy = -(-a12 * b1 + a11 * b2) / det_c
            d = d + torch.stack([ddx, ddy], -1) * scale

    pts2 = pts + d
    H, W = g1.shape[-2:]
    m = win // 2 + 1
    status = ((pts2[..., 0] >= m) & (pts2[..., 0] <= W - 1 - m)
              & (pts2[..., 1] >= m) & (pts2[..., 1] <= H - 1 - m)
              & torch.isfinite(pts2).all(-1))
    return pts2, status


def track_lk_windowed(img1, img2, pts, win: int = 15, n_levels: int = 3,
                      n_iters: int = 10, search: int = 32):
    """Per-pair form: img (H, W[, C]), pts (N, 2)."""
    pts2, status = track_lk_windowed_batched(
        img1[None], img2[None], pts[None], win, n_levels, n_iters, search)
    return pts2[0], status[0]


# ---------------------------------------------------------------------------
# Full-image pyramidal Lucas-Kanade (the offline loaders' tracker)
# ---------------------------------------------------------------------------

def _axis_taps(c: torch.Tensor, n: int):
    """Clamped-corner bilinear taps along one axis: (i0, i1, w) with i0 =
    floor(c) of c clamped into [0, n - 1], i1 = i0 + 1 (clamped; its weight
    w is 0 there)."""
    c = c.clamp(0.0, n - 1.0)
    c0 = torch.floor(c)
    i0 = c0.long()
    return i0, (i0 + 1).clamp(max=n - 1), c - c0


def _sample_patches(img: torch.Tensor, pts: torch.Tensor, win: int) -> torch.Tensor:
    """Bilinear (win, win) patches of img (B, H, W) centered (ceil) on pts
    (B, N, 2) as (x, y), clamped corners. Returns (B, N, win, win)."""
    B, H, W = img.shape
    off = torch.arange(win, dtype=torch.float32, device=img.device) - (win - 1) / 2.0
    y0, y1, wy = _axis_taps(pts[..., 1, None] + off, H)       # (B, N, win)
    x0, x1, wx = _axis_taps(pts[..., 0, None] + off, W)
    flat = img.float().reshape(B, H * W)

    def at(yi, xi):
        lin = yi[..., :, None] * W + xi[..., None, :]          # (B, N, win, win)
        return torch.gather(flat, 1, lin.reshape(B, -1)).reshape(lin.shape)
    wy = wy[..., :, None]
    wx = wx[..., None, :]
    c0 = (1 - wy) * at(y0, x0) + wy * at(y1, x0)                # rows first
    c1 = (1 - wy) * at(y0, x1) + wy * at(y1, x1)
    return (1 - wx) * c0 + wx * c1


def track_lk_batched(
    imgs1: torch.Tensor, imgs2: torch.Tensor, pts: torch.Tensor,
    win: int = 15, n_levels: int = 3, n_iters: int = 10,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Pyramidal LK over the whole image (OpenCV TrackPyrLK semantics):
    each Gauss-Newton iteration resamples the moving patch from the full
    level, so the motion it follows is unbounded. imgs (B, H, W[, C]), pts
    (B, N, 2) -> (pts2 (B, N, 2), status (B, N))."""
    g1 = _to_gray_batched(imgs1)
    g2 = _to_gray_batched(imgs2)
    pyr1, pyr2 = [g1], [g2]
    for _ in range(n_levels - 1):
        pyr1.append(avg_downsample(pyr1[-1][..., None], 2)[..., 0])
        pyr2.append(avg_downsample(pyr2[-1][..., None], 2)[..., 0])

    d = torch.zeros_like(pts)
    for lvl in range(n_levels - 1, -1, -1):
        scale = 2.0 ** lvl
        p_lvl = pts / scale
        t = _sample_patches(pyr1[lvl], p_lvl, win)            # template
        tx = ((t[..., :, 2:] - t[..., :, :-2]) / 2)[..., 1:-1, :]
        ty = ((t[..., 2:, :] - t[..., :-2, :]) / 2)[..., :, 1:-1]
        a11 = (tx * tx).sum((-2, -1))
        a12 = (tx * ty).sum((-2, -1))
        a22 = (ty * ty).sum((-2, -1))
        det_c = (a11 * a22 - a12 * a12).clamp(min=1e-8)
        for _ in range(n_iters):
            w = _sample_patches(pyr2[lvl], p_lvl + d / scale, win)
            err = (w - t)[..., 1:-1, 1:-1]
            b1 = (err * tx).sum((-2, -1))
            b2 = (err * ty).sum((-2, -1))
            ddx = -(a22 * b1 - a12 * b2) / det_c
            ddy = -(-a12 * b1 + a11 * b2) / det_c
            d = d + torch.stack([ddx, ddy], -1) * scale

    pts2 = pts + d
    H, W = g1.shape[-2:]
    m = win // 2 + 1
    status = ((pts2[..., 0] >= m) & (pts2[..., 0] <= W - 1 - m)
              & (pts2[..., 1] >= m) & (pts2[..., 1] <= H - 1 - m)
              & torch.isfinite(pts2).all(-1))
    return pts2, status


def track_lk(img1, img2, pts, win: int = 15, n_levels: int = 3,
             n_iters: int = 10):
    """Per-pair form: img (H, W[, C]), pts (N, 2)."""
    pts2, status = track_lk_batched(img1[None], img2[None], pts[None], win,
                                    n_levels, n_iters)
    return pts2[0], status[0]


# ---------------------------------------------------------------------------
# Essential-matrix RANSAC
# ---------------------------------------------------------------------------

def gumbel_noise(n_samples: int, n: int, device,
                 generator: Optional[torch.Generator] = None) -> torch.Tensor:
    """(n_samples, 8, n) standard Gumbel noise for RANSAC's sample draws,
    from ``generator`` (default: a fresh generator seeded 1 on ``device``)."""
    if generator is None:
        generator = torch.Generator(device=device).manual_seed(1)
    u = torch.rand((n_samples, 8, n), generator=generator, device=device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2 ** -24)))


def _eight_point(p1n: torch.Tensor, p2n: torch.Tensor) -> torch.Tensor:
    """Normalized 8-point: p1n, p2n (..., 8, 2) -> E (..., 3, 3), the
    nullspace of A as the last column of a complete QR of A^T. (Its sign
    depends on the LAPACK build; Sampson scores and the SVD-based
    decomposition do not.) On the card the QR is replayed from a CUDA
    graph, bit for bit eager's (``qr_graph.sliced_q`` through the shared
    ``utils/cuda_graph`` cache)."""
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    Q = qr_graph.GRAPHS.replay(qr_graph.sliced_q, (A,),
                               eager_fn=qr_graph.eager_q)
    return Q[..., :, 8].reshape(Q.shape[:-2] + (3, 3))


def _decompose_E(E: torch.Tensor):
    """E (..., 3, 3) -> 4 candidate (R (..., 4, 3, 3), t (..., 4, 3))."""
    u, _, vt = torch.linalg.svd(E)
    d = torch.sign(torch.linalg.det(u @ vt))[..., None, None]
    # W = [[0, -1, 0], [1, 0, 0], [0, 0, 1]], made on the device: a tensor
    # copied from the host (or written element by element) waits for the
    # card's queue
    i = torch.arange(9, device=E.device)
    W = ((i == 3).to(E.dtype) - (i == 1).to(E.dtype)
         + (i == 8).to(E.dtype)).reshape(3, 3)
    R1 = u @ W @ vt * d
    R2 = u @ W.T @ vt * d
    t = u[..., :, 2]
    return (torch.stack([R1, R1, R2, R2], dim=-3),
            torch.stack([t, -t, t, -t], dim=-2))


def _homog(p: torch.Tensor) -> torch.Tensor:
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _sampson(E: torch.Tensor, p1n: torch.Tensor, p2n: torch.Tensor) -> torch.Tensor:
    """Sampson distances. E (B, S, 3, 3), p (B, N, 2) -> (B, S, N)."""
    x1 = _homog(p1n)[:, None]                               # (B, 1, N, 3)
    x2 = _homog(p2n)[:, None]
    Ex1 = x1 @ E.transpose(-1, -2)                          # (B, S, N, 3)
    Etx2 = x2 @ E
    num = (x2 * Ex1).sum(-1) ** 2
    den = Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2 + Etx2[..., 1] ** 2
    return num / den.clamp(min=1e-12)


def _cheirality_count(R: torch.Tensor, t: torch.Tensor, p1n: torch.Tensor,
                      p2n: torch.Tensor) -> torch.Tensor:
    """Points with positive depth in both views, counted over ALL N points.
    R (B, C, 3, 3), t (B, C, 3), p (B, N, 2) -> (B, C)."""
    x1 = _homog(p1n)[:, None]                               # (B, 1, N, 3)
    q2 = p2n[:, None]                                       # (B, 1, N, 2)
    Rx1 = x1 @ R.transpose(-1, -2)                          # (B, C, N, 3)
    a = Rx1[..., :2] - Rx1[..., 2:3] * q2
    b = t[..., None, 2:3] * q2 - t[..., None, :2]
    z1 = (a * b).sum(-1) / (a * a).sum(-1).clamp(min=1e-12)
    z2 = z1 * Rx1[..., 2] + t[..., None, 2]
    return ((z1 > 0) & (z2 > 0)).sum(-1)


def _normalize(pts: torch.Tensor, K) -> torch.Tensor:
    K = torch.as_tensor(K, dtype=torch.float32, device=pts.device)
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])
    return (pts - c) / f


def ransac_hypotheses(pts1: torch.Tensor, pts2: torch.Tensor,
                      valid: torch.Tensor, K, noise: torch.Tensor,
                      max_dist: float = 1e-3):
    """RANSAC's samples and their fits. pts (B, N, 2) pixel coords, valid
    (B, N), noise (n_samples, 8, N) shared by every item: each of a
    sample's 8 indices is its own Gumbel-max draw over the valid points
    (with replacement, as in the reference). Returns (idx (B, S, 8), E
    (B, S, 3, 3), Sampson inlier counts (B, S))."""
    p1n, p2n = _normalize(pts1, K), _normalize(pts2, K)
    B = pts1.shape[0]
    S = noise.shape[0]
    scores = noise[None] + torch.where(valid, 0.0, -1e9)[:, None, None, :]
    idx = scores.argmax(-1)                                 # (B, S, 8)
    flat = idx.reshape(B, S * 8, 1).expand(B, S * 8, 2)
    take = lambda p: torch.gather(p, 1, flat).reshape(B, S, 8, 2)
    s1, s2 = take(p1n), take(p2n)
    with profiled_span("ego.qr"):
        Es = _eight_point(s1, s2)                           # (B, S, 3, 3)
    with profiled_span("ego.score"):
        d = _sampson(Es, p1n, p2n)                          # (B, S, N)
        inls = ((d < max_dist) & valid[:, None]).sum(-1)    # (B, S)
    return idx, Es, inls


def get_ego_motion_from_matches_batched(
    pts1: torch.Tensor, pts2: torch.Tensor, valid: torch.Tensor, K,
    noise: torch.Tensor, max_dist: float = 1e-3,
) -> EgoMotion:
    """RANSAC essential-matrix fit over B matched point sets (pixel coords):
    the first sample with the most inliers (``ransac_hypotheses``) wins.
    Returns EgoMotion with R (B, 3, 3), unit T (B, 3), Sampson inlier and
    found counts (B,)."""
    p1n, p2n = _normalize(pts1, K), _normalize(pts2, K)
    _, Es, inls = ransac_hypotheses(pts1, pts2, valid, K, noise, max_dist)
    with profiled_span("ego.score"):
        best = inls.argmax(-1)
        bi = torch.arange(pts1.shape[0], device=pts1.device)
        E = Es[bi, best]
    with profiled_span("ego.pose"):
        Rs, ts = _decompose_E(E)
        counts = _cheirality_count(Rs, ts, p1n, p2n)        # (B, 4)
        pick = counts.argmax(-1)
        return EgoMotion(Rs[bi, pick], ts[bi, pick], inls[bi, best],
                         valid.sum(-1))


def get_ego_motion_from_matches(pts1, pts2, valid, K, noise,
                                max_dist: float = 1e-3) -> EgoMotion:
    """Per-pair form: pts (N, 2), valid (N,)."""
    em = get_ego_motion_from_matches_batched(
        pts1[None], pts2[None], valid[None], K, noise, max_dist)
    return EgoMotion(*(a[0] for a in em))


def get_ego_motion_batched(imgs1, imgs2, K, max_points: int = 400,
                           quality: float = 0.001, noise=None,
                           lk_iters: int = 10, n_samples: int = 64,
                           selector: str = "topk",
                           lk_search: int = 32,
                           tracker: str = "windowed") -> EgoMotion:
    """Ego-motion over B frame pairs: corners in imgs1, LK into imgs2,
    essential RANSAC. imgs (B, H, W[, 3]). ``noise`` (n_samples, 8,
    n_corners) is the RANSAC draw noise (default: gumbel_noise seeded 1);
    n_corners is max_points, or the cell count of the 'grid' selector.
    ``tracker``: 'windowed' (the online program's bounded-motion tracker)
    or 'full' (``track_lk_batched``, the offline loaders')."""
    with profiled_span("ego.corners"):
        pts, pvalid = good_features_to_track_batched(
            imgs1, max_points, quality, selector=selector)
    n = pts.shape[1]
    if noise is None:
        noise = gumbel_noise(n_samples, n, imgs1.device)
    if tuple(noise.shape) != (n_samples, 8, n):
        raise ValueError(f"noise shape {tuple(noise.shape)} != "
                         f"{(n_samples, 8, n)}")
    noise = noise.to(device=imgs1.device, dtype=torch.float32)
    with profiled_span("ego.lk"):
        if tracker == "windowed":
            pts2, status = track_lk_windowed_batched(imgs1, imgs2, pts,
                                                     n_iters=lk_iters,
                                                     search=lk_search)
        elif tracker == "full":
            pts2, status = track_lk_batched(imgs1, imgs2, pts,
                                            n_iters=lk_iters)
        else:
            raise ValueError(f"unknown tracker {tracker!r}")
    return get_ego_motion_from_matches_batched(pts, pts2, pvalid & status, K,
                                               noise)


def get_ego_motion(img1, img2, K, max_points: int = 400,
                   quality: float = 0.001, noise=None,
                   tracker: str = "windowed") -> EgoMotion:
    """Per-pair form of get_ego_motion_batched at the reference's defaults
    (10 LK iterations, 64 RANSAC samples). ``tracker``: 'windowed' (online
    regime) or 'full' (offline loaders)."""
    em = get_ego_motion_batched(img1[None], img2[None], K, max_points, quality,
                                noise, tracker=tracker)
    return EgoMotion(*(a[0] for a in em))


# ---------------------------------------------------------------------------
# 4-DoF (pan, tilt, zoom, roll) model: the 'mc' motion correction
# ---------------------------------------------------------------------------

def _lsq_features(pts_in, pts_out, w_center, h_center):
    """Flow f = pts_out - pts_in and the model's per-point basis, fit as
    x1 p + x2 t + x3 z + x4 r with p = (-1, 0), t = (0, -1), z = -pt,
    r = (pt_y, -pt_x), pt centered. pts (..., N, 2)."""
    c = torch.tensor([w_center, h_center], dtype=torch.float32,
                     device=pts_in.device)
    pt = pts_in - c
    f = (pts_out - c) - pt
    p = torch.tensor([-1.0, 0.0], device=pt.device).expand(pt.shape)
    t = torch.tensor([0.0, -1.0], device=pt.device).expand(pt.shape)
    r = torch.stack([pt[..., 1], -pt[..., 0]], -1)
    return f, (p, t, -pt, r)


def _lsq_solve(pts_in, pts_out, w_center, h_center, weights=None):
    """Weighted least-squares model (..., 4) of point sets (..., N, 2)."""
    f, basis = _lsq_features(pts_in, pts_out, w_center, h_center)
    Bm = torch.stack(basis, dim=-2)                     # (..., N, 4, 2)
    if weights is None:
        weights = torch.ones(f.shape[:-1], device=f.device)
    Bw = Bm * weights[..., None, None]
    A = torch.einsum("...nac,...nbc->...ab", Bw, Bm)
    b = torch.einsum("...nac,...nc->...a", Bw, f)
    eye = 1e-9 * torch.eye(4, device=A.device)
    return torch.linalg.solve(A + eye, b)


def _affine_from_model(x, w_center, h_center) -> torch.Tensor:
    """The (2, 3) warp that undoes model x (4,): a rotation by -atan(x4)
    about the center, then the pan/tilt shift."""
    dtheta = -torch.atan(x[3])
    c, s = torch.cos(dtheta), torch.sin(dtheta)
    return torch.stack([
        torch.stack([c, s, (1 - c) * w_center - s * h_center + x[0]]),
        torch.stack([-s, c, s * w_center - (1 - c) * h_center + x[1]]),
    ])


def lsq_trans(pts_in, pts_out, w_center, h_center, weights=None):
    """Weighted least squares of the 4-DoF model on pts (N, 2). Returns
    (H (2, 3), x (4,))."""
    x = _lsq_solve(pts_in, pts_out, w_center, h_center, weights)
    return _affine_from_model(x, w_center, h_center), x


def _model_residuals(x, pts_in, pts_out, w_center, h_center):
    """|model flow - observed flow| per point: x (..., 4), pts (N, 2) ->
    (..., N)."""
    f, (p, t, z, r) = _lsq_features(pts_in, pts_out, w_center, h_center)
    xs = x[..., None, None, :]
    fout = xs[..., 0] * p + xs[..., 1] * t + xs[..., 2] * z + xs[..., 3] * r
    e = fout - f
    return torch.sqrt((e * e).sum(-1))


def lsq_trans_ransac(pts_in, pts_out, w_center, h_center,
                     n_samples: int = 64, sample_idx=None):
    """RANSAC over minimal 5-point samples, all fitted and scored at once.
    Inlier rule: residual <= sqrt(5.99) * std(residuals). ``sample_idx``
    (n_samples, 5) indices into the N points (default: drawn with a CPU
    ``torch.Generator`` seeded 0). Returns (H (2, 3), inlier count)."""
    n = pts_in.shape[0]
    if sample_idx is None:
        gen = torch.Generator().manual_seed(0)
        sample_idx = torch.randint(0, n, (n_samples, 5), generator=gen)
    idx = torch.as_tensor(np.array(sample_idx), dtype=torch.long,
                          device=pts_in.device)
    xs = _lsq_solve(pts_in[idx], pts_out[idx], w_center, h_center)
    d = _model_residuals(xs, pts_in, pts_out, w_center, h_center)   # (S, N)
    thr = torch.sqrt(torch.tensor(5.99, device=d.device)) * d.std(
        -1, correction=0)
    inliers = (d <= thr[:, None]).sum(-1)
    best = torch.argmax(inliers)
    return _affine_from_model(xs[best], w_center, h_center), inliers[best]


def warp_affine(img: torch.Tensor, H) -> torch.Tensor:
    """Nearest-neighbour affine warp: out(i, j) = img(round(H [j i 1])),
    zero where that lands outside. img (H, W[, C])."""
    Hm = torch.as_tensor(H, dtype=torch.float32, device=img.device)
    Ht, Wd = img.shape[0], img.shape[1]
    xx = torch.arange(Wd, dtype=torch.float32, device=img.device)[None, :]
    yy = torch.arange(Ht, dtype=torch.float32, device=img.device)[:, None]
    xs = torch.round(Hm[0, 0] * xx + Hm[0, 1] * yy + Hm[0, 2]).long()
    ys = torch.round(Hm[1, 0] * xx + Hm[1, 1] * yy + Hm[1, 2]).long()
    ok = (xs >= 0) & (xs < Wd) & (ys >= 0) & (ys < Ht)
    out = img[ys.clamp(0, Ht - 1), xs.clamp(0, Wd - 1)]
    return out * ok[..., None] if img.ndim == 3 else out * ok


# ---------------------------------------------------------------------------
# Epipolar helpers
# ---------------------------------------------------------------------------

def fundamental_from_essential(E, K) -> torch.Tensor:
    """F = K^-T E K^-1."""
    E = torch.as_tensor(E, dtype=torch.float32)
    Ki = torch.linalg.inv(torch.as_tensor(K, dtype=torch.float32,
                                          device=E.device))
    return Ki.T @ E @ Ki


def essential_from_rt(R, T) -> torch.Tensor:
    """E = [T]_x R."""
    R = torch.as_tensor(R, dtype=torch.float32)
    T = torch.as_tensor(T, dtype=torch.float32, device=R.device)
    z = torch.zeros((), device=R.device)
    tx = torch.stack([torch.stack([z, -T[2], T[1]]),
                      torch.stack([T[2], z, -T[0]]),
                      torch.stack([-T[1], T[0], z])])
    return tx @ R


def epipole(K, T) -> torch.Tensor:
    """e2 = K T / T_3 as (x, y)."""
    T = torch.as_tensor(T, dtype=torch.float32)
    e = torch.as_tensor(K, dtype=torch.float32, device=T.device) @ T
    return e[:2] / e[2]
