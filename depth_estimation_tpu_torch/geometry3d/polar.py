"""Polar (radial) geometry (port of ``depth_estimation_tpu.geometry3d.polar``):
epipole-centered cartesian <-> polar warps and flow -> depth for forward
camera motion. In polar space centered on the epipole, forward-motion flow
is (nearly) 1-D along rows (radius), which the radial matcher exploits.

Conventions: grids are (2, hdst, wdst) float32 with channel 0 = source y,
channel 1 = source x (0-based pixel coordinates); warping samples
bilinearly and fills out-of-range with 0. The grid builders take a
``device`` (the card by default; ``device="cpu"`` to run on the CPU); the
other functions run where their tensors are. ``get_c2p_grid``,
``get_p2c_grid``, ``get_rmax`` and ``flow2depth`` take Python floats (the
per-pair forms); their ``_batched`` forms take a centre, rmax and infinity
per item as tensors and read nothing back to the host (the batched polar
loader and the batched radial estimator, ``api_radial``), as does
``smooth_epipole_batched``, ``data/datasets.smooth_epipole`` of each item.
"""

from __future__ import annotations

import math
from typing import Optional, Tuple

import torch

from ..utils.device import resolve, true_div


# ---------------------------------------------------------------------------
# grid builders
# ---------------------------------------------------------------------------

def get_c2p_grid(wsrc: int, hsrc: int, wdst: int, hdst: int,
                 xcenter: Optional[float] = None, ycenter: Optional[float] = None,
                 lpadding: int = 0, rpadding: int = 0,
                 rmax: Optional[float] = None, alpha: float = 1.0,
                 device="cuda") -> torch.Tensor:
    """Cartesian -> polar sampling grid: polar pixel (i, j) reads cartesian
    (y, x) = center + r (sin th, cos th), r = kr i^alpha, th = 2 pi j / wdst;
    the angular axis wraps, expressed by copying wrapped columns into the
    l/r padding."""
    dev = resolve(device)
    if rmax is None:
        rmax = min(hsrc // 2, wsrc // 2) - 1
    xcenter = wsrc / 2 if xcenter is None else xcenter
    ycenter = hsrc / 2 if ycenter is None else ycenter
    kr = rmax / (hdst ** alpha)
    ktheta = 2 * math.pi / wdst

    i = torch.arange(hdst, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(wdst, dtype=torch.float32, device=dev)[None, :]
    r = kr * i ** alpha
    theta = ktheta * j
    gy = r * torch.sin(theta) + ycenter
    gx = r * torch.cos(theta) + xcenter
    grid = torch.stack([gy, gx])
    if lpadding > 0 or rpadding > 0:
        parts = []
        if lpadding > 0:
            parts.append(grid[:, :, wdst - lpadding:])
        parts.append(grid)
        if rpadding > 0:
            parts.append(grid[:, :, :rpadding])
        grid = torch.cat(parts, dim=2)
    return grid


def get_c2p_grid_batched(wsrc: int, hsrc: int, wdst: int, hdst: int,
                         xcenter: torch.Tensor, ycenter: torch.Tensor,
                         rmax: torch.Tensor, lpadding: int = 0,
                         rpadding: int = 0, alpha: float = 1.0) -> torch.Tensor:
    """``get_c2p_grid`` with a centre and rmax per item: (B,) float32
    tensors on the grids' device. Returns (B, 2, hdst, wdst + lpadding +
    rpadding) in float32, the arithmetic of the reference's traced grid
    (kr = rmax / hdst^alpha a true division in float32)."""
    dev = rmax.device
    kr = (rmax / torch.full_like(rmax, hdst ** alpha))[:, None, None]
    ktheta = 2 * math.pi / wdst
    i = torch.arange(hdst, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(wdst, dtype=torch.float32, device=dev)[None, :]
    r = kr * i ** alpha
    theta = ktheta * j
    gy = r * torch.sin(theta) + ycenter[:, None, None]
    gx = r * torch.cos(theta) + xcenter[:, None, None]
    grid = torch.stack([gy, gx], dim=1)
    return torch.cat([grid[..., wdst - lpadding:], grid,
                      grid[..., :rpadding]], dim=-1)


def get_p2c_grid(wsrc: int, hsrc: int, wdst: int, hdst: int,
                 xcenter: Optional[float] = None, ycenter: Optional[float] = None,
                 rmax: Optional[float] = None, alpha: float = 1.0,
                 device="cuda") -> torch.Tensor:
    """Polar -> cartesian inverse grid: cartesian pixel (i, j) reads polar
    (row, col) = ((x^2 + y^2)^(1/(2 alpha)) ky, atan2(y, x) mod 2pi kx)."""
    dev = resolve(device)
    if rmax is None:
        rmax = min(hdst // 2, wdst // 2) - 1
    xcenter = wdst / 2 if xcenter is None else xcenter
    ycenter = hdst / 2 if ycenter is None else ycenter
    pi2 = 2 * math.pi
    kx = wsrc / pi2
    ky = hsrc / (rmax ** (1.0 / alpha))

    i = torch.arange(hdst, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(wdst, dtype=torch.float32, device=dev)[None, :]
    x = j - xcenter
    y = i - ycenter
    gy = (x * x + y * y) ** (0.5 / alpha) * ky
    gx = torch.remainder(torch.atan2(y, x) + pi2, pi2) * kx
    return torch.stack([gy, gx])


def get_p2c_grid_batched(wsrc: int, hsrc: int, wdst: int, hdst: int,
                         xcenter: torch.Tensor, ycenter: torch.Tensor,
                         rmax: torch.Tensor, alpha: float = 1.0
                         ) -> torch.Tensor:
    """``get_p2c_grid`` with a centre and rmax per item: xcenter, ycenter
    (B,) float32, rmax (B,) (float64 for the per-pair form's Python
    floats: ky = hsrc / rmax^(1/alpha) is divided in rmax's dtype, then
    rounded to float32 as the per-pair form's scalar is). Returns (B, 2,
    hdst, wdst)."""
    dev = xcenter.device
    pi2 = 2 * math.pi
    kx = wsrc / pi2
    ky = (torch.full_like(rmax, float(hsrc)) / rmax ** (1.0 / alpha)
          ).float()[:, None, None]
    i = torch.arange(hdst, dtype=torch.float32, device=dev)[:, None]
    j = torch.arange(wdst, dtype=torch.float32, device=dev)[None, :]
    x = j - xcenter[:, None, None]
    y = i - ycenter[:, None, None]
    gy = (x * x + y * y) ** (0.5 / alpha) * ky
    gx = torch.remainder(torch.atan2(y, x) + pi2, pi2) * kx
    return torch.stack([gy, gx], dim=1)


def warp_grid(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """Bilinear warp: out[i, j] = img(grid[0, i, j], grid[1, i, j]), zero
    for out-of-range taps. img (H, W, C)."""
    return warp_grid_batched(img[None], grid[None])[0]


def warp_grid_batched(imgs: torch.Tensor, grids: torch.Tensor) -> torch.Tensor:
    """``warp_grid`` of each item: imgs (B, H, W, C), grids (B, 2, h, w)
    -> (B, h, w, C)."""
    H, W = imgs.shape[1], imgs.shape[2]
    gy, gx = grids[:, 0], grids[:, 1]
    y0f = torch.floor(gy)
    x0f = torch.floor(gx)
    y0 = y0f.to(torch.int64)
    x0 = x0f.to(torch.int64)
    dy = (gy - y0f)[..., None]
    dx = (gx - x0f)[..., None]
    b = torch.arange(imgs.shape[0], device=imgs.device)[:, None, None]

    def at(yy, xx):
        v = imgs[b, yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
        ok = (yy >= 0) & (yy <= H - 1) & (xx >= 0) & (xx <= W - 1)
        return v * ok[..., None]

    return ((1 - dy) * (1 - dx) * at(y0, x0)
            + (1 - dy) * dx * at(y0, x0 + 1)
            + dy * (1 - dx) * at(y0 + 1, x0)
            + dy * dx * at(y0 + 1, x0 + 1))


def cartesian2polar(img: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    return warp_grid(img, grid)


# ---------------------------------------------------------------------------
# rmax / network output bookkeeping
# ---------------------------------------------------------------------------

def get_rmax(h: int, w: int, e2) -> float:
    """Distance from the epipole e2 = (x, y) to the farthest image corner."""
    ex, ey = float(e2[0]), float(e2[1])
    return math.floor(math.sqrt(max(
        max(ex * ex + ey * ey, (w - ex) ** 2 + ey * ey),
        max(ex * ex + (h - ey) ** 2, (w - ex) ** 2 + (h - ey) ** 2),
    )))


def get_rmax_batched(h: int, w: int, e2: torch.Tensor) -> torch.Tensor:
    """``get_rmax`` for (B, 2) epipoles (x, y) -> (B,), in e2's dtype:
    float32 for the polar loader's grid, float64 for the per-pair form's
    Python floats (then equal to it)."""
    ex, ey = e2[:, 0], e2[:, 1]
    d = torch.maximum(
        torch.maximum(ex * ex + ey * ey, (w - ex) ** 2 + ey * ey),
        torch.maximum(ex * ex + (h - ey) ** 2, (w - ex) ** 2 + (h - ey) ** 2))
    return torch.floor(torch.sqrt(d))


def get_k_output(h_input: int, h_kernel: int, h_win: int) -> float:
    """Output shrink factor of the radial net."""
    h_polar = h_input - (h_kernel - 1) // 2 - h_win + 1
    return h_polar / h_input


# ---------------------------------------------------------------------------
# flow -> depth
# ---------------------------------------------------------------------------

def flow2depth(h_img: int, w_img: int, flow: torch.Tensor, center,
               kinfty: float = 1.0) -> Tuple[torch.Tensor, torch.Tensor]:
    """Radial flow (H, W) to normalized depth: depth = d / flow where d is
    the distance from the epipole; flow < 0.1 -> infinity; d <= 10 px -> no
    confidence. Returns (depth / infty, confidences in flow's dtype; an
    integer flow, as the network's WTA decode gives, is a float flow for
    the depth)."""
    infty = get_rmax(h_img, w_img, center) * kinfty
    H, W = flow.shape
    ff = flow if flow.is_floating_point() else flow.float()
    j = torch.arange(W, dtype=torch.float32, device=flow.device)[None, :]
    i = torch.arange(H, dtype=torch.float32, device=flow.device)[:, None]
    d = torch.sqrt((j - center[0]) ** 2 + (i - center[1]) ** 2)
    depth = torch.where(ff < 0.1, torch.full_like(ff, infty),
                        d / torch.clamp(ff, min=0.1))
    depth = torch.where(d > 10.0, depth, torch.zeros_like(depth))
    confs = (d > 10.0).to(flow.dtype)
    return true_div(depth, infty), confs


def flow2depth_batched(flow: torch.Tensor, center: torch.Tensor,
                       infty: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """``flow2depth`` of each item: flow (B, H, W), center (B, 2) float32
    (x, y), infty (B,) float32, the rmax of each centre times kinfty
    (``get_rmax_batched`` in float64, as the per-pair form's Python
    floats). Returns (depth / infty, confidences), (B, H, W) each."""
    H, W = flow.shape[1], flow.shape[2]
    ff = flow if flow.is_floating_point() else flow.float()
    j = torch.arange(W, dtype=torch.float32, device=flow.device)[None, None, :]
    i = torch.arange(H, dtype=torch.float32, device=flow.device)[None, :, None]
    inf = infty[:, None, None]
    d = torch.sqrt((j - center[:, 0, None, None]) ** 2
                   + (i - center[:, 1, None, None]) ** 2)
    depth = torch.where(ff < 0.1, inf.expand_as(ff),
                        d / torch.clamp(ff, min=0.1))
    depth = torch.where(d > 10.0, depth, torch.zeros_like(depth))
    confs = (d > 10.0).to(flow.dtype)
    return depth / inf, confs


def smooth_epipole_batched(prev_e2: Optional[torch.Tensor],
                           e2: torch.Tensor, h_img: int, w_img: int,
                           alpha: float = 0.5
                           ) -> Tuple[torch.Tensor, torch.Tensor]:
    """``data/datasets.smooth_epipole`` of each item, on the card: the EMA
    alpha e2 + (1 - alpha) prev of (B, 2) epipoles (x, y); an epipole
    outside the (h_img, w_img) frame keeps the previous one; no previous
    (None) takes e2. Returns (smoothed (B, 2), kept (B,) bool: the items
    that kept the previous epipole)."""
    if prev_e2 is None:
        return e2, torch.zeros(e2.shape[:1], dtype=torch.bool,
                               device=e2.device)
    inside = ((e2[:, 0] >= 0) & (e2[:, 0] < w_img)
              & (e2[:, 1] >= 0) & (e2[:, 1] < h_img))
    ema = alpha * e2 + (1 - alpha) * prev_e2
    return torch.where(inside[:, None], ema, prev_e2), ~inside


def radial_depth_cartesian(flow: torch.Tensor, center,
                           infty: float) -> Tuple[torch.Tensor, torch.Tensor]:
    """Cartesian radial depth. flow (2, H, W) (dy, dx). Per pixel p
    (relative to center): |flow| >= 0.2 -> depth = min(|p| / |flow|,
    infty), confident iff p_x dx + dy dy > 0.125 (the y term multiplies dy
    by itself, as the reference's C does); |flow| < 0.2 -> (infty,
    confident). Returns (depth, conf)."""
    H, W = flow.shape[1], flow.shape[2]
    j = torch.arange(W, dtype=torch.float32, device=flow.device)[None, :]
    i = torch.arange(H, dtype=torch.float32, device=flow.device)[:, None]
    px = j - center[0]
    py = i - center[1]
    pn = torch.sqrt(px * px + py * py)
    dy, dx = flow[0], flow[1]
    dn = torch.sqrt(dx * dx + dy * dy)
    moving = dn >= 0.2
    depth = torch.where(moving,
                        torch.clamp(pn / torch.clamp(dn, min=0.2), max=infty),
                        torch.full_like(dn, infty))
    conf = torch.where(moving, (px * dx + dy * dy > 0.125).to(flow.dtype),
                       torch.ones_like(dn))
    return depth, conf


def saturate(t: torch.Tensor, lo: float, hi: float) -> torch.Tensor:
    return torch.clamp(t, lo, hi)


def hsl2rgb(hsl: torch.Tensor) -> torch.Tensor:
    """(3, H, W) HSL (h in [0, 1]) -> (3, H, W) RGB."""
    h, s, l = hsl[0], hsl[1], hsl[2]
    c = (1 - torch.abs(2 * l - 1)) * s
    hp = h * 6.0
    x = c * (1 - torch.abs(torch.remainder(hp, 2) - 1))
    zeros = torch.zeros_like(c)
    idx = torch.clamp(hp.to(torch.int32), 0, 5).long()
    options = torch.stack([
        torch.stack([c, x, zeros]), torch.stack([x, c, zeros]),
        torch.stack([zeros, c, x]), torch.stack([zeros, x, c]),
        torch.stack([x, zeros, c]), torch.stack([c, zeros, x]),
    ])                                                   # (6, 3, H, W)
    rgb = torch.gather(options, 0, idx[None, None].expand(1, 3, *idx.shape))[0]
    m = l - c / 2
    return rgb + m[None]


def depth2color(depth: torch.Tensor, confs: torch.Tensor) -> torch.Tensor:
    """HSL colorization of a normalized depth map and its confidences."""
    d = saturate(depth, 0.0, 1.0)
    hsl = torch.stack([true_div(d, 1.5), torch.ones_like(d), confs * 0.5])
    return hsl2rgb(hsl)


def pad_output(h_img: int, w_img: int, im: torch.Tensor) -> torch.Tensor:
    """Center an output map (C, h, w) in the full (C, h_img, w_img) frame."""
    C, h, w = im.shape
    dh, dw = h_img - h, w_img - w
    out = im.new_zeros((C, h_img, w_img))
    y0 = -(-dh // 2) - 1
    x0 = -(-dw // 2) - 1
    out[:, y0:y0 + h, x0:x0 + w] = im
    return out
