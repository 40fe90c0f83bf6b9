"""Coarse-to-fine variational optical flow, Ce Liu's solver (port of
``depth_estimation_tpu.flow.celiu``).

  * Gaussian pyramid with Liu's level/sigma schedule;
  * im2feature: gray+dx+dy (1 channel) or gray+dx+dy+(g-r)+(g-b) (3);
  * IRLS with the robust smoothness weight Phi = 0.5/sqrt(|grad u|^2 +
    |grad v|^2 + eps) and the data weight Psi of the Laplacian ('lap') or
    Gaussian-mixture ('gmm') noise model;
  * per-level schedule n_outer + k, n_sor + 3k;
  * red-black SOR (omega = 1.8) inside each IRLS step: kernel B4
    (``flow/sor_kernel.sor_redblack``, ``csrc/sor_redblack.cu``) on a CUDA
    tensor, its plain twin ``sor_plain`` on a CPU tensor;
  * bilinear (packed taps) or bicubic Hermite warping, out-of-range pixels
    taking frame-1 values. The bilinear warps (with each outer step's flow
    update and Laplacian noise estimate) and Liu's resize go through
    ``flow/liu_warp``: one kernel launch each on a CUDA tensor
    (``csrc/liu_warp.cu``), their plain twins (``warp_image``,
    ``laplacian_noise`` and the host-built resize) on a CPU tensor.

An IRLS step's planes (``_irls_planes``) under the Laplacian noise model
are one launch of the IRLS kernel on a CUDA tensor (``flow/liu_irls``,
``csrc/liu_irls.cu``), bit for bit the torch code's, cold or warm start;
the kernel takes the features of gray and colour images (3 and 5
channels) and raises for others. Under the 'gmm' model the first inner
step replays on the card from a CUDA graph captured once per level shape
(``GRAPHS``, the shared ``utils/cuda_graph`` cache), bit for bit eager's,
and a warm start's steps run eagerly. On a CPU tensor every step runs
``_irls_planes``.

Spans (``utils/timer.SPANS``, ranges only while a profiler runs):
``liu.pyramid`` (both pyramids, then each level's ``im2feature``),
``liu.irls`` (an IRLS step's derivatives, Phi and Psi, the coefficient
planes and the Laplacian: the IRLS kernel's launch, or a graph's replay,
on the card), ``liu.sor`` (the SOR solve), ``liu.warp`` (the flow's
upsampling between levels, each outer step's update, warp and noise
estimate, and the final warp). Counters (``utils/timer.COUNTERS``):
``liu.levels`` a level solved, ``liu.irls_steps`` an outer IRLS step, and
``GRAPHS``'s ``liu_graph.captures``, ``.replays``, ``.eager``; the IRLS
kernel's launches are ``liu_irls.irls_planes.launches``.

Layout: images are (..., H, W, C) float32 in [0, 1], flow fields (..., H,
W); leading dims are independent pairs solved together. vx = x (column)
flow, vy = y (row) flow.

Numerics follow the reference operation by operation. Two torch habits
would round differently and are avoided: ``c / tensor`` is a reciprocal
times c in torch (``_rdiv`` divides where c is not 1 or a power of two),
and a CUDA ``tensor / scalar`` multiplies by the reciprocal (the resize's
twin computes its coordinates on the host and moves them; the kernel
divides on the card as the host does).
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.cuda_graph import GraphCache
from ..utils.device import as_f32
from ..utils.timer import count, profiled_span
from . import liu_irls, liu_warp
from .sor_kernel import sor_redblack

# the IRLS planes' graphs under the 'gmm' noise model (the 'lap' model's
# steps are the IRLS kernel's on the card): a solve's levels at two batch
# sizes a device
GRAPHS = GraphCache("liu_graph", max_graphs=16)

# ---------------------------------------------------------------------------
# image helpers (clamp-boundary separable filters, bilinear sampling)
# ---------------------------------------------------------------------------


def _rdiv(c: float, t: torch.Tensor) -> torch.Tensor:
    """c / t as a true division (torch's ``c / t`` is ``reciprocal(t) * c``)."""
    return torch.div(torch.full_like(t, c), t)


def _edge_index(n: int, lo: int, hi: int, device) -> torch.Tensor:
    """Indices of an edge (replicate) pad of ``lo`` before and ``hi`` after
    an axis of length n."""
    return torch.arange(-lo, n + hi, device=device).clamp(0, n - 1)


def _shift_edge(img: torch.Tensor, axis: int) -> torch.Tensor:
    """img advanced by one along ``axis`` with the last slice repeated: the
    edge pad at the end, then dropping the first slice."""
    n = img.shape[axis]
    idx = torch.arange(1, n + 1, device=img.device).clamp(max=n - 1)
    return img.index_select(axis, idx)


def _hfilter(img: torch.Tensor, f) -> torch.Tensor:
    """Horizontal correlation with clamp (replicate) boundary. img (..., H,
    W, C); ``f`` float32 taps."""
    r = len(f) // 2
    W = img.shape[-2]
    p = img.index_select(-2, _edge_index(W, r, r, img.device))
    out = torch.zeros_like(img)
    for k, w in enumerate(f):
        out = out + float(w) * p[..., k:k + W, :]
    return out


def _vfilter(img: torch.Tensor, f) -> torch.Tensor:
    r = len(f) // 2
    H = img.shape[-3]
    p = img.index_select(-3, _edge_index(H, r, r, img.device))
    out = torch.zeros_like(img)
    for k, w in enumerate(f):
        out = out + float(w) * p[..., k:k + H, :, :]
    return out


_DERIV5 = np.array([1, -8, 0, 8, -1], np.float32) / 12.0


def dx_advanced(img: torch.Tensor) -> torch.Tensor:
    """5-tap derivative filter along W."""
    return _hfilter(img, _DERIV5)


def dy_advanced(img: torch.Tensor) -> torch.Tensor:
    return _vfilter(img, _DERIV5)


def dx_forward(img: torch.Tensor) -> torch.Tensor:
    """Forward difference along W, last column zero. img (..., H, W, C)."""
    d = img[..., :, 1:, :] - img[..., :, :-1, :]
    return F.pad(d, (0, 0, 0, 1))


def dy_forward(img: torch.Tensor) -> torch.Tensor:
    d = img[..., 1:, :, :] - img[..., :-1, :, :]
    return F.pad(d, (0, 0, 0, 0, 0, 1))


def gaussian_smooth(img: torch.Tensor, sigma: float, fsize: int) -> torch.Tensor:
    """Separable Gaussian with clamp boundary."""
    xs = np.arange(-fsize, fsize + 1, dtype=np.float64)
    f = np.exp(-(xs ** 2) / (2 * sigma * sigma))
    f = (f / f.sum()).astype(np.float32)
    return _vfilter(_hfilter(img, f), f)


def _gather_hw(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor) -> torch.Tensor:
    """img (..., H, W, C) at integer (yy, xx) (..., Hs, Ws), coordinates
    clamped into the image. Leading dims of img and the indices match."""
    H, W, C = img.shape[-3], img.shape[-2], img.shape[-1]
    yy = yy.clamp(0, H - 1)
    xx = xx.clamp(0, W - 1)
    if img.ndim == 3:
        return img[yy.long(), xx.long()]
    lead = img.shape[:-3]
    flat = img.reshape(lead + (H * W, C))
    idx = (yy.long() * W + xx.long()).reshape(lead + (-1, 1))
    out = torch.gather(flat, -2, idx.expand(lead + (idx.shape[-2], C)))
    return out.reshape(tuple(yy.shape) + (C,))


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor,
                    packed: bool = False) -> torch.Tensor:
    """Sample img (..., H, W, C) at continuous (x, y) (..., Hs, Ws) with
    clamped corners. Weights are f32; a reduced-precision img promotes to
    f32 in the blend.

    ``packed=True`` is the solver's form: coordinates are clamped into the
    image first, and the four taps come from one edge-padded (H, W, 4C)
    table in one gather. It equals the default four-tap form within float
    rounding (<= 1e-6); the four-tap form stays the default because
    ``geometry3d.undistort`` uses it."""
    if packed:
        H, W = img.shape[-3], img.shape[-2]
        x = x.clamp(0, W - 1)
        y = y.clamp(0, H - 1)
        x0 = torch.floor(x).to(torch.int32)
        y0 = torch.floor(y).to(torch.int32)
        dx = (x - x0.to(x.dtype))[..., None]
        dy = (y - y0.to(y.dtype))[..., None]
        xr = _shift_edge(img, img.ndim - 2)
        yd = _shift_edge(img, img.ndim - 3)
        xyd = _shift_edge(xr, img.ndim - 3)
        table = torch.cat([img, xr, yd, xyd], dim=-1)
        t = _gather_hw(table, y0, x0)
        C = img.shape[-1]
        t00, t10, t01, t11 = (t[..., :C], t[..., C:2 * C],
                              t[..., 2 * C:3 * C], t[..., 3 * C:])
        return ((1 - dx) * (1 - dy) * t00 + dx * (1 - dy) * t10
                + (1 - dx) * dy * t01 + dx * dy * t11)

    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    dx = (x - x0.to(x.dtype)).clamp(0.0, 1.0)[..., None]
    dy = (y - y0.to(y.dtype)).clamp(0.0, 1.0)[..., None]

    def at(yy, xx):
        return _gather_hw(img, yy, xx)

    return ((1 - dx) * (1 - dy) * at(y0, x0)
            + dx * (1 - dy) * at(y0, x0 + 1)
            + (1 - dx) * dy * at(y0 + 1, x0)
            + dx * dy * at(y0 + 1, x0 + 1))


def imresize(img: torch.Tensor, dst_h: int, dst_w: int) -> torch.Tensor:
    """Liu's resize: sample at x = (j+1)/ratio - 1. img: (..., H, W, C)
    float32 (``liu_warp.resize``: the kernel on a CUDA tensor)."""
    return liu_warp.resize(img, dst_h, dst_w)


def _pixel_coords(vx: torch.Tensor, vy: torch.Tensor, H: int, W: int):
    j = torch.arange(W, dtype=torch.float32, device=vx.device)[None, :]
    i = torch.arange(H, dtype=torch.float32, device=vx.device)[:, None]
    x = j + vx
    y = i + vy
    oob = (x < 0) | (x > W - 1) | (y < 0) | (y > H - 1)
    return x, y, oob


def warp_image(im1: torch.Tensor, im2: torch.Tensor,
               vx: torch.Tensor, vy: torch.Tensor) -> torch.Tensor:
    """warpIm2(i,j) = im2(i+vy, j+vx) bilinear; pixels whose (unclamped)
    sample point is out of range copy im1. im1/im2 (..., H, W, C), vx/vy
    (..., H, W)."""
    H, W = im1.shape[-3], im1.shape[-2]
    x, y, oob = _pixel_coords(vx, vy, H, W)
    warped = bilinear_sample(im2, x, y, packed=True)
    return torch.where(oob[..., None], im1, warped)


def _hermite(t: torch.Tensor):
    """Cubic Hermite basis (h00, h10, h01, h11)(t)."""
    t2 = t * t
    t3 = t2 * t
    return (2 * t3 - 3 * t2 + 1, t3 - 2 * t2 + t,
            -2 * t3 + 3 * t2, t3 - t2)


def warp_image_bicubic(im1: torch.Tensor, im2: torch.Tensor,
                       vx: torch.Tensor, vy: torch.Tensor) -> torch.Tensor:
    """Bicubic Hermite warp (central-difference derivative images, filter
    [-0.5, 0, 0.5]) with im1 fallback and a [0, 1] clip."""
    H, W = im1.shape[-3], im1.shape[-2]
    d = np.asarray([-0.5, 0.0, 0.5], np.float32)
    fx = _hfilter(im2, d)
    fy = _vfilter(im2, d)
    fxy = _vfilter(fx, d)

    x, y, oob = _pixel_coords(vx, vy, H, W)
    # pre-clamp before floor: out-of-range pixels are overwritten by im1
    x = x.clamp(0, W - 1)
    y = y.clamp(0, H - 1)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    dx = (x - x0.to(x.dtype))[..., None]
    dy = (y - y0.to(y.dtype))[..., None]
    hx = _hermite(dx)
    hy = _hermite(dy)

    # the 16 taps (4 tables x 4 corners) in one edge-padded (H, W, 16C) table
    G = torch.cat([im2, fx, fy, fxy], dim=-1)
    Gx = _shift_edge(G, G.ndim - 2)
    Gy = _shift_edge(G, G.ndim - 3)
    Gxy = _shift_edge(Gx, G.ndim - 3)
    t = _gather_hw(torch.cat([G, Gx, Gy, Gxy], dim=-1), y0, x0)

    C = im1.shape[-1]
    out = torch.zeros_like(im1)
    # corner blocks: (x0,y0), (x0+1,y0), (y0+1,x0), (x0+1,y0+1); within each
    # block: value, d/dx, d/dy, d2/dxdy
    for bi, (ix, iy) in enumerate(((0, 0), (1, 0), (0, 1), (1, 1))):
        base = bi * 4 * C
        f = t[..., base:base + C]
        gx = t[..., base + C:base + 2 * C]
        gy = t[..., base + 2 * C:base + 3 * C]
        gxy = t[..., base + 3 * C:base + 4 * C]
        bxv = hx[0] if ix == 0 else hx[2]
        bxd = hx[1] if ix == 0 else hx[3]
        byv = hy[0] if iy == 0 else hy[2]
        byd = hy[1] if iy == 0 else hy[3]
        out = out + (bxv * byv * f + bxd * byv * gx
                     + bxv * byd * gy + bxd * byd * gxy)
    out = torch.where(oob[..., None], im1, out)
    return out.clamp(0.0, 1.0)


_WARPERS = {"bilinear": warp_image, "bicubic": warp_image_bicubic}


def _warp(im1, im2, u, v, interpolation: str) -> torch.Tensor:
    """The solver's warp of im2 by (u, v): bilinear through ``liu_warp``
    (the kernel on a CUDA tensor), bicubic in torch."""
    if interpolation == "bilinear":
        return liu_warp.warp_update_noise(im1, im2, u, v)[2]
    return _WARPERS[interpolation](im1, im2, u, v)


# ---------------------------------------------------------------------------
# pyramid and features
# ---------------------------------------------------------------------------

def pyramid_shapes(h: int, w: int, ratio: float, min_width: int) -> List[Tuple[int, int]]:
    if ratio > 0.98 or ratio < 0.4:
        ratio = 0.75
    n_levels = int(math.log(min_width / w) / math.log(ratio))
    shapes = [(h, w)]
    for i in range(1, n_levels):
        shapes.append((int(h * ratio ** i), int(w * ratio ** i)))
    return shapes


def build_pyramid(img: torch.Tensor, ratio: float, min_width: int) -> List[torch.Tensor]:
    """Liu's Gaussian pyramid: level i < n smooths the base image by
    sigma = i (1/ratio - 1); deeper levels smooth level i - n."""
    if ratio > 0.98 or ratio < 0.4:
        ratio = 0.75
    shapes = pyramid_shapes(img.shape[-3], img.shape[-2], ratio, min_width)
    base_sigma = 1 / ratio - 1
    n = int(math.log(0.25) / math.log(ratio))
    n_sigma = base_sigma * n
    pyr = [img]
    for i in range(1, len(shapes)):
        if i <= n:
            sigma = base_sigma * i
            foo = gaussian_smooth(img, sigma, int(sigma * 3))
        else:
            foo = gaussian_smooth(pyr[i - n], n_sigma, int(n_sigma * 3))
        pyr.append(imresize(foo, *shapes[i]))
    return pyr


def im2feature(img: torch.Tensor) -> torch.Tensor:
    """1 channel -> (gray, dx, dy); 3 channels -> (gray, dx, dy, g-r, g-b)."""
    C = img.shape[-1]
    if C == 1:
        return torch.cat([img, dx_advanced(img), dy_advanced(img)], dim=-1)
    if C == 3:
        w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype,
                         device=img.device)
        gray = (img * w).sum(-1, keepdim=True)
        return torch.cat([
            gray, dx_advanced(gray), dy_advanced(gray),
            (img[..., 1] - img[..., 0])[..., None],   # g - r
            (img[..., 1] - img[..., 2])[..., None],   # g - b
        ], dim=-1)
    return img


# ---------------------------------------------------------------------------
# Gaussian-mixture noise model
# ---------------------------------------------------------------------------

def gaussian_mixture_init(n_channels: int, device):
    """Per-channel 2-component mixture (alpha, sigma, beta) = (0.95, 0.05,
    0.5), on ``device``."""
    return tuple(torch.full((n_channels,), v, dtype=torch.float32,
                            device=device) for v in (0.95, 0.05, 0.5))


def _gm_gaussian(t2: torch.Tensor, s: torch.Tensor) -> torch.Tensor:
    """exp(-x / (2 s^2)) / (2 pi s); t2 broadcast against per-channel s."""
    return torch.exp(-t2 / (2.0 * s * s)) / (2.0 * math.pi * s)


def gmm_psi(temp: torch.Tensor, gm) -> torch.Tensor:
    """Data weight under the mixture: (p1/(2 sigma^2) + p2/(2 beta^2)) /
    (p1 + p2), p1 = N(t^2; sigma) alpha, p2 = N(t^2; beta) (1 - alpha)."""
    alpha, sigma, beta = (p[..., None, None, :] for p in gm)
    t2 = temp * temp
    p1 = _gm_gaussian(t2, sigma) * alpha
    p2 = _gm_gaussian(t2, beta) * (1.0 - alpha)
    num = p1 / (2.0 * sigma * sigma) + p2 / (2.0 * beta * beta)
    return num / torch.clamp(p1 + p2, min=1e-30)


def est_gaussian_mixture(im1f: torch.Tensor, warp: torch.Tensor, gm,
                         prior: float = 0.9, n_iters: int = 3):
    """3-iteration EM re-estimate of the mixture after each warp, with the
    regularized M-step (alpha and beta blended toward 0.95 / 0.3 with
    weight ``prior``)."""
    alpha, sigma, beta = gm
    t2 = (im1f - warp) ** 2                      # (..., H, W, C)

    def bc(p):
        return p[..., None, None, :]

    for _ in range(n_iters):
        w1 = _gm_gaussian(t2, bc(sigma)) * bc(alpha)     # E step
        w2 = _gm_gaussian(t2, bc(beta)) * (1.0 - bc(alpha))
        tot = torch.clamp(w1 + w2, min=1e-30)
        w1, w2 = w1 / tot, w2 / tot
        total1 = w1.sum(dim=(-3, -2))
        total2 = w2.sum(dim=(-3, -2))
        alpha = total1 / torch.clamp(total1 + total2, min=1e-30) * (1 - prior) \
            + 0.95 * prior
        sigma = torch.sqrt((w1 * t2).sum(dim=(-3, -2))
                           / torch.clamp(total1, min=1e-30))
        beta = torch.sqrt((w2 * t2).sum(dim=(-3, -2))
                          / torch.clamp(total2, min=1e-30)) * (1 - prior) \
            + 0.3 * prior
    return alpha, sigma, beta


def laplacian_noise(im1f: torch.Tensor, warp: torch.Tensor) -> torch.Tensor:
    """Per-channel mean |It| over pixels with 0 < |It| < 1e6."""
    diff = torch.abs(im1f - warp)
    valid = (diff > 0) & (diff < 1e6)
    cnt = torch.clamp(valid.sum(dim=(-3, -2)), min=1)
    return (diff * valid).sum(dim=(-3, -2)) / cnt


# ---------------------------------------------------------------------------
# the IRLS + red-black SOR solver for one pyramid level
# ---------------------------------------------------------------------------

_GFILTER = np.array([0.02, 0.11, 0.74, 0.11, 0.02], np.float32)


def get_dxs(im1: torch.Tensor, im2: torch.Tensor):
    """Smooth both, Im = 0.4 Im1 + 0.6 Im2, 5-tap derivatives, dt = Im2s -
    Im1s."""
    s1 = _vfilter(_hfilter(im1, _GFILTER), _GFILTER)
    s2 = _vfilter(_hfilter(im2, _GFILTER), _GFILTER)
    im = 0.4 * s1 + 0.6 * s2
    return dx_advanced(im), dy_advanced(im), s2 - s1


def _neighbor_weights(phi: torch.Tensor):
    """Edge weights of the 5-point stencil, zero at the image boundary: west
    uses phi[west], east/south use phi[self], north uses phi[north]."""
    H, W = phi.shape[-2:]
    w_w = F.pad(phi[..., :, :-1], (1, 0))
    w_e = phi * (torch.arange(W, device=phi.device) < W - 1)[None, :]
    w_n = F.pad(phi[..., :-1, :], (0, 0, 1, 0))
    w_s = phi * (torch.arange(H, device=phi.device) < H - 1)[:, None]
    return w_w, w_e, w_n, w_s


def _nsum(f: torch.Tensor, w_w, w_e, w_n, w_s) -> torch.Tensor:
    left = F.pad(f[..., :, :-1], (1, 0))
    right = F.pad(f[..., :, 1:], (0, 1))
    up = F.pad(f[..., :-1, :], (0, 0, 1, 0))
    down = F.pad(f[..., 1:, :], (0, 0, 0, 1))
    return w_w * left + w_e * right + w_n * up + w_s * down


def sor_plain(w_w, w_e, w_n, w_s, denom_u, denom_v, b1, b2, imdxy,
              *, alpha: float, n_sor: int, omega: float = 1.8,
              du=None, dv=None):
    """n_sor red-black SOR iterations, the plain twin of kernel B4. All
    planes (..., H, W) f32. Starts from ``du``/``dv`` (zeros when None; the
    solver's warm start when n_inner > 1). Per colour (red = (i + j) even,
    then black): du from s1 = -alpha * nsum(du) + imdxy * dv, then dv from
    s2 = -alpha * nsum(dv) + imdxy * du with the new du; each update is
    (1 - omega) * x + (omega / denom) * (b - s). Returns (du, dv)."""
    H, W = w_w.shape[-2:]
    if du is None:
        du = torch.zeros_like(w_w)
    if dv is None:
        dv = torch.zeros_like(w_w)
    ii = torch.arange(H, device=w_w.device)[:, None]
    jj = torch.arange(W, device=w_w.device)[None, :]
    red = (ii + jj) % 2 == 0
    odenu = _rdiv(omega, denom_u)
    odenv = _rdiv(omega, denom_v)
    for _ in range(n_sor):
        for color in (red, ~red):
            s1 = -alpha * _nsum(du, w_w, w_e, w_n, w_s) + imdxy * dv
            du = torch.where(color, (1 - omega) * du + odenu * (b1 - s1), du)
            s2 = -alpha * _nsum(dv, w_w, w_e, w_n, w_s) + imdxy * du
            dv = torch.where(color, (1 - omega) * dv + odenv * (b2 - s2), dv)
    return du, dv


def _irls_planes(im1f, warp, u, v, lap_para, *gm, alpha: float,
                 noise_model: str, du=None, dv=None):
    """An IRLS step's derivatives, Phi, Psi, channel means, weighted
    Laplacians and the SOR's coefficient planes. Shapes as in
    ``smooth_flow_sor``; ``gm`` the mixture's three tensors under 'gmm',
    none under 'lap'. ``du``/``dv`` None: the first inner step, whose
    increments are zeros; else a warm start's increments (its derivatives,
    computed again, are the first step's bit for bit). Returns (w_w, w_e,
    w_n, w_s, denom_u, denom_v, b1, b2, imdxy), the arguments of
    ``sor_redblack`` and ``sor_plain``."""
    eps_phi = 1e-6
    eps_psi = 1e-6
    imdx, imdy, imdt = get_dxs(im1f, warp)
    if du is None:
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        uu, vv = u, v
    else:
        uu, vv = u + du, v + dv
    ux = dx_forward(uu[..., None])[..., 0]
    uy = dy_forward(uu[..., None])[..., 0]
    vx_ = dx_forward(vv[..., None])[..., 0]
    vy_ = dy_forward(vv[..., None])[..., 0]
    phi = 0.5 / torch.sqrt(ux * ux + uy * uy + vx_ * vx_
                           + vy_ * vy_ + eps_phi)

    temp = imdt + imdx * du[..., None] + imdy * dv[..., None]
    if noise_model == "gmm":
        psi = gmm_psi(temp, gm)
    else:
        psi = 1.0 / (2.0 * torch.sqrt(temp * temp + eps_psi))
        # channels whose estimated noise is ~0 keep psi = 0
        psi = psi * (lap_para[..., None, None, :] >= 1e-20)

    # collapse = channel average
    imdxy = torch.mean(psi * imdx * imdy, dim=-1)
    imdx2 = torch.mean(psi * imdx * imdx, dim=-1)
    imdy2 = torch.mean(psi * imdy * imdy, dim=-1)
    imdtdx = torch.mean(psi * imdx * imdt, dim=-1)
    imdtdy = torch.mean(psi * imdy * imdt, dim=-1)

    # weighted Laplacian of the current flow (divergence form)
    def lap(f):
        fh = dx_forward(f[..., None])[..., 0] * phi
        fv = dy_forward(f[..., None])[..., 0] * phi
        out = -fh - fv
        out = out + F.pad(fh[..., :, :-1], (1, 0))
        out = out + F.pad(fv[..., :-1, :], (0, 0, 1, 0))
        return out

    b1 = -imdtdx - alpha * lap(u)
    b2 = -imdtdy - alpha * lap(v)

    w_w, w_e, w_n, w_s = _neighbor_weights(phi)
    coeff = alpha * (w_w + w_e + w_n + w_s)
    denom_u = imdx2 + alpha * 0.05 + coeff
    denom_v = imdy2 + alpha * 0.05 + coeff
    return w_w, w_e, w_n, w_s, denom_u, denom_v, b1, b2, imdxy


def smooth_flow_sor(im1f, im2f, warp, u, v, lap_para, alpha,
                    n_outer: int, n_inner: int, n_sor: int,
                    noise_model: str = "lap", gm=None,
                    interpolation: str = "bilinear"):
    """One pyramid level of IRLS with red-black SOR inside. Shapes:
    images/warp (..., H, W, C), flows (..., H, W), lap_para (..., C).
    Returns (u, v, warp, lap_para, gm).

    An IRLS step's planes go through the IRLS kernel
    (``liu_irls.irls_planes``, which raises for features of other than 3
    or 5 channels) on a CUDA tensor under the 'lap' model, cold or warm
    start; under 'gmm' the first inner step's (``_irls_planes``) replay
    from a CUDA graph where the input allows (``GRAPHS``) and a warm
    start's run eagerly; on a CPU tensor every step runs ``_irls_planes``. The SOR solve from a zero start (the first inner step, and
    every step of the reference's schedules, which use n_inner = 1) goes
    through ``sor_redblack``: kernel B4 for a CUDA tensor, ``sor_plain`` for
    a CPU tensor. A warm start (n_inner > 1) runs ``sor_plain``. Each
    outer step's flow update, bilinear warp and Laplacian noise estimate
    are one ``liu_warp.warp_update_noise`` call; bicubic warps and the
    'gmm' estimate run in torch."""
    omega = 1.8
    kernel = noise_model == "lap" and im1f.is_cuda

    for _ in range(n_outer):
        count("liu.irls_steps")
        for hh in range(n_inner):
            with profiled_span("liu.irls"):
                tensors = (im1f, warp, u, v, lap_para, *(gm or ()))
                if kernel:
                    warm = dict(du=du, dv=dv) if hh else {}
                    planes = liu_irls.irls_planes(*tensors, alpha=alpha,
                                                  **warm)
                elif hh == 0:
                    planes = GRAPHS.replay(
                        _irls_planes, tensors, alpha=alpha,
                        noise_model=noise_model)
                else:
                    planes = GRAPHS.run_eager(
                        _irls_planes, tensors, alpha=alpha,
                        noise_model=noise_model, du=du, dv=dv)

            with profiled_span("liu.sor"):
                if hh == 0:
                    du, dv = sor_redblack(*planes, alpha=alpha, n_sor=n_sor,
                                          omega=omega)
                else:
                    du, dv = sor_plain(*planes, alpha=alpha, n_sor=n_sor,
                                       omega=omega, du=du, dv=dv)

        with profiled_span("liu.warp"):
            lap = noise_model == "lap"
            if interpolation == "bilinear":
                u, v, warp, noise = liu_warp.warp_update_noise(
                    im1f, im2f, u, v, du, dv, noise=lap)
            else:
                u = u + du
                v = v + dv
                warp = _WARPERS[interpolation](im1f, im2f, u, v)
                noise = laplacian_noise(im1f, warp) if lap else None

            if noise_model == "gmm":
                gm = est_gaussian_mixture(im1f, warp, gm)
            else:
                lap_para = noise
    return u, v, warp, lap_para, gm


# ---------------------------------------------------------------------------
# the coarse-to-fine solve
# ---------------------------------------------------------------------------

def _as_image(x, device) -> torch.Tensor:
    """f32 tensor; a tensor stays on its device unless ``device`` is given,
    anything else goes to ``device`` (the card by default)."""
    if device is None and isinstance(x, torch.Tensor):
        return x.float()
    return as_f32(x, device or "cuda")


def coarse2fine_flow(
    im1, im2,
    alpha: float = 1.0, ratio: float = 0.5, min_width: int = 40,
    n_outer: int = 3, n_inner: int = 1, n_sor: int = 20,
    noise_model: str = "lap", interpolation: str = "bilinear",
    device=None,
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The full coarse-to-fine solve; defaults are the mex entry point's.
    Returns (vx, vy, warped). The trainer's 'liu' ground truth uses alpha
    0.005, ratio 0.75, min_width 30, 5/1/40. ``noise_model``: 'lap' |
    'gmm'; ``interpolation``: 'bilinear' | 'bicubic'. Tensors are solved
    where they lie; other inputs (numpy arrays) go to ``device``, the card
    unless ``device="cpu"``."""
    if noise_model not in ("lap", "gmm"):
        raise ValueError(f"noise_model {noise_model!r}")
    if interpolation not in _WARPERS:
        raise ValueError(f"interpolation {interpolation!r}")
    im1 = _as_image(im1, device)
    im2 = _as_image(im2, device).to(im1.device)
    if im1.ndim == 2:
        im1, im2 = im1[..., None], im2[..., None]
    with profiled_span("liu.pyramid"):
        pyr1 = build_pyramid(im1, ratio, min_width)
        pyr2 = build_pyramid(im2, ratio, min_width)
    if ratio > 0.98 or ratio < 0.4:
        ratio = 0.75

    n_ch = 3 if im1.shape[-1] == 1 else (5 if im1.shape[-1] == 3
                                          else im1.shape[-1])
    lead = tuple(im1.shape[:-3])
    lap_para = torch.full(lead + (n_ch,), 0.02, dtype=torch.float32,
                          device=im1.device)
    gm = (tuple(p.expand(lead + (n_ch,))
                for p in gaussian_mixture_init(n_ch, im1.device))
          if noise_model == "gmm" else None)

    u = v = warp = None
    for k in range(len(pyr1) - 1, -1, -1):
        count("liu.levels")
        with profiled_span("liu.pyramid"):
            f1 = im2feature(pyr1[k])
            f2 = im2feature(pyr2[k])
        h, w = f1.shape[-3], f1.shape[-2]
        if u is None:
            u = torch.zeros(lead + (h, w), dtype=torch.float32, device=f1.device)
            v = torch.zeros(lead + (h, w), dtype=torch.float32, device=f1.device)
            warp = f2
        else:
            with profiled_span("liu.warp"):
                u = liu_warp.resize(u[..., None], h, w, 1 / ratio)[..., 0]
                v = liu_warp.resize(v[..., None], h, w, 1 / ratio)[..., 0]
                warp = _warp(f1, f2, u, v, interpolation)
        u, v, warp, lap_para, gm = smooth_flow_sor(
            f1, f2, warp, u, v, lap_para, alpha,
            n_outer + k, n_inner, n_sor + k * 3,
            noise_model=noise_model, gm=gm, interpolation=interpolation,
        )
    with profiled_span("liu.warp"):
        warped = _warp(im1, im2, u, v, interpolation).clamp(0.0, 1.0)
    return u, v, warped


def coarse2fine_flow_batched(im1s, im2s, **kw
                             ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """coarse2fine_flow over B independent pairs (B, H, W, C) (or (B, H, W)
    gray) solved together, every stage with the batch as a leading dim.
    Returns (vx, vy, warped), each with leading B."""
    im1s = _as_image(im1s, kw.get("device"))
    im2s = _as_image(im2s, kw.get("device")).to(im1s.device)
    if im1s.ndim == 3:
        im1s, im2s = im1s[..., None], im2s[..., None]
    if im1s.ndim != 4:
        raise ValueError(f"batched input must be (B, H, W, C), got "
                         f"{tuple(im1s.shape)}")
    kw = dict(kw, device=None)
    return coarse2fine_flow(im1s, im2s, **kw)
