"""Ce Liu's coarse-to-fine variational optical flow, the plain reference.

The solve of ``Coarse2FineFlow`` (C. Liu, *Beyond Pixels*, MIT 2009;
``celiu/mex/OpticalFlow.cpp:944-1015`` of
https://github.com/MichaelMathieu/depth-estimation) with the Laplacian
noise model and bilinear warps, at the parameters the trainer's 'liu'
ground truth gives it (``groundtruth_opticalflow_celiu.lua:9-14``: alpha
0.005, ratio 0.75, minWidth 30, 5 outer, 1 inner and 40 SOR iterations).
Plain ``torch`` in float32, TF32 off, written out operation by operation:
no kernel, no cache. It imports nothing of the port
(``depth_estimation_tpu_torch``), of the JAX package or of JAX.
``h100bench/reference/liu.py`` is a frozen copy with the same body.

  * the Gaussian pyramid (``GaussianPyramid.cpp:45-76``): level i <= n
    smooths the base image by sigma = i (1/ratio - 1), deeper levels smooth
    level i - n; Liu's resize samples at x = (j + 1) / ratio - 1;
  * ``im2feature`` (``OpticalFlow.cpp:1090-1130``): gray (0.299, 0.587,
    0.114), its 5-tap x and y derivatives, g - r and g - b;
  * per level k, coarse to fine: the flow upsampled by 1/ratio, frame 2
    warped, then n_outer + k IRLS steps of n_inner fixed points each
    (``OpticalFlow.cpp:194-463``): derivatives of the smoothed average,
    the robust smoothness weight Phi = 0.5 / sqrt(|grad u|^2 + |grad v|^2
    + 1e-6), the data weight Psi = 1 / (2 sqrt(It^2 + 1e-6)) (Laplacian
    noise; channels whose noise estimate is ~0 keep Psi = 0), five
    channel-averaged coefficient planes, the weighted Laplacian, and
    n_sor + 3k SOR iterations (omega 1.8) on du, dv; after each step the
    flow is updated, frame 2 warped again and the noise re-estimated as
    each channel's mean |It| over pixels with 0 < |It| < 1e6;
  * the final warp of frame 2 by the flow, clipped to [0, 1].

Departures from ``OpticalFlow.cpp`` that the port makes and this
reference keeps, so that the two compute the same numbers:
  * the SOR visits pixels in red-black order (red (i + j even) du, red dv,
    black du, black dv, each colour updated at once) where Liu's code
    sweeps them in raster order (Gauss-Seidel): the same linear system and
    fixed point, other iterates;
  * bilinear samples clamp the coordinates into the image before the four
    taps are read (equal to Liu's clamped taps within rounding), and a
    pixel whose sample point falls outside the image takes frame 1's value;
  * the final warp is bilinear (the trainer's ``liu_flow``), where Liu's
    code warps bicubically (``OpticalFlow.cpp:1013-1014``);
  * leading dims of the images are independent pairs solved side by side;
  * ``c / t`` for a tensor t is written as a true division where c is not
    a power of two (``torch``'s ``c / t`` is ``reciprocal(t) * c``), and
    the resize's coordinates are computed on the host.

``state_dtype`` (the benchmark's control) rounds du and dv to that type
after every SOR solve; ``None`` keeps float32.
"""

from __future__ import annotations

import contextlib
import math
from typing import List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

OMEGA = 1.8
EPS_PHI = 1e-6
EPS_PSI = 1e-6
GRAY = (0.299, 0.587, 0.114)
DERIV5 = np.array([1, -8, 0, 8, -1], np.float32) / 12.0
SMOOTH5 = np.array([0.02, 0.11, 0.74, 0.11, 0.02], np.float32)


@contextlib.contextmanager
def full_f32():
    """cuDNN's and cuBLAS's f32 operations in full f32 (TF32 off), the
    previous flags restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


# ---------------------------------------------------------------------------
# filters and sampling on (..., H, W, C) images
# ---------------------------------------------------------------------------

def _clamped(n: int, lo: int, hi: int, device) -> torch.Tensor:
    return torch.arange(lo, n + hi, device=device).clamp(0, n - 1)


def hfilter(img: torch.Tensor, taps) -> torch.Tensor:
    """Correlation along W with the edge value repeated past the border."""
    r = len(taps) // 2
    W = img.shape[-2]
    p = img.index_select(-2, _clamped(W, -r, r, img.device))
    out = torch.zeros_like(img)
    for k, t in enumerate(taps):
        out = out + float(t) * p[..., k:k + W, :]
    return out


def vfilter(img: torch.Tensor, taps) -> torch.Tensor:
    """Correlation along H with the edge value repeated past the border."""
    r = len(taps) // 2
    H = img.shape[-3]
    p = img.index_select(-3, _clamped(H, -r, r, img.device))
    out = torch.zeros_like(img)
    for k, t in enumerate(taps):
        out = out + float(t) * p[..., k:k + H, :, :]
    return out


def gaussian(img: torch.Tensor, sigma: float, radius: int) -> torch.Tensor:
    xs = np.arange(-radius, radius + 1, dtype=np.float64)
    g = np.exp(-(xs ** 2) / (2 * sigma * sigma))
    g = (g / g.sum()).astype(np.float32)
    return vfilter(hfilter(img, g), g)


def forward_dx(f: torch.Tensor) -> torch.Tensor:
    """f (..., H, W): f[:, j + 1] - f[:, j], the last column 0."""
    return F.pad(f[..., :, 1:] - f[..., :, :-1], (0, 1))


def forward_dy(f: torch.Tensor) -> torch.Tensor:
    return F.pad(f[..., 1:, :] - f[..., :-1, :], (0, 0, 0, 1))


def _at(img: torch.Tensor, yi: torch.Tensor, xi: torch.Tensor) -> torch.Tensor:
    """img (..., H, W, C) at integer (yi, xi) (..., h, w) inside the image."""
    H, W, C = img.shape[-3:]
    lead = img.shape[:-3]
    flat = img.reshape(lead + (H * W, C))
    idx = (yi.long() * W + xi.long()).reshape(lead + (-1, 1))
    out = torch.gather(flat, -2, idx.expand(lead + (idx.shape[-2], C)))
    return out.reshape(tuple(yi.shape) + (C,))


def bilinear(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor
             ) -> torch.Tensor:
    """img (..., H, W, C) at (x, y) (..., h, w), clamped into the image."""
    H, W = img.shape[-3], img.shape[-2]
    x = x.clamp(0, W - 1)
    y = y.clamp(0, H - 1)
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    dx = (x - x0.to(x.dtype))[..., None]
    dy = (y - y0.to(y.dtype))[..., None]
    x1 = (x0 + 1).clamp(max=W - 1)
    y1 = (y0 + 1).clamp(max=H - 1)
    t00, t10 = _at(img, y0, x0), _at(img, y0, x1)
    t01, t11 = _at(img, y1, x0), _at(img, y1, x1)
    return ((1 - dx) * (1 - dy) * t00 + dx * (1 - dy) * t10
            + (1 - dx) * dy * t01 + dx * dy * t11)


def resize(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Liu's resize of (..., H, W, C) to (h, w): sample at (j + 1) / r - 1."""
    H, W = img.shape[-3], img.shape[-2]
    rx = torch.tensor(w / W, dtype=torch.float32)
    ry = torch.tensor(h / H, dtype=torch.float32)
    x = (torch.arange(w, dtype=torch.float32) + 1.0) / rx - 1.0
    y = (torch.arange(h, dtype=torch.float32) + 1.0) / ry - 1.0
    lead = img.shape[:-3]
    xx = x[None, :].expand(lead + (h, w)).to(img.device)
    yy = y[:, None].expand(lead + (h, w)).to(img.device)
    return bilinear(img, xx, yy)


def warp(im1: torch.Tensor, im2: torch.Tensor, vx: torch.Tensor,
         vy: torch.Tensor) -> torch.Tensor:
    """im2 at (j + vx, i + vy); a pixel whose sample point lies outside the
    image takes im1's value."""
    H, W = im1.shape[-3], im1.shape[-2]
    x = torch.arange(W, dtype=torch.float32, device=vx.device)[None, :] + vx
    y = torch.arange(H, dtype=torch.float32, device=vx.device)[:, None] + vy
    out = (x < 0) | (x > W - 1) | (y < 0) | (y > H - 1)
    return torch.where(out[..., None], im1, bilinear(im2, x, y))


# ---------------------------------------------------------------------------
# pyramid and features
# ---------------------------------------------------------------------------

def level_shapes(h: int, w: int, ratio: float, min_width: int
                 ) -> List[Tuple[int, int]]:
    n_levels = int(math.log(min_width / w) / math.log(ratio))
    return [(h, w)] + [(int(h * ratio ** i), int(w * ratio ** i))
                       for i in range(1, n_levels)]


def pyramid(img: torch.Tensor, ratio: float, min_width: int
            ) -> List[torch.Tensor]:
    shapes = level_shapes(img.shape[-3], img.shape[-2], ratio, min_width)
    base_sigma = 1 / ratio - 1
    n = int(math.log(0.25) / math.log(ratio))
    n_sigma = base_sigma * n
    levels = [img]
    for i in range(1, len(shapes)):
        if i <= n:
            sigma = base_sigma * i
            smooth = gaussian(img, sigma, int(sigma * 3))
        else:
            smooth = gaussian(levels[i - n], n_sigma, int(n_sigma * 3))
        levels.append(resize(smooth, *shapes[i]))
    return levels


def features(img: torch.Tensor) -> torch.Tensor:
    """(..., H, W, 3) RGB -> (gray, d/dx gray, d/dy gray, g - r, g - b)."""
    w = torch.tensor(GRAY, dtype=img.dtype, device=img.device)
    gray = (img * w).sum(-1, keepdim=True)
    return torch.cat([gray, hfilter(gray, DERIV5), vfilter(gray, DERIV5),
                      (img[..., 1] - img[..., 0])[..., None],
                      (img[..., 1] - img[..., 2])[..., None]], dim=-1)


# ---------------------------------------------------------------------------
# one level: IRLS with red-black SOR
# ---------------------------------------------------------------------------

def _neighbour_weights(phi: torch.Tensor):
    """The 5-point stencil's edge weights (west, east, north, south), 0 at
    the image's border: west and north read Phi of that neighbour, east and
    south Phi of the pixel itself."""
    H, W = phi.shape[-2:]
    w_w = F.pad(phi[..., :, :-1], (1, 0))
    w_e = phi * (torch.arange(W, device=phi.device) < W - 1)[None, :]
    w_n = F.pad(phi[..., :-1, :], (0, 0, 1, 0))
    w_s = phi * (torch.arange(H, device=phi.device) < H - 1)[:, None]
    return w_w, w_e, w_n, w_s


def _neighbour_sum(f, w_w, w_e, w_n, w_s):
    return (w_w * F.pad(f[..., :, :-1], (1, 0))
            + w_e * F.pad(f[..., :, 1:], (0, 1))
            + w_n * F.pad(f[..., :-1, :], (0, 0, 1, 0))
            + w_s * F.pad(f[..., 1:, :], (0, 0, 0, 1)))


def red_black_sor(w_w, w_e, w_n, w_s, denom_u, denom_v, b1, b2, imdxy, *,
                  alpha: float, n_sor: int, du=None, dv=None):
    """n_sor red-black SOR iterations on du, dv (zeros when None). For
    each colour: du <- (1 - omega) du + omega / denom_u (b1 - s1), s1 =
    -alpha (weighted neighbour sum of du) + imdxy dv; then dv likewise from
    s2 = -alpha (neighbour sum of dv) + imdxy du with the new du."""
    H, W = w_w.shape[-2:]
    du = torch.zeros_like(w_w) if du is None else du
    dv = torch.zeros_like(w_w) if dv is None else dv
    ii = torch.arange(H, device=w_w.device)[:, None]
    jj = torch.arange(W, device=w_w.device)[None, :]
    red = (ii + jj) % 2 == 0
    odenu = torch.div(torch.full_like(denom_u, OMEGA), denom_u)
    odenv = torch.div(torch.full_like(denom_v, OMEGA), denom_v)
    for _ in range(n_sor):
        for colour in (red, ~red):
            s1 = -alpha * _neighbour_sum(du, w_w, w_e, w_n, w_s) + imdxy * dv
            du = torch.where(colour, (1 - OMEGA) * du + odenu * (b1 - s1), du)
            s2 = -alpha * _neighbour_sum(dv, w_w, w_e, w_n, w_s) + imdxy * du
            dv = torch.where(colour, (1 - OMEGA) * dv + odenv * (b2 - s2), dv)
    return du, dv


def _laplacian(f: torch.Tensor, phi: torch.Tensor) -> torch.Tensor:
    """The Phi-weighted Laplacian of f in divergence form."""
    fh = forward_dx(f) * phi
    fv = forward_dy(f) * phi
    out = -fh - fv
    out = out + F.pad(fh[..., :, :-1], (1, 0))
    return out + F.pad(fv[..., :-1, :], (0, 0, 1, 0))


def smooth_flow(im1f, im2f, warped, u, v, noise, *, alpha: float,
                n_outer: int, n_inner: int, n_sor: int,
                state_dtype: Optional[torch.dtype] = None):
    """n_outer IRLS steps at one level. Returns (u, v, warped, noise)."""
    for _ in range(n_outer):
        s1 = vfilter(hfilter(im1f, SMOOTH5), SMOOTH5)
        s2 = vfilter(hfilter(warped, SMOOTH5), SMOOTH5)
        im = 0.4 * s1 + 0.6 * s2
        imdx, imdy, imdt = hfilter(im, DERIV5), vfilter(im, DERIV5), s2 - s1
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
        for hh in range(n_inner):
            uu = u if hh == 0 else u + du
            vv = v if hh == 0 else v + dv
            ux, uy = forward_dx(uu), forward_dy(uu)
            vx, vy = forward_dx(vv), forward_dy(vv)
            phi = 0.5 / torch.sqrt(ux * ux + uy * uy + vx * vx + vy * vy
                                   + EPS_PHI)
            it = imdt + imdx * du[..., None] + imdy * dv[..., None]
            psi = 1.0 / (2.0 * torch.sqrt(it * it + EPS_PSI))
            psi = psi * (noise[..., None, None, :] >= 1e-20)
            imdxy = torch.mean(psi * imdx * imdy, dim=-1)
            imdx2 = torch.mean(psi * imdx * imdx, dim=-1)
            imdy2 = torch.mean(psi * imdy * imdy, dim=-1)
            imdtdx = torch.mean(psi * imdx * imdt, dim=-1)
            imdtdy = torch.mean(psi * imdy * imdt, dim=-1)
            b1 = -imdtdx - alpha * _laplacian(u, phi)
            b2 = -imdtdy - alpha * _laplacian(v, phi)
            w_w, w_e, w_n, w_s = _neighbour_weights(phi)
            coeff = alpha * (w_w + w_e + w_n + w_s)
            denom_u = imdx2 + alpha * 0.05 + coeff
            denom_v = imdy2 + alpha * 0.05 + coeff
            du, dv = red_black_sor(
                w_w, w_e, w_n, w_s, denom_u, denom_v, b1, b2, imdxy,
                alpha=alpha, n_sor=n_sor, du=None if hh == 0 else du,
                dv=None if hh == 0 else dv)
            if state_dtype is not None:
                du = du.to(state_dtype).float()
                dv = dv.to(state_dtype).float()
        u = u + du
        v = v + dv
        warped = warp(im1f, im2f, u, v)
        diff = torch.abs(im1f - warped)
        valid = (diff > 0) & (diff < 1e6)
        cnt = torch.clamp(valid.sum(dim=(-3, -2)), min=1)
        noise = (diff * valid).sum(dim=(-3, -2)) / cnt
    return u, v, warped, noise


# ---------------------------------------------------------------------------
# the coarse-to-fine solve
# ---------------------------------------------------------------------------

@torch.no_grad()
def coarse_to_fine(im1: torch.Tensor, im2: torch.Tensor, *,
                   alpha: float = 0.005, ratio: float = 0.75,
                   min_width: int = 30, n_outer: int = 5, n_inner: int = 1,
                   n_sor: int = 40, state_dtype: Optional[torch.dtype] = None
                   ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """The flow from im1 to im2, (..., H, W, 3) float32 RGB in [0, 1] on
    one device. Returns (vx, vy, frame 2 warped by the flow), vx the column
    and vy the row flow, each (..., H, W)."""
    if im1.shape != im2.shape or im1.shape[-1] != 3:
        raise ValueError(f"want two (..., H, W, 3) images, got "
                         f"{tuple(im1.shape)} and {tuple(im2.shape)}")
    if ratio > 0.98 or ratio < 0.4:
        ratio = 0.75
    with full_f32():
        im1, im2 = im1.float(), im2.float().to(im1.device)
        pyr1 = pyramid(im1, ratio, min_width)
        pyr2 = pyramid(im2, ratio, min_width)
        lead = tuple(im1.shape[:-3])
        noise = torch.full(lead + (5,), 0.02, dtype=torch.float32,
                           device=im1.device)
        u = v = warped = None
        for k in range(len(pyr1) - 1, -1, -1):
            f1, f2 = features(pyr1[k]), features(pyr2[k])
            h, w = f1.shape[-3], f1.shape[-2]
            if u is None:
                u = torch.zeros(lead + (h, w), dtype=torch.float32,
                                device=f1.device)
                v = torch.zeros_like(u)
                warped = f2
            else:
                u = resize(u[..., None], h, w)[..., 0] * (1 / ratio)
                v = resize(v[..., None], h, w)[..., 0] * (1 / ratio)
                warped = warp(f1, f2, u, v)
            u, v, warped, noise = smooth_flow(
                f1, f2, warped, u, v, noise, alpha=alpha,
                n_outer=n_outer + k, n_inner=n_inner, n_sor=n_sor + 3 * k,
                state_dtype=state_dtype)
        return u, v, warp(im1, im2, u, v).clamp(0.0, 1.0)
