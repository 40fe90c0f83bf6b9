"""The plain reference of the radial (polar) depth chain, BASELINE config4,
in float32 plain PyTorch.

A frozen copy of the arithmetic the port's radial estimator runs for each
stream, independent of the program it judges: it imports nothing of the
port, of ``jax`` or of the JAX package, and takes nothing the program
made but each stream's smoothed epipole from the step before (the EMA's
state), and, where its own RANSAC winner repeats a point, the program's
pose (see ``pairs``). The benchmark hands it the same frames, weights and
RANSAC noise it hands the program. Every operation acts on each pair
alone; a leading axis holds a block of independent pairs.

Per pair (previous, current) of uint8 frames at the camera's size, after
``radial/test_radial_opticalflow.lua:82-245``:
  1. /255; Shi-Tomasi corners in the previous frame (``online.corners``),
     full-image pyramidal Lucas-Kanade into the current one (``track_lk``:
     3 levels, 15x15 windows, 10 Gauss-Newton steps, each resampling the
     moving patch bilinearly from the whole level), an 8-point essential
     RANSAC on the given Gumbel draws and its pose (``ransac``);
  2. the epipole K T / T_z, scaled to the working size;
  3. its EMA (alpha 0.5) against the stream's last smoothed epipole, the
     last one kept where the new one is out of frame; the bad-frame gate
     on RANSAC's inlier ratio;
  4. both frames resized to the working size (triangle kernel), the
     rotation removed from the previous one (the homography K R K^-1,
     four clamped taps, out of frame zeroed);
  5. the C2P grid about the raw epipole, rmax the distance to the
     farthest corner, the angular axis padded by the trunk's width, and
     the polar warps (four taps, zero out of range);
  6. the trunk (VALID convolutions, 'tanh' where the spec says) on both
     polar frames, the previous one's features cropped by hWin - 1 rows at
     the bottom, the radial SSD as a loop over the hWin rows k (channels
     summed in order), the first argmin;
  7. the P2C grid about the smoothed epipole times k_out, rmax and the
     centre in float64 as the Lua tester's numbers, and the flow warped
     back to cartesian;
  8. flow2depth: d / max(flow, 0.1), infinity where flow < 0.1, zero and
     no confidence within 10 px of the epipole, over infinity = rmax times
     k_infty.
A pair the gate rejects gives zero flow, depth and confidences.

Where it departs from the Lua source, as the JAX package and the port do:
  * the C2P grid is centred on the raw epipole and the P2C grid on the
    smoothed one; the Lua tester smooths first (:173-188);
  * frames are not undistorted (the Lua tester undistorts at load, :90);
  * OpenCV's corners, LK and essential-matrix fit (:96-127) are rebuilt:
    a global stable top-k of peak scores, the LK above, and RANSAC whose
    64 samples of 8 points are Gumbel-max draws with replacement shared
    by every pair, the first sample with the most Sampson inliers
    (< 1e-3) winning, its pose the SVD candidate with the most points in
    front of both views;
  * the epipole is scaled to the working size by the width's ratio on
    both axes;
  * no Farneback baseline (:231-237).

``pairs`` turns TF32 off in cuDNN and cuBLAS (``tf32=True``, the
benchmark's control, turns it on), the previous flags restored after.
"""

from __future__ import annotations

import math
from typing import NamedTuple, Optional, Sequence, Tuple

import torch
import torch.nn.functional as F

from h100bench.reference.online import (_gray, _homog, _in_frame, _normalize,
                                        avg_downsample, bilinear_sample,
                                        corners, homography_grid, resize,
                                        tf32 as tf32_flags)

EMA_ALPHA = 0.5


class Radial(NamedTuple):
    """The configuration: the camera (its size, K, Shi-Tomasi's budget and
    quality, the gate's threshold), the working and polar size, the net
    (its spec with 'tanh' entries, [(weight, bias)] of its convolutions,
    hWin) and k_infty."""
    cam_w: int
    cam_h: int
    K: torch.Tensor
    max_points: int
    quality: float
    bad_threshold: float
    h: int
    w: int
    spec: tuple
    weights: list
    h_win: int
    k_infty: float

    def convs(self):
        return [l for l in self.spec if not isinstance(l, str)]

    @property
    def kernel(self) -> Tuple[int, int]:
        c = self.convs()
        return (sum(l[1] - 1 for l in c) + 1, sum(l[2] - 1 for l in c) + 1)

    @property
    def k_out(self) -> float:
        return (self.h - (self.kernel[0] - 1) // 2 - self.h_win + 1) / self.h


# ---------------------------------------------------------------------------
# ego-motion
# ---------------------------------------------------------------------------

def _patches(img: torch.Tensor, pts: torch.Tensor, win: int) -> torch.Tensor:
    """(win, win) bilinear patches of img (B, H, W) centred on pts (B, N,
    2) as (x, y), clamped corners, rows blended first."""
    B, H, W = img.shape
    off = torch.arange(win, dtype=torch.float32, device=img.device) \
        - (win - 1) / 2.0

    def taps(c, n):
        c = c.clamp(0.0, n - 1.0)
        c0 = torch.floor(c)
        i0 = c0.long()
        return i0, (i0 + 1).clamp(max=n - 1), c - c0
    y0, y1, wy = taps(pts[..., 1, None] + off, H)
    x0, x1, wx = taps(pts[..., 0, None] + off, W)
    flat = img.float().reshape(B, H * W)

    def at(yi, xi):
        lin = yi[..., :, None] * W + xi[..., None, :]
        return torch.gather(flat, 1, lin.reshape(B, -1)).reshape(lin.shape)
    wy = wy[..., :, None]
    wx = wx[..., None, :]
    c0 = (1 - wy) * at(y0, x0) + wy * at(y1, x0)
    c1 = (1 - wy) * at(y0, x1) + wy * at(y1, x1)
    return (1 - wx) * c0 + wx * c1


def track_lk(imgs1, imgs2, pts, win: int = 15, n_levels: int = 3,
             n_iters: int = 10):
    """Full-image pyramidal LK. imgs (B, H, W, 3), pts (B, N, 2) ->
    (pts2, status (B, N): inside the frame by win // 2 + 1, finite)."""
    g1, g2 = _gray(imgs1), _gray(imgs2)
    pyr1, pyr2 = [g1], [g2]
    for _ in range(n_levels - 1):
        pyr1.append(avg_downsample(pyr1[-1][..., None], 2)[..., 0])
        pyr2.append(avg_downsample(pyr2[-1][..., None], 2)[..., 0])
    d = torch.zeros_like(pts)
    for lvl in range(n_levels - 1, -1, -1):
        scale = 2.0 ** lvl
        p = pts / scale
        t = _patches(pyr1[lvl], p, win)
        tx = ((t[..., :, 2:] - t[..., :, :-2]) / 2)[..., 1:-1, :]
        ty = ((t[..., 2:, :] - t[..., :-2, :]) / 2)[..., :, 1:-1]
        a11 = (tx * tx).sum((-2, -1))
        a12 = (tx * ty).sum((-2, -1))
        a22 = (ty * ty).sum((-2, -1))
        det = (a11 * a22 - a12 * a12).clamp(min=1e-8)
        for _ in range(n_iters):
            err = (_patches(pyr2[lvl], p + d / scale, win) - t)[..., 1:-1, 1:-1]
            b1 = (err * tx).sum((-2, -1))
            b2 = (err * ty).sum((-2, -1))
            ddx = -(a22 * b1 - a12 * b2) / det
            ddy = -(-a12 * b1 + a11 * b2) / det
            d = d + torch.stack([ddx, ddy], -1) * scale
    pts2 = pts + d
    H, W = g1.shape[-2:]
    m = win // 2 + 1
    status = ((pts2[..., 0] >= m) & (pts2[..., 0] <= W - 1 - m)
              & (pts2[..., 1] >= m) & (pts2[..., 1] <= H - 1 - m)
              & torch.isfinite(pts2).all(-1))
    return pts2, status


def ransac(pts1, pts2, valid, K, noise, max_dist: float = 1e-3):
    """Essential RANSAC (``online.ransac``'s draws and scores) and the
    winner's pose. Returns (R (B, 3, 3), T (B, 3), inliers, found,
    distinct (B,): false where the winning sample repeats a point, so that
    its E is whichever nullspace vector the QR build returns)."""
    p1n, p2n = _normalize(pts1, K), _normalize(pts2, K)
    B, S = pts1.shape[0], noise.shape[0]
    scores = noise[None] + torch.where(valid, 0.0, -1e9)[:, None, None, :]
    idx = scores.argmax(-1)
    flat = idx.reshape(B, S * 8, 1).expand(B, S * 8, 2)
    q1 = torch.gather(p1n, 1, flat).reshape(B, S, 8, 2)
    q2 = torch.gather(p2n, 1, flat).reshape(B, S, 8, 2)
    x1, y1, x2, y2 = q1[..., 0], q1[..., 1], q2[..., 0], q2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    Q, _ = torch.linalg.qr(A.transpose(-1, -2), mode="complete")
    Es = Q[..., :, 8].reshape(Q.shape[:-2] + (3, 3))
    h1, h2 = _homog(p1n)[:, None], _homog(p2n)[:, None]
    Ex1 = h1 @ Es.transpose(-1, -2)
    Etx2 = h2 @ Es
    num = (h2 * Ex1).sum(-1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
           + Etx2[..., 1] ** 2)
    inls = (((num / den.clamp(min=1e-12)) < max_dist) & valid[:, None]).sum(-1)
    best = inls.argmax(-1)
    bi = torch.arange(B, device=pts1.device)
    win = idx[bi, best].sort(-1).values
    distinct = (win[:, 1:] != win[:, :-1]).all(-1)
    u, _, vt = torch.linalg.svd(Es[bi, best])
    sgn = torch.sign(torch.linalg.det(u @ vt))[..., None, None]
    Wm = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], device=u.device)
    R1, R2 = u @ Wm @ vt * sgn, u @ Wm.T @ vt * sgn
    t = u[..., :, 2]
    Rs = torch.stack([R1, R1, R2, R2], dim=-3)
    ts = torch.stack([t, -t, t, -t], dim=-2)
    Rx1 = h1 @ Rs.transpose(-1, -2)
    q = p2n[:, None]
    a = Rx1[..., :2] - Rx1[..., 2:3] * q
    b = ts[..., None, 2:3] * q - ts[..., None, :2]
    z1 = (a * b).sum(-1) / (a * a).sum(-1).clamp(min=1e-12)
    z2 = z1 * Rx1[..., 2] + ts[..., None, 2]
    pick = ((z1 > 0) & (z2 > 0)).sum(-1).argmax(-1)
    return Rs[bi, pick], ts[bi, pick], inls[bi, best], valid.sum(-1), distinct


# ---------------------------------------------------------------------------
# polar geometry
# ---------------------------------------------------------------------------

def rmax_of(h: int, w: int, e2: torch.Tensor) -> torch.Tensor:
    """floor of the distance from e2 (B, 2) (x, y) to the farthest corner,
    in e2's dtype."""
    ex, ey = e2[:, 0], e2[:, 1]
    d = torch.maximum(
        torch.maximum(ex * ex + ey * ey, (w - ex) ** 2 + ey * ey),
        torch.maximum(ex * ex + (h - ey) ** 2, (w - ex) ** 2 + (h - ey) ** 2))
    return torch.floor(torch.sqrt(d))


def c2p_grid(wsrc: int, hsrc: int, wdst: int, hdst: int, e2: torch.Tensor,
             pad: int) -> torch.Tensor:
    """(B, 2, hdst, wdst + pad) cartesian (y, x) of each polar pixel (i, j):
    e2 + r (sin, cos) of 2 pi j / wdst, r = rmax i / hdst, in float32; the
    angular axis wraps into (pad - 1) // 2 columns before and the rest
    after."""
    rmax = rmax_of(hsrc, wsrc, e2)
    kr = (rmax / torch.tensor(float(hdst), device=e2.device))[:, None, None]
    i = torch.arange(hdst, dtype=torch.float32, device=e2.device)[:, None]
    j = torch.arange(wdst, dtype=torch.float32, device=e2.device)[None, :]
    r = kr * i ** 1.0
    theta = (2 * math.pi / wdst) * j
    g = torch.stack([r * torch.sin(theta) + e2[:, 1, None, None],
                     r * torch.cos(theta) + e2[:, 0, None, None]], dim=1)
    lp = pad // 2
    return torch.cat([g[..., wdst - lp:], g, g[..., :pad - lp]], dim=-1)


def p2c_grid(wsrc: int, hsrc: int, wdst: int, hdst: int, c64: torch.Tensor,
             rmax64: torch.Tensor) -> torch.Tensor:
    """(B, 2, hdst, wdst) polar (row, column) of each cartesian pixel: the
    radius from the centre times hsrc / rmax, its angle in [0, 2 pi) times
    wsrc / 2 pi; the centre and rmax given in float64, each rounded to
    float32 once, as the Lua tester's numbers enter a float tensor."""
    pi2 = 2 * math.pi
    ky = (torch.full_like(rmax64, float(hsrc)) / rmax64).float()
    c = c64.float()
    i = torch.arange(hdst, dtype=torch.float32, device=c.device)[:, None]
    j = torch.arange(wdst, dtype=torch.float32, device=c.device)[None, :]
    x = j - c[:, 0, None, None]
    y = i - c[:, 1, None, None]
    gy = (x * x + y * y) ** 0.5 * ky[:, None, None]
    gx = torch.remainder(torch.atan2(y, x) + pi2, pi2) * (wsrc / pi2)
    return torch.stack([gy, gx], dim=1)


def warp(imgs: torch.Tensor, grid: torch.Tensor) -> torch.Tensor:
    """imgs (B, H, W, C) at grid (B, 2, h, w) (y, x): four taps, each zero
    out of range."""
    H, W = imgs.shape[1], imgs.shape[2]
    gy, gx = grid[:, 0], grid[:, 1]
    y0f, x0f = torch.floor(gy), torch.floor(gx)
    y0, x0 = y0f.long(), x0f.long()
    dy, dx = (gy - y0f)[..., None], (gx - x0f)[..., None]
    b = torch.arange(imgs.shape[0], device=imgs.device)[:, None, None]

    def at(yy, xx):
        v = imgs[b, yy.clamp(0, H - 1), xx.clamp(0, W - 1)]
        return v * ((yy >= 0) & (yy <= H - 1) & (xx >= 0)
                    & (xx <= W - 1))[..., None]
    return ((1 - dy) * (1 - dx) * at(y0, x0) + (1 - dy) * dx * at(y0, x0 + 1)
            + dy * (1 - dx) * at(y0 + 1, x0) + dy * dx * at(y0 + 1, x0 + 1))


# ---------------------------------------------------------------------------
# the net
# ---------------------------------------------------------------------------

def trunk(x: torch.Tensor, spec: Sequence, weights: Sequence) -> torch.Tensor:
    """(B, H, W, C) -> (B, H', W', K): the spec's VALID convolutions in
    order, tanh at each 'tanh'."""
    h = x.permute(0, 3, 1, 2)
    i = 0
    for layer in spec:
        if isinstance(layer, str):
            h = torch.tanh(h)
        else:
            w, b = weights[i]
            h = F.conv2d(h, w, b)
            i += 1
    return h.permute(0, 2, 3, 1).contiguous()


def radial_flow(cfg: Radial, p_prev: torch.Tensor, p_cur: torch.Tensor):
    """WTA radial flow (B, H', W') int32: the first k of the least
    sum_c (f_prev[y, x, c] - f_cur[y + k, x, c])^2 over k < hWin."""
    f1 = trunk(p_prev, cfg.spec, cfg.weights)
    f2 = trunk(p_cur, cfg.spec, cfg.weights)
    H = f1.shape[1] - cfg.h_win + 1
    f1 = f1[:, :H]
    costs = []
    for k in range(cfg.h_win):
        acc = None
        for c in range(f1.shape[-1]):
            d = f1[..., c] - f2[:, k:k + H, :, c]
            acc = d * d if acc is None else acc + d * d
        costs.append(acc)
    return torch.argmin(torch.stack(costs, dim=-1), dim=-1).to(torch.int32)


# ---------------------------------------------------------------------------
# the chain
# ---------------------------------------------------------------------------

def pairs(cfg: Radial, prev_u8: torch.Tensor, cur_u8: torch.Tensor,
          noise: torch.Tensor, e2_last: Optional[torch.Tensor],
          theirs=None, tf32: bool = False) -> dict:
    """``chain`` with cuDNN's and cuBLAS's float32 in full precision, or in
    TF32 with ``tf32``."""
    with tf32_flags(tf32):
        return chain(cfg, prev_u8, cur_u8, noise, e2_last, theirs)


@torch.no_grad()
def chain(cfg: Radial, prev_u8: torch.Tensor, cur_u8: torch.Tensor,
          noise: torch.Tensor, e2_last: Optional[torch.Tensor],
          theirs=None) -> dict:
    """The chain over a block of pairs (B, H, W, 3) uint8. ``e2_last`` (B,
    2): each stream's smoothed epipole before the step (None: the first
    step, which takes the raw one). ``theirs``, the judged side's (R, T,
    inliers, found): where the reference's RANSAC winner repeats a point
    its pose is whichever nullspace vector the QR build returns, so there
    the chain goes on from theirs. Returns flow (B, H', W') int32, depth
    and confs (B, h_out, w_out), e2 (B, 2) smoothed, good (B,), the pose
    it went on from (R, T, inliers, found) and distinct (B,)."""
    dev = prev_u8.device
    K = torch.as_tensor(cfg.K, dtype=torch.float32, device=dev)
    k255 = torch.tensor(255.0, device=dev)
    prev, cur = prev_u8.float() / k255, cur_u8.float() / k255
    pts, pvalid = corners(prev, cfg.max_points, cfg.quality)
    pts2, status = track_lk(prev, cur, pts)
    R, T, inl, found, distinct = ransac(pts, pts2, pvalid & status, K,
                                        noise.float())
    if theirs is not None:
        keep = distinct[:, None]
        R = torch.where(keep[..., None], R, theirs[0].to(R))
        T = torch.where(keep, T, theirs[1].to(T))
        inl = torch.where(distinct, inl, theirs[2].to(inl))
        found = torch.where(distinct, found, theirs[3].to(found))
    e = T @ K.T
    e2 = (e[:, :2] / e[:, 2:3]) * (cfg.w / cfg.cam_w)
    good = (inl.double() / found.double().clamp(min=1)) >= cfg.bad_threshold
    if e2_last is None:
        e2s = e2
    else:
        inside = ((e2[:, 0] >= 0) & (e2[:, 0] < cfg.w)
                  & (e2[:, 1] >= 0) & (e2[:, 1] < cfg.h))
        e2s = torch.where(inside[:, None],
                          EMA_ALPHA * e2 + (1 - EMA_ALPHA) * e2_last, e2_last)

    Ks = K.clone()
    Ks[0] = Ks[0] * (cfg.w / cfg.cam_w)
    Ks[1] = Ks[1] * (cfg.h / cfg.cam_h)
    prev_s, cur_s = resize(prev, cfg.h, cfg.w), resize(cur, cfg.h, cfg.w)
    xs, ys = homography_grid(Ks, R, cfg.h, cfg.w)
    prev_w = bilinear_sample(prev_s, xs, ys) * _in_frame(
        xs, ys, cfg.h, cfg.w)[..., None]
    grid = c2p_grid(cfg.w, cfg.h, cfg.w, cfg.h, e2, cfg.kernel[1] - 1)
    flow = radial_flow(cfg, warp(prev_w, grid), warp(cur_s, grid))

    k_out = cfg.k_out
    h_out, w_out = int(cfg.h * k_out), int(cfg.w * k_out)
    c = e2s.double() * k_out
    rmax = rmax_of(cfg.h, cfg.w, e2s.double()) * k_out
    cart = warp(flow.float()[..., None],
                p2c_grid(flow.shape[2], flow.shape[1], w_out, h_out, c,
                         rmax))[..., 0]
    inf = (rmax_of(h_out, w_out, c) * cfg.k_infty).float()[:, None, None]
    cf = c.float()
    j = torch.arange(w_out, dtype=torch.float32, device=dev)[None, None, :]
    i = torch.arange(h_out, dtype=torch.float32, device=dev)[None, :, None]
    d = torch.sqrt((j - cf[:, 0, None, None]) ** 2
                   + (i - cf[:, 1, None, None]) ** 2)
    depth = torch.where(cart < 0.1, inf.expand_as(cart),
                        d / torch.clamp(cart, min=0.1))
    depth = torch.where(d > 10.0, depth, torch.zeros_like(depth)) / inf
    confs = (d > 10.0).float()
    g = good[:, None, None]
    zero = lambda t: torch.where(g, t, torch.zeros_like(t))
    return dict(flow=zero(flow), depth=zero(depth), confs=zero(confs),
                e2=e2s, good=good, R=R, T=T, inliers=inl, found=found,
                distinct=distinct)
