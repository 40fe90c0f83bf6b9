"""The plain reference of the online program, in float32 plain PyTorch.

A frozen copy of the port's per-stream arithmetic, independent of the
program it judges: it imports nothing of the port, of ``jax`` or of the
JAX package, and takes nothing the program made (the benchmark hands it
the same frames, weights and RANSAC noise it hands the program).

Per frame pair: uint8 frames -> /255 -> triangle-kernel resize to the
working size -> Brown undistortion (bilinear, out of frame zeroed) ->
conv trunk (VALID convolutions, tanh between layers) -> ego-motion
(Shi-Tomasi corners ranked by a stable sort, window-cached pyramidal
Lucas-Kanade, an 8-point essential-matrix RANSAC whose draws are the
given Gumbel noise, SVD decomposition, cheirality) -> bad-frame gate
(inlier ratio) -> compensation -> the fused matcher's arithmetic (SSD
cost volume; row-local online softmax; WTA; soft-argmax; 'mean'-head
confidence gate) -> mask erosion by the trunk's footprint -> depth.

``batched_pairs`` is ``BatchedDepthEstimator``'s step in 'decode'
compensation (the analytic rotation flow added to the decoded flow), with
ego-motion on frames averaged down by ``ego_downsample``.

Whether cuDNN and cuBLAS run in TF32 is the caller's: ``tf32(on)``.
"""

from __future__ import annotations

import contextlib
import math
from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG_INF = -3.4e38
EPS = 1e-3


@contextlib.contextmanager
def tf32(on: bool):
    """cuDNN's and cuBLAS's f32 operations in TF32 (``on``) or full f32,
    the previous flags restored after."""
    saved = (torch.backends.cudnn.allow_tf32,
             torch.backends.cuda.matmul.allow_tf32)
    torch.backends.cudnn.allow_tf32 = on
    torch.backends.cuda.matmul.allow_tf32 = on
    try:
        yield
    finally:
        torch.backends.cudnn.allow_tf32, \
            torch.backends.cuda.matmul.allow_tf32 = saved


class Camera(NamedTuple):
    """The calibration: intrinsics at the camera's size, 5 distortion
    coefficients, Shi-Tomasi's corner budget and quality, and the bad-frame
    threshold on RANSAC's inlier ratio."""
    w: int
    h: int
    fx: float
    fy: float
    cx: float
    cy: float
    distortion: Tuple[float, ...]
    max_points: int
    quality: float
    bad_threshold: float

    def K(self) -> np.ndarray:
        return np.array([[self.fx, 0.0, self.cx], [0.0, self.fy, self.cy],
                         [0.0, 0.0, 1.0]], np.float32)


def scaled_K(cam: Camera, h: int, w: int) -> np.ndarray:
    K = cam.K().copy()
    K[0] *= w / cam.w
    K[1] *= h / cam.h
    return K


# ---------------------------------------------------------------------------
# prep
# ---------------------------------------------------------------------------

def _resize_operator(n_in: int, n_out: int) -> np.ndarray:
    s = n_out / n_in
    x = (np.arange(n_out) + 0.5) / s - 0.5
    j = np.arange(n_in)
    w = np.maximum(0.0, 1.0 - np.abs(j[None, :] - x[:, None]) * min(s, 1.0))
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def resize(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W, C) -> (B, h, w, C): separable triangle-kernel products."""
    H, W = frames.shape[1:3]
    if (H, W) == (h, w):
        return frames
    R = torch.from_numpy(_resize_operator(H, h)).to(frames.device)
    C = torch.from_numpy(_resize_operator(W, w)).to(frames.device)
    t = torch.einsum("hH,bHWc->bhWc", R, frames)
    return torch.einsum("wW,bhWc->bhwc", C, t)


def _gather_hw(img: torch.Tensor, yy: torch.Tensor, xx: torch.Tensor):
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


def bilinear_sample(img: torch.Tensor, x: torch.Tensor, y: torch.Tensor):
    """img (..., H, W, C) at continuous (x, y) (..., Hs, Ws), clamped
    corners, four taps."""
    x0 = torch.floor(x).to(torch.int32)
    y0 = torch.floor(y).to(torch.int32)
    dx = (x - x0.to(x.dtype)).clamp(0.0, 1.0)[..., None]
    dy = (y - y0.to(y.dtype)).clamp(0.0, 1.0)[..., None]
    return ((1 - dx) * (1 - dy) * _gather_hw(img, y0, x0)
            + dx * (1 - dy) * _gather_hw(img, y0, x0 + 1)
            + (1 - dx) * dy * _gather_hw(img, y0 + 1, x0)
            + dx * dy * _gather_hw(img, y0 + 1, x0 + 1))


def _in_frame(xs, ys, H: int, W: int) -> torch.Tensor:
    return ((xs >= -EPS) & (xs <= W - 1 + EPS)
            & (ys >= -EPS) & (ys <= H - 1 + EPS))


def undistort(img: torch.Tensor, K, dist) -> torch.Tensor:
    """img (..., H, W, C); out-of-range samples are zero."""
    K = torch.as_tensor(K, dtype=torch.float32, device=img.device)
    H, W = img.shape[-3], img.shape[-2]
    fx, fy, cx, cy = K[0, 0], K[1, 1], K[0, 2], K[1, 2]
    j = torch.arange(W, dtype=torch.float32, device=img.device)[None, :]
    i = torch.arange(H, dtype=torch.float32, device=img.device)[:, None]
    x = (j - cx) / fx * torch.ones((H, 1), device=img.device)
    y = (i - cy) / fy * torch.ones((1, W), device=img.device)
    k1, k2, p1, p2, k3 = [float(d) for d in dist]
    r2 = x * x + y * y
    radial = 1 + k1 * r2 + k2 * r2 * r2 + k3 * r2 * r2 * r2
    xd = x * radial + 2 * p1 * x * y + p2 * (r2 + 2 * x * x)
    yd = y * radial + p1 * (r2 + 2 * y * y) + 2 * p2 * x * y
    xs = xd * fx + cx
    ys = yd * fy + cy
    lead = img.shape[:-3]
    out = bilinear_sample(img, xs.expand(lead + (H, W)),
                          ys.expand(lead + (H, W)))
    return out * _in_frame(xs, ys, H, W)[..., None]


def trunk(x: torch.Tensor, weights: Sequence) -> torch.Tensor:
    """(..., H, W, Cin) -> (..., H', W', K): VALID convolutions with tanh
    between layers; ``weights`` [(weight (cout, cin, kh, kw), bias)]."""
    lead = x.shape[:-3]
    h = x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)
    for i, (w, b) in enumerate(weights):
        h = F.conv2d(h, w, b)
        if i != len(weights) - 1:
            h = torch.tanh(h)
    h = h.permute(0, 2, 3, 1).contiguous()
    return h.reshape(tuple(lead) + tuple(h.shape[1:]))


def avg_downsample(img: torch.Tensor, r: int) -> torch.Tensor:
    """Average over non-overlapping r x r blocks. img (..., H, W, C)."""
    if r == 1:
        return img
    *lead, H, W, C = img.shape
    img = img[..., : (H // r) * r, : (W // r) * r, :]
    img = img.reshape(*lead, H // r, r, W // r, r, C)
    return img.mean(dim=(-4, -2))


# ---------------------------------------------------------------------------
# ego-motion
# ---------------------------------------------------------------------------

def _gray(imgs: torch.Tensor) -> torch.Tensor:
    w = torch.tensor([0.299, 0.587, 0.114], dtype=imgs.dtype).tolist()
    p = imgs.float()
    return ((p[..., 0] * w[0] + p[..., 1] * w[1]) + p[..., 2] * w[2]
            ).to(imgs.dtype)


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    H, W = x.shape[-2:]
    p = F.pad(x, (k // 2, k - 1 - k // 2, k // 2, k - 1 - k // 2))
    acc = torch.zeros_like(x)
    for i in range(k):
        for j in range(k):
            acc = acc + p[..., i:i + H, j:j + W]
    return acc


def corners(imgs: torch.Tensor, max_points: int, quality: float,
            min_dist: int = 8, block: int = 5):
    """Shi-Tomasi, the global top ``max_points`` by a stable sort.
    imgs (B, H, W, 3) -> (pts (B, N, 2) as (x, y), valid (B, N))."""
    g = _gray(imgs)
    gx = (F.pad(g[:, :, 2:], (0, 2)) - F.pad(g[:, :, :-2], (2, 0))) / 2
    gy = (F.pad(g[:, 2:, :], (0, 0, 0, 2)) - F.pad(g[:, :-2, :], (0, 0, 2, 0))) / 2
    ixx = _box_sum(gx * gx, block)
    iyy = _box_sum(gy * gy, block)
    ixy = _box_sum(gx * gy, block)
    tr = ixx + iyy
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
    score = torch.where(is_peak, lam, torch.zeros_like(lam)).float()
    vals, flat = torch.sort(score.reshape(B, H * W), dim=-1, descending=True,
                            stable=True)
    vals, flat = vals[:, :max_points], flat[:, :max_points]
    ys = torch.div(flat, W, rounding_mode="floor").float()
    xs = (flat % W).float()
    valid = vals > quality * vals[:, :1].clamp(min=1e-20)
    return torch.stack([xs, ys], dim=-1), valid


def _gather_window(img: torch.Tensor, by, bx, s: int) -> torch.Tensor:
    """(s, s) windows of img (B, H, W) at top-left (by, bx) (B, N),
    replicate-clamped, read from the image rounded to bf16."""
    B, H, W = img.shape
    img = img.to(torch.bfloat16).float()
    k = torch.arange(s, device=img.device)
    rows = (by.long()[..., None] + k).clamp(0, H - 1)
    cols = (bx.long()[..., None] + k).clamp(0, W - 1)
    lin = rows[..., :, None] * W + cols[..., None, :]
    N = by.shape[1]
    out = torch.gather(img.reshape(B, H * W), 1, lin.reshape(B, N * s * s))
    return out.reshape(B, N, s, s)


def _bilin4(w, fy, fx):
    fy = fy[..., None, None]
    fx = fx[..., None, None]
    return ((1 - fy) * (1 - fx) * w[..., :-1, :-1]
            + (1 - fy) * fx * w[..., :-1, 1:]
            + fy * (1 - fx) * w[..., 1:, :-1]
            + fy * fx * w[..., 1:, 1:])


def _axis_weights(coords: torch.Tensor, n: int) -> torch.Tensor:
    c = coords.clamp(0.0, n - 1.0)
    c0 = torch.floor(c)
    w = c - c0
    ii = torch.arange(n, dtype=torch.float32, device=coords.device)
    return ((1.0 - w)[..., None] * (ii == c0[..., None])
            + w[..., None] * (ii == c0[..., None] + 1.0))


def track_lk(imgs1, imgs2, pts, win: int = 15, n_levels: int = 3,
             n_iters: int = 10, search: int = 32):
    """Window-cached pyramidal LK: per level the template and a search
    window are read once per point; Gauss-Newton samples two per-point
    cross-correlation surfaces. -> (pts2 (B, N, 2), status (B, N))."""
    g1, g2 = _gray(imgs1), _gray(imgs2)
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
        t = _bilin4(_gather_window(i1, tby, tbx, win + 1), ty0 - tby, tx0 - tbx)
        tx = ((t[..., :, 2:] - t[..., :, :-2]) / 2)[..., 1:-1, :]
        ty = ((t[..., 2:, :] - t[..., :-2, :]) / 2)[..., :, 1:-1]
        a11 = (tx * tx).sum((-2, -1))
        a12 = (tx * ty).sum((-2, -1))
        a22 = (ty * ty).sum((-2, -1))
        det = a11 * a22 - a12 * a12
        c0 = p_lvl + d / scale
        bx = torch.floor(c0[..., 0]).long() - search // 2
        by = torch.floor(c0[..., 1]).long() - search // 2
        wnd = _gather_window(i2, by, bx, search)

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
            oy = _axis_weights(ly + 1.0, P)
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


def _homog(p):
    return torch.cat([p, torch.ones_like(p[..., :1])], dim=-1)


def _normalize(pts, K):
    K = torch.as_tensor(K, dtype=torch.float32, device=pts.device)
    f = torch.stack([K[0, 0], K[1, 1]])
    c = torch.stack([K[0, 2], K[1, 2]])
    return (pts - c) / f


def ransac(pts1, pts2, valid, K, noise, max_dist: float = 1e-3):
    """Essential RANSAC: each sample's 8 indices are Gumbel-max draws over
    the valid points (``noise`` (S, 8, N) shared by every item); E is the
    nullspace of the 8-point system (last column of a complete QR of
    A^T); the first sample with the most Sampson inliers wins; its R is
    the decomposition with the most points in front of both views.
    Returns (R (B, 3, 3), inliers (B,), found (B,), distinct (B,)):
    ``distinct`` is false where the winning sample repeats a point. Its
    8-point system then has a nullspace of two or more dimensions, E is
    whichever vector of it the QR build returns, and R with it."""
    p1n, p2n = _normalize(pts1, K), _normalize(pts2, K)
    B = pts1.shape[0]
    S = noise.shape[0]
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
    h1 = _homog(p1n)[:, None]
    h2 = _homog(p2n)[:, None]
    Ex1 = h1 @ Es.transpose(-1, -2)
    Etx2 = h2 @ Es
    num = (h2 * Ex1).sum(-1) ** 2
    den = (Ex1[..., 0] ** 2 + Ex1[..., 1] ** 2 + Etx2[..., 0] ** 2
           + Etx2[..., 1] ** 2)
    dist = num / den.clamp(min=1e-12)
    inls = ((dist < max_dist) & valid[:, None]).sum(-1)
    best = inls.argmax(-1)
    bi = torch.arange(B, device=pts1.device)
    win = idx[bi, best].sort(-1).values
    distinct = (win[:, 1:] != win[:, :-1]).all(-1)
    E = Es[bi, best]
    u, _, vt = torch.linalg.svd(E)
    sgn = torch.sign(torch.linalg.det(u @ vt))[..., None, None]
    Wm = torch.tensor([[0.0, -1, 0], [1, 0, 0], [0, 0, 1]], device=E.device)
    R1 = u @ Wm @ vt * sgn
    R2 = u @ Wm.T @ vt * sgn
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
    return Rs[bi, pick], inls[bi, best], valid.sum(-1), distinct


def ego_motion(imgs1, imgs2, K, cam: Camera, noise, lk_iters: int,
               lk_search: int):
    """(R (B, 3, 3), inliers, found, distinct) from frames (B, H, W, 3)."""
    pts, pvalid = corners(imgs1, cam.max_points, cam.quality)
    pts2, status = track_lk(imgs1, imgs2, pts, n_iters=lk_iters,
                            search=lk_search)
    return ransac(pts, pts2, pvalid & status, K, noise)


def good_and_R(R, inliers, found, bad_threshold: float):
    ratio = inliers.float() / torch.clamp(found.float(), min=1.0)
    good = ratio >= bad_threshold
    eye = torch.eye(3, device=R.device).expand(R.shape)
    return good, torch.where(good[:, None, None], R, eye)


def homography_grid(K, R: torch.Tensor, H: int, W: int):
    """Sample coordinates of out(x) = img(K R K^-1 x); R (..., 3, 3)."""
    K = torch.as_tensor(K, dtype=torch.float32, device=R.device)
    Hm = K @ R @ torch.linalg.inv(K)
    xx = torch.arange(W, dtype=torch.float32, device=R.device)[None, :]
    yy = torch.arange(H, dtype=torch.float32, device=R.device)[:, None]
    h = [[Hm[..., a, c, None, None] for c in range(3)] for a in range(3)]
    q = [h[a][0] * xx + h[a][1] * yy + h[a][2] for a in range(3)]
    return q[0] / q[2], q[1] / q[2]


# ---------------------------------------------------------------------------
# match and decode
# ---------------------------------------------------------------------------

def match_ssd(f1, f2, maxh: int, maxw: int) -> torch.Tensor:
    """(..., H, W, maxh maxw) SSD costs, channels summed in k order."""
    win = f2.unfold(-3, maxh, 1).unfold(-3, maxw, 1)
    acc = None
    for k in range(f1.shape[-1]):
        d = f1[..., k, None, None].float() - win[..., k, :, :].float()
        sq = d * d
        acc = sq if acc is None else acc + sq
    return acc.reshape(acc.shape[:-2] + (maxh * maxw,))


def match_mean_head(f1, f2, maxh: int, maxw: int, conf_threshold=0.11):
    """The fused matcher's arithmetic, 'mean' head: (ey, ex, conf) (B, H,
    W): the soft-argmax of a row-local online softmax over the window and
    the gate max_dy(row marginal) > threshold."""
    costs = match_ssd(f1, f2, maxh, maxw)
    halfh1 = math.ceil(maxh / 2) - 1
    halfw1 = math.ceil(maxw / 2) - 1
    shape = costs.shape[:-1]
    dev = costs.device
    m_rows, s_rows, sx_rows = [], [], []
    for dy in range(maxh):
        m = torch.full(shape, NEG_INF, device=dev)
        s = torch.zeros(shape, device=dev)
        sx = torch.zeros(shape, device=dev)
        for dx in range(maxw):
            l = -costs[..., dy * maxw + dx]
            m_new = torch.maximum(m, l)
            alpha = torch.exp(m - m_new)
            p = torch.exp(l - m_new)
            s = s * alpha + p
            sx = sx * alpha + p * (dx - halfw1)
            m = m_new
        m_rows.append(m)
        s_rows.append(s)
        sx_rows.append(sx)
    m = m_rows[0]
    for dy in range(1, maxh):
        m = torch.maximum(m, m_rows[dy])
    s = torch.zeros(shape, device=dev)
    sy = torch.zeros(shape, device=dev)
    sx = torch.zeros(shape, device=dev)
    rows = []
    for dy in range(maxh):
        w = torch.exp(m_rows[dy] - m)
        r = s_rows[dy] * w
        rows.append(r)
        s = s + r
        sy = sy + r * (dy - halfh1)
        sx = sx + sx_rows[dy] * w
    mx = rows[0]
    for dy in range(1, maxh):
        mx = torch.maximum(mx, rows[dy])
    return sy / s, sx / s, (mx > conf_threshold * s).float()


def erode(mask: torch.Tensor, kh: int, kw: int) -> torch.Tensor:
    """(B, H, W) bool: valid only where the whole (kh, kw) window is."""
    inv = 1.0 - mask.float()
    inv = F.pad(inv, (kw // 2, kw - 1 - kw // 2, kh // 2, kh - 1 - kh // 2),
                value=1.0)
    return (1.0 - F.max_pool2d(inv[:, None], (kh, kw), stride=1)[:, 0]) > 0.5


def embed_center(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    H, W = x.shape[-2:]
    hoff, woff = (h - H) // 2, (w - W) // 2
    out = x.new_zeros(x.shape[:-2] + (h, w))
    out[..., hoff:hoff + H, woff:woff + W] = x
    return out


def depth_rule(xflow: torch.Tensor, w_img: int) -> torch.Tensor:
    """|x - cx| / max(|flow|, 0.1), infinite where |flow| < 0.1."""
    cx = w_img / 2.0
    j = torch.arange(w_img, dtype=torch.float32, device=xflow.device)[None, None, :]
    a = torch.abs(xflow)
    return torch.where(a < 0.1, torch.full_like(a, float("inf")),
                       torch.abs(j - cx) / torch.clamp(a, min=0.1))


class Model(NamedTuple):
    """A single-scale flow model: its trunk (layers and weights on the
    device), working size and search window."""
    layers: tuple
    weights: list
    h: int
    w: int
    maxh: int
    maxw: int

    @property
    def kernel(self) -> Tuple[int, int]:
        return (sum(l[1] - 1 for l in self.layers) + 1,
                sum(l[2] - 1 for l in self.layers) + 1)

    @property
    def halves(self) -> Tuple[int, int, int, int]:
        """(top, bottom, left, right) crop of the reference branch."""
        return (math.ceil(self.maxh / 2) - 1, self.maxh // 2,
                math.ceil(self.maxw / 2) - 1, self.maxw // 2)

    def crop(self, f: torch.Tensor) -> torch.Tensor:
        t, b, l, r = self.halves
        return f[..., t:f.shape[-3] - b, l:f.shape[-2] - r, :]


def prep(model: Model, cam: Camera, frames_u8: torch.Tensor):
    """uint8 (B, H, W, 3) -> (undistorted working frames, features)."""
    x = resize(frames_u8.float() / 255.0, model.h, model.w)
    u = undistort(x, scaled_K(cam, model.h, model.w), cam.distortion)
    return u, trunk(u, model.weights)


@torch.no_grad()
def batched_pairs(model: Model, cam: Camera, frames1, frames2, noise,
                  ego_downsample: int, lk_iters: int, lk_search: int,
                  theirs=None):
    """``BatchedDepthEstimator``'s step over pairs (B, H, W, 3) uint8, in
    'decode' compensation and the 'mean' head, f32 storage. Returns a dict:
    xflow, mask, depth (B, h, w), good (B,), R (B, 3, 3) before the gate,
    inliers, found, distinct (B,): see ``ransac``.

    ``theirs``, the (R, inliers, found) of the side being judged: where the
    reference's RANSAC winner repeats a point its R is whichever nullspace
    vector the QR build returns, so there the step goes on from theirs
    (and ``distinct`` says where it did not)."""
    Ks = scaled_K(cam, model.h, model.w)
    u1, f1 = prep(model, cam, frames1)
    u2, f2 = prep(model, cam, frames2)
    r = ego_downsample
    K_ego = Ks.copy()
    K_ego[:2] /= r
    R, inl, found, distinct = ego_motion(
        avg_downsample(u1, r), avg_downsample(u2, r), K_ego, cam, noise,
        lk_iters, lk_search)
    if theirs is not None:
        R_o, inl_o, found_o = theirs
        R = torch.where(distinct[:, None, None], R, R_o.to(R.dtype))
        inl = torch.where(distinct, inl, inl_o.to(inl.dtype))
        found = torch.where(distinct, found, found_o.to(found.dtype))
    R_raw = R
    good, R = good_and_R(R, inl, found, cam.bad_threshold)
    Hf, Wf = f1.shape[1], f1.shape[2]
    dxs, dys = homography_grid(Ks, R, Hf, Wf)
    jgrid = torch.arange(Wf, dtype=torch.float32, device=R.device)[None, None, :]
    igrid = torch.arange(Hf, dtype=torch.float32, device=R.device)[None, :, None]
    rot_x = dxs - jgrid
    rot_y = dys - igrid
    t, b, l, rr = model.halves
    margin_y = min(t, b) - 1
    margin_x = min(l, rr) - 1
    wmask = ((torch.abs(rot_y) <= margin_y)
             & (torch.abs(rot_x) <= margin_x)).float()
    _, x, conf = match_mean_head(model.crop(f1), f2, model.maxh, model.maxw)
    H, W = x.shape[1:]
    x = x + rot_x[:, t:t + H, l:l + W]
    xflow = embed_center(x, model.h, model.w)
    m = erode(wmask[:, t:t + H, l:l + W] > 0.5, *model.kernel)
    mask = embed_center(m.float(), model.h, model.w) \
        * embed_center(conf, model.h, model.w)
    keep = good[:, None, None]
    xflow = torch.where(keep, xflow, torch.zeros_like(xflow))
    mask = torch.where(keep, mask, torch.zeros_like(mask))
    return dict(xflow=xflow, mask=mask, depth=depth_rule(xflow, model.w),
                good=good, R=R_raw, inliers=inl, found=found,
                distinct=distinct)
