"""Study matchers (port of ``depth_estimation_tpu.ops.matching_experimental``).

Both satisfy the (idx, ey, ex, pmax) contract of ``ops.matching``'s fused
matchers; no pipeline code imports them.

  * ``match_flow_throughput`` — kernel B2's function with f32 storage and
    the window visited dy-major. On a CUDA tensor it launches the
    hand-written kernel ``csrc/match_throughput.cu`` (kernel B5, the port
    of the Pallas ``_lanes_kernel``), which computes the squared norms
    itself, on ``matching.match_plan`` (dy-major bands); on a CPU tensor it
    computes the norms here and runs ``match_flow_throughput_plain``, the
    same arithmetic in plain torch.
  * ``match_flow_mxu`` — the cost as |f1|^2 + |f2|^2 - 2<f1, f2>, the cross
    terms of each window row as one batched matrix product of a row block
    against the shifted rows, the window's band read off the product, then
    a dense softmax / WTA decode. Plain torch (no kernel).
"""

from __future__ import annotations

import math
from typing import Tuple

import torch

from ..utils import debug
from . import _kernels
from .matching import (DECOMPOSED_MAX_CHANNELS, NEG_INF, _dot_k_order,
                       _middle, _unsupported, match_plan)


# ---------------------------------------------------------------------------
# Kernel B5: the throughput matcher
# ---------------------------------------------------------------------------

def _norms(f1: torch.Tensor, f2: torch.Tensor):
    """f1, f2 cast to f32 and their squared norms summed in k order."""
    a = f1.float()
    b = f2.float()
    return a, b, _dot_k_order(a, a), _dot_k_order(b, b)


def match_flow_throughput_plain(f1, f2, n1, n2, maxh: int, maxw: int):
    """Plain-torch twin of kernel B5, in the kernel's order. f1 (B, H, W, K)
    and f2 (B, H + maxh - 1, W + maxw - 1, K) in f32, n1 (B, H, W) and n2
    (B, H2, W2) their squared norms. Per cell, visited dy outer, dx inner:
    cross = <f1, f2> in k order, t = (2 cross - n2) - n1, one running max
    bm: m = max(bm, t), s = s exp(bm - m) + exp(t - m) (and the dy/dx-
    weighted sums), the WTA index moves where t > bm. The middle cell wins
    where it attains bm; pmax = 1 / s."""
    B, H, W, _ = f1.shape
    halfh1 = math.ceil(maxh / 2) - 1
    halfw1 = math.ceil(maxw / 2) - 1
    mid = _middle(maxh, maxw)
    dev = f1.device
    shape = (B, H, W)
    s = torch.zeros(shape, device=dev)
    sy = torch.zeros(shape, device=dev)
    sx = torch.zeros(shape, device=dev)
    bi = torch.zeros(shape, dtype=torch.int32, device=dev)
    bm = torch.full(shape, NEG_INF, device=dev)
    tmid = torch.zeros(shape, device=dev)
    for dy in range(maxh):
        for dx in range(maxw):
            d = dy * maxw + dx
            cross = _dot_k_order(f1, f2[:, dy:dy + H, dx:dx + W])
            t = 2.0 * cross - n2[:, dy:dy + H, dx:dx + W] - n1
            m_new = torch.maximum(bm, t)
            scale = torch.exp(bm - m_new)
            e = torch.exp(t - m_new)
            s = s * scale + e
            sy = sy * scale + e * (dy - halfh1)
            sx = sx * scale + e * (dx - halfw1)
            bi = torch.where(t > bm, torch.full_like(bi, d), bi)
            bm = m_new
            if d == mid:
                tmid = t
    idx = torch.where(tmid >= bm, torch.full_like(bi, mid), bi)
    return idx, sy / s, sx / s, 1.0 / s


def _match_flow_throughput_cuda(f1, f2, maxh, maxw, plan=None):
    """Kernel B5 on f32 CUDA tensors, on ``plan`` (default:
    ``matching.match_plan``, dy-major); the kernel computes the norms."""
    for name, t in (("f1", f1), ("f2", f2)):
        _kernels.check_cuda_tensor(name, t, (torch.float32,), 4)
    if f2.device != f1.device:
        raise ValueError("f1 and f2 must be on the same device")
    B, H, W, K = f1.shape
    plan = plan or match_plan(maxh, maxw, K, dx_major=False)
    if plan is None:
        raise _unsupported("match_throughput", K, DECOMPOSED_MAX_CHANNELS)
    idx = torch.empty((B, H, W), dtype=torch.int32, device=f1.device)
    ey, ex, pmax = (torch.empty((B, H, W), device=f1.device) for _ in range(3))
    _kernels.library().call(
        "match_throughput_launch", f1.device, f1.data_ptr(), f2.data_ptr(),
        idx.data_ptr(), ey.data_ptr(), ex.data_ptr(), pmax.data_ptr(),
        B, H, W, K, maxh, maxw, plan.rx, plan.ry, plan.tx, plan.ty,
        plan.bh, plan.bw)
    _kernels.count_launch(match_flow_throughput, f1.device)
    debug.check_outputs("match_flow_throughput (kernel B5)", (ey, ex, pmax))
    return idx, ey, ex, pmax


def match_flow_throughput(
    f1: torch.Tensor, f2: torch.Tensor, maxh: int, maxw: int,
    block_rows: int = 8, block_cols: int = 8,
) -> Tuple[torch.Tensor, ...]:
    """Throughput-variant fused matcher: ``match_flow_fast``'s (idx, ey, ex,
    pmax) contract on f32 features. f1 ([B,] H, W, K), f2 ([B,] H+maxh-1,
    W+maxw-1, K). The squared norms are summed in k order, by the kernel
    or, for the twin, here; cells are visited dy-major, so exact
    ties go to the first cell in flat order (the middle cell first, where it
    ties the best). ``block_rows`` and ``block_cols`` are accepted for
    signature parity with the reference and have no effect, except that a
    ``block_cols`` that is not a multiple of 8 raises, as the reference
    does. CUDA tensors go through kernel B5 (counted in
    ``match_flow_throughput.launches``) on ``matching.match_plan``: every
    window, walked in bands of rows where its halo does not fit, and K up to
    DECOMPOSED_MAX_CHANNELS (811; the package's configurations use K <= 32),
    beyond which it raises RuntimeError. CPU tensors go through
    ``match_flow_throughput_plain``."""
    if block_cols % 8:
        raise ValueError(f"block_cols must be a multiple of 8, got {block_cols}")
    squeeze = f1.ndim == 3
    if squeeze:
        f1, f2 = f1[None], f2[None]
    B = f1.shape[0]
    H = f2.shape[1] - maxh + 1
    W = f2.shape[2] - maxw + 1
    if tuple(f1.shape[:3]) != (B, H, W) or f2.shape[0] != B \
            or f2.shape[3] != f1.shape[3]:
        raise ValueError(f"shapes {tuple(f1.shape)} / {tuple(f2.shape)} do "
                         f"not match a {maxh}x{maxw} window")
    if f1.is_cuda:
        outs = _match_flow_throughput_cuda(f1.float().contiguous(),
                                           f2.float().contiguous(), maxh, maxw)
    else:
        outs = match_flow_throughput_plain(*_norms(f1, f2), maxh, maxw)
    if squeeze:
        outs = tuple(o[0] for o in outs)
    return outs


match_flow_throughput.launches = 0


# ---------------------------------------------------------------------------
# Band-matmul variant (plain torch)
# ---------------------------------------------------------------------------

def _band_from_gram(G: torch.Tensor, maxw: int) -> torch.Tensor:
    """G: (..., W, W2) gram matrix, W2 >= W + maxw - 1. Returns
    (..., W, maxw) with band[..., x, dx] = G[..., x, x + dx]: the flat index
    of (x, x + dx) is x (W2 + 1) + dx, so the flattened matrix, padded and
    re-viewed with row stride W2 + 1, has the band as its leading columns."""
    *lead, W, W2 = G.shape
    flat = G.reshape(*lead, W * W2)
    flat = torch.nn.functional.pad(flat, (0, W))
    view = flat.reshape(*lead, W, W2 + 1)
    return view[..., :maxw]


def match_flow_mxu(
    f1: torch.Tensor, f2: torch.Tensor, maxh: int, maxw: int,
    block_rows: int = 8, dtype=torch.bfloat16,
) -> Tuple[torch.Tensor, ...]:
    """Band-matmul matcher with the (idx, ey, ex, pmax) contract. f1 ([B,]
    H, W, K), f2 ([B,] H+maxh-1, W+maxw-1, K). For each block of
    ``block_rows`` rows and each dy, the cross terms against every dx are
    one batched product (rows x K x shifted rows) whose band is read off
    with ``_band_from_gram``; the norms are f32 sums of the f32 inputs.
    ``dtype`` rounds the product's inputs (bf16 by default); the product is
    taken in f32 on the rounded values, as the reference's bf16 product
    with an f32 result type: products of two bf16 values are exact in f32,
    so only the summation order differs. The decode is dense: WTA by first
    argmin with the middle tie-break, softmax(-cost), its expectation and
    its max."""
    squeeze = f1.ndim == 3
    if squeeze:
        f1, f2 = f1[None], f2[None]
    B, H, W, K = f1.shape
    H2, W2 = f2.shape[1], f2.shape[2]
    if H2 != H + maxh - 1 or W2 != W + maxw - 1:
        raise ValueError(f"shapes {tuple(f1.shape)} / {tuple(f2.shape)} do "
                         f"not match a {maxh}x{maxw} window")
    mid = _middle(maxh, maxw)
    halfh1 = math.ceil(maxh / 2) - 1
    halfw1 = math.ceil(maxw / 2) - 1
    dev = f1.device
    off = torch.arange(maxh * maxw, dtype=torch.float32, device=dev)
    off_y = torch.div(off, maxw, rounding_mode="floor") - halfh1
    off_x = torch.remainder(off, maxw) - halfw1

    n1 = (f1.float() ** 2).sum(-1)                          # (B, H, W)
    n2 = (f2.float() ** 2).sum(-1)                          # (B, H2, W2)
    f1c = f1.to(dtype).float()
    f2c = f2.to(dtype).float()

    outs = []
    for y0 in range(0, H, block_rows):
        tb = min(block_rows, H - y0)
        a = f1c[:, y0:y0 + tb]                               # (B, t, W, K)
        na = n1[:, y0:y0 + tb]
        costs = []
        for dy in range(maxh):
            b = f2c[:, y0 + dy:y0 + dy + tb]                 # (B, t, W2, K)
            nb = n2[:, y0 + dy:y0 + dy + tb]
            G = torch.matmul(a, b.transpose(-1, -2))         # (B, t, W, W2)
            band = _band_from_gram(G, maxw)                  # (B, t, W, maxw)
            nb_band = torch.stack([nb[..., dx:dx + W] for dx in range(maxw)],
                                  dim=-1)                    # nb[x + dx]
            costs.append(na[..., None] + nb_band - 2.0 * band)
        c = torch.cat(costs, dim=-1)                         # (B, t, W, D)
        best = torch.argmax(-c, dim=-1).to(torch.int32)
        cmin = torch.amin(c, dim=-1)
        tie = c[..., mid] <= cmin
        idx = torch.where(tie, torch.full_like(best, mid), best)
        p = torch.softmax(-c, dim=-1)
        outs.append((idx, p @ off_y, p @ off_x, torch.amax(p, dim=-1)))
    idx, ey, ex, pmax = (torch.cat(o, dim=1) for o in zip(*outs))
    if squeeze:
        idx, ey, ex, pmax = idx[0], ey[0], ex[0], pmax[0]
    return idx, ey, ex, pmax
