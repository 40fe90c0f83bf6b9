"""Patch-correlation matching (port of ``depth_estimation_tpu.ops.matching``).

    cost[y, x, dy*maxw + dx] = sum_k (f1[y, x, k] - f2[y+dy, x+dx, k])^2

with ``f1`` the half-window-cropped reference features, so flat index ``d``
is the centered displacement ``(dy - halfh1, dx - halfw1)``.

  * ``match_ssd`` — the full cost volume (plain torch), and its 1-D
    radial form ``match_ssd_radial``.
  * ``match_flow_fused`` — match + softmax + winner-take-all + soft-argmax
    (+ the y-marginal or the 'mean'-head confidence gate) in one pass. On a
    CUDA tensor it launches the hand-written kernel ``csrc/match_fused.cu``
    (kernel B1, the port of the Pallas ``_fused_kernel``); on a CPU tensor
    it runs ``match_flow_fused_plain``, the same arithmetic in plain torch.
  * ``match_flow_fast`` — the same contract without marginal or gate, on
    the norm-decomposed logit ``2<f1, f2> - |f2|^2 - |f1|^2`` with one
    running max over all cells, visited dx-major. On a CUDA tensor it
    launches ``csrc/match_fast.cu`` (kernel B2, the port of the Pallas
    ``_fast_kernel``); on a CPU tensor it runs ``match_flow_fast_plain``.
    ``match_plan`` is the launch's rule on the window and K: the pixels a
    thread computes, the output tile a block stages the halo of, and the
    bands of the window staged one at a time where the whole does not fit;
    ``fused_plan`` is B1's.

Numerics of B1, shared by its kernel and plain version, and with the
reference: features are stored in ``dtype`` (f32, bf16 or f16) and upcast to
f32 before the subtraction; channel sums run in k order; the softmax is
row-local (each dy row keeps its own running max, sum and x-sum, combined
at the end, so the row sums are the y-marginal); WTA is the first-occurrence
argmax of the logit -cost, replaced by the middle (zero-flow) cell when it
ties the best.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, NamedTuple, Optional, Tuple

import torch

from ..utils import debug
from . import _kernels

NEG_INF = -3.4e38
SMEM_LIMIT = 227 * 1024             # shared memory a block may use
SMEM_PER_SM = 228 * 1024            # and an SM holds, 1 KB a block reserved


def match_ssd(f1: torch.Tensor, f2: torch.Tensor, maxh: int, maxw: int,
              dtype=None) -> torch.Tensor:
    """SSD cost volume. f1 (..., H, W, K) reference features (half-window
    cropped), f2 (..., H + maxh - 1, W + maxw - 1, K). ``dtype``: optional
    feature storage type (quantized once; the arithmetic stays f32).
    Returns (..., H, W, maxh * maxw) f32, d = dy * maxw + dx.

    Each cell's sum runs over the channels in k order, in f32. The cells
    are computed together, one channel at a time over f2's (maxh, maxw)
    windows (an ``unfold`` view), so that the work is O(K) tensor ops
    rather than O(maxh maxw K): every cost is the same sum in the same
    order, bit for bit, and a traced program (torch.export) stays small."""
    H = f2.shape[-3] - maxh + 1
    W = f2.shape[-2] - maxw + 1
    if f1.shape[-3:-1] != (H, W):
        raise ValueError(f"shapes {tuple(f1.shape)} / {tuple(f2.shape)} do "
                         f"not match a {maxh}x{maxw} window")
    if dtype is not None:
        f1, f2 = f1.to(dtype), f2.to(dtype)
    # (..., H, W, K, maxh, maxw): cell (dy, dx) of pixel (y, x) reads
    # f2[y + dy, x + dx]
    win = f2.unfold(-3, maxh, 1).unfold(-3, maxw, 1)
    acc = None
    for k in range(f1.shape[-1]):
        d = f1[..., k, None, None].float() - win[..., k, :, :].float()
        sq = d * d
        acc = sq if acc is None else acc + sq
    return acc.reshape(acc.shape[:-2] + (maxh * maxw,))


def match_ssd_radial(f1: torch.Tensor, f2: torch.Tensor, hwin: int) -> torch.Tensor:
    """1-D radial matching (polar space, search along rows only): f2 is
    taller than f1 by hwin - 1. Returns (..., H, W, hwin)."""
    return match_ssd(f1, f2, hwin, 1)


def wta_from_costs(costs: torch.Tensor, mid: int) -> torch.Tensor:
    """Argmin over the window with the middle tie-break: if the zero-flow
    cell attains the min, pick it. costs (..., D) -> int32 (...)."""
    best = torch.argmin(costs, dim=-1).to(torch.int32)
    cmin = torch.amin(costs, dim=-1)
    tie = costs[..., mid] <= cmin
    return torch.where(tie, torch.full_like(best, mid), best)


def softmax_scores(costs: torch.Tensor) -> torch.Tensor:
    """softmax(-cost) over the window dim."""
    return torch.softmax(-costs, dim=-1)


def _middle(maxh: int, maxw: int) -> int:
    return (math.ceil(maxh / 2) - 1) * maxw + (math.ceil(maxw / 2) - 1)


def match_flow_fused_plain(f1, f2, maxh: int, maxw: int, want_marg=False,
                           dtype=torch.float32, want_conf=False,
                           conf_threshold: float = 0.11):
    """Plain-torch twin of the fused kernel: the cost volume, then the
    row-local online softmax and the WTA scan in the kernel's order.
    f1 (B, H, W, K), f2 (B, H + maxh - 1, W + maxw - 1, K)."""
    costs = match_ssd(f1, f2, maxh, maxw, dtype)            # (B, H, W, D)
    halfh1 = math.ceil(maxh / 2) - 1
    halfw1 = math.ceil(maxw / 2) - 1
    mid = _middle(maxh, maxw)
    shape = costs.shape[:-1]
    dev = costs.device
    bi = torch.zeros(shape, dtype=torch.int32, device=dev)
    bm = torch.full(shape, NEG_INF, device=dev)
    lmid = torch.zeros(shape, device=dev)
    m_rows, s_rows, sx_rows = [], [], []
    for dy in range(maxh):
        m = torch.full(shape, NEG_INF, device=dev)
        s = torch.zeros(shape, device=dev)
        sx = torch.zeros(shape, device=dev)
        for dx in range(maxw):
            d = dy * maxw + dx
            l = -costs[..., d]
            better = l > bm
            bi = torch.where(better, torch.full_like(bi, d), bi)
            bm = torch.where(better, l, bm)
            if d == mid:
                lmid = l
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
    idx = torch.where(lmid >= bm, torch.full_like(bi, mid), bi)
    outs = [idx, sy / s, sx / s, torch.exp(bm - m) / s]
    if want_marg:
        outs.append(torch.stack(rows, dim=1) / s[:, None])
    if want_conf:
        mx = rows[0]
        for dy in range(1, maxh):
            mx = torch.maximum(mx, rows[dy])
        outs.append((mx > conf_threshold * s).float())
    return tuple(outs)


# The launch plan of B1 (csrc/match_fused.cu, which holds the same rules).
# The unblocked kernel takes windows of up to FUSED_PASS_ROWS rows at K up
# to FUSED_KC[-1] whose halo fits; the general kernel every other shape, in
# passes of at most FUSED_PASS_ROWS window rows, each in bands of columns.
# Channel counts are rounded up to the listed bounds (the general kernel
# reads K above GENERAL_KC[-1] at run time). A block covers an 8 x 32
# output tile, two pixels a thread.
FUSED_KC = (4, 8, 10, 12, 16, 32)
GENERAL_KC = (8, 16, 32, 64)
FUSED_PASS_ROWS = 16
FUSED_TILE = (8, 32)
FUSED_R = 2


class FusedPlan(NamedTuple):
    general: bool           # the general kernel (passes, bands, scratch)
    block_rows: int         # window rows a pass
    band_cols: int          # window columns a band
    smem: int               # bytes of one staged halo


def _round_up(K: int, bounds) -> Optional[int]:
    return next((kc for kc in bounds if K <= kc), None)


def fused_halo_bytes(kc: int, rows: int, cols: int) -> int:
    """Shared memory of B1's channel-major f2 halo for ``rows`` x ``cols``
    window cells: kc planes of (8 + rows - 1) x (2 * 15 + 2 * pairs) f32,
    pairs = the column pairs a thread walks in a row of ``cols`` cells."""
    pairs = (cols + 2 * FUSED_R - 2) // FUSED_R
    halo_w = FUSED_R * (FUSED_TILE[1] // FUSED_R - 1) + FUSED_R * pairs
    return kc * (FUSED_TILE[0] + rows - 1) * halo_w * 4


@lru_cache(maxsize=None)
def fused_plan(maxh: int, maxw: int, K: int) -> Optional[FusedPlan]:
    """B1's plan for a maxh x maxw window on K channels: the unblocked
    kernel where it takes the shape; else the general kernel on the most
    window rows a pass (at most 16), and on them the widest band of columns,
    whose halo fits in 227 KB. None above FUSED_MAX_CHANNELS channels, where
    not even one cell's halo fits. Memoised."""
    kc = _round_up(K, FUSED_KC)
    if maxh <= FUSED_PASS_ROWS and kc is not None:
        smem = fused_halo_bytes(kc, maxh, maxw)
        if smem <= SMEM_LIMIT:
            return FusedPlan(False, maxh, maxw, smem)
    kc = _round_up(K, GENERAL_KC) or K
    for rows in range(min(FUSED_PASS_ROWS, maxh), 0, -1):
        cols = next((c for c in range(maxw, 0, -1)
                     if fused_halo_bytes(kc, rows, c) <= SMEM_LIMIT), 0)
        if cols:
            return FusedPlan(True, rows, cols, fused_halo_bytes(kc, rows, cols))
    return None


# the most channels B1 takes: one cell's halo, K planes, fills 227 KB
FUSED_MAX_CHANNELS = SMEM_LIMIT // fused_halo_bytes(1, 1, 1)
# the general kernel's window rows a pass that B1's candidates try
FUSED_CANDIDATE_ROWS = (16, 8, 4)


def fused_candidates(maxh: int, maxw: int, K: int) -> List[FusedPlan]:
    """Every plan of B1 worth timing for this window and K (the autotuner's
    candidates, ``ops/autotune.best_plan``): ``fused_plan``'s first, then
    the general kernel on each of FUSED_CANDIDATE_ROWS window rows a pass
    (those within maxh) with the widest band of columns whose halo fits in
    227 KB, and with half of it. Every plan gives the same outputs, bit for
    bit; they differ in speed. Empty above FUSED_MAX_CHANNELS."""
    default = fused_plan(maxh, maxw, K)
    if default is None:
        return []
    kc = _round_up(K, GENERAL_KC) or K
    out = [default]
    for rows in (r for r in FUSED_CANDIDATE_ROWS if r <= maxh):
        widest = next((c for c in range(maxw, 0, -1)
                       if fused_halo_bytes(kc, rows, c) <= SMEM_LIMIT), 0)
        for cols in (widest, widest // 2):
            plan = FusedPlan(True, rows, cols,
                             fused_halo_bytes(kc, rows, cols))
            if cols and plan not in out:
                out.append(plan)
    return out


def _unsupported(name: str, K: int, limit: int) -> RuntimeError:
    return RuntimeError(
        f"{name}: unsupported configuration: K={K} channels; the f2 halo of "
        f"one window cell fits in {SMEM_LIMIT} bytes of shared memory up to "
        f"K={limit}")


def _match_flow_fused_cuda(f1, f2, maxh, maxw, want_marg, dtype, want_conf,
                           conf_threshold, plan=None):
    """Kernel B1 on CUDA tensors, on ``plan`` (default: ``fused_plan``;
    the plan is the same for every storage type, since the halo is staged
    in f32)."""
    f1 = f1.to(dtype).contiguous()
    f2 = f2.to(dtype).contiguous()
    _kernels.check_cuda_tensor("f1", f1, tuple(_kernels.STORAGE), 4)
    _kernels.check_cuda_tensor("f2", f2, tuple(_kernels.STORAGE), 4)
    if f2.device != f1.device:
        raise ValueError("f1 and f2 must be on the same device")
    B, H, W, K = f1.shape
    plan = plan or fused_plan(maxh, maxw, K)
    if plan is None:
        raise _unsupported("match_fused", K, FUSED_MAX_CHANNELS)
    idx = torch.empty((B, H, W), dtype=torch.int32, device=f1.device)
    ey, ex, pmax = (torch.empty((B, H, W), device=f1.device) for _ in range(3))
    extra = scratch = None
    if want_marg:
        extra = torch.empty((B, maxh, H, W), device=f1.device)
    elif want_conf:
        extra = torch.empty((B, H, W), device=f1.device)
    if plan.general:        # each row's (max, sum, x-sum)
        scratch = torch.empty((3, B, maxh, H, W), device=f1.device)
    _kernels.library().call(
        "match_fused_launch", f1.device, f1.data_ptr(), f2.data_ptr(),
        idx.data_ptr(), ey.data_ptr(), ex.data_ptr(), pmax.data_ptr(),
        extra.data_ptr() if extra is not None else None,
        scratch.data_ptr() if scratch is not None else None,
        B, H, W, K, maxh, maxw, plan.block_rows, plan.band_cols,
        _kernels.STORAGE[dtype], int(want_marg), int(want_conf),
        float(conf_threshold))
    _kernels.count_launch(match_flow_fused, f1.device)
    outs = [idx, ey, ex, pmax]
    if extra is not None:
        outs.append(extra)
    return tuple(outs)


# B1 as the operator ``depth_estimation_tpu_torch::match_flow_fused``, so that
# torch.export keeps it as one node of an exported program. The dispatcher
# takes the implementation by the tensors' device: the kernel for CUDA
# tensors, the plain twin for CPU tensors. Its schema is fixed: ``storage``
# is the features' storage code (``_kernels.STORAGE``: 0 f32, 1 bf16, 2
# f16); the fifth output is the y-marginal (``want_marg``), the confidence
# gate (``want_conf``) or an empty tensor. The trailing (general, block_rows,
# band_cols) name the launch plan (a ``FusedPlan``); block_rows 0, the
# default, is ``fused_plan``'s choice. An exported program holds them as
# constants; the plain twin has no plan and ignores them.
_FusedOut = Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor,
                  torch.Tensor]


STORAGE_DTYPES = {code: dt for dt, code in _kernels.STORAGE.items()}


def _storage_dtype(storage: int) -> torch.dtype:
    if storage not in STORAGE_DTYPES:
        raise ValueError(f"storage code {storage}: 0 (f32), 1 (bf16) or 2 "
                         "(f16)")
    return STORAGE_DTYPES[storage]


def _with_extra(outs, like: torch.Tensor) -> _FusedOut:
    if len(outs) == 5:
        return tuple(outs)
    return tuple(outs) + (torch.empty(0, device=like.device),)


def _op_plan(maxh: int, maxw: int, K: int, general: bool, block_rows: int,
             band_cols: int) -> Optional[FusedPlan]:
    """The operator's plan arguments as a ``FusedPlan`` (None: the
    default). The unblocked kernel takes the whole window a pass."""
    if block_rows == 0:
        return None
    if not general and (block_rows, band_cols) != (maxh, maxw):
        raise ValueError(f"the unblocked kernel takes the whole {maxh}x{maxw}"
                         f" window, not {block_rows}x{band_cols}")
    kc = (_round_up(K, GENERAL_KC) or K) if general else _round_up(K, FUSED_KC)
    if kc is None:
        raise ValueError(f"the unblocked kernel takes K <= {FUSED_KC[-1]}")
    return FusedPlan(general, block_rows, band_cols,
                     fused_halo_bytes(kc, block_rows, band_cols))


@torch.library.custom_op("depth_estimation_tpu_torch::match_flow_fused",
                         mutates_args=(), device_types="cpu")
def match_flow_fused_op(f1: torch.Tensor, f2: torch.Tensor, maxh: int,
                        maxw: int, want_marg: bool, storage: int,
                        want_conf: bool, conf_threshold: float,
                        general: bool = False, block_rows: int = 0,
                        band_cols: int = 0) -> _FusedOut:
    """B1 on (B, H, W, K) / (B, H + maxh - 1, W + maxw - 1, K) features:
    (idx, ey, ex, pmax, extra); ``storage`` the feature storage code (0
    f32, 1 bf16, 2 f16); (general, block_rows, band_cols) the launch plan,
    ignored here."""
    return _with_extra(match_flow_fused_plain(
        f1, f2, maxh, maxw, want_marg, _storage_dtype(storage), want_conf,
        conf_threshold), f1)


@match_flow_fused_op.register_kernel("cuda")
def _(f1, f2, maxh, maxw, want_marg, storage, want_conf, conf_threshold,
      general=False, block_rows=0, band_cols=0):
    dtype = _storage_dtype(storage)
    plan = _op_plan(maxh, maxw, f1.shape[-1], general, block_rows, band_cols)
    return _with_extra(_match_flow_fused_cuda(
        f1, f2, maxh, maxw, want_marg, dtype, want_conf, conf_threshold,
        plan), f1)


@match_flow_fused_op.register_fake
def _(f1, f2, maxh, maxw, want_marg, storage, want_conf, conf_threshold,
      general=False, block_rows=0, band_cols=0):
    _storage_dtype(storage)
    B, H, W = f1.shape[:3]
    extra = ((B, maxh, H, W) if want_marg else (B, H, W) if want_conf
             else (0,))
    return (f1.new_empty((B, H, W), dtype=torch.int32),
            *(f1.new_empty((B, H, W), dtype=torch.float32) for _ in range(3)),
            f1.new_empty(extra, dtype=torch.float32))


def match_flow_fused(
    f1: torch.Tensor, f2: torch.Tensor, maxh: int, maxw: int,
    block_rows: int = 8, want_marg: bool = False, dtype=torch.float32,
    want_conf: bool = False, conf_threshold: float = 0.11,
    plan: Optional[FusedPlan] = None,
) -> Tuple[torch.Tensor, ...]:
    """Fused match + decode. f1 ([B,] H, W, K), f2 ([B,] H+maxh-1, W+maxw-1, K).

    Returns (idx, ey, ex, pmax), each ([B,] H, W): int32 WTA flat window
    index (middle tie-break), f32 soft-argmax centered displacements, f32
    softmax probability of the WTA cell. ``want_marg`` appends the
    normalized y-marginal ([B,] maxh, H, W); ``want_conf`` appends the
    'mean'-head confidence gate ([B,] H, W) f32 0/1 (max_dy marginal >
    conf_threshold). The two are mutually exclusive. ``dtype`` is the
    feature storage type (f32, bf16 or f16; anything else raises
    ValueError); accumulation is f32.
    ``block_rows`` is accepted for signature parity with the reference and
    has no effect. The work is the operator ``match_flow_fused_op``: CUDA
    tensors go through kernel B1 (counted in ``match_flow_fused.launches``)
    on ``plan`` (one of ``fused_candidates``; default ``fused_plan``, and
    every plan gives the same outputs): every window, and K up to FUSED_MAX_CHANNELS (227,
    where one window cell's f2 halo fills shared memory; the package's
    configurations use K <= 32), beyond which it raises RuntimeError. CPU
    tensors go through the plain version."""
    if want_marg and want_conf:
        raise ValueError("want_marg and want_conf are mutually exclusive")
    if dtype not in _kernels.STORAGE:
        raise ValueError(f"dtype {dtype}: f32, bf16 or f16 storage")
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
    plan_args = () if plan is None else (
        bool(plan.general), int(plan.block_rows), int(plan.band_cols))
    outs = match_flow_fused_op(f1, f2, maxh, maxw, want_marg,
                               _kernels.STORAGE[dtype], want_conf,
                               float(conf_threshold), *plan_args)
    outs = outs if want_marg or want_conf else outs[:4]
    if squeeze:
        outs = tuple(a[0] for a in outs)
    return outs


match_flow_fused.launches = 0


# ---------------------------------------------------------------------------
# Kernel B2: norm-decomposed matcher
# ---------------------------------------------------------------------------

# The launch plan of B2 and B5 (csrc/match_decomposed.cuh, which holds the
# same rules). Channel counts are rounded up to a compiled bound, and K above
# the largest is taken at run time (bound RUNTIME_K); each bound has the
# (rx, ry) pixel blockings listed here compiled, the first being the one the
# plan takes (the others are there to be timed against it).
KC_BUCKETS = (4, 8, 10, 16, 32, 64)
RUNTIME_K = 0
BLOCKINGS = {4: ((2, 2),), 8: ((2, 2),),
             10: ((2, 2), (4, 2), (4, 1), (2, 1)),
             16: ((2, 2),), 32: ((4, 1),), 64: ((1, 1),), RUNTIME_K: ((1, 1),)}
# output tiles (rows, columns) tried in order: the first whose halo fits
# and leaves MIN_WARPS warps resident on an SM, else the fitting one with
# the most resident warps
TILES = ((32, 32), (16, 32), (16, 16), (8, 16), (8, 8))
MIN_WARPS = 8
# a window whose halo fits on no tile is walked in bands, each band's halo
# within BAND_SMEM so that two blocks share an SM and one stages while the
# other computes (SMEM_LIMIT where even that does not fit)
BAND_SMEM = SMEM_PER_SM // 2 - 1024


class MatchPlan(NamedTuple):
    rx: int                 # output pixels a thread, across
    ry: int                 # and down
    tx: int                 # threads across a tile
    ty: int                 # and down
    smem: int               # bytes of one band's staged halo
    bh: int                 # window rows a band
    bw: int                 # and columns

    @property
    def tile(self) -> Tuple[int, int]:
        return self.ty * self.ry, self.tx * self.rx


def channel_bound(K: int) -> int:
    """K rounded up to a compiled channel bound; RUNTIME_K above the
    largest."""
    return _round_up(K, KC_BUCKETS) or RUNTIME_K


def slot_channels(K: int) -> int:
    """The channels a staged halo position holds besides |f2|^2."""
    return channel_bound(K) or K


def max_threads(kc: int, blocking: Tuple[int, int]) -> int:
    """Threads a block of this bound and blocking may hold: 256 where a
    thread keeps 64 channels or reads them at run time, so that it may use
    255 registers; else 1024 / (rx ry)."""
    if kc in (64, RUNTIME_K):
        return 256
    return 1024 // (blocking[0] * blocking[1])


def halo_bytes(kc: int, ry: int, tile_h: int, tile_w: int, bh: int,
               bw: int) -> int:
    """Shared memory of a tile's f2 halo for a band of bh x bw window cells:
    positions of kc channels and |f2|^2, padded to an odd number of float4s,
    rows of ``cols`` positions at an odd thread-row stride (row R starts at
    R * pitch + R // ry)."""
    rows, cols = tile_h + bh - 1, tile_w + bw - 1
    pitch = cols + ((ry * cols) & 1)
    slot = (((kc + 4) // 4) | 1) * 4
    return ((rows - 1) * pitch + (rows - 1) // ry + cols) * slot * 4


def resident_warps(plan: MatchPlan) -> int:
    """Warps an SM holds at once, by shared memory and thread count."""
    threads = plan.tx * plan.ty
    blocks = min(SMEM_PER_SM // (plan.smem + 1024), 32, 2048 // threads)
    return blocks * threads // 32


def _tiles(K: int, blocking: Tuple[int, int]):
    """The TILES a block of this blocking may cover at K channels."""
    rx, ry = blocking
    cap = max_threads(channel_bound(K), blocking)
    return [(th, tw) for th, tw in TILES if (tw // rx) * (th // ry) <= cap]


def plan_for(maxh: int, maxw: int, K: int, blocking: Tuple[int, int],
             tile: Optional[Tuple[int, int]] = None) -> Optional[MatchPlan]:
    """The plan of one blocking with the whole window in one band, on
    ``tile`` (rows, columns), or by default on the tile TILES' rule picks;
    None where that tile (or every tile) is not one a block of this
    blocking may cover or its halo does not fit in shared memory."""
    kc = slot_channels(K)
    rx, ry = blocking
    best = None
    for th, tw in _tiles(K, blocking):
        if tile is not None and (th, tw) != tuple(tile):
            continue
        smem = halo_bytes(kc, ry, th, tw, maxh, maxw)
        if smem > SMEM_LIMIT:
            continue
        plan = MatchPlan(rx, ry, tw // rx, th // ry, smem, maxh, maxw)
        if resident_warps(plan) >= MIN_WARPS:
            return plan
        if best is None or resident_warps(plan) > resident_warps(best):
            best = plan
    return best


def band_for(maxh: int, maxw: int, K: int, blocking: Tuple[int, int],
             tile: Tuple[int, int], dx_major: bool,
             limit: int) -> Optional[Tuple[int, int]]:
    """The largest band (rows, columns of the window) whose halo on
    ``tile`` fits in ``limit`` bytes and keeps the twin's visit order:
    whole inner lines (columns for dx_major, B2; rows for B5) as many as
    fit, else pieces of one outer line as long as fit; None where not even
    one cell fits."""
    th, tw = tile
    kc, ry = slot_channels(K), blocking[1]
    outer, inner = (maxw, maxh) if dx_major else (maxh, maxw)

    def band(o, i):
        return (i, o) if dx_major else (o, i)

    for o, i in [(o, inner) for o in range(outer, 0, -1)] + \
                [(1, i) for i in range(inner - 1, 0, -1)]:
        if halo_bytes(kc, ry, th, tw, *band(o, i)) <= limit:
            return band(o, i)
    return None


@lru_cache(maxsize=None)
def match_plan(maxh: int, maxw: int, K: int,
               dx_major: bool = True) -> Optional[MatchPlan]:
    """The launch plan of B2 (``dx_major``) or B5 for a maxh x maxw window
    on K channels: the channel bound's first blocking, on the whole window
    (``plan_for``) where a tile's halo holds it, else on the first tile
    with a band (``band_for``) within BAND_SMEM, or within SMEM_LIMIT. None
    above DECOMPOSED_MAX_CHANNELS channels, where not even one cell's halo
    fits (the wrappers then raise). Memoised: a program asks for one window
    again and again."""
    blocking = BLOCKINGS[channel_bound(K)][0]
    plan = plan_for(maxh, maxw, K, blocking)
    if plan is not None:
        return plan
    rx, ry = blocking
    for limit in (BAND_SMEM, SMEM_LIMIT):
        for th, tw in _tiles(K, blocking):
            band = band_for(maxh, maxw, K, blocking, (th, tw), dx_major, limit)
            if band is not None:
                smem = halo_bytes(slot_channels(K), ry, th, tw, *band)
                return MatchPlan(rx, ry, tw // rx, th // ry, smem, *band)
    return None


def fast_candidates(maxh: int, maxw: int, K: int) -> List[MatchPlan]:
    """Every plan of B2 worth timing for this window and K (the autotuner's
    candidates, ``ops/autotune.best_plan``): ``match_plan``'s first, then
    each blocking compiled for K's channel bound (BLOCKINGS) on each tile
    of TILES that a block of it may cover and whose halo, the whole window
    in one band, fits in 227 KB. Every plan gives the same outputs, bit
    for bit; they differ in speed. Empty above DECOMPOSED_MAX_CHANNELS."""
    default = match_plan(maxh, maxw, K)
    if default is None:
        return []
    out = [default]
    for blocking in BLOCKINGS[channel_bound(K)]:
        for tile in TILES:
            plan = plan_for(maxh, maxw, K, blocking, tile)
            if plan is not None and plan not in out:
                out.append(plan)
    return out


def _decomposed_channel_limit() -> int:
    """The most channels with a plan: one cell's halo on the smallest
    tile, at run time, within SMEM_LIMIT."""
    th, tw = TILES[-1]
    K = KC_BUCKETS[-1]
    while halo_bytes(K + 1, 1, th, tw, 1, 1) <= SMEM_LIMIT:
        K += 1
    return K


DECOMPOSED_MAX_CHANNELS = _decomposed_channel_limit()


def _dot_k_order(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """sum_k a * b over the last dim, accumulated in k order in f32."""
    acc = a[..., 0] * b[..., 0]
    for k in range(1, a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def match_flow_fast_plain(f1, f2, maxh: int, maxw: int, dtype=torch.float32):
    """Plain-torch twin of kernel B2, in the kernel's order. f1 (B, H, W,
    K), f2 (B, H + maxh - 1, W + maxw - 1, K), stored in ``dtype`` and
    upcast to f32 before any product. Norms |f1|^2, |f2|^2 and the cross
    term <f1, f2> are summed in k order from the stored values; the logit
    is t = (2 cross - |f2|^2) - |f1|^2. Cells are visited dx outer, dy
    inner, with one running max bm: m = max(bm, t), s = s exp(bm - m) +
    exp(t - m) (and the dy/dx-weighted sums), the WTA index moves where
    t > bm. The middle cell wins where it attains bm; pmax = 1 / s."""
    a = f1.to(dtype).float()
    b = f2.to(dtype).float()
    B, H, W, _ = a.shape
    n1 = _dot_k_order(a, a)
    n2 = _dot_k_order(b, b)
    halfh1 = math.ceil(maxh / 2) - 1
    halfw1 = math.ceil(maxw / 2) - 1
    mid = _middle(maxh, maxw)
    dev = a.device
    shape = (B, H, W)
    s = torch.zeros(shape, device=dev)
    sy = torch.zeros(shape, device=dev)
    sx = torch.zeros(shape, device=dev)
    bi = torch.zeros(shape, dtype=torch.int32, device=dev)
    bm = torch.full(shape, NEG_INF, device=dev)
    tmid = torch.zeros(shape, device=dev)
    for dx in range(maxw):
        for dy in range(maxh):
            d = dy * maxw + dx
            cross = _dot_k_order(a, b[:, dy:dy + H, dx:dx + W])
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


def _match_flow_fast_cuda(f1, f2, maxh, maxw, dtype, plan=None):
    """Kernel B2 on CUDA tensors, on ``plan`` (default: ``match_plan``;
    the plan is the same for every storage type, since the halo is staged
    in f32)."""
    f1 = f1.to(dtype).contiguous()
    f2 = f2.to(dtype).contiguous()
    _kernels.check_cuda_tensor("f1", f1, tuple(_kernels.STORAGE), 4)
    _kernels.check_cuda_tensor("f2", f2, tuple(_kernels.STORAGE), 4)
    if f2.device != f1.device:
        raise ValueError("f1 and f2 must be on the same device")
    B, H, W, K = f1.shape
    plan = plan or match_plan(maxh, maxw, K)
    if plan is None:
        raise _unsupported("match_fast", K, DECOMPOSED_MAX_CHANNELS)
    idx = torch.empty((B, H, W), dtype=torch.int32, device=f1.device)
    ey, ex, pmax = (torch.empty((B, H, W), device=f1.device) for _ in range(3))
    _kernels.library().call(
        "match_fast_launch", f1.device, f1.data_ptr(), f2.data_ptr(),
        idx.data_ptr(), ey.data_ptr(), ex.data_ptr(), pmax.data_ptr(),
        B, H, W, K, maxh, maxw, _kernels.STORAGE[dtype],
        plan.rx, plan.ry, plan.tx, plan.ty, plan.bh, plan.bw)
    _kernels.count_launch(match_flow_fast, f1.device)
    debug.check_outputs("match_flow_fast (kernel B2)", (ey, ex, pmax))
    return idx, ey, ex, pmax


def match_flow_fast(
    f1: torch.Tensor, f2: torch.Tensor, maxh: int, maxw: int,
    block_rows: int = 8, dtype=torch.float32,
    plan: Optional[MatchPlan] = None,
) -> Tuple[torch.Tensor, ...]:
    """Norm-decomposed fused matcher: ``match_flow_fused``'s (idx, ey, ex,
    pmax) contract without marginal or gate. f1 ([B,] H, W, K), f2 ([B,]
    H+maxh-1, W+maxw-1, K); ``dtype`` is the feature storage type (f32,
    bf16 or f16; on CUDA tensors anything else raises ValueError), norms
    and logits stay f32 and come from the stored values.
    Differs from match_flow_fused only at near-exact cost ties, where the
    decomposition rounds apart and the dx-major visit order breaks ties
    differently. ``block_rows`` is accepted for signature parity with the
    reference and has no effect. CUDA tensors go through kernel B2 (counted
    in ``match_flow_fast.launches``) on ``plan`` (one of
    ``fast_candidates``, all of which give the same outputs; default
    ``match_plan``): every window, walked
    in bands where its halo does not fit, and K up to
    DECOMPOSED_MAX_CHANNELS (811, where one window cell's halo on the
    smallest tile fills shared memory; the package's configurations use K
    <= 32), beyond which it raises RuntimeError. CPU tensors go through
    ``match_flow_fast_plain``."""
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
        outs = _match_flow_fast_cuda(f1, f2, maxh, maxw, dtype, plan)
    else:
        outs = match_flow_fast_plain(f1, f2, maxh, maxw, dtype)
    if squeeze:
        outs = tuple(a[0] for a in outs)
    return outs


match_flow_fast.launches = 0
