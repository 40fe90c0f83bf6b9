"""The launch plans of kernels B2 and B5 (``ops/matching.match_plan``) and
B1 (``ops/matching.fused_plan``), on the CPU.

``csrc/match_decomposed.cuh`` gives a block a (ty RY) x (tx RX) output
tile, gives thread ``tid`` an RX x RY block of pixels through a lane
mapping that makes each quarter-warp a (8 / RX) x RX patch of threads, and
walks the staged halo columns outer (B2) or rows outer (B5). These tests
mirror those rules in Python, as the kernel applies them, and hold the
plan to what the kernel needs: every output pixel owned by exactly one
thread, the halo within Hopper's 227 KB for every window and channel
count the card tests use, a quarter-warp's 16-byte loads in eight
different bank groups, and every pixel's cells visited in its twin's
order. The staged halo is f32 whatever the storage type, so one plan
serves bf16 and f32. Windows whose halo fits on no tile are walked in
bands, and every band order is held to the twin's visit order. A group
checks, in plain torch, that the kernels' branch-free online-softmax
update gives the twins' bits. The last group holds B1's plan: the
unblocked kernel where it takes the shape, else passes of at most 16
window rows in bands of columns that cover the window once, with the
general kernel's arithmetic (lower index wins an exact tie, rows combined
after the last pass) bit-equal to the twin in plain torch.
"""

import math
import re

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch.ops import _kernels, matching
from depth_estimation_tpu_torch.ops import matching_experimental as mexp
from depth_estimation_tpu_torch.ops.matching import (BLOCKINGS, NEG_INF,
                                                     RUNTIME_K, _dot_k_order,
                                                     _middle, fused_plan,
                                                     match_plan, plan_for)

WINDOWS = [(1, 1), (3, 5), (4, 4), (6, 4), (5, 3), (9, 13), (16, 16),
           (20, 7)]
CHANNELS = [1, 3, 10, 17, 32]
# every blocking compiled, at the windows it is timed or used at (K = 100,
# whose halo holds smaller windows whole, for the run-time channel count)
ALL_PLANS = [(kc or 100, b, w) for kc, bs in BLOCKINGS.items() for b in bs
             for w in ([(1, 1), (3, 5), (16, 16), (20, 7)] if kc else
                       [(1, 1), (3, 5), (7, 5), (9, 4)])]
# shapes whose halo fits on no tile, walked in bands (the first four are
# shapes a plan without bands refused), and channel counts above 32
BANDED = [(64, 64, 32), (64, 64, 1), (48, 48, 17), (3, 500, 10),
          (500, 3, 32), (3, 500, 32), (17, 96, 64), (7, 5, 100)]


def _lane_place(plan, tid):
    """(tx, ty) of thread ``tid``: lanes 8p .. 8p+7 form a (8 / rx) x rx
    patch of threads, patches laid across the tile first, a warp's four
    laid 2 x 2 where the tile's patches come in even rows and columns."""
    pa = 8 // plan.rx
    p, lane = tid >> 3, tid & 7
    across, down = plan.tx // pa, plan.ty // plan.rx
    px, py = p % across, p // across
    if across % 2 == 0 and down % 2 == 0:
        px = (p >> 2) % (across // 2) * 2 + (p & 1)
        py = (p >> 2) // (across // 2) * 2 + ((p >> 1) & 1)
    return px * pa + lane % pa, py * plan.rx + lane // pa


def _row_start(plan, R):
    """First position of halo row R: R * pitch + R // ry."""
    cols = plan.tx * plan.rx + plan.bw - 1
    pitch = cols + ((plan.ry * cols) & 1)
    return R * pitch + R // plan.ry


def _check_shape(plan, K):
    assert plan.tx % (8 // plan.rx) == 0 and plan.ty % plan.rx == 0
    assert plan.tx * plan.ty <= matching.max_threads(
        matching.channel_bound(K), (plan.rx, plan.ry))


def _check_halo(plan, K):
    """The band's halo within 227 KB, and the last position a thread reads
    inside it."""
    assert plan.smem <= matching.SMEM_LIMIT
    th, tw = plan.tile
    rows, cols = th + plan.bh - 1, tw + plan.bw - 1
    last = _row_start(plan, rows - 1) + cols - 1
    slot = plan.smem // (4 * (last + 1))
    assert slot * 4 * (last + 1) == plan.smem
    assert slot >= matching.slot_channels(K) + 1 and (slot // 4) % 2 == 1


@pytest.mark.parametrize("maxh,maxw", WINDOWS)
@pytest.mark.parametrize("K", CHANNELS)
def test_halo_fits_shared_memory(maxh, maxw, K):
    plan = match_plan(maxh, maxw, K)
    assert plan is not None
    _check_shape(plan, K)
    assert (plan.bh, plan.bw) == (maxh, maxw)           # one band
    assert (plan.rx, plan.ry) == BLOCKINGS[matching.channel_bound(K)][0]
    _check_halo(plan, K)


def test_car_model_plan():
    # car_model's matching core: 16x16 window, K=10, bf16 or f32 storage
    # (both staged as f32): one band, a 32x32 tile of 2x2 pixels a thread,
    # two blocks and 16 warps an SM, for B2 and B5 alike
    plan = match_plan(16, 16, 10)
    assert plan == matching.MatchPlan(2, 2, 16, 16, plan.smem, 16, 16)
    assert plan.tile == (32, 32)
    assert match_plan(16, 16, 10, dx_major=False) == plan
    assert matching.resident_warps(plan) >= matching.MIN_WARPS
    assert 2 * (plan.smem + 1024) <= matching.SMEM_PER_SM


def _bands(plan, maxh, maxw, dx_major):
    """The bands (dy0, dx0, rows, columns) in the kernel's order: outer
    lines (columns for B2) band by band, inner pieces within them."""
    outer, inner = (maxw, maxh) if dx_major else (maxh, maxw)
    so, si = (plan.bw, plan.bh) if dx_major else (plan.bh, plan.bw)
    out = []
    for o0 in range(0, outer, so):
        for i0 in range(0, inner, si):
            dy0, dx0 = (i0, o0) if dx_major else (o0, i0)
            out.append((dy0, dx0, min(plan.bh, maxh - dy0),
                        min(plan.bw, maxw - dx0)))
    return out


@pytest.mark.parametrize("dx_major", [True, False])
@pytest.mark.parametrize("maxh,maxw,K", BANDED)
def test_banded_plans_cover_the_window_in_the_twins_order(maxh, maxw, K,
                                                         dx_major):
    assert plan_for(maxh, maxw, K, BLOCKINGS[matching.channel_bound(K)][0]) \
        is None or K > 32
    plan = match_plan(maxh, maxw, K, dx_major)
    assert plan is not None
    _check_shape(plan, K)
    _check_halo(plan, K)
    # a band is whole inner lines, or pieces of one outer line
    if dx_major:
        assert plan.bh == maxh or plan.bw == 1
    else:
        assert plan.bw == maxw or plan.bh == 1
    # every pixel of a thread's block sees every cell once, in the twin's
    # order, band after band
    cells = {(j, q): [] for j in range(plan.ry) for q in range(plan.rx)}
    for dy0, dx0, eh, ew in _bands(plan, maxh, maxw, dx_major):
        for (j, q), seen in _walk(plan.rx, plan.ry, eh, ew, dx_major).items():
            cells[(j, q)] += [(dy0 + dy, dx0 + dx) for dy, dx in seen]
    if dx_major:
        want = [(dy, dx) for dx in range(maxw) for dy in range(maxh)]
    else:
        want = [(dy, dx) for dy in range(maxh) for dx in range(maxw)]
    for seen in cells.values():
        assert seen == want


@pytest.mark.parametrize("K,bound", [(32, 32), (33, 64), (64, 64),
                                     (65, RUNTIME_K), (500, RUNTIME_K)])
def test_channel_counts_above_32(K, bound):
    assert matching.channel_bound(K) == bound
    plan = match_plan(4, 4, K)
    assert (plan.rx, plan.ry) == BLOCKINGS[bound][0]
    _check_shape(plan, K)
    _check_halo(plan, K)


def test_channel_limit():
    # one window cell on the smallest tile: beyond it no plan, and the
    # wrappers raise
    limit = matching.DECOMPOSED_MAX_CHANNELS
    assert limit == 811
    assert match_plan(64, 64, limit) is not None
    assert match_plan(1, 1, limit + 1) is None


def test_plans_are_memoised():
    assert match_plan(16, 16, 10) is match_plan(16, 16, 10)
    assert fused_plan(17, 4, 10) is fused_plan(17, 4, 10)


@pytest.mark.parametrize("H,W", [(1, 1), (3, 5), (7, 31), (9, 33), (2, 63),
                                 (11, 65), (150, 290)])
@pytest.mark.parametrize("kc,blocking,window", ALL_PLANS)
def test_every_pixel_owned_once(H, W, kc, blocking, window):
    plan = plan_for(*window, kc, blocking)
    assert plan is not None
    _check_shape(plan, kc)
    th, tw = plan.tile
    owners = np.zeros((H, W), np.int64)
    for tid in range(plan.tx * plan.ty):
        tx, ty = _lane_place(plan, tid)
        assert 0 <= tx < plan.tx and 0 <= ty < plan.ty
        for by in range(-(-H // th)):
            for bx in range(-(-W // tw)):
                for j in range(plan.ry):
                    for q in range(plan.rx):
                        y = by * th + ty * plan.ry + j
                        x = bx * tw + tx * plan.rx + q
                        assert y < (by + 1) * th and x < (bx + 1) * tw
                        if y < H and x < W:
                            owners[y, x] += 1
    assert (owners == 1).all()


@pytest.mark.parametrize("kc,blocking,window", ALL_PLANS)
def test_quarter_warp_loads_hit_distinct_bank_groups(kc, blocking, window):
    # a 16-byte shared load of a quarter-warp is conflict-free when its
    # eight lanes' addresses fall in eight different 16-byte bank groups
    plan = plan_for(*window, kc, blocking)
    slot4 = (((kc + 4) // 4) | 1)                 # float4s a position
    for q0 in range(0, plan.tx * plan.ty, 8):
        groups = set()
        for tid in range(q0, q0 + 8):
            tx, ty = _lane_place(plan, tid)
            pos = _row_start(plan, ty * plan.ry) + tx * plan.rx
            groups.add((pos * slot4) % 8)
        assert len(groups) == 8


def _walk(rx, ry, maxh, maxw, dx_major):
    """The cells each of a thread's pixels sees, in the kernel's order:
    halo positions (r, c) walked columns outer (dx_major) or rows outer;
    (r, c) is cell (r - j, c - q) of pixel (j, q) where that lies in the
    window."""
    seen = {(j, q): [] for j in range(ry) for q in range(rx)}
    nr, nc = ry + maxh - 1, rx + maxw - 1
    outer, inner = (nc, nr) if dx_major else (nr, nc)
    for o in range(outer):
        for i in range(inner):
            r, c = (i, o) if dx_major else (o, i)
            for (j, q), cells in seen.items():
                if 0 <= r - j < maxh and 0 <= c - q < maxw:
                    cells.append((r - j, c - q))
    return seen


@pytest.mark.parametrize("maxh,maxw", WINDOWS)
@pytest.mark.parametrize("blocking", sorted({b for bs in BLOCKINGS.values()
                                             for b in bs}))
@pytest.mark.parametrize("dx_major", [True, False])
def test_blocked_walk_keeps_the_twins_visit_order(maxh, maxw, blocking,
                                                  dx_major):
    rx, ry = blocking
    if dx_major:       # B2: dx outer, dy inner
        want = [(dy, dx) for dx in range(maxw) for dy in range(maxh)]
    else:              # B5: dy outer, dx inner
        want = [(dy, dx) for dy in range(maxh) for dx in range(maxw)]
    for cells in _walk(rx, ry, maxh, maxw, dx_major).values():
        assert cells == want


def test_compiled_blockings_match_the_plan_table():
    src = (_kernels.CSRC / "match_decomposed.cuh").read_text()
    compiled = {tuple(int(v) for v in m.groups()) for m in
                re.finditer(r"MD_CASE\((\d+), (\d+), (\d+)\)", src)}
    table = {(kc, rx, ry) for kc, bs in BLOCKINGS.items() for rx, ry in bs}
    assert compiled == table
    assert set(BLOCKINGS) == set(matching.KC_BUCKETS) | {RUNTIME_K}


def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    for path in _kernels.CSRC.iterdir():
        (tmp_path / path.name).write_bytes(path.read_bytes())
    monkeypatch.setattr(_kernels, "CSRC", tmp_path)
    before = _kernels._digest()
    header = tmp_path / "match_decomposed.cuh"
    header.write_text(header.read_text() + "\n// edited\n")
    assert _kernels._digest() != before


def _branch_free(f1, f2, maxh, maxw, dx_major):
    """The kernels' per-pixel arithmetic in plain torch: the cells in the
    twin's order, one exp(-|t - m|) a cell, the old sums' factor and the
    cell's weight selected from it and 1, and the middle cell's logit
    computed after the window."""
    a, b = f1.float(), f2.float()
    B, H, W, _ = a.shape
    n1, n2 = _dot_k_order(a, a), _dot_k_order(b, b)
    halfh1, halfw1 = math.ceil(maxh / 2) - 1, math.ceil(maxw / 2) - 1
    mid = _middle(maxh, maxw)
    cells = ([(dy, dx) for dx in range(maxw) for dy in range(maxh)]
             if dx_major else
             [(dy, dx) for dy in range(maxh) for dx in range(maxw)])

    def logit(dy, dx):
        cross = _dot_k_order(a, b[:, dy:dy + H, dx:dx + W])
        return 2.0 * cross - n2[:, dy:dy + H, dx:dx + W] - n1

    bm = torch.full((B, H, W), NEG_INF)
    s, sy, sx = (torch.zeros(B, H, W) for _ in range(3))
    bi = torch.zeros((B, H, W), dtype=torch.int32)
    for dy, dx in cells:
        t = logit(dy, dx)
        up = t > bm
        e = torch.exp(-(t - bm).abs())
        offy, offx = float(dy - halfh1), float(dx - halfw1)
        scale, w = torch.where(up, e, 1.0), torch.where(up, 1.0, e)
        s = s * scale + w
        sy = sy * scale + w * offy
        sx = sx * scale + w * offx
        bm = torch.where(up, t, bm)
        bi = torch.where(up, torch.full_like(bi, dy * maxw + dx), bi)
    tmid = logit(halfh1, halfw1)
    idx = torch.where(tmid >= bm, torch.full_like(bi, mid), bi)
    return idx, sy / s, sx / s, 1.0 / s


@pytest.mark.parametrize("maxh,maxw,K", [(1, 1, 3), (3, 5, 10), (4, 4, 1),
                                         (7, 3, 17)])
@pytest.mark.parametrize("dx_major", [True, False])
def test_branch_free_update_gives_the_twins_bits(maxh, maxw, K, dx_major):
    rng = np.random.RandomState(maxh * 100 + maxw * 10 + K)
    H, W = 5, 6
    f1 = torch.from_numpy(rng.randn(2, H, W, K).astype(np.float32))
    f2 = torch.from_numpy(
        rng.randn(2, H + maxh - 1, W + maxw - 1, K).astype(np.float32))
    # an exact tie between the middle cell and pixel (1, 1)'s own features
    f2[0, 1 + math.ceil(maxh / 2) - 1, 1 + math.ceil(maxw / 2) - 1] = f1[0, 1, 1]
    if dx_major:
        twin = matching.match_flow_fast_plain(f1, f2, maxh, maxw)
    else:
        twin = mexp.match_flow_throughput_plain(*mexp._norms(f1, f2), maxh,
                                                maxw)
    ours = _branch_free(f1, f2, maxh, maxw, dx_major)
    for x, y in zip(ours, twin):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# Kernel B1 (csrc/match_fused.cu): the unblocked kernel where it takes the
# shape, else the general kernel's passes of window rows and bands of
# columns
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("maxh,maxw,K", [(16, 16, 10), (5, 3, 17), (16, 16, 32),
                                         (1, 1, 1), (9, 13, 3), (3, 500, 10)])
def test_fused_plan_keeps_the_unblocked_kernel(maxh, maxw, K):
    plan = fused_plan(maxh, maxw, K)
    kc = next(kc for kc in matching.FUSED_KC if K <= kc)
    assert plan == matching.FusedPlan(False, maxh, maxw,
                                      matching.fused_halo_bytes(kc, maxh, maxw))
    assert plan.smem <= matching.SMEM_LIMIT
    if (maxh, maxw, K) == (16, 16, 10):     # the online program's halo
        assert plan.smem == 10 * (8 + 15) * (2 * 15 + 2 * 9) * 4


FUSED_GENERAL = [(17, 4, 10), (24, 24, 10), (32, 32, 10), (64, 64, 10),
                 (16, 16, 33), (16, 16, 64), (17, 5, 33), (24, 3, 40),
                 (20, 6, 70), (3, 500, 32), (200, 3, 10), (4, 4, 227)]


def _fused_passes(plan, maxh, maxw):
    """The general kernel's (pass, band) visits: (dy0, rows, dx0, cols)."""
    return [(dy0, min(plan.block_rows, maxh - dy0), dx0,
             min(plan.band_cols, maxw - dx0))
            for dy0 in range(0, maxh, plan.block_rows)
            for dx0 in range(0, maxw, plan.band_cols)]


@pytest.mark.parametrize("maxh,maxw,K", FUSED_GENERAL)
def test_fused_plan_passes_and_bands_cover_the_window(maxh, maxw, K):
    plan = fused_plan(maxh, maxw, K)
    assert plan.general
    assert 1 <= plan.block_rows <= min(matching.FUSED_PASS_ROWS, maxh)
    assert 1 <= plan.band_cols <= maxw
    kc = next((kc for kc in matching.GENERAL_KC if K <= kc), K)
    assert plan.smem == matching.fused_halo_bytes(kc, plan.block_rows,
                                                  plan.band_cols)
    assert plan.smem <= matching.SMEM_LIMIT
    # each cell once; each window row's cells in dx order (its online
    # softmax carries across the bands), the rows' passes in dy order
    rows = {}
    for dy0, bh, dx0, bw in _fused_passes(plan, maxh, maxw):
        for dy in range(dy0, dy0 + bh):
            rows.setdefault(dy, []).extend(range(dx0, dx0 + bw))
    assert list(rows) == list(range(maxh))
    assert all(cells == list(range(maxw)) for cells in rows.values())


def test_fused_channel_limit():
    limit = matching.FUSED_MAX_CHANNELS
    assert limit == 227
    assert fused_plan(64, 64, limit) is not None
    assert fused_plan(1, 1, limit + 1) is None


def test_fused_compiled_bounds_match_the_plan_table():
    src = (_kernels.CSRC / "match_fused.cu").read_text()
    unblocked = tuple(int(v) for v in re.findall(r"MF_CASE\((\d+)\)\n", src))
    general = tuple(int(v) for v in re.findall(r"MG_CASE\((\d+)\)\n", src))
    assert unblocked == matching.FUSED_KC
    assert general == matching.GENERAL_KC


def _fused_general(f1, f2, maxh, maxw, plan):
    """The general kernel's arithmetic in plain torch, f32: passes and
    bands in its order, each cell's WTA update with the lower index winning
    an exact tie, the branch-free row softmax carried across bands, the
    rows combined after the last pass as the twin combines them."""
    a, b = f1.float(), f2.float()
    B, H, W, _ = a.shape
    halfh1, halfw1 = math.ceil(maxh / 2) - 1, math.ceil(maxw / 2) - 1
    mid = _middle(maxh, maxw)

    costs = matching.match_ssd(a, b, maxh, maxw)   # each cell in k order

    def logit(dy, dx):
        return -costs[..., dy * maxw + dx]

    bm = torch.full((B, H, W), NEG_INF)
    bi = torch.zeros((B, H, W), dtype=torch.int32)
    rows = {}
    for dy0, bh, dx0, bw in _fused_passes(plan, maxh, maxw):
        for dy in range(dy0, dy0 + bh):
            m, s, sx = rows.get(dy, (torch.full((B, H, W), NEG_INF),
                                     torch.zeros(B, H, W),
                                     torch.zeros(B, H, W)))
            for dx in range(dx0, dx0 + bw):
                l, d = logit(dy, dx), dy * maxw + dx
                better = (l > bm) | ((l == bm) & (d < bi))
                bi = torch.where(better, torch.full_like(bi, d), bi)
                bm = torch.where(better, l, bm)
                up = l > m
                e = torch.exp(-(l - m).abs())
                off = float(dx - halfw1)
                s = torch.where(up, s, 1.0) * e + torch.where(up, 1.0, s)
                sx = torch.where(up, sx, off) * e + torch.where(up, off, sx)
                m = torch.where(up, l, m)
            rows[dy] = (m, s, sx)
    M = rows[0][0]
    for dy in range(1, maxh):
        M = torch.maximum(M, rows[dy][0])
    s, sy, sx = (torch.zeros(B, H, W) for _ in range(3))
    for dy in range(maxh):
        w = torch.exp(rows[dy][0] - M)
        r = rows[dy][1] * w
        s = s + r
        sy = sy + r * (dy - halfh1)
        sx = sx + rows[dy][2] * w
    idx = torch.where(logit(halfh1, halfw1) >= bm, torch.full_like(bi, mid), bi)
    return idx, sy / s, sx / s, torch.exp(bm - M) / s


@pytest.mark.parametrize("maxh,maxw,K,rows,cols", [
    (17, 5, 33, None, None), (7, 5, 3, 3, 2), (5, 6, 4, 16, 1),
    (9, 4, 2, 4, 3)])
def test_fused_general_arithmetic_gives_the_twins_bits(maxh, maxw, K, rows,
                                                        cols):
    # the plan's passes and bands, or smaller ones that split every row
    plan = fused_plan(maxh, maxw, K)
    if rows is not None:
        plan = matching.FusedPlan(True, min(rows, maxh), cols, 0)
    rng = np.random.RandomState(maxh * 10 + maxw)
    H, W = 4, 6
    f1 = torch.from_numpy(rng.randn(2, H, W, K).astype(np.float32))
    f2 = torch.from_numpy(
        rng.randn(2, H + maxh - 1, W + maxw - 1, K).astype(np.float32))
    # exact ties: pixel (0, 0)'s cells (1, 0) and (0, maxw - 1), in
    # different bands, and pixel (1, 1)'s middle cell equal its features
    f2[0, 1, 0] = f1[0, 0, 0]
    f2[0, 0, maxw - 1] = f1[0, 0, 0]
    f2[0, 1 + math.ceil(maxh / 2) - 1, 1 + math.ceil(maxw / 2) - 1] = f1[0, 1, 1]
    twin = matching.match_flow_fused_plain(f1, f2, maxh, maxw)
    ours = _fused_general(f1, f2, maxh, maxw, plan)
    assert ours[0][0, 0, 0].item() == maxw - 1          # the lower index
    for x, y in zip(ours, twin):
        assert torch.equal(x, y)
