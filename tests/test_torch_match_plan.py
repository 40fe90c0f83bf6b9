"""The launch plan of kernels B2 and B5 (``ops/matching.match_plan``), on
the CPU.

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
serves bf16 and f32. A last group checks, in plain torch, that the
kernels' branch-free online-softmax update gives the twins' bits.
"""

import math
import re

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch.ops import _kernels, matching
from depth_estimation_tpu_torch.ops import matching_experimental as mexp
from depth_estimation_tpu_torch.ops.matching import (BLOCKINGS, NEG_INF,
                                                     _dot_k_order, _middle,
                                                     match_plan, plan_for)

WINDOWS = [(1, 1), (3, 5), (4, 4), (6, 4), (5, 3), (9, 13), (16, 16),
           (20, 7)]
CHANNELS = [1, 3, 10, 17, 32]
# every blocking compiled, at the windows it is timed or used at
ALL_PLANS = [(kc, b, w) for kc, bs in BLOCKINGS.items() for b in bs
             for w in [(1, 1), (3, 5), (16, 16), (20, 7)]]


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


def _row_start(plan, R, maxw):
    """First position of halo row R: R * pitch + R // ry."""
    cols = plan.tx * plan.rx + maxw - 1
    pitch = cols + ((plan.ry * cols) & 1)
    return R * pitch + R // plan.ry


def _check_shape(plan):
    assert plan.tx % (8 // plan.rx) == 0 and plan.ty % plan.rx == 0
    assert plan.tx * plan.ty <= 1024 // (plan.rx * plan.ry)


@pytest.mark.parametrize("maxh,maxw", WINDOWS)
@pytest.mark.parametrize("K", CHANNELS)
def test_halo_fits_shared_memory(maxh, maxw, K):
    plan = match_plan(maxh, maxw, K)
    assert plan is not None
    _check_shape(plan)
    assert plan.smem <= matching.SMEM_LIMIT
    assert (plan.rx, plan.ry) == BLOCKINGS[matching.channel_bound(K)][0]
    # the last position a thread reads lies inside the staged halo
    th, tw = plan.tile
    rows, cols = th + maxh - 1, tw + maxw - 1
    last = _row_start(plan, rows - 1, maxw) + cols - 1
    slot = plan.smem // (4 * (last + 1))
    assert slot * 4 * (last + 1) == plan.smem
    assert slot >= matching.channel_bound(K) + 1 and (slot // 4) % 2 == 1


def test_car_model_plan():
    # car_model's matching core: 16x16 window, K=10, bf16 or f32 storage
    # (both staged as f32): a 32x32 tile of 2x2 pixels a thread, two blocks
    # and 16 warps an SM
    plan = match_plan(16, 16, 10)
    assert plan == matching.MatchPlan(2, 2, 16, 16, plan.smem)
    assert plan.tile == (32, 32)
    assert matching.resident_warps(plan) >= matching.MIN_WARPS
    assert 2 * (plan.smem + 1024) <= matching.SMEM_PER_SM


@pytest.mark.parametrize("maxh,maxw,K", [(64, 64, 32), (64, 64, 1),
                                         (48, 48, 17), (3, 500, 10)])
def test_refuses_what_does_not_fit(maxh, maxw, K):
    assert match_plan(maxh, maxw, K) is None
    for kc, blockings in BLOCKINGS.items():
        if K <= kc:
            for b in blockings:
                assert plan_for(maxh, maxw, K, b) is None


def test_refuses_more_than_32_channels():
    with pytest.raises(ValueError):
        match_plan(4, 4, 33)


def test_plans_are_memoised():
    assert match_plan(16, 16, 10) is match_plan(16, 16, 10)


@pytest.mark.parametrize("H,W", [(1, 1), (3, 5), (7, 31), (9, 33), (2, 63),
                                 (11, 65), (150, 290)])
@pytest.mark.parametrize("kc,blocking,window", ALL_PLANS)
def test_every_pixel_owned_once(H, W, kc, blocking, window):
    plan = plan_for(*window, kc, blocking)
    assert plan is not None
    _check_shape(plan)
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
            pos = _row_start(plan, ty * plan.ry, window[1]) + tx * plan.rx
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
    assert set(BLOCKINGS) == set(matching.KC_BUCKETS)


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
