"""The launch plan of kernel B4 (``flow/sor_kernel.sor_plan``), on the CPU.

The CUDA kernel gives CTA r of an image the rows [r * rows, min(H, (r + 1)
* rows)) and places the planes by the plan's mode; these tests hold the
plan to what the kernel needs: every row owned by exactly one CTA, no CTA
without a row, at most MAX_CLUSTER CTAs a cluster, and a CTA's shared
memory within Hopper's 227 KB, at every level of the config2 liu solve and
at sizes that cut strips unevenly or exceed the cluster's shared memory.
"""

import pytest
import torch

from depth_estimation_tpu_torch.flow import celiu, sor_kernel
from depth_estimation_tpu_torch.flow.sor_kernel import (ALL_GLOBAL,
                                                        ALL_SHARED,
                                                        FLOW_SHARED)
from depth_estimation_tpu_torch.ops import _kernels

CONFIG2_LEVELS = [tuple(p.shape[:2]) for p in
                  celiu.build_pyramid(torch.zeros(192, 256, 3), 0.75, 30)]
SHAPES = CONFIG2_LEVELS + [(1, 1), (2, 3), (13, 22), (17, 9), (5, 2001),
                           (3, 4001), (97, 129), (240, 320), (480, 640),
                           (1000, 1000), (1, 100000), (4096, 3)]


def _owners(H, plan):
    """Row -> owning CTA, as the kernel assigns them."""
    owner = [None] * H
    for r in range(plan.cluster):
        r0 = r * plan.rows
        nrows = min(plan.rows, H - r0)
        assert nrows >= 1, f"CTA {r} of {plan} owns no row of {H}"
        for i in range(r0, r0 + nrows):
            assert owner[i] is None
            owner[i] = r
    return owner


@pytest.mark.parametrize("H,W", SHAPES)
def test_every_row_owned_by_exactly_one_cta(H, W):
    plan = sor_kernel.sor_plan(H, W)
    assert 1 <= plan.cluster <= sor_kernel.MAX_CLUSTER
    assert plan.cluster <= H
    owner = _owners(H, plan)
    assert all(o is not None for o in owner)
    assert owner == sorted(owner)           # strips in order, CTA by CTA
    assert sor_kernel.smem_bytes(plan.mode, plan.rows, W) <= sor_kernel.SMEM_LIMIT


def test_config2_levels_keep_their_strips_in_shared_memory():
    assert CONFIG2_LEVELS == [(192, 256), (144, 192), (108, 144), (81, 108),
                              (60, 81), (45, 60), (34, 45)]
    plans = [sor_kernel.sor_plan(H, W) for H, W in CONFIG2_LEVELS]
    # the finest level spreads each image over an 8-CTA cluster (B=8 images
    # on 64 SMs) with du/dv in shared memory; every coarser level keeps all
    # its planes there, and the coarsest fits one CTA
    assert plans[0] == (8, 24, FLOW_SHARED)
    assert all(p.mode == ALL_SHARED for p in plans[1:])
    assert plans[-1].cluster == 1
    assert [p.cluster for p in plans] == sorted(
        (p.cluster for p in plans), reverse=True)
    for (H, W), p in zip(CONFIG2_LEVELS, plans):
        assert sor_kernel.smem_bytes(p.mode, p.rows, W) <= sor_kernel.SMEM_LIMIT
        if p.cluster < sor_kernel.MAX_CLUSTER:
            assert H * W / p.cluster <= 2 * sor_kernel.PX_PER_CTA


@pytest.mark.parametrize("H,W,mode", [(240, 320, FLOW_SHARED),
                                      (3, 4001, FLOW_SHARED),
                                      (480, 640, ALL_GLOBAL),
                                      (1000, 1000, ALL_GLOBAL),
                                      (1, 100000, ALL_GLOBAL)])
def test_large_images_move_planes_out_of_shared_memory(H, W, mode):
    plan = sor_kernel.sor_plan(H, W)
    assert plan.mode == mode
    # no cluster size would hold the strip's coefficient planes
    rows = -(-H // min(sor_kernel.MAX_CLUSTER, H))
    assert sor_kernel.smem_bytes(ALL_SHARED, rows, W) > sor_kernel.SMEM_LIMIT


@pytest.mark.parametrize("mode,rows,W,want", [
    (ALL_SHARED, 12, 256, 4 * (2 * 14 * 256 + 9 * 12 * 256)),
    (FLOW_SHARED, 30, 640, 4 * 2 * 32 * 640),
    (ALL_GLOBAL, 63, 1000, 0)])
def test_smem_bytes(mode, rows, W, want):
    assert sor_kernel.smem_bytes(mode, rows, W) == want


@pytest.mark.parametrize("stem,name", [
    (stem, name) for stem, sigs in _kernels.SIGNATURES.items()
    for name in sigs])
def test_every_c_function_is_exported_by_its_source(stem, name):
    assert f"{stem}.cu" in _kernels.SOURCES
    assert f'extern "C" int {name}(' in (_kernels.CSRC / f"{stem}.cu").read_text()


def test_plans_are_memoised():
    assert sor_kernel.sor_plan(192, 256) is sor_kernel.sor_plan(192, 256)


def test_cpu_planes_run_the_plain_twin():
    g = torch.Generator().manual_seed(0)
    planes = [torch.rand(2, 9, 7, generator=g) + 0.5 for _ in range(9)]
    du, dv = sor_kernel.sor_redblack(*planes, alpha=0.3, n_sor=4)
    ref = celiu.sor_plain(*planes, alpha=0.3, n_sor=4)
    assert torch.equal(du, ref[0]) and torch.equal(dv, ref[1])
