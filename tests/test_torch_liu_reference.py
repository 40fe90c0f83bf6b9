"""The port's batched liu ground truth (``data/groundtruth.liu_flow_batched``,
Ce Liu's solve with the trainer's parameters) against the benchmark's plain
reference ``h100bench/reference/liu.py`` and the per-pair ``liu_flow``, on
the CPU (B4's plain twin in the SOR): the counters of the solve, the
reference's independence, the solve's spans, and the one-device dataset
loader solving its cache misses in batched chunks.

Inputs are smooth seeded textures (white noise is ill-conditioned for the
solver, ``test_torch_celiu.py``) at 48x64 with min_width 25: 3 levels,
5 + 6 + 7 = 18 IRLS steps of 40, 43 and 46 sweeps."""

import ast
import dataclasses
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch.data import datasets, groundtruth
from depth_estimation_tpu_torch.geometry import Geometry
from depth_estimation_tpu_torch.geometry3d import calibration
from depth_estimation_tpu_torch.utils import timer
from h100bench.reference import liu as ref

ROOT = Path(__file__).resolve().parent.parent
KW = dict(alpha=0.005, ratio=0.75, min_width=25, n_outer=5, n_inner=1,
          n_sor=40)
LEVELS, STEPS = 3, 18
# the JAX package's bound between its batched and its single-pair solver
SOLVE_TOL = 1e-4


def smooth_pairs(B, h, w, seed, shift=(1, 2)):
    """(im1, im2) (B, h, w, 3) in [0, 1]: a bilinearly upsampled random
    texture, im2 the same scene moved by ``shift`` (rows, columns)."""
    g = torch.Generator().manual_seed(seed)
    base = torch.rand((B, 3, h // 4 + 2, w // 4 + 2), generator=g)
    base = torch.nn.functional.interpolate(base, (h + 2, w + 2),
                                           mode="bilinear")
    base = base.permute(0, 2, 3, 1)
    dy, dx = shift
    return (base[:, dy:dy + h, dx:dx + w].contiguous(),
            base[:, :h, :w].contiguous())


@pytest.fixture(scope="module")
def solved():
    torch.set_num_threads(2)
    im1, im2 = smooth_pairs(2, 48, 64, seed=4)
    before = dict(timer.COUNTERS)
    vx, vy = groundtruth.liu_flow_batched(im1, im2, **KW)
    counted = {k: timer.COUNTERS[k] - before.get(k, 0)
               for k in ("liu.levels", "liu.irls_steps")}
    return im1, im2, vx, vy, counted


def test_batched_solve_equals_the_reference(solved):
    im1, im2, vx, vy, _ = solved
    rx, ry, warped = ref.coarse_to_fine(im1, im2, **KW)
    assert vx.shape == vy.shape == (2, 48, 64) and vx.dtype == torch.float32
    # the flow is real: the scene moved by (1, 2) px
    assert 1.0 < float(vx.abs().mean()) < 3.0
    # the same operations in the same order: bit for bit
    assert torch.equal(vx, rx) and torch.equal(vy, ry)
    assert warped.shape == im1.shape


def test_batched_solve_equals_per_pair_liu_flow(solved):
    im1, im2, vx, vy, _ = solved
    for b in range(2):
        fy, fx = groundtruth.liu_flow(im1[b].numpy(), im2[b].numpy(),
                                      device="cpu", **KW)
        np.testing.assert_allclose(fx, vx[b].numpy(), rtol=0, atol=SOLVE_TOL)
        np.testing.assert_allclose(fy, vy[b].numpy(), rtol=0, atol=SOLVE_TOL)


def test_counters_read_the_schedule(solved):
    assert solved[4] == {"liu.levels": LEVELS, "liu.irls_steps": STEPS}
    shapes = ref.level_shapes(48, 64, KW["ratio"], KW["min_width"])
    assert len(shapes) == LEVELS
    assert sum(KW["n_outer"] + k for k in range(LEVELS)) == STEPS


def test_reference_control_rounds_the_state(solved):
    """The benchmark's control, a bfloat16 SOR state, moves the flow."""
    im1, im2, vx, _, _ = solved
    bx, _, _ = ref.coarse_to_fine(im1[:1], im2[:1], state_dtype=torch.bfloat16,
                                  **KW)
    gap = float((bx - vx[:1]).abs().max())
    assert 1e-4 < gap < 1.0


def _imports(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            assert node.level == 0, path
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", ["h100bench/reference/liu.py"])
def test_reference_imports_neither_package_nor_jax(path):
    tops = set(_imports(ROOT / path))
    assert tops <= {"__future__", "contextlib", "math", "typing", "numpy",
                    "torch"}, tops
    module = path.removesuffix(".py").replace("/", ".")
    code = (f"import sys; sys.path.insert(0, '.'); import {module};"
            "print(sorted({m.split('.')[0] for m in sys.modules} & "
            "{'jax', 'jaxlib', 'flax', 'depth_estimation_tpu', "
            "'depth_estimation_tpu_torch'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                       capture_output=True, text=True, timeout=120)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip() == "[]"


def test_liu_spans_are_declared_with_their_readers():
    spans = {s.name: s for s in timer.SPANS if s.name.startswith("liu.")}
    assert set(spans) == {"liu.pyramid", "liu.irls", "liu.sor", "liu.warp"}
    assert spans["liu.irls"].reader == "irls_idle_ms.liu"
    assert spans["liu.warp"].reader == "warp_device_ms.liu"
    for s in spans.values():
        assert s.layer.startswith("liu solve")
        if s.reader != timer.BREAKDOWN:
            assert (ROOT / "h100bench/metrics" / f"{s.reader}.py").exists()


# ---------------------------------------------------------------------------
# the one-device loader: cache hits from disk, misses in batched chunks
# ---------------------------------------------------------------------------

H, W = 96, 128
GEOM = Geometry(hImg=32, wImg=40, layers=((3, 5, 5, 8),), maxh=6, maxw=6,
                maxhGT=6, maxwGT=6, hKernelGT=5, wKernelGT=5)


def _calibration():
    base = calibration.RECTIFIED_GOPRO_SMALL
    return dataclasses.replace(
        base, name="t", wImg=W, hImg=H, fx=100.0, fy=100.0, cx=W / 2,
        cy=H / 2, bad_image_threshold=0.0,
        sfm=dataclasses.replace(base.sfm, max_points=128))


def _frames(n):
    """n frames of a camera stepping sideways: each the last moved 2 px."""
    g = torch.Generator().manual_seed(7)
    base = torch.rand((1, 3, H // 8 + 2, W // 8 + 2 + 2 * n), generator=g)
    base = torch.nn.functional.interpolate(
        base, (H, W + 2 * n), mode="bilinear")[0].permute(1, 2, 0).numpy()
    return [np.ascontiguousarray(base[:, 2 * (n - k):2 * (n - k) + W])
            for k in range(n)]


def test_one_device_loader_solves_its_misses_in_batched_chunks(
        tmp_path, monkeypatch):
    calls = []
    solve = groundtruth.liu_flow_batched

    def counted(im1s, im2s, **kw):
        calls.append(im1s.shape[0])
        return solve(im1s, im2s, **kw)
    monkeypatch.setattr(groundtruth, "liu_flow_batched", counted)
    monkeypatch.setattr(datasets, "LIU_CHUNK", 2)
    frames, names = _frames(4), ["a", "b", "c"]
    pairs = datasets.load_rectified_pairs_batched(
        GEOM, _calibration(), frames, cache_root=str(tmp_path), names=names,
        groundtruth="liu", device="cpu")
    assert calls == [2, 1] and all(p.good for p in pairs)
    for p, name in zip(pairs, names):
        fy, fx = groundtruth.liu_flow(p.prev_warped, p.image, device="cpu")
        np.testing.assert_array_equal(p.flow, datasets._quantize(fy, fx))
        z = np.load(groundtruth.liu_cache_path(str(tmp_path), GEOM, 1, name))
        assert z["fy"].shape == z["fx"].shape == (32, 40)
        np.testing.assert_allclose(z["fx"], fx, rtol=0, atol=SOLVE_TOL)
    # a second load reads every pair from the cache and solves nothing
    again = datasets.load_rectified_pairs_batched(
        GEOM, _calibration(), frames, cache_root=str(tmp_path), names=names,
        groundtruth="liu", device="cpu")
    assert calls == [2, 1]
    for a, b in zip(again, pairs):
        np.testing.assert_array_equal(a.flow, b.flow)
