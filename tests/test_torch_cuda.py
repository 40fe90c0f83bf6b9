"""The port's CUDA kernels against their plain PyTorch twins, on the card.

Shapes here are chosen to reach the kernels' edges rather than the main
paths' shapes (``chip_smoke.py`` covers those): ragged output tiles,
channel counts between the compiled sizes, non-square and 16-row windows,
bands of 0 and 1, taps on the image border, f32, bf16 and f16 storage
(and the refusal of any other type), B3's rows cut inside a CTA's
segment at C = 1 to 17, 1x1 and odd SOR images, 0, 1 and 40 SOR
iterations, leading batch dims, B2 and B5 at K = 1 to 100, 1x1 to 64x64,
B2 at the version2 cell's K = 32 on a 17x17 window,
3x500 and 500x3 windows (walked in bands where the halo does not fit),
batches of 1 and 130, widths that cut a thread's pixel block or a tile,
every compiled pixel blocking, and launch plans the kernels refuse; B1's
general kernel at 17 to 32 window rows, 33 to 70 channels and column
bands, with an exact tie across two bands.
B4's cluster partitions are held at every level shape of a config2 solve,
at strips cut unevenly, at images shorter than a cluster, at images whose
planes (240x320) or flows (480x640, 1000x1000) exceed the cluster's
shared memory, and on stale memory from the allocator, with its barrier
probe in every mode; B1's two pixels a thread at widths that cut a
thread's pair and at images smaller than one tile. The training slice
has no kernel of its own: its trainers (3 criteria, and the multiscale
trainer) are held card vs CPU, and the 'liu' GT of a pair loader is held
to launch B4; the batched liu GT at the benchmark cell's shapes launches
B4 68 times, the liu warp kernel 76 times and its resize 28 times, and
equals the plain reference on the card. The liu warp kernel and its
resize equal their twins bit for bit (the noise estimate within 1e-5) at
every level of the cell's pyramid, at ragged widths and 1 to 5 channels,
past every edge of the image, with NaN flows, on identical frames and on
stale memory. B1 and B3 pass
``torch.library.opcheck`` as operators on CUDA tensors, and a loaded
flow-forward artifact launches B1 once a call and equals the live
forward. The peak meter's P1 (FMA and exp chains) and P2 (1 to 8
logistic chains, at full occupancy and at 4 warps an SM) equal their twins
at sizes below, at and beyond one value a thread of the card.
The shared CUDA-graph cache's two users, RANSAC's complete QR and the liu
solve's IRLS planes, replay eager's bits and layout over replays with new
contents (the QR at the online program's shape, at B=1, S=64 and at an odd
B), capture each shape up to the process cache's bound and run eagerly
past it, serve threads sharing a cache, and stay eager inside a caller's
capture and for a new key under a profiler. The QR in 32 slices equals it
in one chain; the IRLS planes equal eager's over whole solves (gmm with
bicubic warps: a capture a level), and the 'lap' solve through the IRLS
kernel (``flow/liu_irls``) equals the eager solve (180x320, B=2 and 64,
the trainer's schedule: 68 kernel launches a solve, no graph).
Every test skips without a CUDA card. This file imports no jax, so it also runs where
jax is absent:

    python -m pytest --noconftest tests/test_torch_cuda.py -q
"""

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch.ops import matching, warp

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda:0")


def _features(dev, H, W, K, maxh, maxw, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    f1 = 0.5 * torch.randn(2, H, W, K, generator=g, device=dev)
    f2 = 0.5 * torch.randn(2, H + maxh - 1, W + maxw - 1, K, generator=g,
                           device=dev)
    return f1, f2


@pytest.mark.parametrize("mode", ["plain", "marg", "conf"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("K", [3, 10, 17])
@pytest.mark.parametrize("maxh,maxw", [(4, 4), (5, 3), (9, 13), (16, 16)])
def test_match_fused_kernel_matches_plain(dev, maxh, maxw, K, dt, mode):
    H, W = 13, 37                      # ragged against the 8x32 output tile
    f1, f2 = _features(dev, H, W, K, maxh, maxw, seed=maxh * 100 + K)
    marg, conf = mode == "marg", mode == "conf"
    n0 = matching.match_flow_fused.launches
    got = matching.match_flow_fused(f1, f2, maxh, maxw, 8, marg, dt, conf)
    assert matching.match_flow_fused.launches == n0 + 1
    ref = matching.match_flow_fused_plain(f1, f2, maxh, maxw, marg, dt, conf)
    torch.cuda.synchronize()
    assert len(got) == len(ref) == (4 if mode == "plain" else 5)
    assert got[0].dtype == torch.int32 and tuple(got[0].shape) == (2, H, W)
    # same arithmetic in the same order; only the exp implementations
    # differ, so WTA indices agree except at exact-cost near-ties
    costs = matching.match_ssd(f1, f2, maxh, maxw, dt)
    top2 = torch.topk(-costs, 2, dim=-1).values
    flip = got[0] != ref[0]
    assert bool(((top2[..., 0] - top2[..., 1])[flip] < 1e-5).all())
    for a, b in zip(got[1:4], ref[1:4]):
        assert (a - b).abs().max().item() <= 1e-5
    if marg:
        assert tuple(got[4].shape) == (2, maxh, H, W)
        assert (got[4] - ref[4]).abs().max().item() <= 1e-5
    if conf:
        # the gate may differ only where the marginal's peak sits on the
        # threshold
        m = matching.match_flow_fused_plain(f1, f2, maxh, maxw, True, dt)[4]
        near = ((m.amax(dim=1) - 0.11).abs() <= 1e-5)
        assert bool(near[got[4] != ref[4]].all())


# shapes beyond the unblocked kernel: more than 16 window rows, more than 32
# channels (64 and above at run time), halos beyond shared memory
GENERAL_FUSED = [(17, 4, 10), (24, 24, 10), (32, 32, 3), (4, 4, 33),
                 (16, 16, 64), (20, 6, 70), (3, 70, 40)]


@pytest.mark.parametrize("mode", ["plain", "marg", "conf"])
@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("maxh,maxw,K", GENERAL_FUSED)
def test_match_fused_kernel_general_shapes_match_plain(dev, maxh, maxw, K, dt,
                                                       mode):
    assert matching.fused_plan(maxh, maxw, K).general
    H, W = 9, 37                       # two tiles across, one cut
    f1, f2 = _features(dev, H, W, K, maxh, maxw, seed=maxh * 100 + K)
    marg, conf = mode == "marg", mode == "conf"
    n0 = matching.match_flow_fused.launches
    got = matching.match_flow_fused(f1, f2, maxh, maxw, 8, marg, dt, conf)
    assert matching.match_flow_fused.launches == n0 + 1
    ref = matching.match_flow_fused_plain(f1, f2, maxh, maxw, marg, dt, conf)
    torch.cuda.synchronize()
    costs = matching.match_ssd(f1, f2, maxh, maxw, dt)
    top2 = torch.topk(-costs, 2, dim=-1).values
    flip = got[0] != ref[0]
    assert bool(((top2[..., 0] - top2[..., 1])[flip] < 1e-5).all())
    for a, b in zip(got[1:], ref[1:]):
        assert a.shape == b.shape
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("rows,cols", [(16, 16), (3, 2), (1, 1)])
@pytest.mark.parametrize("maxh,maxw,K", [(4, 4, 3), (9, 13, 10), (16, 16, 17)])
def test_match_fused_general_kernel_any_passes_and_bands_match_plain(
        dev, maxh, maxw, K, rows, cols):
    # the general kernel forced onto shapes the unblocked one takes, with
    # whole-window, small and one-cell passes and bands
    plan = matching.FusedPlan(True, min(rows, maxh), min(cols, maxw), 0)
    f1, f2 = _features(dev, 9, 37, K, maxh, maxw, seed=rows * 10 + cols + K)
    for dt in (torch.float32, torch.bfloat16, torch.float16):
        got = matching._match_flow_fused_cuda(f1, f2, maxh, maxw, True, dt,
                                              False, 0.11, plan)
        ref = matching.match_flow_fused_plain(f1, f2, maxh, maxw, True, dt)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_match_fused_kernel_ties_across_bands_take_the_first_cell(dev):
    # cells (1, 0) (d = 16, the first band) and (0, 8) (d = 8, the second)
    # tie: the twin's first occurrence in flat order is d = 8
    f1 = torch.zeros(1, 1, 1, 33, device=dev)
    f2 = torch.full((1, 16, 16, 33), 5.0, device=dev)
    f2[0, 1, 0] = 0.0
    f2[0, 0, 8] = 0.0
    assert matching.fused_plan(16, 16, 33).band_cols <= 8
    got = matching.match_flow_fused(f1, f2, 16, 16)
    ref = matching.match_flow_fused_plain(f1, f2, 16, 16)
    assert got[0].item() == ref[0].item() == 8


def test_kernels_refuse_other_storage_types(dev):
    """B1, B2 and B3 take f32, bf16 and f16 storage on the card; any other
    type raises before a launch (and is never run through the twin)."""
    f1, f2 = _features(dev, 8, 8, 10, 4, 4, seed=0)
    n = (matching.match_flow_fused.launches, matching.match_flow_fast.launches,
         warp.banded_bilinear_warp.launches)
    for dt in (torch.float64, torch.int32):
        with pytest.raises(ValueError):
            matching.match_flow_fused(f1, f2, 4, 4, dtype=dt)
        with pytest.raises(ValueError):
            matching.match_flow_fast(f1, f2, 4, 4, dtype=dt)
        xs = torch.zeros(2, 8, 8, device=dev)
        with pytest.raises(ValueError):
            warp.banded_bilinear_warp(f1[:, :8, :8].to(dt).contiguous(),
                                      xs, xs, 2)
    assert (matching.match_flow_fused.launches,
            matching.match_flow_fast.launches,
            warp.banded_bilinear_warp.launches) == n


def test_f16_estimator_step_launches_its_kernels(dev):
    """A BatchedDepthEstimator step with every storage knob in f16, in
    'warp_banded' mode: B3 and B1 launch on f16 tensors (once each), and
    the outputs are finite, as in f32 (chip_smoke.py phase 18 measures the
    f16 step against the f32 one on frames of determined motion)."""
    import os
    from depth_estimation_tpu_torch import api_batched
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.models import io as mio
    geom, _, params, _ = mio.load_model(os.path.join(
        os.path.dirname(__file__), "..", "examples", "car_model"))
    g = torch.Generator(device=dev).manual_seed(3)
    base = torch.rand(2, 120, 160, 3, generator=g, device=dev)
    f1 = torch.nn.functional.interpolate(
        base.permute(0, 3, 1, 2), size=(480, 640), mode="bilinear",
        align_corners=False).permute(0, 2, 3, 1)
    f2 = torch.roll(f1, 2, dims=2)
    u8 = [(f * 255).to(torch.uint8) for f in (f1, f2)]
    for dt in (torch.float32, torch.float16):
        est = api_batched.BatchedDepthEstimator(
            geom, params, ARDRONE, compensation="warp_banded",
            match_dtype=dt, warp_dtype=dt, state_dtype=dt, device=dev)
        n = (matching.match_flow_fused.launches,
             warp.banded_bilinear_warp.launches)
        est.reset(u8[0])
        xflow, mask, depth, good = est.next_frames(u8[1])
        assert (matching.match_flow_fused.launches,
                warp.banded_bilinear_warp.launches) == (n[0] + 1, n[1] + 1)
        assert torch.isfinite(xflow).all() and torch.isfinite(mask).all()
        assert est.last_feats.dtype == dt


def test_match_fused_kernel_rejects_mixed_devices(dev):
    for maxh, K in ((4, 10), (17, 33)):
        f1, f2 = _features(dev, 8, 8, K, maxh, 4, seed=0)
        with pytest.raises(ValueError):
            matching.match_flow_fused(f1, f2.cpu(), maxh, 4)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("band,C", [(0, 1), (1, 3), (3, 10), (8, 10)])
def test_warp_banded_kernel_matches_plain(dev, band, C, dt):
    rng = np.random.RandomState(band * 10 + C)
    B, H, W = 2, 21, 35
    special = np.array([0.0, 0.5, -0.5, 1.0, -1.0, band, -band, band + 0.5,
                        -band - 0.5, band + 1, -band - 1, band + 1.5,
                        -band - 1.5, band + 2, -band - 2, 0.25], np.float32)

    def field():
        f = rng.uniform(-band - 2.5, band + 2.5, (B, H, W)).astype(np.float32)
        pick = rng.rand(B, H, W) < 0.5
        f[pick] = rng.choice(special, size=pick.sum())
        return f
    ys = np.arange(H, dtype=np.float32)[None, :, None] + field()
    xs = np.arange(W, dtype=np.float32)[None, None, :] + field()
    xs[0, 0, :3] = [1e9, -1e9, W - 1 + 0.5]                 # far off the band
    imgs = torch.from_numpy(rng.rand(B, H, W, C).astype(np.float32)).to(dev, dt)
    xs, ys = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    n0 = warp.banded_bilinear_warp.launches
    got = warp.banded_bilinear_warp(imgs, xs, ys, band)
    assert warp.banded_bilinear_warp.launches == n0 + 1
    ref = warp.banded_bilinear_warp_plain(imgs, xs, ys, band)
    torch.cuda.synchronize()
    assert got.dtype == torch.float32 and got.shape == ref.shape
    assert torch.isfinite(got).all()
    assert (got - ref).abs().max().item() <= 1e-6


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("C", [1, 3, 10, 17, 500])
@pytest.mark.parametrize("W", [1, 127, 129, 305])
def test_warp_banded_kernel_ragged_rows_match_plain(dev, W, C, dt):
    # rows cut inside a CTA's 128-pixel segment, one pixel, and car_model's
    # 305; C = 500 shrinks the segment to 64 pixels (their outputs staged in
    # shared memory)
    band = 8
    rng = np.random.RandomState(W * 100 + C)
    B, H = 3, 6
    special = np.array([0.0, 0.5, -0.5, band, -band, band + 0.5, -band - 0.5,
                        band + 1, -band - 1, band + 1.5, -band - 1.5],
                       np.float32)

    def field():
        f = rng.uniform(-band - 2.5, band + 2.5, (B, H, W)).astype(np.float32)
        pick = rng.rand(B, H, W) < 0.5
        f[pick] = rng.choice(special, size=pick.sum())
        return f
    ys = np.arange(H, dtype=np.float32)[None, :, None] + field()
    xs = np.arange(W, dtype=np.float32)[None, None, :] + field()
    xs[0, 0, 0] = 1e9                                       # far off the band
    ys[1, 1, -1] = -1e9
    imgs = torch.from_numpy(rng.rand(B, H, W, C).astype(np.float32)).to(dev, dt)
    xs, ys = torch.from_numpy(xs).to(dev), torch.from_numpy(ys).to(dev)
    n0 = warp.banded_bilinear_warp.launches
    got = warp.banded_bilinear_warp(imgs, xs, ys, band)
    assert warp.banded_bilinear_warp.launches == n0 + 1
    ref = warp.banded_bilinear_warp_plain(imgs, xs, ys, band)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    assert torch.equal(got, ref)


def _sor_planes(dev, lead, H, W, seed):
    """Random well-conditioned SOR planes as the solver builds them: zero
    boundary weights, denominators above the weights' sum."""
    from depth_estimation_tpu_torch.flow import celiu
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = tuple(lead) + (H, W)

    def rnd():
        return torch.rand(shape, generator=g, device=dev)
    phi = rnd() + 0.1
    alpha = 0.3
    w = celiu._neighbor_weights(phi)
    coeff = alpha * (w[0] + w[1] + w[2] + w[3])
    return (*w, rnd() + 0.5 + coeff, rnd() + 0.5 + coeff,
            torch.randn(shape, generator=g, device=dev),
            torch.randn(shape, generator=g, device=dev),
            (rnd() - 0.5) * 0.1), alpha


@pytest.mark.parametrize("lead,H,W", [((), 1, 1), ((1,), 2, 3), ((8,), 13, 22),
                                      ((2, 3), 17, 9), ((1,), 192, 256)])
@pytest.mark.parametrize("n_sor", [0, 1, 40])
def test_sor_redblack_kernel_matches_plain(dev, lead, H, W, n_sor):
    from depth_estimation_tpu_torch.flow import celiu, sor_kernel
    planes, alpha = _sor_planes(dev, lead, H, W, seed=H * 100 + W + n_sor)
    n0 = sor_kernel.sor_redblack.launches
    du, dv = sor_kernel.sor_redblack(*planes, alpha=alpha, n_sor=n_sor)
    assert sor_kernel.sor_redblack.launches == n0 + 1
    ref = celiu.sor_plain(*planes, alpha=alpha, n_sor=n_sor)
    torch.cuda.synchronize()
    assert du.shape == dv.shape == tuple(lead) + (H, W)
    assert torch.isfinite(du).all() and torch.isfinite(dv).all()
    # same operations in the same order with rounded intrinsics: equal
    assert (du - ref[0]).abs().max().item() <= 1e-6
    assert (dv - ref[1]).abs().max().item() <= 1e-6


def _config2_levels():
    """(H, W) of the liu solve's pyramid at BASELINE config2 (192x256,
    ratio 0.75, min_width 30), finest first."""
    from depth_estimation_tpu_torch.flow import celiu
    pyr = celiu.build_pyramid(torch.zeros(192, 256, 3), 0.75, 30)
    return [tuple(p.shape[:2]) for p in pyr]


@pytest.mark.parametrize("k", range(7))
def test_sor_redblack_config2_levels_equal_plain(dev, k):
    from depth_estimation_tpu_torch.flow import celiu, sor_kernel
    levels = _config2_levels()
    assert len(levels) == 7
    H, W = levels[k]
    planes, alpha = _sor_planes(dev, (8,), H, W, seed=k)
    du, dv = sor_kernel.sor_redblack(*planes, alpha=alpha, n_sor=40 + 3 * k)
    ref = celiu.sor_plain(*planes, alpha=alpha, n_sor=40 + 3 * k)
    torch.cuda.synchronize()
    assert torch.equal(du, ref[0]) and torch.equal(dv, ref[1])


@pytest.mark.parametrize("H,W,mode", [
    (144, 192, 0),      # 8 CTAs of 18 rows
    (97, 129, 0),       # odd W, 7 CTAs, the last strip short
    (5, 2001, 0),       # fewer rows than a full cluster: one row a CTA
    (3, 4001, 1),       # three one-row CTAs, du/dv alone in shared memory
    (240, 320, 1),      # planes beyond a cluster's shared memory
    (480, 640, 2),      # du/dv beyond it too: global memory
    (1000, 1000, 2),
])
def test_sor_redblack_partitions_equal_plain(dev, H, W, mode):
    from depth_estimation_tpu_torch.flow import celiu, sor_kernel
    assert sor_kernel.sor_plan(H, W).mode == mode
    planes, alpha = _sor_planes(dev, (2,), H, W, seed=H + W)
    n0 = sor_kernel.sor_redblack.launches
    du, dv = sor_kernel.sor_redblack(*planes, alpha=alpha, n_sor=7)
    assert sor_kernel.sor_redblack.launches == n0 + 1
    ref = celiu.sor_plain(*planes, alpha=alpha, n_sor=7)
    torch.cuda.synchronize()
    assert torch.equal(du, ref[0]) and torch.equal(dv, ref[1])


@pytest.mark.parametrize("H,W", [(192, 256), (144, 192), (480, 640)])
def test_sor_redblack_ignores_stale_memory(dev, H, W):
    # du/dv are allocated empty: the kernel must set every pixel itself,
    # whatever the allocator hands back (here blocks just filled with NaN)
    from depth_estimation_tpu_torch.flow import celiu, sor_kernel
    planes, alpha = _sor_planes(dev, (8,), H, W, seed=H)
    stale = [torch.full((8, H, W), float("nan"), device=dev) for _ in range(4)]
    del stale
    du, dv = sor_kernel.sor_redblack(*planes, alpha=alpha, n_sor=3)
    ref = celiu.sor_plain(*planes, alpha=alpha, n_sor=3)
    torch.cuda.synchronize()
    assert torch.equal(du, ref[0]) and torch.equal(dv, ref[1])


@pytest.mark.parametrize("H,W", [(192, 256), (34, 45), (480, 640)])
def test_sor_barrier_probe_runs_each_mode_uncounted(dev, H, W):
    # the dependency-floor probe: the plan's launch shape with no
    # arithmetic, and not a B4 launch
    from depth_estimation_tpu_torch.flow import sor_kernel
    n0 = sor_kernel.sor_redblack.launches
    sor_kernel.sor_barrier_probe(8, H, W, 5)
    torch.cuda.synchronize()
    assert sor_kernel.sor_redblack.launches == n0


# ---------------------------------------------------------------------------
# the liu solve's warps (csrc/liu_warp.cu) against their plain twins
# ---------------------------------------------------------------------------

def _cell_levels():
    """(H, W) of the liu cell's pyramid (180x320, ratio 0.75, min_width
    30), finest first."""
    from depth_estimation_tpu_torch.flow import celiu
    return celiu.pyramid_shapes(180, 320, 0.75, 30)


def _warp_inputs(dev, lead, H, W, C, seed, flow=2.0):
    """Frames in [0, 1], a flow of a few px and its increments."""
    g = torch.Generator(device=dev).manual_seed(seed)
    shape = tuple(lead) + (H, W)

    def rnd(scale, c=()):
        return scale * torch.randn(shape + c, generator=g, device=dev)
    im1 = torch.rand(shape + (C,), generator=g, device=dev)
    im2 = torch.rand(shape + (C,), generator=g, device=dev)
    return im1, im2, rnd(flow), rnd(flow), rnd(0.3), rnd(0.3)


def _warp_both(*args, noise=True):
    """The kernel (counted once) and its twin on the same CUDA tensors."""
    from depth_estimation_tpu_torch.flow import liu_warp
    n0 = liu_warp.warp_update_noise.launches
    got = liu_warp.warp_update_noise(*args, noise=noise)
    assert liu_warp.warp_update_noise.launches == n0 + 1
    ref = liu_warp.warp_update_noise_plain(*args, noise=noise)
    torch.cuda.synchronize()
    return got, ref


def _held_to_twin(got, ref):
    """u, v and the warp bit for bit (NaN where the twin's is NaN); the
    noise estimate within 1e-5, and 0 exactly where the twin's is."""
    for g, r in zip(got[:3], ref[:3]):
        assert g.shape == r.shape
        assert torch.equal(torch.isnan(g), torch.isnan(r))
        assert torch.equal(torch.nan_to_num(g), torch.nan_to_num(r))
    if ref[3] is None:
        assert got[3] is None
        return
    assert got[3].shape == ref[3].shape
    assert torch.equal(got[3] == 0, ref[3] == 0)
    torch.testing.assert_close(got[3], ref[3], rtol=1e-5, atol=0,
                               equal_nan=True)


@pytest.mark.parametrize("k", range(8))
def test_liu_warp_kernel_cell_levels_equal_twin(dev, k):
    levels = _cell_levels()
    assert len(levels) == 8
    H, W = levels[k]
    ins = _warp_inputs(dev, (3,), H, W, 5, seed=k)
    _held_to_twin(*_warp_both(*ins))
    # the warps between levels and the final one: no update, no noise
    got, ref = _warp_both(*ins[:4], noise=False)
    _held_to_twin(got, ref)
    assert got[0] is ins[2] and got[1] is ins[3]


@pytest.mark.parametrize("C", [1, 3, 5])
@pytest.mark.parametrize("W", [1, 31, 33, 127])
def test_liu_warp_kernel_ragged_widths_equal_twin(dev, W, C):
    ins = _warp_inputs(dev, (2,), 7, W, C, seed=W * 10 + C)
    _held_to_twin(*_warp_both(*ins))
    _held_to_twin(*_warp_both(*ins[:4], noise=False))
    _held_to_twin(*_warp_both(*ins, noise=False))
    # one image with no leading dims, and two leading dims
    _held_to_twin(*_warp_both(*(t[0] for t in ins)))
    _held_to_twin(*_warp_both(*(t.reshape((2, 1) + t.shape[1:])
                                for t in ins)))


def test_liu_warp_kernel_past_every_edge_equals_twin(dev):
    """Sample points before, exactly on and past each edge (frame 1 where
    they leave the image) among interior ones, and NaN flows (NaN warps,
    NaN noise sums)."""
    H, W = 23, 41
    im1, im2, u, v, du, dv = _warp_inputs(dev, (4,), H, W, 5, seed=3)
    j = torch.arange(W, dtype=torch.float32, device=dev)
    i = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    offs = torch.tensor([-3.0, -0.25, 0.0, 0.5, 1.0, 1.25], device=dev)
    pick = torch.randint(0, 14, (2, 4, H, W), device=dev,
                         generator=torch.Generator(device=dev).manual_seed(4))

    def edge(p, n, inside):
        # p < 6: near the first row or column, 6-11 near the last, else
        # the random flow's point
        near = torch.where(p < 6, offs[p % 6], (n - 1) + offs[p % 6])
        return torch.where(p < 12, near, inside)
    u = edge(pick[0], W, j + u) - j
    v = edge(pick[1], H, i + v) - i
    z = torch.zeros_like(u)
    got, ref = _warp_both(im1, im2, u, v, z, z)
    outside = (j + u < 0) | (j + u > W - 1) | (i + v < 0) | (i + v > H - 1)
    assert 0.2 < float(outside.float().mean()) < 0.8
    _held_to_twin(got, ref)
    _held_to_twin(*_warp_both(im1, im2, u, v, du, dv))
    u[0, 3, 5] = v[1, 7, 8] = float("nan")
    got, ref = _warp_both(im1, im2, u, v, du, dv)
    assert torch.isnan(ref[2]).any() and torch.isnan(ref[3]).any()
    _held_to_twin(got, ref)


def test_liu_warp_kernel_identical_frames_read_no_noise(dev):
    im1 = _warp_inputs(dev, (3,), 45, 80, 5, seed=9)[0]
    z = torch.zeros(im1.shape[:-1], device=dev)
    got, ref = _warp_both(im1, im1.clone(), z, z, z, z)
    _held_to_twin(got, ref)
    assert torch.equal(got[2], im1) and not got[3].any()


@pytest.mark.parametrize("H,W", [(180, 320), (42, 75)])
def test_liu_warp_kernel_ignores_stale_memory(dev, H, W):
    # every output is allocated empty: the kernel sets each element itself,
    # whatever the allocator hands back (here blocks just filled with NaN)
    ins = _warp_inputs(dev, (3,), H, W, 5, seed=H)
    stale = [torch.full((3, H, W, 5), float("nan"), device=dev)
             for _ in range(6)]
    del stale
    _held_to_twin(*_warp_both(*ins))


def _resize_both(img, h, w, scale=1.0):
    from depth_estimation_tpu_torch.flow import liu_warp
    n0 = liu_warp.resize.launches
    got = liu_warp.resize(img, h, w, scale)
    assert liu_warp.resize.launches == n0 + 1
    ref = liu_warp.resize_plain(img, h, w, scale)
    torch.cuda.synchronize()
    assert got.shape == ref.shape and torch.isfinite(got).all()
    return got, ref


@pytest.mark.parametrize("k", range(1, 8))
def test_liu_resize_kernel_cell_pyramid_equals_twin(dev, k):
    """Each level of the cell's pyramid from the finest frame (B=3, RGB),
    and the flow's upsampling from level k to k - 1 (1 channel, times
    1 / ratio)."""
    levels = _cell_levels()
    g = torch.Generator(device=dev).manual_seed(k)
    img = torch.rand(3, 180, 320, 3, generator=g, device=dev)
    assert torch.equal(*_resize_both(img, *levels[k]))
    flow = 3 * torch.randn((3,) + levels[k] + (1,), generator=g, device=dev)
    assert torch.equal(*_resize_both(flow, *levels[k - 1], 1 / 0.75))


@pytest.mark.parametrize("C", [1, 3, 5])
@pytest.mark.parametrize("W", [1, 31, 33, 127])
def test_liu_resize_kernel_ragged_widths_equal_twin(dev, W, C):
    g = torch.Generator(device=dev).manual_seed(W + C)
    img = torch.rand(2, 9, W, C, generator=g, device=dev)
    for h, w in ((5, max(1, W // 2)), (13, W + 7), (1, 1)):
        assert torch.equal(*_resize_both(img, h, w))
        assert torch.equal(*_resize_both(img[0], h, w, 2.0))
    stale = [torch.full((2, 13, W + 7, C), float("nan"), device=dev)
             for _ in range(4)]
    del stale
    assert torch.equal(*_resize_both(img, 13, W + 7))


def test_liu_warp_kernels_refuse_what_they_do_not_take(dev):
    from depth_estimation_tpu_torch.flow import liu_warp
    ins = _warp_inputs(dev, (2,), 9, 11, 17, seed=1)
    n0 = (liu_warp.warp_update_noise.launches, liu_warp.resize.launches)
    with pytest.raises(ValueError, match="channels"):
        liu_warp.warp_update_noise(*ins, noise=True)
    with pytest.raises(ValueError, match="channels"):
        liu_warp.resize(ins[0], 5, 5)
    with pytest.raises(ValueError, match="float32"):
        liu_warp.resize(ins[0][..., :3].half(), 5, 5)
    with pytest.raises(ValueError, match="cpu"):
        liu_warp.warp_update_noise(ins[0][..., :3], ins[1][..., :3],
                                   ins[2].cpu(), ins[3])
    assert (liu_warp.warp_update_noise.launches,
            liu_warp.resize.launches) == n0


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("H,W", [(1, 1), (3, 5), (7, 31), (9, 33), (2, 63),
                                 (11, 65)])
def test_match_fused_kernel_ragged_widths_equal_plain(dev, H, W, dt):
    # W cut inside a thread's pixel pair, inside a tile, and below one tile
    f1, f2 = _features(dev, H, W, 10, 16, 16, seed=H * 100 + W)
    for marg, conf in ((False, False), (True, False), (False, True)):
        got = matching.match_flow_fused(f1, f2, 16, 16, 8, marg, dt, conf)
        ref = matching.match_flow_fused_plain(f1, f2, 16, 16, marg, dt, conf)
        torch.cuda.synchronize()
        for a, b in zip(got, ref):
            assert torch.equal(a, b)


def test_sor_redblack_rejects_mismatched_planes(dev):
    from depth_estimation_tpu_torch.flow import sor_kernel
    planes, alpha = _sor_planes(dev, (2,), 5, 6, seed=0)
    with pytest.raises(ValueError):
        sor_kernel.sor_redblack(*planes[:-1], planes[-1][:, :4], alpha=alpha,
                                n_sor=3)
    with pytest.raises(ValueError):
        sor_kernel.sor_redblack(*planes[:-1], planes[-1].cpu(), alpha=alpha,
                                n_sor=3)


def _check_decomposed(got, ref, f1, f2, maxh, maxw, dt=None):
    """A decomposed matcher (B2 or B5) against its twin: same arithmetic in
    the same order, so only the exp implementations may differ; WTA indices
    agree except at near-ties of the logit."""
    B, H, W = f1.shape[:3]
    assert got[0].dtype == torch.int32 and tuple(got[0].shape) == (B, H, W)
    if maxh * maxw > 1:
        costs = matching.match_ssd(f1, f2, maxh, maxw, dt)
        top2 = torch.topk(-costs, 2, dim=-1).values
        flip = got[0] != ref[0]
        assert bool(((top2[..., 0] - top2[..., 1])[flip] < 1e-4).all())
    else:
        assert bool((got[0] == 0).all())
    for a, b in zip(got[1:], ref[1:]):
        assert torch.isfinite(a).all()
        assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("K", [1, 3, 10, 17, 32])
@pytest.mark.parametrize("maxh,maxw", [(1, 1), (3, 5), (4, 4), (6, 4), (5, 3),
                                       (9, 13), (16, 16), (20, 7)])
def test_match_fast_kernel_matches_plain(dev, maxh, maxw, K, dt):
    H, W = 13, 37                      # ragged against the 32x32 output tile
    f1, f2 = _features(dev, H, W, K, maxh, maxw, seed=maxh * 100 + K + 7)
    n0 = matching.match_flow_fast.launches
    got = matching.match_flow_fast(f1, f2, maxh, maxw, 8, dt)
    assert matching.match_flow_fast.launches == n0 + 1
    ref = matching.match_flow_fast_plain(f1, f2, maxh, maxw, dt)
    torch.cuda.synchronize()
    _check_decomposed(got, ref, f1, f2, maxh, maxw, dt)


def test_match_fast_kernel_at_the_version2_shape_matches_plain(dev):
    # the version2 cell's match: K = 32 on a 17x17 window, whose halo fills
    # one block's shared memory on a 16x32 tile; 148 rows cut the tile
    f1, f2 = _features(dev, 148, 288, 32, 17, 17, seed=1717)
    n0 = matching.match_flow_fast.launches
    got = matching.match_flow_fast(f1, f2, 17, 17)
    assert matching.match_flow_fast.launches == n0 + 1
    ref = matching.match_flow_fast_plain(f1, f2, 17, 17)
    torch.cuda.synchronize()
    _check_decomposed(got, ref, f1, f2, 17, 17)


# W cut inside a thread's pixel block, inside a tile and below one tile; H
# cut inside a thread's pixel rows
RAGGED = [(1, 1), (3, 5), (7, 31), (9, 33), (2, 63), (11, 65)]
RAGGED_WINDOWS = [(1, 1), (3, 5), (20, 7), (16, 16)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("maxh,maxw", RAGGED_WINDOWS)
@pytest.mark.parametrize("H,W", RAGGED)
def test_match_fast_kernel_ragged_equal_plain(dev, H, W, maxh, maxw, dt):
    f1, f2 = _features(dev, H, W, 10, maxh, maxw, seed=H * 100 + W + maxh)
    n0 = matching.match_flow_fast.launches
    got = matching.match_flow_fast(f1, f2, maxh, maxw, 8, dt)
    assert matching.match_flow_fast.launches == n0 + 1
    ref = matching.match_flow_fast_plain(f1, f2, maxh, maxw, dt)
    torch.cuda.synchronize()
    _check_decomposed(got, ref, f1, f2, maxh, maxw, dt)


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("B", [1, 3, 130])
def test_match_fast_kernel_batches_equal_plain(dev, B, dt):
    g = torch.Generator(device=dev).manual_seed(B)
    f1 = 0.5 * torch.randn(B, 11, 65, 10, generator=g, device=dev)
    f2 = 0.5 * torch.randn(B, 26, 80, 10, generator=g, device=dev)
    n0 = matching.match_flow_fast.launches
    got = matching.match_flow_fast(f1, f2, 16, 16, 8, dt)
    assert matching.match_flow_fast.launches == n0 + 1
    ref = matching.match_flow_fast_plain(f1, f2, 16, 16, dt)
    torch.cuda.synchronize()
    _check_decomposed(got, ref, f1, f2, 16, 16, dt)


# every compiled (channel bound, blocking), at a K of that bound (100 for
# the run-time bound) and a window whose halo one tile holds
COMPILED = [(kc or 100, b, (16, 16) if kc else (7, 5))
            for kc, bs in matching.BLOCKINGS.items() for b in bs]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("K,blocking,window", COMPILED)
def test_match_fast_every_compiled_blocking_equals_plain(dev, K, blocking,
                                                         window, dt):
    # the blockings chip_smoke.py times against the plan's (K=10), and the
    # others, at ragged widths
    maxh, maxw = window
    f1, f2 = _features(dev, 11, 65, K, maxh, maxw, seed=sum(blocking) + K)
    plan = matching.plan_for(maxh, maxw, K, blocking)
    got = matching._match_flow_fast_cuda(f1, f2, maxh, maxw, dt, plan)
    ref = matching.match_flow_fast_plain(f1, f2, maxh, maxw, dt)
    torch.cuda.synchronize()
    _check_decomposed(got, ref, f1, f2, maxh, maxw, dt)


# windows whose halo fits on no tile (walked in bands) and channel counts
# above 32 (64 compiled, 100 at run time)
GENERAL_DECOMPOSED = [(64, 64, 32), (64, 64, 1), (48, 48, 17), (3, 500, 10),
                      (500, 3, 32), (4, 4, 33), (16, 16, 64), (7, 5, 100)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("maxh,maxw,K", GENERAL_DECOMPOSED)
def test_match_fast_kernel_general_shapes_match_plain(dev, maxh, maxw, K, dt):
    f1, f2 = _features(dev, 7, 37, K, maxh, maxw, seed=maxh + maxw + K)
    n0 = matching.match_flow_fast.launches
    got = matching.match_flow_fast(f1, f2, maxh, maxw, 8, dt)
    assert matching.match_flow_fast.launches == n0 + 1
    ref = matching.match_flow_fast_plain(f1, f2, maxh, maxw, dt)
    torch.cuda.synchronize()
    _check_decomposed(got, ref, f1, f2, maxh, maxw, dt)


def test_match_fast_kernel_rejects_what_it_does_not_take(dev):
    f1, f2 = _features(dev, 8, 8, 10, 4, 4, seed=0)
    with pytest.raises(ValueError):
        matching.match_flow_fast(f1, f2.cpu(), 4, 4)      # mixed devices
    # a plan the launcher was not built for is refused on the C side
    bad = matching.MatchPlan(3, 1, 8, 8, 0, 4, 4)
    with pytest.raises(RuntimeError, match="unsupported configuration"):
        matching._match_flow_fast_cuda(f1, f2, 4, 4, torch.float32, bad)
    # and so is a band that breaks the dx-major visit order
    bad = matching.MatchPlan(2, 2, 16, 16, 0, 2, 2)
    with pytest.raises(RuntimeError, match="unsupported configuration"):
        matching._match_flow_fast_cuda(f1, f2, 4, 4, torch.float32, bad)


def _throughput_case(dev, B, H, W, K, maxh, maxw, seed):
    from depth_estimation_tpu_torch.ops import matching_experimental as mexp
    g = torch.Generator(device=dev).manual_seed(seed)
    f1 = 0.5 * torch.randn(B, H, W, K, generator=g, device=dev)
    f2 = 0.5 * torch.randn(B, H + maxh - 1, W + maxw - 1, K, generator=g,
                           device=dev)
    n0 = mexp.match_flow_throughput.launches
    got = mexp.match_flow_throughput(f1, f2, maxh, maxw)
    assert mexp.match_flow_throughput.launches == n0 + 1
    # the twin on the norms the wrapper hands it on the CPU; the kernel
    # sums them itself in the same order
    ref = mexp.match_flow_throughput_plain(*mexp._norms(f1, f2), maxh, maxw)
    torch.cuda.synchronize()
    _check_decomposed(got, ref, f1, f2, maxh, maxw)
    return f1, f2, got


@pytest.mark.parametrize("B", [1, 3, 130])
@pytest.mark.parametrize("K", [1, 3, 10, 17, 32])
@pytest.mark.parametrize("maxh,maxw", [(1, 1), (3, 5), (20, 7), (16, 16)])
def test_match_throughput_kernel_matches_plain(dev, maxh, maxw, K, B):
    from depth_estimation_tpu_torch.ops import matching_experimental as mexp
    f1, f2, got = _throughput_case(dev, B, 13, 37, K, maxh, maxw,
                                   seed=maxh * 1000 + K * 10 + B)
    # the unbatched form gives the first item
    one = mexp.match_flow_throughput(f1[0], f2[0], maxh, maxw)
    for x, y in zip(one, got):
        assert torch.equal(x, y[0])


@pytest.mark.parametrize("maxh,maxw", RAGGED_WINDOWS)
@pytest.mark.parametrize("H,W", RAGGED)
def test_match_throughput_kernel_ragged_equal_plain(dev, H, W, maxh, maxw):
    _throughput_case(dev, 3, H, W, 10, maxh, maxw, seed=H * 100 + W + maxh)


@pytest.mark.parametrize("K,blocking,window", COMPILED)
def test_match_throughput_every_compiled_blocking_equals_plain(dev, K,
                                                               blocking,
                                                               window):
    from depth_estimation_tpu_torch.ops import matching_experimental as mexp
    maxh, maxw = window
    f1, f2 = _features(dev, 11, 65, K, maxh, maxw, seed=sum(blocking) + K + 1)
    plan = matching.plan_for(maxh, maxw, K, blocking)
    got = mexp._match_flow_throughput_cuda(f1, f2, maxh, maxw, plan)
    ref = mexp.match_flow_throughput_plain(*mexp._norms(f1, f2), maxh, maxw)
    torch.cuda.synchronize()
    _check_decomposed(got, ref, f1, f2, maxh, maxw)


@pytest.mark.parametrize("maxh,maxw,K", GENERAL_DECOMPOSED)
def test_match_throughput_kernel_general_shapes_match_plain(dev, maxh, maxw, K):
    _throughput_case(dev, 2, 7, 37, K, maxh, maxw, seed=maxh + maxw + K + 1)


def test_match_throughput_kernel_rejects_what_it_does_not_take(dev):
    from depth_estimation_tpu_torch.ops import matching_experimental as mexp
    f1, f2 = _features(dev, 8, 8, 10, 4, 4, seed=0)
    with pytest.raises(ValueError, match="block_cols"):
        mexp.match_flow_throughput(f1, f2, 4, 4, 8, 12)
    with pytest.raises(ValueError):
        mexp.match_flow_throughput(f1, f2.cpu(), 4, 4)     # mixed devices
    # a band that breaks the dy-major visit order is refused on the C side
    bad = matching.MatchPlan(2, 2, 16, 16, 0, 2, 2)
    with pytest.raises(RuntimeError, match="unsupported configuration"):
        mexp._match_flow_throughput_cuda(f1, f2, 4, 4, bad)


# ---------------------------------------------------------------------------
# the training slice on the card (no kernel of its own: the trainer runs
# plain torch with autograd; the loaders reach B4 through the liu GT)
# ---------------------------------------------------------------------------

_TRAIN_GEOM = dict(hImg=48, wImg=56, layers=((3, 5, 5, 8), (8, 3, 3, 6)),
                   maxh=6, maxw=6, maxhGT=6, maxwGT=6, hKernelGT=5,
                   wKernelGT=5)


def _patch_set(g, n, seed):
    from depth_estimation_tpu_torch.geometry import Learning
    from depth_estimation_tpu_torch.training import train
    rng = np.random.RandomState(seed)
    base = rng.rand(g.hImg + 20, g.wImg + 20, 3).astype(np.float32)
    images = [base[10:10 + g.hImg, 10:10 + g.wImg],
              base[11:11 + g.hImg, 8:8 + g.wImg]]
    flow = np.zeros((2, g.hImg, g.wImg), np.float32)
    flow[0], flow[1] = 1, -2
    return train.sample_patches(g, Learning(), images, [flow], None, n,
                                np.random.RandomState(seed + 1))


def tree_leaves(tree):
    """The leaves of a nested dict, in its order."""
    if isinstance(tree, dict):
        return [x for k in tree for x in tree_leaves(tree[k])]
    return [tree]


@pytest.mark.parametrize("criterion", ["nll", "soft", "mse"])
def test_trainer_card_matches_cpu(dev, criterion):
    """Three SGD steps from the same weights on the same batches, TF32 off:
    parameters within 1e-5 of the CPU's."""
    from depth_estimation_tpu_torch.geometry import Geometry, Learning
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.training import train
    g = Geometry(**_TRAIN_GEOM)
    lrn = Learning(rate=2e-2, rate_decay=1e-5, criterion=criterion,
                   soft_targets=criterion == "soft", batch_size=16)
    ds = _patch_set(g, 48, 0)
    card = train.Trainer(g, lrn, device=dev).init(
        torch.Generator().manual_seed(0))
    cpu = train.Trainer(g, lrn, device="cpu").init(
        torch.Generator().manual_seed(0))
    mc = card.epoch(ds, shuffle_rng=np.random.RandomState(1))
    mh = cpu.epoch(ds, shuffle_rng=np.random.RandomState(1))
    assert all(mc["grad_ok"]) and next(card.model.parameters()).is_cuda
    np.testing.assert_allclose(mc["losses"], mh["losses"], rtol=1e-5)
    for a, b in zip(tree_leaves(mio.model_tree(card.model)),
                    tree_leaves(mio.model_tree(cpu.model))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_multiscale_trainer_card_matches_cpu(dev):
    from depth_estimation_tpu_torch.geometry import Geometry, Learning
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.training import train
    g = Geometry(hImg=48, wImg=56, layers=((3, 3, 3, 6),), maxh=4, maxw=4,
                 maxhGT=6, maxwGT=6, hKernelGT=5, wKernelGT=5,
                 multiscale=True, ratios=(1, 2))
    lrn = Learning(rate=5e-2, rate_decay=1e-5, batch_size=8)
    rng = np.random.RandomState(3)
    base = rng.rand(g.hImg + 20, g.wImg + 20, 3).astype(np.float32)
    images = [base[10:10 + g.hImg, 10:10 + g.wImg],
              base[11:11 + g.hImg, 8:8 + g.wImg]]
    flow = np.zeros((2, g.hImg, g.wImg), np.float32)
    flow[0], flow[1] = 1, -2
    ds = train.sample_foveas(g, lrn, images, [flow], None, 16,
                             np.random.RandomState(4))
    card = train.MultiscaleTrainer(g, lrn, device=dev).init(
        torch.Generator().manual_seed(0))
    cpu = train.MultiscaleTrainer(g, lrn, device="cpu").init(
        torch.Generator().manual_seed(0))
    mc = card.epoch(ds, shuffle_rng=np.random.RandomState(5))
    mh = cpu.epoch(ds, shuffle_rng=np.random.RandomState(5))
    assert all(mc["grad_ok"])
    np.testing.assert_allclose(mc["losses"], mh["losses"], rtol=1e-5)
    for a, b in zip(tree_leaves(mio.model_tree(card.model)),
                    tree_leaves(mio.model_tree(cpu.model))):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5)


def test_liu_ground_truth_of_a_pair_launches_b4(dev):
    """The 'liu' GT of the pair loader runs its SOR sweeps through B4."""
    import dataclasses
    from depth_estimation_tpu_torch.data import datasets
    from depth_estimation_tpu_torch.flow import sor_kernel
    from depth_estimation_tpu_torch.geometry import Geometry
    from depth_estimation_tpu_torch.geometry3d import calibration
    g = Geometry(**dict(_TRAIN_GEOM, hImg=48, wImg=64))
    cal = dataclasses.replace(calibration.RECTIFIED_GOPRO_SMALL, wImg=128,
                              hImg=96, fx=100.0, fy=100.0, cx=64, cy=48,
                              bad_image_threshold=0.0)
    rng = np.random.RandomState(0)
    base = rng.rand(24, 32, 3).astype(np.float32).repeat(4, 0).repeat(4, 1)
    prev, img = base, np.roll(base, 2, axis=1)
    n0 = sor_kernel.sor_redblack.launches
    pair = datasets.load_rectified_pair(g, cal, prev, img, groundtruth="liu",
                                        device=dev)
    assert sor_kernel.sor_redblack.launches > n0
    assert pair.good and pair.flow.shape == (2, 48, 64)
    assert np.isfinite(pair.flow).all()


def test_liu_flow_batched_at_the_cells_shapes_equals_the_reference(dev):
    """One batched liu solve at the benchmark cell's shapes (B=64, 180x320,
    the trainer's schedule: 8 levels, 68 IRLS steps) launches B4 once an
    IRLS step, as it does the IRLS kernel, and equals the plain reference
    (``h100bench/reference/liu.py``) on the card bit for bit."""
    from depth_estimation_tpu_torch.data import groundtruth
    from depth_estimation_tpu_torch.flow import sor_kernel
    from h100bench.reference import liu as ref
    g = torch.Generator(device=dev).manual_seed(20)
    base = torch.rand((64, 3, 47, 82), generator=g, device=dev)
    base = torch.nn.functional.interpolate(base, (182, 324), mode="bilinear")
    base = base.permute(0, 2, 3, 1)
    im1 = base[:, 1:181, 3:323].contiguous()
    im2 = base[:, :180, :320].contiguous()
    from depth_estimation_tpu_torch.flow import liu_warp
    from depth_estimation_tpu_torch.flow import liu_irls
    n0 = sor_kernel.sor_redblack.launches
    w0, r0 = liu_warp.warp_update_noise.launches, liu_warp.resize.launches
    i0 = liu_irls.irls_planes.launches
    vx, vy = groundtruth.liu_flow_batched(im1, im2)
    torch.cuda.synchronize()
    assert sor_kernel.sor_redblack.launches == n0 + 68
    assert liu_irls.irls_planes.launches == i0 + 68
    # a warp an IRLS step, one between each two levels and the final one;
    # the pyramids' 2 x 7 resizes and the flow's 2 x 7 upsamplings
    assert liu_warp.warp_update_noise.launches == w0 + 76
    assert liu_warp.resize.launches - r0 <= 28
    assert vx.shape == vy.shape == (64, 180, 320) and vx.device == im1.device
    rx, ry, _ = ref.coarse_to_fine(im1, im2)
    gap = max(float((vx - rx).abs().max()), float((vy - ry).abs().max()))
    assert 1.0 < float(vx.abs().mean()) < 5.0
    assert gap == 0.0, gap


# ---------------------------------------------------------------------------
# B1 and B3 as operators, and inside a loaded artifact
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["plain", "marg", "conf", "bf16"])
def test_match_fused_operator_passes_opcheck_on_the_card(dev, mode):
    f1, f2 = _features(dev, 13, 37, 10, 5, 3, seed=77)
    torch.library.opcheck(matching.match_flow_fused_op,
                          (f1, f2, 5, 3, mode == "marg", mode == "bf16",
                           mode == "conf", 0.11))


def test_banded_warp_operator_passes_opcheck_on_the_card(dev):
    g = torch.Generator(device=dev).manual_seed(78)
    imgs = torch.randn(2, 21, 35, 3, generator=g, device=dev)
    ys = torch.arange(21.0, device=dev)[:, None] + 2 * torch.randn(
        2, 21, 35, generator=g, device=dev)
    xs = torch.arange(35.0, device=dev) + 2 * torch.randn(
        2, 21, 35, generator=g, device=dev)
    torch.library.opcheck(warp.banded_bilinear_warp_op, (imgs, xs, ys, 3))


def test_flow_forward_artifact_launches_b1_on_the_card(dev, tmp_path):
    from depth_estimation_tpu_torch import serving
    from depth_estimation_tpu_torch.geometry import Geometry
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.models.flow import FlowModel
    g = Geometry(hImg=32, wImg=40, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    m = FlowModel(g, device=dev).init(torch.Generator().manual_seed(0))
    path = str(tmp_path / "fwd.pt2")
    serving.export_flow_forward(g, mio.model_tree(m), path, device=dev)
    program = serving.load_exported(path).module()
    a, b = (torch.rand(32, 40, 3, generator=torch.Generator(device=dev)
                       .manual_seed(s), device=dev) for s in (1, 2))
    n = matching.match_flow_fused.launches
    got = program(a, b)
    torch.cuda.synchronize()
    assert matching.match_flow_fused.launches == n + 1
    for x, y in zip(got, m.forward_fused(a, b)):
        assert torch.equal(x, y)


# ---------------------------------------------------------------------------
# P1 and P2, the peak meter's issue-rate probes (csrc/vpu_peak.cu)
# ---------------------------------------------------------------------------

# the kernel's FFMA rounds c - c*c once where the twin rounds twice, and
# expf may part from torch's exp by an ulp; both maps contract on (0, 1)
TOL_VPU = 1e-6


@pytest.mark.parametrize("n", [1, 257, 132 * 2048 * 3 + 5])
@pytest.mark.parametrize("op", ["fma", "exp"])
def test_vpu_loop_kernel_matches_plain(dev, op, n):
    from depth_estimation_tpu_torch.benchmarks import device_peaks as dp
    g = torch.Generator(device=dev).manual_seed(n)
    x = 0.05 + 0.9 * torch.rand(n, generator=g, device=dev)
    launches = dp.vpu_loop.launches
    got = dp.vpu_loop(x, op, 4)
    _, n_chains, steps, mean = dp.P1[op]
    plain = dp.chains_fma_plain if op == "fma" else dp.chains_exp_plain
    ref = plain(x, n_chains, steps, 4, mean)
    torch.cuda.synchronize()
    assert dp.vpu_loop.launches == launches + 1
    assert (got - ref).abs().max().item() <= TOL_VPU
    assert torch.equal(dp.vpu_loop(x, op, 0), x)


@pytest.mark.parametrize("warps", [4, 64])
@pytest.mark.parametrize("n_chains", [1, 2, 4, 8])
def test_logistic_loop_kernel_matches_plain(dev, n_chains, warps):
    from depth_estimation_tpu_torch.benchmarks import device_peaks as dp
    g = torch.Generator(device=dev).manual_seed(n_chains)
    x = 0.05 + 0.9 * torch.rand(132 * 128 * 2 + 3, generator=g, device=dev)
    launches = dp.logistic_loop.launches
    got = dp.logistic_loop(x, n_chains, 3, warps)
    ref = dp.chains_fma_plain(x, n_chains, dp.P2_STEPS // n_chains, 3, False)
    torch.cuda.synchronize()
    assert dp.logistic_loop.launches == launches + 1
    assert (got - ref).abs().max().item() <= TOL_VPU


def test_vpu_kernels_refuse_what_they_do_not_take(dev):
    from depth_estimation_tpu_torch.benchmarks import device_peaks as dp
    with pytest.raises(ValueError):
        dp.vpu_loop(torch.ones(4, 4, device=dev), "fma", 1)
    with pytest.raises(ValueError):
        dp.vpu_loop(torch.ones(4, dtype=torch.float64, device=dev), "fma", 1)


# the autotuner's candidates (ops/autotune.best_plan): every plan of B1 and
# of B2 gives the default plan's outputs bit for bit, and the twin's as the
# tests above hold them; the winner is measured once and read back
CANDIDATE_WINDOWS = [(16, 16, 10), (9, 13, 3), (8, 8, 16), (24, 24, 10)]


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("maxh,maxw,K", CANDIDATE_WINDOWS)
def test_every_match_fused_candidate_equals_the_default_plan(dev, maxh, maxw,
                                                             K, dt):
    f1, f2 = _features(dev, 13, 37, K, maxh, maxw, seed=maxh + K)
    plans = matching.fused_candidates(maxh, maxw, K)
    assert len(plans) > 1
    for marg, conf in ((False, True), (True, False)):
        want = matching.match_flow_fused(f1, f2, maxh, maxw, 8, marg, dt,
                                         conf)
        for plan in plans[1:]:
            got = matching.match_flow_fused(f1, f2, maxh, maxw, 8, marg, dt,
                                            conf, plan=plan)
            torch.cuda.synchronize()
            for a, b in zip(got, want):
                assert torch.equal(a, b), plan
        ref = matching.match_flow_fused_plain(f1, f2, maxh, maxw, marg, dt,
                                              conf)
        for a, b in zip(want[1:4], ref[1:4]):
            assert (a - b).abs().max().item() <= 1e-5


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
@pytest.mark.parametrize("maxh,maxw,K", CANDIDATE_WINDOWS)
def test_every_match_fast_candidate_equals_the_default_plan(dev, maxh, maxw,
                                                            K, dt):
    f1, f2 = _features(dev, 13, 70, K, maxh, maxw, seed=maxh + K + 1)
    plans = matching.fast_candidates(maxh, maxw, K)
    assert len(plans) > 1
    want = matching.match_flow_fast(f1, f2, maxh, maxw, 8, dt)
    for plan in plans[1:]:
        got = matching.match_flow_fast(f1, f2, maxh, maxw, 8, dt, plan=plan)
        torch.cuda.synchronize()
        for a, b in zip(got, want):
            assert torch.equal(a, b), plan
    _check_decomposed(want, matching.match_flow_fast_plain(
        f1, f2, maxh, maxw, dt), f1, f2, maxh, maxw, dt)


def test_best_plan_measures_once_and_reads_the_store_back(dev, tmp_path,
                                                          monkeypatch):
    from depth_estimation_tpu_torch.ops import autotune
    monkeypatch.setattr(autotune, "store_path",
                        lambda: tmp_path / "autotune.json")
    monkeypatch.setattr(autotune, "_cache", None)
    monkeypatch.setattr(autotune, "_session_only", {})
    shapes = ((2, 30, 40, 10), (2, 45, 55, 10), 16, 16)
    timed = []

    def timer(fn):
        timed.append(1)
        return autotune._default_timer(fn)
    for kernel in ("fused", "fast"):
        plan = autotune.best_plan(kernel, *shapes, torch.bfloat16, True,
                                  device=dev, timer=timer)
        assert plan in autotune.candidates_for(kernel, 16, 16, 10)
    n = len(timed)
    assert n == 7 + 20
    autotune._cache = None              # a later process reads the store
    for kernel in ("fused", "fast"):
        autotune.best_plan(kernel, *shapes, torch.bfloat16, True, device=dev,
                           timer=timer)
    assert len(timed) == n


def test_estimator_auto_equals_a_fixed_block_on_the_card(dev, tmp_path,
                                                          monkeypatch):
    from depth_estimation_tpu_torch import api_batched
    from depth_estimation_tpu_torch.geometry import Geometry
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.models.filters import init_params
    from depth_estimation_tpu_torch.ops import autotune
    monkeypatch.setattr(autotune, "store_path",
                        lambda: tmp_path / "autotune.json")
    monkeypatch.setattr(autotune, "_cache", None)
    g = Geometry(hImg=90, wImg=160, layers=((3, 5, 5, 8), (8, 7, 7, 10)),
                 maxh=16, maxw=16)
    est = api_batched.BatchedDepthEstimator(g, None, ARDRONE, device=dev,
                                            match_block="auto")
    init_params(est.trunk, torch.Generator().manual_seed(0))
    fixed = api_batched.BatchedDepthEstimator(g, None, ARDRONE, device=dev)
    fixed.trunk.load_state_dict(est.trunk.state_dict())
    gen = torch.Generator(device=dev).manual_seed(3)
    t1 = (255 * torch.rand(4, 480, 640, 3, generator=gen, device=dev)).to(
        torch.uint8)
    t2 = torch.roll(t1, 2, dims=2)
    for e in (est, fixed):
        e.reset(t1)
    assert len(est._plans) == 1 and fixed._plans == {}
    for a, b in zip(est.next_frames(t2), fixed.next_frames(t2)):
        assert torch.equal(a, b)


# ---------------------------------------------------------------------------
# The shared CUDA-graph cache (utils/cuda_graph) and its two users, RANSAC's
# QR (geometry3d/qr_graph) and the liu solve's IRLS planes (flow/celiu):
# eager's bits
# ---------------------------------------------------------------------------

GRAPH_USERS = ["qr_graph", "liu_graph"]


def _qr_input(dev, B, S, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    p1 = 0.4 * torch.randn(B, S, 8, 2, generator=g, device=dev)
    p2 = p1 + 0.02 * torch.randn(B, S, 8, 2, generator=g, device=dev)
    x1, y1, x2, y2 = p1[..., 0], p1[..., 1], p2[..., 0], p2[..., 1]
    A = torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                     torch.ones_like(x1)], dim=-1)
    return p1, p2, A


def _planes_input(dev, B, H, W, seed):
    """An IRLS step's (im1f, warp, u, v, lap_para), 5 channels."""
    g = torch.Generator(device=dev).manual_seed(seed)
    return tuple(torch.rand(s, generator=g, device=dev) for s in
                 ((B, H, W, 5), (B, H, W, 5), (B, H, W), (B, H, W), (B, 5)))


def _graph_user(name):
    """One user of the shared cache: (its call through a cache, its eager
    call, its inputs at (size, seed), the process's cache)."""
    from depth_estimation_tpu_torch.flow import celiu
    from depth_estimation_tpu_torch.geometry3d import qr_graph
    if name == "qr_graph":
        return (lambda cache, ts: cache.replay(qr_graph.sliced_q, ts,
                                               eager_fn=qr_graph.eager_q),
                lambda ts: qr_graph.eager_q(*ts),
                lambda dev, size, seed: (_qr_input(dev, *size, seed)[2],),
                qr_graph.GRAPHS)
    kw = dict(alpha=0.005, noise_model="lap")
    return (lambda cache, ts: cache.replay(celiu._irls_planes, ts, **kw),
            lambda ts: celiu._irls_planes(*ts, **kw),
            lambda dev, size, seed: _planes_input(dev, *size, seed),
            celiu.GRAPHS)


def _graph_routes(name):
    from depth_estimation_tpu_torch.utils.timer import COUNTERS
    return [COUNTERS[f"{name}.{k}"] for k in ("captures", "replays",
                                               "eager")]


def _same(got, want):
    """Bit for bit, in eager's layout."""
    from torch.utils import _pytree
    got, want = _pytree.tree_leaves(got), _pytree.tree_leaves(want)
    return len(got) == len(want) and all(
        torch.equal(a, b) and a.stride() == b.stride()
        for a, b in zip(got, want))


@pytest.mark.parametrize("user,size", [
    ("qr_graph", (128, 48)), ("qr_graph", (1, 64)), ("qr_graph", (3, 48)),
    ("liu_graph", (2, 180, 320)), ("liu_graph", (1, 7, 9))])
def test_graph_equals_eager_over_replays(dev, user, size):
    from depth_estimation_tpu_torch.utils.cuda_graph import GraphCache
    call, eager, inputs, _ = _graph_user(user)
    cache = GraphCache(user, 4)
    c0, r0, e0 = _graph_routes(user)
    for seed in range(4):               # new contents each replay
        tensors = inputs(dev, size, seed)
        assert _same(call(cache, tensors), eager(tensors))
    assert _graph_routes(user) == [c0 + 1, r0 + 4, e0]
    if user == "qr_graph":              # the program's own path
        from depth_estimation_tpu_torch.geometry3d import egomotion
        p1, p2, _ = _qr_input(dev, *size, 3)
        want = eager(tensors)[..., :, 8].reshape(size + (3, 3))
        assert torch.equal(egomotion._eight_point(p1, p2), want)


@pytest.mark.parametrize("user", GRAPH_USERS)
def test_graph_captures_up_to_its_bound(dev, user):
    """Each size up to the process cache's bound captured once and replayed
    twice; the last past the bound, eager."""
    from depth_estimation_tpu_torch.utils.cuda_graph import GraphCache
    call, eager, inputs, process = _graph_user(user)
    n = process.max_graphs
    cache = GraphCache(user, n)
    sizes = [(B, 48) if user == "qr_graph" else (B, 12, 16)
             for B in range(2, 3 + n)]
    c0, r0, e0 = _graph_routes(user)
    for seed in range(2):
        for i, size in enumerate(sizes):
            tensors = inputs(dev, size, 10 * seed + i)
            assert _same(call(cache, tensors), eager(tensors))
    assert _graph_routes(user) == [c0 + n, r0 + 2 * n, e0 + 2]


@pytest.mark.parametrize("user", GRAPH_USERS)
def test_graph_shared_by_threads(dev, user):
    """Threads replaying one key on one stream each get their own
    outputs."""
    import threading
    from depth_estimation_tpu_torch.utils.cuda_graph import GraphCache
    call, eager, inputs, _ = _graph_user(user)
    size = (8, 48) if user == "qr_graph" else (2, 24, 32)
    cache = GraphCache(user, 4)
    call(cache, inputs(dev, size, 0))
    bad, errors = [], []

    def worker(t):
        try:
            for i in range(5):
                tensors = inputs(dev, size, 100 * t + i)
                if not _same(call(cache, tensors), eager(tensors)):
                    bad.append((t, i))
        except Exception as e:          # re-raised below
            errors.append(e)
    threads = [threading.Thread(target=worker, args=(t,)) for t in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    assert not errors, errors
    assert bad == []
    assert len(cache._graphs) == 1      # one device, the default stream


@pytest.mark.parametrize("user", GRAPH_USERS)
def test_graph_stays_eager_in_a_capture_and_captures_off_the_profiler(
        dev, user):
    """Inside a caller's capture the call is eager and captures nothing; a
    new key under a running profiler is eager too; once captured outside
    one, it replays under it."""
    from depth_estimation_tpu_torch.utils.cuda_graph import GraphCache
    call, eager, inputs, _ = _graph_user(user)
    cache = GraphCache(user, 4)
    tensors = inputs(dev, (2, 48) if user == "qr_graph" else (2, 30, 40), 3)
    want = eager(tensors)
    torch.cuda.synchronize()
    c0, r0, e0 = _graph_routes(user)
    outer = torch.cuda.CUDAGraph()
    with torch.cuda.graph(outer):
        got = call(cache, tensors)
    outer.replay()
    assert _same(got, want)
    assert _graph_routes(user) == [c0, r0, e0 + 1] and cache._graphs == {}
    with torch.profiler.profile():
        got = call(cache, tensors)
    assert _same(got, want)
    assert _graph_routes(user) == [c0, r0, e0 + 2] and cache._graphs == {}
    call(cache, tensors)
    with torch.profiler.profile():
        got = call(cache, tensors)
    assert _same(got, want)
    assert _graph_routes(user) == [c0 + 1, r0 + 2, e0 + 2]


def test_qr_graph_slices_give_the_bits_of_one_chain(dev, monkeypatch):
    from depth_estimation_tpu_torch.geometry3d import qr_graph
    from depth_estimation_tpu_torch.utils.cuda_graph import _Graph
    _, _, A = _qr_input(dev, 128, 48, 7)
    assert qr_graph.slices(128 * 48) == qr_graph.MAX_SLICES == 32
    sliced = _Graph(qr_graph.sliced_q, (A,))
    monkeypatch.setattr(qr_graph, "MAX_SLICES", 1)
    one = _Graph(qr_graph.sliced_q, (A,))
    for seed in (8, 9):
        _, _, A = _qr_input(dev, 128, 48, seed)
        want = qr_graph.eager_q(A)
        assert torch.equal(one((A,)), want) and torch.equal(sliced((A,)), want)


# the trainer's 'liu' schedule: 8 levels and 68 IRLS steps at 180x320
_LIU = dict(alpha=0.005, ratio=0.75, min_width=30, n_outer=5, n_inner=1,
            n_sor=40)


def _liu_pair(dev, B, H, W, seed):
    """(im1, im2) (B, H, W, 3): a smooth random scene moved by (1, 3) px."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.rand((B, 3, H // 4 + 2, W // 4 + 2), generator=g, device=dev)
    base = torch.nn.functional.interpolate(base, (H + 2, W + 4),
                                           mode="bilinear")
    base = base.permute(0, 2, 3, 1)
    return (base[:, 1:H + 1, 3:W + 3].contiguous(),
            base[:, :H, :W].contiguous())


def _fresh_liu_graphs(monkeypatch):
    from depth_estimation_tpu_torch.flow import celiu
    from depth_estimation_tpu_torch.utils.cuda_graph import GraphCache
    monkeypatch.setattr(celiu, "GRAPHS", GraphCache("liu_graph", 16))


@torch.no_grad()
def _liu_solve(pair, **kw):
    from depth_estimation_tpu_torch.flow import celiu
    return celiu.coarse2fine_flow_batched(*pair, **dict(_LIU, **kw))


def _eager_liu_solve(monkeypatch, pair, **kw):
    """The solve with every IRLS step eager (a cache bound of 0)."""
    from depth_estimation_tpu_torch.flow import celiu
    from depth_estimation_tpu_torch.utils.cuda_graph import GraphCache
    with monkeypatch.context() as m:
        m.setattr(celiu, "GRAPHS", GraphCache("liu_graph", 0))
        return _liu_solve(pair, **kw)


@pytest.mark.parametrize("B", [2, 64])
def test_liu_graph_solve_equals_eager_over_solves(dev, monkeypatch, B):
    """Whole solves at 180x320, the trainer's schedule ('lap'), B=2 and
    the liu cell's B=64: the IRLS kernel's solve and the eager solve (every
    IRLS step in ``_irls_planes``) bit-equal over 3 solves with new
    contents; 68 kernel launches each solve, and no IRLS graph captured or
    replayed."""
    from depth_estimation_tpu_torch.flow import celiu, liu_irls
    _fresh_liu_graphs(monkeypatch)
    pairs = [_liu_pair(dev, B, 180, 320, 40 + s) for s in range(3)]
    with monkeypatch.context() as m:
        m.setattr(liu_irls, "irls_planes", lambda *a, **k: celiu._irls_planes(
            *a, noise_model="lap", **k))
        wants = [_liu_solve(p) for p in pairs]
    routes = _graph_routes("liu_graph")
    for i, (pair, want) in enumerate(zip(pairs, wants)):
        n0 = liu_irls.irls_planes.launches
        got = _liu_solve(pair)
        for a, b in zip(got, want):
            assert torch.equal(a, b), float((a - b).abs().max())
        assert liu_irls.irls_planes.launches == n0 + 68
        assert _graph_routes("liu_graph") == routes
    assert 0.5 < float(got[0].abs().mean()) < 5.0


def test_liu_graph_gmm_bicubic_equals_eager(dev, monkeypatch):
    """The Gaussian-mixture noise model (its three tensors copied in, the
    first level's expanded) and bicubic warps, graph against eager."""
    _fresh_liu_graphs(monkeypatch)
    kw = dict(alpha=0.01, min_width=30, n_outer=2, noise_model="gmm",
              interpolation="bicubic")
    c0 = _graph_routes("liu_graph")[0]
    for seed in (50, 51):
        pair = _liu_pair(dev, 2, 60, 80, seed)
        want = _eager_liu_solve(monkeypatch, pair, **kw)
        got = _liu_solve(pair, **kw)
        for a, b in zip(got, want):
            assert torch.equal(a, b), float((a - b).abs().max())
    assert _graph_routes("liu_graph")[0] >= c0 + 3
