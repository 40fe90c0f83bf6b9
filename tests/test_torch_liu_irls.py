"""The liu solve's IRLS kernel (``csrc/liu_irls.cu`` through
``flow/liu_irls.irls_planes``) against its plain twin, the solver's torch
code ``celiu._irls_planes`` under the Laplacian noise model.

On the CPU: the wrapper runs the twin bit for bit (3 and 5 channels, cold
and warm start, a channel whose noise estimate is 0), refuses what the
kernel does not take, and counts no launch. On the card (marked ``cuda``,
skipped here): the kernel equals the twin bit for bit at every level shape
of the liu cell's pyramid at B=64 and B=1, at odd shapes (7x9, 1xW, Hx1)
with 3 and 5 channels, cold and warm, and over a whole solve with warm
starts at the cell's shape, where it launches once an IRLS step and no
IRLS graph replays; a solve on the card whose features have another
channel count raises before any IRLS step runs in torch. This file imports no jax; its card cases run as

    python -m pytest --noconftest tests/test_torch_liu_irls.py -q
"""

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch.flow import celiu, liu_irls

ALPHA = 0.005           # the trainer's schedule


def _inputs(lead, H, W, C, seed, device="cpu", zero_channel=None):
    """(im1f, warp, u, v, lap_para, du, dv): smooth features in [0, 1] as
    the pyramid makes them, a flow of a few px, increments of a few tenths;
    ``zero_channel``'s noise estimate 0 (its Psi masked)."""
    g = torch.Generator(device=device).manual_seed(seed)
    shape = tuple(lead) + (H, W)

    def rnd(scale, tail=()):
        return scale * torch.randn(shape + tail, generator=g, device=device)
    im1 = torch.rand(shape + (C,), generator=g, device=device)
    im2 = (im1 + rnd(0.05, (C,))).clamp(0, 1)
    lap = 0.05 * torch.rand(tuple(lead) + (C,), generator=g, device=device)
    if zero_channel is not None:
        lap[..., zero_channel] = 0.0
    return im1, im2, rnd(2.0), rnd(2.0), lap, rnd(0.3), rnd(0.3)


def _both(ins, warm):
    """The wrapper's planes and the twin's on the same tensors."""
    im1, im2, u, v, lap, du, dv = ins
    kw = dict(du=du, dv=dv) if warm else {}
    got = liu_irls.irls_planes(im1, im2, u, v, lap, alpha=ALPHA, **kw)
    want = celiu._irls_planes(im1, im2, u, v, lap, alpha=ALPHA,
                              noise_model="lap", **kw)
    return got, want


def _assert_bitwise(got, want):
    assert len(got) == len(want) == 9
    for n, (g, w) in enumerate(zip(got, want)):
        assert g.shape == w.shape and g.dtype == torch.float32
        assert torch.equal(g, w), (n, float((g - w).abs().max()))


# ---------------------------------------------------------------------------
# the CPU: the twin's route, the checks, the counter
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("C", [3, 5])
@pytest.mark.parametrize("warm", [False, True])
def test_cpu_wrapper_is_the_twin(C, warm):
    ins = _inputs((2,), 13, 21, C, seed=C, zero_channel=1)
    got, want = _both(ins, warm)
    _assert_bitwise(got, want)
    imdxy = got[8]
    assert bool(torch.isfinite(torch.stack(got)).all())
    assert float(imdxy.abs().max()) > 0


def _refused(case):
    im1, im2, u, v, lap, du, dv = _inputs((1,), 6, 7, 5, seed=0)
    kw = {}
    if case == "float64":
        im1 = im1.double()
    elif case == "float16 flow":
        u = u.half()
    elif case in ("nine channels", "four channels"):
        n = 9 if case == "nine channels" else 4
        im1, im2 = (torch.rand(1, 6, 7, n) for _ in range(2))
        lap = torch.rand(1, n)
    elif case == "mixed devices":
        v = torch.empty(v.shape, device="meta")
    elif case == "du without dv":
        kw = dict(du=du)
    elif case == "shapes":
        u = u[:, :, :-1]
    elif case == "lap_para":
        lap = lap[:, :3]
    return (im1, im2, u, v, lap), kw


@pytest.mark.parametrize("case", ["float64", "float16 flow", "nine channels",
                                  "four channels", "mixed devices",
                                  "du without dv", "shapes", "lap_para"])
def test_wrapper_refuses_what_the_kernel_does_not_take(case):
    args, kw = _refused(case)
    n0 = liu_irls.irls_planes.launches
    with pytest.raises(ValueError):
        liu_irls.irls_planes(*args, alpha=ALPHA, **kw)
    assert liu_irls.irls_planes.launches == n0


def test_cpu_counts_no_launch():
    from depth_estimation_tpu_torch.ops import _kernels
    n0 = liu_irls.irls_planes.launches
    by_device = dict(_kernels.LAUNCHES_BY_DEVICE)
    for warm in (False, True):
        _both(_inputs((1,), 9, 11, 3, seed=4), warm)
    celiu.coarse2fine_flow(*_inputs((), 24, 40, 3, seed=5)[:2], alpha=0.02,
                           ratio=0.75, min_width=30, n_outer=2, n_inner=2,
                           n_sor=3)
    assert liu_irls.irls_planes.launches == n0
    assert dict(_kernels.LAUNCHES_BY_DEVICE) == by_device


def test_cpu_solve_of_four_channels_runs_the_twin():
    """On the CPU a 'lap' solve takes features of any channel count (here
    4, which ``im2feature`` passes through): every IRLS step is the twin's,
    through the IRLS planes' cache eagerly, and no kernel is launched."""
    from depth_estimation_tpu_torch.utils.timer import COUNTERS
    g = torch.Generator().manual_seed(6)
    im1 = torch.rand((24, 40, 4), generator=g)
    im2 = (im1 + 0.02 * torch.randn((24, 40, 4), generator=g)).clamp(0, 1)
    n0, e0 = liu_irls.irls_planes.launches, COUNTERS["liu_graph.eager"]
    vx, vy, warp = celiu.coarse2fine_flow(im1, im2, alpha=0.02, ratio=0.75,
                                          min_width=30, n_outer=2,
                                          n_inner=1, n_sor=3)
    assert vx.shape == vy.shape == (24, 40) and warp.shape == im1.shape
    assert bool(torch.isfinite(vx).all() & torch.isfinite(vy).all())
    assert liu_irls.irls_planes.launches == n0
    assert COUNTERS["liu_graph.eager"] > e0


def test_consts_are_torchs_f32_scalars():
    """The kernel's scalars: the twin's taps as they are, the Python
    scalars rounded to f32 once, and the mean's factor as torch's CUDA
    reduction forms it, float(n) / float(n C), in f32."""
    n = 64 * 180 * 320
    k = np.array(liu_irls._consts(ALPHA, n, 5)[:], np.float32)
    assert np.array_equal(k[:5], celiu._GFILTER)
    assert np.array_equal(k[5:10], celiu._DERIV5)
    assert np.array_equal(k[10:17], np.float32(
        [0.4, 0.6, 1e-6, 1e-6, 1e-20, ALPHA, ALPHA * 0.05]))
    assert k[17] == np.float32(0.2)


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    return torch.device("cuda:0")


def _counted(ins, warm, dev):
    from depth_estimation_tpu_torch.ops import _kernels
    n0 = liu_irls.irls_planes.launches
    d0 = _kernels.LAUNCHES_BY_DEVICE[("irls_planes", str(dev))]
    got, want = _both(ins, warm)
    torch.cuda.synchronize()
    assert liu_irls.irls_planes.launches == n0 + 1
    assert _kernels.LAUNCHES_BY_DEVICE[("irls_planes", str(dev))] == d0 + 1
    return got, want


@pytest.mark.cuda
@pytest.mark.parametrize("B", [64, 1])
@pytest.mark.parametrize("k", range(8))
def test_kernel_equals_twin_at_the_cells_levels(dev, B, k):
    H, W = celiu.pyramid_shapes(180, 320, 0.75, 30)[k]
    for warm in (False, True):
        ins = _inputs((B,), H, W, 5, seed=10 * k + B, device=dev,
                      zero_channel=4 if k % 2 else None)
        _assert_bitwise(*_counted(ins, warm, dev))


@pytest.mark.cuda
@pytest.mark.parametrize("H,W,C", [(7, 9, 5), (7, 9, 3), (1, 40, 5),
                                   (35, 1, 5), (1, 1, 3), (17, 33, 3),
                                   (16, 32, 5), (33, 70, 3), (20, 37, 5),
                                   (45, 80, 5), (60, 100, 3)])
def test_kernel_equals_twin_at_odd_shapes(dev, H, W, C):
    for warm in (False, True):
        ins = _inputs((2,), H, W, C, seed=H * W + C, device=dev,
                      zero_channel=0)
        _assert_bitwise(*_counted(ins, warm, dev))


@pytest.mark.cuda
def test_kernel_takes_leading_dims_and_strided_inputs(dev):
    im1, im2, u, v, lap, du, dv = _inputs((2, 3), 12, 20, 5, seed=7,
                                          device=dev)
    ins = (im1, im2, u.transpose(-1, -2).contiguous().transpose(-1, -2), v,
           lap, du, dv)
    _assert_bitwise(*_counted(ins, True, dev))


def _pair(dev, B, H, W, seed):
    """(im1, im2) (B, H, W, 3): a smooth random scene moved by (1, 3) px."""
    g = torch.Generator(device=dev).manual_seed(seed)
    base = torch.rand((B, 3, H // 4 + 2, W // 4 + 2), generator=g, device=dev)
    base = torch.nn.functional.interpolate(base, (H + 2, W + 4),
                                           mode="bilinear")
    base = base.permute(0, 2, 3, 1)
    return (base[:, 1:H + 1, 3:W + 3].contiguous(),
            base[:, :H, :W].contiguous())


def _routes():
    from depth_estimation_tpu_torch.utils.timer import COUNTERS
    return [COUNTERS[f"liu_graph.{k}"] for k in ("captures", "replays",
                                                  "eager")]


@pytest.mark.cuda
def test_warm_start_solve_equals_the_twins(dev, monkeypatch):
    """Whole solves at the liu cell's shape (180x320, the trainer's schedule)
    with two inner steps, B=4: the kernel's solve, cold and warm starts,
    equals the solve with every IRLS step in the twin bit for bit,
    launching the kernel once an IRLS step (2 x 68 a solve) and replaying
    no IRLS graph. (The cold schedule at B=2 and B=64 is
    ``test_torch_cuda.test_liu_graph_solve_equals_eager_over_solves``.)"""
    kw = dict(alpha=ALPHA, ratio=0.75, min_width=30, n_outer=5, n_inner=2,
              n_sor=40)
    im1, im2 = _pair(dev, 4, 180, 320, 62)
    with torch.no_grad():
        n0, r0 = liu_irls.irls_planes.launches, _routes()
        got = celiu.coarse2fine_flow_batched(im1, im2, **kw)
        torch.cuda.synchronize()
        assert liu_irls.irls_planes.launches == n0 + 2 * 68
        assert _routes() == r0
        with monkeypatch.context() as m:
            m.setattr(celiu.liu_irls, "irls_planes",
                      lambda *a, **k: celiu._irls_planes(
                          *a, noise_model="lap", **k))
            want = celiu.coarse2fine_flow_batched(im1, im2, **kw)
    for a, b in zip(got, want):
        assert torch.equal(a, b), float((a - b).abs().max())
    assert 0.5 < float(got[0].abs().mean()) < 5.0


@pytest.mark.cuda
@pytest.mark.parametrize("C", [2, 4])
def test_solve_of_other_channel_counts_raises_on_the_card(dev, monkeypatch,
                                                          C):
    """A 'lap' solve on the card whose features have neither 3 nor 5
    channels (``im2feature`` passes 2 and 4 through) raises from the
    kernel's wrapper at its first IRLS step: no step runs the torch twin or
    an IRLS graph on the card."""
    g = torch.Generator(device=dev).manual_seed(70 + C)
    im1 = torch.rand((2, 60, 80, C), generator=g, device=dev)
    im2 = torch.rand((2, 60, 80, C), generator=g, device=dev)
    n0, r0 = liu_irls.irls_planes.launches, _routes()
    twin, ran = celiu._irls_planes, []
    monkeypatch.setattr(celiu, "_irls_planes",
                        lambda *a, **k: ran.append(1) or twin(*a, **k))
    with torch.no_grad(), pytest.raises(ValueError, match="channels"):
        celiu.coarse2fine_flow_batched(im1, im2, alpha=ALPHA, ratio=0.75,
                                       min_width=30, n_outer=2, n_inner=1,
                                       n_sor=5)
    assert not ran
    assert liu_irls.irls_planes.launches == n0
    assert _routes() == r0
