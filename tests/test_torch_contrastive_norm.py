"""The version2 net's contrastive normalisation kernel
(``csrc/contrastive_norm.cu`` through ``ops/normalization.contrastive_norm``)
against its plain twin, the torch code
``spatial_contrastive_normalization_plain``.

On the CPU: the entry runs the twin bit for bit and counts no launch, an
input that requires grad, a window or a channel count outside the kernel's
range included; the kernel's refusals; a trace (make_fx, fake tensors,
torch.export) is seen as one; the kernel route's backward is the twin's
gradient, to the second derivative; the cached border map and taps are the
twin's. On the card (marked ``cuda``, skipped here): the kernel equals the
twin bit for bit at the version2 cell's frame (180x320x3, k = 17), over k
in {1, 4, 7, 17, 33} and C in {1, 2, 3, 4}, at frames smaller than the
window and not multiples of the tile, with leading dimensions, on a
constant frame (the std floored at 1e-4); ``V2Network.flow_batch`` returns
the same tensors either way with one kernel call; what the kernel does not
take raises; autograd, a dispatch mode and a capture take the kernel;
``torch.export`` keeps the torch code. This file imports no jax; its card
cases run as

    python -m pytest --noconftest tests/test_torch_contrastive_norm.py -q
"""

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch.ops import _kernels
from depth_estimation_tpu_torch.ops import normalization as N


def _frames(lead, H, W, C, seed, device="cpu"):
    g = torch.Generator(device=device).manual_seed(seed)
    return torch.rand(tuple(lead) + (H, W, C), generator=g, device=device)


def _counts(dev="cpu"):
    """(the wrapper's launches, the launches on ``dev``)"""
    return (N.contrastive_norm.launches,
            _kernels.LAUNCHES_BY_DEVICE[("contrastive_norm", str(dev))])


# ---------------------------------------------------------------------------
# the CPU: the twin's route, the reasons, the constants
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("k,C", [(17, 3), (4, 1), (7, 2)])
def test_cpu_entry_is_the_twin(k, C):
    x = _frames((2,), 19, 26, C, seed=k)
    n0 = _counts()
    got = N.spatial_contrastive_normalization(x, k)
    assert torch.equal(got, N.spatial_contrastive_normalization_plain(x, k))
    assert _counts() == n0


def test_input_requiring_grad_takes_the_twin():
    x = _frames((1,), 15, 21, 3, seed=3).requires_grad_()
    assert N.kernel_refusal(x, 17) == "cpu"
    n0 = _counts()
    got = N.spatial_contrastive_normalization(x, 17)
    assert torch.equal(got, N.spatial_contrastive_normalization_plain(x, 17))
    got.square().sum().backward()
    assert x.grad is not None and bool(torch.isfinite(x.grad).all())
    assert _counts() == n0


@pytest.mark.parametrize("k,C,why", [(35, 3, "window"), (0, 3, "window"),
                                     (17, 5, "channels"), (3, 8, "channels")])
def test_windows_and_channels_outside_the_kernel_take_the_twin(k, C, why):
    """On the CPU; on the card they raise
    (``test_card_raises_for_what_the_kernel_does_not_take``)."""
    x = _frames((2,), 12, 18, C, seed=C + k)
    assert N.kernel_refusal(x, k) == why
    if k == 0:
        return       # the twin's window of no taps is not a window
    got = N.spatial_contrastive_normalization(x, k)
    assert torch.equal(got, N.spatial_contrastive_normalization_plain(x, k))


@pytest.mark.parametrize("case,why", [("float64", "dtype"), ("2-D", "shape"),
                                      ("empty", "cpu"), ("float k", "window"),
                                      ("bool k", "window"), ("cpu", "cpu")])
def test_kernel_refusal_reasons(case, why):
    x = _frames((1,), 9, 11, 3, seed=1)
    k = 17
    if case == "float64":
        x = x.double()
    elif case == "2-D":
        x = x[0, :, :, 0]
    elif case == "empty":
        x = x[:0]
    elif case == "float k":
        k = 17.0
    elif case == "bool k":
        k = True
    # an empty batch is no refusal of its own: the route launches nothing
    assert N.kernel_refusal(x, k) == why


def test_kernel_route_refuses_what_it_does_not_take():
    n0 = _counts()
    with pytest.raises(ValueError):
        N.contrastive_norm(_frames((1,), 9, 11, 3, seed=2), 17)
    with pytest.raises(ValueError):
        N.contrastive_norm(torch.empty((1, 9, 11, 5), device="meta"), 17)
    with pytest.raises(ValueError, match="window"):
        N.contrastive_norm(torch.empty((1, 9, 11, 3), device="meta"), 35)
    assert _counts() == n0


def test_traces_are_seen_and_take_the_twin(monkeypatch):
    """make_fx and a fake-tensor mode count as traces: the entry runs the
    twin there and launches nothing, a fake card tensor included."""
    from torch._subclasses.fake_tensor import FakeTensorMode
    from torch.fx.experimental.proxy_tensor import make_fx

    assert not N._tracing()
    seen = []

    def f(x):
        seen.append(N._tracing())
        return N.spatial_contrastive_normalization(x, 7)

    x = _frames((1,), 9, 12, 3, seed=4)
    n0 = _counts()
    gm = make_fx(f)(x)
    assert seen == [True]
    assert torch.equal(gm(x), N.spatial_contrastive_normalization_plain(x, 7))
    assert _counts() == n0

    def kernel(img, k):
        raise AssertionError("the kernel's route under a trace")

    monkeypatch.setattr(N, "contrastive_norm", kernel)
    monkeypatch.setattr(N, "spatial_contrastive_normalization_plain",
                        lambda img, k: "twin")
    with FakeTensorMode():
        fake = torch.empty((2, 9, 12, 3), device="cuda")
        assert fake.is_cuda and N._tracing()
        assert N.spatial_contrastive_normalization(fake, 17) == "twin"
    assert not N._tracing()


def test_kernel_route_gradient_is_the_twins(monkeypatch):
    """The route that a card input requiring grad takes, with the twin in
    the kernel's place (the kernel has no CPU mode): its gradient is the
    twin's bit for bit, and its first and second derivatives check
    numerically."""
    monkeypatch.setattr(N, "contrastive_norm",
                        N.spatial_contrastive_normalization_plain)
    x = _frames((2,), 11, 13, 3, seed=8).requires_grad_()
    g = _frames((2,), 11, 13, 3, seed=9)
    got = N._KernelWithTwinGrad.apply(x, 5)
    dx, = torch.autograd.grad(got, x, g)
    want = N.spatial_contrastive_normalization_plain(x, 5)
    assert torch.equal(got, want)
    assert torch.equal(dx, torch.autograd.grad(want, x, g)[0])
    x64 = _frames((1,), 6, 7, 2, seed=10).double().requires_grad_()
    fn = lambda t: N._KernelWithTwinGrad.apply(t, 3)    # noqa: E731
    assert torch.autograd.gradcheck(fn, (x64,))
    assert torch.autograd.gradgradcheck(fn, (x64,))


@pytest.mark.parametrize("H,W,k,C", [(19, 26, 17, 3), (5, 3, 33, 4),
                                     (12, 40, 4, 1)])
def test_cached_border_map_equals_the_twins(H, W, k, C):
    x = _frames((2,), H, W, C, seed=H)
    coef = N._coef(H, W, k, C, torch.device("cpu"))
    assert torch.equal(coef, N._local_mean(x, N._window(k, C))[0])
    assert N._coef(H, W, k, C, torch.device("cpu")) is coef
    assert len(N._COEF) <= N._COEF_MAX


@pytest.mark.parametrize("k,C", [(17, 3), (4, 2), (33, 1)])
def test_taps_are_the_twins_f32_window(k, C):
    assert np.array_equal(np.array(N._taps(k, C)[:], np.float32),
                          N._window(k, C))


# ---------------------------------------------------------------------------
# the card
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    return torch.device("cuda:0")


def _assert_kernel_is_the_twin(x, k, dev):
    n0 = _counts(dev)
    got = N.spatial_contrastive_normalization(x, k)
    torch.cuda.synchronize()
    assert _counts(dev) == (n0[0] + 1, n0[1] + 1)
    want = N.spatial_contrastive_normalization_plain(x, k)
    assert got.shape == want.shape and got.dtype == torch.float32
    assert torch.equal(got, want), float((got - want).abs().max())
    return got


@pytest.mark.cuda
def test_kernel_equals_twin_at_the_cells_frame(dev):
    """The version2 cell's frames (180x320x3, k = 17) on a few frames: the
    tiling does not depend on B."""
    x = _frames((4,), 180, 320, 3, seed=17, device=dev)
    got = _assert_kernel_is_the_twin(x, 17, dev)
    assert bool(torch.isfinite(got).all())


@pytest.mark.cuda
@pytest.mark.parametrize("k", [1, 4, 7, 17, 33])
@pytest.mark.parametrize("C", [1, 2, 3, 4])
def test_kernel_equals_twin_over_windows_and_channels(dev, k, C):
    _assert_kernel_is_the_twin(_frames((2,), 37, 70, C, seed=k * C,
                                       device=dev), k, dev)


@pytest.mark.cuda
@pytest.mark.parametrize("H,W", [(1, 1), (5, 7), (16, 9), (1, 40), (40, 1),
                                 (33, 70), (47, 65)])
@pytest.mark.parametrize("k", [17, 33, 6])
def test_kernel_equals_twin_at_odd_shapes(dev, H, W, k):
    _assert_kernel_is_the_twin(_frames((3,), H, W, 3, seed=H * W + k,
                                       device=dev), k, dev)


@pytest.mark.cuda
def test_kernel_takes_leading_dims_and_strided_inputs(dev):
    _assert_kernel_is_the_twin(_frames((), 50, 61, 3, seed=5, device=dev), 17,
                               dev)
    _assert_kernel_is_the_twin(_frames((2, 3), 24, 40, 2, seed=6, device=dev),
                               7, dev)
    x = _frames((2,), 40, 33, 3, seed=7, device=dev).transpose(1, 2)
    _assert_kernel_is_the_twin(x, 17, dev)


@pytest.mark.cuda
def test_constant_frame_floors_the_std(dev):
    """A constant frame (and a black one) beside a textured one: the
    constant frames' std is 0 or nearly, floored at 1e-4 (their own mean);
    values up to 255 as the loaders' frames before scaling."""
    x = _frames((3,), 45, 80, 3, seed=9, device=dev) * 255
    x[0] = 0.5
    x[1] = 0.0
    got = _assert_kernel_is_the_twin(x, 17, dev)
    assert bool(torch.isfinite(got).all())
    assert float(got[1].abs().max()) == 0.0


@pytest.mark.cuda
def test_flow_batch_is_the_same_either_way(dev, monkeypatch):
    """``V2Network.flow_batch`` at the cell's frame: one kernel call (both
    frames as one batch of 2B), and the same tensors as with the torch
    code in its place."""
    from depth_estimation_tpu_torch.models import version2
    net = version2.V2Network(device=dev).init(torch.Generator().manual_seed(3))
    g = net.geometry
    x1 = _frames((2,), g.hImg, g.wImg, 3, seed=31, device=dev)
    x2 = torch.roll(x1, (1, 2), dims=(1, 2))
    with torch.no_grad():
        n0 = _counts(dev)
        got = net.flow_batch(x1, x2)
        torch.cuda.synchronize()
        assert _counts(dev) == (n0[0] + 1, n0[1] + 1)
        monkeypatch.setattr(version2, "spatial_contrastive_normalization",
                            N.spatial_contrastive_normalization_plain)
        want = net.flow_batch(x1, x2)
    assert _counts(dev) == (n0[0] + 1, n0[1] + 1)
    for a, b in zip(got, want):
        assert torch.equal(a, b)


@pytest.mark.cuda
def test_card_raises_for_what_the_kernel_does_not_take(dev):
    """A window, a channel count or a dtype outside the kernel's raise on
    the card, launching nothing; an empty batch launches nothing and
    returns an empty tensor."""
    n0 = _counts(dev)
    for k, C, dtype in ((35, 3, torch.float32), (17, 5, torch.float32),
                        (17, 3, torch.float64), (17, 3, torch.float16)):
        x = _frames((1,), 12, 18, C, seed=k + C, device=dev).to(dtype)
        with pytest.raises(ValueError):
            N.spatial_contrastive_normalization(x, k)
    empty = N.spatial_contrastive_normalization(
        torch.empty((0, 12, 18, 3), device=dev), 17)
    assert empty.shape == (0, 12, 18, 3) and empty.is_cuda
    assert _counts(dev) == n0


@pytest.mark.cuda
def test_autograd_dispatch_mode_and_capture_take_the_kernel(dev):
    """An input requiring grad: the kernel forward, the twin's gradient.
    nan_debug: the kernel, its output checked for NaNs. A CUDA-graph
    capture at a frame whose border map is not yet made: the kernel and
    the map in the graph, replayed on new frames bit for bit the twin."""
    from depth_estimation_tpu_torch.utils.debug import nan_debug
    x = _frames((2,), 30, 44, 3, seed=11, device=dev)
    g = _frames((2,), 30, 44, 3, seed=12, device=dev)
    want = N.spatial_contrastive_normalization_plain(x, 17)
    n0 = _counts(dev)
    xg = x.clone().requires_grad_()
    got = N.spatial_contrastive_normalization(xg, 17)
    got.backward(g)
    assert _counts(dev) == (n0[0] + 1, n0[1] + 1)
    xw = x.clone().requires_grad_()
    N.spatial_contrastive_normalization_plain(xw, 17).backward(g)
    assert torch.equal(got.detach(), want) and torch.equal(xg.grad, xw.grad)
    bad = x.clone()
    bad[1, 3, 4, 0] = float("nan")
    with nan_debug():
        assert torch.equal(N.spatial_contrastive_normalization(x, 17), want)
        with pytest.raises(FloatingPointError):
            N.spatial_contrastive_normalization(bad, 17)
    # a capture, warmed up (the library loaded) at another frame
    static = _frames((2,), 29, 43, 3, seed=13, device=dev)
    N._COEF.pop((29, 43, 17, 3, dev), None)
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        N.spatial_contrastive_normalization(x, 17)
    torch.cuda.current_stream().wait_stream(side)
    n1 = _counts(dev)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = N.spatial_contrastive_normalization(static, 17)
    assert (29, 43, 17, 3, dev) not in N._COEF
    for seed in (14, 15):
        static.copy_(_frames((2,), 29, 43, 3, seed=seed, device=dev))
        graph.replay()
        torch.cuda.synchronize()
        assert torch.equal(out,
                           N.spatial_contrastive_normalization_plain(static, 17))
    assert _counts(dev) == (n1[0] + 1, n1[1] + 1)


@pytest.mark.cuda
def test_export_keeps_the_torch_code(dev):
    class Norm(torch.nn.Module):
        def forward(self, x):
            return N.spatial_contrastive_normalization(x, 17)

    x = _frames((2,), 24, 36, 3, seed=12, device=dev)
    n0 = _counts(dev)
    with torch.no_grad():
        ep = torch.export.export(Norm(), (x,))
        got = ep.module()(x)
    torch.cuda.synchronize()
    assert _counts(dev) == n0
    assert torch.equal(got, N.spatial_contrastive_normalization_plain(x, 17))
