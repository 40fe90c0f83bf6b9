"""The liu solve's warps (``flow/liu_warp.py``) on the CPU: the plain twins
of the kernel ``csrc/liu_warp.cu`` against the solver's torch code they
replace, the routes a solve takes (a CPU tensor never reaches the kernel
library; bicubic warps and the 'gmm' estimate stay in torch), and the
wrappers' refusals. The kernel itself is held to the twins on the card
(``tests/test_torch_cuda.py``)."""

import re

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch.flow import celiu, liu_warp
from depth_estimation_tpu_torch.ops import _kernels


def _inputs(shape, C, seed, flow=3.0):
    g = torch.Generator().manual_seed(seed)
    im1 = torch.rand(tuple(shape) + (C,), generator=g)
    im2 = torch.rand(tuple(shape) + (C,), generator=g)
    u, v, du, dv = (s * torch.randn(tuple(shape), generator=g)
                    for s in (flow, flow, 0.3, 0.3))
    return im1, im2, u, v, du, dv


SHAPES = [((2, 13, 17), 5), ((13, 17), 3), ((2, 3, 9, 7), 1), ((1, 1, 1), 5)]


@pytest.mark.parametrize("shape,C", SHAPES)
@pytest.mark.parametrize("update", [True, False])
@pytest.mark.parametrize("noise", [True, False])
def test_warp_twin_equals_the_solvers_composition(shape, C, update, noise):
    im1, im2, u, v, du, dv = _inputs(shape, C, seed=len(shape) * 10 + C)
    if not update:
        du = dv = None
    got = liu_warp.warp_update_noise(im1, im2, u, v, du, dv, noise=noise)
    if update:
        u, v = u + du, v + dv
    warp = celiu.warp_image(im1, im2, u, v)
    assert torch.equal(got[0], u) and torch.equal(got[1], v)
    assert torch.equal(got[2], warp)
    if noise:
        assert torch.equal(got[3], celiu.laplacian_noise(im1, warp))
    else:
        assert got[3] is None


def _imresize_before(img, dst_h, dst_w):
    """Liu's resize as the solver wrote it before the kernel: coordinates
    built on the host and moved, then the packed-tap sample."""
    H, W = img.shape[-3], img.shape[-2]
    rx = torch.tensor(dst_w / W, dtype=torch.float32)
    ry = torch.tensor(dst_h / H, dtype=torch.float32)
    x = (torch.arange(dst_w, dtype=torch.float32) + 1.0) / rx - 1.0
    y = (torch.arange(dst_h, dtype=torch.float32) + 1.0) / ry - 1.0
    lead = img.shape[:-3]
    xx = x[None, :].expand(lead + (dst_h, dst_w)).to(img.device)
    yy = y[:, None].expand(lead + (dst_h, dst_w)).to(img.device)
    return celiu.bilinear_sample(img, xx, yy, packed=True)


@pytest.mark.parametrize("src,dst,C", [
    ((2, 180, 320), (135, 240), 3), ((2, 42, 75), (57, 101), 1),
    ((13, 17), (9, 11), 3), ((3, 5, 1), (4, 7), 5), ((1, 9, 31), (1, 1), 1)])
def test_resize_twin_equals_the_solvers_imresize(src, dst, C):
    img = torch.rand(tuple(src) + (C,),
                     generator=torch.Generator().manual_seed(C))
    want = _imresize_before(img, *dst)
    assert torch.equal(liu_warp.resize(img, *dst), want)
    assert torch.equal(celiu.imresize(img, *dst), want)
    # the flow's upsampling: the sample times 1 / ratio, as the solver
    # multiplied it
    assert torch.equal(liu_warp.resize(img, *dst, 1 / 0.75)[..., 0],
                       want[..., 0] * (1 / 0.75))


def _pair(B, H, W, seed):
    g = torch.Generator().manual_seed(seed)
    base = celiu.gaussian_smooth(torch.rand(B, H, W + 2, 3, generator=g),
                                 1.5, 4)
    return base[..., 2:, :].contiguous(), base[..., :-2, :].contiguous()


def _count(monkeypatch, module, name, calls, refuse=False):
    fn = getattr(module, name)

    def counted(*a, **k):
        calls.append(k)
        if refuse:
            raise AssertionError(f"{name} reached")
        return fn(*a, **k)
    monkeypatch.setattr(module, name, counted)


SCHEDULE = dict(alpha=0.005, ratio=0.75, min_width=12, n_outer=2, n_inner=1,
                n_sor=5)


def test_cpu_solve_never_reaches_the_kernel_library(monkeypatch):
    """A whole small solve on CPU tensors runs the twins: the library is
    never asked for, no launch is counted, and the solve calls a warp an
    outer step, one between levels and the final one, and two resizes a
    pyramid level and two upsamplings a level."""
    def refuse():
        raise AssertionError("the kernel library was asked for on the CPU")
    monkeypatch.setattr(_kernels, "library", refuse)
    kernels = (liu_warp.warp_update_noise, liu_warp.resize)
    n0 = [k.launches for k in kernels]
    warps, resizes = [], []
    _count(monkeypatch, liu_warp, "warp_update_noise", warps)
    _count(monkeypatch, liu_warp, "resize", resizes)
    im1, im2 = _pair(2, 24, 32, seed=5)
    vx, vy, warped = celiu.coarse2fine_flow_batched(im1, im2, **SCHEDULE)
    assert torch.isfinite(vx).all() and torch.isfinite(vy).all()
    assert warped.shape == im1.shape
    levels = len(celiu.pyramid_shapes(24, 32, 0.75, 12))
    assert levels == 3
    steps = sum(SCHEDULE["n_outer"] + k for k in range(levels))
    assert len(warps) == steps + (levels - 1) + 1
    assert sum(k.get("noise", False) for k in warps) == steps
    assert len(resizes) == 4 * (levels - 1)
    assert [k.launches for k in kernels] == n0


@pytest.mark.parametrize("noise_model,interpolation", [
    ("gmm", "bicubic"), ("gmm", "bilinear"), ("lap", "bicubic")])
def test_gmm_and_bicubic_keep_their_torch_code(monkeypatch, noise_model,
                                               interpolation):
    """The 'gmm' estimate runs in torch after every warp; a bicubic warp
    never reaches ``liu_warp`` (nor its noise sums), a bilinear one asks
    it for no noise under 'gmm'."""
    warps, gmms, laps, bicubics = [], [], [], []
    _count(monkeypatch, liu_warp, "warp_update_noise", warps,
           refuse=interpolation == "bicubic")
    _count(monkeypatch, celiu, "est_gaussian_mixture", gmms)
    _count(monkeypatch, celiu, "laplacian_noise", laps)
    monkeypatch.setitem(celiu._WARPERS, "bicubic", lambda *a: (
        bicubics.append(1), celiu.warp_image_bicubic(*a))[1])
    im1, im2 = _pair(1, 24, 32, seed=6)
    vx, vy, _ = celiu.coarse2fine_flow(
        im1, im2, noise_model=noise_model, interpolation=interpolation,
        **SCHEDULE)
    assert torch.isfinite(vx).all() and torch.isfinite(vy).all()
    steps = sum(SCHEDULE["n_outer"] + k for k in range(3))
    assert len(gmms) == (steps if noise_model == "gmm" else 0)
    if interpolation == "bicubic":
        assert not warps and len(bicubics) == steps + 3
        assert len(laps) == (steps if noise_model == "lap" else 0)
    else:
        assert len(warps) == steps + 3
        assert not any(k.get("noise") for k in warps)


def _bad_warp_calls():
    im1, im2, u, v, du, dv = _inputs((2, 5, 6), 3, seed=1)
    return {
        "im1 float64": ((im1.double(), im2, u, v), "float32"),
        "u float16": ((im1, im2, u.half(), v), "float32"),
        "du float64": ((im1, im2, u, v, du.double(), dv), "float32"),
        "frames differ": ((im1, im2[:, :4], u, v), "shape"),
        "frames 2-D": ((im1[0, 0], im2[0, 0], u, v), "shape"),
        "u of another shape": ((im1, im2, u[:, :4], v), "u and v"),
        "du without dv": ((im1, im2, u, v, du, None), "together"),
        "dv without du": ((im1, im2, u, v, None, dv), "together"),
        "du of another shape": ((im1, im2, u, v, du[0], dv[0]), "du and dv"),
    }


@pytest.mark.parametrize("case", list(_bad_warp_calls()))
def test_warp_wrapper_refuses(case):
    args, match = _bad_warp_calls()[case]
    with pytest.raises(ValueError, match=match):
        liu_warp.warp_update_noise(*args, noise=True)


@pytest.mark.parametrize("img,h,w,match", [
    (torch.rand(2, 5, 6, 3, dtype=torch.float64), 3, 3, "float32"),
    (torch.rand(5, 6, 3).bfloat16(), 3, 3, "float32"),
    (torch.rand(5, 6), 3, 3, "H, W, C"),
    (torch.rand(5, 6, 3), 0, 3, "resize to"),
    (torch.rand(5, 6, 3), 3, 0, "resize to")])
def test_resize_wrapper_refuses(img, h, w, match):
    with pytest.raises(ValueError, match=match):
        liu_warp.resize(img, h, w)


def test_wrapper_constants_are_the_kernels():
    """The pixels a block (the partials' count) and the channel bound the
    wrapper assumes are the kernel source's."""
    src = (_kernels.CSRC / "liu_warp.cu").read_text()
    for const, value in (("PX_PER_BLOCK", liu_warp.PX_PER_BLOCK),
                         ("MAX_C", liu_warp.MAX_CHANNELS)):
        got = re.search(rf"constexpr int {const} = (\d+);", src)
        assert got and int(got.group(1)) == value
    assert "liu_warp.cu" in _kernels.SOURCES


def test_noise_of_identical_frames_is_zero_and_gates_psi():
    """Identical frames: the warp is frame 1, the estimate 0 exactly, so
    the next IRLS step's Psi is gated off."""
    im1 = _inputs((2, 9, 11), 5, seed=2)[0]
    z = torch.zeros(im1.shape[:-1])
    _, _, warp, lap = liu_warp.warp_update_noise(im1, im1.clone(), z, z, z, z,
                                                 noise=True)
    assert torch.equal(warp, im1) and not lap.any()
    planes = celiu._irls_planes(im1, warp, z, z, lap, alpha=0.005,
                                noise_model="lap")
    # Psi = 0: the data terms of the denominators and right sides vanish
    assert np.allclose(planes[8].numpy(), 0)
