"""The liu solve's warps: one kernel launch a warp (``csrc/liu_warp.cu``).

``warp_update_noise`` is one step of the solver's ``liu.warp`` span: the
flow update u + du, v + dv, frame 2 warped by the flow with the packed-tap
bilinear rule (frame 1 where the sample point leaves the image) and,
under the Laplacian noise model, the per-channel noise estimate.
``resize`` is Liu's resize (the pyramid's levels and the flow's upsampling
between levels), its sample coordinates made on the card. On a CUDA
tensor each launches the kernel (counted in ``warp_update_noise.launches``
and ``resize.launches``, and by device in
``ops/_kernels.LAUNCHES_BY_DEVICE``) or raises; on a CPU tensor each runs
its plain twin, the solver's torch code: ``u + du``, ``celiu.warp_image``
and ``celiu.laplacian_noise``; and the resize with coordinates built on
the host.

The flow, the warp and the resize equal the twin bit for bit on the card;
the noise estimate adds in another order (the kernel's source says why
the flow never sees that).
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _kernels
from ..utils import debug

PX_PER_BLOCK = 256      # pixels a block, one a thread (the kernel's own)
MAX_CHANNELS = 16       # channels the kernel takes (its shared memory)


def _check_f32(**tensors) -> None:
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the liu warps take float32, got "
                             f"{t.dtype}")


def _check_card(C: int, device, tensors) -> None:
    if C > MAX_CHANNELS:
        raise ValueError(f"the liu warp kernel takes at most {MAX_CHANNELS} "
                         f"channels, got {C}")
    for t in tensors:
        if t.device != device:
            raise ValueError(f"all tensors must be on {device}, got "
                             f"{t.device}")


def _images(shape) -> int:
    return int(np.prod(shape[:-3], dtype=np.int64))


def warp_update_noise(im1, im2, u, v, du=None, dv=None, *, noise=False):
    """Frame 2 warped by the flow: im1, im2 (..., H, W, C), u, v (and du,
    dv) (..., H, W), all float32. With du and dv the flow is updated first.
    Returns (u, v, warp, lap_para): the updated flow (u and v themselves
    without du), the warp (..., H, W, C), and with ``noise`` the per-channel
    mean |im1 - warp| over 0 < |.| < 1e6, (..., C), else None."""
    _check_f32(im1=im1, im2=im2, u=u, v=v)
    if im1.ndim < 3 or im1.shape != im2.shape:
        raise ValueError(f"im1 and im2 must share one (..., H, W, C) shape: "
                         f"{tuple(im1.shape)}, {tuple(im2.shape)}")
    flow = tuple(im1.shape[:-1])
    if tuple(u.shape) != flow or tuple(v.shape) != flow:
        raise ValueError(f"u and v must be {flow}: {tuple(u.shape)}, "
                         f"{tuple(v.shape)}")
    if (du is None) != (dv is None):
        raise ValueError("du and dv go together")
    if du is not None:
        _check_f32(du=du, dv=dv)
        if tuple(du.shape) != flow or tuple(dv.shape) != flow:
            raise ValueError(f"du and dv must be {flow}: {tuple(du.shape)}, "
                             f"{tuple(dv.shape)}")
    if not im1.is_cuda:
        return warp_update_noise_plain(im1, im2, u, v, du, dv, noise=noise)

    H, W, C = im1.shape[-3:]
    dev = im1.device
    ins = [t.contiguous() for t in (im1, im2, u, v)]
    upd = [t.contiguous() for t in (du, dv)] if du is not None else []
    _check_card(C, dev, ins + upd)
    B = _images(im1.shape)
    warp = torch.empty(im1.shape, dtype=torch.float32, device=dev)
    u_out = v_out = psum = pcnt = lap = None
    if upd:
        u_out = torch.empty(flow, dtype=torch.float32, device=dev)
        v_out = torch.empty(flow, dtype=torch.float32, device=dev)
    if noise:
        nblk = -(-H * W // PX_PER_BLOCK)
        psum = torch.empty((B, nblk, C), dtype=torch.float64, device=dev)
        pcnt = torch.empty((B, nblk, C), dtype=torch.int32, device=dev)
        lap = torch.empty(tuple(im1.shape[:-3]) + (C,), dtype=torch.float32,
                          device=dev)

    # a missing du, dv or output is a null pointer
    ptrs = [None if t is None else t.data_ptr()
            for t in (*ins, *(upd or (None, None)), u_out, v_out, warp, psum,
                      pcnt, lap)]
    _kernels.library().call("liu_warp_launch", dev, *ptrs, B, H, W, C,
                            PX_PER_BLOCK)
    _kernels.count_launch(warp_update_noise, dev)
    if upd:
        u, v = u_out, v_out
    debug.check_outputs("liu_warp (warp_update_noise)", (u, v, warp, lap))
    return u, v, warp, lap


warp_update_noise.launches = 0


def warp_update_noise_plain(im1, im2, u, v, du=None, dv=None, *,
                            noise=False):
    """The plain twin of ``warp_update_noise``: the solver's torch code."""
    from .celiu import laplacian_noise, warp_image
    if du is not None:
        u = u + du
        v = v + dv
    warp = warp_image(im1, im2, u, v)
    return u, v, warp, laplacian_noise(im1, warp) if noise else None


def resize(img, dst_h: int, dst_w: int, scale: float = 1.0):
    """Liu's resize of img (..., H, W, C) float32 to (..., dst_h, dst_w, C):
    the packed-tap bilinear sample at x = (j + 1) / (dst_w / W) - 1 (and so
    for y), times ``scale`` (as an f32 multiply; 1 leaves it out)."""
    _check_f32(img=img)
    if img.ndim < 3:
        raise ValueError(f"img must be (..., H, W, C), got {tuple(img.shape)}")
    if dst_h < 1 or dst_w < 1:
        raise ValueError(f"resize to {dst_h}x{dst_w}")
    if not img.is_cuda:
        return resize_plain(img, dst_h, dst_w, scale)
    H, W, C = img.shape[-3:]
    dev = img.device
    src = img.contiguous()
    _check_card(C, dev, [src])
    out = torch.empty(tuple(img.shape[:-3]) + (dst_h, dst_w, C),
                      dtype=torch.float32, device=dev)
    # the ratios and the scale rounded to f32 once, as the twin's tensors
    rx, ry = float(np.float32(dst_w / W)), float(np.float32(dst_h / H))
    _kernels.library().call(
        "liu_resize_launch", dev, src.data_ptr(), out.data_ptr(),
        _images(img.shape), H, W, C, dst_h, dst_w, rx, ry,
        float(np.float32(scale)), PX_PER_BLOCK)
    _kernels.count_launch(resize, dev)
    debug.check_outputs("liu_warp (resize)", out)
    return out


resize.launches = 0


def resize_plain(img, dst_h: int, dst_w: int, scale: float = 1.0):
    """The plain twin of ``resize``: coordinates built on the host, then
    ``celiu.bilinear_sample(packed=True)``."""
    from .celiu import bilinear_sample
    H, W = img.shape[-3], img.shape[-2]
    rx = torch.tensor(dst_w / W, dtype=torch.float32)
    ry = torch.tensor(dst_h / H, dtype=torch.float32)
    x = (torch.arange(dst_w, dtype=torch.float32) + 1.0) / rx - 1.0
    y = (torch.arange(dst_h, dtype=torch.float32) + 1.0) / ry - 1.0
    lead = img.shape[:-3]
    xx = x[None, :].expand(lead + (dst_h, dst_w)).to(img.device)
    yy = y[:, None].expand(lead + (dst_h, dst_w)).to(img.device)
    out = bilinear_sample(img, xx, yy, packed=True)
    return out if scale == 1.0 else out * scale
