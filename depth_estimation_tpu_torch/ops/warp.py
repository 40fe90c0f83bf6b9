"""Banded bilinear warp (port of ``depth_estimation_tpu.ops.warp``).

Bilinear sample of ``imgs`` at ``(ys, xs)``, exact wherever the sample
displacement ``|(ys, xs) - (y, x)|`` is at most ``band`` on both axes;
beyond that the taps are clipped to shifts in ``[-band, band+1]`` and the
caller masks the pixel (``undistort.ego_motion_valid_mask(..., band=band)``).
Out-of-image taps read zeros.

The TPU kernel writes this as a sum over (2*band+2)^2 static shifts because
TPU gathers are slow; the hat weights leave at most four non-zero taps, so
both the CUDA kernel (``csrc/warp_banded.cu``) and the plain version here
compute those four taps, grouped as the reference's XLA form groups them.
"""

from __future__ import annotations

import torch

from . import _kernels


def banded_bilinear_warp_plain(imgs: torch.Tensor, xs: torch.Tensor,
                               ys: torch.Tensor, band: int = 8) -> torch.Tensor:
    """Plain-torch twin of the kernel: four band-clipped, zero-bordered taps.
    imgs (B, H, W, C) f32, bf16 or f16 (each tap upcast to f32), xs/ys
    (B, H, W) -> (B, H, W, C) f32."""
    B, H, W, C = imgs.shape
    dev = imgs.device
    ii = torch.arange(H, dtype=torch.float32, device=dev)[None, :, None]
    jj = torch.arange(W, dtype=torch.float32, device=dev)[None, None, :]
    dyf = ys.float() - ii
    dxf = xs.float() - jj
    s0 = torch.floor(dyf)
    t0 = torch.floor(dxf)
    flat = imgs.reshape(B, H * W, C)

    def axis_taps(f, d0, grid, n):
        taps = []
        for sh in (d0, d0 + 1):
            inband = (sh >= -band) & (sh <= band + 1)
            pos = grid + sh
            ok = inband & (pos >= 0) & (pos <= n - 1)
            w = torch.clamp(1 - torch.abs(f - sh), min=0.0)
            taps.append((torch.where(ok, pos, 0.0).long(), ok, w))
        return taps

    ys_t = axis_taps(dyf, s0, ii, H)
    xs_t = axis_taps(dxf, t0, jj, W)

    def tap(ty, tx):
        (yi, yok, _), (xi, xok, _) = ty, tx
        idx = (yi * W + xi).reshape(B, H * W, 1).expand(B, H * W, C)
        v = torch.gather(flat, 1, idx).reshape(B, H, W, C).float()
        return torch.where((yok & xok)[..., None], v, torch.zeros_like(v))

    wx0, wx1 = xs_t[0][2][..., None], xs_t[1][2][..., None]
    rows = [wx0 * tap(ty, xs_t[0]) + wx1 * tap(ty, xs_t[1]) for ty in ys_t]
    return ys_t[0][2][..., None] * rows[0] + ys_t[1][2][..., None] * rows[1]


def _banded_bilinear_warp_cuda(imgs: torch.Tensor, xs: torch.Tensor,
                               ys: torch.Tensor, band: int) -> torch.Tensor:
    """Kernel B3 on CUDA tensors."""
    imgs = imgs.contiguous()
    xs = xs.float().contiguous()
    ys = ys.float().contiguous()
    _kernels.check_cuda_tensor("imgs", imgs, tuple(_kernels.STORAGE), 4)
    _kernels.check_cuda_tensor("xs", xs, (torch.float32,), 3)
    _kernels.check_cuda_tensor("ys", ys, (torch.float32,), 3)
    if xs.device != imgs.device or ys.device != imgs.device:
        raise ValueError("imgs, xs and ys must be on the same device")
    B, H, W, C = imgs.shape
    out = torch.empty((B, H, W, C), dtype=torch.float32, device=imgs.device)
    _kernels.library().call(
        "warp_banded_launch", imgs.device, imgs.data_ptr(), xs.data_ptr(),
        ys.data_ptr(), out.data_ptr(), B, H, W, C, int(band),
        _kernels.STORAGE[imgs.dtype])
    _kernels.count_launch(banded_bilinear_warp, imgs.device)
    return out


# B3 as the operator ``depth_estimation_tpu_torch::banded_bilinear_warp``, so
# that torch.export keeps it as one node of an exported program: the kernel
# for CUDA tensors, the plain twin for CPU tensors, chosen by the dispatcher.
@torch.library.custom_op("depth_estimation_tpu_torch::banded_bilinear_warp",
                         mutates_args=(), device_types="cpu")
def banded_bilinear_warp_op(imgs: torch.Tensor, xs: torch.Tensor,
                            ys: torch.Tensor, band: int) -> torch.Tensor:
    """B3 on imgs (B, H, W, C) f32, bf16 or f16 and xs, ys (B, H, W):
    (B, H, W, C) f32."""
    return banded_bilinear_warp_plain(imgs, xs, ys, band)


@banded_bilinear_warp_op.register_kernel("cuda")
def _(imgs, xs, ys, band):
    return _banded_bilinear_warp_cuda(imgs, xs, ys, band)


@banded_bilinear_warp_op.register_fake
def _(imgs, xs, ys, band):
    return imgs.new_empty(imgs.shape, dtype=torch.float32)


def banded_bilinear_warp(imgs: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor,
                         band: int = 8, block_rows: int = 16) -> torch.Tensor:
    """imgs (B, H, W, C) channels-last f32, bf16 or f16 (on CUDA tensors
    any other type raises ValueError); xs, ys (B, H, W) sample
    coordinates. Returns (B, H, W, C) f32. The work is the operator
    ``banded_bilinear_warp_op``: CUDA tensors go through the kernel
    (counted in ``banded_bilinear_warp.launches``), CPU tensors through
    ``banded_bilinear_warp_plain``. ``block_rows`` is accepted for
    signature parity with the reference and has no effect."""
    if imgs.ndim != 4 or tuple(xs.shape) != tuple(imgs.shape[:3]) \
            or tuple(ys.shape) != tuple(imgs.shape[:3]):
        raise ValueError(f"shapes {tuple(imgs.shape)} / {tuple(xs.shape)} / "
                         f"{tuple(ys.shape)}")
    return banded_bilinear_warp_op(imgs, xs, ys, int(band))


banded_bilinear_warp.launches = 0
