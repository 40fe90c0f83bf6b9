"""Local contrastive normalization (port of
``depth_estimation_tpu.ops.normalization``), as torch's
nn.SpatialContrastiveNormalization computes it: a separable gaussian
window normalized over kernel-sum x channels gives a cross-channel local
mean (subtracted) and local std (divided, floored by its spatial mean), with
border renormalization by the convolved coefficient map. The version2
network normalizes its inputs with it; the legacy CNN's subtractive
normalization (``models.legacy_depth``) is its first half.

``spatial_contrastive_normalization`` routes by what it is handed. A card
tensor takes the hand-written kernel (``contrastive_norm``,
``csrc/contrastive_norm.cu``: two launches around torch's reduce, bit for
bit the torch code on the card), which raises for a dtype other than
float32, a window outside 1 to 33 taps or a channel count outside 1 to 4
(``kernel_refusal``); an input that requires grad gets the torch code's
gradient, recomputed in the backward pass. The torch code,
``spatial_contrastive_normalization_plain``, runs on the CPU and wherever
no card tensor holds data: torch.compile, torch.export, make_fx and
fake-tensor tracing. Kernel calls are counted on the wrapper
(``contrastive_norm.launches``), by device in
``ops/_kernels.LAUNCHES_BY_DEVICE``."""

from __future__ import annotations

import ctypes
from functools import lru_cache
from numbers import Integral
from typing import Optional

import numpy as np
import torch

from ..utils import debug
from . import _kernels

KERNEL_TAPS = range(1, 34)        # the windows the kernel takes
KERNEL_CHANNELS = range(1, 5)     # and the channel counts


def gaussian1d(k: int, sigma: float = 0.25) -> np.ndarray:
    """torch image.gaussian1D: size k, sigma relative to size, amplitude 1,
    centered."""
    x = np.arange(k, dtype=np.float64)
    center = (k - 1) / 2
    g = np.exp(-((x - center) / (sigma * k)) ** 2 / 2)
    return g.astype(np.float32)


def _sep_conv_same(x: torch.Tensor, f: np.ndarray) -> torch.Tensor:
    """Separable 'same' correlation with zero padding over the last two
    dims of x (..., H, W), the taps summed in order (rows, then columns)."""
    r = len(f) // 2
    H, W = x.shape[-2:]
    xp = torch.nn.functional.pad(x, (0, 0, r, r))
    out = torch.zeros_like(x)
    for i, w in enumerate(f):
        out = out + float(w) * xp[..., i:i + H, :]
    xp = torch.nn.functional.pad(out, (r, r))
    out2 = torch.zeros_like(x)
    for i, w in enumerate(f):
        out2 = out2 + float(w) * xp[..., i:i + W]
    return out2


def _channel_sum(x: torch.Tensor, f: np.ndarray) -> torch.Tensor:
    """sum_c _sep_conv_same(x[..., c], f) for x (..., H, W, C): every
    channel convolved at once (the same taps in the same order on each),
    then summed in c order."""
    conv = _sep_conv_same(x.movedim(-1, -3), f)          # (..., C, H, W)
    acc = conv[..., 0, :, :]
    for c in range(1, conv.shape[-3]):
        acc = acc + conv[..., c, :, :]
    return acc


def _border_map(hw, f: np.ndarray, C: int, dtype, device) -> torch.Tensor:
    """The border-renormalization map (H, W): the window's sum over the
    frame, times C, clamped at 1e-8."""
    ones = torch.ones(hw, dtype=dtype, device=device)
    return torch.clamp(_sep_conv_same(ones, f) * C, min=1e-8)


def _local_mean(img: torch.Tensor, f: np.ndarray):
    """The border-renormalization map and the cross-channel local mean of
    img (..., H, W, C) under the normalized window f."""
    coef = _border_map(img.shape[-3:-1], f, img.shape[-1], img.dtype,
                       img.device)
    return coef, _channel_sum(img, f) / coef


def _window(k: int, C: int) -> np.ndarray:
    f = gaussian1d(k)
    return f / (f.sum() * C)          # torch kernel normalization


def spatial_contrastive_normalization_plain(img: torch.Tensor,
                                            k: int = 17) -> torch.Tensor:
    """The torch code (the kernel's twin): img (..., H, W, C) -> same shape,
    gaussian window of size k; each leading index is one image (the std
    floor is that image's mean std)."""
    C = img.shape[-1]
    f = _window(k, C)
    coef, mean = _local_mean(img, f)
    v = img - mean[..., None]
    sq = v * v
    local_var = _channel_sum(sq, f)
    local_std = torch.sqrt(torch.clamp(local_var / coef, min=0.0))
    thresh = torch.maximum(local_std, local_std.mean(dim=(-2, -1), keepdim=True))
    thresh = torch.clamp(thresh, min=1e-4)
    return v / thresh[..., None]


_TRACING_MODES = (torch._C._TorchDispatchModeKey.FAKE,
                  torch._C._TorchDispatchModeKey.PROXY,
                  torch._C._TorchDispatchModeKey.FUNCTIONAL)


def _tracing() -> bool:
    """Whether tensors stand in for data here (torch.compile, torch.export,
    make_fx, a fake-tensor mode), so that a kernel launched outside the
    dispatcher would be missed or would read no memory."""
    if torch.compiler.is_compiling():
        return True
    return any(torch._C._get_dispatch_mode(key) is not None
               for key in _TRACING_MODES)


def kernel_refusal(img: torch.Tensor, k) -> Optional[str]:
    """Why the kernel does not take ``(img, k)``, or None where it does
    (an empty batch included: nothing to launch)."""
    if img.dtype != torch.float32:
        return "dtype"
    if img.ndim < 3:
        return "shape"
    if isinstance(k, bool) or not isinstance(k, Integral) \
            or k not in KERNEL_TAPS:
        return "window"
    if img.shape[-1] not in KERNEL_CHANNELS:
        return "channels"
    if img.shape[-3] * img.shape[-2] * img.shape[-1] >= 2 ** 31 - 1:
        return "frame size"
    if not img.is_cuda:
        return "cpu"
    return None


def spatial_contrastive_normalization(img: torch.Tensor, k: int = 17) -> torch.Tensor:
    """img (..., H, W, C) -> same shape, gaussian window of size k; each
    leading index is one image (the std floor is that image's mean std).
    The kernel on a card tensor (raising for what it does not take), the
    torch code on the CPU and under a trace; the same bits either way."""
    if not img.is_cuda or _tracing():
        return spatial_contrastive_normalization_plain(img, k)
    if torch.is_grad_enabled() and img.requires_grad:
        return _KernelWithTwinGrad.apply(img, k)
    return contrastive_norm(img, k)


class _KernelWithTwinGrad(torch.autograd.Function):
    """The kernel forward, the torch code's gradient backward: the twin
    recomputed from the saved input and differentiated, so that higher
    derivatives are the twin's too."""

    @staticmethod
    def forward(ctx, img, k):
        ctx.save_for_backward(img)
        ctx.k = k
        return contrastive_norm(img, k)

    @staticmethod
    def backward(ctx, grad):
        img, = ctx.saved_tensors
        with torch.enable_grad():
            out = spatial_contrastive_normalization_plain(img, ctx.k)
        dimg, = torch.autograd.grad(out, img, grad,
                                    create_graph=torch.is_grad_enabled())
        return dimg, None


@lru_cache(maxsize=64)
def _taps(k: int, C: int):
    """The window's k taps as the f32 values the twin multiplies by."""
    f = _window(k, C)
    return (ctypes.c_float * k)(*[float(w) for w in f])


_COEF = {}          # (H, W, k, C, device) -> the border map
_COEF_MAX = 16


def _coef(H: int, W: int, k: int, C: int, device: torch.device):
    """The border map (H, W) of a window and channel count on ``device``,
    made by the twin's own code: it never depends on the frames. Kept
    once complete (the making stream synchronised, so that any stream may
    read it); inside a CUDA-graph capture it is made in the graph and not
    kept."""
    key = (H, W, k, C, device)
    coef = _COEF.get(key)
    if coef is not None:
        return coef
    with torch.no_grad():
        coef = _border_map((H, W), _window(k, C), C, torch.float32, device)
    if device.type == "cuda":
        with torch.cuda.device(device):
            if torch.cuda.is_current_stream_capturing():
                return coef
            torch.cuda.current_stream(device).synchronize()
    if len(_COEF) >= _COEF_MAX:
        _COEF.pop(next(iter(_COEF)))
    _COEF[key] = coef
    return coef


def contrastive_norm(img: torch.Tensor, k: int = 17) -> torch.Tensor:
    """The kernel's route (``csrc/contrastive_norm.cu``): img (..., H, W, C)
    float32 on a card, k in ``KERNEL_TAPS``, C in ``KERNEL_CHANNELS``;
    raises ``ValueError`` for anything else (``kernel_refusal``). The local
    mean and std in one launch, their per-frame mean by torch's reduce (the
    twin's own), the output in a second launch. Counted in
    ``contrastive_norm.launches``."""
    why = kernel_refusal(img, k)
    if why is not None:
        raise ValueError(
            f"contrastive_norm ({why}): takes a CUDA float32 (..., H, W, C) "
            f"tensor, a window of {KERNEL_TAPS.start} to "
            f"{KERNEL_TAPS.stop - 1} taps and {KERNEL_CHANNELS.start} to "
            f"{KERNEL_CHANNELS.stop - 1} channels; got {img.dtype} "
            f"{tuple(img.shape)} on {img.device}, k={k!r}")
    k = int(k)
    H, W, C = img.shape[-3:]
    lead = tuple(img.shape[:-3])
    x = img.contiguous()
    if x.numel() == 0:
        return torch.empty_like(x)
    dev = x.device
    B = x.numel() // (H * W * C)
    coef = _coef(H, W, k, C, dev)
    mean = torch.empty(lead + (H, W), dtype=torch.float32, device=dev)
    std = torch.empty_like(mean)
    lib = _kernels.library()
    lib.call("contrastive_norm_stats_launch", dev, x.data_ptr(),
             coef.data_ptr(), mean.data_ptr(), std.data_ptr(),
             ctypes.addressof(_taps(k, C)), k, B, H, W, C)
    frame = std.mean(dim=(-2, -1), keepdim=True)
    out = torch.empty_like(x)
    lib.call("contrastive_norm_apply_launch", dev, x.data_ptr(),
             mean.data_ptr(), std.data_ptr(), frame.data_ptr(),
             out.data_ptr(), B, H, W, C)
    _kernels.count_launch(contrastive_norm, dev)
    debug.check_outputs("contrastive_norm", out)
    return out


contrastive_norm.launches = 0
