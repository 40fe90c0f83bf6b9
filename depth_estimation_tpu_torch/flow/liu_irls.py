"""The liu solve's IRLS coefficient planes: one kernel launch a step
(``csrc/liu_irls.cu``).

``irls_planes`` is one step of the solver's ``liu.irls`` span under the
Laplacian noise model: the derivatives of both features, Phi, Psi, the
five channel means, both weighted Laplacians and the nine planes that the
SOR (kernel B4, ``sor_kernel.sor_redblack``) reads, from a cold start or
a warm start's du, dv. On a CUDA tensor it launches the kernel (counted in
``irls_planes.launches``, and by device in
``ops/_kernels.LAUNCHES_BY_DEVICE``) or raises; on a CPU tensor it runs
its plain twin, the solver's torch code ``celiu._irls_planes``. The kernel
equals the twin bit for bit on the card (the kernel's source says how).
"""

from __future__ import annotations

import ctypes
from functools import lru_cache

import numpy as np
import torch

from ..ops import _kernels
from ..utils import debug

CHANNELS = (3, 5)       # the features of gray and of colour pairs


@lru_cache(maxsize=64)
def _consts(alpha: float, n_out: int, C: int):
    """The kernel's scalars (``struct Consts``) as the f32 values torch
    rounds the twin's Python scalars to: the Gaussian's and the
    derivative's taps, the average's 0.4 and 0.6, Phi's and Psi's epsilon,
    the noise mask's 1e-20, alpha, alpha * 0.05, and the factor torch's
    CUDA mean multiplies a channel sum by, float(n_out) / float(n_out C).
    Made once a level shape (a solve's steps share them); the kernel's
    launcher copies them and writes nothing back."""
    from .celiu import _DERIV5, _GFILTER
    factor = np.float32(n_out) / np.float32(n_out * C)
    vals = [*_GFILTER, *_DERIV5, 0.4, 0.6, 1e-6, 1e-6, 1e-20, alpha,
            alpha * 0.05, factor]
    return (ctypes.c_float * len(vals))(*[float(np.float32(x)) for x in vals])


def irls_planes(im1f, warp, u, v, lap_para, *, alpha: float, du=None,
                dv=None):
    """An IRLS step's planes under the Laplacian noise model: im1f and warp
    (..., H, W, C), u, v (and a warm start's du, dv) (..., H, W), lap_para
    (..., C), all float32, C one of ``CHANNELS`` (other counts raise, on
    the CPU too). Returns (w_w, w_e, w_n, w_s, denom_u, denom_v, b1, b2,
    imdxy), each (..., H, W), the arguments of ``sor_redblack``; on the
    card nine views of one allocation."""
    tensors = dict(im1f=im1f, warp=warp, u=u, v=v, lap_para=lap_para)
    if (du is None) != (dv is None):
        raise ValueError("du and dv go together")
    if du is not None:
        tensors.update(du=du, dv=dv)
    for name, t in tensors.items():
        if t.dtype != torch.float32:
            raise ValueError(f"{name}: the IRLS planes take float32, got "
                             f"{t.dtype}")
        if t.device != im1f.device:
            raise ValueError(f"all tensors must be on {im1f.device}, got "
                             f"{name} on {t.device}")
    if im1f.ndim < 3 or im1f.shape != warp.shape:
        raise ValueError(f"im1f and warp must share one (..., H, W, C) "
                         f"shape: {tuple(im1f.shape)}, {tuple(warp.shape)}")
    flow, C = tuple(im1f.shape[:-1]), im1f.shape[-1]
    for name in ("u", "v", "du", "dv"):
        if name in tensors and tuple(tensors[name].shape) != flow:
            raise ValueError(f"{name} must be {flow}, got "
                             f"{tuple(tensors[name].shape)}")
    if tuple(lap_para.shape) != flow[:-2] + (C,):
        raise ValueError(f"lap_para must be {flow[:-2] + (C,)}, got "
                         f"{tuple(lap_para.shape)}")
    if C not in CHANNELS:
        raise ValueError(f"the IRLS kernel takes {CHANNELS} channels, got "
                         f"{C}")
    if not im1f.is_cuda:
        from .celiu import _irls_planes
        return _irls_planes(im1f, warp, u, v, lap_para, alpha=alpha,
                            noise_model="lap", du=du, dv=dv)

    H, W = flow[-2:]
    n_out = int(np.prod(flow, dtype=np.int64))
    dev = im1f.device
    ins = [t.contiguous() for t in tensors.values()]
    planes = torch.empty((9,) + flow, dtype=torch.float32,
                         device=dev).unbind(0)
    ptrs = [t.data_ptr() for t in ins[:4]]
    ptrs += [t.data_ptr() for t in ins[5:]] or [None, None]
    consts = _consts(alpha, n_out, C)
    _kernels.library().call(
        "liu_irls_launch", dev, *ptrs, ins[4].data_ptr(),
        *[p.data_ptr() for p in planes], ctypes.addressof(consts),
        len(consts), n_out // (H * W), H, W, C)
    _kernels.count_launch(irls_planes, dev)
    debug.check_outputs("liu_irls (irls_planes)", planes)
    return planes


irls_planes.launches = 0
