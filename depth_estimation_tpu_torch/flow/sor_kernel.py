"""Red-black SOR for the celiu IRLS solver (port of
``depth_estimation_tpu.flow.sor_kernel``): kernel B4.

``sor_redblack`` runs n_sor red-black iterations from du = dv = 0. On a
CUDA tensor it launches ``csrc/sor_redblack.cu`` (one thread block per
image, all iterations in one launch, counted in
``sor_redblack.launches``); on a CPU tensor it runs ``celiu.sor_plain``,
the same arithmetic in the same order. The TPU kernel's VMEM gate
(``fits_vmem``) has no counterpart: the CUDA kernel takes every size.
"""

from __future__ import annotations

import numpy as np
import torch

from ..ops import _kernels


def sor_redblack(w_w, w_e, w_n, w_s, denom_u, denom_v, b1, b2, imdxy,
                 *, alpha: float, n_sor: int, omega: float = 1.8):
    """n_sor red-black SOR iterations from du = dv = 0 (order red du, red
    dv, black du, black dv). All operands (..., H, W) float32 with the same
    shape and any leading batch dims. Returns (du, dv) of that shape."""
    planes = (w_w, w_e, w_n, w_s, denom_u, denom_v, b1, b2, imdxy)
    shape = tuple(w_w.shape)
    if len(shape) < 2 or any(tuple(p.shape) != shape for p in planes):
        raise ValueError(f"planes must share one (..., H, W) shape: "
                         f"{[tuple(p.shape) for p in planes]}")
    if n_sor < 0:
        raise ValueError(f"n_sor {n_sor}")
    if not w_w.is_cuda:
        from .celiu import sor_plain
        return sor_plain(*planes, alpha=alpha, n_sor=n_sor, omega=omega)
    H, W = shape[-2:]
    B = int(np.prod(shape[:-2], dtype=np.int64))
    du = torch.zeros(shape, dtype=torch.float32, device=w_w.device)
    dv = torch.zeros(shape, dtype=torch.float32, device=w_w.device)
    ops = []
    for name, p in zip(("w_w", "w_e", "w_n", "w_s", "denom_u", "denom_v",
                        "b1", "b2", "imdxy"), planes):
        p = p.contiguous().reshape(B, H, W)
        _kernels.check_cuda_tensor(name, p, (torch.float32,), 3)
        if p.device != w_w.device:
            raise ValueError("all planes must be on the same device")
        ops.append(p)
    # the constants are rounded to f32 once, here, as the plain version's
    # scalar operands are (1 - omega is formed in double first)
    neg_alpha = float(np.float32(-alpha))
    om = float(np.float32(omega))
    one_minus = float(np.float32(1 - omega))
    lib = _kernels.library()
    with torch.cuda.device(w_w.device):
        lib.call("sor_redblack_launch", *[p.data_ptr() for p in ops],
                 du.data_ptr(), dv.data_ptr(), B, H, W, int(n_sor),
                 neg_alpha, om, one_minus)
    sor_redblack.launches += 1
    return du, dv


sor_redblack.launches = 0
