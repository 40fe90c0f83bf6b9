"""Red-black SOR for the celiu IRLS solver (port of
``depth_estimation_tpu.flow.sor_kernel``): kernel B4.

``sor_redblack`` runs n_sor red-black iterations from du = dv = 0. On a
CUDA tensor it launches ``csrc/sor_redblack.cu`` (one thread-block cluster
per image, each CTA owning a strip of rows, all iterations in one launch,
counted in ``sor_redblack.launches``); on a CPU tensor it runs
``celiu.sor_plain``, the same arithmetic in the same order. ``sor_plan``
is the launch's rule on (H, W): how many CTAs share an image, how many rows
each owns, and which planes live in shared memory. The TPU kernel's VMEM
gate (``fits_vmem``) has no counterpart: the plan takes every size.
"""

from __future__ import annotations

from functools import lru_cache
from typing import NamedTuple

import numpy as np
import torch

from ..ops import _kernels
from ..utils import debug

# CTAs an image, at most: the H100 holds 15 clusters of 8 CTAs at once but
# only 7 of 16 (one a GPC), so at B=8 a 16-CTA cluster leaves one image
# waiting (csrc/sor_redblack.cu holds the same limit)
MAX_CLUSTER = 8
PX_PER_CTA = 2048           # pixels a CTA: two updates a thread a sweep
SMEM_LIMIT = 227 * 1024     # shared memory a CTA may use on Hopper
# where the planes live (the kernel's `mode`)
ALL_SHARED, FLOW_SHARED, ALL_GLOBAL = 0, 1, 2


class SorPlan(NamedTuple):
    cluster: int            # CTAs an image, ceil(H / rows)
    rows: int               # rows a CTA owns (the last CTA may own fewer)
    mode: int               # ALL_SHARED, FLOW_SHARED or ALL_GLOBAL


def smem_bytes(mode: int, rows: int, W: int) -> int:
    """Shared memory of one CTA: du/dv of its strip with a halo row above
    and below (unless ALL_GLOBAL), and the nine coefficient planes of the
    strip (ALL_SHARED), each split by colour into rows of ceil(W / 2)."""
    wh = (W + 1) // 2
    flow = 0 if mode == ALL_GLOBAL else 4 * (rows + 2) * wh
    coef = 18 * rows * wh if mode == ALL_SHARED else 0
    return 4 * (flow + coef)


def _ceil(a: int, b: int) -> int:
    return -(-a // b)


@lru_cache(maxsize=None)
def sor_plan(H: int, W: int) -> SorPlan:
    """The launch plan of an (H, W) image: about PX_PER_CTA pixels a CTA
    (at most MAX_CLUSTER CTAs, at least one row each), raised until the
    whole strip fits shared memory; where no cluster size fits it, du/dv
    alone in shared memory at MAX_CLUSTER CTAs, else everything in global
    memory. Memoised: a liu solve asks for its few level shapes again and
    again."""
    cap = min(MAX_CLUSTER, H)
    first = min(cap, max(1, _ceil(H * W, PX_PER_CTA)))
    for c in range(first, cap + 1):
        rows = _ceil(H, c)
        if smem_bytes(ALL_SHARED, rows, W) <= SMEM_LIMIT:
            return SorPlan(_ceil(H, rows), rows, ALL_SHARED)
    rows = _ceil(H, cap)
    mode = (FLOW_SHARED if smem_bytes(FLOW_SHARED, rows, W) <= SMEM_LIMIT
            else ALL_GLOBAL)
    return SorPlan(_ceil(H, rows), rows, mode)


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
    # the kernel writes every pixel of du and dv and reads none
    du = torch.empty(shape, dtype=torch.float32, device=w_w.device)
    dv = torch.empty(shape, dtype=torch.float32, device=w_w.device)
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
    dev = w_w.device
    _kernels.library().call(
        "sor_redblack_launch", dev, *[p.data_ptr() for p in ops],
        du.data_ptr(), dv.data_ptr(), B, H, W, int(n_sor), neg_alpha, om,
        one_minus, *sor_plan(H, W), dev.index)
    _kernels.count_launch(sor_redblack, dev)
    debug.check_outputs("sor_redblack (kernel B4)", (du, dv))
    return du, dv


sor_redblack.launches = 0


def sor_barrier_probe(B: int, H: int, W: int, n_sor: int,
                      device="cuda") -> None:
    """Launch ``sor_redblack``'s plan for B images of (H, W) with every
    half-sweep's boundary-row exchange and cluster barrier but no
    arithmetic: timed against n_sor, it gives B4's dependency floor. Not a
    B4 launch (the counter stays)."""
    du = torch.empty((B, H, W), dtype=torch.float32, device=device)
    dv = torch.empty_like(du)
    _kernels.library().call(
        "sor_redblack_probe_launch", du.device, du.data_ptr(), dv.data_ptr(),
        B, H, W, int(n_sor), *sor_plan(H, W), du.device.index)
