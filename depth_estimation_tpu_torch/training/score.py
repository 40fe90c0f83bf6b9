"""Flow evaluation metrics (port of ``depth_estimation_tpu.training.score``).

``eval_flow`` compares two full-frame (2, H, W) flow fields inside a
border-cropped interior: nGood (|dy| + |dx| == 0), nNear (== 1), nBad
(>= 2), and the RMS, mean and standard deviation of the L2 distance.
Host numpy; tensors are fetched first.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import numpy as np

from ..geometry import Geometry
from ..utils.device import host


class FlowScore(NamedTuple):
    n_good: int
    n_near: int
    n_bad: int
    rms: float
    mean_dst: float
    std_dst: float

    @property
    def accuracy(self) -> float:
        n = self.n_good + self.n_near + self.n_bad
        return self.n_good / n if n else 0.0


def borders(geom: Geometry):
    hborder = math.ceil((max(geom.hKernelGT, geom.hKernel) + geom.maxh) / 2)
    wborder = math.ceil((max(geom.wKernelGT, geom.wKernel) + geom.maxw) / 2)
    return hborder, wborder


def eval_flow(geom: Geometry, output, gt, compute_dst: bool = True) -> FlowScore:
    """output, gt: (2, H, W) full-frame flow (y then x)."""
    output = host(output)
    gt = host(gt)
    hb, wb = borders(geom)
    o = output[:, hb:output.shape[1] - hb, wb:output.shape[2] - wb]
    g = gt[:, hb:gt.shape[1] - hb, wb:gt.shape[2] - wb]
    diff = np.abs(o - g).sum(axis=0)
    n_good = int((diff == 0).sum())
    n_near = int((diff == 1).sum())
    n_bad = int((diff >= 2).sum())
    if not compute_dst:
        return FlowScore(n_good, n_near, n_bad, 0.0, 0.0, 0.0)
    d2 = ((o - g) ** 2).sum(axis=0)
    rms = float(np.sqrt(d2.mean()))
    mean_dst = float(np.sqrt(d2).mean())
    mean_dst2 = float(d2.mean())
    std = float(np.sqrt(max(mean_dst2 - mean_dst * mean_dst, 0.0)))
    return FlowScore(n_good, n_near, n_bad, rms, mean_dst, std)


def epe(output, gt, mask=None) -> float:
    """Plain mean end-point error, optionally masked."""
    output = host(output).astype(np.float64)
    gt = host(gt).astype(np.float64)
    e = np.sqrt(((output - gt) ** 2).sum(axis=0))
    if mask is not None:
        mask = host(mask) > 0
        return float(e[mask].mean()) if mask.any() else 0.0
    return float(e.mean())
