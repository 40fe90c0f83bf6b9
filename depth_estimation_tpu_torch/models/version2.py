"""version2 network (port of ``depth_estimation_tpu.models.version2``):
contrastive normalization -> a single 17x17 conv (32 features, shared by
both frames) -> a 17x17 SSD match; the trainer head is LogSoftMax(-cost).
The reference frame's features are cropped by the window's asymmetric
halves so that matching is centered (``crop_features_center``).

``flow_batch`` is the throughput path: B pairs normalised as one batch of
2B frames, one trunk call, and the matching core's fused contract (idx,
ey, ex, pmax) from ``ops/matching.match_flow_fast`` (kernel B2 on the
card), in the program's spans ``v2.norm``, ``v2.trunk`` and ``v2.match``;
the pairs go to the counter ``v2.pairs``."""

from __future__ import annotations

import dataclasses
from typing import Tuple

import torch
from torch import nn

from ..geometry import Geometry
from ..ops import matching
from ..ops.normalization import spatial_contrastive_normalization
from ..utils.device import resolve
from ..utils.precision import full_f32
from ..utils.timer import count, profiled_span
from .filters import ConvFilter, init_params
from .flow import crop_features_center


@dataclasses.dataclass(frozen=True)
class V2Params:
    """The version2 trainer's data parameters."""
    wImg: int = 320
    hImg: int = 180
    normalization_k: int = 17
    layers: Tuple[Tuple[int, int, int, int], ...] = ((3, 17, 17, 32),)
    hWin: int = 17
    wWin: int = 17

    def geometry(self) -> Geometry:
        return Geometry(hImg=self.hImg, wImg=self.wImg, layers=self.layers,
                        maxh=self.hWin, maxw=self.wWin,
                        maxhGT=self.hWin, maxwGT=self.wWin,
                        hKernelGT=self.layers[0][1], wKernelGT=self.layers[0][2])


class V2Network(nn.Module):
    """The version2 matcher around a ``ConvFilter`` trunk (load its weights
    with ``models.io.filter_state_from_jax`` into ``self.filter``), on
    ``device``: the card by default; raises where there is none unless
    given ``device="cpu"``."""

    def __init__(self, datap: V2Params = V2Params(), device="cuda"):
        super().__init__()
        self.datap = datap
        self.geometry = datap.geometry()
        self.filter = ConvFilter(self.geometry).to(resolve(device))

    def init(self, generator: torch.Generator) -> "V2Network":
        """Random trunk weights from a CPU ``torch.Generator``."""
        init_params(self.filter, generator)
        return self

    @full_f32()
    def costs(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """(..., hImg, wImg, 3) pair -> (..., H'', W'', hWin * wWin) SSD."""
        g = self.geometry
        k = self.datap.normalization_k
        n1 = spatial_contrastive_normalization(img1, k)
        n2 = spatial_contrastive_normalization(img2, k)
        f1 = crop_features_center(g, self.filter(n1))
        f2 = self.filter(n2)
        return matching.match_ssd(f1, f2, g.maxh, g.maxw)

    @full_f32()
    def log_scores(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """Trainer head: log_softmax(-cost) over the window."""
        return torch.log_softmax(-self.costs(img1, img2), dim=-1)

    @full_f32()
    def flow_batch(self, img1: torch.Tensor, img2: torch.Tensor):
        """Throughput path: (B, hImg, wImg, 3) f32 pairs -> the matching
        core's (idx int32, ey, ex, pmax), each (B, H'', W''). Both frames
        are normalised and go through the trunk as one batch of 2B; the
        match is ``match_flow_fast`` on f32 features (kernel B2 on CUDA
        tensors, its plain twin on the CPU). Reads nothing back to the
        host."""
        g = self.geometry
        B = img1.shape[0]
        with profiled_span("v2.norm"):
            n = spatial_contrastive_normalization(torch.cat((img1, img2)),
                                                  self.datap.normalization_k)
        with profiled_span("v2.trunk"):
            f = self.filter(n)
        with profiled_span("v2.match"):
            out = matching.match_flow_fast(crop_features_center(g, f[:B]),
                                           f[B:], g.maxh, g.maxw)
        count("v2.pairs", B)
        return out
