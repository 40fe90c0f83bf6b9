"""Single-scale patch-correlation flow model (port of
``depth_estimation_tpu.models.flow``): the conv trunk, the half-window crop
of the reference branch, the training heads (the cost volume through the
plain ``match_ssd`` and its log-softmax / softmax, with gradients), the
fused-matcher forward for inference, the target encoding
(``prepare_target``), and the decode of a window distribution into flow
(``process_output``, ``soft_argmax``)."""

from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import torch
from torch import nn

from .. import codecs
from ..geometry import Geometry, Learning
from ..ops import extract, matching
from ..utils.device import resolve, true_div
from ..utils.precision import full_f32
from .filters import ConvFilter, init_params


def crop_features_center(geom: Geometry, f: torch.Tensor) -> torch.Tensor:
    """Crop the reference-branch feature map by the half-window so matching
    is centered: drop ceil(maxh/2)-1 rows at the top and floor(maxh/2) at
    the bottom (same for columns). f (..., H, W, K)."""
    h1, h2 = geom.halfh1, geom.halfh2
    w1, w2 = geom.halfw1, geom.halfw2
    return f[..., h1:f.shape[-3] - h2, w1:f.shape[-2] - w2, :]


class FlowModel(nn.Module):
    """Single-scale matcher around a ``ConvFilter`` trunk (``filter``).
    Without ``trunk`` it builds its own on ``device``: the card by default,
    raising where there is none unless given ``device="cpu"``. A given
    trunk stays where it is and is shared, not copied."""

    def __init__(self, geometry: Geometry, trunk: ConvFilter = None,
                 device="cuda"):
        super().__init__()
        geometry.validate()
        if geometry.multiscale:
            raise ValueError("FlowModel is single-scale")
        self.geometry = geometry
        if trunk is None:
            trunk = ConvFilter(geometry).to(resolve(device))
        self.filter = trunk

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "FlowModel":
        """Random trunk weights from a CPU ``torch.Generator``."""
        init_params(self.filter, generator)
        return self

    @full_f32()
    @torch.no_grad()
    def features(self, image: torch.Tensor) -> torch.Tensor:
        """image (..., H, W, Cin) -> (..., H', W', K), for inference."""
        return self.filter(image)

    # -- training heads (with gradients) -----------------------------------

    @full_f32()
    def costs(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """Cost volume of frame pairs (..., H, W, C): (..., H'', W'',
        maxh * maxw) SSD costs."""
        g = self.geometry
        f1 = crop_features_center(g, self.filter(img1))
        f2 = self.filter(img2)
        return matching.match_ssd(f1, f2, g.maxh, g.maxw)

    @full_f32()
    def log_scores(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """Training head of 'max': log softmax(-cost) over the window."""
        return torch.log_softmax(-self.costs(img1, img2), dim=-1)

    @full_f32()
    def scores(self, img1: torch.Tensor, img2: torch.Tensor) -> torch.Tensor:
        """softmax(-cost) over the window."""
        return torch.softmax(-self.costs(img1, img2), dim=-1)

    @full_f32()
    @torch.no_grad()
    def forward_fused(self, img1: torch.Tensor, img2: torch.Tensor):
        """Fused matcher on a frame pair: (idx, ey, ex, pmax), each (..., H'', W'')."""
        g = self.geometry
        f1 = crop_features_center(g, self.features(img1))
        f2 = self.features(img2)
        return matching.match_flow_fused(f1, f2, g.maxh, g.maxw)


# ---------------------------------------------------------------------------
# Target encoding (prepareTarget)
# ---------------------------------------------------------------------------

def window_bounds(geom: Geometry) -> Tuple[int, int, int, int]:
    """(lo_h, hi_h, lo_w, hi_w): the centered displacements a target may
    take, the window's (the coarsest scale's for a multiscale geometry)."""
    if geom.multiscale:
        mh, mw = geom.maxh * geom.rmax, geom.maxw * geom.rmax
        return (-math.ceil(mh / 2) + 1, mh // 2,
                -math.ceil(mw / 2) + 1, mw // 2)
    return -geom.halfh1, geom.halfh2, -geom.halfw1, geom.halfw2


def prepare_target(geom: Geometry, learning: Learning, target_yx
                   ) -> Tuple[torch.Tensor, torch.Tensor]:
    """Encode continuous GT displacements (..., 2) as (dy, dx) into
    (itarget, target): displacements outside the window become (0, 0);
    itarget is the flat index; with soft targets, target is the
    unnormalized Gaussian exp(-d^2 / st_sigma2) over the window cells
    (..., n_indices), else itarget again. Multiscale geometries clamp to
    the coarsest window."""
    t = torch.as_tensor(target_yx)
    dy, dx = t[..., 0], t[..., 1]
    lo_h, hi_h, lo_w, hi_w = window_bounds(geom)
    inside = (dy >= lo_h) & (dy <= hi_h) & (dx >= lo_w) & (dx <= hi_w)
    dy = torch.where(inside, dy, torch.zeros_like(dy))
    dx = torch.where(inside, dx, torch.zeros_like(dx))
    itarget = codecs.encode(geom, dy, dx)
    if learning.soft_targets:
        off = codecs.window_offsets(geom).to(t.device, torch.float32)
        d2 = (dy[..., None] - off[:, 0]) ** 2 + (dx[..., None] - off[:, 1]) ** 2
        return itarget, torch.exp(true_div(-d2, learning.st_sigma2))
    return itarget, itarget


# ---------------------------------------------------------------------------
# Output decoding (processOutput)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FlowOutput:
    """Decoded flow. y/x are centered displacements (..., H'', W''); full
    is the (..., 2, hImg, wImg) zero-padded full-frame flow; confidences as
    in the reference (1s, or thresholded extract scores)."""
    index: Optional[torch.Tensor]
    y: torch.Tensor
    x: torch.Tensor
    confidences: Optional[torch.Tensor] = None
    full: Optional[torch.Tensor] = None
    full_confidences: Optional[torch.Tensor] = None


def embed_center(x: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Zero (..., h, w) frame with x (..., H, W) set at its center."""
    H, W = x.shape[-2:]
    hoff, woff = (h - H) // 2, (w - W) // 2
    out = x.new_zeros(x.shape[:-2] + (h, w))
    out[..., hoff:hoff + H, woff:woff + W] = x
    return out


def process_output(
    geom: Geometry,
    dist: torch.Tensor,
    process_full: bool = True,
    threshold: Optional[float] = None,
    method: str = "max",
) -> FlowOutput:
    """Decode a window distribution (..., H'', W'', D) into flow. 'max':
    WTA with the middle tie-break (no threshold) or extract_output
    confidences (with threshold); 'mean': the soft-argmax decode, gated by
    the distribution's peak when a threshold is given. Both then assemble
    the full frame with centered zero padding. Leading dims are kept."""
    mid = codecs.middle_index(geom)
    if method == "mean":
        ey, ex = soft_argmax(geom, dist)
        if threshold is None:
            confidences = torch.ones(ey.shape, dtype=dist.dtype,
                                     device=dist.device)
        else:
            pmax = torch.amax(dist, dim=-1)
            confidences = (pmax > threshold).to(dist.dtype)
        out = FlowOutput(index=None, y=ey, x=ex, confidences=confidences)
        y, x = ey, ex
    else:
        if threshold is None:
            best = torch.argmax(dist, dim=-1).to(torch.int32)
            m = torch.amax(dist, dim=-1)
            tie = dist[..., mid] >= m
            index = torch.where(tie, torch.full_like(best, mid), best)
            confidences = torch.ones(index.shape, dtype=dist.dtype,
                                     device=dist.device)
        else:
            index, scores = extract.extract_output(dist, 0.11)
            confidences = (scores > threshold).to(dist.dtype)
        y, x = codecs.decode(geom, index)
        out = FlowOutput(index=index, y=y, x=x, confidences=confidences)
    if process_full:
        yx = torch.stack([y.to(dist.dtype), x.to(dist.dtype)], dim=-3)
        out.full = embed_center(yx, geom.hImg, geom.wImg)
        out.full_confidences = embed_center(confidences, geom.hImg, geom.wImg)
    return out


def soft_argmax(geom: Geometry, dist: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """'mean' head: expectation of the centered (dy, dx) under the
    distribution."""
    off = codecs.window_offsets(geom).to(dist.device, dist.dtype)
    ey = torch.einsum("...d,d->...", dist, off[:, 0])
    ex = torch.einsum("...d,d->...", dist, off[:, 1])
    return ey, ex
