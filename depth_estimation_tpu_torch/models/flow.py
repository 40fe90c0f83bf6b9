"""Single-scale patch-correlation flow model (the inference part of
``depth_estimation_tpu.models.flow``): the conv trunk, the half-window crop
of the reference branch, the fused-matcher forward, and the decode of a
window distribution into flow (``process_output``, ``soft_argmax``)."""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch

from .. import codecs
from ..geometry import Geometry
from ..ops import extract, matching
from .filters import ConvFilter


def crop_features_center(geom: Geometry, f: torch.Tensor) -> torch.Tensor:
    """Crop the reference-branch feature map by the half-window so matching
    is centered: drop ceil(maxh/2)-1 rows at the top and floor(maxh/2) at
    the bottom (same for columns). f (..., H, W, K)."""
    h1, h2 = geom.halfh1, geom.halfh2
    w1, w2 = geom.halfw1, geom.halfw2
    return f[..., h1:f.shape[-3] - h2, w1:f.shape[-2] - w2, :]


class FlowModel:
    """Single-scale matcher around a ``ConvFilter`` trunk."""

    def __init__(self, geometry: Geometry, trunk: ConvFilter = None):
        geometry.validate()
        if geometry.multiscale:
            raise ValueError("FlowModel is single-scale")
        self.geometry = geometry
        self.filter = trunk if trunk is not None else ConvFilter(geometry)

    @torch.no_grad()
    def features(self, image: torch.Tensor) -> torch.Tensor:
        """image (..., H, W, Cin) -> (..., H', W', K)."""
        return self.filter(image)

    @torch.no_grad()
    def forward_fused(self, img1: torch.Tensor, img2: torch.Tensor):
        """Fused matcher on a frame pair: (idx, ey, ex, pmax), each (..., H'', W'')."""
        g = self.geometry
        f1 = crop_features_center(g, self.features(img1))
        f2 = self.features(img2)
        return matching.match_flow_fused(f1, f2, g.maxh, g.maxw)


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
