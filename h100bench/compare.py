"""The comparison that decides ``correct``: gaps between what the timed
path produced and what the plain reference computes from the same inputs,
accumulated over blocks of streams.

  * a widest gap (``widest``): the largest absolute difference, e.g. the
    x-flow in px or a WTA probability;
  * a share in % (``share``): of pixels whose value differs by more than a
    stated amount (a 0/1 mask, a WTA index), or whose depth differs by more
    than 1% of the reference's (a finite depth against an infinite one
    counts as differing).
"""

from __future__ import annotations

import math
from typing import Dict

import torch

DEPTH_REL = 0.01


class Gaps:
    """Accumulates widest gaps and shares over blocks."""

    def __init__(self):
        self.widest: Dict[str, float] = {}
        self.hits: Dict[str, float] = {}
        self.total: Dict[str, float] = {}

    def wide(self, name: str, got: torch.Tensor, want: torch.Tensor) -> None:
        d = (got.double() - want.double()).abs()
        v = float(d.max()) if d.numel() else 0.0
        if not torch.isfinite(got).all() and d.numel():
            v = math.inf
        self.widest[name] = max(self.widest.get(name, 0.0), v)

    def share(self, name: str, differs: torch.Tensor) -> None:
        self.hits[name] = self.hits.get(name, 0.0) + float(differs.sum())
        self.total[name] = self.total.get(name, 0.0) + differs.numel()

    def depth(self, name: str, got: torch.Tensor, want: torch.Tensor) -> None:
        """Share of pixels whose depth is off by more than DEPTH_REL of the
        reference's (inf against finite differs; inf against inf agrees)."""
        fin_g, fin_w = torch.isfinite(got), torch.isfinite(want)
        both = fin_g & fin_w
        rel = (got - want).abs() / want.abs().clamp(min=1e-12)
        off = (fin_g != fin_w) | (both & (rel > DEPTH_REL)) | torch.isnan(got)
        self.share(name, off)

    def numbers(self) -> Dict[str, float]:
        out = dict(self.widest)
        for k, h in self.hits.items():
            out[k] = 100.0 * h / max(self.total[k], 1.0)
        return out


def flow_gaps(g: Gaps, got: dict, want: dict) -> None:
    """The online program's outputs: x-flow (widest, px), the 0/1 mask
    (share differing), depth (share off by > 1%), where present."""
    g.wide("xflow_px", got["xflow"], want["xflow"])
    g.share("mask_pct", ~((got["mask"] - want["mask"]).abs() <= 0.5))
    if "depth" in got:
        g.depth("depth_pct", got["depth"], want["depth"])
