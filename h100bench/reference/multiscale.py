"""The plain reference of the multiscale model's staged decode, in float32
plain PyTorch: a frozen copy of the arithmetic, importing nothing of the
port, of ``jax`` or of the JAX package.

Per scale ratio r: r x r average-pool downsample, zero pad by the patch
size - 1, the shared conv trunk, the reference branch cropped by the
half-window, an SSD cost volume, softmax(-cost). Then the linear cascade
at each scale's own resolution (coarser distributions read at the
ceil-centered cell and replicated down), middle-band removal in the
multiscale codec's layout, and a winner-take-all over the kept cells of
every scale with the zero-flow cell winning ties. Returns, per pixel, the
concatenated-codec index and its probability: ``decode``.
"""

from __future__ import annotations

import math
from typing import List, NamedTuple

import numpy as np
import torch
import torch.nn.functional as F

from .online import avg_downsample, match_ssd, trunk


class Multiscale(NamedTuple):
    """Working size, window, pyramid ratios and the shared trunk's layers
    and weights (on the device)."""
    h: int
    w: int
    maxh: int
    maxw: int
    ratios: tuple
    layers: tuple
    weights: list

    @property
    def patch2(self):
        kh = sum(l[1] - 1 for l in self.layers) + 1
        kw = sum(l[2] - 1 for l in self.layers) + 1
        return self.maxh + kh - 1, self.maxw + kw - 1


def _round_half_up(v: float) -> int:
    return int(math.floor(v + 0.5))


def border(m: Multiscale, i: int) -> int:
    """Width of the ring band kept at scale i (i >= 1)."""
    return _round_half_up(
        m.maxw * (m.ratios[i] - m.ratios[i - 1]) / (2 * m.ratios[i]))


def band_indices(m: Multiscale) -> np.ndarray:
    """Per scale, the cells the middle removal keeps, in codec order:
    entry k is scale * maxh * maxw + flat cell."""
    maxh, maxw = m.maxh, m.maxw
    idx = list(range(maxh * maxw))
    for i in range(1, len(m.ratios)):
        d = border(m, i)
        base = i * maxh * maxw
        for iy in range(d):
            idx.extend(base + iy * maxw + ix for ix in range(maxw))
        for iy in range(d, maxh - d):
            idx.extend(base + iy * maxw + ix for ix in range(d))
        for iy in range(d, maxh - d):
            idx.extend(base + iy * maxw + ix for ix in range(maxw - d, maxw))
        for iy in range(maxh - d, maxh):
            idx.extend(base + iy * maxw + ix for ix in range(maxw))
    return np.asarray(idx, np.int64)


def cascade_map(maxh: int, maxw: int, r: int) -> np.ndarray:
    """Fine-window flat cell -> the coarser (by r) window's flat cell."""
    cy, cx = math.ceil(maxh / 2), math.ceil(maxw / 2)
    out = np.empty(maxh * maxw, np.int64)
    for iy in range(maxh):
        for ix in range(maxw):
            ty = math.ceil((iy + 1 - cy) / r) + cy - 1
            tx = math.ceil((ix + 1 - cx) / r) + cx - 1
            out[iy * maxw + ix] = ty * maxw + tx
    return out


def _replicate(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    if r == 1:
        return x
    return x.repeat_interleave(r, dim=dim).repeat_interleave(r, dim=dim + 1)


def _true_div(t: torch.Tensor, c: float) -> torch.Tensor:
    return t / torch.tensor(float(c), dtype=t.dtype, device=t.device)


def features(m: Multiscale, img1: torch.Tensor, img2: torch.Tensor) -> List:
    """Per scale (cropped reference features, full searched features)."""
    ph, pw = m.patch2[0] - 1, m.patch2[1] - 1
    t, b = math.ceil(m.maxh / 2) - 1, m.maxh // 2
    l, r_ = math.ceil(m.maxw / 2) - 1, m.maxw // 2
    out = []
    for r in m.ratios:
        d1, d2 = (F.pad(avg_downsample(x, r),
                        (0, 0, pw // 2, pw - pw // 2, ph // 2, ph - ph // 2))
                  for x in (img1, img2))
        f1 = trunk(d1, m.weights)
        out.append((f1[..., t:f1.shape[-3] - b, l:f1.shape[-2] - r_, :],
                    trunk(d2, m.weights)))
    return out


@torch.no_grad()
def decode(m: Multiscale, img1: torch.Tensor, img2: torch.Tensor):
    """(B, h, w, 3) frame pairs -> (idx int32, pmax f32), each (B, h, w)."""
    n = len(m.ratios)
    D = m.maxh * m.maxw
    mid = (math.ceil(m.maxh / 2) - 1) * m.maxw + math.ceil(m.maxw / 2) - 1
    dists = [torch.softmax(-match_ssd(f1, f2, m.maxh, m.maxw), dim=-1)
             for f1, f2 in features(m, img1, img2)]
    band = band_indices(m)
    scale_of, cell_of = band // D, band % D
    vals, idxs, sums, mid_p = [], [], [], None
    for s in range(n):
        acc = dists[s]
        Hs, Ws = acc.shape[-3], acc.shape[-2]
        for j in range(s + 1, n):
            r = m.ratios[j] // m.ratios[s]
            sel = torch.from_numpy(cascade_map(m.maxh, m.maxw, r)).to(acc.device)
            gj = _replicate(torch.index_select(dists[j], -1, sel), r, -3)
            acc = acc + gj[..., :Hs, :Ws, :]
        fused = _true_div(acc, n - s)
        if s == 0:
            mid_p = fused[..., mid]
        k = np.zeros(D, bool)
        k[cell_of[scale_of == s]] = True
        keep = torch.from_numpy(k).to(fused.device)
        masked = torch.where(keep, fused, torch.full_like(fused, -1.0))
        v = torch.amax(masked, dim=-1)
        am = torch.argmax(masked, dim=-1)
        # cell -> position in the concatenated codec layout
        lut = np.full(D, -1, np.int64)
        pos = np.nonzero(scale_of == s)[0]
        lut[cell_of[pos]] = pos
        ci = torch.from_numpy(lut).to(fused.device)[am].to(torch.int32)
        ssum = torch.where(keep, fused, torch.zeros_like(fused)).sum(-1)
        r = m.ratios[s]
        vals.append(_replicate(v, r, -2)[..., :m.h, :m.w])
        idxs.append(_replicate(ci, r, -2)[..., :m.h, :m.w])
        sums.append(_replicate(ssum, r, -2)[..., :m.h, :m.w])
    total, bm, bi = sums[0], vals[0], idxs[0]
    for s in range(1, n):
        total = total + sums[s]
        bi = torch.where(vals[s] > bm, idxs[s], bi)
        bm = torch.maximum(bm, vals[s])
    tie = mid_p >= bm
    idx = torch.where(tie, torch.full_like(bi, mid), bi)
    return idx, torch.where(tie, mid_p, bm) / total
