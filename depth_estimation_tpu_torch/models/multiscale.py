"""Multiscale (foveated pyramid) flow model (port of
``depth_estimation_tpu.models.multiscale``): a coarse-to-fine matcher.

  * per-ratio pyramid: r x r average-pool downsample, zero pad by the
    patch size - 1, a conv trunk (shared by the scales, or one per scale),
    an SSD match per scale;
  * cascading score fusion: each finer scale's window distribution gets the
    central crop of every coarser scale's, read at the ceil-centered cell
    ``ceil(centered / r)``, averaged over the contributing scales (or the
    trainable-beta power form);
  * middle-band removal + concatenation: at each coarse scale the center
    already covered by finer scales is dropped and the four remaining
    bands (top, left, right, bottom) are laid out in the multiscale codec's
    order, so ``codecs.decode`` reads the concatenated distribution.

The reference selects cells with one-hot matrix products (a TPU choice);
here every selection is an ``index_select`` with the same maps, exact on
every device. Layouts are channels-last; every function takes leading
batch dims. The model is an ``nn.Module`` holding its trunk(s)
(``filters``) and, with trainable cascade weights, ``betas``; weights come
from the flax tree through ``models.io.multiscale_state_from_jax`` or from
a seed through ``init``.
"""

from __future__ import annotations

import math
from functools import lru_cache
from typing import List, Optional, Tuple

import numpy as np
import torch
from torch import nn

from .. import codecs
from ..geometry import Geometry
from ..ops import matching
from ..utils.device import resolve, true_div
from ..utils.precision import full_f32
from ..utils.timer import profiled_span
from .filters import ConvFilter, init_params
from .flow import crop_features_center


# ---------------------------------------------------------------------------
# Cascade maps
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _cascade_map(maxh: int, maxw: int, r: int) -> np.ndarray:
    """(maxh*maxw,) int32: fine-window flat cell -> coarse-window flat cell
    of a scale coarser by factor r, via the ceil-centered mapping."""
    cy, cx = math.ceil(maxh / 2), math.ceil(maxw / 2)
    out = np.empty(maxh * maxw, np.int32)
    for iy in range(maxh):
        for ix in range(maxw):
            ii = iy + 1 - cy           # centered, 1-based arithmetic
            jj = ix + 1 - cx
            ty = math.ceil(ii / r) + cy - 1
            tx = math.ceil(jj / r) + cx - 1
            out[iy * maxw + ix] = ty * maxw + tx
    return out


def _select(x: torch.Tensor, index: np.ndarray) -> torch.Tensor:
    """x[..., index] along the last dim."""
    return torch.index_select(
        x, -1, torch.from_numpy(index.astype(np.int64)).to(x.device))


def _coarse_to_fine(x: torch.Tensor, maxh: int, maxw: int, r: int) -> torch.Tensor:
    """A coarser scale's distribution read at each fine cell's coarse cell."""
    return _select(x, _cascade_map(maxh, maxw, r))


def cascade(geom: Geometry, dists: List[torch.Tensor],
            normalize: bool = True) -> List[torch.Tensor]:
    """Coarse-to-fine fusion. dists[i]: (..., maxh*maxw) distribution at
    scale ratios[i]. Returns the same-shaped list: out[i] = mean_{j >= i}
    of dists[j] read at the fine cells (the sum if not ``normalize``)."""
    n = len(geom.ratios)
    out = []
    for i in range(n):
        acc = dists[i]
        for j in range(i + 1, n):
            r = geom.ratios[j] // geom.ratios[i]
            acc = acc + _coarse_to_fine(dists[j], geom.maxh, geom.maxw, r)
        if normalize:
            acc = true_div(acc, n - i)
        out.append(acc)
    return out


def cascade_beta(geom: Geometry, dists: List[torch.Tensor],
                 betas: torch.Tensor, single_beta: bool = False
                 ) -> List[torch.Tensor]:
    """Trainable-beta cascade: out[i] = (w1 in[i] + w2 out[i+1] read at the
    fine cells) ** pow with pow = -1 / sqrt(w1 w2), pow a constant for the
    gradient (the reference updates it after each SGD step). Weights start
    at -1; ``single_beta`` shares one weight per link."""
    n = len(geom.ratios)
    if n < 2:
        raise ValueError("cascade_beta needs at least two scales")
    out: List = [None] * n
    out[n - 1] = dists[n - 1]
    for i in range(n - 2, -1, -1):
        if single_beta:
            w1 = w2 = betas[i]
        else:
            w1, w2 = betas[i, 0], betas[i, 1]
        r = geom.ratios[i + 1] // geom.ratios[i]
        s = w1 * dists[i] + w2 * _coarse_to_fine(out[i + 1], geom.maxh,
                                                 geom.maxw, r)
        prod = (w1 * w2).detach()
        # sqrt of a negative product is NaN in the reference too; the tiny
        # floor only guards the exactly-zero case
        root = torch.sqrt(torch.clamp(prod, min=1e-12))
        pw = torch.div(torch.full_like(root, -1.0), root)
        out[i] = torch.pow(s, pw)
    return out


def init_cascade_betas(geom: Geometry) -> torch.Tensor:
    """Initial weights -1: shape (n_links,) with single_beta, else
    (n_links, 2)."""
    n_links = len(geom.ratios) - 1
    shape = (n_links,) if geom.single_beta else (n_links, 2)
    return torch.full(shape, -1.0)


def apply_cascade(geom: Geometry, betas: Optional[torch.Tensor],
                  dists: List[torch.Tensor]) -> List[torch.Tensor]:
    """The trainable-beta cascade where the geometry asks for it (``betas``
    then holds the weights), the shipped mean cascade otherwise."""
    if geom.cascad_trainable_weights:
        return cascade_beta(geom, dists, betas, geom.single_beta)
    return cascade(geom, dists)


# ---------------------------------------------------------------------------
# Middle removal + band concatenation (the multiscale index layout)
# ---------------------------------------------------------------------------

@lru_cache(maxsize=None)
def _band_indices(geom: Geometry) -> np.ndarray:
    """Concatenated gather indices selecting, per scale, the cells kept by
    the middle removal, in codec order. Shape (n_indices,); entry k is
    scale * maxh * maxw + flat cell."""
    maxh, maxw = geom.maxh, geom.maxw
    idx = list(range(maxh * maxw))          # scale 0: everything
    for i in range(1, len(geom.ratios)):
        d = codecs._border(geom, i)
        base = i * maxh * maxw
        for iy in range(d):                                   # top band
            idx.extend(base + iy * maxw + ix for ix in range(maxw))
        for iy in range(d, maxh - d):                         # left band
            idx.extend(base + iy * maxw + ix for ix in range(d))
        for iy in range(d, maxh - d):                         # right band
            idx.extend(base + iy * maxw + ix for ix in range(maxw - d, maxw))
        for iy in range(maxh - d, maxh):                      # bottom band
            idx.extend(base + iy * maxw + ix for ix in range(maxw))
    out = np.asarray(idx, np.int32)
    if out.shape[0] != codecs.n_indices(geom):
        raise AssertionError((out.shape, codecs.n_indices(geom)))
    return out


def middle_removal_concat(geom: Geometry, dists: List[torch.Tensor]) -> torch.Tensor:
    """Per-scale (..., maxh*maxw) distributions -> (..., n_indices) in the
    multiscale codec's layout."""
    return _select(torch.cat(dists, dim=-1), _band_indices(geom))


def log_eps(x: torch.Tensor, eps: float = 1e-10) -> torch.Tensor:
    """log with the input clamped below at eps (NaN guard before NLL)."""
    return torch.log(torch.clamp(x, min=eps))


# ---------------------------------------------------------------------------
# Pyramid helpers
# ---------------------------------------------------------------------------

def avg_downsample(img: torch.Tensor, r: int) -> torch.Tensor:
    """Average over non-overlapping r x r blocks. img (..., H, W, C)."""
    if r == 1:
        return img
    *lead, H, W, C = img.shape
    img = img[..., : (H // r) * r, : (W // r) * r, :]
    img = img.reshape(*lead, H // r, r, W // r, r, C)
    return img.mean(dim=(-4, -2))


def pad_patch_border(geom: Geometry, img: torch.Tensor) -> torch.Tensor:
    """Zero-pad (..., H, W, C) by (hPatch2 - 1, wPatch2 - 1), split
    floor/ceil."""
    hP, wP = geom.hPatch2 - 1, geom.wPatch2 - 1
    return torch.nn.functional.pad(
        img, (0, 0, wP // 2, wP - wP // 2, hP // 2, hP - hP // 2))


def _slice_start(start: int, dim: int, size: int) -> int:
    """Where a dynamic slice of ``size`` at ``start`` lands in an axis of
    ``dim``: a negative start counts from the end, then the slice is
    clamped into the axis."""
    if start < 0:
        start += dim
    return min(max(start, 0), dim - size)


def _replicate(x: torch.Tensor, r: int, dim: int) -> torch.Tensor:
    """Upsample by r along dims ``dim`` and ``dim + 1`` by replication
    (0-based row Y reads coarse row Y // r)."""
    if r == 1:
        return x
    return x.repeat_interleave(r, dim=dim).repeat_interleave(r, dim=dim + 1)


class MultiscaleFlowModel(nn.Module):
    """Multiscale matcher, on ``device`` (the card by default; raises where
    there is none unless given ``device="cpu"``). ``decode_dtype`` is the
    feature storage type of the staged decode (None keeps f32; f16 halves
    the match's load traffic); ``forward_full`` and the fovea paths stay in
    full precision."""

    def __init__(self, geometry: Geometry, decode_dtype=None, device="cuda"):
        super().__init__()
        geometry.validate()
        if not geometry.multiscale:
            raise ValueError("MultiscaleFlowModel needs a multiscale geometry")
        if geometry.output_extraction_method != "max":
            raise ValueError("multiscale supports the 'max' head only")
        self.geometry = geometry
        self.decode_dtype = decode_dtype
        n_filters = 1 if geometry.share_filters else len(geometry.ratios)
        self.filters = nn.ModuleList(ConvFilter(geometry)
                                     for _ in range(n_filters))
        if geometry.cascad_trainable_weights:
            self.betas = nn.Parameter(init_cascade_betas(geometry))
        else:
            self.betas = None
        self.to(resolve(device))

    @torch.no_grad()
    def init(self, generator: torch.Generator) -> "MultiscaleFlowModel":
        """Random trunk weights from a CPU ``torch.Generator`` (one draw per
        scale's trunk where they are not shared), betas at -1."""
        init_params(self.filters, generator)
        if self.betas is not None:
            self.betas.fill_(-1.0)
        return self

    def _filter(self, s: int) -> ConvFilter:
        """The trunk of pyramid scale s."""
        return self.filters[s if len(self.filters) > 1 else 0]

    def _scale_costs(self, d1: torch.Tensor, d2: torch.Tensor,
                     s: int = 0) -> torch.Tensor:
        g = self.geometry
        f1 = crop_features_center(g, self._filter(s)(d1))
        f2 = self._filter(s)(d2)
        return matching.match_ssd(f1, f2, g.maxh, g.maxw)

    # -- full-image inference ----------------------------------------------

    @full_f32()
    def forward_full(self, img1: torch.Tensor, img2: torch.Tensor,
                     log: bool = False) -> torch.Tensor:
        """img1, img2 (..., hImg, wImg, C) -> (..., hImg, wImg, n_indices)
        multiscale distribution (its log if ``log``)."""
        g = self.geometry
        dists = []
        for s, r in enumerate(g.ratios):
            d1 = pad_patch_border(g, avg_downsample(img1, r))
            d2 = pad_patch_border(g, avg_downsample(img2, r))
            dist = torch.softmax(-self._scale_costs(d1, d2, s), dim=-1)
            dist = _replicate(dist, r, -3)[..., : g.hImg, : g.wImg, :]
            dists.append(dist)
        out = middle_removal_concat(g, apply_cascade(g, self.betas, dists))
        return log_eps(out) if log else out

    # -- fast full-image inference decode ------------------------------------

    @full_f32()
    @torch.no_grad()
    def features_pyramid(self, img1: torch.Tensor, img2: torch.Tensor):
        """Per-scale cropped/full feature pairs [(f1, f2), ...]: stage 1 of
        the staged decode."""
        g = self.geometry
        outs = []
        for s, r in enumerate(g.ratios):
            d1 = pad_patch_border(g, avg_downsample(img1, r))
            d2 = pad_patch_border(g, avg_downsample(img2, r))
            outs.append((crop_features_center(g, self._filter(s)(d1)),
                         self._filter(s)(d2)))
        return outs

    @full_f32()
    @torch.no_grad()
    def decode_from_features(self, feats) -> Tuple[torch.Tensor, torch.Tensor]:
        """Stage 2 of the staged decode: per-scale match + softmax +
        cascade + middle-band WTA, each at its scale's own resolution (see
        ``decode_full``)."""
        g = self.geometry
        if g.cascad_trainable_weights:
            raise ValueError("the staged decode implements the shipped "
                             "linear cascade only")
        with profiled_span("decode.cost"):
            dists = [torch.softmax(-matching.match_ssd(
                f1, f2, g.maxh, g.maxw, dtype=self.decode_dtype), dim=-1)
                for f1, f2 in feats]
        with profiled_span("decode.select"):
            return self._select_from_costs(dists)

    def _select_from_costs(self, dists) -> Tuple[torch.Tensor, torch.Tensor]:
        """The staged decode's cascade, band WTA, merge over scales and
        middle tie-break, from each scale's softmax over its window."""
        g = self.geometry
        n = len(g.ratios)
        D = g.maxh * g.maxw
        mid_concat = codecs.middle_index(g)

        # static per-scale band metadata from the concatenated codec layout
        band = _band_indices(g)
        scale_of = band // D
        cell_of = band % D
        keep = []
        for s in range(n):
            k = np.zeros(D, bool)
            k[cell_of[scale_of == s]] = True
            keep.append(k)

        def up_to_full(x, r):
            return _replicate(x, r, -2)[..., : g.hImg, : g.wImg]

        vals, idxs, sums, mid_p = [], [], [], None
        for s in range(n):
            # cascade at scale-s resolution: coarser dists read at the fine
            # cells, spatially replicated down to scale s
            acc = dists[s]
            Hs, Ws = acc.shape[-3], acc.shape[-2]
            for j in range(s + 1, n):
                r = g.ratios[j] // g.ratios[s]
                gj = _replicate(_coarse_to_fine(dists[j], g.maxh, g.maxw, r),
                                r, -3)
                acc = acc + gj[..., :Hs, :Ws, :]
            fused = true_div(acc, n - s)
            if s == 0:
                mid_p = fused[..., mid_concat]   # zero-flow cell (scale 0)
            keep_s = torch.from_numpy(keep[s]).to(fused.device)
            masked = torch.where(keep_s, fused, torch.full_like(fused, -1.0))
            v = torch.amax(masked, dim=-1)
            am = torch.argmax(masked, dim=-1).to(torch.int32)
            # cell -> concatenated index: the band layout is piecewise
            # affine in (iy, ix)
            if s == 0:
                k = am                           # scale 0 keeps every cell
            else:
                d = codecs._border(g, s)
                base = int(np.nonzero(scale_of == s)[0][0])
                iy = torch.div(am, g.maxw, rounding_mode="floor")
                ix = am - iy * g.maxw
                rows_mid = g.maxh - 2 * d
                pos_left = d * g.maxw + (iy - d) * d + ix
                pos_right = (d * g.maxw + rows_mid * d
                             + (iy - d) * d + ix - (g.maxw - d))
                pos_bot = (d * g.maxw + 2 * rows_mid * d
                           + (iy - (g.maxh - d)) * g.maxw + ix)
                k = torch.where(iy < d, am,
                                torch.where(iy >= g.maxh - d, pos_bot,
                                            torch.where(ix < d, pos_left,
                                                        pos_right)))
                k = base + k
            ssum = torch.where(keep_s, fused, torch.zeros_like(fused)).sum(-1)
            r = g.ratios[s]
            vals.append(up_to_full(v, r))
            idxs.append(up_to_full(k, r))
            sums.append(up_to_full(ssum, r))

        total = sums[0]
        bm = vals[0]
        bi = idxs[0]
        for s in range(1, n):                    # first occurrence = lowest
            total = total + sums[s]              # scale = concat order
            bi = torch.where(vals[s] > bm, idxs[s], bi)
            bm = torch.maximum(bm, vals[s])
        # flat-pixel middle tie-break
        tie = mid_p >= bm
        idx = torch.where(tie, torch.full_like(bi, mid_concat), bi)
        pmax = torch.where(tie, mid_p, bm) / total
        return idx, pmax

    @full_f32()
    @torch.no_grad()
    def decode_full(self, img1: torch.Tensor, img2: torch.Tensor
                    ) -> Tuple[torch.Tensor, torch.Tensor]:
        """WTA decode of the multiscale distribution without materializing
        it at full resolution. Returns (idx, pmax): the concatenated-codec
        index (int32, middle tie-break) and its probability, each (...,
        hImg, wImg): the argmax and max of ``forward_full``.

        The cascaded distribution at scale s is constant over scale-s pixel
        blocks (a full-res pixel p reads coarser scales at p // r_j, and
        r_j | r_s), so cascade, band selection, per-scale max and per-scale
        sum all run at each scale's own resolution, and only (value, index)
        maps are replicated to full resolution. With trainable betas (a
        non-linear cascade) the distribution is materialized instead."""
        if self.geometry.cascad_trainable_weights:
            g = self.geometry
            out = self.forward_full(img1, img2, log=False)
            mid = codecs.middle_index(g)
            val = torch.amax(out, dim=-1)
            am = torch.argmax(out, dim=-1).to(torch.int32)
            tie = out[..., mid] >= val
            idx = torch.where(tie, torch.full_like(am, mid), am)
            pmax = torch.where(tie, out[..., mid], val) / out.sum(-1)
            return idx, pmax
        return self.decode_from_features(self.features_pyramid(img1, img2))

    @full_f32()
    def decode_full_staged(self, imgs1: torch.Tensor, imgs2: torch.Tensor):
        """Throughput path: batched (B, H, W, C) image pairs through the two
        stages (conv pyramid, then match + decode)."""
        return self.decode_from_features(self.features_pyramid(imgs1, imgs2))

    # -- foveated training path --------------------------------------------

    @full_f32()
    def forward_fovea(self, img1: torch.Tensor, img2: torch.Tensor,
                      y: int, x: int, log: bool = True) -> torch.Tensor:
        """Single fovea at 0-based center (y, x) of (H, W, C) frames: per
        scale r, the full-res (r hPatch2, r wPatch2) region whose center
        pixel (ceil convention) is (y, x), placed as the reference's dynamic
        slice places it (``_slice_start``), downsampled, matched and fused.
        Returns the
        (n_indices,) distribution (its log by default, the training head)."""
        g = self.geometry
        H, W = img1.shape[0], img1.shape[1]
        dists = []
        for s, r in enumerate(g.ratios):
            Hc, Wc = r * g.hPatch2, r * g.wPatch2
            y0 = _slice_start(y - (math.ceil(Hc / 2) - 1), H, Hc)
            x0 = _slice_start(x - (math.ceil(Wc / 2) - 1), W, Wc)
            c1 = img1[y0:y0 + Hc, x0:x0 + Wc]
            c2 = img2[y0:y0 + Hc, x0:x0 + Wc]
            costs = self._scale_costs(avg_downsample(c1, r),
                                      avg_downsample(c2, r), s)
            dists.append(torch.softmax(-costs, dim=-1).reshape(-1))
        out = middle_removal_concat(g, apply_cascade(g, self.betas, dists))
        return log_eps(out) if log else out

    @full_f32()
    def forward_fovea_batch(self, crops1: torch.Tensor, crops2: torch.Tensor,
                            log: bool = True) -> torch.Tensor:
        """Batched fovea forward over pre-cropped coarsest-scale footprints
        crops1/crops2 (B, rmax hPatch2, rmax wPatch2, C), each centered
        (ceil convention) on its fovea: every per-scale crop is a static
        centered slice. Returns (B, n_indices)."""
        g = self.geometry
        Hm, Wm = g.rmax * g.hPatch2, g.rmax * g.wPatch2
        if tuple(crops1.shape[1:3]) != (Hm, Wm):
            raise ValueError(f"crops {tuple(crops1.shape)} are not "
                             f"{Hm}x{Wm} footprints")
        B = crops1.shape[0]
        dists = []
        for s, r in enumerate(g.ratios):
            Hc, Wc = r * g.hPatch2, r * g.wPatch2
            oy = (math.ceil(Hm / 2) - 1) - (math.ceil(Hc / 2) - 1)
            ox = (math.ceil(Wm / 2) - 1) - (math.ceil(Wc / 2) - 1)
            d1 = avg_downsample(crops1[:, oy:oy + Hc, ox:ox + Wc], r)
            d2 = avg_downsample(crops2[:, oy:oy + Hc, ox:ox + Wc], r)
            costs = self._scale_costs(d1, d2, s)
            dists.append(torch.softmax(-costs, dim=-1).reshape(B, -1))
        out = middle_removal_concat(g, apply_cascade(g, self.betas, dists))
        return log_eps(out) if log else out
