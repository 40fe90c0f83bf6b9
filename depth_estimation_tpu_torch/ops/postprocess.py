"""Flow-field post-processing (port of ``depth_estimation_tpu.ops.postprocess``):
masked windowed mode and median filters.

  * 'max' — per-window histogram mode over quantized (y, x) flow pairs,
    counting only masked-in pixels;
  * 'med' — per-window, per-component median over masked-in pixels.

Output pixels outside the k-cropped interior stay zero.
"""

from __future__ import annotations

import torch

ROWSIZE = 16  # histogram row stride of the reference's mode kernel


def _box_sum(x: torch.Tensor, k: int) -> torch.Tensor:
    """Sums over every k x k VALID window of the two leading dims of an
    integer tensor (H, W, ...) -> (H-k+1, W-k+1, ...), from an integral
    image: exact on integer counts."""
    cs = torch.nn.functional.pad(x.cumsum(0).cumsum(1),
                                 (0, 0) * (x.ndim - 2) + (1, 0, 1, 0))
    return cs[k:, k:] - cs[:-k, k:] - cs[k:, :-k] + cs[:-k, :-k]


def _place_interior(flow: torch.Tensor, ys: torch.Tensor, xs: torch.Tensor,
                    k: int) -> torch.Tensor:
    """Zero (2, H, W) frame with the two (H-k+1, W-k+1) maps at offset k//2."""
    out = torch.zeros_like(flow)
    halfk = k // 2
    hh, ww = ys.shape
    out[0, halfk:halfk + hh, halfk:halfk + ww] = ys
    out[1, halfk:halfk + hh, halfk:halfk + ww] = xs
    return out


def mode_filter(flow: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """flow: (2, H, W) (y then x); mask: (H, W). Returns (2, H, W). Flow is
    rounded half-up, offset by its floor minimum and binned as x + 16 y; a
    bin of 256 or above (flow spanning more than 16 px) counts nowhere, as
    the reference's one-hot drops it. Ties go to the lowest bin."""
    fy = torch.floor(flow[0] + 0.5)
    fx = torch.floor(flow[1] + 0.5)
    m = torch.floor(torch.minimum(fy.min(), fx.min()))
    v = (fx - m).to(torch.int32) + ROWSIZE * (fy - m).to(torch.int32)
    bins = torch.arange(ROWSIZE * ROWSIZE, dtype=torch.int32,
                        device=flow.device)
    hist = ((v[..., None] == bins) & (mask > 0.5)[..., None]).to(torch.int32)
    best = torch.argmax(_box_sum(hist, k), dim=-1)
    by = torch.div(best, ROWSIZE, rounding_mode="floor").to(flow.dtype) + m
    bx = torch.remainder(best, ROWSIZE).to(flow.dtype) + m
    return _place_interior(flow, by, bx, k)


def median_filter(flow: torch.Tensor, mask: torch.Tensor, k: int) -> torch.Tensor:
    """Masked per-window median of each flow component. Invalid pixels are
    excluded; the median is element floor(n/2) of the sorted valid values,
    and 0 where a window holds none."""
    H, W = mask.shape

    def unfold(a):
        return torch.stack([a[i:i + H - k + 1, j:j + W - k + 1]
                            for i in range(k) for j in range(k)], dim=-1)

    wm = unfold(mask > 0.5)
    n_valid = wm.sum(-1)

    def masked_median(comp):
        big = torch.where(wm, unfold(comp), torch.full_like(wm, float("inf"),
                                                            dtype=comp.dtype))
        s = torch.sort(big, dim=-1).values
        med = torch.gather(s, -1, torch.div(n_valid, 2, rounding_mode="floor")
                           .long()[..., None])[..., 0]
        return torch.where(n_valid > 0, med, torch.zeros_like(med))

    return _place_interior(flow, masked_median(flow[0]),
                           masked_median(flow[1]), k)


def post_process_image(flow: torch.Tensor, mask: torch.Tensor, winsize: int,
                       method: str = "max") -> torch.Tensor:
    """'max' -> ``mode_filter``, anything else -> ``median_filter``."""
    if method == "max":
        return mode_filter(flow, mask, winsize)
    return median_filter(flow, mask, winsize)
