"""Operation and byte counts of the radial (polar) depth net, frozen for the
benchmark's ``config4_radial`` cell, so that its roofline and its share of
the peak do not move when the program does.

The net's spec holds its convolutions as (cin, kh, kw, cout) and 'tanh'
entries; the counts take the convolutions (``counts.trunk_work``: the f32
input and weights read once, the f32 features written once, 2 Cin Cout kh
kw FLOPs an output pixel). The radial matcher: 3 FP32 operations (a
subtraction, a multiplication, an addition) a channel and cell, hWin cells
a pixel of the cropped previous features. The step counts the trunk on
both polar frames of every pair and the matcher; ego-motion, the warps and
the depth are left out, so the count is a floor.
"""

from __future__ import annotations

from typing import Sequence, Tuple

from h100bench import counts


def convs(spec: Sequence):
    """The spec's convolutions, (cin, kh, kw, cout) each."""
    return [tuple(l) for l in spec if not isinstance(l, str)]


def trunk_work(spec: Sequence):
    """Span work of ``RadialFilter.forward(x)``: x (..., H, W, C)."""
    layers = convs(spec)

    def work(args, kwargs) -> Tuple[float, float]:
        x = args[1] if len(args) > 1 else kwargs["x"]
        B = 1
        for s in x.shape[:-3]:
            B *= int(s)
        return counts.trunk_work(layers, B, int(x.shape[-3]),
                                 int(x.shape[-2]))
    return work


def step_flops(spec: Sequence, h_win: int, pairs: int, h: int,
               w_polar: int) -> float:
    """FP32 operations of one step on ``pairs`` pairs of (h, w_polar) polar
    frames: the trunk on both frames and the radial matcher's cells."""
    layers = convs(spec)
    kh = sum(l[1] - 1 for l in layers)
    kw = sum(l[2] - 1 for l in layers)
    H, W = h - kh - h_win + 1, w_polar - kw
    K = layers[-1][3]
    return float(counts.trunk_flops(layers, 2 * pairs, h, w_polar)
                 + pairs * H * W * h_win * 3 * K)
