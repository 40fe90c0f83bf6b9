"""Operation and byte counts of the version2 net's batched flow, frozen for
the benchmark's ``config1_v2`` cell, so that its rooflines and its share
of the peak do not move when the program does.

The trunk is ``counts.trunk_work`` (one VALID convolution, 2 Cin Cout kh
kw FLOPs an output pixel). The matching core's kernel B2 works on the
norm decomposition of the cost, -cost = 2 <f1, f2> - |f2|^2 - |f1|^2:
a cell of a pixel's window costs 2K FP32 operations for the cross term's
K multiply-adds, 3 for the logit and 5 for the online softmax, the
soft-argmax and the WTA scan (as ``counts.b1_flops_per_cell`` counts
them); each position of f1 and f2 costs 2K for its norm. Its bytes: f1
and f2 read once in f32, idx, ey, ex and pmax written once. The step counts the trunk on both frames of every pair and B2's
cross terms; the normalisation, the norms and the heads are left out, so
the count is a floor.
"""

from __future__ import annotations

from typing import Sequence

from h100bench import counts


def fast_flops_per_cell(K: int) -> int:
    """FP32 operations a pixel and window cell of B2: 2K + 8."""
    return 2 * K + 8


def fast_work(args, kwargs):
    """Span work of ``match_flow_fast(f1, f2, maxh, maxw)`` on (B, H, W, K)
    f32 features: (bytes, FP32 operations)."""
    f1, f2, maxh, maxw = args[:4]
    s1, s2 = tuple(f1.shape), tuple(f2.shape)
    K = s1[-1]
    nbytes, flops = counts.matcher_work(s1, s2, 4, maxh, maxw, 4,
                                        fast_flops_per_cell(K))
    norms = 2 * K * (counts._numel(s1[:-1]) + counts._numel(s2[:-1]))
    return nbytes, flops + norms


def step_flops(layers: Sequence, maxh: int, maxw: int, pairs: int, h: int,
               w: int) -> float:
    """FP32 operations of one step on ``pairs`` pairs of (h, w) frames: the
    trunk on both frames and B2's cross terms, 2K a cell."""
    layers = [tuple(l) for l in layers]
    kh = sum(l[1] - 1 for l in layers)
    kw = sum(l[2] - 1 for l in layers)
    H, W = h - kh - maxh + 1, w - kw - maxw + 1
    K = layers[-1][3]
    return float(counts.trunk_flops(layers, 2 * pairs, h, w)
                 + pairs * H * W * maxh * maxw * 2 * K)
