"""Operation and byte counts of Ce Liu's coarse-to-fine solve, frozen for
the benchmark's ``config2_liu`` cell, so that its roofline and its share of
the peak do not move when the program does.

Kernel B4 (``sor_redblack``): the row of the port's speed-of-light report
(``benchmarks/speed_of_light.sor_work``): the nine coefficient planes read
and du, dv written once, 4 bytes each; 30 FP32 operations a pixel and
iteration (two colours, each a weighted neighbour sum and a relaxed update
of du and of dv).

The solve's FP32 operations a pixel, counted once from
``flow/celiu.smooth_flow_sor`` for the 5-channel features of an RGB pair
(a multiply or an add is 1, a square root, division or comparison 1):
  * an IRLS step, ``IRLS_PER_PX`` = 492: both features smoothed by the
    5-tap Gaussian along W and H (2 x 5 channels x 20), their weighted
    average (15), its 5-tap x and y derivatives (100), dt (5); the flow's
    four forward differences and Phi (15); It (20), Psi and its mask (30);
    the five channel-averaged products (75); the two Laplacians and right
    sides (22); the stencil's weights and both denominators (10);
  * the warp after it, ``WARP_PER_PX`` = 90: the flow update (2), the
    sample points and their range test (6), the clamped corners and
    fractions (8), the four-tap blend of 5 channels (4 weights, 35), the
    out-of-range select (5); the noise estimate (|It|, its two bounds, the
    masked sum: 30);
  * the SOR: ``SOR_PER_PX_SWEEP`` = 30 a sweep, the sweeps n_sor + 3k at
    level k.
The pyramids, the features and the upsampling between levels (once a
level or once a solve) are left out: the count is a floor.
"""

from __future__ import annotations

import math
from typing import List, Tuple

SOR_PER_PX_SWEEP = 30
IRLS_PER_PX = 492
WARP_PER_PX = 90


def sor_work(args, kwargs) -> Tuple[float, float]:
    """B4's (bytes, flops) for one call ``sor_redblack(*planes, alpha=,
    n_sor=, ...)``: planes (..., H, W) float32."""
    n = 1
    for s in args[0].shape:
        n *= int(s)
    return 11 * n * 4, n * int(kwargs["n_sor"]) * SOR_PER_PX_SWEEP


def schedule(h: int, w: int, ratio: float, min_width: int, n_outer: int,
             n_sor: int) -> List[Tuple[int, int, int, int]]:
    """(height, width, IRLS steps, SOR sweeps) of each pyramid level, fine
    to coarse: Liu's level count and sizes, n_outer + k steps and n_sor +
    3k sweeps at level k."""
    if ratio > 0.98 or ratio < 0.4:
        ratio = 0.75
    n = int(math.log(min_width / w) / math.log(ratio))
    return [(int(h * ratio ** k), int(w * ratio ** k), n_outer + k,
             n_sor + 3 * k) for k in range(n)]


def solve_flops(pairs: int, h: int, w: int, ratio: float, min_width: int,
                n_outer: int, n_inner: int, n_sor: int) -> float:
    """FP32 operations of one solve of ``pairs`` pairs: at every level,
    each IRLS step's fixed points (IRLS and SOR) and its warp."""
    total = 0
    for hk, wk, steps, sweeps in schedule(h, w, ratio, min_width, n_outer,
                                          n_sor):
        per_step = (n_inner * (IRLS_PER_PX + SOR_PER_PX_SWEEP * sweeps)
                    + WARP_PER_PX)
        total += hk * wk * steps * per_step
    return float(pairs * total)
