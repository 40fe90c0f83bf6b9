#!/usr/bin/env python3
"""Wall time of the liu ground-truth solve and host time of B4's wrapper.

Run from the root of a checkout, on a machine with a CUDA card and nvcc:

    python3 solve_time.py

The package and ``chip_smoke.py`` are imported from the current directory,
so one copy of this script can time two checkouts in one session (``cd``
into each and run it), parent and change alternating. It prints one line:
  * nine BASELINE config2 solves (B=8, 192x256x3, ``chip_smoke.GT_SCHEDULE``
    on ``chip_smoke.shifted_textures``), each timed on the host clock with
    a sync after it, after one warm-up: their median, least and all;
  * the host time of one ``sor_redblack`` call (kernel B4) at config2's
    coarsest level (B=8, 34x45, one iteration), over 200 calls issued
    without a sync, so that the host, not the card, sets the pace.
A config2 solve makes 56 such calls one after another, and the host
issues them, so a change in the wrapper's host time moves a solve by 56
times as much.
"""

import os
import statistics
import sys
import time

sys.path.insert(0, os.getcwd())

import torch  # noqa: E402

from chip_smoke import GT_SCHEDULE, shifted_textures, sor_planes  # noqa: E402
from depth_estimation_tpu_torch.flow import celiu, sor_kernel  # noqa: E402

SOLVES = 9
CALLS = 200


def main() -> int:
    dev = torch.device("cuda:0")
    im1, im2 = shifted_textures(torch.Generator(device=dev).manual_seed(3),
                                8, 192, 256, 2, dev)
    celiu.coarse2fine_flow_batched(im1, im2, **GT_SCHEDULE)
    torch.cuda.synchronize()
    ts = []
    for _ in range(SOLVES):
        t = time.perf_counter()
        celiu.coarse2fine_flow_batched(im1, im2, **GT_SCHEDULE)
        torch.cuda.synchronize()
        ts.append((time.perf_counter() - t) * 1e3)
    planes, alpha = sor_planes(torch.Generator(device=dev).manual_seed(0), 8,
                               34, 45, dev)
    sor_kernel.sor_redblack(*planes, alpha=alpha, n_sor=1)
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(CALLS):
        sor_kernel.sor_redblack(*planes, alpha=alpha, n_sor=1)
    host_us = (time.perf_counter() - t) / CALLS * 1e6
    torch.cuda.synchronize()
    print(f"{os.getcwd()}: solve median {statistics.median(ts):.1f} ms, least "
          f"{min(ts):.1f}, all {[round(x, 1) for x in ts]}; B4 wrapper host "
          f"{host_us:.1f} us a call", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
