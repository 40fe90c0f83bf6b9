"""Time kernels B1 and B3 through their public wrappers
(``ops.matching.match_flow_fused``, ``ops.warp.banded_bilinear_warp``) at
the online program's shapes, for the copy of the package under ``--root``,
so that two trees can be timed on one card in one session (run each tree
in turn, e.g. parent, change, change, parent):

    python3 depth_estimation_tpu_torch/cli/time_wrappers.py --root DIR [--out FILE]

Shapes: B=128; B1 150x290x10 features against 165x305x10, a 16x16 window,
with the confidence gate; B3 165x305x10 warped by a 0.01 rad yaw, band 8.
For each wrapper and storage type: the median of ``--reps`` single calls
(CUDA events around each call, the wrapper's host work included), the time
a call when 10 are queued back to back, and the host's time to issue one
call on a tiny input (``--issue`` calls queued, ``time.perf_counter``, the
card synchronised once at the end). Prints the card's name and power limit
and one JSON line; ``--out`` also writes the JSON there. Needs a card.
"""

from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time

from ..utils.precision import full_f32

B, H, W, K, WIN, BAND = 128, 150, 290, 10, 16, 8
TINY = 16                   # the tiny input's feature side


def cuda_ms(torch, fn, reps: int) -> float:
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def issue_us(torch, fn, n: int) -> float:
    """Host microseconds to queue one call, over n calls queued in a row."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


@full_f32()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--root", required=True,
                    help="directory holding the depth_estimation_tpu_torch "
                         "package to time")
    ap.add_argument("--reps", type=int, default=21)
    ap.add_argument("--issue", type=int, default=200)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    root = os.path.abspath(args.root)
    sys.path.insert(0, root)
    import torch
    if not torch.cuda.is_available():
        print("time_wrappers: no CUDA card", file=sys.stderr)
        return 2
    from depth_estimation_tpu_torch.geometry3d import undistort
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.ops import matching, warp
    import depth_estimation_tpu_torch as pkg
    if not os.path.abspath(pkg.__file__).startswith(root + os.sep):
        raise RuntimeError(f"imported {pkg.__file__}, not the package under {root}")

    dev = torch.device("cuda:0")
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    gen = torch.Generator(device=dev).manual_seed(2)
    f1 = 0.5 * torch.randn(B, H, W, K, generator=gen, device=dev)
    f2 = 0.5 * torch.randn(B, H + WIN - 1, W + WIN - 1, K, generator=gen,
                           device=dev)
    t1 = 0.5 * torch.randn(1, TINY, TINY, K, generator=gen, device=dev)
    t2 = 0.5 * torch.randn(1, TINY + WIN - 1, TINY + WIN - 1, K, generator=gen,
                           device=dev)
    Ks = ARDRONE.K.copy()
    Ks[0] *= 320 / ARDRONE.wImg
    Ks[1] *= 180 / ARDRONE.hImg
    R = torch.eye(3, device=dev).expand(B, 3, 3).clone()
    R[:, 0, 2], R[:, 2, 0] = 0.01, -0.01
    Hw, Ww = H + WIN - 1, W + WIN - 1
    xs, ys = undistort.homography_grid(Ks, R, Hw, Ww)
    imgs = torch.randn(B, Hw, Ww, K, generator=gen, device=dev)
    txs, tys = xs[:1, :TINY, :TINY].contiguous(), ys[:1, :TINY, :TINY].contiguous()
    timgs = imgs[:1, :TINY, :TINY].contiguous()

    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        name = str(dt)[6:]
        b1 = lambda: matching.match_flow_fused(f1, f2, WIN, WIN, 8, False, dt, True)
        im = imgs.to(dt)
        b3 = lambda: warp.banded_bilinear_warp(im, xs, ys, BAND)
        tim = timgs.to(dt)
        for kname, fn, tiny in (
                ("match_fused", b1, lambda: matching.match_flow_fused(
                    t1, t2, WIN, WIN, 8, False, dt, True)),
                ("warp_banded", b3, lambda: warp.banded_bilinear_warp(
                    tim, txs, tys, BAND))):
            rows[f"{kname}_{name}"] = dict(
                one_call_ms=cuda_ms(torch, fn, args.reps),
                back_to_back_ms=cuda_ms(
                    torch, lambda: [fn() for _ in range(10)], args.reps) / 10,
                issue_us=issue_us(torch, tiny, args.issue))
    launches = {"match_fused": matching.match_flow_fused.launches,
                "warp_banded": warp.banded_bilinear_warp.launches}
    report = dict(root=root, card=card, torch=torch.__version__,
                  custom_ops=hasattr(torch.ops.depth_estimation_tpu_torch,
                                     "match_flow_fused"),
                  launches=launches, rows=rows)
    print(f"card: {card}")
    for k, v in rows.items():
        print(f"{k}: one call {v['one_call_ms']:.4f} ms, back to back "
              f"{v['back_to_back_ms']:.4f} ms a call, issue {v['issue_us']:.2f} "
              f"us a call (tiny input)")
    line = json.dumps(report)
    print(line)
    if args.out:
        os.makedirs(os.path.dirname(os.path.abspath(args.out)), exist_ok=True)
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
