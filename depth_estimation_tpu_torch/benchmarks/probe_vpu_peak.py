"""Which chain structure reaches the card's FP32 issue rate? Kernel P2.

Counterpart of the JAX package's ``benchmarks/probe_vpu_peak.py``: the
logistic step v <- v - v*v (one FFMA) in 1, 2, 4 and 8 independent chains
of 64 steps an iteration in all (``device_peaks.logistic_loop``,
``csrc/vpu_peak.cu``), its rate counted as the JAX probe counts it. The
peak meter must report a rate at or above what any real kernel sustains,
which is speed_of_light's contract.

TRAP (recorded by the JAX probe): a chain of FMAs with CONSTANT
coefficients (v <- v*a + b) is affine in v, and a compiler composes the
whole chain into ONE fma, so that the "measured" rate counts work that was
folded away. Every chain here is the logistic step: non-affine, and it
cannot fold.

On the TPU one dependent chain was bound by the FMA's latency. On Hopper
other warps hide that latency, so the sweep runs twice: at full occupancy
(64 warps an SM), where every chain count should reach the FP32 pipe's
rate, and at 4 warps an SM (one a scheduler), where one dependent chain
issues an FFMA only every few clocks, as on the TPU.

Run on the card (writes ``chiprun_out/probe_vpu_peak.json`` by default):

    python -m depth_estimation_tpu_torch.benchmarks.probe_vpu_peak [--json PATH]

``--device cpu`` runs the harness at tiny sizes through the plain twin.
"""

from __future__ import annotations

import argparse
import math

import torch

from depth_estimation_tpu_torch.benchmarks import device_peaks as dp
from depth_estimation_tpu_torch.utils.device import resolve
from depth_estimation_tpu_torch.utils.precision import full_f32

CHAINS = (1, 2, 4, 8)
WARPS = (dp.FULL_WARPS, 4)


def sweep(dev, warps_an_sm) -> dict:
    """GFLOP/s of the logistic step in 1, 2, 4 and 8 chains at
    ``warps_an_sm`` warps an SM, with each timing and, on the card, the SM
    clock and power draw under it. Unlike P1's FMA chains, whose mean
    about halves each value an iteration until it is zero, the
    sums here keep the values away from zero, so these are the clock and
    power of FFMAs on live operands."""
    n_el, n_iter = dp.SIZES[dev.type]["p2"]
    x = torch.full((n_el,), 0.5, dtype=torch.float32, device=dev)
    out = {}
    for c in CHAINS:
        def run(k, c=c):
            return dp.logistic_loop(x, c, k, warps_an_sm)
        ms, n, times = dp.best_ms(run, n_iter, dev)
        out[c] = dict(gflops=n_el * n * dp.P2_OPS[c] / (ms / 1e3) / 1e9,
                      ms=ms, n_iter=n, timings_ms=times)
        if dev.type == "cuda":
            out[c]["clock_under_load"] = dp.sm_clock_under(
                lambda: run(n), math.ceil(600 / ms))
    return out


def probe(dev) -> dict:
    """The sweep at full occupancy and at 4 warps an SM."""
    dev = resolve(dev)
    return {"device": dev.type,
            "kind": torch.cuda.get_device_name(dev) if dev.type == "cuda"
            else "cpu",
            "warps_an_sm": {w: sweep(dev, w) for w in WARPS}}


@full_f32()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--json", default=str(dp.OUT_DIR / "probe_vpu_peak.json"))
    args = ap.parse_args(argv)
    res = probe(args.device)
    for w, rows in res["warps_an_sm"].items():
        for c, r in rows.items():
            print(f"{w:2d} warps an SM, {c} chain{'s' if c > 1 else ' '} "
                  f"x{dp.P2_STEPS // c:<2d} {r['gflops']:10.1f} GFLOP/s "
                  f"({r['ms']:.1f} ms, {res['device']})", flush=True)
    print(f"wrote {dp.write_json(res, args.json)}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
