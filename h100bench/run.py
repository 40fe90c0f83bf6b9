"""Run one cell of the port's benchmark and print its result line.

    python3 h100bench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout, on a machine with the cards the cell asks for.
The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics`` (the cell's end-to-end metrics with
``--trace 0``, its per-layer metrics with ``--trace 1``), ``device``
(and with ``--trace 1`` ``breakdown``), and last ``compared``: each number
compared with the plain reference beside its limit. The same numbers are
the last lines of standard error. Exits non-zero, printing no result,
without enough CUDA cards, without the port, or where a module of JAX or
of the JAX package is loaded once the window has closed.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
CACHE = ROOT / ".bench_cache"


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # kernel caches at fixed paths inside the checkout; one host thread
    # for torch's and numpy's own work, so that the load is one steady thread
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
        os.environ[var] = str(CACHE / sub)
    for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
        os.environ[var] = "1"
    sys.path.insert(0, str(ROOT))
    try:
        import torch
        torch.set_num_threads(1)
        import depth_estimation_tpu_torch  # noqa: F401
        from h100bench import harness
    except ImportError as e:
        print(f"cannot run: {e}", file=sys.stderr)
        return 3
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"cannot run: {cell.name} needs {cell.chips} CUDA card(s), "
              f"{n} visible", file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    out = harness.run_cell(cell, args.seed, args.seconds, bool(args.trace),
                           devices, T0)
    bad = harness.forbidden_modules()
    if bad:
        print(f"loaded modules of JAX or the JAX package: {bad}",
              file=sys.stderr)
        return 4
    correct, rows = harness.verdict(out["compared"], cell.limits)
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips,
              "memory_peak_bytes": int(out["memory_peak_bytes"])}
    if args.trace:
        device["busy_s"] = out.get("busy_s", 0.0)
        device["window_s"] = out.get("window_s", 0.0)
    line = {"correct": correct, "attempted": out["attempted"],
            "failed": out["failed"], "metrics": out["metrics"],
            "device": device}
    if "breakdown" in out:
        line["breakdown"] = out["breakdown"]
    line["compared"] = {k: {"value": v, "limit": lim} for k, v, lim in rows}
    for k, v in sorted(out["compared"].items()):
        if k not in cell.limits:
            print(f"not compared {k} {v!r}", file=sys.stderr)
    for k, v, lim in rows:
        print(f"compared {k} {v!r} limit {lim!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
