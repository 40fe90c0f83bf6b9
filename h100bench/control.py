"""The readings that a cell's limits are set from, on the card.

    python3 h100bench/control.py --workload <cell> --seeds 1 2 3 ... [--seconds S] [--control 0|1]

For each seed, in one process (the set-up is paid once for the build): the
cell's program over a short closed-loop window at the cell's own size, its
kept outputs compared with the plain reference (the lower readings), and
with ``--control 1`` the control: the reference computed in TF32, the
precision next below the configuration's f32 with TF32 off, put in the
program's place (the upper readings). One JSON line a seed on standard
output, with the cell's current limits beside them. The benchmark's own
runs never run the control.
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--control", type=int, choices=(0, 1), default=1)
    args = ap.parse_args(argv)
    sys.path.insert(0, str(ROOT))
    import torch
    from h100bench import harness
    cell = harness.Cell(args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        print(f"{cell.name} needs {cell.chips} CUDA card(s)", file=sys.stderr)
        return 2
    devices = [f"cuda:{i}" for i in range(cell.chips)]
    for seed in args.seeds:
        t0 = time.perf_counter()
        out = harness.run_cell(cell, seed, args.seconds, False, devices, t0,
                               control=bool(args.control))
        print(json.dumps({"workload": cell.name, "seed": seed,
                          "program": out["compared"],
                          "control": out.get("control"),
                          "limits": cell.limits,
                          "metrics": out["metrics"],
                          "card": torch.cuda.get_device_name(0)}),
              flush=True)
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
