"""The benchmark's run of one cell, driven by data.

A cell of ``BENCHMARK.json`` names a configuration and a traffic mix. The
harness finds each by name: ``configs/<config>.json``, ``traffic/<mix>.json``
(which names its path), ``paths/<path>.py``, ``limits/<cell>.json`` and a
reader ``metrics/<metric>.py`` for each per-layer metric of the cell. A new
cell, configuration, mix, path or metric is a new file and a new entry.

A path module has ``build(config, mix, seed, devices) -> program``; the
program has ``items`` (frame pairs a step), ``step()`` (one closed-loop
step: the next input goes in once the last result has returned), ``last()``
(an opaque record of the last step's outputs), ``failed()`` (inputs whose
outputs were not finite, so far), ``spans()`` ((owner, attribute, span,
work) targets), ``flops()`` (model FLOPs a step), ``release()`` (drop the
program's state) and ``check(records, control)`` (the compared numbers of
the kept records against the plain reference; with ``control`` the
reference computed in TF32 stands in the program's place).

One run: set-up (process start to the first timed step: imports, the
card, the program, its weights and inputs, two warm-up steps) ->
``seconds`` of closed-loop steps, a seeded reservoir keeping a few steps'
outputs -> with ``trace``, synchronising spans over a few steps, then a
few profiled steps -> the peak memory read, the program released, the
kept outputs compared against the reference.
"""

from __future__ import annotations

import importlib.util
import json
import math
import random
import sys
import time
from pathlib import Path
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from h100bench import readings, trace

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FORBIDDEN = ("jax", "jaxlib", "flax", "depth_estimation_tpu")
KEEP = 3                    # step records kept for the comparison, unless
                            # the mix says ``keep``


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def _json(kind: str, name: str) -> dict:
    with open(BENCH / kind / f"{name}.json") as f:
        return json.load(f)


def _module(kind: str, name: str):
    path = BENCH / kind / f"{name}.py"
    spec = importlib.util.spec_from_file_location(
        f"h100bench_{kind}_{name.replace('.', '_')}", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """One entry of ``workloads`` with its files."""

    def __init__(self, name: str, bench: Optional[dict] = None):
        bench = manifest() if bench is None else bench
        entry = [w for w in bench["workloads"] if w["name"] == name]
        if not entry:
            raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
        self.name = name
        self.entry = entry[0]
        self.chips = int(self.entry["chips"])
        self.config = _json("configs", self.entry["config"])
        self.mix = _json("traffic", self.entry["traffic"])
        self.path = _module("paths", self.mix["path"])
        self.limits = _json("limits", name)

        def here(m):
            return name in m["workloads"] if "workloads" in m else None
        self.end_to_end = [m for m in bench["end_to_end"]
                           if here(m) is not False]
        names = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if here(m) or (here(m) is None
                                         and m["moves"] in names)]


def forbidden_modules() -> List[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's,
    compared whole (the port's name begins with the JAX package's)."""
    tops = {m.split(".", 1)[0] for m in list(sys.modules)}
    return sorted(t for t in tops if t in FORBIDDEN)


def quantile(values: Sequence[float], q: float) -> float:
    """The q-quantile, linear between order statistics (numpy's default)."""
    return float(np.quantile(np.asarray(values, np.float64), q))


def _reservoir_offer(kept: list, k: int, rec, seen: int,
                     rng: random.Random) -> None:
    """Algorithm R: after ``seen`` offers, ``kept`` is a uniform sample of
    k of them, drawn from the seed."""
    if len(kept) < k:
        kept.append(rec)
    else:
        j = rng.randrange(seen)
        if j < k:
            kept[j] = rec


def run_cell(cell: Cell, seed: int, seconds: float, trace_on: bool,
             devices: Sequence, t0: float, control: bool = False,
             mix: Optional[dict] = None, log=None) -> dict:
    """Run one cell (see the module's docstring). Returns the result line's
    fields and ``compared``/``control`` ({name: value}). ``mix`` overrides
    the cell's traffic (the tests' tiny runs)."""
    log = log or (lambda s: print(s, file=sys.stderr, flush=True))
    mix = dict(cell.mix if mix is None else mix)
    cuda = [d for d in devices if torch.device(d).type == "cuda"]
    t_build = time.perf_counter()
    prog = cell.path.build(cell.config, mix, seed, list(devices))
    t_warm = time.perf_counter()
    for _ in range(int(mix.get("warmup_steps", 2))):
        prog.step()
    trace.synchronize(devices)
    setup_s = time.perf_counter() - t0
    log(f"set-up {setup_s:.3f} s: imports and the card {t_build - t0:.3f} s, "
        f"program and inputs {t_warm - t_build:.3f} s, warm-up steps "
        f"{t0 + setup_s - t_warm:.3f} s")

    rng = random.Random(int(seed))
    keep = int(mix.get("keep", KEEP))
    kept: list = []
    lat: List[float] = []
    steps = 0
    start = time.perf_counter()
    while True:
        t = time.perf_counter()
        prog.step()
        now = time.perf_counter()
        lat.append(now - t)
        steps += 1
        _reservoir_offer(kept, keep, prog.last(), steps, rng)
        if now - start >= seconds:
            break
    trace.synchronize(devices)
    window_s = time.perf_counter() - start
    attempted = steps * prog.items
    failed = int(prog.failed())

    out: Dict = {"attempted": attempted, "failed": failed}
    e2e = {"setup_s": setup_s,
           "pairs_per_s": (attempted - failed) / window_s,
           "frame_ms_p50": 1e3 * quantile(lat, 0.50),
           "frame_ms_p95": 1e3 * quantile(lat, 0.95)}
    metrics: Dict = {}
    if not trace_on:
        for m in cell.end_to_end:
            # 'pairs_per_s.decode' is pairs_per_s under a bound of its own
            metrics[m["name"]] = {"value": e2e[m["name"].split(".", 1)[0]],
                                  "unit": m["unit"]}
        q = [lat[i * len(lat) // 4:(i + 1) * len(lat) // 4] for i in range(4)]
        log(f"window {window_s:.3f} s, {steps} steps, {attempted} pairs; "
            "step ms p50 by quarter of the window: " + ", ".join(
                f"{1e3 * quantile(x, 0.5):.2f}" for x in q if x))
    else:
        r = readings.Readings(step_s=window_s / steps, step_flops=prog.flops(),
                              cards=max(1, len(set(map(str, cuda)))))
        n_sync = int(mix.get("sync_steps", 2))
        with trace.Spans(prog.spans(), "sync", devices) as sp:
            for _ in range(n_sync):
                prog.step()
        r.sync_ms, r.sync_steps = dict(sp.ms), n_sync
        n_prof = int(mix.get("profile_steps", 1))
        with trace.Spans(prog.spans(), "profile", devices) as sp:
            r.profiled = trace.profile(prog.step, n_prof, devices, r.cards)
        r.work, r.profiled_steps = dict(sp.work), n_prof
        for m in cell.per_layer:
            v = _module("metrics", m["name"]).read(r)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
        if r.profiled is not None:
            out["busy_s"] = sum(r.profiled.busy_s) / len(r.profiled.busy_s)
            out["window_s"] = r.profiled.window_s
            out["breakdown"] = {"device_ops": r.profiled.device_ops,
                                "idle_gaps": r.profiled.idle_gaps}
    out["metrics"] = metrics
    out["memory_peak_bytes"] = max(
        [torch.cuda.max_memory_allocated(d) for d in cuda] or [0])

    prog.release()
    t = time.perf_counter()
    out["compared"] = prog.check(kept, control=False)
    if control:
        out["control"] = prog.check(kept, control=True)
    log(f"reference over {len(kept)} kept steps: "
        f"{time.perf_counter() - t:.1f} s")
    return out


def verdict(compared: Dict[str, float], limits: Dict[str, float]):
    """(correct, [(name, value, limit)]): every compared number finite and
    at or under its limit."""
    rows = [(k, compared.get(k, math.nan), limits[k]) for k in limits]
    ok = all(math.isfinite(v) and v <= lim for _, v, lim in rows)
    return ok, rows
