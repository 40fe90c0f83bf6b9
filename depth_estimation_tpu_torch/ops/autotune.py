"""Shape-keyed autotuning of the matchers' launch plans (port of
``depth_estimation_tpu.ops.autotune``).

A plan of kernel B1 (``matching.FusedPlan``: the unblocked kernel, or the
general one with its window rows a pass and band of columns) or of B2
(``matching.MatchPlan``: the pixel blocking and the tile) is a pure
launch choice: every plan gives the same outputs, bit for bit, and only
its speed depends on the shape, the storage type and the card. The rules
``fused_plan`` and ``match_plan`` predict a plan; on the H100 a prediction
can be wrong (B2's 4x2 blocking, predicted fastest, was the slowest).
``best_plan`` measures the candidates (``matching.fused_candidates``,
``fast_candidates``) ONCE per (kernel, card, torch and CUDA version,
kernel build, shapes, window, dtype, gate) on the live card and persists
the winner in ``_build/autotune.json`` beside the built kernels, so that
every later process starts tuned. The kernel build's digest is in the
key, so an edit under ``csrc/`` invalidates every winner.

This is an EXPLICIT pre-pass, as in the reference: resolve the plan
before the program runs (``BatchedDepthEstimator(match_block="auto")``
resolves during ``reset()``, where the real feature shapes exist) and hand
it to the kernel; kernels never see "auto". On the CPU the plain twins run
and have no plan: nothing is timed and the store is not touched.
"""

from __future__ import annotations

import json
import os
import statistics
import tempfile
import threading
from pathlib import Path

import numpy as np
import torch

from . import _kernels, matching

_LOCK = threading.Lock()
_cache = None
# winners from partial or failed sweeps: process-local only, never persisted
_session_only: dict = {}


def store_path() -> Path:
    """The persistent store (git-ignored, beside the built kernels)."""
    return _kernels.BUILD_ROOT / "autotune.json"


def _read_store() -> dict:
    try:
        with open(store_path()) as fh:
            data = json.load(fh)
        return data if isinstance(data, dict) else {}
    except (OSError, ValueError):
        return {}


def _load() -> dict:
    global _cache
    if _cache is None:
        _cache = _read_store()
    return _cache


def _save() -> None:
    """Merge this process's winners into the store and write it atomically
    (a temporary file, then ``os.replace``): another process, or another
    thread's resolution, never reads half a file."""
    path = store_path()
    try:
        path.parent.mkdir(parents=True, exist_ok=True)
        merged = {**_read_store(), **_cache}
        fd, tmp = tempfile.mkstemp(dir=path.parent, prefix=".autotune.")
        with os.fdopen(fd, "w") as fh:
            json.dump(merged, fh, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except OSError:
        pass


def _encode(c):
    return list(c) if isinstance(c, tuple) else c


def _context_poisoned() -> bool:
    """True where the CUDA context holds a sticky fault (an illegal address,
    say): then every later call fails too, so the fault is raised, never
    skipped as a candidate that does not launch."""
    if not torch.cuda.is_available() or not torch.cuda.is_initialized():
        return False
    try:
        torch.cuda.synchronize()
    except RuntimeError:
        return True
    return False


def _default_timer(fn, n: int = 5) -> float:
    """Seconds a call of ``fn``: CUDA events on the current stream around
    each of ``n`` calls after 2 warm-up calls, the median."""
    for _ in range(2):
        fn()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / 1e3)
    return statistics.median(times)


def pick(key: str, run_candidate, candidates, timer=None):
    """Return the cached winner for ``key``, measuring each candidate via
    ``run_candidate(c)`` on a miss (a stored winner that is not among
    ``candidates`` is a miss). Candidates that raise (a launch the
    kernel's C entry point refuses) are skipped, unless the CUDA context
    holds a sticky fault, which is raised. A sweep with ANY failure is
    only cached in-process, never persisted: a winner written to disk must
    come from a complete sweep. Where nothing could be measured, the first
    candidate wins, for this process only."""
    candidates = list(candidates)
    with _LOCK:
        stored = _load().get(key, _session_only.get(key))
    for c in candidates:
        if stored is not None and _encode(c) == stored:
            return c
    timer = timer or _default_timer
    best, best_t, failed = None, float("inf"), 0
    for c in candidates:
        try:
            t = timer(lambda: run_candidate(c))
        except Exception:
            if _context_poisoned():
                raise
            failed += 1
            continue
        if t < best_t:
            best, best_t = c, t
    if best is None:
        # nothing measured at all: fall back for this process only
        best, failed = candidates[0], failed or 1
    with _LOCK:
        if failed:
            _session_only[key] = _encode(best)
        else:
            _load()[key] = _encode(best)
            _save()
    return best


def plan_key(kernel: str, f1_shape, f2_shape, maxh: int, maxw: int, dtype,
             want_conf: bool, conf_threshold: float, device) -> str:
    """The store's key: everything that can change the winner. The card
    by name, torch's and CUDA's versions, the kernel build's digest (any
    file under ``csrc/``), the shapes, the window, the storage type and,
    for B1, the confidence gate."""
    dname = str(dtype).replace("torch.", "")
    return (f"{kernel}:{torch.cuda.get_device_name(device)}:"
            f"torch{torch.__version__}:cuda{torch.version.cuda}:"
            f"build{_kernels._digest()}:{tuple(f1_shape)}:"
            f"{tuple(f2_shape)}:{maxh}x{maxw}:{dname}:"
            f"conf={int(want_conf)}@{float(conf_threshold)!r}")


def candidates_for(kernel: str, maxh: int, maxw: int, K: int) -> list:
    """The plans ``best_plan`` times for ``kernel`` ('fused' or 'fast'),
    the rule's own first."""
    if kernel == "fused":
        return matching.fused_candidates(maxh, maxw, K)
    if kernel == "fast":
        return matching.fast_candidates(maxh, maxw, K)
    raise ValueError(f"kernel {kernel!r}: 'fused' (B1) or 'fast' (B2)")


def best_plan(kernel: str, f1_shape, f2_shape, maxh: int, maxw: int,
              dtype=torch.float32, want_conf: bool = False,
              conf_threshold: float = 0.11, device="cuda", timer=None):
    """The fastest plan of ``kernel`` ('fused': B1, a ``FusedPlan``;
    'fast': B2, a ``MatchPlan``) for a call signature: the concrete (B, H,
    W, K) feature shapes the program will pass, measured on ``device`` on
    ``np.random.RandomState(0)`` features (cached persistently, see
    ``pick``). On a CPU device the rule's plan, untimed, with the store
    untouched: the plain twins have no plan."""
    f1_shape = tuple(int(n) for n in f1_shape)
    f2_shape = tuple(int(n) for n in f2_shape)
    cands = candidates_for(kernel, maxh, maxw, f1_shape[-1])
    dev = torch.device(device)
    if dev.type != "cuda" or len(cands) <= 1:
        return cands[0] if cands else None
    key = plan_key(kernel, f1_shape, f2_shape, maxh, maxw, dtype, want_conf,
                   conf_threshold, dev)
    feats = []          # made on a miss only

    def run(plan):
        if not feats:
            rng = np.random.RandomState(0)
            feats.extend(torch.as_tensor(rng.rand(*s), dtype=torch.float32,
                                         device=dev)
                         for s in (f1_shape, f2_shape))
        f1, f2 = feats
        if kernel == "fast":
            return matching._match_flow_fast_cuda(f1, f2, maxh, maxw, dtype,
                                                  plan)
        return matching._match_flow_fused_cuda(
            f1, f2, maxh, maxw, False, dtype, want_conf, conf_threshold, plan)

    with torch.cuda.device(dev):
        return pick(key, run, cands, timer)
