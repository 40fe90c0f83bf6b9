"""Spans around the program's functions, and the reduction of a
``torch.profiler`` trace to the per-layer readings.

Two kinds of span, each wrapping a named function of the program from the
benchmark's own files (``Spans``), never from inside the program:
  * 'sync': the function waits for the card before and after it runs, and
    the host clock is read around it: a layer's time in ms a call. Such a
    wrapper makes the card idle, so these steps are not profiled;
  * 'profile': a ``torch.profiler.record_function`` range around the
    call, and the call's work (bytes, FP32 operations) counted from its
    arguments' shapes by ``counts.py``. In the profiled steps a kernel
    belongs to every range whose host interval holds its launch, so a
    layer's device time is the sum of the kernels it launched.

``reduce_trace`` reads the Chrome trace the profiler exports: device
operations (kernels, copies, sets) with their launches' correlation ids,
host launch calls, and the ranges. Busy time is the union of the device
intervals inside the traced window (the 'step' ranges), per card.
"""

from __future__ import annotations

import bisect
import functools
import json
import os
import tempfile
import threading
import time
from collections import defaultdict
from dataclasses import dataclass, field
from typing import Callable, Dict, List, Optional, Sequence, Tuple

import torch

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
LAUNCH_CATS = ("cuda_runtime", "cuda_driver")
STEP = "step"


def synchronize(devices: Sequence) -> None:
    for d in devices:
        if torch.device(d).type == "cuda":
            torch.cuda.synchronize(d)


class Spans:
    """Wraps each (owner, attribute, span name, work) target in a span of
    ``mode`` 'sync' or 'profile' while the context is open. ``work`` maps
    the call's (args, kwargs) to (bytes, flops), or is None."""

    def __init__(self, targets: Sequence[Tuple], mode: str, devices):
        self.targets = list(targets)
        self.mode = mode
        self.devices = list(devices)
        self.ms: Dict[str, List[float]] = defaultdict(list)
        self.work: Dict[str, List[Tuple[float, float]]] = defaultdict(list)
        self._lock = threading.Lock()
        self._saved = []

    def _wrap(self, fn: Callable, name: str, work) -> Callable:
        if self.mode == "sync":
            @functools.wraps(fn)
            def run(*args, **kwargs):
                synchronize(self.devices)
                t = time.perf_counter()
                out = fn(*args, **kwargs)
                synchronize(self.devices)
                with self._lock:
                    self.ms[name].append((time.perf_counter() - t) * 1e3)
                return out
            return run

        @functools.wraps(fn)
        def run(*args, **kwargs):
            if work is not None:
                w = work(args, kwargs)
                with self._lock:
                    self.work[name].append(w)
            with torch.profiler.record_function(name):
                return fn(*args, **kwargs)
        return run

    def __enter__(self):
        for owner, attr, name, work in self.targets:
            fn = getattr(owner, attr)
            self._saved.append((owner, attr, owner.__dict__.get(attr)))
            setattr(owner, attr, self._wrap(fn, name, work))
        return self

    def __exit__(self, *exc):
        for owner, attr, old in reversed(self._saved):
            if old is None:
                delattr(owner, attr)
            else:
                setattr(owner, attr, old)
        self._saved = []
        return False


@dataclass
class Reduced:
    """What a profiled window gives: its length, the card's busy seconds
    (one entry a card), kernels launched, each range name's device seconds
    and call count, device seconds by operation name, and idle seconds by
    the range the host was in."""
    window_s: float
    busy_s: List[float]
    kernels: int
    span_device_s: Dict[str, float] = field(default_factory=dict)
    span_calls: Dict[str, int] = field(default_factory=dict)
    device_ops: List[Tuple[str, float]] = field(default_factory=list)
    idle_gaps: List[Tuple[str, float]] = field(default_factory=list)


def _union(intervals: List[Tuple[float, float]]) -> List[Tuple[float, float]]:
    out: List[List[float]] = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return [(a, b) for a, b in out]


def _clip(intervals, lo: float, hi: float):
    return [(max(a, lo), min(b, hi)) for a, b in intervals
            if min(b, hi) > max(a, lo)]


def reduce_trace(events: List[dict], n_cards: int) -> Optional[Reduced]:
    """Reduce Chrome-trace events (times in us) to a ``Reduced``, or None
    where the trace holds no step range or no device operation."""
    ranges, launches, device = [], {}, []
    for e in events:
        if e.get("ph") != "X":
            continue
        cat = str(e.get("cat", "")).lower()
        ts, dur = float(e.get("ts", 0.0)), float(e.get("dur", 0.0))
        args = e.get("args") or {}
        if cat == "user_annotation":
            ranges.append((e.get("name", ""), e.get("tid"), ts, ts + dur))
        elif cat in LAUNCH_CATS and "correlation" in args:
            launches[args["correlation"]] = (e.get("tid"), ts)
        elif cat in DEVICE_CATS:
            dev = args.get("device", e.get("pid", 0))
            device.append((cat, e.get("name", ""), dev, ts, ts + dur,
                           args.get("correlation")))
    steps = [(a, b) for n, _, a, b in ranges if n == STEP]
    if not steps or not device:
        return None
    lo, hi = min(a for a, _ in steps), max(b for _, b in steps)
    window = hi - lo
    by_dev: Dict = defaultdict(list)
    ops: Dict[str, float] = defaultdict(float)
    kernels = 0
    for cat, name, dev, a, b, _ in device:
        if b <= lo or a >= hi:
            continue
        by_dev[dev].append((a, b))
        ops[name[:96]] += (min(b, hi) - max(a, lo)) * 1e-6
        kernels += cat == "kernel"
    busy = []
    for dev, iv in by_dev.items():
        busy.append(sum(b - a for a, b in _clip(_union(iv), lo, hi)) * 1e-6)
    busy += [0.0] * max(0, n_cards - len(busy))

    # device seconds of each range name: the kernels whose launch lies in
    # one of its instances on the launching thread
    inst: Dict[str, Dict] = defaultdict(lambda: defaultdict(list))
    calls: Dict[str, int] = defaultdict(int)
    for name, tid, a, b in ranges:
        if name == STEP:
            continue
        inst[name][tid].append((a, b))
        calls[name] += 1
    span_s: Dict[str, float] = defaultdict(float)
    for name, per_tid in inst.items():
        starts = {tid: sorted(iv) for tid, iv in per_tid.items()}
        keys = {tid: [a for a, _ in iv] for tid, iv in starts.items()}
        for _, _, _, a, b, corr in device:
            hit = launches.get(corr)
            if hit is None or hit[0] not in starts:
                continue
            tid, t = hit
            i = bisect.bisect_right(keys[tid], t) - 1
            # instances of one name on one thread do not overlap
            if i >= 0 and starts[tid][i][0] <= t <= starts[tid][i][1]:
                span_s[name] += (b - a) * 1e-6
        span_s.setdefault(name, 0.0)

    # idle gaps of the busiest card, labelled by the innermost range the
    # host was in at each gap's middle
    main_dev = max(by_dev, key=lambda d: len(by_dev[d])) if by_dev else None
    gaps: Dict[str, float] = defaultdict(float)
    if main_dev is not None:
        busy_iv = _clip(_union(by_dev[main_dev]), lo, hi)
        edges = [lo] + [x for ab in busy_iv for x in ab] + [hi]
        inner = [(n, a, b) for n, _, a, b in ranges]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            mid = 0.5 * (a + b)
            best = None
            for n, ra, rb in inner:
                if ra <= mid <= rb and (best is None or rb - ra < best[1]):
                    best = (n, rb - ra)
            gaps["host in " + (best[0] if best else "no range")] += (b - a) * 1e-6
    top = lambda d: sorted(d.items(), key=lambda kv: -kv[1])[:10]
    return Reduced(window_s=window * 1e-6, busy_s=busy, kernels=kernels,
                   span_device_s=dict(span_s), span_calls=dict(calls),
                   device_ops=[[k, v] for k, v in top(ops)],
                   idle_gaps=[[k, v] for k, v in top(gaps)])


def profile(run_step: Callable[[], None], n_steps: int, devices,
            n_cards: int) -> Optional[Reduced]:
    """Run ``n_steps`` steps under torch.profiler, each in a 'step' range
    that ends once every card has finished, after one profiled step that is
    thrown away (the profiler's own start-up). The Chrome trace goes to a
    temporary file under TMPDIR, which is read back and removed."""
    from torch.profiler import ProfilerActivity, profile as tprofile, schedule
    acts = [ProfilerActivity.CPU]
    if any(torch.device(d).type == "cuda" for d in devices):
        acts.append(ProfilerActivity.CUDA)
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        with tprofile(activities=acts,
                      schedule=schedule(wait=0, warmup=1, active=n_steps),
                      on_trace_ready=lambda p: p.export_chrome_trace(path)
                      ) as prof:
            for _ in range(n_steps + 1):
                with torch.profiler.record_function(STEP):
                    run_step()
                    synchronize(devices)
                prof.step()
        with open(path) as f:
            events = json.load(f).get("traceEvents", [])
    finally:
        os.remove(path)
    return reduce_trace(events, n_cards)
