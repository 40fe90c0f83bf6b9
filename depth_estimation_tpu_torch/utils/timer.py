"""Named-span timing with running means, and profiler spans and traces
(port of ``depth_estimation_tpu.utils.timer``). With ``sync_device`` a
toc or a span waits for the CUDA work queued before it ends, so the span
covers the device time and not only the enqueue. ``profiled_span`` and
``capture_trace`` are ``torch.profiler``'s: a named range in a Chrome
trace of CPU and CUDA activity."""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict

import torch


def sync(x) -> None:
    """Wait for the device work producing ``x`` (a tensor or a sequence)."""
    leaves = x if isinstance(x, (list, tuple)) else [x]
    if any(torch.is_tensor(t) and t.is_cuda for t in leaves):
        torch.cuda.synchronize()


class Timers:
    def __init__(self, sync_device: bool = False):
        self.totals: Dict[str, float] = defaultdict(float)
        self.counts: Dict[str, int] = defaultdict(int)
        self.sync_device = sync_device
        self._tics: Dict[str, float] = {}

    @contextlib.contextmanager
    def span(self, name: str):
        """Time the block as ``name``; with ``sync_device``, first wait for
        the work producing what the block puts in the yielded dict's
        "out"."""
        t0 = time.perf_counter()
        holder = {}
        yield holder
        if self.sync_device and holder.get("out") is not None:
            sync(holder["out"])
        self.totals[name] += time.perf_counter() - t0
        self.counts[name] += 1

    def tic(self, name: str) -> float:
        t = time.perf_counter()
        self._tics[name] = t
        return t

    def toc(self, name: str, out=None) -> float:
        if self.sync_device and out is not None:
            sync(out)
        dt = time.perf_counter() - self._tics[name]
        self.totals[name] += dt
        self.counts[name] += 1
        return dt

    def means(self) -> Dict[str, float]:
        return {k: self.totals[k] / max(self.counts[k], 1) for k in self.totals}

    def report(self) -> str:
        return " ".join(f"{k}={v * 1e3:.2f}ms" for k, v in
                        sorted(self.means().items()))


@contextlib.contextmanager
def profiled_span(name: str):
    """A named range (``torch.profiler.record_function``): it shows in a
    trace that ``capture_trace`` captures."""
    with torch.profiler.record_function(name):
        yield


TRACE_FILE = "trace.json"


@contextlib.contextmanager
def capture_trace(log_dir: str):
    """Profile the block (CPU, and CUDA where a card is visible) and write
    it to ``log_dir/trace.json`` as a Chrome trace (chrome://tracing or
    Perfetto). Yields whether the profiler started: it does not where
    another profiler is running."""
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(ProfilerActivity.CUDA)
    prof = profile(activities=activities)
    try:
        prof.__enter__()
        started = True
    except RuntimeError:
        started = False
    try:
        yield started
    finally:
        if started:
            prof.__exit__(None, None, None)
            os.makedirs(log_dir, exist_ok=True)
            prof.export_chrome_trace(os.path.join(log_dir, TRACE_FILE))
