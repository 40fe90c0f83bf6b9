"""Named-span timing with running means, and profiler spans and traces
(port of ``depth_estimation_tpu.utils.timer``). With ``sync_device`` a
toc or a span waits for the CUDA work queued before it ends, so the span
covers the device time and not only the enqueue. ``profiled_span`` and
``capture_trace`` are ``torch.profiler``'s: a named range in a Chrome
trace of CPU and CUDA activity.

The program's own spans are declared once, in ``SPANS``: the online
step's three stages (``online.*``, ``api_batched``), ego-motion's five
(``ego.*``, ``geometry3d/egomotion``) and the multiscale decode's two
(``decode.*``, ``models/multiscale``). Each records only while a
``torch.profiler`` runs, and then as a ``record_function`` range stamped
on the profiler's clock, the clock of its CUDA kernel records; otherwise,
and while ``torch.compile`` or ``torch.export`` traces, a span is one
check and no range. An operator captures them by running the program
inside ``capture_trace(log_dir)``::

    with capture_trace("traces/step"):
        est.next_frames(frames)

and finds the ranges, and the kernels launched inside each, in
``traces/step/trace.json``. ``SPANS`` also says what reads each span: a
per-layer metric of the benchmark (``h100bench/metrics``), or its
breakdown of the card's idle time by the span the host was in.
"""

from __future__ import annotations

import contextlib
import os
import time
from collections import defaultdict
from typing import Dict, NamedTuple

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


class Span(NamedTuple):
    """A program span: its name, the layer and the lines it holds, and
    what reads it (a per-layer metric of ``h100bench``, or the breakdown
    of idle time by the span the host was in)."""
    name: str
    layer: str
    reader: str


BREAKDOWN = "the breakdown"

SPANS = (
    Span("online.prep", "API: BatchedDepthEstimator._prep: normalise, "
         "resize, undistort, trunk", BREAKDOWN),
    Span("online.ego", "API: BatchedDepthEstimator._step: ego-motion and "
         "the bad-frame gate", BREAKDOWN),
    Span("online.flow", "API: BatchedDepthEstimator._step: compensation, "
         "B1, erosion, embed, depth", BREAKDOWN),
    Span("ego.corners", "ego-motion: Shi-Tomasi corners", BREAKDOWN),
    Span("ego.lk", "ego-motion: windowed LK (the full tracker offline)",
         "lk_device_ms.batch"),
    Span("ego.qr", "ego-motion: RANSAC's 8-point QR", "qr_idle_ms.batch"),
    Span("ego.score", "ego-motion: Sampson distances, inlier counts, the "
         "winner", BREAKDOWN),
    Span("ego.pose", "ego-motion: E's decomposition, cheirality, the pick",
         BREAKDOWN),
    Span("decode.cost", "multiscale decode: cost volume (every scale's "
         "match_ssd and softmax)", "cost_device_ms.decode"),
    Span("decode.select", "multiscale decode: cascade, band WTA, merge, "
         "tie-break", BREAKDOWN),
)

_OFF = contextlib.nullcontext()


def _profiling() -> bool:
    return torch._C._autograd._profiler_enabled()


# torch._dynamo.assume_constant_result's mark, set without importing
# torch._dynamo (seconds): torch.compile reads the check as a constant
_profiling._dynamo_marked_constant = True


def profiled_span(name: str):
    """A named range (``torch.profiler.record_function``) while a profiler
    runs: it shows in a trace that ``capture_trace`` captures. Without a
    profiler, and while torch.compile or torch.export traces, a shared
    no-op context: the cost is the profiler check."""
    if not _profiling() or torch.compiler.is_compiling():
        return _OFF
    return torch.profiler.record_function(name)


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
