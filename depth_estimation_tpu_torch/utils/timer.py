"""Named-span timing with running means, and profiler spans and traces
(port of ``depth_estimation_tpu.utils.timer``). With ``sync_device`` a
toc or a span waits for the CUDA work queued before it ends, so the span
covers the device time and not only the enqueue. ``profiled_span`` and
``capture_trace`` are ``torch.profiler``'s: a named range in a Chrome
trace of CPU and CUDA activity.

The program's own spans are declared once, in ``SPANS``: the online
step's three stages (``online.*``, ``api_batched``), ego-motion's five
(``ego.*``, ``geometry3d/egomotion``), the multiscale decode's two
(``decode.*``, ``models/multiscale``), Ce Liu's solve's four
(``liu.*``, ``flow/celiu``), the radial estimator's four
(``radial.*``, ``api_radial`` and ``models/radial``) and the version2
net's batched flow's three (``v2.*``, ``models/version2``). Each records only while a ``torch.profiler``
runs, and then as a ``record_function`` range stamped
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

The program's own counters sit beside them in ``COUNTERS``, by name
(``count``), from every thread: how many pyramid levels and outer IRLS
steps Ce Liu's solve made (``liu.levels``, ``liu.irls_steps``;
``flow/celiu``), and how often each cache of ``utils/cuda_graph``
captured a call into a CUDA graph, replayed one, or ran the call eagerly
(``<name>.captures``, ``<name>.replays``, ``<name>.eager``): RANSAC's QR
as ``qr_graph`` (``geometry3d/qr_graph``) and an IRLS step's planes off
the IRLS kernel's route ('gmm') as ``liu_graph`` (``flow/celiu``); and
the radial estimator's pairs, the
pairs its gate rejected and the epipoles it kept from the step before
(``radial.pairs``, ``radial.bad_pairs``, ``radial.epipole_kept``;
``api_radial``); the pairs the version2 net's batched flow matched
(``v2.pairs``; ``models/version2``). A count that lives on the card goes through
``count_on_device``: copied to the host behind the card's work and added
once the copy has landed, so that the step that counts never waits;
``fold_counts()`` waits for every copy, for a reader of ``COUNTERS``.
"""

from __future__ import annotations

import contextlib
import os
import threading
import time
from collections import Counter, defaultdict
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
    Span("ego.lk", "ego-motion: windowed LK (the full tracker in the polar "
         "chain)", "lk_device_ms.batch, lk_device_ms.radial"),
    Span("ego.qr", "ego-motion: RANSAC's 8-point QR", "qr_idle_ms.batch"),
    Span("ego.score", "ego-motion: Sampson distances, inlier counts, the "
         "winner", BREAKDOWN),
    Span("ego.pose", "ego-motion: E's decomposition, cheirality, the pick",
         BREAKDOWN),
    Span("decode.cost", "multiscale decode: cost volume (every scale's "
         "match_ssd and softmax)", "cost_device_ms.decode"),
    Span("decode.select", "multiscale decode: cascade, band WTA, merge, "
         "tie-break", BREAKDOWN),
    Span("liu.pyramid", "liu solve: both Gaussian pyramids, each level's "
         "im2feature", BREAKDOWN),
    Span("liu.irls", "liu solve: an IRLS step's derivatives, Phi, Psi, "
         "coefficient planes, Laplacian (the IRLS kernel on the card)",
         "irls_idle_ms.liu"),
    Span("liu.sor", "liu solve: the red-black SOR (kernel B4 on the card)",
         BREAKDOWN),
    Span("liu.warp", "liu solve: upsampling between levels, each outer "
         "step's update, warp and noise estimate", "warp_device_ms.liu"),
    Span("radial.ego", "radial estimator: ego-motion (full tracker), the "
         "epipole, its EMA and the gate", BREAKDOWN),
    Span("radial.polar", "radial estimator: rescale, rotation removal, the "
         "C2P grids, the three polar warps", "polar_device_ms.radial"),
    Span("radial.net", "radial net: the trunk on both frames, the radial "
         "SSD and the WTA", "net_device_ms.radial"),
    Span("radial.depth", "radial estimator: the P2C grid, the warp back, "
         "flow2depth", "polar_device_ms.radial"),
    Span("v2.norm", "version2 net: both frames' contrastive normalisation",
         "norm_device_ms.v2"),
    Span("v2.trunk", "version2 net: the 17x17 conv on both frames",
         BREAKDOWN),
    Span("v2.match", "version2 net: the crop and the matching core (B2 on "
         "the card)", BREAKDOWN),
)

COUNTERS: Counter = Counter()
_COUNT_LOCK = threading.Lock()


def count(name: str, n: int = 1) -> None:
    """Add ``n`` to the program's counter ``name`` (``COUNTERS``)."""
    with _COUNT_LOCK:
        COUNTERS[name] += n


# copies of counts on their way from the card: (event, host tensor, names)
_PENDING: list = []


def count_on_device(names, values: torch.Tensor) -> None:
    """Add ``values`` (an integer tensor, one entry a name) to the counters
    ``names`` without waiting for the card: on the CPU at once; on a card
    through a copy into pinned host memory queued behind the work that
    made the values, added by the first ``fold_counts`` after it lands."""
    if values.device.type != "cuda":
        for name, v in zip(names, values.tolist()):
            count(name, int(v))
        return
    host = torch.empty(values.shape, dtype=values.dtype, pin_memory=True)
    host.copy_(values, non_blocking=True)
    done = torch.cuda.Event()
    done.record()
    with _COUNT_LOCK:
        _PENDING.append((done, host, tuple(names)))
    fold_counts(wait=False)


def fold_counts(wait: bool = True) -> None:
    """Add the card's counts whose copies have landed to ``COUNTERS``;
    with ``wait``, every one, waiting for the copies still on their way."""
    with _COUNT_LOCK:
        left = []
        for done, host, names in _PENDING:
            if wait:
                done.synchronize()
            elif not done.query():
                left.append((done, host, names))
                continue
            for name, v in zip(names, host.tolist()):
                COUNTERS[name] += int(v)
        _PENDING[:] = left


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
