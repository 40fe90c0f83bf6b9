"""What a traced run hands the per-layer metric readers
(``metrics/<name>.py``), and the arithmetic they share. A reader returns
a number, or None where the run holds nothing to read (the harness then
leaves the metric out of the line); a share of a roofline or of a peak is
never 0 for want of data."""

from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

from h100bench import counts
from h100bench.trace import Reduced


@dataclass
class Readings:
    """``sync_ms``: each synchronising span's ms, a call; ``sync_steps``:
    the steps they ran over; ``profiled``: the profiled steps' reduction
    (None where there was none); ``profiled_steps``; ``work``: each
    profiled span's (bytes, flops) a call, counted from its arguments;
    ``step_s``: seconds a step without instrumentation; ``step_flops``:
    the model's FLOPs a step; ``cards``: the cards the step runs on."""
    sync_ms: Dict[str, List[float]] = field(default_factory=dict)
    sync_steps: int = 0
    profiled: Optional[Reduced] = None
    profiled_steps: int = 0
    work: Dict[str, List[Tuple[float, float]]] = field(default_factory=dict)
    step_s: float = 0.0
    step_flops: float = 0.0
    cards: int = 1


def span_ms_per_step(r: Readings, span: str) -> Optional[float]:
    """A synchronising span's ms a step, summed over its calls."""
    ms = r.sync_ms.get(span)
    if not ms or r.sync_steps <= 0:
        return None
    return sum(ms) / r.sync_steps


def roofline_pct(r: Readings, span: str) -> Optional[float]:
    """The span's bound time (``counts.bound_s`` of each call's work) over
    its device time in the profiled steps, in %."""
    p, work = r.profiled, r.work.get(span)
    if p is None or not work:
        return None
    calls, dev_s = p.span_calls.get(span, 0), p.span_device_s.get(span, 0.0)
    if calls <= 0 or dev_s <= 0.0:
        return None
    bound = sum(counts.bound_s(b, f) for b, f in work) / len(work)
    return 100.0 * bound * calls / dev_s


def idle_pct(r: Readings) -> Optional[float]:
    """100 (1 - busy / window), the mean of the cards' idle shares."""
    p = r.profiled
    if p is None or p.window_s <= 0.0 or not p.busy_s:
        return None
    shares = [1.0 - b / p.window_s for b in p.busy_s]
    return 100.0 * sum(shares) / len(shares)


def kernels_per_step(r: Readings) -> Optional[float]:
    p = r.profiled
    if p is None or r.profiled_steps <= 0 or p.kernels <= 0:
        return None
    return p.kernels / r.profiled_steps


def mfu_pct(r: Readings) -> Optional[float]:
    """Model FLOPs a step over (step time x FP32 peak x cards), in %."""
    if r.step_s <= 0.0 or r.step_flops <= 0.0:
        return None
    return 100.0 * r.step_flops / (r.step_s * counts.PEAK_FP32 * r.cards)
