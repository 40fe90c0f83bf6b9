"""The readers of the program's own spans (``ego.qr``, ``ego.lk``,
``decode.cost``), on synthetic traces whose program spans sit inside the
benchmark's wrappers, as they do in a traced run."""

import importlib.util
from pathlib import Path

import pytest

from h100bench import harness, readings, trace


def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "tid": 1, "pid": 0, "ts": ts,
         "dur": dur}
    if args:
        e["args"] = args
    return e


def _range(name, a, b):
    return _x("user_annotation", name, a, b - a)


def _launched(corr, at, kernel, a, b):
    """A launch on the host thread at ``at`` and its kernel on card 0."""
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 5.0, correlation=corr),
            _x("kernel", kernel, a, b - a, correlation=corr, device=0)]


# one online step of 20 ms: the benchmark's wrappers (step, api, trunk,
# ego, match) and the program's spans inside them
ONLINE_WRAPPERS = [
    _range("step", 1000, 21000), _range("api", 1010, 20990),
    _range("trunk", 1100, 3400), _range("ego", 3650, 14950),
    _range("match", 15200, 15400)]
ONLINE_SPANS = [
    _range("online.prep", 1050, 3500), _range("online.ego", 3600, 15000),
    _range("ego.corners", 3700, 4000), _range("ego.lk", 4100, 5000),
    _range("ego.qr", 5100, 12000), _range("ego.score", 12100, 12600),
    _range("ego.score", 13000, 13200), _range("ego.pose", 13300, 14900),
    _range("online.flow", 15100, 20900)]
ONLINE_KERNELS = (
    _launched(1, 1200, "conv", 1300, 3300)            # trunk, 2 ms
    + _launched(2, 3800, "corners", 3850, 4150)
    + _launched(3, 4200, "lk", 4300, 5300)            # ego.lk, 1 ms
    + _launched(4, 4900, "lk", 5300, 5800)            # ego.lk, 0.5 ms
    + _launched(5, 11000, "gemmSN", 11100, 11600)     # ego.qr
    + _launched(6, 12200, "sampson", 12300, 12500)    # ego.score
    + _launched(7, 15300, "b1", 15400, 16400))        # match, 1 ms

# one decode call of 10 ms: the wrappers (step, api, pyramid, trunk,
# decode, match_ssd) and the decode's two spans
DECODE_WRAPPERS = [
    _range("step", 1000, 11000), _range("api", 1005, 10995),
    _range("pyramid", 1010, 3000), _range("trunk", 1020, 2900),
    _range("decode", 3000, 10900), _range("match_ssd", 3020, 6000)]
DECODE_SPANS = [_range("decode.cost", 3010, 7000),
                _range("decode.select", 7010, 10800)]
DECODE_KERNELS = (
    _launched(11, 1100, "conv", 1200, 2200)
    + _launched(12, 3100, "ssd", 3200, 6200)          # match_ssd, 3 ms
    + _launched(13, 6500, "softmax", 6600, 7100)      # decode.cost, 0.5 ms
    + _launched(14, 7100, "wta", 7200, 7400))         # decode.select

TRACES = {"online": (ONLINE_WRAPPERS + ONLINE_SPANS + ONLINE_KERNELS,
                     ONLINE_WRAPPERS + ONLINE_KERNELS),
          "decode": (DECODE_WRAPPERS + DECODE_SPANS + DECODE_KERNELS,
                     DECODE_WRAPPERS + DECODE_KERNELS)}
# each reader's value on its trace, and the trace (with the program's
# spans, and without them as in the parent of the change)
EXPECT = {"qr_idle_ms.batch": 6.0, "lk_device_ms.batch": 1.5,
          "cost_device_ms.decode": 3.5}
EVENTS = {"qr_idle_ms.batch": TRACES["online"][0],
          "lk_device_ms.batch": TRACES["online"][0],
          "cost_device_ms.decode": TRACES["decode"][0]}
WRAPPERS_ONLY = {"qr_idle_ms.batch": TRACES["online"][1],
                 "lk_device_ms.batch": TRACES["online"][1],
                 "cost_device_ms.decode": TRACES["decode"][1]}


def _reader(name):
    path = harness.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _readings(events, steps=1):
    return readings.Readings(profiled=trace.reduce_trace(events, 1),
                             profiled_steps=steps)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_program_span_reader(name):
    assert _reader(name)(_readings(EVENTS[name])) == pytest.approx(
        EXPECT[name])
    # a step's worth: two profiled steps over the same trace halve the
    # per-step readers; the decode's reads a call
    half = EXPECT[name] if name == "cost_device_ms.decode" else \
        EXPECT[name] / 2
    assert _reader(name)(_readings(EVENTS[name], 2)) == pytest.approx(half)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_program_span_reader_finds_nothing(name):
    read = _reader(name)
    assert read(readings.Readings()) is None
    # a program without the spans (the parent of this change): no number,
    # and no error
    assert read(_readings(WRAPPERS_ONLY[name])) is None


def test_qr_idle_reads_zero_where_its_label_was_not_kept():
    # a 0.2 ms idle gap in ego.qr (1000-1200); ten other ranges each hold
    # a gap of 8.5 ms or more, so the reduction keeps their ten labels
    events = [_range("step", 0, 100100), _range("ego.qr", 900, 1600)]
    events += _launched(1, 0, "k", 0, 1000) + _launched(2, 950, "k", 1200,
                                                         1500)
    for i in range(10):
        a = 10000 * (i + 1)
        events += [_range(f"other{i}", a - 9000, a + 100)]
        events += _launched(3 + i, a, "k", a, a + 100)
    r = _readings(events)
    assert len(r.profiled.idle_gaps) == 10
    assert "host in ego.qr" not in dict(r.profiled.idle_gaps)
    assert r.profiled.span_calls["ego.qr"] == 1
    assert _reader("qr_idle_ms.batch")(r) == 0.0


def test_breakdown_names_the_program_stages():
    gaps = dict(trace.reduce_trace(EVENTS["qr_idle_ms.batch"], 1).idle_gaps)
    # 5800-11100 and 11600-12300 fall in ego.qr, 4150-4300 in ego.lk,
    # 12500-15400 in ego.pose, 16400-21000 in online.flow
    assert gaps["host in ego.qr"] == pytest.approx(0.006)
    assert gaps["host in ego.lk"] == pytest.approx(0.00015)
    assert gaps["host in ego.pose"] == pytest.approx(0.0029)
    assert gaps["host in online.flow"] == pytest.approx(0.0046)
    assert "host in ego" not in gaps
    parent = dict(trace.reduce_trace(WRAPPERS_ONLY["qr_idle_ms.batch"],
                                     1).idle_gaps)
    assert parent["host in ego"] == pytest.approx(0.00905)


@pytest.mark.parametrize("path", sorted(TRACES))
def test_program_spans_leave_the_wrappers_readings(path):
    """Program spans nested in the wrappers change neither the wrappers'
    call counts nor their device time, nor the kernel count (what
    ``trunk_roofline``, ``b1_roofline`` and ``kernels_per_step`` read)."""
    with_spans, without = (trace.reduce_trace(e, 1) for e in TRACES[path])
    assert with_spans.kernels == without.kernels
    for name in ("trunk", "match", "match_ssd", "ego", "decode"):
        assert with_spans.span_calls.get(name) == without.span_calls.get(name)
        assert with_spans.span_device_s.get(name) == pytest.approx(
            without.span_device_s.get(name))
    assert with_spans.busy_s == without.busy_s
    assert with_spans.window_s == without.window_s


def test_every_metric_file_is_tested_here_or_beside():
    """Every reader under ``metrics/`` is tested, in this file or in
    ``test_h100bench_readers.py`` (whose own coverage set lists only the
    readers it tests)."""
    path = Path(__file__).with_name("test_h100bench_readers.py")
    spec = importlib.util.spec_from_file_location("readers_tests", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    names = {p.stem for p in (harness.BENCH / "metrics").glob("*.py")}
    assert names == set(mod.EXPECT) | set(EXPECT)
    assert not set(mod.EXPECT) & set(EXPECT)
