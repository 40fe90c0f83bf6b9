"""The trace reduction and every per-layer reader, on a synthetic trace."""

import importlib.util

import pytest

from h100bench import counts, harness, readings, trace

# one step of 10 ms on the host; card 0 runs a trunk kernel (2 ms) and a
# match kernel (1 ms) launched inside their ranges, and a copy (0.5 ms)
EVENTS = [
    {"ph": "X", "cat": "user_annotation", "name": "step", "tid": 1,
     "ts": 1000.0, "dur": 10000.0},
    {"ph": "X", "cat": "user_annotation", "name": "trunk", "tid": 1,
     "ts": 1100.0, "dur": 300.0},
    {"ph": "X", "cat": "user_annotation", "name": "ego", "tid": 1,
     "ts": 1500.0, "dur": 5000.0},
    {"ph": "X", "cat": "user_annotation", "name": "match", "tid": 1,
     "ts": 7000.0, "dur": 100.0},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
     "ts": 1200.0, "dur": 5.0, "args": {"correlation": 7}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel", "tid": 1,
     "ts": 7050.0, "dur": 5.0, "args": {"correlation": 8}},
    {"ph": "X", "cat": "cuda_runtime", "name": "cudaMemcpyAsync", "tid": 1,
     "ts": 9000.0, "dur": 5.0, "args": {"correlation": 9}},
    {"ph": "X", "cat": "kernel", "name": "conv", "pid": 0, "tid": 7,
     "ts": 1300.0, "dur": 2000.0, "args": {"correlation": 7, "device": 0}},
    {"ph": "X", "cat": "kernel", "name": "b1", "pid": 0, "tid": 7,
     "ts": 7100.0, "dur": 1000.0, "args": {"correlation": 8, "device": 0}},
    {"ph": "X", "cat": "gpu_memcpy", "name": "copy", "pid": 0, "tid": 7,
     "ts": 9100.0, "dur": 500.0, "args": {"correlation": 9, "device": 0}},
    {"ph": "X", "cat": "kernel", "name": "outside", "pid": 0, "tid": 7,
     "ts": 20000.0, "dur": 500.0, "args": {"correlation": 10, "device": 0}},
]


def test_reduce_trace():
    r = trace.reduce_trace(EVENTS, n_cards=1)
    assert r.window_s == pytest.approx(0.010)
    assert r.busy_s == [pytest.approx(0.0035)]
    assert r.kernels == 2
    assert r.span_device_s["trunk"] == pytest.approx(0.002)
    assert r.span_device_s["match"] == pytest.approx(0.001)
    assert r.span_device_s["ego"] == 0.0
    assert r.span_calls == {"trunk": 1, "ego": 1, "match": 1}
    assert r.device_ops[0] == ["conv", pytest.approx(0.002)]
    gaps = dict(r.idle_gaps)
    # idle 1000-1300 (its middle in trunk), 3300-7100 (middle in ego),
    # 8100-9100 and 9600-11000 (in step alone)
    assert gaps["host in trunk"] == pytest.approx(0.0003)
    assert gaps["host in ego"] == pytest.approx(0.0038)
    assert gaps["host in step"] == pytest.approx(0.0024)


def test_reduce_trace_without_steps_or_device():
    assert trace.reduce_trace(EVENTS[1:], 1) is None
    assert trace.reduce_trace([e for e in EVENTS if e["cat"] != "kernel"
                               and e["cat"] != "gpu_memcpy"], 1) is None


def _reader(name):
    path = harness.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _readings():
    trunk_work = (1e6, 67e9)         # 1 ms of FP32 operations at the peak
    match_work = (3.35e6, 1.0)       # 0.001 ms of bytes
    return readings.Readings(
        sync_ms={"ego": [40.0, 60.0], "decode": [30.0, 30.0]}, sync_steps=2,
        profiled=trace.reduce_trace(EVENTS, 1), profiled_steps=1,
        work={"trunk": [trunk_work, trunk_work], "match": [match_work]},
        step_s=0.5, step_flops=0.5 * 67e12 * 0.01, cards=1)


EXPECT = {"ego_ms.batch": 50.0, "decode_ms": 30.0,
          "kernels_per_step.batch": 2.0, "trunk_roofline": 50.0,
          "trunk_roofline.decode": 50.0, "b1_roofline": 0.1,
          "device_idle.batch": 65.0, "device_idle.decode": 65.0,
          "step_mfu": 1.0, "step_mfu.decode": 1.0}


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(name):
    assert _reader(name)(_readings()) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_finds_nothing(name):
    assert _reader(name)(readings.Readings()) is None


def test_every_reader_is_tested():
    names = {p.stem for p in (harness.BENCH / "metrics").glob("*.py")}
    assert names == set(EXPECT)


def test_mesh_idle_is_the_mean_of_the_cards():
    ev = EVENTS + [{"ph": "X", "cat": "kernel", "name": "k", "pid": 1,
                    "tid": 7, "ts": 1000.0, "dur": 10000.0,
                    "args": {"device": 1}}]
    r = readings.Readings(profiled=trace.reduce_trace(ev, 2))
    assert readings.idle_pct(r) == pytest.approx(100 * (0.65 + 0.0) / 2)


def test_counts_match_the_published_kernel_table():
    # B1 at the online program's shape: 0.745 ms, bound by operations
    ms, which = counts.bound_ms(*counts.matcher_work(
        (128, 150, 290, 10), (128, 165, 305, 10), 4, 16, 16, 5,
        counts.b1_flops_per_cell(10)))
    assert which == "operations" and ms == pytest.approx(0.745, abs=5e-4)
    # car_model's trunk at B=128: about 1.57e11 FLOPs
    flops = counts.trunk_flops(((3, 5, 5, 8), (8, 12, 12, 10)), 128, 180, 320)
    assert flops == pytest.approx(1.57e11, rel=5e-3)
