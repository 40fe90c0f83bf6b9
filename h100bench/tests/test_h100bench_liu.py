"""The ``config2_liu.gt_b64`` cell: a tiny run of its path on the CPU
through the harness (B4's plain twin in the SOR), its five per-layer
readers on a synthetic trace, the faults it must catch (one SOR sweep
fewer a call, a bfloat16 SOR state, an IRLS step skipped) and, on a card,
its control."""

import importlib.util
import time

import pytest
import torch

from h100bench import harness, readings, trace

CELL = "config2_liu.gt_b64"
# the cell cut to a size the CPU solves in about a second: 2 pairs of
# 90x160 (3 levels, widths 160, 120, 90: 5, 6 and 7 IRLS steps), 2 batches
TINY = {"hImg": 90, "wImg": 160, "min_width": 60, "pairs": 2,
        "distinct_batches": 2}
# the faults at the cell's own frames and schedule (8 levels, 68 IRLS
# steps), 4 pairs: the limits are set at that size, and one sweep fewer a
# call moves the flow by about a third of what the control's bfloat16
# state does (mean gap 0.0024-0.0032 px on seeds 11-13, limit 0.0022)
FAULT_SIZE = {"hImg": 180, "wImg": 320, "min_width": 30, "pairs": 4,
              "distinct_batches": 1}


def tiny_cell(size=TINY):
    cell = harness.Cell(CELL)
    cell.config = dict(
        cell.config,
        image=dict(cell.config["image"], hImg=size["hImg"],
                   wImg=size["wImg"]),
        solver=dict(cell.config["solver"], min_width=size["min_width"]))
    mix = dict(cell.mix, pairs=size["pairs"],
               distinct_batches=size["distinct_batches"])
    return cell, mix


def tiny_run(trace_on=False, control=False, seed=2 ** 31 + 7, size=TINY):
    cell, mix = tiny_cell(size)
    torch.set_num_threads(2)
    out = harness.run_cell(cell, seed, 0.2, trace_on, ["cpu"],
                           time.perf_counter(), control=control, mix=mix,
                           log=lambda s: None)
    return cell, out


def test_tiny_run_is_correct():
    cell, out = tiny_run()
    ok, rows = harness.verdict(out["compared"], cell.limits)
    assert ok, rows
    assert out["compared"] == {"flow_px": 0.0, "flow_mean_px": 0.0,
                               "steps_short": 0.0}
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_tiny_traced_run_reads_the_solve():
    cell, out = tiny_run(trace_on=True)
    # the CPU trace has no device operations: only the synchronising span
    # and the host clock's share of the peak
    assert set(out["metrics"]) == {"solve_ms.liu", "step_mfu.liu"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert {m["name"] for m in cell.per_layer} == {
        "solve_ms.liu", "irls_idle_ms.liu", "warp_device_ms.liu",
        "sor_roofline.liu", "step_mfu.liu"}


def _one_sweep_fewer(monkeypatch):
    """Every SOR solve one sweep short, where celiu calls it."""
    from depth_estimation_tpu_torch.flow import celiu
    sor = celiu.sor_redblack

    def short(*a, n_sor, **k):
        return sor(*a, n_sor=n_sor - 1, **k)
    monkeypatch.setattr(celiu, "sor_redblack", short)


def _bf16_state(monkeypatch):
    """du and dv rounded to bfloat16 after every SOR solve (the control's
    2-byte state, in the program)."""
    from depth_estimation_tpu_torch.flow import celiu
    sor = celiu.sor_redblack

    def rounded(*a, **k):
        return tuple(x.to(torch.bfloat16).float() for x in sor(*a, **k))
    monkeypatch.setattr(celiu, "sor_redblack", rounded)


def _steps_skipped(monkeypatch):
    """The finest level one IRLS step short: flow and count both move."""
    from depth_estimation_tpu_torch.flow import celiu
    smooth = celiu.smooth_flow_sor

    def fewer(*a, **k):
        a = list(a)
        if a[0].shape[-2] == FAULT_SIZE["wImg"]:
            a[7] -= 1
        return smooth(*a, **k)
    monkeypatch.setattr(celiu, "smooth_flow_sor", fewer)


FAULTS = [_one_sweep_fewer, _bf16_state, _steps_skipped]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    cell, out = tiny_run(seed=11, size=FAULT_SIZE)
    ok, rows = harness.verdict(out["compared"], cell.limits)
    assert not ok, rows
    if fault is _steps_skipped:
        assert out["compared"]["steps_short"] == 1.0


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 202])
def test_control_is_not_correct_on_the_card(seed, card):
    cell = harness.Cell(CELL)
    mix = dict(cell.mix, pairs=16, distinct_batches=2, keep=1)
    out = harness.run_cell(cell, seed, 1.0, False, [card],
                           time.perf_counter(), control=True, mix=mix,
                           log=lambda s: None)
    ok, rows = harness.verdict(out["compared"], cell.limits)
    assert ok, rows
    bad, rows = harness.verdict(out["control"], cell.limits)
    assert not bad, rows
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the readers on a synthetic trace: one solve of 100 ms on the host
# ---------------------------------------------------------------------------

def _x(cat, name, ts, dur, **args):
    e = {"ph": "X", "cat": cat, "name": name, "tid": 1, "pid": 0, "ts": ts,
         "dur": dur}
    if args:
        e["args"] = args
    return e


def _range(name, a, b):
    return _x("user_annotation", name, a, b - a)


def _launched(corr, at, kernel, a, b):
    return [_x("cuda_runtime", "cudaLaunchKernel", at, 5.0, correlation=corr),
            _x("kernel", kernel, a, b - a, correlation=corr, device=0)]


# the benchmark's wrappers (step, solve, sor) and the program's spans
WRAPPERS = [_range("step", 1000, 101000), _range("solve", 1010, 100990),
            _range("sor", 20010, 20990)]
SPANS = [_range("liu.pyramid", 1100, 5000), _range("liu.irls", 5000, 20000),
         _range("liu.sor", 20000, 21000), _range("liu.warp", 21000, 25000),
         _range("liu.irls", 25000, 40000)]
KERNELS = (_launched(1, 1200, "gauss", 1300, 4000)
           + _launched(2, 5100, "phi", 5200, 6000)
           + _launched(3, 20100, "sor_redblack", 20200, 30200)   # B4, 10 ms
           + _launched(4, 21100, "warp", 30200, 32200)           # 2 ms
           + _launched(5, 25100, "psi", 32200, 33000))
# B4's work: 0.1 ms of bytes, 2 ms of FP32 operations at the peaks
SOR_WORK = (0.1e-3 * 3.35e12, 2e-3 * 67e12)
EXPECT = {
    # idle 6000-20200 with the host in the first liu.irls
    "irls_idle_ms.liu": 14.2,
    "warp_device_ms.liu": 2.0,
    "sor_roofline.liu": 20.0,
    "solve_ms.liu": 410.0,
    # 6.7e11 operations in 0.5 s on 67 TFLOP/s
    "step_mfu.liu": 2.0,
}


def _reader(name):
    path = harness.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _readings(events, steps=1):
    return readings.Readings(
        profiled=trace.reduce_trace(events, 1), profiled_steps=steps,
        work={"sor": [SOR_WORK, SOR_WORK]}, sync_ms={"solve": [400.0, 420.0]},
        sync_steps=2, step_s=0.5, step_flops=6.7e11)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(name):
    r = _readings(WRAPPERS + SPANS + KERNELS)
    assert _reader(name)(r) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_finds_nothing(name):
    read = _reader(name)
    assert read(readings.Readings()) is None
    if name in ("irls_idle_ms.liu", "warp_device_ms.liu"):
        # a program without the spans: no number, and no error
        assert read(_readings(WRAPPERS + KERNELS)) is None


def test_readers_are_the_cells():
    cell = harness.Cell(CELL)
    assert {m["name"] for m in cell.per_layer} == set(EXPECT)
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "pairs_per_s"
