"""The ``config4_radial.stream_b64`` cell: a tiny run of its path on the CPU
through the harness, its six per-layer readers on a synthetic trace, the
faults it must catch (the smoothed epipole moved by 2 px, one row of the
WTA flow shifted by one class, the trunk in TF32) and, on a card, its
control."""

import importlib.util
import time

import pytest
import torch

from h100bench import harness, readings, trace

CELL = "config4_radial.stream_b64"
# the cell cut to a size the CPU runs in seconds: 2 streams of 3 frames at
# 90x160 (the GoPro camera scaled by 1/8, 200 corners), polar 48x48, a
# two-layer trunk of 4 channels, hWin 7
TINY = dict(frame_hw=[90, 160], texture=[23, 40], streams=2, frames=3,
            scale=8, max_points=200, polar=48, h_win=7,
            layers=[[3, 3, 3, 4], "tanh", [4, 3, 3, 4]])


def tiny_cell(size=TINY):
    cell = harness.Cell(CELL)
    c, s = cell.config["camera"], size["scale"]
    cam = dict(c, wImg=c["wImg"] // s, hImg=c["hImg"] // s, fx=c["fx"] / s,
               fy=c["fy"] / s, cx=c["cx"] / s, cy=c["cy"] / s,
               max_points=size["max_points"])
    cell.config = dict(
        cell.config, camera=cam,
        network={"layers": size["layers"], "h_win": size["h_win"]},
        polar=dict(cell.config["polar"], h_input=size["polar"],
                   w_input=size["polar"]))
    mix = dict(cell.mix, streams=size["streams"], frames=size["frames"],
               frame_hw=size["frame_hw"], texture=size["texture"])
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
    gaps = {k: v for k, v in out["compared"].items() if k != "repeat_pct"}
    assert gaps == {"rflow_pct": 0.0, "depth_pct": 0.0, "e2_px": 0.0,
                    "good_diff": 0.0}
    assert 0.0 <= out["compared"]["repeat_pct"] <= 100.0
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_tiny_traced_run_reads_the_spans():
    cell, out = tiny_run(trace_on=True)
    # the CPU trace has no device operations: only the synchronising span
    # and the host clock's share of the peak
    assert set(out["metrics"]) == {"ego_ms.radial", "step_mfu.radial"}
    assert all(v["value"] > 0 for v in out["metrics"].values())
    assert {m["name"] for m in cell.per_layer} == set(EXPECT)


def _epipole_moved(monkeypatch):
    """The smoothed epipole 2 px off in x, where the estimator smooths."""
    from depth_estimation_tpu_torch.geometry3d import polar
    smooth = polar.smooth_epipole_batched

    def moved(*a, **k):
        e2s, kept = smooth(*a, **k)
        return e2s + torch.tensor([2.0, 0.0], device=e2s.device), kept
    monkeypatch.setattr(polar, "smooth_epipole_batched", moved)


def _row_shifted(monkeypatch):
    """One row of the WTA flow (the middle radius) one class out."""
    from depth_estimation_tpu_torch.models import radial
    flow = radial.RadialFlowNetwork.flow

    def shifted(self, *a, **k):
        f, cost = flow(self, *a, **k)
        f = f.clone()
        r = f.shape[-2] // 2
        f[..., r, :] = (f[..., r, :] + 1) % self.h_win
        return f, cost
    monkeypatch.setattr(radial.RadialFlowNetwork, "flow", shifted)


def _to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def _trunk_tf32(monkeypatch):
    """The trunk's convolutions on TF32 inputs and weights, as cuDNN's TF32
    kernels read them (accumulating in float32)."""
    from depth_estimation_tpu_torch.models import filters
    conv = filters._conv

    def tf32(x, weight, bias):
        return conv(_to_tf32(x), _to_tf32(weight), bias)
    monkeypatch.setattr(filters, "_conv", tf32)


FAULTS = [_epipole_moved, _row_shifted, _trunk_tf32]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    cell, out = tiny_run(seed=11)
    ok, rows = harness.verdict(out["compared"], cell.limits)
    assert not ok, rows


def test_tf32_rounding():
    x = torch.tensor([1.0, 1.0 + 2 ** -11, 1.0 + 2 ** -10 + 2 ** -11,
                      -3.0 - 2 ** -12])
    assert _to_tf32(x).tolist() == [1.0, 1.0, 1.0 + 2 ** -9, -3.0]


@pytest.mark.cuda
@pytest.mark.parametrize("seed", [101, 202])
def test_control_is_not_correct_on_the_card(seed, card):
    cell = harness.Cell(CELL)
    mix = dict(cell.mix, streams=16, frames=4, keep=1)
    out = harness.run_cell(cell, seed, 1.0, False, [card],
                           time.perf_counter(), control=True, mix=mix,
                           log=lambda s: None)
    ok, rows = harness.verdict(out["compared"], cell.limits)
    assert ok, rows
    bad, rows = harness.verdict(out["control"], cell.limits)
    assert not bad, rows
    torch.cuda.empty_cache()


# ---------------------------------------------------------------------------
# the readers on a synthetic trace: one step of 100 ms on the host
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


# the benchmark's wrappers (step, api, ego, trunk) and the program's spans
WRAPPERS = [_range("step", 1000, 101000), _range("api", 1010, 100990),
            _range("ego", 1100, 60000), _range("trunk", 70100, 72000),
            _range("trunk", 72100, 74000)]
SPANS = [_range("radial.ego", 1050, 60100), _range("ego.lk", 10000, 30000),
         _range("radial.polar", 60200, 70000),
         _range("radial.net", 70050, 80000),
         _range("radial.depth", 80100, 90000)]
KERNELS = (_launched(1, 2000, "corners", 2100, 9000)
           + _launched(2, 10100, "lk", 10200, 40200)            # 30 ms
           + _launched(3, 60300, "warp", 60400, 64400)          # 4 ms
           + _launched(4, 70200, "conv", 70300, 72300)          # 2 ms
           + _launched(5, 72200, "conv", 72300, 74300)          # 2 ms
           + _launched(6, 75000, "ssd", 75100, 76100)           # 1 ms
           + _launched(7, 80200, "p2c", 80300, 81300))          # 1 ms
# a trunk call's work: 0.2 ms of bytes, 0.5 ms of FP32 operations
TRUNK_WORK = (0.2e-3 * 3.35e12, 0.5e-3 * 67e12)
EXPECT = {
    "ego_ms.radial": 60.0,
    "lk_device_ms.radial": 30.0,
    "polar_device_ms.radial": 5.0,
    "net_device_ms.radial": 5.0,
    # 2 calls of 0.5 ms bound over 4 ms of device time
    "trunk_roofline.radial": 25.0,
    # 6.7e11 operations in 0.1 s on 67 TFLOP/s
    "step_mfu.radial": 10.0,
}


def _reader(name):
    path = harness.BENCH / "metrics" / f"{name}.py"
    spec = importlib.util.spec_from_file_location("m", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def _readings(events):
    return readings.Readings(
        profiled=trace.reduce_trace(events, 1), profiled_steps=1,
        work={"trunk": [TRUNK_WORK, TRUNK_WORK]},
        sync_ms={"ego": [58.0, 62.0]}, sync_steps=2, step_s=0.1,
        step_flops=6.7e11)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(name):
    r = _readings(WRAPPERS + SPANS + KERNELS)
    assert _reader(name)(r) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_finds_nothing(name):
    read = _reader(name)
    assert read(readings.Readings()) is None
    if name in ("lk_device_ms.radial", "polar_device_ms.radial",
                "net_device_ms.radial"):
        # a program without the spans (an older one): no number, and
        # no error
        assert read(_readings(WRAPPERS + KERNELS)) is None


def test_readers_are_the_cells():
    cell = harness.Cell(CELL)
    assert {m["name"] for m in cell.per_layer} == set(EXPECT)
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "pairs_per_s"
