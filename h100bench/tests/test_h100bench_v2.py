"""The ``config1_v2.core_b64`` cell: a tiny run of its path on the CPU
through the harness, its four per-layer readers on a synthetic trace and
on nothing, ``v2_counts`` against a hand count, the faults it must catch
(the trunk in TF32, the normalisation without its border
renormalisation, the WTA index moved at 0.1% of pixels), the reference's
imports and, on a card, its control."""

import ast
import importlib.util
import subprocess
import sys
import time

import pytest
import torch

from h100bench import counts, harness, readings, trace, v2_counts

CELL = "config1_v2.core_b64"
# the cell cut to a size the CPU runs in seconds: 2 pairs at 64x96, a
# 7x7 trunk of 8 features, a 7x7 window (52x84 pixels a pair)
TINY = dict(image={"hImg": 64, "wImg": 96},
            network={"normalization_k": 17, "layers": [[3, 7, 7, 8]],
                     "hWin": 7, "wWin": 7})


def tiny_cell():
    cell = harness.Cell(CELL)
    cell.config = dict(cell.config, **TINY)
    mix = dict(cell.mix, pairs=2, distinct_batches=2, ref_block=1)
    return cell, mix


def tiny_run(trace_on=False, seed=2 ** 31 + 7):
    cell, mix = tiny_cell()
    torch.set_num_threads(2)
    out = harness.run_cell(cell, seed, 0.2, trace_on, ["cpu"],
                           time.perf_counter(), mix=mix, log=lambda s: None)
    return cell, out


def test_tiny_run_is_correct():
    cell, out = tiny_run()
    ok, rows = harness.verdict(out["compared"], cell.limits)
    assert ok, rows
    assert set(out["compared"]) == set(cell.limits)
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"pairs_per_s", "setup_s"}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_tiny_traced_run_reads_the_host_clock():
    cell, out = tiny_run(trace_on=True)
    # the CPU trace has no device operations: only the host clock's share
    # of the peak
    assert set(out["metrics"]) == {"step_mfu.v2"}
    assert out["metrics"]["step_mfu.v2"]["value"] > 0


def _to_tf32(t: torch.Tensor) -> torch.Tensor:
    """float32 rounded to TF32 (10 mantissa bits, to nearest even)."""
    i = t.contiguous().view(torch.int32)
    i = (i + 0x0FFF + ((i >> 13) & 1)) & -8192
    return i.view(torch.float32)


def _trunk_tf32(monkeypatch):
    """The trunk's convolution on TF32 inputs and weights, as cuDNN's TF32
    kernels read them (accumulating in float32)."""
    from depth_estimation_tpu_torch.models import filters
    conv = filters._conv

    def tf32(x, weight, bias):
        return conv(_to_tf32(x), _to_tf32(weight), bias)
    monkeypatch.setattr(filters, "_conv", tf32)


def _no_border_renormalisation(monkeypatch):
    """The normalisation's local sums divided by the interior's
    coefficient everywhere, not by the convolved map of ones."""
    from depth_estimation_tpu_torch.ops import normalization
    local_mean = normalization._local_mean

    def flat(img, f):
        coef, _ = local_mean(img, f)
        inner = coef.amax()
        return (torch.full_like(coef, float(inner)),
                normalization._channel_sum(img, f) / inner)
    monkeypatch.setattr(normalization, "_local_mean", flat)


def _wta_moved(monkeypatch):
    """The WTA index one cell on at every thousandth pixel."""
    from depth_estimation_tpu_torch.models import version2
    flow_batch = version2.V2Network.flow_batch

    def moved(self, *a, **k):
        idx, ey, ex, pmax = flow_batch(self, *a, **k)
        flat = idx.clone().reshape(-1)
        cells = self.geometry.maxh * self.geometry.maxw
        flat[::1000] = (flat[::1000] + 1) % cells
        return flat.reshape(idx.shape), ey, ex, pmax
    monkeypatch.setattr(version2.V2Network, "flow_batch", moved)


FAULTS = [_trunk_tf32, _no_border_renormalisation, _wta_moved]


@pytest.mark.parametrize("fault", FAULTS, ids=lambda f: f.__name__[1:])
def test_fault_is_not_correct(fault, monkeypatch):
    fault(monkeypatch)
    cell, out = tiny_run(seed=11)
    ok, rows = harness.verdict(out["compared"], cell.limits)
    assert not ok, rows


def test_reference_imports_no_jax_and_no_port():
    path = harness.BENCH / "reference" / "v2.py"
    tree = ast.parse(path.read_text())
    tops = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            tops |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom):
            tops.add(node.module.split(".")[0])
    assert tops <= {"__future__", "math", "typing", "torch", "h100bench"}
    code = ("import sys; sys.path.insert(0, '.');"
            "import h100bench.reference.v2;"
            "print(sorted({m.split('.')[0] for m in sys.modules}"
            " & {'jax', 'jaxlib', 'flax', 'depth_estimation_tpu',"
            " 'depth_estimation_tpu_torch'}))")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"


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
# the counts against a hand count
# ---------------------------------------------------------------------------

def test_fast_work_by_hand():
    # f1 (2, 3, 4, 5), f2 (2, 5, 7, 5), a 3x4 window: 24 pixels of 12 cells
    # at 2*5 + 8 = 18 operations; norms of 24 + 70 positions at 10
    f1, f2 = torch.zeros(2, 3, 4, 5), torch.zeros(2, 5, 7, 5)
    nbytes, flops = v2_counts.fast_work((f1, f2, 3, 4), {})
    assert flops == 24 * 12 * 18 + (24 + 70) * 10
    assert nbytes == (120 + 350) * 4 + 4 * 24 * 4


def test_step_flops_by_hand():
    # 64 pairs at 180x320: the trunk on 128 frames of 164x304 output
    # pixels at 2*3*32*17*17 FLOPs, and 148x288 pixels of 289 cells at 64
    trunk = 128 * 164 * 304 * 2 * 3 * 32 * 17 * 17
    match = 64 * 148 * 288 * 289 * 64
    got = v2_counts.step_flops([[3, 17, 17, 32]], 17, 17, 64, 180, 320)
    assert got == trunk + match
    assert got == pytest.approx(4.0456e11, rel=1e-4)


# ---------------------------------------------------------------------------
# the readers on a synthetic trace: one step of 40 ms on the host
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


# the benchmark's wrappers (step, api, trunk, match) and the program's spans
WRAPPERS = [_range("step", 1000, 41000), _range("api", 1010, 40990),
            _range("trunk", 11000, 12000), _range("match", 30000, 31000)]
SPANS = [_range("v2.norm", 1050, 10900), _range("v2.trunk", 10950, 12100),
         _range("v2.match", 29900, 31100)]
KERNELS = (_launched(1, 2000, "norm_add", 2100, 6100)          # 4 ms
           + _launched(2, 3000, "norm_mul", 6100, 7100)        # 1 ms
           + _launched(3, 11100, "conv", 11200, 21200)         # 10 ms
           + _launched(4, 30100, "b2", 30200, 34200))          # 4 ms
# the trunk's work: 5 ms of FP32 operations; B2's: 1 ms of operations
TRUNK_WORK = (1e-3 * 3.35e12, 5e-3 * 67e12)
MATCH_WORK = (0.1e-3 * 3.35e12, 1e-3 * 67e12)
EXPECT = {
    "norm_device_ms.v2": 5.0,
    # 5 ms bound over 10 ms of device time
    "trunk_roofline.v2": 50.0,
    # 1 ms bound over 4 ms
    "b2_roofline.v2": 25.0,
    # 1.34e12 operations in 0.04 s on 67 TFLOP/s
    "step_mfu.v2": 50.0,
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
        work={"trunk": [TRUNK_WORK], "match": [MATCH_WORK]},
        step_s=0.04, step_flops=1.34e12)


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader(name):
    r = _readings(WRAPPERS + SPANS + KERNELS)
    assert _reader(name)(r) == pytest.approx(EXPECT[name])


@pytest.mark.parametrize("name", sorted(EXPECT))
def test_reader_finds_nothing(name):
    read = _reader(name)
    assert read(readings.Readings()) is None
    if name == "norm_device_ms.v2":
        # a program without the span (the parent's): no number, no error
        assert read(_readings(WRAPPERS + KERNELS)) is None


def test_readers_are_the_cells():
    cell = harness.Cell(CELL)
    assert {m["name"] for m in cell.per_layer} == set(EXPECT)
    for m in cell.per_layer:
        assert m["workloads"] == [CELL] and m["moves"] == "pairs_per_s"
    assert counts.PEAK_FP32 == 67e12
