"""PyTorch port vs the JAX package: the peak meter's kernels P1 and P2, the
speed-of-light row, the bound formulas, and the small API gaps that came
with them (``geometry.default_geometry``, ``utils/timer``'s span, profiler
span and trace capture).

The JAX meter's chains return only a rate, so their bodies are taken from
the JAX files themselves: P1's by catching the chain ``measure_vpu_*``
hands to ``_measure_vpu`` (benchmarks/device_peaks.py:235-270), P2's
``logi1``-``logi8`` (benchmarks/probe_vpu_peak.py:64-95) and its op counts
(:92-95) by reading the file's syntax tree. Both run under ``jax.jit`` on
the same numpy-seeded values as the port's plain twins. Tolerance 1e-6:
XLA may fuse ``c - c*c`` into one FMA where torch rounds the product and
the difference, and the two exps may part by an ulp; both maps contract
on (0, 1), so the values below 1 part by a few ulp (6e-8 each).

On the CPU the wrappers run their plain twins; the kernels' own checks
against the twins are in tests/test_torch_cuda.py and chip_smoke.py.
"""

import ast
import dataclasses
import importlib.util
import json
import os
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.flop_counter import FlopCounterMode

from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.geometry import default_geometry as jdefault
from depth_estimation_tpu.utils import timer as jtimer
from depth_estimation_tpu_torch import geometry as tgeometry
from depth_estimation_tpu_torch.benchmarks import device_peaks as dp
from depth_estimation_tpu_torch.benchmarks import probe_vpu_peak
from depth_estimation_tpu_torch.benchmarks import speed_of_light as sol
from depth_estimation_tpu_torch.models.filters import ConvFilter, init_params
from depth_estimation_tpu_torch.utils import timer as ttimer
from torch_parity import one_torch_thread  # noqa: F401

BENCH = os.path.join(os.path.dirname(__file__), "..", "benchmarks")
TOL = 1e-6
N_ITER = 3


def load_bench(name):
    """The JAX package's ``benchmarks/<name>.py`` as a module, with
    ``benchmarks/`` on sys.path only while it loads (speed_of_light imports
    device_peaks from there); sys.path and sys.modules as they were after."""
    path = sys.path[:]
    had = "device_peaks" in sys.modules
    sys.path.insert(0, BENCH)
    try:
        spec = importlib.util.spec_from_file_location(
            f"jax_bench_{name}", os.path.join(BENCH, f"{name}.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        sys.path[:] = path
        if not had:
            sys.modules.pop("device_peaks", None)
    return mod


def values(seed, n=8 * 128):
    return np.random.RandomState(seed).uniform(0.05, 0.95, n).astype(np.float32)


def jax_loop(op, x, n_iter):
    """n_iter iterations of a JAX chain body, as the meter's fori_loop runs
    it (device_peaks.py:180-183)."""
    f = jax.jit(lambda v: jax.lax.fori_loop(0, n_iter, lambda _, w: op(w), v))
    return np.asarray(f(jnp.asarray(x)))


@pytest.fixture(scope="module")
def p1_chains():
    """{op: (the JAX chain body, its ops an element and iteration)}, caught
    from measure_vpu_fma_gflops / measure_vpu_exp_gops."""
    mod = load_bench("device_peaks")
    caught = {}

    def fake(unrolled_op, ops, tpu, interpret, **kw):
        caught["op"] = (unrolled_op, ops)
        return 1.0
    mod._measure_vpu = fake
    out = {}
    for op, fn in (("fma", mod.measure_vpu_fma_gflops),
                   ("exp", mod.measure_vpu_exp_gops)):
        fn(False, True)
        out[op] = caught["op"]
    return out


@pytest.fixture(scope="module")
def p2_source():
    """The JAX probe's logi1-logi8 as functions, and its op counts by
    chain function, from the file's syntax tree."""
    path = os.path.join(BENCH, "probe_vpu_peak.py")
    with open(path) as f:
        tree = ast.parse(f.read())
    U = next(n.value.value for n in ast.walk(tree)
             if isinstance(n, ast.Assign) and isinstance(n.targets[0], ast.Name)
             and n.targets[0].id == "U")
    fns, ops = {}, {}
    for node in ast.walk(tree):
        if isinstance(node, ast.FunctionDef) and node.name.startswith("logi"):
            ns = {"U": U}
            exec(compile(ast.Module(body=[node], type_ignores=[]), path,
                         "exec"), ns)
            fns[node.name] = ns[node.name]
        if (isinstance(node, ast.Call) and isinstance(node.func, ast.Name)
                and node.func.id == "run"):
            ops[node.args[0].id] = eval(compile(ast.Expression(node.args[1]),
                                                path, "eval"), {"U": U})
    return U, fns, ops


@pytest.mark.parametrize("op", ["fma", "exp"])
def test_p1_twin_matches_jax_chains(p1_chains, op):
    x = values(1)
    body, _ = p1_chains[op]
    want = jax_loop(body, x, N_ITER)
    plain = dp.chains_fma_plain if op == "fma" else dp.chains_exp_plain
    _, n_chains, steps, mean = dp.P1[op]
    got = plain(torch.from_numpy(x), n_chains, steps, N_ITER, mean).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    # the wrapper runs the twin on CPU tensors, uncounted
    launches = dp.vpu_loop.launches
    np.testing.assert_array_equal(
        dp.vpu_loop(torch.from_numpy(x), op, N_ITER).numpy(), got)
    assert dp.vpu_loop.launches == launches


@pytest.mark.parametrize("n_chains", [1, 2, 4, 8])
def test_p2_twin_matches_jax_chains(p2_source, n_chains):
    U, fns, _ = p2_source
    assert U == dp.P2_STEPS
    x = values(2)
    want = jax_loop(fns[f"logi{n_chains}"], x, N_ITER)
    got = dp.chains_fma_plain(torch.from_numpy(x), n_chains, U // n_chains,
                              N_ITER, False).numpy()
    np.testing.assert_allclose(got, want, rtol=0, atol=TOL)
    launches = dp.logistic_loop.launches
    np.testing.assert_array_equal(
        dp.logistic_loop(torch.from_numpy(x), n_chains, N_ITER).numpy(), got)
    assert dp.logistic_loop.launches == launches


def test_op_counts_equal_the_jax_meters(p1_chains, p2_source):
    assert {op: ops for op, (_, ops) in p1_chains.items()} == dp.P1_OPS
    _, _, ops = p2_source
    assert {int(k[4:]): v for k, v in ops.items()} == dp.P2_OPS
    assert probe_vpu_peak.CHAINS == tuple(sorted(dp.P2_OPS))


def test_wrappers_refuse_what_the_kernel_does_not_compile():
    x = torch.full((8,), 0.5)
    with pytest.raises(ValueError):
        dp.logistic_loop(x, 3, 1)
    with pytest.raises(ValueError):
        dp.occupancy(12)
    assert dp.occupancy(dp.FULL_WARPS) == (256, 8)
    assert dp.occupancy(4) == (128, 1)


PEAKS = {"vpu_fma_f32_gflops": 60000.0, "vpu_exp_gops": 3000.0,
         "tc_bf16_tflops": 700.0, "mxu_bf16_tflops": 700.0,
         "hbm_stream_gbps": 3000.0, "gather_idx_gops": 20.0}


@pytest.mark.parametrize("case", [
    ("compute", 5e-3, 5e10, 1.4e9, 2e8, 0.0, 0.0),
    ("memory", 3e-4, 4e8, 0.0, 5.7e8, 0.0, 0.0),
    ("gather", 4e-4, 2.8e7, 0.0, 1.9e7, 0.0, 3.9e5),
    ("tensor cores", 2e-3, 1e9, 1e6, 1e8, 1e12, 0.0),
])
def test_roofline_row_matches_jax(case):
    sol_jax = load_bench("speed_of_light")
    name, t, flops, n_exp, nbytes, mm, n_idx = case
    want = sol_jax._roofline(name, t, flops, n_exp, nbytes, PEAKS,
                             mxu_flops=mm, n_idx=n_idx)
    got = sol.roofline(name, t, flops, n_exp, nbytes, PEAKS, mm_flops=mm,
                       n_idx=n_idx)
    assert {k: v for k, v in got.items() if "published" not in k} == want
    assert got["bound_published"] in ("compute", "memory")


FP32_PUB = sol.PUBLISHED["vpu_fma_f32_gflops"]


@pytest.mark.parametrize("case, n_failures", [
    ("ok", 0), ("hbm over", 1), ("impossible row", 1), ("sweep over", 1),
    ("all three", 3), ("cpu", 0)])
def test_contract_failures(case, n_failures):
    """One home for the contract: ceilings above 105% of their published
    peak, P2's sweep above 105% of the FP32 peak, rows marked impossible;
    nothing for numbers taken on the CPU."""
    peaks = dict({k: 0.9 * v for k, v in sol.PUBLISHED.items()},
                 device="cuda")
    rows = [{"kernel": "B1", "pct_sol": 80.0}]
    sweep = {"warps_an_sm": {"64": {"8": {"gflops": 0.95 * FP32_PUB}}}}
    if case in ("hbm over", "all three", "cpu"):
        peaks["hbm_stream_gbps"] = 1.06 * sol.PUBLISHED["hbm_stream_gbps"]
    if case in ("impossible row", "all three", "cpu"):
        rows.append({"kernel": "B2", "pct_sol": 101.0, "impossible": True})
    if case in ("sweep over", "all three", "cpu"):
        sweep["warps_an_sm"]["4"] = {"1": {"gflops": 1.06 * FP32_PUB}}
    if case == "cpu":
        peaks["device"] = "cpu"
    got = sol.contract_failures(peaks, rows, sweep)
    assert len(got) == n_failures, got
    assert sol.contract_failures(peaks, rows) == [
        f for f in got if not f.startswith("P2")]


def test_bounds_keep_perf_md_numbers():
    """The moved formulas give PERF.md's bounds at the main paths' shapes:
    B1 0.745 ms (operations, 35 a cell), B3 f32 0.169 ms and bf16 0.131 ms
    (bytes), B4 0.0070 ms (operations)."""
    def meta(*shape, dt=torch.float32):
        return torch.empty(shape, dtype=dt, device="meta")
    bf = torch.bfloat16
    ms, by = sol.matcher_bound(meta(128, 150, 290, 10, dt=bf),
                               meta(128, 165, 305, 10, dt=bf), 16, 16, 5,
                               3 * 10 + 5)
    assert (round(ms, 3), by) == (0.745, "operations")
    imgs, xs = meta(128, 165, 305, 10), meta(128, 165, 305)
    assert [round(sol.bound_ms(*sol.warp_work(i, xs, xs))[0], 3)
            for i in (imgs, meta(128, 165, 305, 10, dt=bf))] == [0.169, 0.131]
    assert sol.bound_ms(*sol.warp_work(imgs, xs, xs))[1] == "bytes"
    ms, by = sol.bound_ms(*sol.sor_work([meta(8, 192, 256)], 40))
    assert (round(ms, 4), by) == (0.0070, "operations")
    assert round(sol.PEAK_SFU / 1e12, 2) == 4.18


def test_trunk_flops_equal_flop_counter():
    B, H, W = 2, 24, 32
    geom = tgeometry.Geometry(hImg=H, wImg=W, layers=sol.CAR_LAYERS)
    trunk = ConvFilter(geom)
    with torch.no_grad():
        init_params(trunk, torch.Generator().manual_seed(0))
        with FlopCounterMode(display=False) as fc:
            trunk(torch.rand(B, H, W, 3))
    assert sol.trunk_flops(sol.CAR_LAYERS, B, H, W) == fc.get_total_flops()


@pytest.mark.parametrize("overrides", [
    {}, dict(maxh=8, maxw=8), dict(hImg=96, wImg=128, layers=sol.CAR_LAYERS),
    dict(multiscale=True, ratios=(1, 2), maxh=8, maxw=8)])
def test_default_geometry_equals_jax(overrides):
    want = jdefault(**overrides)
    got = tgeometry.default_geometry(**overrides)
    fields = [f.name for f in dataclasses.fields(tgeometry.Geometry)]
    assert fields == [f.name for f in dataclasses.fields(JGeometry)]
    for name in fields:
        assert getattr(got, name) == getattr(want, name), name


def test_default_geometry_validates():
    with pytest.raises(ValueError):
        tgeometry.default_geometry(layers=((3, 5, 5, 8), (10, 3, 3, 4)))


def test_timers_span_counts_like_jax():
    spans = ["a", "b", "a", "a"]
    jt, tt = jtimer.Timers(), ttimer.Timers(sync_device=True)
    for name in spans:
        with jt.span(name):
            pass
        with tt.span(name) as holder:
            holder["out"] = torch.ones(2)
    assert dict(tt.counts) == dict(jt.counts) == {"a": 3, "b": 1}
    assert set(tt.means()) == set(jt.means())


def test_capture_trace_names_a_profiled_span(tmp_path):
    with ttimer.capture_trace(str(tmp_path)) as started:
        with ttimer.profiled_span("peak_meter_span"):
            torch.ones(64).mul_(2.0)
    assert started
    trace = json.loads((tmp_path / ttimer.TRACE_FILE).read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert "peak_meter_span" in names


def test_meter_and_report_run_on_the_cpu_and_refuse_a_missing_card(
        tmp_path, capsys):
    peaks_path = str(tmp_path / "peaks.json")
    assert dp.main(["--device", "cpu", "--json", peaks_path]) == 0
    peaks = json.loads(open(peaks_path).read())
    assert (peaks["device"], peaks["kind"], peaks["card"]) == ("cpu",) * 3
    for key in ("vpu_fma_f32_gflops", "vpu_exp_gops", "tc_bf16_tflops",
                "matmul_f32_tflops", "hbm_stream_gbps", "gather_idx_gops"):
        assert peaks[key] > 0 and key in peaks["probes"]
    sweep_path = str(tmp_path / "sweep.json")
    assert probe_vpu_peak.main(["--device", "cpu", "--json", sweep_path]) == 0
    sweep = json.loads(open(sweep_path).read())
    assert sweep["device"] == "cpu"
    assert set(sweep["warps_an_sm"]) == {"64", "4"}
    report_path = str(tmp_path / "sol.json")
    assert sol.main(["--device", "cpu", "--peaks", peaks_path,
                     "--json", report_path]) == 0
    report = json.loads(open(report_path).read())
    assert report["device"] == "cpu"
    assert len(report["kernels"]) == 9
    assert all(r["device"] == "cpu" and "impossible" not in r
               for r in report["kernels"])
    other = dict(peaks, kind="NVIDIA H100 80GB HBM3")
    (tmp_path / "other.json").write_text(json.dumps(other))
    with pytest.raises(SystemExit):
        sol.main(["--device", "cpu", "--peaks", str(tmp_path / "other.json"),
                  "--json", report_path])
    if not torch.cuda.is_available():
        for main in (dp.main, probe_vpu_peak.main, sol.main):
            with pytest.raises(RuntimeError):
                main(["--json", str(tmp_path / "x.json")])
