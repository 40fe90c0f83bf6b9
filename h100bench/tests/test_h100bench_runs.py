"""Tiny runs of every cell's path on the CPU through the harness (the
program's plain twins stand in for its kernels there), and the entry
point's refusals."""

import json
import shutil
import subprocess
import sys
import time

import pytest
import torch

from h100bench import harness

CELLS = [w["name"] for w in harness.manifest()["workloads"]]


def tiny_run(name, mixes, seed=2 ** 31 + 7, trace_on=False, control=False):
    cell = harness.Cell(name)
    mix = dict(cell.mix, **mixes[name])
    devices = ["cpu"] * cell.chips
    torch.set_num_threads(2)
    out = harness.run_cell(cell, seed, 0.2, trace_on, devices,
                           time.perf_counter(), control=control, mix=mix,
                           log=lambda s: None)
    return cell, out


@pytest.mark.parametrize("name", CELLS)
def test_tiny_run_is_correct(name, tiny_mixes):
    cell, out = tiny_run(name, tiny_mixes)
    ok, rows = harness.verdict(out["compared"], cell.limits)
    assert ok, rows
    assert out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {m["name"] for m in cell.end_to_end}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_tiny_traced_run_reads_spans(tiny_mixes):
    cell, out = tiny_run("car_model.online_fast", tiny_mixes, trace_on=True)
    # the CPU trace has no device operations: only the span's reader and
    # the host clock's read
    assert set(out["metrics"]) == {"ego_ms.batch", "step_mfu"}
    assert all(v["value"] > 0 for v in out["metrics"].values())


def test_same_seed_same_inputs(tiny_mixes):
    from h100bench import traffic
    a = traffic.camera_streams(traffic.device_generator(2 ** 40 + 3, "cpu"),
                               2, 3, texture=(12, 16), hw=(48, 64))
    b = traffic.camera_streams(traffic.device_generator(2 ** 40 + 3, "cpu"),
                               2, 3, texture=(12, 16), hw=(48, 64))
    c = traffic.camera_streams(traffic.device_generator(2 ** 40 + 4, "cpu"),
                               2, 3, texture=(12, 16), hw=(48, 64))
    assert torch.equal(a, b) and not torch.equal(a, c)
    w1 = traffic.working_frames(traffic.device_generator(2 ** 33, "cpu"), 2,
                                18, 32, "cpu")
    w2 = traffic.working_frames(traffic.device_generator(2 ** 33, "cpu"), 2,
                                18, 32, "cpu")
    assert all(torch.equal(x, y) for x, y in zip(w1, w2))
    assert [traffic.ping_pong(t, 4) for t in range(8)] == [0, 1, 2, 3, 2, 1,
                                                           0, 1]


def _run_py(cwd, *extra):
    return subprocess.run(
        [sys.executable, "h100bench/run.py", "--workload",
         "car_model.online_fast", "--seed", "1", "--seconds", "1",
         "--trace", "0", *extra], cwd=cwd, capture_output=True, text=True,
        timeout=120)


def test_run_refuses_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is visible")
    p = _run_py(harness.ROOT)
    assert p.returncode != 0 and p.stdout == ""
    assert "CUDA" in p.stderr


def test_run_refuses_without_the_program(tmp_path):
    shutil.copy(harness.ROOT / "BENCHMARK.json", tmp_path)
    shutil.copytree(harness.BENCH, tmp_path / "h100bench",
                    ignore=shutil.ignore_patterns("__pycache__"))
    p = _run_py(tmp_path)
    assert p.returncode != 0 and p.stdout == ""


def test_result_line_shape(tiny_mixes, monkeypatch, capsys):
    """run.main's line, its CUDA look bypassed: the keys a reader expects,
    ``compared`` last, each number beside its limit."""
    from h100bench import run
    cell = harness.Cell("config3_multiscale.decode_b64")
    mix = dict(cell.mix, **tiny_mixes[cell.name])
    real = harness.run_cell
    monkeypatch.setattr(harness, "_json", lambda kind, name: mix
                        if kind == "traffic" else json.load(open(
                            harness.BENCH / kind / f"{name}.json")))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    monkeypatch.setattr(torch.cuda, "get_device_name", lambda *a: "cpu")
    monkeypatch.setattr(torch.cuda, "max_memory_allocated", lambda *a: 0)
    monkeypatch.setattr(harness, "run_cell", lambda c, s, sec, t, d, t0: real(
        c, s, sec, t, ["cpu"], t0))
    assert run.main(["--workload", cell.name, "--seed", "5", "--seconds",
                     "0.1", "--trace", "0"]) == 0
    line = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    assert list(line)[-1] == "compared"
    assert {"correct", "attempted", "failed", "metrics", "device"} <= set(line)
    assert line["correct"] is True
    assert set(line["compared"]) == set(cell.limits)
