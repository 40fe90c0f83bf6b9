"""BENCHMARK.json against the benchmark's contract: keys, names and units
of the allowed characters, and every file a cell needs found by name."""

import json
import re

import pytest

from h100bench import harness

BENCH = harness.manifest()
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["paths"] == ["h100bench"]
    assert BENCH["command"] == ["python3", "h100bench/run.py"]
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024


def _names():
    yield from (c["name"] for c in BENCH["configs"])
    for w in BENCH["workloads"]:
        yield from (w["name"], w["config"], w["traffic"])
    yield from (m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"])
    for c in BENCH["configs"]:
        yield from c["reduced"]


@pytest.mark.parametrize("name", sorted(set(_names())))
def test_name_characters(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", BENCH["end_to_end"] + BENCH["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_fields(metric):
    assert UNIT.match(metric["unit"]), metric["unit"]
    assert metric["better"] in ("lower", "higher")
    if "bound" in metric:
        assert set(metric) <= {"name", "unit", "better", "bound", "source",
                               "workloads"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert TEXT.match(metric["layer"])
        assert metric["moves"] in {m["name"] for m in BENCH["end_to_end"]}
        assert (harness.BENCH / "metrics" / f"{metric['name']}.py").exists()


def test_unique_names_and_chips():
    for kind in ("configs", "workloads"):
        names = [e["name"] for e in BENCH[kind]]
        assert len(names) == len(set(names))
    metrics = [m["name"] for m in BENCH["end_to_end"] + BENCH["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert "setup_s" in metrics
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)
    used = {w["config"] for w in BENCH["workloads"]}
    assert used == {c["name"] for c in BENCH["configs"]}


@pytest.mark.parametrize("workload", BENCH["workloads"],
                         ids=lambda w: w["name"])
def test_cell_finds_its_files(workload):
    assert set(workload) == {"name", "config", "traffic", "chips", "why"}
    assert workload["chips"] in (1, 4)
    assert TEXT.match(workload["why"])
    cell = harness.Cell(workload["name"], BENCH)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names
    assert cell.limits and all(v >= 0 for v in cell.limits.values())
    assert hasattr(cell.path, "build")


@pytest.mark.parametrize("config", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(config):
    assert set(config) == {"name", "source", "file", "reduced", "why"}
    assert config["file"].startswith("h100bench/")
    with open(harness.ROOT / config["file"]) as f:
        body = json.load(f)
    assert body["name"] == config["name"]
    assert body["reduced"] == config["reduced"]
    assert TEXT.match(config["source"]) and TEXT.match(config["why"])
