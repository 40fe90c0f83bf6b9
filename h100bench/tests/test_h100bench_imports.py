"""Nothing the benchmark runs loads JAX or the JAX package: compared by
the whole top-level module name, since the port's name begins with the
JAX package's. The reference imports nothing of the port either."""

import ast
import subprocess
import sys

import pytest

from h100bench import harness

FILES = sorted(p for p in harness.BENCH.rglob("*.py")
               if "tests" not in p.parts)


def _tops(path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", FILES, ids=lambda p: str(p.relative_to(
    harness.BENCH)))
def test_no_jax_import(path):
    tops = set(_tops(path))
    assert not tops & set(harness.FORBIDDEN), tops
    if "reference" in path.parts:
        assert "depth_estimation_tpu_torch" not in tops


def test_forbidden_is_a_whole_name(monkeypatch):
    monkeypatch.setitem(sys.modules, "depth_estimation_tpu_torch_fake", sys)
    assert "depth_estimation_tpu_torch_fake" not in harness.forbidden_modules()
    monkeypatch.setitem(sys.modules, "jax.numpy", sys)
    assert harness.forbidden_modules() == ["jax"]


def test_a_run_loads_no_jax():
    code = ("import sys, time, torch; sys.path.insert(0, '.');"
            "from h100bench import harness;"
            "c = harness.Cell('config3_multiscale.decode_b64');"
            "m = dict(c.mix, pairs=1, distinct_batches=1);"
            "harness.run_cell(c, 3, 0.1, False, ['cpu'], time.perf_counter(),"
            " mix=m, log=lambda s: None);"
            "import depth_estimation_tpu_torch.api_batched;"
            "print(harness.forbidden_modules())")
    p = subprocess.run([sys.executable, "-c", code], cwd=harness.ROOT,
                       capture_output=True, text=True, timeout=300)
    assert p.returncode == 0, p.stderr[-2000:]
    assert p.stdout.strip().splitlines()[-1] == "[]"
