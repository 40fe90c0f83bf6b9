"""PyTorch port vs the JAX package: the batched online program
(BatchedDepthEstimator) in every compensation mode with both heads, over a
two-step stream, on the same weights, frames and RANSAC noise; and the
port's import boundary."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch import api_batched as tapi
from torch_parity import pipeline_case, run_batched_both

H, W = 96, 128
REPO = os.path.join(os.path.dirname(__file__), "..")
# xflow tolerance where both masks keep a pixel: the one the reference's own
# warp-vs-warp_banded test holds (tests/test_batched_pipeline.py)
ATOL = 1e-3
# 'max' head: the WTA index may flip where the two best logits are within
# float rounding; such pixels move by whole pixels and must stay this rare
MAX_HEAD_FLIPS = 1e-3


@pytest.fixture(scope="module")
def setup():
    return pipeline_case()


@pytest.mark.parametrize("head", ["mean", "max"])
@pytest.mark.parametrize("compensation", ["warp", "warp_banded", "decode"])
def test_batched_pipeline_matches_jax(setup, compensation, head):
    kept = []
    for step, (a, b) in enumerate(run_batched_both(setup, compensation=compensation,
                                            head=head)):
        xf, m, depth, good = a
        jxf, jm, jdepth, jgood = b
        assert xf.shape == m.shape == depth.shape == (2, H, W)
        np.testing.assert_array_equal(good, jgood)
        assert good.all(), step
        assert ((m > 0) == (jm > 0)).mean() >= 0.999, step
        sel = (m > 0) & (jm > 0)
        kept.append(sel.mean())
        d = np.abs(xf - jxf)[sel]
        if head == "mean":
            assert d.size == 0 or d.max() <= ATOL, (step, d.max())
        else:
            bad = d > ATOL
            assert bad.sum() <= MAX_HEAD_FLIPS * d.size, (step, bad.mean())
            np.testing.assert_allclose(d[bad], np.round(d[bad]), atol=ATOL)
        # depth is the x-flow rule applied to this xflow
        np.testing.assert_array_equal(
            depth, tapi.depth_from_xflow(torch.from_numpy(xf), W).numpy())
        assert np.isfinite(depth[np.abs(xf) >= 0.1]).all()
        same = sel & (np.abs(xf - jxf) <= ATOL) & (np.abs(xf) >= 0.5)
        np.testing.assert_allclose(depth[same], jdepth[same], rtol=1e-2)
    # decode mode masks rotations beyond its 2 px margin, which the first
    # step's estimate exceeds in these scenes (in both packages)
    assert max(kept) > 0.5, kept


def test_port_imports_no_jax():
    """Every module of the port imports without jax, flax, msgpack or the
    JAX package, the mesh layer (parallel/) among them."""
    code = (
        "import importlib, pkgutil, sys\n"
        "import depth_estimation_tpu_torch as p\n"
        "for m in pkgutil.walk_packages(p.__path__, p.__name__ + '.'):\n"
        "    importlib.import_module(m.name)\n"
        "assert 'depth_estimation_tpu_torch.parallel.mesh' in sys.modules\n"
        "bad = [n for n in ('jax', 'flax', 'msgpack', 'depth_estimation_tpu')\n"
        "       if n in sys.modules]\n"
        "assert not bad, bad\n"
        "print(len([m for m in sys.modules if m.startswith(p.__name__)]))\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert res.returncode == 0, res.stderr
    assert int(res.stdout.strip()) >= 20
