"""PyTorch port vs the JAX package: the legacy direct-depth CLI
(``cli/depth_estimation.py``) end to end, the same argv through both
``main``s (the port's with ``--device cpu``): training, then ``-lw`` with
``-i``.

The CLI takes no ``-lw`` for its initial weights, so the port trainer's
``init`` is made to load the JAX CLI's ``PRNGKey(0)`` tree through the
weight bridge. Tolerances (tests/test_torch_family_trainers.py): the
corpora (patches and classes of ``generate_data_discrete``) and the
discretizer's line equal; each epoch's loss (the score history) within
relative 1e-5, accuracies and confusion matrices equal; the weights
within absolute 1e-5 (``TOL_PARAM``), read by the JAX reader; ``meta.json``
equal apart from the score history; the class maps (each package on the
other's checkpoint for the ``-lw`` run) equal on 99.9% of the pixels, as
their ``.npz`` and PNG files.
"""

import json
import os
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest
from PIL import Image

from depth_estimation_tpu.cli import depth_estimation as jlegacy_cli
from depth_estimation_tpu.data import depth_legacy as jdl
from depth_estimation_tpu.models import legacy_depth as jlegacy
from depth_estimation_tpu_torch.cli import depth_estimation as tlegacy_cli
from depth_estimation_tpu_torch.data import depth_legacy as tdl
from depth_estimation_tpu_torch.training import families
from torch_parity import (assert_trees_close, one_torch_thread,  # noqa: F401
                          read_weights, record, start_from)

TOL_LOSS_REL = 1e-5
TOL_PARAM = 1e-5



def write_legacy_scene(root):
    """tests/test_cli.py's legacy scene: the left half textured and near
    (depth 4), the right half flat and far (depth 40)."""
    h, w = 96, 128
    os.makedirs(os.path.join(root, "images"))
    os.makedirs(os.path.join(root, "depths"))
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    stripes = 0.5 + 0.4 * np.sin(2 * np.pi * (xx + yy) / 4.0)
    for i in range(4):
        img = np.full((h, w), 0.5, np.float32)
        img[:, : w // 2] = stripes[:, : w // 2]
        img += rng.rand(h, w).astype(np.float32) * 0.05
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(root, "images", f"{i:09d}.png"))
        xs = rng.randint(0, w, 60).astype(np.float32)
        ys = rng.randint(0, h, 60).astype(np.float32)
        depth = np.where(xs < w // 2, 4.0, 40.0).astype(np.float32)
        np.savez(os.path.join(root, "depths", f"{i:09d}.npz"), x=xs, y=ys,
                 depth=depth)
    return root


def test_depth_estimation_cli_matches_jax(tmp_path, monkeypatch, capsys):
    """Training (2 epochs, n 160, m 32, B=16) with its confusion matrices
    and class map of frame 0, then ``-lw`` with ``-i 1``: the class maps,
    their .npz and PNG, the score history and the weights."""
    init = jax.jit(jlegacy.DepthClassifierCNN(n_classes=2).init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 2), jnp.float32))
    start_from(monkeypatch, families.DepthClassifierTrainer, init)
    root = write_legacy_scene(str(tmp_path / "scene"))
    jdraws, tdraws = [], []
    record(monkeypatch, jdl, "generate_data_discrete", jdraws)
    record(monkeypatch, tdl, "generate_data_discrete", tdraws)
    argv = ["-rd", root, "-d", "1", "-ni", "3", "-n", "160", "-m", "32",
            "-e", "2", "-nc", "2", "-hi", "96", "-wi", "128", "-bs", "16",
            "-i", "0"]
    out = {}
    dirs = {k: str(tmp_path / k) for k in ("jax", "port")}
    for name, main, extra in (("jax", jlegacy_cli.main, []),
                              ("port", tlegacy_cli.main,
                               ["--device", "cpu"])):
        assert main(argv + ["-o", dirs[name]] + extra) == 0
        out[name] = capsys.readouterr().out
    assert len(tdraws) == len(jdraws) == 2
    for t, j in zip(tdraws, jdraws):
        np.testing.assert_array_equal(t[0], j[0])
        np.testing.assert_array_equal(t[1], j[1])
    # the cut line, then each epoch's line and confusion matrix
    tlines, jlines = (o.split("epoch 0:")[0] for o in (out["port"],
                                                      out["jax"]))
    assert tlines == jlines and "cutDepth=" in tlines
    for name in ("confusion", "class map:"):
        assert out["port"].count(name) == out["jax"].count(name) > 0
    tconf, jconf = (re.findall(r"confusion:\n (\[\[.*?\]\])", o, re.S)
                    for o in (out["port"], out["jax"]))
    assert tconf == jconf and len(tconf) == 2
    tmeta, jmeta = (json.load(open(os.path.join(dirs[k], "meta.json")))
                    for k in ("port", "jax"))
    assert ({k: v for k, v in tmeta.items() if k != "score"}
            == {k: v for k, v in jmeta.items() if k != "score"})
    for t, j in zip(tmeta["score"], jmeta["score"]):
        np.testing.assert_allclose(t["loss"], j["loss"], rtol=TOL_LOSS_REL)
        assert (t["train_acc"], t["test_acc"]) == (j["train_acc"],
                                                   j["test_acc"])
    assert_trees_close(
        read_weights(os.path.join(dirs["port"], "params.msgpack"), init),
        read_weights(os.path.join(dirs["jax"], "params.msgpack"), init),
        TOL_PARAM)

    # -lw: each package loads the other's checkpoint and maps frame 1
    for name, main, extra, model in (
            ("jax", jlegacy_cli.main, [], dirs["port"]),
            ("port", tlegacy_cli.main, ["--device", "cpu"], dirs["jax"])):
        assert main(["-rd", root, "-d", "1", "-ni", "3", "-hi", "96", "-wi",
                     "128", "-lw", model, "-i", "1", "-o", dirs[name]]
                    + extra) == 0
    capsys.readouterr()
    for i in (0, 1):
        stem = f"depth_classes_{i:09d}"
        t, j = (np.load(os.path.join(dirs[k], stem + ".npz"))["classes"]
                for k in ("port", "jax"))
        assert t.shape == j.shape and t.ndim == 2
        assert (t == j).mean() >= 0.999
        png = [np.asarray(Image.open(os.path.join(dirs[k], stem + ".png")))
               for k in ("port", "jax")]
        assert png[0].shape == png[1].shape
        assert (png[0] == png[1]).mean() >= 0.999


@pytest.mark.parametrize("cut_depth", ["10", "3"])
def test_depth_estimation_cli_cut_depth_matches_jax(tmp_path, capsys,
                                                    cut_depth):
    """``-cd`` overrides the discretizer's cut and bin step (no epoch:
    the draws, the printed line and the saved meta.json)."""
    root = write_legacy_scene(str(tmp_path / "scene"))
    argv = ["-rd", root, "-d", "1", "-ni", "3", "-n", "40", "-m", "20",
            "-e", "0", "-nc", "3", "-hi", "96", "-wi", "128", "-cd",
            cut_depth]
    out = {}
    for name, main, extra in (("jax", jlegacy_cli.main, []),
                              ("port", tlegacy_cli.main,
                               ["--device", "cpu"])):
        assert main(argv + ["-o", str(tmp_path / name)] + extra) == 0
        out[name] = capsys.readouterr().out
    assert out["port"] == out["jax"]
    assert f"cutDepth={float(cut_depth)}" in out["port"]
    tmeta, jmeta = (json.load(open(tmp_path / k / "meta.json"))
                    for k in ("port", "jax"))
    assert tmeta == jmeta
