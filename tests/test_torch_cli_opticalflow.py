"""PyTorch port vs the JAX package: the flow trainer CLI
(``cli/opticalflow.py``) end to end, the same argv through both ``main``s
(the JAX CLI with ``--dp off``, the port's with ``--device cpu``).

Both start from one checkpoint (``-lw``: the CLIs draw their initial
weights from different generators), read their own copy of the sequence
(each package caches its GT under the dataset root) and take RANSAC's
draws from the reference's key. The scene is the camera stepping
sideways over varying depth (``torch_parity.parallax_frames``, seed 3 at
96x128), whose RANSAC winners are 8 distinct points, so R agrees to float
rounding (ROADMAP C9). Tolerances:
  * the sampled corpora: targets and sample positions equal; the patches
    within 1e-3 (the warped previous frame carries R's ~1e-6 rounding,
    tests/test_torch_datasets.py);
  * each epoch's loss and test error within relative 1e-5, train and
    test accuracies equal;
  * the full-image scores (``full_acc``, ``full_meandst``: WTA over
    every pixel of the eval pairs) within FULL_TOL: a pick between two
    costs within rounding flips a few of the ~50,000 pixels;
  * the saved weights within absolute 1e-5 (``TOL_PARAM``), read back by
    the JAX reader;
  * ``meta.json`` equal apart from the score history.
"""

import dataclasses
import json
import os
import shutil

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from depth_estimation_tpu.cli import opticalflow as jcli
from depth_estimation_tpu.geometry3d import calibration as jcal
from depth_estimation_tpu.models import io as jio
from depth_estimation_tpu.training import train as jtrain
from depth_estimation_tpu_torch.cli import opticalflow as tcli
from depth_estimation_tpu_torch.geometry3d import calibration as tcal
from depth_estimation_tpu_torch.geometry3d import egomotion as tego
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.models.flow import FlowModel
from depth_estimation_tpu_torch.models.multiscale import MultiscaleFlowModel
from depth_estimation_tpu_torch.training import train as ttrain
from torch_parity import (one_torch_thread, parallax_frames,  # noqa: F401
                          ransac_noise, record)

H, W, NPTS = 96, 128, 200
TOL_LOSS_REL = 1e-5
TOL_PARAM = 1e-5
TOL_PATCH = 1e-3
FULL_TOL = 2e-3
COMMON = ["-ni", "4", "-n", "48", "-m", "16", "-nf", "8", "-k1s", "5",
          "-nl", "1", "-ws", "6", "-gtws", "6", "-r", "0.05", "-bs", "16",
          "-cal", "t96x128"]


@pytest.fixture(autouse=True)
def preset_and_draws(monkeypatch):
    """A 96x128 pinhole preset in both packages, and the reference's
    RANSAC draws in the port."""
    for mod in (jcal, tcal):
        base = mod.RECTIFIED_GOPRO_SMALL
        monkeypatch.setitem(mod.PRESETS, "t96x128", dataclasses.replace(
            base, name="t96x128", wImg=W, hImg=H, fx=100.0, fy=100.0,
            cx=W / 2, cy=H / 2,
            sfm=dataclasses.replace(base.sfm, max_points=NPTS)))
    monkeypatch.setattr(tego, "gumbel_noise",
                        lambda s, n, dev, generator=None: torch.as_tensor(
                            ransac_noise(s, n), device=dev))


def write_sequence(root, parallax):
    d = os.path.join(root, "images")
    os.makedirs(d)
    for i, f in enumerate(parallax_frames(np.random.RandomState(3), H, W,
                                          4, *parallax)):
        Image.fromarray((f * 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:09d}.png"))
    return root


def init_checkpoint(tmp, argv):
    """The weights both runs start from (``-lw``), seeded, in the port's
    checkpoint writer (which the JAX reader loads)."""
    args = tcli.build_parser().parse_args(argv)
    g, lrn = tcli.geometry_from_args(args), tcli.learning_from_args(args)
    cls = MultiscaleFlowModel if g.multiscale else FlowModel
    model = cls(g, device="cpu").init(torch.Generator().manual_seed(5))
    return tio.save_model(str(tmp / "init"), g, lrn, model)


def run_both(tmp, monkeypatch, argv, runs=((),), parallax=(1.0, 5.0)):
    """Each CLI over its own copy of the sequence (disparities in
    ``parallax`` px), once per entry of ``runs`` (extra flags), the port's
    first. Where the port cached a liu GT, the JAX CLI reads it (the
    layout both share): the JAX package's eager solver takes minutes at
    the CLI's 180x320 on a CPU, and the two solvers are held to each other
    in tests/test_torch_datasets.py and test_torch_celiu.py. Returns (JAX
    model dir, port model dir, JAX datasets, port datasets, each run's
    (JAX, port) meta.json)."""
    argv = COMMON + argv
    init = init_checkpoint(tmp, argv)
    jseq, tseq = (write_sequence(str(tmp / k), parallax)
                  for k in ("jseq", "tseq"))
    jsets, tsets = [], []
    for name in ("sample_patches", "sample_foveas"):
        record(monkeypatch, jtrain, name, jsets)
        record(monkeypatch, ttrain, name, tsets)
    metas = []
    for extra in runs:
        assert tcli.main(argv + list(extra) + [
            "-lw", init, "-rd", tseq, "-omd", str(tmp / "port"),
            "--device", "cpu"]) == 0
        liu = os.path.join(tseq, "flow_liu")
        if os.path.isdir(liu) and not os.path.isdir(os.path.join(jseq,
                                                                 "flow_liu")):
            shutil.copytree(liu, os.path.join(jseq, "flow_liu"))
        assert jcli.main(argv + list(extra) + [
            "-lw", init, "-rd", jseq, "-omd", str(tmp / "jax"),
            "--dp", "off"]) == 0
        (name,) = os.listdir(tmp / "jax")
        assert os.listdir(tmp / "port") == [name]
        metas.append(tuple(json.load(open(tmp / k / name / "meta.json"))
                           for k in ("jax", "port")))
    return (str(tmp / "jax" / name), str(tmp / "port" / name), jsets, tsets,
            metas)


def assert_corpora_match(tsets, jsets):
    assert len(tsets) == len(jsets) > 0
    for t, j in zip(tsets, jsets):
        assert type(t).__name__ == type(j).__name__
        for f in dataclasses.fields(j):
            a, b = getattr(t, f.name), getattr(j, f.name)
            if f.name in ("itargets", "targets_yx", "img_idx", "ys", "xs"):
                np.testing.assert_array_equal(a, b, err_msg=f.name)
            elif b is not None:
                np.testing.assert_allclose(a, b, rtol=0, atol=TOL_PATCH,
                                           err_msg=f.name)


def assert_scores_match(ours, ref):
    assert len(ours) == len(ref)
    for t, j in zip(ours, ref):
        assert set(t) == set(j)
        for k in j:
            if k in ("loss", "test_err"):
                np.testing.assert_allclose(t[k], j[k], rtol=TOL_LOSS_REL)
            elif k.startswith("full_"):
                np.testing.assert_allclose(t[k], j[k], rtol=FULL_TOL)
            else:
                assert t[k] == j[k], (k, t[k], j[k])


def assert_checkpoints_match(tdir, jdir):
    """The port's checkpoint read by the JAX reader: the geometry and
    learning, and the weights within TOL_PARAM of the JAX run's."""
    tg, tl, tparams, tmeta = jio.load_model(tdir)
    jg, jl, jparams, jmeta = jio.load_model(jdir)
    assert (tg, tl) == (jg, jl)
    assert ({k: v for k, v in tmeta.items() if k != "score"}
            == {k: v for k, v in jmeta.items() if k != "score"})
    assert_scores_match(tmeta["score"], jmeta["score"])
    for a, b in zip(jax.tree.leaves(tparams), jax.tree.leaves(jparams)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=TOL_PARAM)


@pytest.mark.parametrize("flags,parallax", [
    (["-gt", "cross-correlation"], (1.0, 5.0)),
    (["-gt", "cc-mean"], (1.0, 5.0)),
    # the liu GT is dense and unsaturated: flows within a 10x10 window;
    # two GT pairs (the port's solver at 180x320 on the CPU)
    (["-gt", "liu", "-ws", "10", "-gtws", "10", "-ni", "3"], (0.2, 0.8)),
    (["-ms", "2", "-ws", "8", "-gtws", "8"], (1.0, 5.0))])
def test_opticalflow_cli_matches_jax(tmp_path, monkeypatch, flags, parallax):
    """Single-scale with each GT generator (liu with the model's kernel
    as its own; the port's liu runs B4's plain twin here), and a 2-scale
    run (patch sets drawn, then the foveas)."""
    jdir, tdir, jsets, tsets, _ = run_both(tmp_path, monkeypatch,
                                           flags + ["-e", "2"],
                                           parallax=parallax)
    assert_corpora_match(tsets, jsets)
    assert_checkpoints_match(tdir, jdir)


def test_opticalflow_cli_resume_matches_jax(tmp_path, monkeypatch):
    """2 epochs, then ``--resume -e 4``: the first two scores kept as they
    were, the lr-decay count fast-forwarded, the weights as the JAX
    resume's."""
    jdir, tdir, jsets, tsets, metas = run_both(
        tmp_path, monkeypatch, ["-lrd", "0.05"],
        runs=(["-e", "2"], ["-e", "4", "--resume"]))
    assert_corpora_match(tsets, jsets)
    assert_checkpoints_match(tdir, jdir)
    (jfirst, tfirst), (jlast, tlast) = metas
    assert [s["epoch"] for s in tlast["score"]] == [0, 1, 2, 3]
    assert tlast["score"][:2] == tfirst["score"]
    assert jlast["score"][:2] == jfirst["score"]
