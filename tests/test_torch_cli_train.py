"""PyTorch port vs the JAX package: the radial and version2 trainer CLIs
(``cli/train_radial.py``, ``cli/train_v2.py``) end to end, the same argv
through both ``main``s (the JAX radial CLI with ``--dp off``, the port's
with ``--device cpu``); the legacy depth CLI is in
tests/test_torch_cli_depth.py.

These CLIs take no ``-lw``, so the port trainer's ``init`` is made to load
the JAX CLI's ``PRNGKey(0)`` tree through the weight bridge; RANSAC takes
the reference's draws; each CLI reads its own copy of the frames (each
package caches its GT under the dataset root). Tolerances, the trainers'
(tests/test_torch_family_trainers.py):
  * the radial CLI's polar pairs: the port's loader, called as the CLI
    calls it, against the JAX CLI's: the epipoles within 2e-2 px (1.1e-2
    read; RANSAC's essential matrix rounds apart in the two LAPACK builds,
    ROADMAP C26) and the polar images, resampled around them, within 2e-2
    (1.1e-2 read); both CLIs then train on the
    JAX CLI's pairs, so their patch corpora are equal;
  * version2's corpus: the port's targets equal to the JAX CLI's, its
    patches within 1e-3 (R rounds apart by ~1e-6); both CLIs then train
    on the JAX CLI's corpus;
  * every step's loss within relative 1e-5, accuracies equal;
  * the saved weights within absolute 1e-5 (``TOL_PARAM``), read by the
    JAX reader (flax's ``from_bytes``);
  * ``meta.json`` equal, but for the radial spec's 'tanh', which the port
    writes as the string and the JAX CLI as its letters (ROADMAP C25).
"""

import dataclasses
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from depth_estimation_tpu.cli import train_radial as jradial_cli
from depth_estimation_tpu.cli import train_v2 as jv2_cli
from depth_estimation_tpu.data import datasets as jds
from depth_estimation_tpu.flow.celiu import bilinear_sample, gaussian_smooth
from depth_estimation_tpu.geometry3d import calibration as jcal
from depth_estimation_tpu.models import radial as jradial
from depth_estimation_tpu.models import version2 as jv2
from depth_estimation_tpu_torch.cli import train_radial as tradial_cli
from depth_estimation_tpu_torch.cli import train_v2 as tv2_cli
from depth_estimation_tpu_torch.data import datasets as tds
from depth_estimation_tpu_torch.geometry3d import calibration as tcal
from depth_estimation_tpu_torch.geometry3d import egomotion as tego
from depth_estimation_tpu_torch.training import families
from depth_estimation_tpu_torch.training import train as ttrain
from torch_parity import (assert_trees_close, one_torch_thread,  # noqa: F401
                          parallax_frames, ransac_noise, read_weights,
                          record, start_from)

TOL_LOSS_REL = 1e-5
TOL_PARAM = 1e-5
TOL_EPIPOLE = 2e-2
TOL_V2_PATCH = 1e-3


def preset(mod, name, h, w, f, points):
    base = mod.RECTIFIED_GOPRO_SMALL
    return dataclasses.replace(
        base, name=name, wImg=w, hImg=h, fx=f, fy=f, cx=w / 2, cy=h / 2,
        sfm=dataclasses.replace(base.sfm, max_points=points,
                                points_quality=0.001))


@pytest.fixture(autouse=True)
def presets_and_draws(monkeypatch):
    """tests/test_cli.py's 'test128x160' (the radial scene) and a 96x128
    preset (version2's parallax scene) in both packages; the reference's
    RANSAC draws in the port."""
    for mod in (jcal, tcal):
        monkeypatch.setitem(mod.PRESETS, "test128x160",
                            preset(mod, "test128x160", 128, 160, 200.0, 400))
        monkeypatch.setitem(mod.PRESETS, "t96x128",
                            dataclasses.replace(
                                preset(mod, "t96x128", 96, 128, 100.0, 200),
                                sfm=dataclasses.replace(
                                    mod.RECTIFIED_GOPRO_SMALL.sfm,
                                    max_points=200)))
    monkeypatch.setattr(tego, "gumbel_noise",
                        lambda s, n, dev, generator=None: torch.as_tensor(
                            ransac_noise(s, n), device=dev))


def record_steps(monkeypatch):
    """The per-step losses and accuracies of every epoch: the JAX CLIs
    fetch each epoch's losses, then its accuracies, with one
    ``jax.device_get`` each; the port's trainer returns them. Returns (JAX
    fetches, port epochs as (losses, accs))."""
    fetched, ours = [], []
    get = jax.device_get

    def device_get(x):
        fetched.append([float(v) for v in get(x)])
        return get(x)
    monkeypatch.setattr(jax, "device_get", device_get)
    epoch = families._NLLTrainer.epoch

    def wrapped(self, *a, **k):
        m = epoch(self, *a, **k)
        ours.append((m["losses"], m["accs"]))
        return m
    monkeypatch.setattr(families._NLLTrainer, "epoch", wrapped)
    return fetched, ours


def assert_epochs_match(ours, fetched, n):
    ref = list(zip(fetched[0::2], fetched[1::2]))
    assert len(ours) == len(ref) == n
    for (losses, accs), (jlosses, jaccs) in zip(ours, ref):
        assert len(losses) == len(jlosses) > 0
        np.testing.assert_allclose(losses, jlosses, rtol=TOL_LOSS_REL)
        assert accs == jaccs


# ---------------------------------------------------------------------------
# train_radial
# ---------------------------------------------------------------------------

def forward_frames(noise_seed=None):
    """tests/test_cli.py's radial scene: 3 frames of a forward step over
    two depth planes (zoom 1.05 on top, 1.10 below) at 128x160; with
    ``noise_seed``, the same frames with pixel noise (the noisy recording
    of the clean-targets regime)."""
    rng = np.random.RandomState(0)
    H, W = 128, 160
    base = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(H, W, 3).astype(np.float32)), 0.8, 2))
    frame = np.clip(base * 1.5, 0, 1).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    s = np.where(yy < H / 2, 1.05, 1.10)
    xs = jnp.asarray(W / 2 + (xx - W / 2) / s)
    ys = jnp.asarray(H / 2 + (yy - H / 2) / s)
    frames = []
    for _ in range(3):
        frames.append(frame)
        frame = np.asarray(bilinear_sample(jnp.asarray(frame), xs, ys))
    if noise_seed is not None:
        nrng = np.random.RandomState(noise_seed)
        frames = [np.clip(f + 0.03 * nrng.randn(*f.shape), 0, 1)
                  for f in frames]
    return frames


def write_frames(root, frames):
    d = os.path.join(root, "images")
    os.makedirs(d)
    for i, f in enumerate(frames):
        Image.fromarray((np.clip(f, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:09d}.png"))


@pytest.mark.parametrize("gt_dataset", [False, True])
def test_train_radial_cli_matches_jax(tmp_path, monkeypatch, capsys,
                                      gt_dataset):
    """Two epochs of the radial CLI, straight and with ``-gtd`` (GT and
    geometry from the clean sequence, pixels from the noisy one)."""
    layers = [[3, 5, 5, 8], "tanh", [8, 3, 3, 6]]
    init = jradial.RadialFlowNetwork(((3, 5, 5, 8), "tanh", (8, 3, 3, 6)),
                                     5).init(jax.random.PRNGKey(0))
    start_from(monkeypatch, families.RadialTrainer, init)
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    for root in roots.values():
        write_frames(os.path.join(root, "clean"), forward_frames())
        if gt_dataset:
            write_frames(os.path.join(root, "noisy"), forward_frames(4))
    jsteps, tsteps = record_steps(monkeypatch)
    jloaded, jsampled, tsampled = [], [], []
    record(monkeypatch, jds, "load_polar_pairs_batched", jloaded)
    loader = tds.load_polar_pairs_batched

    def the_jax_pairs(*a, **k):
        """The port's loader, called as the port's CLI calls it, against
        the JAX CLI's (the epipoles part by ~1e-3 px, C26); then the JAX
        CLI's pairs, so that both train on the same pixels."""
        (ref,) = jloaded
        ours = loader(*a, **k)
        assert [p.good for p in ours] == [bool(p.good) for p in ref]
        for t, j in zip(ours, ref):
            np.testing.assert_allclose(t.e2, np.asarray(j.e2), rtol=0,
                                       atol=TOL_EPIPOLE)
            for f in ("polar_image", "polar_prev_image"):
                np.testing.assert_allclose(getattr(t, f),
                                           np.asarray(getattr(j, f)),
                                           rtol=0, atol=TOL_EPIPOLE)
        return [tds.PolarPair(**{
            f.name: (bool(getattr(j, f.name)) if f.name == "good"
                     else np.asarray(getattr(j, f.name)))
            for f in dataclasses.fields(tds.PolarPair)}) for j in ref]
    monkeypatch.setattr(tds, "load_polar_pairs_batched", the_jax_pairs)
    record(monkeypatch, jds, "generate_polar_training_patches", jsampled)
    record(monkeypatch, tds, "generate_polar_training_patches", tsampled)
    argv = ["-cal", "test128x160", "-net", repr(layers), "-hwin", "5",
            "-hi", "100", "-wi", "100", "-ni", "3", "-n", "64", "-e", "2",
            "-bs", "16"]
    argv += (["-ds", "noisy", "-gtd", "clean"] if gt_dataset
             else ["-ds", "clean"])
    out = {}
    for name, main, extra in (("jax", jradial_cli.main, ["--dp", "off"]),
                              ("port", tradial_cli.main,
                               ["--device", "cpu"])):
        assert main(argv + ["-rd", roots[name], "-omd",
                            os.path.join(roots[name], "models")]
                    + extra) == 0
        out[name] = capsys.readouterr().out
    assert "2/2 pairs usable" in out["port"] and "2/2 pairs usable" in out["jax"]
    assert len(tsampled) == len(jsampled) == 2
    for t, j in zip(tsampled, jsampled):
        for a, b in zip(t, j):
            np.testing.assert_array_equal(a, b)
    assert_epochs_match(tsteps, jsteps, 2)
    for e in range(2):
        assert_trees_close(
            read_weights(os.path.join(roots["port"], "models",
                                      f"e{e}.msgpack"), init),
            read_weights(os.path.join(roots["jax"], "models",
                                      f"e{e}.msgpack"), init), TOL_PARAM)
    tmeta, jmeta = (json.load(open(os.path.join(roots[k], "models",
                                                "meta.json")))
                    for k in ("port", "jax"))
    assert jmeta["layers"][1] == ["t", "a", "n", "h"]      # C25
    assert tmeta == dict(jmeta, layers=layers)


def test_train_radial_cli_refuses_what_the_jax_cli_refuses(tmp_path, capsys):
    """One frame: no usable pairs; a -gtd sibling with fewer frames: not
    index-aligned. Both return 1 before building anything."""
    write_frames(str(tmp_path / "one"), forward_frames()[:1])
    write_frames(str(tmp_path / "three"), forward_frames())
    write_frames(str(tmp_path / "two"), forward_frames()[:2])
    base = ["-rd", str(tmp_path), "-cal", "test128x160", "-ni", "3",
            "-omd", str(tmp_path / "m")]
    for argv, msg in ((["-ds", "one"], "no usable pairs"),
                      (["-ds", "three", "-gtd", "two"], "not index-aligned")):
        assert jradial_cli.main(base + argv + ["--dp", "off"]) == 1
        jerr = capsys.readouterr().err
        assert tradial_cli.main(base + argv + ["--device", "cpu"]) == 1
        assert msg in capsys.readouterr().err and msg in jerr
    assert not os.path.exists(tmp_path / "m")


# ---------------------------------------------------------------------------
# train_v2
# ---------------------------------------------------------------------------

V2_ARGV = ["-cal", "t96x128", "-ni", "3", "-win", "6", "-ker", "5", "-nf",
           "8", "-nk", "5", "-n", "40", "-e", "2", "-bs", "8"]


def test_train_v2_cli_matches_jax(tmp_path, monkeypatch, capsys):
    datap = jv2.V2Params(wImg=128, hImg=96, normalization_k=5,
                         layers=((3, 5, 5, 8),), hWin=6, wWin=6)
    init = jv2.V2Network(datap).init(jax.random.PRNGKey(0))
    start_from(monkeypatch, families.V2Trainer, init)
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    for root in roots.values():
        write_frames(root, parallax_frames(np.random.RandomState(3), 96, 128,
                                           n=4))
    jsteps, tsteps = record_steps(monkeypatch)
    jsets, tsets = [], []
    record(monkeypatch, jds.FlowDataset, "get_patches", jsets)
    get_patches = tds.FlowDataset.get_patches

    def the_jax_patches(self, *a, **k):
        """The port's corpus (kept for the checks below), then the JAX
        CLI's, so that both train on the same pixels."""
        tsets.append(get_patches(self, *a, **k))
        (j,) = jsets
        return ttrain.PatchDataset(*(np.asarray(getattr(j, f.name)) for f in
                                     dataclasses.fields(ttrain.PatchDataset)))
    monkeypatch.setattr(tds.FlowDataset, "get_patches", the_jax_patches)
    out = {}
    for name, main, extra in (("jax", jv2_cli.main, []),
                              ("port", tv2_cli.main, ["--device", "cpu"])):
        assert main(V2_ARGV + ["-rd", roots[name], "-omd",
                               os.path.join(roots[name], "models")]
                    + extra) == 0
        out[name] = capsys.readouterr().out
    (t,), (j,) = tsets, jsets
    assert len(j) == 40
    np.testing.assert_array_equal(t.itargets, j.itargets)
    np.testing.assert_array_equal(t.targets_yx, j.targets_yx)
    for a, b in ((t.patches1, j.patches1), (t.patches2, j.patches2)):
        np.testing.assert_allclose(a, b, rtol=0, atol=TOL_V2_PATCH)
    assert_epochs_match(tsteps, jsteps, 2)
    for e in range(2):
        assert_trees_close(
            read_weights(os.path.join(roots["port"], "models", f"e{e}"), init),
            read_weights(os.path.join(roots["jax"], "models", f"e{e}"), init),
            TOL_PARAM)
    assert (json.load(open(os.path.join(roots["port"], "models", "meta.json")))
            == json.load(open(os.path.join(roots["jax"], "models",
                                           "meta.json"))))
