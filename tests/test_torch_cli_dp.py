"""The port's --dp surface (tests/test_cli_dp.py's cases): ``auto_mesh``,
the dataset build with a mesh, and the ``opticalflow``, ``tools rectify``
and ``train_radial`` CLIs with ``--dp`` on an 8-shard CPU mesh, each held
against the port's unsharded run and against the JAX package's sharded
run on its 8 virtual CPU devices.

Scenes whose RANSAC winners the two packages share (ROADMAP C9):
test_torch_cli_opticalflow.py's parallax sequence at 96x128 and
test_torch_cli_train.py's forward step at 128x160, with the reference's
RANSAC draws. Tolerances are those files': warped frames within 1e-3,
masks and GT equal on >= 0.99 of the pixels (the shards' batched LAPACK
calls round R apart by ~1e-6 from the full batch's); each step's loss
within relative 1e-5 and the saved weights within 1e-5; the epipoles of
the polar pairs within 2e-2 px (C26); written images as
tests/test_cli_dp.py holds them.
"""

import contextlib
import dataclasses
import io
import json
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from depth_estimation_tpu.cli import opticalflow as jcli
from depth_estimation_tpu.cli import tools as jtools
from depth_estimation_tpu.cli import train_radial as jradial_cli
from depth_estimation_tpu.data import datasets as jds
from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.models import radial as jradial
from depth_estimation_tpu.parallel import mesh as jmesh
from depth_estimation_tpu_torch.cli import opticalflow as tcli
from depth_estimation_tpu_torch.cli import tools as ttools
from depth_estimation_tpu_torch.cli import train_radial as tradial_cli
from depth_estimation_tpu_torch.data import datasets as tds
from depth_estimation_tpu_torch.geometry import Geometry
from depth_estimation_tpu_torch.parallel import mesh as pm
from depth_estimation_tpu_torch.training import families
from test_torch_cli_opticalflow import (COMMON, assert_checkpoints_match,
                                        init_checkpoint, write_sequence)
from test_torch_cli_train import forward_frames, preset, write_frames
from torch_parity import (assert_trees_close, one_torch_thread,  # noqa: F401
                          ransac_noise, read_weights, record, start_from)

TOL_EPIPOLE = 2e-2
SHARE = 0.99


def set_presets(mp):
    """test_torch_cli_opticalflow.py's 't96x128' and test_cli.py's
    'test128x160' in both packages, and the reference's RANSAC draws in
    the port."""
    from depth_estimation_tpu.geometry3d import calibration as jcal
    from depth_estimation_tpu_torch.geometry3d import calibration as tcal
    from depth_estimation_tpu_torch.geometry3d import egomotion as tego
    for mod in (jcal, tcal):
        mp.setitem(mod.PRESETS, "t96x128", preset(mod, "t96x128", 96, 128,
                                                  100.0, 200))
        mp.setitem(mod.PRESETS, "t96x128", dataclasses.replace(
            mod.PRESETS["t96x128"], sfm=dataclasses.replace(
                mod.RECTIFIED_GOPRO_SMALL.sfm, max_points=200)))
        mp.setitem(mod.PRESETS, "test128x160",
                   preset(mod, "test128x160", 128, 160, 200.0, 400))
    mp.setattr(tego, "gumbel_noise",
               lambda s, n, dev, generator=None: torch.as_tensor(
                   ransac_noise(s, n), device=dev))


@pytest.fixture
def presets(monkeypatch):
    set_presets(monkeypatch)


def test_auto_mesh_resolution(monkeypatch):
    """--dp's rules, as the JAX auto_mesh's: off/0/1/none stay on one
    device; 'auto' takes every card when there are two or more; N the
    first N (SystemExit past the visible count); with a CPU device, N CPU
    shards."""
    for dp in ("off", "0", "1", "none"):
        assert pm.auto_mesh(dp, "cpu") is None
        assert jmesh.auto_mesh(dp) is None
    assert pm.auto_mesh("auto", "cpu") is None          # one CPU device
    m4 = pm.auto_mesh("4", "cpu")
    assert m4.devices == (torch.device("cpu"),) * 4 and m4.platform == "cpu"
    # eight cards, as the JAX package sees eight devices
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 8)
    m = pm.auto_mesh("auto")
    assert m.size == len(jmesh.auto_mesh("auto").devices.flat) == 8
    assert m.devices == tuple(torch.device("cuda", i) for i in range(8))
    assert pm.auto_mesh("4").devices == m.devices[:4]
    assert jmesh.auto_mesh("4").devices.size == 4
    with pytest.raises(SystemExit) as ours:
        pm.auto_mesh("999")
    with pytest.raises(SystemExit) as ref:
        jmesh.auto_mesh("999")
    assert str(ours.value) == str(ref.value)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    assert pm.auto_mesh("auto") is None


def test_sharded_dataset_build_matches_unsharded(tmp_path, presets):
    """load_data_optical_flow with a mesh: the rectification and the GT
    split over 8 shards (3 pairs padded to 8), against the unsharded build
    and the JAX build on its 8-device mesh; the sharded build is
    deterministic."""
    from depth_estimation_tpu_torch.geometry3d import calibration as tcal
    from depth_estimation_tpu.geometry3d import calibration as jcal

    root = write_sequence(str(tmp_path / "seq"), (1.0, 5.0))
    kw = dict(hImg=48, wImg=64, layers=((3, 5, 5, 8),), maxh=6, maxw=6,
              maxhGT=6, maxwGT=6, hKernelGT=5, wKernelGT=5)
    mesh = pm.make_mesh(["cpu"] * 8)
    noise = ransac_noise(64, 200)

    def port(m):
        return tds.load_data_optical_flow(
            Geometry(**kw), tcal.PRESETS["t96x128"], root, 4, noise=noise,
            device="cpu", mesh=m)

    base, sharded, again = port(None), port(mesh), port(mesh)
    ref = jds.load_data_optical_flow(JGeometry(**kw), jcal.PRESETS["t96x128"],
                                     root, 4, cache_root=None,
                                     mesh=jmesh.make_mesh())
    assert len(sharded["flow"]) == len(base["flow"]) == len(ref["flow"]) == 3
    for other in (base, ref):
        for k in ("images", "warped_images"):
            for a, b in zip(sharded[k], other[k]):
                np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                           atol=1e-5 if k == "images"
                                           else 1e-3)
        for a, b in zip(sharded["masks"], other["masks"]):
            assert (a == np.asarray(b)).mean() >= SHARE
        for a, b in zip(sharded["flow"], other["flow"]):
            assert (a is None) == (b is None)
            if a is not None:
                assert (a == np.asarray(b)).mean() >= SHARE
    for k in ("warped_images", "masks"):
        for a, b in zip(sharded[k], again[k]):
            np.testing.assert_array_equal(a, b)


@pytest.fixture(scope="module")
def opticalflow_runs(tmp_path_factory):
    """One epoch of the flow trainer CLI from one ``-lw`` checkpoint: the
    port's with --dp 8 and with --dp off, and the JAX CLI's with --dp
    auto, each over its own copy of the sequence. Returns {run: model
    dir} and the port's --dp 8 output."""
    tmp = tmp_path_factory.mktemp("of")
    argv = COMMON + ["-e", "1", "-gt", "cross-correlation"]
    runs, log = {}, io.StringIO()
    with pytest.MonkeyPatch.context() as mp, contextlib.redirect_stdout(log):
        set_presets(mp)
        init = init_checkpoint(tmp, argv)
        for name, main, extra in (
                ("port_dp", tcli.main, ["--dp", "8", "--device", "cpu"]),
                ("port_off", tcli.main, ["--dp", "off", "--device", "cpu"]),
                ("jax_dp", jcli.main, ["--dp", "auto"])):
            seq = write_sequence(str(tmp / f"seq_{name}"), (1.0, 5.0))
            out = str(tmp / name)
            assert main(argv + extra + ["-lw", init, "-rd", seq,
                                        "-omd", out]) == 0
            (d,) = os.listdir(out)
            runs[name] = os.path.join(out, d)
    return runs, log.getvalue()


def test_opticalflow_cli_dp_end_to_end(opticalflow_runs):
    """opticalflow --dp 8: the dataset build and the training sharded, a
    checkpoint written whose weights and score equal the JAX CLI's --dp
    run (the JAX reader loads it)."""
    runs, out = opticalflow_runs
    assert "dp mesh: 8 devices (cpu)" in out
    meta = json.load(open(os.path.join(runs["port_dp"], "meta.json")))
    assert len(meta["score"]) == 1
    assert_checkpoints_match(runs["port_dp"], runs["jax_dp"])


def test_opticalflow_cli_dp_matches_single_device(opticalflow_runs):
    """One --dp epoch equals one single-device epoch on the same data, to
    the gradient reduction's rounding: --dp changes where the work runs,
    not the trained model."""
    runs, _ = opticalflow_runs
    assert_checkpoints_match(runs["port_dp"], runs["port_off"])


def test_rectify_cli_dp(tmp_path, presets, capsys):
    """tools rectify --dp 8: the sharded batch path writes what the
    per-pair path writes, and what the JAX CLI's --dp auto writes."""
    roots = {k: write_sequence(str(tmp_path / k), (1.0, 5.0))
             for k in ("dp", "off", "jax")}
    for name, main, extra in (
            ("dp", ttools.main, ["--dp", "8", "--device", "cpu"]),
            ("off", ttools.main, ["--dp", "off", "--device", "cpu"]),
            ("jax", jtools.main, ["--dp", "auto"])):
        assert main(["rectify", roots[name], "--calibration", "t96x128"]
                    + extra) == 0
    out = capsys.readouterr().out
    assert "dp mesh: 8 devices (cpu)" in out and "rectified 3 pairs" in out

    def read(root, sub):
        d = os.path.join(root, sub)
        names = sorted(os.listdir(d))
        assert len(names) == 3
        return [np.asarray(Image.open(os.path.join(d, f))).astype(int)
                for f in names]

    for other in ("off", "jax"):
        for a, b in zip(read(roots["dp"], "undistorted_images"),
                        read(roots[other], "undistorted_images")):
            assert np.abs(a - b).max() <= 1
        loose = 0
        for a, b in zip(read(roots["dp"], "rectified_images"),
                        read(roots[other], "rectified_images")):
            d = np.abs(a - b)
            loose += int(d.max()) > 1
            assert float((d > 2).mean()) < 0.05
        assert loose <= 1, loose


def test_radial_cli_dp_end_to_end(tmp_path, monkeypatch, presets, capsys):
    """train_radial --dp 8: the polar build sharded (its pairs within
    2e-2 px of the JAX CLI's sharded build, C26), then the training
    sharded on the JAX CLI's pairs, as test_torch_cli_train.py does: every
    step's loss and the saved weights equal the JAX CLI's --dp auto run."""
    layers = [[3, 5, 5, 8]]
    init = jradial.RadialFlowNetwork(((3, 5, 5, 8),), 5).init(
        jax.random.PRNGKey(0))
    start_from(monkeypatch, families.RadialTrainer, init)
    roots = {k: str(tmp_path / k) for k in ("jax", "port")}
    for root in roots.values():
        write_frames(root, forward_frames())
    jcalls, meshes = [], []
    jloader, loader = jds.load_polar_pairs_batched, tds.load_polar_pairs_batched

    def jax_loader(*a, **k):
        jcalls.append((a, k, jloader(*a, **k)))
        return jcalls[-1][2]
    monkeypatch.setattr(jds, "load_polar_pairs_batched", jax_loader)

    def the_jax_pairs(*a, **k):
        """The port's sharded loader, called as the port's CLI calls it:
        equal to its unsharded run, and against the JAX CLI's sharded
        pairs within C26's 2e-2 px, widened by how far the JAX package's
        own sharded build moved each pair from its unsharded build (its
        shard_map program rounds apart from its jit, and an epipole far
        outside the frame amplifies that). Then the JAX CLI's pairs, so
        that both train on the same pixels."""
        ((ja, jk, ref),) = jcalls
        unsharded = jloader(*ja, **dict(jk, mesh=None))
        meshes.append(k["mesh"])
        ours = loader(*a, **k)
        alone = loader(*a, **dict(k, mesh=None))
        assert [p.good for p in ours] == [bool(p.good) for p in ref]
        for t, u, j, ju in zip(ours, alone, ref, unsharded):
            for f in ("e2", "polar_image", "polar_prev_image"):
                np.testing.assert_array_equal(getattr(t, f), getattr(u, f))
                got, want = getattr(t, f), np.asarray(getattr(j, f))
                drift = np.abs(want - np.asarray(getattr(ju, f))).max()
                np.testing.assert_allclose(got, want, rtol=0,
                                           atol=TOL_EPIPOLE + drift)
        return [tds.PolarPair(**{
            f.name: (bool(getattr(j, f.name)) if f.name == "good"
                     else np.asarray(getattr(j, f.name)))
            for f in dataclasses.fields(tds.PolarPair)}) for j in ref]
    monkeypatch.setattr(tds, "load_polar_pairs_batched", the_jax_pairs)
    fetched, steps = [], []
    get = jax.device_get

    def device_get(x):
        fetched.append([float(v) for v in get(x)])
        return get(x)
    monkeypatch.setattr(jax, "device_get", device_get)
    step = families._NLLTrainer.step

    def recorded(self, *a):
        aux = step(self, *a)
        steps.append(float(aux["loss"]))
        return aux
    monkeypatch.setattr(families._NLLTrainer, "step", recorded)
    argv = ["-cal", "test128x160", "-net", repr(layers), "-hwin", "5",
            "-hi", "100", "-wi", "100", "-ni", "3", "-n", "64", "-e", "1",
            "-bs", "16"]
    for name, main, extra in (("jax", jradial_cli.main, ["--dp", "auto"]),
                              ("port", tradial_cli.main,
                               ["--dp", "8", "--device", "cpu"])):
        assert main(argv + ["-rd", roots[name], "-omd",
                            os.path.join(roots[name], "models")]
                    + extra) == 0
    out = capsys.readouterr().out
    assert out.count("dp mesh: 8 devices") == 2 and "(cpu)" in out
    assert meshes[0].size == 8 and len(steps) == len(fetched[0]) > 0
    # the JAX CLI fetches the epoch's losses, then its accuracies
    np.testing.assert_allclose(steps, fetched[0], rtol=1e-5)
    assert_trees_close(
        read_weights(os.path.join(roots["port"], "models", "e0.msgpack"),
                     init),
        read_weights(os.path.join(roots["jax"], "models", "e0.msgpack"),
                     init), 1e-5)
    with pytest.raises(SystemExit, match="not divisible"):
        families.RadialTrainer([(3, 5, 5, 8)], 5, batch_size=12,
                               device="cpu").use_mesh(pm.make_mesh(["cpu"] * 8))
