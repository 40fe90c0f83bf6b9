"""The port's f32 rule (``depth_estimation_tpu_torch/utils/precision.py``):
every public entry point that runs on the card computes with cuDNN's and
cuBLAS's TF32 off, as the JAX package computes in f32, and gives the
caller's settings back. The flags are read inside the trunk's forward
(every ``ConvFilter`` instance, the mesh's replicas included) while each
kind of entry point runs with the caller's flags set to TF32 on: an
estimator step, a family's forward, a Trainer step, a CLI main, and a
two-shard CPU mesh. Nested scopes, and scopes in several threads, restore
only when the outermost closes."""

import dataclasses
import os
import sys
import threading

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch import api_batched as tapi
from depth_estimation_tpu_torch.cli import tools
from depth_estimation_tpu_torch.data import images as timages
from depth_estimation_tpu_torch.geometry import Geometry, Learning
from depth_estimation_tpu_torch.geometry3d import calibration as tcal
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.models.filters import ConvFilter
from depth_estimation_tpu_torch.models.flow import FlowModel
from depth_estimation_tpu_torch.models.multiscale import MultiscaleFlowModel
from depth_estimation_tpu_torch.parallel import mesh as pm
from depth_estimation_tpu_torch.training import train
from depth_estimation_tpu_torch.utils import precision
from depth_estimation_tpu_torch.utils.precision import full_f32, tf32_flags
from torch_parity import pipeline_case, ransac_noise

TF32_ON = (True, True)


@pytest.fixture
def seen(monkeypatch):
    """The flags each trunk forward ran under, with the caller's flags set
    to TF32 on for the test (and put back after it)."""
    out = []
    forward = ConvFilter.forward

    def spy(self, x):
        out.append(tf32_flags())
        y = forward(self, x)
        if y.requires_grad:
            y.register_hook(lambda g: out.append(("backward",) + tf32_flags()))
        return y
    monkeypatch.setattr(ConvFilter, "forward", spy)
    saved = tf32_flags()
    precision._set(*TF32_ON)
    yield out
    precision._set(*saved)


def assert_f32_inside_and_restored(seen, n_min=1):
    assert len(seen) >= n_min
    assert all(s == (False, False) for s in seen), seen
    assert tf32_flags() == TF32_ON
    assert precision._open == 0


def test_estimator_step(seen):
    c = pipeline_case(48, 64, n_points=64)
    est = tapi.BatchedDepthEstimator(c["tg"], c["params"], c["tc"],
                                     ransac_noise=ransac_noise(64, 64),
                                     device="cpu", compensation="warp_banded")
    est.reset(c["frames"][0])
    est.next_frames(c["frames"][1])
    assert_f32_inside_and_restored(seen, 2)


def test_family_forward(seen):
    g = Geometry(hImg=24, wImg=32, layers=((3, 5, 5, 6),), maxh=4, maxw=4,
                 multiscale=True, ratios=(1, 2))
    model = MultiscaleFlowModel(g, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    a, b = (torch.from_numpy(rng.rand(24, 32, 3).astype(np.float32))
            for _ in range(2))
    with torch.no_grad():
        model.decode_full(a, b)
    assert_f32_inside_and_restored(seen, 2)


def test_trainer_step(seen):
    """The step's forward and its backward (a hook on the trunk's output)
    both run in f32."""
    g = Geometry(hImg=24, wImg=32, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    lrn = Learning(rate=1e-2, batch_size=4, criterion="nll")
    tr = train.Trainer(g, lrn, device="cpu").init(
        torch.Generator().manual_seed(0))
    rng = np.random.RandomState(1)
    p1, p2 = (torch.from_numpy(rng.rand(4, g.hPatch2, g.wPatch2, 3)
                               .astype(np.float32)) for _ in range(2))
    it = torch.from_numpy(rng.randint(0, g.maxh * g.maxw, 4).astype(np.int32))
    st = torch.zeros(4, g.maxh * g.maxw)
    out = tr.step(p1, p2, it, st)
    assert bool(out["grad_ok"]) and np.isfinite(float(out["loss"]))
    assert any(s == ("backward", False, False) for s in seen)
    assert_f32_inside_and_restored(
        [s[1:] if s[0] == "backward" else s for s in seen], 3)


def test_cli_main(seen, tmp_path, monkeypatch):
    h, w = 64, 80
    base = tcal.RECTIFIED_GOPRO_SMALL
    monkeypatch.setitem(tcal.PRESETS, "p64x80", dataclasses.replace(
        base, name="p64x80", wImg=w, hImg=h, fx=60.0, fy=60.0, cx=w / 2,
        cy=h / 2, sfm=dataclasses.replace(base.sfm, max_points=64,
                                          points_quality=0.001)))
    rng = np.random.RandomState(0)
    big = timages.scale_np(rng.rand(24, 28, 3).astype(np.float32), h + 30,
                           w + 30)
    os.makedirs(tmp_path / "seq" / "images")
    for i in range(3):
        f = big[10:10 + h, 10 + 2 * i:10 + w + 2 * i]
        (tmp_path / "seq" / "images" / f"{i:09d}.png").write_bytes(
            timages.encode_png((np.clip(f, 0, 1) * 255).astype(np.uint8)))
    g = Geometry(hImg=h, wImg=w, layers=((3, 5, 5, 8),), maxh=6, maxw=6)
    model = FlowModel(g, device="cpu").init(torch.Generator().manual_seed(0))
    mdir = tio.save_model(str(tmp_path / "model"), g, Learning(), model)
    assert tools.main(["stream", mdir, str(tmp_path / "seq"), "--calibration",
                       "p64x80", "--num", "2", "--device", "cpu"]) == 0
    assert_f32_inside_and_restored(seen, 2)


def test_two_shard_cpu_mesh(seen):
    c = pipeline_case(48, 64, n_points=64)
    est = tapi.BatchedDepthEstimator(c["tg"], c["params"], c["tc"],
                                     ransac_noise=ransac_noise(64, 64),
                                     device="cpu", compensation="warp_banded")
    est.shard(pm.make_mesh(["cpu"] * 2))
    est.reset(c["frames"][0])
    est.next_frames(c["frames"][1])
    # two shards' preps on reset, two on the step
    assert_f32_inside_and_restored(seen, 4)
    n = len(seen)
    pm.sharded_flow_fn(FlowModel(c["tg"], device="cpu"),
                       pm.make_mesh(["cpu"] * 2))(
        torch.rand(2, 48, 64, 3), torch.rand(2, 48, 64, 3))
    assert_f32_inside_and_restored(seen, n + 4)


def test_nested_scopes_restore_at_the_outermost_exit():
    saved = tf32_flags()
    try:
        precision._set(True, False)     # torch's defaults
        with full_f32():
            assert tf32_flags() == (False, False)
            with full_f32():
                assert tf32_flags() == (False, False)
            assert tf32_flags() == (False, False)
            # an entry point turns TF32 off again inside a caller's change
            precision._set(True, True)
            with full_f32():
                assert tf32_flags() == (False, False)
            assert tf32_flags() == (False, False)
        assert tf32_flags() == (True, False)
        with pytest.raises(KeyError):
            with full_f32():
                raise KeyError("an error inside the scope")
        assert tf32_flags() == (True, False) and precision._open == 0
    finally:
        precision._set(*saved)


def test_threads_restore_only_when_the_last_scope_closes():
    """A mesh's shards on several cards run in host threads, each inside a
    scope of its own: a shard that leaves its scope must not turn TF32 back
    on while another shard is still issuing. First in a fixed order (A
    enters, B enters, A leaves, B reads), then eight threads entering and
    leaving at random under a short switch interval, each reading the
    flags while it holds its scope; the caller's flags come back once all
    have left."""
    saved = tf32_flags()
    old = sys.getswitchinterval()
    try:
        precision._set(*TF32_ON)
        a_in, b_in, a_out = (threading.Event() for _ in range(3))
        read = []

        def a():
            with full_f32():
                a_in.set()
                b_in.wait(timeout=30)
            a_out.set()

        def b():
            a_in.wait(timeout=30)
            with full_f32():
                b_in.set()
                a_out.wait(timeout=30)
                read.append(tf32_flags())
        threads = [threading.Thread(target=f) for f in (a, b)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert read == [(False, False)] and tf32_flags() == TF32_ON

        errors = []
        start = threading.Barrier(8)

        def shard():
            try:
                start.wait(timeout=30)
                for _ in range(300):
                    with full_f32():
                        if tf32_flags() != (False, False):
                            errors.append(tf32_flags())
            except BaseException as e:      # read in the test's thread
                errors.append(e)
        sys.setswitchinterval(1e-6)
        threads = [threading.Thread(target=shard) for _ in range(8)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
        assert not errors, errors[:3]
        assert tf32_flags() == TF32_ON and precision._open == 0
    finally:
        sys.setswitchinterval(old)
        precision._set(*saved)
