"""PyTorch port vs the JAX package: the real-drone loop end to end.

Each package's ``FifoDroneAPI`` talks over real ``os.mkfifo`` pipes to a
peer thread that plays the drone's SDK (navdata with a forward velocity
in, control records read back), with its own ``DepthEstimator`` fed by an
``ImageCamera`` and driven by ``AvoidanceController`` for 4 ticks at a
pinned tick time. The port runs on the CPU at a small geometry (96x128
frames and working size, a 6x6 window, seeded weights); the JAX package
runs the same frames, weights and RANSAC draw. (At a 48x64 working size
of these frames the two packages' RANSAC winners part, ROADMAP C9, and
their x-flows with them.)

Held: the control records the peer receives equal; the confidence and
depth maps equal on at least SHARE of the pixels, each tick: the
estimators' masks and x-flows agree on 99.9% of the pixels and within
1e-3 (tests/test_torch_api.py: R rounds apart by ~1e-6, which moves a
pixel across a mask edge, or an x-flow across a .5 rounding edge, and a
window's mode with it); the native library built under the port's
``_build/`` and nothing new under the JAX package's ``robotics/native/``.
The pixels that differ are printed.
"""

import os
import threading

import jax.numpy as jnp
import numpy as np

from depth_estimation_tpu import api as japi
from depth_estimation_tpu.data import images as jimages
from depth_estimation_tpu.robotics import control as jcontrol
from depth_estimation_tpu.robotics import drone_api as jdrone
from depth_estimation_tpu.robotics import runtime as jruntime
from depth_estimation_tpu_torch import api as tapi
from depth_estimation_tpu_torch.data import images as timages
from depth_estimation_tpu_torch.robotics import control as tcontrol
from depth_estimation_tpu_torch.robotics import drone_api as tdrone
from depth_estimation_tpu_torch.robotics import runtime as truntime
from torch_parity import (calibrations, geometries,  # noqa: F401
                          one_torch_thread, parallax_frames, ransac_noise,
                          to_jax, trunk_params)

H, W, NPTS = 96, 128, 200
TICKS = 4
SHARE = 0.999


class Clock:
    """A pinned tick time: 0.1 s between two reads."""
    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 0.1
        return self.t


def peer(ctrl, nav, navdata, received, ready):
    """The SDK's side: the control pipe's read end first (the API opens
    its write end first, blocking), then the navdata write end; one
    navdata record, then the control records until the API closes."""
    with open(ctrl, "rb") as f, open(nav, "wb") as nav_w:
        nav_w.write(navdata)
        nav_w.flush()
        ready.set()
        while True:
            rec = f.read(33)
            if len(rec) < 33:
                return
            received.append(rec)


def fly(tmp_path, monkeypatch, tag, rt, drone, ctl_mod, camera_cls,
        estimator, frames, **kw):
    ctrl, nav = str(tmp_path / f"{tag}.control"), str(tmp_path / f"{tag}.nav")
    os.mkfifo(ctrl)
    os.mkfifo(nav)
    received, ready = [], threading.Event()
    t = threading.Thread(target=peer, args=(
        ctrl, nav, rt.encode_navdata(1, 90.0, [0, 0, 0], 100.0,
                                     [2.0, 0.0, 0.0]), received, ready),
        daemon=True)
    t.start()
    camera = camera_cls(H, W)
    for f in frames[1:]:
        camera.push(f)
    estimator.reset(frames[0])
    monkeypatch.setattr(drone, "time", Clock())
    api = drone.FifoDroneAPI(ctrl, nav, estimator, camera, **kw)
    assert ready.wait(10)
    api.takeoff()
    ctl = ctl_mod.AvoidanceController(api, rt.DepthMap(64, 128, 100.0, 0.9,
                                                       320.0), fov=32)
    ticks = []
    for _ in range(TICKS):
        safe = ctl.step()
        ticks.append((safe, api.get_depth_map().copy(),
                      api.get_confidence_map().copy(), api.position().copy()))
    api.close()
    t.join(10)
    assert not t.is_alive()
    return received, ticks, ctl.map.values()


def test_fifo_drone_loop_matches_jax(tmp_path, monkeypatch, capsys):
    jnative = os.path.join(os.path.dirname(jruntime.__file__), "native")
    jruntime.load_library()
    before = sorted(os.listdir(jnative))

    jg, tg = geometries(H, W)
    jc, tc = calibrations(H, W, f=100.0, max_points=NPTS)
    params = trunk_params(0)
    frames = parallax_frames(np.random.RandomState(4), H, W, n=TICKS + 1)

    ours = fly(tmp_path, monkeypatch, "port", truntime, tdrone, tcontrol,
               timages.ImageCamera,
               tapi.DepthEstimator(tg, params, tc, device="cpu",
                                   ransac_noise=ransac_noise(64, NPTS)),
               frames, device="cpu")
    assert truntime.library_path().exists()
    assert sorted(os.listdir(jnative)) == before
    ref = fly(tmp_path, monkeypatch, "jax", jruntime, jdrone, jcontrol,
              jimages.ImageCamera, japi.DepthEstimator(jg, to_jax(params), jc),
              [jnp.asarray(f) for f in frames])

    (rec, ticks, values), (jrec, jticks, jvalues) = ours, ref
    assert rec == jrec and len(rec) == TICKS + 1
    assert [truntime.decode_control(r)[0] for r in rec] == ["T"] + ["C"] * TICKS
    differ = []
    for (safe, depth, conf, pos), (jsafe, jdepth, jconf, jpos) in zip(ticks,
                                                                      jticks):
        assert safe == jsafe
        assert depth.shape == conf.shape == (H, W)
        assert conf.mean() > 0.3            # the maps are not blank
        assert (depth[conf > 0] > 0).all() and (depth < 100).any()
        differ.append((int((conf != jconf).sum()),
                       int((depth != jdepth).sum())))
        assert (conf == jconf).mean() >= SHARE, differ
        assert (depth == jdepth).mean() >= SHARE, differ
        np.testing.assert_array_equal(pos, jpos)
    with capsys.disabled():
        print(f"\n[robotics loop] (confidence, depth) pixels that differ a "
              f"tick, of {H * W}: {differ}")
    if not any(c or d for c, d in differ):
        np.testing.assert_array_equal(values, jvalues)
