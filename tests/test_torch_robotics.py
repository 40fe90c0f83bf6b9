"""PyTorch port vs the JAX package: the drone runtime (``robotics/``).

The port builds its own copy of the native sources into
``depth_estimation_tpu_torch/_build/``; the JAX package builds its copy in
place. Both are the same C++ under the same flags, so everything the
native code computes is held bit-equal: the simulator's trajectories and
depth renders, the avoidance controller's runs (seed 11 with a pillar;
seed 7 on the default course), ``DepthMap`` and ``RadialDepthMap`` after
the same frames and displacements, and the FIFO records (byte-equal, and
over real ``os.mkfifo`` pipes). Teleop driven by scripted keys gives the
same controls and states. ``compute_depth_map_from_flow`` (a Python
double loop over pixels in the JAX package, tensors here) is held
bit-equal on random x-flows and masks with explicit bin ties, at both
window sizes and on the border pixels, and its ``mode_filter`` equal to
the JAX function's loop.
"""

import os
import threading

import numpy as np
import pytest
import torch

from depth_estimation_tpu.robotics import control as jcontrol
from depth_estimation_tpu.robotics import drone_api as jdrone
from depth_estimation_tpu.robotics import runtime as jruntime
from depth_estimation_tpu.robotics import teleop as jteleop
from depth_estimation_tpu_torch.robotics import control as tcontrol
from depth_estimation_tpu_torch.robotics import drone_api as tdrone
from depth_estimation_tpu_torch.robotics import runtime as truntime
from depth_estimation_tpu_torch.robotics import teleop as tteleop


def test_native_library_builds_under_the_port():
    path = truntime.library_path()
    assert truntime.load_library() is truntime.load_library()
    assert path.exists()
    build = os.path.join(os.path.dirname(truntime.__file__), "..", "_build")
    assert os.path.samefile(path.parent.parent, build)
    assert path.parent.name.startswith("robotics-")


def run_controller(mod_rt, mod_ctl, seed, default_course, n_steps, dt):
    sim = mod_rt.SimulatedAPI(320, 240, fixed_dt=dt, seed=seed,
                              default_course=default_course)
    if not default_course:
        sim.add_obstacle(8.0, 0.0, 0.0, 1.5)    # a pillar dead ahead
    sim.takeoff()
    dm = mod_rt.DepthMap(64, 128, 100.0, 0.9, 320.0)
    ctl = mod_ctl.AvoidanceController(sim, dm, fov=32)
    safes = []
    traj = np.zeros((n_steps, 3), np.float32)
    for i in range(n_steps):
        safes.append(ctl.step())
        traj[i] = sim.position()
    return dict(traj=traj, safes=safes, depth=sim.get_depth_map(),
                conf=sim.get_confidence_map(), values=dm.values(),
                map2d=dm.to_2d_map(100), yaw=sim.yaw, alt=sim.altitude,
                imu=sim.get_imu_translation(), gyro=sim.get_gyro())


@pytest.mark.parametrize("seed,default_course,n_steps,dt", [
    (11, False, 150, 0.05), (7, True, 60, 0.1)])
def test_avoidance_runs_bit_equal(seed, default_course, n_steps, dt):
    ours = run_controller(truntime, tcontrol, seed, default_course, n_steps,
                          dt)
    ref = run_controller(jruntime, jcontrol, seed, default_course, n_steps,
                         dt)
    assert ours["safes"] == ref["safes"]
    for k in ours:
        if k != "safes":
            np.testing.assert_array_equal(ours[k], ref[k], err_msg=k)
    if not default_course:
        # the pillar run advances and never reaches the pillar
        traj = ours["traj"]
        assert traj[-1, 0] > 4.0
        assert np.hypot(traj[:, 0] - 8.0, traj[:, 1]).min() > 1.5


def test_simulator_renders_and_noise_bit_equal():
    out = []
    for rt in (truntime, jruntime):
        sim = rt.SimulatedAPI(64, 48, fixed_dt=0.05, seed=3,
                              default_course=False)
        sim.add_obstacle(10.0, 0.5, 0.0, 1.0)
        sim.takeoff()
        sim.set_control(0.5, 0.1, -0.2, 0.3)
        got = []
        for _ in range(25):
            sim.next()
            got += [sim.get_depth_map(), sim.get_confidence_map(),
                    sim.get_imu_translation(), sim.get_vo_translation(),
                    sim.get_filtered_translation(), sim.get_gyro(),
                    sim.position(), np.float32(sim.delta_t)]
        sim.clear_obstacles()
        got.append(sim.get_depth_map())
        sim.land()
        sim.next()
        got.append(sim.position())
        out.append(got)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


def test_depth_maps_bit_equal():
    rng = np.random.RandomState(0)
    frames = [(rng.uniform(2, 100, (48, 64)).astype(np.float32),
               (rng.rand(48, 64) > 0.3).astype(np.float32))
              for _ in range(6)]
    moves = [(rng.randn(3).astype(np.float32), rng.randn(3).astype(np.float32))
             for _ in range(6)]
    out = []
    for rt in (truntime, jruntime):
        dm = rt.DepthMap(64, 128, 100.0, 0.9, 320.0)
        rm = rt.RadialDepthMap(128, 100.0, 0.9, 320.0)
        got = []
        for (depth, conf), (pos, sight) in zip(frames, moves):
            dm.new_frame(depth, conf)
            dm.new_pixel(30.0, 20.0, 12.0, 1.0, 64.0, 48.0)
            dm.new_displacement(pos, sight)
            rm.new_frame(depth)
            rm.new_pixel(30.0, 20.0, 12.0, 0.5, 64.0, 48.0)
            rm.new_displacement(pos, sight)
            got += [dm.values(), np.float32(dm.get_safe_theta(32)),
                    np.float32(dm.theta_sight), rm.depths(), rm.variances()]
        got += [dm.to_2d_map(80), rm.to_2d_map(80)]
        out.append(got)
    for a, b in zip(*out):
        np.testing.assert_array_equal(a, b)


CONTROLS = [(0.5, -0.25, 1.5, -2.0), (0.0, 0.0, 0.0, 0.0),
            (-0.999, 0.004, 0.3, -0.3), (1.0, 1.0, -1.0, 1.0)]
NAVDATA = [(2, 87.0, [1, 2, 3], 150.0, [0.5, -0.25, 0.125]),
           (0, 0.0, [0, 0, 0], 0.0, [0.0, 0.0, 0.0]),
           (4, 12.5, [-7, 8, -9], 1234.0, [-3.75, 2.5, 1e-3])]


def test_fifo_records_byte_equal():
    for c in CONTROLS:
        rec = truntime.encode_control(*c)
        assert rec == jruntime.encode_control(*c)
        assert len(rec) == truntime.CONTROL_RECORD_LEN
        assert truntime.decode_control(rec) == jruntime.decode_control(rec)
    for enc in ("encode_takeoff", "encode_land"):
        rec = getattr(truntime, enc)()
        assert rec == getattr(jruntime, enc)()
        assert truntime.decode_control(rec) == jruntime.decode_control(rec)
    for n in NAVDATA:
        rec = truntime.encode_navdata(*n)
        assert rec == jruntime.encode_navdata(*n)
        assert len(rec) == truntime.NAVDATA_RECORD_LEN
        ours, ref = truntime.decode_navdata(rec), jruntime.decode_navdata(rec)
        assert set(ours) == set(ref)
        for k in ref:
            np.testing.assert_array_equal(ours[k], ref[k])
    assert truntime.decode_navdata(b" " * 98) is None
    assert jruntime.decode_navdata(b" " * 98) is None
    with pytest.raises(ValueError):
        truntime.decode_control(b"C")


def peer(ctrl, nav, navdata, received, ready):
    """The SDK's side: open the control pipe's read end first (the API
    opens its write end first, blocking), then the navdata write end;
    write the navdata, then read control records until the API closes."""
    with open(ctrl, "rb") as f, open(nav, "wb") as nav_w:
        for n in navdata:
            nav_w.write(n)
        nav_w.flush()
        ready.set()
        while True:
            rec = f.read(33)
            if len(rec) < 33:
                return
            received.append(rec)


class Clock:
    """A pinned tick time: 0.1 s between two reads."""
    def __init__(self):
        self.t = 0.0

    def monotonic(self):
        self.t += 0.1
        return self.t


def test_fifo_drone_api_over_real_pipes_matches_jax(tmp_path, monkeypatch):
    """Each package's FifoDroneAPI (no estimator) against its own peer
    thread: the control records the peer receives byte-equal, the
    navdata read back equal (the last of several records wins), the
    dead-reckoned position at a pinned tick time equal."""
    results = []
    for mod, rt, kw in ((tdrone, truntime, dict(device="cpu")),
                        (jdrone, jruntime, {})):
        ctrl, nav = (str(tmp_path / f"{mod.__name__}.{k}") for k in "cn")
        os.mkfifo(ctrl)
        os.mkfifo(nav)
        received, ready = [], threading.Event()
        t = threading.Thread(target=peer, args=(
            ctrl, nav, [rt.encode_navdata(*n) for n in NAVDATA],
            received, ready), daemon=True)
        t.start()
        monkeypatch.setattr(mod, "time", Clock())
        api = mod.FifoDroneAPI(ctrl, nav, **kw)
        assert ready.wait(10)
        api.takeoff()
        api.set_control(0.25, 0.0, -0.5, 0.1)
        api.next()
        api.next()
        nd = dict(api.navdata)
        api.land()
        api.close()
        t.join(10)
        assert not t.is_alive()
        results.append((received, nd, api.position(), api.altitude))
    (ours, ond, opos, oalt), (ref, rnd, rpos, ralt) = results
    assert ours == ref and len(ours) == 3
    assert [truntime.decode_control(r)[0] for r in ours] == ["T", "C", "L"]
    for k in rnd:
        np.testing.assert_array_equal(ond[k], rnd[k])
    # the record carries the battery and altitude as integers
    assert ond["battery"] == 12.0 and oalt == ralt == 1234.0
    np.testing.assert_array_equal(opos, rpos)
    assert opos[0] < 0


KEYS = [" ", "w", "w", "a", "UP", "RIGHT", "h", "s", "d", "DOWN", "LEFT",
        "x", " ", "q", "w"]


def test_teleop_scripted_keys_match_jax():
    out = []
    for rt, tel in ((truntime, tteleop), (jruntime, jteleop)):
        api = rt.SimulatedAPI(fixed_dt=0.05, default_course=False)
        t = tel.Teleop(api)
        lines = []
        steps = t.run(iter(KEYS), render=lines.append)
        out.append((steps, lines, t.flying, api.position(),
                    (t.pitch, t.roll, t.gaz, t.dyaw)))
    (s, lines, fly, pos, ctl), (js, jlines, jfly, jpos, jctl) = out
    assert (s, lines, fly, ctl) == (js, jlines, jfly, jctl)
    assert s == KEYS.index("q")
    np.testing.assert_array_equal(pos, jpos)
    assert list(tteleop.decode_keys(iter("\x1b[Aw\x1b[D\x1b[Zq"))) == \
        list(jteleop.decode_keys(iter("\x1b[Aw\x1b[D\x1b[Zq"))) == \
        ["UP", "w", "LEFT", "q"]


def test_teleop_main_over_fifo_pipes_matches_jax(tmp_path, monkeypatch,
                                                 capsys):
    """``teleop.main(["--fifo", ...])`` with scripted keys in place of the
    tty, at a pinned tick time: the peer receives the same control
    records, and the same status lines are printed."""
    results = []
    for rt, tel, drone in ((truntime, tteleop, tdrone),
                           (jruntime, jteleop, jdrone)):
        ctrl, nav = (str(tmp_path / f"{tel.__name__}.{k}") for k in "cn")
        os.mkfifo(ctrl)
        os.mkfifo(nav)
        received, ready = [], threading.Event()
        t = threading.Thread(target=peer, args=(
            ctrl, nav, [rt.encode_navdata(*NAVDATA[0])], received, ready),
            daemon=True)
        t.start()

        def keys(ready=ready):
            assert ready.wait(10)     # the navdata is in the pipe
            yield from KEYS
        made = []

        class Link(drone.FifoDroneAPI):
            def __init__(self, *a, **k):
                super().__init__(*a, **k)
                made.append(self)
        monkeypatch.setattr(tel, "stdin_keys", keys)
        monkeypatch.setattr(drone, "FifoDroneAPI", Link)
        monkeypatch.setattr(drone, "time", Clock())
        assert tel.main(["--fifo", ctrl, nav, "--steps", "6"]) == 0
        made[0].close()   # the JAX CLI leaves its link open
        t.join(10)
        assert not t.is_alive()
        results.append((received, capsys.readouterr().out))
    (ours, oout), (ref, rout) = results
    assert ours == ref and len(ours) == 7
    assert oout.splitlines()[-7:] == rout.splitlines()[-7:]
    assert oout.splitlines()[-1] == "teleop: 6 steps"


# ---------------------------------------------------------------------------
# the depth rule
# ---------------------------------------------------------------------------

def mode_loop(xflow, mask, k):
    """The JAX function's mode filter, its loop as it stands."""
    h, w = xflow.shape
    mk = mask > 0.5
    f = np.round(xflow).astype(np.int32)
    flow_p = np.zeros_like(xflow)
    for i in range(w):
        for j in range(h):
            if not mk[j, i]:
                continue
            i0, i1 = max(0, i - k), min(w, i + k)
            j0, j1 = max(0, j - k), min(h, j + k)
            vals = f[j0:j1, i0:i1][mk[j0:j1, i0:i1]]
            if vals.size:
                counts = np.bincount(np.clip(vals + 8, 0, 19), minlength=20)
                flow_p[j, i] = int(np.argmax(counts)) - 8
    return flow_p


def flow_cases():
    rng = np.random.RandomState(0)
    h, w = 24, 33
    cases = []
    # wide random flows: both clip ends, .5 rounding edges
    f = rng.uniform(-13, 15, (h, w)).astype(np.float32)
    f[::5, ::3] = np.round(f[::5, ::3]) + 0.5
    cases.append((f, (rng.rand(h, w) > 0.3).astype(np.float32)))
    # two values in a checkerboard: every full window ties, the lower bin
    # wins; a mask off at the borders
    f = np.where((np.indices((h, w)).sum(0) % 2) == 0, 3.0, -2.0)
    m = np.ones((h, w), np.float32)
    m[0], m[:, -1] = 0.0, 0.0
    cases.append((f.astype(np.float32), m))
    # small flows (depth 100 where |mode| < 1.1) under a sparse mask
    f = rng.normal(0, 1.5, (h, w)).astype(np.float32)
    cases.append((f, (rng.rand(h, w) > 0.8).astype(np.float32)))
    return cases


@pytest.mark.parametrize("k", [3, 2])
@pytest.mark.parametrize("case", range(3))
@pytest.mark.parametrize("m", [2.0, 0.0625, -0.3])
def test_depth_rule_bit_equal_to_jax(k, case, m):
    xflow, mask = flow_cases()[case]
    mode = tdrone.mode_filter(torch.from_numpy(xflow), torch.from_numpy(mask),
                              k)
    np.testing.assert_array_equal(mode.numpy(), mode_loop(xflow, mask, k))
    depth, conf = tdrone.compute_depth_map_from_flow(
        torch.from_numpy(xflow), torch.from_numpy(mask), m, k)
    jdepth, jconf = jdrone.compute_depth_map_from_flow(xflow, mask, m, k)
    assert depth.dtype == conf.dtype == torch.float32
    np.testing.assert_array_equal(depth.numpy(), jdepth)
    np.testing.assert_array_equal(conf.numpy(), jconf)
    assert (conf.numpy()[:, xflow.shape[1] // 2] == 0).all()


def test_depth_rule_rejects_an_empty_window():
    with pytest.raises(ValueError, match="k=0"):
        tdrone.mode_filter(torch.zeros(4, 4), torch.ones(4, 4), 0)
