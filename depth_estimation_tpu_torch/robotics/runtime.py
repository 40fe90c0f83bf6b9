"""ctypes bindings over the native C++ drone runtime (port of
``depth_estimation_tpu.robotics.runtime``).

The sources in ``native/`` (the port's own copy) are compiled at first use
with ``g++ -O3 -fPIC -std=c++17 -shared`` into
``_build/robotics-<hash of the sources and flags>/libdrone_runtime.so``
and loaded with ctypes; nothing is built at import, and a failed build
raises. Exposes ``SimulatedAPI``, ``DepthMap``, ``RadialDepthMap`` and the
FIFO record codecs. Host code: numpy arrays in and out at the ctypes
boundary.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
from functools import lru_cache
from pathlib import Path

import numpy as np

NATIVE = Path(__file__).resolve().parent / "native"
BUILD_ROOT = Path(__file__).resolve().parent.parent / "_build"
CXX_FLAGS = ("-O3", "-fPIC", "-std=c++17", "-shared")
SOURCES = ("simulator.cpp", "depth_map.cpp", "radial_depth_map.cpp",
           "fifo_link.cpp", "capi.cpp")

CONTROL_RECORD_LEN = 33
NAVDATA_RECORD_LEN = 98


def _digest() -> str:
    """Hash of the flags and of every file under native/."""
    h = hashlib.sha256(" ".join(CXX_FLAGS).encode())
    for path in sorted(NATIVE.iterdir()):
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def library_path() -> Path:
    """Where the library for these sources and flags is built."""
    return BUILD_ROOT / f"robotics-{_digest()}" / "libdrone_runtime.so"


def build() -> Path:
    """Compile the native runtime unless it is built for these sources.
    Returns the library's path; raises if g++ is missing or fails."""
    path = library_path()
    if path.exists():
        return path
    cxx = shutil.which("g++")
    if not cxx:
        raise RuntimeError("g++ not found: the native drone runtime needs a "
                           "C++17 compiler")
    path.parent.mkdir(parents=True, exist_ok=True)
    tmp = path.with_name(f"libdrone_runtime.{os.getpid()}.so")
    proc = subprocess.run(
        [cxx, *CXX_FLAGS, "-o", str(tmp), *(str(NATIVE / s) for s in SOURCES)],
        capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"g++ failed ({proc.returncode}) building the "
                           f"drone runtime:\n{proc.stdout}{proc.stderr}")
    os.replace(tmp, path)
    return path


@lru_cache(maxsize=1)
def load_library() -> ctypes.CDLL:
    """The process's native runtime, built on first use."""
    lib = ctypes.CDLL(str(build()))
    F = ctypes.c_float
    P = ctypes.c_void_p
    I = ctypes.c_int
    FP = ctypes.POINTER(ctypes.c_float)
    S = ctypes.c_size_t
    sigs = {
        "sim_create": (P, [I, I, F, ctypes.c_ulonglong, I]),
        "sim_delta_t": (F, [P]), "sim_altitude": (F, [P]),
        "sim_yaw": (F, [P]),
        "sim_set_control": (None, [P, F, F, F, F]),
        "sim_add_obstacle": (None, [P, F, F, F, F]),
        "dmap_create": (P, [S, S, F, F, F]),
        "dmap_new_pixel": (None, [P, F, F, F, F, F, F]),
        "dmap_new_displacement": (None, [P, FP, FP]),
        "dmap_new_frame": (None, [P, FP, FP, I, I]),
        "dmap_safe_theta": (F, [P, S]),
        "dmap_values": (None, [P, FP]),
        "dmap_to_2d": (None, [P, FP, I]),
        "dmap_theta_sight": (F, [P]),
        "rdmap_create": (P, [S, F, F, F]),
        "rdmap_new_pixel": (None, [P, F, F, F, F, F, F]),
        "rdmap_new_displacement": (None, [P, FP, FP]),
        "rdmap_new_frame": (None, [P, FP, I, I]),
        "rdmap_depths": (None, [P, FP]), "rdmap_variances": (None, [P, FP]),
        "rdmap_to_2d": (None, [P, FP, I]),
        "fifo_encode_control": (None, [ctypes.c_char_p, F, F, F, F]),
        "fifo_encode_takeoff": (None, [ctypes.c_char_p]),
        "fifo_encode_land": (None, [ctypes.c_char_p]),
        "fifo_decode_control": (ctypes.c_char,
                                [ctypes.c_char_p, FP, FP, FP, FP]),
        "fifo_encode_navdata": (None, [ctypes.c_char_p, I, F, FP, F, FP]),
        "fifo_decode_navdata": (I, [ctypes.c_char_p, ctypes.POINTER(I), FP,
                                    FP, FP, FP]),
        "fifo_open": (P, [ctypes.c_char_p, ctypes.c_char_p]),
        "fifo_set_control": (None, [P, F, F, F, F]),
        "fifo_read_navdata": (I, [P, ctypes.POINTER(I), FP, FP, FP, FP]),
    }
    for name in ("sim_destroy", "sim_next", "sim_takeoff", "sim_land",
                 "sim_clear_obstacles", "dmap_destroy", "rdmap_destroy",
                 "fifo_close", "fifo_takeoff", "fifo_land"):
        sigs[name] = (None, [P])
    for name in ("sim_depth_map", "sim_confidence_map", "sim_imu_translation",
                 "sim_vo_translation", "sim_filtered_translation", "sim_gyro",
                 "sim_position"):
        sigs[name] = (None, [P, FP])
    for name, (restype, argtypes) in sigs.items():
        fn = getattr(lib, name)
        fn.restype = restype
        fn.argtypes = argtypes
    return lib


def _fp(a: np.ndarray):
    return a.ctypes.data_as(ctypes.POINTER(ctypes.c_float))


def _f32(a) -> np.ndarray:
    return np.ascontiguousarray(a, np.float32)


class SimulatedAPI:
    """The native physics simulator (the fake backend)."""

    def __init__(self, w: int = 320, h: int = 240, fixed_dt: float = 0.0,
                 seed: int = 42, default_course: bool = True):
        self._lib = load_library()
        self._h = self._lib.sim_create(w, h, fixed_dt, seed,
                                       1 if default_course else 0)
        self.w, self.h = w, h

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.sim_destroy(self._h)
            self._h = None

    def next(self):
        self._lib.sim_next(self._h)

    @property
    def delta_t(self) -> float:
        return self._lib.sim_delta_t(self._h)

    def _map(self, fn) -> np.ndarray:
        out = np.empty((self.h, self.w), np.float32)
        fn(self._h, _fp(out))
        return out

    def get_depth_map(self) -> np.ndarray:
        return self._map(self._lib.sim_depth_map)

    def get_confidence_map(self) -> np.ndarray:
        return self._map(self._lib.sim_confidence_map)

    def _vec3(self, fn) -> np.ndarray:
        out = np.empty(3, np.float32)
        fn(self._h, _fp(out))
        return out

    def get_imu_translation(self): return self._vec3(self._lib.sim_imu_translation)
    def get_vo_translation(self): return self._vec3(self._lib.sim_vo_translation)
    def get_filtered_translation(self): return self._vec3(self._lib.sim_filtered_translation)
    def get_gyro(self): return self._vec3(self._lib.sim_gyro)
    def position(self): return self._vec3(self._lib.sim_position)

    @property
    def altitude(self) -> float:
        return self._lib.sim_altitude(self._h)

    @property
    def yaw(self) -> float:
        return self._lib.sim_yaw(self._h)

    def takeoff(self): self._lib.sim_takeoff(self._h)
    def land(self): self._lib.sim_land(self._h)

    def set_control(self, pitch: float, gaz: float, roll: float, dyaw: float):
        self._lib.sim_set_control(self._h, pitch, gaz, roll, dyaw)

    def add_obstacle(self, x, y, z, r):
        self._lib.sim_add_obstacle(self._h, x, y, z, r)

    def clear_obstacles(self):
        self._lib.sim_clear_obstacles(self._h)


class DepthMap:
    """Polar occupancy grid (theta x rho), native."""

    def __init__(self, n_rho: int = 64, n_theta: int = 128,
                 max_depth: float = 100.0, unseen_decay: float = 0.9,
                 focal_length: float = 320.0):
        self._lib = load_library()
        self._h = self._lib.dmap_create(n_rho, n_theta, max_depth,
                                        unseen_decay, focal_length)
        self.n_rho, self.n_theta = n_rho, n_theta

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.dmap_destroy(self._h)
            self._h = None

    def new_pixel(self, x, y, depth, conf, w, h):
        self._lib.dmap_new_pixel(self._h, x, y, depth, conf, w, h)

    def new_displacement(self, pos, sight):
        pos, sight = _f32(pos), _f32(sight)
        if pos.size != 3 or sight.size != 3:
            raise ValueError("pos and sight are 3-vectors")
        self._lib.dmap_new_displacement(self._h, _fp(pos), _fp(sight))

    def new_frame(self, depth: np.ndarray, conf: np.ndarray):
        depth, conf = _f32(depth), _f32(conf)
        if depth.ndim != 2 or conf.shape != depth.shape:
            raise ValueError(f"depth {depth.shape} and confidence "
                             f"{conf.shape} must be one (h, w) shape")
        h, w = depth.shape
        self._lib.dmap_new_frame(self._h, _fp(depth), _fp(conf), w, h)

    def get_safe_theta(self, fov: int) -> float:
        return self._lib.dmap_safe_theta(self._h, fov)

    def values(self) -> np.ndarray:
        out = np.empty((self.n_theta, self.n_rho), np.float32)
        self._lib.dmap_values(self._h, _fp(out))
        return out

    def to_2d_map(self, size: int = 300) -> np.ndarray:
        out = np.empty((size, size), np.float32)
        self._lib.dmap_to_2d(self._h, _fp(out), size)
        return out

    @property
    def theta_sight(self) -> float:
        return self._lib.dmap_theta_sight(self._h)


class RadialDepthMap:
    """1-D Kalman per-angle depth map, native."""

    def __init__(self, n_theta: int = 128, max_depth: float = 100.0,
                 unseen_decay: float = 0.9, focal_length: float = 320.0):
        self._lib = load_library()
        self._h = self._lib.rdmap_create(n_theta, max_depth, unseen_decay,
                                         focal_length)
        self.n_theta = n_theta

    def __del__(self):
        if getattr(self, "_h", None):
            self._lib.rdmap_destroy(self._h)
            self._h = None

    def new_pixel(self, x, y, depth, var, w, h):
        self._lib.rdmap_new_pixel(self._h, x, y, depth, var, w, h)

    def new_displacement(self, pos, sight):
        pos, sight = _f32(pos), _f32(sight)
        if pos.size != 3 or sight.size != 3:
            raise ValueError("pos and sight are 3-vectors")
        self._lib.rdmap_new_displacement(self._h, _fp(pos), _fp(sight))

    def new_frame(self, pixels: np.ndarray):
        pixels = _f32(pixels)
        if pixels.ndim != 2:
            raise ValueError(f"pixels {pixels.shape} must be (h, w)")
        h, w = pixels.shape
        self._lib.rdmap_new_frame(self._h, _fp(pixels), w, h)

    def _row(self, fn) -> np.ndarray:
        out = np.empty(self.n_theta, np.float32)
        fn(self._h, _fp(out))
        return out

    def depths(self) -> np.ndarray:
        return self._row(self._lib.rdmap_depths)

    def variances(self) -> np.ndarray:
        return self._row(self._lib.rdmap_variances)

    def to_2d_map(self, size: int = 300) -> np.ndarray:
        out = np.empty((size, size), np.float32)
        self._lib.rdmap_to_2d(self._h, _fp(out), size)
        return out


# ---------------------------------------------------------------------------
# FIFO records, usable without live pipes
# ---------------------------------------------------------------------------

def _record(fn, *args, n: int = CONTROL_RECORD_LEN) -> bytes:
    buf = ctypes.create_string_buffer(n)
    fn(buf, *args)
    return buf.raw[:n]


def encode_control(pitch: float, gaz: float, roll: float, yaw: float) -> bytes:
    return _record(load_library().fifo_encode_control, pitch, gaz, roll, yaw)


def encode_takeoff() -> bytes:
    return _record(load_library().fifo_encode_takeoff)


def encode_land() -> bytes:
    return _record(load_library().fifo_encode_land)


def decode_control(record: bytes):
    """Returns (kind, pitch, gaz, roll, yaw); kind in 'T', 'L', 'C', ''."""
    if len(record) < CONTROL_RECORD_LEN:
        raise ValueError(f"a control record is {CONTROL_RECORD_LEN} bytes, "
                         f"got {len(record)}")
    F = ctypes.c_float
    p, g, r, y = F(), F(), F(), F()
    kind = load_library().fifo_decode_control(
        record, ctypes.byref(p), ctypes.byref(g), ctypes.byref(r),
        ctypes.byref(y))
    return (kind.decode() if kind != b"\x00" else "", p.value, g.value,
            r.value, y.value)


def encode_navdata(state: int, battery: float, gyro, altitude: float,
                   vel) -> bytes:
    g, v = _f32(gyro), _f32(vel)
    if g.size != 3 or v.size != 3:
        raise ValueError("gyro and velocity are 3-vectors")
    return _record(load_library().fifo_encode_navdata, state, battery, _fp(g),
                   altitude, _fp(v), n=NAVDATA_RECORD_LEN)


def read_navdata(fn, *handle):
    """Call a native navdata reader (``fifo_decode_navdata`` on a record,
    ``fifo_read_navdata`` on a link); the navdata dict, or None where it
    read nothing."""
    state = ctypes.c_int()
    battery = ctypes.c_float()
    alt = ctypes.c_float()
    gyro = np.empty(3, np.float32)
    vel = np.empty(3, np.float32)
    ok = fn(*handle, ctypes.byref(state), ctypes.byref(battery), _fp(gyro),
            ctypes.byref(alt), _fp(vel))
    if not ok:
        return None
    return dict(state=state.value, battery=battery.value, gyro=gyro,
                altitude=alt.value, velocity=vel)


def decode_navdata(record: bytes):
    if len(record) < NAVDATA_RECORD_LEN:
        raise ValueError(f"a navdata record is {NAVDATA_RECORD_LEN} bytes, "
                         f"got {len(record)}")
    return read_navdata(load_library().fifo_decode_navdata, record)
