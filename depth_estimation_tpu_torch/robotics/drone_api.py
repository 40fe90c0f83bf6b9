"""Real-drone adapter (port of ``depth_estimation_tpu.robotics.drone_api``).

``FifoDroneAPI`` has the surface of the native ``SimulatedAPI`` (a drop-in
backend for the avoidance controller and teleop) over:
  * the native FIFO link (``runtime``): control records out, navdata in;
  * a frame source (``data.images.ImageLoader`` / ``ImageCamera``) and the
    port's ``api.DepthEstimator``, whose x-flow and mask stay on its device;
  * ``compute_depth_map_from_flow``, the drone's depth rule, run on the
    same device; the depth and confidence maps the native ``DepthMap``
    takes are the tick's one read from the card.
"""

from __future__ import annotations

import time
from typing import Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..utils.device import resolve
from . import runtime

N_BINS = 20     # the mode filter's histogram: rounded x-flow in [-8, 12)
BIN_LO = -8


def mode_filter(xflow: torch.Tensor, mask: torch.Tensor,
                k: int = 3) -> torch.Tensor:
    """The mode of the rounded x-flow over the masked pixels of each
    masked pixel's window, rows and columns [p - k, p + k) clipped at the
    borders: a histogram over bins clip(f + 8, 0, 19), the lowest bin on
    ties. (h, w) -> (h, w) float64 on the flow's device, 0 where the
    mask is off."""
    if k < 1:
        raise ValueError(f"window half-size k={k} must be >= 1")
    mk = mask > 0.5
    bins = torch.clamp(torch.round(xflow).to(torch.int64) - BIN_LO, 0,
                       N_BINS - 1)
    onehot = (F.one_hot(bins, N_BINS).to(torch.float32)
              * mk[..., None].to(torch.float32))
    # box sums over the window: zero padding k before, k - 1 after
    padded = F.pad(onehot.permute(2, 0, 1)[None], (k, k - 1, k, k - 1))
    counts = F.avg_pool2d(padded, 2 * k, stride=1, divisor_override=1)[0]
    mode = (counts.argmax(0) + BIN_LO).to(torch.float64)
    return torch.where(mk, mode, torch.zeros_like(mode))


def compute_depth_map_from_flow(xflow: torch.Tensor, mask: torch.Tensor,
                                m: float, k: int = 3
                                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """x-flow (h, w) and mask (h, w) -> (depth, confidence), f32 on their
    device: depth = m |j - w // 2| / |mode| over the ``mode_filter``ed
    x-flow (in float64, then rounded to f32), 100 where |mode| < 1.1;
    masked-out pixels and the centre column get depth 0 and confidence
    0."""
    w = xflow.shape[1]
    mk = mask > 0.5
    absf = mode_filter(xflow, mask, k).abs()
    jj = torch.arange(w, device=xflow.device)[None, :]
    middlex = w // 2
    depth = torch.where(
        absf < 1.1, torch.full_like(absf, 100.0),
        m * (jj - middlex).abs().to(torch.float64)
        / torch.clamp(absf, min=1e-6))
    ok = mk & (jj != middlex)
    depth = torch.where(ok, depth, torch.zeros_like(depth))
    return depth.to(torch.float32), ok.to(torch.float32)


class FifoDroneAPI:
    """DroneAPI over the FIFO protocol and the estimator's flow, the
    one-line backend switch with ``SimulatedAPI``: both expose next,
    get_depth_map, get_confidence_map, takeoff, land, set_control,
    get_filtered_translation, get_gyro and position. ``estimator`` is an
    ``api.DepthEstimator`` the caller has ``reset`` with the first frame;
    ``frame_source`` has ``get_next_frame()``. The depth rule runs on
    ``device`` (the card by default; raises where there is none unless
    given ``device="cpu"``). Opening blocks until the peer opens the
    control pipe's read end."""

    def __init__(self, control_path: str, navdata_path: str,
                 estimator=None, frame_source=None, device="cuda"):
        self.device = resolve(device)
        lib = runtime.load_library()
        self._lib = lib
        self._h = lib.fifo_open(
            control_path.encode() if control_path else None,
            navdata_path.encode() if navdata_path else None)
        self.estimator = estimator
        self.frames = frame_source
        self._last_time = time.monotonic()
        self.delta_t = 0.0
        self.navdata = dict(state=0, battery=100.0,
                            gyro=np.zeros(3, np.float32), altitude=0.0,
                            velocity=np.zeros(3, np.float32))
        self._imu_d = np.zeros(3, np.float32)
        self._depth = np.zeros((1, 1), np.float32)
        self._conf = np.zeros((1, 1), np.float32)
        self._pos = np.zeros(3, np.float32)

    def close(self):
        if self._h:
            self._lib.fifo_close(self._h)
            self._h = None

    def next(self):
        now = time.monotonic()
        self.delta_t = now - self._last_time
        self._last_time = now
        got = runtime.read_navdata(self._lib.fifo_read_navdata, self._h)
        if got is not None:
            self.navdata = got
        # the IMU translation is velocity times the tick's time
        self._imu_d = self.navdata["velocity"] * self.delta_t
        self._pos = self._pos + self._imu_d
        if self.estimator is not None and self.frames is not None:
            frame = self.frames.get_next_frame()
            if frame is not None:
                _, xflow, mask = self.estimator.next_frame_depth(frame,
                                                                 fetch=False)
                m = float(self._imu_d[0]) or 1.0
                depth, conf = compute_depth_map_from_flow(
                    xflow.to(self.device), mask.to(self.device), m)
                self._depth, self._conf = torch.stack([depth, conf]).cpu().numpy()

    def get_depth_map(self) -> np.ndarray:
        return self._depth

    def get_confidence_map(self) -> np.ndarray:
        return self._conf

    def get_imu_translation(self) -> np.ndarray:
        return self._imu_d

    def get_filtered_translation(self) -> np.ndarray:
        return self._imu_d   # no visual odometry on the real drone's path

    def get_gyro(self) -> np.ndarray:
        return self.navdata["gyro"]

    def position(self) -> np.ndarray:
        return self._pos

    @property
    def altitude(self) -> float:
        return self.navdata["altitude"]

    def takeoff(self):
        self._lib.fifo_takeoff(self._h)

    def land(self):
        self._lib.fifo_land(self._h)

    def set_control(self, pitch: float, gaz: float, roll: float, dyaw: float):
        self._lib.fifo_set_control(self._h, pitch, gaz, roll, dyaw)
