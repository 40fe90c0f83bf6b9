"""Autonomous obstacle-avoidance control loop, headless (port of
``depth_estimation_tpu.robotics.control``).

Each tick asks the polar occupancy map for a safe heading within a field
of view, turns it into the keyboard-equivalent control (forward pitch 0.5;
roll and yaw rate +-0.3 toward the safe side when an obstacle is close),
steps the drone API, and feeds the map the new frame and displacement.
Any backend with the ``SimulatedAPI`` surface drives it; the real-drone
adapter ``drone_api.FifoDroneAPI`` is a drop-in replacement.
"""

from __future__ import annotations

import numpy as np

from .runtime import DepthMap


class AvoidanceController:
    def __init__(self, api, depth_map: DepthMap, fov: int = 32,
                 viewer=None):
        """``viewer``: an optional ``utils.viewer.LiveViewer``; when given,
        each tick shows the 2-D occupancy map (its headless backend is a
        no-op, so the loop is the same without a display)."""
        self.api = api
        self.map = depth_map
        self.fov = fov
        self.viewer = viewer
        self.last_safe_theta = 0.0

    def step(self) -> float:
        """One control tick; returns the safe-theta decision used."""
        safe = self.map.get_safe_theta(self.fov)
        self.last_safe_theta = safe
        pitch, gaz, roll, dyaw = 0.5, 0.0, 0.0, 0.0   # 'w': forward
        if safe > 0:
            roll, dyaw = 0.3, 0.3                      # 'd' + RIGHT
        elif safe < 0:
            roll, dyaw = -0.3, -0.3                    # 'a' + LEFT
        self.api.set_control(pitch, gaz, roll, dyaw)
        self.api.next()

        depth = self.api.get_depth_map()
        conf = self.api.get_confidence_map()
        self.map.new_displacement(self.api.get_filtered_translation(),
                                  self.api.get_gyro())
        self.map.new_frame(depth, conf)
        if self.viewer is not None:
            self.viewer.show(self.map.to_2d_map())
        return safe

    def run(self, n_steps: int) -> np.ndarray:
        """Run the loop; returns the (n_steps, 3) trajectory."""
        traj = np.zeros((n_steps, 3), np.float32)
        for i in range(n_steps):
            self.step()
            traj[i] = self.api.position()
        return traj
