"""Ego-motion's ms a radial step: the synchronising span around geometry3d/egomotion.get_ego_motion_batched as the radial estimator calls it (corners, full-image LK, RANSAC at the calibration's size)."""

from h100bench import readings


def read(r):
    return readings.span_ms_per_step(r, "ego")
