"""Ego-motion's ms a batched step: the synchronising span around geometry3d/egomotion.get_ego_motion_batched."""

from h100bench import readings


def read(r):
    return readings.span_ms_per_step(r, "ego")
