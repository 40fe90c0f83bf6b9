"""Kernel B1's share of its roofline: each call's bound time (matcher_work at 3K + 5 operations a cell) over the device time of the kernels launched inside ops/matching.match_flow_fused."""

from h100bench import readings


def read(r):
    return readings.roofline_pct(r, "match")
