"""Kernel B2's share of its roofline in the version2 net's batched flow: each call's bound time (v2_counts.fast_work: 2K + 8 FP32 operations a pixel and window cell and 2K a position's norm at the FP32 peak, or f1, f2 and the four outputs' bytes at the HBM rate) over the device time of the kernels launched inside the harness's span around ops/matching.match_flow_fast."""

from h100bench import readings


def read(r):
    return readings.roofline_pct(r, "match")
