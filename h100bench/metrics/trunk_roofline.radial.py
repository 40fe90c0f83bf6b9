"""The radial net's conv trunk's share of its roofline: each call's bound time (radial_counts.trunk_work: its FLOPs at the FP32 peak, or its bytes at the HBM rate) over the device time of the kernels launched inside the harness's span around models/radial.RadialFilter.forward."""

from h100bench import readings


def read(r):
    return readings.roofline_pct(r, "trunk")
