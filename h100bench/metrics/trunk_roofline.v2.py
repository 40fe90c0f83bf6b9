"""The version2 net's conv trunk's share of its roofline: each call's bound time (single_scale.trunk_work of [[3,17,17,32]]: its FLOPs at the FP32 peak, or its bytes at the HBM rate) over the device time of the kernels launched inside the harness's span around models/filters.ConvFilter.forward."""

from h100bench import readings


def read(r):
    return readings.roofline_pct(r, "trunk")
