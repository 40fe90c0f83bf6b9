"""The conv trunk's share of its roofline in the multiscale decode's steps: each call's bound time (trunk FLOPs at the FP32 peak, or its bytes at the HBM rate) over the device time of the kernels it launched."""

from h100bench import readings


def read(r):
    return readings.roofline_pct(r, "trunk")
