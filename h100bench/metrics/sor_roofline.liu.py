"""Kernel B4's share of its roofline in the liu solve: each call's bound time (liu_counts.sor_work: 11 planes of 4 bytes a pixel at the HBM rate, or 30 FP32 operations a pixel and sweep at the FP32 peak) over the device time of the kernels launched inside the harness's span around sor_redblack, as flow/celiu looks it up."""

from h100bench import readings


def read(r):
    return readings.roofline_pct(r, "sor")
