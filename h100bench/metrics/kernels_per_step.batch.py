"""CUDA kernels launched a batched step (profiled steps that carry only ranges)."""

from h100bench import readings


def read(r):
    return readings.kernels_per_step(r)
