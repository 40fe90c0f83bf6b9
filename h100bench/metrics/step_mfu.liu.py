"""The liu solve step's share of the card's FP32 peak: the solve's FP32 operations a step (liu_counts.solve_flops: IRLS, SOR sweeps and warps counted a pixel from the schedule) over (step time x 67 TFLOP/s x cards), in %."""

from h100bench import readings


def read(r):
    return readings.mfu_pct(r)
