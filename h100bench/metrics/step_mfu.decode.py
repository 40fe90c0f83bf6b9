"""The multiscale decode step's share of the card's FP32 peak: model FLOPs a step over (step time x 67 TFLOP/s x cards), in %."""

from h100bench import readings


def read(r):
    return readings.mfu_pct(r)
