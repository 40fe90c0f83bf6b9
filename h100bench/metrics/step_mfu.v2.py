"""The version2 step's share of the card's FP32 peak: the trunk's FLOPs on both frames of every pair and B2's cross terms, 2K a cell (v2_counts.step_flops), over (step time x 67 TFLOP/s x cards), in %."""

from h100bench import readings


def read(r):
    return readings.mfu_pct(r)
