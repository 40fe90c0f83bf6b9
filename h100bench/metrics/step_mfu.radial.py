"""The radial step's share of the card's FP32 peak: the trunk's FLOPs on both polar frames of every pair and the radial matcher's 3 K hWin a cell (radial_counts.step_flops) over (step time x 67 TFLOP/s x cards), in %."""

from h100bench import readings


def read(r):
    return readings.mfu_pct(r)
