"""The card's idle share of the profiled batched steps, in %."""

from h100bench import readings


def read(r):
    return readings.idle_pct(r)
