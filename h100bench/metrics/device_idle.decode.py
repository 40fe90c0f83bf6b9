"""The card's idle share of the profiled multiscale decode steps, in %."""

from h100bench import readings


def read(r):
    return readings.idle_pct(r)
