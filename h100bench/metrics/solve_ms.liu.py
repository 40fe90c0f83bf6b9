"""The liu solve's ms a step: the synchronising span around data/groundtruth.liu_flow_batched (the card waits at each SOR call too, the harness's span around sor_redblack)."""

from h100bench import readings


def read(r):
    return readings.span_ms_per_step(r, "solve")
