"""The multiscale decode's ms a call: the synchronising span around MultiscaleFlowModel.decode_from_features."""

from h100bench import readings


def read(r):
    return readings.span_ms_per_step(r, "decode")
