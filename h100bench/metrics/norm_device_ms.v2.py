"""The version2 net's contrastive normalisation, device ms a step: the kernels launched inside the program's own span v2.norm (models/version2.V2Network.flow_batch: both frames of every pair as one batch); None where the span never ran."""


def read(r):
    p = r.profiled
    if p is None or r.profiled_steps <= 0 or "v2.norm" not in p.span_device_s:
        return None
    return 1e3 * p.span_device_s["v2.norm"] / r.profiled_steps
