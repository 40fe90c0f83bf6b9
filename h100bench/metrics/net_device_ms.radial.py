"""The radial net's device ms a step: the kernels launched inside the program's own span radial.net (models/radial.RadialFlowNetwork.flow_batch: the trunk on both polar frames, the radial SSD, the WTA); None where the span never ran."""


def read(r):
    p = r.profiled
    if p is None or r.profiled_steps <= 0 or "radial.net" not in p.span_device_s:
        return None
    return 1e3 * p.span_device_s["radial.net"] / r.profiled_steps
