"""The radial estimator's warps, device ms a step: the kernels launched inside the program's own spans radial.polar (rescale, rotation removal, the C2P grids, the three polar warps) and radial.depth (the P2C grid, the warp back, flow2depth); None where neither ran."""

SPANS = ("radial.polar", "radial.depth")


def read(r):
    p = r.profiled
    if p is None or r.profiled_steps <= 0:
        return None
    seen = [s for s in SPANS if s in p.span_device_s]
    if not seen:
        return None
    return 1e3 * sum(p.span_device_s[s] for s in seen) / r.profiled_steps
