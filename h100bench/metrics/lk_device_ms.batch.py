"""Windowed LK's device ms a batched step: the kernels launched inside the program's own span ego.lk (geometry3d/egomotion.get_ego_motion_batched's tracker call); None where the span never ran."""


def read(r):
    p = r.profiled
    if p is None or r.profiled_steps <= 0 or "ego.lk" not in p.span_device_s:
        return None
    return 1e3 * p.span_device_s["ego.lk"] / r.profiled_steps
