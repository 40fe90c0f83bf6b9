"""The liu solve's warps, device ms a step: the kernels launched inside the program's own span liu.warp (the flow's upsampling between levels, each outer step's update, warp and noise estimate, the final warp; flow/celiu); None where the span never ran."""


def read(r):
    p = r.profiled
    if p is None or r.profiled_steps <= 0 or "liu.warp" not in p.span_device_s:
        return None
    return 1e3 * p.span_device_s["liu.warp"] / r.profiled_steps
