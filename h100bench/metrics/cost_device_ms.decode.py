"""The multiscale decode's cost volume, device ms a call: the kernels launched inside the program's own span decode.cost (every scale's match_ssd and softmax in MultiscaleFlowModel.decode_from_features, once a call); None where the span never ran."""


def read(r):
    p = r.profiled
    calls = 0 if p is None else p.span_calls.get("decode.cost", 0)
    if calls <= 0:
        return None
    return 1e3 * p.span_device_s["decode.cost"] / calls
