"""The card's idle ms a liu solve step while the host is in an IRLS step's coefficient planes: the idle gaps labelled with the program's own span liu.irls (flow/celiu.smooth_flow_sor). Reads 0 where liu.irls ran but its label is not among the ten largest idle labels the reduction keeps; None where the span never ran."""


def read(r):
    p = r.profiled
    if p is None or r.profiled_steps <= 0 or "liu.irls" not in p.span_calls:
        return None
    idle_s = dict(p.idle_gaps).get("host in liu.irls", 0.0)
    return 1e3 * idle_s / r.profiled_steps
