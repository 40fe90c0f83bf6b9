"""The card's idle ms a batched step while the host is in RANSAC's 8-point QR: the idle gaps labelled with the program's own span ego.qr (geometry3d/egomotion.ransac_hypotheses). Reads 0 where ego.qr ran but its label is not among the ten largest idle labels the reduction keeps (then smaller than the tenth); None where the span never ran."""


def read(r):
    p = r.profiled
    if p is None or r.profiled_steps <= 0 or "ego.qr" not in p.span_calls:
        return None
    idle_s = dict(p.idle_gaps).get("host in ego.qr", 0.0)
    return 1e3 * idle_s / r.profiled_steps
