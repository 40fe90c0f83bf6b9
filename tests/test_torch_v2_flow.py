"""The version2 net's batched flow (``V2Network.flow_batch``) on the CPU
against the benchmark's plain reference ``h100bench/reference/v2.py``
(contrastive normalisation by one 2-D convolution, the trunk, the crop,
SpatialMatching's direct SSD, the matching core's heads), on seeded
weights: a 7x7x8 trunk with a 7x7 window on two pairs, and the published
17x17x32 trunk with a 17x17 window on one 48x64 pair.

The program differs from the reference by rounding alone: its
normalisation sums the gaussian's taps separably, and its match works on
the norm decomposition 2 <f1, f2> - |f2|^2 - |f1|^2 (kernel B2's twin on
the CPU), where the reference subtracts. So the WTA indices are equal
except where two cells' costs tie to within that rounding, and ey, ex and
pmax agree to within it (the tolerances below, each with its reason).
Also: the program's spans ``v2.*`` record under a profiler, nested in
order, the counter ``v2.pairs`` counts the pairs, and the CPU route runs
B2's plain twin and launches nothing."""

import math

import pytest
import torch

from depth_estimation_tpu_torch.models import version2
from depth_estimation_tpu_torch.ops import matching
from depth_estimation_tpu_torch.utils import timer
from h100bench import traffic
from h100bench.reference import v2 as ref
from h100bench.reference.online import match_ssd
from torch_parity import one_torch_thread  # noqa: F401 (fixture)

# |f|^2 of the published trunk's features is ~30-60, and the norm
# decomposition rounds the logit by ~1e-5 of that; the normalisation's
# separable sums move the features by ~1e-6 relative. A cost gap below
# COST_TIE may therefore order two cells either way.
COST_TIE = 1e-3
# ey, ex: the soft-argmax moves by the logit's rounding times a
# displacement of at most 8 px, through probabilities of at most 1
E_TOL = 2e-4
# pmax: a probability, moved by the logit's rounding
PMAX_TOL = 1e-4

SMALL = dict(h=24, w=32, layers=((3, 7, 7, 8),), win=7, pairs=2, seed=1)
PUBLISHED = dict(h=48, w=64, layers=((3, 17, 17, 32),), win=17, pairs=1,
                 seed=2)


def _panned_frames(g, pairs, h, w):
    """A smooth random texture and the view panned by (2, 3) px: frame 1's
    pixel (y, x) shows in frame 2 at (y - 2, x - 3), inside the window."""
    base = traffic.resize(torch.rand((pairs, h // 4, w // 4, 3), generator=g),
                          h + 8, w + 8)
    return base[:, 4:4 + h, 4:4 + w], base[:, 6:6 + h, 7:7 + w]


def _setup(h, w, layers, win, pairs, seed):
    g = torch.Generator().manual_seed(seed)
    (cin, kh, kw, cout), = layers
    weight = torch.randn((cout, cin, kh, kw), generator=g) / math.sqrt(
        cin * kh * kw)
    bias = 0.1 * torch.randn((cout,), generator=g)
    img1, img2 = _panned_frames(g, pairs, h, w)
    datap = version2.V2Params(wImg=w, hImg=h, layers=layers, hWin=win,
                              wWin=win)
    net = version2.V2Network(datap, device="cpu")
    net.load_state_dict({"filter.layer1.weight": weight,
                         "filter.layer1.bias": bias})
    return net, ref.V2(17, weight, bias, win, win), img1, img2


def _ref_costs(m, img1, img2):
    h1, h2 = math.ceil(m.h_win / 2) - 1, m.h_win // 2
    w1, w2 = math.ceil(m.w_win / 2) - 1, m.w_win // 2
    f1 = ref.features(m, img1)
    f1 = f1[:, h1:f1.shape[1] - h2, w1:f1.shape[2] - w2]
    return match_ssd(f1, ref.features(m, img2), m.h_win, m.w_win)


@pytest.mark.parametrize("size", [SMALL, PUBLISHED],
                         ids=["small", "published"])
def test_flow_batch_equals_the_reference(size):
    net, m, img1, img2 = _setup(**size)
    with torch.no_grad():
        idx, ey, ex, pmax = net.flow_batch(img1, img2)
    want = ref.flow(m, img1, img2)
    B, h, w = size["pairs"], size["h"], size["w"]
    k = size["layers"][0][1] - 1 + size["win"] - 1
    assert tuple(idx.shape) == (B, h - k, w - k) and idx.dtype == torch.int32
    assert all(tuple(x.shape) == tuple(idx.shape) for x in (ey, ex, pmax))
    flip = idx != want["idx"]
    if flip.any():
        cost = _ref_costs(m, img1, img2)
        got_c = cost.gather(-1, idx.long()[..., None])[..., 0]
        want_c = cost.gather(-1, want["idx"].long()[..., None])[..., 0]
        assert bool(((got_c - want_c).abs()[flip] <= COST_TIE).all())
    assert flip.float().mean().item() <= 0.01
    assert (ey - want["ey"]).abs().max().item() <= E_TOL
    assert (ex - want["ex"]).abs().max().item() <= E_TOL
    assert (pmax - want["pmax"]).abs().max().item() <= PMAX_TOL
    # the pan: most pixels pick the cell (-2, -3) px from the middle
    pan = (size["win"] // 2 - 2) * size["win"] + size["win"] // 2 - 3
    assert (idx == pan).float().mean().item() >= 0.5


def test_flow_batch_keeps_the_trainer_costs():
    """The batched flow's WTA is the argmin of ``costs``, the trainer's
    cost volume, except at ties of the decomposition's rounding."""
    net, m, img1, img2 = _setup(**SMALL)
    with torch.no_grad():
        idx = net.flow_batch(img1, img2)[0]
        costs = net.costs(img1, img2)
    mid = (SMALL["win"] // 2) * SMALL["win"] + SMALL["win"] // 2
    want = matching.wta_from_costs(costs, mid)
    got_c = costs.gather(-1, idx.long()[..., None])[..., 0]
    assert bool(((got_c - costs.amin(-1)) <= COST_TIE).all())
    assert (idx == want).float().mean().item() >= 0.99


def test_flow_batch_records_its_spans_and_counts_pairs(tmp_path):
    import json
    net, _, img1, img2 = _setup(**SMALL)
    before = timer.COUNTERS["v2.pairs"]
    with timer.capture_trace(str(tmp_path)) as started:
        with torch.no_grad():
            net.flow_batch(img1, img2)
    assert started
    assert timer.COUNTERS["v2.pairs"] - before == SMALL["pairs"]
    events = json.loads((tmp_path / timer.TRACE_FILE).read_text())
    ranges = {}
    for e in events["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            ranges.setdefault(e["name"], []).append(
                (e["ts"], e["ts"] + e["dur"]))
    stages = [ranges[n] for n in ("v2.norm", "v2.trunk", "v2.match")]
    assert all(len(s) == 1 for s in stages)
    assert all(x[0][1] <= y[0][0] for x, y in zip(stages, stages[1:]))


def test_cpu_route_runs_the_twin_and_launches_nothing(monkeypatch):
    net, _, img1, img2 = _setup(**SMALL)
    calls = []
    plain = matching.match_flow_fast_plain

    def counted(*args, **kwargs):
        calls.append(tuple(args[0].shape))
        return plain(*args, **kwargs)
    monkeypatch.setattr(matching, "match_flow_fast_plain", counted)
    n0 = matching.match_flow_fast.launches
    with torch.no_grad():
        net.flow_batch(img1, img2)
    assert calls == [(SMALL["pairs"], 12, 20, 8)]
    assert matching.match_flow_fast.launches == n0
