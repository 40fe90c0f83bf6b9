"""The program's own spans (``utils/timer.SPANS``): each is opened where the
table says and nowhere else, under no name the benchmark's wrappers use;
under a profiler an online step and a staged multiscale decode record
every one, nested as declared, as do a liu solve, a radial estimator
step (whose ego-motion opens the ``ego.*`` spans again, inside
``radial.ego``) and the version2 net's batched flow; without a profiler, and while torch.export traces, a span
enters no ``record_function``."""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch import api_batched, api_radial
from depth_estimation_tpu_torch.flow import celiu
from depth_estimation_tpu_torch.geometry import Geometry
from depth_estimation_tpu_torch.geometry3d import calibration
from depth_estimation_tpu_torch.models import multiscale, radial, version2
from depth_estimation_tpu_torch.utils import timer

PACKAGE = Path(api_batched.__file__).resolve().parent
# the range names the benchmark's wrappers and its trace reduction use
# (h100bench/paths/*.py, h100bench/trace.STEP): a program span under one of
# them would be counted as the wrapper's
RESERVED = {"step", "api", "ego", "trunk", "match", "pyramid", "decode",
            "match_ssd", "solve", "sor"}
# each span's module, and the program spans it lies inside (ego-motion's
# in the online step's and in the radial step's)
EGO = ("online.ego", "radial.ego")
WHERE = {"online.prep": ("api_batched.py", None),
         "online.ego": ("api_batched.py", None),
         "online.flow": ("api_batched.py", None),
         "ego.corners": ("geometry3d/egomotion.py", EGO),
         "ego.lk": ("geometry3d/egomotion.py", EGO),
         "ego.qr": ("geometry3d/egomotion.py", EGO),
         "ego.score": ("geometry3d/egomotion.py", EGO),
         "ego.pose": ("geometry3d/egomotion.py", EGO),
         "decode.cost": ("models/multiscale.py", None),
         "decode.select": ("models/multiscale.py", None),
         "liu.pyramid": ("flow/celiu.py", None),
         "liu.irls": ("flow/celiu.py", None),
         "liu.sor": ("flow/celiu.py", None),
         "liu.warp": ("flow/celiu.py", None),
         "radial.ego": ("api_radial.py", None),
         "radial.polar": ("api_radial.py", None),
         "radial.net": ("models/radial.py", None),
         "radial.depth": ("api_radial.py", None),
         "v2.norm": ("models/version2.py", None),
         "v2.trunk": ("models/version2.py", None),
         "v2.match": ("models/version2.py", None)}
# the liu solve below: 3 levels of 1 + k outer steps (k = 0, 1, 2)
LIU_KW = dict(alpha=0.005, ratio=0.75, min_width=13, n_outer=1, n_inner=1,
              n_sor=2)
LIU_LEVELS, LIU_STEPS = 3, 6
# instances a step (the online program, the radial estimator: ego-motion
# once in each) or a call (the decode, the liu solve: the pyramids then a
# level's features; an outer step's IRLS, SOR and warp; the upsampling
# between levels and the final warp)
OPENS = dict.fromkeys(WHERE, 1) | {
    "ego.corners": 2, "ego.lk": 2, "ego.qr": 2, "ego.score": 4,
    "ego.pose": 2, "liu.pyramid": 1 + LIU_LEVELS, "liu.irls": LIU_STEPS,
    "liu.sor": LIU_STEPS, "liu.warp": LIU_STEPS + LIU_LEVELS}
NAMES = [s.name for s in timer.SPANS]


def _opened_in_the_package():
    """(module path, name) of every ``profiled_span("<name>")`` call; a
    call whose name is not a literal fails the scan."""
    for path in sorted(PACKAGE.rglob("*.py")):
        text = path.read_text()
        names = re.findall(r'profiled_span\("([^"]+)"\)', text)
        calls = len(re.findall(r"(?<!def )profiled_span\(", text))
        assert calls == len(names), path
        yield from ((str(path.relative_to(PACKAGE)), n) for n in names)


def test_every_span_is_declared_once_and_opened_where_declared():
    assert len(NAMES) == len(set(NAMES)) == len(WHERE)
    assert set(NAMES) == set(WHERE)
    assert not set(NAMES) & RESERVED
    assert all(s.layer and s.reader for s in timer.SPANS)
    opened = sorted(set(_opened_in_the_package()))
    assert opened == sorted((where, name)
                            for name, (where, _) in WHERE.items())


def _estimator():
    h, w = 48, 64
    g = Geometry(hImg=h, wImg=w, layers=((3, 5, 5, 8),), maxh=6, maxw=6)
    base = calibration.RECTIFIED_GOPRO_SMALL
    cal = dataclasses.replace(
        base, name="t", wImg=w, hImg=h, fx=60.0, fy=60.0, cx=w / 2,
        cy=h / 2, sfm=dataclasses.replace(base.sfm, max_points=48))
    est = api_batched.BatchedDepthEstimator(
        g, None, cal, compensation="decode", lk_iters=2, ransac_samples=8,
        device="cpu")
    gen = torch.Generator().manual_seed(3)
    tex = torch.rand((1, 3, h // 4, w // 4 + 2), generator=gen)
    tex = torch.nn.functional.interpolate(tex, (h, w + 8), mode="bilinear")
    frames = [tex[..., k:k + w].permute(0, 2, 3, 1).expand(2, h, w, 3)
              for k in range(2)]
    est.reset(frames[0])
    return est, frames[1]


def _decoder():
    g = Geometry(hImg=24, wImg=32, layers=((3, 5, 5, 6),), maxh=4, maxw=4,
                 multiscale=True, ratios=(1, 2))
    model = multiscale.MultiscaleFlowModel(g, device="cpu").init(
        torch.Generator().manual_seed(1))
    rng = np.random.RandomState(5)
    imgs = [torch.from_numpy(rng.rand(1, 24, 32, 3).astype(np.float32))
            for _ in range(2)]
    return model, imgs


def _radial():
    """A radial estimator on 48x64 frames of a forward step, reset on the
    first: polar 24x24, a one-layer trunk, hWin 3."""
    h, w = 48, 64
    base = calibration.RECTIFIED_GOPRO_SMALL
    cal = dataclasses.replace(
        base, name="t", wImg=w, hImg=h, fx=60.0, fy=60.0, cx=w / 2,
        cy=h / 2, sfm=dataclasses.replace(base.sfm, max_points=48))
    net = radial.RadialFlowNetwork(((3, 3, 3, 4),), 3, device="cpu").init(
        torch.Generator().manual_seed(2))
    est = api_radial.BatchedRadialEstimator(net, cal, 24, 24, device="cpu")
    gen = torch.Generator().manual_seed(4)
    tex = torch.rand((1, 3, h // 4, w // 4), generator=gen)
    frames = [torch.nn.functional.interpolate(
        tex, (h + 2 * k, w + 2 * k), mode="bilinear")[..., k:k + h, k:k + w]
        .permute(0, 2, 3, 1) for k in range(2)]
    est.reset(frames[0])
    return est, frames[1]


def _v2():
    """The version2 net at 24x32 with a 5x5 trunk of 4 features and a 5x5
    window, and one pair of random frames."""
    datap = version2.V2Params(wImg=32, hImg=24, layers=((3, 5, 5, 4),),
                              hWin=5, wWin=5)
    net = version2.V2Network(datap, device="cpu").init(
        torch.Generator().manual_seed(6))
    gen = torch.Generator().manual_seed(7)
    return net, [torch.rand((1, 24, 32, 3), generator=gen) for _ in range(2)]


def _liu_pair():
    gen = torch.Generator().manual_seed(9)
    base = torch.rand((1, 3, 8, 12), generator=gen)
    base = torch.nn.functional.interpolate(base, (24, 34), mode="bilinear")
    base = base.permute(0, 2, 3, 1)
    return base[:, :, :32], base[:, :, 2:]


@pytest.fixture(scope="module")
def programs():
    torch.manual_seed(0)
    return _estimator(), _decoder(), _liu_pair(), _radial(), _v2()


def _ranges(log_dir):
    events = json.loads((log_dir / timer.TRACE_FILE).read_text())
    out = {}
    for e in events["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (e["tid"], e["ts"], e["ts"] + e["dur"]))
    return out


def test_a_step_and_a_decode_record_every_span_nested(programs, tmp_path):
    (est, frames), (model, imgs), pair, (rest, rframes), (v2, vimgs) = \
        programs
    before = dict(timer.COUNTERS)
    with timer.capture_trace(str(tmp_path)) as started:
        est.next_frames(frames)
        model.decode_full_staged(*imgs)
        celiu.coarse2fine_flow_batched(*pair, **LIU_KW)
        rest.next_frames(rframes)
        v2.flow_batch(*vimgs)
    assert started
    for name, n in (("liu.levels", LIU_LEVELS), ("liu.irls_steps", LIU_STEPS),
                    ("v2.pairs", 1)):
        assert timer.COUNTERS[name] - before.get(name, 0) == n
    ranges = _ranges(tmp_path)
    for name, (_, parents) in WHERE.items():
        assert len(ranges.get(name, ())) == OPENS[name], name
        for tid, a, b in ranges[name]:
            if parents is not None:
                assert any(t == tid and pa <= a and b <= pb
                           for p in (parents if isinstance(parents, tuple)
                                     else (parents,))
                           for t, pa, pb in ranges[p]), (name, parents)
    # the online step's stages, the decode's and the radial step's follow
    # one another
    for stages in (("online.prep", "online.ego", "online.flow"),
                   ("decode.cost", "decode.select"),
                   ("radial.ego", "radial.polar", "radial.net",
                    "radial.depth"), ("v2.norm", "v2.trunk", "v2.match")):
        spans = [ranges[s][0] for s in stages]
        assert all(x[2] <= y[1] for x, y in zip(spans, spans[1:])), spans


def _no_range(*args, **kwargs):
    raise AssertionError("a span entered record_function")


def test_without_a_profiler_a_span_enters_no_range(programs, monkeypatch,
                                                   tmp_path):
    (est, frames), (model, imgs), pair, (rest, rframes), (v2, vimgs) = \
        programs
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    est.next_frames(frames)
    model.decode_full_staged(*imgs)
    celiu.coarse2fine_flow_batched(*pair, **LIU_KW)
    rest.next_frames(rframes)
    v2.flow_batch(*vimgs)
    # the patch is live: under a profiler the same span raises
    with timer.capture_trace(str(tmp_path)):
        with pytest.raises(AssertionError, match="record_function"):
            with timer.profiled_span("ego.qr"):
                pass
        # while torch.compile or torch.export traces, no range either
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
        with timer.profiled_span("ego.qr"):
            pass


def test_an_export_under_a_profiler_holds_no_profiler_node(programs,
                                                           tmp_path):
    _, (model, imgs), _, _, _ = programs

    class Decode(torch.nn.Module):
        def forward(self, a, b):
            return model.decode_full_staged(a, b)

    with timer.capture_trace(str(tmp_path)) as started:
        ep = torch.export.export(Decode(), tuple(imgs))
    assert started
    targets = [str(n.target) for n in ep.graph.nodes]
    assert not [t for t in targets if "profiler" in t or "record" in t]
    torch.testing.assert_close(ep.module()(*imgs),
                               model.decode_full_staged(*imgs))
