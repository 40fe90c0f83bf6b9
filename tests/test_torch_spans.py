"""The program's own spans (``utils/timer.SPANS``): each is opened where the
table says and nowhere else, under no name the benchmark's wrappers use;
under a profiler an online step and a staged multiscale decode record
every one, nested as declared; without a profiler, and while torch.export
traces, a span enters no ``record_function``."""

import dataclasses
import json
import re
from pathlib import Path

import numpy as np
import pytest
import torch

from depth_estimation_tpu_torch import api_batched
from depth_estimation_tpu_torch.geometry import Geometry
from depth_estimation_tpu_torch.geometry3d import calibration
from depth_estimation_tpu_torch.models import multiscale
from depth_estimation_tpu_torch.utils import timer

PACKAGE = Path(api_batched.__file__).resolve().parent
# the range names the benchmark's wrappers and its trace reduction use
# (h100bench/paths/*.py, h100bench/trace.STEP): a program span under one of
# them would be counted as the wrapper's
RESERVED = {"step", "api", "ego", "trunk", "match", "pyramid", "decode",
            "match_ssd"}
# each span's module, and the program span it lies inside
WHERE = {"online.prep": ("api_batched.py", None),
         "online.ego": ("api_batched.py", None),
         "online.flow": ("api_batched.py", None),
         "ego.corners": ("geometry3d/egomotion.py", "online.ego"),
         "ego.lk": ("geometry3d/egomotion.py", "online.ego"),
         "ego.qr": ("geometry3d/egomotion.py", "online.ego"),
         "ego.score": ("geometry3d/egomotion.py", "online.ego"),
         "ego.pose": ("geometry3d/egomotion.py", "online.ego"),
         "decode.cost": ("models/multiscale.py", None),
         "decode.select": ("models/multiscale.py", None)}
# instances a step (the online program) or a call (the decode)
OPENS = dict.fromkeys(WHERE, 1) | {"ego.score": 2}
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


@pytest.fixture(scope="module")
def programs():
    torch.manual_seed(0)
    return _estimator(), _decoder()


def _ranges(log_dir):
    events = json.loads((log_dir / timer.TRACE_FILE).read_text())
    out = {}
    for e in events["traceEvents"]:
        if e.get("ph") == "X" and e.get("cat") == "user_annotation":
            out.setdefault(e["name"], []).append(
                (e["tid"], e["ts"], e["ts"] + e["dur"]))
    return out


def test_a_step_and_a_decode_record_every_span_nested(programs, tmp_path):
    (est, frames), (model, imgs) = programs
    with timer.capture_trace(str(tmp_path)) as started:
        est.next_frames(frames)
        model.decode_full_staged(*imgs)
    assert started
    ranges = _ranges(tmp_path)
    for name, (_, parent) in WHERE.items():
        assert len(ranges.get(name, ())) == OPENS[name], name
        for tid, a, b in ranges[name]:
            if parent is not None:
                assert any(t == tid and pa <= a and b <= pb
                           for t, pa, pb in ranges[parent]), (name, parent)
    # the online step's stages, and the decode's, follow one another
    for stages in (("online.prep", "online.ego", "online.flow"),
                   ("decode.cost", "decode.select")):
        spans = [ranges[s][0] for s in stages]
        assert all(x[2] <= y[1] for x, y in zip(spans, spans[1:])), spans


def _no_range(*args, **kwargs):
    raise AssertionError("a span entered record_function")


def test_without_a_profiler_a_span_enters_no_range(programs, monkeypatch,
                                                   tmp_path):
    (est, frames), (model, imgs) = programs
    monkeypatch.setattr(torch.profiler, "record_function", _no_range)
    est.next_frames(frames)
    model.decode_full_staged(*imgs)
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
    _, (model, imgs) = programs

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
