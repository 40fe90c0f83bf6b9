"""PyTorch port vs the JAX package: the per-frame DepthEstimator (both
ego-motion resolutions), its packed and pipelined outputs, the pairs
pipeline and the fast-mode knobs."""

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu import api as japi
from depth_estimation_tpu_torch import api as tapi
from depth_estimation_tpu_torch import api_batched as tapi_b
from torch_parity import (calibrations, geometries, parallax_frames,
                          pipeline_case, ransac_noise, run_batched_both,
                          to_jax, trunk_params)

H, W, NPTS = 96, 128, 200
ATOL = 1e-3


@pytest.mark.parametrize("ego_resolution", ["working", "full"])
def test_depth_estimator_matches_jax(ego_resolution):
    """next_frame_depth over a two-step stream, on the same weights and
    RANSAC noise. 'full' feeds camera frames at twice the working size."""
    jg, tg = geometries(H, W, maxh=8, maxw=8)
    s = 2 if ego_resolution == "full" else 1
    jc, tc = calibrations(H * s, W * s, f=100.0 * s, max_points=NPTS)
    params = trunk_params(1)
    seq = parallax_frames(np.random.RandomState(4), H * s, W * s, n=3,
                          lo=s, hi=5 * s)
    ours = tapi.DepthEstimator(tg, params, tc, ego_resolution=ego_resolution,
                               ransac_noise=ransac_noise(64, NPTS),
                               device="cpu")
    ref = japi.DepthEstimator(jg, to_jax(params), jc,
                              ego_resolution=ego_resolution)
    ours.reset(seq[0])
    ref.reset(seq[0])
    for f in seq[1:]:
        small, xf, m = ours.next_frame_depth(f)
        jsmall, jxf, jm = ref.next_frame_depth(f)
        assert small.shape == (H, W, 3) and xf.shape == m.shape == (H, W)
        np.testing.assert_allclose(small, jsmall, atol=1e-5)
        assert ((m > 0) == (jm > 0)).mean() >= 0.999
        sel = (m > 0) & (jm > 0)
        assert sel.mean() > 0.3
        assert np.abs(xf - jxf)[sel].max() <= ATOL


def test_packed_and_pipelined_stream_follow_next_frame_depth():
    jg, tg = geometries(H, W, maxh=8, maxw=8)
    _, tc = calibrations(H, W, f=100.0, max_points=NPTS)
    params = trunk_params(1)
    seq = parallax_frames(np.random.RandomState(4), H, W, n=4)
    direct = tapi.DepthEstimator(tg, params, tc, device="cpu")
    direct.reset(seq[0])
    want = []
    for f in seq[1:]:
        _, xf, m = direct.next_frame_depth(f)
        want.append(np.stack([xf, m]).astype(np.float16))
    est = tapi.DepthEstimator(tg, params, tc, device="cpu")
    est.reset(seq[0])
    got = []
    with est.stream(lag=2, fetch_threads=2) as stream:
        for f in seq[1:]:
            out = stream.push(f)
            if out is not None:
                got.append(out)
        got.extend(stream.drain())
    assert len(got) == len(want)
    assert direct.timers.counts["frame"] == len(want)
    for g_, w_ in zip(got, want):
        assert g_.dtype == np.float16 and g_.shape == (2, H, W)
        np.testing.assert_array_equal(g_, w_)


def test_make_batched_pipeline_matches_jax():
    case = pipeline_case()
    frames = case["frames"]
    ours = tapi_b.make_batched_pipeline(case["tg"], case["tc"],
                                        compensation="warp_banded",
                                        ransac_noise=ransac_noise(64, NPTS),
                                        device="cpu")
    ref = japi.make_batched_pipeline(case["jg"], case["jc"],
                                     compensation="warp_banded")
    a = [x.numpy() for x in ours(case["params"], frames[0], frames[1])]
    b = [np.asarray(x) for x in ref(to_jax(case["params"]),
                                    jnp.asarray(frames[0]),
                                    jnp.asarray(frames[1]))]
    np.testing.assert_array_equal(a[3], b[3])
    assert ((a[1] > 0) == (b[1] > 0)).mean() >= 0.999
    sel = (a[1] > 0) & (b[1] > 0)
    assert sel.mean() > 0.3
    assert np.abs(a[0] - b[0])[sel].max() <= ATOL
    with pytest.raises(TypeError):
        tapi_b.make_batched_pipeline(case["tg"], case["tc"], not_a_knob=1,
                                     device="cpu")


FAST_KNOBS = dict(compensation="decode", match_dtype=torch.bfloat16,
                  warp_dtype=torch.bfloat16, state_dtype=torch.bfloat16,
                  ego_downsample=2, lk_iters=5, ransac_samples=48,
                  lk_search=24, corner_selector="topk", match_block="auto")


def _fast_mode_diffs(share_state):
    """Both packages in fast mode at 192x256 (ego-motion then sees 96x128,
    as in the other modes): per step, the checks every mode shares, and the
    x-flow differences where both masks are set."""
    for a, b in run_batched_both(pipeline_case(192, 256), share_state,
                                 **FAST_KNOBS):
        np.testing.assert_array_equal(a[3], b[3])
        assert ((a[1] > 0) == (b[1] > 0)).mean() >= 0.999
        sel = (a[1] > 0) & (b[1] > 0)
        assert sel.mean() > 0.3
        yield np.abs(a[0] - b[0])[sel]


def test_fast_mode_knobs_run_like_jax():
    """bench.py's fast-mode knobs (bf16 storage, ego-motion on a 2x
    downsampled frame, 5 LK iterations, 48 RANSAC samples, the 24 px LK
    window). Both packages compute gray levels and corner scores in bf16
    and pick the same corners. The trunk's f32 outputs differ by convolution
    order, and rounding them to bf16 puts about 1e-4 of the features one
    bf16 step apart: that leaves a sparse x-flow tail of a few 1e-3 px, so
    the program is held at ATOL on its 99th percentile and at 10 * ATOL at
    its worst pixel."""
    for d in _fast_mode_diffs(share_state=False):
        assert np.percentile(d, 99) <= ATOL and d.max() <= 10 * ATOL


def test_fast_mode_shared_state_matches_jax():
    """Fast mode with the port given the reference's bf16 state (frames and
    features) every step: ego-motion, matching and masks agree at ATOL on
    every masked pixel."""
    for d in _fast_mode_diffs(share_state=True):
        assert d.max() <= ATOL


F16_KNOBS = dict(match_dtype=torch.float16, warp_dtype=torch.float16,
                 state_dtype=torch.float16)
# B1's f16 reference writes each channel difference in the storage type,
# which the CPU backend rounds to f16 (it keeps bf16 differences in f32);
# the port's B1 subtracts the stored values in f32 (storage-only, as for
# bf16), so the soft-argmax parts by up to ~2e-3 px where the trained-scale
# costs are flat (see test_torch_matching.test_f16_twins_match_jax_interpret)
F16_MATCH_ATOL = 5e-3


def _f16_diffs(case, share_state, **knobs):
    for a, b in run_batched_both(case, share_state, **F16_KNOBS, **knobs):
        np.testing.assert_array_equal(a[3], b[3])
        assert ((a[1] > 0) == (b[1] > 0)).mean() >= 0.999
        sel = (a[1] > 0) & (b[1] > 0)
        assert sel.mean() > 0.3
        assert np.isfinite(a[0]).all()
        yield np.abs(a[0] - b[0])[sel]


@pytest.mark.parametrize("mode", ["warp", "fast"])
def test_f16_knobs_shared_state_match_jax(mode):
    """f16 storage for the state, the warp and the matcher, with the port
    given the reference's f16 state (frames and features) every step:
    ego-motion (gray levels and corner scores in f16, rounded where the
    reference rounds them), the f16 warp and B1 agree on every masked
    pixel within F16_MATCH_ATOL."""
    if mode == "warp":
        diffs = _f16_diffs(pipeline_case(), True, compensation="warp")
    else:
        knobs = {k: v for k, v in FAST_KNOBS.items() if not k.endswith("dtype")}
        diffs = _f16_diffs(pipeline_case(192, 256), True, **knobs)
    for d in diffs:
        assert d.max() <= F16_MATCH_ATOL


def test_f16_fast_mode_knobs_run_like_jax():
    """bench.py's fast-mode knobs with f16 storage, each package on its own
    prep: the trunk's f32 outputs differ by convolution order and rounding
    them to f16 puts ~7e-4 of the features one f16 step apart, so the
    program is held at 2 ATOL on its 99th percentile and 10 ATOL at its
    worst pixel (bf16's bounds, ATOL and 10 ATOL, plus B1's f16 term)."""
    knobs = {k: v for k, v in FAST_KNOBS.items() if not k.endswith("dtype")}
    for d in _f16_diffs(pipeline_case(192, 256), False, **knobs):
        assert np.percentile(d, 99) <= 2 * ATOL and d.max() <= 10 * ATOL


def test_entry_points_default_to_the_card_and_refuse_the_cpu(monkeypatch):
    """With no device named, every entry point asks for the card; where
    torch sees none (as here, or forced below) it raises instead of
    carrying on on the CPU."""
    from depth_estimation_tpu_torch.models import io as tio
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    case = pipeline_case()
    params = trunk_params(1)
    makers = [
        lambda: tapi.DepthEstimator(case["tg"], params, case["tc"]),
        lambda: tapi_b.BatchedDepthEstimator(case["tg"], params, case["tc"]),
        lambda: tapi_b.make_batched_pipeline(case["tg"], case["tc"]),
        lambda: tio.load_filter(os.path.join(os.path.dirname(__file__), "..",
                                             "examples", "car_model")),
    ]
    for make in makers:
        with pytest.raises(RuntimeError, match="cuda"):
            make()
    est = tapi_b.BatchedDepthEstimator(case["tg"], params, case["tc"],
                                       device="cpu")
    assert est.device.type == "cpu" and est.trunk.layer1.weight.device.type == "cpu"


def test_estimator_rejects_bad_knobs():
    case = pipeline_case()
    for bad in (dict(head="median"), dict(compensation="none"),
                dict(corner_selector="random"), dict(ego_downsample=3),
                dict(match_block=0)):
        with pytest.raises(ValueError):
            tapi_b.BatchedDepthEstimator(case["tg"], None, case["tc"],
                                         device="cpu", **bad)
    est = tapi_b.BatchedDepthEstimator(case["tg"], case["params"], case["tc"],
                                       device="cpu")
    with pytest.raises(RuntimeError):
        est.next_frames(case["frames"][1])
