"""PyTorch port vs the JAX package: the trained-model precision table
(``depth_estimation_tpu_torch.quality``, the counterpart of the precision
rows of ``examples/quality_dossier.py``), its warp sequence, and the
multiscale checkpoint the port's trainer made
(``examples/torch_multiscale_model``), which both packages load. The JAX
rows are built here from the JAX package's functions, the Pallas kernels
in interpret mode."""

import dataclasses
import functools
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu import codecs as jcodecs
from depth_estimation_tpu.models import flow as jflow
from depth_estimation_tpu.models import io as jio
from depth_estimation_tpu.models import multiscale as jms
from depth_estimation_tpu.ops import matching as jmatching
from depth_estimation_tpu_torch import quality
from depth_estimation_tpu_torch.models import io as tio
from torch_parity import one_torch_thread  # noqa: F401  (autouse fixture)

REPO = os.path.join(os.path.dirname(__file__), "..")
MS_MODEL = os.path.join(REPO, "examples", "torch_multiscale_model")
CAR_MODEL = os.path.join(REPO, "examples", "car_model")
# the single-scale crop (rows, columns of the 180x320 pair) and the
# multiscale crop (a multiple of the coarsest ratio, 4)
CROP = (slice(40, 104), slice(100, 196))
MS_CROP = (slice(32, 96), slice(64, 160))


@pytest.fixture(scope="module")
def pairs(tmp_path_factory):
    root, flow = quality.make_warp_sequence(
        str(tmp_path_factory.mktemp("seq")), n=8)
    return {"car_pair": quality.car_pair(),
            "seq_pair": (quality.read_frame(root, 6),
                         quality.read_frame(root, 7)),
            "root": root, "flow": flow}


def test_make_warp_sequence_shifts_each_frame_by_its_shift(pairs):
    """Frame k+1 is frame k moved by SHIFTS[k] (img_k[y, x] ==
    img_k+1[y + dy, x + dx]) on the interior, and the returned flow is the
    last pair's shift."""
    root = pairs["root"]
    frames = [quality.read_frame(root, k) for k in range(8)]
    assert frames[0].shape == (180, 320, 3) and frames[0].dtype == np.float32
    for k, (dy, dx) in enumerate(quality.SHIFTS):
        a, b = frames[k], frames[k + 1]
        ys = slice(max(0, -dy), 180 - max(0, dy))
        xs = slice(max(0, -dx), 320 - max(0, dx))
        yd = slice(ys.start + dy, ys.stop + dy)
        xd = slice(xs.start + dx, xs.stop + dx)
        np.testing.assert_array_equal(a[ys, xs], b[yd, xd])
        assert not np.array_equal(a, b)
    assert pairs["flow"].shape == (2, 180, 320)
    assert (pairs["flow"][0] == quality.SHIFTS[-1][0]).all()
    assert (pairs["flow"][1] == quality.SHIFTS[-1][1]).all()


def test_dossier_calibration_is_registered():
    from depth_estimation_tpu_torch.geometry3d import calibration as calmod
    quality._register_dossier_cal()
    quality._register_dossier_cal()
    cal = calmod.PRESETS["dossier320x180"]
    assert (cal.wImg, cal.hImg, cal.cx, cal.cy) == (320, 180, 160.0, 90.0)


def test_committed_checkpoint_loads_in_both_packages():
    """The trained multiscale checkpoint is version 9 in the JAX layout:
    both packages' load_model read the same geometry and weights, at the
    dossier's multiscale settings, with its 400-epoch history."""
    jg, jl, jp, jmeta = jio.load_model(MS_MODEL)
    tg, tl, tp, tmeta = tio.load_model(MS_MODEL)
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    assert jg.multiscale and jg.share_filters and jg.ratios == (1, 2, 4)
    assert jg.layers == ((3, 5, 5, 10),) and (jg.maxh, jg.maxw) == (4, 4)
    assert (jl.rate, jl.batch_size) == (0.02, 32)
    assert len(jmeta["score"]) == 400 == len(tmeta["score"])
    flat_j = jax_leaves(jp)
    flat_t = jax_leaves(tp)
    assert flat_j.keys() == flat_t.keys()
    for k in flat_j:
        np.testing.assert_array_equal(flat_j[k], flat_t[k])


def jax_leaves(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        if isinstance(v, dict):
            out.update(jax_leaves(v, f"{prefix}{k}/"))
        else:
            out[prefix + k] = np.asarray(v)
    return out


def _ms_geometry(geom, img):
    return dataclasses.replace(geom, hImg=img.shape[0], wImg=img.shape[1])


def _jax_ms_decode(geom, params, img1, img2, dtype):
    m = jms.MultiscaleFlowModel(geom, decode_dtype=dtype)
    idx, _ = m.decode_full(params, jnp.asarray(img1), jnp.asarray(img2))
    wy, wx = jcodecs.decode(geom, idx)
    return np.asarray(idx), np.stack([np.asarray(wy, np.float32),
                                      np.asarray(wx, np.float32)])


@pytest.mark.parametrize("pair", ["car_pair", "seq_pair"])
def test_multiscale_checkpoint_decode_and_deltas_match_jax(pairs, pair):
    """decode_full of the committed checkpoint in f32, port vs JAX, on a
    crop: equal WTA indices except at ties (where the two best fused
    scores are within float rounding); and the staged decode's bf16 and
    f16 deltas against f32 agree within 0.01 px mean."""
    geom, _, params, _ = tio.load_model(MS_MODEL)
    a, b = (np.ascontiguousarray(x[MS_CROP]) for x in pairs[pair])
    g = _ms_geometry(geom, a)
    jg = _ms_geometry(jio.load_model(MS_MODEL)[0], a)
    jparams = jio.load_model(MS_MODEL)[2]
    ours = quality.multiscale_bf16_delta(g, params, a, b, device="cpu")
    j_idx32, j_fl32 = _jax_ms_decode(jg, jparams, a, b, None)
    t_model = quality._multiscale_model(g, params, None, "cpu")
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    t_idx32 = t_model.decode_full(ta, tb)[0].numpy()
    # where the indices part, both cells hold the pixel's best fused score
    # to float rounding (the flat regions of the upscaled source image)
    dist = t_model.forward_full(ta, tb).detach().numpy()
    ys, xs = np.nonzero(t_idx32 != j_idx32)
    assert len(ys) <= 0.01 * t_idx32.size
    for y, x in zip(ys, xs):
        top = dist[y, x].max()
        for i in (t_idx32[y, x], j_idx32[y, x]):
            assert top - dist[y, x, i] <= 1e-6 * top, (y, x)
    for name, dt in (("multiscale_staged_bf16", jnp.bfloat16),
                     ("multiscale_staged_f16", jnp.float16)):
        idx, fl = _jax_ms_decode(jg, jparams, a, b, dt)
        d = np.sqrt(((fl - j_fl32) ** 2).sum(0))
        assert abs(ours[name]["mean_epe_delta_px"] - d.mean()) <= 0.01, name
        assert abs(ours[name]["wta_agreement"]
                   - (idx == j_idx32).mean()) <= 0.01, name
        assert ours[name]["finite"]


def _jax_epe_rows(geom, params, img1, img2):
    """The precision rows of ``quality.EPE_ROWS`` from the JAX package's
    functions. B1 and B2 have one contract, and at a 16x16 window their
    Pallas kernels take minutes a call in interpret mode, so both go
    through the JAX package's plain reference of that contract (the
    storage-typed ``match_ssd``, its softmax and ``soft_argmax``), jitted;
    the kernels' interpret-mode parity, f16 included, is held at small
    windows in test_torch_matching.py."""
    import jax
    model = jflow.FlowModel(geom)

    def feats(dtype):
        a = model.features(params, jnp.asarray(img1, dtype))
        b = model.features(params, jnp.asarray(img2, dtype))
        return jflow.crop_features_center(geom, a), b

    @functools.partial(jax.jit, static_argnums=2)
    def flow_of(f1, f2, dtype):
        costs = jmatching.match_ssd(f1, f2, geom.maxh, geom.maxw, dtype)
        ey, ex = jflow.soft_argmax(geom, jmatching.softmax_scores(costs))
        return jnp.stack([ey, ex])

    f32, bf = feats(jnp.float32), feats(jnp.bfloat16)
    jdt = {torch.float32: jnp.float32, torch.bfloat16: jnp.bfloat16,
           torch.float16: jnp.float16}
    ref = np.asarray(flow_of(*f32, jnp.float32))
    rows = {}
    for name, _, dtype, trunk_bf16 in quality.EPE_ROWS:
        fl = np.asarray(flow_of(*(bf if trunk_bf16 else f32), jdt[dtype]))
        rows[name] = float(np.sqrt(((fl - ref) ** 2).sum(0)).mean())
    return rows


def test_epe_rows_on_car_model_match_jax(pairs):
    """quality.bf16_epe_deltas on car_model, on a crop of the car pair,
    against the same rows built from the JAX package: the f32 row equal
    (to float rounding), every other within 0.01 px mean."""
    geom, _, params, _ = tio.load_model(CAR_MODEL)
    jparams = jio.load_model(CAR_MODEL)[2]
    a, b = (np.ascontiguousarray(x[CROP]) for x in pairs["car_pair"])
    ours = quality.bf16_epe_deltas(geom, params, a, b, device="cpu")
    ref = _jax_epe_rows(jio.load_model(CAR_MODEL)[0], jparams, a, b)
    assert set(ours) == set(ref) == {r[0] for r in quality.EPE_ROWS}
    assert abs(ours["fast_f32"]["mean_epe_delta_px"] - ref["fast_f32"]) <= 1e-5
    for name, want in ref.items():
        assert abs(ours[name]["mean_epe_delta_px"] - want) <= 0.01, (
            name, ours[name], want)
        assert ours[name]["finite"]


def test_full_image_scores_match_jax(pairs):
    """full_image_scores of car_model on a crop of the held-out pair
    against the analytic flow and a second field: the port's full-frame
    decode ('max' head) scored as the JAX package's process_output and
    eval_flow score it."""
    from depth_estimation_tpu.training import score as jscore
    geom, _, params, _ = tio.load_model(CAR_MODEL)
    jg, _, jparams, _ = jio.load_model(CAR_MODEL)
    a, b = (np.ascontiguousarray(x[CROP]) for x in pairs["seq_pair"])
    g = dataclasses.replace(geom, hImg=a.shape[0], wImg=a.shape[1])
    jg = dataclasses.replace(jg, hImg=a.shape[0], wImg=a.shape[1])
    truth = np.ascontiguousarray(pairs["flow"][:, CROP[0], CROP[1]])
    gts = {"analytic": truth, "shifted": truth + 1, "none": None}
    model = quality._flow_model(g, params, "cpu")
    ours, full = quality.full_image_scores(model, g, a, b, gts)
    dist = jflow.FlowModel(jg).scores(jparams, jnp.asarray(a), jnp.asarray(b))
    jfull = np.asarray(jflow.process_output(jg, dist, process_full=True).full)
    assert full.shape == jfull.shape == (2,) + a.shape[:2]
    assert (full != jfull).any(axis=0).mean() <= 1e-3
    assert set(ours) == {"analytic", "shifted"}
    for name in ours:
        s = jscore.eval_flow(jg, jfull, gts[name])
        assert abs(ours[name]["full_acc"] - s.accuracy) <= 1e-3, name
        assert abs(ours[name]["meanDst"] - s.mean_dst) <= 1e-2, name


def test_quality_main_writes_the_table_on_the_cpu(tmp_path, monkeypatch):
    """``python -m depth_estimation_tpu_torch.quality --out DIR --device
    cpu``: every row on both pairs, the device line, the committed
    checkpoint's scores; the bf16 and f16 matcher rows within the 0.1 px
    budget; nothing written outside DIR."""
    rc = quality.main(["--out", str(tmp_path), "--device", "cpu"])
    assert rc == 0
    table = json.load(open(tmp_path / "precision_table.json"))
    assert table["device"] == "cpu"
    for key in ("bf16_deltas_car_pair", "bf16_deltas_seq_pair"):
        rows = table[key]
        assert set(rows) == ({r[0] for r in quality.EPE_ROWS}
                             | {"multiscale_staged_bf16",
                                "multiscale_staged_f16"})
        for name in ("fused_bf16", "fused_f16", "fast_bf16", "fast_f16"):
            assert rows[name]["mean_epe_delta_px"] <= 0.1, (key, name)
        assert all(r["finite"] for r in rows.values())
    s = table["multiscale_scores"]
    assert s["epochs"] == 400 and 0 < s["full_acc_analytic"] <= 1
