"""PyTorch port vs the JAX package: configuration, codecs, checkpoint
loading, the weights bridge and the conv trunk."""

import dataclasses
import json
import os
import shutil

import jax
import jax.numpy as jnp
import msgpack
import numpy as np
import pytest
import torch
from flax import serialization

from depth_estimation_tpu import codecs as jcodecs
from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.geometry3d import calibration as jcal
from depth_estimation_tpu.models import io as jio
from depth_estimation_tpu.models.flow import FlowModel
from depth_estimation_tpu_torch import codecs as tcodecs
from depth_estimation_tpu_torch.geometry import Geometry as TGeometry
from depth_estimation_tpu_torch.geometry3d import calibration as tcal
from depth_estimation_tpu_torch.models import filters as tfilters
from depth_estimation_tpu_torch.models import flow as tflow
from depth_estimation_tpu_torch.models import io as tio

CAR_MODEL = os.path.join(os.path.dirname(__file__), "..", "examples", "car_model")

GEOMETRY_KW = [
    dict(),
    dict(maxh=6, maxw=6, layers=((3, 5, 5, 8),)),
    dict(maxh=5, maxw=3, layers=((3, 5, 5, 8), (8, 12, 12, 10))),
    dict(maxh=7, maxw=9),
    dict(multiscale=True, ratios=(1, 2, 4), maxh=8, maxw=8),
    dict(multiscale=True, ratios=(1, 3), maxh=6, maxw=6),
]

PROPS = ("hKernel", "wKernel", "hPatch2", "wPatch2", "hPatch1", "wPatch1",
         "halfh1", "halfh2", "halfw1", "halfw2", "in_channels",
         "out_channels", "rmax")


@pytest.mark.parametrize("kw", GEOMETRY_KW)
def test_geometry_properties_match(kw):
    jg, tg = JGeometry(**kw), TGeometry(**kw)
    assert dataclasses.asdict(jg) == dataclasses.asdict(tg)
    for p in PROPS:
        assert getattr(jg, p) == getattr(tg, p), p


def test_calibration_presets_and_json_roundtrip(tmp_path):
    for name, tc in tcal.PRESETS.items():
        jc = jcal.PRESETS[name]
        assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
        np.testing.assert_array_equal(tc.K, jc.K)
    # port save -> port load and JAX load; JAX save -> port load
    tc = tcal.ARDRONE.scaled(0.5)
    tc.save(str(tmp_path / "t.cal"))
    assert tcal.Calibration.load(str(tmp_path / "t.cal")) == tc
    assert dataclasses.asdict(jcal.Calibration.load(str(tmp_path / "t.cal"))) \
        == dataclasses.asdict(tc)
    jcal.GOPRO.save(str(tmp_path / "j.cal"))
    assert dataclasses.asdict(tcal.Calibration.load(str(tmp_path / "j.cal"))) \
        == dataclasses.asdict(jcal.GOPRO)


@pytest.mark.parametrize("kw", GEOMETRY_KW)
def test_codecs_match(kw):
    jg, tg = JGeometry(**kw), TGeometry(**kw)
    assert tcodecs.middle_index(tg) == jcodecs.middle_index(jg)
    assert tcodecs.n_indices(tg) == jcodecs.n_indices(jg)
    np.testing.assert_array_equal(tcodecs.decode_lut(tg), jcodecs.decode_lut(jg))
    t_tab, t_y, t_x = tcodecs.encode_lut(tg)
    j_tab, j_y, j_x = jcodecs.encode_lut(jg)
    np.testing.assert_array_equal(t_tab, j_tab)
    assert (t_y, t_x) == (j_y, j_x)
    np.testing.assert_array_equal(tcodecs.window_offsets(tg).numpy(),
                                  np.asarray(jcodecs.window_offsets(jg)))
    rng = np.random.RandomState(0)
    flat = rng.randint(0, tcodecs.n_indices(tg), size=(5, 7)).astype(np.int32)
    for a, b in zip(tcodecs.decode(tg, torch.from_numpy(flat)),
                    jcodecs.decode(jg, jnp.asarray(flat))):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    span = tg.maxh * tg.rmax
    dy = rng.uniform(-span, span, size=(4, 6)).astype(np.float32)
    dx = rng.uniform(-span, span, size=(4, 6)).astype(np.float32)
    np.testing.assert_array_equal(
        tcodecs.encode(tg, torch.from_numpy(dy), torch.from_numpy(dx)).numpy(),
        np.asarray(jcodecs.encode(jg, jnp.asarray(dy), jnp.asarray(dx))))
    np.testing.assert_array_equal(tcodecs.encode_np(tg, dy, dx),
                                  jcodecs.encode_np(jg, dy, dx))
    if not tg.multiscale:
        for v in (0, 3, tg.maxh * tg.maxw - 1):
            assert tcodecs.x2yx(tg, v) == jcodecs.x2yx(jg, v)
            assert tcodecs.yx2x(tg, *tcodecs.x2yx(tg, v)) == v


def _assert_tree_equal(a, b):
    if isinstance(b, dict):
        assert set(a) == set(b)
        for k in b:
            _assert_tree_equal(a[k], b[k])
    else:
        np.testing.assert_array_equal(a, np.asarray(b))
        assert np.asarray(a).dtype == np.asarray(b).dtype


def test_msgpack_decoder_matches_msgpack():
    with open(os.path.join(CAR_MODEL, "params.msgpack"), "rb") as f:
        payload = f.read()
    ours = tio.unpackb(payload)
    _assert_tree_equal(ours, serialization.msgpack_restore(payload))
    # and a payload with the scalar types flax trees may carry
    obj = {"a": [1, -3, 2 ** 40, -2 ** 40, 1.5, None, True, False, "é" * 40,
                 b"\x00\x01"], "b": {str(i): i for i in range(20)}}
    assert tio.unpackb(msgpack.packb(obj, use_bin_type=True)) == obj


def test_load_model_matches_jax_and_rejects_other_versions(tmp_path):
    tg, tl, tparams, _ = tio.load_model(CAR_MODEL)
    jg, jl, jparams, _ = jio.load_model(CAR_MODEL)
    assert dataclasses.asdict(tg) == dataclasses.asdict(jg)
    assert dataclasses.asdict(tl) == dataclasses.asdict(jl)
    _assert_tree_equal(tparams, jparams)
    bad = tmp_path / "bad"
    shutil.copytree(CAR_MODEL, bad)
    meta = json.loads((bad / "meta.json").read_text())
    meta["version"] = 8
    (bad / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="version 8"):
        tio.load_model(str(bad))


def test_trunk_matches_jax_on_car_model():
    geom, trunk = tio.load_filter(CAR_MODEL, device="cpu")
    jg, _, jparams, _ = jio.load_model(CAR_MODEL)
    rng = np.random.RandomState(0)
    img = rng.rand(2, 180, 320, 3).astype(np.float32)
    with torch.no_grad():
        ours = trunk(torch.from_numpy(img)).numpy()
    ref = np.asarray(FlowModel(jg).features(jparams, jnp.asarray(img)))
    assert ours.shape == ref.shape == (2, 180 - 15, 320 - 15, 10)
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-4)
    # the crop of the reference branch
    np.testing.assert_array_equal(
        tflow.crop_features_center(geom, torch.from_numpy(ref.copy())).numpy(),
        ref[:, 7:165 - 8, 7:305 - 8])


@pytest.mark.parametrize("dt", ["bf16", "f16"])
def test_reduced_precision_trunk_matches_jax_on_car_model(dt):
    """The car_model trunk fed bf16 or f16 images computes in that type
    (the quality table's trunk-in-bf16 rows): each layer's sums rounded to
    it, then its bias added in it, as the reference's TrunkConv rounds.
    The two packages sum each output in another order, so a value may sit
    one step of the type apart: held at 2 steps of the output's scale, and
    the mean within a tenth of that."""
    geom, trunk = tio.load_filter(CAR_MODEL, device="cpu")
    jg, _, jparams, _ = jio.load_model(CAR_MODEL)
    jdt, tdt = {"bf16": (jnp.bfloat16, torch.bfloat16),
                "f16": (jnp.float16, torch.float16)}[dt]
    rng = np.random.RandomState(0)
    img = rng.rand(1, 60, 90, 3).astype(np.float32)
    with torch.no_grad():
        ours = trunk(torch.from_numpy(img).to(tdt))
    assert ours.dtype == tdt
    ours = ours.float().numpy()
    ref = np.asarray(FlowModel(jg).features(
        jparams, jnp.asarray(img, jdt)).astype(jnp.float32))
    step = np.abs(ref).max() * float(torch.finfo(tdt).eps)
    d = np.abs(ours - ref)
    assert d.max() <= 2 * step and d.mean() <= 0.2 * step, (d.max(), step)


def test_sparse_conv_map_matches_jax():
    """A layer whose nominal cin (4) differs from the previous cout (8) is
    a sparse random-connection conv; the bridge keeps its sparse kernel."""
    layers = ((3, 5, 5, 8), (4, 3, 3, 6))
    jg, tg = JGeometry(layers=layers, maxh=6, maxw=6), TGeometry(
        layers=layers, maxh=6, maxw=6)
    jparams = FlowModel(jg).init(jax.random.PRNGKey(3))
    npparams = jax.tree.map(np.asarray, jparams)
    assert npparams["params"]["layer2"]["kernel"].shape == (3, 3, 4, 6)
    trunk = tfilters.ConvFilter(tg)
    assert isinstance(trunk.layer2, tfilters.SparseConvMap)
    trunk.load_state_dict(tio.filter_state_from_jax(tg, npparams))
    rng = np.random.RandomState(1)
    img = rng.rand(2, 20, 24, 3).astype(np.float32)
    with torch.no_grad():
        ours = trunk(torch.from_numpy(img)).numpy()
    ref = np.asarray(FlowModel(jg).features(jparams, jnp.asarray(img)))
    np.testing.assert_allclose(ours, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_array_equal(
        tfilters.random_connection_table(8, 6, 4),
        trunk.layer2.table.numpy())


def test_forward_fused_matches_jax():
    """The flow model's fused forward on a frame pair: trunk, half-window
    crop of the reference branch, fused matcher (Pallas in interpret mode
    on the JAX side)."""
    layers = ((3, 5, 5, 8),)
    jg, tg = JGeometry(layers=layers, maxh=6, maxw=6), TGeometry(
        layers=layers, maxh=6, maxw=6)
    jparams = FlowModel(jg).init(jax.random.PRNGKey(4))
    trunk = tfilters.ConvFilter(tg)
    trunk.load_state_dict(tio.filter_state_from_jax(
        tg, jax.tree.map(np.asarray, jparams)))
    rng = np.random.RandomState(2)
    img1 = rng.rand(20, 28, 3).astype(np.float32)
    img2 = np.roll(img1, 1, axis=1)
    ours = tflow.FlowModel(tg, trunk).forward_fused(torch.from_numpy(img1),
                                                    torch.from_numpy(img2))
    ref = FlowModel(jg).forward_fused(jparams, jnp.asarray(img1),
                                      jnp.asarray(img2))
    assert ours[0].shape == (20 - 4 - 5, 28 - 4 - 5)
    np.testing.assert_array_equal(ours[0].numpy(), np.asarray(ref[0]))
    for a, b in zip(ours[1:], ref[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), rtol=0, atol=1e-5)


def test_identity_filter_features_are_patches():
    tg = TGeometry(layers=((1, 3, 3, 9),), maxh=4, maxw=4)
    trunk = tfilters.ConvFilter(tg)
    trunk.load_state_dict(tio.filter_state_from_jax(
        tg, tfilters.identity_filter_params(tg)))
    img = torch.arange(5 * 6, dtype=torch.float32).reshape(5, 6, 1)
    with torch.no_grad():
        f = trunk(img)
    np.testing.assert_array_equal(f[1, 2].numpy(),
                                  img[1:4, 2:5, 0].reshape(-1).numpy())
