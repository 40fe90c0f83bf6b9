"""PyTorch port vs the JAX package: the save side of ``models/io.py`` —
``model_dir_name``, the msgpack writer, the reverse weight bridges and
``save_model`` / ``load_weights_into``. A checkpoint the port saves must
load in the JAX package with exactly equal parameters, and one the JAX
package saves must load in the port: both are held bit-equal, and the
writer's bytes equal ``flax.serialization.to_bytes``'s."""

import json
import os

import flax.serialization
import jax
import numpy as np
import pytest
import torch

from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.geometry import Learning as JLearning
from depth_estimation_tpu.models import flow as jflow
from depth_estimation_tpu.models import io as jio
from depth_estimation_tpu.models import multiscale as jms
from depth_estimation_tpu_torch.geometry import Geometry as TGeometry
from depth_estimation_tpu_torch.geometry import Learning as TLearning
from depth_estimation_tpu_torch.models import filters as tfilters
from depth_estimation_tpu_torch.models import flow as tflow
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.models import multiscale as tms

SINGLE = dict(hImg=48, wImg=56, layers=((3, 5, 5, 8), (8, 3, 3, 6)),
              maxh=6, maxw=6)
SPARSE = dict(hImg=48, wImg=56, layers=((3, 5, 5, 8), (4, 3, 3, 6)),
              maxh=6, maxw=6)
MULTI = dict(hImg=48, wImg=56, layers=((3, 3, 3, 6),), maxh=4, maxw=4,
             multiscale=True, ratios=(1, 2))
CASES = {
    "single": SINGLE,
    "sparse": SPARSE,
    "multi_shared": MULTI,
    "multi_unshared": dict(MULTI, share_filters=False),
    "multi_betas": dict(MULTI, cascad_trainable_weights=True),
    "multi_single_beta": dict(MULTI, ratios=(1, 2, 4), maxh=8, maxw=8,
                              cascad_trainable_weights=True, single_beta=True),
}
LEARNING = dict(rate=2e-2, rate_decay=1e-5, weight_decay=1e-4,
                criterion="soft", soft_targets=True, batch_size=64)


def port_model(tg, seed=0):
    cls = tms.MultiscaleFlowModel if tg.multiscale else tflow.FlowModel
    return cls(tg, device="cpu").init(torch.Generator().manual_seed(seed))


def jax_model(jg):
    return jms.MultiscaleFlowModel(jg) if jg.multiscale else jflow.FlowModel(jg)


def assert_equal_trees(a, b):
    assert (jax.tree_util.tree_structure(jax.tree.map(np.asarray, a))
            == jax.tree_util.tree_structure(jax.tree.map(np.asarray, b)))
    for x, y in zip(jax.tree.leaves(a), jax.tree.leaves(b)):
        assert np.asarray(x).dtype == np.asarray(y).dtype
        np.testing.assert_array_equal(np.asarray(x), np.asarray(y))


@pytest.mark.parametrize("case", list(CASES))
def test_model_dir_name_equals_jax(case):
    assert (tio.model_dir_name(TGeometry(**CASES[case]), TLearning(**LEARNING))
            == jio.model_dir_name(JGeometry(**CASES[case]),
                                  JLearning(**LEARNING)))


@pytest.mark.parametrize("case", list(CASES))
def test_port_checkpoint_loads_in_jax_exactly(case, tmp_path):
    tg, jg = TGeometry(**CASES[case]), JGeometry(**CASES[case])
    model = port_model(tg, seed=3)
    path = str(tmp_path / tio.model_dir_name(tg, TLearning(**LEARNING)))
    tio.save_model(path, tg, TLearning(**LEARNING), model,
                   score_history=[{"test_acc": 0.5}], epoch=2)
    g, lrn, params, meta = jio.load_model(path)
    assert g == jg and lrn == JLearning(**LEARNING)
    assert meta["epoch"] == 2 and meta["score"] == [{"test_acc": 0.5}]
    # the JAX template's structure, the port's values
    template = jax_model(jg).init(jax.random.PRNGKey(0))
    assert (jax.tree_util.tree_structure(params)
            == jax.tree_util.tree_structure(template))
    assert_equal_trees(params, tio.model_tree(model))
    # and the bytes are flax's own for that tree
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        assert f.read() == flax.serialization.to_bytes(tio.model_tree(model))


@pytest.mark.parametrize("case", list(CASES))
def test_jax_checkpoint_loads_in_the_port_exactly(case, tmp_path):
    tg, jg = TGeometry(**CASES[case]), JGeometry(**CASES[case])
    params = jax_model(jg).init(jax.random.PRNGKey(5))
    jio.save_model(str(tmp_path), jg, JLearning(**LEARNING), params, [], 4)
    g, lrn, tree, meta = tio.load_model(str(tmp_path))
    assert g == tg and lrn == TLearning(**LEARNING) and meta["epoch"] == 4
    model = tio.load_tree_into(port_model(tg), tree)
    assert_equal_trees(tio.model_tree(model), params)
    # load_weights_into a module and into a tree template
    other = tio.load_weights_into(str(tmp_path), port_model(tg, seed=9))
    assert_equal_trees(tio.model_tree(other), params)
    as_tree = tio.load_weights_into(str(tmp_path), tio.model_tree(other))
    assert_equal_trees(as_tree, params)


def test_checkpoint_round_trip_in_the_port(tmp_path):
    tg = TGeometry(**SINGLE)
    model = port_model(tg, seed=1)
    tio.save_model(str(tmp_path), tg, TLearning(), model)
    g, lrn, tree, meta = tio.load_model(str(tmp_path))
    assert (g, lrn, meta["score"], meta["epoch"]) == (tg, TLearning(), [], 0)
    trunk = tio.load_tree_into(tfilters.ConvFilter(tg), tree)
    x = torch.from_numpy(np.random.RandomState(0).rand(20, 24, 3)
                         .astype(np.float32))
    with torch.no_grad():
        np.testing.assert_array_equal(trunk(x).numpy(), model.features(x).numpy())
    meta_path = os.path.join(tmp_path, "meta.json")
    bad = json.load(open(meta_path))
    bad["version"] = 8
    json.dump(bad, open(meta_path, "w"))
    with pytest.raises(ValueError, match="version"):
        tio.load_model(str(tmp_path))


def test_load_weights_into_rejects_another_structure(tmp_path):
    tio.save_model(str(tmp_path), TGeometry(**SINGLE), TLearning(),
                   port_model(TGeometry(**SINGLE)))
    with pytest.raises(ValueError):
        tio.load_weights_into(str(tmp_path), port_model(TGeometry(**SPARSE)))
    with pytest.raises(ValueError):
        tio.load_weights_into(str(tmp_path), {"params": {}})


def test_packb_round_trips_and_equals_msgpack():
    import msgpack
    obj = {"a": [1, -1, -33, 200, -200, 70000, -70000, 2 ** 40, -2 ** 40],
           "b": 1.25, "c": None, "d": [True, False], "s": "x" * 40,
           "u": "ü" * 300, "bin": b"\x00\x01" * 200,
           "m": {str(i): i for i in range(20)},
           "arrays": [np.arange(n, dtype=np.float32) for n in (0, 1, 2, 4, 5)],
           "i8": np.array([[1, 2]], np.int8),
           "big": np.zeros((70, 300), np.float64)}
    ours = tio.packb(obj)
    ref = msgpack.packb(obj, default=flax.serialization._msgpack_ext_pack,
                        use_bin_type=True)
    assert ours == ref
    back = tio.unpackb(ours)
    assert back["a"] == obj["a"] and back["u"] == obj["u"]
    np.testing.assert_array_equal(back["big"], obj["big"])
    with pytest.raises(TypeError):
        tio.packb({"x": object()})
