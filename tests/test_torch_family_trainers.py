"""PyTorch port vs the JAX package: the radial, version2 and legacy depth
trainers (``training/families.py``) and their checkpoints
(``models/io.py``). The JAX package trains these families inside its CLIs;
each test rebuilds the CLI's step from the JAX package's public pieces
exactly as the CLI writes it (``log_scores``, ``sgd_torch``,
``optax.apply_updates``; ``softmax_cross_entropy_with_integer_labels``
for the legacy classifier), from the CLI's initial weights
(``PRNGKey(0)``) carried across, and holds the port to it.

Tolerances, float32 (the flow trainer's, tests/test_torch_training.py):
losses within relative 1e-5, accuracies equal, weights within absolute
1e-5 after 3 steps (XLA's and torch's convolution gradients sum in other
orders); the trees and the bytes the writers emit bit-equal to flax's.
The whole radial chain against the JAX CLI: the epipole parts by up to
~1e-2 px (RANSAC's essential matrix rounds apart in the two LAPACK
builds, ROADMAP C26), so the polar patches' pixels agree within 1e-2 and
their targets exactly; the epoch's weights within 1e-5 (5.8e-6 read), and
within 1e-6 when the port trains on the CLI's own patches.
"""

import dataclasses
import functools
import json
import os
import re

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from PIL import Image

from depth_estimation_tpu.cli import depth_estimation as jlegacy_cli
from depth_estimation_tpu.cli import train_radial as jradial_cli
from depth_estimation_tpu.data import datasets as jds
from depth_estimation_tpu.data import depth_legacy as jdl
from depth_estimation_tpu.flow.celiu import bilinear_sample, gaussian_smooth
from depth_estimation_tpu.geometry3d import calibration as jcal
from depth_estimation_tpu.models import legacy_depth as jlegacy
from depth_estimation_tpu.models import radial as jradial
from depth_estimation_tpu.models import version2 as jv2
from depth_estimation_tpu.training import train as jtrain
from depth_estimation_tpu_torch.data import datasets as tds
from depth_estimation_tpu_torch.data import depth_legacy as tdl
from depth_estimation_tpu_torch.geometry3d import calibration as tcal
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.models import legacy_depth as tlegacy
from depth_estimation_tpu_torch.models import radial as tradial
from depth_estimation_tpu_torch.models import version2 as tv2
from depth_estimation_tpu_torch.training import families
from torch_parity import calibrations, parallax_frames, ransac_noise

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOL_LOSS_REL = 1e-5
TOL_PARAM = 1e-5
RADIAL_LAYERS = ((3, 5, 5, 8), "tanh", (8, 3, 3, 6))
V2 = dict(wImg=128, hImg=96, normalization_k=5, layers=((3, 5, 5, 8),),
          hWin=6, wWin=6)


def np_tree(tree):
    return jax.tree.map(np.asarray, tree)


def assert_trees_close(ours, ref, atol):
    assert (jax.tree_util.tree_structure(np_tree(ours))
            == jax.tree_util.tree_structure(np_tree(ref)))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=atol)


def nll_step(log_scores, tx):
    """The radial and version2 CLIs' jitted step (train_radial.py,
    train_v2.py)."""
    def step(params, opt_state, b1, b2, bt):
        def loss_fn(prm):
            logp = jax.vmap(lambda a, b: log_scores(prm, a, b))(b1, b2)
            logp = logp.reshape(logp.shape[0], -1)
            ll = jnp.take_along_axis(logp, bt[:, None], axis=-1)[:, 0]
            acc = (jnp.argmax(logp, -1) == bt).mean()
            return -ll.mean(), acc
        (loss, acc), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, acc
    return jax.jit(step)


def run_nll_epoch(step, params, tx, corpus, bs, rng):
    """The CLIs' epoch: batches of rng.permutation(n), partial dropped."""
    opt_state = tx.init(params)
    n = (len(corpus[2]) // bs) * bs
    order = rng.permutation(n)
    losses, accs = [], []
    for b in range(0, n, bs):
        sel = order[b:b + bs]
        params, opt_state, loss, acc = step(params, opt_state,
                                            *(jnp.asarray(a[sel]) for a in corpus))
        losses.append(float(loss))
        accs.append(float(acc))
    return params, losses, accs


def assert_epoch_matches(m, params, losses, accs, model):
    np.testing.assert_allclose(m["losses"], losses, rtol=TOL_LOSS_REL)
    assert m["accs"] == accs
    assert_trees_close(tio.model_tree(model), params, TOL_PARAM)


# ---------------------------------------------------------------------------
# steps against the CLIs' step bodies
# ---------------------------------------------------------------------------

def test_radial_trainer_steps_match_the_cli_step():
    h_win, bs = 5, 8
    net = jradial.RadialFlowNetwork(RADIAL_LAYERS, h_win)
    params = net.init(jax.random.PRNGKey(0))
    tr = families.RadialTrainer(RADIAL_LAYERS, h_win, 1e-2, 1e-5, bs,
                                device="cpu")
    tio.load_tree_into(tr.model, np_tree(params))
    h_patch, w_patch = tr.patch_shape
    assert (h_patch, w_patch) == (net.h_kernel + h_win - 1, net.w_kernel)
    rng = np.random.RandomState(0)
    corpus = (rng.rand(3 * bs + 5, h_patch, w_patch, 3).astype(np.float32),
              rng.rand(3 * bs + 5, h_patch, w_patch, 3).astype(np.float32),
              rng.randint(0, h_win, 3 * bs + 5).astype(np.int32))
    tx = jtrain.sgd_torch(1e-2, 1e-5)
    ref = run_nll_epoch(nll_step(net.log_scores, tx), params, tx, corpus, bs,
                        np.random.RandomState(3))
    m = tr.epoch(corpus, np.random.RandomState(3))
    assert len(m["losses"]) == 3 and tr.optimizer.count == 3
    assert_epoch_matches(m, *ref, tr.model)


def test_v2_trainer_steps_match_the_cli_step():
    bs = 8
    jnet = jv2.V2Network(jv2.V2Params(**V2))
    params = jnet.init(jax.random.PRNGKey(0))
    tr = families.V2Trainer(tv2.V2Params(**V2), 1e-2, bs, device="cpu")
    tio.load_tree_into(tr.model, np_tree(params))
    g = tr.model.geometry
    rng = np.random.RandomState(1)
    shape = (3 * bs, g.hPatch2, g.wPatch2, 3)
    corpus = (rng.rand(*shape).astype(np.float32),
              rng.rand(*shape).astype(np.float32),
              rng.randint(0, g.maxh * g.maxw, 3 * bs).astype(np.int32))
    tx = jtrain.sgd_torch(1e-2)
    ref = run_nll_epoch(nll_step(jnet.log_scores, tx), params, tx, corpus, bs,
                        np.random.RandomState(4))
    m = tr.epoch(corpus, np.random.RandomState(4))
    assert_epoch_matches(m, *ref, tr.model)


@functools.lru_cache(maxsize=None)
def legacy_init():
    """The CLI's initial weights (PRNGKey(0) on a (1, 32, 32, 2) input),
    jitted: flax's eager init compiles op by op (~15 s on a CPU)."""
    model = jlegacy.DepthClassifierCNN(n_classes=2)
    return jax.jit(model.init)(jax.random.PRNGKey(0),
                               jnp.zeros((1, 32, 32, 2), jnp.float32))


@pytest.fixture(scope="module")
def legacy_jax():
    """cli/depth_estimation.py's model, optimizer, jitted step and jitted
    inference (2 classes; compiled once for the module)."""
    model = jlegacy.DepthClassifierCNN(n_classes=2)
    tx = jtrain.sgd_torch(1e-2, 5e-7)

    @jax.jit
    def step(params, opt_state, patches, classes0):
        def loss_fn(p):
            logits = model.apply(p, patches)[:, 0, 0, :]
            ll = optax.softmax_cross_entropy_with_integer_labels(logits,
                                                                 classes0)
            return ll.mean(), jnp.argmax(logits, -1)
        (loss, pred), grads = jax.value_and_grad(loss_fn, has_aux=True)(params)
        updates, opt_state = tx.update(grads, opt_state, params)
        return optax.apply_updates(params, updates), opt_state, loss, pred

    infer = jax.jit(lambda p, x: jnp.argmax(model.apply(p, x)[:, 0, 0, :], -1))
    return model, tx, step, infer


def test_depth_classifier_steps_match_the_cli_step(legacy_jax):
    _, tx, step, _ = legacy_jax
    params = legacy_init()
    tr = families.DepthClassifierTrainer(2, device="cpu")
    tio.load_tree_into(tr.model, np_tree(params))
    rng = np.random.RandomState(2)
    opt_state = tx.init(params)
    for _ in range(3):
        x = rng.rand(16, 32, 32, 2).astype(np.float32)
        c = rng.randint(0, 2, 16).astype(np.int32)
        params, opt_state, jloss, jpred = step(params, opt_state,
                                               jnp.asarray(x), jnp.asarray(c))
        loss, pred = tr.step(torch.from_numpy(x), torch.from_numpy(c))
        np.testing.assert_allclose(loss.item(), float(jloss), rtol=TOL_LOSS_REL)
        np.testing.assert_array_equal(pred.numpy(), np.asarray(jpred))
    assert_trees_close(tio.model_tree(tr.model), params, TOL_PARAM)


# ---------------------------------------------------------------------------
# trees, bridges and checkpoints
# ---------------------------------------------------------------------------

def test_family_trees_round_trip_bit_equal():
    """model_tree of each family is the flax init tree it was loaded from,
    and packb writes the bytes flax writes for it."""
    cases = [
        (tradial.RadialFlowNetwork(RADIAL_LAYERS, 5, device="cpu"),
         jradial.RadialFlowNetwork(RADIAL_LAYERS, 5).init(
             jax.random.PRNGKey(1))),
        (tv2.V2Network(tv2.V2Params(**V2), device="cpu"),
         jv2.V2Network(jv2.V2Params(**V2)).init(jax.random.PRNGKey(1))),
        (tlegacy.DepthClassifierCNN(2, device="cpu"), legacy_init()),
        (tlegacy.LegacyFlowModel(8, 8, 5, 4, device="cpu"),
         jlegacy.LegacyFlowModel(8, 8, 5, 4).init(jax.random.PRNGKey(1))),
    ]
    for model, params in cases:
        tio.load_tree_into(model, np_tree(params))
        tree = tio.model_tree(model)
        assert_trees_close(tree, params, 0)
        assert tio.packb(tree) == flax.serialization.to_bytes(tree)


def test_radial_checkpoint_loads_in_jax_and_back(tmp_path):
    net = jradial.RadialFlowNetwork(RADIAL_LAYERS, 5)
    template = net.init(jax.random.PRNGKey(0))
    model = tradial.RadialFlowNetwork(RADIAL_LAYERS, 5, device="cpu").init(
        torch.Generator().manual_seed(3))
    path = tio.save_radial_checkpoint(str(tmp_path), model, 2)
    assert os.path.basename(path) == "e2.msgpack"
    with open(path, "rb") as f:
        loaded = flax.serialization.from_bytes(template, f.read())
    assert_trees_close(loaded, tio.model_tree(model), 0)
    meta = json.load(open(tmp_path / "meta.json"))
    # the spec's 'tanh' stays a string, so a reader rebuilds the net
    # (the JAX CLI writes it as ['t', 'a', 'n', 'h']; ROADMAP C25)
    assert meta == {"version": 1, "hWin": 5,
                    "layers": [[3, 5, 5, 8], "tanh", [8, 3, 3, 6]]}
    back = tradial.RadialFlowNetwork(
        [l if isinstance(l, str) else tuple(l) for l in meta["layers"]],
        meta["hWin"], device="cpu")
    tio.load_weights_into(path, back)
    assert_trees_close(tio.model_tree(back), tio.model_tree(model), 0)


def test_v2_checkpoint_loads_in_jax_and_back(tmp_path):
    datap = jv2.V2Params(**V2)
    template = jv2.V2Network(datap).init(jax.random.PRNGKey(0))
    tr = families.V2Trainer(tv2.V2Params(**V2), device="cpu").init(
        torch.Generator().manual_seed(5))
    path = tr._save(str(tmp_path / "ours"), 0)
    assert os.path.basename(path) == "e0"
    with open(path, "rb") as f:
        loaded = flax.serialization.from_bytes(template, f.read())
    assert_trees_close(loaded, tio.model_tree(tr.model), 0)
    meta = json.load(open(tmp_path / "ours" / "meta.json"))
    assert meta == {"version": 1, "family": "version2", "wImg": 128,
                    "hImg": 96, "normalization_k": 5,
                    "layers": [[3, 5, 5, 8]], "hWin": 6, "wWin": 6}
    # a JAX-written payload into the port
    theirs = tmp_path / "e7"
    theirs.write_bytes(flax.serialization.to_bytes(template))
    model = tv2.V2Network(tv2.V2Params(**V2), device="cpu")
    tio.load_weights_into(str(theirs), model)
    assert_trees_close(tio.model_tree(model), template, 0)


# ---------------------------------------------------------------------------
# the legacy chain, rebuilt from the JAX package's public functions
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def legacy_root(tmp_path_factory):
    """tests/test_cli.py's legacy scene: the left half textured and near
    (depth 4), the right half flat and far (depth 40)."""
    h, w = 96, 128
    root = tmp_path_factory.mktemp("legacy")
    os.makedirs(root / "images")
    os.makedirs(root / "depths")
    rng = np.random.RandomState(0)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    stripes = 0.5 + 0.4 * np.sin(2 * np.pi * (xx + yy) / 4.0)
    for i in range(4):
        img = np.full((h, w), 0.5, np.float32)
        img[:, : w // 2] = stripes[:, : w // 2]
        img += rng.rand(h, w).astype(np.float32) * 0.05
        Image.fromarray((np.clip(img, 0, 1) * 255).astype(np.uint8)).save(
            root / "images" / f"{i:09d}.png")
        xs = rng.randint(0, w, 60).astype(np.float32)
        ys = rng.randint(0, h, 60).astype(np.float32)
        depth = np.where(xs < w // 2, 4.0, 40.0).astype(np.float32)
        np.savez(root / "depths" / f"{i:09d}.npz", x=xs, y=ys, depth=depth)
    return str(root)


def test_legacy_chain_matches_the_cli(legacy_root, legacy_jax, tmp_path):
    """2 epochs of cli/depth_estimation.py's training loop (n 160, m 32,
    B=16, 2 classes) against ``DepthClassifierTrainer``, then the
    checkpoint in both packages and the class map of frame 0."""
    model, tx, step, infer = legacy_jax
    frames, images = jlegacy_cli.load_depth_dataset(legacy_root, 3, 1, 96, 128)
    tframes, timages = tdl.load_depth_dataset(legacy_root, 3, 1, 96, 128)
    for a, b in zip(timages, images):
        np.testing.assert_array_equal(a, b)
    rng = np.random.RandomState(1)
    train_p, train_c, disc = jdl.generate_data_discrete(
        frames, images, 32, 32, 2, 160, rng)
    test_p, test_c, _ = jdl.generate_data_discrete(frames, images, 32, 32, 2,
                                                    32, rng)
    params = legacy_init()
    opt_state = tx.init(params)
    bs, n = 16, 160
    history = []
    for _ in range(2):
        order = np.arange(n)
        rng.shuffle(order)
        losses = []
        conf = np.zeros((2, 2), np.int64)
        for b in range(0, n, bs):
            sel = order[b:b + bs]
            params, opt_state, loss, pred = step(
                params, opt_state, jnp.asarray(train_p[sel]),
                jnp.asarray(train_c[sel] - 1))
            losses.append(float(loss))
            np.add.at(conf, (train_c[sel] - 1, np.asarray(pred)), 1)
        history.append(dict(losses=losses, conf=conf,
                            test_acc=float((np.asarray(infer(
                                params, jnp.asarray(test_p))) == test_c - 1)
                                .mean())))

    tr = families.DepthClassifierTrainer(2, bs, device="cpu")
    tio.load_tree_into(tr.model, np_tree(legacy_init()))
    trng = np.random.RandomState(1)
    sets = tr.make_datasets(tframes, timages, 160, 32, trng)
    for a, b in zip(sets, (train_p, train_c, test_p, test_c)):
        np.testing.assert_array_equal(a, b)
    assert (tr.discretizer.cut_depth, tr.discretizer.bin_step) == (
        disc.cut_depth, disc.bin_step)
    got = tr.fit(*sets, 2, trng)
    for m, h in zip(got, history):
        np.testing.assert_allclose(m["losses"], h["losses"], rtol=TOL_LOSS_REL)
        np.testing.assert_array_equal(m["confusion"], h["conf"])
        assert m["test_acc"] == h["test_acc"]
    assert_trees_close(tio.model_tree(tr.model), params, TOL_PARAM)
    assert got[-1]["test_acc"] > 0.5

    out = tr.save(str(tmp_path / "legacy_model"))
    with open(os.path.join(out, "params.msgpack"), "rb") as f:
        loaded = flax.serialization.from_bytes(legacy_init(), f.read())
    assert_trees_close(loaded, tio.model_tree(tr.model), 0)
    meta = json.load(open(os.path.join(out, "meta.json")))
    assert set(meta) == {"n_classes", "cut_depth", "bin_step", "patch",
                         "score"}
    assert meta["patch"] == 32 and len(meta["score"]) == 2
    back = families.DepthClassifierTrainer.load(out, device="cpu")
    assert_trees_close(tio.model_tree(back.model), tio.model_tree(tr.model), 0)
    assert back.discretizer == tr.discretizer
    # the JAX-trained weights, as the CLI writes them, into the port
    with open(os.path.join(out, "params.msgpack"), "wb") as f:
        f.write(flax.serialization.to_bytes(params))
    theirs = families.DepthClassifierTrainer.load(out, device="cpu")
    assert_trees_close(tio.model_tree(theirs.model), params, 0)

    ref_map = np.asarray(jnp.argmax(jax.jit(model.apply)(
        params, jnp.asarray(images[0][None]))[0], axis=-1))
    cmap = tr.class_map(timages[0])
    assert cmap.shape == ref_map.shape
    assert (cmap == ref_map).mean() >= 0.999
    z = np.load(tr.save_class_map(out, 0, timages[0]))
    np.testing.assert_array_equal(z["classes"], cmap)


@pytest.mark.parametrize("cut_depth", [None, 10.0, 3.0])
def test_legacy_datasets_and_cut_depth_match_the_cli(legacy_root, cut_depth):
    """make_datasets draws train then test from one RandomState, and -cd
    overrides the discretizer's cut and bin step as the CLI does."""
    frames, images = tdl.load_depth_dataset(legacy_root, 3, 1, 96, 128)
    rng = np.random.RandomState(1)
    train = jdl.generate_data_discrete(frames, images, 32, 32, 3, 40, rng)
    test = jdl.generate_data_discrete(frames, images, 32, 32, 3, 20, rng)
    disc = train[2]
    if cut_depth is not None:
        disc.cut_depth = cut_depth
        disc.bin_step = int(2 * disc.cut_depth / disc.n_classes) or 1
    tr = families.DepthClassifierTrainer(3, device="cpu")
    sets = tr.make_datasets(frames, images, 40, 20, np.random.RandomState(1),
                            cut_depth=cut_depth)
    for a, b in zip(sets, train[:2] + test[:2]):
        np.testing.assert_array_equal(a, b)
    assert (tr.discretizer.cut_depth, tr.discretizer.bin_step) == (
        disc.cut_depth, disc.bin_step)


# ---------------------------------------------------------------------------
# the whole radial slice against the JAX CLI
# ---------------------------------------------------------------------------

def radial_calibration(mod):
    """tests/test_cli.py's 'test128x160' preset."""
    sfm = dataclasses.replace(mod.RECTIFIED_GOPRO_SMALL.sfm, max_points=400,
                              points_quality=0.001)
    return dataclasses.replace(
        mod.RECTIFIED_GOPRO_SMALL, name="test128x160", wImg=160, hImg=128,
        fx=200.0, fy=200.0, cx=80.0, cy=64.0, sfm=sfm)


def write_forward_sequence(root):
    """tests/test_cli.py's radial scene: 3 frames of a forward step over
    two depth planes (zoom 1.05 on top, 1.10 below) at 128x160."""
    rng = np.random.RandomState(0)
    H, W = 128, 160
    base = np.asarray(gaussian_smooth(
        jnp.asarray(rng.rand(H, W, 3).astype(np.float32)), 0.8, 2))
    frame = np.clip(base * 1.5, 0, 1).astype(np.float32)
    yy, xx = np.mgrid[0:H, 0:W].astype(np.float32)
    s = np.where(yy < H / 2, 1.05, 1.10)
    xs = jnp.asarray(W / 2 + (xx - W / 2) / s)
    ys = jnp.asarray(H / 2 + (yy - H / 2) / s)
    d = os.path.join(root, "images")
    os.makedirs(d)
    for i in range(3):
        Image.fromarray((np.clip(frame, 0, 1) * 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:09d}.png"))
        frame = np.asarray(bilinear_sample(jnp.asarray(frame), xs, ys))


def test_radial_slice_matches_the_jax_cli(tmp_path, monkeypatch):
    seq = str(tmp_path / "seq")
    write_forward_sequence(seq)
    monkeypatch.setitem(jcal.PRESETS, "test128x160", radial_calibration(jcal))
    sampled, loaded = [], []

    def record(fn, into):
        def wrapped(*a, **k):
            into.append(fn(*a, **k))
            return into[-1]
        return wrapped
    monkeypatch.setattr(jds, "generate_polar_training_patches",
                        record(jds.generate_polar_training_patches, sampled))
    monkeypatch.setattr(jds, "load_polar_pairs_batched",
                        record(jds.load_polar_pairs_batched, loaded))
    rc = jradial_cli.main([
        "-rd", seq, "-cal", "test128x160", "-net", "[[3,5,5,8]]",
        "-hwin", "5", "-hi", "100", "-wi", "100", "-ni", "3", "-n", "64",
        "-e", "1", "-bs", "16", "-omd", str(tmp_path / "jax"), "--dp", "off"])
    assert rc == 0
    init = jradial.RadialFlowNetwork(((3, 5, 5, 8),), 5).init(
        jax.random.PRNGKey(0))
    ref_patches = [np.concatenate([s[k] for s in sampled if s])
                   for k in range(3)]

    tr = families.RadialTrainer(((3, 5, 5, 8),), 5, batch_size=16,
                                device="cpu")
    tio.load_tree_into(tr.model, np_tree(init))
    frames = families.read_frames(seq, 128, 160, 3)
    pairs = tr.load_pairs(radial_calibration(tcal), frames, 100, 100,
                          noise=ransac_noise(64, 400))
    assert len(pairs) == sum(p.good for p in loaded[0]) == 2
    rng = np.random.RandomState(0)
    corpus = tr.sample(pairs, 64, rng)
    np.testing.assert_array_equal(corpus[2], ref_patches[2])
    for a, b in zip(corpus[:2], ref_patches[:2]):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-2)
    hist = tr.fit(corpus, 1, rng, str(tmp_path / "port"))
    assert len(hist[0]["losses"]) == len(corpus[2]) // 16
    assert np.isfinite(hist[0]["losses"]).all()

    def weights(d):
        with open(os.path.join(d, "e0.msgpack"), "rb") as f:
            return flax.serialization.from_bytes(init, f.read())
    ref = weights(str(tmp_path / "jax"))
    assert_trees_close(weights(str(tmp_path / "port")), ref, TOL_PARAM)
    assert (json.load(open(tmp_path / "port" / "meta.json"))
            == json.load(open(tmp_path / "jax" / "meta.json")))
    # the port's trainer on the CLI's own patches (the same draws after)
    same = families.RadialTrainer(((3, 5, 5, 8),), 5, batch_size=16,
                                  device="cpu")
    tio.load_tree_into(same.model, np_tree(init))
    rng = np.random.RandomState(0)
    for p in (p for p in loaded[0] if p.good):
        jds.generate_polar_training_patches(p, 9, 5, 5, 32, rng)
    same.fit(tuple(ref_patches), 1, rng)
    assert_trees_close(tio.model_tree(same.model), ref, 1e-6)


def test_radial_pairs_drop_scene_seams_and_split_roles():
    """``scene_length`` drops the pairs that cross a seam between scenes
    (train_radial.py's -sl); ``gt_frames`` takes geometry and GT from one
    index-aligned sequence and the pixels from the other (-gtd), as
    ``load_polar_pairs_batched``'s ``pixel_frames`` does."""
    cal = dataclasses.replace(radial_calibration(tcal), wImg=128, hImg=96,
                              fx=120.0, fy=120.0, cx=64.0, cy=48.0)
    rng = np.random.RandomState(5)
    frames = [f for s in (3, 8) for f in parallax_frames(
        np.random.RandomState(s), 96, 128, n=2)]
    noisy = [np.clip(f + rng.randn(*f.shape).astype(np.float32) * 0.05, 0, 1)
             for f in frames]
    tr = families.RadialTrainer(((3, 5, 5, 4),), 5, device="cpu")
    noise = ransac_noise(64, 400)
    every = tr.load_pairs(cal, frames, 48, 48, noise=noise)
    assert len(every) == 3
    seams = tr.load_pairs(cal, frames, 48, 48, scene_length=2, noise=noise)
    assert len(seams) == 2
    for a, b in zip(seams, (every[0], every[2])):
        np.testing.assert_array_equal(a.polar_image, b.polar_image)
    split = tr.load_pairs(cal, noisy, 48, 48, gt_frames=frames, noise=noise)
    ref = tds.load_polar_pairs_batched(
        cal, frames, 96, 128, 48, 48, 5,
        geom_gt=families.radial_gt_geometry(cal), max_flow=4,
        pixel_frames=noisy, noise=noise, device="cpu")
    for a, b in zip(split, ref):
        for k in ("polar_image", "polar_gt", "polar_gt_mask", "e2"):
            np.testing.assert_array_equal(getattr(a, k), getattr(b, k))
    with pytest.raises(ValueError, match="index-aligned"):
        tr.load_pairs(cal, noisy[:3], 48, 48, gt_frames=frames, noise=noise)


def test_v2_sampler_matches_the_cli_dataset(tmp_path):
    """V2Trainer.sample against the CLI's FlowDataset patches on the
    parallax scene whose RANSAC winners are 8 distinct points."""
    from depth_estimation_tpu.geometry import Learning as JLearning
    jc, tc = calibrations(96, 128, f=100.0, max_points=200)
    d = tmp_path / "images"
    os.makedirs(d)
    for i, f in enumerate(parallax_frames(np.random.RandomState(3), 96, 128,
                                          n=3)):
        Image.fromarray((f * 255).astype(np.uint8)).save(d / f"{i:09d}.png")
    jnet = jv2.V2Network(jv2.V2Params(**V2))
    ds = jds.FlowDataset(jnet.geometry, jc, str(tmp_path),
                         cache_root=str(tmp_path / "jcache"))
    ref = ds.get_patches(40, np.random.RandomState(0), JLearning())
    tr = families.V2Trainer(tv2.V2Params(**V2), device="cpu")
    ours = tr.sample(tc, str(tmp_path), 3, 40, np.random.RandomState(0),
                     noise=ransac_noise(64, 200))
    assert len(ours[2]) == 40
    np.testing.assert_array_equal(ours[2], ref.itargets)
    np.testing.assert_allclose(ours[0], ref.patches1, rtol=0, atol=1e-3)
    np.testing.assert_allclose(ours[1], ref.patches2, rtol=0, atol=1e-5)


# ---------------------------------------------------------------------------
# the port stands alone
# ---------------------------------------------------------------------------

def test_port_sources_import_no_jax():
    """No file of the port, and not chip_smoke.py, imports jax or the JAX
    package (the modules are also imported without them in
    test_torch_pipeline.py)."""
    pat = re.compile(r"^\s*(import|from)\s+(jax|flax|depth_estimation_tpu)\b"
                     r"(?!_torch)", re.M)
    files = [os.path.join(REPO, "chip_smoke.py")]
    for dirpath, _, names in os.walk(os.path.join(REPO,
                                                  "depth_estimation_tpu_torch")):
        files += [os.path.join(dirpath, n) for n in names if n.endswith(".py")]
    assert len(files) > 40
    bad = [f for f in files if pat.search(open(f).read())]
    assert not bad, bad
