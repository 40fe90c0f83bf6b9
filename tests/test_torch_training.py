"""PyTorch port vs the JAX package: the training slice — ``SGDTorch``
against the optax transform, the NaN guard, ``prepare_target``, the three
criteria and their gradients, the patch and fovea samplers, the
single-scale and multiscale trainers, and scoring (``training/``).

Both packages start from the same weights (the JAX init, bridged) and see
the same batches (the samplers are the same numpy code on the same
``RandomState`` seeds). Tolerances, float32: the optimizer's update
bit-equal; losses within relative 1e-5; gradients within 1e-5 of their
largest magnitude (XLA's and torch's convolution gradients sum in other
orders); parameters within absolute 1e-5 after 3 SGD steps at lr 2e-2
(2 steps for the multiscale trainer); samples and metrics of the same
inputs bit-equal.
"""

import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.geometry import Learning as JLearning
from depth_estimation_tpu.models import flow as jflow
from depth_estimation_tpu.models import io as jio
from depth_estimation_tpu.models import multiscale as jms
from depth_estimation_tpu.training import curves as jcurves
from depth_estimation_tpu.training import score as jscore
from depth_estimation_tpu.training import train as jtrain
from depth_estimation_tpu_torch.geometry import Geometry as TGeometry
from depth_estimation_tpu_torch.geometry import Learning as TLearning
from depth_estimation_tpu_torch.models import flow as tflow
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.training import curves as tcurves
from depth_estimation_tpu_torch.training import score as tscore
from depth_estimation_tpu_torch.training import train as ttrain

SINGLE = dict(hImg=48, wImg=56, layers=((3, 5, 5, 8), (8, 3, 3, 6)),
              maxh=6, maxw=6, maxhGT=6, maxwGT=6, hKernelGT=5, wKernelGT=5)
MULTI = dict(hImg=48, wImg=56, layers=((3, 3, 3, 6),), maxh=4, maxw=4,
             maxhGT=6, maxwGT=6, hKernelGT=5, wKernelGT=5, multiscale=True,
             ratios=(1, 2))
LR = dict(rate=2e-2, rate_decay=1e-3, weight_decay=1e-3, batch_size=16)


def both(cls_j, cls_t, **kw):
    return cls_j(**kw), cls_t(**kw)


def sequence(g, n=3, seed=0):
    """Frames where frame i+1 is frame i moved by a known (dy, dx), their
    GT flows, as tests/test_training.py builds them, interleaved into the
    samplers' (image, next image) layout."""
    rng = np.random.RandomState(seed)
    base = rng.rand(g.hImg + 20, g.wImg + 20, 3).astype(np.float32)
    shifts = [(1, -2), (2, 1)][: n - 1]
    images, flows = [], []
    oy, ox = 10, 10
    for k in range(n):
        images.append(base[oy:oy + g.hImg, ox:ox + g.wImg].copy())
        if k < n - 1:
            dy, dx = shifts[k]
            oy, ox = oy + dy, ox + dx
            f = np.zeros((2, g.hImg, g.wImg), np.float32)
            f[0], f[1] = dy, dx
            flows.append(f)
    return images, flows


def leaves(tree):
    return [np.asarray(x) for x in jax.tree.leaves(tree)]


def assert_trees_close(ours, ref, atol):
    assert jax.tree_util.tree_structure(ours) == jax.tree_util.tree_structure(
        jax.tree.map(np.asarray, ref))
    for a, b in zip(leaves(ours), leaves(ref)):
        np.testing.assert_allclose(a, b, rtol=0, atol=atol)


# ---------------------------------------------------------------------------
# optimizer
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("decay,wd", [(0.0, 0.0), (1e-2, 0.0), (3e-3, 5e-2)])
def test_sgd_torch_equals_the_optax_transform(decay, wd):
    rng = np.random.RandomState(0)
    p0 = rng.randn(7, 5).astype(np.float32)
    grads = [rng.randn(7, 5).astype(np.float32) for _ in range(4)]
    tx = jtrain.sgd_torch(0.3, decay, wd)
    jp = {"w": jnp.asarray(p0)}
    st = tx.init(jp)
    w = torch.nn.Parameter(torch.from_numpy(p0.copy()))
    opt = ttrain.sgd_torch([w], 0.3, decay, wd)
    for g in grads:
        up, st = tx.update({"w": jnp.asarray(g)}, st, jp)
        jp = jax.tree.map(lambda a, b: a + b, jp, up)
        w.grad = torch.from_numpy(g)
        opt.step()
        np.testing.assert_array_equal(w.detach().numpy(), np.asarray(jp["w"]))
    assert opt.count == int(st["count"]) == 4


def test_nan_guard_zeroes_the_step_but_keeps_decay_and_count():
    """Non-finite gradients: the update runs on zeroed gradients (weight
    decay alone moves the weights, the count advances), in both packages."""
    jg, tg = both(JGeometry, TGeometry, **SINGLE)
    jl, tl = both(JLearning, TLearning, **dict(LR, batch_size=4))
    jtr = jtrain.Trainer(jflow.FlowModel(jg), jl)
    state = jtr.init(jax.random.PRNGKey(0))
    tr = ttrain.Trainer(tg, tl, device="cpu").reset_optimizer()
    tio.load_tree_into(tr.model, jax.tree.map(np.asarray, state.params))
    p1 = np.full((4, tg.hPatch2, tg.wPatch2, 3), np.nan, np.float32)
    p2 = np.zeros_like(p1)
    it = np.zeros((4,), np.int32)
    st = np.zeros((4, tg.maxh * tg.maxw), np.float32)
    new_state, jaux = jtr._step(state, p1, p2, it, st)
    aux = tr.step(*(torch.from_numpy(a) for a in (p1, p2, it, st)))
    assert not bool(jaux["grad_ok"]) and not bool(aux["grad_ok"])
    assert tr.optimizer.count == int(new_state.opt_state["count"]) == 1
    assert_trees_close(tio.model_tree(tr.model), new_state.params, 0)
    moved = [np.abs(a - b).max() for a, b in zip(leaves(new_state.params),
                                                 leaves(state.params))]
    assert max(moved) > 0     # weight decay acted


# ---------------------------------------------------------------------------
# targets, criteria, gradients
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("geom", ["single", "multi"])
@pytest.mark.parametrize("soft", [False, True])
def test_prepare_target_matches_jax(geom, soft):
    jg, tg = both(JGeometry, TGeometry, **(SINGLE if geom == "single" else MULTI))
    jl, tl = both(JLearning, TLearning, soft_targets=soft, st_sigma2=1.7)
    rng = np.random.RandomState(1)
    t = np.concatenate([rng.randint(-5, 6, (30, 2)),
                        rng.rand(10, 2) * 12 - 6]).astype(np.float32)
    ji, jt = jflow.prepare_target(jg, jl, jnp.asarray(t))
    ti, tt = tflow.prepare_target(tg, tl, torch.from_numpy(t))
    np.testing.assert_array_equal(ti.numpy(), np.asarray(ji))
    np.testing.assert_allclose(tt.numpy(), np.asarray(jt), rtol=1e-6, atol=0)


@pytest.fixture(scope="module")
def single_case():
    jg, tg = both(JGeometry, TGeometry, **SINGLE)
    params = jflow.FlowModel(jg).init(jax.random.PRNGKey(0))
    images, flows = sequence(tg)
    return jg, tg, params, images, flows


@pytest.mark.parametrize("criterion", ["nll", "soft", "mse"])
def test_loss_and_gradients_match_jax(single_case, criterion):
    jg, tg, params, images, flows = single_case
    jl, tl = both(JLearning, TLearning, criterion=criterion,
                  soft_targets=criterion == "soft")
    ds = ttrain.sample_patches(tg, tl, images, flows, None, 12,
                               np.random.RandomState(1))
    soft = np.array(jflow.prepare_target(jg, jl, ds.targets_yx)[1]
                      if criterion == "soft"
                      else np.zeros((12, 36), np.float32), np.float32)
    jloss = jtrain.make_loss_fn(jflow.FlowModel(jg), jl)
    (jv, jaux), jgrad = jax.value_and_grad(jloss, has_aux=True)(
        params, ds.patches1, ds.patches2, ds.itargets, soft)
    model = tflow.FlowModel(tg, device="cpu")
    tio.load_tree_into(model, jax.tree.map(np.asarray, params))
    v, aux = ttrain.make_loss_fn(model, tl)(
        *(torch.from_numpy(a) for a in (ds.patches1, ds.patches2,
                                        ds.itargets, soft)))
    v.backward()
    np.testing.assert_allclose(v.item(), float(jv), rtol=1e-5)
    assert float(aux["acc"]) == float(jaux["acc"])
    grads = tio.filter_tree(tg, {k: p.grad for k, p in
                                 model.filter.named_parameters()})
    # the last layer's bias cancels in f1 - f2: its gradient is rounding
    # noise, held at the scale of the largest gradient as every other
    scale = max(np.abs(b).max() for b in leaves(jgrad))
    for a, b in zip(leaves(grads), leaves(jgrad)):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-5 * scale)


def test_training_heads_match_jax(single_case):
    jg, tg, params, images, _ = single_case
    model = tflow.FlowModel(tg, device="cpu")
    tio.load_tree_into(model, jax.tree.map(np.asarray, params))
    a, b = images[0], images[1]
    ref = np.asarray(jflow.FlowModel(jg).log_scores(params, a, b))
    with torch.no_grad():
        ours = model.log_scores(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4)
    assert ours.shape == (jg.hImg - jg.hKernel - jg.maxh + 2,
                          jg.wImg - jg.wKernel - jg.maxw + 2, 36)


# ---------------------------------------------------------------------------
# samplers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("with_masks", [False, True])
def test_sample_patches_bit_equal(with_masks):
    jg, tg = both(JGeometry, TGeometry, **SINGLE)
    images, flows = sequence(tg)
    masks = None
    if with_masks:
        rng = np.random.RandomState(7)
        masks = [(rng.rand(tg.hImg, tg.wImg) > 0.2).astype(np.float32),
                 None]
    a = ttrain.sample_patches(tg, TLearning(), images, flows, masks, 40,
                              np.random.RandomState(3))
    b = jtrain.sample_patches(jg, JLearning(), images, flows, masks, 40,
                              np.random.RandomState(3))
    assert len(a) == len(b) == 40
    for k in ("patches1", "patches2", "targets_yx", "itargets"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("with_masks", [False, True])
def test_sample_foveas_bit_equal(with_masks):
    jg, tg = both(JGeometry, TGeometry, **MULTI)
    images, flows = sequence(tg)
    masks = None
    if with_masks:
        rng = np.random.RandomState(8)
        masks = [(rng.rand(tg.hImg, tg.wImg) > 0.2).astype(np.float32),
                 None]
    a = ttrain.sample_foveas(tg, TLearning(), images, flows, masks, 24,
                             np.random.RandomState(4))
    b = jtrain.sample_foveas(jg, JLearning(), images, flows, masks, 24,
                             np.random.RandomState(4))
    for k in ("images1", "images2", "img_idx", "ys", "xs", "targets_yx",
              "itargets", "crops1", "crops2"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


# ---------------------------------------------------------------------------
# trainers
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("criterion", ["nll", "soft", "mse"])
def test_trainer_three_steps_match_jax(single_case, criterion):
    jg, tg, params, images, flows = single_case
    jl, tl = both(JLearning, TLearning, **dict(
        LR, criterion=criterion, soft_targets=criterion == "soft"))
    ds = ttrain.sample_patches(tg, tl, images, flows, None, 3 * 16,
                               np.random.RandomState(5))
    jtr = jtrain.Trainer(jflow.FlowModel(jg), jl)
    state = jtr.init(jax.random.PRNGKey(0))
    state, jm = jtr.epoch(state, ds, shuffle_rng=np.random.RandomState(6))
    tr = ttrain.Trainer(tg, tl, device="cpu").reset_optimizer()
    tio.load_tree_into(tr.model, jax.tree.map(np.asarray, params))
    m = tr.epoch(ds, shuffle_rng=np.random.RandomState(6))
    assert len(m["losses"]) == 3 and all(m["grad_ok"])
    assert tr.optimizer.count == 3
    np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    assert abs(m["acc"] - jm["acc"]) < 1e-6
    assert_trees_close(tio.model_tree(tr.model), state.params, 1e-5)


@pytest.mark.parametrize("extra,soft", [
    ({}, False), ({}, True), ({"share_filters": False}, False),
    ({"cascad_trainable_weights": True}, False),
    ({"cascad_trainable_weights": True, "single_beta": True}, False)])
def test_multiscale_trainer_two_steps_match_jax(extra, soft):
    """With trainable betas the reference's cascade takes a power of a
    negative sum once the betas leave -1, so its second step is NaN: both
    packages then guard the step the same way."""
    jg, tg = both(JGeometry, TGeometry, **dict(MULTI, **extra))
    jl, tl = both(JLearning, TLearning, **dict(LR, soft_targets=soft,
                                                batch_size=8))
    images, flows = sequence(tg)
    ds = ttrain.sample_foveas(tg, tl, images, flows, None, 16,
                              np.random.RandomState(1))
    jtr = jtrain.MultiscaleTrainer(jms.MultiscaleFlowModel(jg), jl)
    state = jtr.init(jax.random.PRNGKey(0))
    params = jax.tree.map(np.asarray, state.params)
    state, jm = jtr.epoch(state, ds, shuffle_rng=np.random.RandomState(2))
    tr = ttrain.MultiscaleTrainer(tg, tl, device="cpu").reset_optimizer()
    tio.load_tree_into(tr.model, params)
    m = tr.epoch(ds, shuffle_rng=np.random.RandomState(2))
    assert np.isnan(m["loss"]) == np.isnan(jm["loss"])
    if not np.isnan(jm["loss"]):
        np.testing.assert_allclose(m["loss"], jm["loss"], rtol=1e-5)
    assert m["grad_ok"][0]
    assert_trees_close(tio.model_tree(tr.model), state.params, 1e-5)


def test_trainers_learn():
    """A few epochs of each trainer lower the loss (the port alone)."""
    tg = TGeometry(**SINGLE)
    tl = TLearning(rate=0.2, rate_decay=0.0, batch_size=16)
    images, flows = sequence(tg)
    ds = ttrain.sample_patches(tg, tl, images, flows, None, 64,
                               np.random.RandomState(1))
    tr = ttrain.Trainer(tg, tl, device="cpu").init(
        torch.Generator().manual_seed(0))
    first = tr.epoch(ds, shuffle_rng=np.random.RandomState(2))["loss"]
    for _ in range(3):
        last = tr.epoch(ds, shuffle_rng=np.random.RandomState(2))["loss"]
    assert last < first


@pytest.mark.parametrize("make", ["flow_model", "trainer", "multiscale"])
def test_training_entry_points_default_to_the_card(monkeypatch, make):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    build = {
        "flow_model": lambda **kw: tflow.FlowModel(TGeometry(**SINGLE), **kw),
        "trainer": lambda **kw: ttrain.Trainer(TGeometry(**SINGLE),
                                               TLearning(), **kw),
        "multiscale": lambda **kw: ttrain.MultiscaleTrainer(
            TGeometry(**MULTI), TLearning(), **kw),
    }[make]
    with pytest.raises(RuntimeError, match="cuda"):
        build()
    out = build(device="cpu")
    model = getattr(out, "model", out)
    assert next(model.parameters()).device.type == "cpu"


# ---------------------------------------------------------------------------
# scoring
# ---------------------------------------------------------------------------

def test_eval_flow_and_epe_match_jax():
    jg, tg = both(JGeometry, TGeometry, **SINGLE)
    rng = np.random.RandomState(9)
    gt = rng.randint(-3, 4, (2, 48, 56)).astype(np.float32)
    out = gt + rng.randint(-1, 2, gt.shape) * (rng.rand(*gt.shape) > 0.7)
    mask = rng.rand(48, 56) > 0.5
    for compute_dst in (True, False):
        assert (tscore.eval_flow(tg, torch.from_numpy(out), gt, compute_dst)
                == jscore.eval_flow(jg, out, gt, compute_dst))
    assert tscore.borders(tg) == jscore.borders(jg)
    assert tscore.epe(out, gt) == jscore.epe(out, gt)
    assert tscore.epe(out, gt, mask) == jscore.epe(out, gt, mask)


@pytest.fixture(scope="module")
def scoring_case(single_case):
    jg, tg, params, images, flows = single_case
    ds = ttrain.sample_patches(tg, TLearning(), images, flows, None, 16,
                               np.random.RandomState(0))
    model = tflow.FlowModel(tg, device="cpu")
    tio.load_tree_into(model, jax.tree.map(np.asarray, params))
    pairs = [(images[0], images[1]), (images[1], images[2])]
    return jg, tg, params, model, ds, pairs, flows


def test_score_epoch_matches_jax(scoring_case):
    jg, tg, params, model, ds, pairs, flows = scoring_case
    ref = jcurves.score_epoch(jflow.FlowModel(jg), params, jg, JLearning(),
                              ds, pairs, flows)
    ours = tcurves.score_epoch(model, tg, TLearning(), ds, pairs, flows)
    assert set(ours) == set(ref) == {"test_acc", "test_err", "full_acc",
                                     "full_meandst"}
    assert ours["test_acc"] == ref["test_acc"]
    np.testing.assert_allclose(ours["test_err"], ref["test_err"], rtol=1e-5)
    assert ours["full_acc"] == ref["full_acc"]
    assert ours["full_meandst"] == ref["full_meandst"]


def test_sweep_thresholds_matches_jax(scoring_case):
    jg, tg, params, model, ds, pairs, flows = scoring_case
    ref = jcurves.sweep_thresholds(jflow.FlowModel(jg), params, jg, pairs,
                                   flows, (0.0, 0.3))
    ours = tcurves.sweep_thresholds(model, tg, pairs, flows, (0.0, 0.3))
    assert ours == ref


def test_backfill_scores_and_curves_match_jax(scoring_case, tmp_path):
    jg, tg, params, model, ds, pairs, flows = scoring_case
    images = [pairs[0][0], pairs[0][1], pairs[1][1]]
    for pkg in ("jax", "port"):
        mdir = tmp_path / pkg
        jio.save_model(str(mdir / "a"), jg, JLearning(), params, None, 3)
        jio.save_model(str(mdir / "b"), jg, JLearning(), params,
                       [{"test_acc": 0.25}], 1)
        if pkg == "jax":
            fixed = jcurves.backfill_scores(str(mdir), ds, images, flows)
        else:
            fixed = tcurves.backfill_scores(str(mdir), ds, images, flows,
                                            device="cpu")
        assert fixed == ["a"]
    ref = json.load(open(tmp_path / "jax" / "a" / "meta.json"))["score"][0]
    ours = json.load(open(tmp_path / "port" / "a" / "meta.json"))["score"][0]
    assert set(ours) == set(ref)
    for k in ref:
        np.testing.assert_allclose(ours[k], ref[k], rtol=1e-5)
    assert (tcurves.get_learning_scores(str(tmp_path / "port"))
            == {"a": [ours], "b": [{"test_acc": 0.25}]})
    png = tcurves.plot_learning_curves(str(tmp_path / "port"),
                                       str(tmp_path / "c.png"))
    assert png and open(png, "rb").read(8) == b"\x89PNG\r\n\x1a\n"
    (tmp_path / "none").mkdir()
    assert tcurves.plot_learning_curves(str(tmp_path / "none"),
                                        str(tmp_path / "d.png")) is None
