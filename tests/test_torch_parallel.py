"""The port's mesh layer (depth_estimation_tpu_torch/parallel/mesh.py) on
an 8-shard CPU mesh, against the port's unsharded programs and against the
JAX package's sharded functions on its 8 virtual CPU devices, at the
shapes of tests/test_parallel.py, from the same numpy seeds and weights.
Tolerances are that file's: indices equal, ey/ex within 1e-5, training
loss within 1e-5 relative and parameters within 1e-5."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.geometry import Learning as JLearning
from depth_estimation_tpu.models.flow import FlowModel as JFlowModel
from depth_estimation_tpu.parallel import mesh as jmesh
from depth_estimation_tpu_torch.geometry import Geometry, Learning
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.models.flow import (FlowModel,
                                                    crop_features_center)
from depth_estimation_tpu_torch.ops import _kernels, matching
from depth_estimation_tpu_torch.parallel import mesh as pm

from torch_parity import one_torch_thread  # noqa: F401 (fixture)


def _np_tree(tree):
    return jax.tree.map(np.asarray, tree)


@pytest.fixture(scope="module")
def jmesh8():
    assert len(jax.devices()) == 8, jax.devices()
    return jmesh.make_mesh(jax.devices(), axis="sp")


@pytest.fixture(scope="module")
def mesh8():
    return pm.make_mesh(["cpu"] * 8, axis="sp")


def _flow_models(kw, seed):
    """(JAX model, its params, the port's FlowModel with those weights)."""
    jmodel = JFlowModel(JGeometry(**kw))
    params = jmodel.init(jax.random.PRNGKey(seed))
    model = FlowModel(Geometry(**kw), device="cpu")
    tio.load_tree_into(model, _np_tree(params))
    return jmodel, params, model


def test_spatial_halo_sharding_matches_unsharded(mesh8, jmesh8):
    kw = dict(hImg=64, wImg=48, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    jmodel, params, model = _flow_models(kw, 0)
    g = model.geometry
    rng = np.random.RandomState(0)
    H = 64  # 8 shards x 8 rows
    img1 = rng.rand(H, 48, 3).astype(np.float32)
    img2 = rng.rand(H, 48, 3).astype(np.float32)

    idx_s, ey_s, ex_s, _ = pm.spatial_sharded_flow_fn(model, mesh8)(img1,
                                                                    img2)
    assert len(idx_s) == 8 and idx_s.shape[0] == H

    # unsharded: zero-pad the bottom by the halo and run whole
    halo = (g.maxh - 1) + (g.hKernel - 1)
    pad = (0, 0, 0, 0, 0, halo)
    p1 = torch.nn.functional.pad(torch.from_numpy(img1), pad)
    p2 = torch.nn.functional.pad(torch.from_numpy(img2), pad)
    f1 = crop_features_center(g, model.features(p1))
    f2 = model.features(p2)
    idx_u, ey_u, ex_u, _ = matching.match_flow_fused(f1, f2, g.maxh, g.maxw)
    np.testing.assert_array_equal(np.asarray(idx_s)[:H], idx_u.numpy()[:H])
    np.testing.assert_allclose(np.asarray(ey_s)[:H], ey_u.numpy()[:H],
                               atol=1e-5)
    np.testing.assert_allclose(np.asarray(ex_s)[:H], ex_u.numpy()[:H],
                               atol=1e-5)

    jfn = jmesh.spatial_sharded_flow_fn(jmodel, jmesh8, axis="sp")
    j_idx, j_ey, j_ex, _ = jfn(params, jnp.asarray(img1), jnp.asarray(img2))
    np.testing.assert_array_equal(np.asarray(idx_s), np.asarray(j_idx))
    np.testing.assert_allclose(np.asarray(ey_s), np.asarray(j_ey), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ex_s), np.asarray(j_ex), atol=1e-5)


def _trainer_step_case():
    kw = dict(hImg=32, wImg=32, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    lkw = dict(rate=1e-2, batch_size=16, criterion="nll")
    rng = np.random.RandomState(1)
    B = 16
    g = Geometry(**kw)
    p1 = rng.rand(B, g.hPatch2, g.wPatch2, 3).astype(np.float32)
    p2 = rng.rand(B, g.hPatch2, g.wPatch2, 3).astype(np.float32)
    it = rng.randint(0, 16, B).astype(np.int32)
    st = np.zeros((B, 16), np.float32)
    return kw, lkw, (p1, p2, it, st)


def test_dp_training_step_matches_single_device():
    from depth_estimation_tpu.training import train as jtrain
    from depth_estimation_tpu_torch.training import train as ttrain

    kw, lkw, batch = _trainer_step_case()
    jtrainer = jtrain.Trainer(JFlowModel(JGeometry(**kw)), JLearning(**lkw))
    state = jtrainer.init(jax.random.PRNGKey(1))
    dp = jmesh.make_mesh(jax.devices(), axis="dp")
    jstep = jmesh.sharded_train_step(jtrainer, dp)
    js, jaux = jstep(jmesh.replicate(state, dp),
                     *jmesh.shard_batch(tuple(map(jnp.asarray, batch)), dp))

    def port_trainer():
        tr = ttrain.Trainer(Geometry(**kw), Learning(**lkw), device="cpu")
        tio.load_tree_into(tr.model, _np_tree(state.params))
        return tr.reset_optimizer()

    tb = tuple(torch.from_numpy(a) for a in batch)
    single = port_trainer()
    aux1 = single.step(*tb)
    sharded = port_trainer().use_mesh(pm.make_mesh(["cpu"] * 8))
    aux2 = sharded.step(*tb)

    np.testing.assert_allclose(float(aux1["loss"]), float(aux2["loss"]),
                               rtol=1e-5)
    np.testing.assert_allclose(float(aux2["loss"]), float(jaux["loss"]),
                               rtol=1e-5)
    assert bool(aux2["grad_ok"])
    for a, b in zip(single.model.parameters(), sharded.model.parameters()):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   atol=1e-5)
    ours = _np_tree(tio.model_tree(sharded.model))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(js.params)):
        np.testing.assert_allclose(a, np.asarray(b), atol=1e-5)
    assert sharded.optimizer.count == 1


def test_dp_multiscale_trainer_matches_single_device():
    """MultiscaleTrainer.use_mesh: an epoch of fovea batches split over 8
    shards equals the unsharded epoch and the JAX trainer's epoch on its
    8-device mesh (losses within 1e-5 relative, weights within 1e-5)."""
    from depth_estimation_tpu.models import multiscale as jms
    from depth_estimation_tpu.training import train as jtrain
    from depth_estimation_tpu_torch import codecs
    from depth_estimation_tpu_torch.training import train as ttrain

    kw = dict(hImg=32, wImg=40, layers=((3, 5, 5, 6),), maxh=4, maxw=4,
              multiscale=True, ratios=(1, 2))
    lkw = dict(rate=1e-2, batch_size=8, criterion="nll")
    g = Geometry(**kw)
    rng = np.random.RandomState(4)
    n, hc, wc = 16, g.rmax * g.hPatch2, g.rmax * g.wPatch2
    z = np.zeros(n, np.int32)
    ds = ttrain.FoveaDataset(
        np.zeros((1, 32, 40, 3), np.float32), np.zeros((1, 32, 40, 3),
                                                      np.float32),
        z, z, z, np.zeros((n, 2), np.float32),
        rng.randint(0, codecs.n_indices(g), n).astype(np.int32),
        crops1=rng.rand(n, hc, wc, 3).astype(np.float32),
        crops2=rng.rand(n, hc, wc, 3).astype(np.float32))
    jtr = jtrain.MultiscaleTrainer(jms.MultiscaleFlowModel(JGeometry(**kw)),
                                   JLearning(**lkw))
    state = jtr.init(jax.random.PRNGKey(0))
    params = _np_tree(state.params)
    jtr.use_mesh(jmesh.make_mesh(jax.devices()))
    state, jm = jtr.epoch(state, ds, shuffle_rng=np.random.RandomState(2))

    got = []
    for mesh in (None, pm.make_mesh(["cpu"] * 8)):
        tr = ttrain.MultiscaleTrainer(g, Learning(**lkw), device="cpu")
        tio.load_tree_into(tr.model, params)
        tr.reset_optimizer()
        if mesh is not None:
            tr.use_mesh(mesh)
        got.append((tr.epoch(ds, shuffle_rng=np.random.RandomState(2)),
                    _np_tree(tio.model_tree(tr.model))))
    (single, w1), (sharded, w2) = got
    np.testing.assert_allclose(sharded["losses"], single["losses"],
                               rtol=1e-5)
    np.testing.assert_allclose(sharded["loss"], float(jm["loss"]), rtol=1e-5)
    for a, b, c in zip(jax.tree.leaves(w2), jax.tree.leaves(w1),
                       jax.tree.leaves(state.params)):
        np.testing.assert_allclose(a, b, atol=1e-5)
        np.testing.assert_allclose(a, np.asarray(c), atol=1e-5)


def test_dp_step_skips_a_non_finite_gradient_on_any_shard():
    """The replicas' gradients are summed before the NaN guard: a NaN in
    one shard's patches zeroes the whole step, as unsharded."""
    from depth_estimation_tpu_torch.training import train as ttrain

    kw, lkw, batch = _trainer_step_case()
    p1 = batch[0].copy()
    p1[13] = np.nan                      # shard 6 of 8
    tb = (torch.from_numpy(p1),) + tuple(torch.from_numpy(a)
                                         for a in batch[1:])
    got = []
    for mesh in (None, pm.make_mesh(["cpu"] * 8)):
        tr = ttrain.Trainer(Geometry(**kw), Learning(**lkw), device="cpu")
        tr.init(torch.Generator().manual_seed(0))
        if mesh is not None:
            tr.use_mesh(mesh)
        before = [p.detach().clone() for p in tr.model.parameters()]
        aux = tr.step(*tb)
        assert not bool(aux["grad_ok"])
        got.append([p.detach().clone() for p in tr.model.parameters()])
        # weight decay 0: a skipped step leaves the weights as they were
        for a, b in zip(before, got[-1]):
            torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(SystemExit, match="not divisible"):
        tr.epoch(ttrain.PatchDataset(batch[0][:12], batch[1][:12],
                                     np.zeros((12, 2), np.float32),
                                     batch[2][:12]), batch_size=12)


def test_dp_sharded_inference_matches_single_device():
    kw = dict(hImg=40, wImg=40, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    jmodel, params, model = _flow_models(kw, 2)
    rng = np.random.RandomState(2)
    B = 16
    img1 = rng.rand(B, 40, 40, 3).astype(np.float32)
    img2 = rng.rand(B, 40, 40, 3).astype(np.float32)

    mesh = pm.make_mesh(["cpu"] * 8, axis="dp")
    i_s, ey_s, ex_s, _ = pm.sharded_flow_fn(model, mesh)(
        *pm.shard_batch((img1, img2), mesh))
    assert i_s.devices == mesh.devices
    i_u, ey_u, ex_u, _ = model.forward_fused(torch.from_numpy(img1),
                                             torch.from_numpy(img2))
    np.testing.assert_array_equal(np.asarray(i_s), i_u.numpy())
    np.testing.assert_allclose(np.asarray(ey_s), ey_u.numpy(), atol=1e-5)

    dp = jmesh.make_mesh(jax.devices(), axis="dp")
    j_i, j_ey, j_ex, _ = jmesh.sharded_flow_fn(jmodel, dp, axis="dp")(
        params, *jmesh.shard_batch((jnp.asarray(img1), jnp.asarray(img2)),
                                   dp))
    np.testing.assert_array_equal(np.asarray(i_s), np.asarray(j_i))
    np.testing.assert_allclose(np.asarray(ey_s), np.asarray(j_ey), atol=1e-5)
    np.testing.assert_allclose(np.asarray(ex_s), np.asarray(j_ex), atol=1e-5)


def test_pad_to_multiple_for_sharding(mesh8):
    """pad_to_multiple prepares ragged batches for the mesh; the valid count
    round-trips, for numpy arrays (as the reference's) and tensors."""
    x = np.arange(10 * 3, dtype=np.float32).reshape(10, 3)
    xp, n = pm.pad_to_multiple(x, 8)
    jp, jn = jmesh.pad_to_multiple(x, 8)
    assert n == jn == 10 and xp.shape[0] == 16
    np.testing.assert_array_equal(xp, jp)
    tp, tn = pm.pad_to_multiple(torch.from_numpy(x), 8)
    assert tn == 10
    np.testing.assert_array_equal(tp.numpy(), jp)
    sharded = pm.shard_batch(xp, mesh8)
    assert sharded.shape == (16, 3) and len(sharded) == 8
    np.testing.assert_array_equal(np.asarray(sharded), xp)
    np.testing.assert_array_equal(sharded.gather().numpy(), xp)
    with pytest.raises(ValueError, match="pad_to_multiple"):
        pm.shard_batch(x, mesh8)


@pytest.mark.parametrize("share_filters", [True, False])
def test_spatial_sharded_multiscale_matches_unsharded(share_filters):
    """Row-sharded multiscale forward (halos from both neighbours) equals
    forward_full, for the shared trunk and per-scale trunks."""
    from depth_estimation_tpu.models.multiscale import \
        MultiscaleFlowModel as JMultiscale
    from depth_estimation_tpu_torch.models.multiscale import \
        MultiscaleFlowModel

    kw = dict(hImg=64, wImg=48, layers=((3, 5, 5, 6),), maxh=4, maxw=4,
              multiscale=True, ratios=(1, 2, 4), share_filters=share_filters)
    jmodel = JMultiscale(JGeometry(**kw))
    params = jmodel.init(jax.random.PRNGKey(2))
    model = MultiscaleFlowModel(Geometry(**kw), device="cpu")
    tio.load_tree_into(model, _np_tree(params))
    rng = np.random.RandomState(2)
    img1 = rng.rand(64, 48, 3).astype(np.float32)
    img2 = rng.rand(64, 48, 3).astype(np.float32)

    # 2-shard mesh: 64 rows = 2 x 32, and 32 % rmax == 0
    mesh2 = pm.make_mesh(["cpu"] * 2, axis="sp")
    out_s = np.asarray(pm.spatial_sharded_multiscale_fn(model, mesh2)(
        img1, img2))
    with torch.no_grad():
        out_u = model.forward_full(torch.from_numpy(img1),
                                   torch.from_numpy(img2)).numpy()
    np.testing.assert_allclose(out_s, out_u, rtol=1e-5, atol=1e-6)

    jm2 = jmesh.make_mesh(jax.devices()[:2], axis="sp")
    out_j = np.asarray(jmesh.spatial_sharded_multiscale_fn(jmodel, jm2,
                                                           axis="sp")(
        params, jnp.asarray(img1), jnp.asarray(img2)))
    np.testing.assert_allclose(out_s, out_j, rtol=1e-5, atol=1e-6)


def test_spatial_sharded_radial_matches_unsharded(mesh8, jmesh8):
    """Row-sharded radial matcher equals the unsharded flow on a
    bottom-zero-padded polar pair."""
    from depth_estimation_tpu.models.radial import \
        RadialFlowNetwork as JRadial
    from depth_estimation_tpu_torch.models.radial import RadialFlowNetwork

    layers = ((3, 5, 5, 6), "tanh")
    jnet = JRadial(layers=layers, h_win=4)
    params = jnet.init(jax.random.PRNGKey(3), 32, 32)
    net = RadialFlowNetwork(layers, 4, device="cpu")
    tio.load_tree_into(net, _np_tree(params))
    rng = np.random.RandomState(3)
    H, W = 64, 32    # 8 shards x 8 rows
    p1 = rng.rand(H, W, 3).astype(np.float32)
    p2 = rng.rand(H, W, 3).astype(np.float32)

    flow_s, cost_s = pm.spatial_sharded_radial_fn(net, mesh8)(p1, p2)

    halo = (net.h_kernel - 1) + (net.h_win - 1)
    pad = (0, 0, 0, 0, 0, halo)
    with torch.no_grad():
        fp = net.filter(torch.nn.functional.pad(torch.from_numpy(p1),
                                                pad))[:H]
        fc = net.filter(torch.nn.functional.pad(torch.from_numpy(p2),
                                                pad))[:H + net.h_win - 1]
        costs = matching.match_ssd_radial(fp, fc, net.h_win)
    np.testing.assert_array_equal(np.asarray(flow_s),
                                  torch.argmin(costs, -1).numpy())
    np.testing.assert_allclose(np.asarray(cost_s),
                               torch.amin(costs, -1).numpy(), atol=1e-5)

    j_flow, j_cost = jmesh.spatial_sharded_radial_fn(jnet, jmesh8,
                                                     axis="sp")(
        params, jnp.asarray(p1), jnp.asarray(p2))
    np.testing.assert_array_equal(np.asarray(flow_s), np.asarray(j_flow))
    np.testing.assert_allclose(np.asarray(cost_s), np.asarray(j_cost),
                               atol=1e-5)


def test_kernel_calls_take_the_tensors_device_and_its_stream(monkeypatch):
    """The device guard: every launcher hands ``KernelLibrary.call`` its
    tensors' device, and ``call`` launches with that device current on
    that device's stream (not the current device's). Checked with a
    recording library in place of the built one, on CPU tensors standing
    in for a card's."""
    from depth_estimation_tpu_torch.flow import sor_kernel
    from depth_estimation_tpu_torch.ops import warp

    seen, guards = [], []

    class FakeStream:
        def __init__(self, device):
            self.cuda_stream = 1000 + (device.index or 0)

    class FakeGuard:
        def __init__(self, device):
            self.device = torch.device(device)

        def __enter__(self):
            guards.append(("enter", self.device))

        def __exit__(self, *exc):
            guards.append(("exit", self.device))

    def recorder(name):
        def fn(*args):
            seen.append((name, guards[-1], args))
            return 0
        return fn

    lib = _kernels.KernelLibrary.__new__(_kernels.KernelLibrary)
    lib.fns = {name: recorder(name) for sigs in _kernels.SIGNATURES.values()
               for name in sigs}
    monkeypatch.setattr(_kernels, "library", lambda: lib)
    monkeypatch.setattr(_kernels, "check_cuda_tensor", lambda *a: None)
    monkeypatch.setattr(torch.cuda, "device", FakeGuard)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: FakeStream(torch.device(device)))

    # a direct call: the stream is the named device's
    lib.call("warp_banded_launch", "cuda:1", *([0] * 10))
    assert seen[-1][:2] == ("warp_banded_launch",
                            ("enter", torch.device("cuda:1")))
    assert seen[-1][2][-1] == 1001
    assert guards[-1] == ("exit", torch.device("cuda:1"))

    # every launcher passes its tensors' device (CPU tensors here)
    class OnCard(torch.Tensor):
        is_cuda = True

    f1 = torch.zeros(1, 4, 5, 8)
    f2 = torch.zeros(1, 7, 8, 8)
    matching._match_flow_fused_cuda(f1, f2, 4, 4, False, torch.float32,
                                    True, 0.11)
    matching._match_flow_fast_cuda(f1, f2, 4, 4, torch.float32)
    from depth_estimation_tpu_torch.ops import matching_experimental as mx
    mx._match_flow_throughput_cuda(f1, f2, 4, 4)
    warp._banded_bilinear_warp_cuda(torch.zeros(1, 6, 7, 3),
                                    torch.zeros(1, 6, 7),
                                    torch.zeros(1, 6, 7), 8)
    planes = [torch.zeros(1, 8, 8).as_subclass(OnCard) for _ in range(9)]
    sor_kernel.sor_redblack(*planes, alpha=0.01, n_sor=2)
    names = [s[0] for s in seen[1:]]
    assert names == ["match_fused_launch", "match_fast_launch",
                     "match_throughput_launch", "warp_banded_launch",
                     "sor_redblack_launch"], names
    cpu = torch.device("cpu")
    assert all(s[1] == ("enter", cpu) and s[2][-1] == 1000 for s in seen[1:])
    # B4's plan is made for the tensors' card: its index goes beside the
    # stream (None for these CPU stand-ins)
    assert seen[-1][2][-2] is None


# ---------------------------------------------------------------------------
# the online program and the offline builds
#
# Each is held twice: the port's sharded run against its unsharded run on
# test_parallel.py's fixture (8 shards, B=8, 48x64), and the port's sharded
# run against the JAX sharded run on 2 shards of scenes whose RANSAC
# winners the two packages' LAPACK builds share (torch_parity's parallax
# and forward-zoom scenes at 96x128, with the reference's RANSAC draws): at
# 48x64, and on the pure translations of test_parallel.py, the packages'
# essential matrices part (ROADMAP C5, C9, C26), sharded or not.
# ---------------------------------------------------------------------------

def _small_cals(h, w, f=60.0, max_points=64):
    import dataclasses
    from depth_estimation_tpu.geometry3d import calibration as jcal
    from depth_estimation_tpu_torch.geometry3d import calibration as tcal

    def make(mod):
        base = mod.RECTIFIED_GOPRO_SMALL
        return dataclasses.replace(
            base, name="tp", wImg=w, hImg=h, fx=f, fy=f, cx=w / 2, cy=h / 2,
            sfm=dataclasses.replace(base.sfm, max_points=max_points))
    return make(jcal), make(tcal)


def _assert_equal_per_chunk(got, single_fn, inputs, n_dev):
    """Each shard's chunk equals an unsharded run on that chunk."""
    B = inputs[0].shape[0]
    loc = B // n_dev
    for d in range(n_dev):
        s = slice(d * loc, (d + 1) * loc)
        want = single_fn(*(torch.from_numpy(np.array(a[s]))
                           for a in inputs))
        for i, (g_, w_) in enumerate(zip(got, want)):
            np.testing.assert_array_equal(np.asarray(g_)[s], w_.numpy(),
                                          err_msg=f"chunk {d}, output {i}")


def test_dp_sharded_full_pipeline_matches_unsharded():
    """BatchedDepthEstimator.shard: the complete online program ('warp'
    mode) over the mesh, stream state sharded between steps. Each shard's
    streams equal the unsharded estimator run on that shard's streams
    alone. Against the full batch, ego-motion's batched LAPACK calls round
    apart: on the parallax scene (8-distinct RANSAC winners) the x-flow is
    held to ROADMAP C6's card-vs-CPU bounds (mean <= 1e-2, p99 <= 5e-2
    px); and on 2 shards against the JAX estimator sharded on 2 devices,
    to test_torch_pipeline.py's 1e-3 px."""
    from depth_estimation_tpu import api_batched as japi
    from depth_estimation_tpu_torch import api_batched as tapi
    from torch_parity import pipeline_case, ransac_noise, to_jax

    rng = np.random.RandomState(11)
    h, w = 48, 64
    _, tc = _small_cals(h, w)
    kw = dict(hImg=h, wImg=w, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
    params = _np_tree(JFlowModel(JGeometry(**kw)).init(jax.random.PRNGKey(1)))
    B = 8
    base = rng.rand(B, h // 4, w // 4).astype(np.float32)
    f1 = np.asarray(jax.image.resize(jnp.asarray(base), (B, h, w),
                                     "bilinear"))
    f1 = np.repeat(f1[..., None], 3, axis=-1)
    f2 = np.roll(f1, -1, axis=2)
    noise = ransac_noise(64, 64)

    def run(mesh, frames, geom, params, cal, noise):
        est = tapi.BatchedDepthEstimator(geom, params, cal,
                                         ransac_noise=noise, device="cpu")
        if mesh is not None:
            est.shard(mesh)
        est.reset(frames[0])
        out = [[o.numpy() for o in est.next_frames(f)] for f in frames[1:]]
        return est, out

    est, got = run(pm.make_mesh(["cpu"] * 8), (f1, f2), Geometry(**kw),
                   params, tc, noise)
    assert isinstance(est.last_u, pm.Sharded) and len(est.last_u) == 8
    for d in range(B):
        _, want = run(None, (f1[d:d + 1], f2[d:d + 1]), Geometry(**kw),
                      params, tc, noise)
        for a, b in zip(got[0], want[0]):
            np.testing.assert_array_equal(a[d:d + 1], b)

    case = pipeline_case()
    frames = case["frames"]
    args = (case["tg"], case["params"], case["tc"],
            ransac_noise(64, case["n_points"]))
    _, tout = run(pm.make_mesh(["cpu"] * 2), frames, *args)
    _, full = run(None, frames, *args)
    jest = japi.BatchedDepthEstimator(case["jg"], to_jax(case["params"]),
                                      case["jc"]).shard(
        jmesh.make_mesh(jax.devices()[:2], axis="dp"))
    jest.reset(jnp.asarray(frames[0]))
    jout = [[np.asarray(o) for o in jest.next_frames(jnp.asarray(f))]
            for f in frames[1:]]
    for (xf, m, _, good), (uxf, um, _, ugood), (jxf, jm, _, jgood) in zip(
            tout, full, jout):
        assert good.all()
        np.testing.assert_array_equal(good, ugood)
        np.testing.assert_array_equal(good, jgood)
        for other, omask, tol in ((uxf, um, None), (jxf, jm, 1e-3)):
            assert ((m > 0) == (omask > 0)).mean() >= 0.999
            d = np.abs(xf - other)[(m > 0) & (omask > 0)]
            if tol is None:
                assert d.mean() <= 1e-2 and np.percentile(d, 99) <= 5e-2
            else:
                assert d.max() <= tol


def test_dp_sharded_celiu_gt_matches_single_device():
    """sharded_celiu_fn (kernel B4's solver on every shard): each chunk
    equal to the batched solver at the local batch, and the whole within
    test_torch_celiu.py's solve tolerance of the JAX sharded solve."""
    from depth_estimation_tpu.flow import celiu as jceliu
    from depth_estimation_tpu_torch.flow import celiu

    rng = np.random.RandomState(0)
    B, H, W = 8, 32, 40
    base = rng.rand(B, H, W, 1).astype(np.float32)
    im1 = np.asarray(jceliu.gaussian_smooth(jnp.asarray(base), 0.8, 2))
    im2 = np.roll(im1, 1, axis=2)
    kw = dict(alpha=0.01, ratio=0.75, min_width=16, n_outer=2, n_inner=1,
              n_sor=10)

    got = pm.sharded_celiu_fn(pm.make_mesh(["cpu"] * 8), **kw)(im1, im2)
    _assert_equal_per_chunk(
        got, lambda a, b: celiu.coarse2fine_flow_batched(a, b, **kw),
        (im1, im2), 8)

    dp = jmesh.make_mesh(jax.devices(), axis="dp")
    want = jmesh.sharded_celiu_fn(dp, **kw)(
        *jmesh.shard_batch((jnp.asarray(im1), jnp.asarray(im2)), dp))
    for g_, w_ in zip(got, want):
        np.testing.assert_allclose(np.asarray(g_), np.asarray(w_), rtol=1e-4,
                                   atol=1e-4)


def test_dp_sharded_rectify_build_matches_single_device():
    """sharded_rectify_fn: each chunk equal to the fused rectification
    program at the local batch; and on 2 shards of the parallax scene
    within test_torch_datasets.py's bounds of the JAX sharded build."""
    from depth_estimation_tpu_torch.data import datasets as tds
    from test_parallel import _smooth_shift_pairs
    from torch_parity import (calibrations, parallax_frames,
                                    ransac_noise)

    H, W = 48, 64
    _, tc = _small_cals(H, W)
    prevs, imgs = _smooth_shift_pairs(8, H, W, seed=1)
    noise = torch.from_numpy(ransac_noise(64, 64))
    got = pm.sharded_rectify_fn(pm.make_mesh(["cpu"] * 8), tc, H, W,
                                noise=noise)(prevs, imgs)
    _assert_equal_per_chunk(got, lambda p, i: tds.rectify_batch(
        p, i, tc.K, tuple(tc.distortion), H, W, tc.sfm.max_points,
        tc.sfm.points_quality, noise), (prevs, imgs), 8)

    H, W = 96, 128
    jc, tc = calibrations(H, W, f=100.0, max_points=200)
    fr = np.stack(parallax_frames(np.random.RandomState(3), H, W, n=3))
    ours = pm.sharded_rectify_fn(pm.make_mesh(["cpu"] * 2), tc, H, W,
                                 noise=ransac_noise(64, 200))(fr[:-1], fr[1:])
    dp2 = jmesh.make_mesh(jax.devices()[:2], axis="dp")
    ref = jmesh.sharded_rectify_fn(dp2, jc, H, W)(
        *jmesh.shard_batch((jnp.asarray(fr[:-1]), jnp.asarray(fr[1:])), dp2))
    prev_s, img_s, warped, mask, n_inl, n_fnd = (np.asarray(o) for o in ours)
    np.testing.assert_allclose(img_s, np.asarray(ref[1]), atol=1e-5)
    np.testing.assert_allclose(warped, np.asarray(ref[2]), atol=1e-3)
    assert (mask == np.asarray(ref[3])).mean() >= 0.99
    np.testing.assert_array_equal(n_inl, np.asarray(ref[4]))
    np.testing.assert_array_equal(n_fnd, np.asarray(ref[5]))


def test_dp_sharded_polar_build_matches_single_device():
    """sharded_polar_load_fn: each chunk equal to the fused polar program
    at the local batch (test_parallel.py's two-plane zoom chain); and on 2
    shards of test_torch_polar_data.py's scenes against the JAX sharded
    build: polar images within that file's 1.5e-3, masks equal on >= 0.999
    of the pixels, inlier counts equal, and the epipole within ROADMAP
    C26's 1e-2 px. (The JAX shard_map program rounds apart from its jit by
    ulps, and on these forward steps the epipole moves by ~1e-3 px for a
    1e-5 change of T: 1.2e-3 px here, sharded or not.)"""
    from depth_estimation_tpu_torch.data import datasets as tds
    from test_parallel import _zoom_chain_pairs
    from test_torch_polar_data import JC, NOISE, NPTS, TC, \
        forward_sequence
    from torch_parity import ransac_noise

    H, W = 48, 64
    _, tc = _small_cals(H, W)
    prevs, imgs = _zoom_chain_pairs(8, H, W, seed=2)
    noise = torch.from_numpy(ransac_noise(64, 64))
    got = pm.sharded_polar_load_fn(pm.make_mesh(["cpu"] * 8), tc, H, W, 32,
                                   32, 5, noise=noise)(prevs, imgs)
    _assert_equal_per_chunk(got, lambda p, i: tds.polar_batch(
        p, i, tc.K, tc.wImg, tc.hImg, H, W, 32, 32, 5, tc.sfm.max_points,
        tc.sfm.points_quality, noise), (prevs, imgs), 8)

    H, W = 96, 128
    a, b = forward_sequence(8), forward_sequence(3)
    prevs = np.stack([a[0], b[0]])
    imgs = np.stack([a[1], b[1]])
    ours = pm.sharded_polar_load_fn(pm.make_mesh(["cpu"] * 2), TC, H, W, 64,
                                    64, 5, noise=NOISE)(prevs, imgs)
    dp2 = jmesh.make_mesh(jax.devices()[:2], axis="dp")
    ref = jmesh.sharded_polar_load_fn(dp2, JC, H, W, 64, 64, 5)(
        *jmesh.shard_batch((jnp.asarray(prevs), jnp.asarray(imgs)), dp2))
    assert NPTS == TC.sfm.max_points
    p_img, p_prev, p_mask, e2 = (np.asarray(o) for o in ours[:4])
    np.testing.assert_allclose(e2, np.asarray(ref[3]), rtol=0, atol=1e-2)
    np.testing.assert_allclose(p_img, np.asarray(ref[0]), atol=1.5e-3)
    np.testing.assert_allclose(p_prev, np.asarray(ref[1]), atol=1.5e-3)
    assert (p_mask == np.asarray(ref[2])).mean() >= 0.999
    np.testing.assert_array_equal(np.asarray(ours[4]), np.asarray(ref[4]))


def test_launch_counts_hold_under_threads(monkeypatch):
    """The shards of a mesh of cards count their launches from a host
    thread each: no count is lost (a lock around the read-modify-write),
    with the interpreter switching threads as often as it can."""
    import sys
    import threading

    def wrapper():
        pass
    wrapper.launches = 0
    monkeypatch.setattr(_kernels, "LAUNCHES_BY_DEVICE",
                        type(_kernels.LAUNCHES_BY_DEVICE)())
    n_threads, n_calls = 16, 2000
    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=lambda k=k: [
            _kernels.count_launch(wrapper, f"cuda:{k % 4}")
            for _ in range(n_calls)]) for k in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(old)
    assert wrapper.launches == n_threads * n_calls
    assert sum(_kernels.LAUNCHES_BY_DEVICE.values()) == n_threads * n_calls
    assert _kernels.LAUNCHES_BY_DEVICE[("wrapper", "cuda:0")] == 4 * n_calls


def test_run_shards_keeps_a_host_thread_a_card(monkeypatch):
    """run_shards on a mesh of two cards with two shards each: each card's
    shards run in order in one thread of its own, the two cards' threads
    at once (a barrier between their first shards), the results come back
    in shard order, and the grad mode is the caller's; one card, or the
    CPU, runs in the calling thread. An error in a card's thread reaches
    the caller. (The card guard is stubbed: there is no card here.)"""
    import threading

    monkeypatch.setattr(torch.cuda, "device",
                        lambda d: __import__("contextlib").nullcontext())
    seen = []
    both_cards = threading.Barrier(2, timeout=10)

    def fn(i, x):
        seen.append((i, threading.get_ident(), torch.is_grad_enabled()))
        if len(set(mesh.devices)) == 2 and i in (0, 2):
            both_cards.wait()       # the two cards' threads run at once
        return x * 10

    mesh = pm.Mesh(["cuda:0", "cuda:0", "cuda:1", "cuda:1"])
    with torch.no_grad():
        assert pm.run_shards(fn, mesh, [1, 2, 3, 4]) == [10, 20, 30, 40]
    threads = {i: t for i, t, _ in seen}
    assert threads[0] == threads[1] and threads[2] == threads[3]
    assert threading.get_ident() not in threads.values()
    assert [i for i, _, _ in seen if i < 2] == [0, 1]
    assert not any(g for _, _, g in seen)
    for devices in (["cuda:0"] * 3, ["cpu"] * 3):
        seen.clear()
        mesh = pm.Mesh(devices)
        assert pm.run_shards(fn, mesh, [1, 2, 3]) == [10, 20, 30]
        assert [(i, t) for i, t, _ in seen] == [
            (i, threading.get_ident()) for i in range(3)]
    with pytest.raises(ZeroDivisionError):
        pm.run_shards(lambda i, x: 1 // (i - 3),
                      pm.Mesh(["cuda:0", "cuda:0", "cuda:1", "cuda:1"]),
                      [0, 0, 0, 0])
