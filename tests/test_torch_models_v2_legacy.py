"""PyTorch port vs the JAX package: the version2 network and the legacy
models, on the same numpy inputs and the same weights carried across from
the JAX ``init``."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.models import legacy_depth as jlegacy
from depth_estimation_tpu.models import version2 as jv2
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.models import legacy_depth as tlegacy
from depth_estimation_tpu_torch.models import version2 as tv2

V2_SMALL = dict(wImg=40, hImg=36, normalization_k=7, layers=((3, 5, 5, 8),),
                hWin=5, wWin=4)


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def test_v2_params_and_geometry_match_jax():
    import dataclasses
    for kw in ({}, V2_SMALL):
        jp, tp = jv2.V2Params(**kw), tv2.V2Params(**kw)
        assert dataclasses.asdict(jp) == dataclasses.asdict(tp)
        assert dataclasses.asdict(jp.geometry()) == \
            dataclasses.asdict(tp.geometry())


@pytest.mark.parametrize("k", [7, 17])
def test_v2_costs_and_log_scores_match_jax(k):
    kw = dict(V2_SMALL, normalization_k=k)
    jnet = jv2.V2Network(jv2.V2Params(**kw))
    params = jnet.init(jax.random.PRNGKey(0))
    tnet = tv2.V2Network(tv2.V2Params(**kw), device="cpu")
    tnet.filter.load_state_dict(tio.filter_state_from_jax(tnet.geometry,
                                                          numpy_tree(params)))
    rng = np.random.RandomState(k)
    im1 = rng.rand(36, 40, 3).astype(np.float32)
    im2 = np.roll(im1, 1, axis=1) + 0.02 * rng.rand(36, 40, 3).astype(np.float32)
    t1, t2 = torch.from_numpy(im1), torch.from_numpy(im2)
    costs = tnet.costs(t1, t2).detach().numpy()
    ref = np.asarray(jnet.costs(params, jnp.asarray(im1), jnp.asarray(im2)))
    g = tnet.geometry
    assert costs.shape == ref.shape == (36 - 4 - 4, 40 - 4 - 3, 20)
    np.testing.assert_allclose(costs, ref, rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(
        tnet.log_scores(t1, t2).detach().numpy(),
        np.asarray(jnet.log_scores(params, jnp.asarray(im1), jnp.asarray(im2))),
        rtol=0, atol=1e-4)
    # a leading batch gives each pair's costs
    both = tnet.costs(torch.stack([t1, t2]), torch.stack([t2, t1]))
    np.testing.assert_allclose(both[0].detach().numpy(), costs, rtol=1e-6,
                               atol=1e-6)
    assert g.maxh * g.maxw == 20


def test_legacy_flow_model_matches_jax():
    jm = jlegacy.LegacyFlowModel(maxh=6, maxw=5, kernel=7, n_features=9)
    params = jm.init(jax.random.PRNGKey(1))
    tm = tlegacy.LegacyFlowModel(maxh=6, maxw=5, kernel=7, n_features=9,
                                 device="cpu")
    tm.load_state_dict(tio.legacy_state_from_jax(numpy_tree(params)))
    rng = np.random.RandomState(2)
    p2 = rng.rand(30, 33, 1).astype(np.float32)
    p1 = np.roll(p2, -2, axis=0)
    costs = tm.costs(torch.from_numpy(p1), torch.from_numpy(p2)).detach().numpy()
    ref = np.asarray(jm.costs(params, jnp.asarray(p1), jnp.asarray(p2)))
    assert costs.shape == ref.shape
    np.testing.assert_allclose(costs, ref, rtol=1e-5, atol=1e-5)


def test_legacy_flow_model_identity_recovers_shift():
    """The reference's identity-kernel check: feature = raw 8x8 patch."""
    tm = tlegacy.LegacyFlowModel(maxh=6, maxw=6, kernel=8, n_features=64,
                                 device="cpu")
    kernel = np.zeros((8, 8, 1, 64), np.float32)
    for i in range(8):
        for j in range(8):
            kernel[i, j, 0, i * 8 + j] = 1.0
    tm.load_state_dict(tio.legacy_state_from_jax(
        {"params": {"kernel": kernel, "bias": np.zeros(64, np.float32)}}))
    p2 = np.random.RandomState(3).rand(40, 44, 1).astype(np.float32) * 0.5
    p1 = np.roll(p2, -2, axis=0)
    idx = tm.costs(torch.from_numpy(p1), torch.from_numpy(p2)).argmin(-1)
    assert (idx[4:-4, 4:-4] == 4 * 6 + 2).float().mean() > 0.9


def test_depth_classifier_cnn_matches_jax():
    jnet = jlegacy.DepthClassifierCNN(n_classes=7, in_channels=2)
    rng = np.random.RandomState(4)
    x = rng.rand(2, 46, 46, 2).astype(np.float32)
    params = jnet.init(jax.random.PRNGKey(0), jnp.asarray(x[0]))
    tnet = tlegacy.DepthClassifierCNN(n_classes=7, in_channels=2, device="cpu")
    tnet.load_state_dict(tio.legacy_state_from_jax(numpy_tree(params)))
    out = tnet(torch.from_numpy(x)).detach().numpy()
    # 46 -> conv5 42 -> pool 21 -> conv5 17 -> pool 8 -> conv5 4
    assert out.shape == (2, 4, 4, 7)
    for b in range(2):
        ref = np.asarray(jnet.apply(params, jnp.asarray(x[b])))
        np.testing.assert_allclose(out[b], ref, rtol=1e-5, atol=1e-5)
    one = tnet(torch.from_numpy(x[1])).detach().numpy()
    np.testing.assert_allclose(one, out[1], rtol=1e-6, atol=1e-6)


def test_init_from_a_generator_is_seeded():
    a = tlegacy.DepthClassifierCNN(5, device="cpu").init(
        torch.Generator().manual_seed(3))
    b = tlegacy.DepthClassifierCNN(5, device="cpu").init(
        torch.Generator().manual_seed(3))
    for x, y in zip(a.state_dict().values(), b.state_dict().values()):
        torch.testing.assert_close(x, y, rtol=0, atol=0)
    assert 0.5 < a.classifier.weight.std().item() * np.sqrt(200) < 1.2
    assert (a.conv2.bias == 0).all()


@pytest.mark.parametrize("family", ["multiscale", "radial", "version2",
                                    "legacy_flow", "legacy_cnn", "c2p_grid",
                                    "p2c_grid"])
def test_model_families_default_to_the_card_and_refuse_the_cpu(monkeypatch,
                                                                family):
    """With no device named, each new entry point asks for the card; where
    torch sees none it raises instead of carrying on on the CPU; named, the
    CPU holds the weights."""
    from depth_estimation_tpu_torch.geometry import Geometry
    from depth_estimation_tpu_torch.geometry3d import polar
    from depth_estimation_tpu_torch.models import multiscale, radial
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    g = Geometry(hImg=32, wImg=40, layers=((3, 5, 5, 6),), maxh=4, maxw=4,
                 multiscale=True, ratios=(1, 2))
    make = {
        "multiscale": lambda **kw: multiscale.MultiscaleFlowModel(g, **kw),
        "radial": lambda **kw: radial.RadialFlowNetwork(((3, 5, 5, 4),), 3,
                                                        **kw),
        "version2": lambda **kw: tv2.V2Network(tv2.V2Params(**V2_SMALL), **kw),
        "legacy_flow": lambda **kw: tlegacy.LegacyFlowModel(**kw),
        "legacy_cnn": lambda **kw: tlegacy.DepthClassifierCNN(3, **kw),
        "c2p_grid": lambda **kw: polar.get_c2p_grid(40, 30, 20, 10, **kw),
        "p2c_grid": lambda **kw: polar.get_p2c_grid(20, 10, 40, 30, **kw),
    }[family]
    with pytest.raises(RuntimeError, match="cuda"):
        make()
    out = make(device="cpu")
    t = out if isinstance(out, torch.Tensor) else next(out.parameters())
    assert t.device.type == "cpu"


def _local_mean_per_channel(img, f):
    """The cross-channel local mean one channel's convolution at a time:
    the form the port had before it convolved the channels together."""
    from depth_estimation_tpu_torch.ops import normalization as tnorm
    C = img.shape[-1]
    ones = torch.ones(img.shape[-3:-1], dtype=img.dtype)
    coef = torch.clamp(tnorm._sep_conv_same(ones, f) * C, min=1e-8)
    acc = tnorm._sep_conv_same(img[..., 0], f)
    for c in range(1, C):
        acc = acc + tnorm._sep_conv_same(img[..., c], f)
    return acc / coef


@pytest.mark.parametrize("shape", [(2, 20, 24, 50), (18, 22, 3),
                                   (4, 2, 16, 16, 2)])
def test_local_mean_equals_the_per_channel_loop(shape):
    """The channels convolved together give the per-channel loop's bits,
    and so do their gradients (each channel's taps run in the same order;
    the channel sum is the same chain of adds)."""
    from depth_estimation_tpu_torch.ops import normalization as tnorm
    g = torch.Generator().manual_seed(len(shape))
    x = torch.randn(*shape, generator=g, requires_grad=True)
    f = tnorm._window(15, shape[-1])
    ours = tnorm._local_mean(x, f)[1]
    ref = _local_mean_per_channel(x, f)
    assert torch.equal(ours, ref)
    w = torch.randn(ours.shape, generator=g)
    assert torch.equal(torch.autograd.grad((ours * w).sum(), x)[0],
                       torch.autograd.grad((ref * w).sum(), x)[0])
