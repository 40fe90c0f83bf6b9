"""PyTorch port vs the JAX package: the polar geometry and the radial
network (BASELINE config4's model family), on the same numpy inputs and the
same weights carried across from the JAX ``init`` through
``models.io.radial_state_from_jax``."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.geometry3d import polar as jpolar
from depth_estimation_tpu.models.radial import RadialFlowNetwork as JRadial
from depth_estimation_tpu_torch.geometry3d import polar as tpolar
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.models.radial import RadialFlowNetwork as TRadial

LAYERS = ((3, 5, 5, 6), "tanh", (6, 3, 3, 5))


def smooth_image(h, w, seed=0, c=3):
    rng = np.random.RandomState(seed)
    base = rng.rand(h // 4 + 2, w // 4 + 2, c).astype(np.float32)
    return np.array(jax.image.resize(jnp.asarray(base), (h, w, c),
                                      "bilinear"))


@pytest.mark.parametrize("alpha", [1.0, 0.8])
@pytest.mark.parametrize("pads", [(0, 0), (3, 2)])
def test_polar_grids_match_jax(alpha, pads):
    kw = dict(lpadding=pads[0], rpadding=pads[1], alpha=alpha)
    ours = tpolar.get_c2p_grid(128, 96, 160, 100, device="cpu", **kw).numpy()
    ref = np.asarray(jpolar.get_c2p_grid(128, 96, 160, 100, **kw))
    assert ours.shape == ref.shape == (2, 100, 160 + sum(pads))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)
    kw = dict(xcenter=60.5, ycenter=50.0, rmax=55.0, alpha=alpha)
    ours = tpolar.get_p2c_grid(160, 100, 128, 96, device="cpu", **kw).numpy()
    ref = np.asarray(jpolar.get_p2c_grid(160, 100, 128, 96, **kw))
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-4)


def test_warp_grid_and_cartesian2polar_match_jax():
    img = smooth_image(48, 64)
    rng = np.random.RandomState(1)
    # a grid with taps inside, on the border and outside the image
    grid = np.stack([rng.uniform(-2, 50, (30, 40)),
                     rng.uniform(-2, 66, (30, 40))]).astype(np.float32)
    grid[:, 0, :4] = [[0, 47, 47.5, -0.5], [0, 63, 10, 3]]
    ours = tpolar.warp_grid(torch.from_numpy(img), torch.from_numpy(grid))
    ref = np.asarray(jpolar.warp_grid(jnp.asarray(img), jnp.asarray(grid)))
    assert tuple(ours.shape) == ref.shape == (30, 40, 3)
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-6)
    # the whole cartesian -> polar -> cartesian trip, each on its own grids
    c2p = tpolar.get_c2p_grid(64, 48, 80, 50, device="cpu")
    pol = tpolar.cartesian2polar(torch.from_numpy(img), c2p)
    jpol = jpolar.cartesian2polar(jnp.asarray(img),
                                  jpolar.get_c2p_grid(64, 48, 80, 50))
    np.testing.assert_allclose(pol.numpy(), np.asarray(jpol), rtol=0, atol=1e-4)
    back = tpolar.warp_grid(pol, tpolar.get_p2c_grid(80, 50, 64, 48,
                                                     device="cpu"))
    jback = jpolar.warp_grid(jpol, jpolar.get_p2c_grid(80, 50, 64, 48))
    np.testing.assert_allclose(back.numpy(), np.asarray(jback), rtol=0,
                               atol=1e-4)


def test_rmax_k_output_and_pad_output_match_jax():
    for h, w, e in ((60, 80, (0.0, 0.0)), (60, 80, (40.0, 30.0)),
                    (200, 200, (73.5, 120.25))):
        assert tpolar.get_rmax(h, w, e) == jpolar.get_rmax(h, w, e)
    assert tpolar.get_k_output(200, 9, 15) == jpolar.get_k_output(200, 9, 15)
    im = np.random.RandomState(2).rand(2, 10, 13).astype(np.float32)
    for hw in ((20, 20), (11, 14), (15, 31)):
        np.testing.assert_array_equal(
            tpolar.pad_output(*hw, torch.from_numpy(im)).numpy(),
            np.asarray(jpolar.pad_output(*hw, jnp.asarray(im))))


@pytest.mark.parametrize("kind", ["float", "int"])
def test_flow2depth_matches_jax(kind):
    h, w = 50, 60
    center = (30.0, 25.0)
    rng = np.random.RandomState(3)
    flow = rng.uniform(-0.5, 6.0, (h, w)).astype(np.float32)
    flow[:5] = 0.05
    flow = np.round(flow).astype(np.int32) if kind == "int" else flow
    for kinfty in (1.0, 0.7):
        d, c = tpolar.flow2depth(h, w, torch.from_numpy(flow), center, kinfty)
        jd, jc = jpolar.flow2depth(h, w, jnp.asarray(flow), center, kinfty)
        np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6,
                                   atol=1e-7)
        assert c.dtype == {"float": torch.float32, "int": torch.int32}[kind]
        np.testing.assert_array_equal(c.numpy(), np.asarray(jc))


def test_radial_depth_cartesian_and_depth2color_match_jax():
    rng = np.random.RandomState(4)
    flow = rng.uniform(-3, 3, (2, 40, 50)).astype(np.float32)
    flow[:, :6] *= 0.03                       # still pixels: |flow| < 0.2
    d, c = tpolar.radial_depth_cartesian(torch.from_numpy(flow), (24.5, 20.0), 80.0)
    jd, jc = jpolar.radial_depth_cartesian(jnp.asarray(flow), (24.5, 20.0), 80.0)
    np.testing.assert_allclose(d.numpy(), np.asarray(jd), rtol=1e-6)
    np.testing.assert_array_equal(c.numpy(), np.asarray(jc))
    depth = rng.uniform(-0.2, 1.3, (20, 30)).astype(np.float32)
    confs = (rng.rand(20, 30) > 0.3).astype(np.float32)
    rgb = tpolar.depth2color(torch.from_numpy(depth), torch.from_numpy(confs))
    ref = np.asarray(jpolar.depth2color(jnp.asarray(depth), jnp.asarray(confs)))
    assert tuple(rgb.shape) == (3, 20, 30)
    np.testing.assert_allclose(rgb.numpy(), ref, rtol=0, atol=1e-6)
    hsl = rng.rand(3, 7, 9).astype(np.float32)
    np.testing.assert_allclose(tpolar.hsl2rgb(torch.from_numpy(hsl)).numpy(),
                               np.asarray(jpolar.hsl2rgb(jnp.asarray(hsl))),
                               rtol=0, atol=1e-6)


@pytest.fixture(scope="module")
def radial_pair():
    jnet = JRadial(LAYERS, h_win=6)
    params = jnet.init(jax.random.PRNGKey(0))
    tnet = TRadial(LAYERS, h_win=6, device="cpu")
    tnet.load_state_dict(tio.radial_state_from_jax(
        LAYERS, jax.tree.map(np.asarray, params)))
    return jnet, params, tnet


def test_radial_network_matches_jax(radial_pair):
    jnet, params, tnet = radial_pair
    assert (tnet.h_kernel, tnet.w_kernel) == (jnet.h_kernel, jnet.w_kernel)
    curr = smooth_image(40, 36, seed=5)
    prev = np.roll(curr, -2, axis=0) + 0.01 * np.random.RandomState(6).randn(
        40, 36, 3).astype(np.float32)
    tp, tc = torch.from_numpy(prev), torch.from_numpy(curr)
    costs = tnet.costs(tp, tc).detach().numpy()
    ref = np.asarray(jnet.costs(params, jnp.asarray(prev), jnp.asarray(curr)))
    assert costs.shape == ref.shape == (40 - 6 - 5, 36 - 6, 6)
    np.testing.assert_allclose(costs, ref, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(
        tnet.log_scores(tp, tc).detach().numpy(),
        np.asarray(jnet.log_scores(params, jnp.asarray(prev), jnp.asarray(curr))),
        rtol=0, atol=1e-4)
    flow, mcost = tnet.flow(tp, tc)
    jflow, jmcost = jnet.flow(params, jnp.asarray(prev), jnp.asarray(curr))
    s = np.sort(ref, axis=-1)
    near = (s[..., 1] - s[..., 0]) <= 1e-5 * np.abs(s[..., 0]) + 1e-6
    diff = flow.numpy() != np.asarray(jflow)
    assert flow.dtype == torch.int32 and not (diff & ~near).any()
    np.testing.assert_allclose(mcost.numpy(), np.asarray(jmcost), rtol=1e-5,
                               atol=1e-6)
    assert (flow.numpy()[4:-8] == 2).mean() > 0.5      # the 2-row shift


def test_radial_flow_batch_matches_jax(radial_pair):
    jnet, params, tnet = radial_pair
    rng = np.random.RandomState(7)
    prev = rng.rand(3, 30, 28, 3).astype(np.float32)
    curr = rng.rand(3, 30, 28, 3).astype(np.float32)
    flow, mcost = tnet.flow_batch(torch.from_numpy(prev), torch.from_numpy(curr))
    jflow, jmcost = jnet.flow_batch(params, jnp.asarray(prev), jnp.asarray(curr))
    assert tuple(flow.shape) == (3, 30 - 6 - 5, 28 - 6)
    costs = np.asarray(jax.vmap(jnet.costs, in_axes=(None, 0, 0))(
        params, jnp.asarray(prev), jnp.asarray(curr)))
    s = np.sort(costs, axis=-1)
    near = (s[..., 1] - s[..., 0]) <= 1e-5 * np.abs(s[..., 0]) + 1e-6
    assert not ((flow.numpy() != np.asarray(jflow)) & ~near).any()
    np.testing.assert_allclose(mcost.numpy(), np.asarray(jmcost), rtol=1e-5,
                               atol=1e-6)
    one = tnet.flow(torch.from_numpy(prev[2]), torch.from_numpy(curr[2]))
    np.testing.assert_array_equal(one[0].numpy(), flow[2].numpy())


def test_radial_identity_recovers_shift_and_gate():
    """The reference's identity-kernel check: prev shifted by k rows decodes
    flow = k; and filterOutputTrainer's WTA index and gate."""
    from depth_estimation_tpu_torch.geometry import Geometry
    from depth_estimation_tpu_torch.models.filters import identity_filter_params
    net = TRadial(((1, 5, 5, 25),), h_win=6, device="cpu")
    net.load_state_dict(tio.radial_state_from_jax(
        net.layers, identity_filter_params(Geometry(layers=((1, 5, 5, 25),)))))
    curr = np.random.RandomState(1).rand(40, 32, 1).astype(np.float32)
    prev = np.roll(curr, -3, axis=0)
    flow, cost = net.flow(torch.from_numpy(prev), torch.from_numpy(curr))
    assert (flow.numpy()[2:-10] == 3).all()
    assert cost.numpy()[2:-10].max() < 1e-6
    logp = torch.log(torch.tensor([[0.7, 0.2, 0.1], [0.4, 0.35, 0.25]]))
    idx, good = TRadial.filter_output_trainer(logp, 0.5)
    jidx, jgood = JRadial.filter_output_trainer(jnp.asarray(logp.numpy()), 0.5)
    np.testing.assert_array_equal(idx.numpy(), np.asarray(jidx))
    np.testing.assert_array_equal(good.numpy(), np.asarray(jgood))
    assert math.isclose(float(good.float().mean()), 0.5)
