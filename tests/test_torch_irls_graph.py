"""The liu solve's IRLS planes: the CUDA-graph route and where it stays
eager (``flow/irls_graph.py``, ``flow/celiu._irls_planes``; the card's
cases are in test_torch_cuda.py).

``_irls_planes`` is held bit for bit to the IRLS step as ``smooth_flow_sor``
wrote it inline before the graph route, under both noise models and on a
warm start; each eager route returns its planes and counts
``liu_graph.eager``; the graph key separates what the captured kernels bake
in. The solver's agreement with the JAX package is in test_torch_celiu.py.
"""

import numpy as np
import pytest
import torch
import torch.nn.functional as F

from depth_estimation_tpu_torch.flow import celiu as tc
from depth_estimation_tpu_torch.flow import irls_graph
from depth_estimation_tpu_torch.utils.timer import COUNTERS


def _level(B=2, H=11, W=14, C=5, seed=0):
    """A level's (im1f, warp, u, v, lap_para, gm) from a numpy seed."""
    rng = np.random.RandomState(seed)

    def t(*shape, scale=1.0):
        return torch.from_numpy((scale * rng.rand(*shape)).astype(np.float32))
    im1f, warp = t(B, H, W, C), t(B, H, W, C)
    u, v = t(B, H, W, scale=2.0) - 1.0, t(B, H, W, scale=2.0) - 1.0
    lap_para = t(B, C, scale=0.05)
    lap_para[0, 1] = 0.0                    # a channel with no noise
    gm = tuple(p.expand(B, C) for p in tc.gaussian_mixture_init(C, "cpu"))
    return im1f, warp, u, v, lap_para, gm


def _step_as_written(im1f, warp, u, v, lap_para, alpha, noise_model, gm,
                     du=None, dv=None):
    """The body of ``smooth_flow_sor``'s ``liu.irls`` span before the graph
    route (first inner step when du is None, else a warm start)."""
    imdx, imdy, imdt = tc.get_dxs(im1f, warp)
    warm = du is not None
    if not warm:
        du = torch.zeros_like(u)
        dv = torch.zeros_like(v)
    uu = u + du if warm else u
    vv = v + dv if warm else v
    ux = tc.dx_forward(uu[..., None])[..., 0]
    uy = tc.dy_forward(uu[..., None])[..., 0]
    vx_ = tc.dx_forward(vv[..., None])[..., 0]
    vy_ = tc.dy_forward(vv[..., None])[..., 0]
    phi = 0.5 / torch.sqrt(ux * ux + uy * uy + vx_ * vx_ + vy_ * vy_ + 1e-6)
    temp = imdt + imdx * du[..., None] + imdy * dv[..., None]
    if noise_model == "gmm":
        psi = tc.gmm_psi(temp, gm)
    else:
        psi = 1.0 / (2.0 * torch.sqrt(temp * temp + 1e-6))
        psi = psi * (lap_para[..., None, None, :] >= 1e-20)
    imdxy = torch.mean(psi * imdx * imdy, dim=-1)
    imdx2 = torch.mean(psi * imdx * imdx, dim=-1)
    imdy2 = torch.mean(psi * imdy * imdy, dim=-1)
    imdtdx = torch.mean(psi * imdx * imdt, dim=-1)
    imdtdy = torch.mean(psi * imdy * imdt, dim=-1)

    def lap(f):
        fh = tc.dx_forward(f[..., None])[..., 0] * phi
        fv = tc.dy_forward(f[..., None])[..., 0] * phi
        out = -fh - fv
        out = out + F.pad(fh[..., :, :-1], (1, 0))
        out = out + F.pad(fv[..., :-1, :], (0, 0, 1, 0))
        return out

    b1 = -imdtdx - alpha * lap(u)
    b2 = -imdtdy - alpha * lap(v)
    w_w, w_e, w_n, w_s = tc._neighbor_weights(phi)
    coeff = alpha * (w_w + w_e + w_n + w_s)
    denom_u = imdx2 + alpha * 0.05 + coeff
    denom_v = imdy2 + alpha * 0.05 + coeff
    return w_w, w_e, w_n, w_s, denom_u, denom_v, b1, b2, imdxy


def _tensors(level, noise_model):
    im1f, warp, u, v, lap_para, gm = level
    return (im1f, warp, u, v, lap_para) + (gm if noise_model == "gmm" else ())


def _routes():
    return {k: COUNTERS[f"liu_graph.{k}"]
            for k in ("captures", "replays", "eager")}


def _assert_equal(got, want):
    assert len(got) == len(want) == 9
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.detach(), w), \
            float((g.detach() - w).abs().max())


@pytest.mark.parametrize("noise_model", ["lap", "gmm"])
@pytest.mark.parametrize("warm", [False, True])
def test_irls_planes_equal_the_step_as_written(noise_model, warm):
    level = _level(seed=1)
    im1f, warp, u, v, lap_para, gm = level
    kw = {}
    if warm:
        rng = np.random.RandomState(2)
        kw = {k: torch.from_numpy(0.1 * rng.randn(*u.shape).astype(np.float32))
              for k in ("du", "dv")}
    want = _step_as_written(im1f, warp, u, v, lap_para, 0.005, noise_model,
                            gm, **kw)
    got = tc._irls_planes(*_tensors(level, noise_model), alpha=0.005,
                          noise_model=noise_model, **kw)
    _assert_equal(got, want)


@pytest.mark.parametrize("route", ["cpu", "autograd", "dispatch mode",
                                   "compiling"])
def test_irls_planes_stay_eager_off_the_graph_route(route, monkeypatch):
    from depth_estimation_tpu_torch.utils.debug import nan_debug
    level = _level(seed=3)
    tensors = _tensors(level, "lap")
    want = tc._irls_planes(*tensors, alpha=0.005, noise_model="lap")
    if route == "autograd":
        tensors = tensors[:2] + (tensors[2].clone().requires_grad_(True),) \
            + tensors[3:]               # one input past the first
    if route == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    graphs = irls_graph.IRLSGraphs()
    before = _routes()
    if route == "dispatch mode":
        with nan_debug():
            assert irls_graph.eager_reason(tensors) == route
            got = graphs.replay(tc._irls_planes, tensors, alpha=0.005,
                                noise_model="lap")
    else:
        assert irls_graph.eager_reason(tensors) == route
        got = graphs.replay(tc._irls_planes, tensors, alpha=0.005,
                            noise_model="lap")
    _assert_equal(got, want)
    counted = 0 if route == "compiling" else 1      # a trace runs nothing
    assert _routes() == dict(before, eager=before["eager"] + counted)
    assert graphs._graphs == {}


def test_irls_planes_export_as_plain_ops():
    """Under torch.export the step traces as its eager operations, and the
    trace counts nothing."""
    class Step(torch.nn.Module):
        def forward(self, im1f, warp, u, v, lap_para):
            return irls_graph.GRAPHS.replay(
                tc._irls_planes, (im1f, warp, u, v, lap_para), alpha=0.02,
                noise_model="lap")
    tensors = _tensors(_level(B=1, H=6, W=7, seed=4), "lap")
    before = _routes()
    ep = torch.export.export(Step(), tensors)
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert any("sqrt" in t for t in targets), targets
    _assert_equal(ep.module()(*tensors),
                  tc._irls_planes(*tensors, alpha=0.02, noise_model="lap"))
    assert _routes() == before


def test_warm_start_steps_run_eagerly(monkeypatch):
    """n_inner = 2: the first inner step goes to the graph cache (eager on
    the CPU), the warm start straight to ``run_eager`` with the first SOR's
    du, dv; every step is counted eager."""
    calls = []
    real = irls_graph.run_eager

    def spy(fn, tensors, **consts):
        calls.append(sorted(consts))
        return real(fn, tensors, **consts)
    monkeypatch.setattr(irls_graph, "run_eager", spy)
    im1, im2 = _level(B=1, H=24, W=40, C=3, seed=5)[:2]
    before, steps = _routes(), COUNTERS["liu.irls_steps"]
    tc.coarse2fine_flow(im1, im2, alpha=0.02, ratio=0.75, min_width=30,
                        n_outer=2, n_inner=2, n_sor=3)
    assert COUNTERS["liu.irls_steps"] - steps == 2      # one level
    assert calls == [["alpha", "noise_model"],
                     ["alpha", "du", "dv", "noise_model"]] * 2
    assert _routes() == dict(before, eager=before["eager"] + 4)


@pytest.mark.parametrize("noise_model", ["lap", "gmm"])
def test_cpu_solve_counts_every_irls_step_eager(noise_model):
    level = _level(B=2, H=30, W=44, C=3, seed=7)
    before, steps = _routes(), COUNTERS["liu.irls_steps"]
    tc.coarse2fine_flow_batched(level[0], level[1], alpha=0.01, ratio=0.75,
                                min_width=20, n_outer=2, n_sor=3,
                                noise_model=noise_model)
    n = COUNTERS["liu.irls_steps"] - steps
    assert n == 3 + 2                   # 2 levels, n_outer + k steps each
    assert _routes() == dict(before, eager=before["eager"] + n)


def test_graph_key_separates_what_the_capture_bakes_in():
    level = _level(seed=8)
    tensors = _tensors(level, "lap")
    fn = tc._irls_planes

    def key(ts=tensors, **kw):
        return irls_graph.graph_key(fn, ts, dict(dict(alpha=0.005,
                                                      noise_model="lap"), **kw))
    base = key()
    # new contents, same key
    assert key(tuple(t + 1 for t in tensors)) == base
    others = [key(alpha=0.02), key(noise_model="gmm"),
              key(_tensors(level, "gmm")),
              key(_tensors(_level(B=3, seed=8), "lap")),
              key(_tensors(_level(H=12, seed=8), "lap")),
              key(_tensors(_level(C=3, seed=8), "lap")),
              key(tuple(t.double() for t in tensors)),
              irls_graph.graph_key(tc.get_dxs, tensors,
                                   dict(alpha=0.005, noise_model="lap"))]
    assert len({base, *others}) == 1 + len(others)


def test_irls_graph_bound_holds_the_loaders_two_batches_of_levels():
    """The trainer's schedule at the working size has 8 levels; the loader
    solves a full chunk and a last, shorter one."""
    shapes = tc.pyramid_shapes(180, 320, 0.75, 30)
    assert len(shapes) == 8
    assert irls_graph.MAX_GRAPHS >= 2 * len(shapes)
