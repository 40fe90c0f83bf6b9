"""The shared CUDA-graph cache (``utils/cuda_graph.py``) and its two users,
RANSAC's QR (``geometry3d/qr_graph.py`` through ``egomotion._eight_point``)
and the liu solve's IRLS planes (``flow/celiu._irls_planes``), on the CPU;
the card's cases are in test_torch_cuda.py.

For each user: every eager route returns eager's result and counts
``<name>.eager`` (a trace counts nothing), an export holds the plain
operations, and the graph key separates what the captured kernels bake in.
``_irls_planes`` is held bit for bit to the IRLS step as ``smooth_flow_sor``
wrote it inline before the graph route, under both noise models and on a
warm start; the QR's slices keep cuBLAS's batched route. The solver's
agreement with the JAX package is in test_torch_celiu.py.
"""

import ast
import contextlib
from pathlib import Path

import numpy as np
import pytest
import torch
import torch.nn.functional as F
from torch.utils import _pytree

from depth_estimation_tpu_torch.flow import celiu as tc
from depth_estimation_tpu_torch.geometry3d import egomotion as tego
from depth_estimation_tpu_torch.geometry3d import qr_graph
from depth_estimation_tpu_torch.utils import cuda_graph
from depth_estimation_tpu_torch.utils.timer import COUNTERS

USERS = ["qr_graph", "liu_graph"]
LAP = dict(alpha=0.005, noise_model="lap")


def _routes(name):
    return {k: COUNTERS[f"{name}.{k}"] for k in ("captures", "replays",
                                                 "eager")}


def _assert_equal(got, want):
    got, want = _pytree.tree_leaves(got), _pytree.tree_leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert g.shape == w.shape and torch.equal(g.detach(), w), \
            float((g.detach() - w).abs().max())


# ---------------------------------------------------------------------------
# the QR's inputs, and ``_eight_point`` as written before the graph route
# ---------------------------------------------------------------------------

def _samples(B, S, seed=0):
    rng = np.random.RandomState(seed)
    p1 = torch.from_numpy(0.4 * rng.randn(B, S, 8, 2).astype(np.float32))
    p2 = p1 + torch.from_numpy(0.02 * rng.randn(B, S, 8, 2).astype(np.float32))
    return p1, p2


def _design(p1n, p2n):
    x1, y1 = p1n[..., 0], p1n[..., 1]
    x2, y2 = p2n[..., 0], p2n[..., 1]
    return torch.stack([x2 * x1, x2 * y1, x2, y2 * x1, y2 * y1, y2, x1, y1,
                        torch.ones_like(x1)], dim=-1)


def _eight_point_as_written(p1n, p2n):
    """``_eight_point`` before the graph route: the plain complete QR."""
    Q, _ = torch.linalg.qr(_design(p1n, p2n).transpose(-1, -2),
                           mode="complete")
    return Q[..., :, 8].reshape(Q.shape[:-2] + (3, 3))


# ---------------------------------------------------------------------------
# the IRLS planes' inputs, and the step as ``smooth_flow_sor`` wrote it
# ---------------------------------------------------------------------------

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


# ---------------------------------------------------------------------------
# both users: the eager routes, the export, the key
# ---------------------------------------------------------------------------

def _program(user, seed, grad):
    """(the cache's inputs, a call of the program's path through the
    process's cache, eager's result, that cache) for one user."""
    if user == "qr_graph":
        p1, p2 = _samples(3, 5, seed)
        want = _eight_point_as_written(p1, p2)
        p1.requires_grad_(grad)
        return ((_design(p1, p2),), lambda: tego._eight_point(p1, p2), want,
                qr_graph.GRAPHS)
    tensors = _tensors(_level(seed=seed), "lap")
    want = tc._irls_planes(*tensors, **LAP)
    if grad:                            # one input past the first
        tensors = tensors[:2] + (tensors[2].clone().requires_grad_(True),) \
            + tensors[3:]
    return (tensors, lambda: tc.GRAPHS.replay(tc._irls_planes, tensors, **LAP),
            want, tc.GRAPHS)


@pytest.mark.parametrize("user", USERS)
@pytest.mark.parametrize("route", ["cpu", "autograd", "dispatch mode",
                                   "compiling"])
def test_calls_stay_eager_off_the_graph_route(user, route, monkeypatch):
    from depth_estimation_tpu_torch.utils.debug import nan_debug
    tensors, run, want, cache = _program(user, 3, route == "autograd")
    if route == "compiling":
        monkeypatch.setattr(torch.compiler, "is_compiling", lambda: True)
    before = _routes(user)
    with nan_debug() if route == "dispatch mode" else contextlib.nullcontext():
        assert cuda_graph.eager_reason(tensors) == route
        got = run()
    _assert_equal(got, want)
    counted = 0 if route == "compiling" else 1      # a trace runs nothing
    assert _routes(user) == dict(before, eager=before["eager"] + counted)
    assert cache._graphs == {}


class _Fit(torch.nn.Module):
    def forward(self, p1, p2):
        return tego._eight_point(p1, p2)


class _Step(torch.nn.Module):
    def forward(self, im1f, warp, u, v, lap_para):
        return tc.GRAPHS.replay(tc._irls_planes, (im1f, warp, u, v, lap_para),
                                alpha=0.02, noise_model="lap")


@pytest.mark.parametrize("user", USERS)
def test_calls_export_as_plain_ops(user):
    """Under torch.export the call traces as its eager operations, and the
    trace counts nothing."""
    if user == "qr_graph":
        module, args, op = _Fit(), _samples(2, 4, seed=1), "linalg_qr"
        want = _eight_point_as_written(*args)
    else:
        module, op = _Step(), "sqrt"
        args = _tensors(_level(B=1, H=6, W=7, seed=4), "lap")
        want = tc._irls_planes(*args, alpha=0.02, noise_model="lap")
    before = _routes(user)
    ep = torch.export.export(module, args)
    targets = {str(n.target) for n in ep.graph.nodes
               if n.op == "call_function"}
    assert any(op in t for t in targets), targets
    _assert_equal(ep.module()(*args), want)
    assert _routes(user) == before


@pytest.mark.parametrize("user", USERS)
def test_graph_key_separates_what_the_capture_bakes_in(user):
    if user == "qr_graph":
        A = _design(*_samples(3, 5, seed=8))
        fn, tensors, consts = qr_graph.sliced_q, (A,), {}
        others = [((_design(*_samples(4, 5, seed=8)),), {}),
                  ((_design(*_samples(3, 6, seed=8)),), {}),
                  ((A.double(),), {})]
        other_fn = qr_graph.eager_q
    else:
        level = _level(seed=8)
        fn, tensors, consts = tc._irls_planes, _tensors(level, "lap"), LAP
        others = [(tensors, dict(LAP, alpha=0.02)),
                  (tensors, dict(LAP, noise_model="gmm")),
                  (_tensors(level, "gmm"), LAP),
                  (_tensors(_level(B=3, seed=8), "lap"), LAP),
                  (_tensors(_level(H=12, seed=8), "lap"), LAP),
                  (_tensors(_level(C=3, seed=8), "lap"), LAP),
                  (tuple(t.double() for t in tensors), LAP)]
        other_fn = tc.get_dxs
    base = cuda_graph.graph_key(fn, tensors, consts)
    # new contents, same key
    assert cuda_graph.graph_key(fn, tuple(t + 1 for t in tensors),
                                consts) == base
    keys = [cuda_graph.graph_key(fn, ts, c) for ts, c in others]
    keys.append(cuda_graph.graph_key(other_fn, tensors, consts))
    assert len({base, *keys}) == 1 + len(keys)


def test_flow_imports_nothing_from_geometry3d():
    """The flow layer sits below ego-motion: its graph cache is the shared
    one in utils, not the QR's."""
    for path in Path(tc.__file__).parent.rglob("*.py"):
        for node in ast.walk(ast.parse(path.read_text())):
            if isinstance(node, ast.ImportFrom):
                names = [node.module or ""] + [a.name for a in node.names]
            elif isinstance(node, ast.Import):
                names = [a.name for a in node.names]
            else:
                continue
            assert not any("geometry3d" in n.split(".") for n in names), \
                (path.name, node.lineno)


# ---------------------------------------------------------------------------
# the IRLS planes
# ---------------------------------------------------------------------------

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
    assert len(got) == 9
    _assert_equal(got, want)


def test_warm_start_steps_run_eagerly(monkeypatch):
    """n_inner = 2: the first inner step goes to the graph cache (eager on
    the CPU), the warm start straight to ``run_eager`` with the first SOR's
    du, dv; every step is counted eager."""
    calls = []
    real = tc.GRAPHS.run_eager

    def spy(fn, tensors, **consts):
        calls.append(sorted(consts))
        return real(fn, tensors, **consts)
    monkeypatch.setattr(tc.GRAPHS, "run_eager", spy)
    im1, im2 = _level(B=1, H=24, W=40, C=3, seed=5)[:2]
    before, steps = _routes("liu_graph"), COUNTERS["liu.irls_steps"]
    tc.coarse2fine_flow(im1, im2, alpha=0.02, ratio=0.75, min_width=30,
                        n_outer=2, n_inner=2, n_sor=3)
    assert COUNTERS["liu.irls_steps"] - steps == 2      # one level
    assert calls == [["alpha", "noise_model"],
                     ["alpha", "du", "dv", "noise_model"]] * 2
    assert _routes("liu_graph") == dict(before, eager=before["eager"] + 4)


@pytest.mark.parametrize("noise_model", ["lap", "gmm"])
def test_cpu_solve_counts_every_irls_step_eager(noise_model):
    level = _level(B=2, H=30, W=44, C=3, seed=7)
    before, steps = _routes("liu_graph"), COUNTERS["liu.irls_steps"]
    tc.coarse2fine_flow_batched(level[0], level[1], alpha=0.01, ratio=0.75,
                                min_width=20, n_outer=2, n_sor=3,
                                noise_model=noise_model)
    n = COUNTERS["liu.irls_steps"] - steps
    assert n == 3 + 2                   # 2 levels, n_outer + k steps each
    assert _routes("liu_graph") == dict(before, eager=before["eager"] + n)


def test_irls_graph_bound_holds_the_loaders_two_batches_of_levels():
    """The trainer's schedule at the working size has 8 levels; the loader
    solves a full chunk and a last, shorter one."""
    shapes = tc.pyramid_shapes(180, 320, 0.75, 30)
    assert len(shapes) == 8
    assert tc.GRAPHS.max_graphs >= 2 * len(shapes)


# ---------------------------------------------------------------------------
# the QR's slices
# ---------------------------------------------------------------------------

def test_qr_graph_slices_keep_two_matrices():
    for n in range(1, 9000):
        k = qr_graph.slices(n)
        assert 1 <= k <= qr_graph.MAX_SLICES
        assert k == 1 or n // k >= 2    # cuBLAS's batched geqrf in each
        assert k == min(qr_graph.MAX_SLICES, max(1, n // 2))
