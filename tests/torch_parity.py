"""Shared inputs for the PyTorch-port parity tests (tests/test_torch_*.py):
small geometries and calibrations built identically in both packages,
trunk weights and frames made from numpy seeds."""

import dataclasses

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.geometry3d import calibration as jcal
from depth_estimation_tpu_torch.geometry import Geometry as TGeometry
from depth_estimation_tpu_torch.geometry3d import calibration as tcal
from depth_estimation_tpu_torch.models import io as tio

LAYERS = ((3, 5, 5, 8),)


def geometries(h, w, layers=LAYERS, maxh=6, maxw=6):
    """(JAX Geometry, port Geometry) with the same fields."""
    kw = dict(hImg=h, wImg=w, layers=layers, maxh=maxh, maxw=maxw)
    return JGeometry(**kw), TGeometry(**kw)


def calibrations(h, w, f=80.0, max_points=128):
    """(JAX Calibration, port Calibration): a pinhole camera at (h, w)."""
    def make(mod):
        base = mod.RECTIFIED_GOPRO_SMALL
        return dataclasses.replace(
            base, name="t", wImg=w, hImg=h, fx=f, fy=f, cx=w / 2, cy=h / 2,
            sfm=dataclasses.replace(base.sfm, max_points=max_points))
    return make(jcal), make(tcal)


def trunk_params(seed, layers=LAYERS):
    """Flax-layout trunk tree of numpy arrays (dense layers only)."""
    rng = np.random.RandomState(seed)
    p = {}
    for i, (cin, kh, kw, cout) in enumerate(layers):
        fan = kh * kw * cin
        p[f"layer{i + 1}"] = {
            "kernel": (rng.randn(kh, kw, cin, cout) / np.sqrt(fan)).astype(np.float32),
            "bias": (0.1 * rng.randn(cout)).astype(np.float32)}
    return {"params": p}


def to_jax(tree):
    return jax.tree.map(jnp.asarray, tree)


def texture(rng, h, w):
    """Smooth random RGB texture with enough corners for Shi-Tomasi."""
    base = rng.rand(h // 4, w // 4, 3).astype(np.float32)
    return np.asarray(jax.image.resize(jnp.asarray(base), (h, w, 3), "bilinear"))


def shift_x(img, disp):
    """img (H, W, C) sampled at x + disp(y, x) (linear, edge-clamped)."""
    h, w = img.shape[:2]
    xs = np.clip(np.arange(w)[None, :] + disp, 0, w - 1)
    x0 = np.floor(xs).astype(int)
    x1 = np.minimum(x0 + 1, w - 1)
    f = (xs - x0)[..., None]
    rows = np.arange(h)[:, None]
    return ((1 - f) * img[rows, x0] + f * img[rows, x1]).astype(np.float32)


def parallax_frames(rng, h, w, n=2, lo=1.0, hi=5.0):
    """n frames of a camera stepping sideways over a scene whose depth
    varies smoothly: frame k is frame 0 shifted by k times a disparity map
    in [lo, hi] px. Unlike a uniform shift, the essential matrix of such a
    pair is determined by the points, so RANSAC's answer does not hinge on
    rounding."""
    img = texture(rng, h, w)
    coarse = rng.rand(3, 4)
    yy = np.linspace(0, 2, h)[:, None]
    xx = np.linspace(0, 3, w)[None, :]
    y0, x0 = np.floor(yy).astype(int), np.floor(xx).astype(int)
    y1, x1 = np.minimum(y0 + 1, 2), np.minimum(x0 + 1, 3)
    fy, fx = yy - y0, xx - x0
    d = ((1 - fy) * (1 - fx) * coarse[y0, x0] + (1 - fy) * fx * coarse[y0, x1]
         + fy * (1 - fx) * coarse[y1, x0] + fy * fx * coarse[y1, x1])
    disp = lo + (hi - lo) * d
    return [img] + [shift_x(img, k * disp) for k in range(1, n)]


def ransac_noise(n_samples, n):
    """The reference's RANSAC Gumbel noise (key 1), as numpy."""
    return np.array(jax.random.gumbel(jax.random.PRNGKey(1), (n_samples, 8, n)))


def pipeline_case(h=96, w=128, n_points=200):
    """Geometries (8x8 window: decode mode keeps a 2 px rotation margin),
    calibrations, trunk weights and a 3-frame parallax stream of B=2 items.

    Seeds 3 and 5: at 96x128 the reference's winning RANSAC sample is 8
    distinct points on both steps. RANSAC draws its 8 indices with
    replacement; when the winner repeats a point, its nullspace is 2-D and
    E is whatever the QR build returns, so the packages part there (4 of 40
    steps of seeds 0-19 at 96x128, by 0.5-1 px of x-flow)."""
    jg, tg = geometries(h, w, maxh=8, maxw=8)
    jc, tc = calibrations(h, w, f=100.0, max_points=n_points)
    seqs = [parallax_frames(np.random.RandomState(s), h, w, n=3) for s in (3, 5)]
    frames = [np.stack([s[k] for s in seqs]) for k in range(3)]
    return dict(jg=jg, tg=tg, jc=jc, tc=tc, params=trunk_params(0),
                frames=frames, n_points=n_points)


def run_batched_both(case, share_state=False, **knobs):
    """Two steps of both packages' BatchedDepthEstimator with ``knobs``
    (torch dtypes; mapped to jnp for the reference), on the same weights,
    frames and RANSAC noise. With ``share_state`` the port takes every
    frame's prep (resize, undistort, trunk, storage rounding) from the
    reference, so both run ego-motion and matching on the same state.
    Returns [(port outputs, JAX outputs)] per step as numpy (xflow, mask,
    depth, good)."""
    import torch
    from depth_estimation_tpu import api as japi
    from depth_estimation_tpu_torch import api_batched as tapi
    jknobs = dict(knobs)
    for k in ("match_dtype", "warp_dtype", "state_dtype"):
        if k in knobs:
            jknobs[k] = {torch.bfloat16: jnp.bfloat16,
                         torch.float16: jnp.float16,
                         torch.float32: jnp.float32}[knobs[k]]
    noise = ransac_noise(knobs.get("ransac_samples", 64), case["n_points"])
    ours = tapi.BatchedDepthEstimator(case["tg"], case["params"], case["tc"],
                                      ransac_noise=noise, device="cpu", **knobs)
    ref = japi.BatchedDepthEstimator(case["jg"], to_jax(case["params"]),
                                     case["jc"], **jknobs)
    if share_state:
        dt = knobs.get("state_dtype") or torch.float32

        def prep(frames):
            return tuple(torch.tensor(np.asarray(x.astype(jnp.float32))).to(dt)
                         for x in ref._prep(ref.params, jnp.asarray(frames.numpy())))
        ours._prep = prep
    frames = case["frames"]
    ours.reset(frames[0])
    ref.reset(jnp.asarray(frames[0]))
    out = []
    for f in frames[1:]:
        a = [x.numpy() for x in ours.next_frames(f)]
        b = [np.asarray(x) for x in ref.next_frames(jnp.asarray(f))]
        out.append((a, b))
    return out


# ---------------------------------------------------------------------------
# the CLI parity tests (test_torch_cli_*.py, test_torch_robotics_loop.py)
# ---------------------------------------------------------------------------

@pytest.fixture(autouse=True, scope="module")
def one_torch_thread():
    """One torch intra-op thread for a module that imports this fixture:
    the test run puts six workers on the CPU's cores, and torch's pool of
    a thread a core in each then oversubscribes them (the CLI files ran
    4-15x slower there than alone, and as fast alone on one thread)."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def start_from(monkeypatch, cls, tree):
    """The port trainer's ``init`` loads the JAX CLI's initial tree."""
    def init(self, generator):
        tio.load_tree_into(self.model, jax.tree.map(np.asarray, tree))
        return self.reset_optimizer()
    monkeypatch.setattr(cls, "init", init)


def record(monkeypatch, mod, name, into):
    fn = getattr(mod, name)

    def wrapped(*a, **k):
        into.append(fn(*a, **k))
        return into[-1]
    monkeypatch.setattr(mod, name, wrapped)


def assert_trees_close(ours, ref, atol):
    assert (jax.tree_util.tree_structure(jax.tree.map(np.asarray, ours))
            == jax.tree_util.tree_structure(jax.tree.map(np.asarray, ref)))
    for a, b in zip(jax.tree.leaves(ours), jax.tree.leaves(ref)):
        np.testing.assert_allclose(np.asarray(a), np.asarray(b), rtol=0,
                                   atol=atol)


def read_weights(path, template):
    with open(path, "rb") as f:
        return flax.serialization.from_bytes(template, f.read())
