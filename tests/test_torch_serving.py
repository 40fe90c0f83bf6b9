"""The port's serving exports (``depth_estimation_tpu_torch/serving.py``):
each artifact against the port's live program and against the JAX
package's live (jitted) program on the same weights and inputs, the
``tools export`` CLI on checkpoint directories the JAX package wrote, the
exported graphs, a hermetic load, and the two kernels' operators.

Sizes are those of tests/test_serving.py. Tolerances:
  * artifact vs the port's live program: equal (the artifact runs the
    same torch ops on the same CPU in the same order);
  * single-scale vs JAX: idx equal except at exact-cost ties, ey / ex /
    pmax within 1e-5 (tests/test_torch_api.py);
  * multiscale: idx equal, pmax within 1e-6; radial and version2: flows
    equal, min cost within 1e-5; legacy: the class map equal;
  * the pipeline vs JAX: as tests/test_torch_pipeline.py, on its scene
    (x-flow within 1e-3 where both masks keep a pixel, masks agreeing on
    >= 0.999 of the pixels, ``good`` equal).
"""

import json
import os
import subprocess
import sys

import flax.serialization
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu import codecs as jcodecs
from depth_estimation_tpu import serving as jserving
from depth_estimation_tpu.geometry import Geometry as JGeometry, Learning as JLearning
from depth_estimation_tpu.models import io as jmio
from depth_estimation_tpu.models.flow import FlowModel as JFlowModel
from depth_estimation_tpu.models.legacy_depth import DepthClassifierCNN as JCNN
from depth_estimation_tpu.models.multiscale import MultiscaleFlowModel as JMultiscale
from depth_estimation_tpu.models.radial import RadialFlowNetwork as JRadial
from depth_estimation_tpu.models.version2 import V2Network as JV2, V2Params as JV2Params
from depth_estimation_tpu_torch import serving
from depth_estimation_tpu_torch.cli import tools
from depth_estimation_tpu_torch.geometry import Geometry as TGeometry
from depth_estimation_tpu_torch.models import io as tio
from depth_estimation_tpu_torch.models.flow import FlowModel as TFlowModel
from depth_estimation_tpu_torch.models.legacy_depth import DepthClassifierCNN as TCNN
from depth_estimation_tpu_torch.models.multiscale import MultiscaleFlowModel as TMultiscale
from depth_estimation_tpu_torch.models.radial import RadialFlowNetwork as TRadial
from depth_estimation_tpu_torch.models.version2 import V2Network as TV2, V2Params as TV2Params
from depth_estimation_tpu_torch.ops import matching, warp
from torch_parity import pipeline_case, ransac_noise

REPO = os.path.join(os.path.dirname(__file__), "..")
TINY = dict(hImg=32, wImg=40, layers=((3, 5, 5, 6),), maxh=4, maxw=4)
MULTI = dict(hImg=24, wImg=32, layers=((3, 5, 5, 6),), maxh=4, maxw=4,
             multiscale=True, ratios=(1, 2))
RADIAL_LAYERS, RADIAL_HWIN, RADIAL_HW = ((3, 5, 5, 8), "tanh", (8, 3, 3, 8)), 5, (40, 48)
V2 = dict(wImg=48, hImg=40, normalization_k=5, layers=((3, 5, 5, 6),),
          hWin=5, wWin=5)
LEGACY_CLASSES, LEGACY_HW = 3, (56, 64)
TOL_FLOW = 1e-5
TOL_COST = 1e-5
TOL_PMAX_MS = 1e-6
ATOL_PIPE = 1e-3
SHARE_MASK = 0.999
OPS = ("depth_estimation_tpu_torch.match_flow_fused",
       "depth_estimation_tpu_torch.banded_bilinear_warp")


def numpy_tree(tree):
    return jax.tree.map(np.asarray, tree)


def images(seed, h, w, c=3, n=2):
    rng = np.random.RandomState(seed)
    return [rng.rand(h, w, c).astype(np.float32) for _ in range(n)]


def run_artifact(path, *arrays):
    out = serving.load_exported(path).module()(*(torch.from_numpy(a) for a in arrays))
    return [o.numpy() for o in (out if isinstance(out, (tuple, list)) else (out,))]


def export_cli(model_dir, out, *extra):
    assert tools.main(["export", str(model_dir), "--out", str(out),
                       "--device", "cpu", *extra]) == 0
    return str(out)


def targets(path):
    ep = serving.load_exported(path)
    return [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]


# ---------------------------------------------------------------------------
# flow forward (single-scale, B1)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def flow_dir(tmp_path_factory):
    """A single-scale model dir written by the JAX package's save_model."""
    g = JGeometry(**TINY)
    params = JFlowModel(g).init(jax.random.PRNGKey(0))
    d = str(tmp_path_factory.mktemp("flow"))
    jmio.save_model(d, g, JLearning(rate=1e-2, batch_size=4, criterion="nll"),
                    params)
    return d, g, params


@pytest.mark.parametrize("bf16", [False, True])
def test_flow_forward_artifact_matches_live_and_jax(flow_dir, tmp_path, bf16):
    d, jg, jparams = flow_dir
    out = export_cli(d, tmp_path / "fwd.pt2", *(["--bf16"] if bf16 else []))
    a, b = images(3, jg.hImg, jg.wImg)
    got = run_artifact(out, a, b)

    tg = TGeometry(**TINY)
    live = tio.load_tree_into(TFlowModel(tg, device="cpu"), numpy_tree(jparams))
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    from depth_estimation_tpu_torch.models.flow import crop_features_center
    f1 = crop_features_center(tg, live.features(ta))
    want = matching.match_flow_fused(f1, live.features(tb), tg.maxh, tg.maxw,
                                     8, False,
                                     torch.bfloat16 if bf16 else torch.float32)
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y.numpy())
    assert "depth_estimation_tpu_torch.match_flow_fused.default" in targets(out)
    if bf16:
        return
    ref = [np.asarray(x) for x in jax.jit(JFlowModel(jg).forward_fused)(
        jparams, jnp.asarray(a), jnp.asarray(b))]
    costs = np.asarray(JFlowModel(jg).costs(jparams, jnp.asarray(a), jnp.asarray(b)))
    differ = got[0] != ref[0]
    # an index may differ only where the two cells' costs tie exactly
    rows = np.nonzero(differ)
    assert np.all(costs[rows + (got[0][differ],)] == costs[rows + (ref[0][differ],)])
    for x, y in zip(got[1:], ref[1:]):
        np.testing.assert_allclose(x, y, rtol=0, atol=TOL_FLOW)


def test_export_detects_every_layout_as_jax_does(flow_dir, tmp_path):
    d = flow_dir[0]
    layouts = {"flow": d}
    r = tmp_path / "radial"
    r.mkdir()
    (r / "meta.json").write_text(json.dumps(
        {"version": 1, "layers": [list(l) for l in RADIAL_LAYERS],
         "hWin": RADIAL_HWIN}))
    layouts["radial"] = str(r)
    v = tmp_path / "v2"
    v.mkdir()
    (v / "meta.json").write_text(json.dumps({"version": 1, "family": "version2"}))
    layouts["v2"] = str(v)
    bare = tmp_path / "bare"
    bare.mkdir()
    (bare / "e3").write_bytes(b"")
    layouts["bare"] = str(bare)
    dep = tmp_path / "depth"
    dep.mkdir()
    (dep / "meta.json").write_text(json.dumps({"n_classes": 2, "cut_depth": 2.0}))
    layouts["depth"] = str(dep)
    for name, path in layouts.items():
        assert serving.detect_family(path) == jserving.detect_family(path), name
    odd = tmp_path / "odd"
    odd.mkdir()
    (odd / "meta.json").write_text(json.dumps({"what": 1}))
    for mod in (serving, jserving):
        with pytest.raises(ValueError):
            mod.detect_family(str(odd))


# ---------------------------------------------------------------------------
# the other families, through `tools export` on JAX-written directories
# ---------------------------------------------------------------------------

def test_multiscale_artifact_matches_live_and_jax(tmp_path):
    jg = JGeometry(**MULTI)
    jm = JMultiscale(jg)
    params = jm.init(jax.random.PRNGKey(4))
    d = str(tmp_path / "ms")
    jmio.save_model(d, jg, JLearning(), params)
    out = export_cli(d, tmp_path / "ms.pt2")
    a, b = images(5, jg.hImg, jg.wImg)
    got = run_artifact(out, a, b)
    live = tio.load_tree_into(TMultiscale(TGeometry(**MULTI), device="cpu"),
                              numpy_tree(params))
    want = live.decode_full(torch.from_numpy(a), torch.from_numpy(b))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y.numpy())
    ref = jax.jit(jm.decode_full)(params, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), rtol=0,
                               atol=TOL_PMAX_MS)


@pytest.mark.parametrize("letters", [False, True])
def test_radial_artifact_matches_live_and_jax(tmp_path, letters):
    """The radial trainer's layout: meta.json layers/hWin and e<N>.msgpack.
    With ``letters`` the meta spells 'tanh' as the JAX radial CLI writes
    it, ["t", "a", "n", "h"] (ROADMAP C25); the port reads 'tanh'."""
    jnet = JRadial(RADIAL_LAYERS, RADIAL_HWIN)
    params = jnet.init(jax.random.PRNGKey(6))
    d = tmp_path / "mr"
    d.mkdir()
    spec = [list(l) if letters or not isinstance(l, str) else l
            for l in RADIAL_LAYERS]
    (d / "meta.json").write_text(json.dumps(
        {"version": 1, "layers": spec, "hWin": RADIAL_HWIN}))
    (d / "e0.msgpack").write_bytes(b"stale")
    (d / "e2.msgpack").write_bytes(flax.serialization.to_bytes(params))
    assert serving.radial_layers(spec) == RADIAL_LAYERS
    out = export_cli(d, tmp_path / "radial.pt2", "--hw", *map(str, RADIAL_HW))
    a, b = images(7, *RADIAL_HW)
    got = run_artifact(out, a, b)
    live = tio.load_tree_into(TRadial(RADIAL_LAYERS, RADIAL_HWIN, device="cpu"),
                              numpy_tree(params))
    want = live.flow(torch.from_numpy(a), torch.from_numpy(b))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y.numpy())
    ref = jax.jit(jnet.flow)(params, jnp.asarray(a), jnp.asarray(b))
    np.testing.assert_array_equal(got[0], np.asarray(ref[0]))
    np.testing.assert_allclose(got[1], np.asarray(ref[1]), rtol=0, atol=TOL_COST)


def _jax_v2_decode(net, params, a, b):
    costs = net.costs(params, a, b)
    idx = jnp.argmin(costs, axis=-1).astype(jnp.int32)
    dy, dx = jcodecs.decode(net.geometry, idx)
    return dy, dx, jnp.min(costs, axis=-1)


def test_v2_artifact_matches_live_and_jax(tmp_path, monkeypatch):
    """The version2 layouts: meta.json beside e<N>, and bare e<N> payloads
    (read with the default V2Params)."""
    jnet = JV2(JV2Params(**V2))
    params = jnet.init(jax.random.PRNGKey(8))
    d = tmp_path / "mv2"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps(
        {"version": 1, "family": "version2", **V2,
         "layers": [list(l) for l in V2["layers"]]}))
    (d / "e0").write_bytes(flax.serialization.to_bytes(params))
    out = export_cli(d, tmp_path / "v2.pt2")
    a, b = images(9, V2["hImg"], V2["wImg"])
    got = run_artifact(out, a, b)
    live = tio.load_tree_into(TV2(TV2Params(**V2), device="cpu"),
                              numpy_tree(params))
    with torch.no_grad():
        want = serving._v2_decode(live, torch.from_numpy(a), torch.from_numpy(b))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y.numpy())
    ref = jax.jit(lambda x, y: _jax_v2_decode(jnet, params, x, y))(
        jnp.asarray(a), jnp.asarray(b))
    for x, y in zip(got[:2], ref[:2]):
        np.testing.assert_array_equal(x, np.asarray(y))
    np.testing.assert_allclose(got[2], np.asarray(ref[2]), rtol=0, atol=TOL_COST)

    # bare payloads: the JAX CLI's reader builds V2Params() and restores
    # the latest e<N> into it; the port hands its exporter the same
    (d / "meta.json").unlink()
    seen = {}
    monkeypatch.setattr(serving, "export_v2_forward",
                        lambda datap, params, path, device: seen.update(
                            datap=datap, params=params) or b"")
    export_cli(d, tmp_path / "bare.pt2")
    assert seen["datap"] == TV2Params()
    assert jax.tree.structure(seen["params"]) == jax.tree.structure(
        numpy_tree(params))


def test_legacy_artifact_matches_live_and_jax(tmp_path):
    jm = JCNN(n_classes=LEGACY_CLASSES)
    params = jax.jit(jm.init)(jax.random.PRNGKey(10),
                              jnp.zeros((1, 48, 48, 2), jnp.float32))
    d = tmp_path / "md"
    d.mkdir()
    (d / "meta.json").write_text(json.dumps(
        {"n_classes": LEGACY_CLASSES, "cut_depth": 2.0, "bin_step": 1.0,
         "patch": 48}))
    (d / "params.msgpack").write_bytes(flax.serialization.to_bytes(params))
    out = export_cli(d, tmp_path / "depth.pt2", "--hw", *map(str, LEGACY_HW))
    (x,) = images(11, *LEGACY_HW, c=2, n=1)
    (got,) = run_artifact(out, x)
    live = tio.load_tree_into(TCNN(LEGACY_CLASSES, device="cpu"),
                              numpy_tree(params))
    with torch.no_grad():
        want = serving._class_map(live, torch.from_numpy(x))
    np.testing.assert_array_equal(got, want.numpy())
    ref = jnp.argmax(jax.jit(jm.apply)(params, jnp.asarray(x)[None])[0], axis=-1)
    np.testing.assert_array_equal(got, np.asarray(ref))


# ---------------------------------------------------------------------------
# the batched online program (B1, and B3 under torch.cond)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def pipe():
    """tests/test_torch_pipeline.py's case (96x128, f 100, 200 corners, a
    (3,5,5,8) trunk with an 8x8 window, B=2 parallax pairs of seeds 3 and
    5, as uint8) with the JAX draw as RANSAC noise; the artifact exported in 'warp'
    mode and loaded once. (tests/test_serving.py's 48x64 'srv' scene is not
    used: with 64 corners on it RANSAC's winner repeats points on every
    seed tried, 0-11, and the two packages' R part by up to 0.8 px of
    x-flow, ROADMAP C9.)"""
    c = pipeline_case()
    c["noise"] = ransac_noise(64, c["n_points"])
    c["pair"] = [(f * 255).astype(np.uint8) for f in c["frames"][:2]]
    c["bytes"] = serving.export_pipeline_pairs(
        c["tg"], c["params"], c["tc"], 2, frame_hw=c["frames"][0].shape[1:3],
        device="cpu", ransac_noise=c["noise"])
    c["program"] = serving.load_exported(c["bytes"])
    return c


def test_pipeline_artifact_matches_live_and_jax(pipe):
    c = pipe
    got = [o.numpy() for o in c["program"].module()(
        *(torch.from_numpy(f) for f in c["pair"]))]
    from depth_estimation_tpu_torch import api_batched as tapi
    live = tapi.make_batched_pipeline(c["tg"], c["tc"], device="cpu",
                                      ransac_noise=c["noise"])
    want = live(c["params"], *(torch.from_numpy(f) for f in c["pair"]))
    for x, y in zip(got, want):
        np.testing.assert_array_equal(x, y.numpy())

    from depth_estimation_tpu import api_batched as japi
    ref = [np.asarray(x) for x in japi.make_batched_pipeline(c["jg"], c["jc"])(
        jax.tree.map(jnp.asarray, c["params"]),
        *(jnp.asarray(f) for f in c["pair"]))]
    xf, m, depth, good = got
    np.testing.assert_array_equal(good, ref[3])
    assert good.all()
    assert ((m > 0) == (ref[1] > 0)).mean() >= SHARE_MASK
    sel = (m > 0) & (ref[1] > 0)
    assert sel.mean() > 0.3
    np.testing.assert_allclose(xf[sel], ref[0][sel], rtol=0, atol=ATOL_PIPE)


def test_pipeline_export_draws_the_live_noise(pipe, monkeypatch):
    """Without ``ransac_noise`` the exporter draws RANSAC's noise once as
    the live step draws it (seeded 1, one row a corner the selector
    returns at the ego-motion size), and hands it to the trace."""
    from depth_estimation_tpu_torch.geometry3d import egomotion as ego
    c = pipe
    seen = {}
    monkeypatch.setattr(serving, "export_jitted",
                        lambda module, ex, path: seen.update(module=module) or b"")
    for knobs in ({}, dict(corner_selector="grid", ego_downsample=2,
                           ransac_samples=48)):
        serving.export_pipeline_pairs(c["tg"], c["params"], c["tc"], 2,
                                      frame_hw=(96, 128), device="cpu", **knobs)
        est = seen["module"].est
        u = torch.zeros((1, 96 // est.ego_downsample, 128 // est.ego_downsample, 3))
        pts, _ = ego.good_features_to_track_batched(
            u, c["tc"].sfm.max_points, selector=est.corner_selector)
        want = ego.gumbel_noise(est.ransac_samples, pts.shape[1], "cpu")
        assert torch.equal(est.ransac_noise, want)


def test_pipeline_graph_keeps_both_warp_branches(pipe):
    """'warp' mode exports its choice as a cond node whose true branch is
    the banded warp (B3's operator) and whose false branch is the gather;
    B1 is one node of the graph."""
    ep = pipe["program"]
    assert ep.example_inputs is None        # the zeros are not carried
    conds = [n for n in ep.graph.nodes if n.op == "call_function"
             and "cond" in str(n.target)]
    assert len(conds) == 1
    true_g, false_g = (getattr(ep.graph_module, a.target)
                       for a in conds[0].args[1:3])

    def calls(gm):
        return {str(n.target) for n in gm.graph.nodes if n.op == "call_function"}
    assert OPS[1] + ".default" in calls(true_g)
    assert not any(OPS[1] in t for t in calls(false_g))
    top = [str(n.target) for n in ep.graph.nodes if n.op == "call_function"]
    assert top.count(OPS[0] + ".default") == 1


class _Exact(torch.nn.Module):
    def forward(self, imgs, K, R):
        from depth_estimation_tpu_torch.geometry3d import undistort
        return undistort.remove_ego_motion_exact(imgs, K, R, 3)


def test_exact_warp_traces_a_cond_and_reads_its_predicate_eagerly(monkeypatch):
    """``remove_ego_motion_exact`` is one ``cond`` node under torch.export
    and the artifact takes the branch the eager call takes, in band and out
    of it, with equal results; the eager call never reaches torch.cond."""
    def rot(ay, az):
        cy, sy, cz, sz = np.cos(ay), np.sin(ay), np.cos(az), np.sin(az)
        return (np.array([[cy, 0, sy], [0, 1, 0], [-sy, 0, cy]])
                @ np.array([[cz, -sz, 0], [sz, cz, 0], [0, 0, 1]])).astype(np.float32)
    K = torch.tensor([[30.0, 0, 16], [0, 30.0, 12], [0, 0, 1]])
    imgs = torch.from_numpy(np.random.RandomState(5).rand(2, 24, 32, 4)
                            .astype(np.float32))
    in_band = torch.from_numpy(np.stack([rot(0.02, 0.01)] * 2))
    out_band = torch.from_numpy(np.stack([rot(-0.06, 0.03), rot(0.15, -0.05)]))
    program = serving.load_exported(serving.export_jitted(
        _Exact(), (imgs, K, in_band.clone())))
    conds = [n for n in program.graph.nodes if n.op == "call_function"
             and "cond" in str(n.target)]
    assert len(conds) == 1
    from depth_estimation_tpu_torch.geometry3d import undistort
    eager = {}
    monkeypatch.setattr(torch, "cond", None)
    for name, R in (("in", in_band), ("out", out_band)):
        eager[name] = undistort.remove_ego_motion_exact(imgs, K, R, 3)
    monkeypatch.undo()
    assert bool(undistort.warp_in_band(K, in_band, 24, 32, 3))
    assert not bool(undistort.warp_in_band(K, out_band, 24, 32, 3))
    for name, R in (("in", in_band), ("out", out_band)):
        got = program.module()(imgs, K, R)
        torch.testing.assert_close(got, eager[name], rtol=0, atol=0)


# ---------------------------------------------------------------------------
# hermetic load, operators
# ---------------------------------------------------------------------------

def test_artifact_loads_without_the_models_or_jax(flow_dir, tmp_path):
    out = export_cli(flow_dir[0], tmp_path / "fwd.pt2")
    a, b = images(3, TINY["hImg"], TINY["wImg"])
    np.save(tmp_path / "a.npy", a)
    np.save(tmp_path / "b.npy", b)
    want = run_artifact(out, a, b)
    np.save(tmp_path / "want.npy", np.stack(want[1:]))
    code = (
        "import sys, numpy as np, torch\n"
        "from depth_estimation_tpu_torch import serving\n"
        f"d = {str(tmp_path)!r}\n"
        "ep = serving.load_exported(d + '/fwd.pt2')\n"
        "a, b = (torch.from_numpy(np.load(d + f)) for f in ('/a.npy', '/b.npy'))\n"
        "idx, ey, ex, pmax = ep.module()(a, b)\n"
        "assert np.array_equal(np.stack([ey, ex, pmax]), np.load(d + '/want.npy'))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', "
        "'depth_estimation_tpu') or m.startswith('depth_estimation_tpu_torch.models')]\n"
        "assert not bad, bad\n"
        "print('ok')\n")
    env = dict(os.environ)
    env.pop("PYTHONPATH", None)
    res = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=300)
    assert res.returncode == 0, res.stderr
    assert res.stdout.strip() == "ok"


@pytest.mark.parametrize("mode", ["plain", "conf", "marg", "bf16", "f16"])
def test_match_flow_fused_operator_passes_opcheck(mode):
    rng = np.random.RandomState(12)
    f1 = torch.from_numpy(rng.rand(2, 5, 6, 4).astype(np.float32))
    f2 = torch.from_numpy(rng.rand(2, 8, 9, 4).astype(np.float32))
    storage = {"bf16": 1, "f16": 2}.get(mode, 0)
    torch.library.opcheck(matching.match_flow_fused_op,
                          (f1, f2, 4, 4, mode == "marg", storage,
                           mode == "conf", 0.11))


@pytest.mark.parametrize("dt", [torch.float32, torch.bfloat16,
                                torch.float16])
def test_banded_bilinear_warp_operator_passes_opcheck(dt):
    rng = np.random.RandomState(13)
    imgs = torch.from_numpy(rng.rand(2, 7, 9, 3).astype(np.float32)).to(dt)
    ys = torch.from_numpy((np.arange(7)[None, :, None]
                           + 3 * rng.randn(2, 7, 9)).astype(np.float32))
    xs = torch.from_numpy((np.arange(9)[None, None, :]
                           + 3 * rng.randn(2, 7, 9)).astype(np.float32))
    torch.library.opcheck(warp.banded_bilinear_warp_op, (imgs, xs, ys, 2))


def test_wrappers_keep_their_outputs():
    """The public wrappers return what they returned before they went
    through the fixed-schema operator: 4 outputs, or 5 with the marginal
    or the gate, without the leading batch dim for 3-D features."""
    rng = np.random.RandomState(14)
    f1 = torch.from_numpy(rng.rand(5, 6, 4).astype(np.float32))
    f2 = torch.from_numpy(rng.rand(8, 9, 4).astype(np.float32))
    assert [tuple(o.shape) for o in matching.match_flow_fused(f1, f2, 4, 4)] \
        == [(5, 6)] * 4
    marg = matching.match_flow_fused(f1, f2, 4, 4, want_marg=True)
    assert tuple(marg[4].shape) == (4, 5, 6)
    conf = matching.match_flow_fused(f1, f2, 4, 4, want_conf=True)
    assert tuple(conf[4].shape) == (5, 6)
    with pytest.raises(ValueError):
        matching.match_flow_fused(f1, f2, 4, 4, dtype=torch.float64)
