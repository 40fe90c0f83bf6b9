"""The port's launch-plan autotuning (``depth_estimation_tpu_torch/ops/
autotune.py``): winner selection and persistence as in the JAX package's
``ops/autotune.py`` (the four cases of tests/test_autotune.py), the
estimator's ``match_block="auto"`` against the JAX package, and what only
the port has: the candidates (every one a plan the kernels take, the
rule's own first), the store's key, a CPU device that times nothing, a
store that concurrent resolutions leave readable, and B1's plan carried
through its operator into an exported program. The card-only cases (every
candidate bitwise equal to the default plan) are in test_torch_cuda.py."""

import json
import threading

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from depth_estimation_tpu import api_batched as japi
from depth_estimation_tpu_torch import api_batched as tapi
from depth_estimation_tpu_torch import serving
from depth_estimation_tpu_torch.ops import _kernels, autotune, matching
from torch_parity import pipeline_case, ransac_noise, to_jax

ATOL = 1e-3         # tests/test_torch_api.py: x-flow where both masks keep


@pytest.fixture
def tuned_store(tmp_path, monkeypatch):
    """Point the autotune store at a tmp file and reset the in-process
    caches."""
    path = tmp_path / "cache" / "autotune.json"
    monkeypatch.setattr(autotune, "store_path", lambda: path)
    monkeypatch.setattr(autotune, "_cache", None)
    monkeypatch.setattr(autotune, "_session_only", {})
    yield path
    autotune._cache = None


def test_pick_selects_fastest_and_persists(tuned_store):
    calls = []

    def timer(fn):
        calls.append(1)
        return {0: 3.0, 1: 1.0, 2: 2.0}[len(calls) - 1]

    got = autotune.pick("k1", lambda c: c, (8, 16, 32), timer=timer)
    assert got == 16
    assert json.loads(tuned_store.read_text())["k1"] == 16

    def exploding_timer(fn):
        raise AssertionError("cache hit must not re-measure")

    autotune._cache = None            # fresh process simulation: reload disk
    assert autotune.pick("k1", lambda c: c, (8, 16, 32),
                         timer=exploding_timer) == 16


def test_pick_skips_failing_candidates(tuned_store):
    def run(c):
        if c == 8:
            raise RuntimeError("match_fused_launch failed with code -2 "
                               "(unsupported configuration)")
        return c

    def timer(fn):
        fn()
        return 1.0

    assert autotune.pick("k2", run, (8, 16), timer=timer) == 16


def test_partial_sweep_not_persisted(tuned_store):
    """A sweep with any failing candidate is answered in-process but never
    written to disk (nor an unmeasured fallback)."""
    def run(c):
        if c == 8:
            raise RuntimeError("refused launch")
        return c

    def timer(fn):
        fn()
        return 1.0

    assert autotune.pick("k3", run, (8, 16), timer=timer) == 16

    def exploding_timer(fn):
        raise AssertionError("session cache must answer without re-measure")

    assert autotune.pick("k3", run, (8, 16), timer=exploding_timer) == 16
    assert not tuned_store.exists() or "k3" not in json.loads(
        tuned_store.read_text())

    # all candidates failing: fallback winner, same no-persist rule
    def all_fail(c):
        raise RuntimeError("refused launch")

    assert autotune.pick("k4", all_fail, (8, 16), timer=timer) == 8
    assert not tuned_store.exists() or "k4" not in json.loads(
        tuned_store.read_text())


def _jax_knobs(knobs):
    out = dict(knobs)
    for k in ("match_dtype", "warp_dtype", "state_dtype"):
        if k in out:
            out[k] = {torch.bfloat16: jnp.bfloat16,
                      torch.float32: jnp.float32}[out[k]]
    return out


@pytest.mark.parametrize("mode", ["warp", "fast"])
def test_estimator_auto_block_matches_fixed(tuned_store, monkeypatch, mode):
    """match_block='auto' resolves B1's plan during reset() (on the CPU the
    rule's plan, untimed: nothing touches the store) and the port's steps
    equal its own fixed block bitwise and the JAX package's at
    match_block=8 within the pipeline tests' bounds (JAX's own 'auto'
    sweep in interpret mode is the slow case)."""
    monkeypatch.setattr(autotune, "_default_timer", None)   # never called
    knobs = dict(compensation="warp") if mode == "warp" else dict(
        compensation="decode", match_dtype=torch.bfloat16,
        warp_dtype=torch.bfloat16, state_dtype=torch.bfloat16,
        ego_downsample=2, lk_iters=5, ransac_samples=48, lk_search=24)
    # fast mode at 192x256, so that ego-motion sees 96x128 as in 'warp'
    # mode (tests/test_torch_api.py)
    c = pipeline_case() if mode == "warp" else pipeline_case(192, 256)
    noise = ransac_noise(knobs.get("ransac_samples", 64), c["n_points"])

    def port(block):
        return tapi.BatchedDepthEstimator(c["tg"], c["params"], c["tc"],
                                          ransac_noise=noise, device="cpu",
                                          match_block=block, **knobs)
    auto, fixed = port("auto"), port(8)
    ref = japi.BatchedDepthEstimator(c["jg"], to_jax(c["params"]), c["jc"],
                                     match_block=8, **_jax_knobs(knobs))
    frames = c["frames"]
    for est in (auto, fixed):
        est.reset(frames[0])
    ref.reset(jnp.asarray(frames[0]))
    assert auto.match_block == "auto" and len(auto._plans) == 1
    g = c["tg"]
    assert list(auto._plans.values()) == [matching.fused_plan(
        g.maxh, g.maxw, g.layers[-1][-1])]
    assert fixed._plans == {}
    assert not tuned_store.exists()
    for f in frames[1:]:
        a = [x.numpy() for x in auto.next_frames(f)]
        b = [x.numpy() for x in fixed.next_frames(f)]
        r = [np.asarray(x) for x in ref.next_frames(jnp.asarray(f))]
        for x, y in zip(a, b):
            np.testing.assert_array_equal(x, y)
        np.testing.assert_array_equal(a[3], r[3])
        assert ((a[1] > 0) == (r[1] > 0)).mean() >= 0.999
        sel = (a[1] > 0) & (r[1] > 0)
        assert sel.mean() > 0.3
        d = np.abs(a[0] - r[0])[sel]
        assert np.percentile(d, 99) <= ATOL and d.max() <= 10 * ATOL


def test_best_plan_on_cpu_times_nothing_and_writes_no_store(tuned_store):
    def exploding_timer(fn):
        raise AssertionError("a CPU device must not be timed")

    for kernel, rule in (("fused", matching.fused_plan),
                         ("fast", matching.match_plan)):
        got = autotune.best_plan(kernel, (2, 30, 40, 10), (2, 45, 55, 10),
                                 16, 16, torch.bfloat16, True, device="cpu",
                                 timer=exploding_timer)
        assert got == rule(16, 16, 10)
    assert not tuned_store.exists() and autotune._cache is None
    with pytest.raises(ValueError, match="kernel"):
        autotune.best_plan("sor", (1, 4, 4, 1), (1, 4, 4, 1), 1, 1,
                           device="cpu")


WINDOWS = [(16, 16, 10), (8, 8, 6), (9, 13, 3), (4, 4, 33), (17, 4, 10),
           (24, 24, 10), (3, 70, 40), (16, 16, 64), (64, 64, 10), (2, 2, 16),
           (16, 16, 100)]


@pytest.mark.parametrize("maxh,maxw,K", WINDOWS)
def test_candidates_are_legal_and_the_rule_comes_first(maxh, maxw, K):
    fused = matching.fused_candidates(maxh, maxw, K)
    assert fused[0] == matching.fused_plan(maxh, maxw, K)
    assert len(set(fused)) == len(fused)
    for p in fused:
        assert p.smem <= matching.SMEM_LIMIT
        assert 1 <= p.block_rows <= min(matching.FUSED_PASS_ROWS, maxh)
        assert 1 <= p.band_cols <= maxw
        # the operator's plan arguments rebuild the same plan
        assert matching._op_plan(maxh, maxw, K, p.general, p.block_rows,
                                 p.band_cols) == p
    for p in fused[1:]:
        assert p.general and p.block_rows in matching.FUSED_CANDIDATE_ROWS

    fast = matching.fast_candidates(maxh, maxw, K)
    assert fast[0] == matching.match_plan(maxh, maxw, K)
    assert len(set(fast)) == len(fast)
    kc = matching.channel_bound(K)
    for p in fast:
        assert (p.rx, p.ry) in matching.BLOCKINGS[kc]
        assert p.smem <= matching.SMEM_LIMIT
        assert p.smem == matching.halo_bytes(matching.slot_channels(K), p.ry,
                                             *p.tile, p.bh, p.bw)
        # what csrc/match_decomposed.cuh's launcher refuses
        assert p.tx % (8 // p.rx) == 0 and p.ty % p.rx == 0
        assert p.tx * p.ty <= matching.max_threads(kc, (p.rx, p.ry))
    for p in fast[1:]:
        assert (p.bh, p.bw) == (maxh, maxw) and p.tile in matching.TILES
    # a plan_for on each tile is the plan of that tile, or None
    for blocking in matching.BLOCKINGS[kc]:
        for tile in matching.TILES:
            p = matching.plan_for(maxh, maxw, K, blocking, tile)
            assert p is None or (p.tile == tile and p in fast)


def test_main_shape_candidates():
    """At the online program's shape (16x16 window, K=10): B1's unblocked
    kernel first, then 6 general plans; B2's 2x2 blocking on a 32x32 tile
    first, then the 4 compiled blockings on 5 tiles (20 in all)."""
    fused = matching.fused_candidates(16, 16, 10)
    assert not fused[0].general and len(fused) == 7
    assert [(p.block_rows, p.band_cols) for p in fused[1:]] == [
        (16, 16), (16, 8), (8, 16), (8, 8), (4, 16), (4, 8)]
    fast = matching.fast_candidates(16, 16, 10)
    assert (fast[0].rx, fast[0].ry, fast[0].tile) == (2, 2, (32, 32))
    assert len(fast) == 20


def test_operator_plan_arguments():
    """The plan rides on B1's operator as trailing constants; the plain
    twin ignores them; an unblocked plan must cover the window."""
    rng = np.random.RandomState(12)
    f1 = torch.from_numpy(rng.rand(2, 5, 6, 4).astype(np.float32))
    f2 = torch.from_numpy(rng.rand(2, 8, 9, 4).astype(np.float32))
    plan = matching.fused_candidates(4, 4, 4)[-1]
    torch.library.opcheck(matching.match_flow_fused_op,
                          (f1, f2, 4, 4, False, False, True, 0.11,
                           plan.general, plan.block_rows, plan.band_cols))
    a = matching.match_flow_fused(f1, f2, 4, 4, want_conf=True, plan=plan)
    b = matching.match_flow_fused(f1, f2, 4, 4, want_conf=True)
    for x, y in zip(a, b):
        assert torch.equal(x, y)
    assert matching._op_plan(4, 4, 4, False, 0, 0) is None
    with pytest.raises(ValueError, match="whole"):
        matching._op_plan(4, 4, 4, False, 2, 4)


def test_key_changes_with_build_digest_and_card(monkeypatch):
    args = ("fused", (2, 30, 40, 10), (2, 45, 55, 10), 16, 16,
            torch.bfloat16, True, 0.11, "cuda:0")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    monkeypatch.setattr(_kernels, "_digest", lambda: "0123456789abcdef")
    base = autotune.plan_key(*args)
    assert "NVIDIA H100 80GB HBM3" in base and "0123456789abcdef" in base
    assert f"torch{torch.__version__}" in base
    monkeypatch.setattr(_kernels, "_digest", lambda: "fedcba9876543210")
    assert autotune.plan_key(*args) != base
    monkeypatch.setattr(_kernels, "_digest", lambda: "0123456789abcdef")
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H200")
    assert autotune.plan_key(*args) != base
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    assert autotune.plan_key(*args) == base
    for i, other in ((0, "fast"), (1, (4, 30, 40, 10)), (5, torch.float32),
                     (6, False)):
        changed = list(args)
        changed[i] = other
        assert autotune.plan_key(*changed) != base
    # the real digest covers every file under csrc/
    assert len(_kernels._digest()) == 16


def test_f16_resolution_is_stored_under_its_own_key(monkeypatch,
                                                   tuned_store):
    """An f16 resolution has its own store key (beside f32's and bf16's)
    and, on the CPU, the rule's plan, which is bf16's: B1 and B2 stage
    their halo in f32 whatever the storage type."""
    monkeypatch.setattr(torch.cuda, "get_device_name",
                        lambda d=None: "NVIDIA H100 80GB HBM3")
    shapes = ((2, 30, 40, 10), (2, 45, 55, 10))
    for kernel in ("fused", "fast"):
        keys = {autotune.plan_key(kernel, *shapes, 16, 16, dt, True, 0.11,
                                  "cuda:0")
                for dt in (torch.float32, torch.bfloat16, torch.float16)}
        assert len(keys) == 3
        assert any(":float16:" in k for k in keys)
        plans = [autotune.best_plan(kernel, *shapes, 16, 16, dt, True,
                                    device="cpu")
                 for dt in (torch.bfloat16, torch.float16)]
        assert plans[0] == plans[1] is not None
    assert not tuned_store.exists()


def test_concurrent_resolutions_leave_a_readable_store(tuned_store):
    """Eight threads resolve 40 keys at once: the store is whole JSON with
    every key, and a fresh process reads every winner back."""
    import sys
    errors = []

    def timer(fn):
        return float(fn())

    def resolve(t):
        try:
            for k in range(5):
                got = autotune.pick(f"t{t}k{k}", lambda c: (c - t) % 3,
                                    (1, 2, 3), timer=timer)
                assert (got - t) % 3 == 0
        except BaseException as e:      # re-raised in the test's thread
            errors.append(e)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=resolve, args=(t,))
                   for t in range(8)]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not errors and not any(th.is_alive() for th in threads)
    store = json.loads(tuned_store.read_text())
    assert sorted(store) == sorted(f"t{t}k{k}" for t in range(8)
                                   for k in range(5))
    assert not list(tuned_store.parent.glob(".autotune.*"))
    autotune._cache = None

    def exploding_timer(fn):
        raise AssertionError("persisted winners must not be re-measured")
    for t in range(8):
        assert (autotune.pick(f"t{t}k0", lambda c: c, (1, 2, 3),
                              timer=exploding_timer) - t) % 3 == 0


def test_auto_artifact_carries_the_resolved_plan(tuned_store, monkeypatch):
    """An estimator with match_block='auto' resolves B1's plan before the
    export traces it: the artifact holds the plan as the operator's
    constant arguments and equals the live program run on that plan."""
    g_plan = matching.FusedPlan(True, 4, 4, 0)
    calls = []

    def fake_best_plan(kernel, f1_shape, f2_shape, maxh, maxw, **kw):
        calls.append((kernel, f1_shape, f2_shape))
        return g_plan._replace(smem=matching.fused_halo_bytes(
            8, g_plan.block_rows, g_plan.band_cols))
    monkeypatch.setattr(autotune, "best_plan", fake_best_plan)
    c = pipeline_case(48, 64, n_points=64)
    noise = ransac_noise(64, c["n_points"])
    pair = [(f * 255).astype(np.uint8) for f in c["frames"][:2]]
    data = serving.export_pipeline_pairs(
        c["tg"], c["params"], c["tc"], 2, frame_hw=pair[0].shape[1:3],
        device="cpu", ransac_noise=noise, compensation="warp_banded",
        match_block="auto")
    assert [k for k, *_ in calls] == ["fused"]
    ep = serving.load_exported(data)
    nodes = [n for n in ep.graph.nodes if n.op == "call_function" and str(
        n.target) == "depth_estimation_tpu_torch.match_flow_fused.default"]
    assert len(nodes) == 1
    assert tuple(nodes[0].args[-3:]) == (True, 4, 4)
    got = ep.module()(*(torch.from_numpy(f) for f in pair))
    live = tapi.make_batched_pipeline(c["tg"], c["tc"], device="cpu",
                                      ransac_noise=noise,
                                      compensation="warp_banded",
                                      match_block="auto")
    want = live(c["params"], *(torch.from_numpy(f) for f in pair))
    assert len(calls) == 2       # the pipeline resolved at its first call
    for x, y in zip(got, want):
        assert torch.equal(x, y)
