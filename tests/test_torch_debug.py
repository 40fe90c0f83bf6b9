"""The port's NaN sanitizers (``depth_estimation_tpu_torch/utils/debug.py``)
against the JAX package's (``depth_estimation_tpu/utils/debug.py``) on the
same numpy inputs: ``nan_debug`` against ``jax_debug_nans`` and
``checked`` against ``checkify`` with ``float_checks``. Both raise where
the other raises and pass where it passes, with equal outputs on a clean
function (within f32 rounding: the two libraries' ``log`` and ``exp``
round apart by an ulp). One recorded exception, ROADMAP C7: a homography
that sends pixels to infinity."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import checkify

from depth_estimation_tpu.geometry3d import undistort as jundist
from depth_estimation_tpu.ops import matching as jmatching
from depth_estimation_tpu.utils import debug as jdebug
from depth_estimation_tpu_torch.geometry3d import undistort as tundist
from depth_estimation_tpu_torch.ops import matching
from depth_estimation_tpu_torch.utils import debug

TOL = 1e-6


def fn_jax(x, y):
    return jnp.log(x) * jnp.exp(-y) + jnp.sqrt(y)


def fn_torch(x, y):
    return torch.log(x) * torch.exp(-y) + torch.sqrt(y)


def inputs(clean: bool):
    rng = np.random.RandomState(0)
    x = rng.rand(4, 5).astype(np.float32) + 0.5
    y = rng.rand(4, 5).astype(np.float32)
    if not clean:
        x[1, 2] = -1.0          # log(-1) is NaN
    return x, y


def run_jax_nan_debug(x, y):
    # a jit of a new function object each call: eager primitives reuse
    # cached executables whose fast path, once another test's programs
    # have populated it, skips jax_debug_nans's check
    with jdebug.nan_debug():
        return np.asarray(jax.jit(lambda a, b: fn_jax(a, b))(
            jnp.asarray(x), jnp.asarray(y)))


def run_jax_checked(x, y):
    return np.asarray(jdebug.checked(fn_jax)(jnp.asarray(x), jnp.asarray(y)))


def run_port_nan_debug(x, y):
    with debug.nan_debug():
        return fn_torch(torch.from_numpy(x), torch.from_numpy(y)).numpy()


def run_port_checked(x, y):
    return debug.checked(fn_torch)(torch.from_numpy(x),
                                   torch.from_numpy(y)).numpy()


@pytest.mark.parametrize("how", ["nan_debug", "checked"])
def test_both_raise_on_a_nan_and_pass_a_clean_function(how):
    run_jax = run_jax_nan_debug if how == "nan_debug" else run_jax_checked
    run_port = run_port_nan_debug if how == "nan_debug" else run_port_checked
    want = run_jax(*inputs(clean=True))
    got = run_port(*inputs(clean=True))
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    with pytest.raises(Exception) as jerr:
        run_jax(*inputs(clean=False))
    assert "nan" in str(jerr.value).lower()
    with pytest.raises(FloatingPointError, match=r"nan.*aten\.log"):
        run_port(*inputs(clean=False))
    # outside the scope nothing is checked: the NaN propagates
    x, y = inputs(clean=False)
    assert np.isnan(fn_torch(torch.from_numpy(x), torch.from_numpy(y))
                    .numpy()).sum() == 1


INT_OPS = {"true": (lambda p, q: p / q, lambda p, q: p / q),
           "floor": (lambda p, q: p // q, torch.floor_divide)}


@pytest.mark.parametrize("op", sorted(INT_OPS))
@pytest.mark.parametrize("divisor", [[1, 2, 3], [1, 0, 3]])
def test_checked_flags_integer_division_by_zero_as_checkify(divisor, op):
    """checkify's float_checks flag an integer division by zero, true or
    floor; so does the port's ``checked``. (Neither checks a remainder;
    torch's own integer remainder by zero raises on the CPU.)"""
    a = np.array([7, 8, 9], np.int32)
    b = np.array(divisor, np.int32)
    jop, top = INT_OPS[op]
    jfn, tfn = jdebug.checked(jop), debug.checked(top)
    if 0 in divisor:
        with pytest.raises(checkify.JaxRuntimeError, match="division by zero"):
            jfn(jnp.asarray(a), jnp.asarray(b))
        with pytest.raises(ZeroDivisionError, match="div"):
            tfn(torch.from_numpy(a), torch.from_numpy(b))
    else:
        np.testing.assert_array_equal(
            tfn(torch.from_numpy(a), torch.from_numpy(b)).numpy(),
            np.asarray(jfn(jnp.asarray(a), jnp.asarray(b))))


def test_uninitialised_allocations_are_never_checked(monkeypatch):
    """torch.empty and its kin return whatever the memory held; the scope
    looks at none of their outputs (every kernel wrapper allocates its
    outputs so), and at every other operation's."""
    seen = []

    def spy(t):
        seen.append(tuple(getattr(t, "shape", ())))
        return False
    monkeypatch.setattr(debug, "_has_nan", spy)
    x = torch.zeros(3, 4)
    with debug.nan_debug():
        torch.empty(5, 6)
        torch.empty_like(x)
        torch.empty_strided((2, 3), (3, 1))
        x.new_empty((7,))
        assert seen == []
        torch.full((2, 2), float("nan"))
    assert seen == [(2, 2)]
    monkeypatch.undo()
    with debug.nan_debug():
        with pytest.raises(FloatingPointError, match="aten.full"):
            torch.full((2, 2), float("nan"))


def test_b1_operator_is_seen_through_its_twin():
    """On CPU tensors B1's operator runs its plain twin inside the
    dispatcher: a NaN from it is named as the operator, as the JAX
    package's debug_nans names the Pallas call (interpret mode)."""
    rng = np.random.RandomState(3)
    f1 = rng.rand(1, 5, 6, 3).astype(np.float32)
    f2 = rng.rand(1, 8, 9, 3).astype(np.float32)
    with debug.nan_debug():
        clean = matching.match_flow_fused(torch.from_numpy(f1),
                                          torch.from_numpy(f2), 4, 4)
    want = jmatching.match_flow_fused(jnp.asarray(f1), jnp.asarray(f2), 4, 4,
                                      interpret=True)
    np.testing.assert_array_equal(clean[0].numpy(), np.asarray(want[0]))
    for a, b in zip(clean[1:], want[1:]):
        np.testing.assert_allclose(a.numpy(), np.asarray(b), atol=1e-5)
    f1[0, 2, 3, 1] = np.nan
    t1, t2 = torch.from_numpy(f1), torch.from_numpy(f2)
    with debug.nan_debug():
        with pytest.raises(FloatingPointError,
                           match="depth_estimation_tpu_torch.match_flow_fused"):
            matching.match_flow_fused(t1, t2, 4, 4)
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            jmatching.match_flow_fused(jnp.asarray(f1), jnp.asarray(f2), 4, 4,
                                       interpret=True)


def test_ctypes_kernels_are_checked_at_their_wrappers_return():
    """B2, B4 and B5 launch through ctypes, which no dispatch mode sees;
    their wrappers hand their outputs to ``check_outputs``, which raises
    only inside a scope."""
    outs = (torch.zeros(2), torch.tensor([1.0, float("nan")]))
    debug.check_outputs("match_flow_fast (kernel B2)", outs)      # no scope
    assert not debug.active()
    with debug.nan_debug():
        assert debug.active()
        with pytest.raises(FloatingPointError, match="kernel B2"):
            debug.check_outputs("match_flow_fast (kernel B2)", outs)
        debug.check_outputs("match_flow_fast (kernel B2)", outs[:1])
    with debug.nan_debug(enable=False):
        assert not debug.active()
    assert not debug.active()


def test_c7_degenerate_homography_is_a_recorded_divergence():
    """ROADMAP C7. A rotation of 90 degrees about the camera's y axis sends
    the principal column to infinity. The JAX banded warp's shift-sum gives
    those pixels weight 0 (max(0, 1 - inf) = 0) and stays finite, so
    debug_nans passes; the port's twin takes floor(inf) as its tap and
    weights it 1 - |inf - inf| = NaN, so nan_debug raises there. The
    pixels are outside the valid mask either way (their displacement
    exceeds any band). An all-zero R (0/0 everywhere) gives NaN in both,
    and both raise."""
    rng = np.random.RandomState(0)
    img = rng.rand(1, 8, 16, 2).astype(np.float32)
    K = np.array([[10.0, 0, 8], [0, 10, 4], [0, 0, 1]], np.float32)
    y90 = np.array([[0, 0, 1], [0, 1, 0], [-1, 0, 0]], np.float32)[None]
    zero = np.zeros((1, 3, 3), np.float32)

    def port(R):
        return tundist.remove_ego_motion_banded(
            torch.from_numpy(img), K, torch.from_numpy(R), band=2)

    def ref(R):
        return np.asarray(jundist.remove_ego_motion_banded(
            jnp.asarray(img), K, jnp.asarray(R), band=2))

    # the divergence: JAX finite, the port NaN on the principal column
    assert np.isfinite(ref(y90)).all()
    nan = np.isnan(port(y90).numpy())
    assert nan.any() and nan[..., 0].sum() == 8 and (nan[..., 0].any(0)
                                                      .nonzero()[-1] == 8).all()
    with jax.debug_nans(True):
        ref(y90)
    with debug.nan_debug():
        with pytest.raises(FloatingPointError):
            port(y90)
    # and where both agree: 0/0 everywhere is NaN in both, and both raise
    assert np.isnan(ref(zero)).all() and torch.isnan(port(zero)).all()
    with jax.debug_nans(True):
        with pytest.raises(FloatingPointError):
            ref(zero)
    with debug.nan_debug():
        with pytest.raises(FloatingPointError):
            port(zero)
