"""Numeric sanitizers: the port's NaN-guard toolkit (port of
``depth_estimation_tpu.utils.debug``).

The reference's numeric safety net (SURVEY.md §5): training aborts on NaN
gradients, CascadingAddTable dumps intermediates on NaN, Log2 clamps
inputs. Here:
  * the training step already skips non-finite-grad updates
    (training/train.py);
  * ``nan_debug()`` is a scope in which the first operation that produces
    a NaN raises ``FloatingPointError`` naming it (as ``jax_debug_nans``);
  * ``checked(fn)`` wraps a function so that a NaN produced inside it, or
    an integer division by zero, raises instead of propagating (as
    ``checkify`` with ``float_checks``).

Both are a ``TorchDispatchMode`` that looks at every output of every
operation the dispatcher runs in the calling thread (a mesh's shard
threads are outside it). The package's operators B1
(``match_flow_fused``) and B3 (``banded_bilinear_warp``) are such
operations, so a NaN from either is named as the operator, on the card
and on the CPU (where the plain twin runs inside the operator). Kernels
B2, B4 and B5 are ctypes launches that no mode sees: their wrappers check
their outputs on return while a scope is open (``check_outputs``). The
peak meter's P1 and P2 are outside it. ``torch.empty``, ``empty_like``,
``empty_strided`` and ``new_empty`` return uninitialised memory and are
never checked.

Each check reads a flag back from the card, so a checked program
synchronises after every operation: a debugging aid, far slower than the
program it checks.
"""

from __future__ import annotations

import contextlib
import functools
import threading

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

aten = torch.ops.aten

# uninitialised allocations: whatever bits they hold are not the program's
_UNINITIALISED = frozenset({
    aten.empty.memory_format, aten.empty_like.default,
    aten.empty_strided.default, aten.new_empty.default,
    aten.new_empty_strided.default,
})
# division of integers (true, floor or truncating): a zero divisor is
# checkify's DivisionByZeroError; a remainder is not checked, as in JAX
_DIVISIONS = frozenset({
    aten.div.Tensor, aten.div.Tensor_mode, aten.div_.Tensor,
    aten.div_.Tensor_mode, aten.floor_divide.default,
    aten.floor_divide_.Tensor,
})

_STATE = threading.local()


def _has_nan(t) -> bool:
    return (isinstance(t, torch.Tensor) and t.numel() > 0
            and (t.is_floating_point() or t.is_complex())
            and bool(torch.isnan(t).any()))


def _zero_int_divisor(args) -> bool:
    if len(args) < 2:
        return False
    x, y = args[0], args[1]
    if isinstance(x, torch.Tensor) and x.is_floating_point():
        return False
    if isinstance(y, torch.Tensor):
        return (not y.is_floating_point() and not y.is_complex()
                and bool((y == 0).any()))
    return isinstance(y, int) and y == 0


class _NaNCheck(TorchDispatchMode):
    """Raise at the first operation that produces a NaN (and, with
    ``divisions``, at an integer division by zero)."""

    def __init__(self, divisions: bool):
        super().__init__()
        self.divisions = divisions

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        if self.divisions and func in _DIVISIONS and _zero_int_divisor(args):
            raise ZeroDivisionError(f"integer division by zero in {func}")
        out = func(*args, **kwargs)
        if func not in _UNINITIALISED and any(
                _has_nan(t) for t in tree_leaves(out)):
            raise FloatingPointError(
                f"invalid value (nan) encountered in {func}")
        return out


@contextlib.contextmanager
def _scope(divisions: bool):
    _STATE.depth = getattr(_STATE, "depth", 0) + 1
    try:
        with _NaNCheck(divisions):
            yield
    finally:
        _STATE.depth -= 1


@contextlib.contextmanager
def nan_debug(enable: bool = True):
    """Scope in which the first operation that produces a NaN raises
    ``FloatingPointError`` naming it. ``enable=False`` adds no check."""
    if not enable:
        yield
        return
    with _scope(divisions=False):
        yield


def active() -> bool:
    """True inside ``nan_debug`` or a ``checked`` call in this thread."""
    return getattr(_STATE, "depth", 0) > 0


def check_outputs(name: str, outs) -> None:
    """Inside a scope: raise ``FloatingPointError`` naming ``name`` where
    one of ``outs`` (a kernel launched outside the dispatcher) holds a
    NaN. Nothing outside a scope."""
    if active() and any(_has_nan(t) for t in tree_leaves(outs)):
        raise FloatingPointError(
            f"invalid value (nan) encountered in {name}")


def checked(fn):
    """``fn`` wrapped so that a NaN produced inside it (``FloatingPointError``)
    or an integer division by zero (``ZeroDivisionError``) raises, naming
    the operation, instead of propagating."""

    @functools.wraps(fn)
    def wrapper(*args, **kw):
        with _scope(divisions=True):
            return fn(*args, **kw)

    return wrapper
