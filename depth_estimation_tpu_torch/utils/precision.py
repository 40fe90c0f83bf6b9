"""The port's float32 rule, in one place.

The JAX package computes in f32 wherever it does not name a storage type
("f32 is the default everywhere", the repository's precision policy),
and asks for the full-precision products where it could have had fewer
bits (LK's products are ``Precision.HIGHEST``,
``depth_estimation_tpu/geometry3d/egomotion.py:189-192`` and
``:314-343``). PyTorch on a card does not by default: cuDNN runs f32
convolutions in TF32 (``torch.backends.cudnn.allow_tf32`` is True),
which keeps about three decimal digits. So every
public entry point of the port that runs on the card (the estimators, the
ground-truth generators, the model families' calls, the trainers and
loaders, the CLIs, the mesh's shards) runs inside ``full_f32()``, which
turns TF32 off for cuDNN and cuBLAS for the call and gives the caller's
settings back after it. There is no switch: the port computes what the
JAX package computes.

Both flags are process-global and are read when an operation is issued
on the host, so the scope covers the host thread's issue, not the card's
execution. Scopes nest, from any thread: a count of the open scopes,
under a lock, restores the flags only when the outermost one closes, so a
mesh's shard thread that leaves its scope cannot turn TF32 back on while
another shard is still issuing. A thread of the caller's own that runs
convolutions while a port call is open runs them in f32 too.

``torch.export`` records neither flag: a loaded artifact runs under the
flags of its caller, so a caller that serves one wraps the call in
``full_f32()``. The backward of a model call made outside a trainer runs
under the caller's flags as well (the trainers' steps hold the scope
around their backward).
"""

from __future__ import annotations

import contextlib
import threading

import torch

_LOCK = threading.Lock()
_open = 0               # scopes open in the process
_saved = None           # the flags before the outermost scope


def tf32_flags() -> tuple:
    """(cuDNN's, cuBLAS's) ``allow_tf32`` as they stand."""
    return (torch.backends.cudnn.allow_tf32,
            torch.backends.cuda.matmul.allow_tf32)


def _set(cudnn: bool, matmul: bool) -> None:
    torch.backends.cudnn.allow_tf32 = cudnn
    torch.backends.cuda.matmul.allow_tf32 = matmul


class full_f32(contextlib.ContextDecorator):
    """Scope (or decorator) in which cuDNN's and cuBLAS's f32 operations
    run in full f32, not TF32. Every entry sets both flags off; the
    outermost exit restores what the caller had. Reentrant and
    thread-safe (see the module's docstring)."""

    def __enter__(self):
        global _open, _saved
        with _LOCK:
            if _open == 0:
                _saved = tf32_flags()
            _open += 1
            _set(False, False)
        return self

    def __exit__(self, *exc):
        global _open, _saved
        with _LOCK:
            _open -= 1
            if _open == 0:
                _set(*_saved)
                _saved = None
        return False
