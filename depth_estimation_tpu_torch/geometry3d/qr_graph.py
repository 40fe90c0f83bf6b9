"""RANSAC's complete QR on the card, replayed from CUDA graphs.

``egomotion._eight_point`` takes the nullspace of every 8-point sample from
``torch.linalg.qr(A^T, mode="complete")`` over B x S matrices of 9 x 8. On
the card torch runs that as cuBLAS's batched geqrf and then one cuSOLVER
orgqr a matrix, about 12 small kernels each: ~74k launches a step of the
online program at B=128, S=48, which bind the step to the host's issue
rate. ``QRGraphs.complete_q`` captures the call once per (device, stream,
shape, dtype) into a ``torch.cuda.CUDAGraph`` and replays it: the same
kernels with the same arguments, so Q is bit for bit eager's, and the host
issues one graph launch.

The capture cuts the matrices into ``slices(n)`` runs of consecutive
matrices, each on a stream forked from the capture stream and joined back
inside the graph, so that the card runs up to 32 chains side by side. Each
slice keeps at least 2 matrices, so that it takes eager's route (torch
picks cuBLAS's batched geqrf for a batch of two or more) and eager's bits.
On an H100 at B=128, S=48 the replay takes 146 ms of device time in one
chain, 14.1 ms in 16 and 12.2 ms in 32 (64: 12.3).

Eager, on whatever the input says:
  * while torch.compile or torch.export traces, so that an exported
    pipeline holds plain ``linalg.qr`` (uncounted: a trace runs nothing);
  * where autograd would record the call;
  * under a Python dispatch mode (``utils/debug.nan_debug``, a FLOP
    counter), which has to see every operation;
  * on the CPU;
  * while the current stream is itself being captured;
  * for a new shape once ``MAX_SHAPES`` graphs hold its device, so that
    loaders whose batch varies keep a bounded cache.

``utils/timer.COUNTERS`` counts the routes: ``qr_graph.captures``,
``qr_graph.replays`` (a capture's own call included) and ``qr_graph.eager``.
"""

from __future__ import annotations

import math
import threading
from typing import Optional

import torch
from torch.utils._python_dispatch import _get_current_dispatch_mode

from ..utils.timer import count

MAX_SLICES = 32     # the card's gain ends here (64 slices: no faster)
MAX_SHAPES = 4      # graphs a device, past which a new shape runs eagerly


def slices(n: int) -> int:
    """Streams the capture of n matrices runs on: up to ``MAX_SLICES``,
    each slice of at least 2 matrices."""
    return max(1, min(MAX_SLICES, n // 2))


def eager_reason(A: torch.Tensor) -> Optional[str]:
    """Why the QR of ``A`` cannot be replayed from a graph, or None."""
    if torch.compiler.is_compiling():
        return "compiling"
    if A.requires_grad and torch.is_grad_enabled():
        return "autograd"
    if _get_current_dispatch_mode() is not None:
        return "dispatch mode"
    if not A.is_cuda:
        return "cpu"
    with torch.cuda.device(A.device):
        if torch.cuda.is_current_stream_capturing():
            return "capturing"
    return None


def eager_q(A: torch.Tensor) -> torch.Tensor:
    """Q of the complete QR of A^T, as torch computes it."""
    return torch.linalg.qr(A.transpose(-1, -2), mode="complete")[0]


class _Graph:
    """The complete QR of one shape's A^T, captured on ``k`` streams: a
    static input A (..., 8, 9) and a static Q (..., 9, 9) laid out as
    ``linalg.qr`` lays out its Q. Replayed on the stream that was current
    at the capture, under a lock, so that no two calls share the static
    tensors at a time."""

    def __init__(self, A: torch.Tensor, k: int):
        self.n = math.prod(A.shape[:-2])
        self.A = A.clone(memory_format=torch.contiguous_format)
        self.Q = torch.empty(A.shape[:-2] + (9, 9), dtype=A.dtype,
                             device=A.device).mT
        self.lock = threading.Lock()
        streams = [torch.cuda.Stream(A.device) for _ in range(k)]
        streams[0].wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(streams[0]):
            self._qr(streams)       # eager: handles, workspaces per stream
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=streams[0],
                              capture_error_mode="thread_local"):
            self._qr(streams)

    def _qr(self, streams) -> None:
        """Fork every slice's stream from the first, run each slice's QR
        into the static Q, join them back."""
        main = streams[0]
        a, q = self.A.reshape(self.n, 8, 9), self.Q.reshape(self.n, 9, 9)
        size, extra = divmod(self.n, len(streams))
        for s in streams[1:]:
            s.wait_stream(main)
        i = 0
        for j, s in enumerate(streams):
            m = size + (j < extra)
            with torch.cuda.stream(s):
                q[i:i + m].copy_(eager_q(a[i:i + m]))
            i += m
        for s in streams[1:]:
            main.wait_stream(s)

    def __call__(self, A: torch.Tensor) -> torch.Tensor:
        with self.lock:
            self.A.copy_(A)
            self.graph.replay()
            return self.Q.clone()


class QRGraphs:
    """A bounded cache of captured QRs, shared by the threads that issue to
    the cards (``parallel/mesh.run_shards``)."""

    def __init__(self):
        self._graphs = {}
        self._lock = threading.Lock()

    def complete_q(self, A: torch.Tensor) -> torch.Tensor:
        """Q (..., 9, 9) of the complete QR of A^T, A (..., 8, 9)."""
        reason = eager_reason(A)
        if reason == "compiling":
            return eager_q(A)
        if reason is None:
            with torch.cuda.device(A.device):
                graph = self._graph(A)
                if graph is not None:
                    count("qr_graph.replays")
                    return graph(A)
        count("qr_graph.eager")
        return eager_q(A)

    def _graph(self, A: torch.Tensor) -> Optional[_Graph]:
        """The graph for A's shape on the current stream, captured on
        first sight (one capture at a time in the process); None past the
        device's bound."""
        key = (A.device, torch.cuda.current_stream().cuda_stream,
               tuple(A.shape), A.dtype)
        with self._lock:
            graph = self._graphs.get(key)
            held = sum(k[0] == A.device for k in self._graphs)
            if graph is None and held < MAX_SHAPES:
                graph = _Graph(A, slices(math.prod(A.shape[:-2])))
                self._graphs[key] = graph
                count("qr_graph.captures")
            return graph


GRAPHS = QRGraphs()
