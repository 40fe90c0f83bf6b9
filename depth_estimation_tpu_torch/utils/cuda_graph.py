"""Eager PyTorch work on the card, replayed from CUDA graphs.

A ``GraphCache`` captures a function whose shapes repeat and which never
waits for the card once per key into a ``torch.cuda.CUDAGraph`` and
replays it: the same kernels with the same arguments, so the outputs are
bit for bit eager's, and the host launches the input copies, one graph
and the output clones. Its users are RANSAC's complete QR
(``geometry3d/qr_graph``) and the liu solve's IRLS planes (``flow/celiu``).
The key is what the captured kernels bake in: the device, the current
stream, the function with its constants, each input's shape and dtype.

A call runs eagerly (``eager_reason``) while torch.compile or torch.export
traces, so that an exported program holds the plain operations (uncounted:
a trace runs nothing); where autograd would record it (any input requiring
grad); under a Python dispatch mode (``utils/debug.nan_debug``, a FLOP
counter), which has to see every operation; on the CPU; and while the
current stream is itself being captured. A new key is captured only
outside a profiler, while fewer than the cache's bound of graphs hold its
device, one capture at a time in a cache; otherwise the call runs eagerly.

``utils/timer.COUNTERS`` counts the routes under the cache's name:
``<name>.captures``, ``<name>.replays`` (a capture's own call included)
and ``<name>.eager``.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Optional, Sequence

import torch
from torch.utils import _pytree
from torch.utils._python_dispatch import _get_current_dispatch_mode

from .timer import count


def eager_reason(tensors: Sequence[torch.Tensor]) -> Optional[str]:
    """Why a call on ``tensors`` cannot be replayed from a graph, or None."""
    if torch.compiler.is_compiling():
        return "compiling"
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return "autograd"
    if _get_current_dispatch_mode() is not None:
        return "dispatch mode"
    if not tensors[0].is_cuda:
        return "cpu"
    with torch.cuda.device(tensors[0].device):
        if torch.cuda.is_current_stream_capturing():
            return "capturing"
    return None


def graph_key(fn: Callable, tensors: Sequence[torch.Tensor],
              consts: dict) -> tuple:
    """What a captured call bakes in: device, current stream, the function
    and its constants, each input's shape and dtype."""
    dev = tensors[0].device
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else None)
    return (dev, stream, fn, tuple(sorted(consts.items())),
            tuple((t.shape, t.dtype) for t in tensors))


class _Graph:
    """``fn`` over static copies of one key's inputs, captured after one
    eager run on the capture's stream (which sets up the library handles
    and workspaces of every stream ``fn`` runs on). Replayed on the current
    stream under a lock, so that no two calls share the static tensors at
    a time; each call gets clones of the static outputs, laid out as
    ``fn`` laid them out."""

    def __init__(self, fn: Callable, tensors: Sequence[torch.Tensor]):
        self.inputs = [t.clone() for t in tensors]
        self.lock = threading.Lock()
        stream = torch.cuda.Stream(tensors[0].device)
        stream.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(stream):
            fn(*self.inputs)
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph, stream=stream,
                              capture_error_mode="thread_local"):
            self.outputs = fn(*self.inputs)

    def __call__(self, tensors: Sequence[torch.Tensor]):
        with self.lock:
            for static, t in zip(self.inputs, tensors):
                static.copy_(t)
            self.graph.replay()
            return _pytree.tree_map(torch.clone, self.outputs)


class GraphCache:
    """A bounded cache of captured calls, counted as ``name``, shared by the
    threads that drive the cards (``parallel/mesh.run_shards``)."""

    def __init__(self, name: str, max_graphs: int):
        self.name = name
        self.max_graphs = max_graphs    # a device; past it, eager
        self._graphs = {}
        self._lock = threading.Lock()

    def replay(self, fn: Callable, tensors: Sequence[torch.Tensor], *,
               eager_fn: Optional[Callable] = None, **consts):
        """``fn(*tensors, **consts)`` from a graph where the input allows
        (outputs that no later call overwrites), else ``eager_fn`` (default
        ``fn``) with the same arguments, eagerly."""
        if eager_reason(tensors) is None:
            with torch.cuda.device(tensors[0].device):
                graph = self._graph(fn, tensors, consts)
                if graph is not None:
                    count(f"{self.name}.replays")
                    return graph(tensors)
        return self.run_eager(eager_fn or fn, tensors, **consts)

    def run_eager(self, fn: Callable, tensors: Sequence[torch.Tensor],
                  **consts):
        """``fn(*tensors, **consts)`` eagerly, counted unless a trace runs."""
        if not torch.compiler.is_compiling():
            count(f"{self.name}.eager")
        return fn(*tensors, **consts)

    def _graph(self, fn, tensors, consts) -> Optional[_Graph]:
        """The graph for this key, captured on first sight; None where a
        new key may not be captured."""
        key = graph_key(fn, tensors, consts)
        dev = tensors[0].device
        with self._lock:
            graph = self._graphs.get(key)
            if (graph is None and not torch._C._autograd._profiler_enabled()
                    and sum(k[0] == dev for k in self._graphs)
                    < self.max_graphs):
                graph = _Graph(functools.partial(fn, **consts), tensors)
                self._graphs[key] = graph
                count(f"{self.name}.captures")
            return graph
