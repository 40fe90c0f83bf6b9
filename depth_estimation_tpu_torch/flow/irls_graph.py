"""The liu solve's IRLS coefficient planes on the card, replayed from CUDA
graphs.

The first inner step of each outer IRLS step (``celiu.smooth_flow_sor``,
``celiu._irls_planes``) computes the SOR's nine planes from the level's
features, warp, flow and noise estimate in ~250 small eager kernels:
derivatives, Phi, Psi, the five channel means, the two weighted
Laplacians, the stencil's weights and denominators. Its shapes are fixed
per pyramid level, its constants are Python floats and it never waits for
the card, so ``IRLSGraphs.replay`` captures it once per key into a
``torch.cuda.CUDAGraph`` and replays it: eager's kernels with eager's
arguments, so the planes are bit for bit eager's, and the host launches
the input copies, one graph and the output clones.

The key is what the captured kernels bake in: the device, the current
stream, the function with its constants (alpha, the noise model), and
each input's shape and dtype.

Eager, on whatever the input says:
  * while torch.compile or torch.export traces (uncounted: a trace runs
    nothing);
  * where autograd would record the step (any input requiring grad);
  * under a Python dispatch mode, which has to see every operation;
  * on the CPU;
  * while the current stream is itself being captured;
  * for a new key while a profiler runs: a capture is made outside one;
  * for a new key once ``MAX_GRAPHS`` graphs hold its device;
  * for a warm start's steps (``run_eager``; n_inner > 1).

``utils/timer.COUNTERS`` counts the routes: ``liu_graph.captures``,
``liu_graph.replays`` (a capture's own call included) and
``liu_graph.eager``.
"""

from __future__ import annotations

import functools
import threading
from typing import Callable, Optional, Sequence, Tuple

import torch

from ..geometry3d import qr_graph
from ..utils.timer import count

# graphs a device, past which a new key runs eagerly: the 8 levels of the
# trainer's schedule at the loader's two batch sizes (a full LIU_CHUNK and
# the last chunk)
MAX_GRAPHS = 16


def eager_reason(tensors: Sequence[torch.Tensor]) -> Optional[str]:
    """Why a step on ``tensors`` cannot be replayed from a graph, or None:
    a trace, autograd on any input, else ``qr_graph.eager_reason`` of the
    first."""
    if torch.compiler.is_compiling():
        return "compiling"
    if torch.is_grad_enabled() and any(t.requires_grad for t in tensors):
        return "autograd"
    return qr_graph.eager_reason(tensors[0])


def run_eager(fn: Callable, tensors: Sequence[torch.Tensor], **consts):
    """``fn(*tensors, **consts)`` eagerly, counted unless a trace runs."""
    if not torch.compiler.is_compiling():
        count("liu_graph.eager")
    return fn(*tensors, **consts)


def graph_key(fn: Callable, tensors: Sequence[torch.Tensor],
              consts: dict) -> tuple:
    """What a captured step bakes in: device, current stream, the function
    and its constants, each input's shape and dtype."""
    dev = tensors[0].device
    stream = (torch.cuda.current_stream(dev).cuda_stream
              if dev.type == "cuda" else None)
    return (dev, stream, fn, tuple(sorted(consts.items())),
            tuple((t.shape, t.dtype) for t in tensors))


class _Graph:
    """``fn`` over static copies of one key's inputs, captured after one
    eager run on the capture's stream. Replayed on the current stream under
    a lock, so that no two calls share the static tensors at a time."""

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

    def __call__(self, tensors: Sequence[torch.Tensor]) -> Tuple:
        with self.lock:
            for static, t in zip(self.inputs, tensors):
                static.copy_(t)
            self.graph.replay()
            return tuple(o.clone() for o in self.outputs)


class IRLSGraphs:
    """A bounded cache of captured steps, shared by the threads that drive
    the cards (``parallel/mesh.run_shards``)."""

    def __init__(self):
        self._graphs = {}
        self._lock = threading.Lock()

    def replay(self, fn: Callable, tensors: Sequence[torch.Tensor],
               **consts):
        """``fn(*tensors, **consts)``, from a graph where the input allows
        (a tuple of tensors that no later call overwrites)."""
        if eager_reason(tensors) is None:
            with torch.cuda.device(tensors[0].device):
                graph = self._graph(fn, tensors, consts)
                if graph is not None:
                    count("liu_graph.replays")
                    return graph(tensors)
        return run_eager(fn, tensors, **consts)

    def _graph(self, fn, tensors, consts) -> Optional[_Graph]:
        """The graph for this key, captured on first sight (one capture at
        a time in the process, none under a profiler); None past the
        device's bound."""
        key = graph_key(fn, tensors, consts)
        dev = tensors[0].device
        with self._lock:
            graph = self._graphs.get(key)
            if (graph is None and not torch._C._autograd._profiler_enabled()
                    and sum(k[0] == dev for k in self._graphs) < MAX_GRAPHS):
                graph = _Graph(functools.partial(fn, **consts), tensors)
                self._graphs[key] = graph
                count("liu_graph.captures")
            return graph


GRAPHS = IRLSGraphs()
