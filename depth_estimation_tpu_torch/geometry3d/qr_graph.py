"""RANSAC's complete QR on the card, replayed from CUDA graphs.

``egomotion._eight_point`` takes the nullspace of every 8-point sample from
``torch.linalg.qr(A^T, mode="complete")`` over B x S matrices of 9 x 8,
which torch runs as cuBLAS's batched geqrf and one cuSOLVER orgqr a matrix:
~74k launches a step of the online program at B=128, S=48. ``GRAPHS``
(``utils/cuda_graph``) replays ``sliced_q`` instead, bit for bit eager's,
and runs ``eager_q`` where it runs eagerly.

``sliced_q`` cuts the matrices into ``slices(n)`` runs, each on a stream
forked from the current one and joined back, so that the card runs up to
32 chains side by side. Each slice keeps at least 2 matrices, so that
torch takes cuBLAS's batched geqrf, eager's route and bits. On an H100 at
B=128, S=48 the replay takes 146 ms of device time in one chain, 14.1 ms
in 16 and 12.2 ms in 32 (64: 12.3).
"""

from __future__ import annotations

import math
import threading
from typing import List

import torch

from ..utils.cuda_graph import GraphCache

MAX_SLICES = 32     # the card's gain ends here (64 slices: no faster)
# graphs a device, past which a new shape runs eagerly, so that loaders
# whose batch varies keep a bounded cache
GRAPHS = GraphCache("qr_graph", max_graphs=4)

_side = {}
_side_lock = threading.Lock()


def slices(n: int) -> int:
    """Streams the QR of n matrices runs on: up to ``MAX_SLICES``, each
    slice of at least 2 matrices."""
    return max(1, min(MAX_SLICES, n // 2))


def eager_q(A: torch.Tensor) -> torch.Tensor:
    """Q of the complete QR of A^T, as torch computes it."""
    return torch.linalg.qr(A.transpose(-1, -2), mode="complete")[0]


def _side_streams(device: torch.device, k: int) -> List[torch.cuda.Stream]:
    """The k side streams of a device's k + 1 slices: the same ones in a
    capture's eager run and in the capture, since cuBLAS's and cuSOLVER's
    handles and workspaces are set up per stream."""
    with _side_lock:
        if (device, k) not in _side:
            _side[device, k] = [torch.cuda.Stream(device) for _ in range(k)]
        return _side[device, k]


def sliced_q(A: torch.Tensor) -> torch.Tensor:
    """``eager_q(A)`` for A (..., 8, 9) on the card, in ``slices(n)`` runs:
    the first on the current stream, the others on side streams forked
    from it and joined back. Q (..., 9, 9) is laid out as ``linalg.qr``
    lays out its Q."""
    n = math.prod(A.shape[:-2])
    Q = torch.empty(A.shape[:-2] + (9, 9), dtype=A.dtype,
                    device=A.device).mT
    a, q = A.reshape(n, 8, 9), Q.reshape(n, 9, 9)
    main = torch.cuda.current_stream(A.device)
    streams = [main] + _side_streams(A.device, slices(n) - 1)
    size, extra = divmod(n, len(streams))
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
    return Q
