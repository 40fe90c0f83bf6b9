"""Device selection for the port's entry points.

The entry points run on the card unless the caller names the CPU. Where
the card is asked for and none is visible they raise: nothing carries on
on the CPU in its place.
"""

from __future__ import annotations

import numpy as np
import torch


def resolve(device) -> torch.device:
    """``torch.device(device)``; raise if it is a CUDA device and no card is
    visible to torch."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {str(dev)!r}: torch.cuda.is_available() is false; "
            "pass device='cpu' to run on the CPU")
    return dev


def true_div(t: torch.Tensor, c: float) -> torch.Tensor:
    """t / c as a true division on every device (a CUDA ``tensor / scalar``
    multiplies by the reciprocal of the scalar)."""
    return t / torch.tensor(float(c), dtype=t.dtype, device=t.device)


def host(x) -> np.ndarray:
    """A tensor (on any device) or an array-like as a numpy array."""
    if isinstance(x, torch.Tensor):
        return x.detach().cpu().numpy()
    return np.asarray(x)


def as_f32(x, device) -> torch.Tensor:
    """``x`` (a tensor or a numpy array) as a float32 tensor on ``device``,
    resolved as above."""
    return torch.as_tensor(x, dtype=torch.float32, device=resolve(device))
