"""Radial (polar 1-D) flow network (port of ``depth_estimation_tpu.models.radial``):
a conv trunk shared by both frames, applied to epipole-centered polar
images, then a 1-D matcher along the radial (row) direction:

    cost[y, x, k] = sum_c (f_prev[y, x, c] - f_curr[y + k, x, c])^2,
    k in [0, hWin)

The previous frame's features are cropped by hWin - 1 at the bottom, so
the search is one-sided: forward motion makes everything flow outward
(increasing radius), flow = k >= 0.

The trunk uses the radial layer-spec format: tuples (in, kh, kw, out)
interleaved with the literal string 'tanh', each a layer of its own. Every
conv is a VALID ``DenseConv`` named ``layer1..N`` (weights from the flax
tree through ``models.io.radial_state_from_jax``).
"""

from __future__ import annotations

from typing import Sequence, Tuple, Union

import torch
from torch import nn

from ..ops import matching
from ..utils.device import resolve
from ..utils.precision import full_f32
from ..utils.timer import profiled_span
from .filters import DenseConv, init_params, to_nchw, to_nhwc

RadialLayer = Union[str, Tuple[int, int, int, int]]


class RadialFilter(nn.Module):
    """Conv trunk for polar images; layers in the radial spec format. Each
    conv takes the channels its input has (the previous conv's output)."""

    def __init__(self, layers: Tuple[RadialLayer, ...]):
        super().__init__()
        self.layers = tuple(layers)
        i = 0
        cin = None
        for layer in self.layers:
            if layer == "tanh":
                continue
            c0, kh, kw, cout = layer
            i += 1
            self.add_module(f"layer{i}", DenseConv(c0 if cin is None else cin,
                                                   cout, kh, kw))
            cin = cout

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., H, W, C) -> (..., H', W', K), channels-last."""
        h = to_nchw(x)
        i = 0
        for layer in self.layers:
            if layer == "tanh":
                h = torch.tanh(h)
            else:
                i += 1
                h = getattr(self, f"layer{i}")(h)
        return to_nhwc(h, x.shape[:-3])


class RadialFlowNetwork(nn.Module):
    """The radial matcher: ``layers`` in the radial spec format and the
    search height ``h_win``, on ``device`` (the card by default; raises
    where there is none unless given ``device="cpu"``)."""

    def __init__(self, layers: Sequence[RadialLayer], h_win: int,
                 device="cuda"):
        super().__init__()
        self.layers = tuple(tuple(l) if not isinstance(l, str) else l
                            for l in layers)
        self.h_win = h_win
        self.filter = RadialFilter(self.layers).to(resolve(device))

    @property
    def h_kernel(self) -> int:
        return sum(l[1] - 1 for l in self.layers if not isinstance(l, str)) + 1

    @property
    def w_kernel(self) -> int:
        return sum(l[2] - 1 for l in self.layers if not isinstance(l, str)) + 1

    def init(self, generator: torch.Generator) -> "RadialFlowNetwork":
        """Random trunk weights from a CPU ``torch.Generator``."""
        init_params(self.filter, generator)
        return self

    @full_f32()
    def costs(self, polar_prev: torch.Tensor,
              polar_curr: torch.Tensor) -> torch.Tensor:
        """(..., H, W, C) polar pair -> (..., H', W', hWin) radial costs."""
        f_prev = self.filter(polar_prev)
        f_curr = self.filter(polar_curr)
        # crop prev features at the bottom by hWin-1 (one-sided search)
        f_prev = f_prev[..., : f_prev.shape[-3] - self.h_win + 1, :, :]
        return matching.match_ssd_radial(f_prev, f_curr, self.h_win)

    @full_f32()
    def log_scores(self, polar_prev, polar_curr) -> torch.Tensor:
        """Trainer head: log_softmax(-cost) over the hWin classes."""
        return torch.log_softmax(-self.costs(polar_prev, polar_curr), dim=-1)

    @staticmethod
    def filter_output_trainer(logp: torch.Tensor, threshold: float
                              ) -> Tuple[torch.Tensor, torch.Tensor]:
        """WTA class index and the confidence gate exp(max log-prob) >=
        threshold. logp (..., hWin) -> (idx (...) int32, good (...) bool)."""
        m = torch.amax(logp, dim=-1)
        idx = torch.argmax(logp, dim=-1).to(torch.int32)
        return idx, torch.exp(m) >= threshold

    @full_f32()
    @torch.no_grad()
    def flow(self, polar_prev, polar_curr) -> Tuple[torch.Tensor, torch.Tensor]:
        """Tester decode: WTA radial flow (first argmin over hWin, int32)
        and the min cost."""
        costs = self.costs(polar_prev, polar_curr)
        return (torch.argmin(costs, dim=-1).to(torch.int32),
                torch.amin(costs, dim=-1))

    @full_f32()
    def flow_batch(self, polar_prev, polar_curr):
        """Throughput path: batched (B, H, W, C) polar pairs -> batched
        (flow, min_cost); the same computation as ``flow`` with a leading
        batch dim, in the program's span ``radial.net``."""
        with profiled_span("radial.net"):
            return self.flow(polar_prev, polar_curr)
