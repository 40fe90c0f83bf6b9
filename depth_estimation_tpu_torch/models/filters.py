"""Conv feature trunk (port of ``depth_estimation_tpu.models.filters``).

A stack of VALID convolutions with tanh between layers and none after the
last. A layer whose nominal ``cin`` differs from the previous layer's
``cout`` is a ``SparseConvMap``: each output map reads a fixed random subset
of input channels, its parameters are the sparse kernel, and the dense
kernel is rebuilt from it at apply time.

The JAX trunk's width-folded ``s2d_conv`` is a TPU lane-padding workaround
that equals a plain VALID conv; here every layer is ``F.conv2d``. Layouts:
channels-last ``(..., H, W, C)`` at the module boundary, NCHW inside.
"""

from __future__ import annotations

import math

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from ..geometry import Geometry


def random_connection_table(nin: int, nout: int, nto: int,
                            seed: int = 0) -> np.ndarray:
    """(nout, nto) int table: each output channel's nto distinct input
    channels, drawn as the reference package draws them."""
    rng = np.random.RandomState(seed)
    return np.stack([rng.choice(nin, size=nto, replace=False)
                     for _ in range(nout)])


def _conv(x: torch.Tensor, weight: torch.Tensor,
          bias: torch.Tensor) -> torch.Tensor:
    """VALID conv of x (N, C, H, W) in x's dtype, the weight and bias
    rounded to it. On the CPU a bf16 or f16 input is convolved in f32 on
    the stored values, the sums rounded to its type, and the bias added in
    it, as the reference's trunk rounds: oneDNN's reduced-precision CPU
    convolution returns wrong values at some shapes (bf16, a 12x12 kernel
    on 8 channels: relative error ~1 with torch 2.13)."""
    dt = x.dtype
    if x.device.type == "cpu" and dt in (torch.bfloat16, torch.float16):
        y = F.conv2d(x.float(), weight.to(dt).float()).to(dt)
        return y + bias.to(dt)[:, None, None]
    return F.conv2d(x, weight.to(dt), bias.to(dt))


class DenseConv(nn.Module):
    """VALID conv with a (cout, cin, kh, kw) weight and a bias."""

    def __init__(self, cin: int, cout: int, kh: int, kw: int):
        super().__init__()
        self.weight = nn.Parameter(torch.zeros(cout, cin, kh, kw))
        self.bias = nn.Parameter(torch.zeros(cout))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(x, self.weight, self.bias)


class SparseConvMap(nn.Module):
    """Sparse random-connection conv: parameters are the (kh, kw, nto, nout)
    sparse kernel; the dense (nout, nin, kh, kw) kernel is scattered from it
    through the fixed connection table."""

    def __init__(self, nin: int, nout: int, nto: int, kh: int, kw: int,
                 seed: int = 0):
        super().__init__()
        self.nin, self.nout, self.nto = nin, nout, nto
        table = random_connection_table(nin, nout, nto, seed)
        self.register_buffer("table", torch.from_numpy(table).long(),
                             persistent=False)
        self.kernel = nn.Parameter(torch.zeros(kh, kw, nto, nout))
        self.bias = nn.Parameter(torch.zeros(nout))

    def dense_kernel(self) -> torch.Tensor:
        kh, kw = self.kernel.shape[:2]
        dense = self.kernel.new_zeros(kh, kw, self.nin, self.nout)
        o = torch.arange(self.nout, device=self.kernel.device)
        for j in range(self.nto):
            dense[:, :, self.table[:, j], o] = self.kernel[:, :, j, :]
        return dense.permute(3, 2, 0, 1).contiguous()

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return _conv(x, self.dense_kernel(), self.bias)


class ConvFilter(nn.Module):
    """Feature trunk: geometry.layers = ((cin, kh, kw, cout), ...)."""

    def __init__(self, geometry: Geometry):
        super().__init__()
        self.geometry = geometry
        layers = geometry.layers
        for i, (cin, kh, kw, cout) in enumerate(layers):
            prev_cout = layers[i - 1][3] if i > 0 else cin
            if i > 0 and prev_cout != cin:
                mod = SparseConvMap(prev_cout, cout, cin, kh, kw)
            else:
                mod = DenseConv(cin, cout, kh, kw)
            self.add_module(f"layer{i + 1}", mod)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., H, W, Cin) -> (..., H', W', K), channels-last."""
        h = to_nchw(x)
        n = len(self.geometry.layers)
        for i in range(n):
            h = getattr(self, f"layer{i + 1}")(h)
            if i != n - 1:
                h = torch.tanh(h)
        return to_nhwc(h, x.shape[:-3])


def to_nchw(x: torch.Tensor) -> torch.Tensor:
    """(..., H, W, C) -> (N, C, H, W), the leading dims flattened."""
    return x.reshape((-1,) + tuple(x.shape[-3:])).permute(0, 3, 1, 2)


def to_nhwc(h: torch.Tensor, lead) -> torch.Tensor:
    """(N, C, H, W) -> (*lead, H, W, C), contiguous."""
    h = h.permute(0, 2, 3, 1).contiguous()
    return h.reshape(tuple(lead) + tuple(h.shape[1:]))


def _lecun_normal(shape, fan_in: int, generator) -> torch.Tensor:
    """flax's lecun_normal: a normal truncated at two standard deviations,
    scaled to variance 1 / fan_in."""
    std = math.sqrt(1.0 / fan_in) / 0.87962566103423978
    w = torch.empty(shape)
    nn.init.trunc_normal_(w, 0.0, std, -2 * std, 2 * std, generator=generator)
    return w


@torch.no_grad()
def init_params(module: nn.Module, generator: torch.Generator) -> nn.Module:
    """Random weights at the reference's initial scales for every conv and
    linear layer of ``module``: lecun-normal dense kernels, uniform sparse
    kernels of variance 1 / (3 fan_in), zero biases. Drawn on the CPU from
    ``generator`` (a CPU ``torch.Generator``), then copied to the module's
    device, so a seed gives the same weights on every device."""
    for m in module.modules():
        if isinstance(m, DenseConv):
            cout, cin, kh, kw = m.weight.shape
            w = _lecun_normal((kh, kw, cin, cout), kh * kw * cin, generator)
            m.weight.copy_(w.permute(3, 2, 0, 1))
        elif isinstance(m, SparseConvMap):
            kh, kw, nto, _ = m.kernel.shape
            lim = math.sqrt(1.0 / (kh * kw * nto))
            w = torch.empty(m.kernel.shape)
            nn.init.uniform_(w, -lim, lim, generator=generator)
            m.kernel.copy_(w)
        elif isinstance(m, nn.Linear):
            w = _lecun_normal((m.in_features, m.out_features), m.in_features,
                              generator)
            m.weight.copy_(w.t())
        else:
            continue
        m.bias.zero_()
    return module


def identity_filter_params(geometry: Geometry) -> dict:
    """Single-layer trunk parameters (flax tree layout, numpy) whose features
    are the raw input patch vectorized; load with
    ``models.io.filter_state_from_jax``."""
    if len(geometry.layers) != 1:
        raise ValueError("identity filter needs a single layer")
    cin, kh, kw, cout = geometry.layers[0]
    if cout != kh * kw * cin:
        raise ValueError("identity filter needs cout == kh*kw*cin")
    kernel = np.zeros((kh, kw, cin, cout), np.float32)
    for i in range(kh):
        for j in range(kw):
            for k in range(cin):
                kernel[i, j, k, (i * kw + j) * cin + k] = 1.0
    return {"params": {"layer1": {"kernel": kernel,
                                  "bias": np.zeros((cout,), np.float32)}}}
