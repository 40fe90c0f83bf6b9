"""Legacy direct depth models (port of ``depth_estimation_tpu.models.legacy_depth``):
  * the classic CNN: subtractive normalization -> conv(50, 5x5) -> tanh ->
    2x2 max pool -> normalization -> conv(128, 5x5) -> tanh -> 2x2 max pool
    -> conv(200, 5x5) -> tanh -> a linear classifier over depth classes at
    every pixel;
  * the 'opticalflow' variant: a shared conv + tanh on both patches and an
    SSD window match.
Layouts are channels-last at the module boundary, NCHW inside. Weights come
from the flax trees through ``models.io.legacy_state_from_jax``.
"""

from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch import nn

from ..ops import matching
from ..ops.normalization import _local_mean, _window
from ..utils.device import resolve
from ..utils.precision import full_f32
from .filters import DenseConv, init_params, to_nchw, to_nhwc


def subtractive_normalization(img: torch.Tensor, k: int = 15) -> torch.Tensor:
    """nn.SpatialSubtractiveNormalization with gaussian1D(k). img (..., H,
    W, C); each leading index is one image."""
    _, mean = _local_mean(img, _window(k, img.shape[-1]))
    return img - mean[..., None]


class DepthClassifierCNN(nn.Module):
    """Patch (a 2-frame stack on the channels) -> per-pixel depth-class
    logits, on ``device`` (the card by default; ``device="cpu"`` to run on
    the CPU)."""

    def __init__(self, n_classes: int, in_channels: int = 2, device="cuda"):
        super().__init__()
        self.n_classes = n_classes
        self.conv1 = DenseConv(in_channels, 50, 5, 5)
        self.conv2 = DenseConv(50, 128, 5, 5)
        self.conv3 = DenseConv(128, 200, 5, 5)
        self.classifier = nn.Linear(200, n_classes)
        self.to(resolve(device))

    def init(self, generator: torch.Generator) -> "DepthClassifierCNN":
        """Random weights from a CPU ``torch.Generator``."""
        init_params(self, generator)
        return self

    @full_f32()
    def forward(self, x: torch.Tensor) -> torch.Tensor:
        """x (..., H, W, in_channels) -> (..., H', W', n_classes)."""
        lead = x.shape[:-3]
        x = subtractive_normalization(x, 15)
        h = F.max_pool2d(torch.tanh(self.conv1(to_nchw(x))), 2, 2)
        x = subtractive_normalization(to_nhwc(h, lead), 15)
        h = F.max_pool2d(torch.tanh(self.conv2(to_nchw(x))), 2, 2)
        h = torch.tanh(self.conv3(h))
        return self.classifier(to_nhwc(h, lead))


class LegacyFlowModel(nn.Module):
    """The 'opticalflow' variant: one shared kernel x kernel conv
    (1 -> n_features) + tanh, then the maxh x maxw SSD match, on ``device``
    (the card by default)."""

    def __init__(self, maxh: int = 16, maxw: int = 16, kernel: int = 16,
                 n_features: int = 10, device="cuda"):
        super().__init__()
        self.maxh, self.maxw = maxh, maxw
        self.kernel = kernel
        self.conv = DenseConv(1, n_features, kernel, kernel)
        self.to(resolve(device))

    def init(self, generator: torch.Generator) -> "LegacyFlowModel":
        """Random weights from a CPU ``torch.Generator``."""
        init_params(self, generator)
        return self

    def _features(self, patch: torch.Tensor) -> torch.Tensor:
        return torch.tanh(to_nhwc(self.conv(to_nchw(patch)), patch.shape[:-3]))

    @full_f32()
    def costs(self, patch1: torch.Tensor, patch2: torch.Tensor) -> torch.Tensor:
        """(..., H, W, 1) patches -> (..., H'', W'', maxh * maxw) SSD, the
        first patch cropped by the window's halves."""
        h1 = math.ceil(self.maxh / 2) - 1
        w1 = math.ceil(self.maxw / 2) - 1
        H, W = patch1.shape[-3], patch1.shape[-2]
        p1 = patch1[..., h1:H - self.maxh // 2, w1:W - self.maxw // 2, :]
        return matching.match_ssd(self._features(p1), self._features(patch2),
                                  self.maxh, self.maxw)
