"""Geometry / learning configuration (port of ``depth_estimation_tpu.geometry``).

Pure Python: frozen dataclasses with the same fields, defaults and derived
properties as the reference, so a checkpoint's ``meta.json`` builds the
same configuration in both packages.

Conventions (unchanged):
  * the search window is ``maxh x maxw``; centered displacement ``dy``
    ranges over ``[-(ceil(maxh/2)-1), floor(maxh/2)]``, same for ``dx``;
  * the trunk is a stack of VALID convolutions whose composed footprint is
    ``hKernel x wKernel``.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Literal, Tuple

# One conv layer: (in_channels, kernel_h, kernel_w, out_channels).
LayerSpec = Tuple[int, int, int, int]


@dataclasses.dataclass(frozen=True)
class Geometry:
    """Static geometry of a flow matcher model (shapes, windows, pyramid)."""

    hImg: int = 180
    wImg: int = 320

    layers: Tuple[LayerSpec, ...] = ((3, 16, 16, 10),)

    maxh: int = 16
    maxw: int = 16

    maxhGT: int = 16
    maxwGT: int = 16
    hKernelGT: int = 16
    wKernelGT: int = 16

    multiscale: bool = False
    ratios: Tuple[int, ...] = (1,)
    share_filters: bool = True
    cascad_trainable_weights: bool = False
    single_beta: bool = False

    output_extraction_method: Literal["max", "mean"] = "max"

    prefilter: bool = False

    training_mode: bool = True

    @property
    def hKernel(self) -> int:
        """Total vertical footprint of the conv stack (composition)."""
        return sum(l[1] - 1 for l in self.layers) + 1

    @property
    def wKernel(self) -> int:
        return sum(l[2] - 1 for l in self.layers) + 1

    @property
    def hPatch2(self) -> int:
        """Height of the patch fed to the 2nd (searched) branch."""
        return self.maxh + self.hKernel - 1

    @property
    def wPatch2(self) -> int:
        return self.maxw + self.wKernel - 1

    @property
    def hPatch1(self) -> int:
        return self.hKernel

    @property
    def wPatch1(self) -> int:
        return self.wKernel

    @property
    def halfh1(self) -> int:
        return int(math.ceil(self.maxh / 2)) - 1

    @property
    def halfh2(self) -> int:
        return self.maxh // 2

    @property
    def halfw1(self) -> int:
        return int(math.ceil(self.maxw / 2)) - 1

    @property
    def halfw2(self) -> int:
        return self.maxw // 2

    @property
    def in_channels(self) -> int:
        return self.layers[0][0]

    @property
    def out_channels(self) -> int:
        return self.layers[-1][3]

    @property
    def rmax(self) -> int:
        return self.ratios[-1]

    def validate(self) -> None:
        if self.multiscale:
            if self.ratios[0] != 1:
                raise ValueError("first pyramid ratio must be 1")
            for r in self.ratios:
                k = self.rmax - r
                if (self.maxh * k) % 2 or (self.maxw * k) % 2:
                    raise ValueError(
                        "maxh/maxw * (rmax - r) must be even for every ratio")
        for a, b in zip(self.layers[:-1], self.layers[1:]):
            if a[3] < b[0]:
                raise ValueError("layer channel chain mismatch")


@dataclasses.dataclass(frozen=True)
class Learning:
    """Training hyper-parameters (``training.train``; carried by
    checkpoints)."""

    rate: float = 5e-3
    rate_decay: float = 5e-7
    weight_decay: float = 0.0
    n_epochs: int = 10
    criterion: Literal["nll", "mse", "soft"] = "nll"
    soft_targets: bool = False
    st_sigma2: float = 1.0
    batch_size: int = 32
