"""The version2 net's batched flow, BASELINE config1:
``V2Network.flow_batch(imgs1, imgs2)`` on batches of working-resolution
frame pairs (``traffic.working_frames``, made on the card from the seed),
a few distinct batches cycled. A step matches one batch and waits for the
matching core's (idx, ey, ex, pmax) on the card. The trunk's weights are
made on the card from the seed and handed to the program and to the
reference alike.

The comparison: a few steps kept by the harness, each recomputed by the
plain reference (``reference/v2.py``: the direct SSD, as SpatialMatching
computes it) from the same frames and weights, in blocks of ``ref_block``
pairs (the mix's; by default 8): ``idx_pct``, the share of pixels whose
WTA index differs; ``e_px``, the widest gap of ey or ex, px; ``pmax_gap``,
the widest gap of pmax.
"""

from __future__ import annotations

import math
import sys

import torch

from h100bench import compare, single_scale as ss, traffic, v2_counts
from h100bench.reference import v2 as ref

OUTS = ("idx", "ey", "ex", "pmax")


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, devices):
        from depth_estimation_tpu_torch.models import filters, version2
        from depth_estimation_tpu_torch.ops import matching
        if not hasattr(version2.V2Network, "flow_batch"):
            raise SystemExit("the program has no V2Network.flow_batch")
        from depth_estimation_tpu_torch.utils import timer
        net, img = cfg["network"], cfg["image"]
        if cfg["storage"] != "float32":
            raise SystemExit(f"storage {cfg['storage']!r}: the batched flow "
                             "matches f32 features")
        self.timer, self.matching = timer, matching
        self.layers = tuple(map(tuple, net["layers"]))
        self.norm_k = int(net["normalization_k"])
        self.h_win, self.w_win = int(net["hWin"]), int(net["wWin"])
        self.h, self.w = int(img["hImg"]), int(img["wImg"])
        self._targets = [
            (version2.V2Network, "flow_batch", "api", None),
            (filters.ConvFilter, "forward", "trunk",
             ss.trunk_work(self.layers)),
            (matching, "match_flow_fast", "match", v2_counts.fast_work)]
        self.dev = torch.device(devices[0])
        self.items = B = int(mix["pairs"])
        gen = traffic.device_generator(seed, self.dev)
        # the trunk's weights: LeCun-normal kernels, small biases
        (cin, kh, kw, cout), = self.layers
        self.weight = torch.randn((cout, cin, kh, kw), generator=gen,
                                  device=self.dev) / math.sqrt(cin * kh * kw)
        self.bias = 0.1 * torch.randn((cout,), generator=gen, device=self.dev)
        self.batches = [traffic.working_frames(gen, B, self.h, self.w,
                                               self.dev)
                        for _ in range(int(mix["distinct_batches"]))]
        datap = version2.V2Params(wImg=self.w, hImg=self.h,
                                  normalization_k=self.norm_k,
                                  layers=self.layers, hWin=self.h_win,
                                  wWin=self.w_win)
        self.model = version2.V2Network(datap, device=self.dev)
        self.model.load_state_dict({"filter.layer1.weight": self.weight,
                                    "filter.layer1.bias": self.bias})
        self.model.requires_grad_(False)
        self.ref_block = int(mix.get("ref_block", 8))
        self.t = 0
        self._bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self._last = None

    def step(self) -> None:
        k = self.t % len(self.batches)
        self.t += 1
        outs = dict(zip(OUTS, self.model.flow_batch(*self.batches[k])))
        finite = torch.stack([torch.isfinite(outs[n]) for n in OUTS[1:]])
        self._bad += (~finite.all(0).flatten(1).all(1)).sum()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self._last = (k, outs)

    def last(self):
        return self._last

    def failed(self) -> int:
        return int(self._bad)

    def spans(self):
        return self._targets

    def flops(self) -> float:
        """The trunk on both frames of every pair and B2's cross terms
        (``v2_counts.step_flops``)."""
        return v2_counts.step_flops(self.layers, self.h_win, self.w_win,
                                    self.items, self.h, self.w)

    def release(self) -> None:
        self.model = None
        self._last = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self, records, control: bool = False) -> dict:
        """Compared numbers over the kept steps (see the module's
        docstring). With ``control`` the reference in TF32 stands in the
        program's place."""
        m = ref.V2(self.norm_k, self.weight, self.bias, self.h_win,
                   self.w_win)
        gaps = compare.Gaps()
        for k, outs in records:
            img1, img2 = self.batches[k]
            want = ref.flow(m, img1, img2, block=self.ref_block)
            got = (ref.flow(m, img1, img2, tf32=True, block=self.ref_block)
                   if control else outs)
            gaps.share("idx_pct", got["idx"] != want["idx"])
            gaps.wide("e_px", got["ey"], want["ey"])
            gaps.wide("e_px", got["ex"], want["ex"])
            gaps.wide("pmax_gap", got["pmax"], want["pmax"])
        print(f"{len(records)} batches compared"
              f"{' (control)' if control else ''}; the program's counters: "
              f"v2.pairs {self.timer.COUNTERS['v2.pairs']}, "
              f"match_flow_fast.launches {self.matching.match_flow_fast.launches}",
              file=sys.stderr)
        return gaps.numbers()


def build(cfg: dict, mix: dict, seed: int, devices) -> Program:
    return Program(cfg, mix, seed, devices)
