"""The multiscale model's throughput path:
``MultiscaleFlowModel.decode_full_staged(imgs1, imgs2)`` on batches of
working-resolution frame pairs (``traffic.working_frames``, made on the
card from the seed), a few distinct batches cycled. A step decodes one
batch and waits for (idx, pmax) on the card. The trunk's weights are made
on the card from the seed and handed to the program and to the reference
alike.

The comparison: a few steps kept by the harness, each recomputed by the
plain reference from the same frames and weights: the share of pixels
whose WTA index differs, and the widest gap of its probability.
"""

from __future__ import annotations

import math
import sys

import torch

from h100bench import compare, counts, single_scale as ss, traffic
from h100bench.reference import multiscale as ref_ms
from h100bench.reference import online as ref


def _geometry(cfg: dict):
    from depth_estimation_tpu_torch.geometry import Geometry
    g = cfg["geometry"]
    return Geometry(hImg=g["hImg"], wImg=g["wImg"],
                    layers=tuple(map(tuple, g["layers"])), maxh=g["maxh"],
                    maxw=g["maxw"], multiscale=True, ratios=tuple(g["ratios"]),
                    share_filters=True)


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, devices):
        from depth_estimation_tpu_torch.models import filters, multiscale
        from depth_estimation_tpu_torch.ops import matching
        g = cfg["geometry"]
        self.layers = tuple(map(tuple, g["layers"]))
        self._targets = [
            (multiscale.MultiscaleFlowModel, "decode_full_staged", "api", None),
            (multiscale.MultiscaleFlowModel, "features_pyramid", "pyramid",
             None),
            (multiscale.MultiscaleFlowModel, "decode_from_features", "decode",
             None),
            (filters.ConvFilter, "forward", "trunk", ss.trunk_work(self.layers)),
            (matching, "match_ssd", "match_ssd", _ssd_work)]
        self.cfg = cfg
        self.dev = torch.device(devices[0])
        self.items = B = int(mix["pairs"])
        gen = traffic.device_generator(seed, self.dev)
        # the trunk's weights: LeCun-normal kernels, small biases
        self.weights = []
        for cin, kh, kw, cout in self.layers:
            w = torch.randn((cout, cin, kh, kw), generator=gen,
                            device=self.dev) / math.sqrt(cin * kh * kw)
            b = 0.1 * torch.randn((cout,), generator=gen, device=self.dev)
            self.weights.append((w, b))
        self.batches = [traffic.working_frames(gen, B, g["hImg"], g["wImg"],
                                               self.dev)
                        for _ in range(int(mix["distinct_batches"]))]
        decode = cfg["storage"]["decode"]
        self.model = multiscale.MultiscaleFlowModel(
            _geometry(cfg), device=self.dev,
            decode_dtype=None if decode == "float32" else ss.torch_dtype(decode))
        self.model.load_state_dict({
            f"filters.0.layer{i + 1}.{k}": v
            for i, (w, b) in enumerate(self.weights)
            for k, v in (("weight", w), ("bias", b))})
        self.model.requires_grad_(False)
        self.t = 0
        self._bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self._last = None

    def step(self) -> None:
        k = self.t % len(self.batches)
        self.t += 1
        idx, pmax = self.model.decode_full_staged(*self.batches[k])
        self._bad += (~torch.isfinite(pmax).flatten(1).all(1)).sum()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self._last = (k, dict(idx=idx, pmax=pmax))

    def last(self):
        return self._last

    def failed(self) -> int:
        return int(self._bad)

    def spans(self):
        return self._targets

    def flops(self) -> float:
        """The trunk on both frames of every pair at each pyramid scale's
        padded size, and the SSD over each scale's window cells."""
        g = self.cfg["geometry"]
        kh = sum(l[1] - 1 for l in self.layers) + 1
        kw = sum(l[2] - 1 for l in self.layers) + 1
        ph, pw = g["maxh"] + kh - 2, g["maxw"] + kw - 2
        total = 0
        for r in g["ratios"]:
            H, W = g["hImg"] // r + ph, g["wImg"] // r + pw
            total += counts.trunk_flops(self.layers, 2 * self.items, H, W)
            hc, wc = H - kh + 1 - g["maxh"] + 1, W - kw + 1 - g["maxw"] + 1
            f1 = (self.items, hc, wc, self.layers[-1][3])
            total += counts.ssd_work(f1, f1, g["maxh"], g["maxw"])[1]
        return float(total)

    def release(self) -> None:
        self.model = None
        self._last = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, m, k: int, control: bool):
        with ref.tf32(control):
            idx, pmax = ref_ms.decode(m, *self.batches[k])
        return dict(idx=idx, pmax=pmax)

    @torch.no_grad()
    def check(self, records, control: bool = False) -> dict:
        """Compared numbers over the kept steps: the share of pixels whose
        WTA index differs (%) and the widest gap of its probability. With
        ``control`` the reference in TF32 stands in the program's place."""
        g = self.cfg["geometry"]
        m = ref_ms.Multiscale(g["hImg"], g["wImg"], g["maxh"], g["maxw"],
                              tuple(g["ratios"]), self.layers, self.weights)
        gaps = compare.Gaps()
        for k, outs in records:
            want = self._reference(m, k, False)
            got = self._reference(m, k, True) if control else outs
            gaps.share("idx_pct", got["idx"] != want["idx"])
            gaps.wide("pmax_gap", got["pmax"], want["pmax"])
        print(f"{len(records)} batches compared"
              f"{' (control)' if control else ''}", file=sys.stderr)
        return gaps.numbers()


def _ssd_work(args, kwargs):
    f1, f2, maxh, maxw = args[:4]
    return counts.ssd_work(tuple(f1.shape), tuple(f2.shape), maxh, maxw)


def build(cfg: dict, mix: dict, seed: int, devices) -> Program:
    return Program(cfg, mix, seed, devices)
