"""The 'liu' ground truth's throughput path: ``data/groundtruth.
liu_flow_batched(im1s, im2s, **schedule)`` (Ce Liu's coarse-to-fine solve,
kernel B4 in its SOR) on batches of working-size frame pairs
(``traffic.working_frames``, made on the card from the seed), a few
distinct batches cycled. A step solves one batch and waits for (vx, vy)
on the card.

The comparison: a few steps kept by the harness, each recomputed by the
plain reference (``reference/liu.py``) from the same frames: the widest
and the mean gap of the flow, in px, and the IRLS steps the kept solve
made short of the schedule's, read from the program's counter
``liu.irls_steps``. The control: the reference with du and dv rounded to
bfloat16 after every SOR solve, a 2-byte state, in the program's place.
"""

from __future__ import annotations

import sys

import torch

from h100bench import liu_counts, traffic
from h100bench.reference import liu as ref_liu

CONTROL_STATE = torch.bfloat16


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, devices):
        from depth_estimation_tpu_torch.data import groundtruth
        from depth_estimation_tpu_torch.flow import celiu
        from depth_estimation_tpu_torch.utils import timer
        if not hasattr(groundtruth, "liu_flow_batched"):
            raise SystemExit("the program has no data/groundtruth."
                             "liu_flow_batched")
        s = cfg["solver"]
        if (s["noise_model"], s["interpolation"]) != ("lap", "bilinear"):
            raise SystemExit("liu_flow_batched solves with the Laplacian "
                             "noise model and bilinear warps only")
        self.gt, self.counters = groundtruth, timer.COUNTERS
        self.kw = {k: s[k] for k in ("alpha", "ratio", "min_width",
                                     "n_outer", "n_inner", "n_sor")}
        img = cfg["image"]
        self.hw = (img["hImg"], img["wImg"])
        self.schedule_steps = sum(st for _, _, st, _ in liu_counts.schedule(
            *self.hw, s["ratio"], s["min_width"], s["n_outer"], s["n_sor"]))
        self._targets = [(groundtruth, "liu_flow_batched", "solve", None),
                         (celiu, "sor_redblack", "sor", liu_counts.sor_work)]
        self.dev = torch.device(devices[0])
        self.items = B = int(mix["pairs"])
        gen = traffic.device_generator(seed, self.dev)
        self.batches = [tuple(f.contiguous() for f in traffic.working_frames(
            gen, B, *self.hw, self.dev))
            for _ in range(int(mix["distinct_batches"]))]
        self.t = 0
        self._bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self._last = None

    def step(self) -> None:
        k = self.t % len(self.batches)
        self.t += 1
        before = self.counters["liu.irls_steps"]
        vx, vy = self.gt.liu_flow_batched(*self.batches[k], **self.kw)
        ok = torch.isfinite(vx) & torch.isfinite(vy)
        self._bad += (~ok.flatten(1).all(1)).sum()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self._last = (k, vx, vy, self.counters["liu.irls_steps"] - before)

    def last(self):
        return self._last

    def failed(self) -> int:
        return int(self._bad)

    def spans(self):
        return self._targets

    def flops(self) -> float:
        """The solve's FP32 operations a step (``liu_counts.solve_flops``)."""
        kw = {k: v for k, v in self.kw.items() if k != "alpha"}
        return liu_counts.solve_flops(self.items, *self.hw, **kw)

    def release(self) -> None:
        self._last = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    @torch.no_grad()
    def check(self, records, control: bool = False) -> dict:
        """Compared numbers over the kept steps: ``flow_px``, the widest
        |dvx| or |dvy|; ``flow_mean_px``, their mean over every pixel of
        both fields; ``steps_short``, the most IRLS steps a kept solve
        made away from the schedule's. With ``control`` the reference with
        a bfloat16 SOR state stands in the program's place."""
        widest, total, count, short = 0.0, 0.0, 0, 0
        for k, vx, vy, steps in records:
            want = ref_liu.coarse_to_fine(*self.batches[k], **self.kw)[:2]
            if control:
                vx, vy = ref_liu.coarse_to_fine(
                    *self.batches[k], **self.kw,
                    state_dtype=CONTROL_STATE)[:2]
                steps = self.schedule_steps
            for got, ref in ((vx, want[0]), (vy, want[1])):
                d = (got.double() - ref.double()).abs()
                if not torch.isfinite(got).all():
                    d = torch.full_like(d, float("inf"))
                widest = max(widest, float(d.max()))
                total += float(d.sum())
                count += d.numel()
            short = max(short, abs(self.schedule_steps - int(steps)))
        print(f"{len(records)} batches compared"
              f"{' (control)' if control else ''}", file=sys.stderr)
        return {"flow_px": widest, "flow_mean_px": total / max(count, 1),
                "steps_short": float(short)}


def build(cfg: dict, mix: dict, seed: int, devices) -> Program:
    return Program(cfg, mix, seed, devices)
