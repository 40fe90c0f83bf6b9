"""The batched online program: ``api_batched.BatchedDepthEstimator
.next_frames`` over B streams in lockstep, each a ping-pong walk of
camera frames made on the card from the seed (``traffic.camera_streams``).
A step hands the estimator every stream's next uint8 frame and waits for
(xflow, mask, depth, good) on the card; the ego-motion it computed on the
way (R, inliers, found) is kept beside them, by a wrapper around
``egomotion.get_ego_motion_batched`` that hands its result on untouched.

The comparison: a few steps kept by the harness, each recomputed by the
plain reference from the same two frames of every stream and the same
RANSAC noise (the step's output depends on the previous frame and the
current one only), in blocks of ``ref_block`` streams (the mix's; by
default the program's batch a card).
"""

from __future__ import annotations

import functools
import sys

import torch

from h100bench import compare, single_scale as ss, traffic
from h100bench.harness import ROOT
from h100bench.reference import online as ref


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, devices):
        from depth_estimation_tpu_torch import api_batched
        from depth_estimation_tpu_torch.models import filters
        from depth_estimation_tpu_torch.ops import matching
        from depth_estimation_tpu_torch.geometry3d import egomotion
        self._targets = [
            (api_batched.BatchedDepthEstimator, "next_frames", "api", None),
            (egomotion, "get_ego_motion_batched", "ego", None),
            (filters.ConvFilter, "forward", "trunk",
             ss.trunk_work(tuple(map(tuple, cfg["geometry"]["layers"])))),
            (matching, "match_flow_fused", "match", ss.b1_work)]
        self.cfg = cfg
        self.devices = list(devices)
        self.dev = torch.device(self.devices[0])
        self.items = B = int(mix["streams"])
        self.n_frames = int(mix["frames"])
        self.block = B // len(self.devices)
        knobs = cfg["batched"]
        gen = traffic.device_generator(seed, self.dev)
        self.frames = traffic.camera_streams(
            gen, B, self.n_frames, tuple(mix["frame_hw"]),
            tuple(mix["texture"]), tuple(mix["depth_grid"]),
            tuple(mix["zoom"]))
        geom, params = ss.port_model(cfg, ROOT)
        d = knobs["ego_downsample"]
        n = min(cfg["camera"]["max_points"], (geom.hImg // d) * (geom.wImg // d))
        self.noise = ss.gumbel(gen, knobs["ransac_samples"], n)
        st = cfg["storage"]
        self.est = api_batched.BatchedDepthEstimator(
            geom, params, ss.port_calibration(cfg), head=knobs["head"],
            match_dtype=ss.torch_dtype(st["match"]),
            warp_dtype=ss.torch_dtype(st["warp"]),
            state_dtype=ss.torch_dtype(st["state"]),
            ego_downsample=d, compensation=knobs["compensation"],
            lk_iters=knobs["lk_iters"], ransac_samples=knobs["ransac_samples"],
            match_block=knobs["match_block"],
            corner_selector=knobs["corner_selector"],
            lk_search=knobs["lk_search"], device=self.dev,
            ransac_noise=self.noise)
        self._ego = egomotion
        self._ego_fn = fn = egomotion.get_ego_motion_batched

        @functools.wraps(fn)
        def keep_ego(*args, **kwargs):
            em = fn(*args, **kwargs)
            self._em = (em.R, em.n_inliers, em.n_found)
            return em
        egomotion.get_ego_motion_batched = keep_ego
        self._em = None
        self.ref_block = int(mix.get("ref_block", self.block))
        self.t = 0
        self.est.reset(self.frames[traffic.ping_pong(0, self.n_frames)])
        self._bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self._last = None

    def step(self) -> None:
        self.t += 1
        prev = traffic.ping_pong(self.t - 1, self.n_frames)
        cur = traffic.ping_pong(self.t, self.n_frames)
        xflow, mask, depth, good = self.est.next_frames(self.frames[cur])
        ok = (torch.isfinite(xflow).flatten(1).all(1)
              & torch.isfinite(mask).flatten(1).all(1))
        self._bad += (~ok).sum()
        for d in self.devices:
            if torch.device(d).type == "cuda":
                torch.cuda.synchronize(d)
        self._last = (prev, cur, dict(xflow=xflow, mask=mask, depth=depth,
                                      good=good), self._em)

    def last(self):
        return self._last

    def failed(self) -> int:
        return int(self._bad)

    def spans(self):
        return self._targets

    def flops(self) -> float:
        g = self.cfg["geometry"]
        return float(ss.model_flops(tuple(map(tuple, g["layers"])), self.items,
                                    g["hImg"], g["wImg"], g["maxh"], g["maxw"]))

    def release(self) -> None:
        if self._ego is not None:
            self._ego.get_ego_motion_batched = self._ego_fn
            self._ego = None
        self.est = None
        self._last = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _reference(self, model, cam, prev, cur, a, b, control: bool,
                   theirs=None):
        k = self.cfg["batched"]
        with ref.tf32(control):
            return ref.batched_pairs(
                model, cam, self.frames[prev, a:b], self.frames[cur, a:b],
                self.noise, k["ego_downsample"], k["lk_iters"],
                k["lk_search"], theirs)

    @torch.no_grad()
    def check(self, records, control: bool = False) -> dict:
        """Compared numbers over the kept steps, every stream: x-flow's
        widest gap (px), the shares of mask pixels and of depths (off by >
        1%) that differ, and on the streams whose reference RANSAC winner
        is 8 distinct points R's widest gap. Where the winner repeats a
        point the reference goes on from the judged side's R, inliers and
        found (its own R is then whichever nullspace vector the QR build
        returns). With ``control`` the reference in TF32 stands in the
        program's place. Prints, on standard error, the streams that took
        the judged side's R and those whose bad-frame gate differs."""
        model = ss.ref_model(self.cfg, ROOT, self.dev)
        cam = ss.ref_camera(self.cfg)
        g = compare.Gaps()
        flips = streams = repeated = good = 0
        for prev, cur, outs, em in records:
            for a in range(0, self.items, self.ref_block):
                b = min(self.items, a + self.ref_block)
                if control:
                    got = self._reference(model, cam, prev, cur, a, b, True)
                    theirs = (got["R"], got["inliers"], got["found"])
                else:
                    got = {k: v[a:b].to(self.dev) for k, v in outs.items()}
                    theirs = tuple(v[a:b].to(self.dev) for v in em)
                    got["R"] = theirs[0]
                want = self._reference(model, cam, prev, cur, a, b, False,
                                       theirs)
                compare.flow_gaps(g, got, want)
                own = want["distinct"]
                g.wide("rot_gap", got["R"][own], want["R"][own])
                flips += int((got["good"] != want["good"]).sum())
                good += int(want["good"].sum())
                repeated += int((~own).sum())
                streams += b - a
        print(f"{streams} streams compared{' (control)' if control else ''}"
              f": {repeated} went on from the judged side's R (the "
              f"reference's RANSAC winner repeats a point), bad-frame gate "
              f"passed on {good}, differs on {flips}", file=sys.stderr)
        return g.numbers()


def build(cfg: dict, mix: dict, seed: int, devices) -> Program:
    return Program(cfg, mix, seed, devices)
