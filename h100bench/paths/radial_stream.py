"""The radial (polar) depth stream: ``api_radial.BatchedRadialEstimator
.next_frames`` over B streams in lockstep, each a ping-pong walk of camera
frames at the calibration's size made on the card from the seed
(``traffic.camera_streams``). A step hands the estimator every stream's
next uint8 frame and waits for (flow, depth, confs, e2, good) on the card;
the ego-motion it computed on the way (R, T, inliers, found) is kept
beside them, by a wrapper around ``egomotion.get_ego_motion_batched`` that
hands its result on untouched, and so is each stream's smoothed epipole
from the step before (the EMA's state). The net's weights are made on the
card from the seed and handed to the program and to the reference alike.

The comparison: a few steps kept by the harness, each recomputed by the
plain reference (``reference/radial.py``) from the same two frames of
every stream, the same RANSAC noise and the same epipole state, in blocks
of ``ref_block`` streams (the mix's; by default the whole batch):
``rflow_pct``, the share of polar pixels whose WTA index differs;
``depth_pct``, the share of confident depths (confident on either side)
off by more than 1%; ``e2_px``, the widest gap of the smoothed epipoles;
``good_diff``, the streams whose gate differs; ``repeat_pct``, the share of
streams whose reference RANSAC winner repeats a point, where the
reference goes on from the program's pose (a count, not a check: its
limit is 100).
"""

from __future__ import annotations

import functools
import math
import sys

import torch

from h100bench import compare, radial_counts, single_scale as ss, traffic
from h100bench.reference import radial as ref


class Program:
    def __init__(self, cfg: dict, mix: dict, seed: int, devices):
        try:
            from depth_estimation_tpu_torch import api_radial
        except ImportError as e:
            raise SystemExit(f"the program has no api_radial: {e}")
        from depth_estimation_tpu_torch.geometry3d import egomotion
        from depth_estimation_tpu_torch.models import radial
        from depth_estimation_tpu_torch.utils import timer
        net_cfg, polar = cfg["network"], cfg["polar"]
        if float(polar["ema_alpha"]) != api_radial.EMA_ALPHA:
            raise SystemExit(f"the estimator smooths the epipole with alpha "
                             f"{api_radial.EMA_ALPHA}, the configuration "
                             f"says {polar['ema_alpha']}")
        self.timer = timer
        self.spec = tuple(l if isinstance(l, str) else tuple(l)
                          for l in net_cfg["layers"])
        self.h_win = int(net_cfg["h_win"])
        self.cfg = cfg
        self._targets = [
            (api_radial.BatchedRadialEstimator, "next_frames", "api", None),
            (egomotion, "get_ego_motion_batched", "ego", None),
            (radial.RadialFilter, "forward", "trunk",
             radial_counts.trunk_work(self.spec))]
        self.dev = torch.device(devices[0])
        self.items = B = int(mix["streams"])
        self.n_frames = int(mix["frames"])
        gen = traffic.device_generator(seed, self.dev)
        self.frames = traffic.camera_streams(
            gen, B, self.n_frames, tuple(mix["frame_hw"]),
            tuple(mix["texture"]), tuple(mix["depth_grid"]),
            tuple(mix["zoom"]))
        # the net's weights: LeCun-normal kernels, small biases
        self.weights = []
        for cin, kh, kw, cout in radial_counts.convs(self.spec):
            w = torch.randn((cout, cin, kh, kw), generator=gen,
                            device=self.dev) / math.sqrt(cin * kh * kw)
            b = 0.1 * torch.randn((cout,), generator=gen, device=self.dev)
            self.weights.append((w, b))
        cam = cfg["camera"]
        self.noise = ss.gumbel(gen, int(cfg["ransac_samples"]),
                               int(cam["max_points"]))
        net = radial.RadialFlowNetwork(self.spec, self.h_win, device=self.dev)
        net.load_state_dict({
            f"filter.layer{i + 1}.{k}": v
            for i, (w, b) in enumerate(self.weights)
            for k, v in (("weight", w), ("bias", b))})
        net.requires_grad_(False)
        self.h, self.w = int(polar["h_input"]), int(polar["w_input"])
        self.w_polar = self.w + net.w_kernel - 1
        self.est = api_radial.BatchedRadialEstimator(
            net, ss.port_calibration(cfg), self.h, self.w,
            float(polar["k_infty"]), device=self.dev, ransac_noise=self.noise)
        self._ego = egomotion
        self._ego_fn = fn = egomotion.get_ego_motion_batched

        @functools.wraps(fn)
        def keep_ego(*args, **kwargs):
            em = fn(*args, **kwargs)
            self._em = (em.R, em.T, em.n_inliers, em.n_found)
            return em
        egomotion.get_ego_motion_batched = keep_ego
        self._em = None
        self.ref_block = int(mix.get("ref_block", B))
        self.t = 0
        self.est.reset(self.frames[traffic.ping_pong(0, self.n_frames)])
        self._bad = torch.zeros((), dtype=torch.int64, device=self.dev)
        self._last = None

    def step(self) -> None:
        self.t += 1
        prev = traffic.ping_pong(self.t - 1, self.n_frames)
        cur = traffic.ping_pong(self.t, self.n_frames)
        e2_last = self.est.e2
        out = self.est.next_frames(self.frames[cur])
        self._bad += (~torch.isfinite(out.depth).flatten(1).all(1)).sum()
        if self.dev.type == "cuda":
            torch.cuda.synchronize(self.dev)
        self._last = (prev, cur, out, e2_last, self._em)

    def last(self):
        return self._last

    def failed(self) -> int:
        return int(self._bad)

    def spans(self):
        return self._targets

    def flops(self) -> float:
        """The trunk on both polar frames of every pair and the radial
        matcher's cells (``radial_counts.step_flops``)."""
        return radial_counts.step_flops(self.spec, self.h_win, self.items,
                                        self.h, self.w_polar)

    def release(self) -> None:
        if self._ego is not None:
            self._ego.get_ego_motion_batched = self._ego_fn
            self._ego = None
        self.est = None
        self._last = None
        if self.dev.type == "cuda":
            torch.cuda.empty_cache()

    def _ref_config(self) -> ref.Radial:
        cam, polar = self.cfg["camera"], self.cfg["polar"]
        K = torch.tensor([[cam["fx"], 0.0, cam["cx"]], [0.0, cam["fy"], cam["cy"]],
                          [0.0, 0.0, 1.0]], dtype=torch.float32)
        return ref.Radial(cam["wImg"], cam["hImg"], K, cam["max_points"],
                          cam["points_quality"], cam["bad_image_threshold"],
                          self.h, self.w, self.spec, self.weights,
                          self.h_win, float(polar["k_infty"]))

    @torch.no_grad()
    def check(self, records, control: bool = False) -> dict:
        """Compared numbers over the kept steps, every stream (see the
        module's docstring). With ``control`` the reference in TF32 stands
        in the program's place."""
        cfg = self._ref_config()
        g = compare.Gaps()
        flips = streams = repeated = 0
        for prev, cur, outs, e2_last, em in records:
            for a in range(0, self.items, self.ref_block):
                b = min(self.items, a + self.ref_block)
                last = None if e2_last is None else e2_last[a:b]

                def reference(tf32: bool, theirs=None):
                    return ref.pairs(cfg, self.frames[prev, a:b],
                                     self.frames[cur, a:b], self.noise, last,
                                     theirs, tf32)
                if control:
                    got = reference(True)
                    theirs = tuple(got[k] for k in ("R", "T", "inliers",
                                                    "found"))
                else:
                    got = {k: getattr(outs, k)[a:b] for k in
                           ("flow", "depth", "confs", "e2", "good")}
                    theirs = tuple(v[a:b] for v in em)
                want = reference(False, theirs)
                g.share("rflow_pct", got["flow"] != want["flow"])
                conf = (got["confs"] > 0) | (want["confs"] > 0)
                g.depth("depth_pct", got["depth"][conf], want["depth"][conf])
                g.wide("e2_px", got["e2"], want["e2"])
                g.share("repeat_pct", ~want["distinct"])
                flips += int((got["good"] != want["good"]).sum())
                repeated += int((~want["distinct"]).sum())
                streams += b - a
        self.timer.fold_counts()
        print("the program's counters: " + ", ".join(
            f"{n} {self.timer.COUNTERS[n]}" for n in (
                "radial.pairs", "radial.bad_pairs", "radial.epipole_kept")),
            file=sys.stderr)
        print(f"{streams} streams compared{' (control)' if control else ''}"
              f": {repeated} went on from the judged side's pose (the "
              f"reference's RANSAC winner repeats a point), gate differs on "
              f"{flips}", file=sys.stderr)
        out = g.numbers()
        out["good_diff"] = float(flips)
        return out


def build(cfg: dict, mix: dict, seed: int, devices) -> Program:
    return Program(cfg, mix, seed, devices)
