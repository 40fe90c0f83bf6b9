"""Batched radial (polar) depth: B independent frame streams advanced one
frame per step, the radial tester's per-frame chain (port of
``depth_estimation_tpu.cli.test_radial``'s loop) on the card with no host
read inside a step.

Per step, for each stream's (previous, current) pair:
  1. ego-motion at the calibration's size: Shi-Tomasi corners, full-image
     pyramidal LK, essential RANSAC with one Gumbel draw shared by every
     stream (``data/datasets.polar_ego``);
  2. the epipole K T / T_z at the working width;
  3. its EMA, alpha 0.5, against the stream's last smoothed epipole (an
     epipole out of frame keeps the last one), and the bad-frame gate on
     RANSAC's inlier ratio;
  4-5. both frames rescaled to the working size, the previous one's
     rotation removed, the C2P grid about the raw epipole and the polar
     warps of the current frame, the warped previous frame and the mask
     (``datasets.polar_warps``);
  6. ``RadialFlowNetwork.flow_batch``: the trunk on both polar frames, the
     radial SSD and its WTA;
  7. the P2C grid about the smoothed epipole, scaled by the net's output
     factor k_out, and the flow warped back to cartesian;
  8. ``flow2depth``.
A pair the gate rejects gives zero flow, depth and confidences.

As in the JAX package's tester, the C2P grid is centred on the raw
epipole and the P2C grid on the smoothed one; the Lua tester smooths
before both (ROADMAP C36).

Spans (``utils/timer.SPANS``): ``radial.ego`` (steps 1-3), ``radial.polar``
(4-5), ``radial.net`` (6, opened by ``flow_batch``), ``radial.depth``
(7-8). Counters: ``radial.pairs``, ``radial.bad_pairs``,
``radial.epipole_kept`` (the card's counts through
``timer.count_on_device``).
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from .data import datasets
from .geometry3d import egomotion as ego
from .geometry3d import polar as polar_ops
from .geometry3d.calibration import Calibration
from .models.radial import RadialFlowNetwork
from .utils.device import resolve as resolve_device
from .utils.precision import full_f32
from .utils.timer import count, count_on_device, profiled_span

EMA_ALPHA = 0.5
RANSAC_SAMPLES = 64


class RadialStep(NamedTuple):
    flow: torch.Tensor    # (B, H', W') int32 radial WTA flow, polar rows
    depth: torch.Tensor   # (B, h_out, w_out) depth / infinity
    confs: torch.Tensor   # (B, h_out, w_out) confidences
    e2: torch.Tensor      # (B, 2) smoothed epipoles (x, y), working size
    good: torch.Tensor    # (B,) bool: the bad-frame gate passed


class BatchedRadialEstimator:
    """B frame streams through the radial net ``net`` on ``cal``'s frames:
    a working (and polar) size ``h_input`` x ``w_input``, depth scaled by
    ``k_infty``. The state (each stream's previous frame and smoothed
    epipole) stays on ``device`` (the card by default; raises where there
    is none unless given ``device="cpu"``), where ``net`` must be.
    ``ransac_noise`` (64, 8, max_points) fixes RANSAC's draws (default
    ``egomotion.gumbel_noise``, seed 1, as the tester's loader)."""

    def __init__(self, net: RadialFlowNetwork, cal: Calibration,
                 h_input: int = 200, w_input: int = 200,
                 k_infty: float = 1.0, *, device="cuda",
                 ransac_noise: Optional[torch.Tensor] = None):
        self.net = net
        self.cal = cal
        self.h_input, self.w_input = h_input, w_input
        self.k_infty = k_infty
        self.device = resolve_device(device)
        # constants on the device, so that a step copies nothing from the host
        self.K = torch.as_tensor(cal.K, dtype=torch.float32, device=self.device)
        self._255 = torch.tensor(255.0, device=self.device)
        self.noise = (ego.gumbel_noise(RANSAC_SAMPLES, cal.sfm.max_points,
                                       self.device)
                      if ransac_noise is None else
                      torch.as_tensor(ransac_noise, dtype=torch.float32,
                                      device=self.device))
        self.k_out = polar_ops.get_k_output(h_input, net.h_kernel, net.h_win)
        self.h_out = int(h_input * self.k_out)
        self.w_out = int(w_input * self.k_out)
        self._prev: Optional[torch.Tensor] = None
        self.e2: Optional[torch.Tensor] = None   # (B, 2) smoothed epipoles

    def _frames(self, frames) -> torch.Tensor:
        """(B, H, W, 3) frames at the calibration's size on the device:
        uint8 scaled to [0, 1], float taken as in [0, 1]."""
        x = torch.as_tensor(frames, device=self.device)
        if tuple(x.shape[1:3]) != (self.cal.hImg, self.cal.wImg):
            raise ValueError(f"frames {tuple(x.shape)} are not the "
                             f"calibration's {self.cal.hImg}x{self.cal.wImg}")
        if x.dtype == torch.uint8:
            return x.float() / self._255
        return x.float()

    def reset(self, frames) -> None:
        """Start every stream at ``frames`` (B, H, W, 3), with no smoothed
        epipole yet."""
        self._prev = self._frames(frames)
        self.e2 = None

    @full_f32()
    @torch.no_grad()
    def next_frames(self, frames) -> RadialStep:
        """Advance every stream by ``frames`` (B, H, W, 3), uint8 or float
        in [0, 1], at the calibration's size; the outputs stay on the
        device (see ``RadialStep``)."""
        if self._prev is None:
            raise RuntimeError("reset() first")
        cal, h, w = self.cal, self.h_input, self.w_input
        cur = self._frames(frames)
        with profiled_span("radial.ego"):
            em, e2 = datasets.polar_ego(
                self._prev, cur, self.K, cal.wImg, w, cal.sfm.max_points,
                cal.sfm.points_quality, self.noise)
            ratio = em.n_inliers.double() / em.n_found.double().clamp(min=1)
            good = ratio >= cal.bad_image_threshold
            e2s, kept = polar_ops.smooth_epipole_batched(self.e2, e2, h, w,
                                                         EMA_ALPHA)
        with profiled_span("radial.polar"):
            p_img, p_prev, _, _, _, _ = datasets.polar_warps(
                self._prev, cur, self.K, em.R, e2, cal.wImg, cal.hImg, h, w,
                h, w, self.net.w_kernel)
        flow, _ = self.net.flow_batch(p_prev, p_img)
        with profiled_span("radial.depth"):
            # the centre and rmax in float64, as the per-pair tester's
            # Python floats
            c = e2s.double() * self.k_out
            rmax = polar_ops.get_rmax_batched(h, w, e2s.double()) * self.k_out
            p2c = polar_ops.get_p2c_grid_batched(
                flow.shape[2], flow.shape[1], self.w_out, self.h_out,
                c[:, 0].float(), c[:, 1].float(), rmax)
            cart = polar_ops.warp_grid_batched(flow.float()[..., None],
                                               p2c)[..., 0]
            infty = polar_ops.get_rmax_batched(self.h_out, self.w_out, c)
            depth, confs = polar_ops.flow2depth_batched(
                cart, c.float(), (infty * self.k_infty).float())
            keep = good[:, None, None]
            out = RadialStep(torch.where(keep, flow, torch.zeros_like(flow)),
                             torch.where(keep, depth, torch.zeros_like(depth)),
                             torch.where(keep, confs, torch.zeros_like(confs)),
                             e2s, good)
        count("radial.pairs", cur.shape[0])
        count_on_device(("radial.bad_pairs", "radial.epipole_kept"),
                        torch.stack([(~good).sum(), kept.sum()]))
        self._prev, self.e2 = cur, e2s
        return out
