"""Per-frame streaming API (port of ``depth_estimation_tpu.api``).

``DepthEstimator.next_frame_depth()``: frame in -> (scaled frame, x-flow,
mask) out: undistort -> ego-motion (R, inlier ratio) -> rotation-compensate
the previous frame's feature maps -> match -> decode -> mask erosion by the
matcher footprint -> confidence gate, with branchless bad-frame zeroing.
"""

from __future__ import annotations

from collections import deque
from concurrent.futures import ThreadPoolExecutor
from typing import Optional

import numpy as np
import torch

from . import codecs
from .api_batched import BatchedDepthEstimator, make_batched_pipeline  # noqa: F401
from .api_batched import embed_center
from .data.images import scale as img_scale
from .geometry import Geometry
from .geometry3d import egomotion as ego
from .geometry3d import undistort as undist
from .geometry3d.calibration import Calibration
from .models import flow as flow_model
from .models.filters import ConvFilter
from .models.io import filter_state_from_jax
from .ops import extract, matching
from .utils.device import resolve as resolve_device
from .utils.precision import full_f32
from .utils.timer import Timers


class DepthEstimator:
    """Model trunk plus the previous frame's state, on ``device`` (the card
    by default; raises where there is none unless given ``device="cpu"``).

    ego_resolution: 'working' (default) estimates ego-motion on the
    downscaled, undistorted frame the matcher consumes; 'full' undistorts at
    camera resolution, estimates there, then scales. ``ransac_noise``
    (64, 8, max_points) fixes RANSAC's draw noise (default: a generator
    seeded 1 on every frame)."""

    def __init__(self, geometry: Geometry, params, cal: Calibration,
                 head: str = "mean", sync_timers: bool = False,
                 ego_resolution: str = "working", *, device="cuda",
                 ransac_noise=None):
        geometry.validate()
        if ego_resolution not in ("working", "full"):
            raise ValueError(f"ego_resolution {ego_resolution!r}")
        if head not in ("mean", "max"):
            raise ValueError(f"head {head!r}")
        self.geometry = geometry
        self.cal = cal
        self.head = head
        self.ego_resolution = ego_resolution
        self.device = resolve_device(device)
        self.timers = Timers(sync_device=sync_timers)
        self.ransac_noise = (None if ransac_noise is None else
                             torch.as_tensor(ransac_noise, dtype=torch.float32,
                                             device=self.device))
        Ks = cal.K.copy()
        Ks[0] *= geometry.wImg / cal.wImg
        Ks[1] *= geometry.hImg / cal.hImg
        self.K_scaled = Ks
        self.trunk = ConvFilter(geometry).to(self.device)
        self.trunk.requires_grad_(False)
        self.trunk.load_state_dict(filter_state_from_jax(geometry, params))
        self.last_im = None
        self.last_im_scaled = None
        self.last_filtered = None

    def _frame(self, frame) -> torch.Tensor:
        if isinstance(frame, np.ndarray):
            return torch.tensor(frame, device=self.device)
        return frame.to(self.device)

    @torch.no_grad()
    def _prep(self, frame: torch.Tensor):
        g, cal = self.geometry, self.cal
        if frame.dtype == torch.uint8:
            frame = frame.float() / 255.0
        if self.ego_resolution == "full":
            u = undist.undistort_image(frame, cal.K, cal.distortion)
            small = img_scale(u, g.hImg, g.wImg)
        else:
            if tuple(frame.shape[:2]) != (g.hImg, g.wImg):
                frame = img_scale(frame, g.hImg, g.wImg)
            u = small = undist.undistort_image(frame, self.K_scaled,
                                               cal.distortion)
        return u, small, self.trunk(small)

    @torch.no_grad()
    def _match(self, last_filtered, filtered, R):
        g = self.geometry
        warped = undist.remove_ego_motion(last_filtered, self.K_scaled, R)
        ones = torch.ones(last_filtered.shape[:2] + (1,), device=self.device)
        mask = undist.remove_ego_motion(ones, self.K_scaled, R)[..., 0]
        f1 = flow_model.crop_features_center(g, warped)
        if self.head == "mean":
            idx, ey, ex, pmax, confs = matching.match_flow_fused(
                f1, filtered, g.maxh, g.maxw, 8, False, torch.float32, True,
                0.11)
            y, x = ey, ex
        else:
            idx, ey, ex, pmax = matching.match_flow_fused(
                f1, filtered, g.maxh, g.maxw)
            wy, wx = codecs.decode(g, idx)
            y, x = wy.float(), wx.float()
            confs = torch.ones_like(pmax)
        H, W = y.shape
        full = embed_center(torch.stack([y, x]), g.hImg, g.wImg)
        fullc = embed_center(confs, g.hImg, g.wImg)
        m = mask[g.halfh1:g.halfh1 + H, g.halfw1:g.halfw1 + W]
        m = extract.enlarge_mask(m > 0.5, g.hKernel, g.wKernel)
        return full, embed_center(m.float(), g.hImg, g.wImg) * fullc

    @torch.no_grad()
    def _step(self, last_im, last_filtered, frame):
        cal = self.cal
        u, small, feats = self._prep(frame)
        ego_K = cal.K if self.ego_resolution == "full" else self.K_scaled
        em = ego.get_ego_motion(last_im, u, ego_K,
                                max_points=cal.sfm.max_points,
                                quality=cal.sfm.points_quality,
                                noise=self.ransac_noise)
        ratio = em.n_inliers.float() / torch.clamp(em.n_found.float(), min=1.0)
        good = ratio >= cal.bad_image_threshold
        R = torch.where(good, em.R, torch.eye(3, device=self.device))
        full, mask_d = self._match(last_filtered, feats, R)
        full = torch.where(good, full, torch.zeros_like(full))
        mask_d = torch.where(good, mask_d, torch.zeros_like(mask_d))
        return u, small, feats, full, mask_d, good

    @full_f32()
    def reset(self, first_frame) -> None:
        u, small, feats = self._prep(self._frame(first_frame))
        self.last_im = u
        self.last_im_scaled = small
        self.last_filtered = feats

    def _advance(self, frame):
        if self.last_im is None:
            raise RuntimeError("call reset(first_frame) first")
        out = self._step(self.last_im, self.last_filtered, self._frame(frame))
        self.last_im, self.last_im_scaled, self.last_filtered = out[:3]
        return out

    @full_f32()
    def next_frame_depth(self, frame, fetch: bool = True):
        """Returns (im_scaled (H, W, C), xflow (H, W), mask (H, W)) as numpy
        arrays, or as device tensors with fetch=False."""
        t = self.timers
        t.tic("frame")
        _, small, _, full, mask_d, _ = self._advance(frame)
        t.toc("frame", mask_d)
        if fetch:
            return (small.cpu().numpy(), full[1].cpu().numpy(),
                    mask_d.cpu().numpy())
        return small, full[1], mask_d

    @full_f32()
    def next_frame_packed(self, frame) -> torch.Tensor:
        """One device output per frame: (2, hImg, wImg) float16
        [xflow, mask * confidences]."""
        _, _, _, full, mask_d, _ = self._advance(frame)
        return torch.stack([full[1], mask_d]).half()

    def stream(self, lag: int = 3, fetch_threads: int = 4) -> "PipelinedStream":
        """A PipelinedStream keeping ``lag`` frames in flight."""
        return PipelinedStream(self, lag=lag, fetch_threads=fetch_threads)


def _fetch(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


class PipelinedStream:
    """``lag`` frames in flight over DepthEstimator.next_frame_packed; the
    device-to-host copies run on worker threads, so dispatching frame N+1
    never waits for frame N's fetch. Results come out in frame order, ``lag``
    frames behind the pushes:

        with est.stream(lag=3) as stream:
            for frame in frames:
                out = stream.push(frame)   # (2, H, W) float16 array or None
            for out in stream.drain():     # the last ``lag`` results
                ...
    """

    def __init__(self, est: DepthEstimator, lag: int = 3,
                 fetch_threads: int = 4):
        if lag < 1:
            raise ValueError("lag must be >= 1")
        self.est = est
        self.lag = lag
        self._pend = deque()
        self._pool = ThreadPoolExecutor(fetch_threads)

    def push(self, frame) -> Optional[np.ndarray]:
        """Dispatch one frame; return the result of frame (current - lag),
        or None while the pipeline fills."""
        packed = self.est.next_frame_packed(frame)
        self._pend.append(self._pool.submit(_fetch, packed))
        if len(self._pend) > self.lag:
            return self._pend.popleft().result()
        return None

    def drain(self):
        """Yield the in-flight results (call after the last push)."""
        while self._pend:
            yield self._pend.popleft().result()

    def close(self):
        for _ in self.drain():
            pass
        self._pool.shutdown(wait=True)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()
