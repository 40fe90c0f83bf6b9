"""Batched online pipeline: B independent streams advanced one frame per
step (port of ``depth_estimation_tpu.api_batched``).

Per step: uint8 frames -> resize to the working resolution -> undistort ->
conv trunk (once per frame) -> ego-motion against the previous frame
(Shi-Tomasi + windowed LK + essential RANSAC) -> bad-frame gate ->
rotation compensation of the previous feature maps -> fused match (kernel
B1 on CUDA) -> warp-mask erosion -> confidence gate -> x-flow to depth.

Compensation modes, as in the reference:
  * 'warp' — warp the previous features by K R K^-1 with unconditional
    4-tap semantics: the banded warp (kernel B3 on CUDA) when every in-frame
    displacement is within ``warp_band``, the gather otherwise, chosen by
    ``torch.cond`` as the reference chooses with ``lax.cond`` (so that
    ``torch.export`` keeps both branches; run eagerly, the choice still
    reads the predicate on the host once a step);
  * 'warp_banded' — the banded warp unconditionally, band-masked;
  * 'decode' — match the unwarped features and add the analytic rotation
    flow back to the decoded flow.
"""

from __future__ import annotations

import copy

import numpy as np
import torch

from . import codecs
from .data import images
from .geometry import Geometry
from .geometry3d import egomotion as ego
from .geometry3d import undistort as undist
from .geometry3d.calibration import Calibration
from .models import flow as flow_model
from .models.filters import ConvFilter
from .models.flow import embed_center
from .models.io import filter_state_from_jax
from .models.multiscale import avg_downsample
from .ops import extract, matching
from .utils.device import resolve as resolve_device
from .utils.precision import full_f32


def depth_from_xflow(xflow: torch.Tensor, w_img: int) -> torch.Tensor:
    """Depth from x-flow at unit translation: |x - cx| / max(|flow|, 0.1),
    infinite where |flow| < 0.1."""
    cx = w_img / 2.0
    j = torch.arange(w_img, dtype=torch.float32, device=xflow.device)[None, None, :]
    absflow = torch.abs(xflow)
    return torch.where(absflow < 0.1, torch.full_like(absflow, float("inf")),
                       torch.abs(j - cx) / torch.clamp(absflow, min=0.1))


class BatchedDepthEstimator:
    """B independent frame streams; state (previous undistorted frames and
    feature maps) stays on ``device`` between steps (the card by default;
    raises where there is none unless given ``device="cpu"``).

    ``params`` is the trunk's flax-layout tree of numpy arrays (as
    ``models.io.load_model`` returns it; may be None and set later with
    ``load_params``). The knobs are the reference's: ``match_dtype`` /
    ``warp_dtype`` / ``state_dtype`` storage types (torch dtypes),
    ``ego_downsample``, ``lk_iters``, ``ransac_samples``, ``warp_band``,
    ``corner_selector``, ``lk_search``. ``match_block="auto"`` measures
    kernel B1's launch plans (``ops/autotune.best_plan``) on the live card
    once per feature shape, storage type and card, during ``reset()`` (or
    a pipeline's first call) and before any shard's thread starts, and
    persists the winner, so that later processes start tuned; every plan
    gives the same outputs. An integer ``match_block`` (the reference's
    Pallas row blocking) is accepted for signature parity and leaves B1 on
    its rule's plan (``ops/matching.fused_plan``). On the CPU the plain
    twin runs and "auto" times nothing.
    ``ransac_noise`` (ransac_samples, 8, n_corners) fixes RANSAC's draw
    noise; by default it comes from a generator seeded 1 on every step, as
    the reference uses one fixed key.
    """

    def __init__(self, geometry: Geometry, params, cal: Calibration,
                 head: str = "mean", match_dtype=torch.float32,
                 warp_dtype=None, ego_downsample: int = 1,
                 compensation: str = "warp", lk_iters: int = 10,
                 ransac_samples: int = 64, state_dtype=None,
                 match_block=8, warp_band: int = 8,
                 corner_selector: str = "topk", lk_search: int = 32,
                 *, device="cuda", ransac_noise=None):
        geometry.validate()
        if head not in ("mean", "max"):
            raise ValueError(f"head {head!r}")
        if compensation not in ("warp", "warp_banded", "decode"):
            raise ValueError(f"compensation {compensation!r}")
        if corner_selector not in ("topk", "grid"):
            raise ValueError(f"corner_selector {corner_selector!r}")
        if ego_downsample not in (1, 2, 4):
            raise ValueError(f"ego_downsample {ego_downsample}")
        if match_block != "auto" and int(match_block) <= 0:
            raise ValueError(f"match_block {match_block}")
        self.geometry = geometry
        self.cal = cal
        self.head = head
        self.compensation = compensation
        self.match_block = (match_block if match_block == "auto"
                            else int(match_block))
        # B1's resolved plans by (device, f1 shape, f2 shape), shared with
        # the replicas of a mesh; empty unless match_block is "auto"
        self._plans = {}
        self.match_dtype = match_dtype
        self.warp_dtype = warp_dtype
        self.state_dtype = state_dtype
        self.ego_downsample = ego_downsample
        self.lk_iters = lk_iters
        self.ransac_samples = ransac_samples
        self.warp_band = warp_band
        self.corner_selector = corner_selector
        self.lk_search = lk_search
        self.device = resolve_device(device)
        self.ransac_noise = (None if ransac_noise is None else
                             torch.as_tensor(ransac_noise, dtype=torch.float32,
                                             device=self.device))
        g = geometry
        Ks = cal.K.copy()
        Ks[0] *= g.wImg / cal.wImg
        Ks[1] *= g.hImg / cal.hImg
        self.K_scaled = Ks
        self.trunk = ConvFilter(geometry).to(self.device)
        self.trunk.requires_grad_(False)
        if params is not None:
            self.load_params(params)
        self.last_u = None
        self.last_feats = None
        self._mesh = None

    def load_params(self, params) -> None:
        """Load the trunk from a flax-layout parameter tree (numpy)."""
        self.trunk.load_state_dict(filter_state_from_jax(self.geometry, params))

    def _frames(self, frames) -> torch.Tensor:
        if self._mesh is not None:
            # left where it is: the mesh sends each shard to its card
            return frames if isinstance(frames, torch.Tensor) \
                else torch.as_tensor(frames)
        if isinstance(frames, np.ndarray):
            return torch.tensor(frames, device=self.device)
        return frames.to(self.device)

    def replica(self, device, trunk: ConvFilter) -> "BatchedDepthEstimator":
        """A copy of this estimator on ``device`` with ``trunk`` (a replica
        of the trunk there) and every setting shared: one shard's program
        of a mesh (``parallel.mesh``)."""
        r = copy.copy(self)
        r.device = torch.device(device)
        r.trunk = trunk
        r.ransac_noise = (None if self.ransac_noise is None
                          else self.ransac_noise.to(r.device))
        r._mesh = None
        r.last_u = r.last_feats = None
        r.__dict__.pop("_prep", None)
        r.__dict__.pop("_step", None)
        return r

    def shard(self, mesh, axis: str = "dp") -> "BatchedDepthEstimator":
        """Split the stream batch across a device mesh
        (``parallel.mesh.Mesh``): every stage of the per-frame program is
        per stream, so the step is pure data parallelism. Each shard runs
        this program at its local batch on its own card, with a replica of
        the trunk (kernel B1, and B3 in the 'warp' modes, launched on every
        card), and the stream state stays sharded on the cards between
        steps. Returns self; ``reset`` and ``next_frames`` keep their API
        (``next_frames`` gathers its outputs on ``device``). The batch must
        divide by the mesh size."""
        from .parallel import mesh as pmesh
        self._prep = pmesh.sharded_pipeline_prep(self, mesh, axis)
        self._step = pmesh.sharded_pipeline_step(self, mesh, axis)
        self._mesh = mesh
        return self

    @torch.no_grad()
    def _prep(self, frames: torch.Tensor):
        """Normalize, resize, undistort and filter a batch of frames."""
        g = self.geometry
        if frames.dtype == torch.uint8:
            frames = frames.float() / 255.0
        frames = images.scale_batched_device(frames, g.hImg, g.wImg)
        u = undist.undistort_image(frames, self.K_scaled, self.cal.distortion)
        feats = self.trunk(u)
        if self.state_dtype is not None:
            u = u.to(self.state_dtype)
            feats = feats.to(self.state_dtype)
        return u, feats

    @torch.no_grad()
    def _step(self, last_u, last_feats, frames):
        g, cal = self.geometry, self.cal
        Ks = self.K_scaled
        B = frames.shape[0]
        u, feats = self._prep(frames)
        r = self.ego_downsample
        if r > 1:
            e1, e2 = avg_downsample(last_u, r), avg_downsample(u, r)
            K_ego = Ks.copy()
            K_ego[:2] /= r
        else:
            e1, e2, K_ego = last_u, u, Ks
        em = ego.get_ego_motion_batched(
            e1, e2, K_ego, max_points=cal.sfm.max_points,
            quality=cal.sfm.points_quality, noise=self.ransac_noise,
            lk_iters=self.lk_iters, n_samples=self.ransac_samples,
            selector=self.corner_selector, lk_search=self.lk_search)
        ratio = em.n_inliers.float() / torch.clamp(em.n_found.float(), min=1.0)
        good = ratio >= cal.bad_image_threshold
        eye = torch.eye(3, device=self.device).expand(B, 3, 3)
        R = torch.where(good[:, None, None], em.R, eye)

        Hf, Wf = last_feats.shape[1], last_feats.shape[2]
        band = self.warp_band
        if self.compensation == "warp":
            warped = undist.remove_ego_motion_exact(
                last_feats, Ks, R, band=band, dtype=self.warp_dtype)
            wmask = undist.ego_motion_valid_mask(Ks, R, Hf, Wf)
            f1 = flow_model.crop_features_center(g, warped)
        elif self.compensation == "warp_banded":
            warped = undist.remove_ego_motion_banded(
                last_feats, Ks, R, band=band, dtype=self.warp_dtype)
            wmask = undist.ego_motion_valid_mask(Ks, R, Hf, Wf, band=band)
            f1 = flow_model.crop_features_center(g, warped)
        else:
            dxs, dys = undist.homography_grid(Ks, R, Hf, Wf)
            jgrid = torch.arange(Wf, dtype=torch.float32, device=self.device)[None, None, :]
            igrid = torch.arange(Hf, dtype=torch.float32, device=self.device)[None, :, None]
            rot_x = dxs - jgrid
            rot_y = dys - igrid
            # valid where the displaced correspondence stays inside the
            # centered search window (margin 1 for the soft tail)
            margin_y = min(g.halfh1, g.halfh2) - 1
            margin_x = min(g.halfw1, g.halfw2) - 1
            wmask = ((torch.abs(rot_y) <= margin_y)
                     & (torch.abs(rot_x) <= margin_x)).float()
            f1 = flow_model.crop_features_center(g, last_feats)
        plan = self._plans.get(self._plan_key(f1, feats))
        if self.head == "mean":
            idx, ey, ex, pmax, confs = matching.match_flow_fused(
                f1, feats, g.maxh, g.maxw, 8, False, self.match_dtype, True,
                0.11, plan)
            y, x = ey, ex
        else:
            idx, ey, ex, pmax = matching.match_flow_fused(
                f1, feats, g.maxh, g.maxw, 8, False, self.match_dtype,
                plan=plan)
            wy, wx = codecs.decode(g, idx)
            y, x = wy.float(), wx.float()
            confs = torch.ones_like(pmax)

        H, W = y.shape[1:]
        if self.compensation == "decode":
            # pure rotation makes the raw match read -delta, so the physical
            # flow is d + delta
            x = x + rot_x[:, g.halfh1:g.halfh1 + H, g.halfw1:g.halfw1 + W]
        xflow = embed_center(x, g.hImg, g.wImg)
        fullc = embed_center(confs, g.hImg, g.wImg)
        m = wmask[:, g.halfh1:g.halfh1 + H, g.halfw1:g.halfw1 + W]
        m = extract.enlarge_mask_batched(m > 0.5, g.hKernel, g.wKernel)
        mask = embed_center(m.float(), g.hImg, g.wImg) * fullc

        keep = good[:, None, None]
        xflow = torch.where(keep, xflow, torch.zeros_like(xflow))
        mask = torch.where(keep, mask, torch.zeros_like(mask))
        return u, feats, xflow, mask, depth_from_xflow(xflow, g.wImg), good

    def _plan_key(self, f1, feats) -> tuple:
        return (str(f1.device), tuple(f1.shape), tuple(feats.shape))

    def _resolve_plans(self, feats) -> None:
        """For match_block "auto": B1's fastest plan at each shard's (or
        the whole batch's) feature shapes, measured on its device in the
        calling thread (``ops/autotune.best_plan``, persisted)."""
        if self.match_block != "auto":
            return
        from .ops import autotune
        g = self.geometry
        for f in (feats if self._mesh is not None else (feats,)):
            f1 = flow_model.crop_features_center(g, f)
            key = self._plan_key(f1, f)
            if key not in self._plans:
                self._plans[key] = autotune.best_plan(
                    "fused", tuple(f1.shape), tuple(f.shape), g.maxh, g.maxw,
                    dtype=self.match_dtype, want_conf=self.head == "mean",
                    device=f.device)

    @full_f32()
    def reset(self, first_frames) -> None:
        self.last_u, self.last_feats = self._prep(self._frames(first_frames))
        self._resolve_plans(self.last_feats)

    @full_f32()
    def next_frames(self, frames):
        """Advance every stream by one frame. Returns (xflow, mask, depth,
        good) on the device: (B, hImg, wImg) f32 x3 and (B,) bool."""
        if self.last_u is None:
            raise RuntimeError("call reset(first_frames) first")
        u, feats, *outs = self._step(self.last_u, self.last_feats,
                                     self._frames(frames))
        self.last_u = u
        self.last_feats = feats
        if self._mesh is not None:
            outs = [o.gather(self.device) for o in outs]
        xflow, mask, depth, good = outs
        return xflow, mask, depth, good


def make_batched_pipeline(geometry: Geometry, cal: Calibration,
                          head: str = "mean", match_dtype=torch.float32,
                          **knobs):
    """Independent-pairs form: ``fn(params, frames1, frames2) -> (xflow,
    mask, depth, good)`` that preps both frames of every pair. ``knobs``
    pass through to BatchedDepthEstimator (``device`` included)."""
    est = BatchedDepthEstimator(geometry, None, cal, head=head,
                                match_dtype=match_dtype, **knobs)
    loaded = []

    @full_f32()
    def pipeline(params, frames1, frames2):
        if not loaded or loaded[0] is not params:
            est.load_params(params)
            loaded[:] = [params]
        last_u, last_feats = est._prep(est._frames(frames1))
        est._resolve_plans(last_feats)      # "auto": once a shape
        return est._step(last_u, last_feats, est._frames(frames2))[2:]

    return pipeline
