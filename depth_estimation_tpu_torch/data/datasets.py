"""Frame-sequence datasets for the flow trainer (port of the flow part of
``depth_estimation_tpu.data.datasets``; the radial/polar pipeline is not
ported yet).

  * ``load_rectified_pair``: undistort -> ego-motion (full-image LK,
    essential RANSAC) -> bad-frame gate on the inlier ratio -> rotation
    compensation of the previous frame -> GT flow on (warped previous,
    current), quantized ``floor(flow + 0.5)``. GT: 'cross-correlation'
    (exhaustive WTA), 'cc-mean' (exhaustive soft-argmax) or 'liu' (the
    variational solver, kernel B4 on the card).
  * ``load_mc_pair``: the 4-DoF (pan, tilt, zoom, roll) motion correction
    (corners, LK, ``lsq_trans_ransac``, nearest-neighbour warp);
    ``load_plain_pair``: no rectification.
  * ``load_rectified_pairs_batched``: the 'sfm' stack for all consecutive
    pairs at once, as batched torch ops on the device;
    ``load_data_optical_flow`` assembles a dataset from ``directory/images/``;
    ``FlowDataset`` is the lazy per-frame form.

Every entry point runs on ``device``: the card unless the caller passes
``device="cpu"``; pairs come back as numpy arrays. RANSAC's draws are
arguments: ``noise`` (n_samples, 8, max_points) Gumbel noise for the
essential fit (default: ``egomotion.gumbel_noise``, seed 1) and
``sample_idx`` (n_samples, 5) for the 4-DoF fit (default: seed 0). The
reference's ``mesh`` (sharding over TPU chips) is dropped.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry import Geometry
from ..geometry3d import egomotion as ego
from ..geometry3d import undistort as undist
from ..geometry3d.calibration import Calibration
from ..utils.device import as_f32, host, resolve
from . import groundtruth as gt_mod
from .images import ImageLoader, load_image, scale, scale_batched_device, scale_np


@dataclasses.dataclass
class RectifiedPair:
    prev_warped: np.ndarray      # rotation-compensated previous frame
    image: np.ndarray            # current frame
    mask: np.ndarray             # warp validity
    flow: Optional[np.ndarray]   # (2, H, W) quantized GT flow
    conf: Optional[np.ndarray]
    good: bool                   # inlier-ratio gate


def _quantize(fy, fx) -> np.ndarray:
    """The reference's GT quantization, floor(flow + 0.5)."""
    return np.floor(np.stack([fy, fx]) + 0.5).astype(np.float32)


def _bad_pair(geom: Geometry, prev_s, img_s) -> RectifiedPair:
    z = np.zeros((geom.hImg, geom.wImg), np.float32)
    return RectifiedPair(host(prev_s), host(img_s), z, None, None, False)


def load_rectified_pair(
    geom: Geometry, cal: Calibration, prev: np.ndarray, img: np.ndarray,
    cache_root: Optional[str] = None, name: str = "",
    compute_gt: bool = True, groundtruth: str = "cross-correlation",
    noise=None, device="cuda",
) -> RectifiedPair:
    """SFM-rectified pair of full-size frames (H, W, C)."""
    dev = resolve(device)
    prev_u = undist.undistort_image(as_f32(prev, dev), cal.K, cal.distortion)
    img_u = undist.undistort_image(as_f32(img, dev), cal.K, cal.distortion)
    if noise is not None:
        noise = as_f32(noise, dev)
    em = ego.get_ego_motion(prev_u, img_u, cal.K,
                            max_points=cal.sfm.max_points,
                            quality=cal.sfm.points_quality, noise=noise,
                            tracker="full")
    ratio = float(em.n_inliers) / max(float(em.n_found), 1.0)
    h, w = geom.hImg, geom.wImg
    prev_s = scale(prev_u, h, w)
    img_s = scale(img_u, h, w)
    if ratio < cal.bad_image_threshold:
        return _bad_pair(geom, prev_s, img_s)
    Ks = cal.K.copy()
    Ks[0] *= w / cal.wImg
    Ks[1] *= h / cal.hImg
    warped = undist.remove_ego_motion(prev_s, Ks, em.R)
    ones = torch.ones((h, w, 1), device=dev)
    mask = (undist.remove_ego_motion(ones, Ks, em.R)[..., 0] > 0.5).float()
    flow = conf = None
    if compute_gt:
        fy, fx, conf = _compute_gt(geom, warped, img_s, cache_root, name,
                                   groundtruth, dev)
        flow = _quantize(fy, fx)
    return RectifiedPair(host(warped), host(img_s), host(mask), flow, conf, True)


def _compute_gt(geom, warped, img_s, cache_root, name, groundtruth, device):
    """GT dispatch: 'liu' (variational solver), else exhaustive matching
    with WTA ('cross-correlation') or soft-argmax ('cc-mean')."""
    if groundtruth == "liu":
        if cache_root is not None and name:
            fy, fx = gt_mod.cached_liu_flow(cache_root, geom, 1, name,
                                            host(warped), host(img_s),
                                            device=device)
        else:
            fy, fx = gt_mod.liu_flow(warped, img_s, device=device)
        return fy, fx, None
    method = "mean" if groundtruth == "cc-mean" else "max"
    if cache_root is not None and name:
        return gt_mod.cached_exhaustive_flow(cache_root, geom, 1, name,
                                             warped, img_s, method, device)
    return gt_mod.exhaustive_flow(geom, warped, img_s, method, device)


def load_mc_pair(
    geom: Geometry, cal: Calibration, prev: np.ndarray, img: np.ndarray,
    cache_root: Optional[str] = None, name: str = "",
    compute_gt: bool = True, n_track_points: int = 200,
    sample_idx=None, device="cuda",
) -> RectifiedPair:
    """4-DoF motion-corrected pair: features on the previous frame tracked
    to the current one; the fitted model's warp (current coords ->
    previous coords) rectifies the previous frame, so the pair has the
    'sfm' backend's orientation."""
    dev = resolve(device)
    h, w = geom.hImg, geom.wImg
    prev_s = scale(as_f32(prev, dev), h, w)
    img_s = scale(as_f32(img, dev), h, w)
    pts, pvalid = ego.good_features_to_track(prev_s, n_track_points,
                                             cal.sfm.points_quality)
    pts_cur, status = ego.track_lk(prev_s, img_s, pts)
    valid = host(pvalid & status)
    n_valid = int(valid.sum())
    if n_valid < 8:
        return _bad_pair(geom, prev_s, img_s)
    # static shapes: valid points repeated into the invalid slots
    sel = np.where(valid)[0]
    fill = sel[np.arange(n_track_points) % n_valid]
    idx = torch.as_tensor(np.where(valid, np.arange(n_track_points), fill),
                          device=dev)
    H, inliers = ego.lsq_trans_ransac(pts[idx], pts_cur[idx], w / 2, h / 2,
                                      sample_idx=sample_idx)
    if float(inliers) / n_track_points < cal.bad_image_threshold:
        return _bad_pair(geom, prev_s, img_s)
    warped = ego.warp_affine(prev_s, H)
    mask = (ego.warp_affine(torch.ones((h, w), device=dev), H) > 0.5).float()
    flow = conf = None
    if compute_gt:
        if cache_root is not None and name:
            fy, fx, conf = gt_mod.cached_exhaustive_flow(
                cache_root, geom, 1, name + "_mc", warped, img_s, device=dev)
        else:
            fy, fx, conf = gt_mod.exhaustive_flow(geom, warped, img_s,
                                                  device=dev)
        flow = _quantize(fy, fx)
    return RectifiedPair(host(warped), host(img_s), host(mask), flow, conf, True)


def load_plain_pair(
    geom: Geometry, cal: Calibration, prev: np.ndarray, img: np.ndarray,
    cache_root: Optional[str] = None, name: str = "",
    compute_gt: bool = True, device="cuda",
) -> RectifiedPair:
    """No rectification: the consecutive frames resized on the host."""
    dev = resolve(device)
    h, w = geom.hImg, geom.wImg
    prev_s = scale_np(np.asarray(prev), h, w)
    img_s = scale_np(np.asarray(img), h, w)
    mask = np.ones((h, w), np.float32)
    flow = conf = None
    if compute_gt:
        if cache_root is not None and name:
            fy, fx, conf = gt_mod.cached_exhaustive_flow(
                cache_root, geom, 1, name + "_raw", prev_s, img_s, device=dev)
        else:
            fy, fx, conf = gt_mod.exhaustive_flow(geom, prev_s, img_s,
                                                  device=dev)
        flow = _quantize(fy, fx)
    return RectifiedPair(prev_s, img_s, mask, flow, conf, True)


_PAIR_LOADERS = {"sfm": load_rectified_pair, "mc": load_mc_pair,
                 None: load_plain_pair}


# ---------------------------------------------------------------------------
# batched rectification: the 'sfm' stack for a whole stack of pairs
# ---------------------------------------------------------------------------

@torch.no_grad()
def rectify_batch(prevs: torch.Tensor, imgs: torch.Tensor, K, dist,
                  h: int, w: int, max_points: int, quality: float,
                  noise: torch.Tensor):
    """Undistort -> ego-motion (corners, full-image LK, essential RANSAC
    with ``noise`` shared by every item) -> resize -> rotation warp for
    (B, H, W, C) frame pairs on their device. Returns (prev_s, img_s,
    warped, mask, n_inliers, n_found) as tensors."""
    K = as_f32(K, prevs.device)
    Ks = K.clone()
    Ks[0] = Ks[0] * (w / prevs.shape[2])
    Ks[1] = Ks[1] * (h / prevs.shape[1])
    prev_u = undist.undistort_image(prevs, K, dist)
    img_u = undist.undistort_image(imgs, K, dist)
    pts, pvalid = ego.good_features_to_track_batched(prev_u, max_points,
                                                     quality)
    pts2, status = ego.track_lk_batched(prev_u, img_u, pts)
    em = ego.get_ego_motion_from_matches_batched(pts, pts2, pvalid & status,
                                                 K, noise)
    prev_s = scale_batched_device(prev_u, h, w)
    img_s = scale_batched_device(img_u, h, w)
    warped = undist.remove_ego_motion_batched(prev_s, Ks, em.R)
    ones = torch.ones((prevs.shape[0], h, w, 1), device=prevs.device)
    mask = (undist.remove_ego_motion_batched(ones, Ks, em.R)[..., 0]
            > 0.5).float()
    return prev_s, img_s, warped, mask, em.n_inliers, em.n_found


def load_rectified_pairs_batched(
    geom: Geometry, cal: Calibration, frames: List[np.ndarray],
    cache_root: Optional[str] = None, names: Optional[List[str]] = None,
    compute_gt: bool = True, delta: int = 1,
    groundtruth: str = "cross-correlation", noise=None, device="cuda",
) -> List[RectifiedPair]:
    """The 'sfm' loader over the consecutive pairs (frames[k],
    frames[k + delta]) in one batched pass (``rectify_batch``), then the
    GT: disk-cache hits read, the exhaustive misses in batched chunks, the
    liu solves a pair at a time."""
    dev = resolve(device)
    prevs = as_f32(np.stack(frames[:-delta]), dev)
    imgs = as_f32(np.stack(frames[delta:]), dev)
    if noise is None:
        noise = ego.gumbel_noise(64, cal.sfm.max_points, dev)
    outs = rectify_batch(prevs, imgs, cal.K, tuple(cal.distortion),
                         geom.hImg, geom.wImg, cal.sfm.max_points,
                         cal.sfm.points_quality, as_f32(noise, dev))
    prev_s, img_s, warped, mask, n_inl, n_fnd = (host(o) for o in outs)
    B = prev_s.shape[0]
    good = [float(n_inl[k]) / max(float(n_fnd[k]), 1.0)
            >= cal.bad_image_threshold for k in range(B)]

    gts: Dict[int, Tuple] = {}
    if compute_gt and groundtruth == "liu":
        for k in range(B):
            if good[k]:
                name = names[k] if names else ""
                gts[k] = _compute_gt(geom, warped[k], img_s[k], cache_root,
                                     name, "liu", dev)
    elif compute_gt:
        method = "mean" if groundtruth == "cc-mean" else "max"
        misses = []
        for k in range(B):
            if not good[k]:
                continue
            name = names[k] if names else ""
            if cache_root is not None and name:
                hit = gt_mod.load_cached_flow(cache_root, geom, 1, name, method)
                if hit is not None:
                    gts[k] = hit
                    continue
            misses.append(k)
        if misses:
            fy, fx, conf = gt_mod.exhaustive_flow_batched(
                geom, warped[misses], img_s[misses], method=method, device=dev)
            for j, k in enumerate(misses):
                gts[k] = (fy[j], fx[j], conf[j])
                name = names[k] if names else ""
                if cache_root is not None and name:
                    gt_mod.store_cached_flow(cache_root, geom, 1, name,
                                             fy[j], fx[j], conf[j], method)

    out = []
    for k in range(B):
        if not good[k]:
            out.append(_bad_pair(geom, prev_s[k], img_s[k]))
            continue
        flow = conf = None
        if compute_gt:
            fy, fx, conf = gts[k]
            flow = _quantize(fy, fx)
        out.append(RectifiedPair(warped[k], img_s[k], mask[k], flow, conf,
                                 True))
    return out


def load_data_optical_flow(
    geom: Geometry, cal: Calibration, directory: str, n_images: int,
    first: int = 0, delta: int = 1, cache_root: Optional[str] = None,
    motion_correction: Optional[str] = "sfm",
    groundtruth: str = "cross-correlation", noise=None, sample_idx=None,
    device="cuda",
) -> Dict[str, list]:
    """Dataset assembly: up to ``n_images`` consecutive (``delta``-strided)
    frames from ``directory/images/``, rectified by ``motion_correction``
    ('sfm' batched, with ``noise``; 'mc' per pair, with ``sample_idx``; or
    None), with GT flow per pair ('sfm' takes ``groundtruth``, the others
    the exhaustive WTA GT). Returns
    lists 'images' (currents, plus a trailing frame), 'warped_images',
    'masks' and 'flow' (None for pairs the gate rejected)."""
    dev = resolve(device)
    raw = {"images": [], "warped_images": [], "masks": [], "flow": []}
    loader = ImageLoader(directory, cal.hImg, cal.wImg, first)
    if motion_correction == "sfm":
        frames = []
        while len(frames) < n_images:
            for _ in range(delta - 1 if frames else 0):
                loader.get_next_frame()
            f = loader.get_next_frame()
            if f is None:
                break
            frames.append(f)
        if len(frames) < 2:
            raise ValueError(f"need >= 2 frames under {directory}")
        names = [f"{first + k * delta:09d}" for k in range(len(frames) - 1)]
        pairs = load_rectified_pairs_batched(geom, cal, frames, cache_root,
                                             names, groundtruth=groundtruth,
                                             noise=noise, device=dev)
        for pair in pairs:
            raw["images"].append(pair.image)
            raw["warped_images"].append(pair.prev_warped)
            raw["masks"].append(pair.mask)
            raw["flow"].append(pair.flow if pair.good else None)
        raw["images"].append(scale_np(np.asarray(frames[-1]),
                                      geom.hImg, geom.wImg))
        return raw

    pair_loader = _PAIR_LOADERS[motion_correction]
    draws = {"sample_idx": sample_idx} if motion_correction == "mc" else {}
    prev = loader.get_next_frame()
    for k in range(n_images - 1):
        for _ in range(delta - 1):
            loader.get_next_frame()
        img = loader.get_next_frame()
        if img is None:
            break
        pair = pair_loader(geom, cal, prev, img, cache_root,
                           f"{first + k * delta:09d}", device=dev, **draws)
        raw["images"].append(pair.image)
        raw["warped_images"].append(pair.prev_warped)
        raw["masks"].append(pair.mask)
        raw["flow"].append(pair.flow if pair.good else None)
        prev = img
    # trailing frame for the last pair's second image
    raw["images"].append(np.asarray(prev))
    return raw


# ---------------------------------------------------------------------------
# lazy dataset object
# ---------------------------------------------------------------------------

class FlowDataset:
    """Lazy per-frame caches over an image directory: full images,
    rectified previous frames, masks and GT, each pair rectified on
    ``device`` (the card unless given ``device="cpu"``) when first read."""

    def __init__(self, geom: Geometry, cal: Calibration, directory: str,
                 delta: int = 1, cache_root: Optional[str] = None,
                 device="cuda"):
        self.geom = geom
        self.cal = cal
        self.dir = directory
        self.delta = delta
        self.cache_root = cache_root
        self.device = resolve(device)
        imgdir = os.path.join(directory, "images")
        self.names = sorted(
            f for f in os.listdir(imgdir) if f.endswith((".jpg", ".png")))
        self._full: Dict[int, np.ndarray] = {}
        self._pairs: Dict[int, RectifiedPair] = {}

    def __len__(self) -> int:
        return len(self.names)

    def get_full_image(self, i: int) -> np.ndarray:
        if i not in self._full:
            img = load_image(os.path.join(self.dir, "images", self.names[i]))
            if img.shape[:2] != (self.cal.hImg, self.cal.wImg):
                img = scale_np(img, self.cal.hImg, self.cal.wImg)
            self._full[i] = img
        return self._full[i]

    def get_image(self, i: int) -> np.ndarray:
        return self._pair(i).image

    def get_prev_image(self, i: int) -> np.ndarray:
        """Rectified (rotation-compensated) previous frame."""
        return self._pair(i).prev_warped

    def get_mask(self, i: int) -> np.ndarray:
        return self._pair(i).mask

    def get_gt(self, i: int) -> Optional[np.ndarray]:
        return self._pair(i).flow

    def _pair(self, i: int) -> RectifiedPair:
        if i < self.delta:
            raise IndexError(f"frame {i} has no previous frame")
        if i not in self._pairs:
            self._pairs[i] = load_rectified_pair(
                self.geom, self.cal,
                self.get_full_image(i - self.delta), self.get_full_image(i),
                self.cache_root, self.names[i].split(".")[0],
                device=self.device)
        return self._pairs[i]

    def get_patches(self, n: int, rng: np.random.RandomState, learning=None):
        """Training patches over the (warped previous, current) pairs
        (``training.train.sample_patches``)."""
        from ..geometry import Learning
        from ..training.train import sample_patches
        learning = learning or Learning()
        images, flows, masks = [], [], []
        for i in range(self.delta, len(self)):
            p = self._pair(i)
            if not p.good:
                continue
            images.extend([p.prev_warped, p.image])
            flows.extend([p.flow, None])
            masks.extend([p.mask, None])
        if not images:
            raise ValueError("no good pairs in dataset")
        return sample_patches(self.geom, learning, images, flows[:-1],
                              masks[:-1], n, rng)
