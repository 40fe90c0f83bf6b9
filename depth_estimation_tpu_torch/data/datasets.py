"""Frame-sequence datasets for the trainers (port of
``depth_estimation_tpu.data.datasets``).

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
  * the polar pipeline of the radial trainer and tester: ``polar_batch``
    (``polar_ego``: ego-motion with the full tracker and the epipole;
    ``polar_warps``: rotation removal and the polar warps, for a stack of
    pairs; ``api_radial`` runs the same two stages),
    ``polar_gt_batch`` (the exhaustive GT projected onto the radius and
    warped to polar rows), ``load_polar_pairs_batched`` over both,
    ``load_polar_pair_reference`` (the per-pair formulation it is held
    to), and the host samplers ``generate_polar_training_patches`` and
    ``smooth_epipole``.

Every entry point runs on ``device``: the card unless the caller passes
``device="cpu"``; pairs come back as numpy arrays. RANSAC's draws are
arguments: ``noise`` (n_samples, 8, max_points) Gumbel noise for the
essential fit (default: ``egomotion.gumbel_noise``, seed 1) and
``sample_idx`` (n_samples, 5) for the 4-DoF fit (default: seed 0). The
batched loaders take a ``mesh`` (``parallel.mesh.Mesh``, the CLIs' --dp
flag): the pair stack, and its ground truth, are split across the mesh's
devices, each running the same program at its local batch.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..geometry import Geometry
from ..geometry3d import egomotion as ego
from ..geometry3d import polar as polar_ops
from ..geometry3d import undistort as undist
from ..geometry3d.calibration import Calibration
from ..utils.device import as_f32, host, resolve, true_div
from ..utils.precision import full_f32
from . import groundtruth as gt_mod
from .images import ImageLoader, load_image, scale, scale_batched_device, scale_np

# liu cache misses solved together on one device, at most: a chunk bounds
# the solver's transient memory and fills the card's SMs with B4's clusters
LIU_CHUNK = 64


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


@full_f32()
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


@full_f32()
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


@full_f32()
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


@full_f32()
def load_rectified_pairs_batched(
    geom: Geometry, cal: Calibration, frames: List[np.ndarray],
    cache_root: Optional[str] = None, names: Optional[List[str]] = None,
    compute_gt: bool = True, delta: int = 1,
    groundtruth: str = "cross-correlation", noise=None, device="cuda",
    mesh=None,
) -> List[RectifiedPair]:
    """The 'sfm' loader over the consecutive pairs (frames[k],
    frames[k + delta]) in one batched pass (``rectify_batch``), then the
    GT: disk-cache hits read, the misses in batched chunks (the exhaustive
    matcher's ``chunk``, the liu solver's ``LIU_CHUNK``).

    With ``mesh`` (more than one device) the pair stack is split across
    the mesh for the rectification (``parallel.mesh.sharded_rectify_fn``,
    the same RANSAC noise on every shard) and for the GT (the sharded
    exhaustive matcher, or, for 'liu', the batched solver on each shard's
    cache misses, ``sharded_celiu_fn``); each shard runs its pairs at its
    local batch."""
    dev = resolve(device)
    sharded = mesh is not None and mesh.size > 1
    if noise is None:
        noise = ego.gumbel_noise(64, cal.sfm.max_points, dev)
    if sharded:
        from ..parallel import mesh as pm
        rect_fn = pm.sharded_rectify_fn(mesh, cal, geom.hImg, geom.wImg,
                                        noise=as_f32(noise, dev))
        pp, n_real = pm.pad_to_multiple(
            np.stack(frames[:-delta]).astype(np.float32), mesh.size)
        pi, _ = pm.pad_to_multiple(
            np.stack(frames[delta:]).astype(np.float32), mesh.size)
        outs = [np.asarray(o)[:n_real] for o in rect_fn(pp, pi)]
    else:
        prevs = as_f32(np.stack(frames[:-delta]), dev)
        imgs = as_f32(np.stack(frames[delta:]), dev)
        outs = rectify_batch(prevs, imgs, cal.K, tuple(cal.distortion),
                             geom.hImg, geom.wImg, cal.sfm.max_points,
                             cal.sfm.points_quality, as_f32(noise, dev))
    prev_s, img_s, warped, mask, n_inl, n_fnd = (host(o) for o in outs)
    B = prev_s.shape[0]
    good = [float(n_inl[k]) / max(float(n_fnd[k]), 1.0)
            >= cal.bad_image_threshold for k in range(B)]

    gts: Dict[int, Tuple] = {}
    if compute_gt and groundtruth == "liu":
        # cache hits from disk, every miss through the batched solver:
        # split across the mesh, or LIU_CHUNK pairs at a time on one device
        misses = []
        for k in range(B):
            if not good[k]:
                continue
            name = names[k] if names else ""
            if cache_root is not None and name:
                path = gt_mod.liu_cache_path(cache_root, geom, 1, name)
                if os.path.exists(path):
                    z = np.load(path)
                    if z["fy"].shape == (geom.hImg, geom.wImg):
                        gts[k] = (z["fy"], z["fx"], None)
                        continue
            misses.append(k)
        if misses and sharded:
            celiu_fn = pm.sharded_celiu_fn(
                mesh, alpha=0.005, ratio=0.75, min_width=30,
                n_outer=5, n_inner=1, n_sor=40)
            im1, n_real = pm.pad_to_multiple(warped[misses], mesh.size)
            im2, _ = pm.pad_to_multiple(img_s[misses], mesh.size)
            vx, vy, _w = celiu_fn(im1, im2)
            vx, vy = np.asarray(vx)[:n_real], np.asarray(vy)[:n_real]
        elif misses:
            vxs, vys = [], []
            for a in range(0, len(misses), LIU_CHUNK):
                chunk = misses[a:a + LIU_CHUNK]
                cx, cy = gt_mod.liu_flow_batched(as_f32(warped[chunk], dev),
                                                 as_f32(img_s[chunk], dev))
                vxs.append(cx.cpu().numpy())
                vys.append(cy.cpu().numpy())
            vx, vy = np.concatenate(vxs), np.concatenate(vys)
        for j, k in enumerate(misses):
            gts[k] = (vy[j], vx[j], None)
            name = names[k] if names else ""
            if cache_root is not None and name:
                gt_mod.store_cached_liu_flow(cache_root, geom, 1, name,
                                             vy[j], vx[j])
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
                geom, warped[misses], img_s[misses], method=method, device=dev,
                mesh=mesh)
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


@full_f32()
def load_data_optical_flow(
    geom: Geometry, cal: Calibration, directory: str, n_images: int,
    first: int = 0, delta: int = 1, cache_root: Optional[str] = None,
    motion_correction: Optional[str] = "sfm",
    groundtruth: str = "cross-correlation", noise=None, sample_idx=None,
    device="cuda", mesh=None,
) -> Dict[str, list]:
    """Dataset assembly: up to ``n_images`` consecutive (``delta``-strided)
    frames from ``directory/images/``, rectified by ``motion_correction``
    ('sfm' batched, with ``noise``; 'mc' per pair, with ``sample_idx``; or
    None), with GT flow per pair ('sfm' takes ``groundtruth``, the others
    the exhaustive WTA GT). ``mesh`` splits the batched 'sfm' build and its
    GT across the mesh's devices (the per-pair 'mc' and None loaders
    ignore it). Returns
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
                                             noise=noise, device=dev,
                                             mesh=mesh)
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
    ``device`` (the card unless given ``device="cpu"``) when first read,
    with RANSAC's ``noise`` (as ``load_rectified_pair``)."""

    def __init__(self, geom: Geometry, cal: Calibration, directory: str,
                 delta: int = 1, cache_root: Optional[str] = None,
                 noise=None, device="cuda"):
        self.geom = geom
        self.cal = cal
        self.dir = directory
        self.delta = delta
        self.cache_root = cache_root
        self.noise = noise
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
                noise=self.noise, device=self.device)
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


# ---------------------------------------------------------------------------
# radial / polar pipeline
# ---------------------------------------------------------------------------

def flow_norm(flow: np.ndarray) -> np.ndarray:
    return np.sqrt(flow[0] ** 2 + flow[1] ** 2) + 1e-12


def project_groundtruth(flow: np.ndarray, gds: np.ndarray, e2) -> Tuple[np.ndarray, np.ndarray]:
    """Project cartesian GT flow (2, H, W) onto the radial direction from
    the epipole e2 = (x, y). Returns (proj (H, W) int-valued, gds zeroed
    where the projection is negative)."""
    H, W = flow.shape[1], flow.shape[2]
    ys = np.arange(H, dtype=np.float32)[:, None] - float(e2[1])
    xs = np.arange(W, dtype=np.float32)[None, :] - float(e2[0])
    radial = np.stack([np.broadcast_to(ys, (H, W)),
                       np.broadcast_to(xs, (H, W))])
    n = flow_norm(radial)
    radial = radial / n
    projf = flow[0] * radial[0] + flow[1] * radial[1]
    proj = np.floor(projf + 0.5)
    gds = gds * (projf >= 0)
    return proj.astype(np.float32), gds.astype(np.float32)


def saturate_groundtruth(flow: np.ndarray, gds: np.ndarray, maxflow: float):
    """Clamp projected GT to maxflow and invalidate the clamped pixels."""
    sat = (flow <= maxflow).astype(np.float32)
    flow = flow * sat + (1 - sat) * maxflow
    gds = gds * sat
    return flow, gds


@dataclasses.dataclass
class PolarPair:
    polar_image: np.ndarray
    polar_prev_image: np.ndarray
    polar_mask: np.ndarray
    e2: np.ndarray
    good: bool
    polar_gt: Optional[np.ndarray] = None
    polar_gt_mask: Optional[np.ndarray] = None


@full_f32()
def load_polar_pair(
    cal: Calibration, prev: np.ndarray, img: np.ndarray,
    h_img: int, w_img: int, h_input: int, w_input: int, w_kernel: int,
    geom_gt: Optional[Geometry] = None, max_flow: Optional[float] = None,
    noise=None, device="cuda",
) -> PolarPair:
    """One pair through ``load_polar_pairs_batched``."""
    return load_polar_pairs_batched(
        cal, [np.asarray(prev), np.asarray(img)], h_img, w_img,
        h_input, w_input, w_kernel, geom_gt, max_flow, noise=noise,
        device=device)[0]


@full_f32()
def load_polar_pair_reference(
    cal: Calibration, prev: np.ndarray, img: np.ndarray,
    h_img: int, w_img: int, h_input: int, w_input: int, w_kernel: int,
    geom_gt: Optional[Geometry] = None, max_flow: Optional[float] = None,
    noise=None, device="cuda",
) -> PolarPair:
    """Step-by-step per-pair formulation of the polar loader, kept as the
    semantic reference of the batched one: ego-motion (full LK), epipole,
    rotation removal, the one-pixel border zeroed, the polar warps on the
    float grid, and the GT (exhaustive WTA) projected onto the radius in
    float64 on the host."""
    dev = resolve(device)
    prev_t, img_t = as_f32(prev, dev), as_f32(img, dev)
    if noise is not None:
        noise = as_f32(noise, dev)
    em = ego.get_ego_motion(prev_t, img_t, cal.K,
                            max_points=cal.sfm.max_points,
                            quality=cal.sfm.points_quality, noise=noise,
                            tracker="full")
    ratio = float(em.n_inliers) / max(float(em.n_found), 1.0)
    e2 = host(ego.epipole(cal.K, em.T)) * (w_img / cal.wImg)
    if ratio < cal.bad_image_threshold:
        z = np.zeros((h_input, w_input), np.float32)
        return PolarPair(z, z, z, e2, False)

    img_s = scale(img_t, h_img, w_img)
    prev_s = scale(prev_t, h_img, w_img)
    Ks = cal.K.copy()
    Ks[0] *= w_img / cal.wImg
    Ks[1] *= h_img / cal.hImg
    prev_w = undist.remove_ego_motion(prev_s, Ks, em.R)
    ones = torch.ones((h_img, w_img, 1), device=dev)
    mask = (undist.remove_ego_motion(ones, Ks, em.R)[..., 0] > 0.5).float()
    mask[0, :] = 0
    mask[-1, :] = 0
    mask[:, 0] = 0
    mask[:, -1] = 0

    rmax = polar_ops.get_rmax(h_img, w_img, e2)
    lp = (w_kernel - 1) // 2
    grid = polar_ops.get_c2p_grid(
        w_img, h_img, w_input, h_input, float(e2[0]), float(e2[1]),
        lpadding=lp, rpadding=(w_kernel - 1) - lp, rmax=rmax, device=dev)
    p_img = host(polar_ops.warp_grid(img_s, grid))
    p_prev = host(polar_ops.warp_grid(prev_w, grid))
    p_mask = (host(polar_ops.warp_grid(mask[..., None], grid)[..., 0])
              > 0).astype(np.float32)

    p_gt = p_gt_mask = None
    if geom_gt is not None:
        fy, fx, conf = gt_mod.exhaustive_flow(geom_gt, prev_w, img_s,
                                              device=dev)
        flow = np.stack([fy, fx])
        gds = (conf > 0).astype(np.float32) * host(mask)
        proj, gds = project_groundtruth(flow, gds, e2)
        if max_flow is not None:
            # max_flow is in polar rows; the projected GT in cartesian
            # radial pixels, rmax / h_input of a row each
            proj, gds = saturate_groundtruth(
                proj, gds, max_flow * float(rmax) / h_input)
        proj = proj * gds
        both = torch.from_numpy(np.stack([proj, gds], axis=-1)).to(dev)
        warped = host(polar_ops.warp_grid(both, grid))
        # cartesian radial pixels -> polar rows
        p_gt = warped[..., 0] * (h_input / float(rmax))
        p_gt_mask = (warped[..., 1] > 0.99).astype(np.float32)
    return PolarPair(p_img, p_prev, p_mask, e2, True, p_gt, p_gt_mask)


@torch.no_grad()
def polar_ego(prevs: torch.Tensor, imgs: torch.Tensor, K, cal_w: int,
              w_img: int, max_points: int, quality: float,
              noise: torch.Tensor):
    """The polar chain's ego-motion for (B, H, W, C) frame pairs at the
    calibration's size: ``egomotion.get_ego_motion_batched`` with the full
    tracker (corners, full-image LK, essential RANSAC with ``noise``
    (n_samples, 8, max_points) shared by every item), and the epipole K T
    / T_z scaled to the working width. Returns (EgoMotion, e2 (B, 2))."""
    K = as_f32(K, prevs.device)
    em = ego.get_ego_motion_batched(prevs, imgs, K, max_points, quality,
                                    noise=noise, n_samples=noise.shape[0],
                                    tracker="full")
    e = em.T @ K.T
    return em, (e[:, :2] / e[:, 2:3]) * (w_img / cal_w)


@torch.no_grad()
def polar_warps(prevs: torch.Tensor, imgs: torch.Tensor, K, R: torch.Tensor,
                e2: torch.Tensor, cal_w: int, cal_h: int, h_img: int,
                w_img: int, h_input: int, w_input: int, w_kernel: int,
                pixel_prevs: Optional[torch.Tensor] = None,
                pixel_imgs: Optional[torch.Tensor] = None):
    """The polar chain after ego-motion: both frames rescaled to (h_img,
    w_img), the rotation R warp of the previous frame and of a ones mask
    (> 0.5, its one-pixel border zeroed), rmax and the polar grid about
    each epipole e2 (B, 2) in float32, and the polar warps of the current
    frame, the warped previous frame and the mask (> 0).

    ``pixel_prevs``/``pixel_imgs`` (optional, same shapes) split the
    frames' roles: the geometry and the cartesian frames the GT matcher
    reads come from ``prevs``/``imgs``; the polar pixel images are the
    pixel frames warped through that geometry (training on noisy pixels
    with targets from clean frames).

    Returns (p_img, p_prev, p_mask, prev_w, img_s, mask)."""
    Ks = as_f32(K, prevs.device).clone()
    Ks[0] = Ks[0] * (w_img / cal_w)
    Ks[1] = Ks[1] * (h_img / cal_h)
    lp = (w_kernel - 1) // 2
    img_s = scale_batched_device(imgs, h_img, w_img)
    prev_s = scale_batched_device(prevs, h_img, w_img)
    prev_w = undist.remove_ego_motion_batched(prev_s, Ks, R)
    ones = torch.ones((prevs.shape[0], h_img, w_img, 1), device=prevs.device)
    mask = (undist.remove_ego_motion_batched(ones, Ks, R)[..., 0]
            > 0.5).float()
    border = torch.zeros((h_img, w_img), device=prevs.device)
    border[1:-1, 1:-1] = 1.0
    mask = mask * border
    rmax = polar_ops.get_rmax_batched(h_img, w_img, e2)
    grid = polar_ops.get_c2p_grid_batched(
        w_img, h_img, w_input, h_input, e2[:, 0], e2[:, 1], rmax,
        lpadding=lp, rpadding=(w_kernel - 1) - lp)
    if pixel_prevs is None:
        pix_img_s, pix_prev_w = img_s, prev_w
    else:
        pix_img_s = scale_batched_device(pixel_imgs, h_img, w_img)
        pix_prev_w = undist.remove_ego_motion_batched(
            scale_batched_device(pixel_prevs, h_img, w_img), Ks, R)
    p_img = polar_ops.warp_grid_batched(pix_img_s, grid)
    p_prev = polar_ops.warp_grid_batched(pix_prev_w, grid)
    p_mask = (polar_ops.warp_grid_batched(mask[..., None], grid)[..., 0]
              > 0).float()
    return p_img, p_prev, p_mask, prev_w, img_s, mask


@torch.no_grad()
def polar_batch(prevs: torch.Tensor, imgs: torch.Tensor, K, cal_w: int,
                cal_h: int, h_img: int, w_img: int, h_input: int,
                w_input: int, w_kernel: int, max_points: int, quality: float,
                noise: torch.Tensor, pixel_prevs: Optional[torch.Tensor] = None,
                pixel_imgs: Optional[torch.Tensor] = None):
    """Ego-motion -> epipole -> rotation removal -> polar warps for (B, H,
    W, C) frame pairs on their device: ``polar_ego`` then ``polar_warps``
    (see each), the chain the radial estimator (``api_radial``) runs too.

    Returns (p_img, p_prev, p_mask, e2, n_inliers, n_found, prev_w,
    img_s, mask) as tensors."""
    em, e2 = polar_ego(prevs, imgs, K, cal_w, w_img, max_points, quality,
                       noise)
    p_img, p_prev, p_mask, prev_w, img_s, mask = polar_warps(
        prevs, imgs, K, em.R, e2, cal_w, cal_h, h_img, w_img, h_input,
        w_input, w_kernel, pixel_prevs, pixel_imgs)
    return (p_img, p_prev, p_mask, e2, em.n_inliers, em.n_found, prev_w,
            img_s, mask)


@torch.no_grad()
def polar_gt_batch(flows_y: torch.Tensor, flows_x: torch.Tensor,
                   confs: torch.Tensor, masks: torch.Tensor, e2s: torch.Tensor,
                   h_img: int, w_img: int, h_input: int, w_input: int,
                   w_kernel: int, max_flow: float = float("inf")):
    """The GT of (B, h_img, w_img) flows projected onto the radius from
    each epipole in float32, quantized floor(x + 0.5), kept where the
    projection is >= 0, saturated at ``max_flow`` polar rows (max_flow rmax
    / h_input cartesian pixels; inf keeps every value), warped to polar
    and scaled to polar rows by h_input / rmax. Returns (gt, gt mask > 0.99)
    (B, h_input, w_input + w_kernel - 1)."""
    dev = flows_y.device
    lp = (w_kernel - 1) // 2
    ys = (torch.arange(h_img, dtype=torch.float32, device=dev)[None, :, None]
          - e2s[:, 1, None, None])
    xs = (torch.arange(w_img, dtype=torch.float32, device=dev)[None, None, :]
          - e2s[:, 0, None, None])
    n = torch.sqrt(ys * ys + xs * xs) + 1e-12
    projf = (flows_y * ys + flows_x * xs) / n
    proj = torch.floor(projf + 0.5)
    gds = (confs > 0).float() * masks * (projf >= 0).float()
    rmax = polar_ops.get_rmax_batched(h_img, w_img, e2s)
    max_flow_cart = true_div(max_flow * rmax, h_input)[:, None, None]
    sat = (proj <= max_flow_cart).float()
    proj = torch.where(sat > 0, proj, max_flow_cart)    # inf-safe clamp
    gds = gds * sat
    proj = proj * gds
    grid = polar_ops.get_c2p_grid_batched(
        w_img, h_img, w_input, h_input, e2s[:, 0], e2s[:, 1], rmax,
        lpadding=lp, rpadding=(w_kernel - 1) - lp)
    warped = polar_ops.warp_grid_batched(torch.stack([proj, gds], dim=-1), grid)
    rows = torch.full_like(rmax, float(h_input)) / rmax
    return (warped[..., 0] * rows[:, None, None],
            (warped[..., 1] > 0.99).float())


@full_f32()
def load_polar_pairs_batched(
    cal: Calibration, frames: List[np.ndarray],
    h_img: int, w_img: int, h_input: int, w_input: int, w_kernel: int,
    geom_gt: Optional[Geometry] = None, max_flow: Optional[float] = None,
    delta: int = 1, pixel_frames: Optional[List[np.ndarray]] = None,
    noise=None, device="cuda", mesh=None,
) -> List[PolarPair]:
    """The polar loader over the consecutive pairs (frames[k], frames[k +
    delta]) in one batched pass (``polar_batch``), then, with ``geom_gt``,
    the exhaustive GT in chunks of 2 pairs and its projection
    (``polar_gt_batch``). ``pixel_frames`` (optional, index-aligned with
    ``frames``) supplies the polar pixel images (see ``polar_batch``).
    ``noise``: RANSAC's (64, 8, max_points) Gumbel draw (default
    ``egomotion.gumbel_noise``, seed 1). ``mesh`` (more than one device)
    splits the polar build (``parallel.mesh.sharded_polar_load_fn``, the
    same noise on every shard) and the GT's chunks across the mesh."""
    dev = resolve(device)
    stacks = [np.stack(frames[:-delta]), np.stack(frames[delta:])]
    if pixel_frames is not None:
        if len(pixel_frames) != len(frames):
            raise ValueError("pixel_frames must be index-aligned with "
                             f"frames ({len(pixel_frames)} vs {len(frames)})")
        stacks += [np.stack(pixel_frames[:-delta]),
                   np.stack(pixel_frames[delta:])]
    if noise is None:
        noise = ego.gumbel_noise(64, cal.sfm.max_points, dev)
    if mesh is not None and mesh.size > 1:
        from ..parallel import mesh as pm
        polar_fn = pm.sharded_polar_load_fn(
            mesh, cal, h_img, w_img, h_input, w_input, w_kernel,
            clean_pixels=pixel_frames is not None, noise=as_f32(noise, dev))
        padded = [pm.pad_to_multiple(a.astype(np.float32), mesh.size)
                  for a in stacks]
        n_real = padded[0][1]
        outs = [o.gather(dev)[:n_real]
                for o in polar_fn(*(a for a, _ in padded))]
    else:
        prevs, imgs, *pix = (as_f32(a, dev) for a in stacks)
        outs = polar_batch(prevs, imgs, cal.K, cal.wImg, cal.hImg, h_img,
                           w_img, h_input, w_input, w_kernel,
                           cal.sfm.max_points, cal.sfm.points_quality,
                           as_f32(noise, dev), *pix)
    (p_img, p_prev, p_mask, e2s, n_inl, n_fnd, prev_w, img_s, masks) = outs
    n_inl, n_fnd, e2s_np = host(n_inl), host(n_fnd), host(e2s)
    B = len(stacks[0])
    good = [float(n_inl[k]) / max(float(n_fnd[k]), 1.0)
            >= cal.bad_image_threshold for k in range(B)]

    gt_polar = gt_mask_polar = None
    if geom_gt is not None:
        fy, fx, conf = gt_mod.exhaustive_flow_batched(geom_gt, prev_w, img_s,
                                                      chunk=2, device=dev,
                                                      mesh=mesh)
        gt_polar, gt_mask_polar = (host(o) for o in polar_gt_batch(
            as_f32(fy, dev), as_f32(fx, dev), as_f32(conf, dev), masks, e2s,
            h_img, w_img, h_input, w_input, w_kernel,
            float(max_flow) if max_flow is not None else float("inf")))

    p_img, p_prev, p_mask = host(p_img), host(p_prev), host(p_mask)
    out = []
    for k in range(B):
        if not good[k]:
            z = np.zeros((h_input, w_input), np.float32)
            out.append(PolarPair(z, z, z, e2s_np[k], False))
            continue
        out.append(PolarPair(
            p_img[k], p_prev[k], p_mask[k], e2s_np[k], True,
            None if gt_polar is None else gt_polar[k],
            None if gt_mask_polar is None else gt_mask_polar[k]))
    return out


def smooth_epipole(prev_e2: Optional[np.ndarray], e2: np.ndarray,
                   h_img: int, w_img: int, alpha: float = 0.5) -> np.ndarray:
    """EMA epipole smoothing; an epipole outside the frame keeps the
    previous one."""
    if prev_e2 is None:
        return e2
    if not (0 <= e2[0] < w_img and 0 <= e2[1] < h_img):
        return prev_e2
    return alpha * e2 + (1 - alpha) * prev_e2


@full_f32()
def generate_polar_training_patches(
    pair: PolarPair, h_patch: int, w_patch: int, h_win: int,
    n: int, rng: np.random.RandomState,
):
    """Polar patch sampler with mask and GT-mask rejection. Patches are
    (h_patch, w_patch) with h_patch = hKernel + hWin - 1, so the trainer
    net gives one matcher row a patch; the target is the GT at that row's
    receptive-field centre (row ceil(hKernel/2) - 1, column w_patch // 2).
    The mask must be valid over the whole patch. Returns (prev_patches,
    curr_patches, targets in [0, h_win)), or None if no patch was kept
    within n * 300 tries."""
    H, W = pair.polar_image.shape[:2]
    if H < h_patch or W < w_patch:
        raise ValueError(
            f"polar image {H}x{W} smaller than the patch {h_patch}x{w_patch}")
    h_kernel = h_patch - h_win + 1
    h_off = (h_kernel + 1) // 2 - 1          # ceil(hKernel/2) - 1
    w_off = w_patch // 2
    p1, p2, ts = [], [], []
    tries = 0
    while len(ts) < n and tries < n * 300:
        tries += 1
        # +1: the last valid origin (the largest radius) is sampled too
        y = rng.randint(0, H - h_patch + 1)
        x = rng.randint(0, W - w_patch + 1)
        yc, xc = y + h_off, x + w_off
        if pair.polar_mask[y:y + h_patch, x:x + w_patch].min() < 0.1:
            continue
        if pair.polar_gt_mask is not None:
            gx = min(xc, pair.polar_gt_mask.shape[1] - 1)
            gy = min(yc, pair.polar_gt_mask.shape[0] - 1)
            if pair.polar_gt_mask[gy, gx] < 0.5:
                continue
            t = pair.polar_gt[gy, gx]
        else:
            t = 0.0
        t = float(np.floor(t + 0.5))
        if not (0 <= t < h_win):
            continue
        p1.append(pair.polar_prev_image[y:y + h_patch, x:x + w_patch])
        p2.append(pair.polar_image[y:y + h_patch, x:x + w_patch])
        ts.append(int(t))
    if not ts:
        return None
    return (np.stack(p1).astype(np.float32), np.stack(p2).astype(np.float32),
            np.asarray(ts, np.int32))
