"""Legacy sparse-SFM depth datasets (port of
``depth_estimation_tpu.data.depth_legacy``, numpy only): the depth
discretizer, sparse depth points per frame, class-balanced patch sampling,
the continuous variant, and ``load_depth_dataset``, the frame pairs
(grayscale, stacked on channels) and depth points the legacy depth
classifier trains on.

Depth points are stored as npz (``depths/<frame>.npz`` with arrays x, y,
depth). Every sampler draws from a ``np.random.RandomState`` the caller
passes, in the reference's order, so a seed gives the same patches in
both packages.
"""

from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np

NUMBER_OF_BINS = 100  # histogram resolution


@dataclasses.dataclass
class DepthDiscretizer:
    """Classes split [0, 2*cutDepth] uniformly; cutDepth set so half the
    patch mass falls below it."""

    n_classes: int
    cut_depth: float = 0.0
    bin_step: int = 0

    def get_class(self, depth: float) -> int:
        """1-based class index (clamped to n_classes)."""
        step = 2.0 * self.cut_depth / self.n_classes
        c = int(np.ceil(depth / max(step, 1e-9)))
        return min(max(c, 1), self.n_classes)

    def compute_cut_depth(self, histogram: Sequence[list], n_used: int) -> None:
        """histogram: list of per-integer-depth-bin sample lists."""
        total = 0
        for i, binlist in enumerate(histogram, start=1):
            total += len(binlist)
            if total > n_used / 2:
                self.cut_depth = float(i)
                break
        else:
            self.cut_depth = float(len(histogram))
        self.bin_step = int(2 * self.cut_depth / self.n_classes) or 1

    def random_bin(self, histogram: Sequence[list],
                   rng: np.random.RandomState) -> int:
        """Class-balanced bin sampling: pick a class uniformly,
        then a non-empty integer bin within it. 0-based bin index."""
        for _ in range(10000):
            c = rng.randint(1, self.n_classes + 1)
            b = rng.randint((c - 1) * self.bin_step, c * self.bin_step)
            if b < len(histogram) and histogram[b]:
                return b
        raise RuntimeError("no non-empty bins")


def load_depth_points(path: str) -> Dict[str, np.ndarray]:
    """Sparse depth points of a frame: npz with x, y, depth arrays
    (the 'depths version 2' payload)."""
    z = np.load(path)
    return {"x": z["x"].astype(np.float32),
            "y": z["y"].astype(np.float32),
            "depth": z["depth"].astype(np.float32)}


def load_raw_depth_data(directory: str,
                        blacklist: Sequence[str] = ()) -> List[Dict]:
    """Frames with sparse depth annotations; blacklisted frames skipped."""
    ddir = os.path.join(directory, "depths")
    out = []
    if not os.path.isdir(ddir):
        return out
    for name in sorted(os.listdir(ddir)):
        if not name.endswith(".npz") or name.split(".")[0] in blacklist:
            continue
        d = load_depth_points(os.path.join(ddir, name))
        d["name"] = name.split(".")[0]
        out.append(d)
    return out


def median_patch_depth(points: Dict[str, np.ndarray], y0: int, x0: int,
                       h: int, w: int) -> Optional[float]:
    """Median depth of the sparse points inside a patch."""
    sel = ((points["x"] >= x0) & (points["x"] < x0 + w)
           & (points["y"] >= y0) & (points["y"] < y0 + h))
    if not sel.any():
        return None
    return float(np.median(points["depth"][sel]))


def pre_sort_data_discrete(
    frames: List[Dict], images: List[np.ndarray],
    patch_h: int, patch_w: int, n_samples: int,
    rng: np.random.RandomState,
) -> List[list]:
    """Build the integer-depth histogram of candidate patches."""
    histogram: List[list] = [[] for _ in range(NUMBER_OF_BINS)]
    H, W = images[0].shape[:2]
    for _ in range(n_samples):
        fi = rng.randint(0, len(frames))
        y0 = rng.randint(0, H - patch_h)
        x0 = rng.randint(0, W - patch_w)
        med = median_patch_depth(frames[fi], y0, x0, patch_h, patch_w)
        if med is None:
            continue
        b = min(int(med), NUMBER_OF_BINS - 1)
        histogram[b].append((fi, y0, x0, med))
    return histogram


def generate_data_discrete(
    frames: List[Dict], images: List[np.ndarray],
    patch_h: int, patch_w: int, n_classes: int, n_samples: int,
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray, DepthDiscretizer]:
    """Class-balanced discrete depth dataset. Returns
    (patches (N, h, w, C), classes (N,) 1-based, discretizer)."""
    histogram = pre_sort_data_discrete(frames, images, patch_h, patch_w,
                                       n_samples * 4, rng)
    disc = DepthDiscretizer(n_classes)
    disc.compute_cut_depth(histogram, sum(len(b) for b in histogram))
    patches, classes = [], []
    while len(patches) < n_samples:
        b = disc.random_bin(histogram, rng)
        fi, y0, x0, med = histogram[b][rng.randint(0, len(histogram[b]))]
        patches.append(images[fi][y0:y0 + patch_h, x0:x0 + patch_w])
        classes.append(disc.get_class(med))
    return (np.stack(patches).astype(np.float32),
            np.asarray(classes, np.int32), disc)


def generate_continuous_dataset(
    frames: List[Dict], images: List[np.ndarray],
    patch_h: int, patch_w: int, n_samples: int,
    rng: np.random.RandomState,
) -> Tuple[np.ndarray, np.ndarray]:
    """Continuous-depth variant: the raw median depth as a regression
    target."""
    patches, depths = [], []
    H, W = images[0].shape[:2]
    tries = 0
    while len(patches) < n_samples and tries < n_samples * 100:
        tries += 1
        fi = rng.randint(0, len(frames))
        y0 = rng.randint(0, H - patch_h)
        x0 = rng.randint(0, W - patch_w)
        med = median_patch_depth(frames[fi], y0, x0, patch_h, patch_w)
        if med is None:
            continue
        patches.append(images[fi][y0:y0 + patch_h, x0:x0 + patch_w])
        depths.append(med)
    return (np.stack(patches).astype(np.float32),
            np.asarray(depths, np.float32))


def _to_gray(img: np.ndarray) -> np.ndarray:
    """(H, W, 3) RGB -> (H, W) luma (0.299, 0.587, 0.114); one channel or
    (H, W) as it is."""
    if img.ndim == 3 and img.shape[2] == 3:
        return img @ np.asarray([0.299, 0.587, 0.114], np.float32)
    return img[..., 0] if img.ndim == 3 else img


def load_depth_dataset(root: str, n_images: int, delta: int,
                       h: int, w: int):
    """The annotated frames under ``root`` (``depths/*.npz``, at most
    ``n_images``) with their pairs (frame i, frame i + delta) from
    ``root/images/%09d.{jpg,png}`` as grayscale stacked on channels,
    resized to (h, w) with the depth points scaled alike. Frames whose pair
    is incomplete are dropped. Returns (frames, images (h, w, 2))."""
    from .images import load_image, scale_np

    frames = load_raw_depth_data(root)[:n_images]
    images, kept = [], []
    for fr in frames:
        i = int(fr["name"])
        pair = []
        for j in (i, i + delta):
            path = None
            for ext in (".jpg", ".png"):
                cand = os.path.join(root, "images", f"{j:09d}{ext}")
                if os.path.exists(cand):
                    path = cand
                    break
            if path is None:
                break
            img = load_image(path)
            hs, ws = img.shape[:2]
            g = _to_gray(img.astype(np.float32))
            if (hs, ws) != (h, w):
                g = scale_np(g[..., None], h, w)[..., 0]
                fr = dict(fr, x=fr["x"] * (w / ws), y=fr["y"] * (h / hs))
            pair.append(g)
        if len(pair) == 2:
            images.append(np.stack(pair, axis=-1))
            kept.append(fr)
    return kept, images
