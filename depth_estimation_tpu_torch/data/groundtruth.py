"""Ground-truth flow generators (port of
``depth_estimation_tpu.data.groundtruth``).

  * ``exhaustive_flow`` — the 'cross-correlation' ground truth: brute-force
    patch-SSD winner-take-all (or its soft-argmax, 'cc-mean') over the GT
    window, decoded by the model's ``process_output``. Patch SSD is a box
    sum over the per-pixel squared difference for each displacement, the
    same sum as matching unfolded patches.
  * ``liu_flow`` — the 'liu' ground truth: Ce Liu's variational solver
    (``flow.celiu.coarse2fine_flow``, kernel B4 on the card) with the
    trainer's parameters; ``liu_flow_batched`` solves a stack of pairs
    together on their device.
  * Disk caches with the reference's parameter-encoded layout,
    ``flow/<W>x<H>/<maxw>x<kw>/<method>/<delta>/<name>.npz`` and
    ``flow_liu/<W>x<H>/<delta>/<name>.npz``: the same files are read and
    written by both packages.

The generators take numpy arrays or tensors and return numpy arrays. They
run on ``device``, the card unless the caller passes ``device="cpu"``.
"""

from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch

from ..geometry import Geometry
from ..models import flow as flow_model
from ..utils.device import as_f32
from ..utils.precision import full_f32


def gt_geometry(geom: Geometry) -> Geometry:
    """The geometry of the GT matcher: the GT window and GT kernel on raw
    pixels."""
    return Geometry(
        hImg=geom.hImg,
        wImg=geom.wImg,
        layers=((geom.in_channels, geom.hKernelGT, geom.wKernelGT,
                 geom.hKernelGT * geom.wKernelGT * geom.in_channels),),
        maxh=geom.maxhGT,
        maxw=geom.maxwGT,
        maxhGT=geom.maxhGT,
        maxwGT=geom.maxwGT,
        hKernelGT=geom.hKernelGT,
        wKernelGT=geom.wKernelGT,
        output_extraction_method="max",
        training_mode=False,
    )


def patch_ssd_costs(img1: torch.Tensor, img2: torch.Tensor,
                    kh: int, kw: int, maxh: int, maxw: int) -> torch.Tensor:
    """Cost volume of exhaustive patch matching. img1, img2 (..., H, W, C)
    frames; img1 is cropped by the half-window inside. Returns (..., H - maxh
    - kh + 2, W - maxw - kw + 2, maxh * maxw) SSD costs, d = dy * maxw + dx.
    Plain torch: the reference leaves this to XLA as well."""
    H, W = img1.shape[-3], img1.shape[-2]
    h1 = -(-maxh // 2) - 1     # ceil(maxh/2) - 1
    w1 = -(-maxw // 2) - 1
    img1c = img1[..., h1:H - maxh // 2, w1:W - maxw // 2, :]
    Hc, Wc = img1c.shape[-3], img1c.shape[-2]
    errs = []
    for dy in range(maxh):
        for dx in range(maxw):
            diff = img1c - img2[..., dy:dy + Hc, dx:dx + Wc, :]
            errs.append(torch.sum(diff * diff, dim=-1))
    e = torch.stack(errs, dim=-1)                      # (..., Hc, Wc, D)
    Ho, Wo = Hc - kh + 1, Wc - kw + 1
    rows = e[..., 0:Ho, :, :]
    for a in range(1, kh):
        rows = rows + e[..., a:a + Ho, :, :]
    out = rows[..., :, 0:Wo, :]
    for b in range(1, kw):
        out = out + rows[..., :, b:b + Wo, :]
    return out


def _decode_gt(gg: Geometry, img1: torch.Tensor, img2: torch.Tensor,
               method: str):
    """(flow_y, flow_x, confidences) full frame for (..., H, W, C) pairs."""
    costs = patch_ssd_costs(img1, img2, gg.hKernelGT, gg.wKernelGT,
                            gg.maxh, gg.maxw)
    dist = torch.softmax(-costs, dim=-1)
    out = flow_model.process_output(gg, dist, process_full=True,
                                    threshold=None, method=method)
    outc = flow_model.process_output(gg, dist, process_full=True,
                                     threshold=0.0, method=method)
    return out.full[..., 0, :, :], out.full[..., 1, :, :], outc.full_confidences


@full_f32()
@torch.no_grad()
def exhaustive_flow(
    geom: Geometry, img1, img2, method: str = "max", device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full-frame GT flow: (flow_y, flow_x, confidences), each (hImg, wImg),
    zero outside the valid matching interior. ``method``: 'max' (WTA,
    groundtruth='cross-correlation') or 'mean' (soft-argmax, 'cc-mean')."""
    fy, fx, conf = _decode_gt(gt_geometry(geom), as_f32(img1, device),
                              as_f32(img2, device), method)
    return fy.cpu().numpy(), fx.cpu().numpy(), conf.cpu().numpy()


@full_f32()
@torch.no_grad()
def exhaustive_flow_batched(
    geom: Geometry, imgs1, imgs2, chunk: int = 8, method: str = "max",
    device="cuda", mesh=None,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """exhaustive_flow over a (B, H, W, C) stack of pairs, ``chunk`` pairs
    per batched device pass (``chunk`` bounds the transient cost volume,
    ~59 MB a pair at 320x180 with a 16x16 window).

    With ``mesh`` (a ``parallel.mesh.Mesh`` of more than one device) each
    pass is split across the mesh (``sharded_exhaustive_gt_fn``): ``chunk``
    stays the per-device bound, so a pass covers chunk * mesh size pairs,
    its tail padded with the last pair to a multiple of the mesh size. Each
    pair's result is that of the same pass on its device."""
    gg = gt_geometry(geom)
    sharded_fn = None
    if mesh is not None and mesh.size > 1:
        from ..parallel import mesh as pm
        sharded_fn = pm.sharded_exhaustive_gt_fn(geom, mesh, method)
        chunk = chunk * mesh.size
    fys, fxs, confs = [], [], []
    for s in range(0, imgs1.shape[0], chunk):
        if sharded_fn is not None:
            a, n = pm.pad_to_multiple(imgs1[s:s + chunk], mesh.size)
            b, _ = pm.pad_to_multiple(imgs2[s:s + chunk], mesh.size)
            a = torch.as_tensor(a, dtype=torch.float32)
            b = torch.as_tensor(b, dtype=torch.float32)
            fy, fx, conf = (np.asarray(o)[:n] for o in sharded_fn(a, b))
        else:
            fy, fx, conf = (o.cpu().numpy() for o in _decode_gt(
                gg, as_f32(imgs1[s:s + chunk], device),
                as_f32(imgs2[s:s + chunk], device), method))
        fys.append(fy)
        fxs.append(fx)
        confs.append(conf)
    return (np.concatenate(fys), np.concatenate(fxs), np.concatenate(confs))


# ---------------------------------------------------------------------------
# Disk cache (parameter-encoded paths, like the reference)
# ---------------------------------------------------------------------------

def _cache_path(root: str, geom: Geometry, delta: int, name: str,
                method: str = "max") -> str:
    # 'cross-correlation' -> max/, 'cc-mean' -> mean/
    return os.path.join(
        root, "flow", f"{geom.wImg}x{geom.hImg}",
        f"{geom.maxwGT}x{geom.wKernelGT}", method, str(delta), name + ".npz"
    )


@full_f32()
@torch.no_grad()
def liu_flow(
    img1, img2,
    alpha: float = 0.005, ratio: float = 0.75, min_width: int = 30,
    n_outer: int = 5, n_inner: int = 1, n_sor: int = 40, device="cuda",
) -> Tuple[np.ndarray, np.ndarray]:
    """The 'liu' GT: Ce Liu's variational flow with the trainer's
    parameters, on ``device``. Returns (flow_y, flow_x) as numpy."""
    from ..flow.celiu import coarse2fine_flow
    vx, vy, _ = coarse2fine_flow(img1, img2, alpha=alpha, ratio=ratio,
                                 min_width=min_width, n_outer=n_outer,
                                 n_inner=n_inner, n_sor=n_sor, device=device)
    return vy.cpu().numpy(), vx.cpu().numpy()


@full_f32()
@torch.no_grad()
def liu_flow_batched(
    im1s: torch.Tensor, im2s: torch.Tensor, *,
    alpha: float = 0.005, ratio: float = 0.75, min_width: int = 30,
    n_outer: int = 5, n_inner: int = 1, n_sor: int = 40,
) -> Tuple[torch.Tensor, torch.Tensor]:
    """The 'liu' GT of B pairs at once: (B, H, W, 3) f32 tensors, solved
    where they lie (``coarse2fine_flow_batched``) with the trainer's
    parameters. Returns (vx, vy), each (B, H, W), on that device."""
    from ..flow.celiu import coarse2fine_flow_batched
    vx, vy, _ = coarse2fine_flow_batched(
        im1s, im2s, alpha=alpha, ratio=ratio, min_width=min_width,
        n_outer=n_outer, n_inner=n_inner, n_sor=n_sor)
    return vx, vy


def liu_cache_path(root: str, geom: Geometry, delta: int, name: str) -> str:
    return os.path.join(
        root, "flow_liu", f"{geom.wImg}x{geom.hImg}", str(delta), name + ".npz"
    )


def store_cached_liu_flow(root: str, geom: Geometry, delta: int, name: str,
                          fy, fx) -> None:
    path = liu_cache_path(root, geom, delta, name)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, fy=fy, fx=fx)


def cached_liu_flow(root: str, geom: Geometry, delta: int, name: str,
                    img1, img2, **kw) -> Tuple[np.ndarray, np.ndarray]:
    """Disk-cached liu GT (float npz under ``flow_liu/...``); recomputed
    when the cached shape is not (hImg, wImg). ``kw`` goes to liu_flow."""
    path = liu_cache_path(root, geom, delta, name)
    if os.path.exists(path):
        z = np.load(path)
        if z["fy"].shape == (geom.hImg, geom.wImg):
            return z["fy"], z["fx"]
    fy, fx = liu_flow(img1, img2, **kw)
    store_cached_liu_flow(root, geom, delta, name, fy, fx)
    return fy, fx


def load_cached_flow(root: str, geom: Geometry, delta: int, name: str,
                     method: str = "max"
                     ) -> Optional[Tuple[np.ndarray, np.ndarray, np.ndarray]]:
    """Cache read with the reference's size check (None on a miss or a
    shape mismatch)."""
    path = _cache_path(root, geom, delta, name, method)
    if os.path.exists(path):
        z = np.load(path)
        fy, fx, conf = z["fy"], z["fx"], z["conf"]
        if fy.shape == (geom.hImg, geom.wImg):
            return fy, fx, conf
    return None


def store_cached_flow(root: str, geom: Geometry, delta: int, name: str,
                      fy: np.ndarray, fx: np.ndarray,
                      conf: np.ndarray, method: str = "max") -> None:
    path = _cache_path(root, geom, delta, name, method)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    np.savez_compressed(path, fy=fy, fx=fx, conf=conf)


def cached_exhaustive_flow(
    root: str, geom: Geometry, delta: int, name: str,
    img1, img2, method: str = "max", device="cuda",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Compute-on-miss GT cache."""
    hit = load_cached_flow(root, geom, delta, name, method)
    if hit is not None:
        return hit
    fy, fx, conf = exhaustive_flow(geom, img1, img2, method, device)
    store_cached_flow(root, geom, delta, name, fy, fx, conf, method)
    return fy, fx, conf
