"""What the single-scale online paths share: the configuration's camera and
checkpoint for the program (the port's own loader and calibration type)
and for the plain reference (its own reader), RANSAC's draw noise from the
seed, and the work counts of the spans they wrap."""

from __future__ import annotations

from h100bench import counts
from h100bench.reference import checkpoint, online as ref

STORAGE = ("float32", "bfloat16", "float16")


def torch_dtype(name: str):
    """A storage type of the configuration as a torch dtype."""
    import torch
    if name not in STORAGE:
        raise ValueError(f"storage {name!r}: one of {STORAGE}")
    return getattr(torch, name)


def ref_camera(cfg: dict) -> ref.Camera:
    c = cfg["camera"]
    return ref.Camera(c["wImg"], c["hImg"], c["fx"], c["fy"], c["cx"],
                      c["cy"], tuple(c["distortion"]), c["max_points"],
                      c["points_quality"], c["bad_image_threshold"])


def port_calibration(cfg: dict):
    """The port's ``Calibration`` with the configuration's values."""
    from depth_estimation_tpu_torch.geometry3d.calibration import (
        Calibration, SfmParams)
    c = cfg["camera"]
    return Calibration(name=c["name"], wImg=c["wImg"], hImg=c["hImg"],
                       fx=c["fx"], fy=c["fy"], cx=c["cx"], cy=c["cy"],
                       distortion=tuple(c["distortion"]),
                       sfm=SfmParams(max_points=c["max_points"],
                                     points_quality=c["points_quality"]),
                       bad_image_threshold=c["bad_image_threshold"])


def port_model(cfg: dict, root):
    """(geometry, flax parameter tree) through the port's loader, checked
    against the configuration's widths."""
    from depth_estimation_tpu_torch.models import io
    geom, _, params, _ = io.load_model(str(root / cfg["checkpoint"]))
    g = cfg["geometry"]
    got = dict(hImg=geom.hImg, wImg=geom.wImg, maxh=geom.maxh,
               maxw=geom.maxw, layers=[list(l) for l in geom.layers])
    want = dict(hImg=g["hImg"], wImg=g["wImg"], maxh=g["maxh"],
                maxw=g["maxw"], layers=g["layers"])
    if got != want:
        raise ValueError(f"checkpoint {got} is not the configuration {want}")
    return geom, params


def ref_model(cfg: dict, root, device) -> ref.Model:
    """The reference's model: the checkpoint read by its own reader."""
    import torch
    layers, weights = checkpoint.load_trunk(str(root / cfg["checkpoint"]))
    g = cfg["geometry"]
    return ref.Model(layers, [(torch.from_numpy(w).to(device),
                               torch.from_numpy(b).to(device))
                              for w, b in weights],
                     g["hImg"], g["wImg"], g["maxh"], g["maxw"])


def gumbel(gen, n_samples: int, n: int):
    """(n_samples, 8, n) standard Gumbel noise on the generator's device:
    RANSAC's draws, the same for the program and the reference."""
    import torch
    u = torch.rand((n_samples, 8, n), generator=gen, device=gen.device)
    tiny = torch.finfo(torch.float32).tiny
    return -torch.log(-torch.log(u.clamp(tiny, 1.0 - 2 ** -24)))


def trunk_work(layers):
    """Span work of the conv trunk: its input (..., H, W, C)."""
    def work(args, kwargs):
        x = args[1] if len(args) > 1 else kwargs["x"]
        B = 1
        for s in x.shape[:-3]:
            B *= int(s)
        return counts.trunk_work(layers, B, int(x.shape[-3]), int(x.shape[-2]))
    return work


def b1_work(args, kwargs):
    """Span work of ``match_flow_fused(f1, f2, maxh, maxw, ...)``: f1 and
    f2 read once in their storage type, idx, ey, ex, pmax and the gate
    written once."""
    f1, f2, maxh, maxw = args[:4]
    s1 = tuple(f1.shape) if f1.ndim == 4 else (1,) + tuple(f1.shape)
    s2 = tuple(f2.shape) if f2.ndim == 4 else (1,) + tuple(f2.shape)
    dt = args[6] if len(args) > 6 else kwargs.get("dtype")
    elem = 2 if dt is not None and dt.itemsize == 2 else 4
    return counts.matcher_work(s1, s2, elem, maxh, maxw, 5,
                               counts.b1_flops_per_cell(s1[-1]))


def model_flops(layers, B: int, h: int, w: int, maxh: int, maxw: int) -> int:
    """Model FLOPs of one online step on B streams: the trunk on each new
    frame and the matcher's window cells."""
    k = sum(l[1] - 1 for l in layers), sum(l[2] - 1 for l in layers)
    H, W = h - k[0] - maxh + 1, w - k[1] - maxw + 1
    return (counts.trunk_flops(layers, B, h, w)
            + B * H * W * maxh * maxw * counts.b1_flops_per_cell(layers[-1][3]))
