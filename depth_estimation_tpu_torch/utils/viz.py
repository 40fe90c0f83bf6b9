"""Visualization: flow -> HSV panels, kernels, flow colour wheels, image
and video files (port of ``depth_estimation_tpu.utils.viz``; host numpy).

``save_image`` writes PNG with the standard library's zlib
(``data.images.encode_png``), so it needs no PIL; ``export_video`` tries
ffmpeg, then an animated GIF through PIL where PIL is installed.
"""

from __future__ import annotations

import math
import os
import subprocess

import numpy as np


def flow2hsv(geom, flow: np.ndarray) -> np.ndarray:
    """(2, H, W) flow -> (3, H, W) RGB via hue=direction, sat=1,
    val=magnitude/max (score_opticalflow.lua:13-25)."""
    flow = np.asarray(flow)
    maxh = getattr(geom, "maxh", 16)
    maxw = getattr(geom, "maxw", 16)
    angle = np.arctan2(flow[0], flow[1])
    h = np.mod(angle / (2 * math.pi), 1.0)
    norm = np.sqrt(flow[0] ** 2 + flow[1] ** 2)
    v = np.clip(norm / max(math.ceil(maxh / 2), math.ceil(maxw / 2)), 0, 1)
    hsv = np.stack([h, np.ones_like(h), v])
    return hsv_to_rgb(hsv)


def hsv_to_rgb(hsv: np.ndarray) -> np.ndarray:
    h, s, v = hsv[0], hsv[1], hsv[2]
    i = np.floor(h * 6).astype(int) % 6
    f = h * 6 - np.floor(h * 6)
    p = v * (1 - s)
    q = v * (1 - f * s)
    t = v * (1 - (1 - f) * s)
    r = np.choose(i, [v, q, p, p, t, v])
    g = np.choose(i, [t, v, v, q, p, p])
    b = np.choose(i, [p, p, t, v, v, q])
    return np.stack([r, g, b])


def kernels_image(kernel: np.ndarray, pad: int = 1) -> np.ndarray:
    """Tile conv kernels (kh, kw, cin, cout) into one grid image for display
    (display_opticalflow.lua:62-69)."""
    kh, kw, cin, cout = kernel.shape
    n = cin * cout
    cols = int(math.ceil(math.sqrt(n)))
    rows = int(math.ceil(n / cols))
    canvas = np.zeros((rows * (kh + pad), cols * (kw + pad)), np.float32)
    k = kernel.transpose(2, 3, 0, 1).reshape(n, kh, kw)
    k = (k - k.min()) / max(k.max() - k.min(), 1e-9)
    for idx in range(n):
        r, c = divmod(idx, cols)
        canvas[r * (kh + pad):r * (kh + pad) + kh,
               c * (kw + pad):c * (kw + pad) + kw] = k[idx]
    return canvas


def middlebury_wheel() -> np.ndarray:
    """The standard Middlebury optical-flow color wheel (55 colors) used by
    Liu's flowToColor."""
    RY, YG, GC, CB, BM, MR = 15, 6, 4, 11, 13, 6
    n = RY + YG + GC + CB + BM + MR
    wheel = np.zeros((n, 3))
    c = 0
    wheel[c:c + RY, 0] = 255
    wheel[c:c + RY, 1] = np.floor(255 * np.arange(RY) / RY); c += RY
    wheel[c:c + YG, 0] = 255 - np.floor(255 * np.arange(YG) / YG)
    wheel[c:c + YG, 1] = 255; c += YG
    wheel[c:c + GC, 1] = 255
    wheel[c:c + GC, 2] = np.floor(255 * np.arange(GC) / GC); c += GC
    wheel[c:c + CB, 1] = 255 - np.floor(255 * np.arange(CB) / CB)
    wheel[c:c + CB, 2] = 255; c += CB
    wheel[c:c + BM, 2] = 255
    wheel[c:c + BM, 0] = np.floor(255 * np.arange(BM) / BM); c += BM
    wheel[c:c + MR, 2] = 255 - np.floor(255 * np.arange(MR) / MR)
    wheel[c:c + MR, 0] = 255
    return wheel


def flow_to_color_middlebury(u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Middlebury flow colorization (Liu flowToColor semantics): hue =
    direction via the 55-color wheel, saturation = radius / max radius.
    Returns (H, W, 3) uint8."""
    u = np.asarray(u, np.float64)
    v = np.asarray(v, np.float64)
    rad = np.sqrt(u * u + v * v)
    maxrad = max(float(rad.max()), 1e-9)
    un, vn, radn = u / maxrad, v / maxrad, rad / maxrad
    wheel = middlebury_wheel()
    n = wheel.shape[0]
    a = np.arctan2(-vn, -un) / np.pi
    fk = (a + 1) / 2 * (n - 1)
    k0 = np.floor(fk).astype(int)
    k1 = (k0 + 1) % n
    f = fk - k0
    img = np.zeros(u.shape + (3,), np.uint8)
    for ch in range(3):
        col0 = wheel[k0, ch] / 255
        col1 = wheel[k1, ch] / 255
        col = (1 - f) * col0 + f * col1
        col = 1 - radn * (1 - col)
        img[..., ch] = np.floor(255 * col)
    return img


def color_to_flow_direction(img: np.ndarray):
    """Inverse of the wheel's hue mapping: per-pixel unit flow direction
    (ux, uy) and a saturation proxy, for comparing against rendered flow
    images whose normalization is unknown."""
    rgb = np.asarray(img, np.float64) / 255.0
    mx = rgb.max(-1)
    mn = rgb.min(-1)
    sat = mx - mn                      # distance from white ~ radius
    wheel = middlebury_wheel() / 255.0
    n = wheel.shape[0]
    # angle of each wheel entry
    ks = np.arange(n)
    angs = (2.0 * ks / (n - 1) - 1.0) * np.pi      # a*pi where fk=k
    # match each pixel to the nearest wheel hue (chroma-normalized)
    chroma = rgb - mn[..., None]
    cn = chroma / np.maximum(sat[..., None], 1e-9)
    wmin = wheel.min(-1, keepdims=True)
    wnorm = (wheel - wmin) / np.maximum(wheel.max(-1, keepdims=True) - wmin,
                                        1e-9)
    d = ((cn[..., None, :] - wnorm[None, None]) ** 2).sum(-1)
    k = np.argmin(d, axis=-1)
    a = angs[k]
    # a = atan2(-v, -u): invert
    return -np.cos(a), -np.sin(a), sat


def save_image(path: str, img) -> None:
    """img: (3, H, W) or (H, W) float in [0, 1] (a numpy array or a tensor
    on any device). A ``.png`` path is written by the package's own PNG
    encoder (gray or RGB); other formats need PIL."""
    from ..data.images import encode_png
    from .device import host
    a = host(img)
    if a.ndim == 3:
        a = a.transpose(1, 2, 0)
    a = (np.clip(a, 0, 1) * 255).astype(np.uint8)
    if path.lower().endswith(".png"):
        with open(path, "wb") as fh:
            fh.write(encode_png(a))
        return
    from PIL import Image
    Image.fromarray(a).save(path)


def export_video(frame_dir: str, out_path: str, fps: int = 10,
                 pattern: str = "%09d.png") -> bool:
    """ffmpeg export of the numbered frames. Without ffmpeg, an animated GIF
    next to ``out_path`` through PIL where PIL is installed. Returns False
    only when neither export produced a file."""
    try:
        subprocess.run(
            ["ffmpeg", "-y", "-r", str(fps), "-i",
             os.path.join(frame_dir, pattern), out_path],
            check=True, capture_output=True)
        return True
    except (FileNotFoundError, subprocess.CalledProcessError):
        pass
    try:
        from PIL import Image
        frames = sorted(
            f for f in os.listdir(frame_dir) if f.endswith(".png"))
        if not frames:
            return False
        imgs = [Image.open(os.path.join(frame_dir, f)) for f in frames]
        gif_path = os.path.splitext(out_path)[0] + ".gif"
        imgs[0].save(gif_path, save_all=True, append_images=imgs[1:],
                     duration=int(1000 / fps), loop=0)
        return True
    except Exception:
        return False
