"""Image sources and conversions (port of ``depth_estimation_tpu.data.images``).

  * ``load_image`` reads a frame file as (H, W, 3) float32 in [0, 1]. PNG
    is decoded here with the standard library's zlib (8-bit gray, gray +
    alpha, palette, RGB and RGBA, not interlaced, the five row filters),
    as PIL decodes it; JPEG goes through PIL, which a machine may lack.
    ``encode_png`` writes 8-bit gray or RGB PNG the same way.
  * Resizing: ``jax.image.resize``'s bilinear method is an antialiased
    triangle kernel (stretched by the downscale factor, edge-clamped,
    normalized), which ``F.interpolate`` does not reproduce.
    ``_resize_operator`` builds that kernel as an (n_out, n_in) matrix per
    axis, and a resize is two matrix products with it: on the device
    (``scale``, ``scale_batched_device``) or on the host in numpy
    (``scale_np``, bit-equal to the JAX package's).
  * ``ImageLoader`` walks a numbered ``images/%09d.{jpg,png}`` sequence;
    ``ImageCamera`` is the live source: V4L2 capture when given a device
    path (``data/v4l2.py``), frames pushed by the caller otherwise.
"""

from __future__ import annotations

import os
import struct
import zlib
from functools import lru_cache
from typing import Optional

import numpy as np
import torch


# ---------------------------------------------------------------------------
# Image files
# ---------------------------------------------------------------------------

_PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}   # by colour type


def _unfilter_row(ftype: int, line: np.ndarray, prev: np.ndarray,
                  bpp: int) -> np.ndarray:
    """One PNG row with its filter undone. line, prev: (stride,) uint8."""
    if ftype == 0:
        return line
    if ftype == 2:                                       # up
        return line + prev                               # wraps mod 256
    if ftype == 1:                                       # sub: a running sum
        s = np.cumsum(line.reshape(-1, bpp).astype(np.int64), axis=0)
        return (s & 0xFF).astype(np.uint8).reshape(-1)
    if ftype not in (3, 4):
        raise ValueError(f"PNG row filter {ftype} unknown")
    # average and paeth read the byte decoded bpp to the left: a byte at a
    # time, in plain Python (faster than numpy on single bytes)
    cur = bytearray(line.tobytes())
    up = prev.tobytes()
    for x in range(len(cur)):
        a = cur[x - bpp] if x >= bpp else 0
        b = up[x]
        if ftype == 3:
            pred = (a + b) >> 1
        else:
            c = up[x - bpp] if x >= bpp else 0
            p = a + b - c
            pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
            pred = a if pa <= pb and pa <= pc else (b if pb <= pc else c)
        cur[x] = (cur[x] + pred) & 0xFF
    return np.frombuffer(bytes(cur), np.uint8)


def _unfilter(raw: bytes, h: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the PNG row filters: raw holds h rows of a filter byte and
    ``stride`` bytes. Returns (h, stride) uint8."""
    rows = np.frombuffer(raw, np.uint8)[: h * (stride + 1)]
    if rows.size != h * (stride + 1):
        raise ValueError("PNG image data truncated")
    rows = rows.reshape(h, stride + 1)
    out = np.empty((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        prev = out[y] = _unfilter_row(int(rows[y, 0]), rows[y, 1:], prev, bpp)
    return out


def decode_png(data: bytes) -> np.ndarray:
    """PNG bytes -> (H, W, 3) uint8 RGB, as PIL's ``convert("RGB")`` gives:
    gray replicated, alpha dropped, palette looked up. 8-bit samples,
    not interlaced."""
    if data[:8] != _PNG_SIGNATURE:
        raise ValueError("not a PNG file")
    pos, idat, palette, header = 8, [], None, None
    while pos + 8 <= len(data):
        n, kind = struct.unpack(">I4s", data[pos:pos + 8])
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if kind == b"IHDR":
            header = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if header is None:
        raise ValueError("PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = header
    if depth != 8 or ctype not in _PNG_CHANNELS or interlace:
        raise ValueError(f"PNG of bit depth {depth}, colour type {ctype}, "
                         f"interlace {interlace} is not supported")
    ch = _PNG_CHANNELS[ctype]
    px = _unfilter(zlib.decompress(b"".join(idat)), h, w * ch, ch)
    px = px.reshape(h, w, ch)
    if ctype == 3:
        if palette is None:
            raise ValueError("palette PNG without PLTE")
        return palette[px[..., 0]]
    if ch <= 2:                                        # gray (+ alpha)
        return np.repeat(px[..., :1], 3, axis=-1)
    return np.ascontiguousarray(px[..., :3])


def encode_png(img: np.ndarray) -> bytes:
    """(H, W) or (H, W, 3) uint8 -> PNG bytes (8-bit gray or RGB,
    unfiltered rows, zlib), the inverse of ``decode_png``."""
    img = np.ascontiguousarray(img, np.uint8)
    if img.ndim == 2:
        ctype = 0
    elif img.ndim == 3 and img.shape[2] == 3:
        ctype = 2
    else:
        raise ValueError(f"image of shape {img.shape}: (H, W) or (H, W, 3)")
    h, w = img.shape[:2]
    raw = b"".join(b"\x00" + img[y].tobytes() for y in range(h))

    def chunk(kind: bytes, body: bytes) -> bytes:
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))
    return (_PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(raw, 6)) + chunk(b"IEND", b""))


def load_image(path: str) -> np.ndarray:
    """Load an image file -> (H, W, 3) float32 in [0, 1] (channels-last).
    PNG is decoded here; other formats need PIL."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] == _PNG_SIGNATURE:
        rgb = decode_png(data)
    else:
        try:
            from PIL import Image
        except ImportError as e:
            raise RuntimeError(
                f"{path}: only PNG decodes without PIL, which is not "
                "installed") from e
        rgb = np.asarray(Image.open(path).convert("RGB"))
    return np.asarray(rgb, np.float32) / 255.0


def _resize_operator(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of jax.image.resize's antialiased linear kernel
    along one axis."""
    s = n_out / n_in
    x = (np.arange(n_out) + 0.5) / s - 0.5
    j = np.arange(n_in)
    w = np.maximum(0.0, 1.0 - np.abs(j[None, :] - x[:, None]) * min(s, 1.0))
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


@lru_cache(maxsize=32)
def _operators(H: int, h: int, W: int, w: int, device: str):
    return (torch.from_numpy(_resize_operator(H, h)).to(device),
            torch.from_numpy(_resize_operator(W, w)).to(device))


def scale_batched_device(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Batched bilinear resize (B, H, W, C) -> (B, h, w, C) as two separable
    matrix products with the triangle-kernel operators."""
    H, W = frames.shape[1:3]
    if (H, W) == (h, w):
        return frames
    if torch.compiler.is_compiling():
        # a trace (torch.export) makes its own constants: a tensor it
        # created must not enter the cache that eager calls read
        R, C = (torch.from_numpy(a).to(frames.device)
                for a in _np_operators(H, h, W, w))
    else:
        R, C = _operators(H, h, W, w, str(frames.device))
    t = torch.einsum("hH,bHWc->bhWc", R, frames)
    return torch.einsum("wW,bhWc->bhwc", C, t)


def scale(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """Single-image bilinear resize (H, W, C) -> (h, w, C), the kernel of
    jax.image.resize's bilinear method."""
    return scale_batched_device(img[None], h, w)[0]


@lru_cache(maxsize=32)
def _np_operators(H: int, h: int, W: int, w: int):
    return _resize_operator(H, h), _resize_operator(W, w)


def scale_np(img: np.ndarray, h: int, w: int) -> np.ndarray:
    """Host bilinear resize with the same operators, two BLAS products.
    (H, W[, C]) -> (h, w[, C]); uint8 in -> uint8 out (rounded), float32
    stays float32."""
    H, W = img.shape[:2]
    R, C = _np_operators(H, h, W, w)
    was_u8 = img.dtype == np.uint8
    x = img.astype(np.float32)
    if x.ndim == 2:
        x = x[..., None]
    flat = x.reshape(H, -1)                          # (H, W*C)
    x = (R @ flat).reshape(h, W, -1)                 # rows
    # columns through a transpose round trip: (h*C, W) @ C.T
    xt = np.ascontiguousarray(x.transpose(0, 2, 1)).reshape(-1, W)
    x = (xt @ C.T).reshape(h, -1, w).transpose(0, 2, 1)
    if was_u8:
        return np.clip(x + 0.5, 0, 255).astype(np.uint8)
    return x if img.ndim == 3 else x[..., 0]


def rgb2y(img: torch.Tensor) -> torch.Tensor:
    """Luma (torch image.rgb2y weights): (..., 3) -> (..., 1)."""
    w = torch.tensor([0.299, 0.587, 0.114], dtype=img.dtype, device=img.device)
    return (img[..., :3] * w).sum(-1, keepdim=True)


class ImageLoader:
    """Sequential frame source over numbered files
    ``<directory>/images/<pattern>.{jpg,png}``, resized on the host to
    (h, w) where they differ."""

    def __init__(self, directory: str, h: int, w: int,
                 first: int = 0, pattern: str = "%09d"):
        self.dir = directory
        self.h, self.w = h, w
        self.i = first
        self.pattern = pattern

    def _path(self, i: int) -> Optional[str]:
        for ext in (".jpg", ".png"):
            p = os.path.join(self.dir, "images", (self.pattern % i) + ext)
            if os.path.exists(p):
                return p
        return None

    def get_next_frame(self) -> Optional[np.ndarray]:
        p = self._path(self.i)
        if p is None:
            return None
        self.i += 1
        img = load_image(p)
        if img.shape[:2] != (self.h, self.w):
            img = scale_np(img, self.h, self.w)
        return img


class ImageCamera:
    """Live camera source: V4L2 capture at 640x480 (NTSC), one buffered
    frame dropped before each read (latency flush), then a vertical center
    crop to the target aspect ratio and a host resize to (h, w).

    Pass ``device`` (e.g. "/dev/video0") for real capture (``data/v4l2.py``);
    without a device, frames are given with ``push`` (the source the tests
    and the simulator loop use)."""

    def __init__(self, h: int, w: int, device: Optional[str] = None,
                 capture_w: int = 640, capture_h: int = 480):
        self.h, self.w = h, w
        self._queue: list = []
        self._cam = None
        if device is not None:
            from .v4l2 import V4L2Camera
            self._cam = V4L2Camera(device, capture_w, capture_h)

    def push(self, frame: np.ndarray) -> None:
        self._queue.append(frame)

    def _center_crop_aspect(self, frame: np.ndarray) -> np.ndarray:
        """Crop rows so that the frame has the target aspect ratio."""
        fh, fw = frame.shape[:2]
        target_h = int(round(self.h * fw / self.w))
        if target_h < fh:
            top = (fh - target_h) // 2
            frame = frame[top:top + target_h]
        return frame

    def get_next_frame(self) -> Optional[np.ndarray]:
        if self._cam is not None:
            self._cam.read()
            img = self._center_crop_aspect(self._cam.read())
        else:
            if not self._queue:
                return None
            img = self._center_crop_aspect(self._queue.pop(0))
        if img.shape[:2] != (self.h, self.w):
            img = scale_np(img, self.h, self.w)
        return img

    def close(self) -> None:
        if self._cam is not None:
            self._cam.close()
            self._cam = None
