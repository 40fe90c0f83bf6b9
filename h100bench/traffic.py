"""The benchmark's traffic: camera frames made from a seed.

One general generator, driven by the parameters of a mix file
(``traffic/<mix>.json``): a camera stepping forward through a scene of
smoothly varying depth. Frame k of a stream samples a smooth random
texture at c + (p - c)(1 - s(p))^k, with s(p) a smooth per-pixel step
between ``zoom`` [lo, hi] (a nearer surface flows faster), so that every
step sees new content and a determined motion: a pure pan would leave the
essential matrix undetermined. At the 320x180 working size the flow
reaches 2-4 px at the edges, inside a 16x16 window.

Also here, copied so that a change to the program's own data code cannot
move the traffic: ``forward_frames`` and ``working_frames`` (the style
the port's chip checks use), with a plain resize of the benchmark's own (``resize_operator``: the triangle kernel of
``jax.image.resize``'s bilinear method, as separable matrix products).

Streams advance in lockstep through a ping-pong sequence of ``frames``
frames (0, 1, ..., n-1, n-2, ..., 1, 0, 1, ...), so a run of any length
keeps to a fixed set of pairs: ``ping_pong``.
"""

from __future__ import annotations

import numpy as np
import torch


def resize_operator(n_in: int, n_out: int) -> np.ndarray:
    """(n_out, n_in) matrix of the antialiased linear (triangle) kernel
    along one axis."""
    s = n_out / n_in
    x = (np.arange(n_out) + 0.5) / s - 0.5
    j = np.arange(n_in)
    w = np.maximum(0.0, 1.0 - np.abs(j[None, :] - x[:, None]) * min(s, 1.0))
    w /= np.maximum(w.sum(axis=1, keepdims=True), 1e-12)
    return w.astype(np.float32)


def resize(frames: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """(B, H, W[, C]) float -> (B, h, w[, C]), two separable products."""
    squeeze = frames.ndim == 3
    if squeeze:
        frames = frames[..., None]
    H, W = frames.shape[1:3]
    R = torch.from_numpy(resize_operator(H, h)).to(frames.device)
    C = torch.from_numpy(resize_operator(W, w)).to(frames.device)
    t = torch.einsum("hH,bHWc->bhWc", R, frames)
    out = torch.einsum("wW,bhWc->bhwc", C, t)
    return out[..., 0] if squeeze else out


def ping_pong(t: int, n: int) -> int:
    """The frame a stream shows at step t of a ping-pong sequence of n."""
    p = t % (2 * (n - 1))
    return p if p < n else 2 * (n - 1) - p


def device_generator(seed: int, device) -> torch.Generator:
    """A generator on ``device`` seeded from any whole number (the seed may
    exceed 64 bits' signed range)."""
    return torch.Generator(device=device).manual_seed(int(seed) % (2 ** 63))


def _bilinear_u8(base: torch.Tensor, xs: torch.Tensor, ys: torch.Tensor
                 ) -> torch.Tensor:
    """base (B, H, W, 3) in [0, 1] sampled bilinearly at (ys, xs) (B, H, W),
    clamped to the frame, as uint8."""
    B, H, W, _ = base.shape
    xs, ys = xs.clamp(0, W - 1), ys.clamp(0, H - 1)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=W - 1), (y0 + 1).clamp(max=H - 1)
    flat = base.reshape(B, -1, 3)

    def at(yi, xi):
        idx = (yi * W + xi).reshape(B, -1, 1).expand(-1, -1, 3)
        return torch.gather(flat, 1, idx).reshape(B, H, W, 3)
    img = ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x1))
           + fy * ((1 - fx) * at(y1, x0) + fx * at(y1, x1)))
    return (img.clamp(0, 1) * 255).to(torch.uint8)


def camera_streams(gen: torch.Generator, streams: int, frames: int,
                   hw=(480, 640), texture=(120, 160), depth_grid=(3, 4),
                   zoom=(0.01, 0.02), chunk: int = 128) -> torch.Tensor:
    """(frames, streams, H, W, 3) uint8 frames on the generator's device:
    each stream a forward camera walk (see the module's docstring), so that
    one step's frames are one contiguous block. Made ``chunk`` streams at
    a time, in a few large calls each."""
    dev = gen.device
    H, W = hw
    out = torch.empty((frames, streams, H, W, 3), dtype=torch.uint8,
                      device=dev)
    yy = torch.arange(H, dtype=torch.float32, device=dev)[:, None]
    xx = torch.arange(W, dtype=torch.float32, device=dev)[None, :]
    cy, cx = H / 2.0, W / 2.0
    for a in range(0, streams, chunk):
        b = min(streams, a + chunk)
        n = b - a
        base = resize(torch.rand((n,) + tuple(texture) + (3,), generator=gen,
                                 device=dev), H, W)
        coarse = torch.rand((n,) + tuple(depth_grid), generator=gen,
                            device=dev)
        s = zoom[0] + (zoom[1] - zoom[0]) * resize(coarse, H, W)
        shrink = 1.0 - s
        scale = torch.ones_like(s)
        for k in range(frames):
            out[k, a:b] = _bilinear_u8(base, cx + (xx - cx) * scale,
                                       cy + (yy - cy) * scale)
            scale = scale * shrink
    return out


def forward_frames(gen: torch.Generator, B: int, dev) -> tuple:
    """B uint8 640x480 frame pairs, made on ``dev``: a smooth random
    texture, and the view after the camera moves forward through a scene
    of smoothly varying depth (a forward step over depth of 1-2% across
    the frame, so flow grows to 3-6 px at the edges)."""
    base = torch.rand(B, 120, 160, 3, generator=gen, device=dev)
    t1 = resize(base, 480, 640)
    coarse = torch.rand(B, 3, 4, 1, generator=gen, device=dev)
    s = 0.01 + 0.01 * resize(coarse, 480, 640)[..., 0]
    yy = torch.arange(480.0, device=dev)[:, None]
    xx = torch.arange(640.0, device=dev)[None, :]
    xs = (xx - (xx - 320.0) * s).clamp(0, 639)
    ys = (yy - (yy - 240.0) * s).clamp(0, 479)
    return (t1.clamp(0, 1) * 255).to(torch.uint8), _bilinear_u8(t1, xs, ys)


def working_frames(gen: torch.Generator, B: int, h: int, w: int, dev
                   ) -> tuple:
    """B pairs of ``forward_frames``, normalised and resized to h x w."""
    t1, t2 = forward_frames(gen, B, dev)
    return (resize(t1.float() / 255.0, h, w),
            resize(t2.float() / 255.0, h, w))
