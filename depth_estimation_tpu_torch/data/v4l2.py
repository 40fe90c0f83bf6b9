"""V4L2 webcam capture via raw ioctls (ctypes + mmap, no external deps);
port of ``depth_estimation_tpu.data.v4l2``.

The capture backend behind ``data.images.ImageCamera`` (640x480, NTSC).
This module speaks the V4L2 streaming-I/O protocol directly: S_FMT (YUYV),
S_STD (NTSC), REQBUFS (memory-mapped), QBUF/STREAMON, then DQBUF per frame
with YUYV -> RGB conversion in numpy.

Struct layouts match the 64-bit Linux UAPI (videodev2.h); ioctl codes are
computed from the ctypes sizes so they stay consistent with the structs
defined here.
"""

from __future__ import annotations

import ctypes
import fcntl
import mmap as _mmap
import os
from typing import Optional

import numpy as np

# ---------------------------------------------------------------------------
# UAPI structs (64-bit layouts)
# ---------------------------------------------------------------------------


class v4l2_pix_format(ctypes.Structure):
    _fields_ = [
        ("width", ctypes.c_uint32),
        ("height", ctypes.c_uint32),
        ("pixelformat", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("bytesperline", ctypes.c_uint32),
        ("sizeimage", ctypes.c_uint32),
        ("colorspace", ctypes.c_uint32),
        ("priv", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("ycbcr_enc", ctypes.c_uint32),
        ("quantization", ctypes.c_uint32),
        ("xfer_func", ctypes.c_uint32),
    ]


class v4l2_format(ctypes.Structure):
    # the fmt union holds v4l2_window (pointers) in the kernel -> 8-aligned,
    # 200 bytes; explicit pad reproduces the 64-bit layout (sizeof == 208)
    _fields_ = [
        ("type", ctypes.c_uint32),
        ("_pad", ctypes.c_uint32),
        ("pix", v4l2_pix_format),
        ("_raw", ctypes.c_ubyte * (200 - ctypes.sizeof(v4l2_pix_format))),
    ]


class v4l2_requestbuffers(ctypes.Structure):
    _fields_ = [
        ("count", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("capabilities", ctypes.c_uint32),
        ("flags", ctypes.c_uint8),
        ("reserved", ctypes.c_uint8 * 3),
    ]


class _timeval(ctypes.Structure):
    _fields_ = [("tv_sec", ctypes.c_long), ("tv_usec", ctypes.c_long)]


class _timecode(ctypes.Structure):
    _fields_ = [
        ("type", ctypes.c_uint32), ("flags", ctypes.c_uint32),
        ("frames", ctypes.c_uint8), ("seconds", ctypes.c_uint8),
        ("minutes", ctypes.c_uint8), ("hours", ctypes.c_uint8),
        ("userbits", ctypes.c_uint8 * 4),
    ]


class _buf_m(ctypes.Union):
    _fields_ = [
        ("offset", ctypes.c_uint32),
        ("userptr", ctypes.c_ulong),
        ("fd", ctypes.c_int32),
    ]


class v4l2_buffer(ctypes.Structure):
    _fields_ = [
        ("index", ctypes.c_uint32),
        ("type", ctypes.c_uint32),
        ("bytesused", ctypes.c_uint32),
        ("flags", ctypes.c_uint32),
        ("field", ctypes.c_uint32),
        ("_pad", ctypes.c_uint32),          # timeval is 8-aligned
        ("timestamp", _timeval),
        ("timecode", _timecode),
        ("sequence", ctypes.c_uint32),
        ("memory", ctypes.c_uint32),
        ("m", _buf_m),
        ("length", ctypes.c_uint32),
        ("reserved2", ctypes.c_uint32),
        ("request_fd", ctypes.c_uint32),
        ("_pad2", ctypes.c_uint32),
    ]


# ioctl code construction (asm-generic/ioctl.h)
_IOC_WRITE, _IOC_READ = 1, 2


def _ioc(dirs: int, nr: int, size: int) -> int:
    return (dirs << 30) | (size << 16) | (ord("V") << 8) | nr


def _iowr(nr: int, struct) -> int:
    return _ioc(_IOC_READ | _IOC_WRITE, nr, ctypes.sizeof(struct))


def _iow(nr: int, struct) -> int:
    return _ioc(_IOC_WRITE, nr, ctypes.sizeof(struct))


VIDIOC_S_FMT = _iowr(5, v4l2_format)
VIDIOC_REQBUFS = _iowr(8, v4l2_requestbuffers)
VIDIOC_QUERYBUF = _iowr(9, v4l2_buffer)
VIDIOC_QBUF = _iowr(15, v4l2_buffer)
VIDIOC_DQBUF = _iowr(17, v4l2_buffer)
VIDIOC_STREAMON = _iow(18, ctypes.c_int)
VIDIOC_STREAMOFF = _iow(19, ctypes.c_int)
VIDIOC_S_STD = _iow(24, ctypes.c_uint64)

V4L2_BUF_TYPE_VIDEO_CAPTURE = 1
V4L2_MEMORY_MMAP = 1
V4L2_FIELD_INTERLACED = 4
V4L2_PIX_FMT_YUYV = ord("Y") | (ord("U") << 8) | (ord("Y") << 16) | (ord("V") << 24)
V4L2_STD_NTSC = 0x0000B000  # NTSC-M | NTSC-M-JP | NTSC-443 | NTSC-M-KR


def yuyv_to_rgb(raw: np.ndarray, h: int, w: int) -> np.ndarray:
    """YUYV 4:2:2 -> RGB float32 in [0, 1] (BT.601 full-range). raw: uint8
    buffer of 2*h*w bytes."""
    a = np.frombuffer(raw, np.uint8, count=2 * h * w).reshape(h, w // 2, 4)
    y = a[..., 0::2].reshape(h, w).astype(np.float32)
    u = np.repeat(a[..., 1], 2, axis=1).astype(np.float32) - 128.0
    v = np.repeat(a[..., 3], 2, axis=1).astype(np.float32) - 128.0
    r = y + 1.402 * v
    g = y - 0.344136 * u - 0.714136 * v
    b = y + 1.772 * u
    return np.clip(np.stack([r, g, b], axis=-1) / 255.0, 0.0, 1.0)


class V4L2Camera:
    """Memory-mapped V4L2 streaming capture. Raises OSError if the device
    cannot be opened or does not accept the requested format."""

    def __init__(self, device: str = "/dev/video0", width: int = 640,
                 height: int = 480, n_buffers: int = 2,
                 standard: Optional[int] = V4L2_STD_NTSC):
        self.fd = os.open(device, os.O_RDWR)
        self.maps: list = []
        try:
            if standard is not None:
                try:
                    fcntl.ioctl(self.fd, VIDIOC_S_STD,
                                ctypes.c_uint64(standard))
                except OSError:
                    pass  # digital (USB) cameras reject analog standards

            fmt = v4l2_format()
            fmt.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            fmt.pix.width = width
            fmt.pix.height = height
            fmt.pix.pixelformat = V4L2_PIX_FMT_YUYV
            fmt.pix.field = V4L2_FIELD_INTERLACED
            fcntl.ioctl(self.fd, VIDIOC_S_FMT, fmt)
            if fmt.pix.pixelformat != V4L2_PIX_FMT_YUYV:
                raise OSError("device does not support YUYV capture")
            self.width = int(fmt.pix.width)
            self.height = int(fmt.pix.height)

            req = v4l2_requestbuffers()
            req.count = n_buffers
            req.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
            req.memory = V4L2_MEMORY_MMAP
            fcntl.ioctl(self.fd, VIDIOC_REQBUFS, req)
            for i in range(req.count):
                buf = v4l2_buffer()
                buf.index = i
                buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
                buf.memory = V4L2_MEMORY_MMAP
                fcntl.ioctl(self.fd, VIDIOC_QUERYBUF, buf)
                self.maps.append(_mmap.mmap(
                    self.fd, buf.length, _mmap.MAP_SHARED,
                    _mmap.PROT_READ | _mmap.PROT_WRITE,
                    offset=buf.m.offset))
                fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
            fcntl.ioctl(self.fd, VIDIOC_STREAMON,
                        ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except Exception:
            self.close()
            raise

    def read(self) -> np.ndarray:
        """Dequeue one frame -> (H, W, 3) float32 RGB, re-queue the buffer."""
        buf = v4l2_buffer()
        buf.type = V4L2_BUF_TYPE_VIDEO_CAPTURE
        buf.memory = V4L2_MEMORY_MMAP
        fcntl.ioctl(self.fd, VIDIOC_DQBUF, buf)
        m = self.maps[buf.index]
        m.seek(0)
        raw = np.frombuffer(m.read(2 * self.height * self.width), np.uint8)
        fcntl.ioctl(self.fd, VIDIOC_QBUF, buf)
        return yuyv_to_rgb(raw, self.height, self.width)

    def close(self) -> None:
        try:
            fcntl.ioctl(self.fd, VIDIOC_STREAMOFF,
                        ctypes.c_int(V4L2_BUF_TYPE_VIDEO_CAPTURE))
        except OSError:
            pass
        for m in self.maps:
            try:
                m.close()
            except Exception:
                pass
        self.maps = []
        if self.fd >= 0:
            os.close(self.fd)
            self.fd = -1
