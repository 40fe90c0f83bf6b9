"""The port's host-side display and capture helpers against the JAX
package: ``utils/viz.py`` (flow colourings, kernel tiles, PNG and video
files), ``utils/viewer.py`` (the headless viewer), ``data/images.py``'s PNG
encoder and ``ImageCamera``, and ``data/v4l2.py``'s structs and YUYV
conversion. All host numpy: every comparison is bit-equal.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np
import pytest
import torch
from PIL import Image

from depth_estimation_tpu.data import images as jimages
from depth_estimation_tpu.data import v4l2 as jv4l2
from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu.utils import viewer as jviewer
from depth_estimation_tpu.utils import viz as jviz
from depth_estimation_tpu_torch.data import images as timages
from depth_estimation_tpu_torch.data import v4l2 as tv4l2
from depth_estimation_tpu_torch.utils import viewer as tviewer
from depth_estimation_tpu_torch.utils import viz as tviz


@pytest.fixture(scope="module")
def flow():
    rng = np.random.RandomState(0)
    return (rng.randn(2, 17, 23) * 4).astype(np.float32)


@pytest.mark.parametrize("shape", [(3, 21, 34), (21, 34), (3, 1, 1)])
def test_save_image_png_equals_jax(tmp_path, shape):
    rng = np.random.RandomState(1)
    img = (rng.rand(*shape) * 1.4 - 0.2).astype(np.float32)
    ours, ref = str(tmp_path / "ours.png"), str(tmp_path / "ref.png")
    tviz.save_image(ours, torch.from_numpy(img))
    jviz.save_image(ref, img)
    a, b = np.asarray(Image.open(ours)), np.asarray(Image.open(ref))
    assert a.dtype == b.dtype == np.uint8
    np.testing.assert_array_equal(a, b)
    with open(ours, "rb") as fh:
        rgb = timages.decode_png(fh.read())
    want = b if b.ndim == 3 else np.repeat(b[..., None], 3, axis=-1)
    np.testing.assert_array_equal(rgb, want)
    with open(ref, "rb") as fh:
        np.testing.assert_array_equal(timages.decode_png(fh.read()), want)


def test_save_image_other_formats_go_through_pil(tmp_path):
    img = np.linspace(0, 1, 3 * 8 * 9, dtype=np.float32).reshape(3, 8, 9)
    tviz.save_image(str(tmp_path / "a.bmp"), img)
    jviz.save_image(str(tmp_path / "b.bmp"), img)
    np.testing.assert_array_equal(np.asarray(Image.open(tmp_path / "a.bmp")),
                                  np.asarray(Image.open(tmp_path / "b.bmp")))


def test_encode_png_round_trips_and_refuses_other_shapes():
    rng = np.random.RandomState(2)
    for shape in ((5, 7), (5, 7, 3)):
        img = rng.randint(0, 256, shape).astype(np.uint8)
        rgb = timages.decode_png(timages.encode_png(img))
        np.testing.assert_array_equal(
            rgb, img if img.ndim == 3 else np.repeat(img[..., None], 3, -1))
    with pytest.raises(ValueError):
        timages.encode_png(np.zeros((4, 4, 4), np.uint8))


def test_flow_colourings_equal_jax(flow):
    g = JGeometry(hImg=17, wImg=23, maxh=6, maxw=10)
    np.testing.assert_array_equal(tviz.flow2hsv(g, flow), jviz.flow2hsv(g, flow))
    np.testing.assert_array_equal(tviz.middlebury_wheel(), jviz.middlebury_wheel())
    np.testing.assert_array_equal(tviz.flow_to_color_middlebury(flow[1], flow[0]),
                                  jviz.flow_to_color_middlebury(flow[1], flow[0]))
    rgb = jviz.flow_to_color_middlebury(flow[1], flow[0])
    for a, b in zip(tviz.color_to_flow_direction(rgb),
                    jviz.color_to_flow_direction(rgb)):
        np.testing.assert_array_equal(a, b)
    hsv = np.random.RandomState(3).rand(3, 9, 11)
    np.testing.assert_array_equal(tviz.hsv_to_rgb(hsv), jviz.hsv_to_rgb(hsv))


def test_kernels_image_equals_jax():
    k = np.random.RandomState(4).randn(5, 5, 3, 8).astype(np.float32)
    np.testing.assert_array_equal(tviz.kernels_image(k), jviz.kernels_image(k))
    np.testing.assert_array_equal(tviz.kernels_image(k, pad=0),
                                  jviz.kernels_image(k, pad=0))


def _frames(tmp_path, n=3):
    d = tmp_path / "frames"
    d.mkdir()
    for i in range(n):
        tviz.save_image(str(d / f"{i:09d}.png"),
                        np.full((3, 6, 8), i / n, np.float32))
    return str(d)


def test_export_video_writes_a_gif_without_ffmpeg(tmp_path, monkeypatch):
    def no_ffmpeg(*a, **kw):
        raise FileNotFoundError("ffmpeg")
    monkeypatch.setattr(subprocess, "run", no_ffmpeg)
    d = _frames(tmp_path)
    assert tviz.export_video(d, os.path.join(d, "out.mp4"), fps=5)
    gif = Image.open(os.path.join(d, "out.gif"))
    assert gif.n_frames == 3 and gif.info["duration"] == 200
    empty = tmp_path / "empty"
    empty.mkdir()
    assert not tviz.export_video(str(empty), str(empty / "out.mp4"))


def test_export_video_without_ffmpeg_or_pil_returns_false(tmp_path, monkeypatch):
    def no_ffmpeg(*a, **kw):
        raise FileNotFoundError("ffmpeg")
    monkeypatch.setattr(subprocess, "run", no_ffmpeg)
    monkeypatch.setitem(sys.modules, "PIL", None)
    d = _frames(tmp_path)
    assert tviz.export_video(d, os.path.join(d, "out.mp4")) is False
    assert not os.path.exists(os.path.join(d, "out.gif"))


@pytest.mark.parametrize("env", [{"DE_TPU_HEADLESS": "1"},
                                 {"DISPLAY": "", "WAYLAND_DISPLAY": ""}])
def test_viewer_is_a_no_op_without_a_display(monkeypatch, env):
    for k, v in env.items():
        if v:
            monkeypatch.setenv(k, v)
        else:
            monkeypatch.delenv(k, raising=False)
    for mod in (tviewer, jviewer):
        assert mod._display_available() is False
        v = mod.LiveViewer("t")
        assert v.backend == "none"
        v.show(np.zeros((4, 5)))
        v.close()
    tviewer.LiveViewer("t").show(torch.zeros(4, 5, 3))
    assert tviewer.LiveViewer("t", enabled=False).backend == "none"


@pytest.mark.parametrize("shape", [(480, 640, 3), (300, 640, 3), (480, 200, 3)])
def test_image_camera_push_and_crop_equal_jax(shape):
    rng = np.random.RandomState(5)
    frame = rng.rand(*shape).astype(np.float32)
    ours, ref = timages.ImageCamera(90, 160), jimages.ImageCamera(90, 160)
    assert ours.get_next_frame() is None and ref.get_next_frame() is None
    for cam in (ours, ref):
        cam.push(frame)
        cam.push(frame[::-1].copy())
    for _ in range(2):
        np.testing.assert_array_equal(ours.get_next_frame(), ref.get_next_frame())
    assert ours.get_next_frame() is None
    np.testing.assert_array_equal(ours._center_crop_aspect(frame),
                                  ref._center_crop_aspect(frame))
    ours.close()


def test_image_camera_without_a_device_raises(tmp_path):
    with pytest.raises(OSError):
        timages.ImageCamera(90, 160, device=str(tmp_path / "video9"))


def test_v4l2_structs_and_yuyv_equal_jax():
    for name in ("v4l2_pix_format", "v4l2_format", "v4l2_requestbuffers",
                 "v4l2_buffer"):
        assert ctypes.sizeof(getattr(tv4l2, name)) == \
            ctypes.sizeof(getattr(jv4l2, name))
    assert ctypes.sizeof(tv4l2.v4l2_format) == 208
    for code in ("VIDIOC_S_FMT", "VIDIOC_REQBUFS", "VIDIOC_QUERYBUF",
                 "VIDIOC_QBUF", "VIDIOC_DQBUF", "VIDIOC_STREAMON",
                 "VIDIOC_STREAMOFF", "VIDIOC_S_STD", "V4L2_PIX_FMT_YUYV"):
        assert getattr(tv4l2, code) == getattr(jv4l2, code)
    raw = np.random.RandomState(6).randint(0, 256, 2 * 6 * 8).astype(np.uint8)
    np.testing.assert_array_equal(tv4l2.yuyv_to_rgb(raw, 6, 8),
                                  jv4l2.yuyv_to_rgb(raw, 6, 8))
