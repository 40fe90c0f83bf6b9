"""PyTorch port vs the JAX package: image files, the host resize, luma and
the numbered-sequence loader (``data/images.py``). The port decodes PNG
itself (stdlib zlib); the JAX package decodes through PIL. Tolerances:
the decode, ``scale_np`` and the loader's frames are bit-equal; ``rgb2y``
within 1e-6 (the channel sum may round in another order)."""

import io
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from depth_estimation_tpu.data import images as jim
from depth_estimation_tpu_torch.data import images as tim

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
EXAMPLES = ["car_frame1.png", "car_warped.png"]


@pytest.mark.parametrize("name", EXAMPLES)
def test_load_image_png_bit_equal_to_jax(name):
    path = os.path.join(REPO, "examples", name)
    ours = tim.load_image(path)
    ref = jim.load_image(path)
    assert ours.dtype == np.float32 and ours.shape == ref.shape
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA", "P"])
@pytest.mark.parametrize("optimize", [False, True])
def test_decode_png_colour_types_and_filters(tmp_path, mode, optimize):
    """Every 8-bit colour type; PIL picks the row filters (``optimize``
    tries harder ones), so the five filters all occur across the cases."""
    rng = np.random.RandomState(len(mode))
    smooth = np.cumsum(rng.randint(0, 9, (41, 57, 4)), axis=1) % 256
    arr = smooth.astype(np.uint8)
    if mode == "P":
        im = Image.fromarray(arr[..., :3], "RGB").quantize(23)
    else:
        n = {"L": 1, "LA": 2, "RGB": 3, "RGBA": 4}[mode]
        im = Image.fromarray(arr[..., 0] if n == 1 else arr[..., :n], mode)
    path = tmp_path / "x.png"
    im.save(path, "PNG", optimize=optimize)
    np.testing.assert_array_equal(tim.load_image(str(path)),
                                  jim.load_image(str(path)))


def test_decode_png_rejects_what_it_cannot_read(tmp_path):
    buf = io.BytesIO()
    Image.fromarray(np.zeros((4, 4), np.uint16)).save(buf, "PNG")
    with pytest.raises(ValueError, match="bit depth"):
        tim.decode_png(buf.getvalue())
    with pytest.raises(ValueError, match="not a PNG"):
        tim.decode_png(b"GIF89a")


def test_load_image_jpeg_through_pil(tmp_path):
    path = tmp_path / "x.jpg"
    Image.fromarray((np.random.RandomState(0).rand(16, 24, 3) * 255)
                    .astype(np.uint8)).save(path)
    np.testing.assert_array_equal(tim.load_image(str(path)),
                                  jim.load_image(str(path)))


@pytest.mark.parametrize("dtype", [np.float32, np.uint8])
@pytest.mark.parametrize("shape,out", [((48, 64, 3), (18, 32)),
                                       ((30, 40), (45, 50)),
                                       ((480, 640, 3), (180, 320))])
def test_scale_np_bit_equal_to_jax(dtype, shape, out):
    rng = np.random.RandomState(1)
    img = rng.rand(*shape).astype(np.float32)
    if dtype == np.uint8:
        img = (img * 255).astype(np.uint8)
    ours = tim.scale_np(img, *out)
    ref = jim.scale_np(img, *out)
    assert ours.dtype == ref.dtype == dtype
    np.testing.assert_array_equal(ours, ref)


def test_rgb2y_matches_jax():
    img = np.random.RandomState(2).rand(9, 11, 3).astype(np.float32)
    ours = tim.rgb2y(torch.from_numpy(img)).numpy()
    ref = np.asarray(jim.rgb2y(jnp.asarray(img)))
    assert ours.shape == ref.shape == (9, 11, 1)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-6)


def test_image_loader_matches_jax(tmp_path):
    """A numbered PNG sequence at another size than asked: both loaders
    give the same resized frames, in order, then None."""
    d = tmp_path / "images"
    os.makedirs(d)
    rng = np.random.RandomState(3)
    for i in range(3):
        Image.fromarray((rng.rand(40, 52, 3) * 255).astype(np.uint8)).save(
            d / f"{i + 2:09d}.png")
    ours = tim.ImageLoader(str(tmp_path), 30, 26, first=2)
    ref = jim.ImageLoader(str(tmp_path), 30, 26, first=2)
    for _ in range(3):
        a, b = ours.get_next_frame(), ref.get_next_frame()
        assert a.shape == (30, 26, 3)
        np.testing.assert_array_equal(a, b)
    assert ours.get_next_frame() is None and ref.get_next_frame() is None
