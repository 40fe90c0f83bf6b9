"""PyTorch port vs the JAX package: ``data/depth_legacy.py`` (numpy only)
and ``load_depth_dataset`` / ``_to_gray`` (the JAX package keeps these two
in cli/depth_estimation.py). The same files and the same
``np.random.RandomState`` seeds go through both; every result is held
bit-equal."""

import os

import numpy as np
import pytest
from PIL import Image

from depth_estimation_tpu.cli import depth_estimation as jcli
from depth_estimation_tpu.data import depth_legacy as jdl
from depth_estimation_tpu_torch.data import depth_legacy as tdl

H, W = 64, 96


@pytest.fixture(scope="module")
def root(tmp_path_factory):
    """5 RGB frames (PNG) and depth points for frames 0-3 and 5 (frame 5
    has no image, frame 3 no successor at delta 2); frame 1 is
    blacklisted in one test."""
    root = tmp_path_factory.mktemp("depth")
    os.makedirs(root / "images")
    os.makedirs(root / "depths")
    rng = np.random.RandomState(0)
    for i in range(5):
        img = (rng.rand(H, W, 3) * 255).astype(np.uint8)
        Image.fromarray(img).save(root / "images" / f"{i:09d}.png")
    for i in (0, 1, 2, 3, 5):
        n = 80
        xs = rng.uniform(0, W, n).astype(np.float32)
        ys = rng.uniform(0, H, n).astype(np.float32)
        depth = (rng.gamma(2.0, 6.0, n) + 0.5).astype(np.float64)
        np.savez(root / "depths" / f"{i:09d}.npz", x=xs, y=ys, depth=depth)
    (root / "depths" / "notes.txt").write_text("not a depth file")
    return str(root)


def assert_frames_equal(a, b):
    assert len(a) == len(b)
    for fa, fb in zip(a, b):
        assert set(fa) == set(fb)
        for k in fa:
            if k == "name":
                assert fa[k] == fb[k]
            else:
                assert fa[k].dtype == fb[k].dtype
                np.testing.assert_array_equal(fa[k], fb[k])


@pytest.mark.parametrize("blacklist", [(), ("000000001",)])
def test_depth_points_load_bit_equal(root, blacklist):
    ours = tdl.load_raw_depth_data(root, blacklist)
    assert len(ours) == 5 - len(blacklist)
    assert_frames_equal(ours, jdl.load_raw_depth_data(root, blacklist))
    assert tdl.load_raw_depth_data(os.path.join(root, "images")) == []


@pytest.mark.parametrize("n_classes", [2, 3, 5])
def test_discretizer_is_bit_equal(root, n_classes):
    frames = jdl.load_raw_depth_data(root)
    images = [np.zeros((H, W, 2), np.float32)] * len(frames)
    hists = [m.pre_sort_data_discrete(frames, images, 16, 16, 300,
                                      np.random.RandomState(3))
             for m in (tdl, jdl)]
    assert hists[0] == hists[1]
    ours, ref = tdl.DepthDiscretizer(n_classes), jdl.DepthDiscretizer(n_classes)
    ours.compute_cut_depth(hists[0], sum(len(b) for b in hists[0]))
    ref.compute_cut_depth(hists[1], sum(len(b) for b in hists[1]))
    assert (ours.cut_depth, ours.bin_step) == (ref.cut_depth, ref.bin_step)
    for d in (0.0, 0.3, 5.0, ours.cut_depth, 17.2, 99.0, 1e4):
        assert ours.get_class(d) == ref.get_class(d)
    a, b = np.random.RandomState(4), np.random.RandomState(4)
    assert ([ours.random_bin(hists[0], a) for _ in range(50)]
            == [ref.random_bin(hists[1], b) for _ in range(50)])
    assert (tdl.median_patch_depth(frames[0], 10, 20, 16, 16)
            == jdl.median_patch_depth(frames[0], 10, 20, 16, 16))
    assert tdl.median_patch_depth(frames[0], 0, 0, 0, 0) is None


@pytest.mark.parametrize("n_classes", [2, 3])
def test_samplers_are_bit_equal(root, n_classes):
    frames = jdl.load_raw_depth_data(root)
    rng = np.random.RandomState(7)
    images = [rng.rand(H, W, 2).astype(np.float32) for _ in frames]
    a, b = np.random.RandomState(1), np.random.RandomState(1)
    ours = tdl.generate_data_discrete(frames, images, 16, 16, n_classes, 60, a)
    ref = jdl.generate_data_discrete(frames, images, 16, 16, n_classes, 60, b)
    for x, y in zip(ours[:2], ref[:2]):
        assert x.dtype == y.dtype
        np.testing.assert_array_equal(x, y)
    assert (ours[2].n_classes, ours[2].cut_depth, ours[2].bin_step) == (
        ref[2].n_classes, ref[2].cut_depth, ref[2].bin_step)
    for x, y in zip(tdl.generate_continuous_dataset(frames, images, 16, 16,
                                                    40, a),
                    jdl.generate_continuous_dataset(frames, images, 16, 16,
                                                    40, b)):
        np.testing.assert_array_equal(x, y)


@pytest.mark.parametrize("shape", [(H, W, 3), (H, W, 1), (H, W)])
def test_to_gray_is_bit_equal(shape):
    img = np.random.RandomState(2).rand(*shape).astype(np.float32)
    ours, ref = tdl._to_gray(img), jcli._to_gray(img)
    assert ours.dtype == ref.dtype
    np.testing.assert_array_equal(ours, ref)


@pytest.mark.parametrize("size,delta", [((H, W), 1), ((40, 56), 1),
                                        ((H, W), 2)])
def test_load_depth_dataset_is_bit_equal(root, size, delta):
    """Frames at their own size and resized (depth points scaled alike);
    frames whose pair frame i + delta has no image are dropped."""
    ours = tdl.load_depth_dataset(root, 10, delta, *size)
    ref = jcli.load_depth_dataset(root, 10, delta, *size)
    assert_frames_equal(ours[0], ref[0])
    assert len(ours[1]) == len(ref[1]) == (4 if delta == 1 else 3)
    for a, b in zip(ours[1], ref[1]):
        assert a.shape == size + (2,) and a.dtype == b.dtype
        np.testing.assert_array_equal(a, b)
