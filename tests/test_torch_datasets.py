"""PyTorch port vs the JAX package: the flow part of ``data/datasets.py`` —
the 'sfm' (essential-matrix), 'mc' (4-DoF) and plain pair loaders, the
batched 'sfm' rectification, ``load_data_optical_flow`` with the
'cross-correlation', 'cc-mean' and 'liu' ground truths, and
``FlowDataset``. Frames are PNG files written from numpy seeds, as
tests/test_datasets.py writes them; RANSAC gets the reference's own draws.

The scene is a camera stepping sideways over varying depth
(torch_parity.parallax_frames, seed 3 at 96x128): its RANSAC winners are
8 distinct points, so R agrees to float rounding (ROADMAP C9). Tolerances:
  * resized and plain frames, masks of the plain and 'mc' loaders, and
    the GT of identical inputs: bit-equal;
  * rotation-compensated frames within 1e-3 (R rounds apart by ~1e-6);
    their masks and the quantized GT equal on >= 99% of the pixels (a
    1e-6 change of R moves a bilinear tap across a mask edge, or a WTA
    pick between two costs within rounding; the liu GT rounds at .5);
  * the 'mc' warp (nearest neighbour of a least-squares fit) equal on
    >= 99.9% of the pixels.
"""

import dataclasses
import os

import jax
import numpy as np
import pytest
import torch
from PIL import Image

from depth_estimation_tpu.data import datasets as jds
from depth_estimation_tpu.geometry import Geometry as JGeometry
from depth_estimation_tpu_torch.data import datasets as tds
from depth_estimation_tpu_torch.geometry import Geometry as TGeometry
from depth_estimation_tpu_torch.geometry import Learning as TLearning
from torch_parity import calibrations, parallax_frames, ransac_noise

H, W, NPTS = 96, 128, 200
GEOM = dict(hImg=32, wImg=40, layers=((3, 5, 5, 8),), maxh=6, maxw=6,
            maxhGT=6, maxwGT=6, hKernelGT=5, wKernelGT=5)
JG, TG = JGeometry(**GEOM), TGeometry(**GEOM)
# the 4-DoF fit needs more corners than 32x40 holds for a good pair
MC_GEOM = dict(GEOM, hImg=48, wImg=64)
MC_JG, MC_TG = JGeometry(**MC_GEOM), TGeometry(**MC_GEOM)
JC, TC = calibrations(H, W, f=100.0, max_points=NPTS)
NOISE = ransac_noise(64, NPTS)
MC_IDX = np.array(jax.random.randint(jax.random.PRNGKey(0), (64, 5), 0, 200))
SHARE = 0.99


def write_sequence(root, frames):
    d = os.path.join(root, "images")
    os.makedirs(d)
    for i, f in enumerate(frames):
        Image.fromarray((f * 255).astype(np.uint8)).save(
            os.path.join(d, f"{i:09d}.png"))
    return root


@pytest.fixture(scope="module")
def seq(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("seq"))
    return write_sequence(root, parallax_frames(np.random.RandomState(3), H, W,
                                                n=3))


@pytest.fixture(scope="module")
def frames(seq):
    from depth_estimation_tpu_torch.data.images import ImageLoader
    loader = ImageLoader(seq, H, W)
    return [loader.get_next_frame() for _ in range(3)]


def agree(a, b):
    return float((np.asarray(a) == np.asarray(b)).mean())


def assert_pair(ours, ref, warped_atol=1e-3, share=SHARE):
    assert ours.good == ref.good
    np.testing.assert_allclose(ours.image, np.asarray(ref.image), rtol=0,
                               atol=1e-5)
    np.testing.assert_allclose(ours.prev_warped, np.asarray(ref.prev_warped),
                               rtol=0, atol=warped_atol)
    assert agree(ours.mask, ref.mask) >= share
    if ref.flow is None:
        assert ours.flow is None
    else:
        assert ours.flow.shape == ref.flow.shape
        assert agree(ours.flow, ref.flow) >= share


@pytest.mark.parametrize("mc,gt", [("sfm", "cross-correlation"),
                                   ("sfm", "cc-mean"),
                                   (None, "cross-correlation"),
                                   ("mc", "cross-correlation")])
def test_load_data_optical_flow_matches_jax(seq, mc, gt):
    jg, tg = (MC_JG, MC_TG) if mc == "mc" else (JG, TG)
    ref = jds.load_data_optical_flow(jg, JC, seq, 3, motion_correction=mc,
                                     groundtruth=gt)
    ours = tds.load_data_optical_flow(tg, TC, seq, 3, motion_correction=mc,
                                      groundtruth=gt, noise=NOISE,
                                      sample_idx=MC_IDX, device="cpu")
    assert {k: len(v) for k, v in ours.items()} == {
        k: len(v) for k, v in ref.items()}
    for a, b in zip(ours["images"], ref["images"]):
        np.testing.assert_allclose(a, np.asarray(b), rtol=0, atol=1e-5)
    exact = mc in (None, "mc")
    for a, b in zip(ours["warped_images"], ref["warped_images"]):
        if mc == "mc":
            assert agree(a, b) >= 0.999
        else:
            np.testing.assert_allclose(a, np.asarray(b), rtol=0,
                                       atol=0 if exact else 1e-3)
    for a, b in zip(ours["masks"], ref["masks"]):
        assert agree(a, b) >= (1.0 if exact else SHARE)
    for a, b in zip(ours["flow"], ref["flow"]):
        assert (a is None) == (b is None)
        if a is not None:
            assert agree(a, b) >= (0.999 if exact else SHARE)
    assert all(f is not None for f in ours["flow"])


def test_load_data_optical_flow_liu_matches_jax(seq):
    """'liu' GT (the variational solver per good pair) on the 32x40
    working size; the rectification runs at 96x128."""
    ref = jds.load_data_optical_flow(JG, JC, seq, 3, groundtruth="liu")
    ours = tds.load_data_optical_flow(TG, TC, seq, 3, groundtruth="liu",
                                      noise=NOISE, device="cpu")
    for a, b in zip(ours["flow"], ref["flow"]):
        assert a is not None and b is not None and a.shape == (2, 32, 40)
        assert agree(a, b) >= SHARE
        assert np.abs(a - np.asarray(b)).max() <= 1.0


def test_rectified_pair_matches_jax(frames):
    ref = jds.load_rectified_pair(JG, JC, frames[0], frames[1])
    ours = tds.load_rectified_pair(TG, TC, frames[0], frames[1], noise=NOISE,
                                   device="cpu")
    assert ours.good
    assert_pair(ours, ref)


def test_rectified_pair_without_gt_and_bad_gate(frames):
    ours = tds.load_rectified_pair(TG, TC, frames[0], frames[1],
                                   compute_gt=False, noise=NOISE, device="cpu")
    assert ours.good and ours.flow is None
    strict = dataclasses.replace(TC, bad_image_threshold=1.01)
    bad = tds.load_rectified_pair(TG, strict, frames[0], frames[1],
                                  noise=NOISE, device="cpu")
    assert not bad.good and bad.flow is None and not bad.mask.any()


def test_mc_pair_matches_jax(frames):
    ref = jds.load_mc_pair(MC_JG, JC, frames[1], frames[2])
    ours = tds.load_mc_pair(MC_TG, TC, frames[1], frames[2],
                            sample_idx=MC_IDX, device="cpu")
    assert ours.good and ref.good
    assert agree(ours.prev_warped, ref.prev_warped) >= 0.999
    np.testing.assert_array_equal(ours.image, np.asarray(ref.image))
    assert agree(ours.mask, ref.mask) >= 0.999
    assert agree(ours.flow, ref.flow) >= 0.999


def test_plain_pair_matches_jax(frames):
    ref = jds.load_plain_pair(JG, JC, frames[0], frames[1])
    ours = tds.load_plain_pair(TG, TC, frames[0], frames[1], device="cpu")
    for k in ("prev_warped", "image", "mask", "flow", "conf"):
        np.testing.assert_array_equal(getattr(ours, k),
                                      np.asarray(getattr(ref, k)))


def test_batched_rectification_matches_per_pair(frames):
    """The batched 'sfm' pass against the port's per-pair loader (the JAX
    package's tests/test_datasets.py holds its own two forms the same
    way)."""
    batched = tds.load_rectified_pairs_batched(TG, TC, frames, noise=NOISE,
                                               device="cpu")
    assert len(batched) == 2
    for k in range(2):
        single = tds.load_rectified_pair(TG, TC, frames[k], frames[k + 1],
                                         noise=NOISE, device="cpu")
        assert batched[k].good == single.good
        np.testing.assert_allclose(batched[k].image, single.image, atol=1e-5)
        np.testing.assert_allclose(batched[k].prev_warped, single.prev_warped,
                                   atol=1e-4)
        assert agree(batched[k].mask, single.mask) >= 0.999
        assert agree(batched[k].flow, single.flow) >= 0.999


def test_gt_cache_layout_is_shared_with_jax(frames, tmp_path):
    """GT written by the port's batched loader is read back from the disk
    cache by the JAX package's loader (same parameter-encoded paths)."""
    root = str(tmp_path)
    ours = tds.load_rectified_pairs_batched(TG, TC, frames, root,
                                            ["000000000", "000000001"],
                                            noise=NOISE, device="cpu")
    from depth_estimation_tpu.data import groundtruth as jgt
    for k, name in enumerate(["000000000", "000000001"]):
        hit = jgt.load_cached_flow(root, JG, 1, name)
        assert hit is not None
        np.testing.assert_array_equal(np.floor(np.stack(hit[:2]) + 0.5),
                                      ours[k].flow)


def test_flow_dataset_matches_jax(seq):
    ref = jds.FlowDataset(JG, JC, seq)
    ours = tds.FlowDataset(TG, TC, seq, device="cpu")
    assert len(ours) == len(ref) == 3
    np.testing.assert_array_equal(ours.get_full_image(2), ref.get_full_image(2))
    with pytest.raises(IndexError):
        ours.get_image(0)
    # the per-pair loader's default RANSAC noise is the port's own seed;
    # hand both the same rectified pairs to compare the patch sampler
    for i in (1, 2):
        ours._pairs[i] = tds.load_rectified_pair(
            TG, TC, ours.get_full_image(i - 1), ours.get_full_image(i),
            noise=NOISE, device="cpu")
        assert_pair(ours._pairs[i], ref._pair(i))
        ours._pairs[i] = dataclasses.replace(
            ours._pairs[i], **{k: np.asarray(getattr(ref._pair(i), k))
                               for k in ("prev_warped", "image", "mask",
                                         "flow")})
    np.testing.assert_array_equal(ours.get_prev_image(1), ref.get_prev_image(1))
    np.testing.assert_array_equal(ours.get_gt(2), ref.get_gt(2))
    a = ours.get_patches(24, np.random.RandomState(0), TLearning())
    b = ref.get_patches(24, np.random.RandomState(0))
    for k in ("patches1", "patches2", "targets_yx", "itargets"):
        np.testing.assert_array_equal(getattr(a, k), getattr(b, k))


@pytest.mark.parametrize("entry", ["rectified_pair", "mc_pair", "plain_pair",
                                   "batched", "load_data", "flow_dataset"])
def test_loaders_default_to_the_card_and_refuse_the_cpu(monkeypatch, seq,
                                                        frames, entry):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    call = {
        "rectified_pair": lambda: tds.load_rectified_pair(TG, TC, *frames[:2]),
        "mc_pair": lambda: tds.load_mc_pair(TG, TC, *frames[:2]),
        "plain_pair": lambda: tds.load_plain_pair(TG, TC, *frames[:2]),
        "batched": lambda: tds.load_rectified_pairs_batched(TG, TC, frames),
        "load_data": lambda: tds.load_data_optical_flow(TG, TC, seq, 3),
        "flow_dataset": lambda: tds.FlowDataset(TG, TC, seq),
    }[entry]
    with pytest.raises(RuntimeError, match="cuda"):
        call()
