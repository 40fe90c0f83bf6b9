#!/usr/bin/env python3
"""Drive the PyTorch port's main paths on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing falls back to the CPU):
  1. device: require CUDA, print the card's name and power limit;
  2. build: compile the CUDA kernels from csrc/ with nvcc, one process per
     source, all at once;
  3. kernels vs their plain PyTorch versions on the card, at their main
     paths' shapes: B1 and B3 at the online program's (B=8, f32 and bf16
     storage), B4 at the ground truth's finest level (B=8, 192x256, 40
     iterations, one 8-CTA cluster an image), B2 at the matching core's
     (B=8, f32 and bf16), B5 at the same (B=8, f32, its norms computed by
     the kernel, the twin's by the wrapper), the liu warp kernel and the
     IRLS kernel (cold and warm) at the liu cell's finest level (B=64,
     180x320x5), bit for bit; then the shapes beyond the
     main paths (ROADMAP C24) at B=2, 12x40 outputs: B1 in conf and marg
     mode, f32 and bf16, at windows 17x4, 24x24, 32x32 and 64x64 (K=10)
     and at K 33 and 64 (16x16); B2 (f32, bf16) and B5 at 64x64 (K 1, 32),
     48x48 (K 17), 3x500 and 500x3 (K 10, 32), K 33 and 64 (16x16) and
     K 32 on 17x17 (the version2 net's);
  4. the online program end to end at the car_model's full width (ARDRONE
     640x480 uint8 frames of a forward camera step -> 320x180, trunk
     (3,5,5,8),(8,12,12,10), 16x16 window), B=128, in fast mode, 'warp'
     mode and 'warp_banded' mode, then the per-frame DepthEstimator; B1's
     and B3's launch counts are read around this phase;
  5. card vs CPU: 4 pairs, f32 'warp_banded' mode and fast mode, the same
     package on both devices (the CPU runs the plain versions) with the same
     RANSAC noise, end to end and ego-motion stage by stage;
  6. the flow ground truth at full size: the 'liu' solver batched at
     BASELINE config2 (B=8, 192x256x3, alpha 0.005, ratio 0.75, min_width
     30, 5/1/40) on frames whose scene moves 2 px, with B4's, the liu
     warp kernel's and the IRLS kernel's launches read around it; one pair
     card vs CPU; the exhaustive GT at car_model's
     geometry (180x320, 16x16 GT window and kernel), 2 pairs card vs CPU;
  7. the matching core (bench.py's secondary program): uint8 640x480
     frames, B=128 -> 320x180 -> trunk -> crop -> B2 in bf16 -> the depth
     rule, with B2's launches read around it;
  8. the throughput matching core: the same with B5 (f32) as the matcher,
     B5's launches read around it, its WTA held against B2's (f32) on the
     same features;
  9. the other model families at BASELINE widths, random weights from a
     seed: config3's multiscale pyramid (180x320, trunk (3,16,16,10), 8x8
     window, ratios 1,2,4) through the staged decode at B=64 in f16 and f32
     storage, decode_full against forward_full's argmax on the card (B=4)
     and one pair card vs CPU; config4's radial net (forward-motion frames
     warped to 200x200 polar images, hWin 15) through flow_batch at B=64,
     one pair card vs CPU, and one cartesian frame through
     cartesian2polar, the net and flow2depth; the version2 net (180x320,
     17x17x32 trunk, 17x17 window), one pair's costs card vs CPU, then
     flow_batch at B=64 (timed) with B2's and N1's launches read around
     it, N1 (the contrastive normalisation kernel) held bit for bit to its
     twin on the 128 frames and timed beside its bytes bounds, and B2
     (f32, K=32, 17x17) held against its twin on the same cropped
     features;
 10. timing: CUDA events after warm-up, median of 5; B1 in bf16 (the
     online program's fast mode) and f32; B3 in f32 and bf16 beside
     torch.nn.functional.grid_sample on the same inputs (its library
     yardstick, which the port never calls); B4 at the finest level (one
     call, and 10 calls back to back), and over one config2 solve: each
     launch's device time from torch.profiler, by level, beside the
     dependency floor (one half-sweep's cluster barrier and boundary-row
     exchange, measured by a no-arithmetic probe, times the level's
     dependent half-sweeps); the liu warp kernel (update, warp, noise),
     its resize and the IRLS kernel (a cold step's nine planes) at the liu
     cell's finest shape (B=64, 180x320, C=5; the pyramid's first step)
     beside their twins and their bytes bound, one call and 10 back to
     back; B2 (bf16, f32) and B5 through their wrappers
     on the plan's pixel blocking and on every other compiled blocking,
     and their issue floor (SASS instructions a cell of the plan's
     instantiation, read with cuobjdump, over the card's issue rate);
 11. the flow trainer's path, every kernel count zeroed before it and read
     after: a 5-frame forward-camera sequence (640x480, numpy from a seed)
     written as PNG, ``load_data_optical_flow`` ('sfm', cross-correlation
     GT) at car_model's geometry on the card, and its batched loader card
     vs CPU with the same RANSAC noise; one pair through the 'liu' GT
     (B4); ``sample_patches`` (2048 + 256) and ``Trainer`` at car_model
     width, B=64, one epoch of 32 steps at the demo's rate (the loss must
     fall), one 'soft' and one 'mse' step, 3 steps card vs CPU;
     ``sample_foveas`` and ``MultiscaleTrainer`` at config3's widths, B=32,
     8 steps, 2 card vs CPU; ``score_epoch``, ``save_model``, and one
     ``BatchedDepthEstimator`` step on the saved checkpoint (B1); then the
     step times (TF32 off: the trainers set it off themselves), the bare
     trunk's convolution on the step's patches in f32 and in TF32, each
     step's kernels and device time (torch.profiler), and the loader's
     time for 4 pairs;
 12. the other families' trainers at full width, every kernel count zeroed
     before and read after (the path reaches none of B1-B5): the radial
     trainer ('gopro' 1280x720 PNG frames of a forward step towards two
     depth planes -> ``load_polar_pairs_batched`` with the 16x16 GT at
     720x1280 -> 200x200 polar patches, hWin 15 -> one epoch, n 1000,
     B=32 -> e0.msgpack -> the net loaded back); version2 (340x180 PNG
     frames -> ``FlowDataset`` -> one epoch -> e0 -> loaded back); the
     legacy depth classifier (360x640 pairs and sparse depth points -> one
     epoch, n 2000 / m 500 -> params.msgpack -> loaded back -> the class
     map of one pair); card vs CPU: the radial loader at 'gopro' scaled by
     0.5, version2's pairs, the class map, and 3 steps of each trainer;
     each step's time, kernels and device time, and each loader's time;
 13. serving, B1's and B3's counts zeroed before and read after: `tools
     export` of the car model's flow forward (f32 and --bf16) and of the
     complete online program (--pipeline, B=32, 'warp' mode), of the
     families phase's radial, version2 and legacy checkpoints and of
     config3's multiscale decode on seeded weights; each artifact loaded
     (serving.load_exported), called once with its B1 / B3 launches
     counted (the pipeline's B3 launch is its torch.cond's banded branch)
     and held to the live program (integers equal, floats within 1e-6),
     then both timed; the pipeline's kernels and device time against the
     live step's; the 'warp' step at B=128 and its compensation alone,
     with the live host read of the predicate against torch.cond run
     eagerly (the form the trace keeps, C4);
     and the CLIs: `tools stream` (synchronous and --pipeline 3) over a
     640x480 PNG sequence, `time-matching`, `video` on 3 frames and
     `test_radial` on the radial checkpoint, each exiting 0 and writing
     what it writes;
 14. the training CLIs and the real-drone loop, B1's and B4's counts
     zeroed before each and read after: `opticalflow` at car_model's
     trunk and window (ARDRONE 640x480 PNG frames of the training phase's
     seed -> 320x180; cross-correlation, then '-gt liu' with B4 launched
     for every GT pair, then '--resume -e 2'), `train_radial` ('gopro',
     200x200 polar, hWin 15), `train_v2` ('rectified_gopro_small') and
     `depth_estimation` (360x640, then '-lw ... -i') over the families
     phase's sequences, each through its main(argv) at its default
     widths, one epoch, exiting 0 with its checkpoint loaded back; then
     `robotics`: FifoDroneAPI over os.mkfifo pipes with a peer thread
     playing the drone's SDK (navdata with a forward velocity in, control
     records read back), the per-frame DepthEstimator on car_model fed by
     an ImageCamera pushed a forward-camera sequence, AvoidanceController
     over DepthMap(64, 128, 100, 0.9, 320) for 30 ticks (B1 once a tick,
     the peer receiving every control), the depth rule on the card equal
     to the CPU's on the same x-flow and mask and timed, and the
     simulator's avoidance run (seed 11, a pillar ahead) advancing
     without a collision;
 15. the peak meter and the roofline: kernels P1 (8 FMA chains, 8 expf
     chains) and P2 (1, 2, 4 and 8 logistic chains at full occupancy and
     at 4 warps an SM) against their plain twins on random values at the
     element counts the meter and the sweep launch them at, 3
     iterations; then, P1's and P2's counts zeroed before and read after,
     the meter (benchmarks/device_peaks: FP32 FMA and expf through P1,
     bf16 and f32 matrix products, the HBM stream, the gather's index
     rate; each the best of 3 timings of >= 100 ms, with the SM clock and
     power draw under it) inside capture_trace and profiled_span (the
     Chrome trace must name the span and P1's kernel; kept gzipped under
     chiprun_out/trace_peaks/), and P2's sweep (with the SM clock and
     power draw under each of its rows); the `peaks` JSON line; then the
     roofline
     (benchmarks/speed_of_light: B1 bf16 and f32, B2, B5, B3 f32 and
     bf16, B4, the liu warp kernel and the conv trunk, each 10 calls
     back to back at its main path's shapes, against the measured and the
     published peaks), the `roofline` JSON line, and the contract
     (speed_of_light.contract_failures): every ceiling and every rate of
     P2's sweep within 105% of its published peak, no row above 100% of
     the measured ceiling;
 16. the mesh layer on every visible card (see its block below);
 17. the launch-plan autotuner (ops/autotune.py), the f32 rule and the
     NaN scope: at the online program's shape (B=128, car_model, bf16
     and f32, conf on) every candidate plan of B1 and of B2 (K=10) timed
     and held bitwise to the default plan (the default to its twin within
     phase 3's tolerances); ``best_plan``'s winner against the default;
     a second resolution, in this process and in a new one, answered by
     the store with no timing; ``BatchedDepthEstimator(match_block=
     "auto")`` bitwise equal to match_block=8 in fast and 'warp' mode, B1
     counted around it; a step under torch's default flags (cuDNN TF32
     on) bitwise equal to the step with TF32 off (ROADMAP C12); the
     x-flow TF32 would change (the estimator's inner program, which sets
     no flag, in TF32 against f32, on the 8-distinct-winner streams) and
     the bare trunk's time in each; ``nan_debug`` naming B1's operator and
     B2's wrapper on a NaN input, and passing a clean step;
 18. reduced-precision storage: B1 (conf on) and B2 at B=128, 150x290x10
     against 165x305x10, 16x16, and B3 at (128, 165, 305, 10), band 8, on
     f16 and bf16 storage against their twins (WTA indices equal, the
     floats within phase 3's tolerances), each wrapper launching once,
     timed (CUDA events, median of 5); the precision table
     (``depth_estimation_tpu_torch.quality.precision_table``: car_model's
     B1 and B2 rows in bf16 and f16 and the trunk-in-bf16 rows, the
     committed multiscale checkpoint's staged decode in bf16 and f16, on
     the car pair and the warp sequence's held-out pair; B1's and B2's
     bf16 and f16 rows held at a mean EPE delta of at most 0.1 px, the
     rest recorded; written to chiprun_out/precision_table.json);
     config3's staged decode at B=64 in f32, bf16 and f16 (its BASELINE
     geometry on seeded weights, and the trained checkpoint): ms, EPE
     delta and WTA agreement; the online program on car_model at B=128,
     fast mode (bench.py's knobs) and 'warp' mode, with every storage
     knob in bf16 and in f16 against f32: x-flow mean, p99 and max on the
     streams whose RANSAC winners are 8 distinct points in both runs,
     `good` and the masks; no NaN anywhere.

The build's registers and spills are printed for every kernel.

The port's entry points (the estimators, GT generators, the families'
calls, the trainers and loaders, the CLIs, the mesh's shards) compute in
full f32 whatever the caller's flags (``utils/precision.full_f32``); the
script also switches TF32 off for the whole run, for what it calls below
the entry points (the bare kernels, the trunk, the twins), so that the
card computes what the CPU reference computes. Phase 17 sets the flags
itself where it measures what TF32 would change.
The last three lines are a JSON summary of the kernels (launches on their
main path, error against the plain version, kernel and plain times, the
bound from this run's inputs; B1 at bf16; B1, B2 and B5 also their
largest error at the C24 shapes; B3 in f32 with grid_sample's time as
library_ms, both also 10 calls back to back, and its bf16 times and
bound; B4 also with its dependency
floor and its device time over a solve; B1 and B4 also their launches
on the training phase; each its launches on the families' phase; B1
and B3 their launches on the serving phase; B1 and B4 their launches on
the training CLIs and on the drone loop; P1 and P2 their launches in
the meter and the sweep, their error against the twins, their ms a
launch in the meter, the kernel's and the twin's at the check, their
bound from the
launch's operations at the published rate, and the rate they measured;
B1, B2 and B3 also their f16 time, twin time, bound and error at the main
shape, bf16's time in the same phase, and their launches on phase 18),
the card, and {"ok": true, "device": {...}}. A longer report goes to
chiprun_out/chip_smoke_report.json.
"""

import contextlib
import gc
import gzip
import json
import os
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

from depth_estimation_tpu_torch.benchmarks.device_peaks import (
    card_line, sm_clock_under)
from depth_estimation_tpu_torch.benchmarks.speed_of_light import (
    CLOCK_HZ, PEAK_BYTES, PEAK_SFU, bound_ms, liu_irls_work, liu_warp_inputs,
    liu_warp_work, matcher_bound, resize_work, sor_planes, sor_work,
    warp_work)

ROOT = os.path.dirname(os.path.abspath(__file__))
CAR_MODEL = os.path.join(ROOT, "examples", "car_model")
REPORT = os.path.join(ROOT, "chiprun_out", "chip_smoke_report.json")
B_MAIN = 128
B_CHECK = 8
FAST = dict(compensation="decode", match_dtype=torch.bfloat16,
            warp_dtype=torch.bfloat16, state_dtype=torch.bfloat16,
            ego_downsample=2, lk_iters=5, ransac_samples=48,
            corner_selector="topk", match_block=32, lk_search=24)

# stated tolerances, kernel vs plain on the card (same arithmetic order; only
# library exp/rounding differences remain)
TOL_FLOW_PX = 1e-4          # ey, ex
TOL_PROB = 1e-5             # pmax, marginal
TOL_FLIP = 1e-4             # share of WTA indices / confidence gates that differ
TOL_WARP = 1e-5             # banded warp values
# card vs CPU, per pair. Ego-motion from the same prep: the same corners,
# LK tracks within TOL_TRACK_PX, the same RANSAC winner, and R within TOL_R.
# cuSOLVER's and LAPACK's QRs of the winner's 8-point system round apart by
# up to ~2e-5 in R, and rotation compensation and the soft-argmax over
# trained costs turn that into up to ~1e-2 px of x-flow at single pixels,
# so x-flow is held at its mean and 99th percentile. Where the winner
# repeats a point (RANSAC draws with replacement, as the reference does),
# its nullspace is 2-D and E is whatever the QR build returns: R and x-flow
# are then printed, not held.
B_CMP = 4
TOL_TRACK_PX = 1e-3
TOL_R = 1e-4
TOL_E2E_MEAN_PX = 1e-2
TOL_E2E_P99_PX = 5e-2
TOL_E2E_MASK = 0.999
# B4 vs sor_plain: the same operations in the same order, rounded intrinsics
TOL_SOR = 1e-6
# the ground truth's liu solve, card vs CPU (same package): both run
# 56 IRLS steps of the same arithmetic; they part only by rounding (the
# card's reductions sum in other orders), which the smooth-texture solve
# damps. A wrong kernel or a wrong dispatch moves u by tenths of a pixel.
TOL_GT_MEAN_PX = 1e-3
TOL_GT_MAX_PX = 1e-2
# the exhaustive GT, card vs CPU: WTA over 256 cells of 768-term patch
# sums; the card sums in another order, so an index may flip where the two
# best costs are within float rounding
TOL_GT_FLIP = 1e-3
GT_SCHEDULE = dict(alpha=0.005, ratio=0.75, min_width=30, n_outer=5,
                   n_inner=1, n_sor=40)
GT_B, GT_H, GT_W, GT_SHIFT = 8, 192, 256, 2
GT_SOR_CALLS = 56          # 7 levels, n_outer + k IRLS steps at level k
GT_WARPS = 56 + 6 + 1      # an IRLS step's, one between levels, the final
GT_IRLS = 56               # the IRLS kernel, once an IRLS step
GT_RESIZES = 4 * 6         # two pyramid levels and two flows a level
# the liu cell's finest level (BASELINE config2 at the working size) and
# its pyramid's first step
LIU_B, LIU_H, LIU_W, LIU_C, LIU_NEXT = 64, 180, 320, 5, (135, 240)
TOL_LIU_NOISE_REL = 1e-5   # the noise sums add in another order
# the other model families at BASELINE widths (benchmarks/bench_configs.py
# :136-174): config3's multiscale pyramid and config4's radial net, random
# weights from a seed (the repo holds no trained checkpoint of either)
C3_GEOMETRY = dict(hImg=180, wImg=320, layers=((3, 16, 16, 10),), maxh=8,
                   maxw=8, multiscale=True, ratios=(1, 2, 4))
C3_B, C3_CHECK_B = 64, 4
C4_B, C4_H, C4_W, C4_HWIN = 64, 200, 200, 15
C4_LAYERS = ((3, 5, 5, 10), "tanh", (10, 5, 5, 10))
C4_CART = (240, 320)        # the cartesian frames warped to polar
# card vs CPU (and B5 vs B2): the share of WTA indices that must be equal
# (they may part only where two cells' costs are within rounding), and the
# largest cost difference over the largest cost (cuDNN's and the CPU's f32
# convolutions sum in other orders). The radial net's minimum costs are
# differences of nearly equal features through two conv layers, so their
# rounding is larger against their own scale: held at 1e-4 (9.7e-6 read on
# an H100).
TOL_AGREE = 0.999
TOL_COST_REL = 1e-5
TOL_RADIAL_COST_REL = 1e-4
# the training phase: a 5-frame forward-camera sequence at ARDRONE's
# 640x480 through the 'sfm' loader, the single-scale trainer at car_model
# width (examples/train_car_demo.py:40-45: lr 2e-2, decay 1e-5, nll, B=64)
# on 2048 patches, and the multiscale trainer at config3's widths (B=32).
# Card vs CPU, TF32 off: trainer weights after 3 steps (2 multiscale)
# within TOL_TRAIN_PARAM (XLA's and torch's, or cuDNN's and the CPU's,
# convolution gradients sum in other orders; the CPU tests hold the port
# to the JAX package at the same bound); loader warps within the C6
# bounds as intensities, the masks on TOL_E2E_MASK of the pixels, the GT
# equal on TOL_TRAIN_GT of the pixels confident on both (a 1e-5 change of
# R moves a WTA pick between costs within rounding)
TRAIN_FRAMES, TRAIN_N, TRAIN_TEST, TRAIN_B = 5, 2048, 256, 64
TRAIN_LEARNING = dict(rate=2e-2, rate_decay=1e-5, criterion="nll",
                      batch_size=TRAIN_B)
MS_B, MS_STEPS = 32, 8
TOL_TRAIN_PARAM = 1e-5
TOL_TRAIN_LOSS_REL = 1e-5
TOL_TRAIN_GT = 0.99
# the other families' trainers at full width (ROADMAP A.12): the radial
# trainer at train_radial.py's defaults and BASELINE config4 ('gopro'
# 1280x720 frames, 200x200 polar, hWin 15, the GT's 16x16 window and kernel
# at 720x1280, max_flow 14, n 1000, B=32, lr 1e-2, decay 1e-5), version2 at
# train_v2.py's ('rectified_gopro_small' 340x180, 17x17x32 trunk, 17x17
# window, normalization 17, n 1000, B=32, lr 1e-2) and the legacy depth
# classifier at depth_estimation.py's (360x640, 2 classes, 32x32 patches,
# n 2000, m 500, B=32), each one epoch on frames made from a seed. The
# radial loader is compared card vs CPU at 'gopro' scaled by 0.5: its
# exhaustive GT at 720x1280 (256 displacement planes) would take the CPU
# about a minute. Card vs CPU: the radial epipole is one 8-point fit of
# few-pixel flows (RANSAC's threshold takes every match, C26), so the
# tracks' 1e-6 rounding moves it by pixels and the whole loader is
# printed, not held; R is held within TOL_R where both devices pick the
# same winner of 8 distinct points, and the polar warp and the GT
# projection from the same inputs within TOL_POLAR (intensity) and
# TOL_POLAR_GT (polar rows; sin and cos round apart by an ulp, times radii
# up to ~370 px), the GT mask on TOL_E2E_MASK of the pixels. Version2's
# pairs are held as the flow trainer's; every trainer's weights after 3
# steps within TOL_TRAIN_PARAM and its losses within TOL_TRAIN_LOSS_REL.
FAM_FRAMES, FAM_N, FAM_B = 5, 1000, 32
TOL_POLAR, TOL_POLAR_GT = 1e-3, 1e-3
RAD_ZOOM = (1.003, 1.008)   # top / bottom plane zoom a frame (flow <= 6 px)
LEG_H, LEG_W, LEG_N, LEG_M, LEG_CLASSES = 360, 640, 2000, 500, 2
# B4's dependency floor: the no-arithmetic probe's half-sweeps a timing
PROBE_HALF_SWEEPS = 400


def cuda_ms(fn, reps=5, warmup=1) -> float:
    """Median device time of fn() in ms, CUDA events around each call."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def check(cond, msg):
    if not cond:
        raise AssertionError(msg)


def forward_frames(gen, B, dev):
    """B uint8 640x480 frame pairs, made on ``dev``: bench.py's smooth
    random texture, and the view after the camera moves forward through a
    scene of smoothly varying depth (forward step over depth 1-2% across the
    frame, so flow grows to 3-6 px at the edges). bench.py rolls every pixel
    by 3 px instead; a uniform shift leaves the essential matrix
    undetermined, RANSAC's rotation is then whatever the solver's nullspace
    vector gives, and on the card one item of 128 left the warp band and
    sent the whole 'warp'-mode batch through the gather. A sideways step
    over varying depth is better determined but confuses rotation with
    translation (3e-3 rad between card and CPU); a forward step is not."""
    from depth_estimation_tpu_torch.data import images
    base = torch.rand(B, 120, 160, 3, generator=gen, device=dev)
    t1 = images.scale_batched_device(base, 480, 640)
    coarse = torch.rand(B, 3, 4, 1, generator=gen, device=dev)
    s = 0.01 + 0.01 * images.scale_batched_device(coarse, 480, 640)[..., 0]
    yy = torch.arange(480.0, device=dev)[:, None]
    xx = torch.arange(640.0, device=dev)[None, :]
    xs = (xx - (xx - 320.0) * s).clamp(0, 639)
    ys = (yy - (yy - 240.0) * s).clamp(0, 479)
    x0, y0 = torch.floor(xs), torch.floor(ys)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
    x0, y0 = x0.long(), y0.long()
    x1, y1 = (x0 + 1).clamp(max=639), (y0 + 1).clamp(max=479)
    flat = t1.reshape(B, -1, 3)

    def at(yi, xi):
        idx = (yi * 640 + xi).reshape(B, -1, 1).expand(-1, -1, 3)
        return torch.gather(flat, 1, idx).reshape(B, 480, 640, 3)
    t2 = ((1 - fy) * ((1 - fx) * at(y0, x0) + fx * at(y0, x1))
          + fy * ((1 - fx) * at(y1, x0) + fx * at(y1, x1)))
    return (t1 * 255).to(torch.uint8), (t2 * 255).to(torch.uint8)


def phase_kernels(dev, report):
    """Kernels vs plain versions on the card at the program's shapes."""
    from depth_estimation_tpu_torch.geometry3d import undistort as undist
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.ops import matching, warp
    gen = torch.Generator(device=dev).manual_seed(0)
    liu_err = liu_warp_check(gen, dev)
    irls_err = liu_irls_check(gen, dev)
    f1 = 0.5 * torch.randn(B_CHECK, 150, 290, 10, generator=gen, device=dev)
    f2 = 0.5 * torch.randn(B_CHECK, 165, 305, 10, generator=gen, device=dev)
    b1_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        for mode in ("conf", "marg"):
            marg, conf = mode == "marg", mode == "conf"
            got = matching.match_flow_fused(f1, f2, 16, 16, 8, marg, dt, conf)
            ref = matching.match_flow_fused_plain(f1, f2, 16, 16, marg, dt, conf)
            torch.cuda.synchronize()
            flips = (got[0] != ref[0]).float().mean().item()
            errs = [(a - b).abs().max().item() for a, b in zip(got[1:4], ref[1:4])]
            line = (f"B1 {str(dt)[6:]} {mode}: idx mismatch {flips:.2e}, "
                    f"max err ey {errs[0]:.2e} ex {errs[1]:.2e} "
                    f"pmax {errs[2]:.2e}")
            check(flips <= TOL_FLIP, f"B1 idx mismatch {flips}")
            check(max(errs[:2]) <= TOL_FLOW_PX and errs[2] <= TOL_PROB,
                  f"B1 ey/ex/pmax error {errs}")
            if marg:
                e = (got[4] - ref[4]).abs().max().item()
                line += f" marg {e:.2e}"
                check(e <= TOL_PROB, f"B1 marginal error {e}")
                errs.append(e)
            else:
                c = (got[4] != ref[4]).float().mean().item()
                line += f", conf mismatch {c:.2e}"
                check(c <= TOL_FLIP, f"B1 confidence mismatch {c}")
            b1_err = max(b1_err, max(errs))
            print(line, flush=True)
    # B3: rotation-compensation warps whose displacements lie inside and
    # beyond the band (yaw up to 0.1 rad ~ 15 px at the working focal length)
    cal = ARDRONE
    Ks = cal.K.copy()
    Ks[0] *= 320 / cal.wImg
    Ks[1] *= 180 / cal.hImg
    yaws = torch.tensor([0.0, 0.005, -0.01, 0.02, -0.04, 0.06, 0.1, -0.03])
    c, s = torch.cos(yaws), torch.sin(yaws)
    R = torch.zeros(B_CHECK, 3, 3)
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1], R[:, 2, 0], R[:, 2, 2] = c, s, 1, -s, c
    R = R.to(dev)
    xs, ys = undist.homography_grid(Ks, R, 165, 305)
    jj = torch.arange(305, device=dev)
    beyond = ((xs - jj).abs() > 8).float().mean().item()
    check(0.01 < beyond < 0.9, f"warp test displacements: {beyond} beyond band")
    imgs = torch.randn(B_CHECK, 165, 305, 10, generator=gen, device=dev)
    b3_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        got = warp.banded_bilinear_warp(imgs.to(dt), xs, ys, 8)
        ref = warp.banded_bilinear_warp_plain(imgs.to(dt), xs, ys, 8)
        torch.cuda.synchronize()
        e = (got - ref).abs().max().item()
        print(f"B3 {str(dt)[6:]}: max err {e:.2e} "
              f"({100 * beyond:.1f}% of pixels displaced beyond the band)",
              flush=True)
        check(e <= TOL_WARP, f"B3 error {e}")
        b3_err = max(b3_err, e)
    # B4 at the ground truth's finest level (config2): random planes as the
    # solver builds them
    from depth_estimation_tpu_torch.flow import celiu, sor_kernel
    planes, alpha = sor_planes(gen, GT_B, GT_H, GT_W, dev)
    du, dv = sor_kernel.sor_redblack(*planes, alpha=alpha, n_sor=40)
    rdu, rdv = celiu.sor_plain(*planes, alpha=alpha, n_sor=40)
    torch.cuda.synchronize()
    b4_err = max((du - rdu).abs().max().item(), (dv - rdv).abs().max().item())
    print(f"B4 B={GT_B} {GT_H}x{GT_W} n_sor=40: max err {b4_err:.2e} "
          f"(|du| up to {du.abs().max().item():.2f})", flush=True)
    check(bool(torch.isfinite(du).all() and torch.isfinite(dv).all()),
          "B4 non-finite")
    check(b4_err <= TOL_SOR, f"B4 error {b4_err}")
    # B2 at the matching core's shape
    b2_err = 0.0
    for dt in (torch.float32, torch.bfloat16):
        got = matching.match_flow_fast(f1, f2, 16, 16, 32, dt)
        ref = matching.match_flow_fast_plain(f1, f2, 16, 16, dt)
        torch.cuda.synchronize()
        flips = (got[0] != ref[0]).float().mean().item()
        errs = [(a - b).abs().max().item() for a, b in zip(got[1:], ref[1:])]
        print(f"B2 {str(dt)[6:]}: idx mismatch {flips:.2e}, max err ey "
              f"{errs[0]:.2e} ex {errs[1]:.2e} pmax {errs[2]:.2e}", flush=True)
        check(flips <= TOL_FLIP, f"B2 idx mismatch {flips}")
        check(max(errs[:2]) <= TOL_FLOW_PX and errs[2] <= TOL_PROB,
              f"B2 ey/ex/pmax error {errs}")
        b2_err = max(b2_err, max(errs))
    # B5 at the matching core's shape, f32 (its only storage type), against
    # its twin on the same norms
    from depth_estimation_tpu_torch.ops import matching_experimental as mexp
    got = mexp.match_flow_throughput(f1, f2, 16, 16)
    ref = mexp.match_flow_throughput_plain(*mexp._norms(f1, f2), 16, 16)
    torch.cuda.synchronize()
    flips = (got[0] != ref[0]).float().mean().item()
    errs5 = [(a - b).abs().max().item() for a, b in zip(got[1:], ref[1:])]
    print(f"B5 float32: idx mismatch {flips:.2e}, max err ey {errs5[0]:.2e} "
          f"ex {errs5[1]:.2e} pmax {errs5[2]:.2e}", flush=True)
    check(flips <= TOL_FLIP, f"B5 idx mismatch {flips}")
    check(max(errs5[:2]) <= TOL_FLOW_PX and errs5[2] <= TOL_PROB,
          f"B5 ey/ex/pmax error {errs5}")
    errs = dict(match_fused=b1_err, warp_banded=b3_err, sor_redblack=b4_err,
                match_fast=b2_err, match_throughput=max(errs5),
                liu_warp=liu_err, liu_irls=irls_err)
    report["kernel_vs_plain"] = errs
    return errs


def liu_warp_check(gen, dev):
    """The liu warp kernel (update, warp, noise) against its twin at the
    liu cell's finest shape, and its resize at the pyramid's first step:
    the flow, the warp and the resize bit for bit, the noise within
    TOL_LIU_NOISE_REL. Returns the largest absolute error (0)."""
    from depth_estimation_tpu_torch.benchmarks.speed_of_light import (
        liu_warp_inputs)
    from depth_estimation_tpu_torch.flow import liu_warp
    ins = liu_warp_inputs(gen, LIU_B, LIU_H, LIU_W, LIU_C, dev)
    got = liu_warp.warp_update_noise(*ins, noise=True)
    ref = liu_warp.warp_update_noise_plain(*ins, noise=True)
    img = ins[1][..., :3].contiguous()
    rgot = liu_warp.resize(img, *LIU_NEXT)
    rref = liu_warp.resize_plain(img, *LIU_NEXT)
    torch.cuda.synchronize()
    err = max((a - b).abs().max().item()
              for a, b in zip((*got[:3], rgot), (*ref[:3], rref)))
    noise = ((got[3] - ref[3]).abs() / ref[3].abs()).max().item()
    outside = (got[2] == ins[0]).all(-1).float().mean().item()
    print(f"liu warp B={LIU_B} {LIU_H}x{LIU_W}x{LIU_C}: max err u, v, warp, "
          f"resize to {LIU_NEXT[0]}x{LIU_NEXT[1]}x3 {err:.2e}; noise relative "
          f"err {noise:.2e} ({100 * outside:.2f}% of pixels frame 1's)",
          flush=True)
    check(err == 0.0, f"liu warp kernel not bit for bit: {err}")
    check(noise <= TOL_LIU_NOISE_REL, f"liu warp noise error {noise}")
    return err


# shapes beyond the main paths' (ROADMAP C24), each at small B against the
# twins: B1 in conf and marg mode at more than 16 window rows and more than
# 32 channels, B2 and B5 at windows whose halo fits on no tile (walked in
# bands) and at more than 32 channels
C24_B, C24_H, C24_W = 2, 12, 40
C24_FUSED = [(17, 4, 10), (24, 24, 10), (32, 32, 10), (64, 64, 10),
             (16, 16, 33), (16, 16, 64)]
C24_DECOMPOSED = [(64, 64, 1), (64, 64, 32), (48, 48, 17), (3, 500, 10),
                  (3, 500, 32), (500, 3, 10), (500, 3, 32), (16, 16, 33),
                  (16, 16, 64), (17, 17, 32)]


def phase_general_shapes(dev, report):
    """B1, B2 and B5 against their twins at the C24 shapes; every wrapper
    must take every shape. Returns the largest error of each kernel."""
    from depth_estimation_tpu_torch.ops import matching
    from depth_estimation_tpu_torch.ops import matching_experimental as mexp
    gen = torch.Generator(device=dev).manual_seed(9)

    def feats(maxh, maxw, K):
        return (0.5 * torch.randn(C24_B, C24_H, C24_W, K, generator=gen,
                                  device=dev),
                0.5 * torch.randn(C24_B, C24_H + maxh - 1, C24_W + maxw - 1,
                                  K, generator=gen, device=dev))

    def held(name, got, ref, extra=None):
        torch.cuda.synchronize()
        flips = (got[0] != ref[0]).float().mean().item()
        errs = [(a - b).abs().max().item() for a, b in zip(got[1:4], ref[1:4])]
        row = dict(kernel=name, flips=flips, ey=errs[0], ex=errs[1],
                   pmax=errs[2])
        if extra == "marg":
            row["marg"] = (got[4] - ref[4]).abs().max().item()
        elif extra == "conf":
            row["conf_flips"] = (got[4] != ref[4]).float().mean().item()
        rows.append(row)
        print(f"C24 {name}: idx mismatch {flips:.2e}, max err ey {errs[0]:.2e} "
              f"ex {errs[1]:.2e} pmax {errs[2]:.2e}"
              + (f" marg {row['marg']:.2e}" if "marg" in row else "")
              + (f" conf mismatch {row['conf_flips']:.2e}" if "conf_flips" in row
                 else ""), flush=True)
        check(flips <= TOL_FLIP and row.get("conf_flips", 0) <= TOL_FLIP,
              f"C24 {name}: WTA or gate mismatch {row}")
        check(max(errs[:2]) <= TOL_FLOW_PX and errs[2] <= TOL_PROB
              and row.get("marg", 0) <= TOL_PROB, f"C24 {name}: errors {row}")
        return max(errs + [row.get("marg", 0)])

    rows, worst = [], dict(match_fused=0.0, match_fast=0.0,
                           match_throughput=0.0)
    for maxh, maxw, K in C24_FUSED:
        f1, f2 = feats(maxh, maxw, K)
        plan = matching.fused_plan(maxh, maxw, K)
        for dt in (torch.float32, torch.bfloat16):
            for mode in ("conf", "marg"):
                marg, conf = mode == "marg", mode == "conf"
                got = matching.match_flow_fused(f1, f2, maxh, maxw, 8, marg, dt,
                                                conf)
                ref = matching.match_flow_fused_plain(f1, f2, maxh, maxw, marg,
                                                      dt, conf)
                e = held(f"B1 {str(dt)[6:]} {mode} {maxh}x{maxw} K={K} "
                         f"({plan.block_rows} rows a pass, bands of "
                         f"{plan.band_cols})", got, ref, mode)
                worst["match_fused"] = max(worst["match_fused"], e)
    for maxh, maxw, K in C24_DECOMPOSED:
        f1, f2 = feats(maxh, maxw, K)
        p2 = matching.match_plan(maxh, maxw, K)
        for dt in (torch.float32, torch.bfloat16):
            got = matching.match_flow_fast(f1, f2, maxh, maxw, 8, dt)
            ref = matching.match_flow_fast_plain(f1, f2, maxh, maxw, dt)
            e = held(f"B2 {str(dt)[6:]} {maxh}x{maxw} K={K} (bands "
                     f"{p2.bh}x{p2.bw}, tile {p2.tile[0]}x{p2.tile[1]})",
                     got, ref)
            worst["match_fast"] = max(worst["match_fast"], e)
        p5 = matching.match_plan(maxh, maxw, K, dx_major=False)
        got = mexp.match_flow_throughput(f1, f2, maxh, maxw)
        ref = mexp.match_flow_throughput_plain(*mexp._norms(f1, f2), maxh,
                                               maxw)
        e = held(f"B5 float32 {maxh}x{maxw} K={K} (bands {p5.bh}x{p5.bw}, "
                 f"tile {p5.tile[0]}x{p5.tile[1]})", got, ref)
        worst["match_throughput"] = max(worst["match_throughput"], e)
    report["general_shapes"] = rows
    return worst


def phase_slice(dev, geom, params, report):
    """The online program end to end at full width, B=128, three modes,
    plus the per-frame estimator. Returns the launch counts of this phase."""
    from depth_estimation_tpu_torch import api, api_batched
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.ops import matching, warp
    gen = torch.Generator(device=dev).manual_seed(1)
    t1, t2 = forward_frames(gen, B_MAIN, dev)
    modes = {"fast": FAST, "warp": dict(compensation="warp"),
             "warp_banded": dict(compensation="warp_banded")}
    ests = {name: api_batched.BatchedDepthEstimator(
        geom, params, ARDRONE, head="mean", device=dev, **knobs)
        for name, knobs in modes.items()}
    per = {}
    matching.match_flow_fused.launches = 0
    warp.banded_bilinear_warp.launches = 0
    totals = {"match_fused": 0, "warp_banded": 0}
    for name, est in ests.items():
        b1_0 = matching.match_flow_fused.launches
        b3_0 = warp.banded_bilinear_warp.launches
        est.reset(t1)
        xflow, mask, depth, good = est.next_frames(t2)
        torch.cuda.synchronize()
        b1 = matching.match_flow_fused.launches - b1_0
        b3 = warp.banded_bilinear_warp.launches - b3_0
        shape = (B_MAIN, geom.hImg, geom.wImg)
        check(tuple(xflow.shape) == tuple(mask.shape) == tuple(depth.shape) == shape,
              f"{name}: output shapes {xflow.shape} {mask.shape} {depth.shape}")
        check(tuple(good.shape) == (B_MAIN,), f"{name}: good shape {good.shape}")
        share = good.float().mean().item()
        kept = mask > 0
        check(bool(torch.isfinite(xflow[kept]).all()), f"{name}: non-finite flow")
        check(share >= 0.5, f"{name}: good on only {share:.2f} of the items")
        check(b1 > 0, f"{name}: match_fused kernel not launched")
        if name != "fast":
            check(b3 > 0, f"{name}: warp_banded kernel not launched")
        per[name] = dict(good_share=share, mask_share=kept.float().mean().item(),
                         median_xflow=xflow[kept].median().item(),
                         launches_match_fused=b1, launches_warp_banded=b3)
        print(f"slice {name}: B={B_MAIN} good share {share:.3f}, mask share "
              f"{per[name]['mask_share']:.3f}, median xflow "
              f"{per[name]['median_xflow']:.3f} px, launches B1 {b1} B3 {b3}",
              flush=True)
    # the per-frame estimator, a few frames of the first stream
    est = api.DepthEstimator(geom, params, ARDRONE, head="mean", device=dev)
    b1_0 = matching.match_flow_fused.launches
    est.reset(t1[0])
    for frame in (t2[0], t1[0], t2[0]):
        small, xf, m = est.next_frame_depth(frame, fetch=False)
        check(tuple(xf.shape) == (geom.hImg, geom.wImg), "DepthEstimator shape")
        check(bool(torch.isfinite(xf[m > 0]).all()), "DepthEstimator flow")
    torch.cuda.synchronize()
    b1 = matching.match_flow_fused.launches - b1_0
    check(b1 == 3, f"DepthEstimator: {b1} match_fused launches for 3 frames")
    per["depth_estimator"] = dict(frames=3, launches_match_fused=b1,
                                  mask_share=(m > 0).float().mean().item())
    print(f"slice DepthEstimator: 3 frames, mask share "
          f"{per['depth_estimator']['mask_share']:.3f}, launches B1 {b1}",
          flush=True)
    totals["match_fused"] = matching.match_flow_fused.launches
    totals["warp_banded"] = warp.banded_bilinear_warp.launches
    report["slice"] = per
    return totals, ests, (t1, t2)


def flow_diff(a, b):
    """Per-item agreement of two (xflow, mask, depth, good) outputs."""
    rows = []
    for i in range(a[0].shape[0]):
        ma, mb = a[1][i] > 0, b[1][i] > 0
        sel = ma & mb
        d = (a[0][i] - b[0][i]).abs()[sel] if sel.any() else torch.zeros(1)
        rows.append(dict(good=[bool(a[3][i]), bool(b[3][i])],
                         mask_agreement=(ma == mb).float().mean().item(),
                         kept=sel.float().mean().item(),
                         mean=d.mean().item(),
                         p99=torch.quantile(d, 0.99).item(),
                         max=d.max().item()))
    return rows


def ego_trace(est, u1, u2):
    """The stages of ``est``'s ego-motion from states u1 to u2, on their
    device: corners, LK tracks, RANSAC's winning sample and its number of
    distinct points, and R."""
    from depth_estimation_tpu_torch.geometry3d import egomotion as ego
    from depth_estimation_tpu_torch.models.multiscale import avg_downsample
    r = est.ego_downsample
    K = est.K_scaled.copy()
    K[:2] /= r
    e1, e2 = avg_downsample(u1, r), avg_downsample(u2, r)
    sfm = est.cal.sfm
    pts, pvalid = ego.good_features_to_track_batched(
        e1, sfm.max_points, sfm.points_quality, selector=est.corner_selector)
    pts2, status = ego.track_lk_windowed_batched(
        e1, e2, pts, n_iters=est.lk_iters, search=est.lk_search)
    valid = pvalid & status
    noise = est.ransac_noise.to(u1.device)
    idx, _, inls = ego.ransac_hypotheses(pts, pts2, valid, K, noise)
    best = inls.argmax(-1)
    winners = idx[torch.arange(idx.shape[0]), best]
    em = ego.get_ego_motion_from_matches_batched(pts, pts2, valid, K, noise)
    return dict(pts=pts.cpu(), pvalid=pvalid.cpu(), pts2=pts2.cpu(),
                status=status.cpu(), winner=best.tolist(),
                distinct=[len(set(w.tolist())) for w in winners],
                R=em.R.cpu())


def phase_card_vs_cpu(dev, geom, params, report):
    """The same package on the card and on the CPU (plain versions), same
    RANSAC noise, B_CMP different pairs, in f32 'warp_banded' mode and in
    fast mode: end to end, and ego-motion stage by stage from the card's
    prep. Every reading is printed before any check."""
    from depth_estimation_tpu_torch import api_batched
    from depth_estimation_tpu_torch.geometry3d import egomotion
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    f1, f2 = forward_frames(torch.Generator().manual_seed(13), B_CMP, "cpu")
    out = {}
    for mode, knobs in (("warp_banded", dict(compensation="warp_banded")),
                        ("fast", FAST)):
        noise = egomotion.gumbel_noise(knobs.get("ransac_samples", 64),
                                       ARDRONE.sfm.max_points, "cpu")
        ests = {d: api_batched.BatchedDepthEstimator(
            geom, params, ARDRONE, head="mean", device=d, ransac_noise=noise,
            **knobs) for d in ("cuda", "cpu")}
        outs, states = {}, {}
        for d, est in ests.items():
            est.reset(f1)
            u1, feats1 = est.last_u, est.last_feats
            outs[d] = [t.cpu() for t in est.next_frames(f2)]
            states[d] = (u1, est.last_u, feats1)
        u1, u2, feats1 = states["cuda"]
        trace = {"cuda": ego_trace(ests["cuda"], u1, u2),
                 "cpu": ego_trace(ests["cpu"], u1.cpu(), u2.cpu())}
        tc, tp = trace["cuda"], trace["cpu"]
        ok = tc["status"] & tp["status"]
        res = dict(
            rows=flow_diff(outs["cuda"], outs["cpu"]),
            trunk_features_max_diff=(feats1.cpu().float()
                                     - states["cpu"][2].float()).abs().max().item(),
            corners_equal=bool(torch.equal(tc["pts"], tp["pts"])
                               and torch.equal(tc["pvalid"], tp["pvalid"])),
            lk_status_equal=bool(torch.equal(tc["status"], tp["status"])),
            lk_max_diff_px=(tc["pts2"] - tp["pts2"]).abs()[ok].max().item(),
            winner=[tc["winner"], tp["winner"]], distinct=tc["distinct"],
            R_max_diff=(tc["R"] - tp["R"]).abs().amax((1, 2)).tolist())
        out[mode] = res
        print(f"card vs CPU, {mode}: trunk features max diff "
              f"{res['trunk_features_max_diff']:.2e}; from the card's prep: "
              f"corners equal {res['corners_equal']}, LK status equal "
              f"{res['lk_status_equal']}, tracks max diff "
              f"{res['lk_max_diff_px']:.2e} px", flush=True)
        for i, r in enumerate(res["rows"]):
            print(f"card vs CPU, {mode}, pair {i}: RANSAC winner "
                  f"{tc['winner'][i]}/{tp['winner'][i]} ({tc['distinct'][i]} "
                  f"distinct points), R max diff {res['R_max_diff'][i]:.2e}; "
                  f"good {r['good']}, mask agreement {r['mask_agreement']:.5f}, "
                  f"xflow diff mean {r['mean']:.2e} p99 {r['p99']:.2e} "
                  f"max {r['max']:.2e} px on {r['kept']:.3f} of pixels",
                  flush=True)
    report["card_vs_cpu"] = out
    for mode, res in out.items():
        check(res["corners_equal"] and res["lk_status_equal"],
              f"{mode}: corners or LK status differ")
        check(res["lk_max_diff_px"] <= TOL_TRACK_PX,
              f"{mode}: LK tracks differ by {res['lk_max_diff_px']}")
        check(res["winner"][0] == res["winner"][1],
              f"{mode}: RANSAC winners differ {res['winner']}")
        for i, r in enumerate(res["rows"]):
            check(r["good"][0] == r["good"][1], f"{mode}: good differs")
            check(r["mask_agreement"] >= TOL_E2E_MASK,
                  f"{mode}: mask agreement {r['mask_agreement']}")
            check(r["kept"] > 0.2, f"{mode}: too few pixels kept")
            if res["distinct"][i] == 8:
                check(res["R_max_diff"][i] <= TOL_R,
                      f"{mode}, pair {i}: R differs by {res['R_max_diff'][i]}")
                check(r["mean"] <= TOL_E2E_MEAN_PX and r["p99"] <= TOL_E2E_P99_PX,
                      f"{mode}, pair {i}: xflow difference {r}")


def shifted_textures(gen, B, H, W, shift, dev):
    """B smooth random RGB scenes made on ``dev`` from a seed (uniform noise
    under a sigma-2 Gaussian), seen twice: (im1, im2), each (B, H, W, 3)
    f32, where a feature at x in im1 appears at x + shift in im2 (so the
    flow is +shift px along x). On these the liu solve is well-conditioned:
    a 1-ulp change of one input moves u by under 1e-5 px at 192x256. On
    bilinear upscales of coarse noise it is not (up to 17 px at single
    pixels), and card and CPU then part by the solver's own chaos."""
    from depth_estimation_tpu_torch.flow import celiu
    base = torch.rand(B, H, W + shift, 3, generator=gen, device=dev)
    big = celiu.gaussian_smooth(base, 2.0, 6)
    return (big[:, :, shift:shift + W].contiguous(),
            big[:, :, :W].contiguous())


def diff_stats(a, b):
    d = (a.float().cpu() - b.float().cpu()).abs().flatten()
    return dict(mean=d.mean().item(), p99=torch.quantile(d, 0.99).item(),
                max=d.max().item())


def liu_irls_inputs(gen, dev):
    """An IRLS step's inputs at the liu cell's finest shape: (im1f, warp,
    u, v, lap_para, du, dv), lap_para's last channel 0 (its Psi masked)."""
    im1, im2, u, v, du, dv = liu_warp_inputs(gen, LIU_B, LIU_H, LIU_W, LIU_C,
                                             dev)
    lap = 0.05 * torch.rand(LIU_B, LIU_C, generator=gen, device=dev)
    lap[:, -1] = 0.0
    return im1, im2, u, v, lap, du, dv


def liu_irls_check(gen, dev):
    """The liu IRLS kernel against its twin (``celiu._irls_planes``) at the
    liu cell's finest shape, a cold and a warm step: the nine planes bit
    for bit. Returns the largest absolute error (0)."""
    from depth_estimation_tpu_torch.flow import celiu, liu_irls
    im1, im2, u, v, lap, du, dv = liu_irls_inputs(gen, dev)
    err = 0.0
    for warm in ({}, dict(du=du, dv=dv)):
        got = liu_irls.irls_planes(im1, im2, u, v, lap, alpha=0.005, **warm)
        ref = celiu._irls_planes(im1, im2, u, v, lap, alpha=0.005,
                                 noise_model="lap", **warm)
        torch.cuda.synchronize()
        err = max([err] + [(a - b).abs().max().item()
                           for a, b in zip(got, ref)])
    print(f"liu IRLS B={LIU_B} {LIU_H}x{LIU_W}x{LIU_C}, cold and warm: max "
          f"err of the nine planes {err:.2e}", flush=True)
    check(err == 0.0, f"liu IRLS kernel not bit for bit: {err}")
    return err


def phase_gt(dev, geom, report):
    """The flow ground truth at full size: the 'liu' solve at config2 with
    B4's launches read around it, one pair card vs CPU, and the exhaustive
    GT at car_model's geometry card vs CPU. Returns the launch counts of B4,
    the liu warp kernel and the IRLS kernel, and the frames."""
    from depth_estimation_tpu_torch.data import groundtruth as gt
    from depth_estimation_tpu_torch.flow import celiu, sor_kernel
    gen = torch.Generator(device=dev).manual_seed(3)
    im1, im2 = shifted_textures(gen, GT_B, GT_H, GT_W, GT_SHIFT, dev)
    from depth_estimation_tpu_torch.flow import liu_irls, liu_warp
    sor_kernel.sor_redblack.launches = 0
    liu_warp.warp_update_noise.launches = liu_warp.resize.launches = 0
    liu_irls.irls_planes.launches = 0
    u, v, warped = celiu.coarse2fine_flow_batched(im1, im2, **GT_SCHEDULE)
    torch.cuda.synchronize()
    launches = sor_kernel.sor_redblack.launches
    warps, resizes = (liu_warp.warp_update_noise.launches,
                      liu_warp.resize.launches)
    irls = liu_irls.irls_planes.launches
    check(tuple(u.shape) == tuple(v.shape) == (GT_B, GT_H, GT_W)
          and tuple(warped.shape) == (GT_B, GT_H, GT_W, 3), "GT shapes")
    check(bool(torch.isfinite(u).all() and torch.isfinite(v).all()),
          "GT non-finite flow")
    med_u = u[:, 12:-12, 12:-12].flatten(1).median(dim=1).values
    med_v = v[:, 12:-12, 12:-12].flatten(1).median(dim=1).values
    print(f"GT liu config2: B={GT_B} {GT_H}x{GT_W}x3, {launches} B4 launches, "
          f"{warps} liu warp, {resizes} resize and {irls} IRLS launches, "
          f"median inner x-flow {med_u.min().item():.4f}..{med_u.max().item():.4f} "
          f"px (shift {GT_SHIFT}), y-flow {med_v.abs().max().item():.4f} px",
          flush=True)
    check(launches == GT_SOR_CALLS, f"B4 launched {launches} times, "
          f"expected {GT_SOR_CALLS}")
    check(warps == GT_WARPS and resizes == GT_RESIZES, f"liu warp kernel "
          f"launched {warps} and {resizes} times, expected {GT_WARPS} and "
          f"{GT_RESIZES}")
    check(irls == GT_IRLS, f"liu IRLS kernel launched {irls} times, "
          f"expected {GT_IRLS}")
    check(bool(((med_u - GT_SHIFT).abs() < 0.25).all()
               and (med_v.abs() < 0.25).all()), f"GT shift not recovered: "
          f"{med_u.tolist()} {med_v.tolist()}")
    cu, cv, _ = celiu.coarse2fine_flow_batched(im1[:1].cpu(), im2[:1].cpu(),
                                               **GT_SCHEDULE)
    su, sv = diff_stats(u[:1], cu), diff_stats(v[:1], cv)
    print(f"GT liu card vs CPU, 1 pair: u diff mean {su['mean']:.2e} p99 "
          f"{su['p99']:.2e} max {su['max']:.2e}; v diff mean {sv['mean']:.2e} "
          f"p99 {sv['p99']:.2e} max {sv['max']:.2e} px", flush=True)
    # the exhaustive GT (cross-correlation), car_model's geometry
    g1, g2 = shifted_textures(gen, 2, geom.hImg, geom.wImg, 3, dev)
    card = gt.exhaustive_flow_batched(geom, g1, g2, device=dev)
    cpu = gt.exhaustive_flow_batched(geom, g1.cpu(), g2.cpu(), device="cpu")
    flips = max(float((a != b).mean()) for a, b in zip(card[:2], cpu[:2]))
    conf_off = float((card[2] != cpu[2]).mean())
    inner = card[1][:, 30:-30, 30:-30]
    print(f"GT exhaustive {geom.hImg}x{geom.wImg}, {geom.maxhGT}x"
          f"{geom.maxwGT} window, {geom.hKernelGT}x{geom.wKernelGT} kernel, "
          f"2 pairs card vs CPU: flow differs on {flips:.2e} of pixels, "
          f"confidence on {conf_off:.2e}; median inner x-flow "
          f"{float(np.median(inner)):.1f} px (shift 3)", flush=True)
    report["gt"] = dict(liu_launches_sor=launches, liu_launches_warp=warps,
                        liu_launches_resize=resizes, liu_launches_irls=irls,
                        median_u=med_u.tolist(),
                        card_vs_cpu_u=su, card_vs_cpu_v=sv,
                        exhaustive_flip_share=flips,
                        exhaustive_conf_mismatch=conf_off)
    check(su["mean"] <= TOL_GT_MEAN_PX and sv["mean"] <= TOL_GT_MEAN_PX
          and su["max"] <= TOL_GT_MAX_PX and sv["max"] <= TOL_GT_MAX_PX,
          f"GT card vs CPU: {su} {sv}")
    check(flips <= TOL_GT_FLIP and conf_off <= TOL_GT_FLIP,
          f"GT exhaustive card vs CPU: {flips} {conf_off}")
    check(abs(float(np.median(inner)) - 3) < 0.5, "GT exhaustive shift")
    return launches, warps, irls, (im1, im2)


@torch.no_grad()
def matching_core(model, frames1, frames2, matcher="fast"):
    """bench.py's matching core with the port: normalise the uint8 frames,
    resize to the working size, run the trunk, crop the reference branch,
    match, and apply the x-flow depth rule. ``matcher``: "fast" is B2 on
    bf16 storage (bench.py's program), "throughput" is B5 (f32)."""
    from depth_estimation_tpu_torch.api_batched import depth_from_xflow
    from depth_estimation_tpu_torch.data import images
    from depth_estimation_tpu_torch.models.flow import crop_features_center
    from depth_estimation_tpu_torch.ops import matching, matching_experimental
    g = model.geometry
    small1 = images.scale_batched_device(frames1.float() / 255.0, g.hImg, g.wImg)
    small2 = images.scale_batched_device(frames2.float() / 255.0, g.hImg, g.wImg)
    f1 = crop_features_center(g, model.features(small1))
    f2 = model.features(small2)
    if matcher == "fast":
        idx, ey, ex, pmax = matching.match_flow_fast(f1, f2, g.maxh, g.maxw, 32,
                                                     torch.bfloat16)
    else:
        idx, ey, ex, pmax = matching_experimental.match_flow_throughput(
            f1, f2, g.maxh, g.maxw)
    return idx, ex, ey, depth_from_xflow(ex, ex.shape[-1]), pmax, (f1, f2)


def phase_matching_core(dev, card, report):
    """The matching core at B=128 through B2, its launches read around one
    run; B2's answer beside B1's on the same features; frame-pairs/s."""
    from depth_estimation_tpu_torch.models import flow as flow_model
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.ops import matching
    geom, trunk = mio.load_filter(CAR_MODEL, device=dev)
    model = flow_model.FlowModel(geom, trunk)
    t1, t2 = forward_frames(torch.Generator(device=dev).manual_seed(4),
                            B_MAIN, dev)
    matching.match_flow_fast.launches = 0
    _, ex, ey, depth, pmax, (f1, f2) = matching_core(model, t1, t2)
    torch.cuda.synchronize()
    launches = matching.match_flow_fast.launches
    shape = (B_MAIN, geom.hImg - geom.maxh + 1 - geom.hKernel + 1,
             geom.wImg - geom.maxw + 1 - geom.wKernel + 1)
    check(tuple(ex.shape) == tuple(depth.shape) == shape,
          f"matching core shapes {ex.shape} {depth.shape}")
    check(bool(torch.isfinite(ex).all() and torch.isfinite(ey).all()
               and torch.isfinite(pmax).all()), "matching core non-finite")
    check(launches == 1, f"B2 launched {launches} times in one run")
    fused = matching.match_flow_fused(f1, f2, geom.maxh, geom.maxw, 8, False,
                                      torch.bfloat16)
    fast = matching.match_flow_fast(f1, f2, geom.maxh, geom.maxw, 32,
                                    torch.bfloat16)
    agree = (fast[0] == fused[0]).float().mean().item()
    dex = (fast[2] - fused[2]).abs()
    ms = cuda_ms(lambda: matching_core(model, t1, t2))
    fps = B_MAIN / (ms / 1e3)
    print(f"matching core: B={B_MAIN} uint8 640x480 -> {geom.hImg}x{geom.wImg}"
          f" -> trunk -> B2 bf16, {launches} B2 launch; median |x-flow| "
          f"{ex.abs().median().item():.3f} px; B2 vs B1 on the same features: "
          f"WTA equal on {agree:.5f}, x-flow diff mean {dex.mean().item():.2e} "
          f"max {dex.max().item():.2e} px", flush=True)
    print(f"[{card}] matching core: {ms:.1f} ms per B={B_MAIN} step = "
          f"{fps:.1f} frame-pairs/s", flush=True)
    report["matching_core"] = dict(launches_match_fast=launches, ms=ms,
                                   fps=fps, b2_vs_b1_wta_agree=agree,
                                   b2_vs_b1_xflow_mean=dex.mean().item())
    check(agree >= 0.99 and dex.mean().item() <= 1e-2,
          f"B2 vs B1 on the matching core: {agree} {dex.mean().item()}")
    return launches


def phase_throughput_core(dev, card, report):
    """The matching core at B=128 through B5 (f32), its launches read around
    one run; B5's WTA beside B2's (f32) on the same features; frame-pairs/s."""
    from depth_estimation_tpu_torch.models import flow as flow_model
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.ops import matching
    from depth_estimation_tpu_torch.ops import matching_experimental as mexp
    geom, trunk = mio.load_filter(CAR_MODEL, device=dev)
    model = flow_model.FlowModel(geom, trunk)
    t1, t2 = forward_frames(torch.Generator(device=dev).manual_seed(5),
                            B_MAIN, dev)
    mexp.match_flow_throughput.launches = 0
    idx, ex, ey, depth, pmax, (f1, f2) = matching_core(model, t1, t2,
                                                       "throughput")
    torch.cuda.synchronize()
    launches = mexp.match_flow_throughput.launches
    shape = (B_MAIN, geom.hImg - geom.maxh + 1 - geom.hKernel + 1,
             geom.wImg - geom.maxw + 1 - geom.wKernel + 1)
    check(tuple(ex.shape) == tuple(depth.shape) == shape,
          f"throughput core shapes {ex.shape} {depth.shape}")
    check(bool(torch.isfinite(ex).all() and torch.isfinite(ey).all()
               and torch.isfinite(pmax).all()), "throughput core non-finite")
    check(launches == 1, f"B5 launched {launches} times in one run")
    fast = matching.match_flow_fast(f1, f2, geom.maxh, geom.maxw, 32,
                                    torch.float32)
    agree = (idx == fast[0]).float().mean().item()
    dex = (ex - fast[2]).abs()
    ms = cuda_ms(lambda: matching_core(model, t1, t2, "throughput"))
    fps = B_MAIN / (ms / 1e3)
    print(f"throughput core: B={B_MAIN} uint8 640x480 -> {geom.hImg}x"
          f"{geom.wImg} -> trunk -> B5 f32, {launches} B5 launch; median "
          f"|x-flow| {ex.abs().median().item():.3f} px; B5 vs B2 (f32) on the "
          f"same features: WTA equal on {agree:.6f}, x-flow diff max "
          f"{dex.max().item():.2e} px", flush=True)
    print(f"[{card}] throughput core: {ms:.1f} ms per B={B_MAIN} step = "
          f"{fps:.1f} frame-pairs/s", flush=True)
    report["throughput_core"] = dict(launches_match_throughput=launches,
                                     ms=ms, fps=fps, b5_vs_b2_wta_agree=agree,
                                     b5_vs_b2_xflow_max=dex.max().item())
    check(agree >= TOL_AGREE, f"B5 vs B2 WTA agreement {agree}")
    return launches


def working_frames(seed, B, h, w, dev):
    """B pairs of forward_frames, normalised and resized to h x w."""
    from depth_estimation_tpu_torch.data import images
    t1, t2 = forward_frames(torch.Generator(device=dev).manual_seed(seed), B,
                            dev)
    return (images.scale_batched_device(t1.float() / 255.0, h, w),
            images.scale_batched_device(t2.float() / 255.0, h, w))


@torch.no_grad()
def phase_multiscale(dev, card, report):
    """BASELINE config3 at full width: the staged decode at B=64 in f16 and
    f32 storage (timed), decode_full against forward_full's argmax on the
    card at B=4, and one pair card vs CPU."""
    from depth_estimation_tpu_torch import codecs
    from depth_estimation_tpu_torch.geometry import Geometry
    from depth_estimation_tpu_torch.models import multiscale as ms
    g = Geometry(**C3_GEOMETRY)
    m32 = ms.MultiscaleFlowModel(g, device=dev).init(
        torch.Generator().manual_seed(30))
    m16 = ms.MultiscaleFlowModel(g, decode_dtype=torch.float16, device=dev)
    m16.load_state_dict(m32.state_dict())
    s1, s2 = working_frames(6, C3_B, g.hImg, g.wImg, dev)
    n_idx = codecs.n_indices(g)
    outs = {}
    for name, m in (("f16", m16), ("f32", m32)):
        idx, pmax = m.decode_full_staged(s1, s2)
        torch.cuda.synchronize()
        check(tuple(idx.shape) == tuple(pmax.shape) == (C3_B, g.hImg, g.wImg),
              f"config3 {name} shapes {idx.shape}")
        check(bool(torch.isfinite(pmax).all() and (idx >= 0).all()
                   and (idx < n_idx).all()), f"config3 {name} outputs")
        outs[name] = (idx, pmax)
    f16_agree = (outs["f16"][0] == outs["f32"][0]).float().mean().item()
    times = {name: cuda_ms(lambda m=m: m.decode_full_staged(s1, s2))
             for name, m in (("f16", m16), ("f32", m32))}
    # decode_full equals the argmax (middle tie-break) and max of the full
    # distribution, on the card
    a1, a2 = s1[:C3_CHECK_B], s2[:C3_CHECK_B]
    dist = m32.forward_full(a1, a2)
    idx, pmax = m32.decode_full(a1, a2)
    mid = codecs.middle_index(g)
    bm = dist.amax(-1)
    tie = dist[..., mid] >= bm
    want = torch.where(tie, torch.full_like(idx, mid),
                       dist.argmax(-1).to(torch.int32))
    want_p = torch.where(tie, dist[..., mid], bm) / dist.sum(-1)
    inv_equal = (idx == want).float().mean().item()
    inv_p = ((pmax - want_p).abs() / want_p).max().item()
    del dist
    # one pair, card vs CPU (the same weights)
    cpu = ms.MultiscaleFlowModel(g, device="cpu")
    cpu.load_state_dict(m32.state_dict())
    cidx, cp = cpu.decode_full(s1[0].cpu(), s2[0].cpu())
    cvc_agree = (outs["f32"][0][0].cpu() == cidx).float().mean().item()
    cvc_p = (outs["f32"][1][0].cpu() - cp).abs().max().item()
    fps = {k: C3_B / (v / 1e3) for k, v in times.items()}
    print(f"config3 multiscale {g.hImg}x{g.wImg} trunk {g.layers} "
          f"{g.maxh}x{g.maxw} ratios {g.ratios}: decode_full vs forward_full "
          f"argmax at B={C3_CHECK_B} equal on {inv_equal:.6f}, pmax rel diff "
          f"{inv_p:.2e}; card vs CPU (1 pair) idx equal on {cvc_agree:.6f}, "
          f"pmax diff {cvc_p:.2e}; f16 vs f32 decode idx equal on "
          f"{f16_agree:.4f}", flush=True)
    for k in ("f16", "f32"):
        print(f"[{card}] config3 staged decode {k}: B={C3_B} {times[k]:.1f} ms"
              f" = {fps[k]:.1f} frames/s", flush=True)
    report["config3"] = dict(ms=times, fps=fps, invariant_equal=inv_equal,
                             invariant_pmax_rel=inv_p, card_vs_cpu_equal=cvc_agree,
                             card_vs_cpu_pmax=cvc_p, f16_vs_f32_equal=f16_agree)
    check(inv_equal == 1.0 and inv_p <= 1e-5,
          f"config3 decode_full vs forward_full: {inv_equal} {inv_p}")
    check(cvc_agree >= TOL_AGREE and cvc_p <= TOL_PROB,
          f"config3 card vs CPU: {cvc_agree} {cvc_p}")


@torch.no_grad()
def phase_radial(dev, card, report):
    """BASELINE config4 at full width: forward-motion frames warped to
    200x200 polar images, flow_batch at B=64 (timed), one pair card vs CPU,
    and one cartesian frame through cartesian2polar, the network and
    flow2depth."""
    from depth_estimation_tpu_torch.geometry3d import polar
    from depth_estimation_tpu_torch.models.radial import RadialFlowNetwork
    net = RadialFlowNetwork(C4_LAYERS, C4_HWIN, device=dev).init(
        torch.Generator().manual_seed(40))
    h, w = C4_CART
    s1, s2 = working_frames(7, C4_B, h, w, dev)
    grid = polar.get_c2p_grid(w, h, C4_W, C4_H, device=dev)
    p1 = torch.stack([polar.cartesian2polar(f, grid) for f in s1])
    p2 = torch.stack([polar.cartesian2polar(f, grid) for f in s2])
    flow, mcost = net.flow_batch(p1, p2)
    torch.cuda.synchronize()
    shape = (C4_B, C4_H - net.h_kernel + 1 - C4_HWIN + 1, C4_W - net.w_kernel + 1)
    check(tuple(flow.shape) == tuple(mcost.shape) == shape,
          f"config4 shapes {flow.shape}")
    check(bool(((flow >= 0) & (flow < C4_HWIN)).all()
               and torch.isfinite(mcost).all()), "config4 outputs")
    ms_ = cuda_ms(lambda: net.flow_batch(p1, p2))
    fps = C4_B / (ms_ / 1e3)
    cpu = RadialFlowNetwork(C4_LAYERS, C4_HWIN, device="cpu")
    cpu.load_state_dict(net.state_dict())
    cflow, cmcost = cpu.flow(p1[0].cpu(), p2[0].cpu())
    agree = (flow[0].cpu() == cflow).float().mean().item()
    rel = ((mcost[0].cpu() - cmcost).abs().max() / cmcost.abs().max()).item()
    # one cartesian frame end to end, epipole at the image centre
    fl, _ = net.flow(polar.cartesian2polar(s1[0], grid),
                     polar.cartesian2polar(s2[0], grid))
    depth, confs = polar.flow2depth(h, w, fl, (w / 2, h / 2))
    check(bool(torch.isfinite(depth).all() and (depth >= 0).all())
          and tuple(depth.shape) == tuple(confs.shape) == shape[1:],
          "config4 flow2depth")
    print(f"config4 radial polar {C4_H}x{C4_W} hWin {C4_HWIN} {C4_LAYERS}: "
          f"card vs CPU (1 pair) flow equal on {agree:.6f}, min cost max rel "
          f"diff {rel:.2e}; cartesian {h}x{w} frame -> polar -> flow -> depth: "
          f"median depth {depth[confs > 0].median().item():.3f}, confident "
          f"{confs.float().mean().item():.3f}", flush=True)
    print(f"[{card}] config4 flow_batch: B={C4_B} {ms_:.2f} ms = {fps:.1f} "
          f"frames/s", flush=True)
    report["config4"] = dict(ms=ms_, fps=fps, card_vs_cpu_equal=agree,
                             card_vs_cpu_min_cost_rel=rel)
    check(agree >= TOL_AGREE and rel <= TOL_RADIAL_COST_REL,
          f"config4 card vs CPU: {agree} {rel}")


V2_B = 64                # the version2 cell's pairs a step
V2_TIE = 1e-4            # |logit gap| under which two cells' WTA may swap


@torch.no_grad()
def phase_version2(dev, card, report):
    """The version2 network at its defaults (180x320, contrastive
    normalization, 17x17x32 trunk, 17x17 window): one pair's costs card vs
    CPU; flow_batch at B=64 (timed), B2 and the normalisation kernel N1
    launched once each in it, N1 held bit for bit to its twin on the 128
    frames and timed (one call, back to back) beside its bytes bounds and
    the twin, and B2 held against its twin on the same cropped features
    (WTA swaps only at near-ties of the logit). Returns B2's launches in
    one flow_batch, its largest error and its time alone at that shape, and
    N1's row of the kernels line."""
    from depth_estimation_tpu_torch.models.flow import crop_features_center
    from depth_estimation_tpu_torch.models.version2 import V2Network
    from depth_estimation_tpu_torch.ops import matching
    from depth_estimation_tpu_torch.ops import normalization as norm
    net = V2Network(device=dev).init(torch.Generator().manual_seed(50))
    g = net.geometry
    s1, s2 = working_frames(8, 1, g.hImg, g.wImg, dev)
    costs = net.costs(s1[0], s2[0])
    cpu = V2Network(device="cpu")
    cpu.load_state_dict(net.state_dict())
    ccosts = cpu.costs(s1[0].cpu(), s2[0].cpu())
    check(tuple(costs.shape) == tuple(ccosts.shape)
          and bool(torch.isfinite(costs).all()), f"version2 costs {costs.shape}")
    d = (costs.cpu() - ccosts).abs()
    rel = (d.max() / ccosts.abs().max()).item()
    rel_each = (d / ccosts.abs().clamp(min=1e-3)).max().item()
    agree = (costs.argmin(-1).cpu() == ccosts.argmin(-1)).float().mean().item()
    print(f"version2 {g.hImg}x{g.wImg} trunk {g.layers} {g.maxh}x{g.maxw}: "
          f"costs {tuple(costs.shape)} card vs CPU max diff / max cost "
          f"{rel:.2e} (elementwise {rel_each:.2e}), WTA equal on {agree:.6f}",
          flush=True)
    check(rel <= TOL_COST_REL, f"version2 card vs CPU: {rel}")
    del costs, ccosts, d

    # flow_batch at the cell's shape
    t1, t2 = working_frames(9, V2_B, g.hImg, g.wImg, dev)
    matching.match_flow_fast.launches = 0
    norm.contrastive_norm.launches = 0
    out = net.flow_batch(t1, t2)
    torch.cuda.synchronize()
    launches = matching.match_flow_fast.launches
    n1_launches = norm.contrastive_norm.launches
    check(launches == 1, f"B2 launched {launches} times in one flow_batch")
    check(n1_launches == 1,
          f"N1 launched {n1_launches} times in one flow_batch")
    k = net.datap.normalization_k
    frames = torch.cat((t1, t2))
    n = norm.spatial_contrastive_normalization(frames, k)
    n_twin = norm.spatial_contrastive_normalization_plain(frames, k)
    n1_equal = bool(torch.equal(n, n_twin))
    n1_err = float((n - n_twin).abs().max())
    del n_twin
    check(n1_equal, "N1 differs from its twin on the flow_batch's frames")
    ms_n1 = cuda_ms(lambda: norm.spatial_contrastive_normalization(frames, k))
    ms_n1_b2b = cuda_ms(lambda: [norm.spatial_contrastive_normalization(
        frames, k) for _ in range(20)], reps=3) / 20
    ms_n1_twin = cuda_ms(
        lambda: norm.spatial_contrastive_normalization_plain(frames, k),
        reps=3)
    # the bounds, bytes either way (4 passes of k taps, a multiply and an
    # add a tap and channel): the frames read and the output written once;
    # N1's own, the frames read twice and the local mean and std written,
    # read back and reduced
    n_px = frames.numel() // frames.shape[-1]
    flops = 4 * 2 * k * frames.numel()
    bound_io, bound_by = bound_ms(2 * frames.numel() * 4, flops)
    bound_stats = bound_ms((3 * frames.numel() + 5 * n_px) * 4, flops)[0]
    print(f"[{card}] version2 N1 (contrastive_norm.cu) on {tuple(frames.shape)}, "
          f"k={k}: {n1_launches} call in flow_batch, bit for bit the twin: "
          f"{n1_equal}; {ms_n1:.3f} ms one call, {ms_n1_b2b:.3f} ms a call "
          f"back to back; bytes bound {bound_io:.3f} ms (frames in, output "
          f"out), {bound_stats:.3f} ms (N1's reads and writes); twin "
          f"{ms_n1_twin:.2f} ms", flush=True)
    del frames
    f = net.filter(n)
    f1, f2 = crop_features_center(g, f[:V2_B]), f[V2_B:]
    shape = (V2_B,) + tuple(f1.shape[1:3])
    check(all(tuple(o.shape) == shape for o in out)
          and bool(all(torch.isfinite(o).all() for o in out[1:])),
          f"version2 flow_batch outputs {[tuple(o.shape) for o in out]}")
    got = matching.match_flow_fast(f1, f2, g.maxh, g.maxw)
    same = all(bool(torch.equal(a, b)) for a, b in zip(out, got))
    flips, near, errs = 0, True, [0.0, 0.0, 0.0]
    for a in range(0, V2_B, 8):
        ref = matching.match_flow_fast_plain(f1[a:a + 8], f2[a:a + 8],
                                             g.maxh, g.maxw)
        flip = got[0][a:a + 8] != ref[0]
        flips += int(flip.sum())
        if flip.any():
            top2 = torch.topk(-matching.match_ssd(f1[a:a + 8], f2[a:a + 8],
                                                  g.maxh, g.maxw), 2,
                              dim=-1).values
            near &= bool(((top2[..., 0] - top2[..., 1])[flip] < V2_TIE).all())
        errs = [max(e, (x[a:a + 8] - y).abs().max().item())
                for e, x, y in zip(errs, got[1:], ref[1:])]
    flip_share = flips / got[0].numel()
    ms_batch = cuda_ms(lambda: net.flow_batch(t1, t2))
    ms_b2 = cuda_ms(lambda: matching.match_flow_fast(f1, f2, g.maxh, g.maxw))
    p2 = matching.match_plan(g.maxh, g.maxw, f1.shape[-1])
    print(f"version2 flow_batch B={V2_B}: {launches} B2 launch; B2 f32 "
          f"{g.maxh}x{g.maxw} K={f1.shape[-1]} (bands {p2.bh}x{p2.bw}, tile "
          f"{p2.tile[0]}x{p2.tile[1]}) vs its twin on the same features: idx "
          f"mismatch {flip_share:.2e} (all at logit gaps < {V2_TIE}: {near}), "
          f"max err ey {errs[0]:.2e} ex {errs[1]:.2e} pmax {errs[2]:.2e}; "
          f"flow_batch equals B2 on those features: {same}", flush=True)
    print(f"[{card}] version2 flow_batch: B={V2_B} {ms_batch:.2f} ms = "
          f"{V2_B / (ms_batch / 1e3):.1f} pairs/s; B2 alone {ms_b2:.3f} ms",
          flush=True)
    report["version2"] = dict(card_vs_cpu_rel=rel, elementwise_rel=rel_each,
                              wta_equal=agree, launches_match_fast=launches,
                              b2_idx_mismatch=flip_share,
                              b2_flips_near_ties=near,
                              b2_max_abs_err=max(errs),
                              flow_batch_equals_b2=same,
                              flow_batch_ms=ms_batch, b2_ms=ms_b2,
                              n1_launches=n1_launches, n1_equal=n1_equal,
                              n1_ms=ms_n1, n1_ms_back_to_back=ms_n1_b2b,
                              n1_bound_ms=[bound_io, bound_stats],
                              n1_twin_ms=ms_n1_twin)
    check(near and flip_share <= TOL_FLIP,
          f"version2 B2 vs twin: idx mismatch {flip_share}, near ties {near}")
    check(max(errs[:2]) <= TOL_FLOW_PX and errs[2] <= TOL_PROB,
          f"version2 B2 vs twin: errors {errs}")
    check(same, "version2 flow_batch differs from B2 on its own features")
    n1 = {"name": "contrastive_norm", "route": "cuda",
          "source": "depth_estimation_tpu_torch/csrc/contrastive_norm.cu",
          "replaces": "none (depth_estimation_tpu/ops/normalization.py: jnp)",
          "launches": n1_launches, "max_abs_err": n1_err, "ms": ms_n1,
          "plain_ms": ms_n1_twin, "bound_ms": bound_io, "bound_by": bound_by,
          "library_ms": None, "ms_back_to_back": ms_n1_b2b,
          "bound_ms_own_traffic": bound_stats}
    return launches, max(errs), ms_b2, n1


def kernel_label(mangled):
    """A short name for a kernel's mangled name: the decomposed matcher's
    template arguments spelled out, other names as they are."""
    import re
    m = re.search(r"match_decomposed_kernelI(f|13__nv_bfloat16|6__half)Lb"
                  r"([01])ELi(\d+)ELi(\d+)ELi(\d+)E", mangled)
    if not m:
        return mangled
    dt = {"f": "f32", "13__nv_bfloat16": "bf16", "6__half": "f16"}[m.group(1)]
    order = "dx-major" if m.group(2) == "1" else "dy-major"
    return (f"match_decomposed<{dt}, {order}, KC={m.group(3)}, "
            f"{m.group(4)}x{m.group(5)}>")


def ptxas_table(log):
    """Registers and spills of every kernel in the build log (nvcc -Xptxas
    -v): one row a kernel."""
    import re
    rows, source, name, spill = [], "", None, (0, 0)
    for line in log.splitlines():
        if line.startswith("== "):
            source = line[3:].strip()
        elif m := re.search(r"Function properties for (\S+)", line):
            name = m.group(1)
        elif m := re.search(r"(\d+) bytes spill stores, (\d+) bytes spill "
                            r"loads", line):
            spill = (int(m.group(1)), int(m.group(2)))
        elif (m := re.search(r"Used (\d+) registers", line)) and name:
            rows.append(dict(source=source, kernel=kernel_label(name),
                             registers=int(m.group(1)),
                             spill_stores=spill[0], spill_loads=spill[1]))
            name, spill = None, (0, 0)
    return rows


def sass_per_cell(lib, stem, dt, dx_major, kc, rx, ry):
    """Instructions a cell of one decomposed-matcher instantiation, read
    from its SASS (cuobjdump --dump-sass of the built library): the largest
    basic block whose exps are a multiple of rx * ry is the walk's body
    for halo positions where every pixel's cell lies in its window, one exp
    a cell, so its length over its exps is the instructions a cell, the
    loop's counter and branch included. Returns (per cell, the block's
    opcode counts), or None without cuobjdump."""
    import re
    from depth_estimation_tpu_torch.ops import _kernels
    tool = os.path.join(os.path.dirname(_kernels._nvcc()), "cuobjdump")
    if not os.path.exists(tool):
        return None
    out = subprocess.run([tool, "--dump-sass", str(lib.paths[stem])],
                         capture_output=True, text=True, check=True).stdout
    want = ({torch.float32: "If", torch.bfloat16: "I13__nv_bfloat16",
             torch.float16: "I6__half"}[dt]
            + f"Lb{int(dx_major)}ELi{kc}ELi{rx}ELi{ry}E")
    blocks, block, inside = [], [], False
    for line in out.splitlines():
        if "Function :" in line:
            if inside:
                break
            inside = "match_decomposed_kernel" in line and want in line
            continue
        if not inside:
            continue
        if re.match(r"\s*\.L_x_\d+:", line):
            blocks.append(block)
            block = []
            continue
        m = re.search(r"/\*[0-9a-f]{4,}\*/\s+(.*?);", line)
        if not m:
            continue
        op = m.group(1).split()
        op = op[1] if op[0].startswith("@") else op[0]
        if op != "NOP":
            block.append(op)
        if op.split(".")[0] in ("BRA", "EXIT", "RET", "BRX", "JMP", "CALL"):
            blocks.append(block)
            block = []
    blocks.append(block)
    def exps(b):
        return sum(o.startswith("MUFU.EX2") for o in b)
    body = max((b for b in blocks if exps(b) and exps(b) % (rx * ry) == 0),
               key=len, default=None)
    if not body:
        return None
    counts = {}
    for o in body:
        counts[o.split(".")[0]] = counts.get(o.split(".")[0], 0) + 1
    return len(body) / exps(body), dict(sorted(counts.items(),
                                               key=lambda kv: -kv[1]))


def b4_over_solve(im1, im2):
    """B4 over one config2 solve, level by level: the device time of its
    launches (torch.profiler, in launch order, coarsest level first) and
    the dependency floor of the level's plan, the cost of one half-sweep's
    cluster barrier and boundary-row exchange (the no-arithmetic probe
    timed at 0 and PROBE_HALF_SWEEPS / 2 iterations) times the level's
    dependent half-sweeps."""
    from torch.profiler import ProfilerActivity, profile
    from depth_estimation_tpu_torch.flow import celiu, sor_kernel
    s = GT_SCHEDULE
    shapes = [tuple(p.shape[-3:-1])
              for p in celiu.build_pyramid(im1, s["ratio"], s["min_width"])]
    levels = [(k, shapes[k], s["n_outer"] + k, s["n_sor"] + 3 * k)
              for k in range(len(shapes) - 1, -1, -1)]
    celiu.coarse2fine_flow_batched(im1, im2, **s)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        celiu.coarse2fine_flow_batched(im1, im2, **s)
        torch.cuda.synchronize()
    events = sorted((e for e in prof.events()
                     if "sor_cluster_kernel" in e.name),
                    key=lambda e: e.time_range.start)
    durs = [e.time_range.elapsed_us() / 1e3 for e in events]
    check(len(durs) == sum(lv[2] for lv in levels),
          f"profiler saw {len(durs)} B4 launches in a solve")
    n = PROBE_HALF_SWEEPS // 2
    out, i = [], 0
    for k, (h, w), calls, n_sor in levels:
        def probe(m, h=h, w=w):
            return lambda: [sor_kernel.sor_barrier_probe(GT_B, h, w, m)
                            for _ in range(10)]
        t = cuda_ms(probe(n)) / 10 - cuda_ms(probe(0)) / 10
        half_us = 1e3 * t / (2 * n)
        out.append(dict(level=k, H=h, W=w, plan=list(sor_kernel.sor_plan(h, w)),
                        calls=calls, n_sor=n_sor,
                        device_ms=sum(durs[i:i + calls]),
                        half_sweep_floor_us=half_us,
                        floor_ms=calls * 2 * n_sor * half_us / 1e3))
        i += calls
    return out


def phase_timing(dev, card, ests, frames, gt_frames, report):
    from depth_estimation_tpu_torch.ops import _kernels, matching, warp
    from depth_estimation_tpu_torch.geometry3d import undistort as undist
    t1, t2 = frames
    fps = {}
    for name in ("fast", "warp"):
        est = ests[name]
        u1, feats1 = est._prep(t1)
        ms = cuda_ms(lambda: est._step(u1, feats1, t2))
        fps[name] = B_MAIN / (ms / 1e3)
        print(f"[{card}] slice {name}: B={B_MAIN} step {ms:.1f} ms = "
              f"{fps[name]:.1f} frame-pairs/s", flush=True)
    # kernels at the main path's shapes (B=128), vs their plain versions
    gen = torch.Generator(device=dev).manual_seed(2)
    f1 = 0.5 * torch.randn(B_MAIN, 150, 290, 10, generator=gen, device=dev)
    f2 = 0.5 * torch.randn(B_MAIN, 165, 305, 10, generator=gen, device=dev)
    rows = {}
    for dt in (torch.float32, torch.bfloat16):
        k = cuda_ms(lambda: matching.match_flow_fused(f1, f2, 16, 16, 8, False,
                                                      dt, True))
        p = cuda_ms(lambda: matching.match_flow_fused_plain(
            f1, f2, 16, 16, False, dt, True), reps=3)
        # the general kernel on the same shape (16 rows a pass, one band,
        # K rounded to 16), the path the plan takes beyond the unblocked one
        gp = matching.FusedPlan(True, 16, 16, 0)
        g = cuda_ms(lambda: matching._match_flow_fused_cuda(
            f1, f2, 16, 16, False, dt, True, 0.11, gp))
        rows[f"match_fused_{str(dt)[6:]}"] = (k, p)
        rows[f"match_fused_{str(dt)[6:]}_general"] = g
        print(f"[{card}] B1 match_fused {str(dt)[6:]} conf, B={B_MAIN} "
              f"150x290x10 16x16: kernel {k:.3f} ms, plain {p:.1f} ms; the "
              f"general kernel on this shape {g:.3f} ms", flush=True)
    Ks = ests["warp"].K_scaled
    R = torch.eye(3, device=dev).expand(B_MAIN, 3, 3).clone()
    R[:, 0, 2], R[:, 2, 0] = 0.01, -0.01
    xs, ys = undist.homography_grid(Ks, R, 165, 305)
    imgs = torch.randn(B_MAIN, 165, 305, 10, generator=gen, device=dev)
    # the library yardstick: grid_sample (bilinear, zero padding, corners
    # aligned) on the channels-last image seen as NCHW, with a normalised
    # grid computed beforehand; it matches B3 wherever the displacement lies
    # in the band. bf16 takes a bf16 grid and gives bf16 output.
    import torch.nn.functional as F
    norm = torch.stack((2 * xs / (305 - 1) - 1, 2 * ys / (165 - 1) - 1), -1)
    inband = (((xs - torch.arange(305, device=dev)).abs() <= 8)
              & ((ys - torch.arange(165, device=dev)[:, None]).abs() <= 8))
    for dt in (torch.float32, torch.bfloat16):
        im = imgs.to(dt)
        k = cuda_ms(lambda: warp.banded_bilinear_warp(im, xs, ys, 8))
        p = cuda_ms(lambda: warp.banded_bilinear_warp_plain(im, xs, ys, 8))
        nchw, grid = im.permute(0, 3, 1, 2), norm.to(dt)

        def library():
            return F.grid_sample(nchw, grid, mode="bilinear",
                                 padding_mode="zeros", align_corners=True)
        lib_ms = cuda_ms(library)
        # 10 calls back to back, so that the card, not the wrapper's host
        # work, sets the pace (ms a call)
        k10 = cuda_ms(lambda: [warp.banded_bilinear_warp(im, xs, ys, 8)
                               for _ in range(10)]) / 10
        lib10 = cuda_ms(lambda: [library() for _ in range(10)]) / 10
        rows[f"warp_banded_{str(dt)[6:]}"] = (k, p)
        rows[f"warp_banded_{str(dt)[6:]}_library"] = lib_ms
        rows[f"warp_banded_{str(dt)[6:]}_back_to_back"] = (k10, lib10)
        same = ""
        if dt == torch.float32:      # a bf16 grid rounds the coordinates
            d = (library().permute(0, 2, 3, 1)
                 - warp.banded_bilinear_warp(im, xs, ys, 8))[inband]
            same = (f"; vs B3 on the {inband.float().mean().item():.3f} of "
                    f"pixels in the band: max diff {d.abs().max().item():.2e}")
        print(f"[{card}] B3 warp_banded {str(dt)[6:]}, B={B_MAIN} 165x305x10 "
              f"band 8: kernel {k:.3f} ms, plain {p:.3f} ms, grid_sample "
              f"{lib_ms:.3f} ms (NCHW view of the channels-last image, "
              f"{str(dt)[6:]} output{same}); 10 back to back: kernel "
              f"{k10:.3f}, grid_sample {lib10:.3f} ms a call", flush=True)
    # B2 and B5 at the matching core's shape, in the same call as B1
    # above: the wrappers on the plan's blocking (B2 with its f32 -> bf16
    # cast, B5 with its norms, which the kernel now computes), then every
    # compiled blocking through the same wrappers
    from depth_estimation_tpu_torch.ops import matching_experimental as mexp
    plan = matching.match_plan(16, 16, 10)
    print(f"B2/B5 plan at 16x16, K=10: {plan.rx}x{plan.ry} pixels a thread, "
          f"{plan.tx}x{plan.ty} threads, tile {plan.tile[0]}x{plan.tile[1]}, "
          f"halo {plan.smem} B, {matching.resident_warps(plan)} warps an SM",
          flush=True)
    blockings = {}
    for dt in (torch.float32, torch.bfloat16):
        k = cuda_ms(lambda: matching.match_flow_fast(f1, f2, 16, 16, 32, dt))
        p = cuda_ms(lambda: matching.match_flow_fast_plain(f1, f2, 16, 16, dt),
                    reps=3)
        rows[f"match_fast_{str(dt)[6:]}"] = (k, p)
        print(f"[{card}] B2 match_fast {str(dt)[6:]}, B={B_MAIN} 150x290x10 "
              f"16x16: kernel {k:.3f} ms, plain {p:.1f} ms (B1 same shape: "
              f"{rows['match_fused_' + str(dt)[6:]][0]:.3f} ms)", flush=True)
    k = cuda_ms(lambda: mexp.match_flow_throughput(f1, f2, 16, 16))
    p = cuda_ms(lambda: mexp.match_flow_throughput_plain(
        *mexp._norms(f1, f2), 16, 16), reps=3)
    rows["match_throughput"] = (k, p)
    print(f"[{card}] B5 match_throughput float32, B={B_MAIN} 150x290x10 16x16: "
          f"kernel {k:.3f} ms with its norms, plain {p:.1f} ms (B2 same "
          f"shape: {rows['match_fast_float32'][0]:.3f} ms)", flush=True)
    for rx, ry in matching.BLOCKINGS[10]:
        bp = matching.plan_for(16, 16, 10, (rx, ry))
        times = [cuda_ms(lambda: matching._match_flow_fast_cuda(
                     f1, f2, 16, 16, dt, bp))
                 for dt in (torch.bfloat16, torch.float32)]
        times.append(cuda_ms(lambda: mexp._match_flow_throughput_cuda(
            f1, f2, 16, 16, bp)))
        blockings[f"{rx}x{ry}"] = dict(zip(("b2_bf16", "b2_f32", "b5"), times),
                                       tile=list(bp.tile), threads=bp.tx * bp.ty,
                                       warps_an_sm=matching.resident_warps(bp))
        print(f"[{card}] blocking {rx}x{ry} (tile {bp.tile[0]}x{bp.tile[1]}, "
              f"{bp.tx * bp.ty} threads, {matching.resident_warps(bp)} warps "
              f"an SM): B2 bf16 {times[0]:.3f} ms, B2 f32 {times[1]:.3f} ms, "
              f"B5 {times[2]:.3f} ms", flush=True)
    # B4 at the ground truth's finest level, and one config2 solve
    from depth_estimation_tpu_torch.flow import celiu, sor_kernel
    planes, alpha = sor_planes(gen, GT_B, GT_H, GT_W, dev)
    k = cuda_ms(lambda: sor_kernel.sor_redblack(*planes, alpha=alpha,
                                                 n_sor=40))
    # 10 calls back to back, so that the card, not the wrapper's host work,
    # sets the pace (ms a call)
    k10 = cuda_ms(lambda: [sor_kernel.sor_redblack(*planes, alpha=alpha,
                                                   n_sor=40)
                           for _ in range(10)]) / 10
    p = cuda_ms(lambda: celiu.sor_plain(*planes, alpha=alpha, n_sor=40))
    rows["sor_redblack"] = (k, p)
    print(f"[{card}] B4 sor_redblack, B={GT_B} {GT_H}x{GT_W} n_sor=40: "
          f"kernel {k:.3f} ms for one call (the wrapper's host work "
          f"included), {k10:.3f} ms a call back to back, plain {p:.3f} ms; "
          f"plan {tuple(sor_kernel.sor_plan(GT_H, GT_W))} (cluster, rows, "
          f"mode)", flush=True)
    # the liu warp kernel, its resize and the IRLS kernel (a cold step) at
    # the liu cell's finest shape
    from depth_estimation_tpu_torch.flow import liu_irls, liu_warp
    ins = liu_warp_inputs(gen, LIU_B, LIU_H, LIU_W, LIU_C, dev)
    img = ins[1][..., :3].contiguous()
    irls_in = liu_irls_inputs(gen, dev)[:5]
    for name, kern, plain, work in (
            ("liu_warp",
             lambda: liu_warp.warp_update_noise(*ins, noise=True),
             lambda: liu_warp.warp_update_noise_plain(*ins, noise=True),
             liu_warp_work(ins[0])),
            ("liu_resize", lambda: liu_warp.resize(img, *LIU_NEXT),
             lambda: liu_warp.resize_plain(img, *LIU_NEXT),
             resize_work(img, *LIU_NEXT)),
            ("liu_irls",
             lambda: liu_irls.irls_planes(*irls_in, alpha=0.005),
             lambda: celiu._irls_planes(*irls_in, alpha=0.005,
                                        noise_model="lap"),
             liu_irls_work(irls_in[0]))):
        one, one_plain = cuda_ms(kern), cuda_ms(plain)
        ten = cuda_ms(lambda: [kern() for _ in range(10)]) / 10
        ten_plain = cuda_ms(lambda: [plain() for _ in range(10)]) / 10
        rows[name] = (one, one_plain)
        rows[f"{name}_back_to_back"] = (ten, ten_plain)
        b = bound_ms(*work)
        print(f"[{card}] {name}, B={LIU_B} {LIU_H}x{LIU_W}: kernel {one:.3f} "
              f"ms for one call, {ten:.3f} ms a call back to back; twin "
              f"{one_plain:.3f} / {ten_plain:.3f} ms; bound {b[0]:.4f} ms "
              f"({b[1]})", flush=True)
    im1, im2 = gt_frames
    ms = cuda_ms(lambda: celiu.coarse2fine_flow_batched(im1, im2,
                                                        **GT_SCHEDULE), reps=3)
    fps["gt_liu_config2"] = GT_B / (ms / 1e3)
    print(f"[{card}] GT liu config2 solve: B={GT_B} {GT_H}x{GT_W}x3 "
          f"{ms:.1f} ms = {fps['gt_liu_config2']:.2f} pairs/s", flush=True)
    solve = b4_over_solve(im1, im2)
    for lv in solve:
        print(f"[{card}] B4 in the solve, level {lv['level']} {lv['H']}x"
              f"{lv['W']}: {lv['calls']} launches x n_sor {lv['n_sor']}, "
              f"device {lv['device_ms']:.3f} ms; plan {tuple(lv['plan'])}, "
              f"one half-sweep's barrier and exchange "
              f"{lv['half_sweep_floor_us']:.3f} us, floor {lv['floor_ms']:.3f}"
              f" ms", flush=True)
    b4_solve = dict(levels=solve, back_to_back_ms=k10,
                    device_ms=sum(lv["device_ms"] for lv in solve),
                    floor_ms=sum(lv["floor_ms"] for lv in solve),
                    launches=sum(lv["calls"] for lv in solve),
                    half_sweeps=sum(2 * lv["calls"] * lv["n_sor"]
                                    for lv in solve))
    print(f"[{card}] B4 over one config2 solve: {b4_solve['launches']} "
          f"launches, {b4_solve['half_sweeps']} dependent half-sweeps, device "
          f"{b4_solve['device_ms']:.3f} ms, dependency floor "
          f"{b4_solve['floor_ms']:.3f} ms", flush=True)
    # bounds from this run's inputs
    bounds = {
        # at the online program's fast-mode storage, bf16 (f32 printed too)
        "match_fused": matcher_bound(f1.to(torch.bfloat16),
                                     f2.to(torch.bfloat16), 16, 16, 5,
                                     3 * 10 + 5),
        "match_fused_float32": matcher_bound(f1, f2, 16, 16, 5, 3 * 10 + 5),
        "match_fast": matcher_bound(f1.to(torch.bfloat16), f2.to(torch.bfloat16),
                                    16, 16, 4, 2 * 10 + 3 + 7),
        "match_throughput": matcher_bound(f1, f2, 16, 16, 4, 2 * 10 + 3 + 7),
        "warp_banded": bound_ms(*warp_work(imgs, xs, ys)),
        "warp_banded_bfloat16": bound_ms(*warp_work(
            torch.empty(imgs.shape, dtype=torch.bfloat16, device="meta"),
            xs, ys)),
        "sor_redblack": bound_ms(*sor_work(planes, 40)),
        "liu_warp": bound_ms(*liu_warp_work(ins[0])),
        "liu_resize": bound_ms(*resize_work(img, *LIU_NEXT)),
        "liu_irls": bound_ms(*liu_irls_work(irls_in[0])),
    }
    for name, (b, by) in bounds.items():
        print(f"bound {name}: {b:.4f} ms ({by})", flush=True)
    # the SM clock while B2 (f32) runs back to back, read by nvidia-smi
    # halfway through ~1 s of queued launches
    clock = sm_clock_under(
        lambda: matching.match_flow_fast(f1, f2, 16, 16, 32, torch.float32),
        1000 / rows["match_fast_float32"][0])
    print(f"[{card}] SM clock and power draw with B2 running: "
          f"{clock['clocks.sm']} MHz, {clock['power.draw']} W", flush=True)
    # B2's and B5's issue floor: the SASS instructions a cell of the plan's
    # instantiation, over 132 SMs x 128 lanes at 1.98 GHz (and at the clock
    # read above)
    lib = _kernels.library()
    cells = f1.shape[0] * f1.shape[1] * f1.shape[2] * 16 * 16
    floors = {}
    for name, stem, dt, dxm in (("match_fast", "match_fast", torch.bfloat16,
                                 True),
                                ("match_fast_float32", "match_fast",
                                 torch.float32, True),
                                ("match_throughput", "match_throughput",
                                 torch.float32, False)):
        got = sass_per_cell(lib, stem, dt, dxm, 10, plan.rx, plan.ry)
        if got is None:
            print(f"issue floor {name}: not measured (no cuobjdump or body "
                  f"not found)", flush=True)
            continue
        per_cell, ops = got
        ms = 1e3 * per_cell * cells / (132 * 128 * CLOCK_HZ)
        at_clock = ms * CLOCK_HZ / (1e6 * clock["clocks.sm"])
        floors[name] = dict(per_cell=per_cell, ms=ms, ms_at_read_clock=at_clock,
                            ops=ops)
        print(f"issue floor {name}: {per_cell:.2f} SASS instructions a cell "
              f"({plan.rx}x{plan.ry} body: {ops}) -> {ms:.4f} ms at 1.98 GHz, "
              f"{at_clock:.4f} ms at {clock['clocks.sm']} MHz", flush=True)
    report["timing"] = dict(card=card, fps=fps, kernels_ms=rows,
                            bounds_ms=bounds, b4_solve=b4_solve,
                            plan=plan._asdict(), blockings=blockings,
                            issue_floors=floors, clock_under_b2=clock)
    return rows, bounds, b4_solve, floors


# ---------------------------------------------------------------------------
# the training phase
# ---------------------------------------------------------------------------

def write_png(path, rgb):
    """uint8 (H, W, 3) as an 8-bit RGB PNG (the package's encoder)."""
    from depth_estimation_tpu_torch.data import images
    with open(path, "wb") as f:
        f.write(images.encode_png(rgb))


def forward_sequence(seed, n, h=480, w=640):
    """n uint8 frames of a camera stepping forward through a scene of
    smoothly varying depth, made with numpy: frame k samples a smooth
    random texture at (p - c)(1 - k s(p)) + c, s 2-4% a step (the style of
    forward_frames, with its k-th step; flow reaches 3-6 px at the edges of
    the 320x180 working size, inside the 16x16 GT window)."""
    from depth_estimation_tpu_torch.data import images
    rng = np.random.RandomState(seed)
    base = images.scale_np(rng.rand(h // 4, w // 4, 3).astype(np.float32), h, w)
    s = 0.02 + 0.02 * images.scale_np(rng.rand(3, 4).astype(np.float32), h, w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    return [sample_u8(base, w / 2 + (xx - w / 2) * (1.0 - k * s),
                      h / 2 + (yy - h / 2) * (1.0 - k * s))
            for k in range(n)]


def sample_u8(base, xs, ys):
    """base (H, W, 3) in [0, 1] sampled bilinearly at (ys, xs), clamped to
    the frame, as uint8."""
    h, w = base.shape[:2]
    xs, ys = np.clip(xs, 0, w - 1), np.clip(ys, 0, h - 1)
    x0, y0 = np.floor(xs).astype(int), np.floor(ys).astype(int)
    x1, y1 = np.minimum(x0 + 1, w - 1), np.minimum(y0 + 1, h - 1)
    fx, fy = (xs - x0)[..., None], (ys - y0)[..., None]
    img = ((1 - fy) * ((1 - fx) * base[y0, x0] + fx * base[y0, x1])
           + fy * ((1 - fx) * base[y1, x0] + fx * base[y1, x1]))
    return (np.clip(img, 0, 1) * 255).astype(np.uint8)


def loader_trace(frames, cal, noise, dev, undistort=True):
    """The 'sfm' loader's ego-motion on ``dev`` (the polar loader's with
    ``undistort=False``): per pair, RANSAC's winning sample's number of
    distinct points, R, and the winning sample's indices."""
    from depth_estimation_tpu_torch.geometry3d import egomotion as ego
    from depth_estimation_tpu_torch.geometry3d import undistort as undist
    prevs = torch.as_tensor(np.stack(frames[:-1]), dtype=torch.float32, device=dev)
    imgs = torch.as_tensor(np.stack(frames[1:]), dtype=torch.float32, device=dev)
    u1, u2 = prevs, imgs
    if undistort:
        u1 = undist.undistort_image(prevs, cal.K, cal.distortion)
        u2 = undist.undistort_image(imgs, cal.K, cal.distortion)
    pts, pvalid = ego.good_features_to_track_batched(
        u1, cal.sfm.max_points, cal.sfm.points_quality)
    pts2, status = ego.track_lk_batched(u1, u2, pts)
    valid = pvalid & status
    noise = noise.to(dev)
    idx, _, inls = ego.ransac_hypotheses(pts, pts2, valid, cal.K, noise)
    winners = idx[torch.arange(idx.shape[0]), inls.argmax(-1)]
    em = ego.get_ego_motion_from_matches_batched(pts, pts2, valid, cal.K, noise)
    return ([len(set(w.tolist())) for w in winners], em.R.cpu(),
            [tuple(w.tolist()) for w in winners])


def interleave(raw):
    """(warped previous, current) pairs of a loaded dataset in the
    samplers' layout: images, flows and masks."""
    images, flows, masks = [], [], []
    for k in range(len(raw["flow"])):
        images.extend([raw["warped_images"][k], raw["images"][k]])
        flows.extend([raw["flow"][k], None])
        masks.extend([raw["masks"][k], None])
    return images, flows[:-1], masks[:-1]


def trainer_pair(cls, geom, lrn, seed, dev):
    """The same seeded weights in a trainer on the card and one on the CPU."""
    card = cls(geom, lrn, device=dev).init(torch.Generator().manual_seed(seed))
    cpu = cls(geom, lrn, device="cpu").reset_optimizer()
    cpu.model.load_state_dict(card.model.state_dict())
    return card, cpu


def max_param_diff(a, b):
    sa, sb = a.state_dict(), b.state_dict()
    return max((sa[k].cpu() - sb[k].cpu()).abs().max().item() for k in sa)


def device_profile(fn):
    """One call of fn (after one warm-up) under torch.profiler: the number
    of kernels it ran on the card and their summed device time in ms."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    ev = [e for e in prof.events()
          if getattr(e, "device_type", None) == DeviceType.CUDA
          and e.name not in ("Buffer Flush", "Activity Buffer Request")]
    return len(ev), sum(e.time_range.elapsed_us() for e in ev) / 1e3


def phase_training(dev, card, report):
    """The flow trainer's path on the card: frames on disk -> 'sfm' rectified
    pairs + GT (and one pair through the 'liu' GT, B4) -> patches -> the
    single-scale trainer at car_model width and the multiscale trainer at
    config3's -> scoring -> a checkpoint -> the online estimator on it (B1).
    Every kernel count is zeroed before and read after. Returns the counts
    and the timings."""
    from depth_estimation_tpu_torch import api_batched
    from depth_estimation_tpu_torch.data import datasets
    from depth_estimation_tpu_torch.data.images import ImageLoader
    from depth_estimation_tpu_torch.flow import sor_kernel
    from depth_estimation_tpu_torch.geometry import Geometry, Learning
    from depth_estimation_tpu_torch.geometry3d import egomotion as ego
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.ops import matching, matching_experimental, warp
    from depth_estimation_tpu_torch.training import curves, train
    t_phase = time.perf_counter()
    geom, _, _, _ = mio.load_model(CAR_MODEL)
    cal = ARDRONE
    counters = {"match_fused": matching.match_flow_fused,
                "warp_banded": warp.banded_bilinear_warp,
                "match_fast": matching.match_flow_fast,
                "sor_redblack": sor_kernel.sor_redblack,
                "match_throughput": matching_experimental.match_flow_throughput}
    for fn in counters.values():
        fn.launches = 0
    out = {}
    tmp = tempfile.TemporaryDirectory()
    root = tmp.name
    frames_u8 = forward_sequence(21, TRAIN_FRAMES, cal.hImg, cal.wImg)
    write_frames(root, frames_u8)
    noise = ego.gumbel_noise(64, cal.sfm.max_points, "cpu")

    # 1. the loader on the card
    raw = datasets.load_data_optical_flow(geom, cal, root, TRAIN_FRAMES,
                                          motion_correction="sfm",
                                          noise=noise, device=dev)
    torch.cuda.synchronize()
    n_pairs = len(raw["flow"])
    good = [f is not None for f in raw["flow"]]
    loader = ImageLoader(root, cal.hImg, cal.wImg)
    frames = [loader.get_next_frame() for _ in range(TRAIN_FRAMES)]
    pairs = {d: datasets.load_rectified_pairs_batched(geom, cal, frames,
                                                      noise=noise, device=d)
             for d in (dev, "cpu")}
    conf_share = [float((p.conf > 0).mean()) if p.good else 0.0
                  for p in pairs[dev]]
    check(n_pairs == TRAIN_FRAMES - 1, f"loader made {n_pairs} pairs")
    print(f"training: loader 'sfm' + cross-correlation GT, {n_pairs} pairs of "
          f"{cal.hImg}x{cal.wImg} PNG frames -> {geom.hImg}x{geom.wImg}: good "
          f"{sum(good)}/{n_pairs}, GT confident share "
          f"{[round(c, 4) for c in conf_share]}", flush=True)
    check(sum(good) >= n_pairs // 2, f"loader: good on {good}")

    # 2. card vs CPU, the same frames and RANSAC noise
    distinct, r_card, _ = loader_trace(frames, cal, noise, dev)
    _, r_cpu, _ = loader_trace(frames, cal, noise, "cpu")
    rows = []
    for k in range(n_pairs):
        a, b = pairs[dev][k], pairs["cpu"][k]
        row = dict(good=[a.good, b.good], distinct=distinct[k],
                   R_max_diff=(r_card[k] - r_cpu[k]).abs().max().item())
        if a.good and b.good:
            d = np.abs(a.prev_warped - b.prev_warped)
            both = (a.conf > 0) & (b.conf > 0)
            row.update(warp_mean=float(d.mean()),
                       warp_p99=float(np.quantile(d, 0.99)),
                       mask_agreement=float((a.mask == b.mask).mean()),
                       gt_equal=float((a.flow == b.flow).all(0)[both].mean()),
                       gt_both_confident=float(both.mean()))
        rows.append(row)
        print(f"training: loader card vs CPU, pair {k}: {row}", flush=True)
    out["loader_card_vs_cpu"] = rows

    # 3. one pair through the 'liu' GT (B4)
    b4_0 = sor_kernel.sor_redblack.launches
    liu = datasets.load_rectified_pair(geom, cal, frames[0], frames[1],
                                       groundtruth="liu", noise=noise,
                                       device=dev)
    torch.cuda.synchronize()
    b4 = sor_kernel.sor_redblack.launches - b4_0
    print(f"training: load_rectified_pair 'liu', good {liu.good}, {b4} B4 "
          f"launches", flush=True)
    check(b4 > 0, "the liu GT launched no B4")
    check(liu.good and liu.flow is not None and np.isfinite(liu.flow).all(),
          "liu pair")

    # 4. single-scale training at car_model width
    images, flows, masks = interleave(raw)
    lrn = Learning(**TRAIN_LEARNING)
    rng = np.random.RandomState(0)
    ds = train.sample_patches(geom, lrn, images, flows, masks, TRAIN_N, rng)
    test_ds = train.sample_patches(geom, lrn, images, flows, masks,
                                   TRAIN_TEST, rng)
    check(len(ds) == TRAIN_N and len(test_ds) == TRAIN_TEST,
          f"sampled {len(ds)} / {len(test_ds)} patches")
    trainer, cpu_trainer = trainer_pair(train.Trainer, geom, lrn, 0, dev)
    t0 = time.perf_counter()
    m = trainer.epoch(ds, shuffle_rng=np.random.RandomState(1))
    epoch_s = time.perf_counter() - t0
    losses = m["losses"]
    first8, last8 = float(np.mean(losses[:8])), float(np.mean(losses[-8:]))
    print(f"training: Trainer car_model width, B={TRAIN_B}, {len(losses)} "
          f"steps in {epoch_s:.1f} s: loss first 8 {first8:.4f}, last 8 "
          f"{last8:.4f}, acc {m['acc']:.4f}, grad_ok all "
          f"{all(m['grad_ok'])}", flush=True)
    out["trainer"] = dict(losses=losses, accs=m["accs"], first8=first8,
                          last8=last8, epoch_s=epoch_s)
    check(len(losses) == TRAIN_N // TRAIN_B, f"{len(losses)} steps")
    check(all(m["grad_ok"]), "a training step had non-finite gradients")
    check(last8 < first8, f"loss did not fall: {first8} -> {last8}")
    sel = torch.arange(TRAIN_B, device=dev)
    x1 = torch.as_tensor(ds.patches1[:TRAIN_B], device=dev)
    x2 = torch.as_tensor(ds.patches2[:TRAIN_B], device=dev)
    it = torch.as_tensor(ds.itargets[:TRAIN_B], device=dev)
    yx = torch.as_tensor(ds.targets_yx[:TRAIN_B], device=dev)
    for crit in ("soft", "mse"):
        other = train.Trainer(geom, Learning(**dict(
            TRAIN_LEARNING, criterion=crit, soft_targets=crit == "soft")),
            device=dev).reset_optimizer()
        other.model.load_state_dict(trainer.model.state_dict())
        aux = other.step(x1, x2, it, other.soft_targets(yx[sel], TRAIN_B))
        out[f"step_{crit}"] = dict(loss=aux["loss"].item(),
                                   grad_ok=bool(aux["grad_ok"]))
        print(f"training: one {crit} step, loss {out[f'step_{crit}']['loss']:.4f}"
              f", grad_ok {out[f'step_{crit}']['grad_ok']}", flush=True)
        check(out[f"step_{crit}"]["grad_ok"]
              and np.isfinite(out[f"step_{crit}"]["loss"]), f"{crit} step")

    # 5. card vs CPU: 3 steps from the same weights on the same batches
    small = train.PatchDataset(ds.patches1[:3 * TRAIN_B], ds.patches2[:3 * TRAIN_B],
                               ds.targets_yx[:3 * TRAIN_B], ds.itargets[:3 * TRAIN_B])
    cmp_card, cmp_cpu = trainer_pair(train.Trainer, geom, lrn, 5, dev)
    mc = cmp_card.epoch(small, shuffle_rng=np.random.RandomState(2))
    mh = cmp_cpu.epoch(small, shuffle_rng=np.random.RandomState(2))
    loss_rel = max(abs(a - b) / abs(b) for a, b in zip(mc["losses"], mh["losses"]))
    pdiff = max_param_diff(cmp_card.model, cmp_cpu.model)
    print(f"training: Trainer card vs CPU, 3 steps: loss rel diff "
          f"{loss_rel:.2e}, parameters max diff {pdiff:.2e}", flush=True)
    out["trainer_card_vs_cpu"] = dict(loss_rel=loss_rel, param_max_diff=pdiff)

    # 6. multiscale training at config3 widths
    g3 = Geometry(**C3_GEOMETRY)
    lrn3 = Learning(**dict(TRAIN_LEARNING, batch_size=MS_B))
    fds = train.sample_foveas(g3, lrn3, images, flows, masks, MS_B * MS_STEPS,
                              np.random.RandomState(3))
    ms_trainer, ms_cpu = trainer_pair(train.MultiscaleTrainer, g3, lrn3, 7, dev)
    mm = ms_trainer.epoch(fds, shuffle_rng=np.random.RandomState(4))
    print(f"training: MultiscaleTrainer config3 widths, B={MS_B}, "
          f"{len(mm['losses'])} steps: losses "
          f"{[round(x, 4) for x in mm['losses']]}, grad_ok all "
          f"{all(mm['grad_ok'])}", flush=True)
    check(len(mm["losses"]) == MS_STEPS and all(mm["grad_ok"])
          and np.isfinite(mm["losses"]).all(), "multiscale training")
    ms_card, ms_cpu = trainer_pair(train.MultiscaleTrainer, g3, lrn3, 8, dev)
    two = train.FoveaDataset(*(getattr(fds, k) for k in (
        "images1", "images2", "img_idx", "ys", "xs")),
        fds.targets_yx[:2 * MS_B], fds.itargets[:2 * MS_B],
        crops1=fds.crops1[:2 * MS_B], crops2=fds.crops2[:2 * MS_B])
    a = ms_card.epoch(two, shuffle_rng=np.random.RandomState(5))
    b = ms_cpu.epoch(two, shuffle_rng=np.random.RandomState(5))
    ms_loss_rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
    ms_pdiff = max_param_diff(ms_card.model, ms_cpu.model)
    print(f"training: MultiscaleTrainer card vs CPU, 2 steps: loss rel diff "
          f"{ms_loss_rel:.2e}, parameters max diff {ms_pdiff:.2e}", flush=True)
    out["multiscale"] = dict(losses=mm["losses"], card_vs_cpu_loss_rel=ms_loss_rel,
                             card_vs_cpu_param_max_diff=ms_pdiff)

    # 7. scoring, the checkpoint, and the online estimator on it (B1)
    full_pairs = [(raw["warped_images"][k], raw["images"][k])
                  for k in range(n_pairs) if raw["flow"][k] is not None]
    full_flows = [f for f in raw["flow"] if f is not None]
    score = curves.score_epoch(trainer.model, geom, lrn, test_ds, full_pairs,
                               full_flows)
    ckpt = os.path.join(root, "models", mio.model_dir_name(geom, lrn))
    mio.save_model(ckpt, geom, lrn, trainer.model, [score], 0)
    g2, _, params2, _ = mio.load_model(ckpt)
    est = api_batched.BatchedDepthEstimator(g2, params2, cal, head="mean",
                                            device=dev)
    b1_0 = matching.match_flow_fused.launches
    est.reset(np.stack(frames_u8[:-1]))
    xflow, mask, depth, good_est = est.next_frames(np.stack(frames_u8[1:]))
    torch.cuda.synchronize()
    b1 = matching.match_flow_fused.launches - b1_0
    print(f"training: score {score}; checkpoint {os.path.basename(ckpt)}; "
          f"BatchedDepthEstimator on it, B={n_pairs}: good "
          f"{good_est.tolist()}, {b1} B1 launches", flush=True)
    out["score"] = score
    check(b1 == 1, f"B1 launched {b1} times for one step")
    check(bool(torch.isfinite(xflow[mask > 0]).all()), "estimator flow")
    check(0 <= score["test_acc"] <= 1 and np.isfinite(score["test_err"]),
          f"score {score}")
    counts = {name: fn.launches for name, fn in counters.items()}
    out["launches"] = counts
    print(f"training: launches on this path {counts}", flush=True)
    check(counts["sor_redblack"] > 0 and counts["match_fused"] > 0,
          f"training path launches {counts}")

    # 8. card vs CPU checks, after every reading is printed
    for k, row in enumerate(rows):
        check(row["good"][0] == row["good"][1], f"loader pair {k}: good differs")
        if row["distinct"] == 8 and all(row["good"]):
            check(row["R_max_diff"] <= TOL_R, f"loader pair {k}: R {row}")
            check(row["warp_mean"] <= TOL_E2E_MEAN_PX
                  and row["warp_p99"] <= TOL_E2E_P99_PX, f"loader pair {k}: {row}")
            check(row["mask_agreement"] >= TOL_E2E_MASK, f"loader pair {k}: {row}")
            check(row["gt_equal"] >= TOL_TRAIN_GT, f"loader pair {k}: {row}")
    check(loss_rel <= TOL_TRAIN_LOSS_REL and pdiff <= TOL_TRAIN_PARAM,
          f"trainer card vs CPU: {loss_rel} {pdiff}")
    check(ms_loss_rel <= TOL_TRAIN_LOSS_REL and ms_pdiff <= TOL_TRAIN_PARAM,
          f"multiscale trainer card vs CPU: {ms_loss_rel} {ms_pdiff}")

    # 9. timing, CUDA events, median of 10 after 2 warm-ups (TF32 off: the
    # trainer's step sets it off whatever the caller's flags, so a step
    # "with cuDNN's TF32 on" is the same step; what TF32 would cost is
    # timed on the bare trunk's convolution of the step's patches, which
    # sets no flag)
    soft0 = trainer.soft_targets(yx, TRAIN_B)
    times = {"trainer_step_ms": cuda_ms(lambda: trainer.step(x1, x2, it, soft0),
                                        reps=10, warmup=2)}
    with torch.no_grad():
        times["trunk_patches_ms"] = cuda_ms(
            lambda: trainer.model.filter(x2), reps=10, warmup=2)
        torch.backends.cudnn.allow_tf32 = True
        times["trunk_patches_tf32_ms"] = cuda_ms(
            lambda: trainer.model.filter(x2), reps=10, warmup=3)
        torch.backends.cudnn.allow_tf32 = False
    # the same with the collector's live objects frozen: how much of a
    # step is the Python collector walking what earlier phases left alive
    gc.collect()
    times["live_python_objects"] = len(gc.get_objects())
    gc.freeze()
    times["trainer_step_gc_frozen_ms"] = cuda_ms(
        lambda: trainer.step(x1, x2, it, soft0), reps=10, warmup=2)
    gc.unfreeze()
    c1 = torch.as_tensor(fds.crops1[:MS_B], device=dev)
    c2 = torch.as_tensor(fds.crops2[:MS_B], device=dev)
    it3 = torch.as_tensor(fds.itargets[:MS_B], device=dev)
    soft3 = ms_trainer.soft_targets(None, MS_B)
    times["multiscale_step_ms"] = cuda_ms(
        lambda: ms_trainer.step(c1, c2, it3, soft3), reps=10, warmup=2)
    times["loader_4_pairs_ms"] = cuda_ms(
        lambda: datasets.load_data_optical_flow(geom, cal, root, TRAIN_FRAMES,
                                                noise=noise, device=dev),
        reps=10, warmup=1)
    times["patches_per_s"] = TRAIN_B / (times["trainer_step_ms"] / 1e3)
    # what a step is bound by: its kernels and their device time
    for name, fn in (("trainer_step", lambda: trainer.step(x1, x2, it, soft0)),
                     ("multiscale_step",
                      lambda: ms_trainer.step(c1, c2, it3, soft3))):
        n, busy = device_profile(fn)
        times[f"{name}_kernels"] = n
        times[f"{name}_device_ms"] = busy
    out["times"] = times
    for k, v in times.items():
        print(f"[{card}] training {k}: {v:.3f}", flush=True)
    tmp.cleanup()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"training: phase took {out['seconds']:.1f} s", flush=True)
    report["training"] = out
    return counts


def zoom_sequence(seed, n, h, w, s_top, s_bottom):
    """n uint8 frames of a camera stepping forward towards two depth planes
    (the top half zooms by s_top a step about the centre, the bottom half
    by s_bottom; one plane alone leaves E undetermined, C5), made with
    numpy: frame k samples a smooth random texture at c + (p - c) / s^k, as
    tests/test_cli.py builds its radial scene."""
    from depth_estimation_tpu_torch.data import images
    rng = np.random.RandomState(seed)
    base = images.scale_np(rng.rand(h // 4, w // 4, 3).astype(np.float32), h, w)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    s = np.where(yy < h / 2, s_top, s_bottom)
    return [sample_u8(base, w / 2 + (xx - w / 2) / s ** k,
                      h / 2 + (yy - h / 2) / s ** k) for k in range(n)]


def write_frames(root, frames):
    os.makedirs(os.path.join(root, "images"))
    for i, f in enumerate(frames):
        write_png(os.path.join(root, "images", f"{i:09d}.png"), f)


def nll_card_vs_cpu(card_trainer, cpu_trainer, corpus, seed):
    """3 steps from the same weights on the same batches, on the card and
    on the CPU: the largest relative loss difference and weight
    difference."""
    cpu_trainer.model.load_state_dict(card_trainer.model.state_dict())
    small = tuple(a[:3 * FAM_B] for a in corpus)
    a = card_trainer.epoch(small, np.random.RandomState(seed))
    b = cpu_trainer.epoch(small, np.random.RandomState(seed))
    rel = max(abs(x - y) / abs(y) for x, y in zip(a["losses"], b["losses"]))
    return rel, max_param_diff(card_trainer.model, cpu_trainer.model)


def step_timing(name, fn, card, out):
    """A step's time (CUDA events, median of 5 after 2 warm-ups) and its
    kernels and device time (torch.profiler)."""
    out[f"{name}_step_ms"] = cuda_ms(fn, reps=5, warmup=2)
    n, busy = device_profile(fn)
    out[f"{name}_step_kernels"], out[f"{name}_step_device_ms"] = n, busy
    print(f"[{card}] families {name} step: {out[f'{name}_step_ms']:.3f} ms, "
          f"{out[f'{name}_step_kernels']} kernels, "
          f"{out[f'{name}_step_device_ms']:.3f} ms of device time",
          flush=True)


def family_radial(dev, card, root):
    """The radial trainer: PNG frames -> polar pairs with the projected GT
    -> patches -> one epoch -> e0.msgpack -> the net loaded back, flow on
    one pair; the loader card vs CPU at half size; 3 steps card vs CPU."""
    from depth_estimation_tpu_torch.data import datasets, images
    from depth_estimation_tpu_torch.data import groundtruth as gt_mod
    from depth_estimation_tpu_torch.geometry3d import egomotion as ego
    from depth_estimation_tpu_torch.geometry3d import polar
    from depth_estimation_tpu_torch.geometry3d.calibration import GOPRO
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.models.radial import RadialFlowNetwork
    from depth_estimation_tpu_torch.training import families
    out = {}
    cal = GOPRO
    frames_u8 = zoom_sequence(31, FAM_FRAMES, cal.hImg, cal.wImg, *RAD_ZOOM)
    seq = os.path.join(root, "radial")
    write_frames(seq, frames_u8)
    frames = families.read_frames(seq, cal.hImg, cal.wImg, FAM_FRAMES)
    noise = ego.gumbel_noise(64, cal.sfm.max_points, "cpu")
    tr = families.RadialTrainer(C4_LAYERS, C4_HWIN, 1e-2, 1e-5, FAM_B,
                                device=dev).init(
        torch.Generator().manual_seed(60))
    torch.cuda.reset_peak_memory_stats()
    pairs = tr.load_pairs(cal, frames, C4_H, C4_W, noise=noise)
    torch.cuda.synchronize()
    out["loader_peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    out["loader_ms"] = cuda_ms(
        lambda: tr.load_pairs(cal, frames, C4_H, C4_W, noise=noise),
        reps=3, warmup=0)
    e2s = [p.e2.round(1).tolist() for p in pairs]
    print(f"families radial: loader {FAM_FRAMES} PNG frames {cal.hImg}x"
          f"{cal.wImg} -> {len(pairs)} good polar pairs {C4_H}x{C4_W}, "
          f"epipoles {e2s}, GT valid share "
          f"{[round(float(p.polar_gt_mask.mean()), 4) for p in pairs]}; "
          f"{out['loader_ms']:.1f} ms, peak {out['loader_peak_gb']:.2f} GB "
          f"on the card", flush=True)
    check(len(pairs) >= (FAM_FRAMES - 1) // 2, f"radial: {len(pairs)} pairs")

    rng = np.random.RandomState(0)
    corpus = tr.sample(pairs, FAM_N, rng)
    hist = tr.fit(corpus, 1, rng, os.path.join(root, "models_radial"))
    losses = hist[0]["losses"]
    out.update(n_patches=len(corpus[2]), losses=losses, acc=hist[0]["acc"],
               target_histogram=np.bincount(corpus[2], minlength=C4_HWIN)
               .tolist())
    print(f"families radial: {len(corpus[2])} patches {tr.patch_shape}, "
          f"targets {out['target_histogram']}; one epoch of {len(losses)} "
          f"steps, losses {[round(x, 4) for x in losses]}, acc "
          f"{hist[0]['acc']:.4f}", flush=True)
    check(len(losses) == len(corpus[2]) // FAM_B and np.isfinite(losses).all(),
          "radial epoch")
    net = RadialFlowNetwork(C4_LAYERS, C4_HWIN, device=dev)
    mio.load_weights_into(os.path.join(root, "models_radial", "e0.msgpack"),
                          net)
    check(max_param_diff(net, tr.model) == 0, "radial checkpoint round trip")
    fl, mc = net.flow(torch.as_tensor(pairs[0].polar_prev_image, device=dev),
                      torch.as_tensor(pairs[0].polar_image, device=dev))
    check(bool(torch.isfinite(mc).all()), "radial flow on the checkpoint")

    # card vs CPU at half size: the whole loader, printed (the epipole of
    # these few-pixel flows is one 8-point fit, so 1e-6 in the tracks moves
    # it by pixels, C26); RANSAC's winner and R, held where both devices
    # pick the same 8 distinct points; and the polar grid, warp and GT
    # projection from the same inputs, held
    half = cal.scaled(0.5)
    hf = [images.scale_np(f, half.hImg, half.wImg) for f in frames]
    gg = families.radial_gt_geometry(half)
    wk = tr.model.w_kernel
    got = {d: datasets.load_polar_pairs_batched(
        half, hf, half.hImg, half.wImg, C4_H, C4_W, wk, geom_gt=gg,
        max_flow=C4_HWIN - 1, noise=noise, device=d) for d in (dev, "cpu")}
    distinct, r_card, w_card = loader_trace(hf, half, noise, dev,
                                            undistort=False)
    _, r_cpu, w_cpu = loader_trace(hf, half, noise, "cpu", undistort=False)
    rows = []
    for k, (a, b) in enumerate(zip(got[dev], got["cpu"])):
        row = dict(good=[a.good, b.good], distinct=distinct[k],
                   same_winner=w_card[k] == w_cpu[k],
                   R_max_diff=(r_card[k] - r_cpu[k]).abs().max().item(),
                   e2=[a.e2.tolist(), b.e2.tolist()])
        if a.good and b.good:
            d = np.abs(np.stack([a.polar_image, a.polar_prev_image])
                       - np.stack([b.polar_image, b.polar_prev_image]))
            row.update(polar_mean=float(d.mean()), polar_max=float(d.max()),
                       mask_agreement=float((a.polar_mask == b.polar_mask)
                                            .mean()))
        rows.append(row)
        print(f"families radial: loader card vs CPU at {half.hImg}x"
              f"{half.wImg}, pair {k}: {row}", flush=True)
    out["loader_card_vs_cpu"] = rows
    prevs = torch.as_tensor(np.stack(hf[:-1]), device=dev)
    nxt = torch.as_tensor(np.stack(hf[1:]), device=dev)
    _, _, _, e2s, _, _, prev_w, img_s, masks = datasets.polar_batch(
        prevs, nxt, half.K, half.wImg, half.hImg, half.hImg, half.wImg, C4_H,
        C4_W, wk, half.sfm.max_points, half.sfm.points_quality,
        noise.to(dev))
    flows = gt_mod.exhaustive_flow_batched(gg, prev_w, img_s, chunk=2,
                                           device=dev)
    same = {}
    for d in (dev, "cpu"):
        f = [torch.as_tensor(x, device=d) for x in flows]
        e = e2s.to(d)
        rmax = polar.get_rmax_batched(half.hImg, half.wImg, e)
        grid = polar.get_c2p_grid_batched(
            half.wImg, half.hImg, C4_W, C4_H, e[:, 0], e[:, 1], rmax,
            lpadding=(wk - 1) // 2, rpadding=(wk - 1) - (wk - 1) // 2)
        same[d] = [x.cpu() for x in (
            polar.warp_grid_batched(img_s.to(d), grid),
            *datasets.polar_gt_batch(*f, masks.to(d), e, half.hImg,
                                     half.wImg, C4_H, C4_W, wk, C4_HWIN - 1))]
    out["same_inputs"] = dict(
        polar_max=(same[dev][0] - same["cpu"][0]).abs().max().item(),
        gt_max=(same[dev][1] - same["cpu"][1]).abs().max().item(),
        gt_mask_agreement=(same[dev][2] == same["cpu"][2]).float().mean()
        .item(),
        gt_valid=same["cpu"][2].mean().item())
    print(f"families radial: polar warp and GT projection card vs CPU from "
          f"the same inputs: {out['same_inputs']}", flush=True)
    cpu = families.RadialTrainer(C4_LAYERS, C4_HWIN, 1e-2, 1e-5, FAM_B,
                                 device="cpu")
    cmp = families.RadialTrainer(C4_LAYERS, C4_HWIN, 1e-2, 1e-5, FAM_B,
                                 device=dev).init(
        torch.Generator().manual_seed(61))
    out["loss_rel"], out["param_max_diff"] = nll_card_vs_cpu(cmp, cpu, corpus, 2)
    print(f"families radial: 3 steps card vs CPU: loss rel diff "
          f"{out['loss_rel']:.2e}, parameters max diff "
          f"{out['param_max_diff']:.2e}", flush=True)
    b = tuple(torch.as_tensor(a[:FAM_B], device=dev) for a in corpus)
    step_timing("radial", lambda: tr.step(*b), card, out)
    return out


def family_v2(dev, card, root):
    """The version2 trainer: PNG frames -> FlowDataset pairs with the
    cross-correlation GT -> patches -> one epoch -> e0 -> the net loaded
    back, costs of one pair; the pairs card vs CPU; 3 steps card vs CPU."""
    from depth_estimation_tpu_torch.data import datasets
    from depth_estimation_tpu_torch.geometry3d import egomotion as ego
    from depth_estimation_tpu_torch.geometry3d.calibration import (
        RECTIFIED_GOPRO_SMALL)
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.models.version2 import V2Network, V2Params
    from depth_estimation_tpu_torch.training import families
    out = {}
    cal = RECTIFIED_GOPRO_SMALL
    datap = V2Params(wImg=cal.wImg, hImg=cal.hImg, normalization_k=17,
                     layers=((3, 17, 17, 32),), hWin=17, wWin=17)
    seq = os.path.join(root, "v2")
    frames_u8 = forward_sequence(32, FAM_FRAMES, cal.hImg, cal.wImg)
    write_frames(seq, frames_u8)
    noise = ego.gumbel_noise(64, cal.sfm.max_points, "cpu")
    tr = families.V2Trainer(datap, 1e-2, FAM_B, device=dev).init(
        torch.Generator().manual_seed(62))
    rng = np.random.RandomState(0)
    t0 = time.perf_counter()
    corpus = tr.sample(cal, seq, FAM_FRAMES, FAM_N, rng, noise=noise)
    out["loader_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"families version2: FlowDataset over {FAM_FRAMES} PNG frames "
          f"{cal.hImg}x{cal.wImg} ('sfm', cross-correlation GT, 17x17) -> "
          f"{len(corpus[2])} patches {corpus[0].shape[1:3]} in "
          f"{out['loader_ms']:.1f} ms (cold, GT written to its disk cache)",
          flush=True)
    check(len(corpus[2]) == FAM_N, f"version2: {len(corpus[2])} patches")
    hist = tr.fit(corpus, 1, rng, os.path.join(root, "models_v2"))
    losses = hist[0]["losses"]
    out.update(losses=losses, acc=hist[0]["acc"])
    print(f"families version2: one epoch of {len(losses)} steps, losses "
          f"{[round(x, 4) for x in losses]}, acc {hist[0]['acc']:.4f}",
          flush=True)
    check(len(losses) == FAM_N // FAM_B and np.isfinite(losses).all(),
          "version2 epoch")
    net = V2Network(datap, device=dev)
    mio.load_weights_into(os.path.join(root, "models_v2", "e0"), net)
    check(max_param_diff(net, tr.model) == 0, "version2 checkpoint round trip")
    with torch.no_grad():
        f0 = torch.as_tensor(frames_u8[0], dtype=torch.float32, device=dev) / 255
        f1 = torch.as_tensor(frames_u8[1], dtype=torch.float32, device=dev) / 255
        check(bool(torch.isfinite(net.costs(f0, f1)).all()),
              "version2 costs on the checkpoint")

    frames = families.read_frames(seq, cal.hImg, cal.wImg, FAM_FRAMES)
    rows = []
    for k in range(FAM_FRAMES - 1):
        a, b = (datasets.load_rectified_pair(tr.model.geometry, cal,
                                             frames[k], frames[k + 1],
                                             noise=noise, device=d)
                for d in (dev, "cpu"))
        row = dict(good=[a.good, b.good])
        if a.good and b.good:
            dd = np.abs(a.prev_warped - b.prev_warped)
            both = (a.conf > 0) & (b.conf > 0)
            row.update(warp_mean=float(dd.mean()),
                       warp_p99=float(np.quantile(dd, 0.99)),
                       mask_agreement=float((a.mask == b.mask).mean()),
                       gt_equal=float((a.flow == b.flow).all(0)[both].mean()),
                       gt_both_confident=float(both.mean()))
        rows.append(row)
        print(f"families version2: pair {k} card vs CPU: {row}", flush=True)
    out["loader_card_vs_cpu"] = rows
    distinct, _, _ = loader_trace(frames, cal, noise, dev)
    out["ransac_distinct"] = distinct
    cpu = families.V2Trainer(datap, 1e-2, FAM_B, device="cpu")
    cmp = families.V2Trainer(datap, 1e-2, FAM_B, device=dev).init(
        torch.Generator().manual_seed(63))
    out["loss_rel"], out["param_max_diff"] = nll_card_vs_cpu(cmp, cpu, corpus, 3)
    print(f"families version2: 3 steps card vs CPU: loss rel diff "
          f"{out['loss_rel']:.2e}, parameters max diff "
          f"{out['param_max_diff']:.2e}", flush=True)
    b = tuple(torch.as_tensor(a[:FAM_B], device=dev) for a in corpus)
    step_timing("version2", lambda: tr.step(*b), card, out)
    return out


def legacy_scene(root, seed, n, h, w):
    """depth_estimation.py's data layout, as tests/test_cli.py makes it at
    360x640: n + 1 gray frames (the left half textured and near, depth 4;
    the right half flat and far, depth 40) and n frames of sparse depth
    points (depths/%09d.npz)."""
    rng = np.random.RandomState(seed)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float32)
    stripes = 0.5 + 0.4 * np.sin(2 * np.pi * (xx + yy) / 4.0)
    os.makedirs(os.path.join(root, "depths"))
    frames = []
    for i in range(n + 1):
        img = np.full((h, w), 0.5, np.float32)
        img[:, : w // 2] = stripes[:, : w // 2]
        img += rng.rand(h, w).astype(np.float32) * 0.05
        frames.append(np.repeat((np.clip(img, 0, 1) * 255).astype(np.uint8)
                                [..., None], 3, axis=-1))
        if i < n:
            xs = rng.randint(0, w, 400).astype(np.float32)
            ys = rng.randint(0, h, 400).astype(np.float32)
            depth = np.where(xs < w // 2, 4.0, 40.0).astype(np.float32)
            np.savez(os.path.join(root, "depths", f"{i:09d}.npz"), x=xs,
                     y=ys, depth=depth)
    write_frames(root, frames)


def family_legacy(dev, card, root):
    """The legacy depth classifier: PNG frames and depth points -> gray
    pairs -> class-balanced patches -> one epoch -> params.msgpack -> the
    classifier loaded back and the class map of one full pair; the class
    map and 3 steps card vs CPU."""
    from depth_estimation_tpu_torch.data import depth_legacy
    from depth_estimation_tpu_torch.training import families
    out = {}
    seq = os.path.join(root, "legacy")
    legacy_scene(seq, 33, FAM_FRAMES - 1, LEG_H, LEG_W)
    t0 = time.perf_counter()
    frames, images = depth_legacy.load_depth_dataset(seq, FAM_FRAMES, 1,
                                                     LEG_H, LEG_W)
    tr = families.DepthClassifierTrainer(LEG_CLASSES, FAM_B, device=dev).init(
        torch.Generator().manual_seed(64))
    rng = np.random.RandomState(1)
    sets = tr.make_datasets(frames, images, LEG_N, LEG_M, rng)
    out["loader_ms"] = (time.perf_counter() - t0) * 1e3
    print(f"families legacy: {len(frames)} annotated pairs {LEG_H}x{LEG_W} "
          f"-> {len(sets[1])} / {len(sets[3])} patches, cutDepth "
          f"{tr.discretizer.cut_depth}, in {out['loader_ms']:.1f} ms (host)",
          flush=True)
    m = tr.fit(*sets, 1, rng)[0]
    out.update(losses=m["losses"], train_acc=m["train_acc"],
               test_acc=m["test_acc"], confusion=m["confusion"].tolist())
    print(f"families legacy: one epoch of {len(m['losses'])} steps, losses "
          f"{[round(x, 4) for x in m['losses']]}, train acc "
          f"{m['train_acc']:.4f}, test acc {m['test_acc']:.4f}, confusion "
          f"{out['confusion']}", flush=True)
    check(len(m["losses"]) == LEG_N // FAM_B and np.isfinite(m["losses"]).all(),
          "legacy epoch")
    ckpt = tr.save(os.path.join(root, "legacy_model"))
    back = families.DepthClassifierTrainer.load(ckpt, device=dev)
    check(max_param_diff(back.model, tr.model) == 0
          and back.discretizer == tr.discretizer, "legacy checkpoint round trip")
    cmap = back.class_map(images[0])
    back.save_class_map(ckpt, 0, images[0])
    near_left = float((cmap[:, : cmap.shape[1] // 2] == 0).mean())
    near_right = float((cmap[:, cmap.shape[1] // 2:] == 0).mean())
    cpu = families.DepthClassifierTrainer(LEG_CLASSES, FAM_B, device="cpu")
    cpu.model.load_state_dict(tr.model.state_dict())
    out["class_map_card_vs_cpu"] = float((cpu.class_map(images[0]) == cmap)
                                         .mean())
    out.update(class_map_shape=list(cmap.shape), near_left=near_left,
               near_right=near_right)
    print(f"families legacy: class map {cmap.shape} of pair 0: near share "
          f"left {near_left:.3f}, right {near_right:.3f}; card vs CPU equal "
          f"on {out['class_map_card_vs_cpu']:.6f}", flush=True)

    cmp = families.DepthClassifierTrainer(LEG_CLASSES, FAM_B, device=dev).init(
        torch.Generator().manual_seed(65))
    cpu.model.load_state_dict(cmp.model.state_dict())
    sub = (sets[0][:3 * FAM_B], sets[1][:3 * FAM_B], sets[2][:FAM_B],
           sets[3][:FAM_B])
    a = cmp.epoch(*sub, np.random.RandomState(4))
    b = cpu.epoch(*sub, np.random.RandomState(4))
    out["loss_rel"] = max(abs(x - y) / abs(y) for x, y in zip(a["losses"],
                                                              b["losses"]))
    out["param_max_diff"] = max_param_diff(cmp.model, cpu.model)
    print(f"families legacy: 3 steps card vs CPU: loss rel diff "
          f"{out['loss_rel']:.2e}, parameters max diff "
          f"{out['param_max_diff']:.2e}", flush=True)
    xb = torch.as_tensor(sets[0][:FAM_B], device=dev)
    cb = torch.as_tensor(sets[1][:FAM_B] - 1, device=dev)
    step_timing("legacy", lambda: tr.step(xb, cb), card, out)
    return out


def phase_families(dev, card, root, report):
    """The radial, version2 and legacy depth trainers at full width, each
    from frames on disk under ``root`` to a checkpoint its inference module
    loads back (ROADMAP A.12); the serving phase exports those checkpoints.
    B1-B5's counts are zeroed before and read after: the path reaches none
    of them. Returns the counts."""
    from depth_estimation_tpu_torch.flow import sor_kernel
    from depth_estimation_tpu_torch.ops import matching, matching_experimental, warp
    t_phase = time.perf_counter()
    counters = {"match_fused": matching.match_flow_fused,
                "warp_banded": warp.banded_bilinear_warp,
                "match_fast": matching.match_flow_fast,
                "sor_redblack": sor_kernel.sor_redblack,
                "match_throughput": matching_experimental.match_flow_throughput}
    for fn in counters.values():
        fn.launches = 0
    out = {"radial": family_radial(dev, card, root),
           "version2": family_v2(dev, card, root),
           "legacy": family_legacy(dev, card, root)}
    counts = {name: fn.launches for name, fn in counters.items()}
    out["launches"] = counts
    out["seconds"] = time.perf_counter() - t_phase
    print(f"families: launches on this path {counts}; phase took "
          f"{out['seconds']:.1f} s", flush=True)
    report["families"] = out

    # card vs CPU checks, after every reading is printed
    for k, row in enumerate(out["radial"]["loader_card_vs_cpu"]):
        check(row["good"][0] == row["good"][1], f"radial pair {k}: good differs")
        if row["distinct"] == 8 and row["same_winner"]:
            check(row["R_max_diff"] <= TOL_R, f"radial pair {k}: R {row}")
    same = out["radial"]["same_inputs"]
    check(same["polar_max"] <= TOL_POLAR and same["gt_max"] <= TOL_POLAR_GT
          and same["gt_mask_agreement"] >= TOL_E2E_MASK,
          f"radial polar warp / GT projection card vs CPU: {same}")
    v2 = out["version2"]
    for k, row in enumerate(v2["loader_card_vs_cpu"]):
        check(row["good"][0] == row["good"][1], f"version2 pair {k}: good")
        if v2["ransac_distinct"][k] == 8 and all(row["good"]):
            check(row["warp_mean"] <= TOL_E2E_MEAN_PX
                  and row["warp_p99"] <= TOL_E2E_P99_PX
                  and row["mask_agreement"] >= TOL_E2E_MASK
                  and row["gt_equal"] >= TOL_TRAIN_GT,
                  f"version2 pair {k}: {row}")
    for fam in ("radial", "version2", "legacy"):
        check(out[fam]["loss_rel"] <= TOL_TRAIN_LOSS_REL
              and out[fam]["param_max_diff"] <= TOL_TRAIN_PARAM,
              f"{fam} trainer card vs CPU: {out[fam]}")
    check(out["legacy"]["class_map_card_vs_cpu"] >= TOL_AGREE,
          f"legacy class map card vs CPU {out['legacy']}")
    check(not any(counts.values()), f"a kernel ran on the families' path: "
          f"{counts}")
    return counts


# ---------------------------------------------------------------------------
# phase 13: serving
# ---------------------------------------------------------------------------

# artifact vs the live program on the card: the same kernels on the same
# inputs in the same order; floats within TOL_ARTIFACT (room for a traced
# program that re-associates a float sum), integers and `good` equal
TOL_ARTIFACT = 1e-6
SERVE_B = 32                # `tools export --pipeline`'s default batch
SERVE_STREAM_FRAMES = 5


def max_diff(got, want):
    """Largest |got - want| over tensors whose integer or boolean parts must
    be equal; inf and nan must sit at the same places. Returns (float
    error, integers equal)."""
    err, same = 0.0, True
    for g, w in zip(got, want):
        if not (g.is_floating_point() or w.is_floating_point()):
            same = same and torch.equal(g, w)
            continue
        fin = torch.isfinite(w)
        same = (same and torch.equal(torch.isfinite(g), fin)
                and torch.equal(g[~fin], w[~fin]))
        if fin.any():
            err = max(err, (g[fin].float() - w[fin].float()).abs().max().item())
    return err, same


def exact_eager_cond(imgs, K, R, band=8, dtype=None):
    """``remove_ego_motion_exact``'s traced form, ``torch.cond``, run
    eagerly (the live form reads the predicate back to the host and calls
    one branch)."""
    from depth_estimation_tpu_torch.geometry3d import undistort as undist
    H, W = imgs.shape[1], imgs.shape[2]
    R = torch.as_tensor(R, dtype=torch.float32, device=imgs.device)
    K = torch.as_tensor(K, dtype=torch.float32, device=imgs.device)
    banded, gather = undist._exact_branches(band, dtype)
    return torch.cond(undist.warp_in_band(K, R, H, W, band), banded, gather,
                      (imgs, K, R))


def run_cli(main, argv):
    """One CLI entry point in this process; its exit code and what it
    printed."""
    import contextlib
    import io
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = main(argv)
    return rc, buf.getvalue()


def phase_serving(dev, card, geom, params, ests, frames, fam_root, report):
    """Serving at the car model's width, every kernel count zeroed before
    and read after: `tools export` of the flow forward (f32, bf16), of the
    complete online program at B=32 ('warp' mode), of the families phase's
    radial, version2 and legacy checkpoints and of config3's multiscale
    decode on seeded weights; each artifact loaded, called and held to the
    live program; the warp step with its host read and with eager
    torch.cond (C4); the CLIs
    (`tools stream` sync and --pipeline 3, `time-matching`, `video` on 3
    frames, `test_radial` on the radial checkpoint). Returns B1's and B3's
    launches on the phase."""
    from depth_estimation_tpu_torch import api_batched, serving
    from depth_estimation_tpu_torch.cli import test_radial as radial_cli
    from depth_estimation_tpu_torch.cli import tools
    from depth_estimation_tpu_torch.data import images
    from depth_estimation_tpu_torch.geometry import Geometry, Learning
    from depth_estimation_tpu_torch.geometry3d import undistort as undist
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.models.flow import FlowModel, crop_features_center
    from depth_estimation_tpu_torch.models.legacy_depth import DepthClassifierCNN
    from depth_estimation_tpu_torch.models.multiscale import MultiscaleFlowModel
    from depth_estimation_tpu_torch.models.radial import RadialFlowNetwork
    from depth_estimation_tpu_torch.models.version2 import V2Network, V2Params
    from depth_estimation_tpu_torch.ops import matching, warp
    t_phase = time.perf_counter()
    b1, b3 = matching.match_flow_fused, warp.banded_bilinear_warp
    b1.launches = b3.launches = 0
    tmp = tempfile.TemporaryDirectory()
    out = {"artifacts": {}}

    def export(name, model_dir, *extra):
        path = os.path.join(tmp.name, name + ".pt2")
        t0 = time.perf_counter()
        rc, text = run_cli(tools.main, ["export", model_dir, "--out", path,
                                        "--device", str(dev), *extra])
        export_s = time.perf_counter() - t0
        check(rc == 0 and os.path.exists(path), f"export {name}: {text}")
        t0 = time.perf_counter()
        ep = serving.load_exported(path)
        program = ep.module()
        load_s = time.perf_counter() - t0
        out["artifacts"][name] = dict(
            export_s=export_s, load_s=load_s, bytes=os.path.getsize(path),
            nodes=len(ep.graph.nodes),
            constant_bytes=sum(t.numel() * t.element_size()
                               for t in ep.constants.values()
                               if isinstance(t, torch.Tensor)))
        return program

    def hold(name, program, live, args, b1_calls=0, b3_calls=0):
        """One artifact call (its B1/B3 launches counted) against the live
        program, then both timed: CUDA-event medians of 5."""
        n1, n3 = b1.launches, b3.launches
        got = program(*args)
        torch.cuda.synchronize()
        d1, d3 = b1.launches - n1, b3.launches - n3
        got = got if isinstance(got, (tuple, list)) else (got,)
        want = live(*args)
        want = want if isinstance(want, (tuple, list)) else (want,)
        err, same = max_diff(got, want)
        row = out["artifacts"][name]
        row.update(max_abs_err=err, ints_equal=same, launches_b1=d1,
                   launches_b3=d3, ms=cuda_ms(lambda: program(*args)),
                   live_ms=cuda_ms(lambda: live(*args)))
        print(f"[{card}] serving {name}: export {row['export_s']:.1f} s, "
              f"load {row['load_s']:.1f} s, {row['bytes']} bytes ("
              f"{row['nodes']} nodes, {row['constant_bytes']} bytes of "
              f"constants); call "
              f"{row['ms']:.3f} ms (live {row['live_ms']:.3f}); vs live max "
              f"err {err:.2e}, integers equal {same}; B1 {d1} B3 {d3} "
              f"launches a call", flush=True)
        check(same and err <= TOL_ARTIFACT, f"serving {name} vs live: {row}")
        check(d1 == b1_calls and d3 == b3_calls,
              f"serving {name}: B1 {d1} (want {b1_calls}), B3 {d3} "
              f"(want {b3_calls}) launches a call")
        return got

    # the flow forward, f32 and bf16 storage, on one working-size pair
    model = mio.load_tree_into(FlowModel(geom, device=dev), params)
    a, b = (x[0] for x in working_frames(13, 1, geom.hImg, geom.wImg, dev))
    for dt in (torch.float32, torch.bfloat16):
        name = f"flow_forward_{str(dt)[6:]}"
        program = export(name, CAR_MODEL,
                         *(["--bf16"] if dt == torch.bfloat16 else []))

        def live(x, y, dt=dt):
            f1 = crop_features_center(geom, model.features(x))
            return matching.match_flow_fused(f1, model.features(y), geom.maxh,
                                             geom.maxw, 8, False, dt)
        hold(name, program, live, (a, b), b1_calls=1)

    # the complete online program at B=32, 'warp' mode: the artifact's noise
    # is the live step's draw (seeded 1 on the card), so the live program
    # runs with its default noise
    program = export("pipeline_warp_b32", CAR_MODEL, "--pipeline", "--batch",
                     str(SERVE_B))
    t1, t2 = forward_frames(torch.Generator(device=dev).manual_seed(13),
                            SERVE_B, dev)
    live = api_batched.make_batched_pipeline(geom, ARDRONE, device=dev)
    got = hold("pipeline_warp_b32", program,
               lambda x, y: live(params, x, y), (t1, t2), b1_calls=1,
               b3_calls=1)
    good = got[3].float().mean().item()
    check(good >= 0.5, f"pipeline artifact: good on {good:.2f} of the items")
    row = out["artifacts"]["pipeline_warp_b32"]
    row["good_share"] = good
    row["kernels"], row["device_ms"] = device_profile(lambda: program(t1, t2))
    row["live_kernels"], row["live_device_ms"] = device_profile(
        lambda: live(params, t1, t2))
    print(f"[{card}] serving pipeline_warp_b32: good share {good:.3f}; a call "
          f"runs {row['kernels']} kernels, {row['device_ms']:.1f} ms of device "
          f"time (live {row['live_kernels']}, {row['live_device_ms']:.1f} ms)",
          flush=True)

    # the warp step and its compensation at B=128 with the live form (the
    # predicate read on the host) and with the traced form, torch.cond, run
    # eagerly, in turns: live, cond, cond, live
    est = ests["warp"]
    u1, feats1 = est._prep(frames[0])
    R = torch.eye(3, device=dev).expand(B_MAIN, 3, 3).clone()
    R[:, 0, 2], R[:, 2, 0] = 0.01, -0.01
    Ks = est.K_scaled
    live_exact = undist.remove_ego_motion_exact
    c4 = {"step_host_read": [], "step_eager_cond": [],
          "warp_host_read": [], "warp_eager_cond": []}
    for form in ("host_read", "eager_cond", "eager_cond", "host_read"):
        fn = live_exact if form == "host_read" else exact_eager_cond
        undist.remove_ego_motion_exact = fn
        try:
            c4[f"step_{form}"].append(cuda_ms(lambda: est._step(u1, feats1,
                                                                 frames[1])))
            c4[f"warp_{form}"].append(cuda_ms(lambda: fn(feats1, Ks, R, 8)))
        finally:
            undist.remove_ego_motion_exact = live_exact
    out["c4"] = c4
    print(f"[{card}] C4 'warp' step B={B_MAIN}: host read "
          f"{c4['step_host_read']} ms, eager torch.cond "
          f"{c4['step_eager_cond']} ms; compensation alone: host read "
          f"{c4['warp_host_read']} ms, eager torch.cond "
          f"{c4['warp_eager_cond']} ms", flush=True)

    # the families phase's checkpoints and config3's decode
    def rand(shape, seed):
        return torch.rand(shape, generator=torch.Generator(device=dev)
                          .manual_seed(seed), device=dev)
    net = RadialFlowNetwork(C4_LAYERS, C4_HWIN, device=dev)
    mio.load_weights_into(os.path.join(fam_root, "models_radial", "e0.msgpack"),
                          net)
    program = export("radial", os.path.join(fam_root, "models_radial"),
                     "--hw", str(C4_H), str(C4_W))
    hold("radial", program, net.flow, (rand((C4_H, C4_W, 3), 14),
                                       rand((C4_H, C4_W, 3), 15)))
    with open(os.path.join(fam_root, "models_v2", "meta.json")) as f:
        meta = json.load(f)
    datap = V2Params(wImg=meta["wImg"], hImg=meta["hImg"],
                     normalization_k=meta["normalization_k"],
                     layers=tuple(tuple(l) for l in meta["layers"]),
                     hWin=meta["hWin"], wWin=meta["wWin"])
    v2 = V2Network(datap, device=dev)
    mio.load_weights_into(os.path.join(fam_root, "models_v2", "e0"), v2)
    program = export("version2", os.path.join(fam_root, "models_v2"))
    x1, x2 = (x[0] for x in working_frames(16, 1, datap.hImg, datap.wImg, dev))
    with torch.no_grad():
        hold("version2", program, lambda x, y: serving._v2_decode(v2, x, y),
             (x1, x2))
    with open(os.path.join(fam_root, "legacy_model", "meta.json")) as f:
        n_classes = json.load(f)["n_classes"]
    cnn = DepthClassifierCNN(n_classes, device=dev)
    mio.load_weights_into(os.path.join(fam_root, "legacy_model"), cnn)
    program = export("legacy", os.path.join(fam_root, "legacy_model"),
                     "--hw", str(LEG_H), str(LEG_W))
    with torch.no_grad():
        hold("legacy", program, lambda x: serving._class_map(cnn, x),
             (rand((LEG_H, LEG_W, 2), 17),))
    g3 = Geometry(**C3_GEOMETRY)
    ms = MultiscaleFlowModel(g3, device=dev).init(torch.Generator().manual_seed(30))
    mio.save_model(os.path.join(tmp.name, "config3"), g3, Learning(), ms)
    program = export("config3", os.path.join(tmp.name, "config3"))
    hold("config3", program, ms.decode_full,
         tuple(x[0] for x in working_frames(6, 1, g3.hImg, g3.wImg, dev)))

    # the CLIs, each exiting 0 and writing what it writes
    seq = os.path.join(tmp.name, "seq")
    write_frames(seq, forward_sequence(21, SERVE_STREAM_FRAMES))
    clis = {}
    for k in ("0", "3"):
        rc, text = run_cli(tools.main, ["stream", CAR_MODEL, seq, "--pipeline",
                                        k, "--device", str(dev)])
        total = [l for l in text.splitlines() if l.startswith("total:")]
        check(rc == 0 and total and f"{SERVE_STREAM_FRAMES - 1} frames" in total[0],
              f"tools stream --pipeline {k}: {text[-500:]}")
        clis[f"stream_pipeline_{k}"] = total[0]
    rc, text = run_cli(tools.main, ["time-matching", "--iters", "10",
                                    "--device", str(dev)])
    check(rc == 0 and "filter+match+decode" in text, f"time-matching: {text}")
    clis["time_matching"] = text.strip()
    video = os.path.join(tmp.name, "video")
    rc, text = run_cli(tools.main, ["video", CAR_MODEL, seq, "--num", "3",
                                    "--output-dir", video, "--device", str(dev)])
    pngs = sorted(f for f in os.listdir(video) if f.endswith(".png"))
    check(rc == 0 and len(pngs) == 3, f"tools video: {text} {pngs}")
    with open(os.path.join(video, pngs[-1]), "rb") as f:
        shape = images.decode_png(f.read()).shape
    check(shape == (3 * geom.hImg, 3 * geom.wImg, 3), f"video panel {shape}")
    clis["video"] = text.strip()
    radial_out = os.path.join(tmp.name, "radial_panels")
    rc, text = run_cli(radial_cli.main, [
        "-rd", os.path.join(fam_root, "radial"), "-cal", "gopro", "-net",
        repr([list(l) if not isinstance(l, str) else l for l in C4_LAYERS]),
        "-w", os.path.join(fam_root, "models_radial", "e0.msgpack"),
        "-hwin", str(C4_HWIN), "-hi", str(C4_H), "-wi", str(C4_W), "-ni", "2",
        "-o", radial_out, "--device", str(dev)])
    panels = sorted(os.listdir(radial_out))
    check(rc == 0 and panels, f"test_radial: {text} {panels}")
    clis["test_radial"] = dict(panels=panels, timers=text.strip())
    out["clis"] = clis
    for name, line in clis.items():
        print(f"[{card}] serving CLI {name}: {line}", flush=True)

    out["launches"] = {"match_fused": b1.launches, "warp_banded": b3.launches}
    tmp.cleanup()
    out["seconds"] = time.perf_counter() - t_phase
    print(f"serving: launches on this path {out['launches']}; phase took "
          f"{out['seconds']:.1f} s", flush=True)
    report["serving"] = out
    return out["launches"]

# ---------------------------------------------------------------------------
# phase 14: the training CLIs and the real-drone loop
# ---------------------------------------------------------------------------

# opticalflow at car_model's trunk and window (the CLI's 180x320 geometry)
OF_CAR = ["-nl", "2", "-k1s", "5", "-s2", "8", "-s2c", "8", "-k2s", "12",
          "-nf", "10", "-ws", "16", "-gtws", "16", "-cal", "ardrone"]
ROBOT_TICKS = 30
ROBOT_ZOOM = (1.01, 1.02)     # top / bottom plane zoom a frame (<= 3 px)
ROBOT_VELOCITY = (2.0, 0.0, 0.0)


def kernel_counters():
    from depth_estimation_tpu_torch.flow import sor_kernel
    from depth_estimation_tpu_torch.ops import matching
    return {"match_fused": matching.match_flow_fused,
            "sor_redblack": sor_kernel.sor_redblack}


def phase_training_clis(dev, card, fam_root, report):
    """Phase 14a: the four training CLIs through their ``main(argv)`` on the
    card at their default widths, one epoch each, over the training
    phase's forward-camera sequence (made again from its seed) and the
    families phase's sequences under ``fam_root``: opticalflow at car
    width (cross-correlation, then '-gt liu' with B4's launches counted,
    then '--resume -e 2'), train_radial ('gopro', 200x200 polar, hWin 15),
    train_v2 ('rectified_gopro_small'), depth_estimation (360x640, then
    '-lw ... -i'). Each exits 0 and its checkpoint loads back. B1's and
    B4's counts are zeroed before and read after. Returns them."""
    from depth_estimation_tpu_torch.cli import (depth_estimation,
                                                opticalflow, train_radial,
                                                train_v2)
    from depth_estimation_tpu_torch.data import depth_legacy
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.models.radial import RadialFlowNetwork
    from depth_estimation_tpu_torch.models.version2 import V2Network, V2Params
    from depth_estimation_tpu_torch.training import families
    t_phase = time.perf_counter()
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    tmp = tempfile.TemporaryDirectory()
    seq = os.path.join(tmp.name, "seq")
    write_frames(seq, forward_sequence(21, TRAIN_FRAMES, ARDRONE.hImg,
                                       ARDRONE.wImg))
    out = {"seconds": {}}
    dev_flag = ["--device", str(dev)]

    def run(name, main, argv):
        t0 = time.perf_counter()
        rc, text = run_cli(main, argv + dev_flag)
        torch.cuda.synchronize()
        out["seconds"][name] = time.perf_counter() - t0
        check(rc == 0, f"{name}: exit {rc}: {text[-800:]}")
        last = [l for l in text.splitlines() if l.startswith("epoch")]
        print(f"[{card}] CLI {name}: {out['seconds'][name]:.1f} s; "
              f"{last[-1] if last else text.strip().splitlines()[-1]}",
              flush=True)
        return text

    # opticalflow: cross-correlation, liu (B4), then --resume
    of_argv = OF_CAR + ["-rd", seq, "-ni", str(TRAIN_FRAMES), "-e", "1"]
    for gt in ("cross-correlation", "liu"):
        n4 = counters["sor_redblack"].launches
        run(f"opticalflow_{gt}", opticalflow.main,
            of_argv + ["-gt", gt, "-omd", os.path.join(tmp.name, gt)])
        b4 = counters["sor_redblack"].launches - n4
        out[f"opticalflow_{gt}_b4"] = b4
        if gt == "liu":
            check(b4 >= TRAIN_FRAMES - 1, f"opticalflow -gt liu: B4 launched "
                  f"{b4} times for {TRAIN_FRAMES - 1} GT pairs")
        (name,) = os.listdir(os.path.join(tmp.name, gt))
        ckpt = os.path.join(tmp.name, gt, name)
        g, _, _, meta = mio.load_model(ckpt)
        mio.load_filter(ckpt, device=dev)
        check(len(meta["score"]) == 1 and g.hImg == 180,
              f"opticalflow {gt} checkpoint: {meta['score']}")
    run("opticalflow_resume", opticalflow.main,
        of_argv + ["-gt", "cross-correlation", "-omd",
                   os.path.join(tmp.name, "cross-correlation"), "--resume",
                   "-e", "2"])
    (name,) = os.listdir(os.path.join(tmp.name, "cross-correlation"))
    g, _, _, meta = mio.load_model(os.path.join(tmp.name,
                                                "cross-correlation", name))
    check([s["epoch"] for s in meta["score"]] == [0, 1],
          f"opticalflow --resume: {meta['score']}")

    # train_radial at its defaults ('gopro', 200x200, hWin 15, n 1000)
    omd = os.path.join(tmp.name, "models_radial")
    run("train_radial", train_radial.main,
        ["-rd", fam_root, "-ds", "radial", "-ni", str(FAM_FRAMES), "-e", "1",
         "-omd", omd])
    with open(os.path.join(omd, "meta.json")) as f:
        meta = json.load(f)
    net = RadialFlowNetwork([l if isinstance(l, str) else tuple(l)
                             for l in meta["layers"]], meta["hWin"], device=dev)
    mio.load_weights_into(os.path.join(omd, "e0.msgpack"), net)

    # train_v2 at its defaults ('rectified_gopro_small', 17x17x32), on the
    # families phase's frames without its GT cache: the cache is keyed by
    # frame name, and that phase rectified under another RANSAC draw
    v2_seq = os.path.join(tmp.name, "v2")
    shutil.copytree(os.path.join(fam_root, "v2", "images"),
                    os.path.join(v2_seq, "images"))
    omd = os.path.join(tmp.name, "models_v2")
    run("train_v2", train_v2.main,
        ["-rd", v2_seq, "-ni", str(FAM_FRAMES), "-e", "1", "-omd", omd])
    with open(os.path.join(omd, "meta.json")) as f:
        meta = json.load(f)
    v2 = V2Network(V2Params(wImg=meta["wImg"], hImg=meta["hImg"],
                            normalization_k=meta["normalization_k"],
                            layers=tuple(tuple(l) for l in meta["layers"]),
                            hWin=meta["hWin"], wWin=meta["wWin"]), device=dev)
    mio.load_weights_into(os.path.join(omd, "e0"), v2)

    # depth_estimation at 360x640, then -lw with -i
    legacy = os.path.join(fam_root, "legacy")
    o = os.path.join(tmp.name, "legacy_model")
    base = ["-rd", legacy, "-d", "1", "-ni", str(FAM_FRAMES)]
    run("depth_estimation", depth_estimation.main, base + ["-e", "1", "-o", o])
    families.DepthClassifierTrainer.load(o, device=dev)
    first = int(depth_legacy.load_raw_depth_data(legacy)[0]["name"])
    run("depth_estimation_lw", depth_estimation.main,
        base + ["-lw", o, "-i", str(first), "-o", o])
    z = np.load(os.path.join(o, f"depth_classes_{first:09d}.npz"))
    check(z["classes"].ndim == 2 and os.path.exists(
        os.path.join(o, f"depth_classes_{first:09d}.png")),
        "depth_estimation -i: class map")

    out["launches"] = {k: fn.launches for k, fn in counters.items()}
    tmp.cleanup()
    out["phase_seconds"] = time.perf_counter() - t_phase
    print(f"training CLIs: seconds {json.dumps(out['seconds'])}; launches on "
          f"this path {out['launches']}; phase took "
          f"{out['phase_seconds']:.1f} s", flush=True)
    report["training_clis"] = out
    return out["launches"]


def robot_peer(ctrl, nav, received, ready):
    """The drone SDK's side of the FIFO link: the control pipe's read end
    first (the API opens its write end first, blocking), then the navdata
    write end; one navdata record with a forward velocity, then every
    control record until the API closes the link."""
    from depth_estimation_tpu_torch.robotics import runtime
    with open(ctrl, "rb") as f, open(nav, "wb") as nav_w:
        nav_w.write(runtime.encode_navdata(1, 90.0, [0, 0, 0], 100.0,
                                           list(ROBOT_VELOCITY)))
        nav_w.flush()
        ready.set()
        while True:
            rec = f.read(runtime.CONTROL_RECORD_LEN)
            if len(rec) < runtime.CONTROL_RECORD_LEN:
                return
            received.append(rec)


def phase_robotics(dev, card, geom, params, report):
    """Phase 14b: the real-drone loop on the card. ``FifoDroneAPI`` over
    ``os.mkfifo`` pipes with a peer thread playing the SDK, the per-frame
    ``DepthEstimator`` with car_model (ARDRONE 640x480 -> 320x180, 16x16
    window) fed by an ``ImageCamera`` pushed a forward-camera sequence,
    ``AvoidanceController`` over ``DepthMap(64, 128, 100, 0.9, 320)`` for
    ROBOT_TICKS ticks; B1 once a tick; the depth rule on the card against
    the CPU on the same x-flow and mask; the simulator's avoidance run
    (seed 11, a pillar ahead). B1's and B4's counts are zeroed before the
    loop and read after. Returns them."""
    import threading
    from depth_estimation_tpu_torch import api
    from depth_estimation_tpu_torch.data.images import ImageCamera
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.robotics import control, drone_api, runtime
    t_phase = time.perf_counter()
    out = {}
    t0 = time.perf_counter()
    runtime.load_library()
    out["native_build_s"] = time.perf_counter() - t0
    frames = zoom_sequence(41, ROBOT_TICKS + 2, ARDRONE.hImg, ARDRONE.wImg,
                           *ROBOT_ZOOM)
    est = api.DepthEstimator(geom, params, ARDRONE, device=dev)
    est.reset(frames[0])
    camera = ImageCamera(ARDRONE.hImg, ARDRONE.wImg)
    for f in frames[1:ROBOT_TICKS + 1]:
        camera.push(f)
    tmp = tempfile.TemporaryDirectory()
    ctrl, nav = (os.path.join(tmp.name, k) for k in ("control", "navdata"))
    os.mkfifo(ctrl)
    os.mkfifo(nav)
    received, ready = [], threading.Event()
    peer = threading.Thread(target=robot_peer,
                            args=(ctrl, nav, received, ready), daemon=True)
    peer.start()
    link = drone_api.FifoDroneAPI(ctrl, nav, est, camera, device=dev)
    check(ready.wait(30), "robot peer: no navdata")
    counters = kernel_counters()
    for fn in counters.values():
        fn.launches = 0
    ticks = []
    try:
        link.takeoff()
        ctl = control.AvoidanceController(
            link, runtime.DepthMap(64, 128, 100.0, 0.9, 320.0), fov=32)
        for _ in range(ROBOT_TICKS):
            t0 = time.perf_counter()
            ctl.step()
            ticks.append(time.perf_counter() - t0)
        counts = {k: fn.launches for k, fn in counters.items()}
        depth, conf = link.get_depth_map(), link.get_confidence_map()
        pos = link.position().tolist()
    finally:
        link.close()
        peer.join(30)
    tmp.cleanup()
    check(not peer.is_alive(), "robot peer still running")
    kinds = [runtime.decode_control(r)[0] for r in received]
    out.update(launches=counts, tick_ms=[t * 1e3 for t in ticks],
               tick_median_ms=statistics.median(ticks) * 1e3,
               controls=len(received), position=pos,
               conf_share=float(conf.mean()),
               near_share=float(((depth > 0) & (depth < 100)).mean()))
    check(counts["match_fused"] == ROBOT_TICKS,
          f"robot loop: B1 launched {counts['match_fused']} times in "
          f"{ROBOT_TICKS} ticks")
    check(kinds == ["T"] + ["C"] * ROBOT_TICKS,
          f"robot peer received {len(received)} records: {kinds[:5]}...")
    check(depth.shape == (geom.hImg, geom.wImg) and out["conf_share"] > 0.05,
          f"robot loop: depth {depth.shape}, confident {out['conf_share']}")

    # the depth rule on the card against the CPU, one more frame's flow
    _, xflow, mask = est.next_frame_depth(frames[ROBOT_TICKS + 1],
                                          fetch=False)
    m = float(ROBOT_VELOCITY[0] * 0.05)
    got = drone_api.compute_depth_map_from_flow(xflow, mask, m)
    want = drone_api.compute_depth_map_from_flow(xflow.cpu(), mask.cpu(), m)
    out["depth_rule_equal"] = all(torch.equal(a.cpu(), b)
                                  for a, b in zip(got, want))
    out["depth_rule_ms"] = cuda_ms(
        lambda: drone_api.compute_depth_map_from_flow(xflow, mask, m))
    check(out["depth_rule_equal"], "depth rule: card != CPU")

    # the simulator's avoidance run: a pillar dead ahead, seed 11
    sim = runtime.SimulatedAPI(320, 240, fixed_dt=0.05, seed=11,
                               default_course=False)
    sim.add_obstacle(8.0, 0.0, 0.0, 1.5)
    sim.takeoff()
    traj = control.AvoidanceController(
        sim, runtime.DepthMap(64, 128, 100.0, 0.9, 320.0), fov=32).run(150)
    out["sim_final_x"] = float(traj[-1, 0])
    out["sim_min_pillar_distance"] = float(
        np.hypot(traj[:, 0] - 8.0, traj[:, 1]).min())
    check(out["sim_final_x"] > 4.0 and out["sim_min_pillar_distance"] > 1.5,
          f"simulator avoidance: {out}")
    out["seconds"] = time.perf_counter() - t_phase
    print(f"[{card}] robot loop: {ROBOT_TICKS} ticks, median tick "
          f"{out['tick_median_ms']:.2f} ms (first {out['tick_ms'][0]:.1f} ms), "
          f"launches {counts}, the peer received {len(received)} records, "
          f"position {[round(p, 3) for p in pos]}, confident share "
          f"{out['conf_share']:.3f}; depth rule on the card "
          f"{out['depth_rule_ms']:.3f} ms, equal to the CPU's "
          f"{out['depth_rule_equal']}; native build "
          f"{out['native_build_s']:.1f} s; simulator avoidance x "
          f"{out['sim_final_x']:.2f}, closest to the pillar "
          f"{out['sim_min_pillar_distance']:.2f}; phase took "
          f"{out['seconds']:.1f} s", flush=True)
    report["robotics"] = out
    return counts


# ---------------------------------------------------------------------------
# phase 15: the peak meter (kernel P1), P2's sweep and the roofline
# ---------------------------------------------------------------------------

VPU_CHECK_ITERS = 3     # at the meter's and the sweep's element counts
# P1 and P2 against their twins: the kernel's FFMA rounds c - c*c once
# where the twin rounds the product and then the difference, and CUDA's
# expf and torch's exp may part by an ulp; both maps contract on the
# values they see, (0, 1), so the iterates part by a few ulp of values
# below 1 (6e-8 each) and do not grow
TOL_VPU = 1e-6
TRACE_DIR = os.path.join(ROOT, "chiprun_out", "trace_peaks")


def phase_peaks(dev, card, report):
    """P1 (FMA, exp) and P2 (1, 2, 4, 8 chains, full occupancy and 4 warps
    an SM) against their twins on random values at the element counts the
    meter and the sweep launch them at, for a few iterations; then the peak meter under
    capture_trace and profiled_span, and P2's sweep, with their counts
    zeroed before and read after; the ceilings against the published
    peaks; the roofline rows. Returns the kernels line's P1 and P2 entries."""
    from depth_estimation_tpu_torch.benchmarks import device_peaks as dp
    from depth_estimation_tpu_torch.benchmarks import probe_vpu_peak
    from depth_estimation_tpu_torch.benchmarks import speed_of_light as sol
    from depth_estimation_tpu_torch.utils.timer import (
        TRACE_FILE, capture_trace, profiled_span)
    t_phase = time.perf_counter()
    gen = torch.Generator(device=dev).manual_seed(15)
    xs = {op: 0.05 + 0.9 * torch.rand(dp.SIZES["cuda"][op][0],
                                      generator=gen, device=dev)
          for op in ("fma", "exp", "p2")}
    it = VPU_CHECK_ITERS
    cases = [("p1_fma", xs["fma"], lambda x: dp.vpu_loop(x, "fma", it),
              lambda x: dp.chains_fma_plain(x, 8, 16, it, True)),
             ("p1_exp", xs["exp"], lambda x: dp.vpu_loop(x, "exp", it),
              lambda x: dp.chains_exp_plain(x, 8, 4, it, True))]
    for c in probe_vpu_peak.CHAINS:
        for w in probe_vpu_peak.WARPS:
            cases.append((f"p2_{c}_chains_{w}_warps", xs["p2"],
                          lambda x, c=c, w=w: dp.logistic_loop(x, c, it, w),
                          lambda x, c=c: dp.chains_fma_plain(
                              x, c, dp.P2_STEPS // c, it, False)))
    checks = {}
    for name, x, kernel, plain in cases:
        got, ref = kernel(x), plain(x)
        torch.cuda.synchronize()
        err = (got - ref).abs().max().item()
        check(bool(torch.isfinite(got).all()), f"{name} non-finite")
        check(err <= TOL_VPU, f"{name} error {err}")
        checks[name] = dict(max_abs_err=err, n=x.numel(), n_iter=it,
                            ms_check=cuda_ms(lambda: kernel(x)),
                            plain_ms=cuda_ms(lambda: plain(x)))
        del got, ref
        print(f"{name}: max err {err:.2e} against the twin at {x.numel()} "
              f"values x {it} iterations; kernel "
              f"{checks[name]['ms_check']:.3f} ms, plain "
              f"{checks[name]['plain_ms']:.3f} ms", flush=True)
    del xs
    # the meter and the sweep at full size, the kernels' counts read around
    dp.vpu_loop.launches = 0
    dp.logistic_loop.launches = 0
    shutil.rmtree(TRACE_DIR, ignore_errors=True)
    with capture_trace(TRACE_DIR) as started:
        with profiled_span("device_peaks"):
            peaks = dp.measure_peaks(dev)
    sweep = probe_vpu_peak.probe(dev)
    launches = dict(vpu_loop=dp.vpu_loop.launches,
                    logistic_loop=dp.logistic_loop.launches)
    check(started, "capture_trace did not start the profiler")
    trace_path = os.path.join(TRACE_DIR, TRACE_FILE)
    with open(trace_path) as f:
        trace = f.read()
    check('"device_peaks"' in trace and "chains_kernel" in trace,
          "the trace names neither the span nor P1's kernel")
    with open(trace_path, "rb") as f, gzip.open(trace_path + ".gz", "wb") as g:
        shutil.copyfileobj(f, g)
    os.remove(trace_path)
    print(f"trace of the meter: {len(trace) / 1e6:.1f} MB of Chrome trace, "
          f"names the span and P1's kernel; kept as {trace_path}.gz",
          flush=True)
    probes = peaks["probes"]
    line = {"card": card, "kind": peaks["kind"], "torch": peaks["torch"],
            "tf32": peaks["tf32"]}
    for key in ("vpu_fma_f32_gflops", "vpu_exp_gops", "tc_bf16_tflops",
                "matmul_f32_tflops", "hbm_stream_gbps", "gather_idx_gops"):
        line[key] = dict(rate=peaks[key], ms=probes[key]["ms"],
                         published=sol.PUBLISHED.get(key),
                         share_of_published=(peaks[key] / sol.PUBLISHED[key]
                                             if key in sol.PUBLISHED else None),
                         **probes[key]["clock_under_load"])
    line["p2_sweep"] = {
        w: {c: {"gflops": r["gflops"], **r.get("clock_under_load", {})}
            for c, r in rows.items()}
        for w, rows in sweep["warps_an_sm"].items()}
    print(json.dumps({"peaks": line}), flush=True)
    rows = sol.report(peaks, dev)
    print(json.dumps({"roofline": rows}), flush=True)
    for r in rows:
        print(f"[{card}] roofline {r['kernel']}: {r['measured_ms']:.4f} ms a "
              f"call back to back; {r['pct_sol']:.1f}% of the measured "
              f"ceiling ({r['bound']}), {r['pct_sol_published']:.1f}% of the "
              f"published ({r['bound_published']})", flush=True)
    failures = sol.contract_failures(peaks, rows, sweep)
    check(not failures, f"speed-of-light contract broken: {failures}")
    fp32_pub = sol.PUBLISHED["vpu_fma_f32_gflops"]
    # the kernels line's entries: ms a launch of the meter's; the kernel's
    # and the twin's ms at the check's size; the bound of the meter's
    # launch (each value read and written once; its operations at the
    # published rate)
    n_fma, n_exp, n_p2 = (dp.SIZES["cuda"][k][0] for k in ("fma", "exp", "p2"))
    fma, exp = probes["vpu_fma_f32_gflops"], probes["vpu_exp_gops"]
    s8 = sweep["warps_an_sm"][dp.FULL_WARPS][8]
    p1_bound = bound_ms(8 * n_fma, fma["work"])
    p2_bound = bound_ms(8 * n_p2, n_p2 * s8["n_iter"] * dp.P2_OPS[8])
    p2_check = checks[f"p2_8_chains_{dp.FULL_WARPS}_warps"]
    src = "depth_estimation_tpu_torch/csrc/vpu_peak.cu"
    p1 = {"name": "vpu_loop", "route": "cuda", "source": src,
          "replaces": "benchmarks/device_peaks.py:164",
          "launches": launches["vpu_loop"],
          "max_abs_err": max(checks["p1_fma"]["max_abs_err"],
                             checks["p1_exp"]["max_abs_err"]),
          "ms": fma["ms"], "plain_ms": checks["p1_fma"]["plain_ms"],
          "bound_ms": p1_bound[0], "bound_by": p1_bound[1], "library_ms": None,
          "ms_check": checks["p1_fma"]["ms_check"],
          "rate_gflops": peaks["vpu_fma_f32_gflops"],
          "share_of_published": peaks["vpu_fma_f32_gflops"] / fp32_pub,
          "exp": {"ms": exp["ms"], "plain_ms": checks["p1_exp"]["plain_ms"],
                  "ms_check": checks["p1_exp"]["ms_check"],
                  "bound_ms": 1e3 * max(8 * n_exp / PEAK_BYTES,
                                        exp["work"] / PEAK_SFU),
                  "rate_gops": peaks["vpu_exp_gops"],
                  "share_of_published": peaks["vpu_exp_gops"]
                  / sol.PUBLISHED["vpu_exp_gops"]}}
    p2 = {"name": "logistic_loop", "route": "cuda", "source": src,
          "replaces": "benchmarks/probe_vpu_peak.py:36",
          "launches": launches["logistic_loop"],
          "max_abs_err": max(v["max_abs_err"] for k, v in checks.items()
                             if k.startswith("p2_")),
          "ms": s8["ms"], "plain_ms": p2_check["plain_ms"],
          "bound_ms": p2_bound[0], "bound_by": p2_bound[1], "library_ms": None,
          "ms_check": p2_check["ms_check"],
          "rate_gflops": s8["gflops"],
          "share_of_published": s8["gflops"] / fp32_pub,
          "sweep": line["p2_sweep"]}
    seconds = time.perf_counter() - t_phase
    print(f"peaks: P1 {launches['vpu_loop']} launches, P2 "
          f"{launches['logistic_loop']} on this path; phase took "
          f"{seconds:.1f} s", flush=True)
    report["peaks"] = dict(peaks=peaks, sweep=sweep, checks=checks,
                           launches=launches, roofline=rows, seconds=seconds)
    return p1, p2


# phase 16, the mesh layer (parallel/mesh.py): every visible card, or one
# card split in two shards where only one is visible (a host thread a
# card, so one card's two shards are issued from one thread). The online program at
# PAR_B_CARD streams a card; a shard's streams must equal the unsharded
# program run on those streams alone (each shard runs that program at its
# local batch), and against the full-batch run, where cuSOLVER's batched
# QR and cuDNN may take other paths at another batch size, the x-flow is
# held to C6's bounds on items whose RANSAC winner is 8 distinct points
# (the others counted). The row-sharded flow against the unsharded model
# on the zero-padded frame (cuDNN on another frame height): TOL_FLIP of
# the WTA indices, TOL_FLOW_PX for ey/ex. The liu GT per shard chunk
# against the unsharded solve of that chunk within TOL_SOR; one Trainer
# step within TOL_TRAIN_LOSS_REL / TOL_TRAIN_PARAM of the unsharded step.
PAR_B_CARD, PAR_STEPS, PAR_TRAIN_B = 128, 3, 64


def parallel_mesh():
    """(the phase's mesh, the number of distinct cards in it)."""
    from depth_estimation_tpu_torch.parallel import mesh as pm
    n = torch.cuda.device_count()
    if n >= 2:
        return pm.make_mesh([torch.device("cuda", i) for i in range(n)]), n
    return pm.make_mesh(["cuda:0", "cuda:0"]), 1


def sync_all():
    for i in range(torch.cuda.device_count()):
        torch.cuda.synchronize(i)


def step_seconds(est, t1, t2, steps):
    """Host seconds of ``steps`` online steps (alternating frames, every
    card synchronised after each), after one warm-up step."""
    est.reset(t1)
    est.next_frames(t2)
    sync_all()
    times = []
    for k in range(steps):
        t0 = time.perf_counter()
        est.next_frames(t1 if k % 2 == 0 else t2)
        sync_all()
        times.append(time.perf_counter() - t0)
    return statistics.median(times)


class shards_in_order:
    """Within the block, the mesh layer issues its shards one after another
    from the calling thread, not from a host thread a card: the other
    design, timed against it (the same path where the mesh is one card)."""

    def __enter__(self):
        from depth_estimation_tpu_torch.parallel import mesh as pm
        self.pm, self.saved = pm, pm.run_shards

        def in_order(fn, mesh, *shards):
            out = []
            for i, d in enumerate(mesh.devices):
                with torch.cuda.device(d) if d.type == "cuda" else \
                        contextlib.nullcontext():
                    out.append(fn(i, *(s[i] for s in shards)))
            return out
        pm.run_shards = in_order

    def __exit__(self, *exc):
        self.pm.run_shards = self.saved


def phase_parallel(dev, card, geom, params, report):
    """The mesh layer on the card(s): BatchedDepthEstimator.shard (fast and
    'warp' mode, B1 and B3 on every shard), spatial_sharded_flow_fn (B1 on
    every shard), sharded_celiu_fn (B4 on every shard) and a Trainer step
    with use_mesh, each held against its unsharded run, and the online
    step's time sharded and not. B1's, B3's and B4's counts (and their
    counts by device) are zeroed before and read after."""
    from depth_estimation_tpu_torch import api_batched
    from depth_estimation_tpu_torch.flow import celiu, sor_kernel
    from depth_estimation_tpu_torch.geometry import Learning
    from depth_estimation_tpu_torch.geometry3d import egomotion
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.models.flow import (FlowModel,
                                                        crop_features_center)
    from depth_estimation_tpu_torch.ops import _kernels, matching, warp
    from depth_estimation_tpu_torch.parallel import mesh as pm
    from depth_estimation_tpu_torch.training import train
    t_phase = time.perf_counter()
    mesh, n_cards = parallel_mesh()
    counters = {"match_fused": matching.match_flow_fused,
                "warp_banded": warp.banded_bilinear_warp,
                "sor_redblack": sor_kernel.sor_redblack}
    for fn in counters.values():
        fn.launches = 0
    _kernels.LAUNCHES_BY_DEVICE.clear()
    out = dict(devices=[str(d) for d in mesh.devices], cards=n_cards,
               card=card)
    print(f"parallel: mesh of {mesh.size} shards on {n_cards} card(s): "
          f"{out['devices']}", flush=True)

    # 1. the online program, B=128 a card, fast and 'warp' mode
    B = PAR_B_CARD * n_cards
    gen = torch.Generator(device=dev).manual_seed(21)
    t1, t2 = forward_frames(gen, B, dev)
    online = {}
    # 'warp_banded' too, untimed: 'warp' takes B3 only where a shard's
    # whole batch is in band, and B3 must run on every card
    for mode, knobs in (("fast", FAST), ("warp", dict(compensation="warp")),
                        ("warp_banded", dict(compensation="warp_banded"))):
        noise = egomotion.gumbel_noise(knobs.get("ransac_samples", 64),
                                       ARDRONE.sfm.max_points, dev)

        def estimator(device):
            return api_batched.BatchedDepthEstimator(
                geom, params, ARDRONE, head="mean", device=device,
                ransac_noise=noise, **knobs)
        full = estimator(dev)
        full.reset(t1)
        u1 = full.last_u
        want = [t.cpu() for t in full.next_frames(t2)]
        distinct = ego_trace(full, u1, full.last_u)["distinct"]
        sharded = estimator(dev).shard(mesh)
        sharded.reset(t1)
        got = [t.cpu() for t in sharded.next_frames(t2)]
        check(isinstance(sharded.last_u, pm.Sharded)
              and sharded.last_u.devices == mesh.devices,
              f"{mode}: the stream state is not sharded on the mesh")
        # each shard against the unsharded program on its streams alone
        loc = B // mesh.size
        exact = 0
        for i, d in enumerate(mesh.devices):
            sl = slice(i * loc, (i + 1) * loc)
            alone = estimator(d)
            alone.reset(t1[sl].to(d))
            ref = [t.cpu() for t in alone.next_frames(t2[sl].to(d))]
            exact += all(torch.equal(a[sl], b) for a, b in zip(got, ref))
        rows = flow_diff(got, want)
        held = [r for r, k in zip(rows, distinct) if k == 8]
        worst = dict(mean=max(r["mean"] for r in held),
                     p99=max(r["p99"] for r in held))
        res = dict(B=B, exact_shards=exact, shards=mesh.size,
                   items_exact=sum(r["max"] == 0 for r in rows),
                   items_held=len(held), items_skipped_c9=B - len(held),
                   worst_mean_px=worst["mean"], worst_p99_px=worst["p99"],
                   good_equal=all(r["good"][0] == r["good"][1] for r in rows),
                   min_mask_agreement=min(r["mask_agreement"] for r in rows))
        if mode == "warp_banded":
            online[mode] = res
            print(f"parallel online {mode}: B={B} over {mesh.size} shards; "
                  f"{exact}/{mesh.size} shards equal to the unsharded "
                  f"program on their streams; against the full batch "
                  f"{res['items_exact']}/{B} items exact, xflow diff mean <= "
                  f"{worst['mean']:.2e} p99 <= {worst['p99']:.2e} px on "
                  f"{len(held)} items", flush=True)
            check(exact == mesh.size and res["good_equal"]
                  and worst["mean"] <= TOL_E2E_MEAN_PX
                  and worst["p99"] <= TOL_E2E_P99_PX, f"{mode}: {res}")
            continue
        res["unsharded_s"] = step_seconds(estimator(dev), t1, t2, PAR_STEPS)
        res["sharded_s"] = step_seconds(estimator(dev).shard(mesh), t1, t2,
                                        PAR_STEPS)
        with shards_in_order():
            res["sharded_in_order_s"] = step_seconds(
                estimator(dev).shard(mesh), t1, t2, PAR_STEPS)
        res["unsharded_pairs_s"] = B / res["unsharded_s"]
        res["sharded_pairs_s"] = B / res["sharded_s"]
        if n_cards > 1:     # one card at its own B=128, the per-card yardstick
            res["one_card_s"] = step_seconds(estimator(dev), t1[:PAR_B_CARD],
                                             t2[:PAR_B_CARD], PAR_STEPS)
            res["one_card_pairs_s"] = PAR_B_CARD / res["one_card_s"]
        online[mode] = res
        print(f"parallel online {mode}: B={B} over {mesh.size} shards; "
              f"{exact}/{mesh.size} shards equal to the unsharded program on "
              f"their streams; against the full batch {res['items_exact']}"
              f"/{B} items exact, on the {len(held)} with 8-distinct winners "
              f"xflow diff mean <= {worst['mean']:.2e} p99 <= "
              f"{worst['p99']:.2e} px ({B - len(held)} skipped, C9), good "
              f"equal {res['good_equal']}, mask agreement >= "
              f"{res['min_mask_agreement']:.5f}; step {res['sharded_s']*1e3:.1f}"
              f" ms sharded ({res['sharded_in_order_s']*1e3:.1f} ms with the "
              f"shards issued in order from one thread), "
              f"{res['unsharded_s']*1e3:.1f} ms unsharded "
              f"({res['sharded_pairs_s']:.1f} / {res['unsharded_pairs_s']:.1f}"
              f" frame-pairs/s)" + (
                  f"; one card at B={PAR_B_CARD}: {res['one_card_s']*1e3:.1f}"
                  f" ms ({res['one_card_pairs_s']:.1f} frame-pairs/s)"
                  if n_cards > 1 else ""), flush=True)
        check(exact == mesh.size, f"{mode}: a shard differs from the "
              f"unsharded program on its streams")
        check(res["good_equal"], f"{mode}: good differs from the full batch")
        check(res["min_mask_agreement"] >= TOL_E2E_MASK,
              f"{mode}: mask agreement {res['min_mask_agreement']}")
        check(len(held) > 0 and worst["mean"] <= TOL_E2E_MEAN_PX
              and worst["p99"] <= TOL_E2E_P99_PX,
              f"{mode}: x-flow against the full batch {worst}")
    out["online"] = online

    # 2. one frame pair split by rows, against the zero-padded frame
    model = mio.load_tree_into(FlowModel(geom, device=dev), params)
    u = full.last_u[:2].float()
    H = -(-geom.hImg // mesh.size) * mesh.size
    halo = (geom.maxh - 1) + (geom.hKernel - 1)
    img1 = torch.nn.functional.pad(u[0], (0, 0, 0, 0, 0, H - geom.hImg))
    img2 = torch.nn.functional.pad(u[1], (0, 0, 0, 0, 0, H - geom.hImg))
    idx_s, ey_s, ex_s, _ = (o.gather(dev) for o in
                            pm.spatial_sharded_flow_fn(model, mesh)(img1,
                                                                   img2))
    pad = (0, 0, 0, 0, 0, halo)
    with torch.no_grad():
        f1 = crop_features_center(geom, model.features(
            torch.nn.functional.pad(img1, pad)))
        f2 = model.features(torch.nn.functional.pad(img2, pad))
        idx_u, ey_u, ex_u, _ = matching.match_flow_fused(f1, f2, geom.maxh,
                                                         geom.maxw)
    flips = (idx_s != idx_u[:H]).float().mean().item()
    same = idx_s == idx_u[:H]
    dy = (ey_s - ey_u[:H]).abs()[same].max().item()
    dx = (ex_s - ex_u[:H]).abs()[same].max().item()
    out["spatial_flow"] = dict(rows=H, halo=halo, flip_share=flips,
                               ey_max_diff=dy, ex_max_diff=dx)
    print(f"parallel spatial flow: {H}x{geom.wImg} over {mesh.size} shards, "
          f"halo {halo} rows: WTA differs on {flips:.2e}, ey/ex max diff "
          f"{dy:.2e} / {dx:.2e} px", flush=True)
    check(flips <= TOL_FLIP and dy <= TOL_FLOW_PX and dx <= TOL_FLOW_PX,
          f"spatial flow against the padded frame: {out['spatial_flow']}")

    # 3. the liu GT at config2 (B4 on every shard)
    im1, im2 = shifted_textures(gen, GT_B, GT_H, GT_W, GT_SHIFT, dev)
    vx, vy, warped = pm.sharded_celiu_fn(mesh, **GT_SCHEDULE)(im1, im2)
    loc = GT_B // mesh.size
    gt_diff = 0.0
    for i, d in enumerate(mesh.devices):
        sl = slice(i * loc, (i + 1) * loc)
        ref = celiu.coarse2fine_flow_batched(im1[sl].to(d), im2[sl].to(d),
                                             **GT_SCHEDULE)
        gt_diff = max([gt_diff] + [(a - b).abs().max().item()
                                   for a, b in zip((vx[i], vy[i], warped[i]),
                                                   ref)])
    med_u = vx.gather(dev)[:, 12:-12, 12:-12].flatten(1).median(dim=1).values
    out["liu"] = dict(B=GT_B, max_diff_per_shard=gt_diff,
                      median_u=med_u.tolist())
    print(f"parallel liu config2: B={GT_B} over {mesh.size} shards, max diff "
          f"against the unsharded solve of each shard's pairs {gt_diff:.2e}, "
          f"median inner x-flow {med_u.min().item():.4f}.."
          f"{med_u.max().item():.4f} px (shift {GT_SHIFT})", flush=True)
    check(gt_diff <= TOL_SOR, f"liu per shard: {gt_diff}")
    check(bool(((med_u - GT_SHIFT).abs() < 0.25).all()), "liu shift")

    # 4. one Trainer step, B=64
    lrn = Learning(**TRAIN_LEARNING)
    g = torch.Generator(device=dev).manual_seed(22)
    x1 = torch.rand(PAR_TRAIN_B, geom.hPatch2, geom.wPatch2, 3, generator=g,
                    device=dev)
    x2 = torch.rand(PAR_TRAIN_B, geom.hPatch2, geom.wPatch2, 3, generator=g,
                    device=dev)
    it = torch.randint(0, geom.maxh * geom.maxw, (PAR_TRAIN_B,), generator=g,
                       device=dev, dtype=torch.int32)
    soft = torch.zeros(PAR_TRAIN_B, geom.maxh * geom.maxw, device=dev)
    single = train.Trainer(geom, lrn, device=dev).init(
        torch.Generator().manual_seed(0))
    dp = train.Trainer(geom, lrn, device=dev).init(
        torch.Generator().manual_seed(0)).use_mesh(mesh)
    a1, a2 = single.step(x1, x2, it, soft), dp.step(x1, x2, it, soft)
    loss_rel = abs(a1["loss"].item() - a2["loss"].item()) / abs(
        a1["loss"].item())
    pdiff = max_param_diff(single.model, dp.model)
    out["trainer_step"] = dict(B=PAR_TRAIN_B, loss_rel=loss_rel,
                               param_max_diff=pdiff,
                               grad_ok=bool(a2["grad_ok"]))
    print(f"parallel Trainer step: B={PAR_TRAIN_B} over {mesh.size} shards: "
          f"loss rel diff {loss_rel:.2e}, parameters max diff {pdiff:.2e}",
          flush=True)
    check(bool(a2["grad_ok"]) and loss_rel <= TOL_TRAIN_LOSS_REL
          and pdiff <= TOL_TRAIN_PARAM, f"sharded step: {out['trainer_step']}")

    sync_all()
    counts = {k: fn.launches for k, fn in counters.items()}
    by_device = {}
    for (name, d), v in _kernels.LAUNCHES_BY_DEVICE.items():
        by_device.setdefault(name, {})[d] = v
    out["launches"] = counts
    out["launches_by_device"] = by_device
    out["seconds"] = time.perf_counter() - t_phase
    print(f"parallel: launches {counts}, by device {by_device}; phase "
          f"{out['seconds']:.1f} s", flush=True)
    for fn in counters.values():
        per = by_device.get(fn.__name__, {})
        for d in set(out["devices"]):
            check(per.get(d, 0) > 0, f"{fn.__name__} not launched on {d}")
    report["parallel"] = out
    return counts, by_device


# phase 17: the launch-plan autotuner (ops/autotune.py, the estimator's
# match_block="auto"), the port's f32 rule at its entry points
# (utils/precision.py, ROADMAP C12) and the NaN scope (utils/debug.py). At
# the online program's shape (B=128, car_model, 16x16 window, K=10, conf
# on) every candidate plan of B1 and of B2 must give the default plan's
# outputs bit for bit (the default held to its twin within the phase-3
# tolerances); the store must answer a second resolution, in this process
# and in a new one, with no timing; the "auto" estimator must equal
# match_block=8 bitwise in fast and 'warp' mode; a step run with torch's
# default flags (cuDNN's TF32 on) must equal the step with both flags off.
# What TF32 would change (the trunk's and LK's convolutions in TF32 through
# the estimator's inner program, which sets no flag) is measured on the
# streams whose RANSAC winner is 8 distinct points (C9), beside the 0.1 px
# budget of the repository's precision policy (bf16 storage on a trained
# model).
TF32_BUDGET_PX = 0.1
AUTOTUNE_RESOLVE = r"""
import json, sys
import torch
from depth_estimation_tpu_torch.ops import autotune
timed = []
def timer(fn):
    timed.append(1)
    return autotune._default_timer(fn)
plans = []
for kernel, dt, f1, f2 in json.loads(sys.argv[1]):
    plans.append(list(autotune.best_plan(
        kernel, tuple(f1), tuple(f2), 16, 16, getattr(torch, dt), True,
        device="cuda:0", timer=timer)))
print(json.dumps({"timings": len(timed), "plans": plans}))
"""


def phase_autotune(dev, card, geom, params, report):
    """The autotuner's sweep, store and estimator hook; the f32 rule at
    the entry points and TF32's x-flow delta (C12); nan_debug on the card.
    Returns B1's launches on the "auto" estimators' run."""
    from depth_estimation_tpu_torch import api_batched
    from depth_estimation_tpu_torch.geometry3d import egomotion
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.models.flow import crop_features_center
    from depth_estimation_tpu_torch.ops import autotune, matching
    from depth_estimation_tpu_torch.utils import debug, precision
    t_phase = time.perf_counter()
    out = dict(card=card)
    g = geom
    est = api_batched.BatchedDepthEstimator(geom, params, ARDRONE, device=dev)
    gen = torch.Generator(device=dev).manual_seed(17)
    t1, t2 = forward_frames(gen, B_MAIN, dev)
    with torch.no_grad():
        f1 = crop_features_center(g, est._prep(t1)[1])
        f2 = est._prep(t2)[1]

    # 1-2. every candidate against the default plan and the twin, timed
    def sweep(kernel, dt):
        if kernel == "fused":
            def run(plan):
                return matching._match_flow_fused_cuda(
                    f1, f2, g.maxh, g.maxw, False, dt, True, 0.11, plan)
            ref = matching.match_flow_fused_plain(f1, f2, g.maxh, g.maxw,
                                                  False, dt, True)
        else:
            def run(plan):
                return matching._match_flow_fast_cuda(f1, f2, g.maxh, g.maxw,
                                                      dt, plan)
            ref = matching.match_flow_fast_plain(f1, f2, g.maxh, g.maxw, dt)
        plans = autotune.candidates_for(kernel, g.maxh, g.maxw, f1.shape[-1])
        want = run(None)
        torch.cuda.synchronize()
        flips = (want[0] != ref[0]).float().mean().item()
        errs = [(a - b).abs().max().item() for a, b in zip(want[1:4], ref[1:4])]
        check(flips <= TOL_FLIP and max(errs[:2]) <= TOL_FLOW_PX
              and errs[2] <= TOL_PROB,
              f"{kernel} {dt}: default plan vs twin: flips {flips}, {errs}")
        rows = []
        for plan in plans:
            got = run(plan)
            torch.cuda.synchronize()
            rows.append(dict(
                plan=list(plan), ms=cuda_ms(lambda: run(plan), reps=5,
                                            warmup=2),
                equal_default=all(torch.equal(a, b)
                                  for a, b in zip(got, want)),
                equal_twin=all(torch.equal(a, b) for a, b in zip(got, ref)),
                max_abs_err_twin=max((a.float() - b.float()).abs().max().item()
                                     for a, b in zip(got, ref))))
            r = rows[-1]
            print(f"[{card}] autotune {kernel} {str(dt)[6:]} {plan}: "
                  f"{r['ms']:.3f} ms, equal to the default plan "
                  f"{r['equal_default']}, to the twin {r['equal_twin']} "
                  f"(max abs err {r['max_abs_err_twin']:.2e})", flush=True)
        return rows

    cands = {}
    for kernel in ("fused", "fast"):
        for dt in (torch.bfloat16, torch.float32):
            cands[f"{kernel}_{str(dt)[6:]}"] = sweep(kernel, dt)
    out["candidates"] = cands

    # 2-3. best_plan at the main shape: measured once, persisted, and read
    # back with no timing, in this process and in a new one
    autotune.store_path().unlink(missing_ok=True)
    autotune._cache = None
    autotune._session_only.clear()
    timed = []

    def timer(fn):
        t = autotune._default_timer(fn)
        timed.append(t)
        return t
    calls = [(k, dt, list(f1.shape), list(f2.shape))
             for k in ("fused", "fast") for dt in ("bfloat16", "float32")]
    winners = {}
    for kernel, dt, s1, s2 in calls:
        n0 = len(timed)
        plan = autotune.best_plan(kernel, s1, s2, g.maxh, g.maxw,
                                  getattr(torch, dt), True, device=dev,
                                  timer=timer)
        ts = timed[n0:]
        plans = autotune.candidates_for(kernel, g.maxh, g.maxw, s1[-1])
        check(len(ts) == len(plans), f"{kernel} {dt}: {len(ts)} timings for "
              f"{len(plans)} candidates")
        winners[f"{kernel}_{dt}"] = w = dict(
            winner=list(plan), default=list(plans[0]),
            winner_ms=min(ts) * 1e3, default_ms=ts[0] * 1e3,
            winner_is_default=plan == plans[0], timings=len(ts))
        print(f"[{card}] autotune best_plan {kernel} {dt}: winner "
              f"{plan} {w['winner_ms']:.3f} ms against the default "
              f"{plans[0]} {w['default_ms']:.3f} ms ({len(ts)} timings)",
              flush=True)
    out["best_plan"] = winners
    autotune._cache = None
    n0 = len(timed)
    again = [list(autotune.best_plan(k, s1, s2, g.maxh, g.maxw,
                                     getattr(torch, dt), True, device=dev,
                                     timer=timer))
             for k, dt, s1, s2 in calls]
    res = subprocess.run([sys.executable, "-c", AUTOTUNE_RESOLVE,
                          json.dumps(calls)], cwd=ROOT, capture_output=True,
                         text=True, timeout=300)
    check(res.returncode == 0, f"resolving in a new process: {res.stderr}")
    child = json.loads(res.stdout.strip().splitlines()[-1])
    out["second_resolution"] = dict(timings=len(timed) - n0,
                                    new_process_timings=child["timings"])
    print(f"autotune: a second resolution timed {len(timed) - n0} "
          f"candidates, a new process {child['timings']}", flush=True)
    want_plans = [w["winner"] for w in winners.values()]
    check(len(timed) == n0 and again == want_plans,
          f"second resolution: {len(timed) - n0} timings, {again}")
    check(child["timings"] == 0 and child["plans"] == want_plans,
          f"new process: {child}")

    # 4. the "auto" estimator against match_block=8, bitwise
    counters = {"match_fused": matching.match_flow_fused}
    for fn in counters.values():
        fn.launches = 0
    modes = {"fast": dict(FAST), "warp": dict(compensation="warp")}
    auto_eq = {}
    for mode, knobs in modes.items():
        ests = {}
        for block in ("auto", 8):
            knobs["match_block"] = block
            e = api_batched.BatchedDepthEstimator(geom, params, ARDRONE,
                                                  device=dev, **knobs)
            e.reset(t1)
            ests[block] = [o.cpu() for o in e.next_frames(t2)]
            if block == "auto":
                plans = list(e._plans.values())
        auto_eq[mode] = dict(
            equal=all(torch.equal(a, b) for a, b in zip(ests["auto"], ests[8])),
            plan=[list(p) for p in plans])
        print(f"autotune: {mode} mode, match_block='auto' (B1 plan "
              f"{auto_eq[mode]['plan']}) equal to match_block=8: "
              f"{auto_eq[mode]['equal']}", flush=True)
    b1 = matching.match_flow_fused.launches
    out["estimator_auto"] = auto_eq
    check(all(v["equal"] for v in auto_eq.values()), f"auto: {auto_eq}")
    check(b1 == 4, f"B1 launched {b1} times for 4 auto/fixed steps")

    # 5. C12: a step with torch's default flags equals the step with both
    # off: the entry point sets its own precision
    noise = egomotion.gumbel_noise(64, ARDRONE.sfm.max_points, dev)
    e = api_batched.BatchedDepthEstimator(geom, params, ARDRONE, device=dev,
                                          ransac_noise=noise)
    seen = []
    hook = e.trunk.register_forward_hook(
        lambda m, i, o: seen.append(precision.tf32_flags()))
    steps = {}
    for name, flags in (("torch_defaults", (True, False)),
                        ("tf32_off", (False, False))):
        precision._set(*flags)
        e.reset(t1)
        steps[name] = [o.cpu() for o in e.next_frames(t2)]
        check(precision.tf32_flags() == flags, f"flags not restored: {name}")
    precision._set(False, False)
    hook.remove()
    c12_equal = all(torch.equal(a, b) for a, b in
                    zip(steps["torch_defaults"], steps["tf32_off"]))
    out["c12_step_equal"] = c12_equal
    print(f"C12: a 'warp' step under torch's default flags (cuDNN TF32 on) "
          f"equal to the step with TF32 off: {c12_equal}; the trunk ran "
          f"under {sorted(set(seen))}", flush=True)
    check(c12_equal and set(seen) == {(False, False)}, "C12 step")

    # 6. what TF32 would change: the inner program under cuDNN's default
    delta = {}
    for mode, knobs in (("warp", dict(compensation="warp")),
                        ("fast", {k: v for k, v in FAST.items()
                                  if k != "match_block"})):
        e = api_batched.BatchedDepthEstimator(
            geom, params, ARDRONE, device=dev,
            ransac_noise=egomotion.gumbel_noise(
                knobs.get("ransac_samples", 64), ARDRONE.sfm.max_points, dev),
            **knobs)
        runs = {}
        with torch.no_grad():
            for name, flags in (("tf32", (True, False)), ("f32", (False, False))):
                precision._set(*flags)
                u1, fe1 = e._prep(t1)
                res = e._step(u1, fe1, t2)
                runs[name] = [o.cpu() for o in res[2:]]
                if name == "f32":
                    distinct = ego_trace(e, u1, res[0])["distinct"]
        precision._set(False, False)
        a, b = runs["tf32"], runs["f32"]
        held = [i for i in range(B_MAIN) if distinct[i] == 8
                and bool(a[3][i]) and bool(b[3][i])]
        check(held, f"C12 {mode}: no item with an 8-distinct winner")
        sel = (a[1] > 0) & (b[1] > 0)
        d = torch.cat([(a[0][i] - b[0][i]).abs()[sel[i]] for i in held])
        delta[mode] = dict(
            items_held=len(held), items_skipped_c9=B_MAIN - len(held),
            mean_px=d.mean().item(), p99_px=torch.quantile(d, 0.99).item(),
            max_px=d.max().item(), budget_px=TF32_BUDGET_PX,
            good_equal=bool(torch.equal(a[3], b[3])),
            mask_agreement=((a[1] > 0) == (b[1] > 0)).float().mean().item(),
            items_exact=sum(bool(torch.equal(a[0][i], b[0][i]))
                            for i in range(B_MAIN)))
        r = delta[mode]
        print(f"[{card}] C12 {mode} mode: x-flow TF32 vs f32 on the "
              f"{r['items_held']} items with 8-distinct winners: mean "
              f"{r['mean_px']:.3e} p99 {r['p99_px']:.3e} max "
              f"{r['max_px']:.3e} px (budget {TF32_BUDGET_PX} px); good "
              f"equal {r['good_equal']}, mask agreement "
              f"{r['mask_agreement']:.5f}, {r['items_exact']}/{B_MAIN} items "
              f"bitwise", flush=True)
    out["tf32_delta"] = delta
    # the TF32 cost on the bare trunk convolution (this run: the trunk of
    # the online program at B=128)
    with torch.no_grad():
        u1 = est._prep(t1)[0]
        tr = {}
        for name, flags in (("f32", (False, False)), ("tf32", (True, False))):
            precision._set(*flags)
            tr[name] = cuda_ms(lambda: est.trunk(u1), reps=5, warmup=2)
        precision._set(False, False)
    out["trunk_ms"] = tr
    print(f"[{card}] C12 the trunk alone, B={B_MAIN}: f32 {tr['f32']:.3f} ms, "
          f"TF32 {tr['tf32']:.3f} ms", flush=True)

    # 7. nan_debug on the card: a NaN in B1's (and B2's) input is named; a
    # clean step passes and equals the unchecked step
    bad = f1[:2].clone()
    bad[0, 5, 7, 3] = float("nan")
    named = {}
    for name, call in (
            ("match_flow_fused", lambda: matching.match_flow_fused(
                bad, f2[:2], g.maxh, g.maxw, want_conf=True)),
            ("kernel B2", lambda: matching.match_flow_fast(
                bad, f2[:2], g.maxh, g.maxw))):
        try:
            with debug.nan_debug():
                call()
            named[name] = None
        except FloatingPointError as err:
            named[name] = str(err)
    e = api_batched.BatchedDepthEstimator(geom, params, ARDRONE, device=dev,
                                          compensation="warp")
    e.reset(t1[:B_CHECK])
    plain_step = [o.cpu() for o in e.next_frames(t2[:B_CHECK])]
    e.reset(t1[:B_CHECK])
    t0 = time.perf_counter()
    with debug.nan_debug():
        checked_step = [o.cpu() for o in e.next_frames(t2[:B_CHECK])]
    out["nan_debug"] = dict(
        raised=named, clean_step_equal=all(
            torch.equal(a, b) for a, b in zip(plain_step, checked_step)),
        checked_step_s=time.perf_counter() - t0)
    print(f"nan_debug: {named}; a clean 'warp' step at B={B_CHECK} passes "
          f"in {out['nan_debug']['checked_step_s']:.2f} s, equal to the "
          f"unchecked step: {out['nan_debug']['clean_step_equal']}",
          flush=True)
    check(all(v is not None and name in v for name, v in named.items()),
          f"nan_debug: {named}")
    check(out["nan_debug"]["clean_step_equal"], "nan_debug changed a step")

    # the candidates' checks, after every reading is printed
    for key, rows in cands.items():
        check(all(r["equal_default"] for r in rows),
              f"{key}: a candidate differs from the default plan")
    out["launches"] = {"match_fused": b1}
    out["seconds"] = time.perf_counter() - t_phase
    print(f"autotune: phase took {out['seconds']:.1f} s", flush=True)
    report["autotune"] = out
    return out


# ---------------------------------------------------------------------------
# phase 18: f16 storage in B1, B2 and B3; the trained-model precision table
# ---------------------------------------------------------------------------

# The repository's precision policy: a reduced-precision option
# may move a trained model's flow by at most 0.1 px mean EPE against f32.
# Held here on car_model for B1 and B2 in bf16 and f16 storage, on the
# repo's car pair and on the warp sequence's held-out pair
# (``quality.precision_table``); the multiscale rows (the committed
# checkpoint ``examples/torch_multiscale_model``), the trunk-in-bf16 rows
# and the online program's deltas are recorded, not held (the policy calls
# the multiscale bf16 decode a straddler).
PRECISION_BUDGET_PX = 0.1
STORAGE_TYPES = (torch.bfloat16, torch.float16)


def _kernel_rows(got, ref):
    """WTA / gate mismatches and the largest float error of a matcher's
    outputs against its twin's."""
    flips = (got[0] != ref[0]).float().mean().item()
    errs = [(a - b).abs().max().item() for a, b in zip(got[1:4], ref[1:4])]
    conf = (got[4] != ref[4]).float().mean().item() if len(got) > 4 else 0.0
    return flips, errs, conf


def _held_delta(a, b, da, db, B):
    """x-flow of two (xflow, mask, depth, good) runs on the items whose
    RANSAC winner is 8 distinct points in both (C9) and good in both;
    ``finite``: the first run's x-flow and mask finite and its depth free
    of NaN (zero flow is infinite depth)."""
    held = [i for i in range(B) if da[i] == 8 and db[i] == 8
            and bool(a[3][i]) and bool(b[3][i])]
    sel = (a[1] > 0) & (b[1] > 0)
    d = (torch.cat([(a[0][i] - b[0][i]).abs()[sel[i]] for i in held])
         if held else torch.zeros(1))
    return dict(items_held=len(held), items_skipped_c9=B - len(held),
                mean_px=d.mean().item(), p99_px=torch.quantile(d, 0.99).item(),
                max_px=d.max().item(),
                good_equal=bool(torch.equal(a[3], b[3])),
                mask_agreement=((a[1] > 0) == (b[1] > 0)).float().mean().item(),
                finite=bool(torch.isfinite(a[0]).all()
                            and torch.isfinite(a[1]).all()
                            and not torch.isnan(a[2]).any()))


def _rotation_angle(R):
    """(B, 3, 3) rotations -> (B,) angles in radians."""
    tr = R.diagonal(dim1=-2, dim2=-1).sum(-1)
    return torch.arccos(((tr - 1) / 2).clamp(-1.0, 1.0))


@torch.no_grad()
def phase_precision(dev, card, geom, params, report):
    """B1, B2 and B3 on f16 storage at the main shapes against their twins
    (bf16 beside them, timed); the precision table on car_model and the
    committed multiscale checkpoint; config3's staged decode at B=64 in
    f32, bf16 and f16; the online program at B=128 with every storage knob
    in bf16, and in f16, against f32. Returns the kernels' f16 rows and
    their launches on this phase's program runs."""
    from depth_estimation_tpu_torch import api_batched, codecs, quality
    from depth_estimation_tpu_torch.geometry import Geometry
    from depth_estimation_tpu_torch.geometry3d import egomotion
    from depth_estimation_tpu_torch.geometry3d import undistort as undist
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.models import multiscale as ms
    from depth_estimation_tpu_torch.ops import matching, warp
    t_phase = time.perf_counter()
    out = dict(card=card)
    wrappers = {"match_fused": matching.match_flow_fused,
                "match_fast": matching.match_flow_fast,
                "warp_banded": warp.banded_bilinear_warp}

    # 1. the kernels at the main shapes, bf16 and f16, against the twins
    gen = torch.Generator(device=dev).manual_seed(18)
    f1 = 0.5 * torch.randn(B_MAIN, 150, 290, 10, generator=gen, device=dev)
    f2 = 0.5 * torch.randn(B_MAIN, 165, 305, 10, generator=gen, device=dev)
    Ks = ARDRONE.K.copy()
    Ks[0] *= 320 / ARDRONE.wImg
    Ks[1] *= 180 / ARDRONE.hImg
    yaws = torch.linspace(-0.06, 0.06, B_MAIN)
    c, s = torch.cos(yaws), torch.sin(yaws)
    R = torch.zeros(B_MAIN, 3, 3)
    R[:, 0, 0], R[:, 0, 2], R[:, 1, 1], R[:, 2, 0], R[:, 2, 2] = c, s, 1, -s, c
    xs, ys = undist.homography_grid(Ks, R.to(dev), 165, 305)
    imgs = torch.randn(B_MAIN, 165, 305, 10, generator=gen, device=dev)
    calls = {
        "match_fused": (
            lambda dt: matching.match_flow_fused(f1, f2, 16, 16, 8, False, dt,
                                                 True),
            lambda dt: matching.match_flow_fused_plain(f1, f2, 16, 16, False,
                                                       dt, True)),
        "match_fast": (
            lambda dt: matching.match_flow_fast(f1, f2, 16, 16, 32, dt),
            lambda dt: matching.match_flow_fast_plain(f1, f2, 16, 16, dt)),
    }
    kern = {}
    for dt in STORAGE_TYPES:
        im = imgs.to(dt)
        calls["warp_banded"] = (
            lambda dt, im=im: warp.banded_bilinear_warp(im, xs, ys, 8),
            lambda dt, im=im: warp.banded_bilinear_warp_plain(im, xs, ys, 8))
        for name, (kernel, plain) in calls.items():
            n0 = wrappers[name].launches
            got = kernel(dt)
            launched = wrappers[name].launches - n0
            ref = plain(dt)
            torch.cuda.synchronize()
            if name == "warp_banded":
                flips, errs, conf = 0.0, [(got - ref).abs().max().item()], 0.0
                finite = bool(torch.isfinite(got).all())
            else:
                flips, errs, conf = _kernel_rows(got, ref)
                finite = all(bool(torch.isfinite(o).all()) for o in got[1:])
            ms_k = cuda_ms(lambda: kernel(dt))
            ms_p = cuda_ms(lambda: plain(dt), reps=3)
            kern[f"{name}_{str(dt)[6:]}"] = dict(
                launched=launched, idx_mismatch=flips, conf_mismatch=conf,
                max_abs_err=max(errs), finite=finite, ms=ms_k, plain_ms=ms_p)
            print(f"[{card}] phase 18 {name} {str(dt)[6:]}, B={B_MAIN}: "
                  f"launched {launched}, idx mismatch {flips:.2e}, conf "
                  f"mismatch {conf:.2e}, max err {max(errs):.2e}; kernel "
                  f"{ms_k:.3f} ms, plain {ms_p:.1f} ms", flush=True)
    f16 = torch.float16
    out["bounds_f16"] = {
        "match_fused": matcher_bound(f1.to(f16), f2.to(f16), 16, 16, 5,
                                     3 * 10 + 5),
        "match_fast": matcher_bound(f1.to(f16), f2.to(f16), 16, 16, 4,
                                    2 * 10 + 3 + 7),
        "warp_banded": bound_ms(*warp_work(imgs.to(f16), xs, ys))}
    out["kernels"] = kern

    # 2. the precision table: car_model and the committed multiscale
    # checkpoint, on the car pair and the warp sequence's held-out pair
    for fn in wrappers.values():
        fn.launches = 0
    with tempfile.TemporaryDirectory() as work:
        t0 = time.perf_counter()
        table = quality.precision_table(work, device=dev)
        table_s = time.perf_counter() - t0
    table_launches = {k: fn.launches for k, fn in wrappers.items()}
    table["seconds"] = table_s
    out["precision_table"] = table
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(os.path.join(os.path.dirname(REPORT),
                           "precision_table.json"), "w") as f:
        json.dump(table, f, indent=1)
    for key in ("bf16_deltas_car_pair", "bf16_deltas_seq_pair"):
        for row, r in table[key].items():
            extra = (f", WTA agreement {r['wta_agreement']:.4f}"
                     if "wta_agreement" in r else "")
            print(f"[{card}] precision {key[12:]} {row}: mean EPE delta "
                  f"{r['mean_epe_delta_px']:.4f} p99 "
                  f"{r['p99_epe_delta_px']:.4f} max "
                  f"{r['max_epe_delta_px']:.4f} px{extra}", flush=True)
    sc = table["multiscale_scores"]
    print(f"precision table: {table_s:.1f} s, launches {table_launches}; "
          f"the multiscale checkpoint on the held-out pair: full acc "
          f"{sc['full_acc_analytic']:.4f}, meanDst "
          f"{sc['meanDst_analytic']:.4f}", flush=True)

    # 3. config3's staged decode at B=64 in f32, bf16 and f16: its BASELINE
    # geometry on seeded weights (the time A.9 needs), and the committed
    # trained checkpoint (the EPE on trained weights)
    ms_geom, _, ms_params, _ = mio.load_model(str(quality.MS_MODEL))
    models = {"config3": (Geometry(**C3_GEOMETRY), None),
              "trained_multiscale": (ms_geom, ms_params)}
    decode = {}
    for key, (g, tree) in models.items():
        s1, s2 = working_frames(6, C3_B, g.hImg, g.wImg, dev)
        base = ms.MultiscaleFlowModel(g, device=dev)
        if tree is None:
            base.init(torch.Generator().manual_seed(30))
        else:
            mio.load_tree_into(base, tree)
        runs, rows = {}, {}
        for dt in (torch.float32,) + STORAGE_TYPES:
            m = ms.MultiscaleFlowModel(
                g, decode_dtype=None if dt == torch.float32 else dt,
                device=dev)
            m.load_state_dict(base.state_dict())
            idx, pmax = m.decode_full_staged(s1, s2)
            wy, wx = codecs.decode(g, idx)
            runs[dt] = (idx, torch.stack([wy.float(), wx.float()]))
            check(bool(torch.isfinite(pmax).all()),
                  f"{key} {dt} staged decode: non-finite pmax")
            rows[str(dt)[6:]] = dict(
                ms=cuda_ms(lambda m=m: m.decode_full_staged(s1, s2)))
        for dt in STORAGE_TYPES:
            d = torch.sqrt(((runs[dt][1] - runs[torch.float32][1]) ** 2)
                           .sum(0))
            rows[str(dt)[6:]].update(
                mean_epe_delta_px=d.mean().item(),
                wta_agreement=(runs[dt][0] == runs[torch.float32][0])
                .float().mean().item())
        decode[key] = rows
        print(f"[{card}] {key} staged decode B={C3_B} {g.hImg}x{g.wImg}: "
              + "; ".join(f"{k} {v['ms']:.2f} ms" + (
                  f", EPE delta {v['mean_epe_delta_px']:.4f} px, WTA "
                  f"agreement {v['wta_agreement']:.4f}"
                  if "wta_agreement" in v else "")
                          for k, v in rows.items()), flush=True)
    out["staged_decode"] = decode

    # 4. the online program on car_model, B=128, every storage knob in bf16
    # and in f16 against the same knobs in f32, fast and 'warp' mode; then
    # each knob alone, to tell the matcher's share from ego-motion's
    t1, t2 = forward_frames(torch.Generator(device=dev).manual_seed(19),
                            B_MAIN, dev)
    online = {}
    prog_launches = {k: 0 for k in wrappers}
    knob_names = ("match_dtype", "warp_dtype", "state_dtype")
    for mode, knobs in (("fast", {k: v for k, v in FAST.items()
                                  if not k.endswith("_dtype")}),
                        ("warp", dict(compensation="warp"))):
        variants = [("f32", {})]
        for dt in STORAGE_TYPES:
            variants.append((f"all_{str(dt)[6:]}",
                             {k: dt for k in knob_names}))
            for k in knob_names:
                if not (mode == "fast" and k == "warp_dtype"):  # no warp
                    variants.append((f"{k[:-6]}_{str(dt)[6:]}", {k: dt}))
        res = {}
        for name, dts in variants:
            e = api_batched.BatchedDepthEstimator(
                geom, params, ARDRONE, device=dev,
                ransac_noise=egomotion.gumbel_noise(
                    knobs.get("ransac_samples", 64), ARDRONE.sfm.max_points,
                    dev), **knobs, **dts)
            for fn in wrappers.values():
                fn.launches = 0
            e.reset(t1)
            u1 = e.last_u
            o = [x.cpu() for x in e.next_frames(t2)]
            for k, fn in wrappers.items():
                prog_launches[k] += fn.launches
            trace = ego_trace(e, u1, e.last_u)
            res[name] = (o, trace["distinct"], trace["R"])
        (b, db, Rb) = res["f32"]
        for name, _ in variants[1:]:
            a, da, Ra = res[name]
            r = _held_delta(a, b, da, db, B_MAIN)
            r["R_max_diff"] = (Ra - Rb).abs().amax(dim=(1, 2)).max().item()
            r["R_median_diff"] = (Ra - Rb).abs().amax(dim=(1, 2)) \
                .median().item()
            # the frames' true rotation is none (a forward step): each
            # run's median rotation angle is its error
            r["R_angle_median"] = _rotation_angle(Ra).median().item()
            r["R_angle_median_f32"] = _rotation_angle(Rb).median().item()
            online[f"{mode}_{name}"] = r
            print(f"[{card}] online {mode} mode, {name} vs f32, B={B_MAIN}, "
                  f"on the {r['items_held']} items with 8-distinct winners "
                  f"in both: x-flow mean {r['mean_px']:.4e} p99 "
                  f"{r['p99_px']:.4e} max {r['max_px']:.4e} px; R max diff "
                  f"{r['R_max_diff']:.2e} (median {r['R_median_diff']:.2e}), "
                  f"median rotation angle (truth 0) {r['R_angle_median']:.2e}"
                  f" rad, f32 {r['R_angle_median_f32']:.2e}; "
                  f"good equal {r['good_equal']}, mask agreement "
                  f"{r['mask_agreement']:.5f}, finite {r['finite']}",
                  flush=True)
    out["online"] = online
    launches = {k: table_launches[k] + prog_launches[k] for k in wrappers}
    out["launches"] = dict(table=table_launches, program=prog_launches,
                           total=launches)
    out["seconds"] = time.perf_counter() - t_phase
    print(f"precision: launches on this phase's runs {launches}; phase took "
          f"{out['seconds']:.1f} s", flush=True)
    report["precision"] = out

    # the checks, after every reading is printed
    for key, r in kern.items():
        check(r["launched"] == 1, f"{key}: the wrapper did not launch once")
        check(r["finite"], f"{key}: non-finite output")
        if key.startswith("warp_banded"):
            check(r["max_abs_err"] <= TOL_WARP, f"{key}: {r['max_abs_err']}")
        else:
            check(r["idx_mismatch"] == 0 and r["conf_mismatch"] <= TOL_FLIP
                  and r["max_abs_err"] <= TOL_FLOW_PX,
                  f"{key} against its twin: {r}")
    for key in ("bf16_deltas_car_pair", "bf16_deltas_seq_pair"):
        rows = table[key]
        check(all(r["finite"] for r in rows.values()), f"{key}: NaN")
        for row in ("fused_bf16", "fused_f16", "fast_bf16", "fast_f16"):
            check(rows[row]["mean_epe_delta_px"] <= PRECISION_BUDGET_PX,
                  f"{key} {row} above the budget: {rows[row]}")
    check(all(table_launches[k] > 0 for k in ("match_fused", "match_fast")),
          f"precision table launches {table_launches}")
    check(all(r["finite"] for r in online.values()), "online: NaN")
    check(prog_launches["match_fused"] > 0,
          f"online program launches {prog_launches}")
    return out


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false; this check "
              "needs an NVIDIA card", file=sys.stderr)
        return 2
    from depth_estimation_tpu_torch.models import io as mio
    from depth_estimation_tpu_torch.ops import _kernels

    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card} ({torch.cuda.get_device_name(0)}, torch "
          f"{torch.__version__}, CUDA {torch.version.cuda})", flush=True)
    report = {"card": card}

    t0 = time.perf_counter()
    lib = _kernels.library()
    report["build_seconds"] = lib.build_seconds
    print(f"build: {len(lib.paths)} libraries, nvcc in parallel "
          f"{lib.build_seconds:.1f} s ({time.perf_counter() - t0:.1f} s with "
          f"loading)", flush=True)
    report["ptxas"] = ptxas_table(lib.log)
    for row in report["ptxas"]:
        print(f"  ptxas {row['source']}: {row['kernel']}: {row['registers']} "
              f"registers, spill stores {row['spill_stores']} B, loads "
              f"{row['spill_loads']} B", flush=True)

    errs = phase_kernels(dev, report)
    general = phase_general_shapes(dev, report)

    geom, _, params, _ = mio.load_model(CAR_MODEL)
    counts, ests, frames = phase_slice(dev, geom, params, report)
    phase_card_vs_cpu(dev, geom, params, report)
    (counts["sor_redblack"], counts["liu_warp"], counts["liu_irls"],
     gt_frames) = phase_gt(dev, geom, report)
    counts["match_fast"] = phase_matching_core(dev, card, report)
    counts["match_throughput"] = phase_throughput_core(dev, card, report)
    phase_multiscale(dev, card, report)
    phase_radial(dev, card, report)
    v2_launches, v2_err, v2_ms, n1 = phase_version2(dev, card, report)
    rows, bounds, b4_solve, floors = phase_timing(dev, card, ests, frames,
                                                  gt_frames, report)
    training = phase_training(dev, card, report)
    fam_root = tempfile.TemporaryDirectory()
    family_counts = phase_families(dev, card, fam_root.name, report)
    serving_counts = phase_serving(dev, card, geom, params, ests, frames,
                                   fam_root.name, report)
    cli_counts = phase_training_clis(dev, card, fam_root.name, report)
    fam_root.cleanup()
    robot_counts = phase_robotics(dev, card, geom, params, report)
    p1, p2 = phase_peaks(dev, card, report)
    par_counts, par_by_device = phase_parallel(dev, card, geom, params,
                                               report)
    tuned = phase_autotune(dev, card, geom, params, report)
    prec = phase_precision(dev, card, geom, params, report)

    def entry(name, fn, src, replaces, row):
        return {"name": fn, "route": "cuda",
                "source": f"depth_estimation_tpu_torch/csrc/{src}",
                "replaces": replaces, "launches": counts[name],
                "max_abs_err": errs[name], "ms": rows[row][0],
                "plain_ms": rows[row][1], "bound_ms": bounds[name][0],
                "bound_by": bounds[name][1], "library_ms": None}

    kernels = [
        entry("match_fused", "match_flow_fused", "match_fused.cu",
              "depth_estimation_tpu/ops/matching.py:116", "match_fused_bfloat16"),
        entry("warp_banded", "banded_bilinear_warp", "warp_banded.cu",
              "depth_estimation_tpu/ops/warp.py:38", "warp_banded_float32"),
        entry("match_fast", "match_flow_fast", "match_fast.cu",
              "depth_estimation_tpu/ops/matching.py:366", "match_fast_bfloat16"),
        entry("sor_redblack", "sor_redblack", "sor_redblack.cu",
              "depth_estimation_tpu/flow/sor_kernel.py:50", "sor_redblack"),
        entry("match_throughput", "match_flow_throughput",
              "match_throughput.cu",
              "depth_estimation_tpu/ops/matching_experimental.py:35",
              "match_throughput"),
    ]
    # B4 beside its bound: the floor of its dependent half-sweeps (one call
    # at the finest level, 40 iterations), and its device time over a solve
    finest = b4_solve["levels"][-1]
    next(k for k in kernels if k["name"] == "sor_redblack").update(
        ms_back_to_back=b4_solve["back_to_back_ms"],
        dependency_floor_ms=2 * 40 * finest["half_sweep_floor_us"] / 1e3,
        solve_launches=b4_solve["launches"],
        solve_device_ms=b4_solve["device_ms"],
        solve_dependency_floor_ms=b4_solve["floor_ms"])
    # B2 (bf16) and B5 beside their issue floor
    for name, key in (("match_flow_fast", "match_fast"),
                      ("match_flow_throughput", "match_throughput")):
        if key in floors:
            next(k for k in kernels if k["name"] == name).update(
                issue_floor_ms=floors[key]["ms"],
                sass_per_cell=floors[key]["per_cell"])
    # B2 inside the version2 net's flow_batch at its cell's shape (B=64,
    # 148x288, K=32, 17x17 window, f32)
    next(k for k in kernels if k["name"] == "match_flow_fast").update(
        launches_version2_phase=v2_launches, max_abs_err_version2=v2_err,
        ms_version2=v2_ms)
    # the C24 shapes' largest errors beside the main path's
    for name, key in (("match_flow_fused", "match_fused"),
                      ("match_flow_fast", "match_fast"),
                      ("match_flow_throughput", "match_throughput")):
        next(k for k in kernels if k["name"] == name).update(
            max_abs_err_general_shapes=general[key])
    # B3 in bf16 beside the f32 row, and grid_sample's time in each type
    next(k for k in kernels if k["name"] == "banded_bilinear_warp").update(
        library_ms=rows["warp_banded_float32_library"],
        ms_back_to_back=rows["warp_banded_float32_back_to_back"][0],
        library_ms_back_to_back=rows["warp_banded_float32_back_to_back"][1],
        ms_bf16=rows["warp_banded_bfloat16"][0],
        plain_ms_bf16=rows["warp_banded_bfloat16"][1],
        bound_ms_bf16=bounds["warp_banded_bfloat16"][0],
        library_ms_bf16=rows["warp_banded_bfloat16_library"],
        ms_back_to_back_bf16=rows["warp_banded_bfloat16_back_to_back"][0],
        library_ms_back_to_back_bf16=rows[
            "warp_banded_bfloat16_back_to_back"][1])
    # the training phase's own run of its path (B4 through the liu GT, B1
    # through the estimator on the saved checkpoint)
    for name, key in (("sor_redblack", "sor_redblack"),
                      ("match_flow_fused", "match_fused")):
        next(k for k in kernels if k["name"] == name).update(
            launches_training_phase=training[key])
    # the families' trainers reach none of the kernels
    for k, key in zip(kernels, ("match_fused", "warp_banded", "match_fast",
                                "sor_redblack", "match_throughput")):
        k["launches_families_phase"] = family_counts[key]
    # B1 and B3 from inside the loaded artifacts (and B1 under the CLIs)
    for k, key in zip(kernels[:2], ("match_fused", "warp_banded")):
        k["launches_serving_phase"] = serving_counts[key]
    # phase 14: the training CLIs (B4 through '-gt liu') and the drone loop
    for name, key in (("match_flow_fused", "match_fused"),
                      ("sor_redblack", "sor_redblack")):
        next(k for k in kernels if k["name"] == name).update(
            launches_cli_phase=cli_counts[key],
            launches_robotics_phase=robot_counts[key])
    # phase 16: the mesh layer, B1, B3 and B4 on every shard's card
    for k, key in zip(kernels, ("match_fused", "warp_banded", "match_fast",
                                "sor_redblack", "match_throughput")):
        k["launches_parallel_phase"] = par_counts.get(key, 0)
        k["launches_parallel_phase_by_device"] = par_by_device.get(
            k["name"], {})
    # phase 17: B1 through the "auto" estimators; B1's and B2's default
    # plan against the autotuner's winner at the main shape (bf16)
    for name, key in (("match_flow_fused", "fused"),
                      ("match_flow_fast", "fast")):
        w = tuned["best_plan"][f"{key}_bfloat16"]
        next(k for k in kernels if k["name"] == name).update(
            autotune_default_ms=w["default_ms"],
            autotune_winner_ms=w["winner_ms"],
            autotune_winner_is_default=w["winner_is_default"])
    next(k for k in kernels if k["name"] == "match_flow_fused").update(
        launches_autotune_phase=tuned["launches"]["match_fused"])
    # phase 18: B1, B2 and B3 on f16 storage at the main shapes (bf16 timed
    # beside them in the same phase), and their launches on the precision
    # table and the online program in reduced precision
    for name, key in (("match_flow_fused", "match_fused"),
                      ("match_flow_fast", "match_fast"),
                      ("banded_bilinear_warp", "warp_banded")):
        r16 = prec["kernels"][f"{key}_float16"]
        rb = prec["kernels"][f"{key}_bfloat16"]
        next(k for k in kernels if k["name"] == name).update(
            ms_f16=r16["ms"], plain_ms_f16=r16["plain_ms"],
            bound_ms_f16=prec["bounds_f16"][key][0],
            max_abs_err_f16=r16["max_abs_err"],
            idx_mismatch_f16=r16["idx_mismatch"],
            ms_bf16_precision_phase=rb["ms"],
            max_abs_err_bf16_precision_phase=rb["max_abs_err"],
            launches_precision_phase=prec["launches"]["total"][key])
    # the liu warp kernel (no TPU kernel: jnp code that XLA fuses) and its
    # resize, beside their bytes bound
    liu = entry("liu_warp", "warp_update_noise", "liu_warp.cu",
                "none (depth_estimation_tpu/flow/celiu.py warp_image, imresize:"
                " jnp)", "liu_warp")
    liu.update(ms_back_to_back=rows["liu_warp_back_to_back"][0],
               plain_ms_back_to_back=rows["liu_warp_back_to_back"][1],
               resize_ms=rows["liu_resize"][0],
               resize_plain_ms=rows["liu_resize"][1],
               resize_ms_back_to_back=rows["liu_resize_back_to_back"][0],
               resize_bound_ms=bounds["liu_resize"][0])
    # the liu IRLS kernel (no TPU kernel: jnp code that XLA fuses), a cold
    # step at the cell's finest level
    irls = entry("liu_irls", "irls_planes", "liu_irls.cu",
                 "none (depth_estimation_tpu/flow/celiu.py IRLS step: jnp)",
                 "liu_irls")
    irls.update(ms_back_to_back=rows["liu_irls_back_to_back"][0],
                plain_ms_back_to_back=rows["liu_irls_back_to_back"][1])
    kernels += [liu, irls, n1, p1, p2]
    for k in kernels:
        check(k["launches"] > 0, f"{k['name']} not launched on its path")
    report["kernels"] = kernels
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1)
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
