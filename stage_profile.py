#!/usr/bin/env python3
"""Where the PyTorch port's main paths spend their time, on one NVIDIA card.

Run from the repository root, on a machine with a CUDA card and nvcc:

    python3 stage_profile.py

It runs ``BatchedDepthEstimator`` at the car_model's full width, B=128, on
``chip_smoke.forward_frames`` pairs, in fast mode and in 'warp' mode; the
'liu' ground-truth solve at BASELINE config2 (B=8, 192x256x3, 5/1/40 on
``chip_smoke.shifted_textures``); the matching core (B=128) through B2 and
through B5; BASELINE config3's multiscale staged decode (B=64, f32); and
config4's radial ``flow_batch`` (B=64, 200x200 polar). For each it
reports:
  * the step time without instrumentation (CUDA events, median of 5);
  * per-stage times: each stage's function is wrapped so that it waits for
    the card before and after it runs (``torch.cuda.synchronize``), and the
    host clock is read around it; 3 instrumented steps, mean per step.
    Stages nest (ego-motion holds corners, LK and RANSAC);
  * a ``torch.profiler`` trace of one step: the 12 entries with the most
    device time, with their call counts, and the sum of the device-side
    events' time (the card's busy time in that step).
TF32 is off, as in chip_smoke.py. The report goes to
chiprun_out/stage_profile.json.
"""

import functools
import json
import os
import sys
import time
from collections import defaultdict

import torch

from chip_smoke import (B_MAIN, C3_B, C3_GEOMETRY, C4_B, C4_CART, C4_H,
                        C4_HWIN, C4_LAYERS, C4_W, CAR_MODEL, FAST, GT_B, GT_H,
                        GT_SCHEDULE, GT_SHIFT, GT_W, card_line, cuda_ms,
                        forward_frames, matching_core, shifted_textures,
                        working_frames)

ROOT = os.path.dirname(os.path.abspath(__file__))
REPORT = os.path.join(ROOT, "chiprun_out", "stage_profile.json")
REPS = 3


def timed(totals, name, fn):
    """fn wrapped so that it waits for the card before and after it runs,
    with its host time added to totals[name] (ms)."""
    @functools.wraps(fn)
    def run(*args, **kwargs):
        torch.cuda.synchronize()
        t = time.perf_counter()
        out = fn(*args, **kwargs)
        torch.cuda.synchronize()
        totals[name] += (time.perf_counter() - t) * 1e3
        return out
    return run


def wrap(targets, totals):
    """Wrap each (object, attribute, stage name) in a synchronising timer.
    Returns a function that undoes the wrapping."""
    saved = []
    for obj, attr, name in targets:
        fn = getattr(obj, attr)
        saved.append((obj, attr, obj.__dict__.get(attr)))
        setattr(obj, attr, timed(totals, name, fn))

    def undo():
        for obj, attr, old in reversed(saved):
            if old is None:
                delattr(obj, attr)
            else:
                setattr(obj, attr, old)
    return undo


def instrument(est, totals):
    """Wrap the stages of ``est``'s step in synchronising timers. Returns a
    function that undoes the wrapping."""
    from depth_estimation_tpu_torch import api_batched
    from depth_estimation_tpu_torch.data import images
    from depth_estimation_tpu_torch.geometry3d import egomotion as ego
    from depth_estimation_tpu_torch.geometry3d import undistort as undist
    from depth_estimation_tpu_torch.ops import extract, matching

    targets = [
        (api_batched.BatchedDepthEstimator, "_step", "step"),
        (api_batched.BatchedDepthEstimator, "_prep", "prep"),
        (images, "scale_batched_device", "prep.resize"),
        (undist, "undistort_image", "prep.undistort"),
        (est.trunk, "forward", "prep.trunk"),
        (api_batched, "avg_downsample", "ego.downsample"),
        (ego, "get_ego_motion_batched", "ego"),
        (ego, "good_features_to_track_batched", "ego.corners"),
        (ego, "track_lk_windowed_batched", "ego.lk"),
        (ego, "get_ego_motion_from_matches_batched", "ego.ransac"),
        (ego, "_eight_point", "ego.ransac.eight_point_qr"),
        (ego, "_sampson", "ego.ransac.sampson"),
        (ego, "_decompose_E", "ego.ransac.decompose_svd"),
        (undist, "remove_ego_motion_exact", "compensation.warp"),
        (undist, "homography_grid", "compensation.homography_grid"),
        (matching, "match_flow_fused", "match"),
        (extract, "enlarge_mask_batched", "masks.enlarge"),
    ]
    return wrap(targets, totals)


def instrument_gt(totals):
    """Stages of the liu solve (flow/celiu.py): the pyramids, each IRLS
    level, and inside it the derivatives and B4; the liu warp kernel's
    calls (each outer step's update, warp and noise estimate, the warps
    between levels and the final one) and its resizes (flow/liu_warp.py)."""
    from depth_estimation_tpu_torch.flow import celiu, liu_warp
    return wrap([(celiu, "build_pyramid", "pyramids"),
                 (celiu, "smooth_flow_sor", "level"),
                 (celiu, "get_dxs", "level.get_dxs"),
                 (celiu, "sor_redblack", "level.sor_B4"),
                 (liu_warp, "warp_update_noise", "warps"),
                 (liu_warp, "resize", "resizes")], totals)


def instrument_core(totals):
    """Stages of the matching core (chip_smoke.matching_core)."""
    from depth_estimation_tpu_torch.data import images
    from depth_estimation_tpu_torch.models import flow as flow_model
    from depth_estimation_tpu_torch.ops import matching
    return wrap([(images, "scale_batched_device", "resize"),
                 (flow_model.FlowModel, "features", "trunk"),
                 (matching, "match_flow_fast", "match_B2")], totals)


def instrument_throughput_core(totals):
    """Stages of the matching core with B5 as the matcher."""
    from depth_estimation_tpu_torch.data import images
    from depth_estimation_tpu_torch.models import flow as flow_model
    from depth_estimation_tpu_torch.ops import matching_experimental as mexp
    return wrap([(images, "scale_batched_device", "resize"),
                 (flow_model.FlowModel, "features", "trunk"),
                 (mexp, "match_flow_throughput", "match_B5"),
                 (mexp, "_match_flow_throughput_cuda", "match_B5.kernel")],
                totals)


def instrument_multiscale(totals):
    """Stages of the staged multiscale decode."""
    from depth_estimation_tpu_torch.models import multiscale as ms
    from depth_estimation_tpu_torch.ops import matching
    return wrap([(ms.MultiscaleFlowModel, "features_pyramid", "trunk_pyramid"),
                 (ms.MultiscaleFlowModel, "decode_from_features", "decode"),
                 (matching, "match_ssd", "decode.match_ssd"),
                 (ms, "_coarse_to_fine", "decode.cascade_gathers")], totals)


def instrument_radial(totals):
    """Stages of the radial net's flow_batch."""
    from depth_estimation_tpu_torch.models import radial
    from depth_estimation_tpu_torch.ops import matching
    return wrap([(radial.RadialFilter, "forward", "trunk"),
                 (matching, "match_ssd", "match_ssd_radial")], totals)


def other_families(dev):
    """(title, report key, run) of the config3 and config4 profiles."""
    from depth_estimation_tpu_torch.geometry import Geometry
    from depth_estimation_tpu_torch.geometry3d import polar
    from depth_estimation_tpu_torch.models import multiscale as ms
    from depth_estimation_tpu_torch.models.radial import RadialFlowNetwork
    g = Geometry(**C3_GEOMETRY)
    m3 = ms.MultiscaleFlowModel(g, device=dev).init(
        torch.Generator().manual_seed(30))
    c1, c2 = working_frames(6, C3_B, g.hImg, g.wImg, dev)
    net = RadialFlowNetwork(C4_LAYERS, C4_HWIN, device=dev).init(
        torch.Generator().manual_seed(40))
    h, w = C4_CART
    s1, s2 = working_frames(7, C4_B, h, w, dev)
    grid = polar.get_c2p_grid(w, h, C4_W, C4_H, device=dev)
    with torch.no_grad():
        p1 = torch.stack([polar.cartesian2polar(f, grid) for f in s1])
        p2 = torch.stack([polar.cartesian2polar(f, grid) for f in s2])
    return [
        (f"config3 staged decode f32, B={C3_B}", "config3",
         lambda: profile_fn(lambda: m3.decode_full_staged(c1, c2),
                            instrument_multiscale)),
        (f"config4 radial flow_batch, B={C4_B}", "config4",
         lambda: profile_fn(lambda: net.flow_batch(p1, p2), instrument_radial)),
    ]


def profile_fn(fn, instrument_fn):
    """Uninstrumented time (CUDA events, median of 5), per-stage times
    (REPS instrumented runs, mean), and a torch.profiler top list of one
    run."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    step_ms = cuda_ms(fn)
    totals = defaultdict(float)
    undo = instrument_fn(totals)
    for _ in range(REPS):
        fn()
    undo()
    stages = {k: v / REPS for k, v in sorted(totals.items())}

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        fn()
        torch.cuda.synchronize()
    # the profiler's own buffer events carry device time too; leave them out
    events = [e for e in prof.key_averages()
              if e.key not in ("Buffer Flush", "Activity Buffer Request")]
    dev_ms = lambda e: getattr(e, "self_device_time_total",
                               getattr(e, "self_cuda_time_total", 0)) / 1e3
    top = sorted(events, key=dev_ms, reverse=True)[:12]
    top = [dict(name=e.key[:120], self_device_ms=dev_ms(e), calls=e.count)
           for e in top]
    # device busy time: the device-side events (kernels, copies) only, so
    # that an op and the kernels it launched are not counted twice
    busy = sum(dev_ms(e) for e in events
               if getattr(e, "device_type", None) == DeviceType.CUDA)
    return dict(step_ms=step_ms, stages_ms=stages, profiler_top=top,
                profiler_device_ms_sum=busy)


def profile_mode(name, knobs, geom, params, frames, dev):
    from depth_estimation_tpu_torch import api_batched
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    t1, t2 = frames
    est = api_batched.BatchedDepthEstimator(geom, params, ARDRONE, head="mean",
                                            device=dev, **knobs)
    u1, feats1 = est._prep(t1)
    return profile_fn(lambda: est._step(u1, feats1, t2),
                      lambda totals: instrument(est, totals))


def main() -> int:
    if not torch.cuda.is_available():
        print("stage_profile: torch.cuda.is_available() is false; this "
              "profile needs an NVIDIA card", file=sys.stderr)
        return 2
    from depth_estimation_tpu_torch.models import io as mio
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    dev = torch.device("cuda:0")
    card = card_line()
    print(f"card: {card}", flush=True)
    geom, _, params, _ = mio.load_model(CAR_MODEL)
    frames = forward_frames(torch.Generator(device=dev).manual_seed(1),
                            B_MAIN, dev)
    report = {"card": card, "B": B_MAIN}
    from depth_estimation_tpu_torch.flow import celiu
    from depth_estimation_tpu_torch.models import flow as flow_model
    gt1, gt2 = shifted_textures(torch.Generator(device=dev).manual_seed(3),
                                GT_B, GT_H, GT_W, GT_SHIFT, dev)
    geom_c, trunk = mio.load_filter(CAR_MODEL, device=dev)
    model = flow_model.FlowModel(geom_c, trunk)
    runs = [(f"{name} mode, B={B_MAIN}", name, functools.partial(
        profile_mode, name, knobs, geom, params, frames, dev))
        for name, knobs in (("fast", FAST), ("warp", dict(compensation="warp")))]
    runs += [
        (f"liu GT config2, B={GT_B} {GT_H}x{GT_W}x3", "gt_liu_config2",
         lambda: profile_fn(lambda: celiu.coarse2fine_flow_batched(
             gt1, gt2, **GT_SCHEDULE), instrument_gt)),
        (f"matching core, B={B_MAIN}", "matching_core",
         lambda: profile_fn(lambda: matching_core(model, *frames),
                            instrument_core)),
        (f"throughput core (B5), B={B_MAIN}", "throughput_core",
         lambda: profile_fn(lambda: matching_core(model, *frames, "throughput"),
                            instrument_throughput_core)),
    ] + other_families(dev)
    for title, name, run in runs:
        r = run()
        report[name] = r
        print(f"[{card}] {title}: {r['step_ms']:.1f} ms (CUDA events, median "
              f"of 5); profiler device time {r['profiler_device_ms_sum']:.1f} "
              f"ms", flush=True)
        for k, v in r["stages_ms"].items():
            print(f"  {k:32s} {v:9.2f} ms", flush=True)
        print("  profiler, most device time (ms, calls):", flush=True)
        for e in r["profiler_top"]:
            print(f"    {e['self_device_ms']:9.2f} {e['calls']:6d}  {e['name']}",
                  flush=True)
    os.makedirs(os.path.dirname(REPORT), exist_ok=True)
    with open(REPORT, "w") as f:
        json.dump(report, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
