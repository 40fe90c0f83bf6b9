"""Small tools (port of ``depth_estimation_tpu.cli.tools``): rectification
batch, model download, streaming loop, offline video pipeline,
microbenchmark, serving export.

  * rectify: undistorted + ego-motion-rectified frames for a dataset;
  * download: list / fetch models from a remote host over ssh/scp;
  * stream: the per-frame streaming loop with running per-stage timing,
    synchronous or with K frames in flight;
  * video: the offline pipeline frames -> flow -> depth -> panels -> video;
  * time-matching: the filter / matcher / decode microbenchmark;
  * export: a serving artifact of a trained model dir (``serving.py``).

Every subcommand that computes takes ``--device`` (default ``cuda``; it
raises where there is no card unless given ``--device cpu``). ``rectify
--dp auto|off|N`` (default auto) splits the rectification batch across the
cards (``parallel/mesh.py``; with ``--device cpu``, N CPU shards). Run as
``python -m depth_estimation_tpu_torch.cli.tools``.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np
import torch

from ..utils.precision import full_f32


def cmd_rectify(args) -> int:
    from ..data import images as img_mod
    from ..data.datasets import load_rectified_pair
    from ..geometry import Geometry
    from ..geometry3d import calibration as calmod
    from ..parallel import mesh as pm
    from ..utils.viz import save_image

    cal = calmod.PRESETS[args.calibration]
    g = Geometry(hImg=cal.hImg, wImg=cal.wImg)
    loader = img_mod.ImageLoader(args.directory, cal.hImg, cal.wImg,
                                 args.first)
    und_dir = os.path.join(args.directory, "undistorted_images")
    rect_dir = os.path.join(args.directory, "rectified_images")
    os.makedirs(und_dir, exist_ok=True)
    os.makedirs(rect_dir, exist_ok=True)
    mesh = pm.auto_mesh(args.dp, args.device)
    if mesh is not None:
        # the sharded batch path: consecutive frames in chunks of 16 pairs
        # a device, each chunk one sharded rectification program
        nd = mesh.size
        print(f"dp mesh: {nd} devices ({mesh.platform})")
        rect_fn = pm.sharded_rectify_fn(mesh, cal, cal.hImg, cal.wImg)
        chunk = 16 * nd
        k = args.first
        n_done = 0
        frames = [loader.get_next_frame()]
        done = frames[0] is None
        while not done:
            # fill a chunk of consecutive pairs (the last frame carries over)
            while len(frames) - 1 < chunk:
                if args.num and n_done + len(frames) - 1 >= args.num:
                    break
                img = loader.get_next_frame()
                if img is None:
                    break
                frames.append(img)
            if len(frames) < 2:
                break
            done = len(frames) - 1 < chunk
            prevs = np.stack(frames[:-1]).astype(np.float32)
            imgs = np.stack(frames[1:]).astype(np.float32)
            pp, n_real = pm.pad_to_multiple(prevs, nd)
            pi, _ = pm.pad_to_multiple(imgs, nd)
            _, img_s, warped, _, _, _ = rect_fn(pp, pi)
            img_s = np.asarray(img_s)[:n_real]
            warped = np.asarray(warped)[:n_real]
            for j in range(n_real):
                save_image(os.path.join(und_dir, f"{k:09d}.png"),
                           img_s[j].transpose(2, 0, 1))
                save_image(os.path.join(rect_dir, f"{k:09d}.png"),
                           warped[j].transpose(2, 0, 1))
                k += 1
            n_done += n_real
            frames = frames[-1:]
        print(f"rectified {n_done} pairs")
        return 0
    prev = loader.get_next_frame()
    k = args.first
    while True:
        img = loader.get_next_frame()
        if img is None or (args.num and k - args.first >= args.num):
            break
        pair = load_rectified_pair(g, cal, prev, img, compute_gt=False,
                                   device=args.device)
        save_image(os.path.join(und_dir, f"{k:09d}.png"),
                   pair.image.transpose(2, 0, 1))
        save_image(os.path.join(rect_dir, f"{k:09d}.png"),
                   pair.prev_warped.transpose(2, 0, 1))
        prev = img
        k += 1
    print(f"rectified {k - args.first} pairs")
    return 0


def _recency_star(date_str: str, today: str) -> str:
    """The recency marker: ' **' for today's files, ' *' within 2 days,
    '' otherwise."""
    if not date_str:
        return ""
    if date_str == today:
        return " **"
    try:
        import datetime as _dt
        d1 = _dt.date.fromisoformat(date_str)
        d2 = _dt.date.fromisoformat(today)
        if (d2 - d1).days % 365 < 2:
            return " *"
    except ValueError:
        pass
    return ""


def _select_menu(entries, today: str, input_fn, specials=()):
    """Numbered menu with recency stars. entries: [(name, date)]. Returns
    the chosen entry, a special string the user typed, or None."""
    if not entries:
        print("No files in specified directory")
        return None
    for i, (name, date) in enumerate(entries, 1):
        print(f"({i}) {name}{_recency_star(date, today)}")
    while True:
        s = input_fn()
        if s in specials:
            return s
        if s == "" and len(entries) == 1:
            return entries[0]
        try:
            i = int(s)
        except (TypeError, ValueError):
            continue
        if 1 <= i <= len(entries):
            return entries[i - 1]


def _select_epoch(entries, input_fn):
    """Epoch menu: requires a contiguous 0..N run, empty input = last.
    entries: [(name, date, n)]."""
    entries = sorted(entries, key=lambda e: e[2])
    ns = [e[2] for e in entries]
    if not ns or ns[0] != 0 or ns[-1] != len(ns) - 1:
        print("Missing epochs, can't perform model selection")
        return None
    print(f"Select epoch: 0..{ns[-1]} (default = last)")
    while True:
        s = input_fn()
        if s == "":
            return entries[-1]
        try:
            i = int(s)
        except (TypeError, ValueError):
            continue
        if 0 <= i <= ns[-1]:
            return entries[i]


def _epoch_number(name: str):
    """'e12' (this repo's checkpoints) or 'model_of__e12' (the reference's
    torch files) -> 12; otherwise None."""
    import re
    m = re.fullmatch(r"(?:model_of__)?e(\d+)(?:\.bin)?", name)
    return int(m.group(1)) if m else None


def _ssh_lister(host):
    def lister(path):
        out = subprocess.run(
            ["ssh", host, f"ls -l --time-style=+%F {path}"],
            capture_output=True, text=True, timeout=30, check=True)
        entries = []
        for line in out.stdout.splitlines():
            # with --time-style=+%F the name is everything after column 6
            # (maxsplit keeps filenames containing spaces intact)
            parts = line.split(None, 6)
            if len(parts) >= 7 and (line[0] == "d" or line[0] == "-"):
                entries.append((parts[6], parts[5]))
        return entries
    return lister


def cmd_download_interactive(args, lister=None, input_fn=input,
                             today=None) -> int:
    """Interactive model browser: descend the remote model hierarchy one
    numbered menu at a time (recency stars on fresh entries), pick an epoch
    at the leaf (contiguous-run check, default last), scp it down.
    ``lister``/``input_fn`` are injectable for tests."""
    import datetime as _dt

    if today is None:
        today = _dt.date.today().isoformat()
    if lister is None:
        try:
            lister = _ssh_lister(args.host)
            lister(args.remote_dir)
        except (FileNotFoundError, subprocess.SubprocessError) as e:
            print(f"ssh unavailable: {e}", file=sys.stderr)
            return 1

    path = args.remote_dir
    while True:
        try:
            entries = lister(path)
        except (FileNotFoundError, subprocess.SubprocessError) as e:
            print(f"listing failed for {path}: {e}", file=sys.stderr)
            return 1
        if entries is None or not entries:
            print("No files in specified directory")
            return 1
        epochs = [(n, d, _epoch_number(n)) for n, d in entries
                  if _epoch_number(n) is not None]
        if epochs:
            pick = _select_epoch(epochs, input_fn)
            if pick is None:
                return 1
            target = f"{path}/{pick[0]}"
            break
        pick = _select_menu(entries, today, input_fn)
        if pick is None:
            return 1
        path = f"{path}/{pick[0]}"

    os.makedirs(args.output_dir, exist_ok=True)
    print(f"fetching {target}")
    subprocess.run(["scp", "-r", f"{args.host}:{target}", args.output_dir],
                   check=True)
    return 0


def cmd_download(args) -> int:
    """ssh/scp model fetch (gated on ssh availability)."""
    if getattr(args, "interactive", False):
        return cmd_download_interactive(args)
    try:
        out = subprocess.run(
            ["ssh", args.host, f"ls -1 {args.remote_dir}"],
            capture_output=True, text=True, timeout=30, check=True)
    except (FileNotFoundError, subprocess.SubprocessError) as e:
        print(f"ssh unavailable: {e}", file=sys.stderr)
        return 1
    models = [m for m in out.stdout.splitlines() if m.strip()]
    if args.filter:
        models = [m for m in models if args.filter in m]
    if not models:
        print("no models found")
        return 1
    target = models[-1] if args.latest else models[0]
    print(f"fetching {target}")
    subprocess.run(["scp", "-r", f"{args.host}:{args.remote_dir}/{target}",
                    args.output_dir], check=True)
    return 0


def cmd_stream(args) -> int:
    """Streaming frame loop with per-stage timing.

    Two regimes, each printing per-stage running means:
      * synchronous (default): every frame's outputs are fetched before the
        next frame goes in;
      * --pipeline K: frame in, frame out, with K frames in flight: the
        outputs of frame n are fetched on a fetcher thread while frames
        n+1..n+K compute (``DepthEstimator.next_frame_packed``).
    """
    from collections import deque
    from concurrent.futures import ThreadPoolExecutor

    from ..api import DepthEstimator
    from ..data import images as img_mod
    from ..geometry3d import calibration as calmod
    from ..models import io as model_io
    from ..utils.viewer import LiveViewer

    geom, _, params, _ = model_io.load_model(args.model)
    cal = calmod.PRESETS[args.calibration]
    est = DepthEstimator(geom, params, cal, head=args.head,
                         sync_timers=not args.pipeline, device=args.device)
    if args.camera:
        loader = img_mod.ImageCamera(cal.hImg, cal.wImg, device=args.camera)
    else:
        loader = img_mod.ImageLoader(args.directory, cal.hImg, cal.wImg,
                                     args.first)
    est.reset(loader.get_next_frame())

    def fetch_packed(out):
        a = out.cpu().numpy()
        return a[0].astype(np.float32), a[1].astype(np.float32)

    viewer = LiveViewer("stream: x-flow", enabled=bool(args.show))
    if args.show and viewer.backend == "none":
        print("--show: no display available, continuing headless")

    def show_flow(xflow, mask):
        # gray = flow/16 + 0.5, masked black
        viewer.show((np.asarray(xflow) / 16.0 + 0.5) * np.asarray(mask))

    pool = ThreadPoolExecutor(4) if args.pipeline else None
    pend: deque = deque()
    n = 0
    t0 = time.perf_counter()
    while True:
        frame = loader.get_next_frame()
        if frame is None or (args.num and n >= args.num):
            break
        if args.pipeline:
            # downscale to the working size on the host before the upload
            fsmall = img_mod.scale_np(frame, geom.hImg, geom.wImg)
            pend.append(pool.submit(
                fetch_packed, est.next_frame_packed(fsmall)))
            if len(pend) > args.pipeline:
                show_flow(*pend.popleft().result())
        else:
            _, xflow, mask = est.next_frame_depth(frame)
            show_flow(xflow, mask)
        n += 1
        print(f"frame {n}: {est.timers.report()}  "
              f"FPS: {n / (time.perf_counter() - t0):.2f}")
    while pend:
        show_flow(*pend.popleft().result())
    if pool is not None:
        pool.shutdown()
    viewer.close()
    if n:
        dt = time.perf_counter() - t0
        print(f"total: {n} frames in {dt:.2f}s -> {n / dt:.2f} FPS")
    return 0


def _video_step(g, cal, Khalf, model, maskmiddle, args):
    """One frame of the offline pipeline as eager torch: (last_im,
    last_im_scaled, frame) -> (im, im_scaled, panel (3, 3 hImg, 3 wImg))."""
    import math

    from ..data import images as img_mod
    from ..geometry3d import egomotion as ego
    from ..geometry3d import polar as polar_ops
    from ..geometry3d import undistort as undist
    from ..models import flow as flow_model
    from ..ops import extract, postprocess

    def decode_assemble(dist, head_mean):
        if head_mean:
            ey, ex = flow_model.soft_argmax(g, dist)
        else:
            out = flow_model.process_output(g, dist, process_full=False)
            ey, ex = out.y.float(), out.x.float()
        return flow_model.embed_center(torch.stack([ey, ex]), g.hImg, g.wImg)

    def flow_row(full, mask):
        """Flow panels: gray = flow/16 + 0.5 under the mask, invalid
        pixels 0.5 in blue only."""
        vx = (full[1] / 16.0 + 0.5) * mask
        vy = (full[0] / 16.0 + 0.5) * mask
        bx = vx + (1.0 - mask) * 0.5
        by = vy + (1.0 - mask) * 0.5
        return torch.stack([vx, vx, bx]), torch.stack([vy, vy, by])

    center = (float(Khalf[0, 2]), float(Khalf[1, 2]))

    @torch.no_grad()
    def step(last_im, last_im_scaled, frame):
        dev = frame.device
        im = undist.undistort_image(frame, cal.K, cal.distortion)
        em = ego.get_ego_motion(last_im, im, cal.K,
                                max_points=cal.sfm.max_points,
                                quality=cal.sfm.points_quality)
        ratio = em.n_inliers.float() / torch.clamp(em.n_found.float(),
                                                   min=1.0)
        good = ratio >= cal.bad_image_threshold
        R = torch.where(good, em.R, torch.eye(3, device=dev))
        im_scaled = img_mod.scale(im, g.hImg, g.wImg)
        warped = undist.remove_ego_motion(last_im_scaled, Khalf, R)
        wmask = undist.remove_ego_motion(
            torch.ones((g.hImg, g.wImg, 1), device=dev), Khalf, R)[..., 0]

        dist = torch.softmax(-model.costs(warped, im_scaled), dim=-1)
        full_max = decode_assemble(dist, False)
        full_mean = decode_assemble(dist, True)
        # thresholded-extraction confidence mask (k=2)
        pm = flow_model.process_output(g, dist, process_full=True,
                                       threshold=2.0)
        bh = math.ceil((g.hImg - dist.shape[0]) / 2)
        bw = math.ceil((g.wImg - dist.shape[1]) / 2)
        mask = extract.enlarge_mask(wmask > 0.5, 2 * bh + 1,
                                    2 * bw + 1).float()
        mask_entropy = pm.full_confidences * maskmiddle
        if args.entropy_thr > 0.0:
            # opt-in uncertainty gate, embedded into the full frame
            egate = extract.entropy_mask(dist, args.entropy_thr).float()
            mask_entropy = mask_entropy * flow_model.embed_center(
                egate, g.hImg, g.wImg)
        zero = torch.zeros_like(mask)
        mask = torch.where(good, mask, zero)
        mask_entropy = torch.where(good, mask_entropy, zero)
        full_max_m = full_max * mask[None]
        full_mean_m = full_mean * mask[None]
        mask_total = mask * mask_entropy
        flow_pp = postprocess.post_process_image(full_max_m, mask_total,
                                                 args.post_win, "med")
        flow_pp_mean = postprocess.post_process_image(
            full_mean_m, mask_total, args.post_win, "med")

        # radial depth panels from the postprocessed flows
        rows = []
        for full_m, pp in ((full_max_m, flow_pp), (full_mean_m, flow_pp_mean)):
            rad, radconf = polar_ops.radial_depth_cartesian(
                pp, center, g.wImg / 2.0)
            radconf = radconf * mask * mask_entropy
            depth_rgb = polar_ops.depth2color((rad / 200.0) * radconf,
                                              radconf)
            px, py = flow_row(full_m, mask)
            rows.append(torch.cat([px, py, depth_rgb], dim=2))
        row0 = torch.cat([last_im_scaled.permute(2, 0, 1),
                          warped.permute(2, 0, 1),
                          im_scaled.permute(2, 0, 1)], dim=2)
        panel = torch.cat([row0] + rows, dim=1)
        return im, im_scaled, torch.clamp(panel, 0.0, 1.0)

    return step


def cmd_video(args) -> int:
    """Offline pipeline: frames -> flow + depth panels -> video.

    Per frame: undistort -> ego-motion -> warp of the previous scaled frame
    -> one model forward decoded three ways ('max' WTA, 'mean' soft-argmax,
    thresholded extraction for the confidence mask) -> warp-mask erosion ->
    middle-disc mask times the extraction mask -> bad-frame zeroing ->
    masked flows -> median postprocess on the total mask -> panel rows
    [prev | warped | current], [x-flow | y-flow | radial depth] and the same
    for the 'mean' decode -> ffmpeg (or GIF) at 10 fps. Eager torch on
    ``--device``; one PNG fetch a frame.
    """
    from ..data import images as img_mod
    from ..geometry3d import calibration as calmod
    from ..geometry3d import undistort as undist
    from ..models import flow as flow_model
    from ..models import io as model_io
    from ..ops import extract
    from ..utils.device import resolve
    from ..utils.viewer import LiveViewer
    from ..utils.viz import export_video, save_image

    dev = resolve(args.device)
    g, _, params, _ = model_io.load_model(args.model)
    cal = calmod.PRESETS[args.calibration]
    model = model_io.load_tree_into(flow_model.FlowModel(g, device=dev),
                                    params)
    Khalf = cal.K.copy()
    Khalf[0] *= g.wImg / cal.wImg
    Khalf[1] *= g.hImg / cal.hImg
    maskmiddle = extract.middle_disc_mask(g.hImg, g.wImg, 25.0, device=dev)
    step = _video_step(g, cal, Khalf, model, maskmiddle, args)

    loader = img_mod.ImageLoader(args.directory, cal.hImg, cal.wImg,
                                 args.first)
    os.makedirs(args.output_dir, exist_ok=True)
    first = torch.as_tensor(loader.get_next_frame(), device=dev)
    last_im = undist.undistort_image(first, cal.K, cal.distortion)
    last_im_scaled = img_mod.scale(last_im, g.hImg, g.wImg)
    viewer = LiveViewer("video: panels", enabled=bool(args.show))
    if args.show and viewer.backend == "none":
        print("--show: no display available, continuing headless")
    k = 0
    while True:
        frame = loader.get_next_frame()
        if frame is None or (args.num and k >= args.num):
            break
        last_im, last_im_scaled, panel = step(
            last_im, last_im_scaled, torch.as_tensor(frame, device=dev))
        panel_np = panel.cpu().numpy()
        save_image(os.path.join(args.output_dir, f"{k:09d}.png"), panel_np)
        viewer.show(panel_np.transpose(1, 2, 0))
        k += 1
    viewer.close()
    ok = export_video(args.output_dir,
                      os.path.join(args.output_dir, "out.mp4"), fps=10)
    print(f"wrote {k} panels; video={'ok' if ok else 'unavailable'}")
    return 0


def cmd_time_matching(args) -> int:
    """Microbenchmark: the filter against filter + matcher (B1) + decode on
    random frames at the car model's size, synchronised at each end."""
    from ..geometry import Geometry
    from ..models.flow import FlowModel
    from ..utils.device import resolve
    from ..utils.timer import sync

    dev = resolve(args.device)
    g = Geometry(hImg=180, wImg=320, layers=((3, 16, 16, 10),),
                 maxh=16, maxw=16)
    model = FlowModel(g, device=dev).init(torch.Generator().manual_seed(0))
    rng = np.random.RandomState(0)
    img1, img2 = (torch.tensor(rng.rand(g.hImg, g.wImg, 3), dtype=torch.float32,
                               device=dev) for _ in range(2))

    def bench(fn, *a):
        sync(fn(*a))
        t0 = time.perf_counter()
        for _ in range(args.iters):
            out = fn(*a)
        sync(out)
        return (time.perf_counter() - t0) / args.iters

    t_filter = bench(model.features, img1)
    t_full = bench(model.forward_fused, img1, img2)
    print(f"filter: {t_filter * 1e3:.3f} ms   "
          f"filter+match+decode: {t_full * 1e3:.3f} ms   "
          f"({1.0 / t_full:.0f} fps)")
    return 0


@full_f32()
def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="det-tools-torch")
    sub = p.add_subparsers(dest="cmd", required=True)

    def device_flag(sp):
        sp.add_argument("--device", default="cuda",
                        help="torch device to run on (default cuda; "
                             "'cpu' runs the kernels' plain versions)")

    r = sub.add_parser("rectify")
    r.add_argument("directory")
    r.add_argument("--calibration", default="ardrone")
    r.add_argument("--first", type=int, default=0)
    r.add_argument("--num", type=int, default=0)
    r.add_argument("--dp", default="auto", metavar="auto|off|N",
                   help="data-parallel device mesh for the rectification "
                        "batch ('auto' = every card when there are two or "
                        "more; with --device cpu, N is N CPU shards; see "
                        "parallel/mesh.py sharded_rectify_fn)")
    device_flag(r)

    d = sub.add_parser("download")
    d.add_argument("host")
    d.add_argument("--remote-dir", default="models")
    d.add_argument("--filter", default="")
    d.add_argument("--latest", action="store_true")
    d.add_argument("--interactive", action="store_true",
                   help="menu-driven model browser (menus with recency "
                        "stars, epoch selection)")
    d.add_argument("--output-dir", default=".")

    s = sub.add_parser("stream")
    s.add_argument("model")
    s.add_argument("directory")
    s.add_argument("--camera", default=None, metavar="DEV",
                   help="capture live from a V4L2 device (e.g. /dev/video0) "
                        "instead of reading numbered files")
    s.add_argument("--calibration", default="ardrone")
    s.add_argument("--head", default="mean")
    s.add_argument("--first", type=int, default=0)
    s.add_argument("--num", type=int, default=0)
    s.add_argument("--show", action="store_true",
                   help="live x-flow window when a display exists "
                        "(headless fallback is a no-op; utils/viewer.py)")
    s.add_argument("--pipeline", type=int, default=0, metavar="K",
                   help="frames in flight (0 = synchronous)")
    device_flag(s)

    v = sub.add_parser("video")
    v.add_argument("model")
    v.add_argument("directory")
    v.add_argument("--calibration", default="ardrone")
    v.add_argument("--output-dir", default="video_out")
    v.add_argument("--post-win", type=int, default=3)
    v.add_argument("--entropy-thr", type=float, default=0.0, metavar="H",
                   help="optional extra confidence gate: drop pixels whose "
                        "window-distribution Shannon entropy exceeds H "
                        "(0 = off; ln(maxh*maxw) is the max possible)")
    v.add_argument("--first", type=int, default=0)
    v.add_argument("--num", type=int, default=0)
    v.add_argument("--show", action="store_true",
                   help="live panel window when a display exists "
                        "(headless fallback is a no-op; utils/viewer.py)")
    device_flag(v)

    t = sub.add_parser("time-matching")
    t.add_argument("--iters", type=int, default=10)
    device_flag(t)

    e = sub.add_parser("export",
                       help="write a serving artifact (a torch.export "
                            "program with its weights inside, serving.py)")
    e.add_argument("model")
    e.add_argument("--out", default=None,
                   help="artifact path (default <model>/serving.pt2)")
    e.add_argument("--pipeline", action="store_true",
                   help="export the complete batched online program "
                        "instead of the flow forward")
    e.add_argument("--batch", type=int, default=32)
    e.add_argument("--cal", default=None, help=".cal file (pipeline export)")
    e.add_argument("--bf16", action="store_true",
                   help="bf16 matcher feature storage (forward export)")
    e.add_argument("--hw", type=int, nargs=2, default=None,
                   metavar=("H", "W"),
                   help="artifact input dims for radial (polar grid, "
                        "default 200 200) and legacy-depth (frame, "
                        "default 360 640) exports")
    device_flag(e)

    args = p.parse_args(argv)
    from ..serving import cmd_export
    return {"rectify": cmd_rectify, "download": cmd_download,
            "stream": cmd_stream, "video": cmd_video,
            "time-matching": cmd_time_matching,
            "export": cmd_export}[args.cmd](args)


if __name__ == "__main__":
    sys.exit(main())
