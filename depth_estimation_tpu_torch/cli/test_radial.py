"""Radial online tester CLI (port of ``depth_estimation_tpu.cli.test_radial``).

The polar streaming loop, per frame, through ``api_radial.
BatchedRadialEstimator`` on one stream: ego-motion -> epipole with EMA
smoothing (alpha 0.5; an epipole out of frame keeps the previous one) ->
epipole-centered polar warp of the current and the rotation-compensated
previous frame -> radial matcher -> WTA flow -> polar -> cartesian warp
back -> flow2depth -> HSL colour panel written to disk; with ``-cmp``
also a panel of depth from a dense variational flow.
Run as ``python -m depth_estimation_tpu_torch.cli.test_radial``.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys

import torch

from ..utils.precision import full_f32


def build_parser():
    p = argparse.ArgumentParser(description="Radial polar depth streaming")
    p.add_argument("-net", "--network", default="[[3,5,5,10],'tanh',[10,5,5,10]]")
    p.add_argument("-w", "--weights", default=None, help="msgpack weights")
    p.add_argument("-hwin", "--h-win", type=int, default=15)
    p.add_argument("-hi", "--h-input", type=int, default=200)
    p.add_argument("-wi", "--w-input", type=int, default=200)
    p.add_argument("-rd", "--root-directory", default="data/")
    p.add_argument("-cal", "--calibration", default="gopro")
    p.add_argument("-ni", "--num-images", type=int, default=10)
    p.add_argument("-o", "--output-dir", default="radial_out")
    p.add_argument("-ki", "--k-infty", type=float, default=1.0)
    p.add_argument("-cmp", "--compare-dense", action="store_true",
                   help="also render a dense-variational-flow depth panel "
                        "per frame (the variational solver stands in for "
                        "the original tester's OpenCV Farneback)")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    return p


@full_f32()
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..api_radial import BatchedRadialEstimator
    from ..data import images as img_mod
    from ..geometry3d import calibration as calmod
    from ..geometry3d import polar as polar_ops
    from ..models import io as mio
    from ..models.radial import RadialFlowNetwork
    from ..utils.device import as_f32, resolve
    from ..utils.timer import Timers
    from ..utils.viz import save_image

    dev = resolve(args.device)
    layers = tuple(tuple(l) if isinstance(l, list) else l
                   for l in ast.literal_eval(args.network))
    net = RadialFlowNetwork(layers, args.h_win, device=dev)
    net.init(torch.Generator().manual_seed(0))
    if args.weights:
        mio.load_weights_into(args.weights, net)

    cal = calmod.PRESETS[args.calibration]
    loader = img_mod.ImageLoader(args.root_directory, cal.hImg, cal.wImg)
    os.makedirs(args.output_dir, exist_ok=True)
    timers = Timers(sync_device=True)
    est = BatchedRadialEstimator(net, cal, args.h_input, args.w_input,
                                 args.k_infty, device=dev)

    prev = loader.get_next_frame()
    est.reset(as_f32(prev[None], dev))
    k = 0
    while True:
        img = loader.get_next_frame()
        if img is None or k >= args.num_images:
            break
        timers.tic("pair")
        out = est.next_frames(as_f32(img[None], dev))
        if bool(out.good[0]):
            save_image(os.path.join(args.output_dir, f"{k:09d}.png"),
                       polar_ops.depth2color(out.depth[0], out.confs[0]))
            if args.compare_dense:
                # dense-flow baseline: flow magnitude -> depth panel
                from ..flow import get_optical_flow
                timers.tic("dense")
                ps, cs = (img_mod.scale(torch.as_tensor(a, device=dev),
                                        args.h_input, args.w_input)
                          for a in (prev, img))
                u, v = get_optical_flow(ps, cs, ratio=0.75, n_outer=3,
                                        n_sor=20)
                mag = torch.sqrt(u * u + v * v)
                e2 = out.e2[0].tolist()
                ddepth, dconfs = polar_ops.flow2depth(
                    args.h_input, args.w_input, mag, (e2[0], e2[1]),
                    args.k_infty)
                save_image(os.path.join(args.output_dir, f"{k:09d}_dense.png"),
                           polar_ops.depth2color(ddepth, dconfs))
                timers.toc("dense", mag)
        timers.toc("pair", out.depth)
        prev = img
        k += 1
    print(timers.report())
    return 0


if __name__ == "__main__":
    sys.exit(main())
