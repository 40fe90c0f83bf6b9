"""Radial (polar 1-D) flow trainer CLI (port of
``depth_estimation_tpu.cli.train_radial``).

The network from a string flag (``-net "[[3,5,5,10],'tanh',...]"``), the
polar input size, hWin classes, the nll over the radial window, and a
weights-only checkpoint an epoch (``e{N}.msgpack`` with ``meta.json``,
``training/families.RadialTrainer``), and the data-parallel mesh
(``--dp``: the polar dataset and GT build and the training batches split
across the cards, ``parallel/mesh.py``). Run as ``python -m
depth_estimation_tpu_torch.cli.train_radial -rd data/ ... [--device cpu]
[--dp auto|off|N]``.
"""

from __future__ import annotations

import argparse
import ast
import os
import sys

import numpy as np
import torch

from ..utils.precision import full_f32


def build_parser():
    p = argparse.ArgumentParser(description="Train the radial polar flow net")
    p.add_argument("-net", "--network", default="[[3,5,5,10],'tanh',[10,5,5,10]]",
                   help="layer spec: list of [cin,kh,kw,cout] and 'tanh'")
    p.add_argument("-hwin", "--h-win", type=int, default=15)
    p.add_argument("-hi", "--h-input", type=int, default=200)
    p.add_argument("-wi", "--w-input", type=int, default=200)
    p.add_argument("-rd", "--root-directory", default="data/")
    p.add_argument("-ds", "--dataset", default="")
    p.add_argument("-cal", "--calibration", default="gopro")
    p.add_argument("-ni", "--num-input-images", type=int, default=10)
    p.add_argument("-d", "--delta", type=int, default=1)
    p.add_argument("-n", "--n-train-set", type=int, default=1000)
    p.add_argument("-e", "--num-epochs", type=int, default=10)
    p.add_argument("-r", "--learning-rate", type=float, default=1e-2)
    p.add_argument("-lrd", "--learning-rate-decay", type=float, default=1e-5)
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("-omd", "--output-model-dir", default="models_radial")
    p.add_argument("-mf", "--max-flow", type=float, default=None)
    p.add_argument("-gtd", "--gt-dataset", default=None,
                   help="name of an index-aligned sibling dataset (under "
                        "the same root directory) whose frames drive "
                        "ego-motion geometry and GT targets, while patch "
                        "PIXELS come from --dataset: GT computed on the "
                        "clean recording, features learned on the noisy "
                        "one")
    p.add_argument("--dp", default="auto", metavar="auto|off|N",
                   help="data-parallel device mesh: shards the polar "
                        "dataset/GT build and the training batches across "
                        "the visible cards ('auto' = all when >1; N CPU "
                        "shards with --device cpu)")
    p.add_argument("-sl", "--scene-length", type=int, default=0,
                   help="frames per scene when the dataset dir holds "
                        "several back-to-back recordings: pairs crossing "
                        "a scene boundary are dropped. Counts loaded "
                        "(post--delta) frames. 0 = one continuous sequence")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    return p


@full_f32()
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..geometry3d import calibration as calmod
    from ..models import io as mio
    from ..training.families import RadialTrainer, read_frames
    from ..utils.device import resolve

    dev = resolve(args.device)
    layers = tuple(tuple(l) if isinstance(l, list) else l
                   for l in ast.literal_eval(args.network))
    tr = RadialTrainer(layers, args.h_win, args.learning_rate,
                       args.learning_rate_decay, args.batch_size, device=dev)
    cal = calmod.PRESETS[args.calibration]

    frames = read_frames(os.path.join(args.root_directory, args.dataset),
                         cal.hImg, cal.wImg, args.num_input_images,
                         args.delta)
    if len(frames) < 2:
        print("no usable pairs", file=sys.stderr)
        return 1
    gt_frames = None
    if args.gt_dataset:
        # clean-targets regime: geometry and GT from the sibling dataset's
        # frames, pixels from this one's
        gt_frames = read_frames(
            os.path.join(args.root_directory, args.gt_dataset), cal.hImg,
            cal.wImg, len(frames), args.delta)
        if len(gt_frames) != len(frames):
            print(f"--gt-dataset {args.gt_dataset} is not index-aligned "
                  f"({len(gt_frames)} frames vs {len(frames)})",
                  file=sys.stderr)
            return 1
    # --dp: shard the dataset/GT build and training over a device mesh
    from ..parallel import mesh as pm
    mesh = pm.auto_mesh(args.dp, dev)
    if mesh is not None:
        print(f"dp mesh: {mesh.size} devices ({mesh.platform})")
        if args.batch_size % mesh.size:
            print(f"batch size {args.batch_size} not divisible by the "
                  f"{mesh.size}-device mesh", file=sys.stderr)
            return 1
    pairs = tr.load_pairs(cal, frames, args.h_input, args.w_input,
                          max_flow=args.max_flow,
                          scene_length=args.scene_length,
                          gt_frames=gt_frames, mesh=mesh)
    if not pairs:
        print("no usable pairs", file=sys.stderr)
        return 1
    print(f"{len(pairs)}/{len(frames) - 1} pairs usable")

    rng = np.random.RandomState(0)
    corpus = tr.sample(pairs, args.n_train_set, rng)
    tr.init(torch.Generator().manual_seed(0))
    if mesh is not None:
        tr.use_mesh(mesh)
    corpus = tuple(torch.as_tensor(a, device=dev) for a in corpus)
    os.makedirs(args.output_model_dir, exist_ok=True)
    for epoch in range(args.num_epochs):
        m = tr.epoch(corpus, rng)
        if m["losses"]:
            print(f"epoch {epoch}: loss {m['loss']:.4f} acc {m['acc']:.3f}")
        else:
            print(f"epoch {epoch}: no full batch "
                  f"({len(corpus[2])} patches < batch_size {args.batch_size})")
        mio.save_radial_checkpoint(args.output_model_dir, tr.model, epoch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
