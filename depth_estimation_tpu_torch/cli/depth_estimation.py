"""Legacy direct-depth trainer and inference CLI (port of
``depth_estimation_tpu.cli.depth_estimation``).

Class-balanced 32x32 patches of the sparse depth points, the classic CNN
with the fixed SGD (rate 1e-2, decay 5e-7), per-epoch accuracy and
confusion matrix, the checkpoint with its discretizer
(``training/families.DepthClassifierTrainer``); ``-lw`` loads a model
instead of training one, and ``-i N`` writes the class map of pair (N,
N + delta) as ``depth_classes_<N>.npz`` and ``.png``. Run as ``python -m
depth_estimation_tpu_torch.cli.depth_estimation -rd data/ [-i N]
[--device cpu]``.
"""

from __future__ import annotations

import argparse
import os
import sys

import numpy as np
import torch

from ..utils.precision import full_f32


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Legacy direct depth classifier")
    p.add_argument("-n", "--n-train-set", type=int, default=2000)
    p.add_argument("-m", "--n-test-set", type=int, default=500)
    p.add_argument("-ni", "--num-input-images", type=int, default=10)
    p.add_argument("-e", "--num-epochs", type=int, default=10)
    p.add_argument("-o", "--output-model", default="legacy_depth_model")
    p.add_argument("-d", "--delta", type=int, default=10)
    p.add_argument("-rd", "--root-directory", default="./data")
    p.add_argument("-i", "--input-image", type=int, default=None,
                   help="run inference on image number i (uses pair i, i+delta)")
    p.add_argument("-cd", "--cut-depth", type=float, default=None)
    p.add_argument("-nc", "--num-classes", type=int, default=2)
    p.add_argument("-hi", "--h-img", type=int, default=360)
    p.add_argument("-wi", "--w-img", type=int, default=640)
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("-lw", "--load-model", default=None,
                   help="load a saved model instead of training")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    return p


@full_f32()
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..data.depth_legacy import load_depth_dataset
    from ..training.families import DepthClassifierTrainer
    from ..utils.device import resolve
    from ..utils.viz import save_image

    dev = resolve(args.device)
    frames, images = load_depth_dataset(
        args.root_directory, args.num_input_images, args.delta,
        args.h_img, args.w_img)
    if not frames:
        print("no annotated frames found under", args.root_directory)
        return 1

    rng = np.random.RandomState(1)
    if args.load_model:
        tr = DepthClassifierTrainer.load(args.load_model, args.batch_size,
                                         device=dev)
    else:
        tr = DepthClassifierTrainer(args.num_classes, args.batch_size,
                                    device=dev)
        tr.init(torch.Generator().manual_seed(0))
        sets = tr.make_datasets(frames, images, args.n_train_set,
                                args.n_test_set, rng, cut_depth=args.cut_depth)
        disc = tr.discretizer
        print(f"cutDepth={disc.cut_depth} classes={disc.n_classes} "
              f"train={len(sets[1])} test={len(sets[3])}")
        for epoch in range(args.num_epochs):
            m = tr.fit(*sets, 1, rng)[0]
            print(f"epoch {epoch}: loss {m['loss']:.4f} "
                  f"train acc {m['train_acc']:.3f} test acc {m['test_acc']:.3f}")
            print("confusion:\n", m["confusion"])
        tr.save(args.output_model)

    if args.input_image is not None:
        idx = [i for i, fr in enumerate(frames)
               if int(fr["name"]) == args.input_image]
        if not idx:
            print(f"image {args.input_image} has no annotated frame")
            return 1
        classmap = tr.class_map(images[idx[0]])
        out = os.path.join(args.output_model,
                           f"depth_classes_{args.input_image:09d}")
        np.savez(out + ".npz", classes=classmap)
        # near (class 0) white, far black
        save_image(out + ".png", (classmap == 0).astype(np.float32))
        print("class map:", out + ".png", "shape", classmap.shape,
              "near fraction", float((classmap == 0).mean()))
    return 0


if __name__ == "__main__":
    sys.exit(main())
