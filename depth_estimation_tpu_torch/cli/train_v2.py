"""version2 trainer CLI (port of ``depth_estimation_tpu.cli.train_v2``): the
contrastive-norm + single-conv network on cross-correlation GT patches
(``training/families.V2Trainer``), a constant rate, and the bare weights
``e{N}`` with a ``meta.json`` sidecar an epoch. Run as ``python -m
depth_estimation_tpu_torch.cli.train_v2 -rd data/ ... [--device cpu]``.
"""

from __future__ import annotations

import argparse
import sys

import numpy as np
import torch

from ..utils.precision import full_f32


@full_f32()
def main(argv=None) -> int:
    p = argparse.ArgumentParser(description="Train the version2 network")
    p.add_argument("-rd", "--root-directory", default="data/")
    p.add_argument("-cal", "--calibration", default="rectified_gopro_small")
    p.add_argument("-ni", "--num-input-images", type=int, default=10)
    p.add_argument("-n", "--n-train-set", type=int, default=1000)
    p.add_argument("-e", "--num-epochs", type=int, default=10)
    p.add_argument("-r", "--learning-rate", type=float, default=1e-2)
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("-win", "--window", type=int, default=17)
    p.add_argument("-ker", "--kernel", type=int, default=17)
    p.add_argument("-nf", "--n-features", type=int, default=32)
    p.add_argument("-nk", "--normalization-k", type=int, default=17)
    p.add_argument("-omd", "--output-model-dir", default="models_v2")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda)")
    args = p.parse_args(argv)

    from ..geometry3d import calibration as calmod
    from ..models import io as mio
    from ..models.version2 import V2Params
    from ..training.families import V2Trainer
    from ..utils.device import resolve

    dev = resolve(args.device)
    cal = calmod.PRESETS[args.calibration]
    datap = V2Params(wImg=cal.wImg, hImg=cal.hImg,
                     normalization_k=args.normalization_k,
                     layers=((3, args.kernel, args.kernel, args.n_features),),
                     hWin=args.window, wWin=args.window)
    tr = V2Trainer(datap, args.learning_rate, args.batch_size, device=dev)
    rng = np.random.RandomState(0)
    corpus = tr.sample(cal, args.root_directory, args.num_input_images,
                       args.n_train_set, rng)
    tr.init(torch.Generator().manual_seed(0))
    corpus = tuple(torch.as_tensor(a, device=dev) for a in corpus)
    for epoch in range(args.num_epochs):
        m = tr.epoch(corpus, rng)
        if m["losses"]:
            print(f"epoch {epoch}: loss {m['loss']:.4f} acc {m['acc']:.3f}")
        else:
            print(f"epoch {epoch}: no full batch "
                  f"({len(corpus[2])} patches < batch_size {args.batch_size})")
        mio.save_v2_checkpoint(args.output_model_dir, tr.model, epoch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
