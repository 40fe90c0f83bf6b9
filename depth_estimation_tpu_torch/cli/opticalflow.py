"""Flow trainer CLI (port of ``depth_estimation_tpu.cli.opticalflow``).

The network (1-3 conv layers, features, kernel sizes, sparse fan-in), the
search window (with the multiscale power-of-two ratio schedule), the
learning (SGD rate, decay, soft targets, a renewable training set), the GT
generator (cross-correlation, cc-mean or liu), the motion correction, the
dataset's slice, and the per-epoch score and checkpoint (``--resume``
continues a run), and the data-parallel mesh (``--dp``: the dataset build
and the training batches split across the cards, ``parallel/mesh.py``).
Run as ``python -m depth_estimation_tpu_torch.cli.opticalflow
--root-directory data/ ... [--device cpu] [--dp auto|off|N]``.
"""

from __future__ import annotations

import argparse
import dataclasses
import math
import os
import sys

import numpy as np
import torch

from ..utils.precision import full_f32


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(description="Train the patch-correlation flow model")
    # general
    p.add_argument("-nt", "--num-threads", type=int, default=2,
                   help="(accepted for parity; not used)")
    # network
    p.add_argument("-nf", "--n-features", type=int, default=10)
    p.add_argument("-k1s", "--kernel1-size", type=int, default=5)
    p.add_argument("-k2s", "--kernel2-size", type=int, default=16)
    p.add_argument("-k3s", "--kernel3-size", type=int, default=16)
    p.add_argument("-ws", "--window-size", type=int, default=16)
    p.add_argument("-wsh", "--window-size-height", type=int, default=None)
    p.add_argument("-nl", "--num-layers", type=int, default=2, choices=(1, 2, 3))
    p.add_argument("-s2", "--layer-two-size", type=int, default=8)
    p.add_argument("-s2c", "--layer-two-connections", type=int, default=4,
                   help="sparse fan-in of layer 2 (random connection map "
                        "when != layer-two-size)")
    p.add_argument("-s3", "--layer-three-size", type=int, default=8)
    p.add_argument("-s3c", "--layer-three-connections", type=int, default=4,
                   help="sparse fan-in of layer 3")
    p.add_argument("-ms", "--multiscale", type=int, default=0,
                   help="number of scales (0 disables)")
    p.add_argument("-sf", "--share-filters", action="store_true")
    p.add_argument("-lw", "--load-weights", default=None)
    p.add_argument("--resume", action="store_true",
                   help="continue an interrupted run: load weights and score "
                        "history from the output checkpoint (same flags -> "
                        "same model dir) and train only the remaining "
                        "epochs; the optimizer's lr-decay step count is "
                        "fast-forwarded, the patch-sampling rng is not")
    p.add_argument("-mstw", "--multiscale-trainable-weights", action="store_true")
    p.add_argument("-mssb", "--multiscale-single-beta", action="store_true")
    p.add_argument("-oem", "--output-extraction-method", default="max",
                   choices=("max", "mean"))
    # learning
    p.add_argument("-n", "--n-train-set", type=int, default=2000)
    p.add_argument("-m", "--n-test-set", type=int, default=1000)
    p.add_argument("-mni", "--n-images-test-set", type=int, default=2)
    p.add_argument("-e", "--num-epochs", type=int, default=10)
    p.add_argument("-r", "--learning-rate", type=float, default=5e-3)
    p.add_argument("-lrd", "--learning-rate-decay", type=float, default=5e-7)
    p.add_argument("-wd", "--weight-decay", type=float, default=0.0)
    p.add_argument("-rn", "--renew-train-set", action="store_true")
    p.add_argument("-st", "--soft-targets", type=float, default=None,
                   help="gaussian targets, value = sigma^2")
    p.add_argument("-gtws", "--gt-window-size", type=int, default=16)
    # input
    p.add_argument("-rd", "--root-directory", default="data/")
    p.add_argument("-fi", "--first-image", type=int, default=0)
    p.add_argument("-d", "--delta", type=int, default=1)
    p.add_argument("-ni", "--num-input-images", type=int, default=10)
    p.add_argument("-mc", "--motion-correction", default="sfm",
                   choices=("none", "mc", "sfm"),
                   help="rectification: sfm (essential-matrix ego-motion), "
                        "mc (4-DoF RANSAC homography), none")
    p.add_argument("-gt", "--groundtruth", default="cross-correlation",
                   choices=("cross-correlation", "cc-mean", "liu"),
                   help="GT generator: exhaustive matching with WTA "
                        "(cross-correlation) or soft-argmax (cc-mean) "
                        "decode, or the variational solver (liu)")
    p.add_argument("-nci", "--n-channels-in", type=int, default=3)
    p.add_argument("-cal", "--calibration", default="ardrone",
                   help="calibration preset name")
    p.add_argument("-bs", "--batch-size", type=int, default=32)
    p.add_argument("--dp", default="auto", metavar="auto|off|N",
                   help="data-parallel device mesh: 'auto' engages every "
                        "visible card when there is more than one "
                        "(training batches sharded with replicated weights, "
                        "the replicas' gradients summed before the update, "
                        "and the rectification/GT dataset build split "
                        "across the mesh); 'off' stays on one device; N "
                        "uses the first N cards (N CPU shards with --device "
                        "cpu). Batch size must divide by the mesh size.")
    p.add_argument("--device", default="cuda",
                   help="torch device to run on (default cuda; 'cpu' runs "
                        "the kernels' plain versions)")
    # output
    p.add_argument("-omd", "--output-model-dir", default="models")
    return p


def geometry_from_args(args):
    """The trainer's Geometry: 180x320 frames, the conv stack of the
    layer flags (layer 2+'s first element is its sparse fan-in), the
    window, and the multiscale ratios with the window divided by the
    coarsest ratio. The liu GT takes the model's kernel as its own."""
    from ..geometry import Geometry

    nci, nf = args.n_channels_in, args.n_features
    k1, k2, k3 = args.kernel1_size, args.kernel2_size, args.kernel3_size
    if args.num_layers == 1:
        layers = ((nci, k1, k1, nf),)
    elif args.num_layers == 2:
        layers = ((nci, k1, k1, args.layer_two_size),
                  (args.layer_two_connections, k2, k2, nf))
    else:
        layers = ((nci, k1, k1, args.layer_two_size),
                  (args.layer_two_connections, k2, k2, args.layer_three_size),
                  (args.layer_three_connections, k3, k3, nf))

    maxw_hr = args.window_size
    maxh_hr = args.window_size_height or args.window_size
    if args.multiscale == 0:
        multiscale, ratios = False, (1,)
        maxw, maxh = maxw_hr, maxh_hr
    else:
        multiscale = True
        ratios = tuple(2 ** i for i in range(args.multiscale))
        maxw = math.ceil(maxw_hr / ratios[-1])
        maxh = math.ceil(maxh_hr / ratios[-1])

    g = Geometry(
        hImg=180, wImg=320,
        layers=layers, maxh=maxh, maxw=maxw,
        maxhGT=args.gt_window_size, maxwGT=args.gt_window_size,
        hKernelGT=16, wKernelGT=16,
        multiscale=multiscale, ratios=ratios,
        share_filters=args.share_filters,
        cascad_trainable_weights=args.multiscale_trainable_weights,
        single_beta=args.multiscale_single_beta,
        output_extraction_method=args.output_extraction_method,
    )
    if args.groundtruth == "liu":
        g = dataclasses.replace(g, hKernelGT=g.hKernel, wKernelGT=g.wKernel)
    elif g.maxwGT < g.maxw or g.maxhGT < g.maxh:
        raise ValueError(f"the GT window {g.maxhGT}x{g.maxwGT} must cover "
                         f"the model's {g.maxh}x{g.maxw}")
    g.validate()
    return g


def learning_from_args(args):
    from ..geometry import Learning
    return Learning(
        rate=args.learning_rate,
        rate_decay=args.learning_rate_decay,
        weight_decay=args.weight_decay,
        n_epochs=args.num_epochs,
        criterion=("mse" if args.output_extraction_method == "mean"
                   else ("soft" if args.soft_targets is not None else "nll")),
        soft_targets=args.soft_targets is not None,
        st_sigma2=args.soft_targets or 1.0,
        batch_size=args.batch_size,
    )


@full_f32()
def main(argv=None) -> int:
    args = build_parser().parse_args(argv)

    from ..data import datasets as ds_mod
    from ..geometry3d import calibration as calmod
    from ..models import io as model_io
    from ..training import train as training
    from ..training.curves import score_epoch
    from ..utils.device import resolve

    dev = resolve(args.device)
    geom = geometry_from_args(args)
    lrn = learning_from_args(args)
    if geom.cascad_trainable_weights:
        print("WARNING: -mstw enables the CascadingAddTable beta path, which "
              "the reference ships commented out of its forward. At the "
              "reference init (weights -1) the fused scores are negative, so "
              "the Log2+NLL head saturates and the betas receive zero "
              "gradient: the design's own pathology, reproduced faithfully.")
    cal = calmod.PRESETS[args.calibration]
    print(model_io.model_dir_name(geom, lrn))

    # --dp: the dataset build and the training both shard over the mesh
    from ..parallel import mesh as pm
    mesh = pm.auto_mesh(args.dp, dev)
    if mesh is not None:
        print(f"dp mesh: {mesh.size} devices ({mesh.platform})")

    # consecutive frames and their GT (cached under the dataset root)
    raw = ds_mod.load_data_optical_flow(
        geom, cal, args.root_directory, args.num_input_images,
        first=args.first_image, delta=args.delta,
        cache_root=args.root_directory,
        motion_correction=(None if args.motion_correction == "none"
                           else args.motion_correction),
        groundtruth=args.groundtruth, device=dev, mesh=mesh)
    images = raw["warped_images"]
    currents = raw["images"]
    flows = raw["flow"]
    masks = raw["masks"]
    # the samplers see (warped previous -> current) pairs
    seq_images, seq_flows, seq_masks = [], [], []
    for k in range(len(flows)):
        seq_images.extend([images[k], currents[k]])
        seq_flows.extend([flows[k], None])
        seq_masks.extend([masks[k], None])
    seq_flows = seq_flows[:-1]
    seq_masks = seq_masks[:-1]

    # the patch sets are drawn first in every run, so that a multiscale
    # run's foveas come from the same point of the stream
    rng = np.random.RandomState(0)
    sampler = training.sample_patches
    train_ds = sampler(geom, lrn, seq_images, seq_flows, seq_masks,
                       args.n_train_set, rng)
    test_ds = sampler(geom, lrn, seq_images, seq_flows, seq_masks,
                      args.n_test_set, rng)
    if geom.multiscale:
        trainer = training.MultiscaleTrainer(geom, lrn, device=dev)
        sampler = training.sample_foveas
        train_ds = sampler(geom, lrn, seq_images, seq_flows, seq_masks,
                           args.n_train_set, rng)
        test_ds = sampler(geom, lrn, seq_images, seq_flows, seq_masks,
                          args.n_test_set, rng)
    else:
        trainer = training.Trainer(geom, lrn, device=dev)
    if mesh is not None:
        trainer.use_mesh(mesh)
    trainer.init(torch.Generator().manual_seed(0))
    if args.load_weights:
        model_io.load_weights_into(args.load_weights, trainer.model)

    out_dir = os.path.join(args.output_model_dir,
                           model_io.model_dir_name(geom, lrn))
    history = []
    start_epoch = 0
    if args.resume and os.path.exists(os.path.join(out_dir, "meta.json")):
        _, _, saved, meta = model_io.load_model(out_dir)
        model_io.load_tree_into(trainer.model, saved)
        history = list(meta.get("score", []))
        start_epoch = len(history)
        # the lr-decay count where the interrupted run left it: one a step,
        # the epochs dropping their last partial batch
        trainer.optimizer.count = (args.n_train_set // lrn.batch_size
                                   * start_epoch)
        print(f"resume: {out_dir} at epoch {start_epoch} "
              f"({args.num_epochs - start_epoch} remaining)")
    for epoch in range(start_epoch, args.num_epochs):
        if args.renew_train_set and epoch > 0:
            train_ds = sampler(geom, lrn, seq_images, seq_flows, seq_masks,
                               args.n_train_set, rng)
        got = trainer.epoch(train_ds, shuffle_rng=rng)
        metrics = {"loss": got["loss"], "acc": got["acc"]}
        if geom.multiscale:
            score = {"test_acc": metrics["acc"], "test_err": metrics["loss"]}
        else:
            # full-image scores on the pairs the GT belongs to: (warped
            # previous, current)
            score = score_epoch(trainer.model, geom, lrn, test_ds,
                                list(zip(images, currents)), flows,
                                args.n_images_test_set)
        score.update(metrics, epoch=epoch)
        history.append(score)
        print(f"epoch {epoch}: train loss {metrics['loss']:.4f} "
              f"acc {metrics['acc']:.3f} | test acc {score['test_acc']:.3f} "
              f"meanErr {score['test_err']:.4f}")
        model_io.save_model(out_dir, geom, lrn, trainer.model, history, epoch)
    return 0


if __name__ == "__main__":
    sys.exit(main())
