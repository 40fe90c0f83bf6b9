"""Trained-model precision table and quality scores (the port's counterpart
of the precision and quality functions of ``examples/quality_dossier.py``,
under the same names).

The reduced-precision options of the matchers and of the multiscale
staged decode are held to a budget of 0.1 px mean end-point error (EPE)
against the all-f32 path, on a trained model and real imagery. This module
measures that table with the port's own kernels on whatever device it is
given: on the card the bf16 and f16 rows go through kernels B1 and B2, on
the CPU through their plain twins.

  ``bf16_epe_deltas``        the single-scale rows: B1 and B2 at f32, bf16
                             and f16 feature storage, and the trunk in bf16
                             feeding each matcher in bf16
  ``multiscale_bf16_delta``  the multiscale staged decode at bf16 and f16,
                             with its WTA agreement
  ``make_warp_sequence``     a sequence of shifted crops with analytic flow
                             (``SHIFTS``), cut from ``examples/car_frame1.png``
  ``train``                  the training CLI (``cli/opticalflow.main``) at
                             the dossier's flags, on the ``dossier320x180``
                             calibration
  ``multiscale_quality``     train (or reuse) the multiscale model at the
                             dossier's multiscale settings and score it on
                             the held-out pair against the analytic flow

Run (writes ``DIR/precision_table.json``; nothing else of the repo):

    python -m depth_estimation_tpu_torch.quality --out DIR [--device cpu]

``--train-ms-epochs N`` first trains a multiscale checkpoint under
``DIR/models_multiscale_ccGT`` and scores it (at the dossier's settings;
the committed ``examples/torch_multiscale_model`` was made this way).
Without ``--device`` it runs on the card and raises where there is none.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import os
import time
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent.parent
EXAMPLES = ROOT / "examples"
CAR_MODEL = EXAMPLES / "car_model"
MS_MODEL = EXAMPLES / "torch_multiscale_model"
CAR_FRAME1 = EXAMPLES / "car_frame1.png"
CAR_WARPED = EXAMPLES / "car_warped.png"
H, W = 180, 320


def _register_dossier_cal():
    """Idempotently register the 320x180 dossier calibration preset."""
    from .geometry3d import calibration as calmod
    if "dossier320x180" not in calmod.PRESETS:
        calmod.PRESETS["dossier320x180"] = dataclasses.replace(
            calmod.RECTIFIED_GOPRO_SMALL, name="dossier320x180",
            wImg=320, hImg=180, cx=160.0, cy=90.0)


# per-transition shifts (dy, dx): varying, so that the matching task is not
# trivial (a constant shift would make every patch the same class); all
# within the 16x16 window's centred range [-7, 8]
SHIFTS = [(1, 2), (0, -3), (2, 1), (-1, 3), (3, -2), (0, 4), (1, 2)]


def make_warp_sequence(out_dir: str, n: int = 8, source=CAR_FRAME1):
    """Shifted 180x320 crops of ``source`` (scaled to (180 + my, 320 + mx),
    the margins the shifts need): frame k+1's content is frame k's shifted
    by SHIFTS[k], so the true flow of pair k is SHIFTS[k] everywhere
    (img1[y, x] == img2[y + dy, x + dx]). Writes ``out_dir/images/
    %09d.png``. Returns (out_dir, true flow (2, 180, 320) of the last
    pair)."""
    from .data.images import encode_png, load_image, scale_np

    shifts = SHIFTS[:n - 1]
    # cumulative crop offsets, back from the last frame
    offs = [(0, 0)]
    for dy, dx in reversed(shifts):
        offs.insert(0, (offs[0][0] + dy, offs[0][1] + dx))
    oy = [o[0] for o in offs]
    ox = [o[1] for o in offs]
    my = max(oy) - min(oy) + 8
    mx = max(ox) - min(ox) + 8
    big = scale_np(load_image(str(source)), H + my, W + mx)
    d = os.path.join(out_dir, "images")
    os.makedirs(d, exist_ok=True)
    for i in range(n):
        off_y = 4 + oy[i] - min(oy)
        off_x = 4 + ox[i] - min(ox)
        im = big[off_y:off_y + H, off_x:off_x + W]
        with open(os.path.join(d, f"{i:09d}.png"), "wb") as f:
            f.write(encode_png((np.clip(im, 0, 1) * 255).astype(np.uint8)))
    flow = np.zeros((2, H, W), np.float32)
    flow[0] = shifts[-1][0]
    flow[1] = shifts[-1][1]
    return out_dir, flow


def read_frame(root: str, k: int) -> np.ndarray:
    """Frame k of a sequence: (180, 320, 3) float32 in [0, 1]."""
    from .data.images import load_image
    return load_image(os.path.join(root, "images", f"{k:09d}.png"))


def car_pair():
    """The repo's car pair, ``car_frame1.png`` / ``car_warped.png``, each
    scaled to 180x320."""
    from .data.images import load_image, scale_np
    return tuple(scale_np(load_image(str(p)), H, W)
                 for p in (CAR_FRAME1, CAR_WARPED))


def train(root: str, out: str, epochs: int, gt: str, multiscale: int = 0,
          n_frames: int = 8, n_train: int = 3000, lr: float = 0.02,
          share_filters: bool = True, n_features: int = 10,
          kernel1: int = None, num_layers: int = 1, kernel2: int = 16,
          layer_two_size: int = 8, layer_two_connections: int = 4,
          soft_targets: float = None, resume: bool = False,
          device="cuda"):
    """Train through ``cli/opticalflow.main`` on the sequence under
    ``root`` into ``out``; returns the checkpoint directory."""
    from .cli import opticalflow

    _register_dossier_cal()
    if kernel1 is None:
        kernel1 = 16 if not multiscale else 5
    args = [
        "--root-directory", root,
        "--num-input-images", str(n_frames),
        "--n-train-set", str(n_train), "--n-test-set",
        str(max(n_train // 4, 64)),
        "--num-epochs", str(epochs),
        "--n-features", str(n_features),
        "--kernel1-size", str(kernel1),
        "--num-layers", str(num_layers),
        "--kernel2-size", str(kernel2),
        "--layer-two-size", str(layer_two_size),
        "--layer-two-connections", str(layer_two_connections),
        "--window-size", "16",
        "--gt-window-size", "16",
        "--learning-rate", str(lr),
        "--batch-size", "32",
        "--calibration", "dossier320x180",
        "--motion-correction", "none",
        "--groundtruth", gt,
        "--renew-train-set",
        "--output-model-dir", out,
        "--device", str(device),
    ]
    if multiscale:
        args += ["--multiscale", str(multiscale)]
        if share_filters:
            args += ["--share-filters"]
    if soft_targets is not None:
        args += ["--soft-targets", str(soft_targets)]
    if resume:
        args += ["--resume"]
    rc = opticalflow.main(args)
    if rc != 0:
        raise RuntimeError(f"opticalflow.main returned {rc}")
    (name,) = os.listdir(out)
    return os.path.join(out, name)


def _flow_model(geom, params, device):
    from .models import io as mio
    from .models.flow import FlowModel
    model = FlowModel(geom, device=device)
    mio.load_tree_into(model, params)
    return model


def _multiscale_model(geom, params, decode_dtype, device):
    from .models import io as mio
    from .models.multiscale import MultiscaleFlowModel
    model = MultiscaleFlowModel(geom, decode_dtype=decode_dtype,
                                device=device)
    mio.load_tree_into(model, params)
    return model


def _image(img, device, dtype=torch.float32):
    return torch.as_tensor(np.asarray(img, np.float32)).to(device, dtype)


def full_image_scores(model, geom, img1, img2, gts):
    """Decode a full frame through ``model.scores`` (the port's models
    hold their weights) and score it against each GT field. Returns
    (scores by GT name, the (2, H, W) flow)."""
    from .models import flow as flow_model
    from .training import score as score_mod

    dev = next(model.parameters()).device
    with torch.no_grad():
        dist = model.scores(_image(img1, dev), _image(img2, dev))
    dec = flow_model.process_output(geom, dist, process_full=True)
    full = dec.full.cpu().numpy()
    out = {}
    for name, gt in gts.items():
        if gt is None:
            continue
        s = score_mod.eval_flow(geom, full, gt)
        out[name] = {"full_acc": s.accuracy, "meanDst": s.mean_dst,
                     "stdDst": s.std_dst}
    return out, full


def _delta_row(flow, ref):
    d = np.sqrt(((flow - ref) ** 2).sum(0))
    return {"mean_epe_delta_px": float(d.mean()),
            "p99_epe_delta_px": float(np.percentile(d, 99)),
            "max_epe_delta_px": float(d.max()),
            "finite": bool(np.isfinite(flow).all())}


# the single-scale rows: (name, matcher, feature storage, trunk in bf16)
EPE_ROWS = (
    ("fused_bf16", "fused", torch.bfloat16, False),
    ("fused_f16", "fused", torch.float16, False),
    ("fast_f32", "fast", torch.float32, False),
    ("fast_bf16", "fast", torch.bfloat16, False),
    ("fast_f16", "fast", torch.float16, False),
    ("trunk_bf16_fast_bf16", "fast", torch.bfloat16, True),
    ("trunk_bf16_fused_bf16", "fused", torch.bfloat16, True),
)


def bf16_epe_deltas(geom, params, img1, img2, device="cuda"):
    """EPE between the f32 fused decode (B1 at f32 storage) and each
    reduced-precision option of ``EPE_ROWS``, on one (180, 320, 3) pair:
    mean, 99th percentile and max over the matched pixels, and whether the
    option's flow is finite. ``params``: the flax-layout tree
    ``models.io.load_model`` returns. The trunk-in-bf16 rows feed the
    images in bf16, so the convolutions run in bf16 and the matcher reads
    bf16 features."""
    from .models.flow import crop_features_center
    from .ops import matching

    model = _flow_model(geom, params, device)
    dev = next(model.parameters()).device

    def feats(dtype):
        a = model.features(_image(img1, dev, dtype))
        b = model.features(_image(img2, dev, dtype))
        return crop_features_center(geom, a), b

    f32 = feats(torch.float32)
    bf = None

    def flow_of(kind, dtype, pair):
        if kind == "fused":
            out = matching.match_flow_fused(*pair, geom.maxh, geom.maxw, 8,
                                            False, dtype)
        else:
            out = matching.match_flow_fast(*pair, geom.maxh, geom.maxw, 32,
                                           dtype)
        return np.stack([out[1].cpu().numpy(), out[2].cpu().numpy()])

    ref = flow_of("fused", torch.float32, f32)
    outs = {}
    for name, kind, dtype, trunk_bf16 in EPE_ROWS:
        if trunk_bf16 and bf is None:
            bf = feats(torch.bfloat16)
        outs[name] = _delta_row(flow_of(kind, dtype, bf if trunk_bf16
                                        else f32), ref)
    return outs


def multiscale_bf16_delta(geom, params, img1, img2, device="cuda"):
    """Multiscale staged decode (``decode_full``): the WTA flow at bf16 and
    f16 feature storage against f32 (the decode is WTA, so the delta is
    the L2 of the decoded integer displacements), with the share of equal
    WTA indices."""
    from . import codecs

    def decode(dtype):
        m = _multiscale_model(geom, params, dtype, device)
        dev = next(m.parameters()).device
        idx, _ = m.decode_full(_image(img1, dev), _image(img2, dev))
        wy, wx = codecs.decode(geom, idx)
        return idx.cpu().numpy(), np.stack([wy.cpu().numpy(),
                                            wx.cpu().numpy()]).astype(
                                                np.float32)

    idx32, fl32 = decode(None)
    outs = {}
    for name, dtype in (("multiscale_staged_bf16", torch.bfloat16),
                        ("multiscale_staged_f16", torch.float16)):
        idx, fl = decode(dtype)
        row = _delta_row(fl, fl32)
        row["wta_agreement"] = float((idx == idx32).mean())
        outs[name] = row
    return outs


# the dossier's multiscale settings (examples/quality_dossier.py
# _ms_variant_quality): 3 scales, shared 5x5 filters, 10 features, 16x16
# window, B=32, lr 0.02, 3000 patches an epoch, cross-correlation GT, no
# motion correction, 8 frames
MS_EPOCHS = 400


def score_multiscale(mpath: str, root: str, true_flow, n_frames: int = 8,
                     device="cuda"):
    """The multiscale checkpoint's training history and its full-image
    decode of the held-out pair (n_frames - 2 -> n_frames - 1) scored
    against the analytic flow."""
    from . import codecs
    from .models import io as mio
    from .training import score as score_mod

    geom, _, params, meta = mio.load_model(mpath)
    hist = meta["score"]
    f6 = read_frame(root, n_frames - 2)
    f7 = read_frame(root, n_frames - 1)
    m = _multiscale_model(geom, params, None, device)
    dev = next(m.parameters()).device
    idx, _ = m.decode_full(_image(f6, dev), _image(f7, dev))
    wy, wx = codecs.decode(geom, idx)
    full = np.stack([wy.cpu().numpy(), wx.cpu().numpy()]).astype(np.float32)
    s = score_mod.eval_flow(geom, full, true_flow)
    return {"epochs": len(hist),
            "final_patch_acc": hist[-1]["test_acc"],
            "best_patch_acc": max(h["test_acc"] for h in hist),
            "history_test_acc": [h["test_acc"] for h in hist],
            "full_acc_analytic": s.accuracy,
            "meanDst_analytic": s.mean_dst}


def multiscale_quality(work: str, epochs: int = MS_EPOCHS, n_frames: int = 8,
                       n_train: int = 3000, device="cuda"):
    """Train the multiscale model at the dossier's settings on the warp
    sequence under ``work/seq`` into ``work/models_multiscale_ccGT`` (or
    resume a shorter run there) and score it (``score_multiscale``).
    Returns (checkpoint directory, scores, training seconds)."""
    root, true_flow = make_warp_sequence(os.path.join(work, "seq"),
                                         n=n_frames)
    mdir = os.path.join(work, "models_multiscale_ccGT")
    t0 = time.perf_counter()
    resume = bool(os.path.isdir(mdir) and os.listdir(mdir))
    mpath = train(root, mdir, epochs, "cross-correlation", multiscale=3,
                  n_frames=n_frames, n_train=n_train, resume=resume,
                  device=device)
    seconds = time.perf_counter() - t0
    return mpath, score_multiscale(mpath, root, true_flow, n_frames,
                                   device), seconds


def _device_line(device) -> str:
    """nvidia-smi's name and power limit of the card, or "cpu"."""
    if torch.device(device).type != "cuda":
        return "cpu"
    from .benchmarks.device_peaks import card_line
    return card_line()


def precision_table(out: str, device="cuda", ms_model=MS_MODEL,
                    n_frames: int = 8):
    """Every precision row on both pairs: the car pair and the warp
    sequence's held-out pair, single-scale on ``examples/car_model`` and
    multiscale on ``ms_model``; and ``ms_model``'s scores on the held-out
    pair."""
    from .models import io as mio
    from .utils.device import resolve

    dev = resolve(device)
    root, true_flow = make_warp_sequence(os.path.join(out, "seq"),
                                         n=n_frames)
    pairs = {"car_pair": car_pair(),
             "seq_pair": (read_frame(root, n_frames - 2),
                          read_frame(root, n_frames - 1))}
    geom, _, params, _ = mio.load_model(str(CAR_MODEL))
    ms_geom, _, ms_params, _ = mio.load_model(str(ms_model))
    table = {"device": _device_line(dev), "torch": torch.__version__,
             "models": {"single_scale": str(CAR_MODEL.relative_to(ROOT)),
                        "multiscale": os.path.relpath(ms_model, ROOT)}}
    for key, (a, b) in pairs.items():
        rows = bf16_epe_deltas(geom, params, a, b, device=dev)
        rows.update(multiscale_bf16_delta(ms_geom, ms_params, a, b,
                                          device=dev))
        table[f"bf16_deltas_{key}"] = rows
    table["multiscale_scores"] = score_multiscale(str(ms_model), root,
                                                  true_flow, n_frames, dev)
    return table


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", required=True,
                    help="work directory; the table goes to "
                         "OUT/precision_table.json")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the "
                         "kernels' plain versions)")
    ap.add_argument("--train-ms-epochs", type=int, default=None,
                    help="first train a multiscale checkpoint for this "
                         "many epochs under OUT and use it")
    args = ap.parse_args(argv)
    os.makedirs(args.out, exist_ok=True)
    ms_model, trained = MS_MODEL, None
    if args.train_ms_epochs is not None:
        ms_model, scores, seconds = multiscale_quality(
            args.out, args.train_ms_epochs, device=args.device)
        trained = {"checkpoint": ms_model, "seconds": seconds, **scores}
        print(json.dumps({"trained": trained}), flush=True)
    table = precision_table(args.out, args.device, ms_model)
    if trained is not None:
        table["trained"] = trained
    path = os.path.join(args.out, "precision_table.json")
    with open(path, "w") as f:
        json.dump(table, f, indent=1)
    print(json.dumps(table))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
