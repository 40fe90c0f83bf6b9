"""Per-epoch scoring and learning curves (port of
``depth_estimation_tpu.training.curves``).

``score_epoch``: patch accuracy (exact index) and mean NLL on a held-out
patch set, and full-image accuracy and mean distance on a few frame pairs.
``get_learning_scores`` / ``backfill_scores`` read and repair the score
histories of checkpoint directories; ``plot_learning_curves`` draws them
(matplotlib, imported only there); ``sweep_thresholds`` is the confidence
threshold sweep of full-image decoding. The models hold their weights, so
no ``params`` argument is taken.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional

import numpy as np
import torch

from ..geometry import Geometry, Learning
from ..models import flow as flow_model
from ..utils.device import host
from . import score as score_mod


def _device(model) -> torch.device:
    return next(model.parameters()).device


@torch.no_grad()
def score_epoch(model: flow_model.FlowModel, geom: Geometry, lrn: Learning,
                test_ds, pairs: Optional[list] = None,
                flows: Optional[list] = None, n_images: int = 2) -> Dict:
    """Returns {'test_acc', 'test_err'} and, given ``pairs`` ((im1, im2)
    frame pairs) and ``flows`` (``flows[k]`` the GT of ``pairs[k]``),
    'full_acc' and 'full_meandst' over the first ``n_images``. For the
    rectified datasets a pair is (warped previous, current): the pairing
    the GT was computed on."""
    dev = _device(model)
    tp1 = torch.as_tensor(test_ds.patches1, device=dev)
    tp2 = torch.as_tensor(test_ds.patches2, device=dev)
    logp = model.log_scores(tp1, tp2)
    logp = logp.reshape(logp.shape[0], -1).cpu().numpy()
    it = np.asarray(test_ds.itargets)
    out: Dict = {"test_acc": float((logp.argmax(-1) == it).mean()),
                 "test_err": float(-logp[np.arange(len(it)), it].mean())}
    if pairs and flows:
        accs, dsts = [], []
        for k in range(min(n_images, len(flows))):
            if flows[k] is None:
                continue
            im1, im2 = (torch.as_tensor(np.asarray(im), dtype=torch.float32,
                                        device=dev) for im in pairs[k])
            dec = flow_model.process_output(geom, model.scores(im1, im2),
                                            process_full=True)
            s = score_mod.eval_flow(geom, dec.full, flows[k])
            accs.append(s.accuracy)
            dsts.append(s.mean_dst)
        if accs:
            out["full_acc"] = float(np.mean(accs))
            out["full_meandst"] = float(np.mean(dsts))
    return out


def get_learning_scores(models_dir: str) -> Dict[str, List[Dict]]:
    """Score histories of the checkpoint directories under models_dir."""
    curves = {}
    for name in sorted(os.listdir(models_dir)):
        meta_path = os.path.join(models_dir, name, "meta.json")
        if os.path.exists(meta_path):
            with open(meta_path) as f:
                meta = json.load(f)
            if meta.get("score"):
                curves[name] = meta["score"]
    return curves


def backfill_scores(models_dir: str, test_ds, images: Optional[list] = None,
                    flows: Optional[list] = None, n_images: int = 2,
                    device="cuda") -> List[str]:
    """For each single-scale checkpoint under ``models_dir`` whose score
    history is empty: rebuild the model on ``device``, score it
    (``score_epoch``) on the given test set and rewrite its meta.json.
    ``images``/``flows`` are a plain sequence (``flows[k]`` maps images[k]
    to images[k+1]). Returns the repaired directory names."""
    from ..models import io as model_io
    pairs = ([(images[k], images[k + 1]) for k in range(len(images) - 1)]
             if images else None)
    fixed = []
    for name in sorted(os.listdir(models_dir)):
        path = os.path.join(models_dir, name)
        meta_path = os.path.join(path, "meta.json")
        if not os.path.exists(meta_path):
            continue
        with open(meta_path) as f:
            meta = json.load(f)
        if meta.get("score"):
            continue
        geom, lrn, params, meta = model_io.load_model(path)
        if geom.multiscale:
            continue   # multiscale scores come from the fovea trainer
        model = flow_model.FlowModel(geom, device=device)
        model.filter.load_state_dict(model_io.filter_state_from_jax(geom, params))
        score = score_epoch(model, geom, lrn, test_ds, pairs, flows, n_images)
        score["epoch"] = meta.get("epoch", 0)
        score["backfilled"] = True
        meta["score"] = [score]
        with open(meta_path, "w") as f:
            json.dump(meta, f, indent=1)
        fixed.append(name)
    return fixed


def plot_learning_curves(models_dir: str, out_path: str,
                         key: str = "test_acc") -> Optional[str]:
    """Curves of ``key`` across the checkpoints under models_dir, as a
    PNG at out_path (None where no checkpoint has a history)."""
    curves = get_learning_scores(models_dir)
    if not curves:
        return None
    import matplotlib
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig, ax = plt.subplots(figsize=(8, 5))
    for name, hist in curves.items():
        ys = [h.get(key) for h in hist if key in h]
        if ys:
            ax.plot(range(len(ys)), ys, label=name[:60])
    ax.set_xlabel("epoch")
    ax.set_ylabel(key)
    ax.legend(fontsize=6)
    fig.tight_layout()
    fig.savefig(out_path, dpi=120)
    plt.close(fig)
    return out_path


@torch.no_grad()
def sweep_thresholds(model: flow_model.FlowModel, geom: Geometry, pairs,
                     flows, thresholds=(0.0, 0.2, 0.4, 0.6, 0.8)) -> List[Dict]:
    """Per confidence threshold: the fraction of interior pixels kept and
    their accuracy. ``pairs[k]`` is the (im1, im2) pair ``flows[k]``
    belongs to, as in ``score_epoch``."""
    dev = _device(model)
    pairs_d = [tuple(torch.as_tensor(np.asarray(im), dtype=torch.float32,
                                     device=dev) for im in pr) for pr in pairs]
    hb, wb = score_mod.borders(geom)
    results = []
    for thr in thresholds:
        kept, good, total = 0, 0, 0
        for k in range(len(flows)):
            if flows[k] is None:
                continue
            dist = model.scores(*pairs_d[k])
            dec = flow_model.process_output(geom, dist, process_full=True,
                                            threshold=thr)
            conf = host(dec.full_confidences)[hb:-hb, wb:-wb]
            diff = np.abs(host(dec.full) - flows[k]).sum(0)[hb:-hb, wb:-wb]
            sel = conf > 0.5
            kept += int(sel.sum())
            good += int((diff[sel] == 0).sum())
            total += diff.size
        results.append({"threshold": float(thr),
                        "kept_frac": kept / max(total, 1),
                        "acc_at_kept": good / max(kept, 1)})
    return results
