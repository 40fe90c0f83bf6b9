"""Trainers of the radial, version2 and legacy depth families (the JAX
package trains them inside its CLIs: ``cli/train_radial.py``,
``cli/train_v2.py`` and ``cli/depth_estimation.py``).

  * ``RadialTrainer``: frames -> polar pairs with the projected GT
    (``data.datasets.load_polar_pairs_batched``) -> polar patches ->
    epochs of the nll of ``RadialFlowNetwork.log_scores`` ->
    ``e{N}.msgpack`` checkpoints;
  * ``V2Trainer``: a ``FlowDataset``'s cross-correlation patches -> epochs
    of the nll of ``V2Network.log_scores`` -> bare ``e{N}`` checkpoints;
  * ``DepthClassifierTrainer``: class-balanced patches of the sparse depth
    points (``data.depth_legacy``) -> epochs of softmax cross-entropy of
    ``DepthClassifierCNN`` with a confusion matrix and the held-out
    accuracy -> ``params.msgpack``; and the full-image class map.

Each trainer owns its model, built on ``device`` (the card unless the
caller passes ``device="cpu"``), and an ``SGDTorch`` optimizer. A step is
autograd's backward and the optimizer's update, with no NaN guard (the
reference applies these updates directly). The draws come from the
``np.random.RandomState`` the caller passes, in the reference's order:
the radial and version2 patches, then every epoch's permutation, from one
state; the legacy train and test sets, then every epoch's shuffle, from
another. An epoch reads its losses back from the card once, at its end.
"""

from __future__ import annotations

import json
import os
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..data import datasets
from ..data import depth_legacy
from ..data.images import ImageLoader
from ..geometry import Geometry, Learning
from ..geometry3d.calibration import Calibration
from ..models import io as mio
from ..models.legacy_depth import DepthClassifierCNN
from ..models.radial import RadialFlowNetwork
from ..models.version2 import V2Network, V2Params
from ..utils.precision import full_f32
from .train import sgd_torch

LEGACY_PATCH = 32


def read_frames(directory: str, h: int, w: int, n_images: int,
                delta: int = 1) -> List[np.ndarray]:
    """Up to ``n_images`` frames of ``directory/images/`` at (h, w), each
    ``delta`` after the one before (the frames between are skipped)."""
    loader = ImageLoader(directory, h, w)
    frames = []
    while len(frames) < n_images:
        for _ in range(delta - 1 if frames else 0):
            loader.get_next_frame()
        f = loader.get_next_frame()
        if f is None:
            break
        frames.append(f)
    return frames


class _NLLTrainer:
    """Epochs of the nll of a matcher's ``log_scores`` over a patch corpus
    (prev patches, curr patches, flat targets), in batches of
    ``batch_size`` drawn by ``rng.permutation``; a last partial batch is
    dropped."""

    def __init__(self, model, learning_rate: float,
                 learning_rate_decay: float, batch_size: int):
        self.model = model
        self.device = next(model.parameters()).device
        self.learning_rate = learning_rate
        self.learning_rate_decay = learning_rate_decay
        self.batch_size = batch_size
        self._dp_step = None
        self.reset_optimizer()

    def use_mesh(self, mesh, axis: str = "dp"):
        """Engage a device mesh (``parallel.mesh.Mesh``): each step splits
        its batch across the mesh and sums the replicas' gradients onto
        ``model`` before one update there
        (``parallel.mesh.sharded_train_step``), as the JAX radial CLI's
        ``--dp`` step does. The batch size must divide by the mesh size.
        Returns the trainer."""
        from ..parallel import mesh as pm
        if self.batch_size % mesh.size:
            raise SystemExit(f"batch size {self.batch_size} not divisible by "
                             f"the {mesh.size}-device mesh")
        self._dp_step = pm.sharded_train_step(self, mesh, axis, n_batch=3)
        return self

    def init(self, generator: torch.Generator):
        """Random weights from a CPU ``torch.Generator`` and a fresh
        optimizer. Returns the trainer."""
        self.model.init(generator)
        return self.reset_optimizer()

    def reset_optimizer(self):
        """A fresh optimizer (count 0) over the current weights."""
        self.optimizer = sgd_torch(self.model.parameters(), self.learning_rate,
                                   self.learning_rate_decay)
        return self

    def _loss(self, model, b1, b2, bt):
        """(nll, {"acc"}) of ``model`` (the trainer's model or a replica of
        it) on one batch."""
        logp = model.log_scores(b1, b2).reshape(b1.shape[0], -1)
        it = bt.long()
        loss = -logp.gather(1, it[:, None])[:, 0].mean()
        return loss, {"acc": (logp.argmax(-1) == it).float().mean()}

    def _update(self) -> Dict[str, torch.Tensor]:
        self.optimizer.step()
        return {}

    @full_f32()
    def step(self, b1: torch.Tensor, b2: torch.Tensor,
             bt: torch.Tensor) -> Dict[str, torch.Tensor]:
        """One SGD step on a batch of device tensors (split across the mesh
        after ``use_mesh``). Returns {"loss", "acc"} as device tensors."""
        if self._dp_step is not None:
            return self._dp_step(b1, b2, bt)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=False)
        loss, aux = self._loss(self.model, b1, b2, bt)
        loss.backward()
        return dict(aux, loss=loss.detach(), **self._update())

    @full_f32()
    def epoch(self, corpus: Tuple, rng: np.random.RandomState) -> Dict:
        """One pass over ``corpus`` = (p1, p2, targets) (numpy or device
        tensors). Returns the mean "loss" and "acc" (None without a full
        batch) and the per-step "losses" and "accs"."""
        p1, p2, ts = (torch.as_tensor(a, device=self.device) for a in corpus)
        bs = self.batch_size
        n = (len(ts) // bs) * bs
        order = rng.permutation(n)
        auxs = []
        for b in range(0, n, bs):
            sel = torch.as_tensor(order[b:b + bs], device=self.device)
            auxs.append(self.step(p1[sel], p2[sel], ts[sel]))
        got = {k: torch.stack([a[k] for a in auxs]).cpu().tolist() if auxs
               else [] for k in ("loss", "acc")}
        return {"loss": float(np.mean(got["loss"])) if auxs else None,
                "acc": float(np.mean(got["acc"])) if auxs else None,
                "losses": got["loss"], "accs": got["acc"]}

    def _save(self, directory: str, epoch: int) -> str:
        raise NotImplementedError

    @full_f32()
    def fit(self, corpus: Tuple, n_epochs: int, rng: np.random.RandomState,
            directory: Optional[str] = None) -> List[Dict]:
        """``n_epochs`` epochs over ``corpus`` (uploaded once), each
        followed by its checkpoint in ``directory`` (where given). Returns
        every epoch's result."""
        corpus = tuple(torch.as_tensor(a, device=self.device) for a in corpus)
        history = []
        for e in range(n_epochs):
            history.append(self.epoch(corpus, rng))
            if directory is not None:
                self._save(directory, e)
        return history


def radial_gt_geometry(cal: Calibration) -> Geometry:
    """The radial trainer's GT matcher at the calibration's full size: a
    16x16 window over 16x16 patches of raw pixels."""
    return Geometry(hImg=cal.hImg, wImg=cal.wImg, layers=((3, 16, 16, 768),),
                    maxh=16, maxw=16, maxhGT=16, maxwGT=16,
                    hKernelGT=16, wKernelGT=16)


class RadialTrainer(_NLLTrainer):
    """The radial net (``layers`` in the radial spec format, ``h_win``
    classes) trained on polar patches."""

    def __init__(self, layers: Sequence, h_win: int,
                 learning_rate: float = 1e-2,
                 learning_rate_decay: float = 1e-5, batch_size: int = 32,
                 device="cuda"):
        super().__init__(RadialFlowNetwork(layers, h_win, device=device),
                         learning_rate, learning_rate_decay, batch_size)

    @property
    def patch_shape(self) -> Tuple[int, int]:
        """(h_patch, w_patch): one matcher row a patch."""
        m = self.model
        return m.h_kernel + m.h_win - 1, m.w_kernel

    @full_f32()
    def load_pairs(self, cal: Calibration, frames: List[np.ndarray],
                   h_input: int = 200, w_input: int = 200,
                   max_flow: Optional[float] = None, scene_length: int = 0,
                   gt_frames: Optional[List[np.ndarray]] = None,
                   noise=None, mesh=None) -> List[datasets.PolarPair]:
        """The good polar pairs of consecutive ``frames`` (full size),
        with the GT of ``radial_gt_geometry`` saturated at ``max_flow``
        polar rows (default h_win - 1). ``scene_length`` > 0 drops the
        pairs that cross a boundary between scenes of that many frames.
        With ``gt_frames`` (index-aligned), geometry and GT come from
        them and the pixels from ``frames``. ``mesh`` splits the polar
        build and its GT across the mesh's devices."""
        if gt_frames is not None and len(gt_frames) != len(frames):
            raise ValueError(f"gt_frames are not index-aligned "
                             f"({len(gt_frames)} vs {len(frames)} frames)")
        if max_flow is None:
            max_flow = self.model.h_win - 1
        pairs = datasets.load_polar_pairs_batched(
            cal, gt_frames if gt_frames is not None else frames,
            cal.hImg, cal.wImg, h_input, w_input, self.model.w_kernel,
            geom_gt=radial_gt_geometry(cal), max_flow=max_flow,
            pixel_frames=frames if gt_frames is not None else None,
            noise=noise, device=self.device, mesh=mesh)
        sl = scene_length
        return [p for k, p in enumerate(pairs)
                if p.good and (not sl or k // sl == (k + 1) // sl)]

    @full_f32()
    def sample(self, pairs: List[datasets.PolarPair], n_train_set: int,
               rng: np.random.RandomState) -> Tuple[np.ndarray, ...]:
        """``n_train_set // len(pairs)`` patches from each pair. Returns
        (prev patches, curr patches, targets)."""
        h_patch, w_patch = self.patch_shape
        got = [datasets.generate_polar_training_patches(
                   pair, h_patch, w_patch, self.model.h_win,
                   n_train_set // len(pairs), rng) for pair in pairs]
        got = [g for g in got if g]
        if not got:
            raise ValueError("no polar patch passed the masks")
        return tuple(np.concatenate([g[k] for g in got]) for k in range(3))

    def _save(self, directory: str, epoch: int) -> str:
        return mio.save_radial_checkpoint(directory, self.model, epoch)


class V2Trainer(_NLLTrainer):
    """The version2 net trained on cross-correlation GT patches, at a
    constant rate."""

    def __init__(self, datap: V2Params = V2Params(),
                 learning_rate: float = 1e-2, batch_size: int = 32,
                 device="cuda"):
        super().__init__(V2Network(datap, device=device), learning_rate,
                         0.0, batch_size)

    @full_f32()
    def sample(self, cal: Calibration, directory: str, n_images: int,
               n_train_set: int, rng: np.random.RandomState,
               noise=None) -> Tuple[np.ndarray, ...]:
        """Patches of the first ``n_images`` frames of ``directory/images``
        (a ``FlowDataset`` whose GT is cached under ``directory``).
        Returns (prev patches, curr patches, flat targets)."""
        ds = datasets.FlowDataset(self.model.geometry, cal, directory,
                                  cache_root=directory, noise=noise,
                                  device=self.device)
        ds.names = ds.names[:n_images]
        p = ds.get_patches(n_train_set, rng, Learning())
        return p.patches1, p.patches2, p.itargets

    def _save(self, directory: str, epoch: int) -> str:
        return mio.save_v2_checkpoint(directory, self.model, epoch)


class DepthClassifierTrainer:
    """The legacy depth classifier on ``LEGACY_PATCH``-square patches of
    frame pairs (grayscale, stacked on channels), with the reference's
    fixed SGD (rate 1e-2, decay 5e-7)."""

    def __init__(self, n_classes: int = 2, batch_size: int = 32,
                 device="cuda"):
        self.model = DepthClassifierCNN(n_classes, device=device)
        self.device = next(self.model.parameters()).device
        self.n_classes = n_classes
        self.batch_size = batch_size
        self.discretizer: Optional[depth_legacy.DepthDiscretizer] = None
        self.history: List[Dict] = []
        self.reset_optimizer()

    def init(self, generator: torch.Generator):
        self.model.init(generator)
        return self.reset_optimizer()

    def reset_optimizer(self):
        self.optimizer = sgd_torch(self.model.parameters(), 1e-2, 5e-7)
        return self

    def make_datasets(self, frames: List[Dict], images: List[np.ndarray],
                      n_train: int, n_test: int, rng: np.random.RandomState,
                      cut_depth: Optional[float] = None) -> Tuple:
        """Class-balanced train and test sets, in that order from ``rng``;
        ``cut_depth`` overrides the discretizer's. Returns (train patches,
        train classes (1-based), test patches, test classes)."""
        train_p, train_c, disc = depth_legacy.generate_data_discrete(
            frames, images, LEGACY_PATCH, LEGACY_PATCH, self.n_classes,
            n_train, rng)
        test_p, test_c, _ = depth_legacy.generate_data_discrete(
            frames, images, LEGACY_PATCH, LEGACY_PATCH, self.n_classes,
            n_test, rng)
        if cut_depth is not None:
            disc.cut_depth = cut_depth
            disc.bin_step = int(2 * disc.cut_depth / disc.n_classes) or 1
        self.discretizer = disc
        return train_p, train_c, test_p, test_c

    @full_f32()
    def step(self, patches: torch.Tensor,
             classes0: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
        """One SGD step of the mean softmax cross-entropy of the 1x1
        logits against 0-based classes. Returns (loss, predicted classes)
        as device tensors."""
        self.model.train()
        self.optimizer.zero_grad(set_to_none=False)
        logits = self.model(patches)[:, 0, 0, :]
        loss = F.cross_entropy(logits, classes0.long())
        loss.backward()
        self.optimizer.step()
        return loss.detach(), logits.argmax(-1).detach()

    @full_f32()
    @torch.no_grad()
    def predict(self, patches) -> np.ndarray:
        """0-based classes of (N, 32, 32, 2) patches."""
        x = torch.as_tensor(patches, device=self.device)
        return self.model(x)[:, 0, 0, :].argmax(-1).cpu().numpy()

    @full_f32()
    def epoch(self, train_p, train_c: np.ndarray, test_p, test_c: np.ndarray,
              rng: np.random.RandomState) -> Dict:
        """One shuffled pass over the training set, then the test set's
        accuracy. Returns "loss", "train_acc" (the confusion matrix's
        trace share), "test_acc", "confusion" and the per-step
        "losses"."""
        bs = self.batch_size
        n = (len(train_c) // bs) * bs
        order = np.arange(n)
        rng.shuffle(order)
        xp = torch.as_tensor(train_p, device=self.device)
        c0 = torch.as_tensor(train_c - 1, device=self.device)
        losses, preds = [], []
        for b in range(0, n, bs):
            sel = order[b:b + bs]
            t = torch.as_tensor(sel, device=self.device)
            loss, pred = self.step(xp[t], c0[t])
            losses.append(loss)
            preds.append(pred)
        conf = np.zeros((self.n_classes, self.n_classes), np.int64)
        if preds:
            losses = torch.stack(losses).cpu().tolist()
            np.add.at(conf, (train_c[order] - 1,
                             torch.cat(preds).cpu().numpy()), 1)
        tacc = float((self.predict(test_p) == test_c - 1).mean())
        return {"loss": float(np.mean(losses)) if losses else None,
                "train_acc": float(np.trace(conf) / max(conf.sum(), 1)),
                "test_acc": tacc, "confusion": conf, "losses": losses}

    @full_f32()
    def fit(self, train_p, train_c, test_p, test_c, n_epochs: int,
            rng: np.random.RandomState) -> List[Dict]:
        """``n_epochs`` epochs (the training set uploaded once); appends
        each epoch's {"loss", "train_acc", "test_acc"} to ``history``.
        Returns every epoch's full result."""
        xp = torch.as_tensor(train_p, device=self.device)
        out = []
        for _ in range(n_epochs):
            m = self.epoch(xp, train_c, test_p, test_c, rng)
            out.append(m)
            self.history.append({k: m[k] for k in
                                 ("loss", "train_acc", "test_acc")})
        return out

    def save(self, directory: str) -> str:
        """``params.msgpack`` and the discretizer's ``meta.json``."""
        if self.discretizer is None:
            raise ValueError("no discretizer: call make_datasets() or load()")
        return mio.save_legacy_checkpoint(directory, self.model,
                                          self.discretizer, LEGACY_PATCH,
                                          self.history)

    @classmethod
    def load(cls, directory: str, batch_size: int = 32, device="cuda"):
        """A trainer holding a saved classifier and its discretizer."""
        with open(os.path.join(directory, "meta.json")) as f:
            meta = json.load(f)
        tr = cls(meta["n_classes"], batch_size, device)
        mio.load_weights_into(directory, tr.model)
        tr.discretizer = depth_legacy.DepthDiscretizer(
            meta["n_classes"], meta["cut_depth"], meta["bin_step"])
        tr.history = list(meta.get("score", []))
        return tr

    @full_f32()
    @torch.no_grad()
    def class_map(self, pair: np.ndarray) -> np.ndarray:
        """The per-pixel argmax class (0-based) of one (H, W, 2) pair, the
        classifier run fully convolutionally."""
        x = torch.as_tensor(pair[None], dtype=torch.float32, device=self.device)
        return self.model(x)[0].argmax(-1).cpu().numpy()

    def save_class_map(self, directory: str, index: int,
                       pair: np.ndarray) -> str:
        """``depth_classes_{index:09d}.npz`` (array ``classes``) in
        ``directory``. Returns its path."""
        path = os.path.join(directory, f"depth_classes_{index:09d}.npz")
        np.savez(path, classes=self.class_map(pair))
        return path
