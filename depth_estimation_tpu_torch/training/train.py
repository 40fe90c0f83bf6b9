"""Training (port of ``depth_estimation_tpu.training.train``): SGD with
torch optim.sgd's semantics, the three criteria, the patch and fovea
samplers, and the single-scale and multiscale trainers.

The JAX trainer jits a functional step over an optax state; here each
trainer owns its model (built on ``device``: the card unless the caller
passes ``device="cpu"``) and an ``SGDTorch`` optimizer, and a step is
autograd's backward through the plain ``match_ssd`` followed by the
optimizer's update. The update is the reference's exactly: lr_t = lr /
(1 + t decay) computed in float32, weight decay folded into the gradient,
then p + (-lr_t g). Where the gradients' sum is not finite the step zeroes
every gradient and still applies the update, so weight decay acts and the
count advances (``grad_ok`` reports it).

The samplers are host numpy with ``np.random.RandomState``, copied from
the reference, so a seed gives the same patches in both packages. A step
reads nothing back from the card; an epoch fetches its losses once, at
its end.
"""

from __future__ import annotations

import dataclasses
import math
from typing import Callable, Dict, Optional

import numpy as np
import torch

from .. import codecs
from ..geometry import Geometry, Learning
from ..models import flow as flow_model
from ..models.multiscale import MultiscaleFlowModel
from ..utils.device import host
from ..utils.precision import full_f32


# ---------------------------------------------------------------------------
# torch optim.sgd semantics
# ---------------------------------------------------------------------------

class SGDTorch(torch.optim.Optimizer):
    """lr_t = lr / (1 + t * decay); grad += wd * param; p += -lr_t * grad.
    ``count`` (t) advances once a step, shared by every parameter."""

    def __init__(self, params, learning_rate: float,
                 learning_rate_decay: float = 0.0, weight_decay: float = 0.0):
        super().__init__(params, dict(lr=learning_rate,
                                      lr_decay=learning_rate_decay,
                                      weight_decay=weight_decay))
        self.count = 0

    def current_lr(self, group) -> float:
        """This step's rate, in float32 arithmetic as the reference's."""
        f = np.float32
        return float(f(group["lr"]) / (f(1.0) + f(self.count)
                                       * f(group["lr_decay"])))

    @torch.no_grad()
    def step(self, closure=None):
        for group in self.param_groups:
            neg_lr = -self.current_lr(group)
            wd = group["weight_decay"]
            for p in group["params"]:
                if p.grad is None:
                    continue
                g = p.grad
                if wd:
                    g = g + p * wd
                p.add_(g * neg_lr)
        self.count += 1


def sgd_torch(params, learning_rate: float, learning_rate_decay: float = 0.0,
              weight_decay: float = 0.0) -> SGDTorch:
    return SGDTorch(params, learning_rate, learning_rate_decay, weight_decay)


def guarded_update(params, optimizer: SGDTorch) -> torch.Tensor:
    """The NaN guard, then the optimizer's step: where the sum of every
    gradient is not finite, zero them all (the update still runs). Returns
    the guard's flag as a device tensor (no host read)."""
    grads = [p.grad for p in params if p.grad is not None]
    ok = torch.isfinite(sum(g.sum() for g in grads))
    for g in grads:
        g.copy_(torch.where(ok, g, torch.zeros_like(g)))
    optimizer.step()
    return ok


# ---------------------------------------------------------------------------
# Criteria
# ---------------------------------------------------------------------------

def make_loss_fn(model: flow_model.FlowModel, learning: Learning) -> Callable:
    """loss(patch1 (B, h, w, c), patch2, itarget (B,), soft (B, D)) ->
    (scalar loss, {"acc"}). ``learning.criterion``: 'nll' (log-softmax
    likelihood of the target cell), 'soft' (cross-entropy against the
    normalized soft target) or 'mse' (squared error of the soft-argmax)."""
    g = model.geometry

    def nll(p1, p2, itarget, soft_t):
        logp = model.log_scores(p1, p2).reshape(p1.shape[0], -1)
        it = itarget.long()
        loss = -logp.gather(1, it[:, None])[:, 0].mean()
        acc = (logp.argmax(-1) == it).float().mean()
        return loss, {"acc": acc}

    def soft(p1, p2, itarget, soft_t):
        logp = model.log_scores(p1, p2).reshape(p1.shape[0], -1)
        t = soft_t / soft_t.sum(-1, keepdim=True).clamp(min=1e-8)
        loss = -(t * logp).sum(-1).mean()
        acc = (logp.argmax(-1) == itarget.long()).float().mean()
        return loss, {"acc": acc}

    def mse(p1, p2, itarget, soft_t):
        dist = model.scores(p1, p2).reshape(p1.shape[0], -1)
        ey, ex = flow_model.soft_argmax(g, dist)
        off = codecs.window_offsets(g).to(dist.device, torch.float32)
        it = itarget.long()
        e2 = (ey - off[it, 0]) ** 2 + (ex - off[it, 1]) ** 2
        return e2.mean(), {"acc": (e2 < 1.0).float().mean()}

    return {"nll": nll, "soft": soft, "mse": mse}[learning.criterion]


# ---------------------------------------------------------------------------
# Patch sampler
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class PatchDataset:
    """Sampled training patches with encoded targets. The patch center is
    offset by ceil(maxhGT/2) + ceil(hKernelGT/2) - 1 from the crop corner;
    samples whose GT flow leaves the search window, or whose mask fails at
    the kernel's corners, are rejected."""
    patches1: np.ndarray    # (N, hPatch2, wPatch2, C)
    patches2: np.ndarray
    targets_yx: np.ndarray  # (N, 2) raw GT displacement
    itargets: np.ndarray    # (N,) encoded flat window index

    def __len__(self):
        return len(self.itargets)


def _host_arrays(xs: Optional[list]) -> Optional[list]:
    if xs is None:
        return None
    return [None if x is None else host(x) for x in xs]


def sample_patches(
    geom: Geometry, learning: Learning,
    images: list, flows: list, masks: Optional[list],
    n_samples: int, rng: np.random.RandomState,
) -> PatchDataset:
    """images: list of (H, W, C); flows[i] = (2, H, W) GT flow from
    images[i] to images[i+1] (None where there is none); masks[i] an
    optional validity mask."""
    images = _host_arrays(images)
    flows = _host_arrays(flows)
    masks = _host_arrays(masks)
    hoff = -(-geom.maxhGT // 2) + -(-geom.hKernelGT // 2) - 1
    woff = -(-geom.maxwGT // 2) + -(-geom.wKernelGT // 2) - 1
    lo_h, hi_h, lo_w, hi_w = flow_model.window_bounds(geom)

    p1, p2, tyx, its = [], [], [], []
    hP, wP = geom.hPatch2, geom.wPatch2
    hk = -(-geom.hKernel // 2)
    wk = -(-geom.wKernel // 2)
    tries = 0
    while len(its) < n_samples and tries < n_samples * 200:
        tries += 1
        i = rng.randint(0, len(flows))
        if flows[i] is None:
            continue
        y0 = rng.randint(0, geom.hImg - geom.maxhGT - geom.hKernelGT - 1)
        x0 = rng.randint(0, geom.wImg - geom.maxwGT - geom.wKernelGT - 1)
        yc, xc = y0 + hoff, x0 + woff
        fy = flows[i][0][yc, xc]
        fx = flows[i][1][yc, xc]
        if not (lo_h <= fy <= hi_h and lo_w <= fx <= hi_w):
            continue
        if masks is not None and masks[i] is not None:
            m = masks[i]
            if not (m[yc - hk, xc - wk] > 0.5 and m[yc + hk, xc - wk] > 0.5
                    and m[yc + hk, xc + wk] > 0.5 and m[yc - hk, xc + wk] > 0.5):
                continue
        p1.append(images[i][y0:y0 + hP, x0:x0 + wP])
        p2.append(images[i + 1][y0:y0 + hP, x0:x0 + wP])
        tyx.append((fy, fx))
        its.append(int(codecs.encode_np(geom, fy, fx)))
    return PatchDataset(
        np.stack(p1).astype(np.float32), np.stack(p2).astype(np.float32),
        np.asarray(tyx, np.float32), np.asarray(its, np.int32),
    )


# ---------------------------------------------------------------------------
# Fovea sampler (multiscale)
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class FoveaDataset:
    """Fovea samples: the image pairs they come from, per-sample fovea
    centers and targets, and each sample's coarsest-scale footprint crops
    (the static-shape batch ``MultiscaleFlowModel.forward_fovea_batch``
    takes)."""
    images1: np.ndarray   # (N_img, H, W, C) warped previous frames
    images2: np.ndarray   # (N_img, H, W, C) current frames
    img_idx: np.ndarray   # (N,) int32 into the stacks
    ys: np.ndarray        # (N,) int32 fovea rows
    xs: np.ndarray        # (N,) int32 fovea cols
    targets_yx: np.ndarray
    itargets: np.ndarray
    crops1: np.ndarray = None   # (N, rmax*hPatch2, rmax*wPatch2, C)
    crops2: np.ndarray = None

    def __len__(self):
        return len(self.itargets)


def sample_foveas(
    geom: Geometry, learning: Learning,
    images: list, flows: list, masks: Optional[list],
    n_samples: int, rng: np.random.RandomState,
) -> FoveaDataset:
    """Like ``sample_patches`` but keeps fovea coordinates; rejects foveas
    whose coarsest-scale crop leaves the frame or whose GT leaves the
    coarsest window."""
    images = _host_arrays(images)
    flows = _host_arrays(flows)
    masks = _host_arrays(masks)
    if not geom.multiscale:
        raise ValueError("sample_foveas needs a multiscale geometry")
    lo_h, hi_h, lo_w, hi_w = flow_model.window_bounds(geom)
    Hc, Wc = geom.rmax * geom.hPatch2, geom.rmax * geom.wPatch2
    y_lo = math.ceil(Hc / 2) - 1
    x_lo = math.ceil(Wc / 2) - 1
    H, W = geom.hImg, geom.wImg

    i1, iy, ix, tyx, its = [], [], [], [], []
    img_map: Dict[int, int] = {}
    tries = 0
    while len(its) < n_samples and tries < n_samples * 300:
        tries += 1
        k = rng.randint(0, len(flows))
        if flows[k] is None:
            continue
        yc = rng.randint(y_lo, H - (Hc - y_lo))
        xc = rng.randint(x_lo, W - (Wc - x_lo))
        fy = flows[k][0][yc, xc]
        fx = flows[k][1][yc, xc]
        if not (lo_h <= fy <= hi_h and lo_w <= fx <= hi_w):
            continue
        if masks is not None and masks[k] is not None:
            if masks[k][yc, xc] < 0.5:
                continue
        if k not in img_map:
            img_map[k] = len(img_map)
        i1.append(img_map[k])
        iy.append(yc)
        ix.append(xc)
        tyx.append((fy, fx))
        its.append(int(codecs.encode_np(geom, fy, fx)))
    order = sorted(img_map, key=img_map.get)
    stack1 = np.stack([images[k] for k in order]).astype(np.float32)
    stack2 = np.stack([images[k + 1] for k in order]).astype(np.float32)
    i1a = np.asarray(i1, np.int32)
    iya = np.asarray(iy, np.int32)
    ixa = np.asarray(ix, np.int32)
    c1 = np.empty((len(i1a), Hc, Wc, stack1.shape[-1]), np.float32)
    c2 = np.empty_like(c1)
    for s in range(len(i1a)):
        y0 = iya[s] - y_lo
        x0 = ixa[s] - x_lo
        c1[s] = stack1[i1a[s], y0:y0 + Hc, x0:x0 + Wc]
        c2[s] = stack2[i1a[s], y0:y0 + Hc, x0:x0 + Wc]
    return FoveaDataset(
        stack1, stack2, i1a, iya, ixa,
        np.asarray(tyx, np.float32), np.asarray(its, np.int32),
        crops1=c1, crops2=c2,
    )


# ---------------------------------------------------------------------------
# Trainers
# ---------------------------------------------------------------------------

class _TrainerBase:
    """An epoch over a dataset in (shuffled) batches of ``batch_size``,
    the last partial batch dropped; subclasses give the model and the
    loss of one batch."""

    def __init__(self, model, learning: Learning):
        self.model = model
        self.learning = learning
        self.device = next(model.parameters()).device
        self.optimizer: Optional[SGDTorch] = None
        self._dp_step = None
        self._mesh_n = 1

    def use_mesh(self, mesh, axis: str = "dp"):
        """Engage a device mesh (``parallel.mesh.Mesh``): each step splits
        its batch across the mesh, every shard's replica of the model
        backpropagates its share of the batch-mean loss, and the gradients
        are summed onto ``model`` before one guarded update there
        (``parallel.mesh.sharded_train_step``). Epochs then need a batch
        size that divides by the mesh size. The CLIs' --dp flag lands
        here. Returns the trainer."""
        from ..parallel import mesh as pm
        self._dp_step = pm.sharded_train_step(self, mesh, axis, n_batch=4)
        self._mesh_n = mesh.size
        return self

    def init(self, generator: torch.Generator):
        """Random weights from a CPU ``torch.Generator`` and a fresh
        optimizer (count 0). Returns the trainer."""
        self.model.init(generator)
        return self.reset_optimizer()

    def reset_optimizer(self):
        """A fresh optimizer (count 0) over the model's current weights.
        Returns the trainer."""
        lrn = self.learning
        self.optimizer = sgd_torch(self.model.parameters(), lrn.rate,
                                   lrn.rate_decay, lrn.weight_decay)
        return self

    def _loss(self, model, x1, x2, itarget, soft_t):
        """(loss, {"acc"}) of ``model`` (the trainer's model or a replica
        of it) on one batch."""
        raise NotImplementedError

    def _inputs(self, ds):
        raise NotImplementedError

    def _update(self) -> Dict[str, torch.Tensor]:
        """The NaN guard and the optimizer's step on the model's gradients."""
        return {"grad_ok": guarded_update(list(self.model.parameters()),
                                          self.optimizer)}

    @full_f32()
    def step(self, x1, x2, itarget, soft_t) -> Dict[str, torch.Tensor]:
        """One SGD step on a batch of device tensors (split across the mesh
        after ``use_mesh``). Returns {"loss", "acc", "grad_ok"} as device
        tensors."""
        if self.optimizer is None:
            raise RuntimeError("call init() (or reset_optimizer()) first")
        if self._dp_step is not None:
            return self._dp_step(x1, x2, itarget, soft_t)
        self.model.train()
        self.optimizer.zero_grad(set_to_none=False)
        loss, aux = self._loss(self.model, x1, x2, itarget, soft_t)
        loss.backward()
        return dict(aux, loss=loss.detach(), **self._update())

    def soft_targets(self, targets_yx: torch.Tensor, n: int) -> torch.Tensor:
        """The batch's soft targets (zeros without learning.soft_targets)."""
        g = self.model.geometry
        if self.learning.soft_targets:
            return flow_model.prepare_target(g, self.learning, targets_yx)[1]
        return torch.zeros((n, codecs.n_indices(g)), device=self.device)

    @full_f32()
    def epoch(self, ds, batch_size: Optional[int] = None,
              shuffle_rng: Optional[np.random.RandomState] = None) -> Dict:
        """One pass over ``ds``. Returns the mean "loss" and "acc", and the
        per-step "losses", "accs" and "grad_ok"."""
        bs = batch_size or self.learning.batch_size
        if bs % self._mesh_n:
            raise SystemExit(
                f"batch size {bs} is not divisible by the {self._mesh_n}-"
                f"device dp mesh — pick -bs a multiple of {self._mesh_n}")
        n = (len(ds) // bs) * bs
        order = np.arange(n)
        if shuffle_rng is not None:
            shuffle_rng.shuffle(order)
        x1, x2 = self._inputs(ds)
        itargets = torch.as_tensor(ds.itargets, device=self.device)
        targets_yx = torch.as_tensor(ds.targets_yx, device=self.device)
        auxs = []
        for b in range(0, n, bs):
            sel = torch.as_tensor(order[b:b + bs], device=self.device)
            auxs.append(self.step(x1[sel], x2[sel], itargets[sel],
                                  self.soft_targets(targets_yx[sel], bs)))
        if not auxs:
            raise ValueError(f"{len(ds)} samples make no batch of {bs}")
        # one read from the card an epoch
        got = {k: torch.stack([a[k] for a in auxs]).cpu().tolist()
               for k in ("loss", "acc", "grad_ok")}
        return {"loss": float(np.mean(got["loss"])),
                "acc": float(np.mean(got["acc"])),
                "losses": got["loss"], "accs": got["acc"],
                "grad_ok": [bool(v) for v in got["grad_ok"]]}


class Trainer(_TrainerBase):
    """Single-scale trainer: a ``FlowModel`` of ``geometry`` on ``device``
    (the card by default; raises without one unless given
    ``device="cpu"``), trained on ``PatchDataset`` batches with
    ``learning.criterion``."""

    def __init__(self, geometry: Geometry, learning: Learning, device="cuda"):
        super().__init__(flow_model.FlowModel(geometry, device=device),
                         learning)
        self.loss_fn = make_loss_fn(self.model, learning)

    def _loss(self, model, x1, x2, itarget, soft_t):
        fn = (self.loss_fn if model is self.model
              else make_loss_fn(model, self.learning))
        return fn(x1, x2, itarget, soft_t)

    def _inputs(self, ds: PatchDataset):
        return (torch.as_tensor(ds.patches1, device=self.device),
                torch.as_tensor(ds.patches2, device=self.device))


class MultiscaleTrainer(_TrainerBase):
    """NLL trainer of a ``MultiscaleFlowModel`` of ``geometry`` on
    ``device`` over fovea footprints (``FoveaDataset.crops1/2``). With
    ``learning.soft_targets`` the criterion is the cross-entropy against a
    Gaussian placed at each index's decoded displacement, normalized per
    sample."""

    def __init__(self, geometry: Geometry, learning: Learning, device="cuda"):
        super().__init__(MultiscaleFlowModel(geometry, device=device),
                         learning)

    def _loss(self, model, crops1, crops2, itarget, soft_t):
        logp = model.forward_fovea_batch(crops1, crops2)
        it = itarget.long()
        if self.learning.soft_targets:
            t = soft_t / soft_t.sum(-1, keepdim=True).clamp(min=1e-8)
            loss = -(t * logp).sum(-1).mean()
        else:
            loss = -logp.gather(1, it[:, None])[:, 0].mean()
        return loss, {"acc": (logp.argmax(-1) == it).float().mean()}

    def _inputs(self, ds: FoveaDataset):
        if ds.crops1 is None:
            raise ValueError("FoveaDataset without crops: build it with "
                             "sample_foveas")
        return (torch.as_tensor(ds.crops1, device=self.device),
                torch.as_tensor(ds.crops2, device=self.device))
