"""Device-mesh parallelism over the cards of one host (port of
``depth_estimation_tpu.parallel.mesh``).

Flow inference is independent per frame pair, so the frame or patch batch
is split along its leading axis across a 1-D mesh of devices and each
shard runs the package's own per-device program at its local batch shape,
on its own card, with a replica of the weights: the online program, the
flow forward, the offline ground-truth and dataset builds and the training
step (whose gradients are summed onto the primary card before one update).
The row-sharded functions split ONE frame pair by image rows instead, each
shard taking the halo rows its conv footprint and search window need from
its neighbours; edge shards take zeros, so the result equals the unsharded
program on a zero-padded frame.

One process drives every card, as the reference's single-controller
``shard_map`` does: a ``Mesh`` is a tuple of ``torch.device``s and an axis
name, not a process group. A device may repeat: ``make_mesh(["cpu"] * 8)``
is eight CPU shards, and one card split in two shards is
``make_mesh(["cuda:0"] * 2)``. Where the mesh holds several cards, each
card's shards run in a host thread of that card (``run_shards``), so that
a host read inside one shard's program (the ``warp`` step reads its
branch predicate) does not hold back the work of the other cards; on one
card, or the CPU, the shards run one after another.

A batch split across the mesh is a ``Sharded``: a tuple of per-device
chunks in shard order, which ``np.asarray`` and ``gather`` put back
together. The sharded functions take whole tensors or numpy arrays (split
here) or ``Sharded`` batches, and return ``Sharded`` outputs. The models of
the port hold their weights, so the functions take the model (or
estimator, or trainer) where the reference takes ``params``; its weights
are copied to every replica at each call.
"""

from __future__ import annotations

import contextlib
import copy
import threading
from typing import Callable, List, Optional, Sequence

import numpy as np
import torch
from torch import nn

from ..utils.device import host, resolve
from ..utils.precision import full_f32


class Mesh:
    """A 1-D mesh: ``devices`` (a tuple of ``torch.device``, shard order)
    under the axis name ``axis``."""

    def __init__(self, devices: Sequence, axis: str = "dp"):
        devs = []
        for d in devices:
            d = torch.device(d)
            if d.type == "cuda" and d.index is None:
                d = torch.device("cuda", torch.cuda.current_device())
            devs.append(d)
        if not devs:
            raise ValueError("a mesh needs at least one device")
        self.devices = tuple(devs)
        self.axis = axis

    @property
    def size(self) -> int:
        return len(self.devices)

    @property
    def platform(self) -> str:
        """The devices' type ('cuda' or 'cpu'), as the CLIs print it."""
        return self.devices[0].type

    def __repr__(self) -> str:
        return (f"Mesh({[str(d) for d in self.devices]}, "
                f"axis={self.axis!r})")


class Sharded(tuple):
    """A batch split along its leading axis: one chunk a shard, each on its
    shard's device, in shard order."""

    @property
    def shape(self):
        return (sum(c.shape[0] for c in self),) + tuple(self[0].shape[1:])

    @property
    def devices(self):
        return tuple(c.device for c in self)

    def gather(self, device=None) -> torch.Tensor:
        """The whole batch as one tensor on ``device`` (default: the first
        shard's)."""
        device = self[0].device if device is None else torch.device(device)
        return torch.cat([c.to(device) for c in self])

    def __array__(self, dtype=None, copy=None):
        out = np.concatenate([host(c) for c in self])
        return out if dtype is None else out.astype(dtype)


def visible_devices(device="cuda") -> List[torch.device]:
    """Every card torch sees when ``device`` is a CUDA device (raising
    where there is none), else ``[device]``."""
    dev = resolve(device)
    if dev.type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [dev]


def make_mesh(devices: Optional[Sequence] = None, axis: str = "dp") -> Mesh:
    """A mesh over ``devices`` (default: every visible card)."""
    return Mesh(visible_devices() if devices is None else devices, axis)


def auto_mesh(dp: str = "auto", device="cuda",
              axis: str = "dp") -> Optional[Mesh]:
    """Resolve a CLI ``--dp`` value to a mesh (or None = stay on one
    device).

    'auto'  -> every visible card when there are two or more,
    'off'/'0'/'1'/'none' -> None,
    'N'     -> the first N cards (SystemExit if fewer are visible); with a
               CPU ``device``, N CPU shards.
    Every CLI that can shard (the trainers, rectify, the GT and dataset
    builds) comes through here.
    """
    dp = str(dp)
    if dp in ("off", "0", "1", "none"):
        return None
    dev = resolve(device)
    devices = visible_devices(dev)
    if dp == "auto":
        return make_mesh(devices, axis) if len(devices) > 1 else None
    n = int(dp)
    if dev.type != "cuda":
        return make_mesh([dev] * n, axis)
    if n > len(devices):
        raise SystemExit(f"--dp {n}: only {len(devices)} devices attached")
    return make_mesh(devices[:n], axis)


def shard_batch(x, mesh: Mesh, axis: str = "dp"):
    """Split a batch (a tensor or numpy array, or a tuple or list of them)
    along its leading axis across the mesh: a ``Sharded`` a batch. The
    leading axis must divide by the mesh size (``pad_to_multiple``)."""
    if isinstance(x, Sharded):
        if len(x) != mesh.size:
            raise ValueError(f"{len(x)} shards on a {mesh.size}-device mesh")
        return Sharded(c.to(d) for c, d in zip(x, mesh.devices))
    if isinstance(x, (tuple, list)):
        return type(x)(shard_batch(a, mesh, axis) for a in x)
    if isinstance(x, np.ndarray) and not x.flags.writeable:
        x = x.copy()
    t = torch.as_tensor(x)
    n = mesh.size
    if t.ndim == 0 or t.shape[0] % n:
        raise ValueError(f"leading axis of {tuple(t.shape)} does not split "
                         f"over {n} devices: pad_to_multiple first")
    return Sharded(c.to(d) for c, d in zip(t.split(t.shape[0] // n),
                                           mesh.devices))


def replicate(x, mesh: Mesh) -> list:
    """One replica of ``x`` a shard, in shard order. A tensor (or numpy
    array) is moved to each device (a device it is already on reads it
    itself). A module is deep-copied to each device, except that the first
    shard on the module's own device gets the module itself."""
    if isinstance(x, nn.Module):
        own = next(x.parameters()).device
        out, used = [], False
        for d in mesh.devices:
            if d == own and not used:
                out.append(x)
                used = True
            else:
                out.append(copy.deepcopy(x).to(d))
        return out
    t = torch.as_tensor(x)
    return [t.to(d) for d in mesh.devices]


@torch.no_grad()
def broadcast(module: nn.Module, replicas: Sequence[nn.Module]) -> None:
    """Copy ``module``'s parameters and buffers into every replica that is
    not ``module`` itself."""
    src = list(module.parameters()) + list(module.buffers())
    for r in replicas:
        if r is module:
            continue
        for a, b in zip(list(r.parameters()) + list(r.buffers()), src):
            a.copy_(b)


def reduce_add(tensors: Sequence[torch.Tensor], device) -> torch.Tensor:
    """The sum of ``tensors`` on ``device``, added in the order given."""
    out = tensors[0].to(device)
    for t in tensors[1:]:
        out = out + t.to(device)
    return out


def pad_to_multiple(x, m: int):
    """Pad the leading axis to a multiple of m by repeating the last item
    (static shard shapes). ``x`` is a numpy array or a tensor; returns (the
    padded batch, the original count)."""
    n = x.shape[0]
    pad = (-n) % m
    if pad:
        if isinstance(x, torch.Tensor):
            x = torch.cat([x, x[-1:].expand(pad, *x.shape[1:])])
        else:
            x = np.concatenate([x, np.repeat(x[-1:], pad, axis=0)], axis=0)
    return x, n


def run_shards(fn: Callable, mesh: Mesh, *shards) -> list:
    """``fn(i, *(s[i] for s in shards))`` for every shard i, under the
    shard's device and the caller's grad mode. Where the mesh holds more
    than one card, each card runs its shards in order in a host thread of
    its own, so that no card's host reads and launches wait on another's;
    shards that share a card are issued from one thread (two threads
    issuing into one card took twice as long as one), and a CPU mesh, or
    one card, runs every shard in the calling thread. The whole run is one
    ``full_f32`` scope, entered before any thread starts and left after
    they all join, so that no shard runs in TF32 while another's scope
    closes. Returns the results in shard order."""
    with full_f32():
        return _run_shards(fn, mesh, *shards)


def _run_shards(fn: Callable, mesh: Mesh, *shards) -> list:
    grad = torch.is_grad_enabled()
    out = [None] * mesh.size

    def run(indices):
        for i in indices:
            d = mesh.devices[i]
            with torch.set_grad_enabled(grad), (
                    torch.cuda.device(d) if d.type == "cuda"
                    else contextlib.nullcontext()):
                out[i] = fn(i, *(s[i] for s in shards))

    groups = {}
    for i, d in enumerate(mesh.devices):
        groups.setdefault(d, []).append(i)
    if sum(d.type == "cuda" for d in groups) <= 1:
        run(range(mesh.size))
        return out
    errors = []

    def card(indices):
        try:
            run(indices)
        except BaseException as e:      # re-raised in the calling thread
            errors.append(e)

    threads = [threading.Thread(target=card, args=(g,))
               for g in groups.values()]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if errors:
        raise errors[0]
    return out


def _outputs(outs: list, n_out: int):
    """Per-shard results -> one ``Sharded`` (n_out 1) or a tuple of them."""
    if n_out == 1:
        return Sharded(outs)
    return tuple(Sharded(o[k] for o in outs) for k in range(n_out))


# ---------------------------------------------------------------------------
# training
# ---------------------------------------------------------------------------

def sharded_train_step(trainer, mesh: Mesh, axis: str = "dp",
                       n_batch: int = 4):
    """A trainer's step over the mesh: the first ``n_batch`` arguments
    split on the leading axis, the rest and the weights replicated. Each
    replica backpropagates its shard's share of the batch-mean loss; the
    gradients are summed onto the trainer's model (in shard order), then
    the trainer's update runs once there (``trainer._update``: the NaN
    guard and the optimizer's step), so a non-finite gradient on any shard
    skips the step as it does unsharded. Every step first copies the
    model's weights to the replicas.

    The trainer gives ``model``, ``_loss(model, *batch) -> (loss, {aux})``
    and ``_update() -> {extra aux}``. Returns step(*batch) -> {"loss",
    aux..., extra...} as tensors on the model's device."""
    model = trainer.model
    replicas = replicate(model, mesh)
    primary = next(model.parameters()).device

    def step(*batch):
        B = batch[0].shape[0]
        broadcast(model, replicas)
        for r in replicas:
            r.train()
            r.zero_grad(set_to_none=False)
        local = [shard_batch(a, mesh, axis) for a in batch[:n_batch]]
        rest = [replicate(a, mesh) for a in batch[n_batch:]]

        def body(i, *xs):
            loss, aux = trainer._loss(replicas[i], *xs, *(a[i] for a in rest))
            w = xs[0].shape[0] / B
            (loss * w).backward()
            return (loss.detach() * w,
                    {k: v.detach() * w for k, v in aux.items()})

        outs = run_shards(body, mesh, *local)
        per_replica = [list(r.parameters()) for r in replicas]
        for j, p in enumerate(model.parameters()):
            grads = [ps[j].grad for ps in per_replica]
            if grads[0] is not None:
                p.grad = reduce_add(grads, primary)
        extra = trainer._update()
        aux = {k: reduce_add([o[1][k] for o in outs], primary)
               for k in outs[0][1]}
        return dict(aux, loss=reduce_add([o[0] for o in outs], primary),
                    **extra)

    return step


# ---------------------------------------------------------------------------
# inference: data parallel, and row-sharded with halos
# ---------------------------------------------------------------------------

def _halo_below(shards: Sharded, i: int, rows: int) -> torch.Tensor:
    """The first ``rows`` rows of shard i + 1 on shard i's device (zeros
    for the last shard)."""
    mine = shards[i]
    if i + 1 < len(shards):
        return shards[i + 1][:rows].to(mine.device)
    return torch.zeros_like(mine[:rows])


def _halo_above(shards: Sharded, i: int, rows: int) -> torch.Tensor:
    """The last ``rows`` rows of shard i - 1 on shard i's device (zeros
    for the first shard)."""
    mine = shards[i]
    if i > 0:
        prev = shards[i - 1]
        return prev[prev.shape[0] - rows:].to(mine.device)
    return torch.zeros_like(mine[mine.shape[0] - rows:])


def spatial_sharded_flow_fn(model, mesh: Mesh, axis: str = "sp"):
    """ONE frame pair split across the mesh along image rows: each shard
    takes the halo rows its matcher window and conv footprint need from
    the shard below, computes its slice of features and the fused match
    (kernel B1 on a card), and the row-sharded outputs concatenate to the
    full-frame result. The last shard's halo is zeros, so the result
    equals the unsharded model on a zero-bottom-padded frame.

    Returns fn(img1 (H, W, C), img2) -> (idx, ey, ex, pmax), each a
    ``Sharded`` of rows, with H = mesh size * rows a shard (pad the frame
    to a multiple first)."""
    from ..ops import matching

    g = model.geometry
    halo = (g.maxh - 1) + (g.hKernel - 1)
    replicas = replicate(model, mesh)

    def fn(img1, img2):
        broadcast(model, replicas)
        s1, s2 = shard_batch((img1, img2), mesh, axis)

        def local(i, a, b):
            e1 = torch.cat([a, _halo_below(s1, i, halo)])
            e2 = torch.cat([b, _halo_below(s2, i, halo)])
            net = replicas[i]
            f1full = net.features(e1)
            f2 = net.features(e2)
            # crop f1 by the half-window; rows start at halfh1 as in the
            # unsharded path, keeping Hs output rows a shard
            f1 = f1full[g.halfh1:g.halfh1 + a.shape[0],
                        g.halfw1:f1full.shape[1] - g.halfw2]
            f2 = f2[:a.shape[0] + g.maxh - 1]
            return matching.match_flow_fused(f1, f2, g.maxh, g.maxw)

        with torch.no_grad():
            return _outputs(run_shards(local, mesh, s1, s2), 4)

    return fn


def sharded_flow_fn(model, mesh: Mesh, axis: str = "dp"):
    """Batched flow inference over the mesh: (B, H, W, C) pairs split on
    the batch, each shard's replica running ``forward_fused`` (kernel B1 on
    a card) on its local pairs; no cross-device traffic but the weights.
    Returns fn(img1, img2) -> (idx, ey, ex, pmax), each ``Sharded``."""
    replicas = replicate(model, mesh)

    def fn(img1, img2):
        broadcast(model, replicas)
        s1, s2 = shard_batch((img1, img2), mesh, axis)
        return _outputs(run_shards(
            lambda i, a, b: replicas[i].forward_fused(a, b), mesh, s1, s2), 4)

    return fn


def _estimator_replicas(est, mesh: Mesh) -> list:
    """One ``BatchedDepthEstimator`` a shard, each on its shard's device
    with a replica of the trunk, sharing every setting."""
    trunks = replicate(est.trunk, mesh)
    return [est.replica(d, t) for d, t in zip(mesh.devices, trunks)]


def sharded_pipeline_prep(est, mesh: Mesh, axis: str = "dp"):
    """The estimator's frame prep (normalize, resize, undistort, conv
    trunk) with the frames split on the stream axis. Returns prep(frames)
    -> (u, feats), each ``Sharded``. Pairs with ``sharded_pipeline_step``:
    together they run the complete online program over the mesh, with the
    stream state left sharded on the devices between steps."""
    reps = _estimator_replicas(est, mesh)

    def prep(frames):
        broadcast(est.trunk, [r.trunk for r in reps])
        return _outputs(run_shards(lambda i, f: reps[i]._prep(f), mesh,
                                   shard_batch(frames, mesh, axis)), 2)

    return prep


def sharded_pipeline_step(est, mesh: Mesh, axis: str = "dp"):
    """The estimator's ``_step`` over the mesh: every stage of the online
    program (undistort -> ego-motion -> rotation compensation -> fused
    match -> masks -> depth) is per stream, so the step is pure data
    parallelism: each shard's replica runs its own kernels (B1, and B3 in
    the 'warp' modes) and ego-motion on its local streams, and nothing
    crosses the cards. Returns step(last_u, last_feats, frames) -> (u,
    feats, xflow, mask, depth, good), each ``Sharded``."""
    reps = _estimator_replicas(est, mesh)

    def step(last_u, last_feats, frames):
        broadcast(est.trunk, [r.trunk for r in reps])
        args = shard_batch((last_u, last_feats, frames), mesh, axis)
        return _outputs(run_shards(
            lambda i, u, f, fr: reps[i]._step(u, f, fr), mesh, *args), 6)

    return step


def spatial_sharded_multiscale_fn(model, mesh: Mesh, axis: str = "sp"):
    """Row-sharded multiscale full-image forward: ONE frame pair split
    across the mesh along image rows, each shard computing its rows of
    ``MultiscaleFlowModel.forward_full`` exactly, with a halo from each
    neighbour.

    At pyramid ratio r the output row yc needs downsampled rows [yc -
    pad_top, yc + hPatch2 - 2 - pad_top] (conv footprint and matcher
    window; hP = hPatch2 - 1 splits into pad_patch_border's (pad_top,
    pad_bot)). A shard owning full-resolution rows [i Hs, (i + 1) Hs)
    therefore takes rmax pad_top rows from the shard above and rmax
    pad_bot rows from the shard below; edge shards take zeros, which are
    pad_patch_border's zero rows, so the result equals the unsharded one.
    The plain ``match_ssd`` runs the match (no kernel).

    Needs hImg % (mesh size * rmax) == 0. Returns fn(img1 (hImg, wImg, C),
    img2) -> the (hImg, wImg, n_indices) distribution as a ``Sharded`` of
    rows."""
    from ..models import multiscale as ms
    from ..ops import matching

    g = model.geometry
    n = mesh.size
    ratios = tuple(g.ratios)
    rmax = max(ratios)
    if g.hImg % (n * rmax):
        raise ValueError(f"hImg {g.hImg} does not split into {n} shards of "
                         f"a multiple of {rmax} rows")
    Hs = g.hImg // n
    hP = g.hPatch2 - 1
    wp = g.wPatch2 - 1
    pad_top, pad_bot = hP // 2, hP - hP // 2
    T = rmax * pad_top                      # top halo (full-res rows)
    Bm = rmax * pad_bot                     # bottom halo
    if Hs < max(T, Bm):
        raise ValueError(
            f"shard height {Hs} smaller than the halo ({T}/{Bm} rows): "
            f"halos come from ONE neighbour; use fewer devices or taller "
            f"frames")
    replicas = replicate(model, mesh)

    def fn(img1, img2):
        broadcast(model, replicas)
        s1, s2 = shard_batch((img1, img2), mesh, axis)

        def local(i, a, b):
            net = replicas[i]
            e1 = torch.cat([_halo_above(s1, i, T), a, _halo_below(s1, i, Bm)])
            e2 = torch.cat([_halo_above(s2, i, T), b, _halo_below(s2, i, Bm)])
            dists = []
            for s_i, r in enumerate(ratios):
                start = T // r - pad_top
                L = Hs // r + hP
                wpad = (0, 0, wp // 2, wp - wp // 2)
                d1 = torch.nn.functional.pad(
                    ms.avg_downsample(e1, r)[start:start + L], wpad)
                d2 = torch.nn.functional.pad(
                    ms.avg_downsample(e2, r)[start:start + L], wpad)
                filt = net._filter(s_i)
                f1f = filt(d1)
                f2 = filt(d2)
                f1 = f1f[g.halfh1:g.halfh1 + Hs // r,
                         g.halfw1:f1f.shape[1] - g.halfw2]
                costs = matching.match_ssd(f1, f2, g.maxh, g.maxw)
                dist = torch.softmax(-costs, dim=-1)
                dist = ms._replicate(dist, r, 0)[:Hs, :g.wImg]
                dists.append(dist.reshape(Hs, g.wImg, -1))
            fused = ms.apply_cascade(g, net.betas, dists)
            return ms.middle_removal_concat(g, fused)

        return _outputs(run_shards(local, mesh, s1, s2), 1)

    return fn


def spatial_sharded_radial_fn(net, mesh: Mesh, axis: str = "sp"):
    """Row-sharded radial (polar 1-D) matcher: the polar pair split along
    rows (radii), each shard taking the one-sided bottom halo its conv
    footprint and hWin search need from the shard below and computing its
    rows of ``RadialFlowNetwork.flow`` with the plain ``match_ssd_radial``.
    The last shard's halo is zeros: the result equals the unsharded matcher
    on a zero-bottom-padded polar pair.

    Returns fn(polar_prev (H, W, C), polar_curr) -> (flow, min_cost), each
    a ``Sharded`` of rows, with H = mesh size * rows a shard."""
    from ..ops import matching

    halo = (net.h_kernel - 1) + (net.h_win - 1)
    replicas = replicate(net, mesh)

    def fn(polar_prev, polar_curr):
        broadcast(net, replicas)
        s1, s2 = shard_batch((polar_prev, polar_curr), mesh, axis)

        def local(i, a, b):
            e1 = torch.cat([a, _halo_below(s1, i, halo)])
            e2 = torch.cat([b, _halo_below(s2, i, halo)])
            filt = replicas[i].filter
            fp = filt(e1)[:a.shape[0]]
            fc = filt(e2)[:a.shape[0] + net.h_win - 1]
            costs = matching.match_ssd_radial(fp, fc, net.h_win)
            return (torch.argmin(costs, dim=-1).to(torch.int32),
                    torch.amin(costs, dim=-1))

        with torch.no_grad():
            return _outputs(run_shards(local, mesh, s1, s2), 2)

    return fn


# ---------------------------------------------------------------------------
# the offline workload: ground truth and dataset builds
# ---------------------------------------------------------------------------

def _dp_shard_map(body: Callable, mesh: Mesh, axis: str, n_out: int,
                  n_in: int = 2):
    """Run a per-pair-independent batched ``body`` on every shard.

    The offline builds are independent over pairs, so each shard runs
    ``body`` on its own chunk, on its own device, at the LOCAL batch shape:
    a pair's result is that of an unsharded run on its shard's chunk (the
    same kernels and library calls at that shape; a library may choose
    another algorithm at another batch size, so against a FULL-batch run a
    knife-edge RANSAC pair can land on a different, still valid, fit).
    Returns mapped(*n_in batches) -> n_out ``Sharded`` outputs (one
    ``Sharded`` for n_out 1)."""

    def mapped(*args):
        if len(args) != n_in:
            raise TypeError(f"expected {n_in} batches, got {len(args)}")
        shards = [shard_batch(a, mesh, axis) for a in args]
        with torch.no_grad():
            outs = run_shards(lambda i, *local: body(*local), mesh, *shards)
        return _outputs(outs, n_out)

    return mapped


def sharded_celiu_fn(mesh: Mesh, axis: str = "dp", **solver_kw):
    """The celiu variational GT over the mesh: the batched solver
    (``flow.celiu.coarse2fine_flow_batched``, kernel B4 on a card) on each
    shard's local pairs; no cross-device traffic. ``solver_kw`` is the
    solver's schedule (alpha, ratio, min_width, n_outer, n_inner, n_sor,
    ...). B must be a multiple of the mesh size (``pad_to_multiple``).
    Returns fn(im1s, im2s) -> (vx, vy, warped), each ``Sharded``."""
    from ..flow.celiu import coarse2fine_flow_batched

    def body(im1s, im2s):
        return coarse2fine_flow_batched(im1s, im2s, **solver_kw)

    return _dp_shard_map(body, mesh, axis, n_out=3)


def _noise_replicas(noise, max_points: int, mesh: Mesh) -> list:
    """RANSAC's Gumbel draw on every shard's device: ``noise`` where given,
    else ``egomotion.gumbel_noise`` (seed 1) made on the first device, so
    that every shard draws the same samples."""
    from ..geometry3d import egomotion as ego
    if noise is None:
        noise = ego.gumbel_noise(64, max_points, mesh.devices[0])
    return replicate(torch.as_tensor(noise, dtype=torch.float32), mesh)


def sharded_rectify_fn(mesh: Mesh, cal, h: int, w: int, axis: str = "dp",
                       noise=None):
    """The SFM-rectification dataset build over the mesh: the fused
    undistort -> ego-motion -> resize -> rotation-warp program
    (``data.datasets.rectify_batch``) on each shard's pairs, with the same
    RANSAC ``noise`` on every shard (default: ``egomotion.gumbel_noise``,
    seed 1). Returns fn(prevs, imgs) -> (prev_s, img_s, warped, mask,
    n_inliers, n_found), each ``Sharded``."""
    from ..data import datasets as ds

    noises = _noise_replicas(noise, cal.sfm.max_points, mesh)

    def body(prevs, imgs):
        nz = noises[mesh.devices.index(prevs.device)]
        return ds.rectify_batch(prevs, imgs, cal.K, tuple(cal.distortion),
                                h, w, cal.sfm.max_points,
                                cal.sfm.points_quality, nz)

    return _dp_shard_map(body, mesh, axis, n_out=6)


def sharded_polar_load_fn(mesh: Mesh, cal, h_img: int, w_img: int,
                          h_input: int, w_input: int, w_kernel: int,
                          axis: str = "dp", clean_pixels: bool = False,
                          noise=None):
    """The radial/polar dataset build over the mesh: the fused ego-motion
    -> epipole -> rotation removal -> polar warps program
    (``data.datasets.polar_batch``) on each shard's pairs, with the same
    RANSAC ``noise`` on every shard. Returns fn(prevs, imgs) -> the
    program's 9 outputs, each ``Sharded``. With ``clean_pixels`` the
    returned fn takes (prevs, imgs, pixel_prevs, pixel_imgs): the geometry
    and GT frames and the patch-pixel frames are different recordings
    (train_radial's -gtd flag)."""
    from ..data import datasets as ds

    noises = _noise_replicas(noise, cal.sfm.max_points, mesh)

    def body(prevs, imgs, pix_prevs=None, pix_imgs=None):
        nz = noises[mesh.devices.index(prevs.device)]
        return ds.polar_batch(prevs, imgs, cal.K, cal.wImg, cal.hImg, h_img,
                              w_img, h_input, w_input, w_kernel,
                              cal.sfm.max_points, cal.sfm.points_quality, nz,
                              pix_prevs, pix_imgs)

    return _dp_shard_map(body, mesh, axis, n_out=9,
                         n_in=4 if clean_pixels else 2)


def sharded_exhaustive_gt_fn(geom, mesh: Mesh, method: str = "max",
                             axis: str = "dp"):
    """The cross-correlation GT (the trainer's default GT) over the mesh:
    the box-filter patch-SSD program
    (``data.groundtruth.exhaustive_flow_batched``'s device pass) on each
    shard's pairs. Returns fn(imgs1, imgs2) -> (fy, fx, conf), each
    ``Sharded``."""
    from ..data import groundtruth as gt

    gg = gt.gt_geometry(geom)

    def body(a, b):
        return gt._decode_gt(gg, a, b, method)

    return _dp_shard_map(body, mesh, axis, n_out=3)
