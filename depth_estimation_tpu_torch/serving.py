"""Serving exports: self-contained artifacts of the inference programs
(port of ``depth_estimation_tpu.serving``).

A serving host should not need the research package, its model classes or
its checkpoint readers: just a program and its weights. Here the artifact is
a ``torch.export`` program saved with ``torch.export.save`` (a ``.pt2``
file): the traced inference program with the trained weights held inside as
its parameters and constants. Kernels B1 (``match_flow_fused``) and B3
(``banded_bilinear_warp``) are the operators ``depth_estimation_tpu_torch::
match_flow_fused`` and ``::banded_bilinear_warp`` in it, so a host that
loads an artifact needs torch and this package's ``ops`` modules, which
register them (``load_exported`` imports those first), and nothing else of
the package.

Exporters cover every trainable model family:
  * ``export_flow_forward`` — the single-scale forward (trunk -> B1 ->
    WTA / soft-argmax) and the multiscale full-image WTA decode;
  * ``export_pipeline_pairs`` — the complete batched online program of
    ``api_batched.make_batched_pipeline`` (resize -> undistort -> trunk ->
    ego-motion -> compensation -> B1 -> masks -> depth) over B frame pairs,
    the ``warp`` mode's two branches kept by ``torch.cond``;
  * ``export_radial_forward`` — the radial tester's WTA decode;
  * ``export_v2_forward`` — version2's full-frame WTA flow decode;
  * ``export_legacy_depth`` — the legacy depth classifier's
    fully-convolutional class map.

An artifact is exported for the device it is exported on (``device``,
the card by default): its tensors' devices are part of the program. Serve
with ``load_exported(path).module()(*args)``.
"""

from __future__ import annotations

import io
import json
import os

import torch
from torch import nn

from .utils.device import resolve
from .utils.precision import full_f32


def export_jitted(module: nn.Module, example_args, path: str | None = None) -> bytes:
    """Export ``module`` traced at ``example_args`` (``torch.export.export``
    under no_grad, so that the programs' ``torch.no_grad`` markers leave no
    grad-mode nodes) and serialize it with ``torch.export.save``; the
    module's parameters, buffers and the tensors it makes from constants
    are held in the artifact. Returns the bytes; also writes them to
    ``path`` when given. The weights are held without gradients, so a
    call returns plain tensors. The example tensors must be distinct
    objects: the trace takes one tensor passed twice for one input."""
    module = module.eval().requires_grad_(False)
    with torch.no_grad():
        ep = torch.export.export(module, tuple(example_args))
    ep.example_inputs = None        # the artifact does not carry the zeros
    buf = io.BytesIO()
    torch.export.save(ep, buf)
    data = buf.getvalue()
    if path is not None:
        with open(path, "wb") as fh:
            fh.write(data)
    return data


def load_exported(path_or_bytes) -> torch.export.ExportedProgram:
    """Deserialize an artifact (a path or its bytes) into a
    ``torch.export.ExportedProgram``; call it with ``.module()(*args)``.
    Registers the package's operators (B1, B3) first; imports neither the
    model classes nor the checkpoint readers. The artifact records no
    TF32 setting and runs under its caller's: call it inside
    ``utils.precision.full_f32()`` to compute as the live program does."""
    from .ops import matching, warp  # noqa: F401  (registers the operators)
    if isinstance(path_or_bytes, (bytes, bytearray)):
        return torch.export.load(io.BytesIO(bytes(path_or_bytes)))
    return torch.export.load(path_or_bytes)


def _examples(shape, dtype, device, n: int):
    return tuple(torch.zeros(shape, dtype=dtype, device=device)
                 for _ in range(n))


class _Call(nn.Module):
    """``fn(model, *args)`` as the forward of a module that holds
    ``model``, so that its weights become the program's state."""

    def __init__(self, model: nn.Module, fn):
        super().__init__()
        self.model = model
        self.fn = fn

    def forward(self, *args):
        return self.fn(self.model, *args)


def export_flow_forward(geometry, params, path: str | None = None,
                        dtype=torch.float32, device="cuda") -> bytes:
    """Flow forward with ``params`` (the flax-layout tree ``models.io
    .load_model`` returns) held inside. Single-scale geometry: the trunk and
    B1 (``FlowModel.forward_fused`` at storage ``dtype``), signature
    (hImg, wImg, 3) f32 x2 -> (idx, ey, ex, pmax); multiscale geometry: the
    full-image WTA decode (``decode_full``, staged at ``dtype``), signature
    -> (idx, pmax) (hImg, wImg) maps."""
    from .models import io as mio
    g = geometry
    dev = resolve(device)
    if g.multiscale:
        from .models.multiscale import MultiscaleFlowModel
        model = MultiscaleFlowModel(
            g, decode_dtype=None if dtype == torch.float32 else dtype,
            device=dev)

        def forward(m, img1, img2):
            return m.decode_full(img1, img2)
    else:
        from .models.flow import FlowModel, crop_features_center
        from .ops import matching
        model = FlowModel(g, device=dev)

        def forward(m, img1, img2):
            f1 = crop_features_center(g, m.features(img1))
            f2 = m.features(img2)
            return matching.match_flow_fused(f1, f2, g.maxh, g.maxw, 8,
                                             False, dtype)
    mio.load_tree_into(model, params)
    ex = _examples((g.hImg, g.wImg, 3), torch.float32, dev, 2)
    return export_jitted(_Call(model, forward), ex, path)


class _Pipeline(nn.Module):
    """The batched program's two preps and one step as a module holding
    the trunk."""

    def __init__(self, est):
        super().__init__()
        self.trunk = est.trunk
        self.est = est

    def forward(self, frames1, frames2):
        last_u, last_feats = self.est._prep(frames1)
        return self.est._step(last_u, last_feats, frames2)[2:]


def export_pipeline_pairs(geometry, params, cal, batch: int,
                          frame_hw=(480, 640), path: str | None = None,
                          device="cuda", **knobs) -> bytes:
    """The complete batched per-frame program (``api_batched
    .make_batched_pipeline``) with ``params`` held inside: artifact
    signature (B, h, w, 3) uint8 x2 -> (xflow, mask, depth, good).
    ``knobs`` pass through to ``BatchedDepthEstimator`` (compensation,
    corner_selector, match_dtype, match_block="auto", ...). RANSAC's noise is drawn once as the
    live step draws it (``egomotion.gumbel_noise``, seeded 1), unless
    ``ransac_noise`` is given, and held in the artifact as a constant."""
    from .api_batched import BatchedDepthEstimator
    from .geometry3d import egomotion as ego
    dev = resolve(device)
    est = BatchedDepthEstimator(geometry, params, cal, device=dev, **knobs)
    if est.ransac_noise is None:
        r = est.ego_downsample
        n = ego.corner_count(cal.sfm.max_points, geometry.hImg // r,
                             geometry.wImg // r, est.corner_selector)
        est.ransac_noise = ego.gumbel_noise(est.ransac_samples, n, dev)
    h, w = frame_hw
    ex = _examples((batch, h, w, 3), torch.uint8, dev, 2)
    # match_block "auto": B1's plan resolved on the card before the trace,
    # which then holds it as the operator's constant arguments
    est._resolve_plans(est._prep(ex[0])[1])
    return export_jitted(_Pipeline(est), ex, path)


def export_radial_forward(layers, h_win: int, params, polar_hw=(200, 200),
                          path: str | None = None, device="cuda") -> bytes:
    """Radial tester decode (``RadialFlowNetwork.flow``) with ``params``
    held inside: artifact signature (H, W, C) f32 polar pair -> (radial
    flow int32 (H', W'), min cost (H', W'))."""
    from .models import io as mio
    from .models.radial import RadialFlowNetwork
    dev = resolve(device)
    net = mio.load_tree_into(RadialFlowNetwork(layers, h_win, device=dev),
                             params)
    h, w = polar_hw
    ex = _examples((h, w, layers[0][0]), torch.float32, dev, 2)
    return export_jitted(_Call(net, lambda m, a, b: m.flow(a, b)), ex, path)


def _v2_decode(net, img1, img2):
    from . import codecs
    costs = net.costs(img1, img2)
    idx = torch.argmin(costs, dim=-1).to(torch.int32)
    dy, dx = codecs.decode(net.geometry, idx)
    return dy, dx, torch.amin(costs, dim=-1)


def export_v2_forward(datap, params, path: str | None = None,
                      device="cuda") -> bytes:
    """version2 full-frame WTA flow decode with ``params`` held inside:
    artifact signature (hImg, wImg, 3) f32 x2 -> (flow_y, flow_x int32
    maps, min cost)."""
    from .models import io as mio
    from .models.version2 import V2Network
    dev = resolve(device)
    net = mio.load_tree_into(V2Network(datap, device=dev), params)
    g = net.geometry
    ex = _examples((g.hImg, g.wImg, 3), torch.float32, dev, 2)
    return export_jitted(_Call(net, _v2_decode), ex, path)


def _class_map(model, x):
    return torch.argmax(model(x[None])[0], dim=-1).to(torch.int32)


def export_legacy_depth(n_classes: int, params, frame_hw=(360, 640),
                        path: str | None = None, device="cuda") -> bytes:
    """Legacy depth classifier, fully-convolutional inference on a frame
    pair with ``params`` held inside: artifact signature (H, W, 2) f32
    frame-pair stack -> (H', W') int32 depth-class map (class 0 = nearest
    bin)."""
    from .models import io as mio
    from .models.legacy_depth import DepthClassifierCNN
    dev = resolve(device)
    model = mio.load_tree_into(DepthClassifierCNN(n_classes, device=dev),
                               params)
    h, w = frame_hw
    ex = _examples((h, w, 2), torch.float32, dev, 1)
    return export_jitted(_Call(model, _class_map), ex, path)


def detect_family(model_dir: str):
    """Classify a trained model dir by its checkpoint layout. Returns
    (family, meta_dict_or_None) with family in
    {'flow', 'radial', 'v2', 'depth'}:
      * flow — ``models.io.save_model``'s layout (meta.json carries
        'geometry');
      * radial — the radial trainer's layout (meta.json with layers/hWin,
        weights in e<N>.msgpack);
      * v2 — the version2 trainer's layout (meta.json with
        family='version2', or dirs holding only bare e<N> payloads, the
        reference's own convention);
      * depth — the legacy depth classifier's layout (meta.json with
        n_classes/cut_depth)."""
    mp = os.path.join(model_dir, "meta.json")
    if os.path.exists(mp):
        with open(mp) as fh:
            meta = json.load(fh)
        if "geometry" in meta:
            return "flow", meta
        if meta.get("family") == "version2":
            return "v2", meta
        if "n_classes" in meta:
            return "depth", meta
        if "hWin" in meta and "layers" in meta:
            return "radial", meta
        raise ValueError(f"unrecognized meta.json keys in {model_dir}: "
                         f"{sorted(meta)}")
    if any(e.startswith("e") and e[1:].isdigit()
           for e in os.listdir(model_dir)):
        return "v2", None
    raise ValueError(f"{model_dir} is not a recognized model directory")


def radial_layers(spec) -> tuple:
    """A radial ``meta.json``'s layer list as the net's spec. A 'tanh'
    stored as its letters, ["t", "a", "n", "h"] (the JAX radial CLI maps
    ``list`` over every entry of the spec), reads as 'tanh', as the writer
    meant."""
    out = []
    for layer in spec:
        if isinstance(layer, str):
            out.append(layer)
        elif all(isinstance(c, str) for c in layer):
            out.append("".join(layer))
        else:
            out.append(tuple(layer))
    return tuple(out)


def _latest_epoch_payload(model_dir: str, suffix: str) -> bytes:
    eps = [int(e[1:len(e) - len(suffix)] or -1) for e in os.listdir(model_dir)
           if e.startswith("e") and e.endswith(suffix)
           and e[1:len(e) - len(suffix)].isdigit()]
    if not eps:
        raise FileNotFoundError(
            f"no e<N>{suffix} checkpoints in {model_dir}")
    with open(os.path.join(model_dir, f"e{max(eps)}{suffix}"), "rb") as fh:
        return fh.read()


@full_f32()
def cmd_export(args) -> int:
    """`tools export`: write a serving artifact for a trained model dir.
    The model family (single/multiscale flow, radial, version2, legacy
    depth) is detected from the checkpoint layout."""
    from .models import io as mio

    family, meta = detect_family(args.model)
    out = args.out or os.path.join(args.model, "serving.pt2")
    dev = args.device
    if family == "flow":
        g, _, params, _ = mio.load_model(args.model)
        if args.pipeline:
            from .geometry3d import calibration as calmod
            cal = (calmod.Calibration.load(args.cal) if args.cal
                   else calmod.ARDRONE)
            data = export_pipeline_pairs(g, params, cal, args.batch,
                                         path=out, device=dev)
        else:
            dt = torch.bfloat16 if args.bf16 else torch.float32
            data = export_flow_forward(g, params, path=out, dtype=dt,
                                       device=dev)
    elif family == "radial":
        params = mio.unpackb(_latest_epoch_payload(args.model, ".msgpack"))
        hw = tuple(args.hw) if args.hw else (200, 200)
        data = export_radial_forward(radial_layers(meta["layers"]),
                                     meta["hWin"], params, polar_hw=hw,
                                     path=out, device=dev)
    elif family == "v2":
        from .models.version2 import V2Params
        if meta is not None:
            datap = V2Params(
                wImg=meta["wImg"], hImg=meta["hImg"],
                normalization_k=meta["normalization_k"],
                layers=tuple(tuple(l) for l in meta["layers"]),
                hWin=meta["hWin"], wWin=meta["wWin"])
        else:
            datap = V2Params()
        params = mio.unpackb(_latest_epoch_payload(args.model, ""))
        data = export_v2_forward(datap, params, path=out, device=dev)
    else:  # depth
        with open(os.path.join(args.model, "params.msgpack"), "rb") as fh:
            params = mio.unpackb(fh.read())
        hw = tuple(args.hw) if args.hw else (360, 640)
        data = export_legacy_depth(meta["n_classes"], params, frame_hw=hw,
                                   path=out, device=dev)
    print(f"wrote {out} ({family}, {len(data)} bytes, device "
          f"{resolve(dev)})")
    return 0

