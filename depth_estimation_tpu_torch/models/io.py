"""Version-9 checkpoints (port of ``depth_estimation_tpu.models.io``) and the
weights bridges between the JAX parameter tree and the port's modules.

A checkpoint directory, named by ``model_dir_name``, holds ``meta.json``
(format version, geometry, learning, score history, epoch) and
``params.msgpack`` (flax's serialization of the parameter tree). The
machine that runs the port has neither flax nor msgpack, so ``unpackb``
and ``packb`` below read and write the subset of msgpack that flax
writes: maps, arrays, strings, binaries, integers, floats, nil/bool, and
ext type 1 — a packed ndarray ``(shape, dtype name, raw little-endian
bytes)``. ``packb`` writes the bytes ``flax.serialization.to_bytes``
writes for the same tree, so a checkpoint the port saves loads in the
JAX package and the reverse.

Bridges: ``*_state_from_jax`` map a flax tree (numpy leaves) onto a
module's state dict; ``filter_tree``, ``multiscale_tree``,
``radial_tree``, ``legacy_tree`` and ``model_tree`` map the port's
modules back onto the flax tree.

The other families' trainers write their own layouts:
``save_radial_checkpoint`` (``e{N}.msgpack`` and a version-1
``meta.json``), ``save_v2_checkpoint`` (a bare ``e{N}``) and
``save_legacy_checkpoint`` (``params.msgpack`` with the discretizer in
``meta.json``); ``load_weights_into`` reads any of them back.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from ..geometry import Geometry, Learning

FORMAT_VERSION = 9


# ---------------------------------------------------------------------------
# Minimal msgpack decoder (the subset flax.serialization writes)
# ---------------------------------------------------------------------------

_EXT_NDARRAY = 1


class _Reader:
    def __init__(self, buf: bytes):
        self.buf = memoryview(buf)
        self.pos = 0

    def take(self, n: int) -> bytes:
        if self.pos + n > len(self.buf):
            raise ValueError("msgpack payload truncated")
        out = self.buf[self.pos:self.pos + n].tobytes()
        self.pos += n
        return out

    def unpack(self, fmt: str) -> Any:
        return struct.unpack(fmt, self.take(struct.calcsize(fmt)))[0]


def _decode_ext(code: int, data: bytes) -> Any:
    if code != _EXT_NDARRAY:
        raise ValueError(f"unsupported msgpack ext type {code}")
    shape, dtype_name, raw = unpackb(data)
    return np.frombuffer(raw, dtype=np.dtype(dtype_name)).reshape(shape).copy()


def _read(r: _Reader) -> Any:
    b = r.unpack("B")
    if b <= 0x7f:
        return b
    if b >= 0xe0:
        return b - 0x100
    if 0x80 <= b <= 0x8f:
        return _read_map(r, b & 0x0f)
    if 0x90 <= b <= 0x9f:
        return [_read(r) for _ in range(b & 0x0f)]
    if 0xa0 <= b <= 0xbf:
        return r.take(b & 0x1f).decode("utf-8")
    simple = {0xc0: None, 0xc2: False, 0xc3: True}
    if b in simple:
        return simple[b]
    if b in (0xc4, 0xc5, 0xc6):                     # bin 8/16/32
        n = r.unpack({0xc4: ">B", 0xc5: ">H", 0xc6: ">I"}[b])
        return r.take(n)
    if b in (0xc7, 0xc8, 0xc9):                     # ext 8/16/32
        n = r.unpack({0xc7: ">B", 0xc8: ">H", 0xc9: ">I"}[b])
        code = r.unpack(">b")
        return _decode_ext(code, r.take(n))
    if b == 0xca:
        return r.unpack(">f")
    if b == 0xcb:
        return r.unpack(">d")
    ints = {0xcc: ">B", 0xcd: ">H", 0xce: ">I", 0xcf: ">Q",
            0xd0: ">b", 0xd1: ">h", 0xd2: ">i", 0xd3: ">q"}
    if b in ints:
        return r.unpack(ints[b])
    if b in (0xd4, 0xd5, 0xd6, 0xd7, 0xd8):         # fixext 1/2/4/8/16
        n = {0xd4: 1, 0xd5: 2, 0xd6: 4, 0xd7: 8, 0xd8: 16}[b]
        code = r.unpack(">b")
        return _decode_ext(code, r.take(n))
    if b in (0xd9, 0xda, 0xdb):                     # str 8/16/32
        n = r.unpack({0xd9: ">B", 0xda: ">H", 0xdb: ">I"}[b])
        return r.take(n).decode("utf-8")
    if b in (0xdc, 0xdd):                           # array 16/32
        n = r.unpack(">H" if b == 0xdc else ">I")
        return [_read(r) for _ in range(n)]
    if b in (0xde, 0xdf):                           # map 16/32
        return _read_map(r, r.unpack(">H" if b == 0xde else ">I"))
    raise ValueError(f"unsupported msgpack type byte 0x{b:02x}")


def _read_map(r: _Reader, n: int) -> dict:
    out = {}
    for _ in range(n):
        k = _read(r)
        out[k] = _read(r)
    return out


def unpackb(payload: bytes) -> Any:
    """Decode one msgpack object (flax's subset; ext 1 -> numpy array)."""
    r = _Reader(payload)
    out = _read(r)
    if r.pos != len(r.buf):
        raise ValueError("trailing bytes after msgpack object")
    return out


def _pack(obj: Any, out: bytearray) -> None:
    if obj is None:
        out.append(0xc0)
    elif obj is True or obj is False:
        out.append(0xc3 if obj else 0xc2)
    elif isinstance(obj, int):
        if 0 <= obj < 0x80:
            out.append(obj)
        elif -32 <= obj < 0:
            out.append(obj & 0xff)
        elif obj >= 0:
            for code, fmt, top in ((0xcc, ">B", 1 << 8), (0xcd, ">H", 1 << 16),
                                   (0xce, ">I", 1 << 32), (0xcf, ">Q", 1 << 64)):
                if obj < top:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise ValueError(f"int {obj} too large for msgpack")
        else:
            for code, fmt, lo in ((0xd0, ">b", -(1 << 7)), (0xd1, ">h", -(1 << 15)),
                                  (0xd2, ">i", -(1 << 31)), (0xd3, ">q", -(1 << 63))):
                if obj >= lo:
                    out += bytes([code]) + struct.pack(fmt, obj)
                    return
            raise ValueError(f"int {obj} too small for msgpack")
    elif isinstance(obj, float):
        out += b"\xcb" + struct.pack(">d", obj)
    elif isinstance(obj, str):
        _pack_sized(out, obj.encode("utf-8"), 0xa0, 32, (0xd9, 0xda, 0xdb))
    elif isinstance(obj, (bytes, bytearray)):
        _pack_sized(out, bytes(obj), None, 0, (0xc4, 0xc5, 0xc6))
    elif isinstance(obj, (list, tuple)):
        _pack_header(out, len(obj), 0x90, 16, (None, 0xdc, 0xdd))
        for v in obj:
            _pack(v, out)
    elif isinstance(obj, dict):
        _pack_header(out, len(obj), 0x80, 16, (None, 0xde, 0xdf))
        for k, v in obj.items():
            _pack(k, out)
            _pack(v, out)
    elif isinstance(obj, np.ndarray):
        if obj.dtype.hasobject:
            raise ValueError("object arrays do not serialize")
        data = packb((obj.shape, obj.dtype.name, obj.tobytes("C")))
        fixed = {1: 0xd4, 2: 0xd5, 4: 0xd6, 8: 0xd7, 16: 0xd8}
        if len(data) in fixed:
            out.append(fixed[len(data)])
        else:
            _pack_header(out, len(data), None, 0, (0xc7, 0xc8, 0xc9))
        out += struct.pack(">b", _EXT_NDARRAY) + data
    else:
        raise TypeError(f"cannot serialize {type(obj).__name__}")


def _pack_header(out: bytearray, n: int, fix, fix_limit: int, codes) -> None:
    """A length header: the fix form below fix_limit, else the 8/16/32-bit
    forms of ``codes`` (None where msgpack has no such form)."""
    if fix is not None and n < fix_limit:
        out.append(fix | n)
        return
    for code, fmt, top in zip(codes, (">B", ">H", ">I"),
                              (1 << 8, 1 << 16, 1 << 32)):
        if code is not None and n < top:
            out += bytes([code]) + struct.pack(fmt, n)
            return
    raise ValueError(f"msgpack length {n} too large")


def _pack_sized(out: bytearray, data: bytes, fix, fix_limit: int, codes) -> None:
    _pack_header(out, len(data), fix, fix_limit, codes)
    out += data


def packb(obj: Any) -> bytes:
    """Encode one object as msgpack the way flax.serialization writes a
    state dict: maps in insertion order, Python floats as doubles, bytes as
    bin, numpy arrays as ext 1."""
    out = bytearray()
    _pack(obj, out)
    return bytes(out)


# ---------------------------------------------------------------------------
# Weights bridge: JAX/flax parameter trees -> the port's state dicts
# ---------------------------------------------------------------------------

def filter_state_from_jax(geometry: Geometry, tree: Dict) -> Dict[str, torch.Tensor]:
    """Map a flax ConvFilter tree ``{"params": {"layerN": {"kernel", "bias"}}}``
    (numpy arrays) onto ``models.filters.ConvFilter``'s state dict. Dense
    kernels go (kh, kw, cin, cout) -> (cout, cin, kh, kw); a SparseConvMap
    layer keeps its sparse (kh, kw, nto, nout) kernel (the module rebuilds
    the same dense kernel from its connection table)."""
    params = tree["params"] if "params" in tree else tree
    state = {}
    for i in range(len(geometry.layers)):
        name = f"layer{i + 1}"
        k = np.asarray(params[name]["kernel"], np.float32)
        b = np.asarray(params[name]["bias"], np.float32)
        cin, kh, kw, cout = geometry.layers[i]
        prev_cout = geometry.layers[i - 1][3] if i > 0 else cin
        if i > 0 and prev_cout != cin:
            if k.shape != (kh, kw, cin, cout):
                raise ValueError(f"{name}: sparse kernel shape {k.shape}")
            state[f"{name}.kernel"] = torch.from_numpy(k.copy())
        else:
            if k.shape != (kh, kw, prev_cout if i > 0 else cin, cout):
                raise ValueError(f"{name}: kernel shape {k.shape}")
            state[f"{name}.weight"] = torch.from_numpy(
                np.ascontiguousarray(k.transpose(3, 2, 0, 1)))
        state[f"{name}.bias"] = torch.from_numpy(b.copy())
    return state


def _prefixed(prefix: str, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    return {prefix + k: v for k, v in state.items()}


def multiscale_state_from_jax(geometry: Geometry, tree: Dict) -> Dict[str, torch.Tensor]:
    """Map a flax multiscale tree onto ``models.multiscale.MultiscaleFlowModel``'s
    state dict: the shared trunk (``{"params": ...}``) or one trunk per scale
    (``{"scales": {"scale{s}": {"params": ...}}}``) into ``filters.{s}.*``,
    and the trainable cascade weights ``{"cascade": {"betas"}}`` into
    ``betas``. A shared tree under a geometry with unshared filters fills
    every scale's trunk with it, as the reference then reads it."""
    n = len(geometry.ratios)
    state = {}
    if "scales" in tree:
        if geometry.share_filters:
            raise ValueError("per-scale trunks under a shared-filters geometry")
        for s in range(n):
            state.update(_prefixed(f"filters.{s}.", filter_state_from_jax(
                geometry, tree["scales"][f"scale{s}"])))
    else:
        trunk = filter_state_from_jax(geometry, tree)
        for s in range(1 if geometry.share_filters else n):
            state.update(_prefixed(f"filters.{s}.", trunk))
    if geometry.cascad_trainable_weights:
        state["betas"] = torch.from_numpy(
            np.array(tree["cascade"]["betas"], np.float32))
    return state


def _conv_state(name: str, p: Dict) -> Dict[str, torch.Tensor]:
    """A flax nn.Conv's (kh, kw, cin, cout) kernel and bias as a
    ``DenseConv``'s (cout, cin, kh, kw) weight and bias."""
    k = np.asarray(p["kernel"], np.float32)
    if k.ndim != 4:
        raise ValueError(f"{name}: conv kernel shape {k.shape}")
    return {f"{name}.weight": torch.from_numpy(
                np.ascontiguousarray(k.transpose(3, 2, 0, 1))),
            f"{name}.bias": torch.from_numpy(np.array(p["bias"], np.float32))}


def radial_state_from_jax(layers, tree: Dict) -> Dict[str, torch.Tensor]:
    """Map a flax RadialFilter tree ``{"params": {"layer{i}": {"kernel",
    "bias"}}}`` onto ``models.radial.RadialFlowNetwork``'s state dict
    (``filter.layer{i}.*``); ``layers`` is the radial spec."""
    params = tree["params"] if "params" in tree else tree
    n = sum(1 for l in layers if not isinstance(l, str))
    state = {}
    for i in range(1, n + 1):
        state.update(_conv_state(f"filter.layer{i}", params[f"layer{i}"]))
    return state


def legacy_state_from_jax(tree: Dict) -> Dict[str, torch.Tensor]:
    """Map a flax tree of the legacy models onto their state dicts:
    ``LegacyFlowModel``'s bare nn.Conv (``{"params": {"kernel", "bias"}}``)
    into ``conv.*``; ``DepthClassifierCNN``'s ``conv1..3`` into DenseConvs
    and its nn.Dense ``classifier`` (an (in, out) kernel) into an
    nn.Linear."""
    params = tree["params"] if "params" in tree else tree
    if "kernel" in params:
        return _conv_state("conv", params)
    state = {}
    for name in ("conv1", "conv2", "conv3"):
        state.update(_conv_state(name, params[name]))
    dense = params["classifier"]
    state["classifier.weight"] = torch.from_numpy(
        np.ascontiguousarray(np.asarray(dense["kernel"], np.float32).T))
    state["classifier.bias"] = torch.from_numpy(
        np.array(dense["bias"], np.float32))
    return state


# ---------------------------------------------------------------------------
# Weights bridge: the port's modules -> JAX/flax parameter trees
# ---------------------------------------------------------------------------

def _np(t: torch.Tensor) -> np.ndarray:
    return np.ascontiguousarray(t.detach().cpu().numpy(), np.float32)


def _conv_tree(state: Dict[str, torch.Tensor], name: str) -> Dict:
    """A ``DenseConv``'s weight and bias as a flax nn.Conv's (kh, kw, cin,
    cout) kernel and bias. The inverse of ``_conv_state``."""
    return {"kernel": _np(state[f"{name}.weight"].permute(2, 3, 1, 0)),
            "bias": _np(state[f"{name}.bias"])}


def filter_tree(geometry: Geometry, state: Dict[str, torch.Tensor]) -> Dict:
    """A ``ConvFilter`` state dict as the flax ConvFilter tree
    ``{"params": {"layerN": {"kernel", "bias"}}}`` of numpy arrays: dense
    weights (cout, cin, kh, kw) -> kernels (kh, kw, cin, cout), sparse
    kernels as they are. The inverse of ``filter_state_from_jax``."""
    params = {}
    for i in range(len(geometry.layers)):
        name = f"layer{i + 1}"
        if f"{name}.kernel" in state:
            params[name] = {"kernel": _np(state[f"{name}.kernel"]),
                            "bias": _np(state[f"{name}.bias"])}
        else:
            params[name] = _conv_tree(state, name)
    return {"params": params}


def multiscale_tree(geometry: Geometry, state: Dict[str, torch.Tensor]) -> Dict:
    """A ``MultiscaleFlowModel`` state dict as the flax multiscale tree:
    the shared trunk's ``{"params": ...}`` or ``{"scales": {"scale{s}":
    {"params": ...}}}``, then ``{"cascade": {"betas"}}`` with trainable
    cascade weights. The inverse of ``multiscale_state_from_jax``."""
    def trunk(s):
        p = f"filters.{s}."
        return filter_tree(geometry, {k[len(p):]: v for k, v in state.items()
                                      if k.startswith(p)})
    if geometry.share_filters:
        tree = trunk(0)
    else:
        tree = {"scales": {f"scale{s}": trunk(s)
                           for s in range(len(geometry.ratios))}}
    if geometry.cascad_trainable_weights:
        tree["cascade"] = {"betas": _np(state["betas"])}
    return tree


def radial_tree(layers, state: Dict[str, torch.Tensor]) -> Dict:
    """A ``RadialFlowNetwork`` state dict as the flax RadialFilter tree
    ``{"params": {"layer{i}": {"kernel", "bias"}}}``; ``layers`` is the
    radial spec. The inverse of ``radial_state_from_jax``."""
    n = sum(1 for l in layers if not isinstance(l, str))
    return {"params": {f"layer{i}": _conv_tree(state, f"filter.layer{i}")
                       for i in range(1, n + 1)}}


def legacy_tree(state: Dict[str, torch.Tensor]) -> Dict:
    """A ``LegacyFlowModel`` (``{"params": {"kernel", "bias"}}``) or
    ``DepthClassifierCNN`` (``conv1..3`` and the nn.Dense ``classifier``,
    an (in, out) kernel) state dict as its flax tree. The inverse of
    ``legacy_state_from_jax``."""
    if "conv.weight" in state:
        return {"params": _conv_tree(state, "conv")}
    params = {name: _conv_tree(state, name)
              for name in ("conv1", "conv2", "conv3")}
    params["classifier"] = {"kernel": _np(state["classifier.weight"].T),
                            "bias": _np(state["classifier.bias"])}
    return {"params": params}


def model_tree(model) -> Dict:
    """The flax tree of a ``FlowModel``, ``MultiscaleFlowModel``,
    ``ConvFilter``, ``RadialFlowNetwork``, ``V2Network``,
    ``DepthClassifierCNN`` or ``LegacyFlowModel`` (numpy leaves)."""
    from .filters import ConvFilter
    from .flow import FlowModel
    from .legacy_depth import DepthClassifierCNN, LegacyFlowModel
    from .multiscale import MultiscaleFlowModel
    from .radial import RadialFlowNetwork
    from .version2 import V2Network
    if isinstance(model, MultiscaleFlowModel):
        return multiscale_tree(model.geometry, model.state_dict())
    if isinstance(model, RadialFlowNetwork):
        return radial_tree(model.layers, model.state_dict())
    if isinstance(model, (DepthClassifierCNN, LegacyFlowModel)):
        return legacy_tree(model.state_dict())
    if isinstance(model, (FlowModel, V2Network)):
        model = model.filter
    if isinstance(model, ConvFilter):
        return filter_tree(model.geometry, model.state_dict())
    raise TypeError(f"no flax tree for {type(model).__name__}")


def load_tree_into(model, tree: Dict):
    """Load a flax tree (numpy leaves) into any module ``model_tree``
    takes. Returns the module."""
    from .filters import ConvFilter
    from .flow import FlowModel
    from .legacy_depth import DepthClassifierCNN, LegacyFlowModel
    from .multiscale import MultiscaleFlowModel
    from .radial import RadialFlowNetwork
    from .version2 import V2Network
    if isinstance(model, MultiscaleFlowModel):
        model.load_state_dict(multiscale_state_from_jax(model.geometry, tree))
    elif isinstance(model, RadialFlowNetwork):
        model.load_state_dict(radial_state_from_jax(model.layers, tree))
    elif isinstance(model, (DepthClassifierCNN, LegacyFlowModel)):
        model.load_state_dict(legacy_state_from_jax(tree))
    elif isinstance(model, (FlowModel, V2Network, ConvFilter)):
        trunk = model if isinstance(model, ConvFilter) else model.filter
        trunk.load_state_dict(filter_state_from_jax(trunk.geometry, tree))
    else:
        raise TypeError(f"cannot load a flax tree into {type(model).__name__}")
    return model


# ---------------------------------------------------------------------------
# Checkpoint directories
# ---------------------------------------------------------------------------

def model_dir_name(geom: Geometry, learning: Learning) -> str:
    """Hyperparameter-encoded directory name."""
    layers = "-".join("_".join(map(str, l)) for l in geom.layers)
    parts = [
        f"model={layers}",
        f"win={geom.maxh}x{geom.maxw}",
        f"img={geom.hImg}x{geom.wImg}",
        f"ms={'-'.join(map(str, geom.ratios)) if geom.multiscale else 'no'}"
        + ("" if not geom.multiscale or geom.share_filters else ",sf=0"),
        f"head={geom.output_extraction_method}",
        f"crit={learning.criterion}",
        f"lr={learning.rate}",
        f"lrd={learning.rate_decay}",
        f"wd={learning.weight_decay}",
    ]
    return ",".join(parts)


def save_model(path: str, geom: Geometry, learning: Learning, params: Any,
               score_history: Optional[list] = None, epoch: int = 0) -> str:
    """Write <path>/{meta.json, params.msgpack}; ``params`` is a model
    (``model_tree``) or a flax tree of numpy arrays. Returns path."""
    if isinstance(params, torch.nn.Module):
        params = model_tree(params)
    os.makedirs(path, exist_ok=True)
    meta = {
        "version": FORMAT_VERSION,
        "geometry": dataclasses.asdict(geom),
        "learning": dataclasses.asdict(learning),
        "score": score_history or [],
        "epoch": epoch,
    }
    with open(os.path.join(path, "meta.json"), "w") as f:
        json.dump(meta, f, indent=1)
    with open(os.path.join(path, "params.msgpack"), "wb") as f:
        f.write(packb(params))
    return path


def _restore(template: Any, tree: Any, where: str = "") -> Any:
    """``tree`` in the structure of ``template`` (dicts with the same keys,
    arrays of the same shapes), as flax's from_bytes restores it."""
    if isinstance(template, dict):
        if not isinstance(tree, dict) or set(tree) != set(template):
            raise ValueError(f"checkpoint tree at {where or '/'} has keys "
                             f"{sorted(tree) if isinstance(tree, dict) else tree!r}, "
                             f"expected {sorted(template)}")
        return {k: _restore(template[k], tree[k], f"{where}/{k}")
                for k in template}
    arr = np.asarray(tree)
    if arr.shape != np.shape(template):
        raise ValueError(f"{where}: shape {arr.shape}, expected "
                         f"{np.shape(template)}")
    return arr


def load_weights_into(path: str, template: Any) -> Any:
    """Finetune path: the weights of a checkpoint directory's
    ``params.msgpack``, or of the weights file ``path`` (a radial
    ``e{N}.msgpack``, a version2 ``e{N}``), into ``template``: a module
    (any ``model_tree`` takes; loaded in place and returned) or a flax tree
    (a tree of the same structure is returned)."""
    if os.path.isdir(path):
        path = os.path.join(path, "params.msgpack")
    with open(path, "rb") as f:
        tree = unpackb(f.read())
    if isinstance(template, torch.nn.Module):
        _restore(model_tree(template), tree)
        return load_tree_into(template, tree)
    return _restore(template, tree)


def _write_weights(path: str, model) -> None:
    with open(path, "wb") as f:
        f.write(packb(model_tree(model)))


def _write_meta(directory: str, meta: dict) -> None:
    with open(os.path.join(directory, "meta.json"), "w") as f:
        json.dump(meta, f)


def save_radial_checkpoint(directory: str, model, epoch: int) -> str:
    """The radial trainer's weights-only save of ``epoch``:
    ``<directory>/e{epoch}.msgpack`` and ``meta.json`` ``{"version": 1,
    "layers", "hWin"}``, each 'tanh' of the spec as the string. Returns the
    weights file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"e{epoch}.msgpack")
    _write_weights(path, model)
    _write_meta(directory, {
        "version": 1,
        "layers": [l if isinstance(l, str) else list(l) for l in model.layers],
        "hWin": model.h_win})
    return path


def save_v2_checkpoint(directory: str, model, epoch: int) -> str:
    """The version2 trainer's save of ``epoch``: the bare weights file
    ``<directory>/e{epoch}`` and ``meta.json`` with ``"family":
    "version2"`` and the network's data parameters. Returns the weights
    file's path."""
    os.makedirs(directory, exist_ok=True)
    path = os.path.join(directory, f"e{epoch}")
    _write_weights(path, model)
    d = model.datap
    _write_meta(directory, {
        "version": 1, "family": "version2", "wImg": d.wImg, "hImg": d.hImg,
        "normalization_k": d.normalization_k,
        "layers": [list(l) for l in d.layers], "hWin": d.hWin,
        "wWin": d.wWin})
    return path


def save_legacy_checkpoint(directory: str, model, discretizer, patch: int,
                           score_history: Optional[list] = None) -> str:
    """The legacy depth classifier's save: ``<directory>/params.msgpack``
    and ``meta.json`` ``{n_classes, cut_depth, bin_step, patch, score}``
    (``discretizer`` a ``data.depth_legacy.DepthDiscretizer``, the score
    the per-epoch history). Returns the directory."""
    os.makedirs(directory, exist_ok=True)
    _write_weights(os.path.join(directory, "params.msgpack"), model)
    _write_meta(directory, {
        "n_classes": discretizer.n_classes,
        "cut_depth": discretizer.cut_depth,
        "bin_step": discretizer.bin_step, "patch": patch,
        "score": score_history or []})
    return directory


def load_model(path: str) -> Tuple[Geometry, Learning, Dict, dict]:
    """Rebuild (geometry, learning, params, meta) from a version-9
    checkpoint directory; ``params`` is the flax tree as numpy arrays
    (feed it to ``filter_state_from_jax``, or to
    ``multiscale_state_from_jax`` for a multiscale geometry). Rejects other
    versions. A multiscale checkpoint whose meta says unshared filters but
    whose tree holds one shared trunk (written before per-scale trunks
    existed) comes back with its geometry corrected to shared filters."""
    with open(os.path.join(path, "meta.json")) as f:
        meta = json.load(f)
    if meta.get("version") != FORMAT_VERSION:
        raise ValueError(
            f"checkpoint version {meta.get('version')} unsupported "
            f"(need {FORMAT_VERSION})")
    gd = dict(meta["geometry"])
    gd["layers"] = tuple(tuple(l) for l in gd["layers"])
    gd["ratios"] = tuple(gd["ratios"])
    geom = Geometry(**gd)
    learning = Learning(**meta["learning"])
    with open(os.path.join(path, "params.msgpack"), "rb") as f:
        params = unpackb(f.read())
    if geom.multiscale and not geom.share_filters and "scales" not in params:
        geom = dataclasses.replace(geom, share_filters=True)
    return geom, learning, params, meta


def load_filter(path: str, device="cuda"):
    """Checkpoint directory -> (geometry, ConvFilter with its weights on
    ``device``: the card by default; raises where there is none unless given
    ``device="cpu"``)."""
    from ..utils.device import resolve
    from .filters import ConvFilter
    dev = resolve(device)
    geom, _, params, _ = load_model(path)
    trunk = ConvFilter(geom)
    trunk.load_state_dict(filter_state_from_jax(geom, params))
    return geom, trunk.to(dev)
