"""Version-9 checkpoint loading (load side of ``depth_estimation_tpu.models.io``)
and the weights bridge from the JAX parameter tree.

A checkpoint directory holds ``meta.json`` (format version, geometry,
learning) and ``params.msgpack`` (flax's serialization of the parameter
tree). The machine that runs the port has neither flax nor msgpack, so
``unpackb`` below decodes the subset of msgpack that flax writes: maps,
arrays, strings, binaries, integers, floats, nil/bool, and ext type 1 —
a packed ndarray ``(shape, dtype name, raw little-endian bytes)``.
"""

from __future__ import annotations

import dataclasses
import json
import os
import struct
from typing import Any, Dict, Tuple

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
