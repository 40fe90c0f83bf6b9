"""Build and load the package's CUDA kernels.

The sources in ``csrc/*.cu`` (with the headers they include from
``csrc/``) expose a plain C interface. They are compiled
at first use with nvcc for Hopper (``sm_90a``), one nvcc process per source,
all started together, each into its own shared library under
``_build/<hash of the sources and flags>/``, and loaded with ctypes; the
build takes seconds because no source includes PyTorch's headers. The
libraries are built only when a wrapper is handed a CUDA tensor, never at
import, so the package imports on machines without nvcc or a card.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from collections import Counter
from functools import lru_cache
from pathlib import Path

import torch

_PKG = Path(__file__).resolve().parent.parent
CSRC = _PKG / "csrc"
BUILD_ROOT = _PKG / "_build"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signatures by source (``csrc/<stem>.cu``): every function takes the
# stream last and returns a cudaError_t (0 = success) or a negative code
# for a configuration it does not support.
SIGNATURES = {
    "match_fused": {
        # f1, f2, idx, ey, ex, pmax, extra, scratch, B, H, W, K, maxh, maxw,
        # block_rows, band_cols, storage, want_marg, want_conf,
        # conf_threshold, stream
        "match_fused_launch": [_P] * 8 + [_I] * 11 + [_F, _P],
    },
    "warp_banded": {
        # img, xs, ys, out, B, H, W, C, band, storage, stream
        "warp_banded_launch": [_P, _P, _P, _P, _I, _I, _I, _I, _I, _I, _P],
    },
    "sor_redblack": {
        # w_w, w_e, w_n, w_s, denom_u, denom_v, b1, b2, imdxy, du, dv, B, H,
        # W, n_sor, neg_alpha, omega, one_minus_omega, cluster, rows, mode,
        # device, stream
        "sor_redblack_launch": [_P] * 11 + [_I] * 4 + [_F] * 3 + [_I] * 4
                               + [_P],
        # du, dv, B, H, W, n_sor, cluster, rows, mode, device, stream
        "sor_redblack_probe_launch": [_P, _P] + [_I] * 8 + [_P],
    },
    "match_fast": {
        # f1, f2, idx, ey, ex, pmax, B, H, W, K, maxh, maxw, storage, rx,
        # ry, tx_n, ty_n, band_h, band_w, stream
        "match_fast_launch": [_P] * 6 + [_I] * 13 + [_P],
    },
    "match_throughput": {
        # f1, f2, idx, ey, ex, pmax, B, H, W, K, maxh, maxw, rx, ry, tx_n,
        # ty_n, band_h, band_w, stream
        "match_throughput_launch": [_P] * 6 + [_I] * 12 + [_P],
    },
    "liu_warp": {
        # im1, im2, u, v, du, dv, u_out, v_out, warp, part_sum, part_cnt,
        # lap, B, H, W, C, px_per_block, stream
        "liu_warp_launch": [_P] * 12 + [_I] * 5 + [_P],
        # img, out, B, H, W, C, h, w, rx, ry, scale, px_per_block, stream
        "liu_resize_launch": [_P, _P] + [_I] * 6 + [_F] * 3 + [_I, _P],
    },
    "liu_irls": {
        # im1f, warp, u, v, du, dv, lap_para, w_w, w_e, w_n, w_s, denom_u,
        # denom_v, b1, b2, imdxy, consts (host), n_consts, B, H, W, C, stream
        "liu_irls_launch": [_P] * 17 + [_I] * 5 + [_P],
    },
    "contrastive_norm": {
        # img, coef, mean, std, taps (host), k, B, H, W, C, stream
        "contrastive_norm_stats_launch": [_P] * 5 + [_I] * 5 + [_P],
        # img, mean, std, frame_mean, out, B, H, W, C, stream
        "contrastive_norm_apply_launch": [_P] * 5 + [_I] * 4 + [_P],
    },
    "vpu_peak": {
        # x, out, n, n_iter, variant, threads, blocks_per_sm, stream
        "vpu_peak_launch": [_P, _P] + [_I] * 5 + [_P],
    },
}
SOURCES = tuple(f"{stem}.cu" for stem in SIGNATURES)
# the ``storage`` code of B1, B2 and B3: the type their features (B3: image)
# are stored in; every value is upcast to f32 as it is read
STORAGE = {torch.float32: 0, torch.bfloat16: 1, torch.float16: 2}


def _nvcc() -> str:
    for cand in (shutil.which("nvcc"),
                 os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"),
                              "bin", "nvcc")):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")


def _digest() -> str:
    """Hash of the flags and of every file under csrc/, so that an edited
    header a source includes rebuilds as an edited source does."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.is_file():
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


class KernelLibrary:
    """The loaded shared libraries (one per source), with their build facts."""

    def __init__(self, paths: dict, build_seconds: float, log: str):
        self.paths = paths
        self.build_seconds = build_seconds
        self.log = log
        self.libs = {stem: ctypes.CDLL(str(p)) for stem, p in paths.items()}
        self.fns = {}
        for stem, sigs in SIGNATURES.items():
            for name, argtypes in sigs.items():
                fn = getattr(self.libs[stem], name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
                self.fns[name] = fn

    def call(self, name: str, device, *args) -> None:
        """Call a launcher for tensors on ``device``: with that device
        current (``torch.cuda.device``), on its current stream, and raise on
        any launch error the C side reports. Kernels for tensors on one card
        are never queued on another card's stream."""
        device = torch.device(device)
        with torch.cuda.device(device):
            stream = torch.cuda.current_stream(device).cuda_stream
            err = self.fns[name](*args, stream)
        if err != 0:
            raise RuntimeError(f"{name} failed with code {err} "
                               f"({_error_name(err)})")


def _error_name(err: int) -> str:
    if err == -4:
        return "the tensors' card is not the current device"
    if err < 0:
        return "unsupported configuration"
    return "cudaError %d" % err


def build() -> KernelLibrary:
    """Compile (if not already built for these sources) and load."""
    out_dir = BUILD_ROOT / _digest()
    stems = [Path(s).stem for s in SOURCES]
    paths = {s: out_dir / f"lib{s}.so" for s in stems}
    log_path = out_dir / "build.log"
    if all(p.exists() for p in paths.values()):
        return KernelLibrary(paths, 0.0, log_path.read_text()
                             if log_path.exists() else "")
    out_dir.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    t0 = time.perf_counter()
    procs = {}
    for s in stems:
        tmp = out_dir / f"lib{s}.{os.getpid()}.so"
        procs[s] = (tmp, subprocess.Popen(
            [nvcc, *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{s}.cu")],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True))
    logs, failed = [], []
    for s, (tmp, proc) in procs.items():
        out, _ = proc.communicate()
        logs.append(f"== {s}.cu\n{out}")
        if proc.returncode != 0:
            failed.append(f"{s}.cu ({proc.returncode})")
    seconds = time.perf_counter() - t0
    log = "".join(logs)
    if failed:
        raise RuntimeError(f"nvcc failed for {', '.join(failed)}:\n{log}")
    for s, (tmp, _) in procs.items():
        os.replace(tmp, paths[s])
    log_path.write_text(log)
    return KernelLibrary(paths, seconds, log)


_BUILD_LOCK = threading.Lock()
_COUNT_LOCK = threading.Lock()
# launches by (wrapper name, device), beside each wrapper's own total
LAUNCHES_BY_DEVICE: Counter = Counter()


@lru_cache(maxsize=1)
def _library() -> KernelLibrary:
    return build()


def library() -> KernelLibrary:
    """The process's kernel libraries, built on first use (once, when the
    shards of a mesh ask from several threads at a time)."""
    with _BUILD_LOCK:
        return _library()


def count_launch(wrapper, device) -> None:
    """Add one to ``wrapper.launches`` and to its count on ``device``
    (``LAUNCHES_BY_DEVICE``); the shards of a mesh launch from several
    threads."""
    with _COUNT_LOCK:
        wrapper.launches += 1
        LAUNCHES_BY_DEVICE[(wrapper.__name__, str(device))] += 1


def check_cuda_tensor(name: str, t: torch.Tensor, dtypes, ndim: int) -> None:
    """Raise unless ``t`` is a contiguous CUDA tensor of one of ``dtypes``."""
    if not t.is_cuda:
        raise ValueError(f"{name}: expected a CUDA tensor, got {t.device}")
    if t.dtype not in dtypes:
        raise ValueError(f"{name}: dtype {t.dtype} not in {dtypes}")
    if t.ndim != ndim:
        raise ValueError(f"{name}: expected {ndim} dims, got {tuple(t.shape)}")
    if not t.is_contiguous():
        raise ValueError(f"{name}: tensor must be contiguous")
