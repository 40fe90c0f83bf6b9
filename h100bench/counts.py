"""The yardstick's operation and byte counts, and the card's published peaks.

A frozen copy of the port's ``benchmarks/speed_of_light`` formulas
(``bound_ms``, ``matcher_work``, ``trunk_flops`` and the peaks), so that
the benchmark's rooflines do not move when the program does. Work is
counted from the shapes of each call: each input read once, each output
written once, the operations the algorithm needs, whatever implements it.

Peaks: one NVIDIA H100 SXM at its 700 W limit (NVIDIA's data sheet, dense
rates): 3.35 TB/s of HBM and 67 TFLOP/s of FP32 outside the tensor cores.
Every entry point of the port turns TF32 off, so cuDNN's f32 convolutions
and the matchers run on the FP32 pipes and are charged at 67 TFLOP/s.
"""

from __future__ import annotations

PEAK_BYTES = 3.35e12        # HBM bytes/s
PEAK_FP32 = 67e12           # FP32 FLOP/s outside the tensor cores


def b1_flops_per_cell(K: int) -> int:
    """FP32 operations a pixel and window cell of the fused matcher (B1):
    a subtraction, a multiplication and an addition a channel, and 5 for
    the online softmax, the soft-argmax and the WTA scan; 35 at K = 10, as
    the port's kernel table counts it."""
    return 3 * K + 5


def bound_s(nbytes: float, flops: float) -> float:
    """The least time the card could take, in seconds: the larger of the
    bytes over the HBM rate and the FP32 operations over the FP32 peak."""
    return max(nbytes / PEAK_BYTES, flops / PEAK_FP32)


def bound_ms(nbytes: float, flops: float):
    """``bound_s`` in ms, and which of the two bounds it: 'bytes' or
    'operations'."""
    tb, to = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def matcher_work(f1_shape, f2_shape, elem_bytes: int, maxh: int, maxw: int,
                 n_out: int, flops_per_cell: float):
    """A fused matcher's (bytes, flops): f1 (B, H, W, K) and f2 read once
    in their storage type, n_out (B, H, W) 4-byte outputs written once;
    ``flops_per_cell`` a pixel and window cell."""
    B, H, W, _ = f1_shape
    n1 = _numel(f1_shape)
    n2 = _numel(f2_shape)
    nbytes = (n1 + n2) * elem_bytes + n_out * B * H * W * 4
    return nbytes, B * H * W * maxh * maxw * flops_per_cell


def ssd_work(f1_shape, f2_shape, maxh: int, maxw: int):
    """The SSD cost volume's (bytes, flops) (the multiscale decode's
    ``match_ssd``): f1 (..., H, W, K) and f2 read once in f32, the
    (..., H, W, maxh maxw) f32 volume written once; a subtraction, a
    multiplication and an addition a channel and cell."""
    K = f1_shape[-1]
    cells = _numel(f1_shape[:-1]) * maxh * maxw
    nbytes = (_numel(f1_shape) + _numel(f2_shape)) * 4 + cells * 4
    return nbytes, cells * 3 * K


def trunk_flops(layers, B: int, H: int, W: int) -> int:
    """FLOPs of a VALID conv trunk on (B, H, W, C) frames: the sum over
    layers of 2 B Ho Wo Cin Cout kh kw, Cin the channels the layer's dense
    kernel reads (the previous layer's outputs)."""
    total, cprev = 0, layers[0][0]
    for cin, kh, kw, cout in layers:
        H, W = H - kh + 1, W - kw + 1
        total += 2 * B * H * W * cprev * cout * kh * kw
        cprev = cout
    return total


def trunk_work(layers, B: int, H: int, W: int):
    """The trunk's (bytes, flops): the f32 input frames and the weights
    read once, the f32 features written once."""
    nbytes, cprev, h, w = B * H * W * layers[0][0] * 4, layers[0][0], H, W
    for cin, kh, kw, cout in layers:
        h, w = h - kh + 1, w - kw + 1
        nbytes += (cprev * cout * kh * kw + cout) * 4
        cprev = cout
    return nbytes + B * h * w * cprev * 4, trunk_flops(layers, B, H, W)


def _numel(shape) -> int:
    n = 1
    for s in shape:
        n *= int(s)
    return n
