"""Speed-of-light report for the port's hot kernels, and the bound formulas
that PERF.md's kernel table uses.

Counterpart of the JAX package's ``benchmarks/speed_of_light.py``. For each
kernel, at its main path's shapes, timed back to back (``CALLS`` calls
between CUDA events, median of 3), the least time it could take:
  t_compute = FP32 flops at the FMA rate + exps at the expf rate
              + tensor-core flops at the bf16 rate,
  t_memory  = bytes read once and written once at the HBM rate,
  t_gather  = gathered indices at the gather's index rate,
and %SoL = max(t_compute, t_memory, t_gather) / t_measured, once against
the MEASURED ceilings (``device_peaks``) and once against the PUBLISHED
peaks of an H100 SXM at 700 W (NVIDIA's data sheet: 3.35 TB/s, 67 TFLOP/s
FP32, 989 TFLOP/s bf16 on tensor cores; the SFU's 16 results a clock an
SM at the 1.98 GHz boost clock; no published gather rate).

Operations and bytes are counted for the port's own formulation, as
PERF.md's bound column counts them: each input read once, each output
written once; the matchers' FP32 operations a window cell as
``matcher_work`` counts them, plus one exp a cell. The JAX report scores
the banded warp's TPU shift-sum ((2b+2)^2 shifts a pixel); the port runs
a 4-tap gather, and B3 is scored as that. The conv trunk's flops come from
its shapes (checked against ``torch.utils.flop_counter``) and are charged
at the FP32 rate: with TF32 off cuDNN runs them on the CUDA cores.

CONTRACT (the JAX report's): a row above 100% of the measured ceiling
means the ceiling model is broken (an op count overcounts, or a ceiling
under-measures its unit), not that the kernel beats the hardware; such a
row is marked ``impossible`` and the report exits nonzero. So does any
measured ceiling above 105% of its published peak.

Run on the card, after ``device_peaks`` (its JSON must be of this card):

    python -m depth_estimation_tpu_torch.benchmarks.speed_of_light [--peaks PATH]

``--device cpu`` runs the harness on tiny shapes through the plain twins;
its numbers are not ceilings and are labelled "cpu".
"""

from __future__ import annotations

import argparse
import json
import statistics
from pathlib import Path

import torch

from depth_estimation_tpu_torch.benchmarks import device_peaks as dp
from depth_estimation_tpu_torch.utils.device import resolve
from depth_estimation_tpu_torch.utils.precision import full_f32

# H100 SXM published peaks (NVIDIA's data sheet, 700 W): HBM bytes/s, FP32
# FLOP/s outside the tensor cores, dense bf16 FLOP/s on the tensor cores
PEAK_BYTES = 3.35e12
PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
CLOCK_HZ = 1.98e9           # the SM boost clock, for issue floors
PEAK_SFU = 132 * 16 * CLOCK_HZ      # exps/s: 16 SFU results a clock an SM
# the measured ceilings that have a published peak, in the meter's units
PUBLISHED = {"vpu_fma_f32_gflops": PEAK_FP32 / 1e9,
             "vpu_exp_gops": PEAK_SFU / 1e9,
             "tc_bf16_tflops": PEAK_BF16 / 1e12,
             "hbm_stream_gbps": PEAK_BYTES / 1e9}
OVER_PUBLISHED = 1.05       # a measured ceiling above this share is broken
CALLS = 10                  # back-to-back calls a timing
CAR_LAYERS = ((3, 5, 5, 8), (8, 12, 12, 10))    # examples/car_model's trunk

# the main paths' shapes on the card; tiny ones for the CPU harness
SHAPES = {
    "cuda": dict(match=(128, 150, 290, 10, 16), warp=(128, 165, 305, 10, 8),
                 sor=(8, 192, 256, 40), celiu=(8, 192, 256, 5),
                 trunk=(128, 180, 320)),
    "cpu": dict(match=(1, 6, 10, 10, 4), warp=(1, 9, 13, 4, 2),
                sor=(1, 16, 16, 40), celiu=(1, 12, 16, 5), trunk=(1, 24, 32)),
}


def bound_ms(nbytes, flops):
    """The least time the card could take: the larger of the bytes over the
    HBM rate and the FP32 operations over the FP32 peak. Returns (ms, 'bytes'
    or 'operations')."""
    tb, to = nbytes / PEAK_BYTES, flops / PEAK_FP32
    return 1e3 * max(tb, to), ("bytes" if tb >= to else "operations")


def matcher_work(f1, f2, maxh, maxw, n_out, flops_per_cell, extra_bytes=0):
    """A fused matcher's (bytes, flops): f1 and f2 (and ``extra_bytes`` of
    other inputs) read once, n_out (B, H, W) 4-byte outputs written once;
    flops_per_cell per pixel and window cell."""
    B, H, W, _ = f1.shape
    nbytes = (f1.numel() * f1.element_size() + f2.numel() * f2.element_size()
              + n_out * B * H * W * 4 + extra_bytes)
    return nbytes, B * H * W * maxh * maxw * flops_per_cell


def matcher_bound(f1, f2, maxh, maxw, n_out, flops_per_cell, extra_bytes=0):
    """``bound_ms`` of ``matcher_work``."""
    return bound_ms(*matcher_work(f1, f2, maxh, maxw, n_out, flops_per_cell,
                                  extra_bytes))


def warp_work(imgs, xs, ys):
    """B3's (bytes, flops): the image read once in its storage type, the
    coordinates, the f32 output written once; 7 FP32 operations a value
    (four weighted taps summed)."""
    return (imgs.numel() * imgs.element_size() + xs.numel() * 4
            + ys.numel() * 4 + imgs.numel() * 4, imgs.numel() * 7)


def sor_work(planes, n_sor):
    """B4's (bytes, flops): nine planes read and du, dv written once; 30 FP32
    operations a pixel and iteration."""
    return 11 * planes[0].numel() * 4, planes[0].numel() * n_sor * 30


def liu_warp_work(im1, update=True, noise=True):
    """The liu warp kernel's (bytes, flops) for frames im1 (B, H, W, C):
    u and v read (and with ``update`` du, dv read and u, v written), frame 1
    and frame 2 read once and the warp written, 4 bytes each; a pixel's
    coordinates, range test, clamp, corner and weights (22 FP32
    operations, 2 more for the update), and a value's four-tap blend (7)
    and noise terms (|It|, its two bounds and the sum: 4)."""
    n_pix = im1.numel() // im1.shape[-1]
    C = im1.shape[-1]
    flow = 4 if update else 2
    nbytes = 4 * n_pix * (flow + (2 if update else 0) + 3 * C)
    flops = n_pix * (22 + (2 if update else 0) + C * (7 + (4 if noise else 0)))
    return nbytes, flops


def liu_irls_work(im1f, warm=False):
    """The IRLS kernel's (bytes, flops) for features im1f (B, H, W, C): both
    features, u and v (and a warm start's du, dv) read and the nine planes
    written once, 4 bytes each; 89 C + 47 FP32 operations a pixel (the
    solve's count of an IRLS step, h100bench's ``liu_counts.IRLS_PER_PX`` =
    492 at C = 5)."""
    n_pix = im1f.numel() // im1f.shape[-1]
    C = im1f.shape[-1]
    return (4 * n_pix * (2 * C + (4 if warm else 2) + 9),
            n_pix * (89 * C + 47))


def resize_work(img, h, w):
    """Liu's resize's (bytes, flops): img read once, the (h, w) output
    written once; a pixel's two coordinate divisions and subtractions, the
    clamp, corner and weights (22) and a value's blend and scale (8)."""
    lead = img.numel() // (img.shape[-3] * img.shape[-2] * img.shape[-1])
    C = img.shape[-1]
    return (4 * (img.numel() + lead * h * w * C),
            lead * h * w * (22 + 8 * C))


def liu_warp_inputs(gen, B, H, W, C, dev):
    """Frames in [0, 1] and a flow of a few px with its increments, as a
    liu solve's warp sees them: (im1, im2, u, v, du, dv)."""
    def rnd(scale):
        return scale * torch.randn(B, H, W, generator=gen, device=dev)
    im1 = torch.rand(B, H, W, C, generator=gen, device=dev)
    im2 = torch.rand(B, H, W, C, generator=gen, device=dev)
    return im1, im2, rnd(2.0), rnd(2.0), rnd(0.3), rnd(0.3)


def sor_planes(gen, B, H, W, dev):
    """Random well-conditioned SOR planes as the solver builds them: zero
    boundary weights, denominators above the weights' sum."""
    from depth_estimation_tpu_torch.flow import celiu

    def rnd():
        return torch.rand(B, H, W, generator=gen, device=dev)
    alpha = 0.3
    w = celiu._neighbor_weights(rnd() + 0.1)
    coeff = alpha * (w[0] + w[1] + w[2] + w[3])
    return (*w, rnd() + 0.5 + coeff, rnd() + 0.5 + coeff,
            torch.randn(B, H, W, generator=gen, device=dev),
            torch.randn(B, H, W, generator=gen, device=dev),
            (rnd() - 0.5) * 0.1), alpha


def trunk_flops(layers, B, H, W):
    """Flops of a VALID conv trunk on (B, H, W, C) frames: the sum over
    layers of 2 B Ho Wo Cin Cout kh kw, Cin the channels the layer's dense
    kernel reads (the previous layer's outputs)."""
    total, cprev = 0, layers[0][0]
    for cin, kh, kw, cout in layers:
        H, W = H - kh + 1, W - kw + 1
        total += 2 * B * H * W * cprev * cout * kh * kw
        cprev = cout
    return total


def _published(t_meas, flops, n_exp, nbytes, mm_flops):
    t_compute = flops / PEAK_FP32 + n_exp / PEAK_SFU + mm_flops / PEAK_BF16
    t_mem = nbytes / PEAK_BYTES
    t_sol = max(t_compute, t_mem)
    return {"sol_ms_published": round(t_sol * 1e3, 4),
            "pct_sol_published": round(100.0 * t_sol / t_meas, 1),
            "bound_published": "memory" if t_mem >= t_compute else "compute"}


def roofline(name, t_meas, flops, n_exp, nbytes, peaks, mm_flops=0.0,
             n_idx=0.0):
    """One report row (the JAX report's ``_roofline``): ``flops`` FP32
    flops charged at the measured FMA rate (2 flops an FFMA), ``n_exp`` at
    the expf rate, ``mm_flops`` at the bf16 tensor-core rate, ``nbytes`` at
    the HBM rate, ``n_idx`` gathered indices at the gather's index rate;
    plus the same bound at the published peaks (``*_published``)."""
    t_alu = flops / (peaks["vpu_fma_f32_gflops"] * 1e9)
    t_exp = n_exp / (peaks["vpu_exp_gops"] * 1e9)
    t_mm = mm_flops / (peaks["tc_bf16_tflops"] * 1e12)
    t_mem = nbytes / (peaks["hbm_stream_gbps"] * 1e9)
    t_idx = (n_idx / (peaks["gather_idx_gops"] * 1e9)
             if n_idx else 0.0)
    t_compute = t_alu + t_exp + t_mm
    t_sol = max(t_compute, t_mem, t_idx)
    bound = ("gather" if t_idx >= max(t_compute, t_mem)
             else "memory" if t_mem >= t_compute else "compute")
    row = {
        "kernel": name,
        "measured_ms": round(t_meas * 1e3, 4),
        "sol_ms": round(t_sol * 1e3, 4),
        "pct_sol": round(100.0 * t_sol / t_meas, 1),
        "bound": bound,
        "compute_ms": round(t_compute * 1e3, 4),
        "memory_ms": round(t_mem * 1e3, 4),
        "gather_ms": round(t_idx * 1e3, 4),
    }
    row.update(_published(t_meas, flops, n_exp, nbytes, mm_flops))
    return row


def contract_failures(peaks, rows, sweep=None) -> list:
    """Every breach of the CONTRACT on the card: each measured ceiling (and
    each rate of P2's ``sweep``, if given) above OVER_PUBLISHED of its
    published peak, and each row marked ``impossible``. Empty for numbers
    taken on the CPU, which are no ceilings."""
    if peaks["device"] != "cuda":
        return []
    out = [f"ceiling {k} above {OVER_PUBLISHED:.0%} of its published peak"
           for k, v in PUBLISHED.items() if peaks[k] > OVER_PUBLISHED * v]
    fp32 = PUBLISHED["vpu_fma_f32_gflops"]
    for w, by_chains in (sweep or {}).get("warps_an_sm", {}).items():
        out += [f"P2 {c} chains at {w} warps an SM above {OVER_PUBLISHED:.0%}"
                f" of the published FP32 peak"
                for c, r in by_chains.items()
                if r["gflops"] > OVER_PUBLISHED * fp32]
    out += [f"row {r['kernel']} above 100% of the measured ceiling"
            for r in rows if r.get("impossible")]
    return out


def back_to_back_ms(fn, dev) -> float:
    """ms a call of fn with CALLS calls queued back to back (median of 3)."""
    def run(n):
        for _ in range(n):
            fn()
    dp.elapsed_ms(run, 1, dev)
    return statistics.median(dp.elapsed_ms(run, CALLS, dev)
                             for _ in range(3)) / CALLS


def _features(gen, B, H, W, K, win, dev):
    f1 = 0.5 * torch.randn(B, H, W, K, generator=gen, device=dev)
    f2 = 0.5 * torch.randn(B, H + win - 1, W + win - 1, K, generator=gen,
                           device=dev)
    return f1, f2


def kernel_rows(dev):
    """(name, fn, flops, n_exp, bytes, n_idx) of every row at ``dev``'s
    shapes: B1 (bf16, f32), B2 (bf16), B5 (f32), B3 (f32, bf16), B4, the
    liu warp kernel and the conv trunk."""
    from depth_estimation_tpu_torch.flow import liu_warp, sor_kernel
    from depth_estimation_tpu_torch.geometry import Geometry
    from depth_estimation_tpu_torch.geometry3d import undistort
    from depth_estimation_tpu_torch.geometry3d.calibration import ARDRONE
    from depth_estimation_tpu_torch.models.filters import ConvFilter, init_params
    from depth_estimation_tpu_torch.ops import matching, warp
    from depth_estimation_tpu_torch.ops import matching_experimental as mexp
    s = SHAPES[dev.type]
    gen = torch.Generator(device=dev).manual_seed(0)
    rows = []
    B, H, W, K, win = s["match"]
    f1, f2 = _features(gen, B, H, W, K, win, dev)
    cells = B * H * W * win * win
    bf = torch.bfloat16
    for name, fn, dt, n_out, per_cell in (
            ("B1 match_flow_fused bf16", lambda: matching.match_flow_fused(
                f1, f2, win, win, 8, False, bf, True), bf, 5, 3 * K + 5),
            ("B1 match_flow_fused f32", lambda: matching.match_flow_fused(
                f1, f2, win, win, 8, False, torch.float32, True),
             torch.float32, 5, 3 * K + 5),
            ("B2 match_flow_fast bf16", lambda: matching.match_flow_fast(
                f1, f2, win, win, 32, bf), bf, 4, 2 * K + 3 + 7),
            ("B5 match_flow_throughput f32",
             lambda: mexp.match_flow_throughput(f1, f2, win, win),
             torch.float32, 4, 2 * K + 3 + 7)):
        nbytes, flops = matcher_work(
            torch.empty(f1.shape, dtype=dt, device="meta"),
            torch.empty(f2.shape, dtype=dt, device="meta"), win, win, n_out,
            per_cell)
        rows.append((name, fn, flops, cells, nbytes, 0))
    B, H, W, C, band = s["warp"]
    Ks = ARDRONE.K.copy()
    Ks[0] *= W / ARDRONE.wImg
    Ks[1] *= H / ARDRONE.hImg
    R = torch.eye(3, device=dev).expand(B, 3, 3).clone()
    R[:, 0, 2], R[:, 2, 0] = 0.01, -0.01
    xs, ys = undistort.homography_grid(Ks, R, H, W)
    imgs = torch.randn(B, H, W, C, generator=gen, device=dev)
    for dt, label in ((torch.float32, "f32"), (bf, "bf16")):
        im = imgs.to(dt)
        nbytes, flops = warp_work(im, xs, ys)
        rows.append((f"B3 banded_bilinear_warp {label}",
                     lambda im=im: warp.banded_bilinear_warp(im, xs, ys, band),
                     flops, 0, nbytes, 0))
    B, H, W, n_sor = s["sor"]
    planes, alpha = sor_planes(gen, B, H, W, dev)
    nbytes, flops = sor_work(planes, n_sor)
    rows.append((f"B4 sor_redblack ({n_sor} iterations)",
                 lambda: sor_kernel.sor_redblack(*planes, alpha=alpha,
                                                 n_sor=n_sor),
                 flops, 0, nbytes, 0))
    B, H, W, C = s["celiu"]
    warp_in = liu_warp_inputs(gen, B, H, W, C, dev)
    nbytes, flops = liu_warp_work(warp_in[0])
    rows.append(("liu warp kernel (update, packed-tap warp, noise)",
                 lambda: liu_warp.warp_update_noise(*warp_in, noise=True),
                 flops, 0, nbytes, 0))
    B, H, W = s["trunk"]
    geom = Geometry(hImg=H, wImg=W, layers=CAR_LAYERS, maxh=16, maxw=16)
    trunk = ConvFilter(geom).to(dev)
    with torch.no_grad():
        init_params(trunk, torch.Generator().manual_seed(0))
    frames = torch.rand(B, H, W, 3, generator=gen, device=dev)
    Ho = H - geom.hKernel + 1
    Wo = W - geom.wKernel + 1

    def run_trunk():
        with torch.no_grad(), full_f32():
            return trunk(frames)
    rows.append(("conv trunk (car_model, f32, TF32 off)", run_trunk,
                 trunk_flops(CAR_LAYERS, B, H, W), 0,
                 frames.numel() * 4 + B * Ho * Wo * CAR_LAYERS[-1][3] * 4, 0))
    return rows


def report(peaks, dev) -> list:
    """Every row timed on ``dev`` against ``peaks``; on the card a row above
    100% of the measured ceiling is marked ``impossible``."""
    dev = resolve(dev)
    out = []
    for name, fn, flops, n_exp, nbytes, n_idx in kernel_rows(dev):
        ms = back_to_back_ms(fn, dev)
        row = roofline(name, ms / 1e3, flops, n_exp, nbytes, peaks,
                       n_idx=n_idx)
        row["device"] = dev.type
        if dev.type == "cuda" and row["pct_sol"] > 100.0:
            row["impossible"] = True
        out.append(row)
    return out


def load_peaks(path, dev) -> dict:
    """The meter's JSON; refused if it was taken on another card."""
    path = Path(path)
    if not path.exists():
        raise SystemExit(f"run depth_estimation_tpu_torch.benchmarks."
                         f"device_peaks first (no {path})")
    peaks = json.loads(path.read_text())
    kind = torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"
    if peaks.get("kind") != kind:
        raise SystemExit(f"{path} was measured on {peaks.get('kind')!r} but "
                         f"this run is on {kind!r}; run device_peaks here")
    return peaks


@full_f32()
def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--peaks", default=str(dp.OUT_DIR / "device_peaks.json"))
    ap.add_argument("--json", default=str(dp.OUT_DIR / "speed_of_light.json"))
    args = ap.parse_args(argv)
    dev = resolve(args.device)
    peaks = load_peaks(args.peaks, dev)
    rows = report(peaks, dev)
    hdr = (f"{'kernel':40s} {'measured':>10s} {'SoL':>10s} {'%SoL':>6s} "
           f"{'bound':>8s} {'%pub':>6s}")
    print(hdr)
    print("-" * len(hdr))
    for r in rows:
        print(f"{r['kernel']:40s} {r['measured_ms']:>8.3f}ms "
              f"{r['sol_ms']:>8.3f}ms {r['pct_sol']:>5.1f}% {r['bound']:>8s} "
              f"{r['pct_sol_published']:>5.1f}%"
              + ("  <-- IMPOSSIBLE (ceiling model broken)"
                 if r.get("impossible") else ""))
    failures = contract_failures(peaks, rows)
    path = dp.write_json({"device": dev.type, "kind": peaks["kind"],
                          "card": peaks["card"], "peaks": peaks,
                          "contract_failures": failures, "kernels": rows},
                         args.json)
    print(f"wrote {path}")
    if failures:
        print(f"CEILING MODEL BROKEN: {failures}")
        return 1
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
