// Kernel B5 for Hopper (sm_90a): the throughput matcher, kernel B2's
// function on f32 features with cells visited dy-major. It replaces the
// Pallas TPU kernel
// depth_estimation_tpu/ops/matching_experimental.py:35 (_lanes_kernel,
// called by match_flow_throughput at :104). The TPU kernel puts the frame
// batch on the 128 vector lanes and is handed the squared norms; neither
// carries over: here the kernel computes |f1|^2 and |f2|^2 itself, in k
// order from the values it reads (the sums the plain twin
// depth_estimation_tpu_torch/ops/matching_experimental.py:
// match_flow_throughput_plain is handed), and reads only f1 and f2. The
// body, what bounds it and what its design does about it are in
// match_decomposed.cuh, which this file instantiates with rows outer and
// columns inner in the walk of the staged halo. At the throughput core's
// shape (B=128, 150x290x10, 16x16) it is bound by instruction issue: 48.1
// SASS instructions a cell, an issue floor of 2.05 ms; measured 2.988 ms
// with its norms (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py),
// against 7.421 ms for the design it replaced, whose wrapper summed the
// norms in plain torch (5.175 ms for its kernel alone).

#include "match_decomposed.cuh"

// f1 (B, H, W, K), f2 (B, H + maxh - 1, W + maxw - 1, K), channels last, f32;
// idx int32 and ey, ex, pmax f32, each (B, H, W). rx, ry, tx_n, ty_n,
// band_h, band_w: the launch plan (ops/matching.py:match_plan, dy-major).
extern "C" int match_throughput_launch(const void* f1, const void* f2,
                                       void* idx, void* ey, void* ex,
                                       void* pmax, int B, int H, int W, int K,
                                       int maxh, int maxw, int rx, int ry,
                                       int tx_n, int ty_n, int band_h,
                                       int band_w, void* stream) {
  return match_decomposed::dispatch<float, false>(
      f1, f2, idx, ey, ex, pmax, B, H, W, K, maxh, maxw, rx, ry, tx_n, ty_n,
      band_h, band_w, static_cast<cudaStream_t>(stream));
}
