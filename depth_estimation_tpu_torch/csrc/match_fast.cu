// Kernel B2 for Hopper (sm_90a): the norm-decomposed patch matcher on f32,
// bf16 or f16 storage, cells visited dx-major. It replaces the Pallas TPU
// kernel depth_estimation_tpu/ops/matching.py:366 (_fast_kernel, called by
// match_flow_fast at :452). The Python wrapper is
// depth_estimation_tpu_torch/ops/matching.py:match_flow_fast, and its plain
// twin match_flow_fast_plain computes the same arithmetic in the same
// order. The body, what bounds it and what its design does about it are in
// match_decomposed.cuh, which this file instantiates with columns outer
// and rows inner in the walk of the staged halo. At the matching core's
// shape (B=128, 150x290x10, 16x16) it is bound by instruction issue: 49
// SASS instructions a cell, an issue floor of 2.09 ms; measured 3.248 ms
// in bf16 through the wrapper and 3.035 ms in f32 (NVIDIA H100 80GB HBM3,
// 700.00 W, chip_smoke.py), against 6.112 / 5.598 ms for the one-pixel-a-
// thread design it replaced.

#include "match_decomposed.cuh"

// f1 (B, H, W, K), f2 (B, H + maxh - 1, W + maxw - 1, K), channels last,
// stored as ``storage`` says (0 f32, 1 bf16, 2 f16; -1 for another code);
// idx int32 and ey, ex, pmax f32, each (B, H, W). rx, ry, tx_n, ty_n,
// band_h, band_w: the launch plan (ops/matching.py:match_plan), the same
// for every storage type, since the halo is staged in f32.
extern "C" int match_fast_launch(const void* f1, const void* f2, void* idx,
                                 void* ey, void* ex, void* pmax, int B, int H,
                                 int W, int K, int maxh, int maxw, int storage,
                                 int rx, int ry, int tx_n, int ty_n,
                                 int band_h, int band_w, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0:
      return match_decomposed::dispatch<float, true>(
          f1, f2, idx, ey, ex, pmax, B, H, W, K, maxh, maxw, rx, ry, tx_n,
          ty_n, band_h, band_w, st);
    case 1:
      return match_decomposed::dispatch<__nv_bfloat16, true>(
          f1, f2, idx, ey, ex, pmax, B, H, W, K, maxh, maxw, rx, ry, tx_n,
          ty_n, band_h, band_w, st);
    case 2:
      return match_decomposed::dispatch<__half, true>(
          f1, f2, idx, ey, ex, pmax, B, H, W, K, maxh, maxw, rx, ry, tx_n,
          ty_n, band_h, band_w, st);
  }
  return -1;
}
