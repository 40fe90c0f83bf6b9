// The norm-decomposed patch matcher for Hopper (sm_90a), shared by kernels
// B2 (match_fast.cu, dx-major, f32, bf16 or f16 storage) and B5
// (match_throughput.cu, dy-major, f32): over a maxh x maxw window, the
// logit t = (2<f1, f2> - |f2|^2) - |f1|^2 (= -SSD), one online softmax over
// all cells, winner-take-all, soft-argmax and pmax = 1/s, in one pass. The
// cost volume is never stored. The two sources instantiate this body and
// keep their C entry points.
//
// What bounds it. At the matching core's shape (B=128, 150x290 outputs,
// K=10, 16x16 window) the kernel evaluates 1.43e9 cells. Bit parity with
// the plain twins keeps every multiply and add apart (no FMA): 2K-1 for the
// cross term, 3 for the logit, then the online softmax's exp (CUDA's
// accurate expf, ~8 instructions), a compare, two selects and the three
// sums' five products and three adds, and the WTA's two selects: ~45
// instructions a cell, ~1.9 ms of issue slots on 132 SMs x 128 lanes at
// 1.98 GHz. The
// feature reads (0.2-0.5 GB) take ~0.1 ms. So the kernel is bound by
// instruction issue. The design before this one (one thread a pixel) also
// paid K shared-memory loads a cell, in bf16 a conversion each, a branch
// on every new maximum and a test for the middle cell in every cell:
// B2 6.10 ms bf16, 5.68 ms f32; B5 5.11 ms, 7.32 ms with the norms its
// wrapper computed in plain torch (H100 80GB HBM3, 700 W).
//
// What the design does about it.
//  * Register blocking in two dimensions: a thread owns RX x RY output
//    pixels. It walks the (RY + maxh - 1) x (RX + maxw - 1) staged halo
//    positions its pixels' windows cover, once each; the value at halo
//    (r, c) is cell (dy = r - j, dx = c - q) of its pixel (j, q), so one
//    load of a position's channels serves every pixel whose window holds
//    it. B2 walks columns outer and rows inner, so each pixel still sees
//    its cells dx outer, dy inner, the twin's order; B5 walks rows outer
//    and columns inner (dy-major). Loads a cell and channel fall from 1 to
//    (RX + maxw - 1)(RY + maxh - 1) / (RX RY maxw maxh): 0.16 at 4x2 and
//    16x16. Positions where every pixel's cell lies in its window take a
//    body without per-pixel tests, unrolled by two so that the next
//    position's loads are issued early.
//  * The halo is staged position-major in f32: a position's KC channels,
//    then its |f2|^2 (summed in k order from the staged values, as the twin
//    sums the stored values), padded to an odd number of float4s, so one
//    128-bit load brings four of them. A quarter-warp's eight lanes form a
//    (8 / RX) x RX patch of threads and each pair of halo rows is skewed by
//    one position, which puts the eight lanes' 16-byte loads in eight
//    different bank groups: no conflicts. bf16 and f16 are converted once,
//    while staging; staging steps a (row, column) pair by the block size
//    without a division or modulo an element, and the halo's |f2|^2 needs
//    no second pass.
//  * The online softmax has no branch: with e = exp(-|t - m|), the twin's
//    update s exp(m - max) + exp(t - max) (and sy, sx with the offsets)
//    is s e + 1 when the logit t beats the running max m and s 1 + e
//    otherwise, since m - t is exactly -(t - m) and exp(0) = 1. So two
//    selects, the old sums' factor (e or 1) and the cell's weight (1 or
//    e), shared by s, sy and sx, give the twin's bits (products with 1
//    are exact), and the WTA index takes the same compare. The middle
//    cell's logit, needed only for the tie-break, is computed once after
//    the window with the same operations.
//  * Rounded intrinsics (__fmul_rn, __fadd_rn, __fsub_rn) keep nvcc from
//    contracting into FMAs, and expf (not __expf) is torch's exp, so the
//    kernels round as their twins do.
//  * Every window and channel count. A window whose halo fits on no tile
//    is walked in bands, one band's halo staged at a time in the same
//    place: B2 takes whole columns of the window, as many as fit, and
//    where not even one column fits, one column in pieces of rows; B5 the
//    same with rows and columns swapped. Either keeps each pixel's cells in
//    its twin's order, so the running max, sums and WTA index carry from
//    band to band in registers unchanged; the band's halo is held to half
//    an SM's shared memory so that two blocks share an SM and one stages
//    while the other walks. Channel counts are rounded up to 4, 8, 10, 16,
//    32 or 64 (a pixel a thread at 64, at most 256 threads a block, so a
//    thread may hold 255 registers); above 64 the kernel takes K at run
//    time, one pixel a thread, reading its features from f1 at every cell
//    and the halo's channels one float at a time: slower, but it rounds as
//    the twin does. The plan (ops/matching.py:match_plan) then fails only
//    where one cell's halo on an 8 x 8 tile exceeds 227 KB, above K = 811.
// What is left. The SASS of the plan's 2x2 body (cuobjdump, read by
// chip_smoke.py) holds 49 instructions a cell for B2 and 48.1 for B5, the
// loop's counter and loads included: an issue floor of 2.09 / 2.05 ms at
// the matching core's shape. Measured (NVIDIA H100 80GB HBM3, 700.00 W,
// chip_smoke.py, SM clock 1980 MHz under load): B2 bf16 3.248 ms through
// its wrapper (the f32 -> bf16 cast included), f32 3.035 ms, B5 with its
// norms 2.988 ms, against 6.112 / 5.598 / 7.421 ms for the design before
// in the same call; stage_profile.py's profiler gives the kernels alone
// 2.95 ms (B2 bf16) and 2.87 ms (B5) of device time, ~70% of the issue
// floor. Of the blockings timed, 4x2 (230
// registers, 8 warps an SM) ran 3.8-4.2 ms, 4x1 3.1-3.3, 2x1 (32 warps)
// 2.95-3.23, within noise of 2x2 (124 registers, 16 warps). With the band
// loop the walk's SASS holds 48.9 / 48.1 instructions a cell and B2 f32 and
// B5 128 registers (two blocks an SM still): B2 bf16 3.261-3.373 ms, B5
// 3.008-3.065 ms against 3.220-3.259 and 2.941-3.053 ms for the parent in
// the same calls (NVIDIA H100 80GB HBM3, 700.00 W).
// The launch plan (blocking, threads across and down a tile, the band)
// comes from ops/matching.py:match_plan, which holds the same halo size
// rule as halo_bytes below; the launcher refuses a plan whose halo exceeds
// 227 KB (-2), whose blocking is not compiled here, or whose band breaks
// the visit order (-1).

#pragma once

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace match_decomposed {

constexpr float NEG_INF = -3.4e38f;
constexpr size_t SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// floats a staged position holds: kc channels and |f2|^2, padded to an odd
// number of float4s
__host__ __device__ constexpr int slot_floats(int kc) {
  return (((kc + 4) / 4) | 1) * 4;
}

// threads a block may hold: 1024 / (RX RY), and 256 where a thread keeps 64
// channels in registers or reads them at run time (KC = 0), so that it may
// hold up to 255 registers
__host__ __device__ constexpr int max_threads(int kc, int rx, int ry) {
  return (kc == 0 || kc >= 64) ? 256 : 1024 / (rx * ry);
}

// halo row pitch in positions: row R starts at R * pitch + R / ry, so one
// thread row down (ry halo rows) moves ry * pitch + 1 positions, which the
// pitch keeps odd
__host__ __device__ inline int row_pitch(int cols, int ry) {
  return cols + ((ry * cols) & 1);
}

// the halo of a tile for a band of bh x bw window cells
inline size_t halo_bytes(int kc, int ry, int tile_h, int tile_w, int bh,
                         int bw) {
  const int rows = tile_h + bh - 1;
  const int cols = tile_w + bw - 1;
  const size_t positions =
      (size_t)(rows - 1) * row_pitch(cols, ry) + (rows - 1) / ry + cols;
  return positions * slot_floats(kc) * sizeof(float);
}

// One halo position (r, c), relative to the thread's first in the staged
// band, for each of the thread's pixels whose band holds it (CHECK: test
// each pixel against the band's eh x ew cells; else all do): the cross
// term in k order, the logit, the branch-free online-softmax update and the
// WTA select. fr0 and fc0 turn (r, c) into the centred offsets; bi keeps
// r * maxw + c, from which the band's and the pixel's offsets are taken
// later. KC = 0: K channels, the pixel's (RX = RY = 1) read from f1 at a_rt.
template <bool CHECK, int KC, int RX, int RY, typename T>
__device__ __forceinline__ void visit(
    const float4* __restrict__ pos, int r, int c, int eh, int ew, int maxw,
    int fr0, int fc0, const float (&a)[RY][RX][KC > 0 ? KC : 1],
    const T* __restrict__ a_rt, int K, const float (&n1)[RY][RX],
    float (&bm)[RY][RX], int (&bi)[RY][RX], float (&s)[RY][RX],
    float (&sy)[RY][RX], float (&sx)[RY][RX]) {
  constexpr int NV = KC > 0 ? slot_floats(KC) / 4 : 1;
  float v[4 * NV];
  float n2;
  if constexpr (KC > 0) {
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      const float4 w = pos[i];
      v[4 * i] = w.x;
      v[4 * i + 1] = w.y;
      v[4 * i + 2] = w.z;
      v[4 * i + 3] = w.w;
    }
    n2 = v[KC];
  } else {
    n2 = reinterpret_cast<const float*>(pos)[K];
  }
  const float fr = (float)(r + fr0);
  const float fc = (float)(c + fc0);
  const int cell = r * maxw + c;
#pragma unroll
  for (int j = 0; j < RY; ++j) {
#pragma unroll
    for (int q = 0; q < RX; ++q) {
      if (CHECK && ((unsigned)(r - j) >= (unsigned)eh ||
                    (unsigned)(c - q) >= (unsigned)ew))
        continue;
      float cross;
      if constexpr (KC > 0) {
        cross = __fmul_rn(a[j][q][0], v[0]);
#pragma unroll
        for (int k = 1; k < KC; ++k)
          cross = __fadd_rn(cross, __fmul_rn(a[j][q][k], v[k]));
      } else {
        const float* pf = reinterpret_cast<const float*>(pos);
        cross = __fmul_rn(to_f(a_rt[0]), pf[0]);
        for (int k = 1; k < K; ++k)
          cross = __fadd_rn(cross, __fmul_rn(to_f(a_rt[k]), pf[k]));
      }
      const float t = __fsub_rn(__fsub_rn(__fmul_rn(2.f, cross), n2), n1[j][q]);
      const float offy = __fsub_rn(fr, (float)j);   // dy - halfh1, exact
      const float offx = __fsub_rn(fc, (float)q);   // dx - halfw1, exact
      const float m = bm[j][q];
      const bool up = t > m;
      const float e = expf(-fabsf(__fsub_rn(t, m)));
      const float scale = up ? e : 1.f;     // the old sums' factor
      const float w = up ? 1.f : e;         // this cell's weight
      s[j][q] = __fadd_rn(__fmul_rn(s[j][q], scale), w);
      sy[j][q] = __fadd_rn(__fmul_rn(sy[j][q], scale), __fmul_rn(w, offy));
      sx[j][q] = __fadd_rn(__fmul_rn(sx[j][q], scale), __fmul_rn(w, offx));
      bm[j][q] = up ? t : m;
      bi[j][q] = up ? cell : bi[j][q];
    }
  }
}

// KC: channel count rounded up to a compiled size; channels K..KC-1 are
// zero in both operands, which adds exact zeros to every sum; KC = 0 takes
// K at run time. A block of tx_n x ty_n threads covers a (ty_n RY) x (tx_n
// RX) output tile. The window is walked in bands of band_h x band_w cells:
// whole inner lines (columns for DX_MAJOR) band_w (band_h) at a time, or,
// where one line's halo does not fit, one outer line in pieces; a band's
// halo is staged, walked, and the next staged in its place.
template <typename T, bool DX_MAJOR, int KC, int RX, int RY>
__global__ void __launch_bounds__(max_threads(KC, RX, RY))
match_decomposed_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                        int32_t* __restrict__ idx_out,
                        float* __restrict__ ey_out, float* __restrict__ ex_out,
                        float* __restrict__ pmax_out, int H, int W, int K,
                        int maxh, int maxw, int tx_n, int ty_n, int band_h,
                        int band_w) {
  static_assert(KC > 0 || (RX == 1 && RY == 1),
                "K at run time takes one pixel a thread");
  constexpr int KA = KC > 0 ? KC : 1;
  constexpr int PA = 8 / RX;           // a quarter-warp: PA x RX threads
  const int NV = slot_floats(KC > 0 ? KC : K) / 4;
  extern __shared__ __align__(16) float4 halo[];
  const int tile_w = tx_n * RX;
  const int tile_h = ty_n * RY;
  const int rows = tile_h + band_h - 1;
  const int cols = tile_w + band_w - 1;
  const int pitch = row_pitch(cols, RY);
  const int H2 = H + maxh - 1;
  const int W2 = W + maxw - 1;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * tile_h;
  const int x0 = blockIdx.x * tile_w;
  const int nthreads = tx_n * ty_n;
  const int tid = threadIdx.x;
  const T* f2b = f2 + (size_t)b * H2 * W2 * K;

  // this thread's place: lanes 8p .. 8p+7 form a PA x RX patch of threads
  // (patch p); where the tile holds whole warps of 2 x 2 patches, a warp's
  // four patches are laid 2 x 2, a square footprint, so that fewer warps
  // straddle the image's last row or column
  const int p = tid >> 3;
  const int l = tid & 7;
  const int across = tx_n / PA;
  const int down = ty_n / RX;
  int px = p % across, py = p / across;
  if (across % 2 == 0 && down % 2 == 0) {
    px = (p >> 2) % (across / 2) * 2 + (p & 1);
    py = (p >> 2) / (across / 2) * 2 + ((p >> 1) & 1);
  }
  const int tx = px * PA + l % PA;
  const int ty = py * RX + l / PA;
  const int yb = y0 + ty * RY;
  const int xb = x0 + tx * RX;
  // a thread whose pixels all lie off the image stages and meets the
  // barriers, and computes nothing; a warp of such threads idles
  const bool active = yb < H && xb < W;

  float a[RY][RX][KA];
  float n1[RY][RX];
  const T* a_rt =
      f1 + (((size_t)b * H + (active ? yb : 0)) * W + (active ? xb : 0)) * K;
#pragma unroll
  for (int j = 0; j < RY; ++j) {
#pragma unroll
    for (int q = 0; q < RX; ++q) {
      const bool in = yb + j < H && xb + q < W;
      float n = 0.f;
      if constexpr (KC > 0) {
        const T* f1p = f1 + (((size_t)b * H + yb + j) * W + xb + q) * K;
#pragma unroll
        for (int k = 0; k < KC; ++k) {
          a[j][q][k] = (in && k < K) ? to_f(f1p[k]) : 0.f;
          if (k < K) n = __fadd_rn(n, __fmul_rn(a[j][q][k], a[j][q][k]));
        }
      } else {
        a[j][q][0] = 0.f;
        for (int k = 0; k < K; ++k) {
          const float v = in ? to_f(a_rt[k]) : 0.f;
          n = __fadd_rn(n, __fmul_rn(v, v));
        }
      }
      n1[j][q] = n;
    }
  }

  const int halfh1 = (maxh + 1) / 2 - 1;   // ceil(maxh/2) - 1
  const int halfw1 = (maxw + 1) / 2 - 1;
  const int mid = halfh1 * maxw + halfw1;

  float bm[RY][RX], s[RY][RX], sy[RY][RX], sx[RY][RX], tmid[RY][RX];
  int bi[RY][RX];
#pragma unroll
  for (int j = 0; j < RY; ++j) {
#pragma unroll
    for (int q = 0; q < RX; ++q) {
      bm[j][q] = NEG_INF;
      s[j][q] = 0.f;
      sy[j][q] = 0.f;
      sx[j][q] = 0.f;
      tmid[j][q] = 0.f;
      bi[j][q] = j * maxw + q;   // d = 0 until a cell beats NEG_INF
    }
  }

  // the thread's first halo position: row RY ty starts at RY ty pitch + ty
  const float4* base = halo + (size_t)(ty * RY * pitch + ty + tx * RX) * NV;
  // the bands, outer index o0 (columns for B2, rows for B5), inner i0
  const int len_o = DX_MAJOR ? maxw : maxh;
  const int len_i = DX_MAJOR ? maxh : maxw;
  const int step_o = DX_MAJOR ? band_w : band_h;
  const int step_i = DX_MAJOR ? band_h : band_w;
  bool first = true;
  for (int o0 = 0; o0 < len_o; o0 += step_o) {
    for (int i0 = 0; i0 < len_i; i0 += step_i) {
      const int dy0 = DX_MAJOR ? i0 : o0;
      const int dx0 = DX_MAJOR ? o0 : i0;
      const int eh = min(band_h, maxh - dy0);   // the band's cells
      const int ew = min(band_w, maxw - dx0);
      if (!first) __syncthreads();   // the last band's readers are done
      first = false;

      // stage the band's f2 halo in f32 with each position's |f2|^2, zero
      // off the image and in channels K..KC-1; (r, c) steps by the block
      // size
      {
        int r = tid / cols;
        int c = tid - r * cols;
        while (r < rows) {
          const int gy = y0 + dy0 + r;
          const int gx = x0 + dx0 + c;
          const bool in = gy < H2 && gx < W2;
          const T* src = f2b + ((size_t)gy * W2 + gx) * K;
          float4* dst = halo + (size_t)(r * pitch + r / RY + c) * NV;
          if constexpr (KC > 0) {
            constexpr int NVC = slot_floats(KC) / 4;
            float v[4 * NVC];
            float n = 0.f;
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              v[k] = (in && k < K) ? to_f(src[k]) : 0.f;
              if (k < K) n = __fadd_rn(n, __fmul_rn(v[k], v[k]));
            }
            v[KC] = n;
#pragma unroll
            for (int k = KC + 1; k < 4 * NVC; ++k) v[k] = 0.f;
#pragma unroll
            for (int i = 0; i < NVC; ++i)
              dst[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                                   v[4 * i + 3]);
          } else {
            float* d = reinterpret_cast<float*>(dst);
            float n = 0.f;
            for (int k = 0; k < K; ++k) {
              const float v = in ? to_f(src[k]) : 0.f;
              n = __fadd_rn(n, __fmul_rn(v, v));
              d[k] = v;
            }
            d[K] = n;
            for (int k = K + 1; k < 4 * NV; ++k) d[k] = 0.f;
          }
          c += nthreads;
          while (c >= cols) {
            c -= cols;
            ++r;
          }
        }
      }
      __syncthreads();
      if (!active) continue;

      // bi counts r * maxw + c from the band's first cell while it is walked
      const int cell0 = dy0 * maxw + dx0;
#pragma unroll
      for (int j = 0; j < RY; ++j)
#pragma unroll
        for (int q = 0; q < RX; ++q) bi[j][q] -= cell0;
      const int fr0 = dy0 - halfh1;
      const int fc0 = dx0 - halfw1;
      // the walk, outer index o (a column for B2, a row for B5), inner
      // index i: where o lies in every pixel's band, the inner indices ilo
      // .. ihi-1 do too, and run without per-pixel tests, two positions an
      // iteration
      const int n_outer = DX_MAJOR ? RX + ew - 1 : RY + eh - 1;
      const int n_inner = DX_MAJOR ? RY + eh - 1 : RX + ew - 1;
      const int olo = DX_MAJOR ? RX - 1 : RY - 1;
      const int ohi = DX_MAJOR ? ew : eh;
      const int ilo = DX_MAJOR ? RY - 1 : RX - 1;
      const int ihi = max(ilo, DX_MAJOR ? eh : ew);
#pragma unroll 1
      for (int o = 0; o < n_outer; ++o) {
        const bool o_full = o >= olo && o < ohi;
#pragma unroll 1
        for (int i = 0; i < n_inner; ++i) {
          if (o_full && i == ilo) {
#pragma unroll 2
            for (; i < ihi; ++i) {
              const int r = DX_MAJOR ? i : o;
              const int c = DX_MAJOR ? o : i;
              visit<false, KC, RX, RY>(base + (r * pitch + r / RY + c) * NV,
                                       r, c, eh, ew, maxw, fr0, fc0, a, a_rt,
                                       K, n1, bm, bi, s, sy, sx);
            }
            if (i == n_inner) break;
          }
          const int r = DX_MAJOR ? i : o;
          const int c = DX_MAJOR ? o : i;
          visit<true, KC, RX, RY>(base + (r * pitch + r / RY + c) * NV, r, c,
                                  eh, ew, maxw, fr0, fc0, a, a_rt, K, n1, bm,
                                  bi, s, sy, sx);
        }
      }
#pragma unroll
      for (int j = 0; j < RY; ++j)
#pragma unroll
        for (int q = 0; q < RX; ++q) bi[j][q] += cell0;

      // the middle (zero-flow) cell's logit, computed as in the window, in
      // the band that holds it
      if (halfh1 >= dy0 && halfh1 < dy0 + eh && halfw1 >= dx0 &&
          halfw1 < dx0 + ew) {
#pragma unroll
        for (int j = 0; j < RY; ++j) {
#pragma unroll
          for (int q = 0; q < RX; ++q) {
            const int r = j + halfh1 - dy0;
            const float4* pos =
                base + (r * pitch + r / RY + q + halfw1 - dx0) * NV;
            float cross, n2;
            if constexpr (KC > 0) {
              constexpr int NVC = slot_floats(KC) / 4;
              float v[4 * NVC];
#pragma unroll
              for (int i = 0; i < NVC; ++i) {
                const float4 w = pos[i];
                v[4 * i] = w.x;
                v[4 * i + 1] = w.y;
                v[4 * i + 2] = w.z;
                v[4 * i + 3] = w.w;
              }
              cross = __fmul_rn(a[j][q][0], v[0]);
#pragma unroll
              for (int k = 1; k < KC; ++k)
                cross = __fadd_rn(cross, __fmul_rn(a[j][q][k], v[k]));
              n2 = v[KC];
            } else {
              const float* pf = reinterpret_cast<const float*>(pos);
              cross = __fmul_rn(to_f(a_rt[0]), pf[0]);
              for (int k = 1; k < K; ++k)
                cross = __fadd_rn(cross, __fmul_rn(to_f(a_rt[k]), pf[k]));
              n2 = pf[K];
            }
            tmid[j][q] =
                __fsub_rn(__fsub_rn(__fmul_rn(2.f, cross), n2), n1[j][q]);
          }
        }
      }
    }
  }
  if (!active) return;

#pragma unroll
  for (int j = 0; j < RY; ++j) {
#pragma unroll
    for (int q = 0; q < RX; ++q) {
      const int y = yb + j;
      const int x = xb + q;
      if (y >= H || x >= W) continue;
      const size_t o = ((size_t)b * H + y) * W + x;
      idx_out[o] = (tmid[j][q] >= bm[j][q]) ? mid : bi[j][q] - (j * maxw + q);
      pmax_out[o] = __fdiv_rn(1.f, s[j][q]);
      ey_out[o] = __fdiv_rn(sy[j][q], s[j][q]);
      ex_out[o] = __fdiv_rn(sx[j][q], s[j][q]);
    }
  }
}

template <typename T, bool DX_MAJOR, int KC, int RX, int RY>
int launch(const void* f1, const void* f2, void* idx, void* ey, void* ex,
           void* pmax, int B, int H, int W, int K, int maxh, int maxw,
           int tx_n, int ty_n, int band_h, int band_w, cudaStream_t stream) {
  if (tx_n <= 0 || ty_n <= 0 || tx_n % (8 / RX) || ty_n % RX ||
      tx_n * ty_n > max_threads(KC, RX, RY))
    return -1;
  if (band_h < 1 || band_h > maxh || band_w < 1 || band_w > maxw) return -1;
  // bands keep the twin's visit order: whole inner lines, or pieces of one
  // outer line
  if (DX_MAJOR ? (band_h != maxh && band_w != 1)
               : (band_w != maxw && band_h != 1))
    return -1;
  const size_t smem = halo_bytes(KC > 0 ? KC : K, RY, ty_n * RY, tx_n * RX,
                                 band_h, band_w);
  if (smem > SMEM_LIMIT) return -2;
  auto kern = match_decomposed_kernel<T, DX_MAJOR, KC, RX, RY>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  const int tile_w = tx_n * RX;
  const int tile_h = ty_n * RY;
  dim3 grid((W + tile_w - 1) / tile_w, (H + tile_h - 1) / tile_h, B);
  kern<<<grid, tx_n * ty_n, smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<int32_t*>(idx), static_cast<float*>(ey),
      static_cast<float*>(ex), static_cast<float*>(pmax), H, W, K, maxh, maxw,
      tx_n, ty_n, band_h, band_w);
  return (int)cudaGetLastError();
}

// Returns 0, a cudaError_t from the launch, or a negative code for a
// configuration the kernel does not take: -1 for a blocking not compiled
// for K's channel bound, a thread shape the lane patches do not tile, or a
// band that is not whole inner lines or pieces of one outer line; -2 for a
// halo beyond 227 KB of shared memory.
template <typename T, bool DX_MAJOR>
int dispatch(const void* f1, const void* f2, void* idx, void* ey, void* ex,
             void* pmax, int B, int H, int W, int K, int maxh, int maxw,
             int rx, int ry, int tx_n, int ty_n, int band_h, int band_w,
             cudaStream_t st) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || maxh <= 0 || maxw <= 0)
    return -1;
  // the channel bound; 0: K above the largest, taken at run time
  const int kc = K <= 4 ? 4 : K <= 8 ? 8 : K <= 10 ? 10 : K <= 16 ? 16
               : K <= 32 ? 32 : K <= 64 ? 64 : 0;
  // the blockings compiled for each channel bound (ops/matching.py
  // BLOCKINGS lists the same, its plan's choice first)
#define MD_CASE(KCV, RXV, RYV)                                              \
  if (kc == KCV && rx == RXV && ry == RYV)                                  \
    return launch<T, DX_MAJOR, KCV, RXV, RYV>(f1, f2, idx, ey, ex, pmax, B, \
                                              H, W, K, maxh, maxw, tx_n,    \
                                              ty_n, band_h, band_w, st);
  MD_CASE(4, 2, 2)
  MD_CASE(8, 2, 2)
  MD_CASE(10, 2, 2)
  MD_CASE(10, 4, 2)
  MD_CASE(10, 4, 1)
  MD_CASE(10, 2, 1)
  MD_CASE(16, 2, 2)
  MD_CASE(32, 4, 1)
  MD_CASE(64, 1, 1)
  MD_CASE(0, 1, 1)
#undef MD_CASE
  return -1;
}

}  // namespace match_decomposed
