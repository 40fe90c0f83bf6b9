// Fused patch matcher for Hopper (sm_90a): SSD cost over a maxh x maxw
// window, row-local online softmax, winner-take-all, soft-argmax, and
// optionally the y-marginal or the 'mean'-head confidence gate, in one pass.
// The cost volume is never stored.
//
// Replaces the Pallas TPU kernel depth_estimation_tpu/ops/matching.py:116
// (_fused_kernel, called by match_flow_fused at :224). The Python wrapper is
// depth_estimation_tpu_torch/ops/matching.py:match_flow_fused, and its plain
// twin match_flow_fused_plain computes the same arithmetic in the same order.
// Two kernels share the arithmetic: match_fused_kernel, for windows of up to
// 16 rows at K <= 32 whose halo fits in shared memory (every window the
// package's configurations use), and match_fused_general_kernel, for every
// other window and channel count; ops/matching.py:fused_plan picks one and
// its passes.
//
// What bounds it. At the online program's shape (B=128, 150x290 outputs,
// K=10, 16x16 window) the kernel evaluates 1.43e9 cells, each 3K FP32
// operations (subtract, square, accumulate, kept apart for bit parity with
// the twin) plus the online-softmax update with one exp: ~4e10 FP32
// operations against ~0.2 GB of feature reads. It is bound by instruction
// issue: ~1.5 ms in issue slots on 132 SMs. The design before this one
// (one thread a pixel) also paid K shared-memory loads a cell, in bf16 a
// conversion each, and ran one dependent chain a thread: 6.0 ms f32, 6.7 ms
// bf16 (H100 80GB HBM3, 700 W).
//
// What the design does about it.
//  * Register blocking: a thread computes R = 2 adjacent output pixels of
//    one row. It walks the columns t = 0 .. R + maxw - 2 of its f2 window
//    row two at a time (one 8-byte shared-memory load a channel for two
//    columns), and column t is cell dx = t - q of pixel q, so one load
//    serves up to R cells: (R + maxw - 1) / (R maxw) loads a cell and
//    channel, 0.53 at 16x16, against 1 before. The R pixels are R
//    independent dependency chains. Per-row (max, sum, x-sum) accumulators
//    for up to 16 window rows live in registers (the dy loop is unrolled;
//    the row sums are the y-marginal and are combined in row order at the
//    end), 48 registers a pixel: R = 4 would need 192 for them alone, and
//    moving them to shared memory (tried) cost more than it saved.
//    Registers are capped at 168 a thread so that three 128-thread blocks
//    share an SM.
//  * The f2 halo ((8 + maxh - 1) rows x (32 + maxw - 1) columns, padded to
//    whole column pairs) is staged channel-major as f32: bf16 and f16
//    storage are converted once while staging, not at every load. Staging
//    walks the halo with a (row, column) pair that each thread steps by the
//    block size without integer division or modulo; each column's K channels are
//    contiguous in the channels-last f2. Staging overlaps compute across
//    blocks: three blocks share an SM (~44 KB each at K=10, 16x16), so one
//    block's staging runs while the others compute (no persistent grid).
//  * The online softmax spends one exp per cell and no branch: when the new
//    logit l beats the running max m the update is s*exp(m-l) + 1, else
//    s + exp(l-m); both are exp(-|l - m|) and a product plus a term with
//    selected operands, bit-identical to the two-exp form of the
//    reference, with no divergence between lanes that find a new row max
//    and lanes that do not (the branchy form was slower on the card). The
//    middle cell's logit, needed only for the tie-break, is summed once
//    after the window instead of being tested for in every cell. Rounded
//    intrinsics (__fmul_rn, __fadd_rn) keep nvcc from contracting into
//    FMAs, so the kernel rounds exactly as the plain version does.
//  * Every other shape (more than 16 window rows, more than 32 channels, a
//    halo beyond 227 KB) takes the general kernel: the same thread layout
//    and cell update, walking the window in passes of at most 16 rows, each
//    pass in bands of columns, with the halo of one (pass, band) staged at a
//    time. A row's (max, sum, x-sum) carries across its bands in dx order;
//    a finished pass writes its rows' triples to a scratch buffer the
//    wrapper allocates, (3, B, maxh, H, W) f32, and after the last pass the
//    rows are combined from it in the twin's order. Bands visit a pixel's
//    cells out of flat order, so the WTA takes the lower flat index on an
//    exact tie, which is the twin's first occurrence. The channels are
//    summed in k order from registers (K <= 64, rounded up to 8, 16, 32 or
//    64 with zero channels) or, above 64, read from f1 at every cell.
// What is left: 3K of a cell's instructions are the SSD's separate
// subtract, square and accumulate, which bit parity with the twin keeps,
// and the online softmax's exp, selects and sums follow. Measured (H100 80GB HBM3, 700 W,
// chip_smoke.py) at B=128 150x290x10, 16x16, conf: bf16 5.04 ms, f32
// 4.88 ms (the one-thread-a-pixel design: 6.71 / 6.05 ms in the same run),
// 6.8x / 6.5x the 0.745 ms operations bound. The general kernel on the
// same shape (one pass, one band, K rounded to 16) takes 7.69-8.15 ms
// against the unblocked kernel's 4.86-5.21 ms in the same calls (NVIDIA
// H100 80GB HBM3, 700.00 W), so the plan keeps the unblocked kernel
// wherever it fits.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <stdint.h>

namespace {

constexpr int R = 2;                 // output pixels a thread, along a row
constexpr int TX = 16;               // threads across a tile
constexpr int TY = 8;                // threads down a tile
constexpr int TILE_W = TX * R;       // 32 output columns
constexpr int TILE_H = TY;           // 8 output rows
constexpr int THREADS = TX * TY;
constexpr int BLOCKS_PER_SM = 3;     // caps registers at 168 a thread
constexpr int MAXH_CAP = 16;         // window rows a pass
constexpr float NEG_INF = -3.4e38f;
constexpr size_t SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

// column pairs a thread walks in one window row, and the halo's padded
// width: thread tx reads columns R*tx .. R*tx + R*pairs - 1
__host__ __device__ __forceinline__ int column_pairs(int maxw) {
  return (maxw + R - 1 + R - 1) / R;
}
__host__ __device__ __forceinline__ int halo_cols(int maxw) {
  return R * (TX - 1) + R * column_pairs(maxw);
}

// the online-softmax and WTA update of one cell: logit l, window index d,
// centred x offset off. When l beats the running max m the reference's
// update is s*exp(m-l) + 1, else s + exp(l-m). m - l is exactly -(l - m),
// so one subtraction and exp(-|l - m|) serve both branches, and each sum
// is a product plus a term with its operands selected (x*1 and a + b = b
// + a are exact): no divergence where some lanes find a new row max.
// FLAT: cells arrive in flat (dy-major) order, so the first maximum wins;
// otherwise the lower index wins an exact tie, which is the same cell.
template <bool FLAT>
__device__ __forceinline__ void visit(float l, int d, float off, float& bm,
                                      int& bi, float& m, float& s,
                                      float& sx) {
  if (l > bm || (!FLAT && l == bm && d < bi)) {   // first-occurrence argmax
    bm = l;
    bi = d;
  }
  const bool up = l > m;
  const float e = expf(-fabsf(__fsub_rn(l, m)));
  s = __fadd_rn(__fmul_rn(up ? s : 1.f, e), up ? 1.f : s);
  sx = __fadd_rn(__fmul_rn(up ? sx : off, e), up ? off : sx);
  m = up ? l : m;
}

// stage the f2 halo of rows gy0 .. gy0 + rows - 1 and columns gx0 .. gx0 +
// cols - 1 as s2[k][r][c] in f32, zero off the image and in channels
// K..kn-1; (r, c) steps by THREADS along the rows
template <typename T, int KC>
__device__ __forceinline__ void stage(float* __restrict__ s2,
                                      const T* __restrict__ f2b, int gy0,
                                      int gx0, int rows, int cols, int H2,
                                      int W2, int K, int tid) {
  const int plane = rows * cols;
  int r = tid / cols;
  int c = tid - r * cols;
  while (r < rows) {
    const int gy = gy0 + r;
    const int gx = gx0 + c;
    const bool in = gy < H2 && gx < W2;
    const T* src = f2b + ((size_t)gy * W2 + gx) * K;
    float* dst = s2 + r * cols + c;
    if constexpr (KC > 0) {
#pragma unroll
      for (int k = 0; k < KC; ++k)
        dst[k * plane] = (in && k < K) ? to_f(src[k]) : 0.f;
    } else {
      for (int k = 0; k < K; ++k) dst[k * plane] = in ? to_f(src[k]) : 0.f;
    }
    c += THREADS;
    while (c >= cols) {
      c -= cols;
      ++r;
    }
  }
}

// KC: channel count rounded up to an instantiated size; channels K..KC-1
// are zero in both operands, which adds exact zeros to every cost.
template <typename T, int KC>
__global__ void __launch_bounds__(THREADS, BLOCKS_PER_SM)
match_fused_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                   int32_t* __restrict__ idx_out, float* __restrict__ ey_out,
                   float* __restrict__ ex_out, float* __restrict__ pmax_out,
                   float* __restrict__ extra, int H, int W, int K, int maxh,
                   int maxw, int want_marg, int want_conf,
                   float conf_threshold) {
  extern __shared__ __align__(16) float s2[];
  const int H2 = H + maxh - 1;
  const int W2 = W + maxw - 1;
  const int rows = TILE_H + maxh - 1;
  const int cols = halo_cols(maxw);
  const int plane = rows * cols;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;

  stage<T, KC>(s2, f2 + (size_t)b * H2 * W2 * K, y0, x0, rows, cols, H2, W2,
               K, tid);
  __syncthreads();

  const int y = y0 + ty;
  const int xb = x0 + R * tx;
  if (y >= H || xb >= W) return;

  float a[R][KC];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const bool in = xb + q < W;
    const T* f1p = f1 + (((size_t)b * H + y) * W + xb + q) * K;
#pragma unroll
    for (int k = 0; k < KC; ++k) a[q][k] = (in && k < K) ? to_f(f1p[k]) : 0.f;
  }

  const int halfh1 = (maxh + 1) / 2 - 1;   // ceil(maxh/2) - 1
  const int halfw1 = (maxw + 1) / 2 - 1;
  const int mid = halfh1 * maxw + halfw1;
  const int pairs = column_pairs(maxw);

  int bi[R];
  float bm[R];
  float m_rows[R][MAXH_CAP], s_rows[R][MAXH_CAP], sx_rows[R][MAXH_CAP];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    bi[q] = 0;
    bm[q] = NEG_INF;
  }
#pragma unroll
  for (int dy = 0; dy < MAXH_CAP; ++dy) {
#pragma unroll
    for (int q = 0; q < R; ++q) {
      m_rows[q][dy] = NEG_INF;
      s_rows[q][dy] = 0.f;
      sx_rows[q][dy] = 0.f;
    }
    if (dy < maxh) {
      float m[R], s[R], sx[R];
#pragma unroll
      for (int q = 0; q < R; ++q) {
        m[q] = NEG_INF;
        s[q] = 0.f;
        sx[q] = 0.f;
      }
      const float* srow = s2 + (ty + dy) * cols + R * tx;
      for (int pr = 0; pr < pairs; ++pr) {
        const float off0 = (float)(R * pr - halfw1);   // offset of column R*pr
        float2 v[KC];
#pragma unroll
        for (int k = 0; k < KC; ++k)
          v[k] = *reinterpret_cast<const float2*>(srow + k * plane + R * pr);
#pragma unroll
        for (int j = 0; j < R; ++j) {
#pragma unroll
          for (int q = 0; q < R; ++q) {
            const int dx = R * pr + j - q;    // column R*pr + j is cell dx of pixel q
            if (dx >= 0 && dx < maxw) {
              float cost = 0.f;
#pragma unroll
              for (int k = 0; k < KC; ++k) {
                const float d = __fsub_rn(a[q][k], j == 0 ? v[k].x : v[k].y);
                cost = __fadd_rn(cost, __fmul_rn(d, d));
              }
              const float off = j == q ? off0 : __fadd_rn(off0, (float)(j - q));
              visit<true>(-cost, dy * maxw + dx, off, bm[q], bi[q], m[q],
                          s[q], sx[q]);
            }
          }
        }
      }
#pragma unroll
      for (int q = 0; q < R; ++q) {
        m_rows[q][dy] = m[q];
        s_rows[q][dy] = s[q];
        sx_rows[q][dy] = sx[q];
      }
    }
  }

#pragma unroll
  for (int q = 0; q < R; ++q) {
    const int x = xb + q;
    if (x >= W) break;
    // the middle (zero-flow) cell's logit, summed as in the window loop
    const float* cm = s2 + (ty + halfh1) * cols + R * tx + q + halfw1;
    float cmid = 0.f;
#pragma unroll
    for (int k = 0; k < KC; ++k) {
      const float d = __fsub_rn(a[q][k], cm[k * plane]);
      cmid = __fadd_rn(cmid, __fmul_rn(d, d));
    }
    const float lmid = -cmid;
    // combine rows: global max, then each row's sums rescaled to it
    float M = m_rows[q][0];
#pragma unroll
    for (int dy = 1; dy < MAXH_CAP; ++dy)
      if (dy < maxh) M = fmaxf(M, m_rows[q][dy]);
    float s = 0.f, sy = 0.f, sx = 0.f;
#pragma unroll
    for (int dy = 0; dy < MAXH_CAP; ++dy) {
      if (dy < maxh) {
        const float w = expf(__fsub_rn(m_rows[q][dy], M));
        const float rr = __fmul_rn(s_rows[q][dy], w);
        s_rows[q][dy] = rr;
        s = __fadd_rn(s, rr);
        sy = __fadd_rn(sy, __fmul_rn(rr, (float)(dy - halfh1)));
        sx = __fadd_rn(sx, __fmul_rn(sx_rows[q][dy], w));
      }
    }
    const size_t p = ((size_t)b * H + y) * W + x;
    idx_out[p] = (lmid >= bm[q]) ? mid : bi[q];   // middle-cell tie-break
    pmax_out[p] = __fdiv_rn(expf(__fsub_rn(bm[q], M)), s);
    ey_out[p] = __fdiv_rn(sy, s);
    ex_out[p] = __fdiv_rn(sx, s);
    if (want_marg) {
#pragma unroll
      for (int dy = 0; dy < MAXH_CAP; ++dy)
        if (dy < maxh)
          extra[(((size_t)b * maxh + dy) * H + y) * W + x] =
              __fdiv_rn(s_rows[q][dy], s);
    } else if (want_conf) {
      float mx = s_rows[q][0];
#pragma unroll
      for (int dy = 1; dy < MAXH_CAP; ++dy)
        if (dy < maxh) mx = fmaxf(mx, s_rows[q][dy]);
      extra[p] = (mx > __fmul_rn(conf_threshold, s)) ? 1.f : 0.f;
    }
  }
}

// The general kernel: any window, any K (KC = 0: K channels read from f1 at
// run time). The window is walked in passes of block_rows (<= 16) rows, each
// pass in bands of band_cols columns, one staged halo a (pass, band): the
// halo of (TILE_H + block_rows - 1) rows and halo_cols(band_cols) columns.
// scratch holds each finished row's (max, sum, x-sum): three (B, maxh, H,
// W) f32 planes.
template <typename T, int KC>
__global__ void __launch_bounds__(THREADS)
match_fused_general_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                           int32_t* __restrict__ idx_out,
                           float* __restrict__ ey_out,
                           float* __restrict__ ex_out,
                           float* __restrict__ pmax_out,
                           float* __restrict__ extra,
                           float* __restrict__ scratch, int B, int H, int W,
                           int K, int maxh, int maxw, int block_rows,
                           int band_cols, int want_marg, int want_conf,
                           float conf_threshold) {
  constexpr int KA = KC > 0 ? KC : 1;
  extern __shared__ __align__(16) float s2[];
  const int H2 = H + maxh - 1;
  const int W2 = W + maxw - 1;
  const int rows = TILE_H + block_rows - 1;
  const int cols = halo_cols(band_cols);
  const int plane = rows * cols;
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const int tx = threadIdx.x;
  const int ty = threadIdx.y;
  const int tid = ty * TX + tx;
  const int y = y0 + ty;
  const int xb = x0 + R * tx;
  // a thread whose pixels lie off the image stages and meets the barriers,
  // and computes nothing
  const bool active = y < H && xb < W;
  const T* f2b = f2 + (size_t)b * H2 * W2 * K;

  // the pixels' features: registers (KC > 0) or f1 itself (KC = 0); a pixel
  // off the image reads its row's first pixel and writes nothing
  float a[R][KA];
  const T* f1p[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    const bool in = active && xb + q < W;
    f1p[q] = f1 + (((size_t)b * H + (in ? y : 0)) * W + (in ? xb + q : 0)) * K;
#pragma unroll
    for (int k = 0; k < KA; ++k)
      a[q][k] = (KC > 0 && in && k < K) ? to_f(f1p[q][k]) : 0.f;
  }

  const int halfh1 = (maxh + 1) / 2 - 1;   // ceil(maxh/2) - 1
  const int halfw1 = (maxw + 1) / 2 - 1;
  const int mid = halfh1 * maxw + halfw1;
  const size_t HW = (size_t)H * W;
  const size_t plane_out = (size_t)B * maxh * HW;   // one scratch plane
  float* sc_m = scratch;
  float* sc_s = scratch + plane_out;
  float* sc_x = scratch + 2 * plane_out;

  int bi[R];
  float bm[R], lmid[R];
#pragma unroll
  for (int q = 0; q < R; ++q) {
    bi[q] = 0;
    bm[q] = NEG_INF;
    lmid[q] = 0.f;
  }
  bool first = true;
  for (int dy0 = 0; dy0 < maxh; dy0 += block_rows) {
    const int bh = min(block_rows, maxh - dy0);
    float m_rows[R][MAXH_CAP], s_rows[R][MAXH_CAP], sx_rows[R][MAXH_CAP];
#pragma unroll
    for (int dy = 0; dy < MAXH_CAP; ++dy) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        m_rows[q][dy] = NEG_INF;
        s_rows[q][dy] = 0.f;
        sx_rows[q][dy] = 0.f;
      }
    }
    for (int dx0 = 0; dx0 < maxw; dx0 += band_cols) {
      const int bw = min(band_cols, maxw - dx0);
      if (!first) __syncthreads();     // the last band's readers are done
      first = false;
      stage<T, KC>(s2, f2b, y0 + dy0, x0 + dx0, rows, cols, H2, W2, K, tid);
      __syncthreads();
      if (!active) continue;
      const int pairs = column_pairs(bw);
#pragma unroll
      for (int dy = 0; dy < MAXH_CAP; ++dy) {
        if (dy < bh) {
          float m[R], s[R], sx[R];
#pragma unroll
          for (int q = 0; q < R; ++q) {
            m[q] = m_rows[q][dy];
            s[q] = s_rows[q][dy];
            sx[q] = sx_rows[q][dy];
          }
          const float* srow = s2 + (ty + dy) * cols + R * tx;
          const int drow = (dy0 + dy) * maxw + dx0;
          for (int pr = 0; pr < pairs; ++pr) {
            // the costs of columns R*pr + j against pixels q, in k order
            float cost[R][R];
#pragma unroll
            for (int j = 0; j < R; ++j)
#pragma unroll
              for (int q = 0; q < R; ++q) cost[j][q] = 0.f;
            const float* sp = srow + R * pr;
            if constexpr (KC > 0) {
#pragma unroll
              for (int k = 0; k < KC; ++k) {
                const float2 v = *reinterpret_cast<const float2*>(sp + k * plane);
#pragma unroll
                for (int q = 0; q < R; ++q) {
                  const float d0 = __fsub_rn(a[q][k], v.x);
                  const float d1 = __fsub_rn(a[q][k], v.y);
                  cost[0][q] = __fadd_rn(cost[0][q], __fmul_rn(d0, d0));
                  cost[1][q] = __fadd_rn(cost[1][q], __fmul_rn(d1, d1));
                }
              }
            } else {
              for (int k = 0; k < K; ++k) {
                const float2 v = *reinterpret_cast<const float2*>(sp + k * plane);
#pragma unroll
                for (int q = 0; q < R; ++q) {
                  const float ak = to_f(f1p[q][k]);
                  const float d0 = __fsub_rn(ak, v.x);
                  const float d1 = __fsub_rn(ak, v.y);
                  cost[0][q] = __fadd_rn(cost[0][q], __fmul_rn(d0, d0));
                  cost[1][q] = __fadd_rn(cost[1][q], __fmul_rn(d1, d1));
                }
              }
            }
#pragma unroll
            for (int j = 0; j < R; ++j) {
#pragma unroll
              for (int q = 0; q < R; ++q) {
                const int dx = R * pr + j - q;   // cell dx0 + dx of pixel q
                if (dx >= 0 && dx < bw)
                  visit<false>(-cost[j][q], drow + dx,
                               (float)(dx0 + dx - halfw1), bm[q], bi[q], m[q],
                               s[q], sx[q]);
              }
            }
          }
#pragma unroll
          for (int q = 0; q < R; ++q) {
            m_rows[q][dy] = m[q];
            s_rows[q][dy] = s[q];
            sx_rows[q][dy] = sx[q];
          }
        }
      }
      // the middle (zero-flow) cell's logit, in the band that holds it
      if (halfh1 >= dy0 && halfh1 < dy0 + bh && halfw1 >= dx0 &&
          halfw1 < dx0 + bw) {
#pragma unroll
        for (int q = 0; q < R; ++q) {
          const float* cm =
              s2 + (ty + halfh1 - dy0) * cols + R * tx + q + halfw1 - dx0;
          float cmid = 0.f;
          if constexpr (KC > 0) {
#pragma unroll
            for (int k = 0; k < KC; ++k) {
              const float d = __fsub_rn(a[q][k], cm[k * plane]);
              cmid = __fadd_rn(cmid, __fmul_rn(d, d));
            }
          } else {
            for (int k = 0; k < K; ++k) {
              const float d = __fsub_rn(to_f(f1p[q][k]), cm[k * plane]);
              cmid = __fadd_rn(cmid, __fmul_rn(d, d));
            }
          }
          lmid[q] = -cmid;
        }
      }
    }
    // the pass's rows to scratch
    if (active) {
#pragma unroll
      for (int q = 0; q < R; ++q) {
        if (xb + q >= W) break;
        const size_t o = ((size_t)b * maxh + dy0) * HW + (size_t)y * W + xb + q;
#pragma unroll
        for (int dy = 0; dy < MAXH_CAP; ++dy) {
          if (dy < bh) {
            sc_m[o + dy * HW] = m_rows[q][dy];
            sc_s[o + dy * HW] = s_rows[q][dy];
            sc_x[o + dy * HW] = sx_rows[q][dy];
          }
        }
      }
    }
  }
  if (!active) return;

  // combine the rows in the twin's order: their max, then each row's sums
  // rescaled to it (a thread reads back only what it wrote)
  for (int q = 0; q < R; ++q) {
    const int x = xb + q;
    if (x >= W) break;
    const size_t o = (size_t)b * maxh * HW + (size_t)y * W + x;
    float M = sc_m[o];
    for (int dy = 1; dy < maxh; ++dy) M = fmaxf(M, sc_m[o + dy * HW]);
    float s = 0.f, sy = 0.f, sx = 0.f, mx = 0.f;
    for (int dy = 0; dy < maxh; ++dy) {
      const float w = expf(__fsub_rn(sc_m[o + dy * HW], M));
      const float rr = __fmul_rn(sc_s[o + dy * HW], w);
      s = __fadd_rn(s, rr);
      sy = __fadd_rn(sy, __fmul_rn(rr, (float)(dy - halfh1)));
      sx = __fadd_rn(sx, __fmul_rn(sc_x[o + dy * HW], w));
      mx = dy == 0 ? rr : fmaxf(mx, rr);
    }
    const size_t p = ((size_t)b * H + y) * W + x;
    idx_out[p] = (lmid[q] >= bm[q]) ? mid : bi[q];   // middle-cell tie-break
    pmax_out[p] = __fdiv_rn(expf(__fsub_rn(bm[q], M)), s);
    ey_out[p] = __fdiv_rn(sy, s);
    ex_out[p] = __fdiv_rn(sx, s);
    if (want_marg) {
      for (int dy = 0; dy < maxh; ++dy) {
        const float w = expf(__fsub_rn(sc_m[o + dy * HW], M));
        extra[(((size_t)b * maxh + dy) * H + y) * W + x] =
            __fdiv_rn(__fmul_rn(sc_s[o + dy * HW], w), s);
      }
    } else if (want_conf) {
      extra[p] = (mx > __fmul_rn(conf_threshold, s)) ? 1.f : 0.f;
    }
  }
}

template <typename T, int KC>
int launch_typed(const void* f1, const void* f2, void* idx, void* ey, void* ex,
                 void* pmax, void* extra, int B, int H, int W, int K, int maxh,
                 int maxw, int want_marg, int want_conf, float conf_threshold,
                 cudaStream_t stream) {
  const size_t smem =
      (size_t)KC * (TILE_H + maxh - 1) * halo_cols(maxw) * sizeof(float);
  if (smem > SMEM_LIMIT) return -2;
  auto kern = match_fused_kernel<T, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  dim3 block(TX, TY);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<int32_t*>(idx), static_cast<float*>(ey),
      static_cast<float*>(ex), static_cast<float*>(pmax),
      static_cast<float*>(extra), H, W, K, maxh, maxw, want_marg, want_conf,
      conf_threshold);
  return (int)cudaGetLastError();
}

template <typename T, int KC>
int launch_general(const void* f1, const void* f2, void* idx, void* ey,
                   void* ex, void* pmax, void* extra, void* scratch, int B,
                   int H, int W, int K, int maxh, int maxw, int block_rows,
                   int band_cols, int want_marg, int want_conf,
                   float conf_threshold, cudaStream_t stream) {
  const size_t smem = (size_t)(KC > 0 ? KC : K) * (TILE_H + block_rows - 1) *
                      halo_cols(band_cols) * sizeof(float);
  if (smem > SMEM_LIMIT) return -2;
  auto kern = match_fused_general_kernel<T, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  dim3 block(TX, TY);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<int32_t*>(idx), static_cast<float*>(ey),
      static_cast<float*>(ex), static_cast<float*>(pmax),
      static_cast<float*>(extra), static_cast<float*>(scratch), B, H, W, K,
      maxh, maxw, block_rows, band_cols, want_marg, want_conf,
      conf_threshold);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k(const void* f1, const void* f2, void* idx, void* ey, void* ex,
               void* pmax, void* extra, void* scratch, int B, int H, int W,
               int K, int maxh, int maxw, int block_rows, int band_cols,
               int want_marg, int want_conf, float thr, cudaStream_t st) {
  if (scratch == nullptr) {
    // the unblocked kernel: at most 16 window rows, K <= 32 (the channel
    // bounds ops/matching.py FUSED_KC lists)
    if (maxh > MAXH_CAP) return -1;
#define MF_CASE(KCV)                                                        \
  if (K <= KCV)                                                             \
    return launch_typed<T, KCV>(f1, f2, idx, ey, ex, pmax, extra, B, H, W, K, \
                                maxh, maxw, want_marg, want_conf, thr, st);
    MF_CASE(4)
    MF_CASE(8)
    MF_CASE(10)
    MF_CASE(12)
    MF_CASE(16)
    MF_CASE(32)
#undef MF_CASE
    return -1;
  }
  // the general kernel (ops/matching.py GENERAL_KC; K > 64 at run time)
  if (block_rows < 1 || block_rows > MAXH_CAP || block_rows > maxh ||
      band_cols < 1 || band_cols > maxw)
    return -1;
#define MG_CASE(KCV)                                                          \
  if (K <= KCV)                                                               \
    return launch_general<T, KCV>(f1, f2, idx, ey, ex, pmax, extra, scratch,  \
                                  B, H, W, K, maxh, maxw, block_rows,         \
                                  band_cols, want_marg, want_conf, thr, st);
  MG_CASE(8)
  MG_CASE(16)
  MG_CASE(32)
  MG_CASE(64)
#undef MG_CASE
  return launch_general<T, 0>(f1, f2, idx, ey, ex, pmax, extra, scratch, B, H,
                              W, K, maxh, maxw, block_rows, band_cols,
                              want_marg, want_conf, thr, st);
}

}  // namespace

// Returns 0, a cudaError_t from the launch, or a negative code for a
// configuration the kernel does not take: -1 for a bad shape, pass plan or
// storage code, -2 for a halo beyond 227 KB of shared memory, -3 for a
// missing output. f1 and f2 are stored as ``storage`` says: 0 f32, 1 bf16,
// 2 f16 (each value upcast to f32 as it is staged or loaded).
// scratch == nullptr takes the unblocked kernel; otherwise the general
// kernel walks block_rows window rows a pass in bands of band_cols columns
// (ops/matching.py:fused_plan) and keeps the rows' sums in scratch, three
// (B, maxh, H, W) f32 planes.
extern "C" int match_fused_launch(const void* f1, const void* f2, void* idx,
                                  void* ey, void* ex, void* pmax, void* extra,
                                  void* scratch, int B, int H, int W, int K,
                                  int maxh, int maxw, int block_rows,
                                  int band_cols, int storage, int want_marg,
                                  int want_conf, float conf_threshold,
                                  void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || maxh <= 0 || maxw <= 0)
    return -1;
  if ((want_marg || want_conf) && extra == nullptr) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0:
      return dispatch_k<float>(f1, f2, idx, ey, ex, pmax, extra, scratch, B,
                               H, W, K, maxh, maxw, block_rows, band_cols,
                               want_marg, want_conf, conf_threshold, st);
    case 1:
      return dispatch_k<__nv_bfloat16>(f1, f2, idx, ey, ex, pmax, extra,
                                       scratch, B, H, W, K, maxh, maxw,
                                       block_rows, band_cols, want_marg,
                                       want_conf, conf_threshold, st);
    case 2:
      return dispatch_k<__half>(f1, f2, idx, ey, ex, pmax, extra, scratch, B,
                                H, W, K, maxh, maxw, block_rows, band_cols,
                                want_marg, want_conf, conf_threshold, st);
  }
  return -1;
}
