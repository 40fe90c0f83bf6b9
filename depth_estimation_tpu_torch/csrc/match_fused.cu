// Fused patch matcher for Hopper (sm_90a): SSD cost over a maxh x maxw
// window, row-local online softmax, winner-take-all, soft-argmax, and
// optionally the y-marginal or the 'mean'-head confidence gate, in one pass.
// The cost volume is never stored.
//
// Replaces the Pallas TPU kernel depth_estimation_tpu/ops/matching.py:116
// (_fused_kernel, called by match_flow_fused at :224). The Python wrapper is
// depth_estimation_tpu_torch/ops/matching.py:match_flow_fused, and its plain
// twin match_flow_fused_plain computes the same arithmetic in the same order.
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
//    whole column pairs) is staged channel-major as f32: bf16 storage is
//    converted once while staging, not at every load. Staging walks the
//    halo with a (row, column) pair that each thread steps by the block
//    size without integer division or modulo; each column's K channels are
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
// What is left: 3K of a cell's instructions are the SSD's separate
// subtract, square and accumulate, which bit parity with the twin keeps,
// and the online softmax's exp, selects and sums follow. Measured (H100 80GB HBM3, 700 W,
// chip_smoke.py) at B=128 150x290x10, 16x16, conf: bf16 5.04 ms, f32
// 4.88 ms (the one-thread-a-pixel design: 6.71 / 6.05 ms in the same run),
// 6.8x / 6.5x the 0.745 ms operations bound.
// B2 (match_fast.cu) and B5 (match_throughput.cu) keep the one-pixel-a-
// thread design on the same 8x32 tile; the column-pair walk, the
// division-free f32 staging and the branch-free softmax carry over to them.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int R = 2;                 // output pixels a thread, along a row
constexpr int TX = 16;               // threads across a tile
constexpr int TY = 8;                // threads down a tile
constexpr int TILE_W = TX * R;       // 32 output columns
constexpr int TILE_H = TY;           // 8 output rows
constexpr int THREADS = TX * TY;
constexpr int BLOCKS_PER_SM = 3;     // caps registers at 168 a thread
constexpr int MAXH_CAP = 16;
constexpr float NEG_INF = -3.4e38f;
constexpr size_t SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

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
__device__ __forceinline__ void visit(float l, int d, float off, float& bm,
                                      int& bi, float& m, float& s,
                                      float& sx) {
  if (l > bm) {            // first-occurrence argmax
    bm = l;
    bi = d;
  }
  const bool up = l > m;
  const float e = expf(-fabsf(__fsub_rn(l, m)));
  s = __fadd_rn(__fmul_rn(up ? s : 1.f, e), up ? 1.f : s);
  sx = __fadd_rn(__fmul_rn(up ? sx : off, e), up ? off : sx);
  m = up ? l : m;
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

  // stage the f2 halo as s2[k][r][c] in f32, zero off the image and in
  // channels K..KC-1; (r, c) steps by THREADS along the rows
  const T* f2b = f2 + (size_t)b * H2 * W2 * K;
  int r = tid / cols;
  int c = tid - r * cols;
  while (r < rows) {
    const int gy = y0 + r;
    const int gx = x0 + c;
    const bool in = gy < H2 && gx < W2;
    const T* src = f2b + ((size_t)gy * W2 + gx) * K;
    float* dst = s2 + r * cols + c;
#pragma unroll
    for (int k = 0; k < KC; ++k)
      dst[k * plane] = (in && k < K) ? to_f(src[k]) : 0.f;
    c += THREADS;
    while (c >= cols) {
      c -= cols;
      ++r;
    }
  }
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
              visit(-cost, dy * maxw + dx, off, bm[q], bi[q], m[q], s[q],
                    sx[q]);
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

template <typename T>
int dispatch_k(const void* f1, const void* f2, void* idx, void* ey, void* ex,
               void* pmax, void* extra, int B, int H, int W, int K, int maxh,
               int maxw, int want_marg, int want_conf, float thr,
               cudaStream_t st) {
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

}  // namespace

// Returns 0, a cudaError_t from the launch, or a negative code for a
// configuration the kernel does not take (K > 32, maxh > 16, halo too large).
extern "C" int match_fused_launch(const void* f1, const void* f2, void* idx,
                                  void* ey, void* ex, void* pmax, void* extra,
                                  int B, int H, int W, int K, int maxh,
                                  int maxw, int is_bf16, int want_marg,
                                  int want_conf, float conf_threshold,
                                  void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || maxh <= 0 || maxw <= 0 ||
      maxh > MAXH_CAP)
    return -1;
  if ((want_marg || want_conf) && extra == nullptr) return -3;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_k<__nv_bfloat16>(f1, f2, idx, ey, ex, pmax, extra, B, H, W,
                                     K, maxh, maxw, want_marg, want_conf,
                                     conf_threshold, st);
  return dispatch_k<float>(f1, f2, idx, ey, ex, pmax, extra, B, H, W, K, maxh,
                           maxw, want_marg, want_conf, conf_threshold, st);
}
