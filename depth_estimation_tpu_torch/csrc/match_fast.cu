// Norm-decomposed patch matcher for Hopper (sm_90a): over a maxh x maxw
// window, the logit t = 2<f1, f2> - |f2|^2 - |f1|^2 (= -SSD), one online
// softmax over all cells, winner-take-all, soft-argmax and pmax = 1/s, in
// one pass. The cost volume is never stored.
//
// Replaces the Pallas TPU kernel depth_estimation_tpu/ops/matching.py:366
// (_fast_kernel, called by match_flow_fast at :452). The Python wrapper is
// depth_estimation_tpu_torch/ops/matching.py:match_flow_fast, and its plain
// twin match_flow_fast_plain computes the same arithmetic in the same order.
//
// What bounds it. At the matching core's shape (B=128, 150x290 outputs,
// K=10, 16x16 window) the kernel evaluates 5.57 M pixels x 256 cells, each
// 2K FP32 operations for the cross term (multiply, add) and ~11 for the
// logit and the online softmax, plus one exp: ~4.4e10 operations against
// ~0.3 GB (bf16) to ~0.5 GB (f32) of feature reads. That is ~100 operations
// a byte, far above the card's FP32 ridge (~20), so it is bound by FP32
// issue and the SFU, not by memory. Against kernel B1 it drops the K
// subtractions a cell (3K -> 2K).
//
// What the design does about it. As in match_fused.cu: one thread per
// output pixel keeps its K reference features and |f1|^2 in registers; a
// block covers an 8x32 output tile and stages the tile's f2 halo
// ((8+maxh-1) x (32+maxw-1) x K, channel-major, conflict-free reads) once
// in shared memory, together with |f2|^2 of every halo pixel, computed once
// a block instead of once a cell. Both norms come from the stored values
// (bf16 upcast to f32, the same values the cross terms read), so the
// decomposition cancels back to the SSD of the stored features. Cells are
// visited dx outer, dy inner, as the TPU kernel does; one running max bm
// serves the softmax and the WTA (better = t > bm before bm moves), so
// there are no per-row accumulators and no limit on the window's rows. The
// online softmax spends one exp a cell: the other factor is exp(0) = 1
// exactly, which rounds as the plain version's two-exp form. Rounded
// intrinsics (__fmul_rn, __fadd_rn) keep nvcc from contracting into FMAs,
// so the kernel rounds as the plain version does (FMAs for the cross term
// are the obvious next step, at the cost of bit parity). Limits: K <= 32,
// and the halo must fit in 227 KB of shared memory (the wrapper checks).

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr float NEG_INF = -3.4e38f;
constexpr size_t SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T zero_val();
template <> __device__ __forceinline__ float zero_val<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero_val<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}

// KC: channel count rounded up to an instantiated size; channels K..KC-1
// are zero in both operands, which adds exact zeros to every sum.
template <typename T, int KC>
__global__ void __launch_bounds__(TILE_W * TILE_H)
match_fast_kernel(const T* __restrict__ f1, const T* __restrict__ f2,
                  int32_t* __restrict__ idx_out, float* __restrict__ ey_out,
                  float* __restrict__ ex_out, float* __restrict__ pmax_out,
                  int H, int W, int K, int maxh, int maxw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H2 = H + maxh - 1;
  const int W2 = W + maxw - 1;
  const int rows = TILE_H + maxh - 1;
  const int cols = TILE_W + maxw - 1;
  const int plane = rows * cols;
  float* n2s = reinterpret_cast<float*>(smem_raw);             // |f2|^2
  T* s2 = reinterpret_cast<T*>(smem_raw + (size_t)plane * sizeof(float));
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const int nthreads = TILE_W * TILE_H;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;

  // stage the f2 halo as s2[k][r][c]; global reads run along (c, k), which
  // is contiguous in the channels-last layout
  const T* f2b = f2 + (size_t)b * H2 * W2 * K;
  for (int e = tid; e < plane * K; e += nthreads) {
    const int k = e % K;
    const int rc = e / K;
    const int c = rc % cols;
    const int r = rc / cols;
    const int gy = y0 + r;
    const int gx = x0 + c;
    T v = zero_val<T>();
    if (gy < H2 && gx < W2) v = f2b[((size_t)gy * W2 + gx) * K + k];
    s2[k * plane + r * cols + c] = v;
  }
  for (int e = tid; e < (KC - K) * plane; e += nthreads)
    s2[K * plane + e] = zero_val<T>();
  __syncthreads();
  // |f2|^2 of every halo pixel, in k order, from the stored values
  for (int e = tid; e < plane; e += nthreads) {
    float n = 0.f;
    for (int k = 0; k < K; ++k) {
      const float v = to_f(s2[k * plane + e]);
      n = __fadd_rn(n, __fmul_rn(v, v));
    }
    n2s[e] = n;
  }
  __syncthreads();

  const int ty = threadIdx.y;
  const int tx = threadIdx.x;
  const int y = y0 + ty;
  const int x = x0 + tx;
  if (y >= H || x >= W) return;

  const size_t p = ((size_t)b * H + y) * W + x;
  float a[KC];
  const T* f1p = f1 + p * K;
#pragma unroll
  for (int k = 0; k < KC; ++k) a[k] = (k < K) ? to_f(f1p[k]) : 0.f;
  float n1 = 0.f;
  for (int k = 0; k < K; ++k) n1 = __fadd_rn(n1, __fmul_rn(a[k], a[k]));

  const int halfh1 = (maxh + 1) / 2 - 1;   // ceil(maxh/2) - 1
  const int halfw1 = (maxw + 1) / 2 - 1;
  const int mid = halfh1 * maxw + halfw1;

  int bi = 0;
  float bm = NEG_INF;
  float tmid = 0.f;
  float s = 0.f, sy = 0.f, sx = 0.f;
  for (int dx = 0; dx < maxw; ++dx) {
    const float offx = (float)(dx - halfw1);
    for (int dy = 0; dy < maxh; ++dy) {
      const int rc = (ty + dy) * cols + tx + dx;
      const T* scol = s2 + rc;
      float cross = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k)
        cross = __fadd_rn(cross, __fmul_rn(a[k], to_f(scol[k * plane])));
      const float t = __fsub_rn(__fsub_rn(__fmul_rn(2.f, cross), n2s[rc]), n1);
      const float offy = (float)(dy - halfh1);
      const int d = dy * maxw + dx;
      if (t > bm) {            // new max: the old sums scale, this cell is 1
        const float scale = expf(__fsub_rn(bm, t));
        s = __fadd_rn(__fmul_rn(s, scale), 1.f);
        sy = __fadd_rn(__fmul_rn(sy, scale), offy);
        sx = __fadd_rn(__fmul_rn(sx, scale), offx);
        bm = t;
        bi = d;
      } else {                 // the old sums keep their scale (exp(0) = 1)
        const float e = expf(__fsub_rn(t, bm));
        s = __fadd_rn(s, e);
        sy = __fadd_rn(sy, __fmul_rn(e, offy));
        sx = __fadd_rn(sx, __fmul_rn(e, offx));
      }
      if (d == mid) tmid = t;
    }
  }

  idx_out[p] = (tmid >= bm) ? mid : bi;   // middle-cell tie-break
  pmax_out[p] = __fdiv_rn(1.f, s);
  ey_out[p] = __fdiv_rn(sy, s);
  ex_out[p] = __fdiv_rn(sx, s);
}

template <typename T, int KC>
int launch_typed(const void* f1, const void* f2, void* idx, void* ey, void* ex,
                 void* pmax, int B, int H, int W, int K, int maxh, int maxw,
                 cudaStream_t stream) {
  const size_t plane = (size_t)(TILE_H + maxh - 1) * (TILE_W + maxw - 1);
  const size_t smem = plane * (KC * sizeof(T) + sizeof(float));
  if (smem > SMEM_LIMIT) return -2;
  auto kern = match_fast_kernel<T, KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  dim3 block(TILE_W, TILE_H);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const T*>(f1), static_cast<const T*>(f2),
      static_cast<int32_t*>(idx), static_cast<float*>(ey),
      static_cast<float*>(ex), static_cast<float*>(pmax), H, W, K, maxh, maxw);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch_k(const void* f1, const void* f2, void* idx, void* ey, void* ex,
               void* pmax, int B, int H, int W, int K, int maxh, int maxw,
               cudaStream_t st) {
#define MF_CASE(KCV)                                                          \
  if (K <= KCV)                                                               \
    return launch_typed<T, KCV>(f1, f2, idx, ey, ex, pmax, B, H, W, K, maxh,  \
                                maxw, st);
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
// configuration the kernel does not take (K > 32, halo too large).
extern "C" int match_fast_launch(const void* f1, const void* f2, void* idx,
                                 void* ey, void* ex, void* pmax, int B, int H,
                                 int W, int K, int maxh, int maxw, int is_bf16,
                                 void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || maxh <= 0 || maxw <= 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    return dispatch_k<__nv_bfloat16>(f1, f2, idx, ey, ex, pmax, B, H, W, K,
                                     maxh, maxw, st);
  return dispatch_k<float>(f1, f2, idx, ey, ex, pmax, B, H, W, K, maxh, maxw,
                           st);
}
