// Throughput matcher for Hopper (sm_90a): over a maxh x maxw window, the
// logit t = (2<f1, f2> - |f2|^2) - |f1|^2 (= -SSD) on f32 features, with
// the squared norms computed outside the kernel; one online softmax over
// all cells visited dy-major, winner-take-all, soft-argmax and pmax = 1/s,
// in one pass. The cost volume is never stored.
//
// Replaces the Pallas TPU kernel depth_estimation_tpu/ops/matching_experimental.py:35
// (_lanes_kernel, called by match_flow_throughput at :104). The Python
// wrapper is depth_estimation_tpu_torch/ops/matching_experimental.py:
// match_flow_throughput; it computes n1 = |f1|^2 and n2 = |f2|^2 in k order
// with torch ops, and its plain twin match_flow_throughput_plain reads the
// same n1 and n2 and repeats this kernel's arithmetic in the same order.
//
// What bounds it. The function is kernel B2's (csrc/match_fast.cu) with f32
// storage: at the matching core's shape (B=128, 150x290 outputs, K=10,
// 16x16 window) 5.57 M pixels x 256 cells, each 2K FP32 operations for the
// cross term and ~10 for the logit and the online softmax, plus one exp:
// ~4.3e10 operations against ~0.55 GB of feature and norm reads, ~80
// operations a byte, far above the card's FP32 ridge (~20). It is bound by
// FP32 issue and the SFU, not by memory.
//
// What the design does about it. The TPU kernel puts the frame batch on
// the 128 vector lanes and DMAs (8, 8) spatial slabs; neither is a Hopper
// fact. Here, as in B2: one thread per output pixel keeps its K reference
// features and |f1|^2 in registers; a block covers an 8x32 output tile and
// stages its f2 halo ((8+maxh-1) x (32+maxw-1) x K, channel-major, so a
// warp's reads of one channel are consecutive words) and the halo's |f2|^2
// once in shared memory, sized at launch (above the 48 KB default only
// after opting in; the wrapper raises where the halo exceeds 227 KB). Cells
// are visited dy outer, dx inner, in increasing flat index d, as the TPU
// kernel does; one running max bm serves the softmax and the WTA (better =
// t > bm before bm moves). The online softmax spends one exp a cell: the
// other factor is exp(0) = 1 exactly, which rounds as the twin's two-exp
// form. Rounded intrinsics (__fmul_rn, __fadd_rn, __fsub_rn) keep nvcc from
// contracting into FMAs, so the kernel rounds as the twin does. Limits:
// K <= 32, and the halo within shared memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int TILE_W = 32;
constexpr int TILE_H = 8;
constexpr float NEG_INF = -3.4e38f;
constexpr size_t SMEM_LIMIT = 227 * 1024;

// KC: channel count rounded up to an instantiated size; channels K..KC-1
// are zero in both operands, which adds exact zeros to every sum.
template <int KC>
__global__ void __launch_bounds__(TILE_W * TILE_H)
match_throughput_kernel(const float* __restrict__ f1,
                        const float* __restrict__ f2,
                        const float* __restrict__ n1g,
                        const float* __restrict__ n2g,
                        int32_t* __restrict__ idx_out,
                        float* __restrict__ ey_out, float* __restrict__ ex_out,
                        float* __restrict__ pmax_out, int H, int W, int K,
                        int maxh, int maxw) {
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int H2 = H + maxh - 1;
  const int W2 = W + maxw - 1;
  const int rows = TILE_H + maxh - 1;
  const int cols = TILE_W + maxw - 1;
  const int plane = rows * cols;
  float* n2s = reinterpret_cast<float*>(smem_raw);     // |f2|^2 of the halo
  float* s2 = n2s + plane;                               // s2[k][r][c]
  const int b = blockIdx.z;
  const int y0 = blockIdx.y * TILE_H;
  const int x0 = blockIdx.x * TILE_W;
  const int nthreads = TILE_W * TILE_H;
  const int tid = threadIdx.y * TILE_W + threadIdx.x;

  // stage the f2 halo; global reads run along (c, k), which is contiguous
  // in the channels-last layout
  const float* f2b = f2 + (size_t)b * H2 * W2 * K;
  for (int e = tid; e < plane * K; e += nthreads) {
    const int k = e % K;
    const int rc = e / K;
    const int c = rc % cols;
    const int r = rc / cols;
    const int gy = y0 + r;
    const int gx = x0 + c;
    float v = 0.f;
    if (gy < H2 && gx < W2) v = f2b[((size_t)gy * W2 + gx) * K + k];
    s2[k * plane + r * cols + c] = v;
  }
  for (int e = tid; e < (KC - K) * plane; e += nthreads) s2[K * plane + e] = 0.f;
  const float* n2b = n2g + (size_t)b * H2 * W2;
  for (int e = tid; e < plane; e += nthreads) {
    const int c = e % cols;
    const int r = e / cols;
    const int gy = y0 + r;
    const int gx = x0 + c;
    n2s[e] = (gy < H2 && gx < W2) ? n2b[(size_t)gy * W2 + gx] : 0.f;
  }
  __syncthreads();

  const int ty = threadIdx.y;
  const int tx = threadIdx.x;
  const int y = y0 + ty;
  const int x = x0 + tx;
  if (y >= H || x >= W) return;

  const size_t p = ((size_t)b * H + y) * W + x;
  float a[KC];
  const float* f1p = f1 + p * K;
#pragma unroll
  for (int k = 0; k < KC; ++k) a[k] = (k < K) ? f1p[k] : 0.f;
  const float n1 = n1g[p];

  const int halfh1 = (maxh + 1) / 2 - 1;   // ceil(maxh/2) - 1
  const int halfw1 = (maxw + 1) / 2 - 1;
  const int mid = halfh1 * maxw + halfw1;

  int bi = 0;
  float bm = NEG_INF;
  float tmid = 0.f;
  float s = 0.f, sy = 0.f, sx = 0.f;
  for (int dy = 0; dy < maxh; ++dy) {
    const float offy = (float)(dy - halfh1);
    for (int dx = 0; dx < maxw; ++dx) {
      const int rc = (ty + dy) * cols + tx + dx;
      const float* scol = s2 + rc;
      float cross = 0.f;
#pragma unroll
      for (int k = 0; k < KC; ++k)
        cross = __fadd_rn(cross, __fmul_rn(a[k], scol[k * plane]));
      const float t = __fsub_rn(__fsub_rn(__fmul_rn(2.f, cross), n2s[rc]), n1);
      const float offx = (float)(dx - halfw1);
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

template <int KC>
int launch_typed(const void* f1, const void* f2, const void* n1,
                 const void* n2, void* idx, void* ey, void* ex, void* pmax,
                 int B, int H, int W, int K, int maxh, int maxw,
                 cudaStream_t stream) {
  const size_t plane = (size_t)(TILE_H + maxh - 1) * (TILE_W + maxw - 1);
  const size_t smem = plane * (KC + 1) * sizeof(float);
  if (smem > SMEM_LIMIT) return -2;
  auto kern = match_throughput_kernel<KC>;
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((W + TILE_W - 1) / TILE_W, (H + TILE_H - 1) / TILE_H, B);
  dim3 block(TILE_W, TILE_H);
  kern<<<grid, block, smem, stream>>>(
      static_cast<const float*>(f1), static_cast<const float*>(f2),
      static_cast<const float*>(n1), static_cast<const float*>(n2),
      static_cast<int32_t*>(idx), static_cast<float*>(ey),
      static_cast<float*>(ex), static_cast<float*>(pmax), H, W, K, maxh, maxw);
  return (int)cudaGetLastError();
}

}  // namespace

// Returns 0, a cudaError_t from the launch, or a negative code for a
// configuration the kernel does not take (K > 32, halo too large).
extern "C" int match_throughput_launch(const void* f1, const void* f2,
                                       const void* n1, const void* n2,
                                       void* idx, void* ey, void* ex,
                                       void* pmax, int B, int H, int W, int K,
                                       int maxh, int maxw, void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || K <= 0 || maxh <= 0 || maxw <= 0)
    return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MT_CASE(KCV)                                                          \
  if (K <= KCV)                                                               \
    return launch_typed<KCV>(f1, f2, n1, n2, idx, ey, ex, pmax, B, H, W, K,   \
                             maxh, maxw, st);
  MT_CASE(4)
  MT_CASE(8)
  MT_CASE(10)
  MT_CASE(12)
  MT_CASE(16)
  MT_CASE(32)
#undef MT_CASE
  return -1;
}
