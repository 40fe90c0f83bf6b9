// Red-black SOR for the celiu IRLS solver on Hopper (sm_90a): n_sor
// iterations from du = dv = 0 over the 5-point system of one pyramid level,
// in the order red du, red dv, black du, black dv, with omega = 1.8.
//
// Replaces the Pallas TPU kernel depth_estimation_tpu/flow/sor_kernel.py:50
// (_sor_body, called by sor_pallas at :90). The Python wrapper is
// depth_estimation_tpu_torch/flow/sor_kernel.py:sor_redblack, and its plain
// twin depth_estimation_tpu_torch/flow/celiu.py:sor_plain computes the same
// arithmetic in the same order.
//
// What bounds it. One call reads 9 coefficient planes and writes du, dv:
// at the ground truth's finest level (B=8, 192x256) that is 11 x 1.57 MB =
// 17 MB, 5 us at 3.35 TB/s, and 40 iterations x 30 FP32 operations a pixel
// are 4.7e8 operations, 7 us at 67 TFLOP/s. The true limit is neither: each
// half-sweep depends on the previous one, so the work is 2 x n_sor
// dependent steps of ~50k pixels each, and a step is bound by the latency
// of reading the other colour's neighbours back from L2 and of the barrier.
//
// What the design does about it. One thread block per image runs all n_sor
// iterations inside the kernel, with __syncthreads() between half-sweeps,
// so one call is one launch (the TPU kernel's one program per image). The
// nine planes and du/dv of one 192x256 image are 2.2 MB, far over an SM's
// 227 KB of shared memory, so they stay in global memory; 8 images are
// ~17 MB and live in the 50 MB L2 after the first sweep. Within one colour
// a thread updates du and then dv at the same pixel (dv reads the new du);
// every neighbour is of the other colour, so there are no races. Out-of-
// image neighbours read as 0 through index guards, as the plain version's
// zero padding does; the boundary weights are zero there as well.
// -alpha, omega and 1 - omega come from the wrapper as f32 values (Python
// rounds 1 - omega once from double), and the rounded intrinsics
// (__fmul_rn, __fadd_rn, __fdiv_rn) keep nvcc from contracting into FMAs,
// so the kernel rounds exactly as sor_plain does. Only 2.2 MB per image and
// one SM per image: at B=8 the card uses 8 of its 132 SMs, which is the
// first thing a faster version changes (a cluster or a cooperative grid per
// image).

#include <cuda_runtime.h>

namespace {

constexpr int THREADS = 1024;

struct Planes {
  const float* __restrict__ ww;
  const float* __restrict__ we;
  const float* __restrict__ wn;
  const float* __restrict__ ws;
  const float* __restrict__ denu;
  const float* __restrict__ denv;
  const float* __restrict__ b1;
  const float* __restrict__ b2;
  const float* __restrict__ ixy;
};

// w_w*left + w_e*right + w_n*up + w_s*down, left to right, 0 off the image
__device__ __forceinline__ float nsum(const float* f, const Planes& P, int p,
                                      int i, int j, int H, int W) {
  const float left = j > 0 ? f[p - 1] : 0.f;
  const float right = j < W - 1 ? f[p + 1] : 0.f;
  const float up = i > 0 ? f[p - W] : 0.f;
  const float down = i < H - 1 ? f[p + W] : 0.f;
  float s = __fmul_rn(__ldg(P.ww + p), left);
  s = __fadd_rn(s, __fmul_rn(__ldg(P.we + p), right));
  s = __fadd_rn(s, __fmul_rn(__ldg(P.wn + p), up));
  s = __fadd_rn(s, __fmul_rn(__ldg(P.ws + p), down));
  return s;
}

__global__ void __launch_bounds__(THREADS)
sor_redblack_kernel(Planes P, float* du, float* dv, int H, int W, int n_sor,
                    float neg_alpha, float omega, float one_minus_omega) {
  const size_t off = (size_t)blockIdx.x * H * W;
  Planes Q = P;
  Q.ww += off; Q.we += off; Q.wn += off; Q.ws += off;
  Q.denu += off; Q.denv += off; Q.b1 += off; Q.b2 += off; Q.ixy += off;
  du += off;
  dv += off;
  const int Wh = (W + 1) / 2;            // pixels of one colour in a row, at most
  const int n = H * Wh;
  for (int it = 0; it < n_sor; ++it) {
    for (int color = 0; color < 2; ++color) {   // red: (i + j) even
      for (int e = threadIdx.x; e < n; e += blockDim.x) {
        const int i = e / Wh;
        const int j = 2 * (e - i * Wh) + ((i + color) & 1);
        if (j >= W) continue;
        const int p = i * W + j;
        const float ixy = __ldg(Q.ixy + p);
        const float s1 = __fadd_rn(__fmul_rn(neg_alpha, nsum(du, Q, p, i, j, H, W)),
                                   __fmul_rn(ixy, dv[p]));
        const float du_new = __fadd_rn(
            __fmul_rn(one_minus_omega, du[p]),
            __fmul_rn(__fdiv_rn(omega, __ldg(Q.denu + p)),
                      __fsub_rn(__ldg(Q.b1 + p), s1)));
        du[p] = du_new;
        const float s2 = __fadd_rn(__fmul_rn(neg_alpha, nsum(dv, Q, p, i, j, H, W)),
                                   __fmul_rn(ixy, du_new));
        dv[p] = __fadd_rn(
            __fmul_rn(one_minus_omega, dv[p]),
            __fmul_rn(__fdiv_rn(omega, __ldg(Q.denv + p)),
                      __fsub_rn(__ldg(Q.b2 + p), s2)));
      }
      __syncthreads();
    }
  }
}

}  // namespace

// du and dv must hold zeros on entry (the wrapper allocates them so).
// Returns 0, a cudaError_t from the launch, or -1 for a bad size.
extern "C" int sor_redblack_launch(const void* ww, const void* we,
                                   const void* wn, const void* ws,
                                   const void* denu, const void* denv,
                                   const void* b1, const void* b2,
                                   const void* ixy, void* du, void* dv, int B,
                                   int H, int W, int n_sor, float neg_alpha,
                                   float omega, float one_minus_omega,
                                   void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || n_sor < 0) return -1;
  Planes P{static_cast<const float*>(ww),   static_cast<const float*>(we),
           static_cast<const float*>(wn),   static_cast<const float*>(ws),
           static_cast<const float*>(denu), static_cast<const float*>(denv),
           static_cast<const float*>(b1),   static_cast<const float*>(b2),
           static_cast<const float*>(ixy)};
  sor_redblack_kernel<<<B, THREADS, 0, static_cast<cudaStream_t>(stream)>>>(
      P, static_cast<float*>(du), static_cast<float*>(dv), H, W, n_sor,
      neg_alpha, omega, one_minus_omega);
  return (int)cudaGetLastError();
}
