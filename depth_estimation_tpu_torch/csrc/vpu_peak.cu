// Issue-rate probes for Hopper (sm_90a): chains of FP32 FMAs and of expf,
// one f32 value a thread held in registers, for the peak meter that the
// roofline divides by.
//
// Replaces the two Pallas TPU kernels of the JAX package's peak meter:
//  P1 benchmarks/device_peaks.py:164 (_measure_vpu, pallas_call at :187),
//     driven by measure_vpu_fma_gflops (:235: 8 logistic chains of 16
//     steps) and measure_vpu_exp_gops (:252: 8 chains of 4 x <- exp(-x));
//  P2 benchmarks/probe_vpu_peak.py:36 (run, pallas_call at :43), the
//     logistic step in 1, 2, 4 and 8 chains (logi1-logi8, :64-95).
// The Python wrappers are vpu_loop (P1) and logistic_loop (P2) in
// depth_estimation_tpu_torch/benchmarks/device_peaks.py, and their plain
// twins chains_fma_plain and chains_exp_plain compute the same chains with
// the same seeds and the same combine in torch ops.
//
// What bounds it: only the unit it measures. The FMA chains are bound by
// the FP32 pipe, 132 SMs x 128 lanes x 2 flops a clock, 66.9 TFLOP/s at the
// 1.98 GHz boost clock (less at the clock the card holds under load). The
// exp chains are bound by the SFU, 16 results a clock an SM, 4.18 T/s at
// 1.98 GHz; expf (the precise one, as csrc/match_fused.cu calls it) also
// spends FP32 instructions on its range reduction, so it reads lower. The
// value is read once and written once, so memory moves 8 bytes an element
// against hundreds of operations an element.
//
// What the design does about it:
//  * One value a thread in a register, a grid-stride loop over the
//    elements, and a grid of (warps an SM / 8) 256-thread blocks on each of
//    the card's SMs: 8 blocks (64 warps, full occupancy, 32 registers a
//    thread at most) for the ceilings, 1 block of 128 threads (4 warps) for
//    P2's latency-bound sweep. The launcher refuses a grid that the SM
//    cannot hold at once.
//  * Each logistic step c <- c - c*c is one FFMA (nvcc contracts it), and
//    the chains are independent, so up to 8 FFMAs are in flight a thread.
//  * The chains cannot fold: the logistic step is not affine (a chain of
//    v*a + b with constant a, b composes into one FMA, the trap the JAX
//    probe's docstring records), exp is transcendental, and the result is
//    stored. The loop over iterations is not unrolled, so the compiler
//    sees one iteration's chains and a counter it cannot resolve.
//  * Both maps contract on the values they see: |d/dc (c - c^2)| =
//    |1 - 2c| < 1 on (0, 1), and |d/dx exp(-x)| = exp(-x) < 1 for x > 0,
//    so the kernel's fused FFMA and the twin's rounded multiply and
//    subtract part by a few ulp and do not grow.

#include <cuda_runtime.h>

namespace {

constexpr int MAX_THREADS = 256;
constexpr int MIN_BLOCKS = 8;       // 2048 threads an SM: 32 registers each

enum Op { FMA = 0, EXP = 1 };

// The JAX chains' seeds: v * (0.3 + 0.05 i) for 8 chains, v * (0.3 + 0.1 i)
// for P2's 4, (v, v * 0.5) for its 2, v for its 1; the double is rounded to
// f32 as JAX's weak-typed constant and torch's scalar are.
template <int CHAINS>
__device__ __forceinline__ float seed(int i) {
  return CHAINS == 8   ? static_cast<float>(0.3 + 0.05 * i)
         : CHAINS == 4 ? static_cast<float>(0.3 + 0.1 * i)
         : CHAINS == 2 ? static_cast<float>(1.0 - 0.5 * i)
                       : 1.0f;
}

template <int OP>
__device__ __forceinline__ float step(float c) {
  if constexpr (OP == FMA) return c - c * c;
  else return expf(-c);
}

// One iteration: seed CHAINS chains from v, STEPS steps each, then
// combine them as the JAX chains do (4 chains pairwise, the others in
// order), and (MEAN) scale by 1 / CHAINS.
template <int OP, int CHAINS, int STEPS, bool MEAN>
__device__ __forceinline__ float chains(float v) {
  float c[CHAINS];
#pragma unroll
  for (int i = 0; i < CHAINS; ++i) c[i] = CHAINS == 1 ? v : v * seed<CHAINS>(i);
#pragma unroll
  for (int s = 0; s < STEPS; ++s) {
#pragma unroll
    for (int i = 0; i < CHAINS; ++i) c[i] = step<OP>(c[i]);
  }
  float r;
  if constexpr (CHAINS == 4) {
    r = (c[0] + c[1]) + (c[2] + c[3]);
  } else {
    r = c[0];
#pragma unroll
    for (int i = 1; i < CHAINS; ++i) r = r + c[i];
  }
  if constexpr (MEAN) r = r * (1.0f / CHAINS);
  return r;
}

template <int OP, int CHAINS, int STEPS, bool MEAN>
__global__ void __launch_bounds__(MAX_THREADS, MIN_BLOCKS)
chains_kernel(const float* __restrict__ x, float* __restrict__ out, int n,
              int n_iter) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x +
                     threadIdx.x;
       i < n; i += stride) {
    float v = x[i];
#pragma unroll 1
    for (int it = 0; it < n_iter; ++it) v = chains<OP, CHAINS, STEPS, MEAN>(v);
    out[i] = v;
  }
}

template <int OP, int CHAINS, int STEPS, bool MEAN>
int launch(const float* x, float* out, int n, int n_iter, int threads,
           int blocks_per_sm, cudaStream_t stream) {
  auto kernel = chains_kernel<OP, CHAINS, STEPS, MEAN>;
  int dev, sms, fits;
  cudaError_t err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err == cudaSuccess)
    err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(&fits, kernel, threads,
                                                        0);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (blocks_per_sm > fits) return -1;
  const long long need = (static_cast<long long>(n) + threads - 1) / threads;
  const long long full = static_cast<long long>(sms) * blocks_per_sm;
  const int grid = static_cast<int>(need < full ? need : full);
  kernel<<<grid, threads, 0, stream>>>(x, out, n, n_iter);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// x, out: n f32 values; each is put through n_iter iterations of one
// variant's chains. variant: 0 P1 FMA (8 chains x 16 steps, mean), 1 P1
// exp (8 x 4, mean), 2-5 P2's logistic chains (1 x 64, 2 x 32, 4 x 16,
// 8 x 8, summed). threads a block and blocks an SM set the occupancy.
// Returns a cudaError_t, or -1 for a variant or occupancy it does not take.
extern "C" int vpu_peak_launch(const void* x, void* out, int n, int n_iter,
                               int variant, int threads, int blocks_per_sm,
                               void* stream) {
  const float* xp = static_cast<const float*>(x);
  float* op = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (n <= 0 || n_iter < 0 || threads <= 0 || threads > MAX_THREADS ||
      threads % 32 != 0 || blocks_per_sm <= 0)
    return -1;
  switch (variant) {
    case 0: return launch<FMA, 8, 16, true>(xp, op, n, n_iter, threads,
                                            blocks_per_sm, st);
    case 1: return launch<EXP, 8, 4, true>(xp, op, n, n_iter, threads,
                                           blocks_per_sm, st);
    case 2: return launch<FMA, 1, 64, false>(xp, op, n, n_iter, threads,
                                             blocks_per_sm, st);
    case 3: return launch<FMA, 2, 32, false>(xp, op, n, n_iter, threads,
                                             blocks_per_sm, st);
    case 4: return launch<FMA, 4, 16, false>(xp, op, n, n_iter, threads,
                                             blocks_per_sm, st);
    case 5: return launch<FMA, 8, 8, false>(xp, op, n, n_iter, threads,
                                            blocks_per_sm, st);
    default: return -1;
  }
}
