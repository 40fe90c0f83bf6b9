// Banded bilinear warp for Hopper (sm_90a): sample imgs (B, H, W, C), in
// f32, bf16 or f16, at (ys, xs) (B, H, W) with the bilinear hat, zero
// border, taps clipped to shifts in [-band, band+1] on both axes; f32
// output.
//
// Replaces the Pallas TPU kernel depth_estimation_tpu/ops/warp.py:38
// (_banded_kernel, called by banded_bilinear_warp at :85). The Python
// wrapper is depth_estimation_tpu_torch/ops/warp.py:banded_bilinear_warp,
// and its plain twin banded_bilinear_warp_plain computes the same taps.
//
// The TPU kernel sums (2*band+2)^2 static shifts of the zero-padded image,
// each weighted by hat(dy - s) * hat(dx - t), because gathers are slow on a
// TPU. The hat is non-zero only at s in {floor(dy), floor(dy)+1} and
// t in {floor(dx), floor(dx)+1}, so every output is at most four taps; on
// Hopper a four-tap gather is the simple form. A tap counts only if its
// shift lies in the band and the tapped pixel lies in the image. The sum is
// grouped as the reference's XLA form groups it,
//   out = hat_y0 * (hat_x0 * a + hat_x1 * b) + hat_y1 * (hat_x0 * c + hat_x1 * d),
// with rounded intrinsics so that no FMA contraction changes the rounding.
//
// What bounds it. At the online program's shape (B=128, 165x305, C=10) the
// function reads the image once (0.258 GB in f32, 0.129 GB in bf16) and the
// coordinates (0.052 GB) and writes 0.258 GB, for 7 FP32 operations an
// output value: bound by memory traffic, 0.169 ms in f32 and 0.131 ms in
// bf16 at 3.35 TB/s. The first design (one thread a pixel on a 1-D grid)
// ran 0.586 / 0.492 ms (NVIDIA H100 80GB HBM3, 700 W): each thread
// recovered (b, i, j) with four 64-bit divisions and modulos, and read 4 x C
// and wrote C scalars at a stride of C elements from its neighbours, so one
// warp instruction touched ~10 cache lines instead of one.
//
// What the design does about it. One CTA owns a segment of up to 128
// pixels of one output row (a 3-D grid: segment, row, image; no 64-bit
// arithmetic but the base offsets), one thread a pixel. A thread computes
// its pixel's four tap offsets and hat weights once, then its C outputs,
// channel by channel as grid_sample does: the lanes' loads of one channel
// lie C elements apart, but the next channels' loads find the same lines
// in L1. The outputs go to shared memory first, and the CTA then writes
// the segment's C x 128 values as one contiguous run, so each store
// instruction fills whole lines, where the first design's stores of one
// channel, C elements apart, wrote a partial sector a lane. Two forms that
// map lanes to consecutive (pixel, channel) elements and share the taps
// through shared memory or warp shuffles ran 0.316 / 0.368 and 0.353 /
// 0.367 ms (f32 / bf16, chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W):
// slower than this form, whose loads are those of grid_sample. Segments
// shrink below 128 pixels only where 128 pixels' outputs would not fit in
// shared memory (C above 454).
// Measured (chip_smoke.py, NVIDIA H100 80GB HBM3, 700.00 W): one call
// through the wrapper f32 0.273-0.278 ms, bf16 0.218-0.221 ms, against
// 0.475-0.498 / 0.426-0.481 ms for the first design in the same call; ten
// back to back 0.238-0.240 / 0.179-0.181 ms a call, 70-73% of the bytes
// bounds. torch.nn.functional.grid_sample on the same inputs (NCHW view,
// bf16 output in bf16) 0.236-0.239 / 0.188-0.193 ms, 0.223-0.225 / 0.174
// back to back.

#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int SEG = 128;            // output pixels a CTA, one a thread
constexpr int MAX_GRID_Z = 65535;
constexpr size_t SMEM_LIMIT = 227 * 1024;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }
__device__ __forceinline__ float to_f(__half v) { return __half2float(v); }

__device__ __forceinline__ float hat(float d, float s) {
  return fmaxf(0.f, __fsub_rn(1.f, fabsf(__fsub_rn(d, s))));
}

template <typename T>
__global__ void __launch_bounds__(SEG)
warp_banded_kernel(const T* __restrict__ img, const float* __restrict__ xs,
                   const float* __restrict__ ys, float* __restrict__ out,
                   int H, int W, int C, int band) {
  extern __shared__ float seg_out[];       // the segment's outputs, (pixel, c)
  const int seg = blockDim.x;
  const int i = blockIdx.y;
  const int b = blockIdx.z;
  const int x0 = blockIdx.x * seg;
  const int npix = min(seg, W - x0);
  const int tid = threadIdx.x;
  const size_t row = ((size_t)b * H + i) * W + x0;   // first pixel's index

  if (tid < npix) {
    const int j = x0 + tid;
    const float dy = __fsub_rn(ys[row + tid], (float)i);
    const float dx = __fsub_rn(xs[row + tid], (float)j);
    const float s0 = floorf(dy);
    const float t0 = floorf(dx);
    const float lo = (float)(-band);
    const float hi = (float)(band + 1);
    const float s1 = s0 + 1.f;
    const float t1 = t0 + 1.f;
    // band test in float first (NaN and huge displacements fail it), then
    // the in-image test on the integer tap position
    const bool bs0 = s0 >= lo && s0 <= hi;
    const bool bs1 = s1 >= lo && s1 <= hi;
    const bool bt0 = t0 >= lo && t0 <= hi;
    const bool bt1 = t1 >= lo && t1 <= hi;
    const int y0 = bs0 ? i + (int)s0 : -1;
    const int y1 = bs1 ? i + (int)s1 : -1;
    const int c0 = bt0 ? j + (int)t0 : -1;
    const int c1 = bt1 ? j + (int)t1 : -1;
    const bool vy0 = bs0 && y0 >= 0 && y0 < H;
    const bool vy1 = bs1 && y1 >= 0 && y1 < H;
    const bool vx0 = bt0 && c0 >= 0 && c0 < W;
    const bool vx1 = bt1 && c1 >= 0 && c1 < W;
    const float wy0 = hat(dy, s0), wy1 = hat(dy, s1);
    const float wx0 = hat(dx, t0), wx1 = hat(dx, t1);
    // invalid taps are never read; point them at the image's first pixel
    const T* base = img + (size_t)b * H * W * C;
    const T* p00 = base + (vy0 && vx0 ? (y0 * W + c0) * C : 0);
    const T* p01 = base + (vy0 && vx1 ? (y0 * W + c1) * C : 0);
    const T* p10 = base + (vy1 && vx0 ? (y1 * W + c0) * C : 0);
    const T* p11 = base + (vy1 && vx1 ? (y1 * W + c1) * C : 0);
    float* o = seg_out + tid * C;
    for (int c = 0; c < C; ++c) {
      const float a = (vy0 && vx0) ? to_f(p00[c]) : 0.f;
      const float bb = (vy0 && vx1) ? to_f(p01[c]) : 0.f;
      const float cc = (vy1 && vx0) ? to_f(p10[c]) : 0.f;
      const float d = (vy1 && vx1) ? to_f(p11[c]) : 0.f;
      const float row0 = __fadd_rn(__fmul_rn(wx0, a), __fmul_rn(wx1, bb));
      const float row1 = __fadd_rn(__fmul_rn(wx0, cc), __fmul_rn(wx1, d));
      o[c] = __fadd_rn(__fmul_rn(wy0, row0), __fmul_rn(wy1, row1));
    }
  }
  __syncthreads();

  // the segment's outputs are contiguous in the channels-last output
  float* dst = out + row * C;
  const int n = npix * C;
  for (int e = tid; e < n; e += seg) dst[e] = seg_out[e];
}

template <typename T>
int launch_typed(const void* img, const void* xs, const void* ys, void* out,
                 int B, int H, int W, int C, int band, int seg, size_t smem,
                 cudaStream_t st) {
  if (smem > 48 * 1024) {   // beyond the default, opt in (C above 96)
    cudaError_t err = cudaFuncSetAttribute(
        warp_banded_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)smem);
    if (err != cudaSuccess) return (int)err;
  }
  const size_t image = (size_t)H * W;
  // the grid's third dimension holds at most 65535 images: launch in chunks
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Z) {
    const int nb = B - b0 < MAX_GRID_Z ? B - b0 : MAX_GRID_Z;
    dim3 grid((W + seg - 1) / seg, H, nb);
    warp_banded_kernel<T><<<grid, seg, smem, st>>>(
        static_cast<const T*>(img) + b0 * image * C,
        static_cast<const float*>(xs) + b0 * image,
        static_cast<const float*>(ys) + b0 * image,
        static_cast<float*>(out) + b0 * image * C, H, W, C, band);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Returns 0, a cudaError_t from the launch, or -1 for a configuration the
// kernel does not take: an empty tensor, a negative band, more than 65535
// rows, an image of 2^31 elements or more (tap offsets are 32-bit), a
// pixel's C outputs beyond 227 KB of shared memory (C above 58,000), or a
// storage code other than 0 (f32), 1 (bf16) and 2 (f16).
extern "C" int warp_banded_launch(const void* img, const void* xs,
                                  const void* ys, void* out, int B, int H,
                                  int W, int C, int band, int storage,
                                  void* stream) {
  if (B <= 0 || H <= 0 || W <= 0 || C <= 0 || band < 0 || H > MAX_GRID_Z ||
      (size_t)H * W * C > (size_t)INT_MAX)
    return -1;
  // the segment: 128 pixels, halved while their outputs overflow shared
  // memory
  int seg = SEG;
  while (seg > 1 && (size_t)seg * C * sizeof(float) > SMEM_LIMIT) seg /= 2;
  const size_t smem = (size_t)seg * C * sizeof(float);
  if (smem > SMEM_LIMIT) return -1;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (storage) {
    case 0:
      return launch_typed<float>(img, xs, ys, out, B, H, W, C, band, seg,
                                 smem, st);
    case 1:
      return launch_typed<__nv_bfloat16>(img, xs, ys, out, B, H, W, C, band,
                                         seg, smem, st);
    case 2:
      return launch_typed<__half>(img, xs, ys, out, B, H, W, C, band, seg,
                                  smem, st);
  }
  return -1;
}
