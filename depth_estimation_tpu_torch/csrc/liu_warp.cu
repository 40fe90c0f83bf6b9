// The liu solve's warps on Hopper (sm_90a): in one launch, the flow update
// u + du, v + dv, the packed-tap bilinear warp of frame 2 by the updated
// flow with frame 1 where the sample point leaves the image, and the
// Laplacian noise estimate's per-channel sums; and Liu's resize, its sample
// coordinates made on the card. Both sample through one routine (taps()
// and blend() below).
//
// The JAX package has no TPU kernel here: its celiu.warp_image, imresize
// and the noise estimate are jnp code that XLA fuses. The Python wrapper is
// depth_estimation_tpu_torch/flow/liu_warp.py (warp_update_noise, resize),
// and its plain twins warp_update_noise_plain and resize_plain are the
// solver's torch code (flow/celiu.py: warp_image, laplacian_noise,
// bilinear_sample(packed=True)).
//
// What bounds it. One warp reads u, v, du, dv, writes u and v, reads frame
// 1 and the four taps of frame 2 and writes the warp: at C = 5 about 84
// bytes a pixel, 0.31 GB at the liu cell's finest level (B=64, 180x320),
// 0.09 ms at 3.35 TB/s, against ~40 FP32 operations a pixel. The torch
// form it replaces built an edge-padded (H, W, 4C) tap table (a cat of
// four shifted copies) and gathered from it, then blended, selected and
// reduced in ~91 aten calls; its device time was ~50 times the bytes
// bound, and the host's issue of those calls left the card idle.
//
// The design. One thread a pixel, PX_PER_BLOCK pixels a block on a grid of
// (blocks an image, images): a block's pixels are consecutive in the
// image, so its run of frame 1 and of the warp is contiguous in the
// channels-last layout. The block loads frame 1's run into shared memory
// with coalesced loads, each thread gathers its four taps through the
// read-only path (neighbouring threads' taps share L1 lines: the flow is a
// few pixels) and stages its C outputs in shared memory, and the block
// stores the run contiguously, as B3 (warp_banded.cu) does. A pixel whose
// sample point leaves the image reads no tap. The noise sums go through
// warp shuffles to one partial a block and channel; a second small kernel
// of the same launch adds each image's partials in a fixed order, so the
// result does not depend on scheduling (no atomics).
//
// Bit for bit. The flow, the warp and the resize equal the torch form on
// the card: every operation is written with the rounded intrinsics
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn) in torch's order, so that
// nvcc contracts nothing into an FMA: x = j + u; clamp into the image (a
// NaN stays NaN, as torch.clamp keeps it); x0 = floor(x); dx = x - x0; the
// weights (1-dx)(1-dy), dx(1-dy), (1-dx)dy, dx dy; the sum
// ((w00 t00 + w10 t10) + w01 t01) + w11 t11 over the taps [y0, x0],
// [y0, min(x0+1, W-1)], [min(y0+1, H-1), x0], [min(y0+1, H-1),
// min(x0+1, W-1)]. The resize samples at x = (j + 1) / rx - 1 with rx the
// wrapper's f32 value, the IEEE division the host's CPU tensor division
// made. The noise sums add |It| in double in another order than torch's
// f32 reduction, so lap_para can differ from torch's in its last bits (it
// is 0 exactly where torch's is: no pixel with 0 < |It| < 1e6). That never
// reaches the flow: the solver reads lap_para only as lap_para >= 1e-20.

#include <cuda_runtime.h>
#include <limits.h>
#include <math.h>

namespace {

constexpr int PX_PER_BLOCK = 256;          // one pixel a thread
constexpr int WARPS = PX_PER_BLOCK / 32;
constexpr int MAX_C = 16;                  // channels (flow/liu_warp.py's MAX_CHANNELS)
constexpr int MAX_GRID_Y = 65535;

struct Sample {           // one output pixel's taps (element offsets) and weights
  int o00, o10, o01, o11;
  float w00, w10, w01, w11;
};

// torch.clamp(v, 0, hi): fminf/fmaxf drop a NaN, torch keeps it
__device__ __forceinline__ float clamp_keep_nan(float v, float hi) {
  return isnan(v) ? v : fminf(fmaxf(v, 0.f), hi);
}

// The packed form's taps at (x, y) of an H x W x C image: the coordinates
// clamped into the image first, then the corner and its right, lower and
// diagonal neighbours, each clamped to the last column or row.
__device__ __forceinline__ Sample taps(float x, float y, int H, int W, int C) {
  x = clamp_keep_nan(x, (float)(W - 1));
  y = clamp_keep_nan(y, (float)(H - 1));
  const float fx = floorf(x);
  const float fy = floorf(y);
  const int x0 = isnan(fx) ? 0 : (int)fx;   // a NaN converts to 0 on the card
  const int y0 = isnan(fy) ? 0 : (int)fy;
  const int x1 = min(x0 + 1, W - 1);
  const int y1 = min(y0 + 1, H - 1);
  const float dx = __fsub_rn(x, (float)x0);
  const float dy = __fsub_rn(y, (float)y0);
  const float ax = __fsub_rn(1.f, dx);
  const float ay = __fsub_rn(1.f, dy);
  Sample s;
  s.w00 = __fmul_rn(ax, ay);
  s.w10 = __fmul_rn(dx, ay);
  s.w01 = __fmul_rn(ax, dy);
  s.w11 = __fmul_rn(dx, dy);
  s.o00 = (y0 * W + x0) * C;
  s.o10 = (y0 * W + x1) * C;
  s.o01 = (y1 * W + x0) * C;
  s.o11 = (y1 * W + x1) * C;
  return s;
}

__device__ __forceinline__ float blend(const float* __restrict__ img,
                                       const Sample& s, int c) {
  float v = __fadd_rn(__fmul_rn(s.w00, __ldg(img + s.o00 + c)),
                      __fmul_rn(s.w10, __ldg(img + s.o10 + c)));
  v = __fadd_rn(v, __fmul_rn(s.w01, __ldg(img + s.o01 + c)));
  return __fadd_rn(v, __fmul_rn(s.w11, __ldg(img + s.o11 + c)));
}

// One warp of one image a blockIdx.y: u_out = u + du, v_out = v + dv (when
// du is given; else the flow is u, v), warp = frame 2 at (i + v, j + u), or
// frame 1 where that point lies outside the image; with NOISE, each
// channel's sum of |im1 - warp| over 0 < |.| < 1e6 (and NaN or inf as
// torch's masked product gives them) and its count, one partial a block.
template <bool UPDATE, bool NOISE>
__global__ void __launch_bounds__(PX_PER_BLOCK)
liu_warp_kernel(const float* __restrict__ im1, const float* __restrict__ im2,
                const float* __restrict__ u, const float* __restrict__ v,
                const float* __restrict__ du, const float* __restrict__ dv,
                float* __restrict__ u_out, float* __restrict__ v_out,
                float* __restrict__ warp, double* __restrict__ part_sum,
                int* __restrict__ part_cnt, int H, int W, int C) {
  extern __shared__ float smem[];          // frame 1's run, then the warp's
  float* s_in = smem;
  float* s_out = smem + PX_PER_BLOCK * C;
  __shared__ double red_sum[WARPS][MAX_C];
  __shared__ int red_cnt[WARPS][MAX_C];
  const int HW = H * W;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * PX_PER_BLOCK;
  const int n = min(PX_PER_BLOCK, HW - p0);
  const int tid = threadIdx.x;
  const size_t image = (size_t)b * HW * C;
  const size_t run = image + (size_t)p0 * C;

  for (int e = tid; e < n * C; e += PX_PER_BLOCK) s_in[e] = __ldg(im1 + run + e);
  __syncthreads();

  if (tid < n) {
    const int p = p0 + tid;
    const size_t q = (size_t)b * HW + p;
    float uu = u[q];
    float vv = v[q];
    if (UPDATE) {
      uu = __fadd_rn(uu, du[q]);
      vv = __fadd_rn(vv, dv[q]);
      u_out[q] = uu;
      v_out[q] = vv;
    }
    const int i = p / W;
    const int j = p - i * W;
    const float x = __fadd_rn((float)j, uu);
    const float y = __fadd_rn((float)i, vv);
    const bool outside =
        x < 0.f || x > (float)(W - 1) || y < 0.f || y > (float)(H - 1);
    float* o = s_out + tid * C;
    const float* a = s_in + tid * C;
    if (outside) {
      for (int c = 0; c < C; ++c) o[c] = a[c];
    } else {
      const Sample s = taps(x, y, H, W, C);
      const float* img2 = im2 + image;
      for (int c = 0; c < C; ++c) o[c] = blend(img2, s, c);
    }
  }
  __syncthreads();
  for (int e = tid; e < n * C; e += PX_PER_BLOCK) warp[run + e] = s_out[e];

  if (NOISE) {
    const int lane = tid & 31;
    const int wid = tid >> 5;
    for (int c = 0; c < C; ++c) {
      double sum = 0.0;
      int cnt = 0;
      if (tid < n) {
        const float d = fabsf(__fsub_rn(s_in[tid * C + c], s_out[tid * C + c]));
        const bool ok = d > 0.f && d < 1e6f;
        sum = (double)d * (ok ? 1.0 : 0.0);   // torch's diff * valid
        cnt = ok ? 1 : 0;
      }
      for (int off = 16; off > 0; off >>= 1) {
        sum += __shfl_down_sync(0xffffffffu, sum, off);
        cnt += __shfl_down_sync(0xffffffffu, cnt, off);
      }
      if (lane == 0) {
        red_sum[wid][c] = sum;
        red_cnt[wid][c] = cnt;
      }
    }
    __syncthreads();
    if (tid < C) {
      double sum = 0.0;
      int cnt = 0;
      for (int w = 0; w < WARPS; ++w) {
        sum += red_sum[w][tid];
        cnt += red_cnt[w][tid];
      }
      const size_t k = ((size_t)b * gridDim.x + blockIdx.x) * C + tid;
      part_sum[k] = sum;
      part_cnt[k] = cnt;
    }
  }
}

// lap[b, c] = (sum of image b's partials of channel c) / max(count, 1): one
// warp a (channel, image), lanes over the partials in a fixed order.
__global__ void __launch_bounds__(32)
liu_noise_kernel(const double* __restrict__ part_sum,
                 const int* __restrict__ part_cnt, float* __restrict__ lap,
                 int nblk, int C) {
  const int c = blockIdx.x;
  const int b = blockIdx.y;
  const int lane = threadIdx.x;
  double sum = 0.0;
  int cnt = 0;
  for (int t = lane; t < nblk; t += 32) {
    const size_t k = ((size_t)b * nblk + t) * C + c;
    sum += part_sum[k];
    cnt += part_cnt[k];
  }
  for (int off = 16; off > 0; off >>= 1) {
    sum += __shfl_down_sync(0xffffffffu, sum, off);
    cnt += __shfl_down_sync(0xffffffffu, cnt, off);
  }
  if (lane == 0)
    lap[(size_t)b * C + c] = __fdiv_rn((float)sum, (float)max(cnt, 1));
}

// Liu's resize of one image a blockIdx.y, (H, W, C) to (h, w, C): the sample
// at x = (j + 1) / rx - 1, y = (i + 1) / ry - 1, times `scale`.
__global__ void __launch_bounds__(PX_PER_BLOCK)
liu_resize_kernel(const float* __restrict__ img, float* __restrict__ out,
                  int H, int W, int C, int h, int w, float rx, float ry,
                  float scale) {
  extern __shared__ float s_out[];
  const int hw = h * w;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * PX_PER_BLOCK;
  const int n = min(PX_PER_BLOCK, hw - p0);
  const int tid = threadIdx.x;
  if (tid < n) {
    const int p = p0 + tid;
    const int i = p / w;
    const int j = p - i * w;
    const float x = __fsub_rn(__fdiv_rn((float)(j + 1), rx), 1.f);
    const float y = __fsub_rn(__fdiv_rn((float)(i + 1), ry), 1.f);
    const Sample s = taps(x, y, H, W, C);
    const float* src = img + (size_t)b * H * W * C;
    for (int c = 0; c < C; ++c)
      s_out[tid * C + c] = __fmul_rn(blend(src, s, c), scale);
  }
  __syncthreads();
  float* dst = out + ((size_t)b * hw + p0) * C;
  for (int e = tid; e < n * C; e += PX_PER_BLOCK) dst[e] = s_out[e];
}

bool sizes_ok(int B, int H, int W, int C, int px_per_block) {
  return B >= 0 && H > 0 && W > 0 && C > 0 && C <= MAX_C &&
         px_per_block == PX_PER_BLOCK && (size_t)H * W * C < (size_t)INT_MAX;
}

template <bool UPDATE, bool NOISE>
int launch_warp(const float* im1, const float* im2, const float* u,
                const float* v, const float* du, const float* dv, float* uo,
                float* vo, float* warp, double* ps, int* pc, float* lap, int B,
                int H, int W, int C, cudaStream_t st) {
  const size_t image = (size_t)H * W;
  const int nblk = (int)((image + PX_PER_BLOCK - 1) / PX_PER_BLOCK);
  const size_t smem = 2 * (size_t)PX_PER_BLOCK * C * sizeof(float);
  // the grid's second dimension holds at most 65535 images: in chunks
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int nb = B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y;
    const size_t f = b0 * image;
    liu_warp_kernel<UPDATE, NOISE><<<dim3(nblk, nb), PX_PER_BLOCK, smem, st>>>(
        im1 + f * C, im2 + f * C, u + f, v + f, UPDATE ? du + f : nullptr,
        UPDATE ? dv + f : nullptr, UPDATE ? uo + f : nullptr,
        UPDATE ? vo + f : nullptr, warp + f * C,
        NOISE ? ps + (size_t)b0 * nblk * C : nullptr,
        NOISE ? pc + (size_t)b0 * nblk * C : nullptr, H, W, C);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
    if (NOISE) {
      liu_noise_kernel<<<dim3(C, nb), 32, 0, st>>>(
          ps + (size_t)b0 * nblk * C, pc + (size_t)b0 * nblk * C,
          lap + (size_t)b0 * C, nblk, C);
      err = cudaGetLastError();
      if (err != cudaSuccess) return (int)err;
    }
  }
  return 0;
}

}  // namespace

// One warp of B images of H x W x C (channels last, f32): reads im1, im2,
// u, v (B, H, W) and, when du is not null, du and dv, writing u_out = u + du
// and v_out = v + dv (the warp then samples at the updated flow); writes
// warp (B, H, W, C); when part_sum is not null also lap (B, C), the
// Laplacian noise estimate, through the scratch partials part_sum (double)
// and part_cnt (int), each B x ceil(H * W / px_per_block) x C. Every output
// element is written and none is read. Returns 0, a cudaError_t from a
// launch, or -1 for a size the kernel does not take (an empty image, C
// outside [1, 16], an image of 2^31 elements or more) or a px_per_block
// other than the kernel's.
extern "C" int liu_warp_launch(const void* im1, const void* im2,
                               const void* u, const void* v, const void* du,
                               const void* dv, void* u_out, void* v_out,
                               void* warp, void* part_sum, void* part_cnt,
                               void* lap, int B, int H, int W, int C,
                               int px_per_block, void* stream) {
  if (!sizes_ok(B, H, W, C, px_per_block)) return -1;
  if ((du == nullptr) != (dv == nullptr) ||
      (du != nullptr && (u_out == nullptr || v_out == nullptr)) ||
      (part_sum != nullptr && (part_cnt == nullptr || lap == nullptr)))
    return -1;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const auto* a = static_cast<const float*>(im1);
  const auto* b = static_cast<const float*>(im2);
  const auto* pu = static_cast<const float*>(u);
  const auto* pv = static_cast<const float*>(v);
  const auto* pdu = static_cast<const float*>(du);
  const auto* pdv = static_cast<const float*>(dv);
  auto* uo = static_cast<float*>(u_out);
  auto* vo = static_cast<float*>(v_out);
  auto* wp = static_cast<float*>(warp);
  auto* ps = static_cast<double*>(part_sum);
  auto* pc = static_cast<int*>(part_cnt);
  auto* lp = static_cast<float*>(lap);
  const bool update = du != nullptr;
  const bool noise = part_sum != nullptr;
  if (update && noise)
    return launch_warp<true, true>(a, b, pu, pv, pdu, pdv, uo, vo, wp, ps, pc,
                                   lp, B, H, W, C, st);
  if (update)
    return launch_warp<true, false>(a, b, pu, pv, pdu, pdv, uo, vo, wp, ps,
                                    pc, lp, B, H, W, C, st);
  if (noise)
    return launch_warp<false, true>(a, b, pu, pv, pdu, pdv, uo, vo, wp, ps,
                                    pc, lp, B, H, W, C, st);
  return launch_warp<false, false>(a, b, pu, pv, pdu, pdv, uo, vo, wp, ps, pc,
                                   lp, B, H, W, C, st);
}

// Liu's resize of B images (H, W, C) to (h, w, C), f32 channels last, each
// sample times `scale`; rx = w / W and ry = h / H as f32 values. Every
// output element is written. Returns 0, a cudaError_t from the launch, or
// -1 for a size the kernel does not take (as liu_warp_launch, and an empty
// output).
extern "C" int liu_resize_launch(const void* img, void* out, int B, int H,
                                 int W, int C, int h, int w, float rx,
                                 float ry, float scale, int px_per_block,
                                 void* stream) {
  if (!sizes_ok(B, H, W, C, px_per_block) || !sizes_ok(B, h, w, C, px_per_block))
    return -1;
  if (B == 0) return 0;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t in_image = (size_t)H * W * C;
  const size_t out_image = (size_t)h * w * C;
  const int nblk = (int)(((size_t)h * w + PX_PER_BLOCK - 1) / PX_PER_BLOCK);
  const size_t smem = (size_t)PX_PER_BLOCK * C * sizeof(float);
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int nb = B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y;
    liu_resize_kernel<<<dim3(nblk, nb), PX_PER_BLOCK, smem, st>>>(
        static_cast<const float*>(img) + b0 * in_image,
        static_cast<float*>(out) + b0 * out_image, H, W, C, h, w, rx, ry,
        scale);
    cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}
