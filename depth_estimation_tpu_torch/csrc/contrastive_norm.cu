// The version2 net's local contrastive normalisation on Hopper (sm_90a):
// torch's nn.SpatialContrastiveNormalization as the port's
// ops/normalization.py computes it, in two launches around one aten reduce.
//
// The JAX package has no TPU kernel here: its
// depth_estimation_tpu/ops/normalization.spatial_contrastive_normalization
// is jnp code that XLA fuses. The Python wrapper is
// depth_estimation_tpu_torch/ops/normalization.py (contrastive_norm), and
// its plain twin is the torch code beside it
// (spatial_contrastive_normalization_plain).
//
// What bounds it. The twin runs two separable k-tap convolutions of the
// frames (the local mean, then the local variance) as one aten mul and one
// aten add a tap and direction, each reading and writing whole (B, C, H, W)
// tensors: at the version2 cell's 128 frames of 180x320x3 and k = 17 that is
// ~236 launches and ~30 GB a call. The work itself reads the frames once and
// writes the output once; with the per-pixel mean and std written and read
// back (needed for the per-frame mean of the std, a reduction across the
// whole frame) it is ~0.41 GB, 0.12 ms at 3.35 TB/s, against ~420 FP32
// operations a pixel (0.05 ms at 67 TFLOP/s) and ~800 with the halo's
// recomputation below: below the card's ridge point, so the design keeps
// every intermediate in shared memory.
//
// The design. contrastive_norm_stats: a block a 32x32 tile of one frame
// (256 threads). It stages the frame's C channels over the tile and a halo
// of 2(k - 1) (zeros outside the frame), then, a channel at a time, the
// vertical pass over the mean's region (the tile and a halo of k - 1) and the
// horizontal pass, added into the channel sum in c order; the last channel's
// sum is divided by the border map coef. The squared deviations then
// overwrite the staged channels in place (zeros outside the frame), and the
// same two passes run over the tile alone, their channel sum kept in
// registers; divided by coef, clamped at 0 and square-rooted, it is the local
// std. The block writes the tile's local mean and std (B, H, W). A pass is
// register-blocked: a thread slides down (or along) a strip of 4 outputs,
// loading each input once and adding it to each output whose window holds it,
// so that a load feeds up to 4 taps; the row passes read buffers of odd pitch
// with a row a lane, free of bank conflicts. The window the cell uses
// (k = 17) is compiled with its taps unrolled and its offsets constant; any
// other k from 1 to 33 runs the same code with the window's length a runtime
// value. The wrapper then takes the per-frame mean of the std with torch's
// own reduce, and contrastive_norm_apply, a thread a pixel, writes
// (img - mean) / clamp(maximum(std, frame mean), 1e-4). On an H100 at the
// cell's shape the stats launch takes ~0.48 ms, held by its FP32 issue
// (the passes over the halo), the apply ~0.10 ms, by its bytes; ~5 times
// the bytes bound in all, against ~13 ms for the twin.
//
// Bit for bit. Every operation is written with the rounded intrinsics
// (__fadd_rn, __fsub_rn, __fmul_rn, __fdiv_rn, __fsqrt_rn) in the twin's
// order, so that nvcc contracts nothing into an FMA: each output of a pass
// starts from the twin's 0 and adds w[t] * x tap by tap, t = 0 .. k - 1,
// the zero padding's taps included; the channel sums start from channel 0
// and add 1 .. C - 1; mean = sum / coef and var = sum / coef are true
// divisions as torch's; the squares are (x - mean) * (x - mean). maximum and
// clamp keep torch's NaNs: maximum returns a NaN operand (the first one), a
// clamp passes a NaN through. The taps are the wrapper's f32 values of the
// twin's window, which torch rounds its Python scalars to.

#include <cuda_runtime.h>
#include <limits.h>

#include <atomic>

namespace {

constexpr int TILE = 32;               // a block's output tile, TILE x TILE
constexpr int THREADS = 256;
constexpr int R = 4;                   // outputs a thread sums along a strip
constexpr int KMAX = 33, CMAX = 4;     // the widest window, the most channels
constexpr int FAST_K = 17;             // the window compiled unrolled
constexpr int MAX_GRID_Y = 65535;
static_assert(THREADS * R == TILE * TILE, "one row strip a thread");

struct Taps {
  float w[KMAX];
};

__host__ __device__ constexpr int round_up(int a, int m) {
  return (a + m - 1) / m * m;
}

// The shared memory of a block for a window of k taps: the staged channels
// (rows of the image's region, pitch ip), the vertical pass's buffer (pitch
// vp) and the mean's region (pitch mp), in floats, and the taps. A strip
// that runs past the region reads and writes rows or columns whose results
// are not kept.
struct Layout {
  int k, lo;      // the window's offsets: -lo .. k - 1 - lo
  int ext;        // k - 1
  int mh;         // the mean's region, mh x mh: the tile and a halo of ext
  int iw;         // the image's region's columns, mh + ext
  int vrows;      // mh in whole strips: the mean's passes' rows and columns
  int irows;      // the image's rows staged: vrows + ext
  int ip, vp, mp; // pitches, odd
  int plane;      // floats a staged channel

  __host__ __device__ constexpr explicit Layout(int k_)
      : k(k_), lo(k_ / 2), ext(k_ - 1), mh(TILE + k_ - 1),
        iw(TILE + 2 * (k_ - 1)),
        vrows(round_up(TILE + k_ - 1, R)),
        irows(round_up(TILE + k_ - 1, R) + k_ - 1),
        ip((TILE + 2 * (k_ - 1)) | 1),
        vp((round_up(TILE + k_ - 1, R) + k_ - 1) | 1),
        mp((TILE + k_ - 1) | 1),
        plane((round_up(TILE + k_ - 1, R) + k_ - 1) *
              ((TILE + 2 * (k_ - 1)) | 1)) {}

  __host__ __device__ constexpr int floats(int C) const {
    return C * plane + vrows * vp + mh * mp + KMAX;
  }
};

// acc[j] = sum over t of w[t] * src[(j + t) * stride], t = 0 .. k - 1 in
// order from 0, for j = 0 .. R - 1: one load of each of the strip's k + R - 1
// inputs, added to every output whose window holds it. K > 0: the taps'
// count and values compile-time (the kernel's parameters); K = 0: k taps
// read from shared memory.
template <int K>
__device__ __forceinline__ void strip(const float* __restrict__ src,
                                      int stride, const Taps& taps,
                                      const float* __restrict__ wsm, int k,
                                      float (&acc)[R]) {
#pragma unroll
  for (int j = 0; j < R; ++j) acc[j] = 0.f;
  if constexpr (K > 0) {
#pragma unroll
    for (int s = 0; s < K + R - 1; ++s) {
      const float x = src[s * stride];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int t = s - j;
        if (t >= 0 && t < K) acc[j] = __fadd_rn(acc[j], __fmul_rn(taps.w[t], x));
      }
    }
  } else {
    for (int s = 0; s < k + R - 1; ++s) {
      const float x = src[s * stride];
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int t = s - j;
        if (t >= 0 && t < k) acc[j] = __fadd_rn(acc[j], __fmul_rn(wsm[t], x));
      }
    }
  }
}

// The local mean and the local std of a 32x32 tile (blockIdx.x) of frame
// blockIdx.y: img (H, W, C) a frame, coef (H, W), mean and std (H, W) a frame.
template <int K, int C>
__global__ void __launch_bounds__(THREADS, 2)
contrastive_norm_stats(const float* __restrict__ img,
                       const float* __restrict__ coef,
                       float* __restrict__ mean_out,
                       float* __restrict__ std_out,
                       const __grid_constant__ Taps taps, int k_rt, int H,
                       int W, int tiles_x) {
  extern __shared__ float smem[];
  const Layout L(K > 0 ? K : k_rt);
  const int k = L.k;
  float* const im = smem;                      // C staged channels
  float* const va = im + C * L.plane;          // a vertical pass
  float* const mn = va + L.vrows * L.vp;       // the mean's region
  float* const wsm = mn + L.mh * L.mp;         // the taps
  const int tid = threadIdx.x;
  if (tid < KMAX) wsm[tid] = taps.w[tid];

  const int y0 = (blockIdx.x / tiles_x) * TILE;
  const int x0 = (blockIdx.x % tiles_x) * TILE;
  const size_t frame = (size_t)blockIdx.y * H * W;
  const float* src = img + frame * C;

  // stage the image's region, rows and columns from (y0, x0) - 2 lo
  for (int p = tid; p < L.irows * L.iw; p += THREADS) {
    const int r = p / L.iw, col = p - r * L.iw;
    const int y = y0 - 2 * L.lo + r, x = x0 - 2 * L.lo + col;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const float* px = src + ((size_t)(in ? y : 0) * W + (in ? x : 0)) * C;
#pragma unroll
    for (int c = 0; c < C; ++c)
      im[c * L.plane + r * L.ip + col] = in ? __ldg(px + c) : 0.f;
  }
  __syncthreads();

  // the local mean over the mean's region
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const float* ic = im + c * L.plane;
    for (int s = tid; s < (L.vrows / R) * L.iw; s += THREADS) {
      const int g = s / L.iw, col = s - g * L.iw;
      float acc[R];
      strip<K>(ic + g * R * L.ip + col, L.ip, taps, wsm, k, acc);
#pragma unroll
      for (int j = 0; j < R; ++j) va[(g * R + j) * L.vp + col] = acc[j];
    }
    __syncthreads();
    for (int s = tid; s < L.mh * (L.vrows / R); s += THREADS) {
      const int h = s / L.mh, i = s - h * L.mh;
      float acc[R];
      strip<K>(va + i * L.vp + h * R, 1, taps, wsm, k, acc);
      const int y = y0 - L.lo + i;
#pragma unroll
      for (int j = 0; j < R; ++j) {
        const int jj = h * R + j;
        if (jj >= L.mh) break;
        float v = acc[j];
        if (c > 0) v = __fadd_rn(mn[i * L.mp + jj], v);
        const int x = x0 - L.lo + jj;
        if (c == C - 1 && y >= 0 && y < H && x >= 0 && x < W)
          v = __fdiv_rn(v, __ldg(coef + (size_t)y * W + x));
        mn[i * L.mp + jj] = v;
      }
    }
    __syncthreads();
  }

  // the squared deviations over the mean's region, in place of the staged
  // channels; zeros outside the frame
  for (int p = tid; p < L.mh * L.mh; p += THREADS) {
    const int i = p / L.mh, j = p - i * L.mh;
    const int y = y0 - L.lo + i, x = x0 - L.lo + j;
    const bool in = y >= 0 && y < H && x >= 0 && x < W;
    const float m = mn[i * L.mp + j];
#pragma unroll
    for (int c = 0; c < C; ++c) {
      float* q = im + c * L.plane + (i + L.lo) * L.ip + j + L.lo;
      const float d = __fsub_rn(*q, m);
      *q = in ? __fmul_rn(d, d) : 0.f;
    }
  }
  for (int p = tid; p < TILE * TILE; p += THREADS) {
    const int i = p / TILE, j = p % TILE;
    if (y0 + i < H && x0 + j < W)
      mean_out[frame + (size_t)(y0 + i) * W + x0 + j] =
          mn[(i + L.lo) * L.mp + j + L.lo];
  }
  __syncthreads();

  // the local variance over the tile: this thread's row strip of the
  // horizontal pass, summed over the channels in registers
  const int bi = tid % TILE, bh = tid / TILE;
  float var[R];
#pragma unroll 1
  for (int c = 0; c < C; ++c) {
    const float* sc = im + c * L.plane + L.lo * L.ip + L.lo;
    for (int s = tid; s < (TILE / R) * L.mh; s += THREADS) {
      const int g = s / L.mh, j = s - g * L.mh;
      float acc[R];
      strip<K>(sc + g * R * L.ip + j, L.ip, taps, wsm, k, acc);
#pragma unroll
      for (int jj = 0; jj < R; ++jj) va[(g * R + jj) * L.vp + j] = acc[jj];
    }
    __syncthreads();
    float acc[R];
    strip<K>(va + bi * L.vp + bh * R, 1, taps, wsm, k, acc);
#pragma unroll
    for (int j = 0; j < R; ++j) var[j] = c == 0 ? acc[j] : __fadd_rn(var[j], acc[j]);
    __syncthreads();
  }

  // the local std, staged in the mean's buffer for row-wise stores
  const int y = y0 + bi;
#pragma unroll
  for (int j = 0; j < R; ++j) {
    const int x = x0 + bh * R + j;
    float s = 0.f;
    if (y < H && x < W) {
      float lv = __fdiv_rn(var[j], __ldg(coef + (size_t)y * W + x));
      lv = lv < 0.f ? 0.f : lv;          // clamp(min=0): a NaN passes
      s = __fsqrt_rn(lv);
    }
    mn[bi * L.mp + bh * R + j] = s;
  }
  __syncthreads();
  for (int p = tid; p < TILE * TILE; p += THREADS) {
    const int i = p / TILE, j = p % TILE;
    if (y0 + i < H && x0 + j < W)
      std_out[frame + (size_t)(y0 + i) * W + x0 + j] = mn[i * L.mp + j];
  }
}

// out = (img - mean) / clamp(maximum(std, fmean), 1e-4), a thread a pixel
// (blockIdx.x * blockDim.x + threadIdx.x) of frame blockIdx.y; fmean (one a
// frame) the per-frame mean of std.
template <int C>
__global__ void __launch_bounds__(THREADS)
contrastive_norm_apply(const float* __restrict__ img,
                       const float* __restrict__ mean,
                       const float* __restrict__ stdv,
                       const float* __restrict__ fmean,
                       float* __restrict__ out, int HW) {
  const int p = blockIdx.x * THREADS + threadIdx.x;
  if (p >= HW) return;
  const size_t q = (size_t)blockIdx.y * HW + p;
  const float s = stdv[q], f = __ldg(fmean + blockIdx.y);
  // torch.maximum: a NaN operand wins; clamp(min=1e-4): a NaN passes
  float t = s != s ? s : f != f ? f : fmaxf(s, f);
  t = t != t ? t : fmaxf(t, 1e-4f);
  const float m = mean[q];
#pragma unroll
  for (int c = 0; c < C; ++c)
    out[q * C + c] = __fdiv_rn(__fsub_rn(img[q * C + c], m), t);
}

// Allow an instantiation the shared memory of the widest window of its C
// channels on the current device, once a device (a bit each for devices 0
// to 31; above, on every launch).
template <int K, int C>
cudaError_t allow_smem() {
  static std::atomic<unsigned> done{0};
  int d = 0;
  cudaError_t err = cudaGetDevice(&d);
  if (err != cudaSuccess) return err;
  const unsigned bit = d >= 0 && d < 32 ? 1u << d : 0u;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  const int most = Layout(K > 0 ? K : KMAX).floats(C) * (int)sizeof(float);
  err = cudaFuncSetAttribute(contrastive_norm_stats<K, C>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             most);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int K, int C>
int launch_stats(const float* img, const float* coef, float* mean,
                 float* stdv, const Taps& taps, int k, int B, int H, int W,
                 cudaStream_t st) {
  cudaError_t err = allow_smem<K, C>();
  if (err != cudaSuccess) return (int)err;
  const size_t smem = (size_t)Layout(k).floats(C) * sizeof(float);
  const int tiles_x = (W + TILE - 1) / TILE;
  const int tiles = tiles_x * ((H + TILE - 1) / TILE);
  const size_t frame = (size_t)H * W;
  // the grid's second dimension holds at most 65535 frames: in chunks
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int nb = B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y;
    const size_t f = b0 * frame;
    contrastive_norm_stats<K, C><<<dim3(tiles, nb), THREADS, smem, st>>>(
        img + f * C, coef, mean + f, stdv + f, taps, k, H, W, tiles_x);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <int C>
int launch_c(const float* img, const float* coef, float* mean, float* stdv,
             const Taps& taps, int k, int B, int H, int W, cudaStream_t st) {
  if (k == FAST_K)
    return launch_stats<FAST_K, C>(img, coef, mean, stdv, taps, k, B, H, W,
                                   st);
  return launch_stats<0, C>(img, coef, mean, stdv, taps, k, B, H, W, st);
}

template <int C>
int launch_apply(const float* img, const float* mean, const float* stdv,
                 const float* fmean, float* out, int B, int H, int W,
                 cudaStream_t st) {
  const int HW = H * W;
  const size_t frame = (size_t)HW;
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int nb = B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y;
    const size_t f = b0 * frame;
    contrastive_norm_apply<C><<<dim3((HW + THREADS - 1) / THREADS, nb),
                                THREADS, 0, st>>>(
        img + f * C, mean + f, stdv + f, fmean + b0, out + f * C, HW);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

bool bad_size(int k, int B, int H, int W, int C) {
  return k < 1 || k > KMAX || C < 1 || C > CMAX || B < 0 || H <= 0 ||
         W <= 0 || (size_t)H * W * C >= (size_t)INT_MAX;
}

}  // namespace

// The local mean and std (B, H, W) of B frames img (B, H, W, C) under the
// window of k taps whose f32 values are the host array `taps`, with coef
// (H, W) the border map; all f32 and contiguous. Returns 0, a cudaError_t
// from the launch, or -1 for a size the kernel does not take (k outside
// 1 .. 33, C outside 1 .. 4, an empty frame, a frame of 2^31 elements or
// more).
extern "C" int contrastive_norm_stats_launch(const void* img,
                                             const void* coef, void* mean,
                                             void* stdv, const void* taps,
                                             int k, int B, int H, int W,
                                             int C, void* stream) {
  if (bad_size(k, B, H, W, C)) return -1;
  if (B == 0) return 0;
  Taps t{};
  const float* w = static_cast<const float*>(taps);
  for (int n = 0; n < k; ++n) t.w[n] = w[n];
  const auto* a = static_cast<const float*>(img);
  const auto* cf = static_cast<const float*>(coef);
  auto* m = static_cast<float*>(mean);
  auto* s = static_cast<float*>(stdv);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_c<1>(a, cf, m, s, t, k, B, H, W, st);
    case 2: return launch_c<2>(a, cf, m, s, t, k, B, H, W, st);
    case 3: return launch_c<3>(a, cf, m, s, t, k, B, H, W, st);
    default: return launch_c<4>(a, cf, m, s, t, k, B, H, W, st);
  }
}

// out (B, H, W, C) = (img - mean) / clamp(maximum(std, fmean), 1e-4) with
// mean, std (B, H, W) from contrastive_norm_stats_launch and fmean (B) the
// mean of each frame's std; all f32 and contiguous. Returns 0, a
// cudaError_t, or -1 for a size the kernel does not take.
extern "C" int contrastive_norm_apply_launch(const void* img,
                                             const void* mean,
                                             const void* stdv,
                                             const void* fmean, void* out,
                                             int B, int H, int W, int C,
                                             void* stream) {
  if (bad_size(1, B, H, W, C)) return -1;
  if (B == 0) return 0;
  const auto* a = static_cast<const float*>(img);
  const auto* m = static_cast<const float*>(mean);
  const auto* s = static_cast<const float*>(stdv);
  const auto* f = static_cast<const float*>(fmean);
  auto* o = static_cast<float*>(out);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1: return launch_apply<1>(a, m, s, f, o, B, H, W, st);
    case 2: return launch_apply<2>(a, m, s, f, o, B, H, W, st);
    case 3: return launch_apply<3>(a, m, s, f, o, B, H, W, st);
    default: return launch_apply<4>(a, m, s, f, o, B, H, W, st);
  }
}
