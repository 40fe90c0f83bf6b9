// The liu solve's IRLS coefficient planes on Hopper (sm_90a): in one launch,
// an IRLS step's derivatives (both features smoothed by the 5-tap Gaussian,
// their 0.4 / 0.6 average, its 5-tap x and y derivatives, dt), the flow's
// forward differences and Phi, It and Psi with its noise mask, the five
// channel means, both weighted Laplacians and right sides, the stencil's
// four weights and both denominators: the nine planes kernel B4
// (sor_redblack.cu) reads.
//
// The JAX package has no TPU kernel here: its celiu IRLS step is jnp code
// that XLA fuses. The Python wrapper is
// depth_estimation_tpu_torch/flow/liu_irls.py (irls_planes), and its plain
// twin is the solver's torch code, flow/celiu.py's _irls_planes under the
// Laplacian noise model.
//
// What bounds it. A step reads both features (C channels each) and the flow
// (u, v; and du, dv on a warm start) and writes nine planes: at C = 5 about
// 84 bytes a pixel, 0.31 GB at the liu cell's finest level (B=64, 180x320),
// 0.092 ms at 3.35 TB/s, against ~500 FP32 operations a pixel (0.03 ms at
// 67 TFLOP/s). The torch form it replaces ran ~256 aten calls a step, each
// reading and writing whole planes, at ~100 times the bytes bound. This
// kernel reads each byte once; what holds it near 4 times the bound on an
// H100 is its shared-memory passes and their barriers, two a channel, at
// three 512-thread blocks an SM (its registers capped at 40 for that).
//
// The design. A block computes a TH x TW tile of output pixels, a thread a
// pixel, on a grid of (tiles, images). It stages both features with a
// 4-pixel halo (2 for the Gaussian, 2 for the derivative) and the flow with
// a 1-pixel halo in shared memory, with coalesced loads of the channels-last
// rows, then, a channel at a time, runs the Gaussian's H pass over the halo,
// the V pass and the average over the derivative's halo, and each thread's
// derivatives, Psi and products; the products of every channel stay in the
// thread's registers until the channel means. Phi is computed once for the
// tile and its west column and north row, so that the stencil's west and
// north weights and the Laplacian's shifted fluxes are read, not written and
// read back. Each thread stores its nine outputs, coalesced along the row. No
// atomics; every output element is written, none is read.
//
// The edges. Each pass clamps at the image's edge as the twin does: the H
// pass reads the features' columns clamped, the V pass the H pass's rows
// clamped, the derivatives the average's rows and columns clamped. Every
// staged buffer is indexed by position and holds the value at the clamped
// position, and each tap clamps its real coordinate before it is looked up.
//
// Bit for bit. Every operation is written with the rounded intrinsics
// (__fadd_rn, __fsub_rn, __fmul_rn, __fsqrt_rn, __frcp_rn) in torch's
// order, so that nvcc contracts nothing into an FMA: each filter's sum
// starts from the twin's zero and adds w * p tap by tap; 0.5 / t is
// torch's reciprocal(t) * 0.5 and 1 / (2 sqrt(.)) its reciprocal times 1;
// the masks (the last column and row, lap_para >= 1e-20) multiply by 1.0 or
// 0.0; a warm start's It adds dx du and dy dv as the twin does, and the
// cold start adds dx 0 and dy 0. The channel mean follows torch's CUDA
// reduction over the last dim of C values: last_pow2(C) lanes, lane t
// summing (0 + a[t]) + (0 + a[t + P]), then 0 and 0 (its four
// accumulators), a shuffle tree at offsets P / 2, ..., 2, 1 (read off on
// the card for 3 to 8 channels), and the product with torch's factor,
// float(B H W) / float(B H W C), which the wrapper passes. Only the
// features' channel counts, 3 (gray) and 5 (colour), are compiled.
// The scalars (the filters' taps, 0.4, 0.6, the epsilons, alpha,
// alpha * 0.05, the mask's bound) come from the wrapper as the f32 values
// torch rounds the twin's Python scalars to.

#include <cuda_runtime.h>
#include <limits.h>

#include <atomic>

namespace {

constexpr int TW = 32, TH = 16;            // the tile, one pixel a thread
constexpr int THREADS = TW * TH;
constexpr int XW = TW + 8, XH = TH + 8;    // the features' window: 4-pixel halo
constexpr int GW = TW + 4;                 // the H pass's columns (XH rows)
constexpr int AH = TH + 4;                 // the average's rows (GW columns)
constexpr int FW = TW + 2, FH = TH + 2;    // the flow's window: 1-pixel halo
constexpr int PW = TW + 1, PH = TH + 1;    // Phi: the tile, its west and north
constexpr int MAX_GRID_Y = 65535;

// the scalars, in the order of the wrapper's array
struct Consts {
  float g[5];          // the Gaussian's taps (celiu._GFILTER)
  float d[5];          // the derivative's taps (celiu._DERIV5)
  float w1, w2;        // the average's weights, 0.4 and 0.6
  float eps_phi, eps_psi, lap_min;
  float alpha, alpha_eps;   // alpha and alpha * 0.05
  float mean_factor;   // torch's factor of a channel mean
};
constexpr int N_CONSTS = sizeof(Consts) / sizeof(float);

struct Planes {
  float *w_w, *w_e, *w_n, *w_s, *denom_u, *denom_v, *b1, *b2, *imdxy;
};

__device__ __forceinline__ int clampi(int v, int hi) {
  return min(max(v, 0), hi);
}

__host__ __device__ constexpr int last_pow2(int c) {
  return c >= 8 ? 8 : c >= 4 ? 4 : c >= 2 ? 2 : 1;
}

// torch.mean(a, dim=-1) over C values as torch's CUDA reduction adds them
template <int C>
__device__ __forceinline__ float channel_mean(const float (&a)[C],
                                              float factor) {
  constexpr int P = last_pow2(C);
  float lane[P];
#pragma unroll
  for (int t = 0; t < P; ++t) {
    const float first = __fadd_rn(0.f, a[t]);
    // (the index stays in range where the branch is not taken)
    const float second = t + P < C ? __fadd_rn(0.f, a[t + P < C ? t + P : t])
                                   : 0.f;
    lane[t] = __fadd_rn(__fadd_rn(__fadd_rn(first, second), 0.f), 0.f);
  }
#pragma unroll
  for (int off = P / 2; off > 0; off >>= 1)
#pragma unroll
    for (int t = 0; t < off; ++t) lane[t] = __fadd_rn(lane[t], lane[t + off]);
  return __fmul_rn(lane[0], factor);
}

// the shared memory of one block, in floats
template <int C, bool WARM>
constexpr int smem_floats() {
  return 2 * XH * XW * C + 2 * XH * GW + AH * GW + TH * TW +
         (WARM ? 4 : 2) * FH * FW + PH * PW;
}

// One IRLS step's planes for a tile of one image (blockIdx.y). im1, im2 are
// the features (H, W, C), u, v (and on a warm start du, dv) the flow, lap the
// image's noise estimate (C).
template <int C, bool WARM>
__global__ void __launch_bounds__(THREADS, 3)
liu_irls_kernel(const float* __restrict__ im1, const float* __restrict__ im2,
                const float* __restrict__ u, const float* __restrict__ v,
                const float* __restrict__ du, const float* __restrict__ dv,
                const float* __restrict__ lap, Planes out, Consts k, int H,
                int W, int tiles_x) {
  extern __shared__ float smem[];
  float* xs1 = smem;                        // XH x XW x C, frame 1's features
  float* xs2 = xs1 + XH * XW * C;           // the warp's
  float* h1 = xs2 + XH * XW * C;            // XH x GW, the H pass
  float* h2 = h1 + XH * GW;
  float* avg = h2 + XH * GW;                // AH x GW, 0.4 s1 + 0.6 s2
  float* sdt = avg + AH * GW;               // TH x TW, s2 - s1
  float* fu = sdt + TH * TW;                // FH x FW, u and v
  float* fv = fu + FH * FW;
  float* fuu = WARM ? fv + FH * FW : fu;    // u + du, v + dv
  float* fvv = WARM ? fuu + FH * FW : fv;
  float* phi = fvv + FH * FW;               // PH x PW

  const int b = blockIdx.y;
  const int i0 = (blockIdx.x / tiles_x) * TH;
  const int j0 = (blockIdx.x % tiles_x) * TW;
  const int tx = threadIdx.x, ty = threadIdx.y;
  const int tid = ty * TW + tx;
  const int i = i0 + ty, j = j0 + tx;
  const bool in = i < H && j < W;
  const size_t image = (size_t)b * H * W;
  // no tap of the tile's windows clamps along a row (column): the passes'
  // indices are then plain offsets
  const bool x_inner = j0 >= 4 && j0 + TW + 3 < W;
  const bool y_inner = i0 >= 4 && i0 + TH + 3 < H;

  // the features' window, rows and columns clamped into the image
  const float* a1 = im1 + image * C;
  const float* a2 = im2 + image * C;
  for (int e = tid; e < XH * XW * C; e += THREADS) {
    const int r = e / (XW * C);
    const int rest = e - r * (XW * C);
    const int s = rest / C;
    const size_t g = ((size_t)clampi(i0 - 4 + r, H - 1) * W +
                      clampi(j0 - 4 + s, W - 1)) * C + (rest - s * C);
    xs1[e] = __ldg(a1 + g);
    xs2[e] = __ldg(a2 + g);
  }
  // the flow's window
  for (int e = tid; e < FH * FW; e += THREADS) {
    const int r = e / FW;
    const size_t g = image + (size_t)clampi(i0 - 1 + r, H - 1) * W +
                     clampi(j0 - 1 + (e - r * FW), W - 1);
    const float uu = __ldg(u + g), vv = __ldg(v + g);
    fu[e] = uu;
    fv[e] = vv;
    if (WARM) {
      fuu[e] = __fadd_rn(uu, __ldg(du + g));
      fvv[e] = __fadd_rn(vv, __ldg(dv + g));
    }
  }
  __syncthreads();

  // Phi at the tile, its west column and its north row (positions outside
  // the image are computed from clamped values and never read)
  for (int e = tid; e < PH * PW; e += THREADS) {
    const int r = e / PW, c = e - r * PW;
    const int f = r * FW + c;
    const bool east = j0 - 1 + c < W - 1, south = i0 - 1 + r < H - 1;
    const float ux = east ? __fsub_rn(fuu[f + 1], fuu[f]) : 0.f;
    const float uy = south ? __fsub_rn(fuu[f + FW], fuu[f]) : 0.f;
    const float vx = east ? __fsub_rn(fvv[f + 1], fvv[f]) : 0.f;
    const float vy = south ? __fsub_rn(fvv[f + FW], fvv[f]) : 0.f;
    float s = __fadd_rn(__fmul_rn(ux, ux), __fmul_rn(uy, uy));
    s = __fadd_rn(s, __fmul_rn(vx, vx));
    s = __fadd_rn(s, __fmul_rn(vy, vy));
    s = __fadd_rn(s, k.eps_phi);
    phi[e] = __fmul_rn(__frcp_rn(__fsqrt_rn(s)), 0.5f);
  }

  float du0 = 0.f, dv0 = 0.f;              // the twin's zeros on a cold start
  if (WARM && in) {
    du0 = __ldg(du + image + (size_t)i * W + j);
    dv0 = __ldg(dv + image + (size_t)i * W + j);
  }
  // the derivatives' taps in the average's window, the same every channel
  int ox[5], oy[5];
#pragma unroll
  for (int t = 0; t < 5; ++t) {
    ox[t] = (ty + 2) * GW + clampi(j + t - 2, W - 1) - (j0 - 2);
    oy[t] = (clampi(i + t - 2, H - 1) - (i0 - 2)) * GW + tx + 2;
  }
  // the Gaussian along W over the window's rows, at columns j0 - 2 ..
  // j0 + TW + 1 (clamped); `col` gives a tap's column in the window
  auto h_pass = [&](int c, auto col) {
    for (int e = tid; e < XH * GW; e += THREADS) {
      const int r = e / GW, q = e - r * GW;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int x = (r * XW + col(q, t)) * C + c;
        s1 = __fadd_rn(s1, __fmul_rn(k.g[t], xs1[x]));
        s2 = __fadd_rn(s2, __fmul_rn(k.g[t], xs2[x]));
      }
      h1[e] = s1;
      h2[e] = s2;
    }
  };
  // along H at rows i0 - 2 .. i0 + TH + 1 (clamped), the average, and dt at
  // the tile's pixels; `row` gives a tap's row in the H pass's window
  auto v_pass = [&](auto row) {
    for (int e = tid; e < AH * GW; e += THREADS) {
      const int r = e / GW, q = e - r * GW;
      float s1 = 0.f, s2 = 0.f;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        const int x = row(r, t) * GW + q;
        s1 = __fadd_rn(s1, __fmul_rn(k.g[t], h1[x]));
        s2 = __fadd_rn(s2, __fmul_rn(k.g[t], h2[x]));
      }
      avg[e] = __fadd_rn(__fmul_rn(k.w1, s1), __fmul_rn(k.w2, s2));
      const int ti = r - 2, tj = q - 2;
      if (ti >= 0 && ti < TH && tj >= 0 && tj < TW)
        sdt[ti * TW + tj] = __fsub_rn(s2, s1);
    }
  };
  float pxy[C], px2[C], py2[C], ptx[C], pty[C];
#pragma unroll
  for (int c = 0; c < C; ++c) {
    if (x_inner)
      h_pass(c, [](int q, int t) { return q + t; });
    else
      h_pass(c, [&](int q, int t) {
        return clampi(clampi(j0 - 2 + q, W - 1) + t - 2, W - 1) - (j0 - 4);
      });
    __syncthreads();
    if (y_inner)
      v_pass([](int r, int t) { return r + t; });
    else
      v_pass([&](int r, int t) {
        return clampi(clampi(i0 - 2 + r, H - 1) + t - 2, H - 1) - (i0 - 4);
      });
    __syncthreads();
    if (in) {
      float dx = 0.f, dy = 0.f;
#pragma unroll
      for (int t = 0; t < 5; ++t) {
        dx = __fadd_rn(dx, __fmul_rn(k.d[t], avg[ox[t]]));
        dy = __fadd_rn(dy, __fmul_rn(k.d[t], avg[oy[t]]));
      }
      const float dt = sdt[tid];
      const float it =
          __fadd_rn(__fadd_rn(dt, __fmul_rn(dx, du0)), __fmul_rn(dy, dv0));
      const float root =
          __fsqrt_rn(__fadd_rn(__fmul_rn(it, it), k.eps_psi));
      float psi = __fmul_rn(__frcp_rn(__fmul_rn(root, 2.f)), 1.f);
      psi = __fmul_rn(psi, __ldg(lap + (size_t)b * C + c) >= k.lap_min
                               ? 1.f : 0.f);
      const float pdx = __fmul_rn(psi, dx), pdy = __fmul_rn(psi, dy);
      pxy[c] = __fmul_rn(pdx, dy);
      px2[c] = __fmul_rn(pdx, dx);
      py2[c] = __fmul_rn(pdy, dy);
      ptx[c] = __fmul_rn(pdx, dt);
      pty[c] = __fmul_rn(pdy, dt);
    }
  }
  if (!in) return;

  // the stencil's weights: west and north from the neighbours' Phi, zero at
  // the image's edge; east and south this pixel's, masked at the last column
  // and row
  const int p = (ty + 1) * PW + tx + 1;
  const float ph = phi[p], ph_w = phi[p - 1], ph_n = phi[p - PW];
  const float w_w = j > 0 ? ph_w : 0.f;
  const float w_e = __fmul_rn(ph, j < W - 1 ? 1.f : 0.f);
  const float w_n = i > 0 ? ph_n : 0.f;
  const float w_s = __fmul_rn(ph, i < H - 1 ? 1.f : 0.f);
  // the divergence-form Laplacian of the flow before du, dv:
  // ((-fh - fv) + fh[west]) + fv[north], fh = (f[east] - f) Phi and
  // fv = (f[south] - f) Phi, their forward differences zero at the edge
  const int f = (ty + 1) * FW + tx + 1;
  auto laplacian = [&](const float* F) {
    const float fh = __fmul_rn(j < W - 1 ? __fsub_rn(F[f + 1], F[f]) : 0.f, ph);
    const float fv = __fmul_rn(i < H - 1 ? __fsub_rn(F[f + FW], F[f]) : 0.f, ph);
    float o = __fsub_rn(-fh, fv);
    o = __fadd_rn(o, j > 0 ? __fmul_rn(__fsub_rn(F[f], F[f - 1]), ph_w) : 0.f);
    return __fadd_rn(o, i > 0 ? __fmul_rn(__fsub_rn(F[f], F[f - FW]), ph_n)
                              : 0.f);
  };
  const float m = k.mean_factor;
  const float coeff = __fmul_rn(
      k.alpha, __fadd_rn(__fadd_rn(__fadd_rn(w_w, w_e), w_n), w_s));
  const size_t q = image + (size_t)i * W + j;
  out.w_w[q] = w_w;
  out.w_e[q] = w_e;
  out.w_n[q] = w_n;
  out.w_s[q] = w_s;
  out.denom_u[q] =
      __fadd_rn(__fadd_rn(channel_mean<C>(px2, m), k.alpha_eps), coeff);
  out.denom_v[q] =
      __fadd_rn(__fadd_rn(channel_mean<C>(py2, m), k.alpha_eps), coeff);
  out.b1[q] = __fsub_rn(-channel_mean<C>(ptx, m),
                        __fmul_rn(k.alpha, laplacian(fu)));
  out.b2[q] = __fsub_rn(-channel_mean<C>(pty, m),
                        __fmul_rn(k.alpha, laplacian(fv)));
  out.imdxy[q] = channel_mean<C>(pxy, m);
}

// Allow an instantiation its shared memory on the current device, once a
// device (a bit each for devices 0 to 31; above, on every launch): a solve
// launches it 68 times.
template <int C, bool WARM>
cudaError_t allow_smem(size_t smem) {
  static std::atomic<unsigned> done{0};
  int d = 0;
  cudaError_t err = cudaGetDevice(&d);
  if (err != cudaSuccess) return err;
  const unsigned bit = d >= 0 && d < 32 ? 1u << d : 0u;
  if (bit != 0 && (done.load() & bit) != 0) return cudaSuccess;
  err = cudaFuncSetAttribute(liu_irls_kernel<C, WARM>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)smem);
  if (err == cudaSuccess) done.fetch_or(bit);
  return err;
}

template <int C, bool WARM>
int launch(const float* im1, const float* im2, const float* u,
           const float* v, const float* du, const float* dv, const float* lap,
           Planes out, const Consts& k, int B, int H, int W,
           cudaStream_t st) {
  const size_t smem = smem_floats<C, WARM>() * sizeof(float);
  cudaError_t err = allow_smem<C, WARM>(smem);
  if (err != cudaSuccess) return (int)err;
  const int tiles_x = (W + TW - 1) / TW;
  const int tiles = tiles_x * ((H + TH - 1) / TH);
  const size_t image = (size_t)H * W;
  // the grid's second dimension holds at most 65535 images: in chunks
  for (int b0 = 0; b0 < B; b0 += MAX_GRID_Y) {
    const int nb = B - b0 < MAX_GRID_Y ? B - b0 : MAX_GRID_Y;
    const size_t f = b0 * image;
    Planes o = out;
    float** fields[] = {&o.w_w,     &o.w_e,     &o.w_n, &o.w_s, &o.denom_u,
                        &o.denom_v, &o.b1,      &o.b2,  &o.imdxy};
    for (float** pl : fields) *pl += f;
    liu_irls_kernel<C, WARM><<<dim3(tiles, nb), dim3(TW, TH), smem, st>>>(
        im1 + f * C, im2 + f * C, u + f, v + f, WARM ? du + f : nullptr,
        WARM ? dv + f : nullptr, lap + (size_t)b0 * C, o, k, H, W, tiles_x);
    err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

template <bool WARM>
int launch_c(int C, const float* im1, const float* im2, const float* u,
             const float* v, const float* du, const float* dv,
             const float* lap, Planes out, const Consts& k, int B, int H,
             int W, cudaStream_t st) {
  if (C == 3)
    return launch<3, WARM>(im1, im2, u, v, du, dv, lap, out, k, B, H, W, st);
  if (C == 5)
    return launch<5, WARM>(im1, im2, u, v, du, dv, lap, out, k, B, H, W, st);
  return -1;
}

}  // namespace

// One IRLS step's coefficient planes of B images: the features im1f and
// warp (B, H, W, C), the flow u, v (B, H, W) and, when du is not null, a warm
// start's increments du, dv (B, H, W), the noise estimate lap_para (B, C),
// all f32 and contiguous; writes w_w, w_e, w_n, w_s, denom_u, denom_v, b1,
// b2, imdxy (B, H, W). `consts` is a host array of the N_CONSTS scalars in
// the order of struct Consts. Returns 0, a cudaError_t from the launch, or
// -1 for a size the kernel does not take (an empty image, C other than 3 or 5,
// an image of 2^31 elements or more) or a du without dv.
extern "C" int liu_irls_launch(const void* im1f, const void* warp,
                               const void* u, const void* v, const void* du,
                               const void* dv, const void* lap_para,
                               void* w_w, void* w_e, void* w_n, void* w_s,
                               void* denom_u, void* denom_v, void* b1,
                               void* b2, void* imdxy, const void* consts,
                               int n_consts, int B, int H, int W, int C,
                               void* stream) {
  if (B < 0 || H <= 0 || W <= 0 || (C != 3 && C != 5) ||
      (size_t)H * W * C >= (size_t)INT_MAX || n_consts != N_CONSTS ||
      (du == nullptr) != (dv == nullptr))
    return -1;
  if (B == 0) return 0;
  Consts k;
  const float* src = static_cast<const float*>(consts);
  float* dst = reinterpret_cast<float*>(&k);
  for (int n = 0; n < N_CONSTS; ++n) dst[n] = src[n];
  Planes out{static_cast<float*>(w_w),     static_cast<float*>(w_e),
             static_cast<float*>(w_n),     static_cast<float*>(w_s),
             static_cast<float*>(denom_u), static_cast<float*>(denom_v),
             static_cast<float*>(b1),      static_cast<float*>(b2),
             static_cast<float*>(imdxy)};
  const auto* a = static_cast<const float*>(im1f);
  const auto* w = static_cast<const float*>(warp);
  const auto* pu = static_cast<const float*>(u);
  const auto* pv = static_cast<const float*>(v);
  const auto* pdu = static_cast<const float*>(du);
  const auto* pdv = static_cast<const float*>(dv);
  const auto* lp = static_cast<const float*>(lap_para);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (du != nullptr)
    return launch_c<true>(C, a, w, pu, pv, pdu, pdv, lp, out, k, B, H, W, st);
  return launch_c<false>(C, a, w, pu, pv, pdu, pdv, lp, out, k, B, H, W, st);
}
