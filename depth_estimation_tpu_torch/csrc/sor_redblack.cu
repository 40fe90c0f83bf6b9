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
// at the ground truth's finest level (B=8, 192x256) that is 17 MB, 5 us at
// 3.35 TB/s, and 40 iterations x 30 FP32 operations a pixel are 7 us at
// 67 TFLOP/s. The true limit is neither: each half-sweep depends on the
// previous one, so a call is 2 x n_sor dependent steps, and a config2 solve
// 5,656 of them. A step costs at least one barrier across the CTAs that
// share an image plus the exchange of their boundary rows; chip_smoke.py
// measures that (the "dependency floor", sor_redblack_probe_launch below).
//
// What the design does about it. One thread-block cluster per image
// (cudaLaunchKernelEx with a cluster dimension; grid = cluster size x B),
// so an image's half-sweep runs on several SMs at once instead of one.
// CTA r owns rows [r * rows, (r + 1) * rows) of its image. Per half-sweep a
// CTA updates its pixels of one colour (du, then dv with the new du, at the
// same pixel), writes each new value of its first and last row straight
// into the neighbouring CTAs' halo rows through distributed shared memory
// (cluster.map_shared_rank), and then waits at cluster.sync(). Within one
// colour every neighbour is of the other colour, so no value that a CTA
// reads in a half-sweep is written in it. Shared memory holds the strip
// split by colour (see the kernel), so that a warp's reads of one colour
// and of its neighbours are contiguous: row-major storage read every other
// word, two lanes to a bank, and shared-memory wavefronts, not the
// barrier, were the larger part of a half-sweep. Where the planes live is
// the wrapper's plan (flow/sor_kernel.py:sor_plan, a rule on (H, W)):
//   mode 0: the strip's nine coefficient planes and du/dv (with one halo row
//           above and below) in shared memory, loaded once for all n_sor
//           iterations; omega / denom is divided once a pixel at load (the
//           same __fdiv_rn value the update needs);
//   mode 1: du/dv in shared memory, the coefficients read from L2 and the
//           division redone in every update (strips too big for mode 0);
//   mode 2: everything in global memory, ordered by the cluster barrier
//           (images whose du/dv do not fit a cluster's shared memory).
// The plan takes about 2048 pixels a CTA (two updates a thread a sweep) and
// at most 8 CTAs, a portable cluster size: the H100 holds 15 such clusters
// at once, but only 7 of 16 CTAs (one a GPC) at the shared memory a 16-CTA
// strip of 192x256 needs, so at B=8 the eighth image would wait for a
// second wave (16 CTAs of 12 rows, every plane in shared memory, measured
// even with 8: 0.280 against 0.289 ms a call). At config2 the finest level
// (192x256) runs as 8 CTAs of 24 rows in mode 1, every coarser level in
// mode 0, the coarsest (34x45) as one CTA. du and dv start at zero and the
// kernel sets every pixel of them, so the wrapper allocates them without a
// fill. Out-of-image neighbours read as 0, as the plain version's zero
// padding does; the boundary weights are zero there as well. -alpha, omega
// and 1 - omega come from the wrapper as f32 values, and the rounded
// intrinsics (__fmul_rn, __fadd_rn, __fsub_rn, __fdiv_rn) keep nvcc from
// contracting into FMAs, so the kernel rounds exactly as sor_plain does.
//
// Measured (H100 80GB HBM3, 700 W, chip_smoke.py): B=8 192x256, 40
// iterations, 0.36-0.41 ms for one call through the wrapper, its host work
// included (the one-block-per-image design this replaces: 2.426 ms, on 8
// SMs), and 0.28-0.29 ms a call back to back. Its dependency floor is
// 0.065-0.068 ms: 80 half-sweeps of 0.82-0.86 us, the cost of one cluster
// barrier with its exchange (the probe). A config2 solve's 56 launches take 8.2-8.4 ms
// of device time against a floor of 3.2-3.6 ms; at the coarse levels, one
// or two CTAs an image, instruction issue on those SMs is the rest.

#include <cuda_runtime.h>
#include <cooperative_groups.h>

#include <atomic>

namespace cg = cooperative_groups;

namespace {

constexpr int THREADS = 1024;
constexpr int MAX_CLUSTER = 8;    // CTAs an image (flow/sor_kernel.py's limit)
constexpr size_t SMEM_LIMIT = 227 * 1024;
enum Mode { ALL_SHARED = 0, FLOW_SHARED = 1, ALL_GLOBAL = 2 };

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

// the same formula as flow/sor_kernel.py:smem_bytes: du/dv of the strip
// with one halo row above and below, and (mode 0) its nine coefficient
// planes, each split by colour into rows of ceil(W / 2)
size_t smem_bytes(int mode, int rows, int W) {
  const size_t Wh = (W + 1) / 2;
  const size_t flow = mode == ALL_GLOBAL ? 0 : 4 * (rows + 2) * Wh;
  const size_t coef = mode == ALL_SHARED ? 18 * rows * Wh : 0;
  return (flow + coef) * sizeof(float);
}

__device__ __forceinline__ void sync_image(int C) {
  if (C > 1)
    cg::this_cluster().sync();
  else
    __syncthreads();
}

struct Coef {
  float ww, we, wn, ws, odu, odv, b1, b2, ixy;   // odu = omega / denom_u
};

// One pixel's update, sor_plain's arithmetic: s1 = -alpha * (w_w*left +
// w_e*right + w_n*up + w_s*down of du, left to right) + ixy * dv, then du,
// and dv from s2 with the new du. Out-of-image neighbours come in as 0.
__device__ __forceinline__ void sor_update(
    const Coef& c, float ul, float ur, float uu, float ud, float vl, float vr,
    float vu, float vd, float u, float v, float neg_alpha,
    float one_minus_omega, float& du_new, float& dv_new) {
  float s = __fmul_rn(c.ww, ul);
  s = __fadd_rn(s, __fmul_rn(c.we, ur));
  s = __fadd_rn(s, __fmul_rn(c.wn, uu));
  s = __fadd_rn(s, __fmul_rn(c.ws, ud));
  const float s1 = __fadd_rn(__fmul_rn(neg_alpha, s), __fmul_rn(c.ixy, v));
  du_new = __fadd_rn(__fmul_rn(one_minus_omega, u),
                     __fmul_rn(c.odu, __fsub_rn(c.b1, s1)));
  float t = __fmul_rn(c.ww, vl);
  t = __fadd_rn(t, __fmul_rn(c.we, vr));
  t = __fadd_rn(t, __fmul_rn(c.wn, vu));
  t = __fadd_rn(t, __fmul_rn(c.ws, vd));
  const float s2 = __fadd_rn(__fmul_rn(neg_alpha, t),
                             __fmul_rn(c.ixy, du_new));
  dv_new = __fadd_rn(__fmul_rn(one_minus_omega, v),
                     __fmul_rn(c.odv, __fsub_rn(c.b2, s2)));
}

// the coefficients of global pixel p, omega / denom divided here
__device__ __forceinline__ Coef global_coef(const Planes& P, size_t p,
                                            float omega) {
  return Coef{P.ww[p], P.we[p], P.wn[p], P.ws[p],
              __fdiv_rn(omega, P.denu[p]), __fdiv_rn(omega, P.denv[p]),
              P.b1[p], P.b2[p], P.ixy[p]};
}

// PROBE: no arithmetic, only the boundary-row exchange and the barrier of
// every half-sweep (the dependency floor of the same launch shape).
//
// Modes 0 and 1 keep the strip in shared memory split by colour, du and dv
// of a pixel side by side: pixel (i, j) of colour c = (i + j) & 1 sits at
// [c][i][j >> 1] as a float2 (du, dv), so the pixels a half-sweep updates,
// and each of their four neighbours, are contiguous across the threads of a
// warp (row-major storage read every other word, two lanes to a bank), and
// one 8-byte load brings both flows. Pixel (i, jj) of colour c has column
// j = 2 jj + par with par = (i + c) & 1; its neighbours, all of colour
// 1 - c, are left [i][jj + par - 1], right [i][jj + par], up [i - 1][jj],
// down [i + 1][jj]. Mode 0's coefficients sit in the same order, the nine
// of a pixel together (a stride of 9 words: no two lanes of a warp share a
// bank, and each load is a fixed offset from one address). Mode 2 updates
// du/dv in place in global memory.
template <int MODE, bool PROBE>
__global__ void __launch_bounds__(THREADS)
sor_cluster_kernel(Planes P, float* du, float* dv, int H, int W, int rows,
                   int n_sor, float neg_alpha, float omega,
                   float one_minus_omega) {
  extern __shared__ __align__(16) float smem[];
  cg::cluster_group cluster = cg::this_cluster();
  const int C = gridDim.x;           // the cluster spans x: one image
  const int r = blockIdx.x;
  const int r0 = r * rows;
  const int nrows = min(rows, H - r0);   // >= 1 by the plan
  const size_t own = (size_t)blockIdx.y * H * W + (size_t)r0 * W;
  // threads as TX colour columns x TY rows, fixed for the whole call
  const int Wh = (W + 1) / 2;
  const int TX = min(THREADS, (Wh + 31) / 32 * 32);
  const int TY = THREADS / TX;
  const int tx = threadIdx.x % TX;
  const int ty = threadIdx.x / TX;
  const bool active = ty < TY;
  float* gu = du + own;
  float* gv = dv + own;

  if (MODE == ALL_GLOBAL) {
    for (int lr = ty; active && lr < nrows; lr += TY)
      for (int j = tx; j < W; j += TX) {
        gu[lr * W + j] = 0.f;
        gv[lr * W + j] = 0.f;
      }
    sync_image(C);
    for (int it = 0; it < n_sor; ++it) {
      for (int color = 0; color < 2; ++color) {   // red: (i + j) even
        for (int lr = ty; !PROBE && active && lr < nrows; lr += TY) {
          const int i = r0 + lr;
          for (int jj = tx; jj < Wh; jj += TX) {
            const int j = 2 * jj + ((i + color) & 1);
            if (j >= W) continue;
            const int p = lr * W + j;
            const Coef c = global_coef(P, own + p, omega);
            float du_new, dv_new;
            sor_update(c, j > 0 ? gu[p - 1] : 0.f, j < W - 1 ? gu[p + 1] : 0.f,
                       i > 0 ? gu[p - W] : 0.f, i < H - 1 ? gu[p + W] : 0.f,
                       j > 0 ? gv[p - 1] : 0.f, j < W - 1 ? gv[p + 1] : 0.f,
                       i > 0 ? gv[p - W] : 0.f, i < H - 1 ? gv[p + W] : 0.f,
                       gu[p], gv[p], neg_alpha, one_minus_omega, du_new,
                       dv_new);
            gu[p] = du_new;
            gv[p] = dv_new;
          }
        }
        sync_image(C);
      }
    }
    return;
  }

  // f[c * cp + (lr + 1) * Wh + jj]: colour c, strip row lr in -1 .. nrows;
  // du = dv = 0 at the start, and the halo rows outside the image stay 0
  const int cp = (rows + 2) * Wh;
  float2* f = reinterpret_cast<float2*>(smem);
  for (int x = threadIdx.x; x < 2 * cp; x += THREADS)
    f[x] = make_float2(0.f, 0.f);
  // mode 0: coefficient k of (c, lr, jj) at sc[((c * rows + lr) * Wh + jj) * 9 + k]
  float* sc = smem + 4 * cp;
  if (MODE == ALL_SHARED && !PROBE) {
    for (int lr = ty; active && lr < nrows; lr += TY) {
      const int i = r0 + lr;
      for (int j = tx; j < W; j += TX) {
        const Coef c = global_coef(P, own + (size_t)lr * W + j, omega);
        float* x = sc + ((((i + j) & 1) * rows + lr) * Wh + (j >> 1)) * 9;
        x[0] = c.ww;
        x[1] = c.we;
        x[2] = c.wn;
        x[3] = c.ws;
        x[4] = c.odu;
        x[5] = c.odv;
        x[6] = c.b1;
        x[7] = c.b2;
        x[8] = c.ixy;
      }
    }
  }
  // every CTA of the cluster has started and filled its halos before any
  // CTA writes into them
  sync_image(C);
  // the neighbours' halo rows that this CTA's first and last rows fill
  float2 *up = nullptr, *dn = nullptr;
  if (C > 1) {
    if (r > 0) up = cluster.map_shared_rank(f, r - 1) + (rows + 1) * Wh;
    if (r < C - 1) dn = cluster.map_shared_rank(f, r + 1);
  }
  const float2 zero = make_float2(0.f, 0.f);

  for (int it = 0; it < n_sor; ++it) {
    for (int color = 0; color < 2; ++color) {   // red: (i + j) even
      for (int lr = ty; active && lr < nrows; lr += TY) {
        const int i = r0 + lr;
        const int par = (i + color) & 1;
        const bool first = lr == 0, last = lr == nrows - 1;
        if (PROBE && !first && !last) continue;
        const float2* o = f + (1 - color) * cp + (lr + 1) * Wh;  // other colour
        float2* me = f + color * cp + (lr + 1) * Wh;            // this colour
        const float* cx = sc + (color * rows + lr) * Wh * 9;
        for (int jj = tx; jj < Wh; jj += TX) {
          const int j = 2 * jj + par;
          if (j >= W) continue;
          float2 nw = me[jj];
          if (!PROBE) {
            Coef c;
            if (MODE == ALL_SHARED) {
              const float* x = cx + jj * 9;
              c = Coef{x[0], x[1], x[2], x[3], x[4], x[5], x[6], x[7], x[8]};
            } else {
              c = global_coef(P, own + (size_t)lr * W + j, omega);
            }
            const float2 L = j > 0 ? o[jj + par - 1] : zero;
            const float2 R = j < W - 1 ? o[jj + par] : zero;
            const float2 U = i > 0 ? o[jj - Wh] : zero;
            const float2 D = i < H - 1 ? o[jj + Wh] : zero;
            sor_update(c, L.x, R.x, U.x, D.x, L.y, R.y, U.y, D.y, nw.x, nw.y,
                       neg_alpha, one_minus_omega, nw.x, nw.y);
            me[jj] = nw;
          }
          if (first && up) up[color * cp + jj] = nw;
          if (last && dn) dn[color * cp + jj] = nw;
        }
      }
      sync_image(C);
    }
  }

  for (int lr = ty; active && lr < nrows; lr += TY) {
    const int i = r0 + lr;
    for (int j = tx; j < W; j += TX) {
      const float2 x = f[((i + j) & 1) * cp + (lr + 1) * Wh + (j >> 1)];
      gu[lr * W + j] = x.x;
      gv[lr * W + j] = x.y;
    }
  }
}

// The kernel's shared-memory attribute and cudaOccupancyMaxActiveClusters,
// set and asked once per (kernel, cluster size, shared memory, device): a
// config2 solve makes 56 launches of 7 shapes, and the host issues them
// one by one. An entry packs (cluster << 48 | smem << 16 | active), 0 where
// empty; a lookup is a few relaxed loads, with no lock.
constexpr int MAX_DEVICES = 64;
constexpr int SLOTS = 8;   // shapes kept a kernel and device (config2 has 7)
std::atomic<unsigned long long> prepared[MAX_DEVICES][3][2][SLOTS];

template <int MODE, bool PROBE>
int prepare(int C, int B, size_t smem, int device, cudaLaunchConfig_t* cfg,
            cudaLaunchAttribute* attr, int* active) {
  auto kern = sor_cluster_kernel<MODE, PROBE>;
  cfg->gridDim = dim3(C, B, 1);
  cfg->blockDim = dim3(THREADS, 1, 1);
  cfg->dynamicSmemBytes = smem;
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = C;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg->attrs = attr;
  cfg->numAttrs = 1;
  // the plan is the card's that holds the tensors, and that card must be
  // the current one (the wrapper makes it so): the attribute, the
  // occupancy query and the launch all act on the current device
  int current = 0;
  cudaError_t err = cudaGetDevice(&current);
  if (err != cudaSuccess) return (int)err;
  if (current != device) return -4;
  const unsigned long long key = (unsigned long long)C << 48 | smem << 16;
  std::atomic<unsigned long long>* slots =
      device < MAX_DEVICES ? prepared[device][MODE][PROBE] : nullptr;
  for (int k = 0; slots && k < SLOTS; ++k) {
    const unsigned long long e = slots[k].load(std::memory_order_relaxed);
    if (e >> 16 == key >> 16) {
      *active = (int)(e & 0xffff);
      return 0;
    }
  }
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)SMEM_LIMIT);
  if (err != cudaSuccess) return (int)err;
  err = cudaOccupancyMaxActiveClusters(active, kern, cfg);
  if (err != cudaSuccess) return (int)err;
  if (slots)
    slots[(C + smem / 64) % SLOTS].store(key | (unsigned)*active,
                                         std::memory_order_relaxed);
  return 0;
}

template <int MODE, bool PROBE>
int launch_mode(const Planes& P, float* du, float* dv, int B, int H, int W,
                int n_sor, float neg_alpha, float omega, float one_minus_omega,
                int C, int rows, int device, cudaStream_t stream) {
  const size_t smem = smem_bytes(MODE, rows, W);
  if (smem > SMEM_LIMIT) return -2;
  cudaLaunchConfig_t cfg = {};
  cudaLaunchAttribute attr[1];
  int active = 0;
  int err = prepare<MODE, PROBE>(C, B, smem, device, &cfg, attr, &active);
  if (err != 0) return err;
  if (active < 1) return -3;
  cfg.stream = stream;
  cudaError_t e = cudaLaunchKernelEx(&cfg, sor_cluster_kernel<MODE, PROBE>, P,
                                     du, dv, H, W, rows, n_sor, neg_alpha,
                                     omega, one_minus_omega);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

bool plan_ok(int B, int H, int W, int n_sor, int C, int rows, int mode) {
  return B > 0 && B <= 65535 && H > 0 && W > 0 && n_sor >= 0 && C >= 1 &&
         C <= MAX_CLUSTER && rows >= 1 && (H + rows - 1) / rows == C &&
         mode >= ALL_SHARED && mode <= ALL_GLOBAL;
}

template <bool PROBE>
int dispatch(const Planes& P, float* du, float* dv, int B, int H, int W,
             int n_sor, float neg_alpha, float omega, float one_minus_omega,
             int C, int rows, int mode, int device, cudaStream_t st) {
  if (!plan_ok(B, H, W, n_sor, C, rows, mode) || device < 0) return -1;
  if (mode == ALL_SHARED)
    return launch_mode<ALL_SHARED, PROBE>(P, du, dv, B, H, W, n_sor, neg_alpha,
                                          omega, one_minus_omega, C, rows,
                                          device, st);
  if (mode == FLOW_SHARED)
    return launch_mode<FLOW_SHARED, PROBE>(P, du, dv, B, H, W, n_sor, neg_alpha,
                                           omega, one_minus_omega, C, rows,
                                           device, st);
  return launch_mode<ALL_GLOBAL, PROBE>(P, du, dv, B, H, W, n_sor, neg_alpha,
                                        omega, one_minus_omega, C, rows,
                                        device, st);
}

}  // namespace

// du and dv are written, not read (the iterations start from zero).
// (cluster, rows, mode) is the wrapper's plan: cluster == ceil(H / rows)
// CTAs an image, each owning `rows` rows, planes placed by `mode`, on card
// `device` (the tensors' card, which must be the current device).
// Returns 0, a cudaError_t from the launch, -1 for a bad size or plan, -2
// where the plan's strip exceeds shared memory, -3 where the card cannot
// hold one such cluster, -4 where `device` is not the current device.
extern "C" int sor_redblack_launch(const void* ww, const void* we,
                                   const void* wn, const void* ws,
                                   const void* denu, const void* denv,
                                   const void* b1, const void* b2,
                                   const void* ixy, void* du, void* dv, int B,
                                   int H, int W, int n_sor, float neg_alpha,
                                   float omega, float one_minus_omega,
                                   int cluster, int rows, int mode,
                                   int device, void* stream) {
  Planes P{static_cast<const float*>(ww),   static_cast<const float*>(we),
           static_cast<const float*>(wn),   static_cast<const float*>(ws),
           static_cast<const float*>(denu), static_cast<const float*>(denv),
           static_cast<const float*>(b1),   static_cast<const float*>(b2),
           static_cast<const float*>(ixy)};
  return dispatch<false>(P, static_cast<float*>(du), static_cast<float*>(dv),
                         B, H, W, n_sor, neg_alpha, omega, one_minus_omega,
                         cluster, rows, mode, device,
                         static_cast<cudaStream_t>(stream));
}

// The dependency floor of a plan: the same launch with every half-sweep's
// boundary-row exchange and cluster barrier and no arithmetic, on scratch
// du/dv of B x H x W floats (left at zero). Same return codes as sor_redblack_launch.
extern "C" int sor_redblack_probe_launch(void* du, void* dv, int B, int H,
                                         int W, int n_sor, int cluster,
                                         int rows, int mode, int device,
                                         void* stream) {
  Planes P{};
  return dispatch<true>(P, static_cast<float*>(du), static_cast<float*>(dv),
                        B, H, W, n_sor, 0.f, 0.f, 0.f, cluster, rows, mode,
                        device, static_cast<cudaStream_t>(stream));
}
