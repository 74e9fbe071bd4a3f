// Selective-scan backward for Hopper (sm_90a): the gradients of
//   h_t = exp(dt_t A) h_{t-1} + dt_t B_t u_t,   y_t = C_t . h_t + D u_t
// (csrc/mamba_scan.cu) from dy and dh_T (zeros when absent). With g_t the
// gradient of h_t, walked from the last step to the first:
//   g_t    = C_t dy_t + exp(dt_{t+1} A) g_{t+1}        (g_T = dh_T)
//   du_t   = dt_t sum_n g_t B_t + D dy_t
//   ddt_t  = sum_n g_t (A exp(dt_t A) h_{t-1} + B_t u_t)
//   dB_t   = sum_d g_t dt_t u_t,     dC_t = sum_d dy_t h_t
//   dA     = sum_{b,t} g_t dt_t exp(dt_t A) h_{t-1},   dD = sum_{b,t} dy_t u_t
//   dh0    = exp(dt_1 A) g_1
// du, dB and dC in u's type; ddt, dA, dD and dh0 in float32.
//
// Replaces: src/repro/kernels/mamba_scan.py, mamba_scan_pallas (_kernel),
// whose gradient the reference takes by differentiating its jnp lax.scan
// (src/repro/kernels/ops.py, mamba_scan; the Pallas kernel has no VJP).
//
// Bound on an H100 SXM: u, dt and dy are read and du and ddt written once:
// at Jamba's training shape (Bt 8, T 512, d_in 16384, N 16, u bf16) ~0.94
// GB, 0.28 ms at 3.35 TB/s; one exponential per (b, t, d, n) at least,
// 1.07e9 or 0.26 ms at 4.18e12 per second. This kernel takes two (the
// stage's states are recomputed, then walked back) and moves the saved
// states (268 MB) and the dB / dC partial sums (134 MB written, read back)
// on top: it is written to be right and deterministic first.
//
// Design. The forward's training instance saved the float32 state at the
// start of every stage of kK = 16 steps. A block takes 256 threads over the
// channels of one batch row; thread (channel, q) owns four of the channel's
// NM states (NM = N rounded up to 4, 8 or 16; Q = NM / 4 threads a channel,
// 1024 / NM channels a block), so that a stage's 17 states of a thread
// (float4 each) fit shared memory: 68 KB a block. Stages are walked from
// the last to the first. For each, the block
//   1. stages u, dt and dy of its channels and B_t, C_t (read through their
//      batch and time strides: the model's column slices need no copy) in
//      shared memory, zeros past T, past d_in and past N; the loads go
//      through registers, four items a thread in flight together, and in
//      the 16-wide instances (four u / dt / dy items a thread) the next
//      stage's are issued before this stage's walk;
//   2. recomputes the stage's states from the saved one with the forward's
//      arithmetic (fmaf(ex2(dt * A log2 e), h, dt u * B)), so they equal the
//      forward's bit for bit;
//   3. walks the stage back: each thread updates g for its four states
//      (one ex2 each), sums g B and g A e h over the channel's Q threads
//      with shuffles, and the channel's first thread writes du and ddt;
//      dB_t and dC_t (sums over channels) are reduced within the warp by a
//      reduce-scatter (8 values over 32 lanes in 7 shuffles) into shared
//      memory, one row a warp and step;
//   4. sums its 8 warps' rows in order and writes one partial row of 2 N
//      floats per step: part_bc[block, b, t, :].
// dA and dD are kept per thread across the walk and written as one partial
// per batch row (part_a[b], part_d[b]); dh0 is the last carried g. The
// second launch, mamba_scan_bwd_sum_kernel, sums part_bc over the blocks of
// a row and part_a / part_d over the batch rows, each column by one thread
// in a fixed order. No float atomics: two calls give the same bits, which
// the train step's CUDA graph needs to equal the eager step.
#include "common.cuh"

namespace {

using repro::ex2;
using repro::from_float;
using repro::to_float;

constexpr int kThreads = 256;         // 8 warps, 1024 / NM channels
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;         // blocks per SM the plan is sized for
constexpr int kK = 16;                // steps a stage: the forward's state interval
constexpr int kSumThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;

// Byte layout of a block's shared memory: the stage's states (kK + 1 float4
// a thread: the saved one, then one a step), dt, u and dy rows of the
// block's channels, B_t and C_t rows (float32, NM each), and each warp's dB
// / dC sums (2 NM floats a step).
template <typename TU, int NM>
struct Layout {
  static constexpr int kQ = NM / 4;
  static constexpr int kCh = kThreads / kQ;
  static constexpr int kS = 0;
  static constexpr int kDt = kS + (kK + 1) * kThreads * 16;
  static constexpr int kU = kDt + kK * kCh * 4;
  static constexpr int kDy = kU + kK * kCh * (int)sizeof(TU);
  static constexpr int kBC = kDy + kK * kCh * (int)sizeof(TU);
  static constexpr int kRed = kBC + kK * 2 * NM * 4;
  static constexpr int kSmem = kRed + kWarps * kK * 2 * NM * 4;
};

// The warp's sums over its channels of eight values a lane (vb[0..3] of dB,
// vc[0..3] of dC for the lane's four states), lanes = channel * Q + q:
// three halving exchanges over lane bits 4, 3, 2 leave lane l with the sum
// of value (l >> 2) & 7 over the lanes that differ in those bits, and plain
// exchanges over the lower channel bits (Q < 4) complete it.
template <int Q>
__device__ __forceinline__ float warp_reduce_scatter8(const float (&vb)[4],
                                                      const float (&vc)[4], int lane) {
  float w[4], x[2];
  const bool u4 = lane & 16, u3 = lane & 8, u2 = lane & 4;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const float send = u4 ? vb[j] : vc[j];
    w[j] = (u4 ? vc[j] : vb[j]) + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const float send = u3 ? w[j] : w[j + 2];
    x[j] = (u3 ? w[j + 2] : w[j]) + __shfl_xor_sync(0xffffffffu, send, 8);
  }
  float v = (u2 ? x[1] : x[0]) + __shfl_xor_sync(0xffffffffu, u2 ? x[0] : x[1], 4);
  if constexpr (Q < 4) v += __shfl_xor_sync(0xffffffffu, v, 2);
  if constexpr (Q < 2) v += __shfl_xor_sync(0xffffffffu, v, 1);
  return v;
}

template <typename TU, int NM>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mamba_scan_bwd_kernel(const TU* __restrict__ u, const float* __restrict__ dt,
                      const float* __restrict__ A, const TU* __restrict__ Bm,
                      const TU* __restrict__ Cm, const float* __restrict__ Dv,
                      const float* __restrict__ hs, const TU* __restrict__ dy,
                      const float* __restrict__ dhT, TU* __restrict__ du,
                      float* __restrict__ ddt, float* __restrict__ dh0,
                      float* __restrict__ part_bc, float* __restrict__ part_a,
                      float* __restrict__ part_d, int T, int d_in, int n, long long b_sb,
                      long long b_st, long long c_sb, long long c_st) {
  using L = Layout<TU, NM>;
  constexpr int Q = L::kQ, CH = L::kCh;
  extern __shared__ __align__(16) unsigned char smem[];
  float4* S = reinterpret_cast<float4*>(smem + L::kS);
  float* sdt = reinterpret_cast<float*>(smem + L::kDt);
  TU* su = reinterpret_cast<TU*>(smem + L::kU);
  TU* sdy = reinterpret_cast<TU*>(smem + L::kDy);
  float* sbc = reinterpret_cast<float*>(smem + L::kBC);
  float* red = reinterpret_cast<float*>(smem + L::kRed);

  const int b = blockIdx.y, c0 = blockIdx.x * CH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch = tid / Q, q = tid % Q, c = c0 + ch;
  const bool active = c < d_in;
  const int ncols = min(CH, d_in - c0);
  const int n_chunks = (T + kK - 1) / kK;
  const int Bt = gridDim.y;

  float a[4], a2[4], g[4], dA[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * q + i;
    const bool on = active && s < n;
    a[i] = on ? A[(size_t)c * n + s] : 0.f;
    a2[i] = a[i] * kLog2e;
    g[i] = (on && dhT != nullptr) ? dhT[((size_t)b * d_in + c) * n + s] : 0.f;
    dA[i] = 0.f;
  }
  const float dd = active ? Dv[c] : 0.f;
  float dD = 0.f;

  // A stage's inputs pass through registers, GROUP u / dt / dy items of a
  // thread at a time, whose loads are in flight together. Where a thread
  // has at most GROUP items (kPrefetch: the 16-wide instances), the next
  // stage's loads are issued before this stage's walk and stored after it.
  constexpr int GROUP = 4;
  constexpr int ITEMS = kK * CH / kThreads;
  constexpr int BC_ITEMS = (kK * 2 * NM + kThreads - 1) / kThreads;
  constexpr bool kPrefetch = ITEMS <= GROUP;
  float pdt[GROUP], pbc[BC_ITEMS], ph[4];
  TU pu[GROUP], pdy[GROUP];
  // items g0 .. g0 + GROUP - 1 of stage k
  auto load_items = [&](int k, int g0) {
    const int t0 = k * kK, tn = min(kK, T - t0);
#pragma unroll
    for (int it = 0; it < GROUP; ++it) {
      const int i = tid + (g0 + it) * kThreads, r = i / CH, col = i % CH;
      const bool on = g0 + it < ITEMS && r < tn && col < ncols;
      const size_t off = ((size_t)b * T + t0 + r) * d_in + c0 + col;
      pdt[it] = on ? dt[off] : 0.f;
      pu[it] = on ? u[off] : from_float<TU>(0.f);
      pdy[it] = on ? dy[off] : from_float<TU>(0.f);
    }
  };
  auto store_items = [&](int g0) {
#pragma unroll
    for (int it = 0; it < GROUP; ++it) {
      const int i = tid + (g0 + it) * kThreads;
      if (g0 + it < ITEMS) {
        sdt[i] = pdt[it];
        su[i] = pu[it];
        sdy[i] = pdy[it];
      }
    }
  };
  // B_t and C_t of stage k, and its saved state
  auto load_bc_h = [&](int k) {
    const int t0 = k * kK, tn = min(kK, T - t0);
#pragma unroll
    for (int it = 0; it < BC_ITEMS; ++it) {
      const int i = tid + it * kThreads, r = i / (2 * NM), j = i % (2 * NM);
      const int s = j < NM ? j : j - NM;
      float v = 0.f;
      if (i < kK * 2 * NM && r < tn && s < n)
        v = to_float<TU>(j < NM ? Bm[b * b_sb + (t0 + r) * b_st + s]
                                : Cm[b * c_sb + (t0 + r) * c_st + s]);
      pbc[it] = v;
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * q + i;
      ph[i] = (active && s < n) ? hs[(((size_t)b * n_chunks + k) * d_in + c) * n + s] : 0.f;
    }
  };
  if (kPrefetch) {
    load_items(n_chunks - 1, 0);
    load_bc_h(n_chunks - 1);
  }

  for (int k = n_chunks - 1; k >= 0; --k) {
    const int t0 = k * kK, tn = min(kK, T - t0);
    // 1. the stage's inputs, loaded before (kPrefetch) or now
    if (kPrefetch) {
      store_items(0);
    } else {
#pragma unroll 1
      for (int g0 = 0; g0 < ITEMS; g0 += GROUP) {
        load_items(k, g0);
        store_items(g0);
      }
      load_bc_h(k);
    }
#pragma unroll
    for (int it = 0; it < BC_ITEMS; ++it) {
      const int i = tid + it * kThreads;
      if (i < kK * 2 * NM) sbc[i] = pbc[it];
    }
    float h[4] = {ph[0], ph[1], ph[2], ph[3]};
    S[tid] = make_float4(h[0], h[1], h[2], h[3]);
    __syncthreads();
    if (kPrefetch && k > 0) {
      load_items(k - 1, 0);
      load_bc_h(k - 1);
    }

    // 2. the stage's states, as the forward computed them
    for (int tt = 0; tt < tn; ++tt) {
      const float ut = to_float<TU>(su[tt * CH + ch]);
      const float dtt = sdt[tt * CH + ch];
      const float dtu = dtt * ut;
      const float4 bq = reinterpret_cast<const float4*>(sbc + tt * 2 * NM)[q];
      h[0] = fmaf(ex2(dtt * a2[0]), h[0], dtu * bq.x);
      h[1] = fmaf(ex2(dtt * a2[1]), h[1], dtu * bq.y);
      h[2] = fmaf(ex2(dtt * a2[2]), h[2], dtu * bq.z);
      h[3] = fmaf(ex2(dtt * a2[3]), h[3], dtu * bq.w);
      S[(tt + 1) * kThreads + tid] = make_float4(h[0], h[1], h[2], h[3]);
    }

    // 3. back over the stage
    for (int tt = tn - 1; tt >= 0; --tt) {
      const float ut = to_float<TU>(su[tt * CH + ch]);
      const float dtt = sdt[tt * CH + ch];
      const float dyt = to_float<TU>(sdy[tt * CH + ch]);
      const float dtu = dtt * ut;
      const float4 bq4 = reinterpret_cast<const float4*>(sbc + tt * 2 * NM)[q];
      const float4 cq4 = reinterpret_cast<const float4*>(sbc + tt * 2 * NM + NM)[q];
      const float4 hp4 = S[tt * kThreads + tid], hc4 = S[(tt + 1) * kThreads + tid];
      const float bq[4] = {bq4.x, bq4.y, bq4.z, bq4.w};
      const float cq[4] = {cq4.x, cq4.y, cq4.z, cq4.w};
      const float hp[4] = {hp4.x, hp4.y, hp4.z, hp4.w};
      const float hc[4] = {hc4.x, hc4.y, hc4.z, hc4.w};
      float gB = 0.f, gAe = 0.f, vb[4], vc[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        g[i] = fmaf(cq[i], dyt, g[i]);
        const float e = ex2(dtt * a2[i]);
        const float ge = g[i] * (e * hp[i]);
        gAe = fmaf(a[i], ge, gAe);
        gB = fmaf(g[i], bq[i], gB);
        dA[i] = fmaf(dtt, ge, dA[i]);
        vb[i] = g[i] * dtu;
        vc[i] = dyt * hc[i];
        g[i] = e * g[i];
      }
#pragma unroll
      for (int o = 1; o < Q; o <<= 1) {
        gB += __shfl_xor_sync(0xffffffffu, gB, o);
        gAe += __shfl_xor_sync(0xffffffffu, gAe, o);
      }
      if (q == 0 && active) {
        const size_t off = ((size_t)b * T + t0 + tt) * d_in + c;
        du[off] = from_float<TU>(fmaf(dtt, gB, dd * dyt));
        ddt[off] = fmaf(ut, gB, gAe);
        dD = fmaf(dyt, ut, dD);
      }
      const float v = warp_reduce_scatter8<Q>(vb, vc, lane);
      if ((lane & 3) < Q) {
        const int idx = (lane >> 2) & 7;
        const int slot = idx < 4 ? 4 * q + idx : NM + 4 * q + idx - 4;
        red[(warp * kK + tt) * 2 * NM + slot] = v;
      }
    }
    __syncthreads();

    // 4. the block's dB / dC partial rows of this stage, warps in order
    for (int i = tid; i < tn * 2 * n; i += kThreads) {
      const int r = i / (2 * n), j = i % (2 * n);
      const int slot = j < n ? j : NM + j - n;
      float sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) sum += red[(w * kK + r) * 2 * NM + slot];
      part_bc[(((size_t)blockIdx.x * Bt + b) * T + t0 + r) * 2 * n + j] = sum;
    }
  }

  if (active) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int s = 4 * q + i;
      if (s < n) {
        const size_t off = ((size_t)b * d_in + c) * n + s;
        dh0[off] = g[i];
        part_a[off] = dA[i];
      }
    }
    if (q == 0) part_d[(size_t)b * d_in + c] = dD;
  }
}

// The second launch: dB / dC as the sums of the n_blk blocks' partial rows,
// dA and dD as the sums of the batch rows' partials; one column a thread,
// the rows in order.
template <typename TU>
__global__ void __launch_bounds__(kSumThreads)
mamba_scan_bwd_sum_kernel(const float* __restrict__ part_bc, const float* __restrict__ part_a,
                          const float* __restrict__ part_d, TU* __restrict__ dB,
                          TU* __restrict__ dC, float* __restrict__ dA, float* __restrict__ dD,
                          int n_blk, int Bt, int T, int d_in, int n) {
  const long long n_bc = (long long)Bt * T * 2 * n, n_a = (long long)d_in * n;
  long long j = (long long)blockIdx.x * kSumThreads + threadIdx.x;
  if (j < n_bc) {
    float sum = 0.f;
#pragma unroll 8
    for (int i = 0; i < n_blk; ++i) sum += part_bc[i * n_bc + j];
    const long long row = j / (2 * n);
    const int s = (int)(j % (2 * n));
    if (s < n)
      dB[row * n + s] = from_float<TU>(sum);
    else
      dC[row * n + s - n] = from_float<TU>(sum);
    return;
  }
  j -= n_bc;
  if (j < n_a) {
    float sum = 0.f;
    for (int i = 0; i < Bt; ++i) sum += part_a[i * n_a + j];
    dA[j] = sum;
    return;
  }
  j -= n_a;
  if (j < d_in) {
    float sum = 0.f;
    for (int i = 0; i < Bt; ++i) sum += part_d[(long long)i * d_in + j];
    dD[j] = sum;
  }
}

template <typename TU, int NM>
cudaError_t configure() {
  auto kernel = mamba_scan_bwd_kernel<TU, NM>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<TU, NM>::kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

struct Args {
  const void *u, *dt, *A, *Bm, *Cm, *D, *hs, *dy, *dhT;
  void *du, *ddt, *dB, *dC, *dA, *dD, *dh0, *part_bc, *part_a, *part_d;
  int Bt, T, d_in, n;
  long long b_sb, b_st, c_sb, c_st;
};

template <typename TU, int NM>
cudaError_t launch(const Args& a, int n_blk, cudaStream_t stream) {
  using L = Layout<TU, NM>;
  if (n_blk != (a.d_in + L::kCh - 1) / L::kCh) return cudaErrorInvalidValue;
  cudaError_t err = configure<TU, NM>();
  if (err != cudaSuccess) return err;
  const dim3 grid(n_blk, a.Bt);
  mamba_scan_bwd_kernel<TU, NM><<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const TU*>(a.u), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const TU*>(a.Bm),
      static_cast<const TU*>(a.Cm), static_cast<const float*>(a.D),
      static_cast<const float*>(a.hs), static_cast<const TU*>(a.dy),
      static_cast<const float*>(a.dhT), static_cast<TU*>(a.du), static_cast<float*>(a.ddt),
      static_cast<float*>(a.dh0), static_cast<float*>(a.part_bc),
      static_cast<float*>(a.part_a), static_cast<float*>(a.part_d), a.T, a.d_in, a.n,
      a.b_sb, a.b_st, a.c_sb, a.c_st);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long cols = (long long)a.Bt * a.T * 2 * a.n + (long long)a.d_in * a.n + a.d_in;
  mamba_scan_bwd_sum_kernel<TU><<<(unsigned)((cols + kSumThreads - 1) / kSumThreads),
                                  kSumThreads, 0, stream>>>(
      static_cast<const float*>(a.part_bc), static_cast<const float*>(a.part_a),
      static_cast<const float*>(a.part_d), static_cast<TU*>(a.dB), static_cast<TU*>(a.dC),
      static_cast<float*>(a.dA), static_cast<float*>(a.dD), n_blk, a.Bt, a.T, a.d_in, a.n);
  return cudaGetLastError();
}

template <typename TU>
cudaError_t dispatch_n(const Args& a, int n_blk, cudaStream_t stream) {
  if (a.n <= 4) return launch<TU, 4>(a, n_blk, stream);
  if (a.n <= 8) return launch<TU, 8>(a, n_blk, stream);
  return launch<TU, 16>(a, n_blk, stream);
}

}  // namespace

// u, dy, du: (Bt, T, d_in) contiguous in u's type; dt, ddt: the same shape,
// float32; A: (d_in, n) float32; B, C: (Bt, T, n) in u's type, unit stride
// over n, the given batch and time strides (elements); D: (d_in,) float32;
// hs: (Bt, ceil(T / 16), d_in, n) float32, the forward's saved states; dhT:
// (Bt, d_in, n) float32 or NULL for zeros; dB, dC: (Bt, T, n) contiguous in
// u's type; dA: (d_in, n), dD: (d_in,), dh0: (Bt, d_in, n) float32;
// part_bc: (n_blk, Bt, T, 2 n), part_a: (Bt, d_in, n), part_d: (Bt, d_in)
// float32 workspaces, n_blk = ceil(d_in / (1024 / NM)) with NM = n rounded
// up to 4, 8 or 16 (refused otherwise). 1 <= n <= 16. Two launches. Returns
// a cudaError_t code.
extern "C" int mamba_scan_bwd(const void* u, const void* dt, const void* A, const void* Bm,
                              const void* Cm, const void* D, const void* hs,
                              const void* dy, const void* dhT, void* du, void* ddt,
                              void* dB, void* dC, void* dA, void* dD, void* dh0,
                              void* part_bc, void* part_a, void* part_d, int n_blk, int Bt,
                              int T, int d_in, int n, long long b_sb, long long b_st,
                              long long c_sb, long long c_st, int u_dtype, void* stream) {
  if (Bt <= 0 || T <= 0 || d_in <= 0 || n <= 0 || n > 16 || Bt > 65535)
    return cudaErrorInvalidValue;
  const Args a{u,  dt, A,  Bm, Cm,  D,   hs,      dy,     dhT,    du,   ddt, dB,   dC,   dA,
               dD, dh0, part_bc, part_a, part_d, Bt, T, d_in, n, b_sb, b_st, c_sb, c_st};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u_dtype == repro::kFloat32) return dispatch_n<float>(a, n_blk, st);
  if (u_dtype == repro::kBFloat16) return dispatch_n<__nv_bfloat16>(a, n_blk, st);
  return cudaErrorInvalidValue;
}
