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
// 1.07e9 or 0.26 ms at 4.18e12 per second. On top, the kernel reads the
// forward's saved states (268 MB at a 16-step stride) and writes and reads
// the dB / dC partial sums (134 MB).
//
// What bounds it is the instruction issue rate and the latency that 16
// warps an SM leave exposed, not the exponentials or the bytes: a walk step
// is ~92 instructions a warp for four (t, d, n) elements a thread (the
// update of g and its products, 9 a state; the channel's sums; the warp's
// dB / dC reduce-scatter, 7 shuffles and 14 selects), the recompute ~22 and
// the stage's loads and stores the rest, ~142 a warp and step in all. At
// 126 registers a thread (two blocks of 256 an SM) ptxas keeps one step in
// flight per warp. Measured at Jamba's training shape (NVIDIA H100 80GB
// HBM3, 700 W, SM clock 1,980 MHz): 1.69-1.70 ms for both launches
// (chip_smoke.py phase 2), 6.0x the bound, against 2.28-2.46 ms for the
// design before it, which staged the states in shared memory and took each
// exponential twice (scan_bwd_compare.py times the two side by side).
//
// Design. The forward's training instance saved the float32 state at the
// start of every stage of kS = 16 steps. A block takes 256 threads over
// the channels of one batch row; thread (channel, q) owns
// four of the channel's NM states (NM = N rounded up to 4, 8 or 16; Q = NM /
// 4 threads a channel, 1024 / NM channels a block). Stages are walked from
// the last to the first. For each, the block
//   1. has the stage's u, dt and dy rows of its channels, B_t and C_t
//      (float32, read through their batch and time strides: the model's
//      column slices need no copy) and the saved state in shared memory,
//      zeros past T, d_in and N: the rows and the state arrive by cp.async
//      into the other of two buffers while the previous stage is walked
//      (16-byte copies where the rows are 16-byte aligned, else plain
//      loads), B and C through registers in u's type;
//   2. in sub-stages of kK = 8 steps, the last first: recomputes the
//      sub-stage's states from the saved one with the
//      forward's arithmetic (fmaf(ex2(dt * A log2 e), h, dt u * B)), so they
//      equal the forward's bit for bit, into registers (4 (kK + 1) floats),
//      keeping each step's exponential (4 kK floats) for the walk; the
//      second sub-stage's start is advanced to from the saved state first,
//      so a stage takes 1.5 exponentials a (t, d, n) element (the 4- and
//      8-wide instances, which only SMOKE shapes run, walk sub-stages of 4
//      steps and take the walk's exponentials again: their wider blocks'
//      loads and stores leave no registers to keep them);
//   3. walks the sub-stage back, fully unrolled: each thread updates g for
//      its four states; the channel's two sums, sum_n g B and sum_n g A e h
//      + u g B, by a reduce-scatter over its Q lanes (log2 Q shuffles: lanes
//      with q even end with the first and write du_t over u_t, q odd with
//      the second and write ddt_t over dt_t in shared memory); dB_t and
//      dC_t (sums over channels) by a warp reduce-scatter (8 values over 32
//      lanes in 7 shuffles) into shared memory, one row a warp and step;
//   4. writes the stage's du and ddt rows, coalesced, and sums its 8 warps'
//      dB / dC rows in order into one partial row of 2 N floats per step:
//      part_bc[block, b, t, :].
// Steps past T carry dt = u = dy = B = C = 0: e = 1, no input, no
// contribution, g passes through unchanged, so a ragged last stage needs no
// runtime bound. dA and dD are kept per thread across the walk and written
// as one partial per batch row (part_a[b], part_d[b]); dh0 is the last
// carried g. The second launch, mamba_scan_bwd_sum_kernel, sums part_bc over
// the blocks of a row and part_a / part_d over the batch rows, each column
// by one thread in a fixed order. No float atomics: two calls give the same
// bits, which the train step's CUDA graph needs to equal the eager step.
#include "common.cuh"

namespace {

using repro::ex2;
using repro::from_float;
using repro::to_float;

constexpr int kThreads = 256;         // 8 warps, 1024 / NM channels
constexpr int kWarps = kThreads / 32;
constexpr int kMinBlocks = 2;         // blocks per SM the plan is sized for
constexpr int kS = 16;                // steps a stage: the forward's state interval
constexpr int kSumThreads = 256;
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kLn2 = 0.6931471805599453f;

// Byte layout of a block's shared memory: two buffers, each with a stage's
// dt, u and dy rows of the block's channels, its B_t and C_t rows (float32,
// NM each) and the saved state (a float4 a thread); then each warp's dB /
// dC sums (2 NM floats a step).
template <typename TU, int NM>
struct Layout {
  static constexpr int kQ = NM / 4;
  static constexpr int kCh = kThreads / kQ;
  static constexpr int kDt = 0;
  static constexpr int kU = kDt + kS * kCh * 4;
  static constexpr int kDy = kU + kS * kCh * (int)sizeof(TU);
  static constexpr int kBC = kDy + kS * kCh * (int)sizeof(TU);
  static constexpr int kH0 = kBC + kS * 2 * NM * 4;
  static constexpr int kBuf = kH0 + kThreads * 16;
  static constexpr int kRed = 2 * kBuf;
  static constexpr int kSmem = kRed + kWarps * kS * 2 * NM * 4;
  static_assert(kU % 16 == 0 && kDy % 16 == 0 && kBC % 16 == 0 && kBuf % 16 == 0,
                "16-byte copies need 16-byte aligned rows");
};

// `bytes` (4 or 16) from global to shared memory, asynchronously; with
// `on` false the destination is filled with zeros and nothing is read.
template <int kBytes>
__device__ __forceinline__ void cp_async(void* dst, const void* src, bool on) {
  const uint32_t d = static_cast<uint32_t>(__cvta_generic_to_shared(dst));
  const int n = on ? kBytes : 0;
  if constexpr (kBytes == 16)
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
  else
    asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d), "l"(src), "r"(n)
                 : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// A store to shared memory that the compiler may move past loads: the walk
// writes du_t and ddt_t over u_t and dt_t of the same step, after every
// lane of the channel has read them (the stored sums depend on those
// reads), and no later step reads them; __syncthreads orders the stage's
// read-back.
__device__ __forceinline__ void st_shared(const void* p, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"((uint32_t)__cvta_generic_to_shared(p)), "f"(v));
}
__device__ __forceinline__ void st_shared(const void* p, __nv_bfloat16 v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"((uint32_t)__cvta_generic_to_shared(p)),
               "h"(__bfloat16_as_ushort(v)));
}

// The channel's sums of two values over its Q lanes (lane bits below
// log2 Q): a reduce-scatter, lanes with q even end with the sum of a and
// lanes with q odd with that of b (log2 Q shuffles); Q >= 2.
template <int Q>
__device__ __forceinline__ float channel_scatter2(float a, float b, int q) {
  const bool odd = q & 1;
  float v = (odd ? b : a) + __shfl_xor_sync(0xffffffffu, odd ? a : b, 1);
#pragma unroll
  for (int o = 2; o < Q; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

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

// flags: kRowsVec, the u / dt / dy rows go by 16-byte copies (every row of
// the block's channels starts and ends on 16 bytes); kStateVec, the saved
// states by 16-byte copies (n == NM, hs 16-byte aligned)
constexpr int kRowsVec = 1, kStateVec = 2;

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
                      long long b_st, long long c_sb, long long c_st, int flags) {
  using L = Layout<TU, NM>;
  constexpr int Q = L::kQ, CH = L::kCh;
  // the 4- and 8-wide instances (SMOKE shapes) take the walk's exponentials
  // again, in sub-stages of 4 steps: their wider blocks' loads and stores
  // leave no registers for more
  constexpr bool kKeepE = NM == 16;
  constexpr int kK = NM == 16 ? 8 : 4, kH = kS / kK;
  static_assert(kS % kK == 0, "a stage is a whole number of sub-stages");
  extern __shared__ __align__(16) unsigned char smem[];
  float* red = reinterpret_cast<float*>(smem + L::kRed);

  const int b = blockIdx.y, c0 = blockIdx.x * CH;
  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int ch = tid / Q, q = tid % Q, c = c0 + ch;
  const bool odd = q & 1;
  const bool active = c < d_in;
  const int ncols = min(CH, d_in - c0);
  const int n_chunks = (T + kS - 1) / kS;
  const int Bt = gridDim.y;

  float a2[4], g[4], dA[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int s = 4 * q + i;
    const bool on = active && s < n;
    a2[i] = on ? A[(size_t)c * n + s] * kLog2e : 0.f;
    g[i] = (on && dhT != nullptr) ? dhT[((size_t)b * d_in + c) * n + s] : 0.f;
    dA[i] = 0.f;
  }
  const float dd = active ? Dv[c] : 0.f;
  float dD = 0.f;

  // Stage k's inputs into buffer `buf`: the rows and the saved state by
  // cp.async (or plain loads), B_t and C_t into pbc, stored by store_bc.
  // B and C stay in u's type until store_bc: the loads are consumed a
  // stage later, so no warp waits on them before its walk
  constexpr int BC_ITEMS = (kS * 2 * NM + kThreads - 1) / kThreads;
  TU pbc[BC_ITEMS];
  auto load_stage = [&](int k, int buf) {
    unsigned char* base = smem + buf * L::kBuf;
    float* sdt = reinterpret_cast<float*>(base + L::kDt);
    TU* su = reinterpret_cast<TU*>(base + L::kU);
    TU* sdy = reinterpret_cast<TU*>(base + L::kDy);
    const int t0 = k * kS, tn = min(kS, T - t0);
    const size_t row0 = ((size_t)b * T + t0) * d_in + c0;
    if (flags & kRowsVec) {
      // 16-byte chunks of a row: CH / 4 of dt, CH / (16 / sizeof(TU)) of u,
      // dy; offsets within the stage in 32 bits (kS rows of d_in)
      constexpr int DT_CH = CH / 4, U_CH = CH * (int)sizeof(TU) / 16;
#pragma unroll
      for (int it = 0; it < (kS * DT_CH + kThreads - 1) / kThreads; ++it) {
        const int i = tid + it * kThreads, r = i / DT_CH, col = (i % DT_CH) * 4;
        const bool on = r < tn && col < ncols;
        if (kS * DT_CH % kThreads == 0 || i < kS * DT_CH)
          cp_async<16>(sdt + r * CH + col, dt + row0 + (on ? r * d_in + col : 0), on);
      }
#pragma unroll
      for (int it = 0; it < (kS * U_CH + kThreads - 1) / kThreads; ++it) {
        const int i = tid + it * kThreads, r = i / U_CH;
        const int col = (i % U_CH) * (16 / (int)sizeof(TU));
        const bool on = r < tn && col < ncols;
        const size_t off = row0 + (on ? r * d_in + col : 0);
        if (kS * U_CH % kThreads == 0 || i < kS * U_CH) {
          cp_async<16>(su + r * CH + col, u + off, on);
          cp_async<16>(sdy + r * CH + col, dy + off, on);
        }
      }
    } else {
      for (int i = tid; i < kS * CH; i += kThreads) {
        const int r = i / CH, col = i % CH;
        const bool on = r < tn && col < ncols;
        const size_t off = row0 + (size_t)r * d_in + col;
        sdt[i] = on ? dt[off] : 0.f;
        su[i] = on ? u[off] : from_float<TU>(0.f);
        sdy[i] = on ? dy[off] : from_float<TU>(0.f);
      }
    }
    float* sh = reinterpret_cast<float*>(base + L::kH0) + 4 * tid;
    const float* hp = hs + (((size_t)b * n_chunks + k) * d_in + c) * n + 4 * q;
    if (flags & kStateVec) {
      cp_async<16>(sh, active ? hp : hs, active);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const bool on = active && 4 * q + i < n;
        cp_async<4>(sh + i, on ? hp + i : hs, on);
      }
    }
#pragma unroll
    for (int it = 0; it < BC_ITEMS; ++it) {
      const int i = tid + it * kThreads, r = i / (2 * NM), j = i % (2 * NM);
      const int s = j < NM ? j : j - NM;
      TU v = from_float<TU>(0.f);
      if (i < kS * 2 * NM && r < tn && s < n)
        v = j < NM ? Bm[b * b_sb + (t0 + r) * b_st + s] : Cm[b * c_sb + (t0 + r) * c_st + s];
      pbc[it] = v;
    }
  };
  auto store_bc = [&](int buf) {
    float* sbc = reinterpret_cast<float*>(smem + buf * L::kBuf + L::kBC);
#pragma unroll
    for (int it = 0; it < BC_ITEMS; ++it) {
      const int i = tid + it * kThreads;
      if (i < kS * 2 * NM) sbc[i] = to_float<TU>(pbc[it]);
    }
  };

  load_stage(n_chunks - 1, (n_chunks - 1) & 1);
  for (int k = n_chunks - 1; k >= 0; --k) {
    const int buf = k & 1, t0 = k * kS;
    store_bc(buf);
    cp_async_wait_all();
    __syncthreads();
    if (k > 0) load_stage(k - 1, buf ^ 1);
    unsigned char* base = smem + buf * L::kBuf;
    float* sdt = reinterpret_cast<float*>(base + L::kDt) + ch;
    TU* su = reinterpret_cast<TU*>(base + L::kU) + ch;
    const TU* sdy = reinterpret_cast<const TU*>(base + L::kDy) + ch;
    const float4* sb = reinterpret_cast<const float4*>(base + L::kBC) + q;
    const float4 h4 = reinterpret_cast<const float4*>(base + L::kH0)[tid];

#pragma unroll 1
    for (int j = kH - 1; j >= 0; --j) {
      float h[4] = {h4.x, h4.y, h4.z, h4.w};
      // the states at the start of sub-stage j, as the forward computed them
#pragma unroll 1
      for (int jj = 0; jj < j; ++jj) {
#pragma unroll
        for (int tt = 0; tt < kK; ++tt) {
          const int r = jj * kK + tt;
          const float dtt = sdt[r * CH];
          const float dtu = dtt * to_float<TU>(su[r * CH]);
          const float4 bq = sb[r * (NM / 2)];
          h[0] = fmaf(ex2(dtt * a2[0]), h[0], dtu * bq.x);
          h[1] = fmaf(ex2(dtt * a2[1]), h[1], dtu * bq.y);
          h[2] = fmaf(ex2(dtt * a2[2]), h[2], dtu * bq.z);
          h[3] = fmaf(ex2(dtt * a2[3]), h[3], dtu * bq.w);
        }
      }
      // 2. the sub-stage's states and exponentials, in registers
      float hr[kK + 1][4], er[kKeepE ? kK : 1][4];
#pragma unroll
      for (int i = 0; i < 4; ++i) hr[0][i] = h[i];
#pragma unroll
      for (int tt = 0; tt < kK; ++tt) {
        const int r = j * kK + tt;
        const float dtt = sdt[r * CH];
        const float dtu = dtt * to_float<TU>(su[r * CH]);
        const float4 b4 = sb[r * (NM / 2)];
        const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float e = ex2(dtt * a2[i]);
          hr[tt + 1][i] = fmaf(e, hr[tt][i], dtu * bq[i]);
          if constexpr (kKeepE) er[tt][i] = e;
        }
      }

      // 3. back over the sub-stage
#pragma unroll
      for (int tt = kK - 1; tt >= 0; --tt) {
        const int r = j * kK + tt;
        const float ut = to_float<TU>(su[r * CH]);
        const float dtt = sdt[r * CH];
        const float dyt = to_float<TU>(sdy[r * CH]);
        const float dtu = dtt * ut;
        const float4 b4 = sb[r * (NM / 2)], c4 = sb[r * (NM / 2) + NM / 4];
        const float bq[4] = {b4.x, b4.y, b4.z, b4.w};
        const float cq[4] = {c4.x, c4.y, c4.z, c4.w};
        float pB = 0.f, pA = 0.f, vb[4], vc[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          g[i] = fmaf(cq[i], dyt, g[i]);
          float e;
          if constexpr (kKeepE)
            e = er[tt][i];
          else
            e = ex2(dtt * a2[i]);
          const float ge = g[i] * (e * hr[tt][i]);
          pA = fmaf(a2[i], ge, pA);
          pB = fmaf(g[i], bq[i], pB);
          dA[i] = fmaf(dtt, ge, dA[i]);
          vb[i] = g[i] * dtu;
          vc[i] = dyt * hr[tt + 1][i];
          g[i] = e * g[i];
        }
        // this thread's share of ddt: sum_n g A e h + u g B (A = a2 ln 2)
        const float pD = fmaf(kLn2, pA, ut * pB);
        dD = fmaf(dyt, ut, dD);
        if constexpr (Q == 1) {
          st_shared(su + r * CH, from_float<TU>(fmaf(dtt, pB, dd * dyt)));
          st_shared(sdt + r * CH, pD);
        } else {
          const float v = channel_scatter2<Q>(pB, pD, q);
          if (odd)
            st_shared(sdt + r * CH, v);
          else
            st_shared(su + r * CH, from_float<TU>(fmaf(dtt, v, dd * dyt)));
        }
        const float v = warp_reduce_scatter8<Q>(vb, vc, lane);
        if ((lane & 3) < Q) {
          const int idx = (lane >> 2) & 7;
          const int slot = idx < 4 ? 4 * q + idx : NM + 4 * q + idx - 4;
          red[(warp * kS + r) * 2 * NM + slot] = v;
        }
      }
    }
    __syncthreads();

    // 4. the stage's du and ddt rows (over its u and dt rows), and the
    // block's dB / dC partial rows, warps in order
    const int tn = min(kS, T - t0);
    const size_t row0 = ((size_t)b * T + t0) * d_in + c0;
    const TU* ou = reinterpret_cast<const TU*>(base + L::kU);
    const float* odt = reinterpret_cast<const float*>(base + L::kDt);
    if (flags & kRowsVec) {
      // four channels a thread: 16 bytes of ddt, 4 sizeof(TU) of du
      constexpr int QUADS = kS * CH / 4;
#pragma unroll
      for (int it = 0; it < (QUADS + kThreads - 1) / kThreads; ++it) {
        const int i = 4 * (tid + it * kThreads), r = i / CH, col = i % CH;
        if ((QUADS % kThreads == 0 || i < 4 * QUADS) && r < tn && col < ncols) {
          const size_t off = row0 + (r * d_in + col);
          *reinterpret_cast<float4*>(ddt + off) = *reinterpret_cast<const float4*>(odt + i);
          if constexpr (sizeof(TU) == 2)
            *reinterpret_cast<uint2*>(du + off) = *reinterpret_cast<const uint2*>(ou + i);
          else
            *reinterpret_cast<float4*>(du + off) = *reinterpret_cast<const float4*>(ou + i);
        }
      }
    } else {
      for (int i = tid; i < tn * CH; i += kThreads) {
        const int r = i / CH, col = i % CH;
        if (col < ncols) {
          const size_t off = row0 + (size_t)r * d_in + col;
          ddt[off] = odt[i];
          du[off] = ou[i];
        }
      }
    }
    float* prow = part_bc + (((size_t)blockIdx.x * Bt + b) * T + t0) * 2 * n;
#pragma unroll
    for (int it = 0; it < (kS * 2 * NM + kThreads - 1) / kThreads; ++it) {
      const int i = tid + it * kThreads, r = i / (2 * NM), slot = i % (2 * NM);
      const int s = slot < NM ? slot : slot - NM;   // the state; C's after B's
      if (i < kS * 2 * NM && r < tn && s < n) {
        float sum = 0.f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) sum += red[(w * kS + r) * 2 * NM + slot];
        prow[r * 2 * n + (slot < NM ? s : n + s)] = sum;
      }
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

bool aligned16(const void* p) { return (reinterpret_cast<uintptr_t>(p) & 15) == 0; }

template <typename TU, int NM>
cudaError_t launch(const Args& a, int n_blk, cudaStream_t stream) {
  using L = Layout<TU, NM>;
  if (n_blk != (a.d_in + L::kCh - 1) / L::kCh) return cudaErrorInvalidValue;
  cudaError_t err = configure<TU, NM>();
  if (err != cudaSuccess) return err;
  const int flags =
      (aligned16(a.u) && aligned16(a.dt) && aligned16(a.dy) && a.d_in % 4 == 0 &&
               a.d_in % (16 / (int)sizeof(TU)) == 0
           ? kRowsVec
           : 0) |
      (a.n == NM && aligned16(a.hs) ? kStateVec : 0);
  const dim3 grid(n_blk, a.Bt);
  mamba_scan_bwd_kernel<TU, NM><<<grid, kThreads, L::kSmem, stream>>>(
      static_cast<const TU*>(a.u), static_cast<const float*>(a.dt),
      static_cast<const float*>(a.A), static_cast<const TU*>(a.Bm),
      static_cast<const TU*>(a.Cm), static_cast<const float*>(a.D),
      static_cast<const float*>(a.hs), static_cast<const TU*>(a.dy),
      static_cast<const float*>(a.dhT), static_cast<TU*>(a.du), static_cast<float*>(a.ddt),
      static_cast<float*>(a.dh0), static_cast<float*>(a.part_bc),
      static_cast<float*>(a.part_a), static_cast<float*>(a.part_d), a.T, a.d_in, a.n,
      a.b_sb, a.b_st, a.c_sb, a.c_st, flags);
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

template <typename TU, int NM>
int occupancy() {
  int blocks = 0;
  if (configure<TU, NM>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mamba_scan_bwd_kernel<TU, NM>,
                                                    kThreads, Layout<TU, NM>::kSmem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// u, dy, du: (Bt, T, d_in) contiguous in u's type; dt, ddt: the same shape,
// float32; A: (d_in, n) float32; B, C: (Bt, T, n) in u's type, unit stride
// over n, the given batch and time strides (elements); D: (d_in,) float32;
// hs: (Bt, ceil(T / 16), d_in, n) float32, the forward's
// saved states; dhT: (Bt, d_in, n) float32 or NULL for zeros; dB, dC: (Bt,
// T, n) contiguous in u's type; dA: (d_in, n), dD: (d_in,), dh0: (Bt, d_in,
// n) float32; part_bc: (n_blk, Bt, T, 2 n), part_a: (Bt, d_in, n), part_d:
// (Bt, d_in) float32 workspaces, n_blk = ceil(d_in / (1024 / NM)) with NM =
// n rounded up to 4, 8 or 16 (refused otherwise). 1 <= n <= 16. Two
// launches. Returns a cudaError_t code.
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

// Blocks of the backward instance for state width n and u_dtype that one SM
// holds at once (the CUDA occupancy calculator, with the kernel's shared
// memory and carveout set); -1 on error. The plan is sized for kMinBlocks.
extern "C" int mamba_scan_bwd_blocks_per_sm(int n, int u_dtype) {
  const int nm = n <= 4 ? 4 : n <= 8 ? 8 : 16;
  if (u_dtype == repro::kFloat32)
    return nm == 4 ? occupancy<float, 4>() : nm == 8 ? occupancy<float, 8>()
                                                     : occupancy<float, 16>();
  if (u_dtype == repro::kBFloat16)
    return nm == 4 ? occupancy<__nv_bfloat16, 4>()
           : nm == 8 ? occupancy<__nv_bfloat16, 8>()
                     : occupancy<__nv_bfloat16, 16>();
  return -1;
}
