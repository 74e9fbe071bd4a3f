// Selective state-space scan (Mamba) for Hopper (sm_90a):
//   h_t = exp(dt_t * A) * h_{t-1} + dt_t * B_t * u_t,   y_t = C_t . h_t + D * u_t
// per batch row and channel, from an initial state h0 (zeros when absent).
//
// Replaces: src/repro/kernels/mamba_scan.py, mamba_scan_pallas (_kernel).
//
// Bound on an H100 SXM: the larger of two terms. Bytes: u and dt are read
// once and y written once (2 + 4 + 2 bytes per element when u is bf16 and dt
// float32), plus h_T (Bt * d_in * N floats) and the small A, B, C, D; at
// Jamba's prefill shape (Bt 8, T 512, d_in 16384, N 16) that is ~0.55 GB, or
// ~0.16 ms at 3.35 TB/s. Exponentials: one per (b, t, d, n), 1.07e9 at that
// shape; the special-function units (MUFU) give 16 results per SM per clock,
// 132 x 16 x 1.98 GHz = 4.18e12 per second, so ~0.26 ms. The exponentials
// bind: a warp's MUFU.EX2 holds its SM sub-partition's unit for 8 clocks,
// while the other work of one (t, d, n) element (FMUL dt*a, FMUL dtu*B and
// two FFMAs) takes the FMA pipe 4 clocks and the issue slot ~6.
//
// Design. One consumer thread owns one (batch row, channel) pair: its N
// float32 states and its row of A, pre-scaled by log2 e, stay in registers
// while it walks t = 0..T-1, and each discretisation is one
// ex2.approx.ftz (a bare MUFU.EX2: no denormal fix-up around it). A block is
// 128 consumer threads (128 consecutive channels of one batch row) and one
// producer warp. The producer keeps a ring of kStages shared-memory stages
// of kTc time steps filled, each guarded by a "full" and an "empty"
// mbarrier:
//   - u and dt, one row of the block's channels per time step, arrive by
//     cp.async.bulk (1-D TMA, one copy per row and tensor, completing on the
//     stage's full barrier) when their rows are 16-byte aligned (d_in a
//     multiple of 8 for bf16, 4 for float32, and 16-byte aligned bases), or
//     by the producer lanes' own loads otherwise (ragged widths);
//   - B_t and C_t (N values a step, the same for every channel of the row)
//     are read by the producer lanes through their batch and time strides,
//     so the model's column slices of the x_proj output need no copy and no
//     alignment, converted to float32 once per block, and stored padded to
//     NM with zeros; the consumers read them as 128-bit broadcasts.
// The consumers never touch device memory in the time loop except to store
// y, and never meet a block-wide barrier: a warp waits on a stage's full
// barrier and, done with it, arrives on its empty barrier. Each warp's y
// store at a step is 32 consecutive channels (64 or 128 contiguous bytes,
// whole 32-byte sectors); h_T is written once at the end.
//
// Launch plan (fixed here, not chosen by the host): blocks of kThreads = 160
// (4 consumer warps + the producer), __launch_bounds__(160, 4) so that a
// thread has at most 96 registers and four blocks fit an SM; shared memory
// kStages x kTc x (128 x (sizeof(u) + 4) + 8 N) bytes a block, 43 KB (bf16)
// or 55 KB (float32) at N 16, so four blocks fit the SM's 228 KB too. The
// grid is ceil(d_in / 128) x Bt: at Jamba's shape 1,024 blocks over 132 x 4
// slots, 1.94 waves.
//
// Every input is read as float32 and the state is float32, as in the Pallas
// kernel and mamba_scan_ref; y is written in u's type, h_T in float32. The
// kernel is templated on u's type (B and C share it) and the state width
// rounded up to 4, 8 or 16; the padding lanes carry A = B = C = 0 and stay
// zero. dt is float32, as the model makes it; the wrapper refuses other
// types rather than cast dt. A ragged tail of channels is masked in the
// kernel.
//
// Training (kSave): the same kernel also writes the float32 state at the
// start of every stage of kTc steps, hs[b, k, c, :] = h before step k * kTc
// (h0 or zeros for k = 0), which csrc/mamba_scan_bwd.cu recomputes each
// stage's states from. At Jamba's shape that is 8 x 32 x 16384 x 16 floats,
// 268 MB, written 64 contiguous bytes a thread (a warp's 2 KB in a row) as
// the stage begins; the serving instance (kSave false) has no such store.
#include "common.cuh"

namespace {

using repro::ex2;
using repro::from_float;
using repro::to_float;

constexpr int kCh = 128;              // channels (consumer threads) per block
constexpr int kThreads = kCh + 32;    // and one producer warp
constexpr int kMinBlocks = 4;         // blocks per SM the plan is sized for
constexpr int kTc = 16;               // time steps per stage
constexpr int kStages = 3;            // stages in the ring
constexpr float kLog2e = 1.4426950408889634f;

// Byte layout of one stage: dt rows, u rows, then B and C rows as float32
// (B_t then C_t, NM floats each); the barriers follow the last stage.
template <typename TU, int NM>
struct Layout {
  static constexpr int kDt = 0;
  static constexpr int kU = kTc * kCh * 4;
  static constexpr int kBC = kU + kTc * kCh * (int)sizeof(TU);
  static constexpr int kStage = kBC + kTc * 2 * NM * 4;
  static constexpr int kBars = kStages * kStage;
  static constexpr int kSmem = kBars + 2 * kStages * 8;
};

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

// Arrive and raise the phase's expected transaction bytes (0 is allowed).
__device__ __forceinline__ void mbar_arrive_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait beyond 10 s traps, so a broken pipeline fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}

// One contiguous run of `bytes` (a multiple of 16, both ends 16-byte
// aligned) from device memory into shared memory, completing on `bar`.
__device__ __forceinline__ void bulk_load(uint32_t dst, const void* src, uint32_t bytes,
                                          uint32_t bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];\n"
      ::"r"(dst), "l"(src), "r"(bytes), "r"(bar)
      : "memory");
}

template <typename TU, int NM, bool kSave>
__global__ void __launch_bounds__(kThreads, kMinBlocks)
mamba_scan_kernel(const TU* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ A, const TU* __restrict__ Bm,
                  const TU* __restrict__ Cm, const float* __restrict__ Dv,
                  const float* __restrict__ h0, TU* __restrict__ y,
                  float* __restrict__ hT, float* __restrict__ hs, int T, int d_in, int n,
                  long long b_sb, long long b_st, long long c_sb, long long c_st,
                  int bulk) {
  using L = Layout<TU, NM>;
  extern __shared__ __align__(128) unsigned char smem[];
  const int b = blockIdx.y;
  const int c0 = blockIdx.x * kCh;
  const int ncols = min(kCh, d_in - c0);
  const int n_warps = (ncols + 31) / 32;  // consumer warps with a channel
  const int n_chunks = (T + kTc - 1) / kTc;
  const uint32_t base = smem_addr(smem);
  const uint32_t full0 = base + L::kBars, empty0 = full0 + 8 * kStages;
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full0 + 8 * s, 64);         // each producer lane arrives twice
      mbar_init(empty0 + 8 * s, n_warps);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  const size_t row0 = (size_t)b * T * d_in + c0;  // (b, t, c0 + j) is row0 + t*d_in + j

  if (warp == kCh / 32) {
    // producer: lanes 0-15 bring u rows and B_t, lanes 16-31 dt rows and C_t,
    // one time step of the stage each
    const bool hi = lane >= 16;
    const int r = lane & 15;
    const TU* bc = hi ? Cm + b * c_sb : Bm + b * b_sb;
    const long long bc_st = hi ? c_st : b_st;
    int s = 0;
    uint32_t phase = 0;
    for (int k = 0; k < n_chunks; ++k) {
      const int t0 = k * kTc, tn = min(kTc, T - t0);
      const uint32_t full = full0 + 8 * s;
      mbar_wait(empty0 + 8 * s, phase ^ 1);
      unsigned char* st = smem + s * L::kStage;
      if (bulk) {
        const bool on = r < tn;
        const uint32_t bytes = on ? ncols * (hi ? 4u : (uint32_t)sizeof(TU)) : 0u;
        mbar_arrive_expect_tx(full, bytes);
        if (on) {
          const size_t off = row0 + (size_t)(t0 + r) * d_in;
          if (hi)
            bulk_load(base + s * L::kStage + L::kDt + r * kCh * 4, dt + off, bytes, full);
          else
            bulk_load(base + s * L::kStage + L::kU + r * kCh * (int)sizeof(TU), u + off,
                      bytes, full);
        }
      } else {
        float* sdt = reinterpret_cast<float*>(st + L::kDt);
        TU* su = reinterpret_cast<TU*>(st + L::kU);
        for (int i = lane; i < tn * kCh; i += 32) {
          const int rr = i / kCh, cc = i % kCh;
          if (cc < ncols) {
            const size_t off = row0 + (size_t)(t0 + rr) * d_in + cc;
            su[i] = u[off];
            sdt[i] = dt[off];
          }
        }
        mbar_arrive_expect_tx(full, 0);
      }
      float v[NM];
#pragma unroll
      for (int i = 0; i < NM; ++i)
        v[i] = (r < tn && i < n) ? to_float<TU>(bc[(t0 + r) * bc_st + i]) : 0.f;
      float4* dst = reinterpret_cast<float4*>(st + L::kBC) + r * (NM / 2) + (hi ? NM / 4 : 0);
#pragma unroll
      for (int q = 0; q < NM / 4; ++q)
        dst[q] = make_float4(v[4 * q], v[4 * q + 1], v[4 * q + 2], v[4 * q + 3]);
      mbar_arrive(full);
      if (++s == kStages) {
        s = 0;
        phase ^= 1;
      }
    }
    return;
  }
  if (warp >= n_warps) return;

  // consumer: channel c of batch row b
  const int j = threadIdx.x;
  const int c = c0 + j;
  const bool active = j < ncols;
  float a2[NM], h[NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    const bool on = active && i < n;
    a2[i] = on ? A[(size_t)c * n + i] * kLog2e : 0.f;
    h[i] = (on && h0 != nullptr) ? h0[((size_t)b * d_in + c) * n + i] : 0.f;
  }
  const float dd = active ? Dv[c] : 0.f;
  TU* yp = y + row0 + j;

  // this thread's N states to out[0..n)
  auto store_state = [&](float* out) {
    if (n == NM) {
#pragma unroll
      for (int q = 0; q < NM / 4; ++q)
        reinterpret_cast<float4*>(out)[q] =
            make_float4(h[4 * q], h[4 * q + 1], h[4 * q + 2], h[4 * q + 3]);
    } else {
#pragma unroll
      for (int i = 0; i < NM; ++i)
        if (i < n) out[i] = h[i];
    }
  };

  // one time step: u_t and dt_t from the stage, B_t / C_t as broadcasts
  auto step = [&](const float* sdt, const TU* su, const float4* sbc) {
    const float ut = to_float<TU>(*su);
    const float dtt = *sdt;
    const float dtu = dtt * ut;
    float acc0 = 0.f, acc1 = 0.f;
#pragma unroll
    for (int q = 0; q < NM / 4; ++q) {
      const float4 bq = sbc[q], cq = sbc[NM / 4 + q];
      h[4 * q] = fmaf(ex2(dtt * a2[4 * q]), h[4 * q], dtu * bq.x);
      h[4 * q + 1] = fmaf(ex2(dtt * a2[4 * q + 1]), h[4 * q + 1], dtu * bq.y);
      h[4 * q + 2] = fmaf(ex2(dtt * a2[4 * q + 2]), h[4 * q + 2], dtu * bq.z);
      h[4 * q + 3] = fmaf(ex2(dtt * a2[4 * q + 3]), h[4 * q + 3], dtu * bq.w);
      acc0 = fmaf(h[4 * q], cq.x, acc0);
      acc1 = fmaf(h[4 * q + 1], cq.y, acc1);
      acc0 = fmaf(h[4 * q + 2], cq.z, acc0);
      acc1 = fmaf(h[4 * q + 3], cq.w, acc1);
    }
    if (active) *yp = from_float<TU>(fmaf(dd, ut, acc0 + acc1));
    yp += d_in;
  };

  int s = 0;
  uint32_t phase = 0;
  for (int k = 0; k < n_chunks; ++k) {
    const int tn = min(kTc, T - k * kTc);
    if constexpr (kSave) {
      if (active) store_state(hs + (((size_t)b * n_chunks + k) * d_in + c) * n);
    }
    mbar_wait(full0 + 8 * s, phase);
    const unsigned char* st = smem + s * L::kStage;
    const float* sdt = reinterpret_cast<const float*>(st + L::kDt) + j;
    const TU* su = reinterpret_cast<const TU*>(st + L::kU) + j;
    const float4* sbc = reinterpret_cast<const float4*>(st + L::kBC);
    if (tn == kTc) {
#pragma unroll 2
      for (int tt = 0; tt < kTc; ++tt)
        step(sdt + tt * kCh, su + tt * kCh, sbc + tt * (NM / 2));
    } else {
      for (int tt = 0; tt < tn; ++tt)
        step(sdt + tt * kCh, su + tt * kCh, sbc + tt * (NM / 2));
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty0 + 8 * s);
    if (++s == kStages) {
      s = 0;
      phase ^= 1;
    }
  }
  if (active) store_state(hT + ((size_t)b * d_in + c) * n);
}

template <typename TU, int NM, bool kSave>
cudaError_t configure() {
  auto kernel = mamba_scan_kernel<TU, NM, kSave>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<TU, NM>::kSmem);
  if (err != cudaSuccess) return err;
  return cudaFuncSetAttribute(kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                              (int)cudaSharedmemCarveoutMaxShared);
}

template <typename TU, int NM, bool kSave>
cudaError_t launch(const void* u, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* D, const float* h0, void* y, float* hT,
                   float* hs, int Bt, int T, int d_in, int n, long long b_sb, long long b_st,
                   long long c_sb, long long c_st, cudaStream_t stream) {
  cudaError_t err = configure<TU, NM, kSave>();
  if (err != cudaSuccess) return err;
  // rows of u and dt go by cp.async.bulk when every row starts and ends on
  // 16 bytes; hT is the wrapper's fresh allocation
  const bool bulk = ((reinterpret_cast<uintptr_t>(u) | reinterpret_cast<uintptr_t>(dt)) & 15) == 0 &&
                    d_in % (16 / (int)sizeof(TU)) == 0 && d_in % 4 == 0;
  const dim3 grid((d_in + kCh - 1) / kCh, Bt);
  mamba_scan_kernel<TU, NM, kSave><<<grid, kThreads, Layout<TU, NM>::kSmem, stream>>>(
      static_cast<const TU*>(u), dt, A,
      static_cast<const TU*>(Bm), static_cast<const TU*>(Cm), D, h0,
      static_cast<TU*>(y), hT, hs, T, d_in, n, b_sb, b_st, c_sb, c_st, bulk ? 1 : 0);
  return cudaGetLastError();
}

template <typename TU, bool kSave>
cudaError_t dispatch_n(const void* u, const float* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, const float* h0, void* y,
                       float* hT, float* hs, int Bt, int T, int d_in, int n,
                       long long b_sb, long long b_st, long long c_sb, long long c_st,
                       cudaStream_t st) {
  if (n <= 4)
    return launch<TU, 4, kSave>(u, dt, A, Bm, Cm, D, h0, y, hT, hs, Bt, T, d_in, n,
                                b_sb, b_st, c_sb, c_st, st);
  if (n <= 8)
    return launch<TU, 8, kSave>(u, dt, A, Bm, Cm, D, h0, y, hT, hs, Bt, T, d_in, n,
                                b_sb, b_st, c_sb, c_st, st);
  return launch<TU, 16, kSave>(u, dt, A, Bm, Cm, D, h0, y, hT, hs, Bt, T, d_in, n,
                               b_sb, b_st, c_sb, c_st, st);
}

template <typename TU>
cudaError_t dispatch_save(const void* u, const float* dt, const float* A, const void* Bm,
                          const void* Cm, const float* D, const float* h0, void* y,
                          float* hT, float* hs, int Bt, int T, int d_in, int n,
                          long long b_sb, long long b_st, long long c_sb, long long c_st,
                          cudaStream_t st) {
  if (hs != nullptr)
    return dispatch_n<TU, true>(u, dt, A, Bm, Cm, D, h0, y, hT, hs, Bt, T, d_in, n,
                                b_sb, b_st, c_sb, c_st, st);
  return dispatch_n<TU, false>(u, dt, A, Bm, Cm, D, h0, y, hT, hs, Bt, T, d_in, n,
                               b_sb, b_st, c_sb, c_st, st);
}

template <typename TU, int NM>
int occupancy() {
  int blocks = 0;
  if (configure<TU, NM, false>() != cudaSuccess ||
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&blocks, mamba_scan_kernel<TU, NM, false>,
                                                    kThreads, Layout<TU, NM>::kSmem) !=
          cudaSuccess)
    return -1;
  return blocks;
}

}  // namespace

// u, y: (Bt, T, d_in) contiguous in u's type; dt: the same shape, float32;
// A: (d_in, n) float32; B, C: (Bt, T, n) in u's type with unit stride over n
// and the given batch and time strides (in elements); D: (d_in,) float32;
// h0: (Bt, d_in, n) float32 or NULL for zeros; hT: (Bt, d_in, n) float32,
// 16-byte aligned; hs: NULL (serving), or (Bt, ceil(T / 16), d_in, n)
// float32, 16-byte aligned, for the state at the start of every 16 steps
// (training). 1 <= n <= 16. u_dtype gives the type of u, B, C and y.
// Returns a cudaError_t code.
extern "C" int mamba_scan_fwd(const void* u, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              const void* h0, void* y, void* hT, void* hs, int Bt,
                              int T, int d_in, int n, long long b_sb, long long b_st,
                              long long c_sb, long long c_st, int u_dtype,
                              void* stream) {
  if (Bt <= 0 || T <= 0 || d_in <= 0 || n <= 0 || n > 16 || Bt > 65535)
    return cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  const float* dv = static_cast<const float*>(D);
  const float* h = static_cast<const float*>(h0);
  float* ht = static_cast<float*>(hT);
  float* hsv = static_cast<float*>(hs);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u_dtype == repro::kFloat32)
    return dispatch_save<float>(u, dtf, a, Bm, Cm, dv, h, y, ht, hsv, Bt, T, d_in, n,
                                b_sb, b_st, c_sb, c_st, st);
  if (u_dtype == repro::kBFloat16)
    return dispatch_save<__nv_bfloat16>(u, dtf, a, Bm, Cm, dv, h, y, ht, hsv, Bt, T,
                                        d_in, n, b_sb, b_st, c_sb, c_st, st);
  return cudaErrorInvalidValue;
}

// Blocks of the kernel instance for state width n and u_dtype that one SM
// holds at once (the CUDA occupancy calculator, with the kernel's shared
// memory and carveout set); -1 on error. The launch plan above is sized
// for kMinBlocks.
extern "C" int mamba_scan_blocks_per_sm(int n, int u_dtype) {
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
