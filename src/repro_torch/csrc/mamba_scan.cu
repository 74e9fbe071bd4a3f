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
// shape; the special-function units give 16 results per SM per clock, 132 x
// 16 x 1.98 GHz = 4.18e12 per second, so ~0.26 ms. The exponentials bind.
// The float32 FMAs (~4 per state element) are ~0.1 ms at 67 TFLOP/s.
//
// Design. The Pallas kernel walks T inside one grid cell with a (d_blk, N)
// state in VMEM; here one thread owns one (batch row, channel) pair and keeps
// its N state values and its row of A (pre-scaled by log2 e, so each
// discretisation is one exp2f) in registers while it walks t = 0..T-1. No
// split over T is needed: at the main shape the grid is 8 x 16384 = 131,072
// threads, about one resident wave on 132 SMs at <= 64 registers a thread
// (__launch_bounds__(128, 8)). A block holds 128 consecutive channels of one
// batch row, so at each t its u and dt loads and its y stores are coalesced
// across the warp. B_t and C_t (N values, the same for every channel of the
// row) are staged in shared memory 64 timesteps at a time and read as
// broadcasts; they are read through their batch and time strides, so the
// model's column slices of the x_proj output need no copy. Every input is
// read as float32 and the state is float32, as in the Pallas kernel and
// mamba_scan_ref; y is written in u's type, h_T in float32. The kernel is
// templated on u's type (B and C share it) and the state width rounded up to
// 4, 8 or 16; the padding lanes carry A = B = C = 0 and stay zero. dt is
// float32, as the model makes it (softplus of a bf16 product plus a float32
// bias promotes); the wrapper refuses other types rather than cast dt. A
// ragged tail of channels is masked in the kernel (no d_in % block assert).
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kThreads = 128;  // channels per block
constexpr int kChunk = 64;     // timesteps of B and C staged per pass
constexpr float kLog2e = 1.4426950408889634f;

template <typename TU, int NM>
__global__ void __launch_bounds__(kThreads, 8)
mamba_scan_kernel(const TU* __restrict__ u, const float* __restrict__ dt,
                  const float* __restrict__ A, const TU* __restrict__ Bm,
                  const TU* __restrict__ Cm, const float* __restrict__ Dv,
                  const float* __restrict__ h0, TU* __restrict__ y,
                  float* __restrict__ hT, int T, int d_in, int n,
                  long long b_sb, long long b_st, long long c_sb, long long c_st) {
  __shared__ float sB[kChunk][NM];
  __shared__ float sC[kChunk][NM];
  const int b = blockIdx.y;
  const int d = blockIdx.x * kThreads + threadIdx.x;
  const bool active = d < d_in;

  float a2[NM], h[NM];
#pragma unroll
  for (int i = 0; i < NM; ++i) {
    const bool on = active && i < n;
    a2[i] = on ? A[(size_t)d * n + i] * kLog2e : 0.f;
    h[i] = (on && h0 != nullptr) ? h0[((size_t)b * d_in + d) * n + i] : 0.f;
  }
  const float dd = active ? Dv[d] : 0.f;
  const size_t row = (size_t)b * T * d_in + d;  // (b, t, d) is row + t * d_in
  const TU* Bb = Bm + b * b_sb;
  const TU* Cb = Cm + b * c_sb;

  for (int t0 = 0; t0 < T; t0 += kChunk) {
    const int tn = min(kChunk, T - t0);
    __syncthreads();  // the previous chunk's readers are done
    for (int idx = threadIdx.x; idx < kChunk * NM; idx += kThreads) {
      const int tt = idx / NM, i = idx - tt * NM;
      const bool on = tt < tn && i < n;
      sB[tt][i] = on ? to_float<TU>(Bb[(t0 + tt) * b_st + i]) : 0.f;
      sC[tt][i] = on ? to_float<TU>(Cb[(t0 + tt) * c_st + i]) : 0.f;
    }
    __syncthreads();
    if (active) {
#pragma unroll 4
      for (int tt = 0; tt < tn; ++tt) {
        const size_t off = row + (size_t)(t0 + tt) * d_in;
        const float ut = to_float<TU>(u[off]);
        const float dtt = dt[off];
        const float dtu = dtt * ut;
        float acc = 0.f;
#pragma unroll
        for (int i = 0; i < NM; ++i) {
          h[i] = fmaf(exp2f(dtt * a2[i]), h[i], dtu * sB[tt][i]);
          acc = fmaf(h[i], sC[tt][i], acc);
        }
        y[off] = from_float<TU>(fmaf(dd, ut, acc));
      }
    }
  }
  if (active) {
    float* out = hT + ((size_t)b * d_in + d) * n;
#pragma unroll
    for (int i = 0; i < NM; ++i)
      if (i < n) out[i] = h[i];
  }
}

template <typename TU, int NM>
cudaError_t launch(const void* u, const float* dt, const float* A, const void* Bm,
                   const void* Cm, const float* D, const float* h0, void* y, float* hT,
                   int Bt, int T, int d_in, int n, long long b_sb, long long b_st,
                   long long c_sb, long long c_st, cudaStream_t stream) {
  const dim3 grid((d_in + kThreads - 1) / kThreads, Bt);
  mamba_scan_kernel<TU, NM><<<grid, kThreads, 0, stream>>>(
      static_cast<const TU*>(u), dt, A,
      static_cast<const TU*>(Bm), static_cast<const TU*>(Cm), D, h0,
      static_cast<TU*>(y), hT, T, d_in, n, b_sb, b_st, c_sb, c_st);
  return cudaGetLastError();
}

template <typename TU>
cudaError_t dispatch_n(const void* u, const float* dt, const float* A, const void* Bm,
                       const void* Cm, const float* D, const float* h0, void* y,
                       float* hT, int Bt, int T, int d_in, int n, long long b_sb,
                       long long b_st, long long c_sb, long long c_st,
                       cudaStream_t st) {
  if (n <= 4)
    return launch<TU, 4>(u, dt, A, Bm, Cm, D, h0, y, hT, Bt, T, d_in, n, b_sb,
                         b_st, c_sb, c_st, st);
  if (n <= 8)
    return launch<TU, 8>(u, dt, A, Bm, Cm, D, h0, y, hT, Bt, T, d_in, n, b_sb,
                         b_st, c_sb, c_st, st);
  return launch<TU, 16>(u, dt, A, Bm, Cm, D, h0, y, hT, Bt, T, d_in, n, b_sb,
                        b_st, c_sb, c_st, st);
}

}  // namespace

// u, y: (Bt, T, d_in) contiguous in u's type; dt: the same shape, float32;
// A: (d_in, n) float32; B, C: (Bt, T, n) in u's type with unit stride over n
// and the given batch and time strides (in elements); D: (d_in,) float32;
// h0: (Bt, d_in, n) float32 or NULL for zeros; hT: (Bt, d_in, n) float32.
// 1 <= n <= 16. u_dtype gives the type of u, B, C and y. Returns a
// cudaError_t code.
extern "C" int mamba_scan_fwd(const void* u, const void* dt, const void* A,
                              const void* Bm, const void* Cm, const void* D,
                              const void* h0, void* y, void* hT, int Bt, int T,
                              int d_in, int n, long long b_sb, long long b_st,
                              long long c_sb, long long c_st, int u_dtype,
                              void* stream) {
  if (Bt <= 0 || T <= 0 || d_in <= 0 || n <= 0 || n > 16 || Bt > 65535)
    return cudaErrorInvalidValue;
  const float* dtf = static_cast<const float*>(dt);
  const float* a = static_cast<const float*>(A);
  const float* dv = static_cast<const float*>(D);
  const float* h = static_cast<const float*>(h0);
  float* ht = static_cast<float*>(hT);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (u_dtype == repro::kFloat32)
    return dispatch_n<float>(u, dtf, a, Bm, Cm, dv, h, y, ht, Bt, T, d_in, n, b_sb,
                             b_st, c_sb, c_st, st);
  if (u_dtype == repro::kBFloat16)
    return dispatch_n<__nv_bfloat16>(u, dtf, a, Bm, Cm, dv, h, y, ht, Bt, T, d_in,
                                     n, b_sb, b_st, c_sb, c_st, st);
  return cudaErrorInvalidValue;
}
