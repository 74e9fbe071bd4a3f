// Flash attention backward for Hopper (sm_90a), float32, on the CUDA
// cores: dq, dk, dv of o = softmax(scale * q k^T + mask) v with causal,
// sliding-window or full masking, GQA, an offset for q row 0, and every
// tensor read and written through its batch, head and sequence strides.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (_kernel). The Pallas kernel has no backward; the reference trains
// through the blockwise jnp attention (_flash_jnp) and lets JAX
// differentiate it. This is that gradient as a kernel for float32 inputs,
// beside the float32 forward (flash_attention.cu); bf16 runs on the tensor
// cores (flash_attention_bwd_sm90.cu).
//
// Bound on an H100 SXM: the larger of 10 * B * Hq * D * pairs operations
// (pairs = the (query, key) pairs the mask keeps; five products of 2 D
// each: S = q k^T again, since the forward keeps nothing, dP = dO v^T,
// dv = P^T dO, dq = dS k, dk = dS^T q) over the peak of the input type
// (989 TFLOP/s bf16 on the tensor cores, 67 float32 on the CUDA cores), and
// the bytes of q, k, v, o, dO, dq, dk, dv over 3.35 TB/s. This kernel does
// ~16 D per pair (S and dP twice, once in each launch, and the row sums of
// the log-sum-exp pass), 1.6x the float32 operations bound.
//
// Design: two launches, no atomics, every sum in a fixed order.
//   1. flash_bwd_dq_kernel, one block of 256 threads per (64-row q tile, q
//      head, batch): stages the Q and dO tiles in shared memory as float32,
//      computes delta = rowsum(dO * O) (one warp per row, O from device
//      memory), then walks the kv tiles the mask lets the tile see twice:
//      first for the log-sum-exp L of each row (online max and sum, the
//      forward's arithmetic; a row with no key gets L = +inf), then for dq:
//      S and dP = dO V^T are recomputed, P = exp(S - L), dS = P (dP -
//      delta), and dq += dS K. L and delta go to a (B, Hq, Sq) float32
//      workspace for the second launch.
//   2. flash_bwd_dkdv_kernel, one block per (64-key kv tile, kv head,
//      batch): keeps its K and V tiles in shared memory and its dk and dv
//      accumulators in registers, and walks the q tiles of all G q heads
//      that share the kv head and can see a key of the tile (causal: from
//      the first key's position; window: up to the last key's position plus
//      the window), recomputing S and dP and taking P and dS from L and
//      delta: dv += P^T dO, dk += dS^T Q.
// Thread (t >> 4, t & 15) computes the 4 x 4 products of q rows
// (t >> 4) + 16 i and keys (t & 15) + 16 j; tiles are stored with a row
// stride of D + 1 floats (and P / dS of 80), so the column reads of those
// products, and of the output products (rows or keys (t >> 4) + 16 j,
// columns (t & 15) + 16 c), hit distinct banks. Loads are element by
// element and coalesced along each row: any strides work, including the
// stride-0 dims of a gradient that autograd broadcast. Rows past Sq and
// keys past Skv read as zeros and are masked; nothing is written past them
// or past D. Head dims 16, 20, 24, 32, 64, 80, 128, 192 (24 and 192 are
// MLA's, DeepSeek-V3's at SMOKE size and at its published widths). At 192
// the dK/dV block's four tiles and separate P and dS tiles would pass the
// 227 KB a block can have, so P and then dS go through one tile: dv first,
// then dk, each sum in the same order as with two tiles.
#include "common.cuh"

#include <math.h>

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kB = 64;          // q rows of a q tile, keys of a kv tile
constexpr int kThreads = 256;
constexpr int kPS = 80;         // row stride of the P and dS tiles
constexpr size_t kMaxSmem = 232448;

// (batch, head, sequence) element strides of q, k, v, o, dO, dq, dk, dv
enum { kQ = 0, kK, kV, kO, kDO, kDQ, kDK, kDV, kTensors };
struct Strides {
  long long s[kTensors][3];
  __device__ __forceinline__ long long base(int t, int b, int h, int row) const {
    return b * s[t][0] + h * s[t][1] + row * s[t][2];
  }
};

// rows [row0, row0 + kB) of (b, h) of `src` into a (kB, D + 1) float tile;
// rows at or past `rows` read as zeros
template <typename T, int D>
__device__ __forceinline__ void load_tile(float* dst, const T* __restrict__ src,
                                          const Strides& st, int t, int b, int h, int row0,
                                          int rows) {
  const T* base = src + st.base(t, b, h, row0);
  const long long ss = st.s[t][2];
  for (int idx = threadIdx.x; idx < kB * D; idx += kThreads) {
    const int r = idx / D, c = idx - r * D;
    dst[r * (D + 1) + c] = row0 + r < rows ? to_float<T>(base[r * ss + c]) : 0.f;
  }
}

// s = A B^T (and, with kTwo, dp = C E^T) for this thread's 4 rows of A/C
// and 4 rows of B/E, each tile (kB, D + 1)
template <int D, bool kTwo>
__device__ __forceinline__ void products(const float* a, const float* bt, const float* c,
                                         const float* e, int tq, int tk, float (&s)[4][4],
                                         float (&dp)[4][4]) {
  constexpr int DS = D + 1;
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.f;
#pragma unroll 4
  for (int dd = 0; dd < D; ++dd) {
    float av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = a[(tq + 16 * i) * DS + dd];
#pragma unroll
    for (int j = 0; j < 4; ++j) bv[j] = bt[(tk + 16 * j) * DS + dd];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], bv[j], s[i][j]);
    if constexpr (kTwo) {
      float cv[4], ev[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) cv[i] = c[(tq + 16 * i) * DS + dd];
#pragma unroll
      for (int j = 0; j < 4; ++j) ev[j] = e[(tk + 16 * j) * DS + dd];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) dp[i][j] = fmaf(cv[i], ev[j], dp[i][j]);
    }
  }
}

__device__ __forceinline__ bool visible(int qpos, int kpos, int Skv, int causal, int window) {
  bool ok = kpos < Skv;
  if (causal) ok = ok && kpos <= qpos;
  if (window >= 0) ok = ok && kpos > qpos - window;
  return ok;
}

__device__ __forceinline__ float half_warp_max(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

__device__ __forceinline__ float half_warp_sum(float v) {
#pragma unroll
  for (int o = 8; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

template <int D>
constexpr size_t dq_smem_bytes() {
  return (4 * (size_t)kB * (D + 1) + (size_t)kB * kPS + kB) * sizeof(float);
}

// P and dS each in its own tile, unless that passes a block's shared memory
template <int D>
__host__ __device__ constexpr bool dkdv_two_tiles() {
  return (4 * (size_t)kB * (D + 1) + 2 * (size_t)kB * kPS + 2 * kB) * sizeof(float) <= kMaxSmem;
}

template <int D>
constexpr size_t dkdv_smem_bytes() {
  return (4 * (size_t)kB * (D + 1) + (dkdv_two_tiles<D>() ? 2 : 1) * (size_t)kB * kPS + 2 * kB) *
         sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dq_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const T* __restrict__ o, const T* __restrict__ dout, T* __restrict__ dq,
                    float* __restrict__ lse_out, float* __restrict__ delta_out, Strides st,
                    int Hq, int Sq, int Skv, int G, int causal, int window, int offset,
                    float scale) {
  constexpr int DS = D + 1, CD = (D + 15) / 16;
  extern __shared__ __align__(16) float smem[];
  float* qs = smem;
  float* dos = qs + kB * DS;
  float* ks = dos + kB * DS;
  float* vs = ks + kB * DS;
  float* dss = vs + kB * DS;   // (kB, kPS)
  float* dl = dss + kB * kPS;  // delta of each row
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int tq = tid >> 4, tk = tid & 15;
  const int h = blockIdx.y, b = blockIdx.z, kvh = h / G;
  const int q0 = blockIdx.x * kB, n_q = min(kB, Sq - q0);
  const float kInf = __int_as_float(0x7f800000);

  load_tile<T, D>(qs, q, st, kQ, b, h, q0, Sq);
  load_tile<T, D>(dos, dout, st, kDO, b, h, q0, Sq);
  __syncthreads();
  for (int r = warp; r < kB; r += kThreads / 32) {
    float acc = 0.f;
    if (r < n_q) {
      const T* orow = o + st.base(kO, b, h, q0 + r);
      for (int dd = lane; dd < D; dd += 32) acc = fmaf(to_float<T>(orow[dd]), dos[r * DS + dd], acc);
    }
    acc = repro::warp_sum(acc);
    if (lane == 0) dl[r] = acc;
  }

  // kv tiles the q tile can see: [window start, causal frontier]
  const int q_lo = offset + q0, q_hi = offset + q0 + n_q - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int kv_start = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = kv_start / kB;
  const int t_end = kv_end > kv_start ? (kv_end + kB - 1) / kB : t_begin;

  // pass 1: the log-sum-exp of each of this thread's rows (shared by the 16
  // threads of its half warp)
  float m[4], l[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = -kInf;
    l[i] = 0.f;
  }
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kB;
    __syncthreads();
    load_tile<T, D>(ks, k, st, kK, b, kvh, k0, Skv);
    __syncthreads();
    float s[4][4], unused[4][4];
    products<D, false>(qs, ks, nullptr, nullptr, tq, tk, s, unused);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + tq + 16 * i;
      float mx = -kInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = visible(qpos, k0 + tk + 16 * j, Skv, causal, window) ? s[i][j] * scale : -kInf;
        mx = fmaxf(mx, s[i][j]);
      }
      mx = half_warp_max(mx);
      const float m_new = fmaxf(m[i], mx);
      const float mu = m_new == -kInf ? 0.f : m_new;
      float p = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) p += expf(s[i][j] - mu);
      p = half_warp_sum(p);
      l[i] = l[i] * expf(m[i] - mu) + p;
      m[i] = m_new;
    }
  }
  float lse[4], dlt[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tq + 16 * i;
    lse[i] = l[i] > 0.f ? m[i] + logf(l[i]) : kInf;
    dlt[i] = dl[r];
    if (tk == 0 && r < n_q) {
      const size_t idx = ((size_t)b * Hq + h) * Sq + q0 + r;
      lse_out[idx] = lse[i];
      delta_out[idx] = dlt[i];
    }
  }

  // pass 2: dq = scale * dS K
  float acc[4][CD];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int c = 0; c < CD; ++c) acc[i][c] = 0.f;
  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kB;
    __syncthreads();
    load_tile<T, D>(ks, k, st, kK, b, kvh, k0, Skv);
    load_tile<T, D>(vs, v, st, kV, b, kvh, k0, Skv);
    __syncthreads();
    float s[4][4], dp[4][4];
    products<D, true>(qs, ks, dos, vs, tq, tk, s, dp);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int qpos = q_lo + tq + 16 * i;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const bool ok = visible(qpos, k0 + tk + 16 * j, Skv, causal, window);
        const float p = ok ? expf(s[i][j] * scale - lse[i]) : 0.f;
        dss[(tq + 16 * i) * kPS + tk + 16 * j] = p * (dp[i][j] - dlt[i]);
      }
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < kB; ++kk) {
      float kv[CD];
#pragma unroll
      for (int c = 0; c < CD; ++c) {
        const int col = tk + 16 * c;
        kv[c] = col < D ? ks[kk * DS + col] : 0.f;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float ds = dss[(tq + 16 * i) * kPS + kk];
#pragma unroll
        for (int c = 0; c < CD; ++c) acc[i][c] = fmaf(ds, kv[c], acc[i][c]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = tq + 16 * i;
    if (r >= n_q) continue;
    T* row = dq + st.base(kDQ, b, h, q0 + r);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tk + 16 * c;
      if (col < D) row[col] = from_float<T>(acc[i][c] * scale);
    }
  }
}

// acc[j][c] += sum over the tile's q rows qq of w[qq][key] x[qq][col], for
// this thread's keys tq + 16 j and columns tk + 16 c (w: P or dS; x: dO or Q)
template <int D>
__device__ __forceinline__ void accumulate_rows(float (&acc)[4][(D + 15) / 16], const float* w,
                                                const float* x, int tq, int tk) {
  constexpr int DS = D + 1, CD = (D + 15) / 16;
#pragma unroll 2
  for (int qq = 0; qq < kB; ++qq) {
    float xv[CD];
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tk + 16 * c;
      xv[c] = col < D ? x[qq * DS + col] : 0.f;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float wv = w[qq * kPS + tq + 16 * j];
#pragma unroll
      for (int c = 0; c < CD; ++c) acc[j][c] = fmaf(wv, xv[c], acc[j][c]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_bwd_dkdv_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, const T* __restrict__ dout,
                      const float* __restrict__ lse, const float* __restrict__ delta,
                      T* __restrict__ dk, T* __restrict__ dv, Strides st, int Hq, int Sq,
                      int Skv, int G, int causal, int window, int offset, float scale) {
  constexpr int DS = D + 1, CD = (D + 15) / 16;
  extern __shared__ __align__(16) float smem[];
  float* ks = smem;
  float* vs = ks + kB * DS;
  float* qs = vs + kB * DS;
  float* dos = qs + kB * DS;
  constexpr bool kTwo = dkdv_two_tiles<D>();
  float* ps = dos + kB * DS;                  // (kB, kPS)
  float* dss = kTwo ? ps + kB * kPS : ps;     // (kB, kPS), or P's tile
  float* ls = dss + kB * kPS;  // L of each q row of the tile
  float* dl = ls + kB;         // delta of each q row
  const int tid = threadIdx.x;
  const int tq = tid >> 4, tk = tid & 15;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kB, n_k = min(kB, Skv - k0);
  const float kInf = __int_as_float(0x7f800000);

  load_tile<T, D>(ks, k, st, kK, b, kvh, k0, Skv);
  load_tile<T, D>(vs, v, st, kV, b, kvh, k0, Skv);

  // q rows that see a key of the tile: causal, from the first key's
  // position; window, up to the last key's position plus the window
  const int q_begin = causal ? max(0, k0 - offset) : 0;
  const int q_end = window >= 0 ? min(Sq, k0 + n_k - 1 - offset + window) : Sq;

  // this thread's keys tq + 16 j and columns tk + 16 c
  float dka[4][CD], dva[4][CD];
#pragma unroll
  for (int j = 0; j < 4; ++j)
#pragma unroll
    for (int c = 0; c < CD; ++c) dka[j][c] = dva[j][c] = 0.f;
  for (int g = 0; g < G && q_begin < q_end; ++g) {
    const int h = kvh * G + g;
    for (int q0 = q_begin / kB * kB; q0 < q_end; q0 += kB) {
      __syncthreads();
      load_tile<T, D>(qs, q, st, kQ, b, h, q0, Sq);
      load_tile<T, D>(dos, dout, st, kDO, b, h, q0, Sq);
      for (int r = tid; r < kB; r += kThreads) {
        const bool in = q0 + r < Sq;
        const size_t idx = ((size_t)b * Hq + h) * Sq + q0 + r;
        ls[r] = in ? lse[idx] : kInf;
        dl[r] = in ? delta[idx] : 0.f;
      }
      __syncthreads();
      float s[4][4], dp[4][4];
      products<D, true>(qs, ks, dos, vs, tq, tk, s, dp);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int r = tq + 16 * i;
        const int qpos = offset + q0 + r;
        const float lr = ls[r], dr = dl[r];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = q0 + r < Sq && visible(qpos, k0 + tk + 16 * j, Skv, causal, window);
          const float p = ok ? expf(s[i][j] * scale - lr) : 0.f;
          ps[r * kPS + tk + 16 * j] = p;
          // with one tile, dS waits in s until dv has read P
          if constexpr (kTwo)
            dss[r * kPS + tk + 16 * j] = p * (dp[i][j] - dr);
          else
            s[i][j] = p * (dp[i][j] - dr);
        }
      }
      __syncthreads();
      if constexpr (kTwo) {
#pragma unroll 2
        for (int qq = 0; qq < kB; ++qq) {
          float gv[CD], qv[CD];
#pragma unroll
          for (int c = 0; c < CD; ++c) {
            const int col = tk + 16 * c;
            gv[c] = col < D ? dos[qq * DS + col] : 0.f;
            qv[c] = col < D ? qs[qq * DS + col] : 0.f;
          }
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float p = ps[qq * kPS + tq + 16 * j];
            const float ds = dss[qq * kPS + tq + 16 * j];
#pragma unroll
            for (int c = 0; c < CD; ++c) {
              dva[j][c] = fmaf(p, gv[c], dva[j][c]);
              dka[j][c] = fmaf(ds, qv[c], dka[j][c]);
            }
          }
        }
      } else {
        accumulate_rows<D>(dva, ps, dos, tq, tk);
        __syncthreads();
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) dss[(tq + 16 * i) * kPS + tk + 16 * j] = s[i][j];
        __syncthreads();
        accumulate_rows<D>(dka, dss, qs, tq, tk);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int key = tq + 16 * j;
    if (key >= n_k) continue;
    T* krow = dk + st.base(kDK, b, kvh, k0 + key);
    T* vrow = dv + st.base(kDV, b, kvh, k0 + key);
#pragma unroll
    for (int c = 0; c < CD; ++c) {
      const int col = tk + 16 * c;
      if (col < D) {
        krow[col] = from_float<T>(dka[j][c] * scale);
        vrow[col] = from_float<T>(dva[j][c]);
      }
    }
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o,
                   const void* dout, void* dq, void* dk, void* dv, float* lse, float* delta,
                   const Strides& st, int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                   int window, int offset, float scale, cudaStream_t stream) {
  static_assert(dq_smem_bytes<D>() <= kMaxSmem && dkdv_smem_bytes<D>() <= kMaxSmem,
                "tiles exceed the shared memory of a block");
  static const cudaError_t setup = [] {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_kernel<T, D>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           (int)dq_smem_bytes<D>());
    if (err != cudaSuccess) return err;
    return cudaFuncSetAttribute(flash_bwd_dkdv_kernel<T, D>,
                                cudaFuncAttributeMaxDynamicSharedMemorySize,
                                (int)dkdv_smem_bytes<D>());
  }();
  if (setup != cudaSuccess) return setup;
  const int G = Hq / Hkv;
  const T* qt = static_cast<const T*>(q);
  const T* kt = static_cast<const T*>(k);
  const T* vt = static_cast<const T*>(v);
  const T* dot = static_cast<const T*>(dout);
  flash_bwd_dq_kernel<T, D><<<dim3((Sq + kB - 1) / kB, Hq, B), kThreads, dq_smem_bytes<D>(),
                               stream>>>(qt, kt, vt, static_cast<const T*>(o), dot,
                                         static_cast<T*>(dq), lse, delta, st, Hq, Sq, Skv, G,
                                         causal, window, offset, scale);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  flash_bwd_dkdv_kernel<T, D><<<dim3((Skv + kB - 1) / kB, Hkv, B), kThreads,
                                 dkdv_smem_bytes<D>(), stream>>>(
      qt, kt, vt, dot, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv), st, Hq, Sq, Skv,
      G, causal, window, offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, const void* o,
                       const void* dout, void* dq, void* dk, void* dv, float* lse,
                       float* delta, const Strides& st, int B, int Hq, int Hkv, int Sq,
                       int Skv, int causal, int window, int offset, float scale,
                       cudaStream_t s) {
#define REPRO_BWD(DD)                                                                      \
  return launch<T, DD>(q, k, v, o, dout, dq, dk, dv, lse, delta, st, B, Hq, Hkv, Sq, Skv, \
                       causal, window, offset, scale, s)
  switch (D) {
    case 16: REPRO_BWD(16);
    case 20: REPRO_BWD(20);
    case 24: REPRO_BWD(24);
    case 32: REPRO_BWD(32);
    case 64: REPRO_BWD(64);
    case 80: REPRO_BWD(80);
    case 128: REPRO_BWD(128);
    case 192: REPRO_BWD(192);
    default: return cudaErrorInvalidValue;
  }
#undef REPRO_BWD
}

}  // namespace

// strides: 24 int64 element strides, (batch, head, sequence) of q, k, v, o,
// dout, dq, dk, dv in that order; the last dim of each is contiguous. lse
// and delta: (B, Hq, Sq) float32 workspaces. window < 0 means no sliding
// window. dtype: float32 only (bf16 has flash_attention_bwd_wgmma). Returns
// a cudaError_t code.
extern "C" int flash_attention_bwd(const void* q, const void* k, const void* v, const void* o,
                                   const void* dout, void* dq, void* dk, void* dv, void* lse,
                                   void* delta, const long long* strides, int B, int Hq,
                                   int Hkv, int Sq, int Skv, int D, int causal, int window,
                                   int offset, float scale, int dtype, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || Sq <= 0 ||
      Skv <= 0 || offset < 0)
    return cudaErrorInvalidValue;
  Strides st;
  for (int t = 0; t < kTensors; ++t)
    for (int i = 0; i < 3; ++i) st.s[t][i] = strides[3 * t + i];
  float* l = static_cast<float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype != repro::kFloat32) return cudaErrorInvalidValue;
  return dispatch_d<float>(D, q, k, v, o, dout, dq, dk, dv, l, dl, st, B, Hq, Hkv, Sq, Skv,
                           causal, window, offset, scale, s);
}
