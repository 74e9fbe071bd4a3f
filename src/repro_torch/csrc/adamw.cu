// Fused AdamW with the global-norm clip, for Hopper (sm_90a).
//
// Replaces: the reference's clip_by_global_norm followed by adamw().update
// (src/repro/optim/optimizers.py:28-32 and :62-69). The reference has no
// Pallas kernel for them: it leaves them to XLA, which fuses each leaf's
// elementwise update into one loop once the train step is jitted. A CUDA
// graph replays PyTorch's separate elementwise kernels as they are, so these
// kernels are the port's counterpart of that fusion.
//
// The function, in float32 as the reference computes it:
//   norm  = sqrt(sum over every leaf of sum(float(g)^2))
//   scale = min(1, max_norm / max(norm, 1e-9))
//   g     = float(to_dtype(float(g) * scale))    the clip's storage round trip
//   m     = b1 m + (1 - b1) g,  v = b2 v + (1 - b2) g g
//   u     = (m / c1) / (sqrt(v / c2) + eps), plus wd p on a leaf of ndim >= 2
//   p     = to_dtype(float(p) - lr u)             the storage dtype, in place
// Every step rounds as the plain version's separate tensor ops do (the
// _rn intrinsics keep nvcc from contracting a product and a sum into one
// FMA), so kernel and plain version agree bit for bit on the same scalars.
//
// Bound on an H100 SXM: memory. The update reads p, g, m, v and writes p, m,
// v once: 22 bytes a parameter in bf16 (28 in float32), ~20 flops; the norm
// reads g once more. Both are far below the ridge.
//
// Design:
//   - sumsq_kernel: one launch per leaf, a grid-stride pass of 256-thread
//     blocks over 16-byte vectors (four in flight a thread) and a scalar
//     tail; each block writes one float32 partial sum of squares into a
//     workspace at the leaf's offset. The grid is fixed by the leaf's size
//     and the SM count (the wrapper's sumsq_blocks), so is every sum's order.
//   - clip_finalize_kernel: one block of 1024 threads sums every partial, in
//     a fixed order (a strided serial sum per thread, then warp shuffles and
//     one warp over the warps' sums), and writes norm and scale to the
//     device: no atomics, so the same inputs give the same bits on every
//     call, graphed or eager.
//   - adamw_update_kernel: one launch per leaf, a grid-stride pass over
//     16-byte vectors of p and g (8 bf16 or 4 float32 elements, with the
//     matching 16-byte vectors of m and v), then a scalar tail. lr, the bias
//     corrections c1, c2 and the clip's scale are read through device
//     pointers, never passed as host floats: a CUDA graph would freeze a
//     host value at capture. A null scale skips the round trip.
//   - Pointers that are not 16-byte aligned take the scalar loop alone.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kThreads = 256;
constexpr int kSumUnroll = 4;          // 16-byte vectors in flight per thread
constexpr int kFinalThreads = 1024;

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
};

template <typename T>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[Vec<T>::N]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) f[j] = to_float<T>(e[j]);
}

template <typename T>
__device__ __forceinline__ uint4 pack(const float (&f)[Vec<T>::N]) {
  uint4 raw;
  T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
  for (int j = 0; j < Vec<T>::N; ++j) e[j] = from_float<T>(f[j]);
  return raw;
}

inline bool aligned16(const void* p) { return reinterpret_cast<uintptr_t>(p) % 16 == 0; }

// The sum of v over a block of THREADS threads, in thread 0: warp shuffles,
// then warp 0 over the warps' sums. The order is fixed.
template <int THREADS>
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = repro::warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  if (warp == 0) t = repro::warp_sum(lane < THREADS / 32 ? red[lane] : 0.f);
  return t;
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
sumsq_kernel(const T* __restrict__ g, long long n, float* __restrict__ partial, int vec) {
  constexpr int N = Vec<T>::N;
  __shared__ float red[kThreads / 32];
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  float ss = 0.f;
  long long done = 0;
  if (vec) {
    const long long n_vec = n / N;
    const uint4* gv = reinterpret_cast<const uint4*>(g);
    for (long long i = tid; i < n_vec; i += kSumUnroll * stride) {
      uint4 raw[kSumUnroll];
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        const long long idx = i + u * stride;
        raw[u] = idx < n_vec ? __ldg(gv + idx) : make_uint4(0, 0, 0, 0);
      }
#pragma unroll
      for (int u = 0; u < kSumUnroll; ++u) {
        float f[N];
        unpack<T>(raw[u], f);
#pragma unroll
        for (int j = 0; j < N; ++j) ss = fmaf(f[j], f[j], ss);
      }
    }
    done = n_vec * N;
  }
  for (long long i = done + tid; i < n; i += stride) {
    const float f = to_float<T>(g[i]);
    ss = fmaf(f, f, ss);
  }
  const float total = block_sum<kThreads>(ss, red);
  if (threadIdx.x == 0) partial[blockIdx.x] = total;
}

__global__ void __launch_bounds__(kFinalThreads)
clip_finalize_kernel(const float* __restrict__ partial, int n, float max_norm,
                     float* __restrict__ out) {
  __shared__ float red[kFinalThreads / 32];
  float s = 0.f;
  for (int i = threadIdx.x; i < n; i += kFinalThreads) s += partial[i];
  const float total = block_sum<kFinalThreads>(s, red);
  if (threadIdx.x == 0) {
    const float norm = __fsqrt_rn(total);
    // max(norm, 1e-9) and min(1, q), each passing a NaN on as the reference's
    const float den = norm < 1e-9f ? 1e-9f : norm;
    const float q = __fdiv_rn(max_norm, den);
    out[0] = norm;
    out[1] = q > 1.f ? 1.f : q;
  }
}

struct Hyper {
  float b1, ob1, b2, ob2, eps, wd;  // ob1 = 1 - b1, ob2 = 1 - b2 (rounded once)
};

// One element: g as stored (float), p, m, v updated in place (float).
template <typename T>
__device__ __forceinline__ void adamw_elem(float& p, float g, float& m, float& v, float lr,
                                           float c1, float c2, float s, bool clip,
                                           bool decay, const Hyper& h) {
  if (clip) g = to_float<T>(from_float<T>(__fmul_rn(g, s)));
  m = __fadd_rn(__fmul_rn(h.b1, m), __fmul_rn(h.ob1, g));
  v = __fadd_rn(__fmul_rn(h.b2, v), __fmul_rn(__fmul_rn(h.ob2, g), g));
  float u = __fdiv_rn(__fdiv_rn(m, c1), __fadd_rn(__fsqrt_rn(__fdiv_rn(v, c2)), h.eps));
  if (decay) u = __fadd_rn(u, __fmul_rn(h.wd, p));
  p = __fsub_rn(p, __fmul_rn(lr, u));
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
adamw_update_kernel(T* __restrict__ p, const T* __restrict__ g, float* __restrict__ m,
                    float* __restrict__ v, long long n, const float* __restrict__ lr_p,
                    const float* __restrict__ c1_p, const float* __restrict__ c2_p,
                    const float* __restrict__ scale_p, Hyper h, int decay, int vec) {
  constexpr int N = Vec<T>::N;
  constexpr int F4 = N / 4;  // float4 vectors of m and v per vector of p
  const float lr = *lr_p, c1 = *c1_p, c2 = *c2_p;
  const bool clip = scale_p != nullptr;
  const float s = clip ? *scale_p : 1.f;
  const long long stride = (long long)gridDim.x * kThreads;
  const long long tid = (long long)blockIdx.x * kThreads + threadIdx.x;
  long long done = 0;
  if (vec) {
    const long long n_vec = n / N;
    uint4* pv = reinterpret_cast<uint4*>(p);
    const uint4* gv = reinterpret_cast<const uint4*>(g);
    float4* mv = reinterpret_cast<float4*>(m);
    float4* vv = reinterpret_cast<float4*>(v);
    for (long long i = tid; i < n_vec; i += stride) {
      const uint4 praw = pv[i], graw = __ldg(gv + i);
      float4 m4[F4], v4[F4];
#pragma unroll
      for (int q = 0; q < F4; ++q) {
        m4[q] = mv[i * F4 + q];
        v4[q] = vv[i * F4 + q];
      }
      float pf[N], gf[N];
      unpack<T>(praw, pf);
      unpack<T>(graw, gf);
      float* mf = reinterpret_cast<float*>(m4);
      float* vf = reinterpret_cast<float*>(v4);
#pragma unroll
      for (int j = 0; j < N; ++j)
        adamw_elem<T>(pf[j], gf[j], mf[j], vf[j], lr, c1, c2, s, clip, decay, h);
      pv[i] = pack<T>(pf);
#pragma unroll
      for (int q = 0; q < F4; ++q) {
        mv[i * F4 + q] = m4[q];
        vv[i * F4 + q] = v4[q];
      }
    }
    done = n_vec * N;
  }
  for (long long i = done + tid; i < n; i += stride) {
    float pf = to_float<T>(p[i]), mf = m[i], vf = v[i];
    adamw_elem<T>(pf, to_float<T>(g[i]), mf, vf, lr, c1, c2, s, clip, decay, h);
    p[i] = from_float<T>(pf);
    m[i] = mf;
    v[i] = vf;
  }
}

template <typename T>
cudaError_t launch_sumsq(const void* g, long long n, float* partial, int blocks,
                         cudaStream_t stream) {
  sumsq_kernel<T><<<blocks, kThreads, 0, stream>>>(static_cast<const T*>(g), n, partial,
                                                   aligned16(g));
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch_update(void* p, const void* g, void* m, void* v, long long n,
                          const float* lr, const float* c1, const float* c2,
                          const float* scale, const Hyper& h, int decay, int blocks,
                          cudaStream_t stream) {
  const bool vec = aligned16(p) && aligned16(g) && aligned16(m) && aligned16(v);
  adamw_update_kernel<T><<<blocks, kThreads, 0, stream>>>(
      static_cast<T*>(p), static_cast<const T*>(g), static_cast<float*>(m),
      static_cast<float*>(v), n, lr, c1, c2, scale, h, decay, vec);
  return cudaGetLastError();
}

}  // namespace

// g: n contiguous elements of the dtype; partial: `blocks` floats, one per
// block, each block's sum of squares. Returns a cudaError_t code.
extern "C" int adamw_sumsq(const void* g, long long n, void* partial, int blocks, int dtype,
                           void* stream) {
  if (n <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  float* ws = static_cast<float*>(partial);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return launch_sumsq<float>(g, n, ws, blocks, st);
  if (dtype == repro::kBFloat16) return launch_sumsq<__nv_bfloat16>(g, n, ws, blocks, st);
  return cudaErrorInvalidValue;
}

// partial: n floats; out: 2 floats, norm and scale.
extern "C" int adamw_clip_finalize(const void* partial, int n, float max_norm, void* out,
                                   void* stream) {
  if (n <= 0) return cudaErrorInvalidValue;
  clip_finalize_kernel<<<1, kFinalThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(partial), n, max_norm, static_cast<float*>(out));
  return cudaGetLastError();
}

// p, g: n contiguous elements of the dtype; m, v: n float32; lr, c1, c2 and
// scale (or null: no clip) one float32 each on the device. Updates p, m, v in
// place.
extern "C" int adamw_update(void* p, const void* g, void* m, void* v, long long n,
                            const void* lr, const void* c1, const void* c2, const void* scale,
                            float b1, float ob1, float b2, float ob2, float eps, float wd,
                            int decay, int blocks, int dtype, void* stream) {
  if (n <= 0 || blocks <= 0) return cudaErrorInvalidValue;
  const Hyper h{b1, ob1, b2, ob2, eps, wd};
  const float* lr_f = static_cast<const float*>(lr);
  const float* c1_f = static_cast<const float*>(c1);
  const float* c2_f = static_cast<const float*>(c2);
  const float* s_f = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch_update<float>(p, g, m, v, n, lr_f, c1_f, c2_f, s_f, h, decay, blocks, st);
  if (dtype == repro::kBFloat16)
    return launch_update<__nv_bfloat16>(p, g, m, v, n, lr_f, c1_f, c2_f, s_f, h, decay,
                                        blocks, st);
  return cudaErrorInvalidValue;
}
