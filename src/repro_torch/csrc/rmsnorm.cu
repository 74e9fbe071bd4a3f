// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas (_kernel).
//
// Bound on an H100 SXM: memory. Each element of x is read once and each
// element of y written once, so the least time is 2 * rows * d * bytes /
// 3.35 TB/s (scale, d floats, is negligible). The arithmetic is ~3 flops per
// element, three orders of magnitude below the tensor-core ridge.
//
// Design: one block per row. Each thread loads its share of the row with
// 16-byte vector loads (8 bf16 or 4 float32 values) when d is a multiple of
// the vector width and the base pointers are 16-byte aligned, otherwise with
// scalar loads. The values stay in registers while the block reduces the
// float32 sum of squares (warp shuffles, then 32 partial sums in shared
// memory), so x crosses the memory bus once, as in the Pallas kernel. At
// d = 960 in bf16 that is 120 threads (rounded up to 128) x 8 elements.
// d may be up to 8192.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kMaxD = 8192;
constexpr int kMaxThreads = 1024;

// Sum over the block; every thread gets the total. blockDim.x is a multiple
// of 32.
__device__ __forceinline__ float block_sum(float v, float* red) {
  v = repro::warp_sum(v);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  if (lane == 0) red[warp] = v;
  __syncthreads();
  const int n_warps = blockDim.x >> 5;
  v = lane < n_warps ? red[lane] : 0.f;
  return repro::warp_sum(v);
}

// Vector path: each thread holds up to MAXV vectors of VEC elements.
template <typename T, int VEC, int MAXV>
__global__ void rmsnorm_vec_kernel(const T* __restrict__ x,
                                   const float* __restrict__ scale,
                                   T* __restrict__ y, int d, float eps) {
  __shared__ float red[32];
  const int n_vec = d / VEC;
  const size_t row = blockIdx.x;
  const uint4* xr = reinterpret_cast<const uint4*>(x + row * d);
  uint4* yr = reinterpret_cast<uint4*>(y + row * d);
  float v[MAXV][VEC];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < n_vec) {
      uint4 raw = xr[idx];
      const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        v[i][j] = to_float<T>(e[j]);
        ss += v[i][j] * v[i][j];
      }
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / d + eps);
#pragma unroll
  for (int i = 0; i < MAXV; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < n_vec) {
      uint4 raw;
      T* e = reinterpret_cast<T*>(&raw);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        e[j] = from_float<T>(v[i][j] * r * scale[idx * VEC + j]);
      yr[idx] = raw;
    }
  }
}

// Scalar path for widths that are not a multiple of the vector width.
template <typename T, int ITEMS>
__global__ void rmsnorm_scalar_kernel(const T* __restrict__ x,
                                      const float* __restrict__ scale,
                                      T* __restrict__ y, int d, float eps) {
  __shared__ float red[32];
  const size_t row = blockIdx.x;
  const T* xr = x + row * d;
  T* yr = y + row * d;
  float v[ITEMS];
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < d) {
      v[i] = to_float<T>(xr[idx]);
      ss += v[i] * v[i];
    }
  }
  const float r = rsqrtf(block_sum(ss, red) / d + eps);
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int idx = threadIdx.x + i * blockDim.x;
    if (idx < d) yr[idx] = from_float<T>(v[i] * r * scale[idx]);
  }
}

inline int round_up_warp(int n) { return (n + 31) / 32 * 32; }

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = 16 / sizeof(T);
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const bool aligned = (reinterpret_cast<uintptr_t>(x) % 16 == 0) &&
                       (reinterpret_cast<uintptr_t>(y) % 16 == 0);
  if (d % VEC == 0 && aligned) {
    // d <= 8192 gives at most 2048 float32 vectors: 2 per thread at 1024.
    const int n_vec = d / VEC;
    const int threads = round_up_warp(n_vec < kMaxThreads ? n_vec : kMaxThreads);
    rmsnorm_vec_kernel<T, VEC, 2><<<rows, threads, 0, stream>>>(xt, scale, yt, d, eps);
  } else {
    const int threads = round_up_warp(d < kMaxThreads ? d : kMaxThreads);
    rmsnorm_scalar_kernel<T, kMaxD / kMaxThreads><<<rows, threads, 0, stream>>>(
        xt, scale, yt, d, eps);
  }
  return cudaGetLastError();
}

}  // namespace

extern "C" int rmsnorm_fwd(const void* x, const void* scale, void* y, int rows,
                           int d, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD) return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32) return launch<float>(x, s, y, rows, d, eps, st);
  if (dtype == repro::kBFloat16) return launch<__nv_bfloat16>(x, s, y, rows, d, eps, st);
  return cudaErrorInvalidValue;
}
