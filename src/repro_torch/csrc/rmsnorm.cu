// Fused RMSNorm for Hopper (sm_90a): y = x * rsqrt(mean(x^2) + eps) * scale.
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas (_kernel).
//
// Bound on an H100 SXM: memory. Each element of x is read once and each
// element of y written once, so the least time is 2 * rows * d * bytes /
// 3.35 TB/s (scale, d floats, is negligible). The arithmetic is ~3 flops per
// element, three orders of magnitude below the tensor-core ridge.
//
// Design: enough bytes in flight to cover the memory latency, and little
// else between the loads and the stores.
//   - Rows of up to 256 16-byte vectors (d <= 2048 in bf16, 1024 in
//     float32: smollm-360M's 960, xLSTM's 768 and 1536) take one warp per
//     row, eight rows to a block of 256 threads. Each lane holds NV vectors
//     (lane, lane + 32, ...) in registers; the sum of squares is reduced
//     with warp shuffles alone: no shared memory, no barrier.
//   - Longer rows (Jamba's 8192) take a block of 256 threads per row, each
//     thread holding NV (2, 4 or 8: 4 in bf16, 8 in float32 at d 8192)
//     vectors, with one barrier across the 8 warps per row (partial sums
//     in a double-buffered shared array, so a row needs no second
//     barrier).
//   - Both walk rows persistently: a grid of at most (resident blocks per
//     SM) x (SMs) blocks, each warp or block taking rows with a stride of
//     the grid, and the rows shared out evenly. A thread loads the slice of
//     `scale` it needs once, with 16-byte loads, and keeps it in registers
//     across its rows, and it issues the loads of its next row before the
//     reduction and stores of the current one.
//   - Widths that are not a multiple of the vector width, or pointers that
//     are not 16-byte aligned, take the scalar path: one block per row.
// The arithmetic is that of rmsnorm_ref: the float32 sum of squares,
// x * rsqrt(sum / d + eps) * scale in float32, one rounding to x's dtype.
// d may be up to 8192.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kMaxD = 8192;
constexpr int kThreads = 256;               // both vector paths
constexpr int kWarps = kThreads / 32;
constexpr int kMaxThreadsScalar = 1024;

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
};

// scale[idx * VEC, (idx + 1) * VEC) as VEC / 4 float4 loads, or zeros
template <int VEC>
__device__ __forceinline__ void load_scale(const float* __restrict__ scale, int idx,
                                           bool in, float (&s)[VEC]) {
#pragma unroll
  for (int i = 0; i < VEC / 4; ++i) {
    const float4 f = in ? __ldg(reinterpret_cast<const float4*>(scale) + idx * (VEC / 4) + i)
                        : make_float4(0.f, 0.f, 0.f, 0.f);
    s[4 * i] = f.x;
    s[4 * i + 1] = f.y;
    s[4 * i + 2] = f.z;
    s[4 * i + 3] = f.w;
  }
}

template <int NV, int STRIDE>
__device__ __forceinline__ void load_row(const uint4* __restrict__ xr, int first, int n_vec,
                                         uint4 (&raw)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = first + i * STRIDE;
    raw[i] = idx < n_vec ? __ldg(xr + idx) : make_uint4(0, 0, 0, 0);
  }
}

template <typename T, int NV>
__device__ __forceinline__ float sum_squares(const uint4 (&raw)[NV]) {
  constexpr int VEC = Vec<T>::N;
  float ss = 0.f;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const T* e = reinterpret_cast<const T*>(&raw[i]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      const float f = to_float<T>(e[j]);
      ss = fmaf(f, f, ss);
    }
  }
  return ss;
}

template <typename T, int NV, int STRIDE>
__device__ __forceinline__ void store_row(const uint4 (&raw)[NV],
                                          const float (&s)[NV][Vec<T>::N], float r,
                                          uint4* __restrict__ yr, int first, int n_vec) {
  constexpr int VEC = Vec<T>::N;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = first + i * STRIDE;
    if (idx < n_vec) {
      const T* e = reinterpret_cast<const T*>(&raw[i]);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) oe[j] = from_float<T>(to_float<T>(e[j]) * r * s[i][j]);
      yr[idx] = out;
    }
  }
}

// One warp per row; lane holds vectors lane, lane + 32, ... (NV of them).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                    T* __restrict__ y, int rows, int d, float eps) {
  constexpr int VEC = Vec<T>::N;
  const int n_vec = d / VEC;
  const int lane = threadIdx.x & 31;
  const int n_w = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + (threadIdx.x >> 5);
  float s[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i) load_scale<VEC>(scale, lane + 32 * i, lane + 32 * i < n_vec, s[i]);
  // a row past the end loads nothing (n_vec 0) and reads as zeros
  uint4 cur[NV];
  load_row<NV, 32>(reinterpret_cast<const uint4*>(x + (size_t)row * d), lane,
                      row < rows ? n_vec : 0, cur);
  for (; row < rows; row += n_w) {
    uint4 nxt[NV];
    load_row<NV, 32>(reinterpret_cast<const uint4*>(x + (size_t)(row + n_w) * d), lane,
                        row + n_w < rows ? n_vec : 0, nxt);
    const float r = rsqrtf(repro::warp_sum(sum_squares<T, NV>(cur)) / d + eps);
    store_row<T, NV, 32>(cur, s, r, reinterpret_cast<uint4*>(y + (size_t)row * d), lane, n_vec);
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

// One block of kThreads per row; thread t holds vectors t, t + kThreads, ...
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads)
rmsnorm_block_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                     T* __restrict__ y, int rows, int d, float eps) {
  constexpr int VEC = Vec<T>::N;
  __shared__ float red[2][kWarps];
  const int n_vec = d / VEC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float s[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
    load_scale<VEC>(scale, tid + kThreads * i, tid + kThreads * i < n_vec, s[i]);
  const int stride = gridDim.x;
  int row = blockIdx.x, parity = 0;
  uint4 cur[NV];
  load_row<NV, kThreads>(reinterpret_cast<const uint4*>(x + (size_t)row * d), tid,
                            row < rows ? n_vec : 0, cur);
  for (; row < rows; row += stride, parity ^= 1) {
    uint4 nxt[NV];
    load_row<NV, kThreads>(reinterpret_cast<const uint4*>(x + (size_t)(row + stride) * d),
                              tid, row + stride < rows ? n_vec : 0, nxt);
    const float part = repro::warp_sum(sum_squares<T, NV>(cur));
    if (lane == 0) red[parity][warp] = part;
    __syncthreads();
    float ss = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) ss += red[parity][w];
    const float r = rsqrtf(ss / d + eps);
    store_row<T, NV, kThreads>(cur, s, r, reinterpret_cast<uint4*>(y + (size_t)row * d), tid,
                               n_vec);
#pragma unroll
    for (int i = 0; i < NV; ++i) cur[i] = nxt[i];
  }
}

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

// Scalar path for widths that are not a multiple of the vector width or
// pointers that are not 16-byte aligned: one block per row.
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

int sm_count() {
  static int cache[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess) return 1;
  if (dev < 64 && cache[dev] > 0) return cache[dev];
  int n = 1;
  cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
  if (dev < 64) cache[dev] = n;
  return n;
}

// Blocks for `items` rows at `per_block` rows per pass: all of them when they
// fit on the card at once (`cap` blocks), else `cap` at most, with the rows
// shared out evenly (every block takes the same number of passes, bar the
// last).
int grid_for(int items, int per_block, int cap) {
  const int needed = (items + per_block - 1) / per_block;
  if (needed <= cap) return needed;
  const int passes = (needed + cap - 1) / cap;
  return (needed + passes - 1) / passes;
}

// Launch a vector-path instance on a persistent grid. Its resident blocks
// per SM are asked once per instance.
template <typename T, int NV, bool kWarpPerRow>
void launch_vec(const T* x, const float* scale, T* y, int rows, int d, float eps,
                cudaStream_t stream) {
  static const int per_sm = [] {
    int n = 0;
    if constexpr (kWarpPerRow)
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rmsnorm_warp_kernel<T, NV>, kThreads, 0);
    else
      cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, rmsnorm_block_kernel<T, NV>, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  const int grid = grid_for(rows, kWarpPerRow ? kWarps : 1, per_sm * sm_count());
  if constexpr (kWarpPerRow)
    rmsnorm_warp_kernel<T, NV><<<grid, kThreads, 0, stream>>>(x, scale, y, rows, d, eps);
  else
    rmsnorm_block_kernel<T, NV><<<grid, kThreads, 0, stream>>>(x, scale, y, rows, d, eps);
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, void* y, int rows, int d,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  const T* xt = static_cast<const T*>(x);
  T* yt = static_cast<T*>(y);
  const bool aligned = ((reinterpret_cast<uintptr_t>(x) | reinterpret_cast<uintptr_t>(y) |
                         reinterpret_cast<uintptr_t>(scale)) % 16) == 0;
  if (d % VEC == 0 && aligned) {
    const int n_vec = d / VEC;
    if (n_vec <= 32 * 8) {        // a warp per row, up to 8 vectors a lane
      const int per_lane = (n_vec + 31) / 32;
      if (per_lane <= 2) launch_vec<T, 2, true>(xt, scale, yt, rows, d, eps, stream);
      else if (per_lane <= 4) launch_vec<T, 4, true>(xt, scale, yt, rows, d, eps, stream);
      else launch_vec<T, 8, true>(xt, scale, yt, rows, d, eps, stream);
    } else {                      // a block per row: d <= 8192 gives <= 8 a thread
      const int per_thread = (n_vec + kThreads - 1) / kThreads;
      if (per_thread <= 2) launch_vec<T, 2, false>(xt, scale, yt, rows, d, eps, stream);
      else if (per_thread <= 4) launch_vec<T, 4, false>(xt, scale, yt, rows, d, eps, stream);
      else launch_vec<T, 8, false>(xt, scale, yt, rows, d, eps, stream);
    }
  } else {
    const int threads = round_up_warp(d < kMaxThreadsScalar ? d : kMaxThreadsScalar);
    rmsnorm_scalar_kernel<T, kMaxD / kMaxThreadsScalar><<<rows, threads, 0, stream>>>(
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
