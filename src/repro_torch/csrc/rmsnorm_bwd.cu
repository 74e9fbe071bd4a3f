// RMSNorm backward for Hopper (sm_90a): the gradients of
// y = x * r * scale, r = rsqrt(mean(x^2) + eps), over rows of d:
//   dx = r * (scale * dy - x * r^2 * mean(scale * dy * x))   (x's dtype)
//   dscale = sum over rows of dy * x * r                      (float32)
//
// Replaces: src/repro/kernels/rmsnorm.py, rmsnorm_pallas (_kernel), whose
// gradient the reference takes by differentiating rmsnorm_ref with JAX (the
// Pallas kernel has no backward); this is that gradient as a kernel.
//
// Bound on an H100 SXM: memory. x and dy are read once and dx written once,
// so the least time is 3 * rows * d * bytes / 3.35 TB/s (scale, dscale and
// the partial sums are d floats a block, small beside it); ~10 flops per
// element, far below the ridge.
//
// Design: two launches, deterministic, no atomics.
//   1. rmsnorm_bwd_rows_kernel: a block of 256 threads per contiguous chunk
//      of rows (the grid, about two blocks per SM, is fixed by the host from
//      the row count and the SM count). Thread t holds columns t, t + 256,
//      ... (ITEMS of them, d <= 8192) of scale and of its running dscale sum
//      in registers. Per row it loads x and dy (coalesced, element by
//      element, so any d works), reduces sum(x^2) and sum(scale*dy*x) over
//      the block with warp shuffles and one barrier (a double-buffered
//      shared array, as the forward), writes dx and adds dy * x * r to its
//      dscale sums. At the end each block writes its partial dscale row
//      into a workspace of (blocks, d) floats.
//   2. rmsnorm_bwd_scale_kernel: one thread per column sums the blocks'
//      partial rows in block order.
// The order of every sum is fixed by the shapes and the SM count, so two
// calls give the same bits.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kMaxD = 8192;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <typename T, int ITEMS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_rows_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, int rows, int d, int rows_per_block,
                        float eps) {
  __shared__ float red[2][kWarps][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float s[ITEMS], acc[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int c = tid + i * kThreads;
    s[i] = c < d ? scale[c] : 0.f;
    acc[i] = 0.f;
  }
  const int r0 = blockIdx.x * rows_per_block;
  const int r1 = min(rows, r0 + rows_per_block);
  int parity = 0;
  for (int row = r0; row < r1; ++row, parity ^= 1) {
    const T* xr = x + (size_t)row * d;
    const T* gr = dy + (size_t)row * d;
    float xv[ITEMS], gv[ITEMS];
    float ss = 0.f, dot = 0.f;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int c = tid + i * kThreads;
      xv[i] = c < d ? to_float<T>(xr[c]) : 0.f;
      gv[i] = c < d ? to_float<T>(gr[c]) : 0.f;
      ss = fmaf(xv[i], xv[i], ss);
      dot = fmaf(gv[i] * s[i], xv[i], dot);
    }
    ss = repro::warp_sum(ss);
    dot = repro::warp_sum(dot);
    if (lane == 0) {
      red[parity][warp][0] = ss;
      red[parity][warp][1] = dot;
    }
    __syncthreads();
    float tss = 0.f, tdot = 0.f;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      tss += red[parity][w][0];
      tdot += red[parity][w][1];
    }
    const float r = rsqrtf(tss / d + eps);
    const float k = r * r * (tdot / d);
    T* dxr = dx + (size_t)row * d;
#pragma unroll
    for (int i = 0; i < ITEMS; ++i) {
      const int c = tid + i * kThreads;
      if (c < d) {
        dxr[c] = from_float<T>(r * (gv[i] * s[i] - xv[i] * k));
        acc[i] = fmaf(gv[i] * xv[i], r, acc[i]);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int c = tid + i * kThreads;
    if (c < d) partial[(size_t)blockIdx.x * d + c] = acc[i];
  }
}

__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_scale_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                         int blocks, int d) {
  const int c = blockIdx.x * kThreads + threadIdx.x;
  if (c >= d) return;
  float sum = 0.f;
  for (int b = 0; b < blocks; ++b) sum += partial[(size_t)b * d + c];
  dscale[c] = sum;
}

template <typename T, int ITEMS>
cudaError_t launch_rows(const void* x, const float* scale, const void* dy, void* dx,
                        float* partial, int rows, int d, int rows_per_block, int blocks,
                        float eps, cudaStream_t stream) {
  rmsnorm_bwd_rows_kernel<T, ITEMS><<<blocks, kThreads, 0, stream>>>(
      static_cast<const T*>(x), scale, static_cast<const T*>(dy), static_cast<T*>(dx), partial,
      rows, d, rows_per_block, eps);
  return cudaGetLastError();
}

template <typename T>
cudaError_t launch(const void* x, const float* scale, const void* dy, void* dx,
                   float* partial, float* dscale, int rows, int d, int rows_per_block,
                   int blocks, float eps, cudaStream_t stream) {
  const int items = (d + kThreads - 1) / kThreads;
  cudaError_t err;
  if (items <= 4)
    err = launch_rows<T, 4>(x, scale, dy, dx, partial, rows, d, rows_per_block, blocks, eps, stream);
  else if (items <= 8)
    err = launch_rows<T, 8>(x, scale, dy, dx, partial, rows, d, rows_per_block, blocks, eps, stream);
  else if (items <= 16)
    err = launch_rows<T, 16>(x, scale, dy, dx, partial, rows, d, rows_per_block, blocks, eps, stream);
  else
    err = launch_rows<T, 32>(x, scale, dy, dx, partial, rows, d, rows_per_block, blocks, eps, stream);
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_scale_kernel<<<(d + kThreads - 1) / kThreads, kThreads, 0, stream>>>(
      partial, dscale, blocks, d);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, d) contiguous in the dtype's storage type; scale,
// dscale: (d,) float32; partial: (blocks, d) float32 workspace, where block b
// takes rows [b * rows_per_block, (b + 1) * rows_per_block) and every block
// has at least one row. Returns a cudaError_t code.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* partial, void* dscale, int rows, int d, int rows_per_block,
                           int blocks, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD || rows_per_block <= 0 || blocks <= 0 ||
      (long long)(blocks - 1) * rows_per_block >= rows ||
      (long long)blocks * rows_per_block < rows)
    return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  float* ws = static_cast<float*>(partial);
  float* ds = static_cast<float*>(dscale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch<float>(x, s, dy, dx, ws, ds, rows, d, rows_per_block, blocks, eps, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, s, dy, dx, ws, ds, rows, d, rows_per_block, blocks, eps,
                                 st);
  return cudaErrorInvalidValue;
}
