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
// Design (that of the forward, csrc/rmsnorm.cu): enough bytes in flight to
// cover the memory latency, no barrier per row, and a parallel second pass.
// Two launches, deterministic, no atomics.
//   1. The rows. Rows of up to 256 16-byte vectors (d <= 2048 in bf16, 1024
//      in float32: smollm-360M's 960, xLSTM's 768 and 1536) take one warp
//      per row, eight rows to a block of 256 threads: lane l holds vectors
//      l, l + 32, ... (NV of them) of x and dy in registers, 16-byte loads;
//      sum(x^2) and sum(scale * dy * x) are reduced with warp shuffles
//      alone, and the loads of the warp's next row are issued before the
//      current row's reduction. Longer rows (Jamba's 8192) take a block per
//      row, with one barrier across its 8 warps per row (a double-buffered
//      shared array). Both walk rows persistently: a grid of at most
//      (blocks per SM) x (SMs), each warp or block taking rows with a stride
//      of the grid. `scale` is staged in shared memory once per block. Each
//      thread keeps the dscale sums of its own columns in registers across
//      its rows; at the end the block's warps combine theirs in shared
//      memory in a fixed order (warp w + warp w + 4, then the four in
//      order) and the block writes one partial row of d floats.
//      Widths that are not a multiple of the vector width, or pointers that
//      are not 16-byte aligned, take the scalar path: a block per row,
//      element loads, the same partial rows.
//   2. rmsnorm_bwd_dscale_kernel sums the blocks' partial rows, parallel
//      over columns and block groups: a block of 1024 threads per 32
//      columns, warp w summing partial rows w, w + 32, ... of its lane's
//      column in order, then one warp summing the 32 warps' sums in order.
// The grid is fixed by the shape and the card, so every sum runs in the
// same order and two calls give the same bits.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kMaxD = 8192;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kSumThreads = 1024;   // second launch: 32 columns x 32 block groups

template <typename T>
struct Vec {
  static constexpr int N = 16 / sizeof(T);  // elements per 16-byte vector
};

// Resident blocks per SM that an instance is built for: two when a thread's
// registers (x and dy of this row and the next, its dscale sums: NV * (16 +
// VEC) words) leave room for them under 128, else one.
template <typename T, int NV>
struct Plan {
  static constexpr int kBlocksPerSM = NV * (16 + Vec<T>::N) <= 100 ? 2 : 1;
};

template <int NV, int STRIDE>
__device__ __forceinline__ void load_row(const uint4* __restrict__ r, int first, int n_vec,
                                         uint4 (&raw)[NV]) {
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = first + i * STRIDE;
    raw[i] = idx < n_vec ? __ldg(r + idx) : make_uint4(0, 0, 0, 0);
  }
}

// scale[idx * VEC, (idx + 1) * VEC) from shared memory
template <int VEC>
__device__ __forceinline__ void scale_vec(const float* s_sh, int idx, float (&s)[VEC]) {
#pragma unroll
  for (int q = 0; q < VEC / 4; ++q) {
    const float4 f = reinterpret_cast<const float4*>(s_sh)[idx * (VEC / 4) + q];
    s[4 * q] = f.x;
    s[4 * q + 1] = f.y;
    s[4 * q + 2] = f.z;
    s[4 * q + 3] = f.w;
  }
}

// This thread's part of sum(x^2) and sum(scale * dy * x) over vectors
// first, first + STRIDE, ... (zeros past the row's end add nothing).
template <typename T, int NV, int STRIDE>
__device__ __forceinline__ void row_sums(const uint4 (&xr)[NV], const uint4 (&gr)[NV],
                                         const float* s_sh, int first, int n_vec, float& ss,
                                         float& dot) {
  constexpr int VEC = Vec<T>::N;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = first + i * STRIDE;
    if (idx < n_vec) {
      float s[VEC];
      scale_vec<VEC>(s_sh, idx, s);
      const T* xe = reinterpret_cast<const T*>(&xr[i]);
      const T* ge = reinterpret_cast<const T*>(&gr[i]);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_float<T>(xe[j]), gf = to_float<T>(ge[j]);
        ss = fmaf(xf, xf, ss);
        dot = fmaf(gf * s[j], xf, dot);
      }
    }
  }
}

// dx of this thread's vectors of the row, stored; dy * x * r added to its
// dscale sums.
template <typename T, int NV, int STRIDE>
__device__ __forceinline__ void row_out(const uint4 (&xr)[NV], const uint4 (&gr)[NV],
                                        const float* s_sh, int first, int n_vec, float r,
                                        float k, uint4* __restrict__ dxr,
                                        float (&acc)[NV][Vec<T>::N]) {
  constexpr int VEC = Vec<T>::N;
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = first + i * STRIDE;
    if (idx < n_vec) {
      float s[VEC];
      scale_vec<VEC>(s_sh, idx, s);
      const T* xe = reinterpret_cast<const T*>(&xr[i]);
      const T* ge = reinterpret_cast<const T*>(&gr[i]);
      uint4 out;
      T* oe = reinterpret_cast<T*>(&out);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float xf = to_float<T>(xe[j]), gf = to_float<T>(ge[j]);
        oe[j] = from_float<T>(r * (gf * s[j] - xf * k));
        acc[i][j] = fmaf(gf * xf, r, acc[i][j]);
      }
      dxr[idx] = out;
    }
  }
}

__device__ __forceinline__ void stage_scale(const float* __restrict__ scale, float* s_sh, int d) {
  for (int i = threadIdx.x; i < d / 4; i += blockDim.x)
    reinterpret_cast<float4*>(s_sh)[i] = __ldg(reinterpret_cast<const float4*>(scale) + i);
  __syncthreads();
}

// One warp per row. Shared memory: scale (d floats), then 4 x d floats for
// the combine of the warps' dscale sums.
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, (Plan<T, NV>::kBlocksPerSM))
rmsnorm_bwd_warp_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                        const T* __restrict__ dy, T* __restrict__ dx,
                        float* __restrict__ partial, int rows, int d, float eps) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float4 smem4[];
  float* s_sh = reinterpret_cast<float*>(smem4);
  float* red = s_sh + d;
  const int n_vec = d / VEC;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  stage_scale(scale, s_sh, d);
  float acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
  const int n_w = gridDim.x * kWarps;
  int row = blockIdx.x * kWarps + warp;
  // a row past the end loads nothing (n_vec 0) and reads as zeros
  uint4 cx[NV], cg[NV];
  load_row<NV, 32>(reinterpret_cast<const uint4*>(x + (size_t)row * d), lane,
                   row < rows ? n_vec : 0, cx);
  load_row<NV, 32>(reinterpret_cast<const uint4*>(dy + (size_t)row * d), lane,
                   row < rows ? n_vec : 0, cg);
  for (; row < rows; row += n_w) {
    const int nrow = row + n_w;
    uint4 nx[NV], ng[NV];
    load_row<NV, 32>(reinterpret_cast<const uint4*>(x + (size_t)nrow * d), lane,
                     nrow < rows ? n_vec : 0, nx);
    load_row<NV, 32>(reinterpret_cast<const uint4*>(dy + (size_t)nrow * d), lane,
                     nrow < rows ? n_vec : 0, ng);
    float ss = 0.f, dot = 0.f;
    row_sums<T, NV, 32>(cx, cg, s_sh, lane, n_vec, ss, dot);
    ss = repro::warp_sum(ss);
    dot = repro::warp_sum(dot);
    const float r = rsqrtf(ss / d + eps);
    const float k = r * r * (dot / d);
    row_out<T, NV, 32>(cx, cg, s_sh, lane, n_vec, r, k,
                       reinterpret_cast<uint4*>(dx + (size_t)row * d), acc);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      cx[i] = nx[i];
      cg[i] = ng[i];
    }
  }
  // combine the 8 warps' sums: warps 4-7 write, warps 0-3 add theirs, then
  // each column is the sum of the 4 slots in order
  float* mine = red + (warp & 3) * d;
#pragma unroll
  for (int pass = 0; pass < 2; ++pass) {
    if ((warp >> 2) == 1 - pass) {
#pragma unroll
      for (int i = 0; i < NV; ++i) {
        const int idx = lane + 32 * i;
        if (idx < n_vec) {
#pragma unroll
          for (int q = 0; q < VEC / 4; ++q) {
            float4* slot = reinterpret_cast<float4*>(mine) + idx * (VEC / 4) + q;
            float4 a = make_float4(acc[i][4 * q], acc[i][4 * q + 1], acc[i][4 * q + 2],
                                   acc[i][4 * q + 3]);
            if (pass == 1) {
              const float4 b = *slot;
              a = make_float4(b.x + a.x, b.y + a.y, b.z + a.z, b.w + a.w);
            }
            *slot = a;
          }
        }
      }
    }
    __syncthreads();
  }
  const float4* red4 = reinterpret_cast<const float4*>(red);
  float4* out4 = reinterpret_cast<float4*>(partial + (size_t)blockIdx.x * d);
  const int d4 = d / 4;
  for (int c = threadIdx.x; c < d4; c += kThreads) {
    float4 t = red4[c];
#pragma unroll
    for (int w = 1; w < 4; ++w) {
      const float4 b = red4[w * d4 + c];
      t = make_float4(t.x + b.x, t.y + b.y, t.z + b.z, t.w + b.w);
    }
    out4[c] = t;
  }
}

// One block of kThreads per row; thread t holds vectors t, t + kThreads, ...
// Shared memory: scale (d floats).
template <typename T, int NV>
__global__ void __launch_bounds__(kThreads, (Plan<T, NV>::kBlocksPerSM))
rmsnorm_bwd_block_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                         const T* __restrict__ dy, T* __restrict__ dx,
                         float* __restrict__ partial, int rows, int d, float eps) {
  constexpr int VEC = Vec<T>::N;
  extern __shared__ float4 smem4[];
  float* s_sh = reinterpret_cast<float*>(smem4);
  __shared__ float red[2][kWarps][2];
  const int n_vec = d / VEC;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  stage_scale(scale, s_sh, d);
  float acc[NV][VEC];
#pragma unroll
  for (int i = 0; i < NV; ++i)
#pragma unroll
    for (int j = 0; j < VEC; ++j) acc[i][j] = 0.f;
  const int stride = gridDim.x;
  int row = blockIdx.x, parity = 0;
  uint4 cx[NV], cg[NV];
  load_row<NV, kThreads>(reinterpret_cast<const uint4*>(x + (size_t)row * d), tid,
                         row < rows ? n_vec : 0, cx);
  load_row<NV, kThreads>(reinterpret_cast<const uint4*>(dy + (size_t)row * d), tid,
                         row < rows ? n_vec : 0, cg);
  for (; row < rows; row += stride, parity ^= 1) {
    const int nrow = row + stride;
    uint4 nx[NV], ng[NV];
    load_row<NV, kThreads>(reinterpret_cast<const uint4*>(x + (size_t)nrow * d), tid,
                           nrow < rows ? n_vec : 0, nx);
    load_row<NV, kThreads>(reinterpret_cast<const uint4*>(dy + (size_t)nrow * d), tid,
                           nrow < rows ? n_vec : 0, ng);
    float ss = 0.f, dot = 0.f;
    row_sums<T, NV, kThreads>(cx, cg, s_sh, tid, n_vec, ss, dot);
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
    row_out<T, NV, kThreads>(cx, cg, s_sh, tid, n_vec, r, k,
                             reinterpret_cast<uint4*>(dx + (size_t)row * d), acc);
#pragma unroll
    for (int i = 0; i < NV; ++i) {
      cx[i] = nx[i];
      cg[i] = ng[i];
    }
  }
  // the thread's columns are its own: its sums are the block's
  float4* out4 = reinterpret_cast<float4*>(partial + (size_t)blockIdx.x * d);
#pragma unroll
  for (int i = 0; i < NV; ++i) {
    const int idx = tid + kThreads * i;
    if (idx < n_vec) {
#pragma unroll
      for (int q = 0; q < VEC / 4; ++q)
        out4[idx * (VEC / 4) + q] = make_float4(acc[i][4 * q], acc[i][4 * q + 1],
                                                acc[i][4 * q + 2], acc[i][4 * q + 3]);
    }
  }
}

// Scalar path: a block of kThreads per row, rows with a stride of the grid;
// thread t holds columns t, t + kThreads, ... (ITEMS of them).
template <typename T, int ITEMS>
__global__ void __launch_bounds__(kThreads)
rmsnorm_bwd_scalar_kernel(const T* __restrict__ x, const float* __restrict__ scale,
                          const T* __restrict__ dy, T* __restrict__ dx,
                          float* __restrict__ partial, int rows, int d, float eps) {
  __shared__ float red[2][kWarps][2];
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  float s[ITEMS], acc[ITEMS];
#pragma unroll
  for (int i = 0; i < ITEMS; ++i) {
    const int c = tid + i * kThreads;
    s[i] = c < d ? scale[c] : 0.f;
    acc[i] = 0.f;
  }
  int parity = 0;
  for (int row = blockIdx.x; row < rows; row += gridDim.x, parity ^= 1) {
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

__global__ void __launch_bounds__(kSumThreads)
rmsnorm_bwd_dscale_kernel(const float* __restrict__ partial, float* __restrict__ dscale,
                          int blocks, int d) {
  __shared__ float red[kSumThreads / 32][33];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = blockIdx.x * 32 + lane;
  float sum = 0.f;
  if (c < d) {
#pragma unroll 4
    for (int b = warp; b < blocks; b += kSumThreads / 32) sum += partial[(size_t)b * d + c];
  }
  red[warp][lane] = sum;
  __syncthreads();
  if (warp == 0 && c < d) {
    float t = 0.f;
#pragma unroll
    for (int w = 0; w < kSumThreads / 32; ++w) t += red[w][lane];
    dscale[c] = t;
  }
}

template <typename T, int NV, bool kWarpPerRow>
int launch_vec(const T* x, const float* scale, const T* dy, T* dx, float* partial, int rows,
               int d, int max_blocks, int n_sm, float eps, cudaStream_t stream) {
  const int per_pass = kWarpPerRow ? kWarps : 1;
  int blocks = (rows + per_pass - 1) / per_pass;
  blocks = min(blocks, min(max_blocks, Plan<T, NV>::kBlocksPerSM * n_sm));
  const size_t smem = (kWarpPerRow ? 5 : 1) * (size_t)d * sizeof(float);
  if constexpr (kWarpPerRow)
    rmsnorm_bwd_warp_kernel<T, NV><<<blocks, kThreads, smem, stream>>>(x, scale, dy, dx,
                                                                       partial, rows, d, eps);
  else
    rmsnorm_bwd_block_kernel<T, NV><<<blocks, kThreads, smem, stream>>>(x, scale, dy, dx,
                                                                        partial, rows, d, eps);
  return blocks;
}

template <typename T, int ITEMS>
int launch_scalar(const T* x, const float* scale, const T* dy, T* dx, float* partial,
                  int rows, int d, int max_blocks, int n_sm, float eps, cudaStream_t stream) {
  const int blocks = min(rows, min(max_blocks, 2 * n_sm));
  rmsnorm_bwd_scalar_kernel<T, ITEMS><<<blocks, kThreads, 0, stream>>>(x, scale, dy, dx,
                                                                       partial, rows, d, eps);
  return blocks;
}

template <typename T>
cudaError_t launch(const void* xv, const float* scale, const void* dyv, void* dxv,
                   float* partial, float* dscale, int rows, int d, int max_blocks, int n_sm,
                   float eps, cudaStream_t stream) {
  constexpr int VEC = Vec<T>::N;
  const T* x = static_cast<const T*>(xv);
  const T* dy = static_cast<const T*>(dyv);
  T* dx = static_cast<T*>(dxv);
  const bool aligned = ((reinterpret_cast<uintptr_t>(xv) | reinterpret_cast<uintptr_t>(dyv) |
                         reinterpret_cast<uintptr_t>(dxv) | reinterpret_cast<uintptr_t>(scale)) %
                        16) == 0;
  int blocks;
  if (d % VEC == 0 && aligned) {
    const int n_vec = d / VEC;
    if (n_vec <= 32 * 8) {        // a warp per row, up to 8 vectors a lane
      const int per_lane = (n_vec + 31) / 32;
#define WARP_ROW(NV) launch_vec<T, NV, true>(x, scale, dy, dx, partial, rows, d, max_blocks, \
                                             n_sm, eps, stream)
      if (per_lane <= 1) blocks = WARP_ROW(1);
      else if (per_lane <= 2) blocks = WARP_ROW(2);
      else if (per_lane <= 3) blocks = WARP_ROW(3);
      else if (per_lane <= 4) blocks = WARP_ROW(4);
      else if (per_lane <= 6) blocks = WARP_ROW(6);
      else blocks = WARP_ROW(8);
#undef WARP_ROW
    } else {                      // a block per row: d <= 8192 gives <= 8 a thread
      const int per_thread = (n_vec + kThreads - 1) / kThreads;
#define BLOCK_ROW(NV) launch_vec<T, NV, false>(x, scale, dy, dx, partial, rows, d, max_blocks, \
                                               n_sm, eps, stream)
      if (per_thread <= 2) blocks = BLOCK_ROW(2);
      else if (per_thread <= 4) blocks = BLOCK_ROW(4);
      else blocks = BLOCK_ROW(8);
#undef BLOCK_ROW
    }
  } else {
    const int items = (d + kThreads - 1) / kThreads;
#define SCALAR(ITEMS) launch_scalar<T, ITEMS>(x, scale, dy, dx, partial, rows, d, max_blocks, \
                                              n_sm, eps, stream)
    if (items <= 4) blocks = SCALAR(4);
    else if (items <= 8) blocks = SCALAR(8);
    else if (items <= 16) blocks = SCALAR(16);
    else blocks = SCALAR(32);
#undef SCALAR
  }
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  rmsnorm_bwd_dscale_kernel<<<(d + 31) / 32, kSumThreads, 0, stream>>>(partial, dscale, blocks,
                                                                      d);
  return cudaGetLastError();
}

}  // namespace

// x, dy, dx: (rows, d) contiguous in the dtype's storage type; scale,
// dscale: (d,) float32; partial: (max_blocks, d) float32 workspace, of which
// the first launch writes one row per block it runs (at most max_blocks, and
// at most the blocks an instance keeps resident on n_sm SMs). Returns a
// cudaError_t code.
extern "C" int rmsnorm_bwd(const void* x, const void* scale, const void* dy, void* dx,
                           void* partial, void* dscale, int rows, int d, int max_blocks,
                           int n_sm, float eps, int dtype, void* stream) {
  if (rows <= 0 || d <= 0 || d > kMaxD || max_blocks <= 0 || n_sm <= 0)
    return cudaErrorInvalidValue;
  const float* s = static_cast<const float*>(scale);
  float* ws = static_cast<float*>(partial);
  float* ds = static_cast<float*>(dscale);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return launch<float>(x, s, dy, dx, ws, ds, rows, d, max_blocks, n_sm, eps, st);
  if (dtype == repro::kBFloat16)
    return launch<__nv_bfloat16>(x, s, dy, dx, ws, ds, rows, d, max_blocks, n_sm, eps, st);
  return cudaErrorInvalidValue;
}
