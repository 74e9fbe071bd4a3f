// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a KV cache, with GQA, a per-sequence valid length and an optional
// sliding window, split over the cache ("flash-decoding") in one launch.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (_kernel).
//
// Bound on an H100 SXM: memory, in name. The least time is the bytes of the
// K and V rows that the valid prefixes hold over 3.35 TB/s, but at the
// serving shapes that is under a microsecond (a cache of 129 slots holds
// 1.3 MB for smollm-360M, 4.2 MB for Jamba), so what a call costs is
// latency: the launch, a round trip to memory for the length and q, one for
// each step of K/V rows, and the combination of the partial results
// across warps and blocks. The arithmetic is
// 4 * G * D operations per key, far below the ridge.
//
// Design. The cache of each (batch, kv head) is cut into n_split chunks of
// `chunk` keys (kernels/decode_attention.py split_plan: enough splits that
// the grid covers the 132 SMs, at most 8). One block of 128 threads per
// (split, kv head and tile of kRows = 4 of its G query heads, batch); the
// splits of one (batch, kv head, tile) form one thread-block cluster.
//   - Loads: a group of GS lanes reads one K or V row with 16-byte loads
//     (D * bytes / 16 of them: 8 lanes at D 64 in bf16, 16 at D 128; D 80
//     and float32 mask the lanes of the power-of-two group beyond the row),
//     so a warp covers 32 / GS keys per load and lane group w of the W in
//     the block walks the keys w, w + W, ... of its split, kSteps keys per
//     step with all their loads issued before any is used. Every K/V row is
//     read once for the 4 query rows, whose slices sit in registers as
//     float32, pre-scaled by scale * log2(e) so the softmax runs on exp2.
//     G = 8 (Jamba) takes two tiles, which read K/V twice, mostly from L2:
//     a tile of 8 rows, or more keys a step, or loading the first step
//     before length[b] is known, each raise the registers a thread needs
//     above 128 and fit fewer blocks on an SM, and were slower in
//     bring-up.
//   - Per key: the 4 dot products are reduced across the lane group with
//     shuffles; each lane group keeps its own online softmax (running max
//     m, sum l, and the float32 accumulator of its slice of D for each
//     row). No shared memory and no barrier inside the walk.
//   - At the end: the lane groups of a warp combine with shuffles, the
//     warps through shared memory (one __syncthreads), and the splits of
//     the cluster through distributed shared memory after a cluster
//     barrier: rank r combines every n_split-th output element of the
//     tile from all ranks' (m, l, acc) and writes o. A second cluster
//     barrier keeps every block's shared memory alive until the others
//     have read it.
// Combining route: thread-block clusters, not a workspace with an arrival
// counter. The cluster needs no workspace, no atomics and no state left
// between calls (a counter must be reset by the last block of every call,
// and a cached workspace is shared by every stream of its device), and its
// cap of 8 blocks costs nothing: a longer cache takes longer chunks, whose
// loads the card keeps in flight anyway.
// A split that lies wholly at or past length[b], or before the window's
// start, skips the walk and only marks its partial result empty before the
// cluster barriers (a block of a cluster cannot leave before them). Rows
// with no valid key return 0. The window is applied as
// repro.kernels.ref.decode_attention_ref does: kpos >= length - window (the
// Pallas kernel ignores it). Head dims: 16, 32, 64, 80 and 128, and 20 in
// float32 (the SMOKE configs' 16 and 20; a bf16 row of 20 is not a whole
// number of 16-byte loads). Static shared memory only (at most 11 KB), so
// no cudaFuncSetAttribute call is needed; the cluster size (<= 8, the
// portable limit) goes in the launch attributes of cudaLaunchKernelEx.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

using repro::from_float;
using repro::to_float;

constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 4;       // query rows per block (of the G of a kv head)
constexpr int kSteps = 2;      // keys per lane group per step
constexpr int kMaxSplits = 8;  // the portable cluster size

__host__ __device__ constexpr int pow2_at_least(int n) {
  return n <= 1 ? 1 : 2 * pow2_at_least((n + 1) / 2);
}

template <typename T, int D>
struct Shape {
  static constexpr int VEC = 16 / sizeof(T);       // elements per 16-byte load
  static constexpr int NV = D / VEC;               // loads per K/V row
  static constexpr int GS = pow2_at_least(NV);     // lanes per K/V row
  static constexpr int GPW = 32 / GS;              // rows a warp loads at once
  static constexpr int WORKERS = kWarps * GPW;     // lane groups per block
  static_assert(D % VEC == 0 && GS <= 32, "head dim");
};

template <typename T, int VEC>
__device__ __forceinline__ void unpack(const uint4& raw, float (&f)[VEC]) {
  const T* e = reinterpret_cast<const T*>(&raw);
#pragma unroll
  for (int j = 0; j < VEC; ++j) f[j] = to_float<T>(e[j]);
}

// K and V rows key0, key0 + stride, ... (kSteps of them) of this lane's
// slice; rows at or past `end` read as zeros
template <int NV, int STRIDE>
__device__ __forceinline__ void load_step(const uint4* __restrict__ kb,
                                          const uint4* __restrict__ vb, int key0,
                                          int end, bool has, uint4 (&kr)[kSteps],
                                          uint4 (&vr)[kSteps]) {
#pragma unroll
  for (int u = 0; u < kSteps; ++u) {
    const int key = key0 + u * STRIDE;
    kr[u] = vr[u] = make_uint4(0, 0, 0, 0);
    if (has && key < end) {
      kr[u] = __ldg(kb + (size_t)key * NV);
      vr[u] = __ldg(vb + (size_t)key * NV);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ length,
                        T* __restrict__ o, int Hq, int Hkv, int S, int G,
                        int chunk, int window, float scale_log2) {
  using Sh = Shape<T, D>;
  constexpr int VEC = Sh::VEC, NV = Sh::NV, GS = Sh::GS, GPW = Sh::GPW;
  constexpr int WORKERS = Sh::WORKERS, R = kRows;
  const float kInf = __int_as_float(0x7f800000);
  __shared__ float wm[kWarps][R], wl[kWarps][R];
  __shared__ float wacc[kWarps][R][D];
  __shared__ float bm[R], bl[R];
  __shared__ float bacc[R][D];

  cg::cluster_group cluster = cg::this_cluster();
  const int split = blockIdx.x, n_split = gridDim.x;
  const int n_tiles = (G + R - 1) / R;
  const int kvh = blockIdx.y / n_tiles, g0 = (blockIdx.y % n_tiles) * R;
  const int b = blockIdx.z;
  const int rows = min(R, G - g0);
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int gl = lane % GS;                       // lane within its group
  const int worker = warp * GPW + lane / GS;
  const bool has = gl < NV;                       // lane holds part of a row

  const int len_raw = length ? __ldg(length + b) : S;  // no length: every slot
  const size_t head0 = (size_t)b * Hq + (size_t)kvh * G + g0;
  float qf[R][VEC];  // pre-scaled into the log2 domain
#pragma unroll
  for (int g = 0; g < R; ++g) {
    uint4 raw = make_uint4(0, 0, 0, 0);
    if (has && g < rows) raw = __ldg(reinterpret_cast<const uint4*>(q + (head0 + g) * D) + gl);
    unpack<T, VEC>(raw, qf[g]);
#pragma unroll
    for (int j = 0; j < VEC; ++j) qf[g][j] *= scale_log2;
  }

  // keys [k_begin, k_end) of this split: the valid prefix, cut to the window
  const int len = max(0, min(len_raw, S));
  const int kv_lo = window >= 0 ? max(0, len_raw - window) : 0;
  const int k_begin = max(split * chunk, kv_lo);
  const int k_end = min((split + 1) * chunk, len);

  if (k_begin < k_end) {
    float m[R], l[R], acc[R][VEC];
#pragma unroll
    for (int g = 0; g < R; ++g) {
      m[g] = -kInf;
      l[g] = 0.f;
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[g][j] = 0.f;
    }
    const size_t kv_off = ((size_t)b * Hkv + kvh) * S * NV;
    const uint4* kb = reinterpret_cast<const uint4*>(k) + kv_off + gl;
    const uint4* vb = reinterpret_cast<const uint4*>(v) + kv_off + gl;
    for (int base = k_begin + worker; base - worker < k_end; base += WORKERS * kSteps) {
      uint4 kr[kSteps], vr[kSteps];
      load_step<NV, WORKERS>(kb, vb, base, k_end, has, kr, vr);
      float s[kSteps][R];
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        float kf[VEC];
        unpack<T, VEC>(kr[u], kf);
#pragma unroll
        for (int g = 0; g < R; ++g) {
          float dot = 0.f;
#pragma unroll
          for (int j = 0; j < VEC; ++j) dot = fmaf(qf[g][j], kf[j], dot);
#pragma unroll
          for (int off = GS / 2; off > 0; off >>= 1)
            dot += __shfl_xor_sync(0xffffffffu, dot, off);
          s[u][g] = base + u * WORKERS < k_end ? dot : -kInf;
        }
      }
#pragma unroll
      for (int g = 0; g < R; ++g) {
        float mx = m[g];
#pragma unroll
        for (int u = 0; u < kSteps; ++u) mx = fmaxf(mx, s[u][g]);
        const float mu = mx == -kInf ? 0.f : mx;
        const float corr = exp2f(m[g] - mu);
        float psum = 0.f;
#pragma unroll
        for (int u = 0; u < kSteps; ++u) {
          s[u][g] = exp2f(s[u][g] - mu);  // the logit becomes its weight
          psum += s[u][g];
        }
        l[g] = l[g] * corr + psum;
        m[g] = mx;
#pragma unroll
        for (int j = 0; j < VEC; ++j) acc[g][j] *= corr;
      }
#pragma unroll
      for (int u = 0; u < kSteps; ++u) {
        float vf[VEC];
        unpack<T, VEC>(vr[u], vf);
#pragma unroll
        for (int g = 0; g < R; ++g) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) acc[g][j] = fmaf(s[u][g], vf[j], acc[g][j]);
        }
      }
    }
    // the lane groups of a warp: shuffles across lanes GS apart
#pragma unroll
    for (int off = GS; off < 32; off <<= 1) {
#pragma unroll
      for (int g = 0; g < R; ++g) {
        const float mo = __shfl_xor_sync(0xffffffffu, m[g], off);
        const float lo = __shfl_xor_sync(0xffffffffu, l[g], off);
        const float mx = fmaxf(m[g], mo);
        const float mu = mx == -kInf ? 0.f : mx;
        const float a = exp2f(m[g] - mu), c = exp2f(mo - mu);
        l[g] = l[g] * a + lo * c;
        m[g] = mx;
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          acc[g][j] = acc[g][j] * a + __shfl_xor_sync(0xffffffffu, acc[g][j], off) * c;
      }
    }
    if (lane < GS) {
#pragma unroll
      for (int g = 0; g < R; ++g) {
        if (lane == 0) {
          wm[warp][g] = m[g];
          wl[warp][g] = l[g];
        }
        if (has) {
#pragma unroll
          for (int j = 0; j < VEC; ++j) wacc[warp][g][gl * VEC + j] = acc[g][j];
        }
      }
    }
    __syncthreads();
    // the warps: this block's partial (max, sum, accumulator) of each row
    for (int e = tid; e < R * D; e += kThreads) {
      const int g = e / D, dd = e - g * D;
      float mx = -kInf;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) mx = fmaxf(mx, wm[w][g]);
      const float mu = mx == -kInf ? 0.f : mx;
      float a = 0.f, sum = 0.f;
#pragma unroll
      for (int w = 0; w < kWarps; ++w) {
        const float c = exp2f(wm[w][g] - mu);
        a = fmaf(c, wacc[w][g][dd], a);
        sum = fmaf(c, wl[w][g], sum);
      }
      bacc[g][dd] = a;
      if (dd == 0) {
        bm[g] = mx;
        bl[g] = sum;
      }
    }
  } else if (tid < R) {
    bm[tid] = -kInf;  // an empty split: read as such, its bacc never
  }

  cluster.sync();
  // the splits: rank `split` writes elements split, split + n_split, ... (in
  // units of the block) of the tile's rows, from every rank's partial
  for (int e = split * kThreads + tid; e < rows * D; e += n_split * kThreads) {
    const int g = e / D, dd = e - g * D;
    float mx = -kInf;
    for (int r = 0; r < n_split; ++r) mx = fmaxf(mx, *cluster.map_shared_rank(&bm[g], r));
    float a = 0.f, sum = 0.f;
    if (mx != -kInf) {
      for (int r = 0; r < n_split; ++r) {
        const float mr = *cluster.map_shared_rank(&bm[g], r);
        if (mr == -kInf) continue;
        const float c = exp2f(mr - mx);
        a = fmaf(c, *cluster.map_shared_rank(&bacc[g][dd], r), a);
        sum = fmaf(c, *cluster.map_shared_rank(&bl[g], r), sum);
      }
    }
    o[(head0 + g) * D + dd] = from_float<T>(sum > 0.f ? a / sum : 0.f);
  }
  cluster.sync();
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* length,
                   void* o, int B, int Hq, int Hkv, int S, int n_split, int chunk,
                   int window, float scale_log2, cudaStream_t stream) {
  const int G = Hq / Hkv;
  const int n_tiles = (G + kRows - 1) / kRows;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_split, Hkv * n_tiles, B);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = n_split;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, decode_attention_kernel<T, D>, static_cast<const T*>(q),
      static_cast<const T*>(k), static_cast<const T*>(v), length, static_cast<T*>(o),
      Hq, Hkv, S, G, chunk, window, scale_log2);
  const cudaError_t last = cudaGetLastError();
  return err != cudaSuccess ? err : last;
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* length, void* o, int B, int Hq, int Hkv, int S,
                       int n_split, int chunk, int window, float scale_log2,
                       cudaStream_t st) {
  switch (D) {
    case 16: return launch<T, 16>(q, k, v, length, o, B, Hq, Hkv, S, n_split, chunk, window, scale_log2, st);
    case 20:  // a row of 20 bf16 is 40 bytes, no whole number of 16-byte loads
      if constexpr (Shape<T, 16>::VEC == 4)
        return launch<T, 20>(q, k, v, length, o, B, Hq, Hkv, S, n_split, chunk, window, scale_log2, st);
      else
        return cudaErrorInvalidValue;
    case 32: return launch<T, 32>(q, k, v, length, o, B, Hq, Hkv, S, n_split, chunk, window, scale_log2, st);
    case 64: return launch<T, 64>(q, k, v, length, o, B, Hq, Hkv, S, n_split, chunk, window, scale_log2, st);
    case 80: return launch<T, 80>(q, k, v, length, o, B, Hq, Hkv, S, n_split, chunk, window, scale_log2, st);
    case 128: return launch<T, 128>(q, k, v, length, o, B, Hq, Hkv, S, n_split, chunk, window, scale_log2, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// length: (B,) int32 on the device, or null when every one of the S slots is
// valid (a cross-attention cache). window < 0 means no sliding window. The
// cache is cut into n_split (1..8) chunks of `chunk` keys covering S. q, k,
// v and o must be 16-byte aligned. Returns a cudaError_t code.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* length, void* o, int B, int Hq,
                                    int Hkv, int S, int D, int n_split, int chunk,
                                    int window, float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0) return cudaErrorInvalidValue;
  if (n_split < 1 || n_split > kMaxSplits || chunk < 1 ||
      (long long)n_split * chunk < S || (long long)(n_split - 1) * chunk >= S)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o)) % 16)
    return cudaErrorMisalignedAddress;
  const int* len = static_cast<const int*>(length);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float scale_log2 = scale * 1.4426950408889634f;
  if (dtype == repro::kFloat32)
    return dispatch_d<float>(D, q, k, v, len, o, B, Hq, Hkv, S, n_split, chunk, window,
                             scale_log2, st);
  if (dtype == repro::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, len, o, B, Hq, Hkv, S, n_split, chunk,
                                     window, scale_log2, st);
  return cudaErrorInvalidValue;
}
