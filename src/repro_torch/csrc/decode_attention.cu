// Decode attention for Hopper (sm_90a): one new query token per sequence
// against a KV cache, with GQA, a per-sequence valid length and an optional
// sliding window.
//
// Replaces: src/repro/kernels/decode_attention.py, decode_attention_pallas
// (_kernel).
//
// Bound on an H100 SXM: memory. The least time is the bytes of the K and V
// rows that the valid prefixes hold, over 3.35 TB/s; q and the output are a
// few KB. The arithmetic is 4 * G * D operations per key, far below the
// ridge.
//
// Design: one block per (kv head, batch) with the G query rows of that kv
// head in shared memory, so every K/V row is read once for the whole group.
// The block reads length[b] from device memory itself (the Pallas kernel's
// scalar prefetch) and walks only the tiles of 64 keys below it: the valid
// prefix, with no S % tile assert. Per tile it stages K and V in shared
// memory as float32 (rows padded to D + 1 floats, so threads reading one
// column of consecutive keys hit distinct banks), computes the G x 64 logits
// masked to NEG_INF, updates the running max and denominator with one warp
// per query row (expf, float32), and adds P @ V into a float32 accumulator.
// Unlike the Pallas kernel, which ignores `window`, it applies the window as
// repro.kernels.ref.decode_attention_ref does: kpos > length - 1 - window. At
// smollm-360M's decode shape there are only B * Hkv = 40 blocks for 132 SMs;
// a split-K pass over S is later work.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::kNegInf;
using repro::to_float;

constexpr int kBK = 64;
constexpr int kThreads = 128;
constexpr size_t kMaxSmem = 232448;

size_t smem_floats(int g, int d) {
  return 2 * (size_t)g * d          // q, accumulator
         + (size_t)g * kBK          // logits / probabilities
         + 2 * (size_t)kBK * (d + 1)  // K, V tiles
         + 3 * (size_t)g;           // m, l, corr
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
decode_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                        const T* __restrict__ v, const int* __restrict__ length,
                        T* __restrict__ o, int Hq, int Hkv, int S, int G,
                        int window, float scale) {
  extern __shared__ float smem[];
  float* qs = smem;                 // (G, D)
  float* acc = qs + G * D;          // (G, D)
  float* sp = acc + G * D;          // (G, kBK)
  float* ks = sp + G * kBK;         // (kBK, D + 1)
  float* vs = ks + kBK * (D + 1);   // (kBK, D + 1)
  float* m = vs + kBK * (D + 1);    // (G,)
  float* l = m + G;
  float* corr = l + G;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.x, b = blockIdx.y;
  const size_t head0 = (size_t)b * Hq + (size_t)kvh * G;
  for (int idx = tid; idx < G * D; idx += kThreads) {
    qs[idx] = to_float<T>(q[head0 * D + idx]);
    acc[idx] = 0.f;
  }
  for (int r = tid; r < G; r += kThreads) {
    m[r] = __int_as_float(0xff800000);  // -inf
    l[r] = 0.f;
  }

  // keys [kv_start, len): the valid prefix, cut to the window
  const int len = max(0, min(length[b], S));
  const int kv_start = window >= 0 ? max(0, len - window) : 0;
  const int t_end = len > kv_start ? (len + kBK - 1) / kBK : 0;
  const size_t kv_off = ((size_t)b * Hkv + kvh) * S * D;
  for (int t = kv_start / kBK; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();
    for (int idx = tid; idx < kBK * D; idx += kThreads) {
      const int c = idx / D, dd = idx - c * D;
      const bool in = k0 + c < S;
      ks[c * (D + 1) + dd] = in ? to_float<T>(k[kv_off + (size_t)(k0 + c) * D + dd]) : 0.f;
      vs[c * (D + 1) + dd] = in ? to_float<T>(v[kv_off + (size_t)(k0 + c) * D + dd]) : 0.f;
    }
    __syncthreads();
    for (int idx = tid; idx < G * kBK; idx += kThreads) {
      const int r = idx / kBK, c = idx - r * kBK;
      const int kpos = k0 + c;
      float s = kNegInf;
      if (kpos >= kv_start && kpos < len) {
        const float* qr = qs + r * D;
        const float* kr = ks + c * (D + 1);
        float dot = 0.f;
#pragma unroll
        for (int dd = 0; dd < D; ++dd) dot = fmaf(qr[dd], kr[dd], dot);
        s = dot * scale;
      }
      sp[idx] = s;
    }
    __syncthreads();
    for (int r = warp; r < G; r += kThreads / 32) {
      float* sr = sp + r * kBK;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, repro::warp_max(fmaxf(s0, s1)));
      const float p0 = expf(s0 - m_new), p1 = expf(s1 - m_new);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      const float sum = repro::warp_sum(p0 + p1);
      if (lane == 0) {
        const float c = expf(m_old - m_new);
        corr[r] = c;
        l[r] = l[r] * c + sum;
        m[r] = m_new;
      }
    }
    __syncthreads();
    for (int idx = tid; idx < G * D; idx += kThreads) {
      const int r = idx / D, dd = idx - r * D;
      const float* pr = sp + r * kBK;
      float a = acc[idx] * corr[r];
#pragma unroll 16
      for (int c = 0; c < kBK; ++c) a = fmaf(pr[c], vs[c * (D + 1) + dd], a);
      acc[idx] = a;
    }
  }
  __syncthreads();
  for (int idx = tid; idx < G * D; idx += kThreads)
    o[head0 * D + idx] = from_float<T>(acc[idx] / fmaxf(l[idx / D], 1e-30f));
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const int* length,
                   void* o, int B, int Hq, int Hkv, int S, int window, float scale,
                   cudaStream_t stream) {
  const int G = Hq / Hkv;
  const size_t bytes = smem_floats(G, D) * sizeof(float);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(decode_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(Hkv, B);
  decode_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      length, static_cast<T*>(o), Hq, Hkv, S, G, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v,
                       const int* length, void* o, int B, int Hq, int Hkv, int S,
                       int window, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, length, o, B, Hq, Hkv, S, window, scale, st);
    case 64: return launch<T, 64>(q, k, v, length, o, B, Hq, Hkv, S, window, scale, st);
    case 80: return launch<T, 80>(q, k, v, length, o, B, Hq, Hkv, S, window, scale, st);
    case 128: return launch<T, 128>(q, k, v, length, o, B, Hq, Hkv, S, window, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// length: (B,) int32 on the device. window < 0 means no sliding window.
// Returns a cudaError_t code.
extern "C" int decode_attention_fwd(const void* q, const void* k, const void* v,
                                    const void* length, void* o, int B, int Hq,
                                    int Hkv, int S, int D, int window, float scale,
                                    int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || S <= 0) return cudaErrorInvalidValue;
  const int* len = static_cast<const int*>(length);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_d<float>(D, q, k, v, len, o, B, Hq, Hkv, S, window, scale, st);
  if (dtype == repro::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, len, o, B, Hq, Hkv, S, window, scale, st);
  return cudaErrorInvalidValue;
}
