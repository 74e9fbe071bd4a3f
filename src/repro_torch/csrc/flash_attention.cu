// Flash attention forward for Hopper (sm_90a): causal, sliding-window or full
// masking, GQA, an offset for q row 0, and an explicit softmax scale.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (_kernel).
//
// Bound on an H100 SXM: the larger of 4 * B * Hq * Sq * Skv_eff * D
// operations over the peak rate of the input type (989 TFLOP/s bf16 on the
// tensor cores, 67 TFLOP/s float32) and bytes(q, k, v, o) / 3.35 TB/s, with
// Skv_eff the keys each query actually attends (about Skv / 2 under a causal
// mask). At smollm-360M's prefill shapes (Sq = Skv = 512, D = 64) in bf16
// the bytes bound it, since the tensor-core rate makes the operations cheap.
//
// Design. This version runs on the CUDA cores in float32, so it sits far
// above the tensor-core bound; wgmma and TMA are later work. One block per
// (q tile, kv head, batch) serves all G = Hq / Hkv query heads of its kv
// head: its R = G * BQ rows (row r = g * BQ + qi) share every K/V tile, so
// K/V are read from device memory once per group, not once per q head as the
// Pallas grid does. The block walks kv tiles of 64 keys from the first tile
// of the sliding window to the causal frontier (the Pallas kernel's pl.when
// skip) and masks the ragged ends of Sq and Skv itself, where Pallas asserts
// tile multiples. Per tile:
//   1. K (transposed) and V are staged in shared memory as float32 with
//      16-byte loads;
//   2. each thread computes a 4 x 4 block of logits from float4 loads of
//      Q^T and K^T (16 FMAs per two loads), masks them to NEG_INF as
//      repro.kernels.ref._mask does, and stores them;
//   3. one warp per row updates the running max and denominator and turns
//      the logits into probabilities (expf, float32);
//   4. each thread rescales a 4-row x 4-column block of the float32
//      accumulator and adds P @ V, one float4 of V and four P values per key.
// Q, the accumulator, P and the tiles live in shared memory (up to 227 KB;
// the q tile shrinks from 64 rows until they fit). A row whose every key is
// masked returns 0, as the Pallas kernel does.
#include "common.cuh"

namespace {

using repro::from_float;
using repro::kNegInf;
using repro::to_float;

constexpr int kBK = 64;          // keys per kv tile
constexpr int kKS = kBK + 4;     // row stride of K^T and P (keeps float4 alignment)
constexpr int kThreads = 256;
constexpr size_t kMaxSmem = 232448;

size_t smem_floats(int rows, int d) {
  return 2 * (size_t)rows * d     // Q^T, accumulator
         + (size_t)rows * kKS     // logits / probabilities
         + (size_t)d * kKS        // K^T tile
         + (size_t)kBK * d        // V tile
         + 3 * (size_t)rows;      // m, l, corr
}

__device__ __forceinline__ void fma4(float4& o, float p, const float4& v) {
  o.x = fmaf(p, v.x, o.x);
  o.y = fmaf(p, v.y, o.y);
  o.z = fmaf(p, v.z, o.z);
  o.w = fmaf(p, v.w, o.w);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int Hq,
                       int Hkv, int Sq, int Skv, int G, int BQ, int causal,
                       int window, int offset, float scale) {
  constexpr int VEC = 16 / sizeof(T);   // elements per 16-byte load
  constexpr int TXD = D / 4;            // threads across D in step 4
  constexpr int TYD = kThreads / TXD;   // row groups in step 4
  extern __shared__ __align__(16) float smem[];
  const int R = G * BQ;                 // a multiple of 4 (BQ >= 8)
  float* qt = smem;                     // (D, R)
  float* acc = qt + D * R;              // (R, D)
  float* sp = acc + R * D;              // (R, kKS)
  float* kt = sp + R * kKS;             // (D, kKS)
  float* vs = kt + D * kKS;             // (kBK, D)
  float* m = vs + kBK * D;              // (R,)
  float* l = m + R;
  float* corr = l + R;

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int q0 = blockIdx.x * BQ;
  const int n_q = min(BQ, Sq - q0);
  const size_t head0 = (size_t)b * Hq + (size_t)kvh * G;

  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, dd = idx - r * D;
    const int g = r / BQ, qi = r - g * BQ;
    qt[dd * R + r] = qi < n_q ? to_float<T>(q[((head0 + g) * Sq + q0 + qi) * D + dd]) : 0.f;
    acc[idx] = 0.f;
  }
  for (int r = tid; r < R; r += kThreads) {
    m[r] = __int_as_float(0xff800000);  // -inf
    l[r] = 0.f;
  }

  // kv range this q tile can see: [window start, causal frontier]
  const int q_lo = offset + q0, q_hi = offset + q0 + n_q - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int kv_start = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = kv_start / kBK;
  const int t_end = kv_end > kv_start ? (kv_end + kBK - 1) / kBK : t_begin;
  const size_t kv_off = ((size_t)b * Hkv + kvh) * Skv * D;
  const T* kb = k + kv_off;
  const T* vb = v + kv_off;

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // previous tile's readers are done (and Q is stored)
    // 1. stage K^T and V
    for (int idx = tid; idx < kBK * D / VEC; idx += kThreads) {
      const int c = idx / (D / VEC), d0 = (idx - c * (D / VEC)) * VEC;
      float kf[VEC], vf[VEC];
      if (k0 + c < Skv) {
        const uint4 kr = *reinterpret_cast<const uint4*>(kb + (size_t)(k0 + c) * D + d0);
        const uint4 vr = *reinterpret_cast<const uint4*>(vb + (size_t)(k0 + c) * D + d0);
        const T* ke = reinterpret_cast<const T*>(&kr);
        const T* ve = reinterpret_cast<const T*>(&vr);
#pragma unroll
        for (int e = 0; e < VEC; ++e) {
          kf[e] = to_float<T>(ke[e]);
          vf[e] = to_float<T>(ve[e]);
        }
      } else {
#pragma unroll
        for (int e = 0; e < VEC; ++e) kf[e] = vf[e] = 0.f;
      }
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kt[(d0 + e) * kKS + c] = kf[e];
        vs[c * D + d0 + e] = vf[e];
      }
    }
    __syncthreads();
    // 2. logits: thread (tx, ty) computes rows rb..rb+3 x keys 4tx..4tx+3
    {
      const int tx = tid & 15, ty = tid >> 4;
      for (int rb = ty * 4; rb < R; rb += 64) {
        float s[4][4];
#pragma unroll
        for (int i = 0; i < 4; ++i)
#pragma unroll
          for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 8
        for (int dd = 0; dd < D; ++dd) {
          const float4 a = *reinterpret_cast<const float4*>(qt + dd * R + rb);
          const float4 c4 = *reinterpret_cast<const float4*>(kt + dd * kKS + tx * 4);
          const float av[4] = {a.x, a.y, a.z, a.w};
          const float cv[4] = {c4.x, c4.y, c4.z, c4.w};
#pragma unroll
          for (int i = 0; i < 4; ++i)
#pragma unroll
            for (int j = 0; j < 4; ++j) s[i][j] = fmaf(av[i], cv[j], s[i][j]);
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int r = rb + i;
          const int qpos = q_lo + (r % BQ);
          float out[4];
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int kpos = k0 + tx * 4 + j;
            bool ok = kpos < Skv;
            if (causal) ok = ok && kpos <= qpos;
            if (window >= 0) ok = ok && kpos > qpos - window;
            out[j] = ok ? s[i][j] * scale : kNegInf;
          }
          *reinterpret_cast<float4*>(sp + r * kKS + tx * 4) =
              make_float4(out[0], out[1], out[2], out[3]);
        }
      }
    }
    __syncthreads();
    // 3. online softmax, one warp per row
    for (int r = warp; r < R; r += kThreads / 32) {
      float* sr = sp + r * kKS;
      const float s0 = sr[lane], s1 = sr[lane + 32];
      const float mx = repro::warp_max(fmaxf(s0, s1));
      const float m_old = m[r];
      const float m_new = fmaxf(m_old, mx);
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
    // 4. acc = acc * corr + P @ V: thread (dx, dy) owns columns 4dx..4dx+3
    {
      const int dx = tid % TXD, dy = tid / TXD;
      if (dy < TYD) {
        for (int rb = dy * 4; rb < R; rb += TYD * 4) {
          float4 ov[4];
#pragma unroll
          for (int i = 0; i < 4; ++i) {
            const float4 a = *reinterpret_cast<const float4*>(acc + (rb + i) * D + dx * 4);
            const float c = corr[rb + i];
            ov[i] = make_float4(a.x * c, a.y * c, a.z * c, a.w * c);
          }
#pragma unroll 4
          for (int c = 0; c < kBK; ++c) {
            const float4 vv = *reinterpret_cast<const float4*>(vs + c * D + dx * 4);
#pragma unroll
            for (int i = 0; i < 4; ++i) fma4(ov[i], sp[(rb + i) * kKS + c], vv);
          }
#pragma unroll
          for (int i = 0; i < 4; ++i)
            *reinterpret_cast<float4*>(acc + (rb + i) * D + dx * 4) = ov[i];
        }
      }
    }
  }
  __syncthreads();
  for (int idx = tid; idx < R * D; idx += kThreads) {
    const int r = idx / D, dd = idx - r * D;
    const int g = r / BQ, qi = r - g * BQ;
    if (qi < n_q)
      o[((head0 + g) * Sq + q0 + qi) * D + dd] =
          from_float<T>(acc[idx] / fmaxf(l[r], 1e-30f));
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, int B,
                   int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                   int offset, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  int BQ = 64;
  while (BQ > 8 && BQ / 2 >= Sq) BQ /= 2;  // short prompts: smaller tiles
  while (BQ > 8 && smem_floats(G * BQ, D) * sizeof(float) > kMaxSmem) BQ /= 2;
  const size_t bytes = smem_floats(G * BQ, D) * sizeof(float);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hkv, B);
  flash_attention_kernel<T, D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v),
      static_cast<T*>(o), Hq, Hkv, Sq, Skv, G, BQ, causal, window, offset, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_d(int D, const void* q, const void* k, const void* v, void* o,
                       int B, int Hq, int Hkv, int Sq, int Skv, int causal,
                       int window, int offset, float scale, cudaStream_t st) {
  switch (D) {
    case 32: return launch<T, 32>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, st);
    case 64: return launch<T, 64>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, st);
    case 80: return launch<T, 80>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, st);
    case 128: return launch<T, 128>(q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, st);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

// window < 0 means no sliding window. q, k, v and o must be 16-byte aligned.
// Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, int B, int Hq, int Hkv, int Sq, int Skv,
                                   int D, int causal, int window, int offset,
                                   float scale, int dtype, void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || offset < 0)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(k) | reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kFloat32)
    return dispatch_d<float>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, st);
  if (dtype == repro::kBFloat16)
    return dispatch_d<__nv_bfloat16>(D, q, k, v, o, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, st);
  return cudaErrorInvalidValue;
}
