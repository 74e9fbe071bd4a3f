// Flash attention forward for Hopper (sm_90a), float32 instance, and the C
// entry point of both instances: causal, sliding-window or full masking,
// GQA, an offset for q row 0, an explicit softmax scale, and q, k, v, o read
// and written through their batch, head and sequence strides.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (_kernel), for float32 inputs. bf16 inputs go to the tensor-core kernel of
// flash_attention_sm90.cu; this one stays on the CUDA cores because the
// tensor cores take no float32 input (TF32 keeps ~3 digits, too few for the
// float32 tolerance of 2e-5).
//
// Bound on an H100 SXM: the larger of 4 * B * Hq * Sq * Skv_eff * D
// operations over 67 TFLOP/s of float32 on the CUDA cores and
// bytes(q, k, v, o) / 3.35 TB/s, with Skv_eff the keys each query actually
// attends (about Skv / 2 under a causal mask): the operations bound it at
// the model's prefill shapes.
//
// Design. One block per (q tile, kv head, batch) serves all G = Hq / Hkv
// query heads of its kv head: its R = G * BQ rows (row r = g * BQ + qi) share
// every K/V tile, so K/V are read from device memory once per group, not
// once per q head as the Pallas grid does. The block walks kv tiles of 64
// keys from the first tile of the sliding window to the causal frontier (the
// Pallas kernel's pl.when skip) and masks the ragged ends of Sq and Skv
// itself, where Pallas asserts tile multiples. Per tile:
//   1. K (transposed) and V are staged in shared memory with 16-byte loads;
//   2. each thread computes a 4 x 4 block of logits from float4 loads of
//      Q^T and K^T (16 FMAs per two loads), masks them to -inf, and stores
//      them;
//   3. one warp per row updates the running max and denominator and turns
//      the logits into probabilities (expf);
//   4. each thread rescales a 4-row x 4-column block of the accumulator and
//      adds P @ V, one float4 of V and four P values per key.
// Q, the accumulator, P and the tiles live in shared memory (up to 227 KB;
// the q tile shrinks from 64 rows until they fit). Q is read and O written
// one row per warp: each row's address is one 64-bit block base plus 32-bit
// head and sequence steps, so the strides cost little per element. A row
// whose every key is masked returns 0: its running max stays -inf and its
// denominator 0. The template takes any D that is a multiple of 4 (one float4
// of a row); it is instantiated for 16 and 20 (the SMOKE configs' head dims,
// rows of 64 and 80 bytes), 24 and 192 (MLA's qk width at SMOKE size and at
// DeepSeek-V3's) besides 32, 64, 80 and 128. At 192 a q tile of 64 rows
// takes 213 KB of shared memory, and step 4 runs on 240 of the 256 threads
// (48 across D).
#include "common.cuh"

#include <climits>
#include <math.h>

namespace {

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

// Element strides (batch, head, sequence) of q, k, v and o, in that order.
// The head and sequence strides fit in 32 bits (checked on the host), so the
// per-row offsets inside a block are 32 x 32 -> 64-bit products.
struct Strides {
  long long s[4][3];
  // start of (batch b, head h, row i) of tensor t, in 64 bits
  __device__ __forceinline__ long long base(int t, int b, int h, int i) const {
    return b * s[t][0] + h * s[t][1] + i * s[t][2];
  }
  // offset of (head h, row i) from a base
  __device__ __forceinline__ long long step(int t, int h, int i) const {
    return (long long)h * (int)s[t][1] + (long long)i * (int)s[t][2];
  }
};

__device__ __forceinline__ void fma4(float4& o, float p, const float4& v) {
  o.x = fmaf(p, v.x, o.x);
  o.y = fmaf(p, v.y, o.y);
  o.z = fmaf(p, v.z, o.z);
  o.w = fmaf(p, v.w, o.w);
}

template <int D>
__global__ void __launch_bounds__(kThreads)
flash_attention_kernel(const float* __restrict__ q, const float* __restrict__ k,
                       const float* __restrict__ v, float* __restrict__ o, Strides st,
                       int Sq, int Skv, int G, int BQ, int causal, int window,
                       int offset, float scale) {
  constexpr int VEC = 4;                // floats per 16-byte load
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
  const int head0 = kvh * G;

  // Q^T: one warp per row r = g * BQ + qi, its lanes along D
  {
    const float* qb = q + st.base(0, b, head0, q0);
    for (int r = warp; r < R; r += kThreads / 32) {
      const int g = r / BQ, qi = r - g * BQ;
      const float* qr = qb + st.step(0, g, qi);
      for (int dd = lane; dd < D; dd += 32) qt[dd * R + r] = qi < n_q ? qr[dd] : 0.f;
    }
  }
  for (int idx = tid; idx < R * D; idx += kThreads) acc[idx] = 0.f;
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
  const float* kb = k + st.base(1, b, kvh, 0);
  const float* vb = v + st.base(2, b, kvh, 0);

  for (int t = t_begin; t < t_end; ++t) {
    const int k0 = t * kBK;
    __syncthreads();  // previous tile's readers are done (and Q is stored)
    // 1. stage K^T and V
    for (int idx = tid; idx < kBK * D / VEC; idx += kThreads) {
      const int c = idx / (D / VEC), d0 = (idx - c * (D / VEC)) * VEC;
      float4 kf = make_float4(0.f, 0.f, 0.f, 0.f), vf = kf;
      if (k0 + c < Skv) {
        kf = *reinterpret_cast<const float4*>(kb + st.step(1, 0, k0 + c) + d0);
        vf = *reinterpret_cast<const float4*>(vb + st.step(2, 0, k0 + c) + d0);
      }
      const float ke[VEC] = {kf.x, kf.y, kf.z, kf.w}, ve[VEC] = {vf.x, vf.y, vf.z, vf.w};
#pragma unroll
      for (int e = 0; e < VEC; ++e) {
        kt[(d0 + e) * kKS + c] = ke[e];
        vs[c * D + d0 + e] = ve[e];
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
            out[j] = ok ? s[i][j] * scale : -INFINITY;
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
      // a row with no unmasked key so far keeps max -inf: subtract 0 instead
      const float m_use = m_new == -INFINITY ? 0.f : m_new;
      const float p0 = expf(s0 - m_use), p1 = expf(s1 - m_use);
      sr[lane] = p0;
      sr[lane + 32] = p1;
      const float sum = repro::warp_sum(p0 + p1);
      if (lane == 0) {
        const float c = expf(m_old - m_use);
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
  float* ob = o + st.base(3, b, head0, q0);
  for (int r = warp; r < R; r += kThreads / 32) {
    const int g = r / BQ, qi = r - g * BQ;
    if (qi >= n_q) continue;
    float* orow = ob + st.step(3, g, qi);
    const float lr = l[r];
    for (int dd = lane; dd < D; dd += 32) orow[dd] = lr > 0.f ? acc[r * D + dd] / lr : 0.f;
  }
}

template <int D>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const Strides& st,
                   int B, int Hq, int Hkv, int Sq, int Skv, int causal, int window,
                   int offset, float scale, cudaStream_t stream) {
  const int G = Hq / Hkv;
  int BQ = 64;
  while (BQ > 8 && BQ / 2 >= Sq) BQ /= 2;  // short prompts: smaller tiles
  while (BQ > 8 && smem_floats(G * BQ, D) * sizeof(float) > kMaxSmem) BQ /= 2;
  const size_t bytes = smem_floats(G * BQ, D) * sizeof(float);
  if (bytes > kMaxSmem) return cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(flash_attention_kernel<D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize,
                                         (int)bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid((Sq + BQ - 1) / BQ, Hkv, B);
  flash_attention_kernel<D><<<grid, kThreads, bytes, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k), static_cast<const float*>(v),
      static_cast<float*>(o), st, Sq, Skv, G, BQ, causal, window, offset, scale);
  return cudaGetLastError();
}

}  // namespace

namespace repro {
cudaError_t flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o,
                                       float* lse, const long long* sq, const long long* sk,
                                       const long long* sv, const long long* so, int B,
                                       int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                                       int window, int offset, float scale,
                                       cudaStream_t stream);
}  // namespace repro

// Strides are in elements, three per tensor: batch, head, sequence (the last
// dim is contiguous); every stride and pointer is 16-byte aligned. window < 0
// means no sliding window. float32 runs on the CUDA cores (above), bf16 on
// the tensor cores (flash_attention_sm90.cu). lse: null, or (B, Hq, Sq)
// float32 for each row's log-sum-exp, which only the bf16 kernel writes.
// Returns a cudaError_t code.
extern "C" int flash_attention_fwd(const void* q, const void* k, const void* v,
                                   void* o, void* lse, const long long* sq, const long long* sk,
                                   const long long* sv, const long long* so, int B,
                                   int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                                   int window, int offset, float scale, int dtype,
                                   void* stream) {
  if (B <= 0 || Hkv <= 0 || Hq % Hkv != 0 || Sq <= 0 || Skv <= 0 || offset < 0)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (dtype == repro::kBFloat16)
    return repro::flash_attention_wgmma_bf16(q, k, v, o, static_cast<float*>(lse), sq, sk, sv,
                                             so, B, Hq, Hkv, Sq, Skv, D, causal, window,
                                             offset, scale, s);
  if (dtype != repro::kFloat32 || lse != nullptr) return cudaErrorInvalidValue;
  const Strides st{{{sq[0], sq[1], sq[2]}, {sk[0], sk[1], sk[2]}, {sv[0], sv[1], sv[2]},
                    {so[0], so[1], so[2]}}};
  for (const auto& t : st.s)
    if (t[1] > INT_MAX || t[2] > INT_MAX) return cudaErrorInvalidValue;
  switch (D) {
    case 16: return launch<16>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, s);
    case 20: return launch<20>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, s);
    case 24: return launch<24>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, s);
    case 32: return launch<32>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, s);
    case 64: return launch<64>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, s);
    case 80: return launch<80>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, s);
    case 128: return launch<128>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, s);
    case 192: return launch<192>(q, k, v, o, st, B, Hq, Hkv, Sq, Skv, causal, window, offset, scale, s);
    default: return cudaErrorInvalidValue;
  }
}
