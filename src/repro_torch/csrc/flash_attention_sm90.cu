// Flash attention forward in bf16 for Hopper (sm_90a) on the tensor cores:
// causal, sliding-window or full masking, GQA, an offset for q row 0, an
// explicit softmax scale, and q, k, v, o read and written through their
// batch, head and sequence strides.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (_kernel), for bf16 inputs. The float32 instance stays on the CUDA cores
// (flash_attention.cu), since the tensor cores take no float32 input.
//
// Bound on an H100 SXM: the larger of 4 * B * Hq * D * pairs operations
// (pairs = the (query, key) pairs the mask keeps) over 989 TFLOP/s of bf16
// on the tensor cores, and bytes(q, k, v, o) / 3.35 TB/s. At smollm-360M's
// prefill (q 8x15x512x64, causal) the bytes bound it, 0.0063 ms; at Jamba's
// (q 8x64x512x128, kv 8x8) too, 0.045 ms. Each staged K/V tile serves
// NC * 64 q rows, 64 * NC operations per byte staged from L2, so what holds
// the kernel back is keeping the tensor cores fed: loads must overlap the
// products, and the softmax between the two products must not leave them
// idle.
//
// Design. One block per (64-row q tile, batch, kv head, share of its G query
// heads). Its NC consumer warpgroups each own one q head's 64 x D tile; they
// all consume the same staged K/V tile, so K/V are read once per NC heads.
// A producer warpgroup (one thread issuing; with NC > 1 setmaxnreg hands its
// registers to the consumers) loads Q once and walks the kv tiles of 64 keys
// from the window start to the causal frontier, loading each K and V tile
// with TMA into a ring of kStages shared-memory stages; completion is
// signalled on mbarriers (K and V full apart, so S = Q K^T can start before
// V lands), and the consumers release a stage (empty) after their second
// product on it. TMA (cuTensorMapEncodeTiled, taken from the driver with
// cudaGetDriverEntryPoint, so no -lcuda) was chosen over cp.async because
// its tensor maps carry the strides, zero-fill the ragged Sq/Skv tails and
// the padded head dims, and write the 128-byte swizzle that the wgmma
// descriptors read, with one thread issuing; encoding the three maps costs
// a few microseconds of host time per call. Per tile and warpgroup:
//   1. S = Q K^T with wgmma m64nBNk16, Q and K K-major from shared memory
//      through 128-byte-swizzled descriptors (D / 16 steps);
//   2. the logits are masked (-inf) only on the diagonal, window-edge and
//      ragged tail tiles, folded into the running max and sum of each row in
//      registers (a row spans the four threads of a quad, __shfl_xor), and
//      turned into probabilities with one FFMA and one ex2 each, the scale
//      folded into log2 e;
//   3. P is converted to bf16 pairs in place: the S accumulator layout is
//      the A-fragment layout of the next product, so P never touches shared
//      memory; O is rescaled by the max correction;
//   4. O += P V with wgmma m64nDPk16, P from registers, V (keys x D, D
//      contiguous) the MN-major B operand (transposed descriptor).
// Tile i's S product is issued together with tile i - 1's P V, and tile i's
// softmax runs while the tensor cores do that P V. Head dims 64, 128 and 192
// are native; 16 and 32 run as 64, 80 as 128 (DP), the columns beyond D
// zero-filled by TMA and never written back. The softmax and both accumulations are float32 and
// the output is rounded once to bf16. A row whose every key is masked
// returns 0: its running max stays -inf and its sum 0.
//
// The log-sum-exp. With a non-null `lse` ((B, Hq, Sq) float32) the epilogue
// also writes each row's L = m * scale + ln(l), m the row's max of the
// unscaled logits and l its sum of exp(scale (s - m)), so that the backward
// (flash_attention_bwd_sm90.cu) takes P = exp(scale s - L) without a pass
// of its own; a row with no visible key gets L = +inf (P = 0 there). One
// thread of each quad writes it. A null `lse` (serving, prefill) writes
// nothing and leaves every other instruction as it was.
#include "sm90.cuh"

#include <math.h>

namespace {

constexpr int kRows = 64;           // q rows per warpgroup (one wgmma M)
constexpr int kBN = 64;             // keys per kv tile (one wgmma N of S)
constexpr int kProducerRegs = 40;

// DP: head dim padded to 64 or 128, or 192 (MLA); NC: consumer warpgroups
// (q heads) per block.
template <int DP, int NC>
struct Plan {
  // DP 192: 24 KB of Q and 48 KB a K/V stage, 168 KB in all
  static constexpr int kStages = DP == 64 ? 4 : 3;
  static constexpr int kQPanel = kRows * 128;          // 64 rows x 64 bf16
  static constexpr int kKVPanel = kBN * 128;           // kBN rows x 64 bf16
  static constexpr int kQTile = kRows * DP * 2;        // bytes of a 64 x DP tile
  static constexpr int kKVTile = kBN * DP * 2;         // bytes of a kBN x DP tile
  static constexpr int kQ = 0;                         // NC q tiles
  static constexpr int kK = kQ + NC * kQTile;          // kStages K tiles
  static constexpr int kV = kK + kStages * kKVTile;    // kStages V tiles
  static constexpr int kBar = kV + kStages * kKVTile;  // q, k_full[], v_full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 3 * kStages) + 1024;  // + alignment slack
  static constexpr int kThreads = (NC + 1) * 128;
  // one consumer warpgroup at D 64: two blocks per SM (128 registers each)
  static constexpr int kMinBlocks = NC == 1 && DP == 64 ? 2 : 1;
  // With several consumer warpgroups, setmaxnreg moves registers from the
  // producer to them: each block starts with kEntryRegs per thread (the
  // register file over kThreads, in steps of 8), the producer keeps
  // kProducerRegs and the consumers share the rest. One consumer warpgroup
  // has all it needs at entry.
  static constexpr int kEntryRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kConsumerRegs =
      ((kEntryRegs * (NC + 1) - kProducerRegs) / NC / 8 * 8) < 240
          ? (kEntryRegs * (NC + 1) - kProducerRegs) / NC / 8 * 8
          : 240;
};

// Accumulator element r of a thread (lane l of warp w in its warpgroup)
// sits at row 16 w + l / 4 + 8 ((r >> 1) & 1) and column
// 8 (r >> 2) + 2 (l % 4) + (r & 1).
template <int DP, int NC>
__global__ void __launch_bounds__(Plan<DP, NC>::kThreads, Plan<DP, NC>::kMinBlocks)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
                      long long sob, long long soh, long long sos, float* __restrict__ lse,
                      int Hq, int Sq, int Skv, int D, int G, int causal, int window,
                      int offset, float scale_log2) {
  using P = Plan<DP, NC>;
  constexpr int ST = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1 KB aligned
  const uint32_t bar_q = base + P::kBar;
  const uint32_t bar_k = bar_q + 8, bar_v = bar_k + 8 * ST, bar_e = bar_v + 8 * ST;

  const int shares = G / NC;
  const int kvh = blockIdx.x / shares;
  const int head0 = kvh * G + (blockIdx.x % shares) * NC;  // first q head of the block
  const int b = blockIdx.y;
  const int q0 = (gridDim.z - 1 - blockIdx.z) * kRows;    // the longest causal rows first
  const int n_q = min(kRows, Sq - q0);
  // kv range this q tile can see: [window start, causal frontier]
  const int q_lo = offset + q0, q_hi = offset + q0 + n_q - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int kv_start = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = kv_start / kBN;
  const int n_tiles = kv_end > kv_start ? (kv_end + kBN - 1) / kBN - t_begin : 0;

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 4 * NC);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int wg = threadIdx.x / 128;
  if (wg == NC) {
    // producer: one thread issues every copy
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (threadIdx.x % 128 == 0) {
      mbar_expect_tx(bar_q, NC * P::kQTile);
      for (int c = 0; c < NC; ++c)
        for (int a = 0; a < DP / 64; ++a)
          tma_load(base + P::kQ + c * P::kQTile + a * P::kQPanel, &tmq, bar_q, a * 64, q0,
                   head0 + c, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(bar_e + 8 * s, ((i / ST) & 1) ^ 1);  // released last round
        const int k0 = (t_begin + i) * kBN;
        const uint32_t k_tile = base + P::kK + s * P::kKVTile;
        const uint32_t v_tile = base + P::kV + s * P::kKVTile;
        mbar_expect_tx(bar_k + 8 * s, P::kKVTile);
        for (int a = 0; a < DP / 64; ++a)
          tma_load(k_tile + a * P::kKVPanel, &tmk, bar_k + 8 * s, a * 64, k0, kvh, b);
        mbar_expect_tx(bar_v + 8 * s, P::kKVTile);
        for (int a = 0; a < DP / 64; ++a)
          tma_load(v_tile + a * P::kKVPanel, &tmv, bar_v + 8 * s, a * 64, k0, kvh, b);
      }
    }
  } else {
    // consumers: warpgroup wg owns q head head0 + wg
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::kConsumerRegs));
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = (t / 32) * 16 + lane / 4;  // rows r0 and r0 + 8 of the tile
    const int qp0 = q_lo + r0, qp1 = qp0 + 8;
    const int col0 = 2 * (lane % 4);  // first of this thread's two columns per 8
    float acc[DP / 2];
#pragma unroll
    for (int r = 0; r < DP / 2; ++r) acc[r] = 0.f;
    float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0 = 0.f, c1 = 0.f;
    float sc[kBN / 2];     // logits, then probabilities, of the newest tile
    uint32_t pa[kBN / 4];  // the previous tile's probabilities as bf16 A fragments
    const uint32_t q_tile = base + P::kQ + wg * P::kQTile;

    // 1. S = Q K^T for tile i, Q and K K-major: issued and committed, not
    // waited for
    const auto issue_qk = [&](int i) {
      const int s = i % ST;
      mbar_wait(bar_k + 8 * s, (i / ST) & 1);
      const uint32_t k_tile = base + P::kK + s * P::kKVTile;
#pragma unroll
      for (int kk = 0; kk < DP / 16; ++kk)
        wgmma_ss_m64n64k16(sc, smem_desc(q_tile + (kk / 4) * P::kQPanel + (kk % 4) * 32, 16, 1024),
                     smem_desc(k_tile + (kk / 4) * P::kKVPanel + (kk % 4) * 32, 16, 1024), kk);
      wgmma_commit();
    };
    // 2. mask and fold the tile at k0 into the running max (of the raw
    // logits: the scale is positive) and sum; sc becomes probabilities,
    // exp2(s * scale_log2 - max * scale_log2), one FFMA and one ex2 each, and
    // (c0, c1) the corrections of the rows' old max. Only the ragged Skv tail,
    // the causal diagonal and the window's lower edge (over all 64 rows) need
    // a mask; it keeps keys in [lo, hi] of each row.
    const auto softmax = [&](int k0) {
      if (k0 + kBN > Skv || (causal && k0 + kBN - 1 > q_lo) ||
          (window >= 0 && k0 <= q_lo + kRows - 1 - window)) {
        const int first = k0 + col0;  // key of this thread's column 0
        const int hi0 = (causal ? min(Skv - 1, qp0) : Skv - 1) - first;
        const int hi1 = (causal ? min(Skv - 1, qp1) : Skv - 1) - first;
        const int lo0 = (window >= 0 ? qp0 - window + 1 : 0) - first;
        const int lo1 = (window >= 0 ? qp1 - window + 1 : 0) - first;
#pragma unroll
        for (int r = 0; r < kBN / 2; ++r) {
          const int c = 8 * (r >> 2) + (r & 1);
          const bool out = (r & 2) ? (c < lo1 || c > hi1) : (c < lo0 || c > hi0);
          if (out) sc[r] = -INFINITY;
        }
      }
      float mx0 = -INFINITY, mx1 = -INFINITY;
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) {
        if (r & 2) mx1 = fmaxf(mx1, sc[r]);
        else mx0 = fmaxf(mx0, sc[r]);
      }
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 1));
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, 2));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 1));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, 2));
      const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
      // a row with no unmasked key so far keeps max -inf: subtract 0 instead
      const float mu0 = mn0 == -INFINITY ? 0.f : mn0;
      const float mu1 = mn1 == -INFINITY ? 0.f : mn1;
      c0 = exp2_ftz((m0 - mu0) * scale_log2);
      c1 = exp2_ftz((m1 - mu1) * scale_log2);
      m0 = mn0;
      m1 = mn1;
      const float b0 = -mu0 * scale_log2, b1 = -mu1 * scale_log2;
      float ls0 = 0.f, ls1 = 0.f;
#pragma unroll
      for (int r = 0; r < kBN / 2; ++r) {
        const float p = exp2_ftz(fmaf(sc[r], scale_log2, (r & 2) ? b1 : b0));
        sc[r] = p;
        if (r & 2) ls1 += p;
        else ls0 += p;
      }
      l0 = l0 * c0 + ls0;  // this thread's share of the row sum
      l1 = l1 * c1 + ls1;
    };
    // 3. P as bf16 A fragments, in place: the S accumulator layout is the A
    // layout of the next product
    const auto pack_p = [&] {
#pragma unroll
      for (int j = 0; j < kBN / 4; ++j) pa[j] = pack_bf16(sc[2 * j], sc[2 * j + 1]);
    };
    // 4. O += P V for tile i, V MN-major: issued and committed
    const auto issue_pv = [&](int i) {
      const int s = i % ST;
      mbar_wait(bar_v + 8 * s, (i / ST) & 1);
      const uint32_t v_tile = base + P::kV + s * P::kKVTile;
#pragma unroll
      for (int kk = 0; kk < kBN / 16; ++kk)
        wgmma_rs<DP>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                     smem_desc(v_tile + kk * 2048, P::kKVPanel, 1024));
      wgmma_commit();
    };
    const auto release = [&](int i) {
      if (lane == 0) mbar_arrive(bar_e + 8 * (i % ST));
    };

    mbar_wait(bar_q, 0);
    if (n_tiles > 0) {
      wgmma_fence();
      issue_qk(0);
      wgmma_wait<0>();
      fence_regs(sc);
      softmax(t_begin * kBN);
      pack_p();
      // Tile i's softmax runs while the tensor cores do tile i - 1's P V:
      // S_i and P_{i-1} V_{i-1} are issued together, S_i is waited for
      // first.
      for (int i = 1; i < n_tiles; ++i) {
        wgmma_fence();
        issue_qk(i);
        issue_pv(i - 1);
        wgmma_wait<1>();
        fence_regs(sc);
        softmax((t_begin + i) * kBN);
        wgmma_wait<0>();
        fence_regs(acc);
        fence_regs(pa);
        release(i - 1);
        if (c0 != 1.f || c1 != 1.f) {  // a row's max moved
#pragma unroll
          for (int r = 0; r < DP / 2; ++r) acc[r] *= (r & 2) ? c1 : c0;
        }
        pack_p();
      }
      wgmma_fence();
      issue_pv(n_tiles - 1);
      wgmma_wait<0>();
      fence_regs(acc);
      release(n_tiles - 1);
    }

    // row sums over the quad; write O (bf16 pairs) through its strides
    l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
    l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
    l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
    const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
    __nv_bfloat16* ob = o + b * sob + (long long)(head0 + wg) * soh;
#pragma unroll
    for (int j = 0; j < DP / 8; ++j) {
      const int col = 8 * j + col0;
      if (col < D) {
        if (r0 < n_q)
          *reinterpret_cast<uint32_t*>(ob + (q0 + r0) * sos + col) =
              pack_bf16(acc[4 * j] * inv0, acc[4 * j + 1] * inv0);
        if (r0 + 8 < n_q)
          *reinterpret_cast<uint32_t*>(ob + (q0 + r0 + 8) * sos + col) =
              pack_bf16(acc[4 * j + 2] * inv1, acc[4 * j + 3] * inv1);
      }
    }
    if (lse != nullptr && lane % 4 == 0) {
      // L = (m * scale_log2 + log2 l) * ln 2; +inf where l is 0
      float* lrow = lse + ((long long)b * Hq + head0 + wg) * Sq + q0;
      if (r0 < n_q)
        lrow[r0] = l0 > 0.f ? (m0 * scale_log2 + __log2f(l0)) * 0.6931471805599453f : INFINITY;
      if (r0 + 8 < n_q)
        lrow[r0 + 8] =
            l1 > 0.f ? (m1 * scale_log2 + __log2f(l1)) * 0.6931471805599453f : INFINITY;
    }
  }
}

template <int DP, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const long long* sq, const long long* sk, const long long* sv,
                   const long long* so, int B, int Hq,
                   int Hkv, int Sq, int Skv, int D, int causal, int window, int offset,
                   float scale, cudaStream_t stream) {
  using P = Plan<DP, NC>;
  auto kernel = flash_attention_wgmma<DP, NC>;
  static cudaError_t setup = [&] {
    // setmaxnreg.inc waits for registers the producer frees: make sure the
    // block holds enough of them, or it would wait forever
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (NC > 1 && attr.numRegs * (NC + 1) < NC * P::kConsumerRegs + kProducerRegs)
      return cudaErrorInvalidConfiguration;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes);
  }();
  if (setup != cudaSuccess) return setup;
  CUtensorMap tq, tk, tv;
  if (!encode(&tq, q, B, Hq, Sq, D, sq[0], sq[1], sq[2], kRows) ||
      !encode(&tk, k, B, Hkv, Skv, D, sk[0], sk[1], sk[2], kBN) ||
      !encode(&tv, v, B, Hkv, Skv, D, sv[0], sv[1], sv[2], kBN))
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const dim3 grid(Hkv * (G / NC), B, (Sq + kRows - 1) / kRows);
  kernel<<<grid, P::kThreads, P::kBytes, stream>>>(
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), so[0], so[1], so[2], lse, Hq, Sq, Skv, D, G,
      causal, window, offset, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

namespace repro {

// The bf16 instance of flash_attention_fwd (flash_attention.cu). Strides are
// in elements, (batch, head, sequence) for each of q, k, v, o; every stride
// and pointer is 16-byte aligned and the last dim contiguous. `lse`, when
// not null, receives each row's log-sum-exp, (B, Hq, Sq) float32.
cudaError_t flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o,
                                       float* lse,
                                       const long long* sq, const long long* sk,
                                       const long long* sv, const long long* so, int B,
                                       int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                                       int window, int offset, float scale,
                                       cudaStream_t stream) {
  if (D != 16 && D != 32 && D != 64 && D != 80 && D != 128 && D != 192)
    return cudaErrorInvalidValue;
  if (B > 65535 || (Sq + kRows - 1) / kRows > 65535) return cudaErrorInvalidConfiguration;
  // D <= 64: the three q heads of a kv head per block where G is a multiple
  // of 3 (smollm), else one per block, small enough that two blocks share an
  // SM; D 80 and 128: two q heads per block where G is even; D 192 (MLA,
  // G = 1): one, its O tile 96 float32 registers a thread beside S.
  const int G = Hq / Hkv;
#define REPRO_GO(DP, NC)                                                                   \
  return launch<DP, NC>(q, k, v, o, lse, sq, sk, sv, so, B, Hq, Hkv, Sq, Skv, D, causal, window, \
                        offset, scale, stream)
  if (D == 192) REPRO_GO(192, 1);
  if (D <= 64 && G % 3 == 0) REPRO_GO(64, 3);
  if (D <= 64) REPRO_GO(64, 1);
  if (G % 2 == 0) REPRO_GO(128, 2);
  REPRO_GO(128, 1);
#undef REPRO_GO
}

}  // namespace repro
