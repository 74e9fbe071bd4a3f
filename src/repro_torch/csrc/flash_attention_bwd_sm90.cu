// Flash attention backward in bf16 for Hopper (sm_90a) on the tensor cores:
// dq, dk, dv of o = softmax(scale * q k^T + mask) v with causal,
// sliding-window or full masking, GQA, an offset for q row 0, ragged Sq and
// Skv, and q, k, v, o, dO read and dq, dk, dv written through their batch,
// head and sequence strides.
//
// Replaces: src/repro/kernels/flash_attention.py, flash_attention_pallas
// (_kernel), whose gradient the reference takes by differentiating the
// blockwise jnp attention (_flash_jnp); for bf16 inputs. The float32
// instance stays on the CUDA cores (flash_attention_bwd.cu).
//
// Bound on an H100 SXM: the larger of the bytes of q, k, v, o, dO, dq, dk,
// dv over 3.35 TB/s and 14 * B * Hq * D * pairs operations (pairs = the
// (query, key) pairs the mask keeps; seven products of 2 D each, below)
// over 989 TFLOP/s of bf16 on the tensor cores. At smollm-360M's training
// shape (q 8x15x512x64, kv 8x5, causal) the bytes bound it, 0.0125 ms, the
// products 0.0143 ms. What holds it back is latency: each tile runs two
// products, the exponentials and one or two more products in a chain, so
// loads must overlap the products and the next tile's products the
// current tile's arithmetic.
//
// L, the log-sum-exp of each q row (P = exp(scale s - L)), comes from the
// forward (flash_attention_sm90.cu writes it); +inf marks a row with no
// visible key, so P = 0 there.
//
// Design: two launches, no atomics, every sum in a fixed order, so a call
// gives the same bits every time:
//   1. flash_bwd_dq_wgmma, one block per (64-row q tile, q head, batch):
//      its consumer warpgroup first computes delta = rowsum(dO * O) of its
//      rows (16-byte loads through the strides) and writes it to a (B, Hq,
//      Sq) float32 workspace; then for each kv tile the mask lets the rows
//      see: S = Q K^T and dP = dO V^T (wgmma m64n64k16, all operands
//      K-major from 128-byte-swizzled shared memory), P = exp2(S scale log2e
//      - L log2e) and dS = P (dP - delta) in registers, dS packed to bf16 in
//      place (the accumulator layout is the A-fragment layout), and dQ +=
//      dS K (wgmma m64nDPk16, dS from registers, K the MN-major operand).
//   2. flash_bwd_dkdv_wgmma, one block per (64-key kv tile, kv head, batch):
//      K and V are loaded once and dK, dV stay in registers while it walks
//      the q tiles of all G q heads that can see a key of the tile (causal:
//      from the first key's position; window: to the last key's plus the
//      window): S^T = K Q^T and dP^T = V dO^T (K-major), P^T from L, dV +=
//      P^T dO (P^T from registers, dO MN-major), dS^T = P^T (dP^T - delta),
//      dK += dS^T Q (Q MN-major). L and delta are indexed by the column (the
//      q row) and staged beside the Q and dO tiles by the producer warp's
//      lanes. A tile's products run after the previous tile's (DkvPlan):
//      at DP 64 two blocks share an SM and fill each other's gaps.
// Seven products per visited tile pair against the five of a design whose
// dQ sums across blocks with atomics: the two extra buy determinism and no
// dq accumulation workspace. In both launches a producer warp loads the
// streamed tiles with TMA (tensor maps carry the strides and zero-fill the
// ragged tails and the head-dim padding) into a ring of stages guarded by
// mbarriers (full: the bytes landed; empty: the consumer's last product on
// the stage finished). The dQ consumer issues tile i's first two products
// together with tile i - 1's dQ product, running tile i's exponentials
// while the tensor cores do tile i - 1's accumulation, as the forward does. Head
// dims 16, 32 and 64 run as 64 (DP), 80 and 128 as 128, the columns past D
// zero-filled by TMA and never written. Every accumulation is float32; P and
// dS are rounded to bf16 once, as operands of the tensor-core products.
//
// Head dim 192 (MLA: qk 128 + 64; V padded from 128 by the model) differs
// in two ways. Registers: one warpgroup holding dK and dV (96 + 96 floats a
// thread) beside S^T and dP^T (32 + 32) would need 256, past the 255 a
// thread can have; so flash_bwd_dkdv_split_wgmma gives dV and dK to two
// consumer warpgroups that share the block's K/V tile and its ring of Q/dO
// tiles, each computing its own S^T (warpgroup 0: S^T, dV += P^T dO;
// warpgroup 1: S^T, dP^T, dK += dS^T Q), eight products per tile pair in
// the two launches against seven, with nothing exchanged between them;
// warpgroup 0 also fills the ring, as a producer warp would cost
// warpgroup 1 the registers it needs (below).
// Launch order: with G = 1 a head's K/V (dQ launch) or Q/dO (dK/dV launch)
// is 393 KB at 512 rows, and at DeepSeek-V3's 128 heads x 8 batches the
// head-fastest grid put 1,024 (head, batch) pairs, 402 MB, between two tiles
// of one head, so every tile read its operands from HBM; at DP 192 the
// tiles of one (batch, head) are the fastest grid index, neighbours in
// launch order, and read a head's operands through the 50 MB L2. The dQ
// kernel at DP 192 is the DP 64/128 one with three stages.
#include "sm90.cuh"

#include <math.h>

namespace {

constexpr int kBM = 64;        // q rows of a q tile, keys of a kv tile
constexpr int kThreads = 160;  // one consumer warpgroup, one producer warp
constexpr int kPanel = kBM * 128;  // 64 rows x 64 bf16, one TMA box
constexpr float kLog2e = 1.4426950408889634f;

// batch, head and sequence strides (elements) of one tensor
struct Str {
  long long b, h, s;
};

template <int DP>
struct DqPlan {
  static constexpr int kStages = DP == 64 ? 4 : DP == 128 ? 2 : 3;
  // the tiles of one (batch, head) neighbours in launch order (see above)
  static constexpr bool kTilesFirst = DP == 192;
  static constexpr int kTile = kBM * DP * 2;
  static constexpr int kQ = 0, kDO = kTile;                 // loaded once
  static constexpr int kK = 2 * kTile;                      // kStages K tiles
  static constexpr int kV = kK + kStages * kTile;           // kStages V tiles
  static constexpr int kDelta = kV + kStages * kTile;       // 64 floats
  static constexpr int kBar = kDelta + kBM * 4;             // q, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// dK/dV. A thread keeps dK, dV, S^T and dP^T (64 + 64 floats at DP 64).
// Overlapping tile j's products with tile j - 1's, as the dQ kernel does,
// would keep the previous tile's P^T and dS^T fragments live too, past the
// 168 registers a thread has when two blocks of 5 warps share an SM (3
// warps on one of its 4 schedulers). So the products of consecutive tiles
// run one after the other, and at DP 64 the second block on the SM fills
// the gaps; at DP 128 a block has the SM and 255 registers.
template <int DP>
struct DkvPlan {
  static constexpr int kMinBlocks = DP == 64 ? 2 : 1;
  static constexpr int kStages = DP == 64 ? 3 : 2;
  static constexpr int kTile = kBM * DP * 2;
  static constexpr int kK = 0, kV = kTile;                  // loaded once
  static constexpr int kQ = 2 * kTile;                      // kStages Q tiles
  static constexpr int kDO = kQ + kStages * kTile;          // kStages dO tiles
  static constexpr int kL = kDO + kStages * kTile;          // kStages x 64 L log2e
  static constexpr int kDl = kL + kStages * kBM * 4;        // kStages x 64 delta
  static constexpr int kBar = kDl + kStages * kBM * 4;      // kv, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// d (64 x 64) = A B^T over DP columns, A and B 64-row tiles K-major
template <int DP>
__device__ __forceinline__ void product_nt(float (&d)[32], uint32_t a, uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < DP / 16; ++kk)
    wgmma_ss_m64n64k16(d, smem_desc(a + (kk / 4) * kPanel + (kk % 4) * 32, 16, 1024),
                       smem_desc(b + (kk / 4) * kPanel + (kk % 4) * 32, 16, 1024), kk);
}

// acc (64 x DP) += A (64 x 64 keys or rows, bf16 fragments) B, B a 64-row
// tile read MN-major
template <int DP>
__device__ __forceinline__ void product_rs(float (&acc)[DP / 2], const uint32_t (&a)[16],
                                           uint32_t b) {
#pragma unroll
  for (int kk = 0; kk < kBM / 16; ++kk)
    wgmma_rs<DP>(acc, a[4 * kk], a[4 * kk + 1], a[4 * kk + 2], a[4 * kk + 3],
                 smem_desc(b + kk * 2048, kPanel, 1024));
}

__device__ __forceinline__ void pack(uint32_t (&a)[16], const float (&x)[32]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = pack_bf16(x[2 * j], x[2 * j + 1]);
}

// TMA of the DP / 64 panels of rows [s0, s0 + 64) of head h, batch b
template <int DP>
__device__ __forceinline__ void load_tile(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                          int s0, int h, int b) {
#pragma unroll
  for (int a = 0; a < DP / 64; ++a) tma_load(dst + a * kPanel, map, bar, a * 64, s0, h, b);
}

// write rows r0 and r0 + 8 (of n valid) of a 64 x DP accumulator, times
// `mul`, as bf16 pairs
template <int DP>
__device__ __forceinline__ void store_rows(__nv_bfloat16* base, long long ss, const float (&acc)[DP / 2],
                                           float mul, int r0, int col0, int n, int D) {
#pragma unroll
  for (int j = 0; j < DP / 8; ++j) {
    const int col = 8 * j + col0;
    if (col < D) {
      if (r0 < n)
        *reinterpret_cast<uint32_t*>(base + r0 * ss + col) =
            pack_bf16(acc[4 * j] * mul, acc[4 * j + 1] * mul);
      if (r0 + 8 < n)
        *reinterpret_cast<uint32_t*>(base + (r0 + 8) * ss + col) =
            pack_bf16(acc[4 * j + 2] * mul, acc[4 * j + 3] * mul);
    }
  }
}

template <int DP>
__global__ void __launch_bounds__(kThreads, DP == 64 ? 2 : 1)
flash_bwd_dq_wgmma(const __grid_constant__ CUtensorMap tmq, const __grid_constant__ CUtensorMap tmk,
                   const __grid_constant__ CUtensorMap tmv, const __grid_constant__ CUtensorMap tmdo,
                   const __nv_bfloat16* __restrict__ o, Str so,
                   const __nv_bfloat16* __restrict__ dout, Str sdo, __nv_bfloat16* __restrict__ dq,
                   Str sdq, const float* __restrict__ lse, float* __restrict__ delta, int Hq,
                   int Sq, int Skv, int D, int G, int causal, int window, int offset,
                   float scale, float scale_log2) {
  using P = DqPlan<DP>;
  constexpr int ST = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1 KB aligned
  float* dl = reinterpret_cast<float*>(smem_raw + (base - smem_addr(smem_raw)) + P::kDelta);
  const uint32_t bar_q = base + P::kBar, bar_f = bar_q + 8, bar_e = bar_f + 8 * ST;

  const int h = P::kTilesFirst ? blockIdx.y : blockIdx.x;
  const int b = P::kTilesFirst ? blockIdx.z : blockIdx.y, kvh = h / G;
  // the longest causal rows first
  const int q0 = P::kTilesFirst ? (gridDim.x - 1 - blockIdx.x) * kBM
                                : (gridDim.z - 1 - blockIdx.z) * kBM;
  const int n_q = min(kBM, Sq - q0);
  // kv range this q tile can see: [window start, causal frontier]
  const int q_lo = offset + q0, q_hi = offset + q0 + n_q - 1;
  const int kv_end = causal ? min(Skv, q_hi + 1) : Skv;
  const int kv_start = window >= 0 ? max(0, q_lo - window + 1) : 0;
  const int t_begin = kv_start / kBM;
  const int n_tiles = kv_end > kv_start ? (kv_end + kBM - 1) / kBM - t_begin : 0;
  const long long row0 = ((long long)b * Hq + h) * Sq + q0;  // of L and delta

  if (threadIdx.x == 0) {
    mbar_init(bar_q, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_f + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 4);  // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= 128) {
    // producer: one thread issues every copy
    if (threadIdx.x == 128 && n_tiles > 0) {
      mbar_expect_tx(bar_q, 2 * P::kTile);
      load_tile<DP>(base + P::kQ, &tmq, bar_q, q0, h, b);
      load_tile<DP>(base + P::kDO, &tmdo, bar_q, q0, h, b);
      for (int i = 0; i < n_tiles; ++i) {
        const int s = i % ST;
        if (i >= ST) mbar_wait(bar_e + 8 * s, ((i / ST) & 1) ^ 1);  // released last round
        const int k0 = (t_begin + i) * kBM;
        mbar_expect_tx(bar_f + 8 * s, 2 * P::kTile);
        load_tile<DP>(base + P::kK + s * P::kTile, &tmk, bar_f + 8 * s, k0, kvh, b);
        load_tile<DP>(base + P::kV + s * P::kTile, &tmv, bar_f + 8 * s, k0, kvh, b);
      }
    }
    return;
  }

  const int t = threadIdx.x, lane = t % 32;
  // delta = rowsum(dO * O): two threads per row, 8 columns a load
  {
    const int r = t / 2;
    float acc = 0.f;
    if (r < n_q) {
      const __nv_bfloat16* orow = o + b * so.b + h * so.h + (q0 + r) * so.s;
      const __nv_bfloat16* grow = dout + b * sdo.b + h * sdo.h + (q0 + r) * sdo.s;
      for (int c = (t % 2) * 8; c < D; c += 16) {
        const uint4 ov = *reinterpret_cast<const uint4*>(orow + c);
        const uint4 gv = *reinterpret_cast<const uint4*>(grow + c);
        const __nv_bfloat162* op = reinterpret_cast<const __nv_bfloat162*>(&ov);
        const __nv_bfloat162* gp = reinterpret_cast<const __nv_bfloat162*>(&gv);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float2 of = __bfloat1622float2(op[e]), gf = __bfloat1622float2(gp[e]);
          acc = fmaf(of.x, gf.x, acc);
          acc = fmaf(of.y, gf.y, acc);
        }
      }
    }
    acc += __shfl_xor_sync(0xffffffffu, acc, 1);
    if (t % 2 == 0) {
      dl[r] = acc;
      if (r < n_q) delta[row0 + r] = acc;
    }
  }
  asm volatile("bar.sync 1, 128;\n" ::: "memory");  // the consumer warpgroup only

  const int r0 = (t / 32) * 16 + lane / 4;  // rows r0 and r0 + 8 of the tile
  const int qp0 = q_lo + r0, qp1 = qp0 + 8;
  const int col0 = 2 * (lane % 4);
  const float dl0 = dl[r0], dl1 = dl[r0 + 8];
  const float nl0 = r0 < n_q ? -lse[row0 + r0] * kLog2e : -INFINITY;
  const float nl1 = r0 + 8 < n_q ? -lse[row0 + r0 + 8] * kLog2e : -INFINITY;
  float acc[DP / 2];
#pragma unroll
  for (int r = 0; r < DP / 2; ++r) acc[r] = 0.f;
  float sc[32], dp[32];  // S then dS; dP
  uint32_t pa[16];       // the previous tile's dS as bf16 A fragments

  const auto issue_sdp = [&](int i) {
    const int s = i % ST;
    mbar_wait(bar_f + 8 * s, (i / ST) & 1);
    product_nt<DP>(sc, base + P::kQ, base + P::kK + s * P::kTile);
    product_nt<DP>(dp, base + P::kDO, base + P::kV + s * P::kTile);
    wgmma_commit();
  };
  // dS = P (dP - delta), P = exp2(S scale log2e - L log2e), in sc; only the
  // ragged Skv tail, the causal diagonal and the window's lower edge need a
  // mask, which keeps keys in [lo, hi] of each row
  const auto grads = [&](int k0) {
    if (k0 + kBM > Skv || (causal && k0 + kBM - 1 > q_lo) ||
        (window >= 0 && k0 <= q_lo + kBM - 1 - window)) {
      const int first = k0 + col0;
      const int hi0 = (causal ? min(Skv - 1, qp0) : Skv - 1) - first;
      const int hi1 = (causal ? min(Skv - 1, qp1) : Skv - 1) - first;
      const int lo0 = (window >= 0 ? qp0 - window + 1 : 0) - first;
      const int lo1 = (window >= 0 ? qp1 - window + 1 : 0) - first;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int c = 8 * (r >> 2) + (r & 1);
        const bool out = (r & 2) ? (c < lo1 || c > hi1) : (c < lo0 || c > hi0);
        if (out) sc[r] = -INFINITY;
      }
    }
#pragma unroll
    for (int r = 0; r < 32; ++r) {
      const float p = exp2_ftz(fmaf(sc[r], scale_log2, (r & 2) ? nl1 : nl0));
      sc[r] = p * (dp[r] - ((r & 2) ? dl1 : dl0));
    }
  };
  const auto issue_dq = [&](int i) {
    product_rs<DP>(acc, pa, base + P::kK + (i % ST) * P::kTile);
    wgmma_commit();
  };
  const auto release = [&](int i) {
    if (lane == 0) mbar_arrive(bar_e + 8 * (i % ST));
  };

  if (n_tiles > 0) {
    mbar_wait(bar_q, 0);
    wgmma_fence();
    issue_sdp(0);
    wgmma_wait<0>();
    fence_regs(sc);
    fence_regs(dp);
    grads(t_begin * kBM);
    pack(pa, sc);
    // tile i's S and dP are issued together with tile i - 1's dQ product;
    // tile i's exponentials run while the tensor cores do that product
    for (int i = 1; i < n_tiles; ++i) {
      wgmma_fence();
      issue_sdp(i);
      issue_dq(i - 1);
      wgmma_wait<1>();
      fence_regs(sc);
      fence_regs(dp);
      grads((t_begin + i) * kBM);
      wgmma_wait<0>();
      fence_regs(acc);
      fence_regs(pa);
      release(i - 1);
      pack(pa, sc);
    }
    wgmma_fence();
    issue_dq(n_tiles - 1);
    wgmma_wait<0>();
    fence_regs(acc);
    release(n_tiles - 1);
  }
  store_rows<DP>(dq + b * sdq.b + h * sdq.h + q0 * sdq.s, sdq.s, acc, scale, r0, col0, n_q, D);
}

template <int DP>
__global__ void __launch_bounds__(kThreads, DkvPlan<DP>::kMinBlocks)
flash_bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap tmq,
                     const __grid_constant__ CUtensorMap tmk,
                     const __grid_constant__ CUtensorMap tmv,
                     const __grid_constant__ CUtensorMap tmdo, __nv_bfloat16* __restrict__ dk,
                     Str sdk, __nv_bfloat16* __restrict__ dv, Str sdv,
                     const float* __restrict__ lse, const float* __restrict__ delta, int Hq,
                     int Sq, int Skv, int D, int G, int causal, int window, int offset,
                     float scale, float scale_log2) {
  using P = DkvPlan<DP>;
  constexpr int ST = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  float* ls = reinterpret_cast<float*>(gbase + P::kL);    // -L log2e per stage and q row
  float* dls = reinterpret_cast<float*>(gbase + P::kDl);  // delta per stage and q row
  const uint32_t bar_kv = base + P::kBar, bar_f = bar_kv + 8, bar_e = bar_f + 8 * ST;

  const int kvh = blockIdx.x, b = blockIdx.y;
  const int k0 = blockIdx.z * kBM;  // the first keys see the most q rows under causal
  const int n_k = min(kBM, Skv - k0);
  // q rows that see a key of the tile: causal, from the first key's
  // position; window, up to the last key's position plus the window
  const int q_begin = causal ? max(0, k0 - offset) : 0;
  const int q_end = window >= 0 ? min(Sq, k0 + n_k - 1 - offset + window) : Sq;
  const int t0 = q_begin / kBM;
  const int n_qt = q_begin < q_end ? (q_end + kBM - 1) / kBM - t0 : 0;
  const int n_iter = G * n_qt;  // (q head, q tile) pairs, head-major

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_f + 8 * s, 32);  // every producer lane, after its L/delta stores
      mbar_init(bar_e + 8 * s, 4);   // one arrival per consumer warp
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32;
  if (threadIdx.x >= 128) {
    // producer warp: lane 0 issues the copies, every lane stages L and delta
    if (n_iter == 0) return;
    if (lane == 0) {
      mbar_expect_tx(bar_kv, 2 * P::kTile);
      load_tile<DP>(base + P::kK, &tmk, bar_kv, k0, kvh, b);
      load_tile<DP>(base + P::kV, &tmv, bar_kv, k0, kvh, b);
    }
    for (int j = 0; j < n_iter; ++j) {
      const int s = j % ST;
      if (j >= ST) mbar_wait(bar_e + 8 * s, ((j / ST) & 1) ^ 1);
      const int h = kvh * G + j / n_qt, q0 = (t0 + j % n_qt) * kBM;
      const long long row0 = ((long long)b * Hq + h) * Sq + q0;
      for (int rr = lane; rr < kBM; rr += 32) {
        const bool in = q0 + rr < Sq;
        ls[s * kBM + rr] = in ? -lse[row0 + rr] * kLog2e : -INFINITY;
        dls[s * kBM + rr] = in ? delta[row0 + rr] : 0.f;
      }
      if (lane == 0) {
        mbar_expect_tx(bar_f + 8 * s, 2 * P::kTile);
        load_tile<DP>(base + P::kQ + s * P::kTile, &tmq, bar_f + 8 * s, q0, h, b);
        load_tile<DP>(base + P::kDO + s * P::kTile, &tmdo, bar_f + 8 * s, q0, h, b);
      } else {
        mbar_arrive(bar_f + 8 * s);
      }
    }
    return;
  }

  const int t = threadIdx.x;
  const int r0 = (t / 32) * 16 + lane / 4;  // keys r0 and r0 + 8 of the tile
  const int kp0 = k0 + r0, kp1 = kp0 + 8;
  const int col0 = 2 * (lane % 4);          // first of this thread's q rows per 8
  float dka[DP / 2], dva[DP / 2];
#pragma unroll
  for (int r = 0; r < DP / 2; ++r) dka[r] = dva[r] = 0.f;
  float st[32], dpt[32];     // S^T then P^T; dP^T then dS^T
  uint32_t pp[16], pd[16];   // P^T and dS^T as bf16 A fragments

  const auto issue_sdp = [&](int j) {
    const int s = j % ST;
    mbar_wait(bar_f + 8 * s, (j / ST) & 1);
    product_nt<DP>(st, base + P::kK, base + P::kQ + s * P::kTile);
    product_nt<DP>(dpt, base + P::kV, base + P::kDO + s * P::kTile);
    wgmma_commit();
  };
  // P^T and dS^T of the q tile at q0: column c is q row q0 + c, at position
  // offset + q0 + c; a key kp sees it if kp <= its position (causal) and
  // kp > its position - window
  const auto grads = [&](int j) {
    const int s = j % ST;
    const int q0 = (t0 + j % n_qt) * kBM, qpos0 = offset + q0;
    if ((causal && qpos0 < k0 + kBM - 1) || (window >= 0 && qpos0 + kBM - 1 > k0 + window - 1)) {
      const int lo0 = causal ? kp0 - qpos0 : -(1 << 30);
      const int lo1 = causal ? kp1 - qpos0 : -(1 << 30);
      const int hi0 = window >= 0 ? kp0 + window - 1 - qpos0 : 1 << 30;
      const int hi1 = window >= 0 ? kp1 + window - 1 - qpos0 : 1 << 30;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int c = 8 * (r >> 2) + col0 + (r & 1);
        const bool out = (r & 2) ? (c < lo1 || c > hi1) : (c < lo0 || c > hi0);
        if (out) st[r] = -INFINITY;
      }
    }
    const float* lrow = ls + s * kBM + col0;
    const float* drow = dls + s * kBM + col0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 nl = *reinterpret_cast<const float2*>(lrow + 8 * jj);
      const float2 dd = *reinterpret_cast<const float2*>(drow + 8 * jj);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * jj + e;
        const float p = exp2_ftz(fmaf(st[r], scale_log2, (e & 1) ? nl.y : nl.x));
        st[r] = p;
        dpt[r] = p * (dpt[r] - ((e & 1) ? dd.y : dd.x));
      }
    }
  };
  const auto issue_dkdv = [&](int j) {
    const int s = j % ST;
    product_rs<DP>(dva, pp, base + P::kDO + s * P::kTile);
    product_rs<DP>(dka, pd, base + P::kQ + s * P::kTile);
    wgmma_commit();
  };
  const auto release = [&](int j) {
    if (lane == 0) mbar_arrive(bar_e + 8 * (j % ST));
  };

  if (n_iter > 0) {
    mbar_wait(bar_kv, 0);
    wgmma_fence();
    issue_sdp(0);
    wgmma_wait<0>();
    fence_regs(st);
    fence_regs(dpt);
    grads(0);
    pack(pp, st);
    pack(pd, dpt);
    for (int j = 1; j < n_iter; ++j) {
      wgmma_fence();
      issue_dkdv(j - 1);
      wgmma_wait<0>();
      fence_regs(dka);
      fence_regs(dva);
      release(j - 1);
      wgmma_fence();
      issue_sdp(j);
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      grads(j);
      pack(pp, st);
      pack(pd, dpt);
    }
    wgmma_fence();
    issue_dkdv(n_iter - 1);
    wgmma_wait<0>();
    fence_regs(dka);
    fence_regs(dva);
    release(n_iter - 1);
  }
  store_rows<DP>(dk + b * sdk.b + kvh * sdk.h + k0 * sdk.s, sdk.s, dka, scale, r0, col0, n_k, D);
  store_rows<DP>(dv + b * sdv.b + kvh * sdv.h + k0 * sdv.s, sdv.s, dva, 1.f, r0, col0, n_k, D);
}

// dK/dV at DP 192 on two consumer warpgroups (see above) and no producer
// warp: a ninth warp would cap a thread at 224 registers (65536 / 288 in
// steps of 8), where warpgroup 1 (dK 96 + S^T 32 + dP^T 32 accumulators and
// the products' descriptors) spilled and ptxas serialised its wgmma
// (C7512); at 256 threads a thread has 255. Warpgroup 0, the lighter,
// also fills the ring: thread 0 issues the TMA copies and its 128 threads
// stage L and delta, each arriving on the stage's full barrier; it refills
// stage s with tile j + kStages once both warpgroups have released tile j.
struct DkvSplitPlan {
  static constexpr int kDP = 192;
  static constexpr int kStages = 3;
  static constexpr int kThreads = 256;
  static constexpr int kTile = kBM * kDP * 2;
  static constexpr int kK = 0, kV = kTile;                  // loaded once
  static constexpr int kQ = 2 * kTile;                      // kStages Q tiles
  static constexpr int kDO = kQ + kStages * kTile;          // kStages dO tiles
  static constexpr int kL = kDO + kStages * kTile;          // kStages x 64 -L log2e
  static constexpr int kDl = kL + kStages * kBM * 4;        // kStages x 64 delta
  static constexpr int kBar = kDl + kStages * kBM * 4;      // kv, full[], empty[]
  static constexpr int kBytes = kBar + 8 * (1 + 2 * kStages) + 1024;
};

// One thread's copy (where `p`) issued without a branch: a lane-dependent
// branch between wgmma groups can make ptxas serialise them.
__device__ __forceinline__ void tma_load_if(bool p, uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int d0, int s0, int h, int b) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %7, 0;\n"
      "@p cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n}\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(s0), "r"(h), "r"(b),
      "r"(static_cast<int>(p))
      : "memory");
}

// Arrive on `bar`, announcing `bytes` of TMA where `p`.
__device__ __forceinline__ void mbar_arrive_expect_if(bool p, uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %2, 0;\n"
      "@p mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
      "@!p mbarrier.arrive.shared::cta.b64 _, [%0];\n}\n" ::"r"(bar),
      "r"(bytes), "r"(static_cast<int>(p))
      : "memory");
}

__global__ void __launch_bounds__(DkvSplitPlan::kThreads, 1)
flash_bwd_dkdv_split_wgmma(const __grid_constant__ CUtensorMap tmq,
                           const __grid_constant__ CUtensorMap tmk,
                           const __grid_constant__ CUtensorMap tmv,
                           const __grid_constant__ CUtensorMap tmdo,
                           __nv_bfloat16* __restrict__ dk, Str sdk,
                           __nv_bfloat16* __restrict__ dv, Str sdv,
                           const float* __restrict__ lse, const float* __restrict__ delta,
                           int Hq, int Sq, int Skv, int D, int G, int causal, int window,
                           int offset, float scale, float scale_log2) {
  using P = DkvSplitPlan;
  constexpr int DP = P::kDP, ST = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;
  uint8_t* gbase = smem_raw + (base - smem_addr(smem_raw));
  float* ls = reinterpret_cast<float*>(gbase + P::kL);    // -L log2e per stage and q row
  float* dls = reinterpret_cast<float*>(gbase + P::kDl);  // delta per stage and q row
  const uint32_t bar_kv = base + P::kBar, bar_f = bar_kv + 8, bar_e = bar_f + 8 * ST;

  // the kv tiles of one (batch, kv head) are neighbours in launch order
  const int kvh = blockIdx.y, b = blockIdx.z;
  const int k0 = blockIdx.x * kBM;
  const int n_k = min(kBM, Skv - k0);
  const int q_begin = causal ? max(0, k0 - offset) : 0;
  const int q_end = window >= 0 ? min(Sq, k0 + n_k - 1 - offset + window) : Sq;
  const int t0 = q_begin / kBM;
  const int n_qt = q_begin < q_end ? (q_end + kBM - 1) / kBM - t0 : 0;
  const int n_iter = G * n_qt;  // (q head, q tile) pairs, head-major

  if (threadIdx.x == 0) {
    mbar_init(bar_kv, 1);
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_f + 8 * s, 128);  // every thread of warpgroup 0, after its L/delta store
      mbar_init(bar_e + 8 * s, 8);    // one arrival per consumer warp of both warpgroups
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  const int lane = threadIdx.x % 32, t = threadIdx.x % 128;
  // the same value in every lane, so ptxas sees the branches below as uniform
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  const bool issuer = threadIdx.x == 0;
  // warpgroup 0 fills stage j % ST with tile j: Q and dO by TMA (thread
  // 0), -L log2e (threads 0-63) and delta (64-127) of its 64 q rows
  const auto fill = [&](int j) {
    const int s = j % ST;
    const int h = kvh * G + j / n_qt, q0 = (t0 + j % n_qt) * kBM;
    const int rr = t % kBM;
    const bool is_l = t < kBM, in = q0 + rr < Sq;
    const long long row = ((long long)b * Hq + h) * Sq + q0 + rr;
    const float v = in ? (is_l ? lse : delta)[row] : 0.f;
    (is_l ? ls : dls)[s * kBM + rr] = is_l ? (in ? -v * kLog2e : -INFINITY) : v;
    mbar_arrive_expect_if(issuer, bar_f + 8 * s, 2 * P::kTile);
#pragma unroll
    for (int a = 0; a < DP / 64; ++a) {
      tma_load_if(issuer, base + P::kQ + s * P::kTile + a * kPanel, &tmq, bar_f + 8 * s, a * 64,
                  q0, h, b);
      tma_load_if(issuer, base + P::kDO + s * P::kTile + a * kPanel, &tmdo, bar_f + 8 * s,
                  a * 64, q0, h, b);
    }
  };
  if (wg == 0 && n_iter > 0) {
    if (issuer) mbar_expect_tx(bar_kv, 2 * P::kTile);
#pragma unroll
    for (int a = 0; a < DP / 64; ++a) {
      tma_load_if(issuer, base + P::kK + a * kPanel, &tmk, bar_kv, a * 64, k0, kvh, b);
      tma_load_if(issuer, base + P::kV + a * kPanel, &tmv, bar_kv, a * 64, k0, kvh, b);
    }
    for (int j = 0; j < min(ST, n_iter); ++j) fill(j);
  }

  const int r0 = (t / 32) * 16 + lane / 4;  // keys r0 and r0 + 8 of the tile
  const int kp0 = k0 + r0, kp1 = kp0 + 8;
  const int col0 = 2 * (lane % 4);          // first of this thread's q rows per 8
  float acc[DP / 2];                        // dV (warpgroup 0) or dK (warpgroup 1)
#pragma unroll
  for (int r = 0; r < DP / 2; ++r) acc[r] = 0.f;
  float st[32];      // S^T then P^T
  uint32_t pa[16];   // P^T or dS^T as bf16 A fragments

  // P^T of the q tile of iteration j, in st: column c is q row q0 + c, at
  // position offset + q0 + c; a key kp sees it if kp <= its position
  // (causal) and kp > its position - window
  const auto probs = [&](int j) {
    const int s = j % ST;
    const int q0 = (t0 + j % n_qt) * kBM, qpos0 = offset + q0;
    if ((causal && qpos0 < k0 + kBM - 1) || (window >= 0 && qpos0 + kBM - 1 > k0 + window - 1)) {
      const int lo0 = causal ? kp0 - qpos0 : -(1 << 30);
      const int lo1 = causal ? kp1 - qpos0 : -(1 << 30);
      const int hi0 = window >= 0 ? kp0 + window - 1 - qpos0 : 1 << 30;
      const int hi1 = window >= 0 ? kp1 + window - 1 - qpos0 : 1 << 30;
#pragma unroll
      for (int r = 0; r < 32; ++r) {
        const int c = 8 * (r >> 2) + col0 + (r & 1);
        const bool out = (r & 2) ? (c < lo1 || c > hi1) : (c < lo0 || c > hi0);
        if (out) st[r] = -INFINITY;
      }
    }
    const float* lrow = ls + s * kBM + col0;
#pragma unroll
    for (int jj = 0; jj < 8; ++jj) {
      const float2 nl = *reinterpret_cast<const float2*>(lrow + 8 * jj);
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = 4 * jj + e;
        st[r] = exp2_ftz(fmaf(st[r], scale_log2, (e & 1) ? nl.y : nl.x));
      }
    }
  };
  const auto release = [&](int j) {
    if (lane == 0) mbar_arrive(bar_e + 8 * (j % ST));
  };

  if (n_iter > 0) mbar_wait(bar_kv, 0);
  if (wg == 0) {
    // dV += P^T dO
    for (int j = 0; j < n_iter; ++j) {
      const int s = j % ST;
      mbar_wait(bar_f + 8 * s, (j / ST) & 1);
      wgmma_fence();
      product_nt<DP>(st, base + P::kK, base + P::kQ + s * P::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      probs(j);
      pack(pa, st);
      wgmma_fence();
      product_rs<DP>(acc, pa, base + P::kDO + s * P::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(j);
      if (j + ST < n_iter) {
        // both warpgroups are done with tile j: refill its stage
        mbar_wait(bar_e + 8 * s, (j / ST) & 1);
        fill(j + ST);
      }
    }
    store_rows<DP>(dv + b * sdv.b + kvh * sdv.h + k0 * sdv.s, sdv.s, acc, 1.f, r0, col0, n_k, D);
  } else {
    // dK += dS^T Q, dS^T = P^T (dP^T - delta)
    float dpt[32];
    for (int j = 0; j < n_iter; ++j) {
      const int s = j % ST;
      mbar_wait(bar_f + 8 * s, (j / ST) & 1);
      wgmma_fence();
      product_nt<DP>(st, base + P::kK, base + P::kQ + s * P::kTile);
      product_nt<DP>(dpt, base + P::kV, base + P::kDO + s * P::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(st);
      fence_regs(dpt);
      probs(j);
      const float* drow = dls + s * kBM + col0;
#pragma unroll
      for (int jj = 0; jj < 8; ++jj) {
        const float2 dd = *reinterpret_cast<const float2*>(drow + 8 * jj);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = 4 * jj + e;
          dpt[r] = st[r] * (dpt[r] - ((e & 1) ? dd.y : dd.x));
        }
      }
      pack(pa, dpt);
      wgmma_fence();
      product_rs<DP>(acc, pa, base + P::kQ + s * P::kTile);
      wgmma_commit();
      wgmma_wait<0>();
      fence_regs(acc);
      release(j);
    }
    store_rows<DP>(dk + b * sdk.b + kvh * sdk.h + k0 * sdk.s, sdk.s, acc, scale, r0, col0, n_k,
                   D);
  }
}

template <int DP>
cudaError_t launch(const void* q, const void* k, const void* v, const void* o, const void* dout,
                   void* dq, void* dk, void* dv, const float* lse, float* delta,
                   const long long* st, int B, int Hq, int Hkv, int Sq, int Skv, int D,
                   int causal, int window, int offset, float scale, cudaStream_t stream) {
  constexpr bool kSplit = DP == 192;  // dK/dV on two consumer warpgroups
  static const cudaError_t setup = [] {
    cudaError_t err = cudaFuncSetAttribute(flash_bwd_dq_wgmma<DP>,
                                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                                           DqPlan<DP>::kBytes);
    if (err != cudaSuccess) return err;
    if constexpr (DP == 192)
      return cudaFuncSetAttribute(flash_bwd_dkdv_split_wgmma,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DkvSplitPlan::kBytes);
    else
      return cudaFuncSetAttribute(flash_bwd_dkdv_wgmma<DP>,
                                  cudaFuncAttributeMaxDynamicSharedMemorySize,
                                  DkvPlan<DP>::kBytes);
  }();
  if (setup != cudaSuccess) return setup;
  // st: (batch, head, sequence) of q, k, v, o, dout, dq, dk, dv
  const auto str = [&](int i) { return Str{st[3 * i], st[3 * i + 1], st[3 * i + 2]}; };
  CUtensorMap tq, tk, tv, tdo;
  if (!encode(&tq, q, B, Hq, Sq, D, st[0], st[1], st[2], kBM) ||
      !encode(&tk, k, B, Hkv, Skv, D, st[3], st[4], st[5], kBM) ||
      !encode(&tv, v, B, Hkv, Skv, D, st[6], st[7], st[8], kBM) ||
      !encode(&tdo, dout, B, Hq, Sq, D, st[12], st[13], st[14], kBM))
    return cudaErrorInvalidValue;
  const int G = Hq / Hkv;
  const float scale_log2 = scale * kLog2e;
  const int q_tiles = (Sq + kBM - 1) / kBM, kv_tiles = (Skv + kBM - 1) / kBM;
  const dim3 dq_grid = DqPlan<DP>::kTilesFirst ? dim3(q_tiles, Hq, B) : dim3(Hq, B, q_tiles);
  flash_bwd_dq_wgmma<DP><<<dq_grid, kThreads, DqPlan<DP>::kBytes, stream>>>(
      tq, tk, tv, tdo, static_cast<const __nv_bfloat16*>(o), str(3),
      static_cast<const __nv_bfloat16*>(dout), str(4), static_cast<__nv_bfloat16*>(dq), str(5),
      lse, delta, Hq, Sq, Skv, D, G, causal, window, offset, scale, scale_log2);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  if constexpr (kSplit)
    flash_bwd_dkdv_split_wgmma<<<dim3(kv_tiles, Hkv, B), DkvSplitPlan::kThreads,
                                 DkvSplitPlan::kBytes, stream>>>(
        tq, tk, tv, tdo, static_cast<__nv_bfloat16*>(dk), str(6),
        static_cast<__nv_bfloat16*>(dv), str(7), lse, delta, Hq, Sq, Skv, D, G, causal, window,
        offset, scale, scale_log2);
  else
    flash_bwd_dkdv_wgmma<DP><<<dim3(Hkv, B, kv_tiles), kThreads, DkvPlan<DP>::kBytes,
                               stream>>>(
        tq, tk, tv, tdo, static_cast<__nv_bfloat16*>(dk), str(6),
        static_cast<__nv_bfloat16*>(dv), str(7), lse, delta, Hq, Sq, Skv, D, G, causal, window,
        offset, scale, scale_log2);
  return cudaGetLastError();
}

}  // namespace

// The bf16 backward on the tensor cores. Arguments as flash_attention_bwd
// (flash_attention_bwd.cu), except that lse is read, not written: (B, Hq,
// Sq) float32, each q row's log-sum-exp as the forward wrote it. q, k, v, o
// and dout: 16-byte aligned, strides multiples of 8 elements (TMA and
// 16-byte loads); dq, dk, dv: strides even. Head dims 16, 32, 64 (as 64),
// 80, 128 (as 128), 192. Returns a cudaError_t code.
extern "C" int flash_attention_bwd_wgmma(const void* q, const void* k, const void* v,
                                         const void* o, const void* dout, void* dq, void* dk,
                                         void* dv, const void* lse, void* delta,
                                         const long long* strides, int B, int Hq, int Hkv,
                                         int Sq, int Skv, int D, int causal, int window,
                                         int offset, float scale, void* stream) {
  if (B <= 0 || B > 65535 || Hkv <= 0 || Hq % Hkv != 0 || Hq > 65535 || Sq <= 0 || Skv <= 0 ||
      offset < 0 || (Sq + kBM - 1) / kBM > 65535 || (Skv + kBM - 1) / kBM > 65535)
    return cudaErrorInvalidValue;
  if ((reinterpret_cast<uintptr_t>(q) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(o) |
       reinterpret_cast<uintptr_t>(dout)) % 16 != 0)
    return cudaErrorMisalignedAddress;
  for (int i = 0; i < 15; ++i)
    if (strides[i] % 8 != 0) return cudaErrorInvalidValue;
  for (int i = 15; i < 24; ++i)
    if (strides[i] % 2 != 0) return cudaErrorInvalidValue;
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 16 || D == 32 || D == 64)
    return launch<64>(q, k, v, o, dout, dq, dk, dv, l, dl, strides, B, Hq, Hkv, Sq, Skv, D,
                      causal, window, offset, scale, s);
  if (D == 80 || D == 128)
    return launch<128>(q, k, v, o, dout, dq, dk, dv, l, dl, strides, B, Hq, Hkv, Sq, Skv, D,
                       causal, window, offset, scale, s);
  if (D == 192)
    return launch<192>(q, k, v, o, dout, dq, dk, dv, l, dl, strides, B, Hq, Hkv, Sq, Skv, D,
                       causal, window, offset, scale, s);
  return cudaErrorInvalidValue;
}
