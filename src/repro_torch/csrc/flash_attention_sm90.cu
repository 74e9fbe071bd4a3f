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
// softmax runs while the tensor cores do that P V. Head dims 64 and 128 are
// native; 16 and 32 run as 64, 80 as 128 (DP), the columns beyond D
// zero-filled by TMA and never written back. The softmax and both accumulations are float32 and
// the output is rounded once to bf16. A row whose every key is masked
// returns 0: its running max stays -inf and its sum 0.
#include "common.cuh"

#include <cuda.h>  // CUtensorMap and its enums; no driver library is linked
#include <math.h>

namespace {

constexpr int kRows = 64;           // q rows per warpgroup (one wgmma M)
constexpr int kBN = 64;             // keys per kv tile (one wgmma N of S)
constexpr int kProducerRegs = 40;

// DP: head dim padded to 64 or 128; NC: consumer warpgroups (q heads) per
// block.
template <int DP, int NC>
struct Plan {
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

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar), "r"(count) : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(bar), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar) : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n.reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

// Wait until the phase of parity `parity` of the barrier has completed. A
// wait beyond 10 s traps, so a broken pipeline fails the launch instead of
// hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  uint64_t t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t0));
  while (!mbar_try_wait(bar, parity)) {
    asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
    if (t - t0 > 10000000000ull) __trap();
  }
}

// One 64 x 64 box of a (D, S, H, B) tensor map into shared memory.
__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map, uint32_t bar,
                                         int d0, int s0, int h, int b) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(d0), "r"(s0), "r"(h), "r"(b)
      : "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle. K-major operands (Q, K):
// rows of 128 bytes, 8-row groups 1024 bytes apart (SBO); a k16 step moves
// the start 32 bytes along the row. MN-major V: LBO = 8192 bytes between the
// 64-column panels of D, SBO = 1024 bytes between groups of 8 keys.
__device__ __forceinline__ uint64_t smem_desc(uint32_t addr, uint32_t lbo, uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) | (static_cast<uint64_t>(sbo >> 4) << 32) |
         (1ull << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
// Wait until at most N committed groups of this warpgroup are in flight.
template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Keep the compiler from moving reads or writes of registers across the
// asynchronous product that reads or writes them.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 64, float32) = A (64 x 16) * B (16 x 64), A and B K-major in shared memory;
// D += A * B when scale_d is nonzero, D = A * B otherwise.
__device__ __forceinline__ void wgmma_ss_m64n64k16(float (&d)[32], uint64_t da, uint64_t db,
                                                int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 64, float32) += A (64 x 16, bf16 pairs in registers) * B (16 x 64),
// B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n64k16(float (&d)[32], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

// D (64 x 128, float32) += A (64 x 16, bf16 pairs in registers) * B (16 x 128),
// B MN-major (transposed) in shared memory.
__device__ __forceinline__ void wgmma_rs_m64n128k16(float (&d)[64], uint32_t a0, uint32_t a1,
                                                uint32_t a2, uint32_t a3, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]), "+f"(d[16]), "+f"(d[17]),
        "+f"(d[18]), "+f"(d[19]), "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]), "+f"(d[41]),
        "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]),
        "+f"(d[54]), "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a0), "r"(a1), "r"(a2), "r"(a3), "l"(db), "r"(1));
}

template <int DP>
__device__ __forceinline__ void wgmma_pv(float (&o)[DP / 2], uint32_t a0, uint32_t a1,
                                         uint32_t a2, uint32_t a3, uint64_t db) {
  if constexpr (DP == 64) {
    wgmma_rs_m64n64k16(o, a0, a1, a2, a3, db);
  } else {
    wgmma_rs_m64n128k16(o, a0, a1, a2, a3, db);
  }
}

// 2^x on the special-function unit, subnormal results flushed to 0 (a
// probability below 2^-126 of the row's largest is 0 in bf16 anyway).
__device__ __forceinline__ float exp2_ftz(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);  // .x (low half) = lo
  return *reinterpret_cast<uint32_t*>(&v);
}

// Accumulator element r of a thread (lane l of warp w in its warpgroup)
// sits at row 16 w + l / 4 + 8 ((r >> 1) & 1) and column
// 8 (r >> 2) + 2 (l % 4) + (r & 1).
template <int DP, int NC>
__global__ void __launch_bounds__(Plan<DP, NC>::kThreads, Plan<DP, NC>::kMinBlocks)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv, __nv_bfloat16* __restrict__ o,
                      long long sob, long long soh, long long sos, int Sq, int Skv, int D,
                      int G, int causal, int window, int offset, float scale_log2) {
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
        wgmma_pv<DP>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
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
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

EncodeTiled encoder() {
  static EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                       cudaEnableDefault, &found);
#else
    cudaError_t err = cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault,
                                              &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

// A (D, S, H, B) tensor map of a bf16 (B, H, S, D) tensor with the given
// element strides (the last dim contiguous), read in boxes of `rows` x 64
// with the 128-byte swizzle; rows and columns outside the tensor read as
// zero.
bool encode(CUtensorMap* map, const void* ptr, int B, int H, int S, int D, long long sb,
            long long sh, long long ss, int rows) {
  EncodeTiled fn = encoder();
  if (fn == nullptr) return false;
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)S, (cuuint64_t)H, (cuuint64_t)B};
  const cuuint64_t strides[3] = {(cuuint64_t)ss * 2, (cuuint64_t)sh * 2, (cuuint64_t)sb * 2};
  const cuuint32_t box[4] = {64, (cuuint32_t)rows, 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr), dims, strides, box,
            elem, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
            CU_TENSOR_MAP_L2_PROMOTION_L2_128B, CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int DP, int NC>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, const long long* sq,
                   const long long* sk, const long long* sv, const long long* so, int B, int Hq,
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
      tq, tk, tv, static_cast<__nv_bfloat16*>(o), so[0], so[1], so[2], Sq, Skv, D, G, causal,
      window, offset, scale * 1.4426950408889634f);
  return cudaGetLastError();
}

}  // namespace

namespace repro {

// The bf16 instance of flash_attention_fwd (flash_attention.cu). Strides are
// in elements, (batch, head, sequence) for each of q, k, v, o; every stride
// and pointer is 16-byte aligned and the last dim contiguous.
cudaError_t flash_attention_wgmma_bf16(const void* q, const void* k, const void* v, void* o,
                                       const long long* sq, const long long* sk,
                                       const long long* sv, const long long* so, int B,
                                       int Hq, int Hkv, int Sq, int Skv, int D, int causal,
                                       int window, int offset, float scale,
                                       cudaStream_t stream) {
  if (D != 16 && D != 32 && D != 64 && D != 80 && D != 128) return cudaErrorInvalidValue;
  if (B > 65535 || (Sq + kRows - 1) / kRows > 65535) return cudaErrorInvalidConfiguration;
  // D <= 64: the three q heads of a kv head per block where G is a multiple
  // of 3 (smollm), else one per block, small enough that two blocks share an
  // SM; D > 64: two q heads per block where G is even.
  const int G = Hq / Hkv;
#define REPRO_GO(DP, NC)                                                                   \
  return launch<DP, NC>(q, k, v, o, sq, sk, sv, so, B, Hq, Hkv, Sq, Skv, D, causal, window, \
                        offset, scale, stream)
  if (D <= 64 && G % 3 == 0) REPRO_GO(64, 3);
  if (D <= 64) REPRO_GO(64, 1);
  if (G % 2 == 0) REPRO_GO(128, 2);
  REPRO_GO(128, 1);
#undef REPRO_GO
}

}  // namespace repro
