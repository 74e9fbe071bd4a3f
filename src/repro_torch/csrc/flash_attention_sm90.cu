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
// (q 8x64x512x128, kv 8x8) too, 0.045 ms; at DeepSeek-V3's MLA prefill
// (q = k = v 8x128x512x192, causal, G = 1) too, 0.240 ms (805 MB; its 103
// GFLOP take 0.104 ms). What holds the kernel back is moving those bytes
// once and in whole lines (K/V read from HBM once, O written by TMA) and
// keeping the tensor cores fed: loads must overlap the products, and the
// softmax between the two products must not leave them idle.
//
// Plans (Plan<DP, NH, NQ>). A block takes NH q heads of one kv head and NQ
// 64-row q tiles of each: NC = NH * NQ consumer warpgroups, warpgroup c on
// head c / NQ and q tile c % NQ, all consuming the same staged K/V tile.
// GQA (D 64 and 128) shares each K/V tile among NH heads (smollm 3, Jamba
// 2) of one q tile. MLA (D 192, G = 1) has no heads to share it among, so
// its plan, <192, 1, 2>, shares it between two q tiles of one head: 128 q
// rows a block, each staged 64 x 192 K/V tile read from L2 once for 128 rows
// (0.98 GB of L2 reads at DeepSeek's shape, against 1.77 GB with 64 rows).
//
// Block order. The GQA plans run one block per work item and put the
// longest causal q tiles of the whole grid first; their K/V (5.2 MB
// smollm, 16.8 MB Jamba) stays in the 50 MB L2 whatever the order. MLA's
// K/V is 402 MB at DeepSeek's shape (1,024 (batch, head) pairs of 393 KB):
// with the q tile the slowest index, every q tile would read its causal
// prefix of K/V from HBM again (1.77 GB in all). So MLA's work items are
// ordered (q block, head, batch), the q block fastest and the longest first
// within a head: the ~132 items in flight cover ~33 heads, ~13 MB of K/V,
// which L2 holds, and K/V comes from HBM once. Its grid is persistent, one
// block per SM (192 KB of shared memory each) walking the items in rounds
// (odd rounds backwards, so long and short causal items pair up on a
// block): the K/V ring runs on across items, and the next item's Q loads
// into a second Q buffer while the block works on this one, so neither a
// block's start nor its epilogue leaves the SM waiting for HBM.
//
// Design. A producer warpgroup (one thread issuing; with NC > 1 setmaxnreg
// hands its registers to the consumers) loads each item's Q and walks the
// kv tiles of 64 keys that its rows can see, from the window start to the
// causal frontier, loading each K and V tile with TMA into a ring of
// kStages shared-memory stages; completion is signalled on mbarriers (K
// and V full apart, so S = Q K^T can start before V lands), and each
// consumer warp releases a stage (empty) after its second product on it.
// TMA (cuTensorMapEncodeTiled, taken from the driver with
// cudaGetDriverEntryPoint, so no -lcuda) was chosen over cp.async because
// its tensor maps carry the strides, zero-fill the ragged Sq/Skv tails and
// the padded head dims, and read and write the 128-byte swizzle that the
// wgmma descriptors read, with one thread issuing; encoding the four maps
// costs a few microseconds of host time per call. Per tile and warpgroup:
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
// In the GQA plans tile i's S product is issued together with tile i - 1's
// P V, and tile i's softmax runs while the tensor cores do that P V. MLA's
// plan cannot hold O (96 float32 a thread), S (32) and P (16) of two tiles
// at once: ptxas compiles the consumers within the 168 registers a thread
// of a 384-thread block has at entry, whatever setmaxnreg.inc asks (232),
// and the overlapped loop spilled and serialised its wgmma. So its
// warpgroups take their tiles one at a time, and one's softmax runs while
// the other's products do (turns on named barriers, as FlashAttention-3's
// ping-pong, measured no faster, so the warpgroups interleave on their
// own). Their kv ranges differ by at most one tile at the causal diagonal
// and at a window's lower edge, and an item's second q tile lies past Sq
// when the tiles are odd in number: the producer loads the item's range,
// each warpgroup multiplies only its own and passes over the rest, waiting
// for each such stage to fill and releasing it, so the empty barriers
// balance. The epilogue writes O (bf16) into the
// warpgroup's Q tile, which every product has read, in the swizzle of a
// TMA box, and it leaves by TMA (whole 128-byte lines through O's strides,
// the rows past Sq and columns past D clipped by the map): in the
// persistent plan a warp of the producer warpgroup stores it while the
// consumers go on to the next item.
// Head dims 64, 128 and 192 are native; 16 and 32 run as 64, 80 as 128
// (DP), the columns beyond D zero-filled by TMA and never written back. The
// softmax and both accumulations are float32 and the output is rounded
// once to bf16. A row whose every key is masked returns 0: its running max
// stays -inf and its sum 0.
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

#include <algorithm>

namespace {

constexpr int kRows = 64;           // q rows per warpgroup (one wgmma M)
constexpr int kBN = 64;             // keys per kv tile (one wgmma N of S)
constexpr int kProducerRegs = 40;

// DP: head dim padded to 64 or 128, or 192 (MLA); NH: q heads a block takes
// (of one kv head's G); NQ: 64-row q tiles of each head a block takes.
template <int DP, int NH, int NQ>
struct Plan {
  static_assert(NQ == 1 || (NQ == 2 && NH == 1), "two q tiles a block: one head");
  static_assert(NH * NQ <= 3, "named barriers 1 + wg: three consumer warpgroups at most");
  static constexpr int NC = NH * NQ;                   // consumer warpgroups
  static constexpr int kBlockRows = NQ * kRows;        // q rows of a work item (each head)
  // Work items (q block, head, batch), the q blocks of a head the fastest
  // index, on a persistent grid of one block per SM, for MLA, whose K/V
  // outgrows L2; else one block per work item (head, batch, q block), the
  // longest causal tiles of the grid first (the design note above).
  static constexpr bool kHeadMajor = NQ > 1;
  // Q buffers: the persistent plan loads the next item's Q into the second
  // while it works on the first (and stores the first's O through it).
  // DP 192, NQ 2: 2 x 48 KB of Q and 2 stages of 48 KB of K/V, 192 KB in
  // all (a third stage measured no faster than two)
  static constexpr int kQBufs = kHeadMajor ? 2 : 1;
  static constexpr int kStages = DP == 64 ? 4 : kHeadMajor ? 2 : 3;
  static constexpr int kQPanel = kRows * 128;          // 64 rows x 64 bf16
  static constexpr int kKVPanel = kBN * 128;           // kBN rows x 64 bf16
  static constexpr int kQTile = kRows * DP * 2;        // bytes of a 64 x DP tile
  static constexpr int kKVTile = kBN * DP * 2;         // bytes of a kBN x DP tile
  static constexpr int kQ = 0;                         // kQBufs x NC q tiles
  static constexpr int kK = kQ + kQBufs * NC * kQTile;  // kStages K tiles
  static constexpr int kV = kK + kStages * kKVTile;    // kStages V tiles
  // q_full[], q_empty[], o_full[], k_full[], v_full[], empty[]
  static constexpr int kBar = kV + kStages * kKVTile;
  static constexpr int kBytes = kBar + 8 * (3 * kQBufs + 3 * kStages) + 1024;  // + alignment slack
  static constexpr int kThreads = (NC + 1) * 128;
  // one consumer warpgroup at D 64: two blocks per SM (128 registers each)
  static constexpr int kMinBlocks = NC == 1 && DP == 64 ? 2 : 1;
  // With several consumer warpgroups, setmaxnreg moves registers from the
  // producer to them: each block starts with kEntryRegs per thread (the
  // register file over kThreads, in steps of 8), the producer keeps
  // kProducerRegs and the consumers share the rest. One consumer warpgroup
  // has all it needs at entry. ptxas compiles the consumers' code within
  // kEntryRegs all the same (168 at 384 threads), so that is what the
  // consumers can hold.
  static constexpr int kEntryRegs = 65536 / kThreads / 8 * 8;
  static constexpr int kConsumerRegs =
      ((kEntryRegs * (NC + 1) - kProducerRegs) / NC / 8 * 8) < 240
          ? (kEntryRegs * (NC + 1) - kProducerRegs) / NC / 8 * 8
          : 240;
};

// Accumulator element r of a thread (lane l of warp w in its warpgroup)
// sits at row 16 w + l / 4 + 8 ((r >> 1) & 1) and column
// 8 (r >> 2) + 2 (l % 4) + (r & 1).
template <int DP, int NH, int NQ>
__global__ void __launch_bounds__(Plan<DP, NH, NQ>::kThreads, Plan<DP, NH, NQ>::kMinBlocks)
flash_attention_wgmma(const __grid_constant__ CUtensorMap tmq,
                      const __grid_constant__ CUtensorMap tmk,
                      const __grid_constant__ CUtensorMap tmv,
                      const __grid_constant__ CUtensorMap tmo, float* __restrict__ lse,
                      int B, int Hq, int Sq, int Skv, int G, int causal, int window,
                      int offset, float scale_log2) {
  using P = Plan<DP, NH, NQ>;
  constexpr int NC = P::NC;
  constexpr int ST = P::kStages;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + 1023) & ~1023u;  // swizzle atoms are 1 KB aligned
  constexpr int QB = P::kQBufs;
  const uint32_t bar_q = base + P::kBar, bar_qe = bar_q + 8 * QB, bar_o = bar_qe + 8 * QB;
  const uint32_t bar_k = bar_o + 8 * QB, bar_v = bar_k + 8 * ST, bar_e = bar_v + 8 * ST;

  const int shares = G / NH;  // blocks (work items) of a kv head's G q heads
  struct Item {
    int qblk, n_blk;      // first q row and rows (of each head)
    int head0, kvh, b;    // first q head, its kv head, batch
    int t_begin, n_tiles;  // kv tiles the rows can see: [window start, causal frontier]
  };
  // the work item of q block qb, share `share` of a kv head's q heads, batch b
  const auto item = [&](int qb, int share, int b) {
    Item it;
    it.kvh = share / shares;
    it.head0 = it.kvh * G + (share % shares) * NH;
    it.b = b;
    it.qblk = qb * P::kBlockRows;
    it.n_blk = min(P::kBlockRows, Sq - it.qblk);
    const int kv_end = causal ? min(Skv, offset + it.qblk + it.n_blk) : Skv;
    const int kv_start = window >= 0 ? max(0, offset + it.qblk - window + 1) : 0;
    it.t_begin = kv_start / kBN;
    it.n_tiles = kv_end > kv_start ? (kv_end + kBN - 1) / kBN - it.t_begin : 0;
    return it;
  };
  // MLA (kHeadMajor): the persistent block's j-th item, of n_work in the
  // order (q block, head, batch), the q blocks of a head the fastest and
  // the longest causal rows first: round j of gridDim.x items, odd rounds
  // walked backwards, so a block that took a long item takes a short one
  // next. Else: the block's one item, the longest causal rows of the grid
  // first.
  const int n_qb = (Sq + P::kBlockRows - 1) / P::kBlockRows;
  const int heads = Hq / G * shares;
  const long long n_work = P::kHeadMajor ? (long long)n_qb * heads * B : 1;
  const auto work = [&](int j) -> long long {
    return (long long)j * gridDim.x + ((j & 1) ? gridDim.x - 1 - blockIdx.x : blockIdx.x);
  };
  const auto item_of = [&](int j) {
    if constexpr (P::kHeadMajor) {
      const int w = (int)work(j);
      return item(n_qb - 1 - w % n_qb, w / n_qb % heads, w / n_qb / heads);
    } else {
      return item(gridDim.z - 1 - blockIdx.z, blockIdx.x, blockIdx.y);
    }
  };
  const auto has_item = [&](int j) { return P::kHeadMajor ? work(j) < n_work : j == 0; };

  if (threadIdx.x == 0) {
    for (int u = 0; u < QB; ++u) {
      mbar_init(bar_q + 8 * u, 1);
      mbar_init(bar_qe + 8 * u, 1);
      mbar_init(bar_o + 8 * u, 4 * NC);  // one arrival per consumer warp
    }
    for (int s = 0; s < ST; ++s) {
      mbar_init(bar_k + 8 * s, 1);
      mbar_init(bar_v + 8 * s, 1);
      mbar_init(bar_e + 8 * s, 4 * NC);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // the warpgroup, through a shuffle so that ptxas knows it is the same in
  // every lane: branches on it do not split a warp, so the wgmma under them
  // stay asynchronous
  const int wg = __shfl_sync(0xffffffffu, threadIdx.x / 128, 0);
  if (wg == NC) {
    // producer: one thread issues every copy, item after item; the K/V
    // ring runs on across items, so the next item's first tiles load while
    // the consumers finish this one
    if constexpr (NC > 1) asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kProducerRegs));
    if (P::kHeadMajor && threadIdx.x % 128 == 32) {
      // the persistent plan's storing warp: once the consumers have written
      // an item's O into its Q buffer, TMA stores it, and the buffer goes
      // back to the producer once TMA has read it
      for (int j = 0; has_item(j); ++j) {
        const Item it = item_of(j);
        const int u = j % QB;
        mbar_wait(bar_o + 8 * u, (j / QB) & 1);
        for (int c = 0; c < NC; ++c)
          if (c % NQ * kRows < it.n_blk)
            for (int a = 0; a < DP / 64; ++a)
              tma_store(&tmo, base + P::kQ + (u * NC + c) * P::kQTile + a * P::kQPanel,
                        a * 64, it.qblk + c % NQ * kRows, it.head0 + c / NQ, it.b);
        tma_store_wait_read();
        mbar_arrive(bar_qe + 8 * u);
      }
    }
    if (threadIdx.x % 128 == 0) {
      int g = 0;  // K/V tiles loaded so far
      for (int j = 0; has_item(j); ++j) {
        const Item it = item_of(j);
        // Q buffer j % QB, once item j - QB's O has left it
        const int u = j % QB;
        const uint32_t q_full = bar_q + 8 * u;
        if (j >= QB) mbar_wait(bar_qe + 8 * u, (j / QB - 1) & 1);
        // the q tiles that start inside Sq (with NQ 2 the last q block's
        // second may not)
        mbar_expect_tx(q_full, NH * ((it.n_blk + kRows - 1) / kRows) * P::kQTile);
        for (int c = 0; c < NC; ++c)
          if (c % NQ * kRows < it.n_blk)
            for (int a = 0; a < DP / 64; ++a)
              tma_load(base + P::kQ + (u * NC + c) * P::kQTile + a * P::kQPanel, &tmq, q_full,
                       a * 64, it.qblk + c % NQ * kRows, it.head0 + c / NQ, it.b);
        for (int i = 0; i < it.n_tiles; ++i, ++g) {
          const int s = g % ST;
          if (g >= ST) mbar_wait(bar_e + 8 * s, ((g / ST) & 1) ^ 1);  // released last round
          const int k0 = (it.t_begin + i) * kBN;
          const uint32_t k_tile = base + P::kK + s * P::kKVTile;
          const uint32_t v_tile = base + P::kV + s * P::kKVTile;
          mbar_expect_tx(bar_k + 8 * s, P::kKVTile);
          for (int a = 0; a < DP / 64; ++a)
            tma_load(k_tile + a * P::kKVPanel, &tmk, bar_k + 8 * s, a * 64, k0, it.kvh, it.b);
          mbar_expect_tx(bar_v + 8 * s, P::kKVTile);
          for (int a = 0; a < DP / 64; ++a)
            tma_load(v_tile + a * P::kKVPanel, &tmv, bar_v + 8 * s, a * 64, k0, it.kvh, it.b);
        }
      }
    }
  } else {
    // consumers: warpgroup wg owns q tile wg % NQ of head head0 + wg / NQ of
    // each item
    if constexpr (NC > 1)
      asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(P::kConsumerRegs));
    const int t = threadIdx.x % 128, lane = t % 32;
    const int r0 = (t / 32) * 16 + lane / 4;  // rows r0 and r0 + 8 of the tile
    const int col0 = 2 * (lane % 4);          // first of this thread's two columns per 8
    // item j of this block, whose first K/V tile is the block's tile g0
    const auto consume = [&](int j, const Item& it, int g0) {
      const int u = j % QB;  // its Q buffer
      const uint32_t q_tile = base + P::kQ + (u * NC + wg) * P::kQTile;
      const int t_begin = it.t_begin, n_tiles = it.n_tiles;
      const int head = it.head0 + wg / NQ;
      const int q0 = it.qblk + wg % NQ * kRows;
      const int n_q = min(kRows, Sq - q0);  // <= 0: a q tile past Sq (NQ 2)
      const int q_lo = offset + q0;
      const int qp0 = q_lo + r0, qp1 = qp0 + 8;
      // this warpgroup's kv tiles [first, last) of the item's walk; with NQ
      // 2 it passes over the others
      int first = 0, last = n_tiles;
      if constexpr (NQ > 1) {
        const int end = causal ? min(Skv, q_lo + n_q) : Skv;
        const int start = window >= 0 ? max(0, q_lo - window + 1) : 0;
        first = last = 0;
        if (n_q > 0 && end > start) {
          first = start / kBN - t_begin;
          last = (end + kBN - 1) / kBN - t_begin;
        }
      }
      float acc[DP / 2];
#pragma unroll
      for (int r = 0; r < DP / 2; ++r) acc[r] = 0.f;
      float m0 = -INFINITY, m1 = -INFINITY, l0 = 0.f, l1 = 0.f, c0 = 0.f, c1 = 0.f;
      float sc[kBN / 2];     // logits, then probabilities, of the newest tile
      uint32_t pa[kBN / 4];  // the previous tile's probabilities as bf16 A fragments

      // tile i of the item: its stage and the parity of its round
      const auto stage = [&](int i) { return (g0 + i) % ST; };
      const auto parity = [&](int i) { return ((g0 + i) / ST) & 1; };
      // 1. S = Q K^T for tile i, Q and K K-major: issued and committed, not
      // waited for
      const auto issue_qk = [&](int i) {
        mbar_wait(bar_k + 8 * stage(i), parity(i));
        const uint32_t k_tile = base + P::kK + stage(i) * P::kKVTile;
#pragma unroll
        for (int kk = 0; kk < DP / 16; ++kk)
          wgmma_ss_m64n64k16(
              sc, smem_desc(q_tile + (kk / 4) * P::kQPanel + (kk % 4) * 32, 16, 1024),
              smem_desc(k_tile + (kk / 4) * P::kKVPanel + (kk % 4) * 32, 16, 1024), kk);
        wgmma_commit();
      };
      // 2. mask and fold the tile at k0 into the running max (of the raw
      // logits: the scale is positive) and sum; sc becomes probabilities,
      // exp2(s * scale_log2 - max * scale_log2), one FFMA and one ex2 each,
      // and (c0, c1) the corrections of the rows' old max. Only the ragged
      // Skv tail, the causal diagonal and the window's lower edge (over all
      // 64 rows) need a mask; it keeps keys in [lo, hi] of each row.
      const auto softmax = [&](int k0) {
        if (k0 + kBN > Skv || (causal && k0 + kBN - 1 > q_lo) ||
            (window >= 0 && k0 <= q_lo + kRows - 1 - window)) {
          const int key0 = k0 + col0;  // key of this thread's column 0
          const int hi0 = (causal ? min(Skv - 1, qp0) : Skv - 1) - key0;
          const int hi1 = (causal ? min(Skv - 1, qp1) : Skv - 1) - key0;
          const int lo0 = (window >= 0 ? qp0 - window + 1 : 0) - key0;
          const int lo1 = (window >= 0 ? qp1 - window + 1 : 0) - key0;
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
      // 3. P as bf16 A fragments, in place: the S accumulator layout is the
      // A layout of the next product, so P never touches shared memory
      const auto pack_p = [&] {
#pragma unroll
        for (int k = 0; k < kBN / 4; ++k) pa[k] = pack_bf16(sc[2 * k], sc[2 * k + 1]);
      };
      // O *= the max corrections where a row's max moved
      const auto rescale = [&] {
        if (c0 != 1.f || c1 != 1.f) {
#pragma unroll
          for (int r = 0; r < DP / 2; ++r) acc[r] *= (r & 2) ? c1 : c0;
        }
      };
      // 4. O += P V for tile i, V MN-major: issued and committed
      const auto issue_pv = [&](int i) {
        mbar_wait(bar_v + 8 * stage(i), parity(i));
        const uint32_t v_tile = base + P::kV + stage(i) * P::kKVTile;
#pragma unroll
        for (int kk = 0; kk < kBN / 16; ++kk)
          wgmma_rs<DP>(acc, pa[4 * kk], pa[4 * kk + 1], pa[4 * kk + 2], pa[4 * kk + 3],
                       smem_desc(v_tile + kk * 2048, P::kKVPanel, 1024));
        wgmma_commit();
      };
      const auto release = [&](int i) {
        if (lane == 0) mbar_arrive(bar_e + 8 * stage(i));
      };
      // a tile of the item's walk outside this warpgroup's range: wait for
      // the stage to fill, and release it
      const auto pass = [&](int i) {
        mbar_wait(bar_k + 8 * stage(i), parity(i));
        mbar_wait(bar_v + 8 * stage(i), parity(i));
        release(i);
      };

      mbar_wait(bar_q + 8 * u, (j / QB) & 1);
      if (n_tiles > 0) {
        for (int i = 0; i < first; ++i) pass(i);
        if constexpr (NQ > 1) {
          // one tile at a time: S, softmax, P V (O, S and P of two tiles in
          // flight do not fit; the design note above)
          for (int i = first; i < last; ++i) {
            wgmma_fence();
            issue_qk(i);
            wgmma_wait<0>();
            fence_regs(sc);
            softmax((t_begin + i) * kBN);
            rescale();
            pack_p();
            wgmma_fence();
            issue_pv(i);
            wgmma_wait<0>();
            fence_regs(acc);
            fence_regs(pa);
            release(i);
          }
        } else {
          // NQ 1: the block's tiles are this warpgroup's, first 0 and last
          // n_tiles. Tile i's softmax runs while the tensor cores do tile
          // i - 1's P V: S_i and P_{i-1} V_{i-1} are issued together, S_i is
          // waited for first.
          wgmma_fence();
          issue_qk(0);
          wgmma_wait<0>();
          fence_regs(sc);
          softmax(t_begin * kBN);
          pack_p();
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
            rescale();
            pack_p();
          }
          wgmma_fence();
          issue_pv(n_tiles - 1);
          wgmma_wait<0>();
          fence_regs(acc);
          release(n_tiles - 1);
        }
        for (int i = last; i < n_tiles; ++i) pass(i);
      }
      // row sums over the quad
      l0 += __shfl_xor_sync(0xffffffffu, l0, 1);
      l0 += __shfl_xor_sync(0xffffffffu, l0, 2);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 1);
      l1 += __shfl_xor_sync(0xffffffffu, l1, 2);
      const float inv0 = l0 > 0.f ? 1.f / l0 : 0.f, inv1 = l1 > 0.f ? 1.f / l1 : 0.f;
      // O (bf16 pairs) into this warpgroup's Q tile, which every product
      // has read, in the 128-byte swizzle of a TMA box (16-byte chunk c of
      // row r at chunk c ^ (r % 8)): pair k of rows r0 and r0 + 8 is chunk
      // k % 8 of panel k / 8. In the persistent plan a warp of the producer
      // warpgroup then stores it with TMA while this warpgroup goes on to
      // its next item; else one thread of the warpgroup does.
      if (n_q > 0) {
#pragma unroll
        for (int k = 0; k < DP / 8; ++k) {
          const uint32_t at = q_tile + (k / 8) * P::kQPanel + r0 * 128 +
                              (((k % 8) ^ (r0 % 8)) << 4) + 2 * col0;
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at),
                       "r"(pack_bf16(acc[4 * k] * inv0, acc[4 * k + 1] * inv0))
                       : "memory");
          asm volatile("st.shared.b32 [%0], %1;\n" ::"r"(at + 8 * 128),
                       "r"(pack_bf16(acc[4 * k + 2] * inv1, acc[4 * k + 3] * inv1))
                       : "memory");
        }
        fence_proxy_async();
      }
      if constexpr (P::kHeadMajor) {
        __syncwarp();
        if (lane == 0) mbar_arrive(bar_o + 8 * u);  // to the storing warp
      } else {
        // one item a block: store it from here (a handoff would only add
        // latency at the block's end)
        if (wg == 0) named_bar_sync<1>(128);  // the warpgroup's 128 threads
        else if (wg == 1) named_bar_sync<2>(128);
        else named_bar_sync<3>(128);
        if (t == 0 && n_q > 0) {
          for (int a = 0; a < DP / 64; ++a)
            tma_store(&tmo, q_tile + a * P::kQPanel, a * 64, q0, head, it.b);
          tma_store_wait_read();
        }
      }
      if (lse != nullptr && lane % 4 == 0) {
        // L = (m * scale_log2 + log2 l) * ln 2; +inf where l is 0
        float* lrow = lse + ((long long)it.b * Hq + head) * Sq + q0;
        if (r0 < n_q)
          lrow[r0] = l0 > 0.f ? (m0 * scale_log2 + __log2f(l0)) * 0.6931471805599453f : INFINITY;
        if (r0 + 8 < n_q)
          lrow[r0 + 8] =
              l1 > 0.f ? (m1 * scale_log2 + __log2f(l1)) * 0.6931471805599453f : INFINITY;
      }
    };
    if constexpr (P::kHeadMajor) {
      int g0 = 0;  // K/V tiles of the earlier items
      for (int j = 0; has_item(j); ++j) {
        __syncwarp();  // the last item's epilogue branched on the lane
        const Item it = item_of(j);
        consume(j, it, g0);
        g0 += it.n_tiles;
      }
    } else {
      consume(0, item_of(0), 0);
    }
  }
}

template <int DP, int NH, int NQ>
cudaError_t launch(const void* q, const void* k, const void* v, void* o, float* lse,
                   const long long* sq, const long long* sk, const long long* sv,
                   const long long* so, int B, int Hq,
                   int Hkv, int Sq, int Skv, int D, int causal, int window, int offset,
                   float scale, cudaStream_t stream) {
  using P = Plan<DP, NH, NQ>;
  auto kernel = flash_attention_wgmma<DP, NH, NQ>;
  static cudaError_t setup = [&] {
    // setmaxnreg.inc waits for registers the producer frees: make sure the
    // block holds enough of them, or it would wait forever
    cudaFuncAttributes attr;
    cudaError_t err = cudaFuncGetAttributes(&attr, kernel);
    if (err != cudaSuccess) return err;
    if (P::NC > 1 && attr.numRegs * (P::NC + 1) < P::NC * P::kConsumerRegs + kProducerRegs)
      return cudaErrorInvalidConfiguration;
    return cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, P::kBytes);
  }();
  if (setup != cudaSuccess) return setup;
  const int n_qb = (Sq + P::kBlockRows - 1) / P::kBlockRows, heads = Hq / NH;
  dim3 grid(heads, B, n_qb);  // one block per work item
  if constexpr (P::kHeadMajor) {
    // persistent: one block per SM (192 KB of shared memory each)
    const long long n_work = (long long)n_qb * heads * B;
    if (n_work > 0x7fffffff) return cudaErrorInvalidConfiguration;
    int dev, n_sm;
    cudaError_t err = cudaGetDevice(&dev);
    if (err == cudaSuccess)
      err = cudaDeviceGetAttribute(&n_sm, cudaDevAttrMultiProcessorCount, dev);
    if (err != cudaSuccess) return err;
    grid = dim3((unsigned)std::min<long long>(n_work, n_sm));
  } else if (B > 65535 || n_qb > 65535) {
    return cudaErrorInvalidConfiguration;  // gridDim.y and .z are at most 65535
  }
  CUtensorMap tq, tk, tv, to;
  if (!encode(&tq, q, B, Hq, Sq, D, sq[0], sq[1], sq[2], kRows) ||
      !encode(&tk, k, B, Hkv, Skv, D, sk[0], sk[1], sk[2], kBN) ||
      !encode(&tv, v, B, Hkv, Skv, D, sv[0], sv[1], sv[2], kBN) ||
      !encode(&to, o, B, Hq, Sq, D, so[0], so[1], so[2], kRows))
    return cudaErrorInvalidValue;
  kernel<<<grid, P::kThreads, P::kBytes, stream>>>(
      tq, tk, tv, to, lse, B, Hq, Sq, Skv,
      Hq / Hkv, causal, window, offset, scale * 1.4426950408889634f);
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
  // D <= 64: the three q heads of a kv head per block where G is a multiple
  // of 3 (smollm), else one per block, small enough that two blocks share an
  // SM; D 80 and 128: two q heads per block where G is even; D 192 (MLA,
  // G = 1): two q tiles of one head, 128 rows a block.
  const int G = Hq / Hkv;
#define REPRO_GO(DP, NH, NQ)                                                              \
  return launch<DP, NH, NQ>(q, k, v, o, lse, sq, sk, sv, so, B, Hq, Hkv, Sq, Skv, D, causal, \
                            window, offset, scale, stream)
  if (D == 192) REPRO_GO(192, 1, 2);
  if (D <= 64 && G % 3 == 0) REPRO_GO(64, 3, 1);
  if (D <= 64) REPRO_GO(64, 1, 1);
  if (G % 2 == 0) REPRO_GO(128, 2, 1);
  REPRO_GO(128, 1, 1);
#undef REPRO_GO
}

}  // namespace repro
