// The Gram product of the deflation engine's method="gram" for bf16, on
// Hopper's bf16 tensor cores (sm_90a: wgmma with both operands in shared
// memory).
//
//   gram         B = A^T A    A (m, n) bf16, rows lda apart -> B (n, n) fp32
//   gram, trans  B = A A^T    (wide inputs)                 -> B (m, m) fp32
//
// Replaces the Pallas TPU kernel of src/repro/kernels/gram.py: gram
// (pallas_call at :84), with its reduced-task schedule (paper Alg 3, Fig 2c),
// for every bf16 operand.  Two routes (kernels/gram.py::route): "wgmma",
// where a TMA tensor map describes A (base 16-byte aligned, lda % 8 == 0),
// and "wgmma_ld" for every other bf16 A (any lda >= n, any 2-byte-aligned
// base), read in place: no padded copy.  fp32 runs gram_tf32.cu (3xTF32).
//
// Bound on an H100 SXM at the gram path's 262144 x 8192: the symmetric
// schedule's m n (n + 1) = 1.76e13 flop at the bf16 peak (989 TFLOP/s)
// take 17.79 ms, against 4.56 GB of A and B (1.36 ms at 3.35 TB/s): bound
// by its operations.  Feeding the tensor cores is the hard part:
//   * L2.  A block owns one 128 x 128 tile of B and sums it over the whole
//     reduction, so it takes 512 bytes of A a row (128 columns of each
//     side): 2112 blocks x 262144 rows x 512 B = 283 GB a launch, ~56 ms
//     at the ~5 TB/s gram_tf32.cu's staging reached (PERF.md), three times
//     the bound.  So on "wgmma" four blocks form a 2 x 2 cluster of tiles
//     (i, j), (i, j'), (i', j), (i', j'); each loads one 64-column box of
//     its row's i panel and one of its column's j panel and multicasts it
//     (TMA .multicast::cluster) to the two blocks that share it: 142 GB
//     from L2.
//     A block releases a slot on the empty barrier of every block that
//     wrote into it (its own and its row's and column's partners), one
//     lane each, in parallel, and the cluster meets at a barrier before
//     the first load and after the last arrival.  Built with
//     -DREPRO_STAGING_ONLY (no wgmma: the staging alone, for timing),
//     chip_smoke.py shows what the staging costs (PERF.md section 6).
//   * Device memory.  A row's panels are read by the tiles of one row and
//     one column of B at different times; the grid runs 2 x 2 groups of
//     tiles in super-blocks of 4 x 4 groups, so the blocks resident
//     together share panels.
//   * Shared memory.  A k16 step of the block reads 12 KiB of operands
//     (each consumer 2 KiB of its i box and 4 KiB of the j panel) and
//     takes 8 KiB from TMA, in the 128 tensor-core clocks of its two
//     m64n128k16: 160 B a clock against the SM's 128, so 128 x 128 tiles
//     cannot pass ~80 % of the bf16 peak.  Wider tiles would need more
//     than the register file (acc and sum below).
//   * Both operands of A^T A arrive MN-major (the reduction runs down A's
//     rows).  bf16 wgmma takes either operand MN-major (its transpose
//     bits), so both sides are plain TMA boxes of 64 columns x 64 rows in
//     the 128-byte swizzle (hopper.cuh's MN-major layout): the i box as
//     wgmma's A (TRANS_A = 1), the j panel's two boxes as B (TRANS_B = 1).
//     A A^T reads rows of A: both operands K-major, boxes of 64 rows x 64
//     reduction columns.  A diagonal tile reads the i panel for both sides.
//   * Sums.  A bf16 product is exact in fp32, but the tensor cores'
//     accumulator does not round like an FFMA (left for a whole reduction
//     it reads outside the limits).  The wgmma sums restart from zero every
//     RESTART = 4 stages (256 rows) and the consumer adds them into a
//     second set of fp32 registers with rounded adds, in a fixed order: an
//     entry's error is that of an fp32 sum of R / 256 terms.  acc and sum
//     take 128 registers of a consumer; a 64 x 256 half tile would take
//     256, more than setmaxnreg's 240.  (Restarted every 64-row stage, the
//     two consumers' adds fall in the same clocks and idle the tensor
//     cores.)
//   * Warp-specialised blocks of 384 threads: a producer warpgroup filling
//     a ring of STAGES = 6 stages (32 KiB: the i and j panels, two boxes
//     each) and two consumer warpgroups, each a 64 x 128 half of the tile
//     by wgmma m64n128k16.
//   * "wgmma_ld": no tensor map (TMA needs 16-byte rows and boxes that
//     start on 16 bytes), so no multicast, but the same 2 x 2 clusters and
//     the same two boxes a block: the producer warpgroup's 128 threads
//     assemble them (16 KiB a stage, eight 16-byte chunks a thread) in the
//     swizzled layout, cp.async of 16, 8 or 4 bytes as the chunk's row
//     start allows; where a row starts 2 bytes off a 4-byte boundary (an
//     odd lda leaves every other row so), five 4-byte loads into registers
//     around it, a byte permute and a 16-byte store.  Edges are
//     zero-filled and never read.  A thread issues a stage's copies
//     before it waits for the previous stage's (two stages of loads in
//     flight); once they have landed and are fenced (cp.async and st.shared
//     write through the generic proxy, the push and wgmma read through the
//     async one), lane 0 of each producer warp pushes the warp's 2 KiB of
//     each box to the partner that reads it (cp.async.bulk shared::cluster
//     from shared::cta: the TMA unit's copy between two blocks' shared
//     memory, completing on the partner's full barrier) and arrives on its
//     own full barrier announcing the 4 KiB the partners' same warp pushes
//     into it.  A box is refilled only after every block that reads it has
//     released the slot, which its consumers do after the push has landed.
//     The pushes also keep the empty barriers' phases apart: a partner's
//     consumers release stage k only after this block's push of stage k,
//     which follows this block's wait for stage k - STAGES (without them a
//     partner's early release would count towards the wrong phase).  Of
//     275 GB a launch at 262144 x 8191 without clusters this reads 142 GB
//     from L2, half the copies a thread.  A warp's chunks of one copy lie
//     on rows 8 apart, which share their alignment mod 16, so a warp takes
//     one way of copying at a time.  A box that no block writing B reads
//     (a diagonal tile's j box where its column partner is the lower tile,
//     a box wholly past B's edge) is not copied: its entries feed only
//     entries never written.  The route is held by those copies from L2,
//     not by the pushes or the ring (PERF.md section 6).
//   * The reduced-task schedule: the grid enumerates the upper-triangle
//     groups of 2 x 2 tiles in the order of core/partition.py::
//     symmetric_tasks (gram_tasks.cuh), super-block by super-block, and
//     each block writes its tile and the mirror; symmetric=0 launches every
//     group, and a group below the diagonal computes its mirror's numbers
//     (the same operands in the same roles) and writes them transposed.
//     On a diagonal group the lower tile's block loads for the others and
//     writes nothing (its mirror's block writes both places), as does a
//     tile past B's edge, and a diagonal tile keeps the entries with row
//     <= column, each written to both places: B exactly symmetric.  No
//     atomics, no split of the reduction: bitwise reruns.
//
// Planted fault, built by chip_smoke.py beside the real library to show
// that its checks reject it: -DREPRO_TC_SUMS_ONLY (the sums left in the
// tensor cores' accumulators for the whole reduction).  -DREPRO_STAGING_ONLY
// (no products: B is not computed) is built for timing only.
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_gram_wgmma{,_ld}(A, lda, B, m, n, trans, symmetric, stream)
// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an A the route cannot read (on "wgmma" one no
// tensor map describes; on either, a base not 2-byte aligned or lda < n),
// cudaErrorNotSupported without libcuda's tensor-map encoder.  Allocates
// nothing.

#include <cuda.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "gram_tasks.cuh"
#include "hopper.cuh"

namespace {

using namespace repro_hopper;

constexpr int NCONS = 2;               // consumer warpgroups
constexpr int NT = 128 * (NCONS + 1);  // + one producer warpgroup
constexpr int BT = 64 * NCONS;         // edge of a block's tile of B
constexpr int BK = 64;                 // reduction depth of a stage
constexpr int KS = BK / 16;            // wgmma k16 steps a stage
constexpr int RESTART = 4;             // stages between restarts of the sums
constexpr int STAGES = 6;              // ring of shared-memory stages
constexpr int BOX = 64 * 128;          // a box of 64 rows x 64 bf16, bytes
constexpr int PANEL = 2 * BOX;         // one side of a stage: two boxes
constexpr int STAGE = 2 * PANEL;       // the i panel, then the j panel
constexpr int SBG = 4;                 // groups on a side of a super-block

// Each stage's wgmma sums start from zero every RESTART stages and are
// added into rounded fp32 sums (see the header).  Built with
// -DREPRO_TC_SUMS_ONLY, the sums stay in the tensor cores' accumulators
// for the whole reduction instead: a planted fault, which chip_smoke.py
// builds to show that its gram readings reject it.
#ifdef REPRO_TC_SUMS_ONLY
constexpr bool PROMOTE = false;
#else
constexpr bool PROMOTE = true;
#endif

// The producer: LD = false, TMA from one thread, multicast in a 2 x 2
// cluster ("wgmma"); LD = true, the copies of its 128 threads, which need
// registers for their loads in flight, and one thread's pushes to the
// partners ("wgmma_ld").  setmaxnreg: 128 x PRODUCER_REGS + 256 x
// CONSUMER_REGS <= 384 x 168, the registers __launch_bounds__(384, 1) gives
// the block (more, and the consumers' setmaxnreg.inc waits forever).
template <bool LD>
struct Producer {
  static constexpr int PRODUCER_REGS = LD ? 136 : 40;
  static constexpr int CONSUMER_REGS = LD ? 184 : 232;
  // full: the arrivals that announce the bytes the partners send: the TMA
  // thread's one (the whole stage, multicast), or each copying warp's
  // once its slices have landed (the two 2 KiB slices the partners' same
  // warp pushes)
  static constexpr int FULL_ARRIVALS = LD ? 4 : 1;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 384 * 168,
                "setmaxnreg beyond the block's registers");
};
// empty: each consumer warp of every block that writes into the slot (the
// block itself and its row's and its column's partners)
constexpr int EMPTY_ARRIVALS = 4 * NCONS * 3;
constexpr int SLICE = 16 * 128;        // a producer warp's rows of a box

// Dynamic shared memory, from a 1024-byte aligned base: STAGES slots of
// [i panel: 2 boxes][j panel: 2 boxes], then full[STAGES], empty[STAGES].
struct Smem {
  static constexpr int BAR = STAGES * STAGE;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;
};

// The group (gi, gj) of 2 x 2 tiles of group task g: super-blocks of
// SBG x SBG groups in the reduced-task schedule's order (gram_tasks.cuh:
// upper-triangle pairs in the order of core/partition.py::symmetric_tasks;
// every pair for the full schedule), a super-block's groups j-major.  False
// where the task has no work: a group below the diagonal of the reduced
// schedule's diagonal super-block, or past B's edge of ng groups.
__device__ __forceinline__ bool group_of(int64_t g, int ng, bool symmetric,
                                         int& gi, int& gj) {
  const int nsb = (ng + SBG - 1) / SBG;
  int si, sj;
  repro_gram_tasks::task_tile(g / (SBG * SBG), nsb, symmetric, si, sj);
  const int w = static_cast<int>(g % (SBG * SBG));
  gi = si * SBG + w % SBG;
  gj = sj * SBG + w / SBG;
  return gi < ng && gj < ng && !(symmetric && gi > gj);
}

// Producer thread t's share of a "wgmma_ld" stage: 8 chunks u of the
// block's two boxes, the i box (at `box_i` in a slot, from c_i) for lanes
// l < 16 of each warp, the j box (at `box_j`, from c_j) for the others.  A
// box row is 64 elements of one of A's rows: A^T A's output columns c0 ..
// of reduction row r0 + row, A A^T's reduction columns r0 .. of output row
// c0 + row.  Warp w takes rows 16 w .. 16 w + 15 of each box, 2 KiB it
// pushes to the partner itself; lane l the rows first + g(u), first = 16 w
// + 8 (l / 8 % 2), the even ones for u < 4 and the odd ones after (on an
// odd lda one of the two halves is all by cp.async), and chunk x = l % 8 of
// each: 8 lanes a row's 128 bytes.  A warp's chunks of one u lie on rows 8
// apart, which share their alignment mod 16 (2 * 8 * lda bytes apart), so
// the warp takes one way of copying at a time.  All that does not change
// from stage to stage is worked out once: a stage moves every chunk's
// source by the same step (64 rows, or 128 bytes of a row), and a row's
// alignment, so its way of copying, stays.  A thread whose box no writing
// block reads (`skip`) copies nothing.
template <bool TRANS>
struct Share {
  __device__ static constexpr int g(int u) { return 2 * (u % 4) + u / 4; }

  const char* src;           // chunk 0's source at stage 0
  int64_t row_bytes, step;   // bytes between rows; a stage's step
  uint32_t dst;              // the thread's first row's offset in a slot
  int first, x, vcol;        // its first row of the box, chunk x, and
                             // (A^T A) the elements of chunk x inside A
  uint32_t by_reg, cp16, cp8, read;  // bit u: how chunk u is copied
  bool skip;

  __device__ __forceinline__ Share(const uint16_t* A, long long lda, int m,
                                   int n, int t, int c_i, int c_j,
                                   uint32_t box_i, uint32_t box_j,
                                   bool want_i, bool want_j) {
    const int l = t % 32, p = l / 16;
    const int c0 = p ? c_j : c_i;
    skip = !(p ? want_j : want_i);
    x = l % 8;
    first = 16 * (t / 32) + 8 * (l / 8 % 2);
    row_bytes = 2 * lda;
    if constexpr (!TRANS) {
      vcol = skip ? 0 : min(8, max(0, n - c0 - 8 * x));
      src = reinterpret_cast<const char*>(A + c0 + 8 * x) + first * row_bytes;
      step = BK * row_bytes;
    } else {
      vcol = 8;
      src = reinterpret_cast<const char*>(
          A + static_cast<int64_t>(c0 + first) * lda + 8 * x);
      step = 2 * BK;
    }
    dst = (p ? box_j : box_i) + first * 128;
    by_reg = cp16 = cp8 = read = 0;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int al = static_cast<int>(
          reinterpret_cast<uintptr_t>(src_of(u, 0)) & 15);
      by_reg |= static_cast<uint32_t>((al & 3) != 0) << u;
      cp16 |= static_cast<uint32_t>(al == 0) << u;
      cp8 |= static_cast<uint32_t>(al == 8) << u;
      const bool in_a = TRANS ? c0 + first + g(u) < m : vcol > 0;
      read |= static_cast<uint32_t>(in_a && !skip) << u;
    }
  }

  // chunk u of stage st (whose reduction starts at r0): its offset in the
  // slot, its source, and how many of its 8 elements exist (0: none,
  // stored as zeros)
  __device__ __forceinline__ uint32_t dst_of(int u) const {
    return dst + g(u) * 128 + ((x ^ g(u)) << 4);
  }
  __device__ __forceinline__ const char* src_of(int u, int st) const {
    return src + st * step + g(u) * row_bytes;
  }
  __device__ __forceinline__ int valid(int u, int r0, int m, int n) const {
    if (!(read >> u & 1)) return 0;
    if constexpr (!TRANS)
      return r0 + first + g(u) < m ? vcol : 0;
    else
      return min(8, max(0, n - r0 - 8 * x));
  }

  // stage st's copies into the slot at `slot`, all 8 chunks' loads in
  // flight: cp.async straight into the slot, the register ones into w
  __device__ __forceinline__ void load(uint32_t slot, int st, int m, int n,
                                       uint32_t (&w)[8][5]) const {
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int v = valid(u, st * BK, m, n);
      if (v <= 0) continue;
      if (by_reg >> u & 1)
        load_words(src_of(u, st), v, w[u]);
      else
        copy_chunk(slot + dst_of(u), src_of(u, st), v, cp16 >> u & 1,
                   cp8 >> u & 1);
    }
  }
  // stage st's register chunks, and the zeros of the chunks past A's edge,
  // stored once w has landed
  __device__ __forceinline__ void put(uint32_t slot, int st, int m, int n,
                                      const uint32_t (&w)[8][5]) const {
    if (skip) return;
#pragma unroll
    for (int u = 0; u < 8; ++u) {
      const int v = valid(u, st * BK, m, n);
      if (v > 0 && !(by_reg >> u & 1)) continue;
      put_chunk(slot + dst_of(u), v, w[u]);      // zeros where v == 0
    }
  }
};

// Tile task blockIdx.x of B: A^T A (TRANS = 0, the reduction over A's m
// rows) or A A^T (TRANS = 1, over its n columns), B's edge N = n or m.
// Block r = blockIdx.x % 4 of group task blockIdx.x / 4 (a cluster, r its
// rank) owns tile (2 gi + r / 2, 2 gj + r % 2) of the group's upper pair
// (gi, gj).  Its row's partner is rank r ^ 1, its column's r ^ 2.
template <bool TRANS, bool LD>
__global__ void __launch_bounds__(NT, 1)
    gram_bf16(const __grid_constant__ CUtensorMap ma,
              const uint16_t* __restrict__ A, long long lda,
              float* __restrict__ B, int m, int n, int ng, int symmetric) {
  using P = Producer<LD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const int R = TRANS ? n : m, N = TRANS ? m : n;
  int gi, gj;
  if (!group_of(blockIdx.x / 4, ng, symmetric != 0, gi, gj)) return;
  const int r = static_cast<int>(blockIdx.x % 4), a = r / 2, b = r % 2;
  const int ti = 2 * min(gi, gj) + a, tj = 2 * max(gi, gj) + b;
  const int i0 = ti * BT, j0 = tj * BT;
  const bool diag = ti == tj;
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + Smem::BAR, empty = full + 8 * STAGES;
  const int stages = (R + BK - 1) / BK;
  init_barriers<STAGES, EMPTY_ARRIVALS, P::FULL_ARRIVALS>(full, empty);
  cluster_sync();

  if (threadIdx.x >= 128 * NCONS) {          // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::PRODUCER_REGS));
    const int t = threadIdx.x - 128 * NCONS;
    if (!LD && t == 0) {
      // this block's box of its row's i panel (box b) and of its column's
      // j panel (box a), each to the two blocks that share it; a box
      // wholly past B's edge feeds only entries never written, and the
      // first box stands in for it (no copy outside A)
      const uint16_t row_mask = static_cast<uint16_t>(3u << (2 * a));
      const uint16_t col_mask = static_cast<uint16_t>(5u << b);
      const int ci = i0 + 64 * b < N ? i0 + 64 * b : 0;
      const int cj = j0 + 64 * a < N ? j0 + 64 * a : 0;
      // the box of output columns (A^T A) or rows (A A^T) from c0, the
      // reduction from r0, into dst
      auto load = [&](uint32_t dst, uint32_t bar, int c0, int r0,
                      uint16_t mask) {
        tma_load_2d_multicast(dst, &ma, bar, TRANS ? r0 : c0, TRANS ? c0 : r0,
                              mask);
      };
      for (int st = 0; st < stages; ++st) {
        const uint32_t bar = claim<STAGES>(full, empty, st, STAGE);
        const uint32_t slot = base + (st % STAGES) * STAGE;
        const int r0 = st * BK;
        load(slot + b * BOX, bar, ci, r0, row_mask);
        load(slot + PANEL + a * BOX, bar, cj, r0, col_mask);
      }
    } else if constexpr (LD) {
      // the boxes: box b of the row's i panel and box a of the column's j
      // panel, copied where a block that writes B reads them (tile (ri, rj)
      // writes where ri <= rj inside B; a diagonal tile reads its i panel
      // for both sides)
      const int c_i = i0 + 64 * b, c_j = j0 + 64 * a;
      auto writes = [&](int ri, int rj) { return ri <= rj && rj * BT < N; };
      const bool want_i = c_i < N && (writes(ti, tj) || writes(ti, tj ^ 1));
      const bool want_j =
          c_j < N && ((writes(ti, tj) && !diag) ||
                      (writes(ti ^ 1, tj) && (ti ^ 1) != tj));
      const Share<TRANS> sh(A, lda, m, n, t, c_i, c_j, b * BOX,
                            PANEL + a * BOX, want_i, want_j);
      // the warp's slices: its 16 rows of each box
      const int warp = t / 32, lane = t % 32;
      const uint32_t slice_i = b * BOX + warp * SLICE;
      const uint32_t slice_j = PANEL + a * BOX + warp * SLICE;
      // turn k: stage k's copies issued (a cp.async group; the register
      // loads into w[k % 2]), so that two stages' loads are in flight (the
      // register path's time follows its loads in flight); then stage
      // k - 1's landed, its register chunks stored, fenced (written through
      // the generic proxy, read by the async one) and, once the warp's
      // lanes are all done, its slices pushed by lane 0 to the partners
      // that read them, with one arrival on this block's full barrier for
      // the slices the partners' same warp pushes into it
      uint32_t w[2][8][5];
      for (int st = 0; st <= stages; st += 2) {
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          const int k = st + h;
          if (k < stages) {
            const int s = k % STAGES;
            // released by every block that writes into the slot: their
            // consumers are done with it, and so with the pushes from it
            if (k >= STAGES) mbar_wait(empty + 8 * s, ((k / STAGES) - 1) & 1);
            sh.load(base + s * STAGE, k, m, n, w[h]);
          }
          cp_async_commit();
          if (k >= 1 && k <= stages) {
            const int s = (k - 1) % STAGES;
            const uint32_t slot = base + s * STAGE, bar = full + 8 * s;
            cp_async_wait_group<1>();
            sh.put(slot, k - 1, m, n, w[h ^ 1]);
            fence_proxy_async();
            __syncwarp();
            if (lane == 0) {
              push_to_cluster(slot + slice_i, bar, SLICE, r ^ 1);
              push_to_cluster(slot + slice_j, bar, SLICE, r ^ 2);
              mbar_expect_tx(bar, 2 * SLICE);
            }
          }
        }
      }
    }
  } else {
    // a consumer warpgroup: rows i0 + 64 wg .. + 63 of the tile
    asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
        P::CONSUMER_REGS));
    const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
    const int lane = threadIdx.x % 32;
    float acc[BT / 2], sum[BT / 2];
#pragma unroll
    for (int i = 0; i < BT / 2; ++i) acc[i] = sum[i] = 0.0f;

    for (int st = 0; st < stages; ++st) {
      const int s = st % STAGES;
      mbar_wait(full + 8 * s, (st / STAGES) & 1);
      if constexpr (LD) fence_proxy_async();   // the cp.async data, for wgmma
      const uint32_t ip = base + s * STAGE;
      const uint32_t jp = diag ? ip : ip + PANEL;
      hold(acc);
      wg_fence();
#ifndef REPRO_STAGING_ONLY
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        const int acc_on = ks > 0 || (PROMOTE ? st % RESTART : st) > 0;
        if constexpr (TRANS)
          wgmma_ss<BT, 0, 0>(acc, desc(ip + wg * BOX + 32 * ks, 16, 1024),
                             desc(jp + 32 * ks, 16, 1024), acc_on);
        else
          wgmma_ss<BT, 1, 1>(acc, desc(ip + wg * BOX + 2048 * ks, BOX, 1024),
                             desc(jp + 2048 * ks, BOX, 1024), acc_on);
      }
#endif
      wg_commit();
      wg_wait_all();
      hold(acc);
      // released to every block that writes into this slot: lanes 0, 1, 2
      // to this block and its row's and its column's partners
      if (lane < 3) mbar_arrive_cluster(empty + 8 * s, lane ? r ^ lane : r);
      if (!PROMOTE || st % RESTART == RESTART - 1 || st == stages - 1) {
#pragma unroll
        for (int i = 0; i < BT / 2; ++i)
          sum[i] = PROMOTE ? sum[i] + acc[i] : acc[i];
      }
    }

    // sum[4 j + 2 h + e] is row 16 warp + lane / 4 + 8 h of the half tile
    // (B's row ri), column 8 j + 2 (lane % 4) + e (B's column cj).  Written
    // in place where the group task is the upper one, at the mirror where
    // it is the lower one, both under the reduced-task schedule; a diagonal
    // tile keeps ri <= cj, and the lower tile of a diagonal group (its
    // block loaded for the others) writes nothing.
    const bool up = symmetric || gi <= gj, down = symmetric || gi >= gj;
    if (ti <= tj) {
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int ri = i0 + 64 * wg + 16 * warp + lane / 4 + 8 * h;
        if (ri >= N) continue;
#pragma unroll
        for (int j = 0; j < BT / 8; ++j)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int cj = j0 + 8 * j + 2 * (lane % 4) + e;
            if (cj >= N || (diag && ri > cj)) continue;
            const float v = sum[4 * j + 2 * h + e];
            if (up) B[static_cast<int64_t>(ri) * N + cj] = v;
            if (down) B[static_cast<int64_t>(cj) * N + ri] = v;
          }
      }
    }
  }
  cluster_sync();
}

template <bool TRANS, bool LD>
int launch(const void* A, long long lda, void* B, int m, int n,
           int symmetric, cudaStream_t s) {
  CUtensorMap ma{};
  cudaError_t err = cudaSuccess;
  if (!LD) err = encode_2d(&ma, A, m, n, lda, 64, 2);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = gram_bf16<TRANS, LD>;
  constexpr int bytes = Smem::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);

  const long long N = TRANS ? m : n;
  const int ng = static_cast<int>((N + 2 * BT - 1) / (2 * BT));
  const int64_t tasks = 4 * SBG * SBG * repro_gram_tasks::task_count(
                                            N, 2 * BT * SBG, symmetric != 0);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(tasks));
  cfg.blockDim = dim3(NT);
  cfg.dynamicSmemBytes = bytes;
  cfg.stream = s;
  cudaLaunchAttribute cluster[1];
  cluster[0].id = cudaLaunchAttributeClusterDimension;
  cluster[0].val.clusterDim.x = 4;
  cluster[0].val.clusterDim.y = 1;
  cluster[0].val.clusterDim.z = 1;
  cfg.attrs = cluster;
  cfg.numAttrs = 1;
  err = cudaLaunchKernelEx(&cfg, kern, ma, static_cast<const uint16_t*>(A),
                           lda, static_cast<float*>(B), m, n, ng, symmetric);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

int gram_entry(bool ld, const void* A, long long lda, void* B, long long m,
               long long n, int trans, int symmetric, void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const uintptr_t a = reinterpret_cast<uintptr_t>(A);
  if (a % 2 != 0 || lda < n || (!ld && (a % 16 != 0 || lda % 8 != 0)))
    return static_cast<int>(cudaErrorInvalidValue);
  const int mi = (int)m, ni = (int)n;
  if (trans)
    return ld ? launch<true, true>(A, lda, B, mi, ni, symmetric, s)
              : launch<true, false>(A, lda, B, mi, ni, symmetric, s);
  return ld ? launch<false, true>(A, lda, B, mi, ni, symmetric, s)
            : launch<false, false>(A, lda, B, mi, ni, symmetric, s);
}

}  // namespace

extern "C" int repro_gram_wgmma(const void* A, long long lda, void* B,
                                long long m, long long n, int trans,
                                int symmetric, void* stream) {
  return gram_entry(false, A, lda, B, m, n, trans, symmetric, stream);
}

extern "C" int repro_gram_wgmma_ld(const void* A, long long lda, void* B,
                                   long long m, long long n, int trans,
                                   int symmetric, void* stream) {
  return gram_entry(true, A, lda, B, m, n, trans, symmetric, stream);
}
