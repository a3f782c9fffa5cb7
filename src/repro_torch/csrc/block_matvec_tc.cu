// The bf16 block sweeps on Hopper's tensor cores (sm_90a: wgmma, A staged
// by TMA or by the producer warpgroup's own copies).
//
//   block_matvec   Y = A @ Q      A (m, n) bf16, rows lda apart, Q (n, k),
//                                 Y (m, k)
//   block_rmatvec  Z = A^T @ Y    A (m, n) bf16, rows lda apart, Y (m, k),
//                                 Z (n, k)
//
// Replace the Pallas TPU kernels of src/repro/kernels/block_matvec.py:
// block_matvec (pallas_call at :81) and block_rmatvec (pallas_call at :127),
// for every bf16 operand; the chain Z = A^T (A Q) of that file
// (block_gram_chain, :146) is the composition of the two, done by the
// wrapper in kernels/ops.py.  fp32 sweeps run block_matvec_tf32.cu
// (3xTF32).  Two routes (kernels/block_matvec.py::route): "wgmma", where a
// TMA tensor map describes A (base and row stride 2 lda bytes multiples of
// 16), and "wgmma_ld" for every other bf16 A (any lda >= n, any 2-byte-
// aligned base), whose rows the producer copies itself: the same kernels.
// The solver's own bf16 copy of A (core/operator.py::DenseOperator) has
// rows of whole 16 bytes (lda a multiple of 8, the columns from n to lda
// never read: the tensor map ends at n), so it runs "wgmma" whatever the
// width of A; "wgmma_ld" takes a bf16 A handed to kernels/ops.py directly.
//
// Bound on an H100 SXM at the main path's 262144 x 32768, k = 32: one sweep
// reads 17.2 GB of bf16 A, 5.13 ms at 3.35 TB/s; its 2 m n k = 5.5e11 flop
// take 0.56 ms on the bf16 tensor cores (989 TFLOP/s).  At "wgmma_ld"'s
// 65536 x 8190 a sweep reads 1.07 GB, 0.32 ms, against 0.03 ms of products.
// So each sweep is a stream of A, and the design is about keeping A's
// bytes in flight and the skinny operand out of device memory:
//   * Warp-specialised blocks of 384 threads: one producer thread issues TMA
//     loads (cp.async.bulk.tensor, 128-byte swizzle, elements past the edges
//     arrive as zeros, so nothing is padded in memory) into a ring of
//     STAGES = 4 shared-memory stages, each completing on its "full"
//     mbarrier; two consumer warpgroups issue wgmma (fp32 accumulators in
//     registers) and release the stage on its "empty" mbarrier.  A stage
//     holds 32 KiB of A, so 128 KiB of A a block (one block an SM) is in
//     flight.  setmaxnreg gives the consumers 240 registers, the producer 24.
//   * "wgmma_ld": the producer of A is the template parameter LD of both
//     kernels.  LD = 0 is the TMA thread above.  Otherwise the skinny
//     operand's tile still arrives by TMA from one thread (the wrapper
//     writes it with rows of whole 16 bytes), but A, whose rows no tensor
//     map describes, is copied by all 128 producer threads, each 16-byte
//     chunk written where TMA's 128-byte swizzle puts it, so the consumers
//     and their wgmma descriptors are the same code for every producer:
//       - LD = 8: cp.async of 8 bytes, where every row starts 8-byte
//         aligned (lda % 4 == 0, base 8-byte aligned);
//       - LD = 4: cp.async of 4 bytes, where every row starts 4-byte
//         aligned (lda even, base 4-byte aligned: 65536 x 8190);
//       - LD = 2: rows that start 2 bytes off a 4-byte boundary (an odd
//         lda leaves every other row so; a base 2 bytes off, every row or
//         every other one): a thread takes one chunk column and 16 rows of
//         one parity (so a warp's rows are copied one way), by cp.async of
//         4 bytes where they start aligned, else by five 4-byte loads into
//         registers around each chunk, a byte permute and a 16-byte store
//         (hopper.cuh's load_words / put_chunk, as gram_bf16.cu), all 16
//         of a thread's chunks' loads in flight at once.
//     copy_stage (hopper.cuh) takes the element type, so the cp.async
//     producers are block_matvec_tf32.cu's fp32 ones at twice the elements
//     a copy.  Columns past n and rows past the edge arrive as
//     zeros (cp.async's src-size, 2 of 4 bytes where an odd n ends half
//     way into a word) and are never read.
//     Each copying thread arrives on the stage's full barrier by
//     cp.async.mbarrier.arrive.noinc, and on LD = 2 once more after its
//     register stores: 129 or 257 arrivals with the TMA thread's byte
//     count.  wgmma reads shared memory through the async proxy, which
//     neither cp.async nor st.shared writes through: the register stores
//     are fenced (fence.proxy.async) before their arrival, and the
//     consumers fence after the full wait.  setmaxnreg: 56 / 224 for the
//     cp.async producers (as block_matvec_tf32.cu), 152 / 176 for LD = 2
//     (16 chunks of 5 words in flight), each 128 x producer + 256 x
//     consumer <= 384 x 168, the registers of the block (a larger split
//     hangs the kernel).
//   * block_matvec: a job is BM = 256 rows of A (two m64 tiles a consumer),
//     so every 256 rows of A re-read the skinny operand through L2: k / 256
//     of A's bytes (12.5 % at k = 32).  A stage is 64 columns of A (K-major:
//     the reduction axis contiguous, wgmma's A operand) and the same 64 rows
//     of Q^T (K-major: wgmma's B operand, N = k rounded up to 16, 32 or 64;
//     wider k in tiles of 64 columns, which re-read A).  The grid is
//     persistent, one block an SM taking every gridDim.x-th job, and the
//     ring runs on from one job into the next, so a block's start-up and
//     its stores overlap the next job's loads (faster than a block a job in
//     development runs on an H100).
//   * block_rmatvec is computed as Z^T = Y^T A, so that A's tile, whose
//     contiguous axis is the output axis n whichever way round the product
//     is written, is the MN-major B operand (trans-b = 1) that wgmma reads
//     from shared memory, with the same descriptor as the attention kernel's
//     V (local_attn.cu).  Y^T is the K-major A operand; M = 64 rows of it
//     (k padded with the tensor map's zeros) halves the tensor work used at
//     k = 32, which costs nothing here.  A block owns BN = 256 columns of A
//     (128 a consumer, m64n128) and one slab of rows; a stage is 64 rows.
//     One block a job: the jobs are half as long as block_matvec's, and the
//     same persistent grid was slower here in development runs (its static
//     round-robin cannot even out blocks that finish at different times).
//     The reduction over m is split into slabs of whole stages, at most
//     16384 rows; each slab writes fp32 partials and a second launch sums
//     them in order (slab_sum.cuh): no atomics, bitwise reruns.  Y^T is
//     re-read k / 256 of A's bytes through L2.
//   * The skinny operand is read transposed (Q^T, Y^T: k rows of 2 n_pad or
//     2 m_pad bytes, written by the wrapper, a copy of k / m or k / n of A's
//     bytes), because a row of k bf16 values is a TMA box only when k is a
//     multiple of 8: the K-major box of the transposed operand takes every k,
//     rows past k arriving as zeros.  (Q's MN-major tile would need a 64- or
//     32-byte swizzle per k, and Y's an MN-major A operand, two more layouts
//     for no gain in bytes.)
//   * Precision: a product of two bf16 values is exact in fp32.  Tensor
//     cores need not round their fp32 sums to nearest as an FFMA does
//     (earlier NVIDIA generations were measured to truncate), and a drift
//     of half an fp32 ulp of the running sum at each of the 2048 steps of
//     n = 32768 would reach ~1e-4 relative, ten times the limit.  So each
//     stage (64 deep) starts its wgmma sums from zero, and the consumer
//     adds the stage's sums into a second set of fp32 registers with
//     ordinary (rounded) adds: the error is that of an fp32 sum of n / 64
//     terms.  Every rerun adds in the same order: bitwise equal.
//
// Planted faults, built by chip_smoke.py beside the real library to show
// that the kernel-vs-plain limit rejects them: -DREPRO_TC_SUMS_ONLY (the
// sums left in the tensor cores' accumulators for the whole reduction) and
// -DREPRO_NO_ZFILL ("wgmma_ld" copies the columns past n from past the end
// of the row instead of zero-filling them).  -DREPRO_STAGING_ONLY (no
// products: the outputs are not computed) is built for timing only.
//
// C interface (bound with ctypes; every pointer and the stream as void*;
// the same arguments for both routes):
//   int repro_block_matvec_wgmma{,_ld}(A, lda, Qt, ld_q, Y, m, n, k, stream)
//       Qt: Q^T, (k, n) bf16 with rows ld_q >= n elements apart
//   int repro_block_rmatvec_wgmma{,_ld}(A, lda, Yt, Z, partial, m, n, k,
//                                       ld_y, slab_rows, stream)
//       Yt: Y^T, (k, m) bf16 with rows ld_y >= m elements apart
// The skinny operand's base and row stride are multiples of 16 bytes (a
// tensor map's; the wrapper rounds its rows up).  Both return
// cudaGetLastError() after their launches (0 on success),
// cudaErrorInvalidValue for operands the route cannot read (on "wgmma" an
// A no tensor map describes; on either, a base not 2-byte aligned or an
// lda below n) or a slab that is not whole stages, or
// cudaErrorNotSupported without libcuda's tensor-map encoder.  They
// allocate nothing: `partial` is (ceil(m / slab_rows), n, k) fp32 scratch
// from the caller, unused (may be null) when there is a single slab.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"
#include "slab_sum.cuh"

namespace {

using namespace repro_hopper;

constexpr int NCONS = 2;               // consumer warpgroups
constexpr int NT = 128 * (NCONS + 1);  // + one producer warpgroup
constexpr int BK = 64;                 // reduction depth of a stage
constexpr int STAGES = 4;              // ring of shared-memory stages
constexpr int TILE = 64 * 128;         // one box of 64 rows x 64 bf16, bytes
constexpr int BM = 64 * 2 * NCONS;     // block_matvec: rows of A a block
constexpr int BN = 64 * 2 * NCONS;     // block_rmatvec: columns of A a block
constexpr int KT = 64;                 // block_rmatvec: k rows of Y^T a tile

// Each stage's wgmma sums start from zero and add_into moves them into
// rounded fp32 adds (see the header).  Built with -DREPRO_TC_SUMS_ONLY, the
// sums stay in the tensor cores' accumulators for the whole reduction
// instead (add_into only copies them out): a planted fault, which
// chip_smoke.py builds to show that the kernel-vs-plain limit rejects it.
#ifdef REPRO_TC_SUMS_ONLY
constexpr bool PROMOTE = false;
#else
constexpr bool PROMOTE = true;
#endif
#ifdef REPRO_NO_ZFILL
constexpr bool ZFILL = false;
#else
constexpr bool ZFILL = true;
#endif

// The producer of A (see the header): LD = 0, TMA from one thread; 8 or 4,
// cp.async of LD bytes from each of the producer warpgroup's 128 threads;
// 2, the same with register copies of the rows 2 bytes off.  setmaxnreg:
// 128 x PRODUCER_REGS + 256 x CONSUMER_REGS <= 384 x 168, the registers
// __launch_bounds__(384, 1) gives the block (more, and the consumers'
// setmaxnreg.inc waits forever).
template <int LD>
struct Producer {
  static constexpr int PRODUCER_REGS = LD == 0 ? 24 : LD == 2 ? 152 : 56;
  static constexpr int CONSUMER_REGS = LD == 0 ? 240 : LD == 2 ? 176 : 224;
  // full: the TMA thread's one arrival (the bytes announced with it), and
  // each copying thread's cp.async arrival and, on LD = 2, its register
  // stores'
  static constexpr int FULL_ARRIVALS = LD == 0 ? 1 : LD == 2 ? 257 : 129;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 384 * 168,
                "setmaxnreg beyond the block's registers");
};

// block_matvec's dynamic shared memory, from a 1024-byte aligned base:
// A [STAGES][BM rows][128 B], Q^T [STAGES][N rows][128 B], then
// full[STAGES] and empty[STAGES].
template <int N>
struct MatvecSmem {
  static constexpr int A_STAGE = BM * 128;
  static constexpr int Q_STAGE = N * 128;
  static constexpr int A = 0;
  static constexpr int Q = A + STAGES * A_STAGE;
  static constexpr int BAR = Q + STAGES * Q_STAGE;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;
};

// block_rmatvec's: A [STAGES][BN / 64 boxes][64 rows][128 B], Y^T
// [STAGES][KT rows][128 B], then the barriers.
struct RmatvecSmem {
  static constexpr int A_STAGE = (BN / 64) * TILE;
  static constexpr int Y_STAGE = KT * 128;
  static constexpr int A = 0;
  static constexpr int Y = A + STAGES * A_STAGE;
  static constexpr int BAR = Y + STAGES * Y_STAGE;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;
};

template <int R>
__device__ __forceinline__ void add_into(float (&sum)[R],
                                         const float (&d)[R]) {
#pragma unroll
  for (int i = 0; i < R; ++i) sum[i] = PROMOTE ? sum[i] + d[i] : d[i];
}

// Producer thread t's (0 .. 127) share of a stage of A on LD = 2: rows r0
// .. r0 + R - 1 and columns c0 .. c0 + 64 BOXES - 1 of A (rows row_bytes
// apart), laid out as copy_stage lays them, in 16-byte chunks of 8 bf16.
// The thread keeps chunk column x and takes the rows rt + RPP q, q < 16:
// RPP is even, so they share their alignment, and rt interleaves the
// rows' parities so that each warp's are alike (on an odd lda every other
// row starts 2 bytes off a 4-byte boundary).  Rows that start aligned by
// cp.async of 4 bytes, the others by registers (load_words, put_chunk),
// all 16 chunks' loads in flight at once (the register path's speed
// follows the loads in flight: 8 at a time took twice as long on an H100,
// PERF.md section 6).  Rows from r_end and columns from n arrive as zeros
// and are not read (ZFILL = false: the columns are read past n).  Returns
// whether the thread stored from registers.
template <int R, int BOXES>
__device__ __forceinline__ bool copy_stage_ld(uint32_t dst, const char* A,
                                              long long row_bytes, int r0,
                                              int r_end, int c0, int n,
                                              int t) {
  constexpr int TPR = 8 * BOXES;             // threads on a row: its chunks
  constexpr int RPP = 128 / TPR;             // rows a pass
  constexpr int P = R / RPP;                 // chunks a thread: 16
  static_assert(RPP % 2 == 0, "rows of one parity");
  const int x = t % TPR, slot = t / TPR;
  const int rt = 2 * (slot % (RPP / 2)) + slot / (RPP / 2);
  const char* src = A + (r0 + rt) * row_bytes + 2 * (c0 + 8 * x);
  const long long step = RPP * row_bytes;
  const int vcol = ZFILL ? min(8, max(0, n - c0 - 8 * x)) : 8;
  const bool by_reg = (reinterpret_cast<uintptr_t>(src) & 3) != 0;
  // chunk x % 8 of row rt + RPP q of box x / 8 lies at chunk
  // (x % 8) ^ (rt % 8) ^ (RPP q % 8): rt < RPP, a power of two
  const uint32_t d0 = dst + (x / 8) * R * 128 + rt * 128;
  const int sw = (x % 8) ^ (rt & 7);
  uint32_t w[P][5];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int v = r0 + rt + RPP * p < r_end ? vcol : 0;
    const char* s = src + p * step;
    if (by_reg) {
      if (v > 0) load_words(s, v, w[p]);
    } else {
      copy_chunk(d0 + p * RPP * 128 + ((sw ^ (RPP * p & 7)) << 4),
                 v > 0 ? s : A, v, false, false);
    }
  }
  if (by_reg) {
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const int v = r0 + rt + RPP * p < r_end ? vcol : 0;
      put_chunk(d0 + p * RPP * 128 + ((sw ^ (RPP * p & 7)) << 4), v,
                w[p]);                       // zeros where v == 0
    }
  }
  return by_reg;
}

// A stage of A from the producer's 128 copying threads (LD != 0): rows r0
// .. and BOXES boxes of 64 columns from c0, and thread t's arrivals on the
// stage's full barrier.
template <int LD, int R, int BOXES, bool UNROLL>
__device__ __forceinline__ void copy_a(uint32_t dst, const uint16_t* A,
                                       long long lda, int r0, int r_end,
                                       int c0, int n, int t, uint32_t bar) {
  const char* a = reinterpret_cast<const char*>(A);
  if constexpr (LD == 2) {
    if (copy_stage_ld<R, BOXES>(dst, a, 2 * lda, r0, r_end, c0, n, t))
      fence_proxy_async();                   // the stores, for wgmma
    mbar_arrive(bar);
  } else {
    copy_stage<LD / 2, R, BOXES, UNROLL, ZFILL>(dst, A, lda, r0, r_end, c0, n,
                                                t);
  }
  cp_async_arrive(bar);
}

// Y[row0 : row0 + BM, col0 : col0 + N] = A[rows, :] @ Q[:, cols] for each
// job (row0, col0) of the block, Q^T's tile being rows col0 .. col0 + N of
// the (k, n) map mq.  Persistent: a block takes jobs blockIdx.x,
// + gridDim.x, ..., and the ring runs on from one job into the next, so
// the next job's loads are in flight while this one's sums are stored.
template <int N, int LD>
__global__ void __launch_bounds__(NT, 1)
    matvec_tc(const __grid_constant__ CUtensorMap ma,
              const uint16_t* __restrict__ A, long long lda,
              const __grid_constant__ CUtensorMap mq, float* __restrict__ Y,
              int m, int n, int k) {
  using L = MatvecSmem<N>;
  using P = Producer<LD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES;
  const int row_jobs = (m + BM - 1) / BM;
  const int jobs = row_jobs * ((k + N - 1) / N);
  const int stages = (n + BK - 1) / BK;
  init_barriers<STAGES, 4 * NCONS, P::FULL_ARRIVALS>(full, empty);

  if (threadIdx.x >= 128 * NCONS) {          // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::PRODUCER_REGS));
    const int t = threadIdx.x - 128 * NCONS;
    if (LD == 0 && t != 0) return;            // one thread issues the TMA
    int i = 0;
    for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
      const int row0 = job % row_jobs * BM, col0 = job / row_jobs * N;
      for (int st = 0; st < stages; ++st, ++i) {
        const int s = i % STAGES;
        const uint32_t bar = full + 8 * s;
        if constexpr (LD == 0) {
          claim<STAGES>(full, empty, i, L::A_STAGE + L::Q_STAGE);
          tma_load_2d(base + L::A + s * L::A_STAGE, &ma, bar, st * BK, row0);
        } else {
          if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
          if (t == 0) mbar_expect_tx(bar, L::Q_STAGE);
        }
        if (t == 0)
          tma_load_2d(base + L::Q + s * L::Q_STAGE, &mq, bar, st * BK, col0);
        if constexpr (LD != 0)
          // the rows' loop in groups of 8, as block_matvec_tf32.cu's
          copy_a<LD, BM, 1, false>(base + L::A + s * L::A_STAGE, A, lda, row0,
                                   m, st * BK, n, t, bar);
      }
    }
    if constexpr (LD != 0) cp_async_wait_all();
    return;
  }

  // a consumer warpgroup: rows row0 + 128 wg .. + 127, two m64 tiles
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      P::CONSUMER_REGS));
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  float acc[2][N / 2], sum[2][N / 2];
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int e = 0; e < N / 2; ++e) acc[t][e] = 0.0f;

  int i = 0;
  for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
    const int row0 = job % row_jobs * BM, col0 = job / row_jobs * N;
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int e = 0; e < N / 2; ++e) sum[t][e] = 0.0f;
    for (int st = 0; st < stages; ++st, ++i) {
      const int s = i % STAGES;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      if constexpr (LD != 0) fence_proxy_async();   // the copies, for wgmma
      const uint32_t a_st = base + L::A + s * L::A_STAGE + 2 * wg * TILE;
      const uint32_t q_st = base + L::Q + s * L::Q_STAGE;
      hold(acc[0]);
      hold(acc[1]);
      wg_fence();
#ifndef REPRO_STAGING_ONLY
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_ss<N, 0>(acc[t], desc(a_st + t * TILE + 32 * ks, 16, 1024),
                         desc(q_st + 32 * ks, 16, 1024),
                         ks > 0 || (!PROMOTE && st > 0));
#endif
      wg_commit();
      wg_wait_all();
      hold(acc[0]);
      hold(acc[1]);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      add_into(sum[0], acc[0]);
      add_into(sum[1], acc[1]);
    }

    // sum[t][4 j + e] is row (tile t) 16 warp + lane / 4 + 8 (e / 2),
    // column 8 j + 2 (lane % 4) + e % 2
#pragma unroll
    for (int t = 0; t < 2; ++t) {
      const int r_base = row0 + 64 * (2 * wg + t) + 16 * warp + lane / 4;
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int r = r_base + 8 * (e / 2);
          const int c = col0 + 8 * j + 2 * (lane % 4) + e % 2;
          if (r < m && c < k)
            Y[static_cast<int64_t>(r) * k + c] = sum[t][4 * j + e];
        }
    }
  }
}

// out[c0 : c0 + BN, kt0 : kt0 + KT] = (Y^T[kt0 rows, slab] A[slab, cols])^T,
// the slab being rows [z slab_rows, min(m, (z + 1) slab_rows)) and
// out = Z + z n k.
template <int LD>
__global__ void __launch_bounds__(NT, 1)
    rmatvec_tc(const __grid_constant__ CUtensorMap ma,
               const uint16_t* __restrict__ A, long long lda,
               const __grid_constant__ CUtensorMap my, float* __restrict__ Z,
               int m, int n, int k, int slab_rows) {
  using L = RmatvecSmem;
  using P = Producer<LD>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES;
  const int c0 = static_cast<int>(blockIdx.x) * BN;
  const int kt0 = static_cast<int>(blockIdx.y) * KT;
  const int r_begin = static_cast<int>(blockIdx.z) * slab_rows;
  const int r_end = min(m, r_begin + slab_rows);
  const int tiles = (r_end - r_begin + BK - 1) / BK;
  init_barriers<STAGES, 4 * NCONS, P::FULL_ARRIVALS>(full, empty);

  if (threadIdx.x >= 128 * NCONS) {          // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::PRODUCER_REGS));
    const int t = threadIdx.x - 128 * NCONS;
    if (LD == 0 && t != 0) return;            // one thread issues the TMA
    for (int i = 0; i < tiles; ++i) {
      const int s = i % STAGES;
      const int i0 = r_begin + i * BK;
      const uint32_t bar = full + 8 * s;
      if constexpr (LD == 0) {
        claim<STAGES>(full, empty, i, L::A_STAGE + L::Y_STAGE);
        for (int b = 0; b < BN / 64; ++b)
          tma_load_2d(base + L::A + s * L::A_STAGE + b * TILE, &ma, bar,
                      c0 + 64 * b, i0);
      } else {
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        if (t == 0) mbar_expect_tx(bar, L::Y_STAGE);
      }
      if (t == 0)
        tma_load_2d(base + L::Y + s * L::Y_STAGE, &my, bar, i0, kt0);
      if constexpr (LD != 0)
        // the rows' loop unrolled whole, as block_matvec_tf32.cu's
        copy_a<LD, BK, BN / 64, true>(base + L::A + s * L::A_STAGE, A, lda,
                                      i0, r_end, c0, n, t, bar);
    }
    if constexpr (LD != 0) cp_async_wait_all();
    return;
  }

  // a consumer warpgroup: columns c0 + 128 wg .. + 127 of A, m64n128
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      P::CONSUMER_REGS));
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.0f;

  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    if constexpr (LD != 0) fence_proxy_async();     // the copies, for wgmma
    const uint32_t a_st = base + L::A + s * L::A_STAGE + 2 * wg * TILE;
    const uint32_t y_st = base + L::Y + s * L::Y_STAGE;
    hold(acc);
    wg_fence();
#ifndef REPRO_STAGING_ONLY
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_ss<128, 1>(acc, desc(y_st + 32 * ks, 16, 1024),
                       desc(a_st + 2048 * ks, TILE, 1024),
                       ks > 0 || (!PROMOTE && i > 0));
#endif
    wg_commit();
    wg_wait_all();
    hold(acc);
    if (lane == 0) mbar_arrive(empty + 8 * s);
    add_into(sum, acc);
  }

  // sum[4 j + e] is Z^T row (a column of Z) kt0 + 16 warp + lane / 4 +
  // 8 (e / 2), column (a row of Z) c0 + 128 wg + 8 j + 2 (lane % 4) + e % 2
  float* out = Z + static_cast<int64_t>(blockIdx.z) * n * k;
  const int q_base = kt0 + 16 * warp + lane / 4;
  const int c_base = c0 + 128 * wg + 2 * (lane % 4);
#pragma unroll
  for (int j = 0; j < 16; ++j)
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int q = q_base + 8 * (e / 2);
      const int c = c_base + 8 * j + e % 2;
      if (q < k && c < n)
        out[static_cast<int64_t>(c) * k + q] = sum[4 * j + e];
    }
}

// The producer that reads a bf16 A (m, n), rows lda apart, on the route:
// "wgmma" (ld false) TMA, 0; "wgmma_ld" cp.async of 8 bytes where every
// row starts 8-byte aligned, of 4 where every row starts 4-byte aligned,
// else 2 (the register copies too).  -1 where the route cannot read A.
inline int bf16_producer(const void* A, long long lda, long long n, bool ld) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(A);
  if (a % 2 != 0 || lda < n) return -1;
  if (!ld) return a % 16 == 0 && lda % 8 == 0 ? 0 : -1;
  if (a % 8 == 0 && lda % 4 == 0) return 8;
  return a % 4 == 0 && lda % 2 == 0 ? 4 : 2;
}

// A's tensor map for the TMA producer (LD = 0), boxes of `box_rows` rows;
// the copying producers read A through its pointer and leave the map zero.
template <int LD>
cudaError_t a_map(CUtensorMap* map, const void* A, int m, int n,
                  long long lda, int box_rows) {
  if (LD != 0) return cudaSuccess;
  return encode_2d(map, A, m, n, lda, box_rows);
}

template <int N, int LD>
int launch_matvec(const void* A, long long lda, const void* Qt,
                  long long ld_q, void* Y, int m, int n, int k,
                  cudaStream_t s) {
  CUtensorMap ma{}, mq;
  cudaError_t err = a_map<LD>(&ma, A, m, n, lda, BM);
  if (err == cudaSuccess) err = encode_2d(&mq, Qt, k, n, ld_q, N);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = matvec_tc<N, LD>;
  constexpr int bytes = MatvecSmem<N>::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long jobs = (m + BM - 1) / BM * static_cast<long long>(
                                                   (k + N - 1) / N);
  kern<<<resident_blocks(jobs), NT, bytes, s>>>(
      ma, static_cast<const uint16_t*>(A), lda, mq, static_cast<float*>(Y), m,
      n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int LD>
int matvec_k(const void* A, long long lda, const void* Qt, long long ld_q,
             void* Y, int m, int n, int k, cudaStream_t s) {
  if (k <= 16) return launch_matvec<16, LD>(A, lda, Qt, ld_q, Y, m, n, k, s);
  if (k <= 32) return launch_matvec<32, LD>(A, lda, Qt, ld_q, Y, m, n, k, s);
  return launch_matvec<64, LD>(A, lda, Qt, ld_q, Y, m, n, k, s);
}

template <int LD>
int launch_rmatvec(const void* A, long long lda, const void* Yt, float* out,
                   int m, int n, int k, long long ld_y, int slab_rows,
                   int slabs, cudaStream_t s) {
  CUtensorMap ma{}, my;
  cudaError_t err = a_map<LD>(&ma, A, m, n, lda, BK);
  if (err == cudaSuccess) err = encode_2d(&my, Yt, k, m, ld_y, KT);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = rmatvec_tc<LD>;
  constexpr int bytes = RmatvecSmem::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((k + KT - 1) / KT),
                  (unsigned)slabs);
  kern<<<grid, NT, bytes, s>>>(ma, static_cast<const uint16_t*>(A), lda, my,
                               out, m, n, k, slab_rows);
  return static_cast<int>(cudaGetLastError());
}

int matvec_entry(bool ld, const void* A, long long lda, const void* Qt,
                 long long ld_q, void* Y, long long m, long long n,
                 long long k, void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = bf16_producer(A, lda, n, ld);
  if (p < 0 || ld_q < n) return static_cast<int>(cudaErrorInvalidValue);
  const int mi = (int)m, ni = (int)n, ki = (int)k;
  if (p == 0) return matvec_k<0>(A, lda, Qt, ld_q, Y, mi, ni, ki, s);
  if (p == 8) return matvec_k<8>(A, lda, Qt, ld_q, Y, mi, ni, ki, s);
  if (p == 4) return matvec_k<4>(A, lda, Qt, ld_q, Y, mi, ni, ki, s);
  return matvec_k<2>(A, lda, Qt, ld_q, Y, mi, ni, ki, s);
}

int rmatvec_entry(bool ld, const void* A, long long lda, const void* Yt,
                  void* Z, void* partial, long long m, long long n,
                  long long k, long long ld_y, long long slab_rows,
                  void* stream) {
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int p = bf16_producer(A, lda, n, ld);
  if (p < 0 || slab_rows <= 0 || slab_rows % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = (int)((m + slab_rows - 1) / slab_rows);
  float* out = static_cast<float*>(slabs > 1 ? partial : Z);
  const int mi = (int)m, ni = (int)n, ki = (int)k, rows = (int)slab_rows;
  int err;
  if (p == 0)
    err = launch_rmatvec<0>(A, lda, Yt, out, mi, ni, ki, ld_y, rows, slabs, s);
  else if (p == 8)
    err = launch_rmatvec<8>(A, lda, Yt, out, mi, ni, ki, ld_y, rows, slabs, s);
  else if (p == 4)
    err = launch_rmatvec<4>(A, lda, Yt, out, mi, ni, ki, ld_y, rows, slabs, s);
  else
    err = launch_rmatvec<2>(A, lda, Yt, out, mi, ni, ki, ld_y, rows, slabs, s);
  if (err != 0) return err;
  if (slabs > 1)
    repro_slab_sum::sum_slabs(static_cast<const float*>(partial),
                              static_cast<float*>(Z), n * k, slabs, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_block_matvec_wgmma(const void* A, long long lda,
                                        const void* Qt, long long ld_q,
                                        void* Y, long long m, long long n,
                                        long long k, void* stream) {
  return matvec_entry(false, A, lda, Qt, ld_q, Y, m, n, k, stream);
}

extern "C" int repro_block_matvec_wgmma_ld(const void* A, long long lda,
                                           const void* Qt, long long ld_q,
                                           void* Y, long long m, long long n,
                                           long long k, void* stream) {
  return matvec_entry(true, A, lda, Qt, ld_q, Y, m, n, k, stream);
}

extern "C" int repro_block_rmatvec_wgmma(const void* A, long long lda,
                                         const void* Yt, void* Z,
                                         void* partial, long long m,
                                         long long n, long long k,
                                         long long ld_y, long long slab_rows,
                                         void* stream) {
  return rmatvec_entry(false, A, lda, Yt, Z, partial, m, n, k, ld_y,
                       slab_rows, stream);
}

extern "C" int repro_block_rmatvec_wgmma_ld(const void* A, long long lda,
                                            const void* Yt, void* Z,
                                            void* partial, long long m,
                                            long long n, long long k,
                                            long long ld_y,
                                            long long slab_rows,
                                            void* stream) {
  return rmatvec_entry(true, A, lda, Yt, Z, partial, m, n, k, ld_y,
                       slab_rows, stream);
}
