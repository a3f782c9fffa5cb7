// The fp32 block sweeps on Hopper's tensor cores as 3xTF32 (sm_90a: wgmma
// with A in registers; A staged by TMA or by cp.async).
//
//   block_matvec   Y = A @ Q      A (m, n) fp32, rows lda apart, Q (n, k),
//                                 Y (m, k)
//   block_rmatvec  Z = A^T @ Y    A (m, n) fp32, rows lda apart, Y (m, k),
//                                 Z (n, k)
//
// Replace the Pallas TPU kernels of src/repro/kernels/block_matvec.py:
// block_matvec (pallas_call at :81) and block_rmatvec (pallas_call at :127),
// for every fp32 operand; the chain Z = A^T (A Q) of that file
// (block_gram_chain, :146) is the composition of the two, done by the
// wrapper in kernels/ops.py.  Two routes (kernels/block_matvec.py::route):
// "tf32x3", where a TMA tensor map describes A (base and row stride 4 lda
// bytes multiples of 16), and "tf32x3_cpasync" for every other fp32 A (any
// width, any 4-byte-aligned base), whose rows the producer copies itself.
//
// Bound on an H100 SXM at the main path's 262144 x 32768, k = 32: one sweep
// reads 34.4 GB of fp32 A, 10.26 ms at 3.35 TB/s.  Its 2 m n k = 5.5e11 flop
// take 8.2 ms at the 67 TFLOP/s FFMA peak, so an FFMA sweep is bound twice
// over; as three TF32 products on the tensor cores, 3 x 5.5e11 flop at 495
// TFLOP/s, they take 3.3 ms, which leaves the sweep bound by its bytes.
// What the design does:
//   * 3xTF32, never plain TF32: each fp32 operand x is split into
//     hi = tf32(x) and lo = tf32(x - hi) (round to nearest, ties away), and
//     each product is a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms
//     issued first; the dropped a_lo b_lo is ~2^-22 relative, where one
//     TF32 product alone (~2^-11) would miss the 1e-5 limit by far.  A is
//     split in registers; the skinny operand (k / n or k / m of A's bytes)
//     by a small first launch, split_transpose, which writes Q^T or Y^T as
//     hi and lo halves; both by cvt.rna.tf32.f32.
//   * wgmma's tf32 forms read both shared-memory operands K-major only (the
//     transposed forms are f16/bf16's), so A is the A operand from
//     registers in both kernels, read by the consumer threads out of the
//     swizzled stage, and the skinny operand is the K-major B operand: Q^T
//     (k, n) or Y^T (k, m), k rows of the reduction axis.  block_matvec's
//     fragment is a tile of A (ldmatrix: each 16-byte row of an 8 x 8 b16
//     matrix is 4 fp32, lane l receiving element l % 4 of row l / 4, the
//     fragment's layout; the swizzle makes it conflict-free).
//     block_rmatvec's is a tile of A^T, read element by element out of the
//     row-major stage; its 64 output rows are a permutation of 64 columns
//     of A (bits 2 and 4 of the column swapped with bits 4 and 3 of the
//     output row, see rmatvec_col), chosen with the swizzle's XOR so that
//     the 32 lanes of each read hit 32 banks.
//   * Warp-specialised blocks of 384 threads: a producer warpgroup fills a
//     ring of STAGES = 4 stages of 32 KiB of A (32 fp32 deep) and the two
//     halves of the skinny operand's tile, each completing on its "full"
//     mbarrier; two consumer warpgroups split A, issue wgmma and release
//     the stage on its "empty" mbarrier.  The stage is laid out as TMA's
//     128-byte swizzle writes it (16-byte chunk c of row r at chunk
//     c ^ (r % 8)), whichever producer fills it, so the consumers are one
//     code for both routes.  Elements past the edges arrive as zeros and
//     nothing is padded in memory.  The producer, the template parameter
//     CP of both kernels:
//       - CP = 0 ("tf32x3"): one thread issues TMA loads of A's boxes and of
//         the skinny operand's halves; setmaxnreg gives the producer
//         warpgroup 24 registers, the consumers 240.
//       - CP = 1 or 2 ("tf32x3_cpasync"): the skinny operand's halves still
//         arrive by TMA (one thread; the library writes them with rows of
//         whole 16 bytes), but A, whose rows no tensor map describes, is
//         copied by all 128 producer threads with cp.async of CP fp32 (8
//         bytes where lda is even and the base 8-byte aligned, else 4),
//         each granule written to its swizzled place; coalesced along A's
//         rows, 32 consecutive fp32 a warp.  Columns past n and rows past
//         the edge arrive as zeros through cp.async's src-size (a row is
//         never read past its n-th element), and each thread's copies
//         complete on the stage's full barrier through
//         cp.async.mbarrier.arrive.noinc (129 arrivals: the 128 copying
//         threads and the TMA thread's byte count).  The producer needs
//         registers for the addresses: 56 a thread, the consumers 224
//         (128 x 56 + 256 x 224 = the block's 384 x 168).
//   * block_matvec: a job is BM = 256 rows of A (two m64 tiles a consumer),
//     N = k rounded up to 16, 32 or 64 (wider k in tiles of 64 columns,
//     which re-read A); the grid is persistent, one block an SM taking every
//     gridDim.x-th job, the ring running on from job to job.  The skinny
//     operand's two halves are re-read 2 k / 256 of A's bytes through L2.
//   * block_rmatvec: a block owns BN = 256 columns of A (two m64 tiles a
//     consumer), a k tile of N and one slab of rows; the reduction over m is
//     split into slabs of whole stages, at most 16384 rows, whose fp32
//     partials a second launch sums in order (slab_sum.cuh): no atomics,
//     bitwise reruns.
//   * The sums: the tensor cores' fp32 accumulator need not round as an FFMA
//     does, so each stage (32 deep) starts its wgmma sums from zero and the
//     consumer adds them into a second set of fp32 registers with ordinary
//     (rounded) adds: the error is that of an fp32 sum of n / 32 (or slab /
//     32) terms.  Every rerun adds in the same order.
//   * Shared-memory reads per 8-deep step: B's hi half twice, its lo half
//     once, and A once more from the stage into registers; at the path's
//     shape ~2.5 bytes of shared memory a byte of A, hidden under the
//     device-memory stream.
//
// Planted faults, built by chip_smoke.py beside the real library to show
// that the kernel-vs-plain limit rejects them: -DREPRO_TF32_ONLY (the hi hi
// term alone: plain TF32), -DREPRO_TC_SUMS_ONLY (the sums left in the
// tensor cores' accumulators for the whole reduction), both on both routes,
// and -DREPRO_NO_ZFILL (the cp.async route copies the columns past n from
// past the end of the row instead of zero-filling them).
//
// C interface (bound with ctypes; every pointer and the stream as void*;
// the same arguments for both routes):
//   int repro_block_matvec_tf32x3{,_cpasync}(A, lda, Q, split, Y, m, n, k,
//                                            ld, stream)
//   int repro_block_rmatvec_tf32x3{,_cpasync}(A, lda, Y, split, Z, partial,
//                                             m, n, k, ld, slab_rows, stream)
// Both return cudaGetLastError() after their launches (0 on success),
// cudaErrorInvalidValue for operands the route cannot read (on "tf32x3" A
// that no tensor map describes; on either, a base not 4-byte aligned, an
// lda below n, a `split` row stride ld that is not a multiple of 4 or a
// slab that is not whole stages), or cudaErrorNotSupported without libcuda's
// tensor-map encoder.  They allocate nothing.  Scratch from the caller,
// fp32: `split` (2, k, ld) for the skinny operand's transposed halves, ld
// >= n (block_matvec) or m (block_rmatvec) rounded up to a multiple of 4;
// `partial` (ceil(m / slab_rows), n, k), unused (may be null) when there is
// a single slab.

#include <cuda.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"
#include "slab_sum.cuh"

namespace {

using namespace repro_hopper;

constexpr int NCONS = 2;               // consumer warpgroups
constexpr int NT = 128 * (NCONS + 1);  // + one producer warpgroup
constexpr int BK = 32;                 // reduction depth of a stage (128 B)
constexpr int KS = BK / 8;             // wgmma k8 steps a stage
constexpr int STAGES = 4;              // ring of shared-memory stages
constexpr int BOX = 32 * 128;          // a box of 32 rows x 32 fp32, bytes
constexpr int BM = 64 * 2 * NCONS;     // block_matvec: rows of A a block
constexpr int BN = 64 * 2 * NCONS;     // block_rmatvec: columns of A a block

#ifdef REPRO_TC_SUMS_ONLY
constexpr bool PROMOTE = false;
#else
constexpr bool PROMOTE = true;
#endif
#ifdef REPRO_TF32_ONLY
constexpr bool SPLIT = false;
#else
constexpr bool SPLIT = true;
#endif
#ifdef REPRO_NO_ZFILL
constexpr bool ZFILL = false;
#else
constexpr bool ZFILL = true;
#endif

// The producer of A: CP = 0, TMA from one thread; CP = 1 or 2, cp.async of
// CP fp32 from each of the producer warpgroup's 128 threads.  setmaxnreg:
// 128 x PRODUCER_REGS + 256 x CONSUMER_REGS <= 384 x 168, the registers
// __launch_bounds__(384, 1) gives the block.
template <int CP>
struct Producer {
  static constexpr int PRODUCER_REGS = CP ? 56 : 24;
  static constexpr int CONSUMER_REGS = CP ? 224 : 240;
  static constexpr int FULL_ARRIVALS = CP ? 128 + 1 : 1;
};

// Dynamic shared memory of both kernels, from a 1024-byte aligned base:
// A [STAGES][32 KiB], the skinny operand's hi [STAGES][N rows][128 B] and
// lo halves, then full[STAGES] and empty[STAGES].
template <int N>
struct Smem {
  static constexpr int A_STAGE = 256 * 128;
  static constexpr int B_STAGE = N * 128;
  static constexpr int A = 0;
  static constexpr int BH = A + STAGES * A_STAGE;
  static constexpr int BL = BH + STAGES * B_STAGE;
  static constexpr int BAR = BL + STAGES * B_STAGE;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;
};

// One stage's products of a consumer's two m64 tiles, their sums restarted
// (`restart`): acc[t] = sum over the stage's k8 steps s of
// A_t,s (B_hi + B_lo) as a_lo b_hi + a_hi b_lo, then a_hi b_hi.
template <int N>
__device__ __forceinline__ void stage_products(
    float (&acc)[2][N / 2], uint32_t (&ah)[2 * KS][4],
    uint32_t (&al)[2 * KS][4], uint32_t bh, uint32_t bl, bool restart) {
#pragma unroll
  for (int t = 0; t < 2; ++t) {
    if constexpr (SPLIT) {
#pragma unroll
      for (int s = 0; s < KS; ++s) {
        wgmma_rs_tf32<N>(acc[t], al[KS * t + s], desc(bh + 32 * s, 16, 1024),
                         s > 0 || !restart);
        wgmma_rs_tf32<N>(acc[t], ah[KS * t + s], desc(bl + 32 * s, 16, 1024),
                         1);
      }
    }
#pragma unroll
    for (int s = 0; s < KS; ++s)
      wgmma_rs_tf32<N>(acc[t], ah[KS * t + s], desc(bh + 32 * s, 16, 1024),
                       SPLIT || s > 0 || !restart);
  }
}

template <int N>
__device__ __forceinline__ void add_into(float (&sum)[2][N / 2],
                                         const float (&d)[2][N / 2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < N / 2; ++i)
      sum[t][i] = PROMOTE ? sum[t][i] + d[t][i] : d[t][i];
}

template <int N>
__device__ __forceinline__ void zero(float (&r)[2][N / 2]) {
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int i = 0; i < N / 2; ++i) r[t][i] = 0.0f;
}

// Y[row0 : row0 + BM, col0 : col0 + N] = A[rows, :] @ Q[:, cols] for each
// job (row0, col0) of the block.  Persistent: a block takes jobs
// blockIdx.x, + gridDim.x, ..., and the ring runs on from one job into the
// next, so the next job's loads are in flight while this one's sums are
// stored.
template <int N, int CP>
__global__ void __launch_bounds__(NT, 1)
    matvec_tf32(const __grid_constant__ CUtensorMap ma,
                const float* __restrict__ A, long long lda,
                const __grid_constant__ CUtensorMap mqh,
                const __grid_constant__ CUtensorMap mql,
                float* __restrict__ Y, int m, int n, int k) {
  using L = Smem<N>;
  using P = Producer<CP>;
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
    if (CP == 0 && t != 0) return;            // one thread issues the TMA
    int i = 0;
    for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
      const int row0 = job % row_jobs * BM, col0 = job / row_jobs * N;
      for (int st = 0; st < stages; ++st, ++i) {
        const int s = i % STAGES;
        const uint32_t bar = full + 8 * s;
        if constexpr (CP == 0) {
          claim<STAGES>(full, empty, i, L::A_STAGE + 2 * L::B_STAGE);
          tma_load_2d(base + L::A + s * L::A_STAGE, &ma, bar, st * BK, row0);
        } else {
          if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
          if (t == 0) mbar_expect_tx(bar, 2 * L::B_STAGE);
        }
        if (t == 0) {
          tma_load_2d(base + L::BH + s * L::B_STAGE, &mqh, bar, st * BK, col0);
          tma_load_2d(base + L::BL + s * L::B_STAGE, &mql, bar, st * BK, col0);
        }
        if constexpr (CP != 0) {
          // the rows' loop in groups of 8 (unrolled whole it spills here)
          copy_stage<CP, BM, 1, false, ZFILL>(base + L::A + s * L::A_STAGE,
                                              A, lda, row0, m, st * BK, n, t);
          cp_async_arrive(bar);
        }
      }
    }
    if constexpr (CP != 0) cp_async_wait_all();
    return;
  }

  // a consumer warpgroup: rows row0 + 128 wg .. + 127, two m64 tiles
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      P::CONSUMER_REGS));
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  // ldmatrix: lane j addresses row j % 8 of matrix j / 8, which is rows
  // + 8 (j / 8 % 2) and 16-byte chunk + (j / 16) of the k8 step
  const int lrow = 16 * warp + 8 * (lane / 8 % 2) + lane % 8;
  const uint32_t a_off = 128 * wg * 128 + lrow * 128;
  float acc[2][N / 2], sum[2][N / 2];
  zero<N>(acc);

  int i = 0;
  for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
    const int row0 = job % row_jobs * BM, col0 = job / row_jobs * N;
    zero<N>(sum);
    for (int st = 0; st < stages; ++st, ++i) {
      const int s = i % STAGES;
      mbar_wait(full + 8 * s, (i / STAGES) & 1);
      const uint32_t a_st = base + L::A + s * L::A_STAGE + a_off;
      uint32_t ah[2 * KS][4], al[2 * KS][4];
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int ks = 0; ks < KS; ++ks) {
          uint32_t x[4];
          const int chunk = 2 * ks + lane / 16;
          ldsm_x4(x, a_st + t * 64 * 128 + ((chunk ^ (lane % 8)) << 4));
          split(x, ah[KS * t + ks], al[KS * t + ks]);
        }
      hold(acc[0]);
      hold(acc[1]);
      wg_fence();
      stage_products<N>(acc, ah, al, base + L::BH + s * L::B_STAGE,
                        base + L::BL + s * L::B_STAGE, PROMOTE || st == 0);
      wg_commit();
      wg_wait_all();
      hold(acc[0]);
      hold(acc[1]);
      hold(ah);
      hold(al);
      if (lane == 0) mbar_arrive(empty + 8 * s);
      add_into<N>(sum, acc);
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

// out[c, q0 : q0 + N] = (A[slab, c]^T Y[slab, q0 : q0 + N]) for the block's
// BN columns c of A, the slab being rows [z slab_rows, min(m, (z + 1)
// slab_rows)) and out = Z + z n k.
template <int N, int CP>
__global__ void __launch_bounds__(NT, 1)
    rmatvec_tf32(const __grid_constant__ CUtensorMap ma,
                 const float* __restrict__ A, long long lda,
                 const __grid_constant__ CUtensorMap myh,
                 const __grid_constant__ CUtensorMap myl,
                 float* __restrict__ Z, int m, int n, int k, int slab_rows) {
  using L = Smem<N>;
  using P = Producer<CP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES;
  const int c0 = static_cast<int>(blockIdx.x) * BN;
  const int q0 = static_cast<int>(blockIdx.y) * N;
  const int r_begin = static_cast<int>(blockIdx.z) * slab_rows;
  const int r_end = min(m, r_begin + slab_rows);
  const int tiles = (r_end - r_begin + BK - 1) / BK;
  init_barriers<STAGES, 4 * NCONS, P::FULL_ARRIVALS>(full, empty);

  if (threadIdx.x >= 128 * NCONS) {          // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::PRODUCER_REGS));
    const int t = threadIdx.x - 128 * NCONS;
    if (CP == 0 && t != 0) return;            // one thread issues the TMA
    for (int i = 0; i < tiles; ++i) {
      const int s = i % STAGES;
      const int i0 = r_begin + i * BK;
      const uint32_t bar = full + 8 * s;
      if constexpr (CP == 0) {
        claim<STAGES>(full, empty, i, L::A_STAGE + 2 * L::B_STAGE);
        for (int b = 0; b < BN / 32; ++b)
          tma_load_2d(base + L::A + s * L::A_STAGE + b * BOX, &ma, bar,
                      c0 + 32 * b, i0);
      } else {
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        if (t == 0) mbar_expect_tx(bar, 2 * L::B_STAGE);
      }
      if (t == 0) {
        tma_load_2d(base + L::BH + s * L::B_STAGE, &myh, bar, i0, q0);
        tma_load_2d(base + L::BL + s * L::B_STAGE, &myl, bar, i0, q0);
      }
      if constexpr (CP != 0) {
        // the rows' loop unrolled whole (faster here, PERF.md section 6)
        copy_stage<CP, BK, BN / 32, true, ZFILL>(base + L::A + s * L::A_STAGE,
                                                 A, lda, i0, r_end, c0, n, t);
        cp_async_arrive(bar);
      }
    }
    if constexpr (CP != 0) cp_async_wait_all();
    return;
  }

  // a consumer warpgroup: columns c0 + 128 wg .. + 127 of A, two m64 tiles
  // of two boxes each; warp w of a tile reads box w / 2, rows 16 (w % 2) ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      P::CONSUMER_REGS));
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  // fragment register e: output row 16 (warp % 2) + lane / 4 + 8 (e % 2) of
  // the box-half, reduction row lane % 4 + 4 (e / 2) of the k8 step
  uint32_t off[4];
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const int col = rmatvec_col(16 * (warp % 2) + lane / 4 + 8 * (e % 2));
    const int r = lane % 4 + 4 * (e / 2);
    off[e] = (4 * wg + warp / 2) * BOX + r * 128 +
             (((col / 4) ^ r) << 4) + 4 * (col % 4);
  }
  float acc[2][N / 2], sum[2][N / 2];
  zero<N>(acc);
  zero<N>(sum);

  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t a_st = base + L::A + s * L::A_STAGE;
    uint32_t ah[2 * KS][4], al[2 * KS][4];
#pragma unroll
    for (int t = 0; t < 2; ++t)
#pragma unroll
      for (int ks = 0; ks < KS; ++ks) {
        uint32_t x[4];
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = lds_u32(a_st + t * 2 * BOX + ks * 8 * 128 + off[e]);
        split(x, ah[KS * t + ks], al[KS * t + ks]);
      }
    hold(acc[0]);
    hold(acc[1]);
    wg_fence();
    stage_products<N>(acc, ah, al, base + L::BH + s * L::B_STAGE,
                      base + L::BL + s * L::B_STAGE, PROMOTE || i == 0);
    wg_commit();
    wg_wait_all();
    hold(acc[0]);
    hold(acc[1]);
    hold(ah);
    hold(al);
    if (lane == 0) mbar_arrive(empty + 8 * s);
    add_into<N>(sum, acc);
  }

  // sum[t][4 j + e] is output row 16 warp + lane / 4 + 8 (e / 2) of tile t
  // (a column of A: box 2 t + warp / 2 of the consumer's four, rmatvec_col
  // of the row within the box), column q0 + 8 j + 2 (lane % 4) + e % 2
  float* out = Z + static_cast<int64_t>(blockIdx.z) * n * k;
#pragma unroll
  for (int t = 0; t < 2; ++t)
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int c = c0 + 32 * (4 * wg + 2 * t + warp / 2) +
                    rmatvec_col(16 * (warp % 2) + lane / 4 + 8 * h);
#pragma unroll
      for (int j = 0; j < N / 8; ++j)
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int q = q0 + 8 * j + 2 * (lane % 4) + e;
          if (q < k && c < n)
            out[static_cast<int64_t>(c) * k + q] = sum[t][4 * j + 2 * h + e];
        }
    }
}

// hi[q][r] = tf32(X[r][q]) and lo[q][r] = tf32(X[r][q] - hi[q][r]) for X
// (rows, k) row-major and hi, lo (k, ld); columns r >= rows of hi and lo
// are not written (their tensor maps end at `rows`).  A 32 x 32 tile a
// block, transposed through shared memory.
__global__ void __launch_bounds__(256)
    split_transpose(const float* __restrict__ X, float* __restrict__ hi,
                    float* __restrict__ lo, int rows, int k, int64_t ld) {
  __shared__ float tile[32][33];
  const int r0 = blockIdx.x * 32, q0 = blockIdx.y * 32;
  const int tx = threadIdx.x % 32, ty = threadIdx.x / 32;
  for (int y = ty; y < 32; y += 8) {
    const int r = r0 + y, q = q0 + tx;
    tile[y][tx] = r < rows && q < k ? X[static_cast<int64_t>(r) * k + q] : 0.f;
  }
  __syncthreads();
  for (int y = ty; y < 32; y += 8) {
    const int q = q0 + y, r = r0 + tx;
    if (q < k && r < rows) {
      const float v = tile[tx][y];
      const uint32_t h = tf32_rna(v);
      hi[q * ld + r] = __uint_as_float(h);
      lo[q * ld + r] = __uint_as_float(tf32_rna(v - __uint_as_float(h)));
    }
  }
}

// The skinny operand X (rows, k) as its transposed tf32 halves in
// split[0] and split[1], (k, ld) each.
inline void split_skinny(const void* X, void* split, int rows, int k,
                         int64_t ld, cudaStream_t s) {
  float* hi = static_cast<float*>(split);
  const dim3 grid((unsigned)((rows + 31) / 32), (unsigned)((k + 31) / 32));
  split_transpose<<<grid, 256, 0, s>>>(static_cast<const float*>(X), hi,
                                       hi + k * ld, rows, k, ld);
}

// A's tensor map for the TMA producer (CP = 0), boxes of `box_rows` rows;
// the cp.async producer reads A through its pointer and leaves the map zero.
template <int CP>
cudaError_t a_map(CUtensorMap* map, const void* A, int m, int n, long long lda,
                  int box_rows) {
  if (CP != 0) return cudaSuccess;
  return encode_2d(map, A, m, n, lda, box_rows, 4);
}

template <int N, int CP>
int launch_matvec(const void* A, long long lda, const void* Qh,
                  const void* Ql, long long ld, void* Y, int m, int n, int k,
                  cudaStream_t s) {
  CUtensorMap ma{}, mqh, mql;
  cudaError_t err = a_map<CP>(&ma, A, m, n, lda, BM);
  if (err == cudaSuccess) err = encode_2d(&mqh, Qh, k, n, ld, N, 4);
  if (err == cudaSuccess) err = encode_2d(&mql, Ql, k, n, ld, N, 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = matvec_tf32<N, CP>;
  constexpr int bytes = Smem<N>::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long jobs = (m + BM - 1) / BM * static_cast<long long>(
                                                   (k + N - 1) / N);
  kern<<<resident_blocks(jobs), NT, bytes, s>>>(
      ma, static_cast<const float*>(A), lda, mqh, mql, static_cast<float*>(Y),
      m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int N, int CP>
int launch_rmatvec(const void* A, long long lda, const void* Yh,
                   const void* Yl, float* out, int m, int n, int k,
                   long long ld_y, int slab_rows, int slabs, cudaStream_t s) {
  CUtensorMap ma{}, myh, myl;
  cudaError_t err = a_map<CP>(&ma, A, m, n, lda, BK);
  if (err == cudaSuccess) err = encode_2d(&myh, Yh, k, m, ld_y, N, 4);
  if (err == cudaSuccess) err = encode_2d(&myl, Yl, k, m, ld_y, N, 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = rmatvec_tf32<N, CP>;
  constexpr int bytes = Smem<N>::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((k + N - 1) / N),
                  (unsigned)slabs);
  kern<<<grid, NT, bytes, s>>>(ma, static_cast<const float*>(A), lda, myh, myl,
                               out, m, n, k, slab_rows);
  return static_cast<int>(cudaGetLastError());
}

template <int CP>
int matvec_k(const void* A, long long lda, const float* hi, const float* lo,
             long long ld, void* Y, int m, int n, int k, cudaStream_t s) {
  if (k <= 16) return launch_matvec<16, CP>(A, lda, hi, lo, ld, Y, m, n, k, s);
  if (k <= 32) return launch_matvec<32, CP>(A, lda, hi, lo, ld, Y, m, n, k, s);
  return launch_matvec<64, CP>(A, lda, hi, lo, ld, Y, m, n, k, s);
}

template <int CP>
int rmatvec_k(const void* A, long long lda, const float* hi, const float* lo,
              float* out, int m, int n, int k, long long ld, int rows,
              int slabs, cudaStream_t s) {
  if (k <= 16)
    return launch_rmatvec<16, CP>(A, lda, hi, lo, out, m, n, k, ld, rows,
                                  slabs, s);
  if (k <= 32)
    return launch_rmatvec<32, CP>(A, lda, hi, lo, out, m, n, k, ld, rows,
                                  slabs, s);
  return launch_rmatvec<64, CP>(A, lda, hi, lo, out, m, n, k, ld, rows, slabs,
                                s);
}

int matvec_entry(bool cpasync, const void* A, long long lda, const void* Q,
                 void* split, void* Y, long long m, long long n, long long k,
                 long long ld, void* stream) {
  cudaGetLastError();  // report this call's launches, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = fp32_producer(A, lda, n, cpasync);
  if (cp < 0 || ld < n || ld % 4 != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int mi = (int)m, ni = (int)n, ki = (int)k;
  split_skinny(Q, split, ni, ki, ld, s);
  const float* hi = static_cast<const float*>(split);
  const float* lo = hi + k * ld;
  if (cp == 0) return matvec_k<0>(A, lda, hi, lo, ld, Y, mi, ni, ki, s);
  if (cp == 1) return matvec_k<1>(A, lda, hi, lo, ld, Y, mi, ni, ki, s);
  return matvec_k<2>(A, lda, hi, lo, ld, Y, mi, ni, ki, s);
}

int rmatvec_entry(bool cpasync, const void* A, long long lda, const void* Y,
                  void* split, void* Z, void* partial, long long m,
                  long long n, long long k, long long ld, long long slab_rows,
                  void* stream) {
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = fp32_producer(A, lda, n, cpasync);
  if (cp < 0 || ld < m || ld % 4 != 0 || slab_rows <= 0 ||
      slab_rows % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = (int)((m + slab_rows - 1) / slab_rows);
  float* out = static_cast<float*>(slabs > 1 ? partial : Z);
  const int mi = (int)m, ni = (int)n, ki = (int)k, rows = (int)slab_rows;
  split_skinny(Y, split, mi, ki, ld, s);
  const float* hi = static_cast<const float*>(split);
  const float* lo = hi + k * ld;
  int err;
  if (cp == 0)
    err = rmatvec_k<0>(A, lda, hi, lo, out, mi, ni, ki, ld, rows, slabs, s);
  else if (cp == 1)
    err = rmatvec_k<1>(A, lda, hi, lo, out, mi, ni, ki, ld, rows, slabs, s);
  else
    err = rmatvec_k<2>(A, lda, hi, lo, out, mi, ni, ki, ld, rows, slabs, s);
  if (err != 0) return err;
  if (slabs > 1)
    repro_slab_sum::sum_slabs(static_cast<const float*>(partial),
                              static_cast<float*>(Z), n * k, slabs, s);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_block_matvec_tf32x3(const void* A, long long lda,
                                         const void* Q, void* split, void* Y,
                                         long long m, long long n, long long k,
                                         long long ld, void* stream) {
  return matvec_entry(false, A, lda, Q, split, Y, m, n, k, ld, stream);
}

extern "C" int repro_block_matvec_tf32x3_cpasync(const void* A, long long lda,
                                                 const void* Q, void* split,
                                                 void* Y, long long m,
                                                 long long n, long long k,
                                                 long long ld, void* stream) {
  return matvec_entry(true, A, lda, Q, split, Y, m, n, k, ld, stream);
}

extern "C" int repro_block_rmatvec_tf32x3(const void* A, long long lda,
                                          const void* Y, void* split, void* Z,
                                          void* partial, long long m,
                                          long long n, long long k,
                                          long long ld, long long slab_rows,
                                          void* stream) {
  return rmatvec_entry(false, A, lda, Y, split, Z, partial, m, n, k, ld,
                       slab_rows, stream);
}

extern "C" int repro_block_rmatvec_tf32x3_cpasync(
    const void* A, long long lda, const void* Y, void* split, void* Z,
    void* partial, long long m, long long n, long long k, long long ld,
    long long slab_rows, void* stream) {
  return rmatvec_entry(true, A, lda, Y, split, Z, partial, m, n, k, ld,
                       slab_rows, stream);
}
