// The fp32 block sweeps on Hopper's tensor cores as 3xTF32 (sm_90a: TMA +
// wgmma with A in registers).
//
//   block_matvec   Y = A @ Q      A (m, n) fp32 row-major, Q (n, k), Y (m, k)
//   block_rmatvec  Z = A^T @ Y    A (m, n) fp32 row-major, Y (m, k), Z (n, k)
//
// Replace the Pallas TPU kernels of src/repro/kernels/block_matvec.py:
// block_matvec (pallas_call at :81) and block_rmatvec (pallas_call at :127),
// for fp32 operands that a TMA tensor map describes; the chain Z = A^T (A Q)
// of that file (block_gram_chain, :146) is the composition of the two, done
// by the wrapper in kernels/ops.py.  Every other fp32 operand runs the FFMA
// kernels of block_matvec.cu (kernels/block_matvec.py::route).
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
//     TMA-filled, swizzled stage, and the skinny operand is the K-major B
//     operand: Q^T (k, n) or Y^T (k, m), k rows of the reduction axis.
//     block_matvec's fragment is a tile of A (ldmatrix: each 16-byte row of
//     an 8 x 8 b16 matrix is 4 fp32, lane l receiving element l % 4 of row
//     l / 4, the fragment's layout; the swizzle makes it conflict-free).
//     block_rmatvec's is a tile of A^T, read element by element out of the
//     row-major stage; its 64 output rows are a permutation of 64 columns
//     of A (bits 2 and 4 of the column swapped with bits 4 and 3 of the
//     output row, see rmatvec_col), chosen with the swizzle's XOR so that
//     the 32 lanes of each read hit 32 banks.
//   * Warp-specialised blocks of 384 threads: one producer thread issues the
//     TMA loads (128-byte swizzle; elements past the edges arrive as zeros,
//     nothing is padded in memory) into a ring of STAGES = 4 stages of 32
//     KiB of A (32 fp32 deep) and the two halves of the skinny operand's
//     tile, each completing on its "full" mbarrier; two consumer warpgroups
//     split A, issue wgmma and release the stage on its "empty" mbarrier.
//     setmaxnreg gives the consumers 240 registers, the producer 24.
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
//     32) terms, as in the FFMA kernels.  Every rerun adds in the same order.
//   * Shared-memory reads per 8-deep step: B's hi half twice, its lo half
//     once, and A once more from the stage into registers; at the path's
//     shape ~2.5 bytes of shared memory a byte of A, hidden under the
//     device-memory stream.
//
// Requirements (checked by the wrapper's route; encode_2d refuses the rest):
// A's base and its row stride 4 n bytes multiples of 16 (n % 4 == 0); the
// transposed skinny operand likewise (its row stride is rounded up).
//
// Planted faults, built by chip_smoke.py beside the real library to show
// that the kernel-vs-plain limit rejects them: -DREPRO_TF32_ONLY (the hi hi
// term alone: plain TF32) and -DREPRO_TC_SUMS_ONLY (the sums left in the
// tensor cores' accumulators for the whole reduction).
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_block_matvec_tf32x3(A, Q, split, Y, m, n, k, stream)
//   int repro_block_rmatvec_tf32x3(A, Y, split, Z, partial, m, n, k, ld,
//                                  slab_rows, stream)
// Both return cudaGetLastError() after their launches (0 on success),
// cudaErrorInvalidValue for operands a tensor map cannot describe or a slab
// that is not whole stages, or cudaErrorNotSupported without libcuda's
// tensor-map encoder.  They allocate nothing.  Scratch from the caller,
// fp32: `split` (2, k, ld) for the skinny operand's transposed halves, ld
// = n for block_matvec and m rounded up to a multiple of 4 for
// block_rmatvec; `partial` (ceil(m / slab_rows), n, k), unused (may be
// null) when there is a single slab.

#include <cuda.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"
#include "slab_sum.cuh"

namespace {

using namespace repro_hopper;

constexpr int NCONS = 2;               // consumer warpgroups
constexpr int NT = 128 * (NCONS + 1);  // + one producer warpgroup
constexpr int PRODUCER_REGS = 24;      // setmaxnreg: 128 x 24 + 256 x 240
constexpr int CONSUMER_REGS = 240;     //   <= 65,536 registers of the SM
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

// The fragment x split into its tf32 halves.
__device__ __forceinline__ void split(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v = __uint_as_float(x[e]);
    hi[e] = tf32_rna(v);
    lo[e] = tf32_rna(v - __uint_as_float(hi[e]));
  }
}

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
template <int N>
__global__ void __launch_bounds__(NT, 1)
    matvec_tf32(const __grid_constant__ CUtensorMap ma,
                const __grid_constant__ CUtensorMap mqh,
                const __grid_constant__ CUtensorMap mql,
                float* __restrict__ Y, int m, int n, int k) {
  using L = Smem<N>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES;
  const int row_jobs = (m + BM - 1) / BM;
  const int jobs = row_jobs * ((k + N - 1) / N);
  const int stages = (n + BK - 1) / BK;
  init_barriers<STAGES, 4 * NCONS>(full, empty);

  if (threadIdx.x >= 128 * NCONS) {          // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 128 * NCONS) return;   // one thread issues the TMA
    int i = 0;
    for (int job = blockIdx.x; job < jobs; job += gridDim.x) {
      const int row0 = job % row_jobs * BM, col0 = job / row_jobs * N;
      for (int st = 0; st < stages; ++st, ++i) {
        const int s = i % STAGES;
        const uint32_t bar =
            claim<STAGES>(full, empty, i, L::A_STAGE + 2 * L::B_STAGE);
        tma_load_2d(base + L::A + s * L::A_STAGE, &ma, bar, st * BK, row0);
        tma_load_2d(base + L::BH + s * L::B_STAGE, &mqh, bar, st * BK, col0);
        tma_load_2d(base + L::BL + s * L::B_STAGE, &mql, bar, st * BK, col0);
      }
    }
    return;
  }

  // a consumer warpgroup: rows row0 + 128 wg .. + 127, two m64 tiles
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
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

// The column of A, within its 32-column box, that output row i (0 .. 31)
// of an m64 tile's box-half stands for: bits 0-1 of i stay, bit 2 of i
// becomes bit 4, bit 3 becomes bit 2 and bit 4 becomes bit 3.  A warp's
// reads of A^T's fragment (8 rows of output, lane / 4, by 4 reduction rows,
// lane % 4) then fall on 32 distinct banks of the swizzled stage.
__device__ __forceinline__ int rmatvec_col(int i) {
  return (i & 3) | ((i >> 2 & 1) << 4) | ((i >> 3 & 1) << 2) |
         ((i >> 4 & 1) << 3);
}

// out[c, q0 : q0 + N] = (A[slab, c]^T Y[slab, q0 : q0 + N]) for the block's
// BN columns c of A, the slab being rows [z slab_rows, min(m, (z + 1)
// slab_rows)) and out = Z + z n k.
template <int N>
__global__ void __launch_bounds__(NT, 1)
    rmatvec_tf32(const __grid_constant__ CUtensorMap ma,
                 const __grid_constant__ CUtensorMap myh,
                 const __grid_constant__ CUtensorMap myl,
                 float* __restrict__ Z, int m, int n, int k, int slab_rows) {
  using L = Smem<N>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES;
  const int c0 = static_cast<int>(blockIdx.x) * BN;
  const int q0 = static_cast<int>(blockIdx.y) * N;
  const int r_begin = static_cast<int>(blockIdx.z) * slab_rows;
  const int r_end = min(m, r_begin + slab_rows);
  const int tiles = (r_end - r_begin + BK - 1) / BK;
  init_barriers<STAGES, 4 * NCONS>(full, empty);

  if (threadIdx.x >= 128 * NCONS) {          // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 128 * NCONS) return;
    for (int i = 0; i < tiles; ++i) {
      const int s = i % STAGES;
      const int i0 = r_begin + i * BK;
      const uint32_t bar =
          claim<STAGES>(full, empty, i, L::A_STAGE + 2 * L::B_STAGE);
      for (int b = 0; b < BN / 32; ++b)
        tma_load_2d(base + L::A + s * L::A_STAGE + b * BOX, &ma, bar,
                    c0 + 32 * b, i0);
      tma_load_2d(base + L::BH + s * L::B_STAGE, &myh, bar, i0, q0);
      tma_load_2d(base + L::BL + s * L::B_STAGE, &myl, bar, i0, q0);
    }
    return;
  }

  // a consumer warpgroup: columns c0 + 128 wg .. + 127 of A, two m64 tiles
  // of two boxes each; warp w of a tile reads box w / 2, rows 16 (w % 2) ..
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
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

template <int N>
int launch_matvec(const void* A, const void* Qh, const void* Ql, void* Y,
                  int m, int n, int k, cudaStream_t s) {
  CUtensorMap ma, mqh, mql;
  cudaError_t err = encode_2d(&ma, A, m, n, n, BM, 4);
  if (err == cudaSuccess) err = encode_2d(&mqh, Qh, k, n, n, N, 4);
  if (err == cudaSuccess) err = encode_2d(&mql, Ql, k, n, n, N, 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = matvec_tf32<N>;
  constexpr int bytes = Smem<N>::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long jobs = (m + BM - 1) / BM * static_cast<long long>(
                                                   (k + N - 1) / N);
  kern<<<resident_blocks(jobs), NT, bytes, s>>>(
      ma, mqh, mql, static_cast<float*>(Y), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

template <int N>
int launch_rmatvec(const void* A, const void* Yh, const void* Yl, float* out,
                   int m, int n, int k, long long ld_y, int slab_rows,
                   int slabs, cudaStream_t s) {
  CUtensorMap ma, myh, myl;
  cudaError_t err = encode_2d(&ma, A, m, n, n, BK, 4);
  if (err == cudaSuccess) err = encode_2d(&myh, Yh, k, m, ld_y, N, 4);
  if (err == cudaSuccess) err = encode_2d(&myl, Yl, k, m, ld_y, N, 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = rmatvec_tf32<N>;
  constexpr int bytes = Smem<N>::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((k + N - 1) / N),
                  (unsigned)slabs);
  kern<<<grid, NT, bytes, s>>>(ma, myh, myl, out, m, n, k, slab_rows);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_block_matvec_tf32x3(const void* A, const void* Q,
                                         void* split, void* Y, long long m,
                                         long long n, long long k,
                                         void* stream) {
  cudaGetLastError();  // report this call's launches, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mi = (int)m, ni = (int)n, ki = (int)k;
  split_skinny(Q, split, ni, ki, n, s);
  const float* hi = static_cast<const float*>(split);
  const float* lo = hi + k * n;
  if (k <= 16) return launch_matvec<16>(A, hi, lo, Y, mi, ni, ki, s);
  if (k <= 32) return launch_matvec<32>(A, hi, lo, Y, mi, ni, ki, s);
  return launch_matvec<64>(A, hi, lo, Y, mi, ni, ki, s);
}

extern "C" int repro_block_rmatvec_tf32x3(const void* A, const void* Y,
                                          void* split, void* Z, void* partial,
                                          long long m, long long n,
                                          long long k, long long ld,
                                          long long slab_rows, void* stream) {
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab_rows <= 0 || slab_rows % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = (int)((m + slab_rows - 1) / slab_rows);
  float* out = static_cast<float*>(slabs > 1 ? partial : Z);
  const int mi = (int)m, ni = (int)n, ki = (int)k, rows = (int)slab_rows;
  split_skinny(Y, split, mi, ki, ld, s);
  const float* hi = static_cast<const float*>(split);
  const float* lo = hi + k * ld;
  int err;
  if (k <= 16)
    err = launch_rmatvec<16>(A, hi, lo, out, mi, ni, ki, ld, rows, slabs, s);
  else if (k <= 32)
    err = launch_rmatvec<32>(A, hi, lo, out, mi, ni, ki, ld, rows, slabs, s);
  else
    err = launch_rmatvec<64>(A, hi, lo, out, mi, ni, ki, ld, rows, slabs, s);
  if (err != 0) return err;
  if (slabs > 1)
    repro_slab_sum::sum_slabs(static_cast<const float*>(partial),
                              static_cast<float*>(Z), n * k, slabs, s);
  return static_cast<int>(cudaGetLastError());
}
