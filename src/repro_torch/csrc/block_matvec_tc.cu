// The bf16 block sweeps on Hopper's tensor cores (sm_90a: TMA + wgmma).
//
//   block_matvec   Y = A @ Q      A (m, n) bf16 row-major, Q (n, k), Y (m, k)
//   block_rmatvec  Z = A^T @ Y    A (m, n) bf16 row-major, Y (m, k), Z (n, k)
//
// Replace the Pallas TPU kernels of src/repro/kernels/block_matvec.py:
// block_matvec (pallas_call at :81) and block_rmatvec (pallas_call at :127),
// for bf16 operands; the chain Z = A^T (A Q) of that file (block_gram_chain,
// :146) is the composition of the two, done by the wrapper in kernels/ops.py.
// fp32 sweeps run block_matvec_tf32.cu (3xTF32) or, like bf16 ones whose A
// a TMA tensor map cannot describe, the FFMA kernels of block_matvec.cu
// (kernels/block_matvec.py::route).
//
// Bound on an H100 SXM at the main path's 262144 x 32768, k = 32: one sweep
// reads 17.2 GB of bf16 A, 5.13 ms at 3.35 TB/s; its 2 m n k = 5.5e11 flop
// take 0.56 ms on the bf16 tensor cores (989 TFLOP/s).  So each sweep is a
// stream of A, and the design is about keeping A's bytes in flight and the
// skinny operand out of device memory:
//   * Warp-specialised blocks of 384 threads: one producer thread issues TMA
//     loads (cp.async.bulk.tensor, 128-byte swizzle, elements past the edges
//     arrive as zeros, so nothing is padded in memory) into a ring of
//     STAGES = 4 shared-memory stages, each completing on its "full"
//     mbarrier; two consumer warpgroups issue wgmma (fp32 accumulators in
//     registers) and release the stage on its "empty" mbarrier.  A stage
//     holds 32 KiB of A, so 128 KiB of A a block (one block an SM) is in
//     flight.  setmaxnreg gives the consumers 240 registers, the producer 24.
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
//   * The skinny operand is read transposed (Q^T, Y^T: k rows of 2 n or
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
//     terms, as in the FFMA kernels.  Every rerun adds in the same order:
//     bitwise equal.
//
// Requirements (checked by the wrapper's route; encode_2d refuses the rest):
// A's base and its row stride 2 n bytes multiples of 16 (n % 8 == 0); the
// transposed skinny operand likewise (its row stride is rounded up).
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_block_matvec_wgmma(A, Qt, Y, m, n, k, stream)
//       Qt: Q^T, (k, n) row-major bf16
//   int repro_block_rmatvec_wgmma(A, Yt, Z, partial, m, n, k, ld_y,
//                                 slab_rows, stream)
//       Yt: Y^T, (k, m) bf16 with rows ld_y >= m elements apart
// Both return cudaGetLastError() after their launches (0 on success),
// cudaErrorInvalidValue for operands a tensor map cannot describe or a slab
// that is not whole stages, or cudaErrorNotSupported without libcuda's
// tensor-map encoder.  They allocate nothing: `partial` is
// (ceil(m / slab_rows), n, k) fp32 scratch from the caller, unused (may be
// null) when there is a single slab.

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
constexpr int PRODUCER_REGS = 24;      // setmaxnreg: 128 x 24 + 256 x 240
constexpr int CONSUMER_REGS = 240;     //   <= 65,536 registers of the SM
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

// Y[row0 : row0 + BM, col0 : col0 + N] = A[rows, :] @ Q[:, cols] for each
// job (row0, col0) of the block, Q^T's tile being rows col0 .. col0 + N of
// the (k, n) map mq.  Persistent: a block takes jobs blockIdx.x,
// + gridDim.x, ..., and the ring runs on from one job into the next, so
// the next job's loads are in flight while this one's sums are stored.
template <int N>
__global__ void __launch_bounds__(NT, 1)
    matvec_tc(const __grid_constant__ CUtensorMap ma,
              const __grid_constant__ CUtensorMap mq, float* __restrict__ Y,
              int m, int n, int k) {
  using L = MatvecSmem<N>;
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
            claim<STAGES>(full, empty, i, L::A_STAGE + L::Q_STAGE);
        tma_load_2d(base + L::A + s * L::A_STAGE, &ma, bar, st * BK, row0);
        tma_load_2d(base + L::Q + s * L::Q_STAGE, &mq, bar, st * BK, col0);
      }
    }
    return;
  }

  // a consumer warpgroup: rows row0 + 128 wg .. + 127, two m64 tiles
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
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
      const uint32_t a_st = base + L::A + s * L::A_STAGE + 2 * wg * TILE;
      const uint32_t q_st = base + L::Q + s * L::Q_STAGE;
      hold(acc[0]);
      hold(acc[1]);
      wg_fence();
#pragma unroll
      for (int t = 0; t < 2; ++t)
#pragma unroll
        for (int ks = 0; ks < BK / 16; ++ks)
          wgmma_ss<N, 0>(acc[t], desc(a_st + t * TILE + 32 * ks, 16, 1024),
                         desc(q_st + 32 * ks, 16, 1024),
                         ks > 0 || (!PROMOTE && st > 0));
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
__global__ void __launch_bounds__(NT, 1)
    rmatvec_tc(const __grid_constant__ CUtensorMap ma,
               const __grid_constant__ CUtensorMap my, float* __restrict__ Z,
               int m, int n, int k, int slab_rows) {
  using L = RmatvecSmem;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES;
  const int c0 = static_cast<int>(blockIdx.x) * BN;
  const int kt0 = static_cast<int>(blockIdx.y) * KT;
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
          claim<STAGES>(full, empty, i, L::A_STAGE + L::Y_STAGE);
      for (int b = 0; b < BN / 64; ++b)
        tma_load_2d(base + L::A + s * L::A_STAGE + b * TILE, &ma, bar,
                    c0 + 64 * b, i0);
      tma_load_2d(base + L::Y + s * L::Y_STAGE, &my, bar, i0, kt0);
    }
    return;
  }

  // a consumer warpgroup: columns c0 + 128 wg .. + 127 of A, m64n128
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  float acc[64], sum[64];
#pragma unroll
  for (int i = 0; i < 64; ++i) acc[i] = sum[i] = 0.0f;

  for (int i = 0; i < tiles; ++i) {
    const int s = i % STAGES;
    mbar_wait(full + 8 * s, (i / STAGES) & 1);
    const uint32_t a_st = base + L::A + s * L::A_STAGE + 2 * wg * TILE;
    const uint32_t y_st = base + L::Y + s * L::Y_STAGE;
    hold(acc);
    wg_fence();
#pragma unroll
    for (int ks = 0; ks < BK / 16; ++ks)
      wgmma_ss<128, 1>(acc, desc(y_st + 32 * ks, 16, 1024),
                       desc(a_st + 2048 * ks, TILE, 1024),
                       ks > 0 || (!PROMOTE && i > 0));
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

template <int N>
int launch_matvec(const void* A, const void* Qt, void* Y, int m, int n, int k,
                  cudaStream_t s) {
  CUtensorMap ma, mq;
  cudaError_t err = encode_2d(&ma, A, m, n, n, BM);
  if (err == cudaSuccess) err = encode_2d(&mq, Qt, k, n, n, N);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = matvec_tc<N>;
  constexpr int bytes = MatvecSmem<N>::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long jobs = (m + BM - 1) / BM * static_cast<long long>(
                                                   (k + N - 1) / N);
  kern<<<resident_blocks(jobs), NT, bytes, s>>>(
      ma, mq, static_cast<float*>(Y), m, n, k);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int repro_block_matvec_wgmma(const void* A, const void* Qt, void* Y,
                                        long long m, long long n, long long k,
                                        void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (k <= 16) return launch_matvec<16>(A, Qt, Y, (int)m, (int)n, (int)k, s);
  if (k <= 32) return launch_matvec<32>(A, Qt, Y, (int)m, (int)n, (int)k, s);
  return launch_matvec<64>(A, Qt, Y, (int)m, (int)n, (int)k, s);
}

extern "C" int repro_block_rmatvec_wgmma(const void* A, const void* Yt,
                                         void* Z, void* partial, long long m,
                                         long long n, long long k,
                                         long long ld_y, long long slab_rows,
                                         void* stream) {
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (slab_rows <= 0 || slab_rows % BK != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slabs = (int)((m + slab_rows - 1) / slab_rows);
  CUtensorMap ma, my;
  cudaError_t err = encode_2d(&ma, A, m, n, n, BK);
  if (err == cudaSuccess) err = encode_2d(&my, Yt, k, m, ld_y, KT);
  if (err != cudaSuccess) return static_cast<int>(err);
  constexpr int bytes = RmatvecSmem::BYTES;
  err = cudaFuncSetAttribute(rmatvec_tc,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* out = static_cast<float*>(slabs > 1 ? partial : Z);
  const dim3 grid((unsigned)((n + BN - 1) / BN), (unsigned)((k + KT - 1) / KT),
                  (unsigned)slabs);
  rmatvec_tc<<<grid, NT, bytes, s>>>(ma, my, out, (int)m, (int)n, (int)k,
                                     (int)slab_rows);
  if (slabs > 1)
    repro_slab_sum::sum_slabs(static_cast<const float*>(partial),
                              static_cast<float*>(Z), n * k, slabs, s);
  return static_cast<int>(cudaGetLastError());
}
