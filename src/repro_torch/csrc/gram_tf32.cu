// The Gram product of the deflation engine's method="gram" for fp32, on
// Hopper's tensor cores as 3xTF32 (sm_90a: wgmma with A in registers).
//
//   gram         B = A^T A    A (m, n) fp32, rows lda apart -> B (n, n) fp32
//   gram, trans  B = A A^T    (wide inputs)                 -> B (m, m) fp32
//
// Replaces the Pallas TPU kernel of src/repro/kernels/gram.py: gram
// (pallas_call at :84), with its reduced-task schedule (paper Alg 3, Fig 2c),
// for every fp32 operand.  Two routes (kernels/gram.py::route): "tf32x3",
// where a TMA tensor map describes A (base and row stride 4 lda bytes
// multiples of 16), and "tf32x3_cpasync" for every other fp32 A (any width,
// any 4-byte-aligned base).  bf16 runs gram_bf16.cu (bf16 tensor cores).
//
// Bound on an H100 SXM at the gram path's 262144 x 8192: the symmetric
// schedule's m n (n + 1) = 1.76e13 flop, as three TF32 products at 495
// TFLOP/s, take 106.6 ms, against 8.6 GB of A (2.6 ms at 3.35 TB/s): bound
// by its operations.  What the design does:
//   * 3xTF32, never plain TF32: each fp32 operand x is split into
//     hi = tf32(x) and lo = tf32(x - hi) (cvt.rna), each product is
//     a_lo b_hi + a_hi b_lo + a_hi b_hi, the small terms issued first.
//   * A block owns one 128 x 128 tile of B (i side rows, j side columns) and
//     sums it over the whole reduction: warp-specialised, 384 threads, a
//     producer warpgroup filling a ring of STAGES = 4 stages of BK = 32
//     reduction steps and two consumer warpgroups, each a 64 x 128 half of
//     the tile by wgmma m64n128k8.
//   * Both operands of A^T A arrive MN-major (the reduction runs down A's
//     rows), and tf32 wgmma reads shared-memory operands K-major only.  The
//     i side is the A operand, from registers: the consumers read it out of
//     the stage, as TMA (or cp.async) wrote it, row-major and swizzled:
//     for A^T A element by element, a tile of A^T, its output rows permuted
//     by rmatvec_col so a warp's reads hit 32 banks; for A A^T (rows of A,
//     already K-major) by ldmatrix.  Split in registers.  The j side is the
//     B operand: the producer warpgroup's 128 threads load it from global
//     memory into registers (A^T A: thread t column j0 + t, 32 rows, each
//     load a warp's 128 contiguous bytes; A A^T: 16-byte pieces of 8 rows,
//     8 threads a row), split it and store the hi and lo halves K-major in
//     the 128-byte swizzle (16-byte chunk c of row q at chunk c ^ (q % 8),
//     conflict-free), then fence.proxy.async so wgmma sees the stores.  On
//     "tf32x3" the next stage's loads are in flight while this one is
//     stored.  No scratch in device memory: nothing grows with m.
//   * Shared memory a 32-deep stage: 16 KiB of the i side in, 32 KiB of
//     the j side's halves stored, 16 KiB read into fragments, and wgmma's
//     B reads (96 KiB: half the bandwidth at the tensor cores' rate), about
//     5/6 of the stage's tensor time.
//   * The i side arrives by TMA from one producer thread (boxes of 32 fp32
//     x 32 rows for A^T A, x 128 rows for A A^T) or, on "tf32x3_cpasync",
//     by copy_stage's cp.async of 4 or 8 bytes from all 128 producer
//     threads; edges arrive as zeros and are never read.  The stage's full
//     barrier counts the j side's 128 stores and the i side's bytes (TMA)
//     or 128 cp.async arrivals.
//   * The sums: each stage's wgmma sums restart from zero and the consumer
//     adds them into a second set of fp32 registers with rounded adds, so
//     an entry's error is that of an fp32 sum of R / 32 terms (the tensor
//     cores' accumulator, left for the whole reduction, truncates).
//   * The reduced-task schedule: the grid enumerates the upper-triangle
//     tiles in the order of core/partition.py::symmetric_tasks and each
//     block writes its tile and the mirror; symmetric=0 launches every tile,
//     and a tile below the diagonal computes its mirror's numbers (the same
//     operands in the same roles) and writes them transposed.  On a diagonal
//     tile only the entries with row <= column are kept, each written to
//     both places.  B is exactly symmetric either way.
//   * No atomics and no split of the reduction: every rerun bitwise equal.
//     Blocks of a wave run down A's rows side by side, so their panels of a
//     row range are read from device memory once and meet in L2.
//
// On an H100 this runs at ~55 % of the bound (PERF.md section 6), held back
// by the staging, not the tensor cores: built as plain TF32 (a third of the
// products, all of the staging) it takes ~60 % of the time, not a third.
// Each block moves 1 KiB a row from L2 (558 GB a launch at the gram path);
// the next step is a cluster of two blocks that share a panel by TMA
// multicast.
//
// Planted faults, built by chip_smoke.py beside the real library to show
// that its checks reject them: -DREPRO_TF32_ONLY (the hi hi term alone:
// plain TF32) and -DREPRO_TC_SUMS_ONLY (the sums left in the tensor cores'
// accumulators for the whole reduction).
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_gram_tf32x3{,_cpasync}(A, lda, B, m, n, trans, symmetric,
//                                    stream)
// Returns cudaGetLastError() after the launch (0 on success),
// cudaErrorInvalidValue for an A the route cannot read (on "tf32x3" one no
// tensor map describes; on either, a base not 4-byte aligned or lda < n),
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
constexpr int BK = 32;                 // reduction depth of a stage (128 B)
constexpr int KS = BK / 8;             // wgmma k8 steps a stage
constexpr int STAGES = 4;              // ring of shared-memory stages
constexpr int BOX = 32 * 128;          // a box of 32 rows x 32 fp32, bytes

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

// The producer of the i side: CP = 0, TMA from one thread, the j side's
// next stage loaded while this one is stored; CP = 1 or 2, cp.async of CP
// fp32 from each of the 128 producer threads.  Its registers: 104, and
// 120 for A A^T by cp.async, whose copies and eight j-side rows a thread
// need more (with fewer it spilled in development runs on an H100).
// setmaxnreg: 128 x PRODUCER_REGS + 256 x CONSUMER_REGS <= 384 x 168, the
// registers __launch_bounds__(384, 1) gives the block (more, and the
// consumers' setmaxnreg.inc waits forever).
template <bool TRANS, int CP>
struct Producer {
  static constexpr int PRODUCER_REGS = TRANS && CP ? 120 : 104;
  static constexpr int CONSUMER_REGS = TRANS && CP ? 192 : 200;
  static constexpr int FULL_ARRIVALS = CP ? 128 + 128 : 128 + 1;
  static_assert(128 * PRODUCER_REGS + 256 * CONSUMER_REGS <= 384 * 168,
                "setmaxnreg beyond the block's registers");
};

// Dynamic shared memory, from a 1024-byte aligned base: the i side
// [STAGES][16 KiB], the j side's hi [STAGES][BT rows][128 B] and lo halves,
// then full[STAGES] and empty[STAGES].
struct Smem {
  static constexpr int I_STAGE = BT * 128;
  static constexpr int J_STAGE = BT * 128;
  static constexpr int I = 0;
  static constexpr int JH = I + STAGES * I_STAGE;
  static constexpr int JL = JH + STAGES * J_STAGE;
  static constexpr int BAR = JL + STAGES * J_STAGE;
  static constexpr int BYTES = BAR + 16 * STAGES + 1024;
};

__device__ __forceinline__ void sts_v4(uint32_t addr, const uint32_t (&v)[4]) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v[0]), "r"(v[1]), "r"(v[2]), "r"(v[3])
               : "memory");
}

// Four values of the j side split into their tf32 halves, stored at `off`
// of the stage's hi and lo halves.
__device__ __forceinline__ void store_split(uint32_t jh, uint32_t jl,
                                            uint32_t off, const float* v) {
  const uint32_t x[4] = {__float_as_uint(v[0]), __float_as_uint(v[1]),
                         __float_as_uint(v[2]), __float_as_uint(v[3])};
  uint32_t hi[4], lo[4];
  split(x, hi, lo);
  sts_v4(jh + off, hi);
  if constexpr (SPLIT) sts_v4(jl + off, lo);
}

// One stage's products of a consumer's 64 x 128 half tile, their sums
// restarted (`restart`): acc = sum over the stage's k8 steps s of
// A_s (B_hi + B_lo) as a_lo b_hi + a_hi b_lo, then a_hi b_hi.
__device__ __forceinline__ void stage_products(float (&acc)[BT / 2],
                                               uint32_t (&ah)[KS][4],
                                               uint32_t (&al)[KS][4],
                                               uint32_t jh, uint32_t jl,
                                               bool restart) {
  if constexpr (SPLIT) {
#pragma unroll
    for (int s = 0; s < KS; ++s) {
      wgmma_rs_tf32<BT>(acc, al[s], desc(jh + 32 * s, 16, 1024),
                        s > 0 || !restart);
      wgmma_rs_tf32<BT>(acc, ah[s], desc(jl + 32 * s, 16, 1024), 1);
    }
  }
#pragma unroll
  for (int s = 0; s < KS; ++s)
    wgmma_rs_tf32<BT>(acc, ah[s], desc(jh + 32 * s, 16, 1024),
                      SPLIT || s > 0 || !restart);
}

// Tile task blockIdx.x of B: A^T A (TRANS = 0, the reduction over A's m
// rows) or A A^T (TRANS = 1, over its n columns), B's edge N = n or m.
template <bool TRANS, int CP>
__global__ void __launch_bounds__(NT, 1)
    gram_tf32(const __grid_constant__ CUtensorMap ma,
              const float* __restrict__ A, long long lda,
              float* __restrict__ B, int m, int n, int nb, int symmetric) {
  using L = Smem;
  using P = Producer<TRANS, CP>;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full = base + L::BAR, empty = full + 8 * STAGES;
  const int R = TRANS ? n : m, N = TRANS ? m : n;
  const int stages = (R + BK - 1) / BK;
  int bi, bj;
  repro_gram_tasks::task_tile(blockIdx.x, nb, symmetric != 0, bi, bj);
  // the upper tile of the pair (bi, bj), (bj, bi): its rows are the i side
  const int i0 = min(bi, bj) * BT, j0 = max(bi, bj) * BT;
  init_barriers<STAGES, 4 * NCONS, P::FULL_ARRIVALS>(full, empty);

  if (threadIdx.x >= 128 * NCONS) {          // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(
        P::PRODUCER_REGS));
    const int t = threadIdx.x - 128 * NCONS;
    // The j side of stage st into v.  A^T A: rows r0 + r (r < 32) of
    // column j0 + t.  A A^T: row j0 + t / 8 + 16 q (q < 8), columns
    // r0 + 4 (t % 8) .. + 3 in v[4 q ..].  Zero past the edges.
    auto load = [&](int st, float (&v)[BK]) {
      const int r0 = st * BK;
      if constexpr (!TRANS) {
        const int col = j0 + t;
        const bool ok = col < n;
        const float* p = A + static_cast<int64_t>(r0) * lda + (ok ? col : 0);
#pragma unroll
        for (int r = 0; r < BK; ++r, p += lda)
          v[r] = ok && r0 + r < m ? __ldg(p) : 0.0f;
      } else {
        const int col = r0 + 4 * (t % 8);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int row = j0 + t / 8 + 16 * q;
          const float* p =
              A + static_cast<int64_t>(row < m ? row : 0) * lda + col;
          if (CP == 0 && row < m && col + 4 <= n) {
            const float4 x = __ldg(reinterpret_cast<const float4*>(p));
            v[4 * q] = x.x, v[4 * q + 1] = x.y, v[4 * q + 2] = x.z,
                  v[4 * q + 3] = x.w;
          } else {
#pragma unroll
            for (int e = 0; e < 4; ++e)
              v[4 * q + e] = row < m && col + e < n ? __ldg(p + e) : 0.0f;
          }
        }
      }
    };
    // Stage st's slot released, and its i side on the way.
    auto fill = [&](int st) {
      const int s = st % STAGES, r0 = st * BK;
      const uint32_t bar = full + 8 * s;
      if (st >= STAGES) mbar_wait(empty + 8 * s, ((st / STAGES) - 1) & 1);
      const uint32_t di = base + L::I + s * L::I_STAGE;
      if constexpr (CP == 0) {
        if (t == 0) {
          mbar_expect_tx(bar, L::I_STAGE);
          if constexpr (TRANS) {
            tma_load_2d(di, &ma, bar, r0, i0);
          } else {
#pragma unroll
            for (int b = 0; b < BT / 32; ++b)
              tma_load_2d(di + b * BOX, &ma, bar, i0 + 32 * b, r0);
          }
        }
      } else {
        if constexpr (TRANS)
          copy_stage<CP, BT, 1, false>(di, A, lda, i0, m, r0, n, t);
        else
          copy_stage<CP, BK, BT / 32, true>(di, A, lda, r0, m, i0, n, t);
        cp_async_arrive(bar);
      }
    };
    // Stage st's j side: the halves of v stored K-major, then the arrival.
    auto put = [&](int st, const float (&v)[BK]) {
      const int s = st % STAGES;
      const uint32_t jh = base + L::JH + s * L::J_STAGE;
      const uint32_t jl = base + L::JL + s * L::J_STAGE;
      if constexpr (!TRANS) {
#pragma unroll
        for (int c = 0; c < BK / 4; ++c)
          store_split(jh, jl, t * 128 + ((c ^ (t & 7)) << 4), v + 4 * c);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          const int row = t / 8 + 16 * q;
          store_split(jh, jl, row * 128 + (((t % 8) ^ (row & 7)) << 4),
                      v + 4 * q);
        }
      }
      fence_proxy_async();
      mbar_arrive(full + 8 * s);
    };
    float va[BK], vb[BK];
    if constexpr (CP == 0) {
      if (stages > 0) load(0, va);
      for (int st = 0; st < stages; st += 2) {
        if (st + 1 < stages) load(st + 1, vb);
        fill(st);
        put(st, va);
        if (st + 1 >= stages) break;
        if (st + 2 < stages) load(st + 2, va);
        fill(st + 1);
        put(st + 1, vb);
      }
    } else {                  // the copies' registers free before the loads
      for (int st = 0; st < stages; ++st) {
        fill(st);
        load(st, va);
        put(st, va);
      }
      cp_async_wait_all();
    }
    return;
  }

  // a consumer warpgroup: rows i0 + 64 wg .. + 63 of the tile (A A^T; for
  // A^T A a permutation of them, see rmatvec_col)
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(
      P::CONSUMER_REGS));
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  // A^T A, fragment register e: output row 16 (warp % 2) + lane / 4 +
  // 8 (e % 2) of box 2 wg + warp / 2, reduction row lane % 4 + 4 (e / 2) of
  // the k8 step.  A A^T, ldmatrix: lane j addresses row j % 8 of matrix
  // j / 8, which is rows + 8 (j / 8 % 2) and 16-byte chunk + (j / 16) of the
  // k8 step.
  uint32_t off[4];
  if constexpr (TRANS) {
    off[0] = (64 * wg + 16 * warp + 8 * (lane / 8 % 2) + lane % 8) * 128;
  } else {
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      const int col = rmatvec_col(16 * (warp % 2) + lane / 4 + 8 * (e % 2));
      const int r = lane % 4 + 4 * (e / 2);
      off[e] = (2 * wg + warp / 2) * BOX + r * 128 + (((col / 4) ^ r) << 4) +
               4 * (col % 4);
    }
  }
  float acc[BT / 2], sum[BT / 2];
#pragma unroll
  for (int i = 0; i < BT / 2; ++i) acc[i] = sum[i] = 0.0f;

  for (int st = 0; st < stages; ++st) {
    const int s = st % STAGES;
    mbar_wait(full + 8 * s, (st / STAGES) & 1);
    const uint32_t a_st = base + L::I + s * L::I_STAGE;
    uint32_t ah[KS][4], al[KS][4];
#pragma unroll
    for (int ks = 0; ks < KS; ++ks) {
      uint32_t x[4];
      if constexpr (TRANS) {
        ldsm_x4(x, a_st + off[0] + (((2 * ks + lane / 16) ^ (lane % 8)) << 4));
      } else {
#pragma unroll
        for (int e = 0; e < 4; ++e)
          x[e] = lds_u32(a_st + ks * 8 * 128 + off[e]);
      }
      split(x, ah[ks], al[ks]);
    }
    hold(acc);
    wg_fence();
    stage_products(acc, ah, al, base + L::JH + s * L::J_STAGE,
                   base + L::JL + s * L::J_STAGE, PROMOTE || st == 0);
    wg_commit();
    wg_wait_all();
    hold(acc);
    hold(ah);
    hold(al);
    if (lane == 0) mbar_arrive(empty + 8 * s);
#pragma unroll
    for (int i = 0; i < BT / 2; ++i)
      sum[i] = PROMOTE ? sum[i] + acc[i] : acc[i];
  }

  // sum[4 j + 2 h + e] is row 16 warp + lane / 4 + 8 h of the half tile (B's
  // row gi), column 8 j + 2 (lane % 4) + e (B's column gj).  Written in
  // place where the task is the upper tile, at the mirror where it is the
  // lower one, both under the reduced-task schedule; a diagonal tile keeps
  // gi <= gj.
  const bool up = symmetric || bi <= bj, down = symmetric || bi >= bj;
  const bool diag = bi == bj;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int row = 16 * warp + lane / 4 + 8 * h;
    const int col = 32 * (warp / 2) + rmatvec_col(row % 32);
    const int gi = i0 + 64 * wg + (TRANS ? row : col);
    if (gi >= N) continue;
#pragma unroll
    for (int j = 0; j < BT / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int gj = j0 + 8 * j + 2 * (lane % 4) + e;
        if (gj >= N || (diag && gi > gj)) continue;
        const float v = sum[4 * j + 2 * h + e];
        if (up) B[static_cast<int64_t>(gi) * N + gj] = v;
        if (down) B[static_cast<int64_t>(gj) * N + gi] = v;
      }
  }
}

template <bool TRANS, int CP>
int launch(const void* A, long long lda, void* B, int m, int n,
           int symmetric, cudaStream_t s) {
  CUtensorMap ma{};
  cudaError_t err = cudaSuccess;
  if (CP == 0) err = encode_2d(&ma, A, m, n, lda, TRANS ? BT : BK, 4);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = gram_tf32<TRANS, CP>;
  constexpr int bytes = Smem::BYTES;
  err = cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long N = TRANS ? m : n;
  const int nb = static_cast<int>((N + BT - 1) / BT);
  const int64_t tasks = repro_gram_tasks::task_count(N, BT, symmetric != 0);
  kern<<<static_cast<unsigned>(tasks), NT, bytes, s>>>(
      ma, static_cast<const float*>(A), lda, static_cast<float*>(B), m, n, nb,
      symmetric);
  return static_cast<int>(cudaGetLastError());
}

template <bool TRANS>
int launch_by_producer(int cp, const void* A, long long lda, void* B, int m,
                       int n, int symmetric, cudaStream_t s) {
  if (cp == 0) return launch<TRANS, 0>(A, lda, B, m, n, symmetric, s);
  if (cp == 1) return launch<TRANS, 1>(A, lda, B, m, n, symmetric, s);
  return launch<TRANS, 2>(A, lda, B, m, n, symmetric, s);
}

int gram_entry(bool cpasync, const void* A, long long lda, void* B,
               long long m, long long n, int trans, int symmetric,
               void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int cp = fp32_producer(A, lda, n, cpasync);
  if (cp < 0) return static_cast<int>(cudaErrorInvalidValue);
  const int mi = (int)m, ni = (int)n;
  if (trans) return launch_by_producer<true>(cp, A, lda, B, mi, ni, symmetric,
                                             s);
  return launch_by_producer<false>(cp, A, lda, B, mi, ni, symmetric, s);
}

}  // namespace

extern "C" int repro_gram_tf32x3(const void* A, long long lda, void* B,
                                 long long m, long long n, int trans,
                                 int symmetric, void* stream) {
  return gram_entry(false, A, lda, B, m, n, trans, symmetric, stream);
}

extern "C" int repro_gram_tf32x3_cpasync(const void* A, long long lda,
                                         void* B, long long m, long long n,
                                         int trans, int symmetric,
                                         void* stream) {
  return gram_entry(true, A, lda, B, m, n, trans, symmetric, stream);
}
