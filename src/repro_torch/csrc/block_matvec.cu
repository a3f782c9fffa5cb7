// The bf16 block sweeps on FFMA, for the operands that no tensor map
// describes, written for Hopper (sm_90a).
//
//   block_matvec   Y = A @ Q      A (m, n) bf16, rows lda apart, Q (n, k),
//                                 Y (m, k)
//   block_rmatvec  Z = A^T @ Y    A (m, n) bf16, rows lda apart, Y (m, k),
//                                 Z (n, k)
//
// Replace the Pallas TPU kernels of src/repro/kernels/block_matvec.py:
// block_matvec (pallas_call at :81) and block_rmatvec (pallas_call at :127).
// The fused chain Z = A^T (A Q) of that file (block_gram_chain, :146) is the
// composition of the two, done by the wrapper in kernels/ops.py.
//
// This file is the "ffma" route of kernels/block_matvec.py::route: a bf16 A
// handed to kernels/ops.py directly whose base is not 16-byte aligned or
// whose rows (lda) are not a multiple of 16 bytes, which a TMA tensor map
// cannot describe.  Every other bf16 A, the solver's own copy included
// (core/operator.py::DenseOperator pads its rows to whole 16 bytes), runs
// the tensor cores (block_matvec_tc.cu), and every fp32 A runs 3xTF32
// (block_matvec_tf32.cu, by TMA or by cp.async).
//
// Types: A and the skinny operand are bf16, widened to fp32 when they are
// staged into shared memory; every product is an fp32 FFMA (exact for two
// bf16 values) and the sums are fp32, so the output differs from the plain
// version (kernels/ref.py) only in the order of the sums.
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): at 65536 x 8190 with k = 32 one sweep reads 1.07 GB of A
// (0.32 ms) and does 2*m*n*k = 3.4e10 flop (0.51 ms of FFMA), so it is bound
// by its FFMA work.  What the design does about it:
//   * A is read from device memory exactly once per k tile of up to 64
//     columns, so for k <= 64 each sweep moves A once; the skinny operand
//     and the output are k/n and k/m of A's bytes.
//   * Global loads are coalesced along A's rows (the contiguous axis), one
//     element per load (the rows this route takes need not be whole 16-byte
//     vectors), and are issued into registers one stage ahead; two
//     shared-memory stages with one barrier each keep the next tile's bytes
//     in flight while the FFMAs run.
//   * Each thread keeps an 8 x TK block of sums in registers and reads its 8
//     A values (and 4 skinny values at a time when TK is a multiple of 4) as
//     float4 loads from shared memory, so the inner loop is mostly FFMA.  The
//     k tile is k rounded up to a multiple of 8 (at most 64), so at most 7
//     columns of FFMA are idle.
//   * The reduction of block_rmatvec runs over the long m axis.  It is split
//     into slabs of at most 16384 rows (and enough slabs to fill the card when
//     n is small); each slab writes fp32 partials and a second launch sums
//     the slabs in order (slab_sum.cuh).  No atomics: the summation order is
//     fixed, so every rerun is bitwise equal.
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_block_matvec(A, lda, Q, Y, m, n, k, stream)
//   int repro_block_rmatvec(A, lda, Y, Z, partial, m, n, k, slab_rows,
//                           stream)
// Both return cudaGetLastError() after their launches (0 on success), or
// cudaErrorInvalidValue for an lda below n.  They allocate nothing:
// `partial` is (ceil(m / slab_rows), n, k) fp32 scratch from the caller,
// unused (may be null) when there is a single slab.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "slab_sum.cuh"

namespace {

constexpr int NT = 256;       // threads per block
constexpr int TX = 8;         // threads across the k tile
constexpr int TY = NT / TX;   // 32 threads across the output rows
constexpr int TM = 8;         // output rows per thread
constexpr int BM = TY * TM;   // output rows per block
constexpr int BK = 16;        // reduction depth of one shared-memory stage
constexpr int XPAD = 4;       // keeps float4 alignment, spreads stores over banks
constexpr int MIN_BLOCKS = 2; // resident blocks per SM the register budget keeps

using T = __nv_bfloat16;

__device__ __forceinline__ float widen(T x) { return __bfloat162float(x); }
__device__ __forceinline__ T zero() { return __float2bfloat16(0.0f); }

// acc[i][c] += xs[j][ty*TM + i] * ws[j][tx*TK + c] over one stage.
template <int TK>
__device__ __forceinline__ void stage_fma(const float* xs, const float* ws,
                                          int tx, int ty,
                                          float (&acc)[TM][TK]) {
  constexpr int XS = BM + XPAD, KT = TX * TK;
#pragma unroll
  for (int j = 0; j < BK; ++j) {
    float xv[TM];
#pragma unroll
    for (int i = 0; i < TM; i += 4) {
      const float4 x = *reinterpret_cast<const float4*>(xs + j * XS +
                                                        ty * TM + i);
      xv[i] = x.x, xv[i + 1] = x.y, xv[i + 2] = x.z, xv[i + 3] = x.w;
    }
    float wv[TK];
    if constexpr (TK % 4 == 0) {
#pragma unroll
      for (int c = 0; c < TK; c += 4) {
        const float4 w = *reinterpret_cast<const float4*>(ws + j * KT +
                                                          tx * TK + c);
        wv[c] = w.x, wv[c + 1] = w.y, wv[c + 2] = w.z, wv[c + 3] = w.w;
      }
    } else {
#pragma unroll
      for (int c = 0; c < TK; ++c) wv[c] = ws[j * KT + tx * TK + c];
    }
#pragma unroll
    for (int i = 0; i < TM; ++i)
#pragma unroll
      for (int c = 0; c < TK; ++c) acc[i][c] = fmaf(xv[i], wv[c], acc[i][c]);
  }
}

// The skinny operand's stage: ws[j][c] = W[r0 + j][col0 + c] for rows
// below r_end (zero elsewhere), staged through registers.
template <int TK>
struct SkinnyStage {
  static constexpr int KT = TX * TK;
  static constexpr int PER = (BK * KT + NT - 1) / NT;
  T pre[PER];

  __device__ __forceinline__ void fetch(const T* __restrict__ W, int k,
                                        int col0, int r0, int r_end,
                                        int tid) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      const int r = r0 + e / KT, c = col0 + e % KT;
      pre[p] = (e < BK * KT && r < r_end && c < k)
                   ? W[static_cast<int64_t>(r) * k + c]
                   : zero();
    }
  }
  __device__ __forceinline__ void stash(float* ws, int tid) const {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      if (e < BK * KT) ws[e] = widen(pre[p]);
    }
  }
};

// Y[row0:row0+BM, col0:col0+KT] = A[rows, :] @ Q[:, cols]; the n loop runs
// inside the block (on the TPU it was the sequential grid axis).
template <int TK>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    matvec_kernel(const T* __restrict__ A, int64_t lda,
                  const T* __restrict__ Q, float* __restrict__ Y, int m, int n,
                  int k) {
  constexpr int KT = TX * TK, XS = BM + XPAD;
  constexpr int PER = BM * BK / NT;          // A loads per thread per stage
  __shared__ __align__(16) float xs[2][BK * XS];  // xs[j][r] = A[r][j]
  __shared__ __align__(16) float ws[2][BK * KT];  // ws[j][c] = Q[j][c]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * KT;

  T a_pre[PER];
  SkinnyStage<TK> w;
  float acc[TM][TK];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TK; ++c) acc[i][c] = 0.0f;

  auto fetch = [&](int j0) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      const int64_t r = row0 + e / BK;
      const int j = j0 + e % BK;
      a_pre[p] = (r < m && j < n) ? A[r * lda + j] : zero();
    }
    w.fetch(Q, k, col0, j0, n, tid);
  };
  auto stash = [&](int b) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      xs[b][e % BK * XS + e / BK] = widen(a_pre[p]);
    }
    w.stash(ws[b], tid);
  };

  // two shared-memory stages: the loads of stage s+1 are in flight while
  // stage s is summed, and one barrier per stage orders both buffers
  fetch(0);
  stash(0);
  __syncthreads();
  for (int j0 = 0, b = 0; j0 < n; j0 += BK, b ^= 1) {
    const bool more = j0 + BK < n;
    if (more) fetch(j0 + BK);
    stage_fma<TK>(xs[b], ws[b], tx, ty, acc);
    if (more) stash(b ^ 1);
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = row0 + ty * TM + i;
    if (r >= m) continue;
#pragma unroll
    for (int c = 0; c < TK; ++c) {
      const int col = col0 + tx * TK + c;
      if (col < k) Y[r * k + col] = acc[i][c];
    }
  }
}

// out[c0:c0+BM, col0:col0+KT] = A[slab, cols]^T @ Y[slab, :], where the slab
// is rows [z*slab_rows, min(m, (z+1)*slab_rows)) and out = Z + z*n*k.
template <int TK>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    rmatvec_kernel(const T* __restrict__ A, int64_t lda,
                   const T* __restrict__ Y, float* __restrict__ Z, int m,
                   int n, int k, int slab_rows) {
  constexpr int KT = TX * TK, XS = BM + XPAD;
  constexpr int PER = BM * BK / NT;
  __shared__ __align__(16) float xs[2][BK * XS];  // xs[i][c] = A[i][c]
  __shared__ __align__(16) float ws[2][BK * KT];  // ws[i][c] = Y[i][c]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int c0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * KT;
  const int r_begin = blockIdx.z * slab_rows;
  const int r_end = min(m, r_begin + slab_rows);

  T a_pre[PER];
  SkinnyStage<TK> w;
  float acc[TM][TK];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TK; ++c) acc[i][c] = 0.0f;

  auto fetch = [&](int i0) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      const int r = i0 + e / BM, c = c0 + e % BM;
      a_pre[p] = (r < r_end && c < n) ? A[r * lda + c] : zero();
    }
    w.fetch(Y, k, col0, i0, r_end, tid);
  };
  auto stash = [&](int b) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      xs[b][e / BM * XS + e % BM] = widen(a_pre[p]);
    }
    w.stash(ws[b], tid);
  };

  fetch(r_begin);
  stash(0);
  __syncthreads();
  for (int i0 = r_begin, b = 0; i0 < r_end; i0 += BK, b ^= 1) {
    const bool more = i0 + BK < r_end;
    if (more) fetch(i0 + BK);
    stage_fma<TK>(xs[b], ws[b], tx, ty, acc);
    if (more) stash(b ^ 1);
    __syncthreads();
  }

  float* out = Z + static_cast<int64_t>(blockIdx.z) * n * k;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int64_t r = c0 + ty * TM + i;
    if (r >= n) continue;
#pragma unroll
    for (int c = 0; c < TK; ++c) {
      const int col = col0 + tx * TK + c;
      if (col < k) out[r * k + col] = acc[i][c];
    }
  }
}

template <int TK>
void launch_matvec(const void* A, int64_t lda, const void* Q, void* Y, int m,
                   int n, int k, cudaStream_t s) {
  constexpr int KT = TX * TK;
  const dim3 grid((m + BM - 1) / BM, (k + KT - 1) / KT);
  matvec_kernel<TK><<<grid, NT, 0, s>>>(static_cast<const T*>(A), lda,
                                        static_cast<const T*>(Q),
                                        static_cast<float*>(Y), m, n, k);
}

template <int TK>
void launch_rmatvec(const void* A, int64_t lda, const void* Y, void* Z, int m,
                    int n, int k, int slab_rows, int slabs, cudaStream_t s) {
  constexpr int KT = TX * TK;
  const dim3 grid((n + BM - 1) / BM, (k + KT - 1) / KT, slabs);
  rmatvec_kernel<TK><<<grid, NT, 0, s>>>(
      static_cast<const T*>(A), lda, static_cast<const T*>(Y),
      static_cast<float*>(Z), m, n, k, slab_rows);
}

// The k tile: k rounded up to a multiple of TX, at most 64 columns.
inline int tile_k(int k) {
  const int tk = (k + TX - 1) / TX;
  return tk < 8 ? tk : 8;
}

#define REPRO_TK_SWITCH(tk, CALL) \
  switch (tk) {                   \
    case 1: CALL(1); break;       \
    case 2: CALL(2); break;       \
    case 3: CALL(3); break;       \
    case 4: CALL(4); break;       \
    case 5: CALL(5); break;       \
    case 6: CALL(6); break;       \
    case 7: CALL(7); break;       \
    default: CALL(8); break;      \
  }

}  // namespace

extern "C" int repro_block_matvec(const void* A, long long lda, const void* Q,
                                  void* Y, long long m, long long n,
                                  long long k, void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  if (lda < n) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int mi = (int)m, ni = (int)n, ki = (int)k;
#define REPRO_CALL(TK) launch_matvec<TK>(A, lda, Q, Y, mi, ni, ki, s)
  REPRO_TK_SWITCH(tile_k(ki), REPRO_CALL)
#undef REPRO_CALL
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_block_rmatvec(const void* A, long long lda, const void* Y,
                                   void* Z, void* partial, long long m,
                                   long long n, long long k,
                                   long long slab_rows, void* stream) {
  cudaGetLastError();
  if (lda < n) return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slabs = (int)((m + slab_rows - 1) / slab_rows);
  void* out = slabs > 1 ? partial : Z;
  const int mi = (int)m, ni = (int)n, ki = (int)k, rows = (int)slab_rows;
#define REPRO_CALL(TK) \
  launch_rmatvec<TK>(A, lda, Y, out, mi, ni, ki, rows, slabs, s)
  REPRO_TK_SWITCH(tile_k(ki), REPRO_CALL)
#undef REPRO_CALL
  if (slabs > 1)
    repro_slab_sum::sum_slabs(static_cast<const float*>(partial),
                              static_cast<float*>(Z), n * k, slabs, s);
  return static_cast<int>(cudaGetLastError());
}
