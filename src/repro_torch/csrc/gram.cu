// The Gram product of the deflation engine's method="gram" for bf16, by
// FFMA on Hopper (sm_90a).
//
//   gram         B = A^T A    A (m, n) bf16, rows lda apart -> B (n, n) fp32
//   gram, trans  B = A A^T    (wide inputs)                 -> B (m, m) fp32
//
// Replaces the Pallas TPU kernel of src/repro/kernels/gram.py: gram
// (pallas_call at :84), with its reduced-task schedule (paper Alg 3, Fig 2c),
// for bf16 operands (the "ffma" route of kernels/gram.py::route; no solve
// runs it: the deflation engines are fp32).  Every fp32 A runs gram_tf32.cu
// (3xTF32 on the tensor cores).
//
// Types: bf16 values are widened to fp32 when they are staged into shared
// memory; every product is an fp32 FFMA and the output is fp32.
//
// Bound on an H100 SXM (67 TFLOP/s fp32 outside the tensor cores, 3.35 TB/s):
// the symmetric schedule does m*n*(n+1) flop on 2mn bytes, ~n flop a byte,
// so for any n past a few hundred the FFMA rate bounds it (263 ms at the
// gram path's 262144 x 8192).  What the design does:
//   * Register tiling as in an SGEMM: a block of 256 threads owns one 128 x 128
//     output tile; each thread keeps 8 x 8 sums in registers and reads its
//     operands from shared memory as float4 (two 4-wide halves per side, so
//     a quarter-warp's reads are contiguous and free of bank conflicts): 64
//     FFMA per 4 shared-memory loads.
//   * Two shared-memory stages of 8 reduction steps each, the next stage's
//     global loads (8 bytes per thread where every row starts 8-byte aligned
//     and n is a multiple of 4) in flight while the current one is summed;
//     one barrier per stage.
//   * The reduced-task schedule: the grid enumerates only the upper-triangle
//     tiles (i <= j), n_b (n_b + 1) / 2 blocks in the order of
//     core/partition.py::symmetric_tasks (gram_tasks.cuh); symmetric=0
//     enumerates all n_b^2.  Where the JAX wrapper halves the diagonal tiles
//     and adds W + W^T, each block here writes its tile and, off the
//     diagonal, its mirror: the same numbers, without the extra n x n pass,
//     and B is exactly symmetric (a tile and its mirror are one set of sums;
//     fmaf(a, c, s) == fmaf(c, a, s), so the full schedule's mirror tile
//     gets the same bits).
//   * Each block sums over all rows of A in a fixed order inside the block:
//     no split over the reduction, no atomics, every rerun bitwise equal.
//     The price is one long sequential fp32 sum per entry (rounding near
//     sqrt(m) * 2^-24 relative, ~3e-5 at m = 262144).
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_gram(A, lda, B, m, n, trans, symmetric, stream)
// Returns cudaGetLastError() after the launch (0 on success); allocates
// nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include "gram_tasks.cuh"

namespace {

constexpr int NT = 256;   // threads per block, 16 x 16
constexpr int BN = 128;   // output tile edge
constexpr int BK = 8;     // reduction depth of one shared-memory stage
constexpr int HALF = 64;  // each thread's rows (cols) are two 4-wide halves

// bf16 is the upper half of an fp32: element 2i is the low half-word.
__device__ __forceinline__ void widen4(const uint2& v, float (&o)[4]) {
  o[0] = __uint_as_float(v.x << 16);
  o[1] = __uint_as_float(v.x & 0xffff0000u);
  o[2] = __uint_as_float(v.y << 16);
  o[3] = __uint_as_float(v.y & 0xffff0000u);
}

// Four consecutive bf16 elements, of which the first `cnt` exist.  VEC: cnt
// is 0 or 4 and the address 8-byte aligned, one 8-byte load.
template <bool VEC>
struct Four;
template <>
struct Four<true> {
  uint2 v;
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int cnt) {
    v = cnt > 0 ? *reinterpret_cast<const uint2*>(p) : make_uint2(0u, 0u);
  }
  __device__ __forceinline__ void get(float (&o)[4]) const { widen4(v, o); }
};
template <>
struct Four<false> {
  __nv_bfloat16 v[4];
  __device__ __forceinline__ void load(const __nv_bfloat16* p, int cnt) {
#pragma unroll
    for (int q = 0; q < 4; ++q)
      v[q] = q < cnt ? p[q] : __float2bfloat16(0.0f);
  }
  __device__ __forceinline__ void get(float (&o)[4]) const {
#pragma unroll
    for (int q = 0; q < 4; ++q) o[q] = __bfloat162float(v[q]);
  }
};

__device__ __forceinline__ int clamp4(int64_t x) {
  return x <= 0 ? 0 : (x >= 4 ? 4 : static_cast<int>(x));
}

// One 128 x 128 tile of B.  R is the reduction length and N the edge of B:
// R = m, N = n for A^T A (the operand of output index p at step r is
// A[r][p]); R = n, N = m for A A^T (it is A[p][r]).  Rows of A lda apart.
template <bool TRANS, bool VEC>
__global__ void __launch_bounds__(NT)
    gram_kernel(const __nv_bfloat16* __restrict__ A, long long lda,
                float* __restrict__ B, int m, int n, int nb, int symmetric) {
  const int R = TRANS ? n : m;
  const int N = TRANS ? m : n;
  __shared__ __align__(16) float si[2][BK][BN];   // si[r][p]: tile i's side
  __shared__ __align__(16) float sj[2][BK][BN];   // sj[r][p]: tile j's side

  int bi, bj;
  repro_gram_tasks::task_tile(blockIdx.x, nb, symmetric != 0, bi, bj);
  const int pi = bi * BN, pj = bj * BN;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  // the element group this thread stages: A^T A -> step lr, outputs lp..+3;
  // A A^T -> output lp, steps lr..+3
  const int lr = TRANS ? (tid % 2) * 4 : (tid * 4) / BN;
  const int lp = TRANS ? tid / 2 : (tid * 4) % BN;
  Four<VEC> fi, fj;

  auto fetch = [&](int r0) {
    if constexpr (TRANS) {
      const int cnt = clamp4(static_cast<int64_t>(R) - (r0 + lr));
      const int64_t gi = pi + lp, gj = pj + lp;
      fi.load(A + (gi < N ? gi : 0) * lda + r0 + lr, gi < N ? cnt : 0);
      fj.load(A + (gj < N ? gj : 0) * lda + r0 + lr, gj < N ? cnt : 0);
    } else {
      const int64_t r = r0 + lr;
      const bool ok = r < R;
      const int64_t row = (ok ? r : 0) * lda;
      fi.load(A + row + pi + lp, ok ? clamp4(static_cast<int64_t>(N) - (pi + lp)) : 0);
      fj.load(A + row + pj + lp, ok ? clamp4(static_cast<int64_t>(N) - (pj + lp)) : 0);
    }
  };
  auto stash = [&](int b) {
    float oi[4], oj[4];
    fi.get(oi);
    fj.get(oj);
    if constexpr (TRANS) {
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        si[b][lr + q][lp] = oi[q];
        sj[b][lr + q][lp] = oj[q];
      }
    } else {
      *reinterpret_cast<float4*>(&si[b][lr][lp]) =
          make_float4(oi[0], oi[1], oi[2], oi[3]);
      *reinterpret_cast<float4*>(&sj[b][lr][lp]) =
          make_float4(oj[0], oj[1], oj[2], oj[3]);
    }
  };

  float acc[8][8];
#pragma unroll
  for (int x = 0; x < 8; ++x)
#pragma unroll
    for (int y = 0; y < 8; ++y) acc[x][y] = 0.0f;

  fetch(0);
  stash(0);
  __syncthreads();
  for (int r0 = 0, b = 0; r0 < R; r0 += BK, b ^= 1) {
    const bool more = r0 + BK < R;
    if (more) fetch(r0 + BK);
#pragma unroll
    for (int r = 0; r < BK; ++r) {
      const float4 a0 = *reinterpret_cast<const float4*>(&si[b][r][ty * 4]);
      const float4 a1 =
          *reinterpret_cast<const float4*>(&si[b][r][HALF + ty * 4]);
      const float4 c0 = *reinterpret_cast<const float4*>(&sj[b][r][tx * 4]);
      const float4 c1 =
          *reinterpret_cast<const float4*>(&sj[b][r][HALF + tx * 4]);
      const float a[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const float c[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
      for (int x = 0; x < 8; ++x)
#pragma unroll
        for (int y = 0; y < 8; ++y) acc[x][y] = fmaf(a[x], c[y], acc[x][y]);
    }
    if (more) stash(b ^ 1);
    __syncthreads();
  }

  const bool mirror = symmetric && bi != bj;
#pragma unroll
  for (int x = 0; x < 8; ++x) {
    const int64_t gi = pi + (x < 4 ? ty * 4 + x : HALF + ty * 4 + x - 4);
    if (gi >= N) continue;
#pragma unroll
    for (int y = 0; y < 8; ++y) {
      const int64_t gj = pj + (y < 4 ? tx * 4 + y : HALF + tx * 4 + y - 4);
      if (gj >= N) continue;
      B[gi * N + gj] = acc[x][y];
      if (mirror) B[gj * N + gi] = acc[x][y];
    }
  }
}

}  // namespace

extern "C" int repro_gram(const void* A, long long lda, void* B, long long m,
                          long long n, int trans, int symmetric,
                          void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const long long N = trans ? m : n;
  const int nb = (int)((N + BN - 1) / BN);
  const dim3 grid(static_cast<unsigned>(
      repro_gram_tasks::task_count(N, BN, symmetric != 0)));
  const __nv_bfloat16* a = static_cast<const __nv_bfloat16*>(A);
  float* b = static_cast<float*>(B);
  const bool vec = reinterpret_cast<uintptr_t>(A) % 8 == 0 && lda % 4 == 0 &&
                   n % 4 == 0;
  const int mi = (int)m, ni = (int)n;
  if (trans) {
    if (vec)
      gram_kernel<true, true><<<grid, NT, 0, s>>>(a, lda, b, mi, ni, nb,
                                                  symmetric);
    else
      gram_kernel<true, false><<<grid, NT, 0, s>>>(a, lda, b, mi, ni, nb,
                                                   symmetric);
  } else {
    if (vec)
      gram_kernel<false, true><<<grid, NT, 0, s>>>(a, lda, b, mi, ni, nb,
                                                   symmetric);
    else
      gram_kernel<false, false><<<grid, NT, 0, s>>>(a, lda, b, mi, ni, nb,
                                                    symmetric);
  }
  return static_cast<int>(cudaGetLastError());
}
