// Multi-vector sweeps of the block power step, written for Hopper (sm_90a).
//
//   block_matvec   Y = A @ Q      A (m, n) row-major, Q (n, k), Y (m, k)
//   block_rmatvec  Z = A^T @ Y    A (m, n) row-major, Y (m, k), Z (n, k)
//
// Replace the Pallas TPU kernels of src/repro/kernels/block_matvec.py:
// block_matvec (pallas_call at :81) and block_rmatvec (pallas_call at :127).
// The fused chain Z = A^T (A Q) of that file (block_gram_chain, :146) is the
// composition of the two, done by the wrapper in kernels/ops.py.
//
// This file is the FFMA route: every fp32 sweep, and the bf16 sweeps that
// kernels/block_matvec.py::route does not send to the tensor-core kernels of
// block_matvec_tc.cu (an A whose base is not 16-byte aligned or whose n is
// not a multiple of 8, which a TMA tensor map cannot describe).
//
// Types: A and the skinny operand are both fp32 or both bf16.  bf16 values
// are widened to fp32 when they are staged into shared memory, every product
// is an fp32 FFMA (never TF32), and the sums are fp32; the output is fp32.
// The product of two bf16 values is exact in fp32, so the bf16 path differs
// from the plain version (kernels/ref.py) only in the order of the sums.
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): at the main path's 262144 x 32768 with k = 32 one fp32 sweep
// reads 34.4 GB of A (10.3 ms) and does 2*m*n*k = 5.5e11 flop (8.2 ms of
// FFMA).  Both sweeps are bound by the bytes of A, the FFMA rate close behind;
// in bf16 the bytes halve (5.1 ms) and the FFMA work (8.2 ms) becomes the
// limit of this design (hence the bf16 tensor-core route).  What the design
// does about it:
//   * A is read from device memory exactly once per k tile of up to 64
//     columns, so for k <= 64 each sweep moves A once; the skinny operand
//     and the output are k/n and k/m of A's bytes.
//   * Global loads are coalesced along A's rows (the contiguous axis), 16
//     bytes per thread where A is aligned and its rows are whole vectors (the
//     main path; one element per load otherwise), and are issued into
//     registers one stage ahead; two shared-memory stages with one barrier
//     each keep the next tile's bytes in flight while the FFMAs run.
//   * Each thread keeps an 8 x TK block of sums in registers and reads its 8
//     A values (and 4 skinny values at a time when TK is a multiple of 4) as
//     float4 loads from shared memory, so the inner loop is mostly FFMA.  The
//     k tile is k rounded up to a multiple of 8 (at most 64), so at most 7
//     columns of FFMA are idle.
//   * The reduction of block_rmatvec runs over the long m axis.  It is split
//     into slabs of at most 16384 rows (and enough slabs to fill the card when
//     n is small); each slab writes fp32 partials and a second launch sums
//     the slabs in order (slab_sum.cuh).  No atomics: the summation order is
//     fixed, so every rerun is bitwise equal.  The slab bound also caps each
//     thread's sequential fp32 sum, which keeps the rounding error near 2e-6
//     relative.
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_block_matvec(A, Q, Y, m, n, k, is_bf16, stream)
//   int repro_block_rmatvec(A, Y, Z, partial, m, n, k, slab_rows, is_bf16,
//                           stream)
// Both return cudaGetLastError() after their launches (0 on success).  They
// allocate nothing: `partial` is (ceil(m / slab_rows), n, k) fp32 scratch
// from the caller, unused (may be null) when there is a single slab.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

#include <type_traits>

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

// 16-byte vectors of A for the aligned path: 4 fp32 or 8 bf16 values.
template <typename T>
struct Vec;
template <>
struct Vec<float> {
  using type = float4;
  static constexpr int N = 4;
};
template <>
struct Vec<__nv_bfloat16> {
  using type = uint4;
  static constexpr int N = 8;
};

__device__ __forceinline__ float widen(float x) { return x; }
__device__ __forceinline__ float widen(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void widen(const float4& v, float (&o)[4]) {
  o[0] = v.x, o[1] = v.y, o[2] = v.z, o[3] = v.w;
}
// bf16 is the upper half of an fp32: element 2i is the low half-word.
__device__ __forceinline__ void widen(const uint4& v, float (&o)[8]) {
  const unsigned w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    o[2 * i] = __uint_as_float(w[i] << 16);
    o[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
  }
}

template <typename T>
__device__ __forceinline__ T zero();
template <>
__device__ __forceinline__ float zero<float>() { return 0.0f; }
template <>
__device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.0f);
}
template <typename V>
__device__ __forceinline__ V zero_vec() {
  V v;
  v.x = v.y = v.z = v.w = 0;
  return v;
}

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
template <typename T, int TK>
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
                   : zero<T>();
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
// inside the block (on the TPU it was the sequential grid axis).  VEC: A is
// 16-byte aligned and n is a multiple of the vector width, so A is read in
// 16-byte vectors; otherwise one element per load.
template <typename T, int TK, bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    matvec_kernel(const T* __restrict__ A, const T* __restrict__ Q,
                  float* __restrict__ Y, int m, int n, int k) {
  constexpr int KT = TX * TK, XS = BM + XPAD;
  constexpr int VN = VEC ? Vec<T>::N : 1;
  constexpr int PER = BM * BK / VN / NT;     // A loads per thread per stage
  using L = typename std::conditional<VEC, typename Vec<T>::type, T>::type;
  __shared__ __align__(16) float xs[2][BK * XS];  // xs[j][r] = A[r][j]
  __shared__ __align__(16) float ws[2][BK * KT];  // ws[j][c] = Q[j][c]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int64_t row0 = static_cast<int64_t>(blockIdx.x) * BM;
  const int col0 = blockIdx.y * KT;

  L a_pre[PER];
  SkinnyStage<T, TK> w;
  float acc[TM][TK];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TK; ++c) acc[i][c] = 0.0f;

  auto fetch = [&](int j0) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      const int64_t r = row0 + e / (BK / VN);
      const int j = j0 + (e % (BK / VN)) * VN;
      if constexpr (VEC)
        a_pre[p] = (r < m && j < n)
                       ? *reinterpret_cast<const L*>(A + r * n + j)
                       : zero_vec<L>();
      else
        a_pre[p] = (r < m && j < n) ? A[r * n + j] : zero<T>();
    }
    w.fetch(Q, k, col0, j0, n, tid);
  };
  auto stash = [&](int b) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      const int r = e / (BK / VN), j = (e % (BK / VN)) * VN;
      if constexpr (VEC) {
        float v[VN];
        widen(a_pre[p], v);
#pragma unroll
        for (int q = 0; q < VN; ++q) xs[b][(j + q) * XS + r] = v[q];
      } else {
        xs[b][j * XS + r] = widen(a_pre[p]);
      }
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
template <typename T, int TK, bool VEC>
__global__ void __launch_bounds__(NT, MIN_BLOCKS)
    rmatvec_kernel(const T* __restrict__ A, const T* __restrict__ Y,
                   float* __restrict__ Z, int m, int n, int k,
                   int slab_rows) {
  constexpr int KT = TX * TK, XS = BM + XPAD;
  constexpr int VN = VEC ? Vec<T>::N : 1;
  constexpr int PER = BM * BK / VN / NT;
  using L = typename std::conditional<VEC, typename Vec<T>::type, T>::type;
  __shared__ __align__(16) float xs[2][BK * XS];  // xs[i][c] = A[i][c]
  __shared__ __align__(16) float ws[2][BK * KT];  // ws[i][c] = Y[i][c]

  const int tid = threadIdx.x;
  const int tx = tid % TX, ty = tid / TX;
  const int c0 = blockIdx.x * BM;
  const int col0 = blockIdx.y * KT;
  const int r_begin = blockIdx.z * slab_rows;
  const int r_end = min(m, r_begin + slab_rows);

  L a_pre[PER];
  SkinnyStage<T, TK> w;
  float acc[TM][TK];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int c = 0; c < TK; ++c) acc[i][c] = 0.0f;

  auto fetch = [&](int i0) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      const int r = i0 + e / (BM / VN), c = c0 + (e % (BM / VN)) * VN;
      const T* src = A + static_cast<int64_t>(r) * n + c;
      if constexpr (VEC)
        a_pre[p] = (r < r_end && c < n) ? *reinterpret_cast<const L*>(src)
                                        : zero_vec<L>();
      else
        a_pre[p] = (r < r_end && c < n) ? *src : zero<T>();
    }
    w.fetch(Y, k, col0, i0, r_end, tid);
  };
  auto stash = [&](int b) {
#pragma unroll
    for (int p = 0; p < PER; ++p) {
      const int e = tid + p * NT;
      const int i = e / (BM / VN), c = (e % (BM / VN)) * VN;
      if constexpr (VEC) {
        float v[VN];
        widen(a_pre[p], v);
#pragma unroll
        for (int q = 0; q < VN; q += 4)
          *reinterpret_cast<float4*>(&xs[b][i * XS + c + q]) =
              make_float4(v[q], v[q + 1], v[q + 2], v[q + 3]);
      } else {
        xs[b][i * XS + c] = widen(a_pre[p]);
      }
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

template <typename T, int TK>
void launch_matvec(const void* A, const void* Q, void* Y, int m, int n, int k,
                   bool vec, cudaStream_t s) {
  constexpr int KT = TX * TK;
  const dim3 grid((m + BM - 1) / BM, (k + KT - 1) / KT);
  const T* a = static_cast<const T*>(A);
  const T* q = static_cast<const T*>(Q);
  float* y = static_cast<float*>(Y);
  if (vec)
    matvec_kernel<T, TK, true><<<grid, NT, 0, s>>>(a, q, y, m, n, k);
  else
    matvec_kernel<T, TK, false><<<grid, NT, 0, s>>>(a, q, y, m, n, k);
}

template <typename T, int TK>
void launch_rmatvec(const void* A, const void* Y, void* Z, int m, int n,
                    int k, int slab_rows, int slabs, bool vec,
                    cudaStream_t s) {
  constexpr int KT = TX * TK;
  const dim3 grid((n + BM - 1) / BM, (k + KT - 1) / KT, slabs);
  const T* a = static_cast<const T*>(A);
  const T* y = static_cast<const T*>(Y);
  float* z = static_cast<float*>(Z);
  if (vec)
    rmatvec_kernel<T, TK, true>
        <<<grid, NT, 0, s>>>(a, y, z, m, n, k, slab_rows);
  else
    rmatvec_kernel<T, TK, false>
        <<<grid, NT, 0, s>>>(a, y, z, m, n, k, slab_rows);
}

// The 16-byte path needs an aligned A whose rows are whole vectors.
template <typename T>
bool vector_ok(const void* A, int n) {
  return reinterpret_cast<uintptr_t>(A) % 16 == 0 && n % Vec<T>::N == 0;
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

template <typename T>
void matvec_typed(const void* A, const void* Q, void* Y, int m, int n, int k,
                  cudaStream_t s) {
  const bool vec = vector_ok<T>(A, n);
#define REPRO_CALL(TK) launch_matvec<T, TK>(A, Q, Y, m, n, k, vec, s)
  REPRO_TK_SWITCH(tile_k(k), REPRO_CALL)
#undef REPRO_CALL
}

template <typename T>
void rmatvec_typed(const void* A, const void* Y, void* Z, int m, int n, int k,
                   int slab_rows, int slabs, cudaStream_t s) {
  const bool vec = vector_ok<T>(A, n);
#define REPRO_CALL(TK) \
  launch_rmatvec<T, TK>(A, Y, Z, m, n, k, slab_rows, slabs, vec, s)
  REPRO_TK_SWITCH(tile_k(k), REPRO_CALL)
#undef REPRO_CALL
}

}  // namespace

extern "C" int repro_block_matvec(const void* A, const void* Q, void* Y,
                                  long long m, long long n, long long k,
                                  int is_bf16, void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (is_bf16)
    matvec_typed<__nv_bfloat16>(A, Q, Y, (int)m, (int)n, (int)k, s);
  else
    matvec_typed<float>(A, Q, Y, (int)m, (int)n, (int)k, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_block_rmatvec(const void* A, const void* Y, void* Z,
                                   void* partial, long long m, long long n,
                                   long long k, long long slab_rows,
                                   int is_bf16, void* stream) {
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int slabs = (int)((m + slab_rows - 1) / slab_rows);
  void* out = slabs > 1 ? partial : Z;
  if (is_bf16)
    rmatvec_typed<__nv_bfloat16>(A, Y, out, (int)m, (int)n, (int)k,
                                 (int)slab_rows, slabs, s);
  else
    rmatvec_typed<float>(A, Y, out, (int)m, (int)n, (int)k, (int)slab_rows,
                         slabs, s);
  if (slabs > 1)
    repro_slab_sum::sum_slabs(static_cast<const float*>(partial),
                              static_cast<float*>(Z), n * k, slabs, s);
  return static_cast<int>(cudaGetLastError());
}
