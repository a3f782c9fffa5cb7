// Vector sweeps of the gram-free deflated power step (paper Alg 4), written
// for Hopper (sm_90a).  All operands fp32, row-major; sums in fp32 FFMA.
//
//   matvec                 y = A @ v            A (m, n), v (n,)  -> y (m,)
//   matvec, trans          y = A^T @ u          u (m,)            -> y (n,)
//   deflate_rmatvec        t13 = A^T (Xv - U @ c), utxv = U^T Xv
//                          U (m, k), Xv (m,), c (k,)  -> (n,), (k,)
//   deflate_rmatvec, trans t13 = A (x - V @ c),   vtx = V^T x
//                          V (n, k), x (n,), c (k,)   -> (m,), (k,)
//
// Replace the Pallas TPU kernels of src/repro/kernels/deflate_matvec.py:
// matvec (pallas_call at :55) and deflate_rmatvec (pallas_call at :127).  The
// trans forms serve wide inputs, whose power step runs on the left side:
// they apply the same function to A^T without forming it.
//
// Bound on an H100 SXM (80 GB HBM3 at 3.35 TB/s, 67 TFLOP/s fp32 outside the
// tensor cores): both are GEMVs, 2mn flop on 4mn bytes of A, so A's bytes
// bound them by a factor of ~130 over the FFMA work.  At the gram-free path's
// 262144 x 32768 one read of A is 34.4 GB, 10.3 ms.  What the design does:
//   * A is read from device memory exactly once per call, coalesced along its
//     rows, 16 bytes per thread where A (and the vector read along A's rows)
//     is 16-byte aligned and n is a multiple of 4 (one element per load
//     otherwise).  The vectors and U are k/n of A's bytes or less.
//   * Row dots (matvec, and the last pass of the trans deflate): a block
//     sums 8 rows at once, its 256 threads striding along them together, so
//     each load instruction of the block reads 4 KB of one row and each
//     element of v, read from L2, feeds 8 rows.  The partial sums meet in a
//     fixed xor-shuffle tree and then across the warps in order.  Few,
//     long contiguous streams per SM matter here: giving each warp rows of
//     its own (some 256 row streams per SM) ran well below the byte bound.
//   * Column sweeps (matvec trans, deflate_rmatvec): a block owns 1024
//     columns (4 per thread) and one slab of at most 16384 rows; each thread
//     walks the slab's rows in order.  The slabs write fp32 partials that a
//     second launch sums in slab order.  No atomics anywhere: every rerun is
//     bitwise equal (the solver's health-guard rollback replays a solve and
//     expects the same bits).
//   * deflate_rmatvec fuses the deflation correction as the TPU kernel did:
//     per chunk of 64 rows the block forms corr = Xv - U c in shared memory
//     (k FMAs a row) and then sweeps A against it, so A is read once.  The
//     blocks of the first column tile also sum U^T Xv over their slab (the
//     Pallas kernel's j == 0 guard), summed over slabs in the same fixed
//     order.
//   * The trans deflate corrects the n-side vector: a small launch forms
//     corr = x - V c and per-block partials of V^T x (a fixed shuffle tree),
//     a second sums the partials in block order, and the row-dot kernel
//     then reads A once against corr.
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_matvec(A, v, y, partial, m, n, slab_rows, trans, stream)
//   int repro_deflate_rmatvec(A, U, x, c, t13, utxv, partial, upartial,
//                             m, n, k, slab_rows, trans, stream)
// Both return cudaGetLastError() after their launches (0 on success) and
// allocate nothing.  Scratch from the caller, fp32:
//   matvec trans:           partial (slabs, n), unused with one slab;
//   deflate_rmatvec:        partial (slabs, n) and upartial (slabs, k),
//                           unused with one slab;
//   deflate_rmatvec trans:  partial (n,) for corr, upartial (ceil(n/256), k).
// k is at most 1024 (UQ * NT).

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int WARPS = NT / 32;
constexpr int RB = 8;              // rows per block in the row dots
constexpr int CW = 4;              // columns per thread in the column sweeps
constexpr int BC = NT * CW;        // columns per block in the column sweeps
constexpr int CHUNK = 64;          // rows whose weights are staged at a time
constexpr int UQ = 4;              // U^T Xv sums per thread: k <= UQ * NT

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    x += __shfl_xor_sync(0xffffffffu, x, off);
  return x;
}

// y[r] = A[r, :] . v for RB rows per block: the block's threads stride
// along the rows together, each v element loaded once for the RB rows; each
// thread's sums meet in a fixed xor-shuffle tree, then across the warps in
// order.  Rows past m re-read row m-1 and are not written, so the inner
// loop has no branch.
template <bool VEC>
__global__ void __launch_bounds__(NT)
    rowdot_kernel(const float* __restrict__ A, const float* __restrict__ v,
                  float* __restrict__ y, int m, int n) {
  __shared__ float red[WARPS][RB];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t r0 = static_cast<int64_t>(blockIdx.x) * RB;
  const float* rows[RB];
  float acc[RB];
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const int64_t r = r0 + i < m ? r0 + i : m - 1;
    rows[i] = A + r * n;
    acc[i] = 0.0f;
  }
  if constexpr (VEC) {
    const int nv = n / 4;
    const float4* v4 = reinterpret_cast<const float4*>(v);
#pragma unroll 2
    for (int j = threadIdx.x; j < nv; j += NT) {
      const float4 x = __ldg(v4 + j);
#pragma unroll
      for (int i = 0; i < RB; ++i) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(rows[i]) + j);
        acc[i] = fmaf(a.x, x.x, acc[i]);
        acc[i] = fmaf(a.y, x.y, acc[i]);
        acc[i] = fmaf(a.z, x.z, acc[i]);
        acc[i] = fmaf(a.w, x.w, acc[i]);
      }
    }
  } else {
#pragma unroll 2
    for (int j = threadIdx.x; j < n; j += NT) {
      const float x = __ldg(v + j);
#pragma unroll
      for (int i = 0; i < RB; ++i) acc[i] = fmaf(__ldg(rows[i] + j), x, acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < RB; ++i) {
    const float s = warp_sum(acc[i]);
    if (lane == 0) red[warp][i] = s;
  }
  __syncthreads();
  if (threadIdx.x < RB && r0 + threadIdx.x < m) {
    float s = 0.0f;
#pragma unroll
    for (int w = 0; w < WARPS; ++w) s += red[w][threadIdx.x];
    y[r0 + threadIdx.x] = s;
  }
}

// out[z*n + c] = sum over the rows r of slab z = blockIdx.y, in order, of
// w[r] * A[r][c], with w = x (plain) or w = x - U @ cv (DEFLATE).  DEFLATE
// blocks of the first column tile also write pu[z*k + q] = sum_r U[r][q] x[r].
template <bool VEC, bool DEFLATE>
__global__ void __launch_bounds__(NT)
    colsweep_kernel(const float* __restrict__ A, const float* __restrict__ x,
                    const float* __restrict__ U, const float* __restrict__ cv,
                    float* __restrict__ out, float* __restrict__ pu, int m,
                    int n, int k, int slab_rows) {
  __shared__ float ws[CHUNK];   // the weights of the chunk's rows
  __shared__ float xs[CHUNK];   // x of the chunk's rows (DEFLATE)
  const int tid = threadIdx.x;
  const int c0 = blockIdx.x * BC + tid * CW;
  const int r_begin = blockIdx.y * slab_rows;
  const int r_end = min(m, r_begin + slab_rows);
  const bool first_tile = DEFLATE && blockIdx.x == 0;
  float acc[CW] = {0.0f, 0.0f, 0.0f, 0.0f};
  float uacc[UQ] = {0.0f, 0.0f, 0.0f, 0.0f};

  for (int r0 = r_begin; r0 < r_end; r0 += CHUNK) {
    const int rows = min(CHUNK, r_end - r0);
    if (tid < CHUNK) {
      float w = 0.0f;
      if (tid < rows) {
        const int64_t r = r0 + tid;
        w = x[r];
        if constexpr (DEFLATE) {
          xs[tid] = w;
          float s = 0.0f;
          for (int q = 0; q < k; ++q) s = fmaf(U[r * k + q], cv[q], s);
          w -= s;
        }
      }
      ws[tid] = w;
    }
    __syncthreads();
    if (first_tile) {
#pragma unroll
      for (int u = 0; u < UQ; ++u) {
        const int q = tid + u * NT;
        if (q < k)
          for (int i = 0; i < rows; ++i)
            uacc[u] = fmaf(U[static_cast<int64_t>(r0 + i) * k + q], xs[i],
                           uacc[u]);
      }
    }
    if (c0 < n) {
      const float* base = A + static_cast<int64_t>(r0) * n + c0;
      if constexpr (VEC) {
#pragma unroll 8
        for (int i = 0; i < rows; ++i) {
          const float4 a = __ldg(reinterpret_cast<const float4*>(
              base + static_cast<int64_t>(i) * n));
          const float w = ws[i];
          acc[0] = fmaf(a.x, w, acc[0]);
          acc[1] = fmaf(a.y, w, acc[1]);
          acc[2] = fmaf(a.z, w, acc[2]);
          acc[3] = fmaf(a.w, w, acc[3]);
        }
      } else {
        const int cols = min(CW, n - c0);
#pragma unroll 4
        for (int i = 0; i < rows; ++i) {
          const float* row = base + static_cast<int64_t>(i) * n;
          const float w = ws[i];
#pragma unroll
          for (int q = 0; q < CW; ++q)
            if (q < cols) acc[q] = fmaf(__ldg(row + q), w, acc[q]);
        }
      }
    }
    __syncthreads();
  }

  float* o = out + static_cast<int64_t>(blockIdx.y) * n;
#pragma unroll
  for (int q = 0; q < CW; ++q)
    if (c0 + q < n) o[c0 + q] = acc[q];
  if (first_tile) {
#pragma unroll
    for (int u = 0; u < UQ; ++u) {
      const int q = tid + u * NT;
      if (q < k) pu[static_cast<int64_t>(blockIdx.y) * k + q] = uacc[u];
    }
  }
}

// corr[j] = x[j] - V[j, :] . cv, and pv[b*k + q] = sum over the block's j of
// V[j][q] * x[j] (shuffle tree, then the warps in order).
__global__ void __launch_bounds__(NT)
    deflate_prep_kernel(const float* __restrict__ x,
                        const float* __restrict__ V,
                        const float* __restrict__ cv,
                        float* __restrict__ corr, float* __restrict__ pv,
                        int n, int k) {
  __shared__ float red[WARPS];
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int64_t j = static_cast<int64_t>(blockIdx.x) * NT + threadIdx.x;
  const bool in = j < n;
  const float xj = in ? x[j] : 0.0f;
  if (in) {
    float s = 0.0f;
    for (int q = 0; q < k; ++q) s = fmaf(V[j * k + q], cv[q], s);
    corr[j] = xj - s;
  }
  for (int q = 0; q < k; ++q) {
    const float p = warp_sum(in ? V[j * k + q] * xj : 0.0f);
    if (lane == 0) red[warp] = p;
    __syncthreads();
    if (threadIdx.x == 0) {
      float s = 0.0f;
      for (int w = 0; w < WARPS; ++w) s += red[w];
      pv[static_cast<int64_t>(blockIdx.x) * k + q] = s;
    }
    __syncthreads();
  }
}

// Z[e] = sum over slabs s = 0, 1, ... of P[s][e], in that order.
__global__ void sum_slabs_kernel(const float* __restrict__ P,
                                 float* __restrict__ Z, int64_t count,
                                 int slabs) {
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  for (int64_t e = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < count; e += stride) {
    float s = 0.0f;
    for (int z = 0; z < slabs; ++z) s += P[z * count + e];
    Z[e] = s;
  }
}

void sum_slabs(const float* P, float* Z, int64_t count, int slabs,
               cudaStream_t s) {
  if (count == 0) return;
  const int64_t want = (count + NT - 1) / NT;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_slabs_kernel<<<blocks, NT, 0, s>>>(P, Z, count, slabs);
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

void rowdot(const float* A, const float* v, float* y, int m, int n,
            cudaStream_t s) {
  const int blocks = (m + RB - 1) / RB;
  if (aligned16(A) && aligned16(v) && n % 4 == 0)
    rowdot_kernel<true><<<blocks, NT, 0, s>>>(A, v, y, m, n);
  else
    rowdot_kernel<false><<<blocks, NT, 0, s>>>(A, v, y, m, n);
}

template <bool DEFLATE>
void colsweep(const float* A, const float* x, const float* U,
              const float* cv, float* out, float* pu, int m, int n, int k,
              int slab_rows, int slabs, cudaStream_t s) {
  const dim3 grid((n + BC - 1) / BC, slabs);
  if (aligned16(A) && n % 4 == 0)
    colsweep_kernel<true, DEFLATE>
        <<<grid, NT, 0, s>>>(A, x, U, cv, out, pu, m, n, k, slab_rows);
  else
    colsweep_kernel<false, DEFLATE>
        <<<grid, NT, 0, s>>>(A, x, U, cv, out, pu, m, n, k, slab_rows);
}

}  // namespace

extern "C" int repro_matvec(const void* A, const void* v, void* y,
                            void* partial, long long m, long long n,
                            long long slab_rows, int trans, void* stream) {
  cudaGetLastError();  // report this call's launches, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* x = static_cast<const float*>(v);
  float* out = static_cast<float*>(y);
  if (!trans) {
    rowdot(a, x, out, (int)m, (int)n, s);
  } else {
    const int slabs = (int)((m + slab_rows - 1) / slab_rows);
    float* p = slabs > 1 ? static_cast<float*>(partial) : out;
    colsweep<false>(a, x, nullptr, nullptr, p, nullptr, (int)m, (int)n, 0,
                    (int)slab_rows, slabs, s);
    if (slabs > 1) sum_slabs(p, out, n, slabs, s);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_deflate_rmatvec(const void* A, const void* U,
                                     const void* x, const void* c, void* t13,
                                     void* utxv, void* partial,
                                     void* upartial, long long m, long long n,
                                     long long k, long long slab_rows,
                                     int trans, void* stream) {
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const float* a = static_cast<const float*>(A);
  const float* u = static_cast<const float*>(U);
  const float* xv = static_cast<const float*>(x);
  const float* cv = static_cast<const float*>(c);
  float* t = static_cast<float*>(t13);
  float* ut = static_cast<float*>(utxv);
  float* p = static_cast<float*>(partial);
  float* up = static_cast<float*>(upartial);
  if (!trans) {
    const int slabs = (int)((m + slab_rows - 1) / slab_rows);
    float* out = slabs > 1 ? p : t;
    float* pu = slabs > 1 ? up : ut;
    colsweep<true>(a, xv, u, cv, out, pu, (int)m, (int)n, (int)k,
                   (int)slab_rows, slabs, s);
    if (slabs > 1) {
      sum_slabs(p, t, n, slabs, s);
      sum_slabs(up, ut, k, slabs, s);
    }
  } else {
    const int blocks = (int)((n + NT - 1) / NT);
    deflate_prep_kernel<<<blocks, NT, 0, s>>>(xv, u, cv, p, up, (int)n,
                                               (int)k);
    sum_slabs(up, ut, k, blocks, s);
    rowdot(a, p, t, (int)m, (int)n, s);
  }
  return static_cast<int>(cudaGetLastError());
}
