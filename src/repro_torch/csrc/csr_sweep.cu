// Deterministic CSR row-block sweeps of the sparse stream
// (repro_torch/core/sparse.py), written for Hopper (sm_90a).  Values fp32 or
// bf16; the dense operands and every sum fp32.
//
//   csr_matmat    Y_b = A_b Q           A_b (rows, n) CSR, Q (n, k) -> (rows, k)
//   csr_rmatmat   Z  += A_b^T Y_b       Y_b (rows, k), Z (n, k) in place
//
// The JAX package has no kernel here: it streams the nonzeros on the host
// with np.add.at (src/repro/core/sparse.py:96-164, "TPUs have no hardware
// CSR path").  On the card the streamed products belong on the device, and
// two properties rule out a library's sparse product: the solver's resume
// and health-guard rollback expect bitwise-equal reruns (no atomics), and
// the bf16 chain rounds y to bf16 between its halves.
//
// The arithmetic contract: every product is rounded before its add
// (__fmul_rn, then __fadd_rn: no FMA contraction), and every sum is taken in
// the stream's order, so each output element is bitwise what np.add.at gives
// for the same rounded operands in the same order:
//   * csr_matmat: row r's nonzeros in stream (CSR) order, from 0.
//   * csr_rmatmat: the block's columns are sorted stably by the caller (so
//     each column's nonzeros form one run in row order), and each run is
//     summed straight into Z[c, :], starting from Z's value.  The caller
//     launches the blocks of a pass in order on one stream, so Z[c] sees
//     block 0's run, then block 1's, ... exactly as np.add.at over the whole
//     stream does.  One thread group owns a run: no atomics.
//
// Layout: T lanes (the smallest power of two >= k, at most 32) share a row
// (matmat) or a run (rmatmat), lane c summing column c (and c + 32, ... for
// k > 32).  The T lanes read the same column index and value (one broadcast
// load), then T consecutive floats of Q's (or Y's) row.
//
// Bound on an H100 SXM (3.35 TB/s): bytes.  Each nonzero carries 4 bytes of
// column and 4 (fp32) or 2 (bf16) of value, and reads one k-float row of Q
// (matmat) or Y (rmatmat) and, in rmatmat, reads and writes one k-float row
// of Z: at k = 8 some 40-100 bytes a nonzero against 2k flops.  The rows of
// Q and Z a block touches are scattered over n (33.5M columns at the paper's
// per-node share), so each is a separate 32-byte sector from device memory;
// Y_b (rows x k fp32, 2 MB at 65536 x 8) stays in L2.  What the design does:
// matmat issues the loads of four nonzeros before their four ordered adds,
// so each lane keeps four sector reads in flight; both kernels launch one
// group per row or per nonzero (65536 x T and ~2.2M x T threads a block at
// the paper's share), enough warps to hide the scattered reads.  Making them
// faster is later work; PERF.md section 6 has their times.
//
// C interface (bound with ctypes; every pointer and the stream as void*).
// Each returns cudaGetLastError() after its launches (0 on success) and
// allocates nothing:
//   int repro_csr_matmat(off, col, val, val_bf16, Q, Y, rows, k, round_out,
//                        stream)
//       off int32 (rows + 1), col int32 (nnz), val fp32|bf16 (nnz), Q fp32
//       (n, k) row-major, Y fp32 (rows, k) written; round_out rounds each
//       sum to the nearest bf16 (the bf16 chain's y).
//   int repro_csr_rmatmat(off, skey, perm, row_of, val, val_bf16, Y, Z,
//                         rows, nnz, k, stream)
//       skey int32 (nnz): the block's columns sorted stably; perm int64
//       (nnz): each sorted entry's position in the block; row_of int32
//       (nnz) scratch; Y fp32 (rows, k); Z fp32 (n, k) accumulated in place.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int UNROLL = 4;          // nonzeros whose loads a lane issues at once

__device__ __forceinline__ float load_val(const float* v, long long j) {
  return v[j];
}

__device__ __forceinline__ float load_val(const __nv_bfloat16* v,
                                          long long j) {
  return __bfloat162float(v[j]);
}

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

template <typename V, int T>
__global__ void __launch_bounds__(NT)
csr_matmat(const int* __restrict__ off, const int* __restrict__ col,
           const V* __restrict__ val, const float* __restrict__ Q,
           float* __restrict__ Y, int rows, int k, int round_out) {
  const int lane = threadIdx.x % T;
  const long long r = (long long)blockIdx.x * (NT / T) + threadIdx.x / T;
  if (r >= rows) return;
  const long long b = off[r], e = off[r + 1];
  for (int c = lane; c < k; c += T) {
    float acc = 0.f;
    long long j = b;
    for (; j + UNROLL <= e; j += UNROLL) {
      float v[UNROLL], q[UNROLL];
#pragma unroll
      for (int u = 0; u < UNROLL; ++u) {
        v[u] = load_val(val, j + u);
        q[u] = Q[(size_t)col[j + u] * k + c];
      }
#pragma unroll
      for (int u = 0; u < UNROLL; ++u)        // in stream order
        acc = __fadd_rn(acc, __fmul_rn(v[u], q[u]));
    }
    for (; j < e; ++j)
      acc = __fadd_rn(acc, __fmul_rn(load_val(val, j),
                                     Q[(size_t)col[j] * k + c]));
    Y[(size_t)r * k + c] = round_out ? to_bf16(acc) : acc;
  }
}

// row_of[j] = the block-local row of nonzero j
__global__ void __launch_bounds__(NT)
expand_rows(const int* __restrict__ off, int* __restrict__ row_of,
            int rows) {
  const long long r = (long long)blockIdx.x * NT + threadIdx.x;
  if (r >= rows) return;
  for (long long j = off[r]; j < off[r + 1]; ++j) row_of[j] = (int)r;
}

// one group of T lanes per sorted entry; the group at the start of a run
// (the first entry of its column) sums the whole run into Z
template <typename V, int T>
__global__ void __launch_bounds__(NT)
csr_runs(const int* __restrict__ skey, const long long* __restrict__ perm,
         const int* __restrict__ row_of, const V* __restrict__ val,
         const float* __restrict__ Y, float* __restrict__ Z, long long nnz,
         int k) {
  const int lane = threadIdx.x % T;
  const long long i = (long long)blockIdx.x * (NT / T) + threadIdx.x / T;
  if (i >= nnz) return;
  const int c = skey[i];
  if (i > 0 && skey[i - 1] == c) return;      // not the start of a run
  long long end = i + 1;
  while (end < nnz && skey[end] == c) ++end;
  for (int cc = lane; cc < k; cc += T) {
    float acc = Z[(size_t)c * k + cc];
    for (long long t = i; t < end; ++t) {
      const long long j = perm[t];
      acc = __fadd_rn(acc, __fmul_rn(load_val(val, j),
                                     Y[(size_t)row_of[j] * k + cc]));
    }
    Z[(size_t)c * k + cc] = acc;
  }
}

template <typename V, int T>
void matmat_t(const void* off, const void* col, const void* val,
              const void* Q, void* Y, long long rows, long long k,
              int round_out, cudaStream_t s) {
  const long long per = NT / T;
  const unsigned grid = (unsigned)((rows + per - 1) / per);
  csr_matmat<V, T><<<grid, NT, 0, s>>>(
      static_cast<const int*>(off), static_cast<const int*>(col),
      static_cast<const V*>(val), static_cast<const float*>(Q),
      static_cast<float*>(Y), (int)rows, (int)k, round_out);
}

template <typename V, int T>
void runs_t(const void* skey, const void* perm, const void* row_of,
            const void* val, const void* Y, void* Z, long long nnz,
            long long k, cudaStream_t s) {
  const long long per = NT / T;
  const unsigned grid = (unsigned)((nnz + per - 1) / per);
  csr_runs<V, T><<<grid, NT, 0, s>>>(
      static_cast<const int*>(skey), static_cast<const long long*>(perm),
      static_cast<const int*>(row_of), static_cast<const V*>(val),
      static_cast<const float*>(Y), static_cast<float*>(Z), nnz, (int)k);
}

// lanes a row (or run) gets: the smallest power of two >= k, at most 32
int lanes(long long k) {
  int t = 1;
  while (t < k && t < 32) t *= 2;
  return t;
}

template <typename V>
void matmat_v(const void* off, const void* col, const void* val,
              const void* Q, void* Y, long long rows, long long k,
              int round_out, cudaStream_t s) {
  switch (lanes(k)) {
    case 1: matmat_t<V, 1>(off, col, val, Q, Y, rows, k, round_out, s); break;
    case 2: matmat_t<V, 2>(off, col, val, Q, Y, rows, k, round_out, s); break;
    case 4: matmat_t<V, 4>(off, col, val, Q, Y, rows, k, round_out, s); break;
    case 8: matmat_t<V, 8>(off, col, val, Q, Y, rows, k, round_out, s); break;
    case 16:
      matmat_t<V, 16>(off, col, val, Q, Y, rows, k, round_out, s);
      break;
    default:
      matmat_t<V, 32>(off, col, val, Q, Y, rows, k, round_out, s);
  }
}

template <typename V>
void runs_v(const void* skey, const void* perm, const void* row_of,
            const void* val, const void* Y, void* Z, long long nnz,
            long long k, cudaStream_t s) {
  switch (lanes(k)) {
    case 1: runs_t<V, 1>(skey, perm, row_of, val, Y, Z, nnz, k, s); break;
    case 2: runs_t<V, 2>(skey, perm, row_of, val, Y, Z, nnz, k, s); break;
    case 4: runs_t<V, 4>(skey, perm, row_of, val, Y, Z, nnz, k, s); break;
    case 8: runs_t<V, 8>(skey, perm, row_of, val, Y, Z, nnz, k, s); break;
    case 16: runs_t<V, 16>(skey, perm, row_of, val, Y, Z, nnz, k, s); break;
    default: runs_t<V, 32>(skey, perm, row_of, val, Y, Z, nnz, k, s);
  }
}

}  // namespace

extern "C" int repro_csr_matmat(const void* off, const void* col,
                                const void* val, int val_bf16, const void* Q,
                                void* Y, long long rows, long long k,
                                int round_out, void* stream) {
  cudaGetLastError();  // report this call's launches, not an older error
  if (rows <= 0 || k <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (val_bf16)
    matmat_v<__nv_bfloat16>(off, col, val, Q, Y, rows, k, round_out, s);
  else
    matmat_v<float>(off, col, val, Q, Y, rows, k, round_out, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_csr_rmatmat(const void* off, const void* skey,
                                 const void* perm, void* row_of,
                                 const void* val, int val_bf16, const void* Y,
                                 void* Z, long long rows, long long nnz,
                                 long long k, void* stream) {
  cudaGetLastError();
  if (rows <= 0 || nnz <= 0 || k <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  expand_rows<<<(unsigned)((rows + NT - 1) / NT), NT, 0, s>>>(
      static_cast<const int*>(off), static_cast<int*>(row_of), (int)rows);
  if (val_bf16)
    runs_v<__nv_bfloat16>(skey, perm, row_of, val, Y, Z, nnz, k, s);
  else
    runs_v<float>(skey, perm, row_of, val, Y, Z, nnz, k, s);
  return static_cast<int>(cudaGetLastError());
}
