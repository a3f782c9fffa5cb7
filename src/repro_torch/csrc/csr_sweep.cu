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
// and health-guard rollback expect bitwise-equal reruns (no atomics in a
// sum), and the bf16 chain rounds y to bf16 between its halves.
//
// The arithmetic contract: every product is rounded before its add
// (__fmul_rn, then __fadd_rn: no FMA contraction), and every sum is taken in
// the stream's order, so each output element is bitwise what np.add.at gives
// for the same rounded operands in the same order:
//   * csr_matmat: row r's nonzeros in stream (CSR) order, from 0.
//   * csr_rmatmat: the block's nonzeros are ordered stably by column, so each
//     column's nonzeros form a run in row order, and each run is summed
//     straight into Z[c, :], starting from Z's value.  The caller launches
//     the blocks of a pass in order on one stream, so Z[c] sees block 0's
//     run, then block 1's, ... exactly as np.add.at over the whole stream
//     does.  One thread owns a run: no atomics in any sum.
// Products may be formed in parallel (loads are issued ahead of the ordered
// adds, and long runs stage their products in shared memory); only the adds
// keep their order.
//
// Bound on an H100 SXM: bytes (3.35 TB/s), and in practice the card's rate
// of scattered 32-byte row reads (0.8 TB/s measured by row_gather below).
// The rows of Q and Z a block touches are spread over n (33.5M columns at the
// paper's per-node share, Q and Z 1.07 GB each at k = 8, far beyond the 50 MB
// L2), so each nonzero costs its own 32-byte row of Q (matmat) and each
// touched column a row of Z read and written (rmatmat); Y_b (2 MB at 65536
// x 8) stays in L2.
//
// csr_matmat: lane c of a row's k lanes sums its column c (a 4-byte load of
// each Q row), issuing the loads of U nonzeros before their ordered adds (U
// = 8 for fp32 values, 4 for bf16: the faster of each on the card) with
// read-only loads, and takes its next row as soon as its own ends (one loop
// over rows and batches, so a warp is not held by its longest row).  Index
// math is 32-bit where n k and rows k fit in 31 bits.  It runs at the rate
// of scattered row reads; more loads in flight (a lane owning 8 columns as
// two float4, U up to 16) measured slower (PERF.md section 6).
//
// csr_rmatmat, six steps on the launching stream:
//   1. csr_records: one warp a row writes each nonzero's record, its block
//      row (high 32 bits) and its value's fp32 bits (low 32), in stream
//      order: the rows come from off, no expanded row array is kept.
//   2. one stable radix pass (CUB's DeviceRadixSort::SortPairs on the top
//      bucket bits only: it computes no product and no sum) partitions the
//      (column, record) pairs into buckets of columns with equal top bits,
//      each bucket in stream order.
//   3. csr_bucket_bounds: each bucket's first entry.
//   4. csr_bucket_sort: one block a bucket of at most CAP entries sorts it
//      on the low column bits in shared memory (CUB's BlockRadixSort, keys
//      only: each key is an entry's low bits above its rank, so equal
//      columns keep their stream order), writes the columns back in place,
//      gathers the records in that order, and appends the run starts to the
//      run list (one atomicAdd a block reserves its slots: a list slot,
//      never a sum; the list's order may change from run to run, the sums
//      cannot).
//   5. csr_runs: a thread a run start: Z's row read once, the run's records
//      and Y rows loaded U at a time ahead of its ordered adds, Z's row
//      written once.
//   6. csr_big_buckets: a bucket above CAP entries (skewed columns; one
//      column holding the whole block) is taken by one block in chunks of
//      CAP in order, each sorted as in step 4, its products formed by all
//      threads into shared memory and added in order by the thread at each
//      run's start; blocks of other buckets return at once.
// A whole stable sort of the pairs (CUB, every key bit) before step 5 took
// 0.37 ms of the 0.32 here (PERF.md section 6).  Scratch (the sorted
// columns, both record arrays, the run list, its counter, the bucket bounds
// and CUB's temporary storage) comes from the caller: the binding carves it
// from one torch.empty buffer (kernels/csr_sweep.py::scratch_layout).
//
// C interface (bound with ctypes; every pointer and the stream as void*).
// Each returns a cudaError_t (0 on success) and allocates nothing:
//   int repro_csr_matmat(off, col, val, val_bf16, Q, Y, rows, n, k,
//                        round_out, stream)
//       off int32 (rows + 1), col int32 (nnz), val fp32|bf16 (nnz), Q fp32
//       (n, k) row-major, Y fp32 (rows, k) written; round_out rounds each
//       sum to the nearest bf16 (the bf16 chain's y).
//   int repro_csr_sort_bytes(nnz, bits, low, &bytes)
//       CUB's temporary storage for step 2.
//   int repro_csr_bucket_cap()
//       CAP.
//   int repro_csr_rmatmat(off, col, val, val_bf16, Y, Z, rows, nnz, n, k,
//                         bits, low, skey, rec_in, rec_out, starts, count,
//                         bounds, temp, temp_bytes, phases, stream)
//       Y fp32 (rows, k); Z fp32 (n, k) accumulated in place; bits the key
//       width (columns < 2^bits), low the bits sorted within a bucket (the
//       top bits - low <= 8 partition); the next eight the scratch; phases 1
//       = the records and sorts (steps 1-4), 2 = the sums (steps 5-6, on the
//       scratch phase 1 left), 3 = all.
//   int repro_row_gather(src, idx, out, count, row_floats, stream)
//       out[i] = the sum of src[idx[i]], a row of row_floats (a multiple of
//       4) floats: the card's rate of scattered row reads, the ceiling the
//       two sweeps are read against (chip_smoke.py phase 9.1).
#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>
#include <cub/device/device_radix_sort.cuh>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <limits.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int NT = 256;            // threads per block
constexpr int WAVES = 32;          // matmat's grid: at most 32 blocks an SM

typedef unsigned long long u64;

__device__ __forceinline__ float load_val(const float* v, long long j) {
  return __ldg(v + j);
}

__device__ __forceinline__ float load_val(const __nv_bfloat16* v,
                                          long long j) {
  const unsigned short bits =
      __ldg(reinterpret_cast<const unsigned short*>(v) + j);
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

__device__ __forceinline__ float to_bf16(float x) {
  return __bfloat162float(__float2bfloat16_rn(x));
}

// element offset of row a of a (., k) array: 32-bit math unless WIDE
template <bool WIDE>
__device__ __forceinline__ size_t at(unsigned a, int k) {
  return WIDE ? static_cast<size_t>(a) * static_cast<unsigned>(k)
              : static_cast<size_t>(a * static_cast<unsigned>(k));
}

// a lane's CW columns [c0, c0 + cols) of one row, p pointing at column c0;
// VEC: k % 4 == 0 and the rows 16-byte aligned, so float4 loads; RO:
// read-only for the kernel's lifetime (ld.global.nc)
template <int CW, bool VEC, bool RO>
__device__ __forceinline__ void load_chunk(float (&x)[CW], const float* p,
                                           int cols) {
  if constexpr (VEC && CW % 4 == 0) {
#pragma unroll
    for (int v = 0; v < CW / 4; ++v)
      if (4 * v < cols) {
        const float4* q = reinterpret_cast<const float4*>(p) + v;
        const float4 t = RO ? __ldg(q) : *q;
        x[4 * v] = t.x;
        x[4 * v + 1] = t.y;
        x[4 * v + 2] = t.z;
        x[4 * v + 3] = t.w;
      }
  } else {
#pragma unroll
    for (int u = 0; u < CW; ++u)
      if (u < cols) x[u] = RO ? __ldg(p + u) : p[u];
  }
}

template <int CW, bool VEC>
__device__ __forceinline__ void store_chunk(float* p, const float (&x)[CW],
                                            int cols) {
  if constexpr (VEC && CW % 4 == 0) {
#pragma unroll
    for (int v = 0; v < CW / 4; ++v)
      if (4 * v < cols)
        reinterpret_cast<float4*>(p)[v] =
            make_float4(x[4 * v], x[4 * v + 1], x[4 * v + 2], x[4 * v + 3]);
  } else {
#pragma unroll
    for (int u = 0; u < CW; ++u)
      if (u < cols) p[u] = x[u];
  }
}

// ---------------------------------------------------------------------------
// csr_matmat: a task is (row, CW columns); a lane walks its tasks
// (grid-stride) in batches of U nonzeros, taking its next task as soon as
// its row ends.  CW = 1 is the one instantiated: 8 columns a lane (two
// float4) measured slower, and so did rewrites for one column with scalar
// accumulators, with and without the task loop (PERF.md section 6)
// ---------------------------------------------------------------------------

template <typename V, int CW, int U, bool VEC, bool WIDE>
__global__ void __launch_bounds__(NT)
csr_matmat(const int* __restrict__ off, const int* __restrict__ col,
           const V* __restrict__ val, const float* __restrict__ Q,
           float* __restrict__ Y, long long tasks, int k, int G,
           int round_out) {
  const long long stride = static_cast<long long>(gridDim.x) * NT;
  long long t = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (t >= tasks) return;
  int r = static_cast<int>(t / G);
  int c0 = static_cast<int>(t % G) * CW;
  int cols = min(CW, k - c0);
  int j = __ldg(off + r), e = __ldg(off + r + 1);
  float acc[CW];
#pragma unroll
  for (int x = 0; x < CW; ++x) acc[x] = 0.f;
  while (true) {
    while (j >= e) {                               // the task is done
      if (round_out) {
#pragma unroll
        for (int x = 0; x < CW; ++x) acc[x] = to_bf16(acc[x]);
      }
      store_chunk<CW, VEC>(Y + at<WIDE>(r, k) + c0, acc, cols);
      t += stride;
      if (t >= tasks) return;
      r = static_cast<int>(t / G);
      c0 = static_cast<int>(t % G) * CW;
      cols = min(CW, k - c0);
      j = __ldg(off + r);
      e = __ldg(off + r + 1);
#pragma unroll
      for (int x = 0; x < CW; ++x) acc[x] = 0.f;
    }
    const int here = min(U, e - j);
    int c[U];
    float v[U], q[U][CW];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < here) {
        c[u] = __ldg(col + j + u);
        v[u] = load_val(val, j + u);
      }
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (u < here)
        load_chunk<CW, VEC, true>(q[u], Q + at<WIDE>(c[u], k) + c0, cols);
#pragma unroll
    for (int u = 0; u < U; ++u)                     // in stream order
      if (u < here) {
#pragma unroll
        for (int x = 0; x < CW; ++x)
          if (x < cols) acc[x] = __fadd_rn(acc[x], __fmul_rn(v[u], q[u][x]));
      }
    j += here;
  }
}

// ---------------------------------------------------------------------------
// csr_rmatmat
// ---------------------------------------------------------------------------

// step 1: one warp a row; record = (block row << 32) | fp32 bits of value
template <typename V>
__global__ void __launch_bounds__(NT)
csr_records(const int* __restrict__ off, const V* __restrict__ val,
            u64* __restrict__ rec, int rows) {
  const long long w =
      (static_cast<long long>(blockIdx.x) * NT + threadIdx.x) / 32;
  if (w >= rows) return;
  const int lane = threadIdx.x % 32;
  const int b = __ldg(off + w), e = __ldg(off + w + 1);
  for (int j = b + lane; j < e; j += 32)
    rec[j] = (static_cast<u64>(w) << 32) | __float_as_uint(load_val(val, j));
}

// step 5: a lane a (run, CW columns); the next batch's keys and records are
// loaded before this batch's adds
template <int CW, int U, bool VEC, bool WIDE>
__global__ void __launch_bounds__(NT)
csr_runs(const unsigned* __restrict__ skey, const u64* __restrict__ rec,
         const int* __restrict__ starts, const int* __restrict__ count,
         const float* __restrict__ Y, float* __restrict__ Z, int nnz, int k,
         int G) {
  const long long t = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  const long long i = t / G;
  if (i >= __ldg(count)) return;
  const int c0 = static_cast<int>(t % G) * CW, cols = min(CW, k - c0);
  int j = __ldg(starts + i);
  const unsigned c = __ldg(skey + j);
  float* z = Z + at<WIDE>(c, k) + c0;
  float acc[CW];
  load_chunk<CW, VEC, false>(acc, z, cols);
  u64 r[U];
  bool in[U];
#pragma unroll
  for (int u = 0; u < U; ++u) {        // entries of this run (a prefix)
    in[u] = j + u < nnz && __ldg(skey + j + u) == c;
    r[u] = in[u] ? __ldg(rec + j + u) : 0;
  }
  while (true) {
    float y[U][CW];
#pragma unroll
    for (int u = 0; u < U; ++u)
      if (in[u])
        load_chunk<CW, VEC, true>(
            y[u], Y + at<WIDE>(static_cast<unsigned>(r[u] >> 32), k) + c0,
            cols);
    float v[U];
    bool here[U];
#pragma unroll
    for (int u = 0; u < U; ++u) {
      here[u] = in[u];
      v[u] = __uint_as_float(static_cast<unsigned>(r[u]));
    }
    const bool more = in[U - 1];
    if (more) {                        // the next batch, ahead of the adds
      j += U;
#pragma unroll
      for (int u = 0; u < U; ++u) {
        in[u] = j + u < nnz && __ldg(skey + j + u) == c;
        r[u] = in[u] ? __ldg(rec + j + u) : 0;
      }
    }
#pragma unroll
    for (int u = 0; u < U; ++u)                     // in stream order
      if (here[u]) {
#pragma unroll
        for (int x = 0; x < CW; ++x)
          if (x < cols) acc[x] = __fadd_rn(acc[x], __fmul_rn(v[u], y[u][x]));
      }
    if (!more) break;
  }
  store_chunk<CW, VEC>(z, acc, cols);
}

// step 3: the first entry of each bucket (the entries whose
// columns share their top bits, contiguous and in stream order after the
// partition): bounds[b] for b in [0, buckets], bounds[buckets] = nnz
__global__ void __launch_bounds__(NT)
csr_bucket_bounds(const unsigned* __restrict__ skey, int* __restrict__ bounds,
                  int nnz, int low, int buckets) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i > nnz) return;
  const int prev = i == 0 ? -1 : static_cast<int>(__ldg(skey + i - 1) >> low);
  const int cur = i == nnz ? buckets
                           : static_cast<int>(__ldg(skey + i) >> low);
  for (int b = prev + 1; b <= cur; ++b) bounds[b] = static_cast<int>(i);
}

// steps 4 and 6: one block a bucket.  A chunk of at most CAP
// entries is sorted on the low column bits in shared memory (CUB's
// BlockRadixSort, keys only, no sums): each key is an entry's low column
// bits above its rank in the chunk, so equal columns keep their stream
// order and the rank finds the entry's record afterwards.
constexpr int BT = 512;            // threads of a bucket block
constexpr int BITEMS = 20;         // entries a thread sorts
constexpr int CAP = BT * BITEMS;   // entries a chunk
constexpr int RANK_BITS = 14;
static_assert(CAP <= (1 << RANK_BITS), "a chunk's ranks need RANK_BITS");
constexpr int BRADIX = 6;          // bits a pass of the sort in shared memory

template <typename K>
using ChunkSort = cub::BlockRadixSort<K, BT, BITEMS, cub::NullType, BRADIX>;

template <typename K>
__host__ __device__ constexpr size_t chunk_smem() {
  return sizeof(typename ChunkSort<K>::TempStorage) > CAP * sizeof(K)
             ? sizeof(typename ChunkSort<K>::TempStorage)
             : CAP * sizeof(K);
}

// the keys [c0, c0 + cnt) of a bucket sorted by (low column bits, rank):
// left in shared memory as sorted keys (low bits << RANK_BITS | rank)
template <typename K>
__device__ __forceinline__ const K* sort_chunk(const unsigned* skey, int c0,
                                               int cnt, int low,
                                               unsigned char* smem) {
  auto& temp = *reinterpret_cast<typename ChunkSort<K>::TempStorage*>(smem);
  K* out = reinterpret_cast<K*>(smem);
  const K mask = (K(1) << low) - 1;
  K key[BITEMS];
#pragma unroll
  for (int i = 0; i < BITEMS; ++i) {      // blocked: rank t * BITEMS + i
    const int at_ = threadIdx.x * BITEMS + i;
    const K lowbits = at_ < cnt ? K(__ldg(skey + c0 + at_)) & mask : mask;
    key[i] = lowbits << RANK_BITS | K(at_);
  }
  __syncthreads();                        // the last chunk is done with smem
  ChunkSort<K>(temp).Sort(key, RANK_BITS, RANK_BITS + low);
  __syncthreads();                        // temp is reused as out
#pragma unroll
  for (int i = 0; i < BITEMS; ++i) out[threadIdx.x * BITEMS + i] = key[i];
  __syncthreads();
  return out;
}

// step 4: a bucket of at most CAP entries is sorted, its columns written
// back in place and its records gathered from rec_from into rec_to, and its
// run starts appended to the run list; a larger
// bucket is left to step 6
template <typename K>
__global__ void __launch_bounds__(BT)
csr_bucket_sort(unsigned* __restrict__ skey, const u64* __restrict__ rec_from,
                u64* __restrict__ rec_to, const int* __restrict__ bounds,
                int* __restrict__ starts, int* __restrict__ count, int low) {
  extern __shared__ __align__(16) unsigned char smem[];
  const int start = __ldg(bounds + blockIdx.x);
  const int cnt = __ldg(bounds + blockIdx.x + 1) - start;
  if (cnt == 0 || cnt > CAP) return;
  const K* sorted = sort_chunk<K>(skey, start, cnt, low, smem);
  const unsigned top = blockIdx.x << low;
  u64 r[BITEMS];
  int n_st = 0;
#pragma unroll
  for (int it = 0; it < BITEMS; ++it) {   // striped: the records gathered
    const int i = it * BT + threadIdx.x;  // before any is stored
    if (i < cnt) {
      const K kc = sorted[i];
      r[it] = __ldg(rec_from + start +
                    static_cast<int>(kc & ((1 << RANK_BITS) - 1)));
      n_st += i == 0 || sorted[i - 1] >> RANK_BITS != kc >> RANK_BITS;
    }
  }
  // one slot reservation a block: the run list's counter is shared by all
  __shared__ typename cub::BlockScan<int, BT>::TempStorage scan;
  __shared__ int base;
  int at_, total;
  cub::BlockScan<int, BT>(scan).ExclusiveSum(n_st, at_, total);
  if (threadIdx.x == 0) base = atomicAdd(count, total);
  __syncthreads();
  at_ += base;
#pragma unroll
  for (int it = 0; it < BITEMS; ++it) {
    const int i = it * BT + threadIdx.x;
    if (i < cnt) {
      const K kc = sorted[i];
      skey[start + i] = top | static_cast<unsigned>(kc >> RANK_BITS);
      rec_to[start + i] = r[it];
      if (i == 0 || sorted[i - 1] >> RANK_BITS != kc >> RANK_BITS)
        starts[at_++] = start + i;
    }
  }
}

// step 6: a bucket of more than CAP entries, in chunks of CAP in order,
// each sorted as in step 4, then in sub-chunks of SUB sorted entries: all
// threads form the sub-chunk's products (fp32, rounded) in shared memory,
// then the thread at the start of each run's piece in the sub-chunk adds
// them in order into Z's row.  A run spanning pieces gets them in order,
// Z written between them (the barrier orders them), so a run as long as
// the block costs its ordered adds from shared memory, not a load each.
constexpr int SUB = 2048;          // entries whose products are staged
constexpr int SUM_AHEAD = 4;       // staged products loaded before their adds

// where the staged products start: after the sort's storage, 16-byte aligned
template <typename K>
__host__ __device__ constexpr size_t prod_at() {
  return (chunk_smem<K>() + 15) / 16 * 16;
}

template <typename K, int CW, bool VEC, bool WIDE>
__global__ void __launch_bounds__(BT)
csr_big_buckets(const unsigned* __restrict__ skey, const u64* __restrict__ rec,
                const int* __restrict__ bounds, const float* __restrict__ Y,
                float* __restrict__ Z, int k, int low) {
  extern __shared__ __align__(16) unsigned char smem[];
  float* prod = reinterpret_cast<float*>(smem + prod_at<K>());
  const int start = __ldg(bounds + blockIdx.x);
  const int end = __ldg(bounds + blockIdx.x + 1);
  if (end - start <= CAP) return;
  const unsigned top = blockIdx.x << low;
  for (int c0 = start; c0 < end; c0 += CAP) {
    const int cnt = min(CAP, end - c0);
    const K* sorted = sort_chunk<K>(skey, c0, cnt, low, smem);
    for (int col0 = 0; col0 < k; col0 += CW) {
      const int cols = min(CW, k - col0);
      for (int s0 = 0; s0 < cnt; s0 += SUB) {
        const int sn = min(SUB, cnt - s0);
        for (int p = threadIdx.x; p < sn; p += BT) {     // the products
          const u64 e = __ldg(rec + c0 + static_cast<int>(
                                  sorted[s0 + p] & ((1 << RANK_BITS) - 1)));
          const float v = __uint_as_float(static_cast<unsigned>(e));
          float y[CW];
          load_chunk<CW, VEC, true>(
              y, Y + at<WIDE>(static_cast<unsigned>(e >> 32), k) + col0,
              cols);
#pragma unroll
          for (int x = 0; x < CW; ++x)
            if (x < cols) prod[p * CW + x] = __fmul_rn(v, y[x]);
        }
        __syncthreads();
        for (int p = threadIdx.x; p < sn; p += BT) {     // the ordered adds
          const K lowbits = sorted[s0 + p] >> RANK_BITS;
          if (p > 0 && sorted[s0 + p - 1] >> RANK_BITS == lowbits) continue;
          float* z = Z + at<WIDE>(top | static_cast<unsigned>(lowbits), k) +
                     col0;
          float acc[CW];
          load_chunk<CW, VEC, false>(acc, z, cols);
          for (int q = p;; q += SUM_AHEAD) {  // SUM_AHEAD entries' loads first
            float pr[SUM_AHEAD][CW];
            bool in[SUM_AHEAD];
#pragma unroll
            for (int u = 0; u < SUM_AHEAD; ++u) {
              in[u] = q + u < sn && sorted[s0 + q + u] >> RANK_BITS == lowbits;
              if (in[u]) load_chunk<CW, true, false>(pr[u], prod + (q + u) * CW,
                                                     CW);
            }
#pragma unroll
            for (int u = 0; u < SUM_AHEAD; ++u)
              if (in[u]) {
#pragma unroll
                for (int x = 0; x < CW; ++x)
                  if (x < cols) acc[x] = __fadd_rn(acc[x], pr[u][x]);
              }
            if (!in[SUM_AHEAD - 1]) break;
          }
          store_chunk<CW, VEC>(z, acc, cols);
        }
        __syncthreads();          // prod reused; Z's pieces in order
      }
    }
  }
}

// the ceiling probe: one lane a row, its row_floats / 4 float4 read and
// summed in column order (4 bytes written a row)
__global__ void __launch_bounds__(NT)
row_gather(const float4* __restrict__ src, const int* __restrict__ idx,
           float* __restrict__ out, long long count, int vecs) {
  const long long i = static_cast<long long>(blockIdx.x) * NT + threadIdx.x;
  if (i >= count) return;
  const float4* s = src + static_cast<size_t>(__ldg(idx + i)) * vecs;
  float acc = 0.f;
  for (int v = 0; v < vecs; ++v) {
    const float4 t = __ldg(s + v);
    acc = __fadd_rn(__fadd_rn(__fadd_rn(__fadd_rn(acc, t.x), t.y), t.z), t.w);
  }
  out[i] = acc;
}

// ---------------------------------------------------------------------------
// dispatch
// ---------------------------------------------------------------------------

int sm_count() {
  static int n = 0;
  if (n == 0) {
    int d = 0;
    cudaGetDevice(&d);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, d);
    if (n <= 0) n = 132;
  }
  return n;
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

long long lanes_per(long long k, int cw) { return (k + cw - 1) / cw; }

template <typename V, int CW, int U, bool VEC, bool WIDE>
void matmat_launch(const void* off, const void* col, const void* val,
                   const void* Q, void* Y, long long rows, long long k,
                   int round_out, cudaStream_t s) {
  const long long G = lanes_per(k, CW), tasks = rows * G;
  const long long cap = static_cast<long long>(sm_count()) * WAVES;
  const unsigned grid =
      static_cast<unsigned>(std::min((tasks + NT - 1) / NT, cap));
  csr_matmat<V, CW, U, VEC, WIDE><<<grid, NT, 0, s>>>(
      static_cast<const int*>(off), static_cast<const int*>(col),
      static_cast<const V*>(val), static_cast<const float*>(Q),
      static_cast<float*>(Y), tasks, static_cast<int>(k),
      static_cast<int>(G), round_out);
}

// a lane a column (CW = 1, scalar loads); U nonzeros ahead by the values'
// type
template <typename V, int U>
void matmat_v(const void* off, const void* col, const void* val,
              const void* Q, void* Y, long long rows, long long n,
              long long k, int round_out, cudaStream_t s) {
  if (n * k >= (1LL << 31) || rows * k >= (1LL << 31))
    matmat_launch<V, 1, U, false, true>(off, col, val, Q, Y, rows, k,
                                        round_out, s);
  else
    matmat_launch<V, 1, U, false, false>(off, col, val, Q, Y, rows, k,
                                         round_out, s);
}

template <int CW, int U, bool VEC, bool WIDE>
void runs_launch(const unsigned* skey, const u64* rec, const int* starts,
                 const int* count, const void* Y, void* Z, long long nnz,
                 long long k, cudaStream_t s) {
  const long long G = lanes_per(k, CW);
  const unsigned grid = static_cast<unsigned>((nnz * G + NT - 1) / NT);
  csr_runs<CW, U, VEC, WIDE><<<grid, NT, 0, s>>>(
      skey, rec, starts, count, static_cast<const float*>(Y),
      static_cast<float*>(Z), static_cast<int>(nnz), static_cast<int>(k),
      static_cast<int>(G));
}

template <int CW, int U>
void runs_layout(const unsigned* skey, const u64* rec, const int* starts,
                 const int* count, const void* Y, void* Z, long long rows,
                 long long nnz, long long n, long long k, cudaStream_t s) {
  const bool vec = CW % 4 == 0 && k % 4 == 0 && aligned16(Y) && aligned16(Z);
  const bool wide = n * k >= (1LL << 31) || rows * k >= (1LL << 31);
  if (vec && !wide)
    runs_launch<CW, U, true, false>(skey, rec, starts, count, Y, Z, nnz, k,
                                    s);
  else if (vec)
    runs_launch<CW, U, true, true>(skey, rec, starts, count, Y, Z, nnz, k, s);
  else if (!wide)
    runs_launch<CW, U, false, false>(skey, rec, starts, count, Y, Z, nnz, k,
                                     s);
  else
    runs_launch<CW, U, false, true>(skey, rec, starts, count, Y, Z, nnz, k,
                                    s);
}

// step 6 is rare (skewed columns): one instance a index width, 64-bit sort
// keys (any low bits), scalar loads
template <bool WIDE>
cudaError_t big_launch(const unsigned* skey, const u64* rec,
                       const int* bounds, const void* Y, void* Z, long long k,
                       int low, unsigned buckets, cudaStream_t s) {
  const size_t smem = prod_at<u64>() + SUB * 8 * sizeof(float);
  const cudaError_t e = cudaFuncSetAttribute(    // above 48 KB: dynamic
      csr_big_buckets<u64, 8, false, WIDE>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  csr_big_buckets<u64, 8, false, WIDE><<<buckets, BT, smem, s>>>(
      skey, rec, bounds, static_cast<const float*>(Y), static_cast<float*>(Z),
      static_cast<int>(k), low);
  return cudaSuccess;
}

template <typename K>
cudaError_t bucket_sort_launch(unsigned* skey, const u64* rec_from,
                               u64* rec_to, const int* bounds, int* starts,
                               int* count, int low, unsigned buckets,
                               cudaStream_t s) {
  const size_t smem = chunk_smem<K>();
  const cudaError_t e = cudaFuncSetAttribute(
      csr_bucket_sort<K>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (e != cudaSuccess) return e;
  csr_bucket_sort<K><<<buckets, BT, smem, s>>>(skey, rec_from, rec_to,
                                               bounds, starts, count, low);
  return cudaSuccess;
}

// the stable radix sort of (column, record) pairs on key bits [lo, hi)
cudaError_t sort_records(void* temp, size_t& temp_bytes, const void* col,
                         unsigned* skey, const u64* rec_in, u64* rec_out,
                         long long nnz, int lo, int hi, cudaStream_t s) {
  return cub::DeviceRadixSort::SortPairs(
      temp, temp_bytes, static_cast<const unsigned*>(col), skey, rec_in,
      rec_out, static_cast<int>(nnz), lo, hi, s);
}

}  // namespace

extern "C" int repro_csr_matmat(const void* off, const void* col,
                                const void* val, int val_bf16, const void* Q,
                                void* Y, long long rows, long long n,
                                long long k, int round_out, void* stream) {
  cudaGetLastError();  // report this call's launches, not an older error
  if (rows <= 0 || k <= 0) return 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (val_bf16)
    matmat_v<__nv_bfloat16, 4>(off, col, val, Q, Y, rows, n, k, round_out, s);
  else
    matmat_v<float, 8>(off, col, val, Q, Y, rows, n, k, round_out, s);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_csr_sort_bytes(long long nnz, int bits, int low,
                                    unsigned long long* bytes) {
  if (nnz > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  size_t b = 0;
  const cudaError_t e =
      low < bits ? sort_records(nullptr, b, nullptr, nullptr, nullptr,
                                nullptr, nnz, low, bits, 0)
                 : cudaSuccess;
  *bytes = b;
  return static_cast<int>(e);
}

extern "C" int repro_csr_bucket_cap() { return CAP; }

extern "C" int repro_csr_rmatmat(
    const void* off, const void* col, const void* val, int val_bf16,
    const void* Y, void* Z, long long rows, long long nnz, long long n,
    long long k, int bits, int low, void* skey, void* rec_in, void* rec_out,
    void* starts, void* count, void* bucket_bounds, void* temp,
    unsigned long long temp_bytes, int phases, void* stream) {
  cudaGetLastError();
  if (rows <= 0 || nnz <= 0 || k <= 0) return 0;
  if (nnz > INT_MAX || rows > INT_MAX || bits < 1 || bits > 31 || low < 1 ||
      low > bits || bits - low > 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  unsigned* sk = static_cast<unsigned*>(skey);
  u64* ri = static_cast<u64*>(rec_in);
  u64* ro = static_cast<u64*>(rec_out);
  int* st = static_cast<int*>(starts);
  int* cnt = static_cast<int*>(count);
  // the partition is on the top bits [low, bits) only; with none (one
  // bucket), the bucket sort works on the records in place
  const int buckets = 1 << (bits - low);
  int* bounds = static_cast<int*>(bucket_bounds);
  if (phases & 1) {
    const unsigned rgrid = static_cast<unsigned>((rows * 32 + NT - 1) / NT);
    const bool part = low < bits;
    u64* rt = part ? ri : ro;      // the records, in stream order
    if (val_bf16)
      csr_records<__nv_bfloat16><<<rgrid, NT, 0, s>>>(
          static_cast<const int*>(off),
          static_cast<const __nv_bfloat16*>(val), rt, static_cast<int>(rows));
    else
      csr_records<float><<<rgrid, NT, 0, s>>>(
          static_cast<const int*>(off), static_cast<const float*>(val), rt,
          static_cast<int>(rows));
    if (part) {
      size_t tb = temp_bytes;
      const cudaError_t e = sort_records(temp, tb, col, sk, ri, ro, nnz, low,
                                         bits, s);
      if (e != cudaSuccess) return static_cast<int>(e);
    } else {
      cudaMemcpyAsync(sk, col, nnz * sizeof(unsigned),
                      cudaMemcpyDeviceToDevice, s);
    }
    cudaMemsetAsync(cnt, 0, sizeof(int), s);
    csr_bucket_bounds<<<static_cast<unsigned>((nnz + NT) / NT), NT, 0, s>>>(
        sk, bounds, static_cast<int>(nnz), low, buckets);
    const cudaError_t e =
        low + RANK_BITS <= 32
            ? bucket_sort_launch<unsigned>(sk, ro, ri, bounds, st, cnt, low,
                                           buckets, s)
            : bucket_sort_launch<u64>(sk, ro, ri, bounds, st, cnt, low,
                                      buckets, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  if (phases & 2) {
    // the sorted records are in rec_in, but those of buckets above CAP,
    // left in rec_out for step 6
    runs_layout<8, 4>(sk, ri, st, cnt, Y, Z, rows, nnz, n, k, s);
    const cudaError_t e =
        n * k >= (1LL << 31) || rows * k >= (1LL << 31)
            ? big_launch<true>(sk, ro, bounds, Y, Z, k, low, buckets, s)
            : big_launch<false>(sk, ro, bounds, Y, Z, k, low, buckets, s);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_row_gather(const void* src, const void* idx, void* out,
                                long long count, long long row_floats,
                                void* stream) {
  cudaGetLastError();
  if (count <= 0) return 0;
  if (row_floats % 4 != 0 || !aligned16(src))
    return static_cast<int>(cudaErrorInvalidValue);
  row_gather<<<static_cast<unsigned>((count + NT - 1) / NT), NT, 0,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(src), static_cast<const int*>(idx),
      static_cast<float*>(out), count, static_cast<int>(row_floats / 4));
  return static_cast<int>(cudaGetLastError());
}
