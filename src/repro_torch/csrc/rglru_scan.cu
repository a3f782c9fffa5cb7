// RG-LRU's linear recurrence (recurrentgemma's recurrent block), written for
// Hopper (sm_90a).  All operands fp32, contiguous; a and b 16-byte
// aligned.
//
//   h_t = a_t * h_{t-1} + b_t  along t     a, b (B, T, R), h0 (B, R) or none
//                                          -> h (B, T, R); the last state h[:, T-1]
//
// Replaces no Pallas kernel.  The JAX package runs this recurrence as one
// jax.lax.associative_scan (src/repro/models/recurrent.py:65, _rglru_scan),
// which XLA compiles into one program on the device; PyTorch has no such
// operator, and a loop over t in Python costs T launches per op per layer
// (some 4096 x 26 a prefill of recurrentgemma-9b).  This kernel is that loop
// on the card, in one launch for any T >= 1: prefill and each decode step
// (T = 1) share its arithmetic.
//
// Bound on an H100 SXM (3.35 TB/s): 2 flops an element on 12 bytes (a and b
// read, h written), so bytes bound it: 0.120 ms at the prefill's
// (2, 4096, 4096).  The dependent chain is short (a product, then a sum:
// some 8 cycles a step), so what holds the loop is the bytes it keeps in
// flight (Little's law: 3.35 TB/s over 132 SMs at ~0.7 us a load needs
// ~18 KB an SM); 16 steps of loads a thread in registers kept 8 KB an SM
// in flight and ran at half the bound.  What the design does:
//   * One thread a channel r of one batch row b, the state in a register,
//     a loop over t; a block takes NC = 64 neighbouring channels of one
//     batch row (the 8192 channels of the prefill: 128 blocks).
//   * Tiles of U = 32 steps x the block's channels of a and b are staged by
//     cp.async into a shared ring of NS = 4 stages: three tiles (~52 KB)
//     are in flight while one is computed.  All 256 threads of the block
//     copy (16 a staged row), so the copies keep pace; the first 64 step
//     the channels.  Every copy moves 16 bytes, for any R: a staged row is
//     shifted by where its first channel lies in its 16-byte granule.
//   * Each step rounds the product, then the sum (__fmul_rn, __fadd_rn): the
//     plain version's two elementwise ops, so kernel and plain version agree
//     bit for bit (no FMA contraction), and reruns are bitwise.
//   * h is stored straight from the register: a warp's stores of a step
//     are one 128-byte line.
//
// The gradient (the training path), a second kernel in the same layout run
// backward in t: with g = dL/dh (B, T, R), from t = T - 1 down
//
//   d_t = g_t + a_{t+1} d_{t+1} (d_{T-1} = g_{T-1});  db_t = d_t;
//   da_t = d_t h_{t-1} (h0, or zeros, before step 0);  dh0 = a_0 d_0
//
// from the forward's a and h (saved by autograd: no recompute).  Bound:
// 20 bytes an element (g, a, h read; da, db written), 0.40 ms at a training
// step's (8, 2048, 4096).  Tiles of U steps of g, a and h are staged by
// cp.async from the END of the sequence, NSB = 3 deep (~78 KB); a thread
// keeps d and a_{t+1} in registers across tiles and reads h_{t-1} of a
// tile's first step from device memory (one load a tile, issued before the
// tile's steps).  d rounds as the plain reverse loop does (__fmul_rn, then
// __fadd_rn), so da, db and dh0 equal it bit for bit.
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_rglru_scan(a, b, h0, h, B, T, R, stream)
//   int repro_rglru_scan_bwd(g, a, h, h0, da, db, dh0, B, T, R, stream)
// h0 may be null (a zero state; then dh0 is not written and may be null).
// Each returns cudaGetLastError() after its launch (0 on success;
// cudaErrorMisalignedAddress where a staged operand -- a and b; g, a and
// h -- is not 16-byte aligned); neither allocates.

#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"

namespace {

using repro_hopper::cp_async;
using repro_hopper::cp_async_commit;
using repro_hopper::cp_async_wait_group;
using repro_hopper::smem_u32;

constexpr int NC = 64;         // channels a block (its first NC threads)
constexpr int NT = 256;        // threads a block: all of them copy
constexpr int NTP = NC + 4;    // floats a staged row: NC and the shift
constexpr int U = 32;          // steps a stage
constexpr int NS = 4;          // stages in the ring
constexpr size_t SMEM = sizeof(float) * NS * 2 * U * NTP;
static_assert(NC == 64 && NT % 16 == 0, "16 threads copy a staged row");

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// One 16-byte granule g of a staged row: bytes past the arrays' end
// (`left` floats from the granule's start) are not read.
__device__ __forceinline__ void copy_granule(float* row, const float* src,
                                             int g, int64_t left) {
  const int bytes = left <= 0 ? 0 : (left >= 4 ? 16 : (int)(4 * left));
  cp_async<16>(smem_u32(row + 4 * g), src + 4 * g, bytes);
}

// Steps [0, n) of the block's nr channels of a and b from element `off` into
// a stage (a: U rows of NTP floats, then b), 16 threads a row.  Row t
// starts at element p = off + t R, which lies p % 4 into its 16-byte
// granule: the row lands that far into its staged row, so the 16-byte
// copies of the granules covering it (16, or 17 where the shift pushes its
// end past the 16th) keep their alignment for any R.  A granule past the
// arrays' end (`total` elements) reads only what lies inside.
__device__ __forceinline__ void stage_tile(float* st,
                                           const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int64_t off, int64_t R, int nr,
                                           int n, int64_t total, int tid) {
  const int g = tid % 16;
  for (int row = tid / 16; row < 2 * n; row += NT / 16) {
    const int ab = row >= n;
    const int t = row - ab * n;
    const int64_t p = off + t * R;
    const int mis = (int)(p & 3);
    const int64_t first = p - mis;             // the row's first granule
    const float* src = (ab ? b : a) + first;
    float* dst = st + ab * U * NTP + t * NTP;
    if (4 * g < mis + nr) copy_granule(dst, src, g, total - first - 4 * g);
    if (g == 0 && 4 * 16 < mis + nr)
      copy_granule(dst, src, 16, total - first - 4 * 16);
  }
}

__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int64_t B, int64_t T, int64_t R) {
  extern __shared__ __align__(16) float ring[];   // [NS][2][U][NTP]
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * NC, bi = blockIdx.y;
  const int nr = (int)lmin(NC, R - r0);
  const int64_t base = bi * T * R + r0;          // (bi, 0, r0)
  const int64_t total = B * T * R;
  float s = (h0 != nullptr && tid < nr) ? h0[bi * R + r0 + tid] : 0.f;
  const int64_t tiles = (T + U - 1) / U;
#pragma unroll
  for (int p = 0; p < NS - 1; ++p) {
    if (p < tiles)
      stage_tile(ring + p * 2 * U * NTP, a, b, base + p * U * R, R, nr,
                 (int)lmin(U, T - p * U), total, tid);
    cp_async_commit();
  }
  const int step = (int)(R & 3);
  for (int64_t c = 0; c < tiles; ++c) {
    cp_async_wait_group<NS - 2>();
    __syncthreads();            // tile c visible; tile c - 1 done by all
    const int64_t next = c + NS - 1;
    if (next < tiles)
      stage_tile(ring + (next % NS) * 2 * U * NTP, a, b, base + next * U * R,
                 R, nr, (int)lmin(U, T - next * U), total, tid);
    cp_async_commit();
    if (tid < nr) {
      const float* as = ring + (c % NS) * 2 * U * NTP + tid;
      const float* bs = as + U * NTP;
      const int64_t off = base + c * U * R;
      const int n = (int)lmin(U, T - c * U);
      float* out = h + off + tid;
      int mis = (int)(off & 3);   // where row t starts in its staged row
#pragma unroll 8
      for (int t = 0; t < n; ++t) {
        const int o = t * NTP + mis;
        s = __fadd_rn(__fmul_rn(as[o], s), bs[o]);
        out[t * R] = s;
        mis = (mis + step) & 3;
      }
    }
  }
}

constexpr int NSB = 3;         // stages in the backward's ring (3 arrays)
constexpr size_t SMEM_BWD = sizeof(float) * NSB * 3 * U * NTP;

// stage_tile for the backward: steps [0, n) of g, a and h (three staged
// blocks of U rows) from element `off`, 16 threads a row.
__device__ __forceinline__ void stage_tile3(float* st,
                                            const float* __restrict__ g,
                                            const float* __restrict__ a,
                                            const float* __restrict__ h,
                                            int64_t off, int64_t R, int nr,
                                            int n, int64_t total, int tid) {
  const int gr = tid % 16;
  for (int row = tid / 16; row < 3 * n; row += NT / 16) {
    const int which = row / n;
    const int t = row - which * n;
    const int64_t p = off + t * R;
    const int mis = (int)(p & 3);
    const int64_t first = p - mis;
    const float* src = (which == 0 ? g : which == 1 ? a : h) + first;
    float* dst = st + which * U * NTP + t * NTP;
    if (4 * gr < mis + nr) copy_granule(dst, src, gr, total - first - 4 * gr);
    if (gr == 0 && 4 * 16 < mis + nr)
      copy_granule(dst, src, 16, total - first - 4 * 16);
  }
}

__global__ void __launch_bounds__(NT)
rglru_scan_bwd_kernel(const float* __restrict__ g,
                      const float* __restrict__ a,
                      const float* __restrict__ h,
                      const float* __restrict__ h0, float* __restrict__ da,
                      float* __restrict__ db, float* __restrict__ dh0,
                      int64_t B, int64_t T, int64_t R) {
  extern __shared__ __align__(16) float ring[];   // [NSB][3][U][NTP]
  const int tid = threadIdx.x;
  const int64_t r0 = (int64_t)blockIdx.x * NC, bi = blockIdx.y;
  const int nr = (int)lmin(NC, R - r0);
  const int64_t base = bi * T * R + r0;          // (bi, 0, r0)
  const int64_t total = B * T * R;
  const int64_t tiles = (T + U - 1) / U;
  // the p-th tile processed is tile tiles - 1 - p (steps from its U p)
#pragma unroll
  for (int p = 0; p < NSB - 1; ++p) {
    if (p < tiles) {
      const int64_t c = tiles - 1 - p;
      stage_tile3(ring + p * 3 * U * NTP, g, a, h, base + c * U * R, R, nr,
                  (int)lmin(U, T - c * U), total, tid);
    }
    cp_async_commit();
  }
  const int step = (int)(R & 3);
  float d = 0.f, anext = 0.f;
  bool started = false;
  for (int64_t p = 0; p < tiles; ++p) {
    cp_async_wait_group<NSB - 2>();
    __syncthreads();            // tile p visible; tile p - 1 done by all
    const int64_t next = p + NSB - 1;
    if (next < tiles) {
      const int64_t c = tiles - 1 - next;
      stage_tile3(ring + (next % NSB) * 3 * U * NTP, g, a, h,
                  base + c * U * R, R, nr, (int)lmin(U, T - c * U), total,
                  tid);
    }
    cp_async_commit();
    if (tid < nr) {
      const int64_t c = tiles - 1 - p;
      const float* gs = ring + (p % NSB) * 3 * U * NTP + tid;
      const float* as = gs + U * NTP;
      const float* hs = as + U * NTP;
      const int64_t off = base + c * U * R;
      const int n = (int)lmin(U, T - c * U);
      // h_{t-1} of the tile's first step: the last row of the tile before
      // it, or h0 (zeros without one)
      const float hfirst = c > 0 ? h[off - R + tid]
                           : (h0 != nullptr ? h0[bi * R + r0 + tid] : 0.f);
      const int mis0 = (int)(off & 3);
#pragma unroll 8
      for (int t = n - 1; t >= 0; --t) {
        const int o = t * NTP + ((mis0 + t * step) & 3);
        const float ad = __fmul_rn(anext, d);
        d = started ? __fadd_rn(gs[o], ad) : gs[o];
        started = true;
        db[off + t * R + tid] = d;
        const float hp =
            t > 0 ? hs[(t - 1) * NTP + ((mis0 + (t - 1) * step) & 3)] : hfirst;
        da[off + t * R + tid] = __fmul_rn(d, hp);
        anext = as[o];
      }
    }
  }
  if (h0 != nullptr && tid < nr) dh0[bi * R + r0 + tid] = __fmul_rn(anext, d);
}

// Raise a kernel's dynamic shared memory limit once a device.
template <typename K>
cudaError_t allow_smem(K kernel, size_t bytes, unsigned& done) {
  int dev = 0;
  cudaError_t e = cudaGetDevice(&dev);
  if (e == cudaSuccess && !(dev < 32 && (done >> dev & 1u))) {
    e = cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             (int)bytes);
    if (e == cudaSuccess && dev < 32) done |= 1u << dev;
  }
  return e;
}

}  // namespace

extern "C" int repro_rglru_scan_bwd(const void* g, const void* a,
                                    const void* h, const void* h0, void* da,
                                    void* db, void* dh0, long long B,
                                    long long T, long long R, void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  if (B * R == 0 || T == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(g) | reinterpret_cast<uintptr_t>(a) |
       reinterpret_cast<uintptr_t>(h)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static unsigned done = 0;   // devices whose shared memory limit is raised
  const cudaError_t e = allow_smem(rglru_scan_bwd_kernel, SMEM_BWD, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((unsigned)((R + NC - 1) / NC), (unsigned)B);
  rglru_scan_bwd_kernel<<<grid, NT, SMEM_BWD,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(g), static_cast<const float*>(a),
      static_cast<const float*>(h), static_cast<const float*>(h0),
      static_cast<float*>(da), static_cast<float*>(db),
      static_cast<float*>(dh0), B, T, R);
  return static_cast<int>(cudaGetLastError());
}

extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* h, long long B, long long T,
                                long long R, void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  if (B * R == 0 || T == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b)) % 16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  static unsigned done = 0;   // devices whose shared memory limit is raised
  const cudaError_t e = allow_smem(rglru_scan_kernel, SMEM, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid((unsigned)((R + NC - 1) / NC), (unsigned)B);
  rglru_scan_kernel<<<grid, NT, SMEM, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(a), static_cast<const float*>(b),
      static_cast<const float*>(h0), static_cast<float*>(h), B, T, R);
  return static_cast<int>(cudaGetLastError());
}
