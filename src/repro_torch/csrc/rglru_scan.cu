// RG-LRU's linear recurrence (recurrentgemma's recurrent block), written for
// Hopper (sm_90a).  All operands fp32, contiguous.
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
// (2, 4096, 4096).  What the design does:
//   * One thread a channel (b, r), the state in a register, a loop over t.
//     Neighbouring threads take neighbouring r, so every load and store of
//     a warp is one 128-byte line.  Blocks of 64 threads spread the 8192
//     channels of the prefill over 128 SMs.
//   * The loop is latency-bound (each step's product needs the last step's
//     state), so the loads run ahead of the dependent arithmetic: a chunk of
//     U steps of a and b is loaded into registers while the chunk before it
//     is computed.
//   * Each step rounds the product, then the sum (__fmul_rn, __fadd_rn): the
//     plain version's two elementwise ops, so kernel and plain version agree
//     bit for bit (no FMA contraction).
// B x R = 8192 channels leave most of the card's threads idle; a chunked
// two-pass scan (chunk states, then a carry-in pass) is the later redesign.
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_rglru_scan(a, b, h0, h, B, T, R, stream)
// h0 may be null (a zero state).  Returns cudaGetLastError() after the
// launch (0 on success); allocates nothing.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

constexpr int NT = 64;   // channels (threads) a block
constexpr int U = 16;    // steps a chunk: the loads in flight per thread

__device__ __forceinline__ void load_chunk(const float* __restrict__ a,
                                           const float* __restrict__ b,
                                           int64_t off, int64_t R,
                                           float (&av)[U], float (&bv)[U]) {
#pragma unroll
  for (int j = 0; j < U; ++j) {
    av[j] = __ldg(a + off + j * R);
    bv[j] = __ldg(b + off + j * R);
  }
}

__global__ void __launch_bounds__(NT)
rglru_scan_kernel(const float* __restrict__ a, const float* __restrict__ b,
                  const float* __restrict__ h0, float* __restrict__ h,
                  int64_t B, int64_t T, int64_t R) {
  const int64_t c = (int64_t)blockIdx.x * NT + threadIdx.x;  // b * R + r
  if (c >= B * R) return;
  const int64_t bi = c / R;
  const int64_t base = bi * T * R + (c - bi * R);            // (bi, 0, r)
  float s = h0 != nullptr ? h0[c] : 0.f;
  const int64_t whole = T / U * U;
  float av[U], bv[U], an[U], bn[U];
  if (whole > 0) load_chunk(a, b, base, R, av, bv);
  for (int64_t t = 0; t < whole; t += U) {
    if (t + U < whole) load_chunk(a, b, base + (t + U) * R, R, an, bn);
#pragma unroll
    for (int j = 0; j < U; ++j) {
      s = __fadd_rn(__fmul_rn(av[j], s), bv[j]);
      h[base + (t + j) * R] = s;
    }
#pragma unroll
    for (int j = 0; j < U; ++j) {
      av[j] = an[j];
      bv[j] = bn[j];
    }
  }
  for (int64_t t = whole; t < T; ++t) {
    const int64_t o = base + t * R;
    s = __fadd_rn(__fmul_rn(__ldg(a + o), s), __ldg(b + o));
    h[o] = s;
  }
}

}  // namespace

extern "C" int repro_rglru_scan(const void* a, const void* b, const void* h0,
                                void* h, long long B, long long T,
                                long long R, void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  const int64_t channels = (int64_t)B * R;
  if (channels > 0 && T > 0) {
    const unsigned blocks = (unsigned)((channels + NT - 1) / NT);
    rglru_scan_kernel<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
        static_cast<const float*>(a), static_cast<const float*>(b),
        static_cast<const float*>(h0), static_cast<float*>(h), B, T, R);
  }
  return static_cast<int>(cudaGetLastError());
}
