// The second pass of block_rmatvec's split reduction, shared by its
// kernels (block_matvec_tc.cu: bf16; block_matvec_tf32.cu: fp32): each slab
// of rows wrote fp32 partials of Z, and this sums them in slab order.  No
// atomics: the order is fixed, so every rerun is bitwise equal.

#pragma once

#include <cuda_runtime.h>

#include <stdint.h>

namespace repro_slab_sum {

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

// Launch the sum of `slabs` partials of `count` floats each on stream `s`.
inline void sum_slabs(const float* P, float* Z, int64_t count, int slabs,
                      cudaStream_t s) {
  constexpr int threads = 256;
  const int64_t want = (count + threads - 1) / threads;
  const int blocks = static_cast<int>(want < 4096 ? want : 4096);
  sum_slabs_kernel<<<blocks, threads, 0, s>>>(P, Z, count, slabs);
}

}  // namespace repro_slab_sum
