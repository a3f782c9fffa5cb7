// RWKV-6's recurrence (rwkv6's time mix), written for Hopper (sm_90a).  All
// operands fp32, contiguous.
//
//   each step t:  o_t = r_t^T (S + u * (k_t v_t^T));  S <- w_t * S + k_t v_t^T
//   r, k, v, w (B, T, H, hd); u (H, hd); S0 (B, H, hd, hd) or none (zeros)
//   -> out (B, T, H, hd), S_T (B, H, hd, hd); S[i][j]: key index i, value j
//
// Replaces no Pallas kernel.  The JAX package runs this recurrence as one
// jax.lax.scan over time (src/repro/models/recurrent.py:177, _wkv_scan), which
// XLA compiles into one program on the device; in PyTorch the only
// counterpart is a loop in Python of some six launches a step (4096 x 24
// layers a prefill of rwkv6-1.6b).  This kernel is that loop on the card, one
// launch for any T >= 1: prefill and each decode step (T = 1) share its
// arithmetic.
//
// Bound on an H100 SXM (3.35 TB/s, 67 TFLOP/s fp32): 20 bytes an element of
// (B, T, H, hd) (r, k, v, w read, out written) against about 5 hd flops an
// element (the output's and the state's multiply-adds, the outer product):
// bytes bound it, 0.100 ms at the prefill's (2, 4096, 32, 64).  What the
// design does (the layout of the public RWKV-LM wkv6 CUDA kernel):
//   * One block a (b, h), one thread a value column j, holding the state's
//     column S[:, j] (hd floats) in registers for the whole sequence: the
//     state never touches device memory between steps.
//   * r_t, k_t and w_t are broadcast through shared memory (each thread
//     loads one element of each, reads all hd as 16-byte vectors); every
//     thread sums its own o_t[j] over i, so no reduction crosses threads.
//   * Two shared buffers, one __syncthreads a step; the next step's four
//     loads start before this step's arithmetic.
//   * The state update and the bonus term round as the plain version's
//     elementwise ops (__fmul_rn, __fadd_rn: k v rounded, u (k v) rounded,
//     w S rounded, then each sum), so S_T equals it bit for bit; only o's sum
//     over i (an FMA chain in order of i) differs from its einsum.
// B x H = 64 blocks of 64 threads leave most of the card idle; a chunked
// form (GLA-style: intra-chunk products on the tensor cores, the state
// carried between chunks) is the later redesign.
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_wkv6(r, k, v, w, u, S0, out, S_T, B, T, H, hd, stream)
// hd is one of 16, 32, 64, 128; S0 may be null.  Returns cudaGetLastError()
// after the launch (0 on success, cudaErrorInvalidValue for another hd);
// allocates nothing.

#include <cuda_runtime.h>

#include <stdint.h>

namespace {

template <int HD>
__global__ void __launch_bounds__(HD)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ S0,
            float* __restrict__ out, float* __restrict__ ST, int64_t T,
            int H) {
  __shared__ __align__(16) float rs[2][HD];
  __shared__ __align__(16) float ks[2][HD];
  __shared__ __align__(16) float ws[2][HD];
  __shared__ __align__(16) float us[HD];
  const int64_t bh = blockIdx.x;          // b * H + h
  const int hh = (int)(bh % H);
  const int64_t bi = bh / H;
  const int j = threadIdx.x;
  const int64_t ld = (int64_t)H * HD;     // one step of (B, T, H, hd)
  const int64_t base = (bi * T * H + hh) * HD + j;

  float S[HD];
  const float* s0 = S0 != nullptr ? S0 + bh * HD * HD + j : nullptr;
#pragma unroll
  for (int i = 0; i < HD; ++i) S[i] = s0 != nullptr ? s0[i * HD] : 0.f;
  us[j] = u[hh * HD + j];

  float rn = __ldg(r + base), kn = __ldg(k + base), wn = __ldg(w + base),
        vn = __ldg(v + base);
  for (int64_t t = 0; t < T; ++t) {
    const int buf = (int)(t & 1);
    rs[buf][j] = rn;
    ks[buf][j] = kn;
    ws[buf][j] = wn;
    const float vj = vn;
    __syncthreads();
    if (t + 1 < T) {
      const int64_t o = base + (t + 1) * ld;
      rn = __ldg(r + o);
      kn = __ldg(k + o);
      wn = __ldg(w + o);
      vn = __ldg(v + o);
    }
    const float4* r4 = reinterpret_cast<const float4*>(rs[buf]);
    const float4* k4 = reinterpret_cast<const float4*>(ks[buf]);
    const float4* w4 = reinterpret_cast<const float4*>(ws[buf]);
    const float4* u4 = reinterpret_cast<const float4*>(us);
    float acc = 0.f;
#pragma unroll
    for (int q = 0; q < HD / 4; ++q) {
      const float4 rq = r4[q], kq = k4[q], wq = w4[q], uq = u4[q];
      const float rr[4] = {rq.x, rq.y, rq.z, rq.w};
      const float kk[4] = {kq.x, kq.y, kq.z, kq.w};
      const float ww[4] = {wq.x, wq.y, wq.z, wq.w};
      const float uu[4] = {uq.x, uq.y, uq.z, uq.w};
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int i = 4 * q + e;
        const float kv = __fmul_rn(kk[e], vj);
        acc = fmaf(rr[e], __fadd_rn(S[i], __fmul_rn(uu[e], kv)), acc);
        S[i] = __fadd_rn(__fmul_rn(ww[e], S[i]), kv);
      }
    }
    out[base + t * ld] = acc;
  }
  float* st = ST + bh * HD * HD + j;
#pragma unroll
  for (int i = 0; i < HD; ++i) st[i * HD] = S[i];
}

template <int HD>
void launch(const float* r, const float* k, const float* v, const float* w,
            const float* u, const float* S0, float* out, float* ST,
            int64_t B, int64_t T, int H, cudaStream_t s) {
  wkv6_kernel<HD><<<(unsigned)(B * H), HD, 0, s>>>(r, k, v, w, u, S0, out,
                                                    ST, T, H);
}

}  // namespace

extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* S0,
                          void* out, void* ST, long long B, long long T,
                          long long H, long long hd, void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  if (B * H == 0 || T == 0) return 0;
  const auto* r_ = static_cast<const float*>(r);
  const auto* k_ = static_cast<const float*>(k);
  const auto* v_ = static_cast<const float*>(v);
  const auto* w_ = static_cast<const float*>(w);
  const auto* u_ = static_cast<const float*>(u);
  const auto* s0 = static_cast<const float*>(S0);
  auto* o_ = static_cast<float*>(out);
  auto* st = static_cast<float*>(ST);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: launch<16>(r_, k_, v_, w_, u_, s0, o_, st, B, T, (int)H, s); break;
    case 32: launch<32>(r_, k_, v_, w_, u_, s0, o_, st, B, T, (int)H, s); break;
    case 64: launch<64>(r_, k_, v_, w_, u_, s0, o_, st, B, T, (int)H, s); break;
    case 128: launch<128>(r_, k_, v_, w_, u_, s0, o_, st, B, T, (int)H, s);
      break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
