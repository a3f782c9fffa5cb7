// Causal sliding-window (local) attention with GQA and optional logit
// soft-capping, written for Hopper (sm_90a).  It is the prefill attention of
// every attention layer of the LM serving path (window >= S for the global
// layers, which is plain causal attention).
//
//   o[b, h, i] = sum_j p_ij v[b, h / group, j],   over  i - window < j <= i,
//   p_i. = softmax_j(cap(q[b, h, i] . k[b, h / group, j] / sqrt(D)))
//   cap(s) = tanh(s / softcap) * softcap  (softcap > 0), else s
//
// q (B, H, S, D), k and v (B, Hkv, S, D), o (B, H, S, D), all addressed by
// element strides (b, h, s) with unit stride along D, so the model's
// (B, S, H, D) projections are read as (B, H, S, D) views without a copy.
// fp32 or bf16 in (q, k, v and o share one type); every sum is fp32.
//
// Replaces the Pallas TPU kernel of src/repro/kernels/local_attn.py:
// local_attention (pallas_call at :104), and computes what its body computes
// (:27-76): scale 1/sqrt(D) on the fp32 score, the soft-cap after the scale,
// mask kpos <= qpos and kpos > qpos - window with -1e30, running max,
// denominator and accumulator in fp32, output acc / max(l, 1e-30) in q's type.
// Keys outside a row's window take p = 0 exactly (the TPU kernel reaches the
// same value through exp(-1e30 - m)).
//
// Bound on an H100 SXM: 4 D flop per live (query, key) pair on 2 B S D
// (H + Hkv) bytes, i.e. hundreds of flop a byte at D = 256 and window 4096:
// the arithmetic bounds it (0.83 ms a local layer of gemma2-9b at B = 2,
// S = 8192 on the bf16 tensor cores; the bytes take ~0.12 ms).  This first
// version does every product as an fp32 FFMA (67 TFLOP/s, never TF32), so its
// own ceiling is about 15x that bound.  What the design does:
//   * One block of 256 threads per (64-row query tile, head, batch) owns its
//     output rows and loops over the key tiles inside the block, visiting only
//     the live ones, from max(0, q_lo - window + 1) to q_hi: O(S w) work, no
//     atomics, no cross-block sum, so reruns are bitwise equal.  The heaviest
//     query tiles (the last ones under a causal mask) are launched first.
//   * GQA by index: the block of head h reads K/V head h / group; nothing is
//     repeated in memory.
//   * Q, K and V tiles are staged into shared memory as fp32 (bf16 widened on
//     the way, 16-byte global loads).  Thread (ty, tx) of the 16 x 16 grid
//     owns query rows 4 ty .. 4 ty + 3 and keys tx + 16 c (c < 4) of the score
//     tile: 64 FFMA per 8 float4 shared-memory loads; the row stride D + 4
//     keeps a quarter-warp's key rows on distinct banks.  Row max and row sum
//     of the online softmax are butterfly shuffles over the 16 lanes of a row
//     (every lane ends with the same bits).  P goes to shared memory
//     transposed, and each thread accumulates its 4 rows x D/16 output columns
//     (4-wide chunks 64 columns apart) in registers.
//   * D is a template parameter, D in {16, 32, 64, 128, 256}; at D = 256 the
//     tiles take 216,064 bytes of dynamic shared memory (one block per SM),
//     granted by cudaFuncSetAttribute before the launch.
//   * Ragged S: rows and keys at or past S are staged as zeros, masked, and
//     never written; nothing is padded in memory.
//
// Later work (not here): mma.sync / wgmma on bf16 with fp32 sums, TMA staging
// of the next key tile while the current one is summed, two blocks per SM.
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_local_attention(q, k, v, o, B, H, Hkv, S, D, strides[12],
//                             window, scale, softcap, is_bf16, stream)
// strides: (b, h, s) of q, k, v, o in elements.  Returns cudaGetLastError()
// after the launch (0 on success), or cudaErrorInvalidValue for a D outside
// the template; allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;      // threads per block, 16 x 16
constexpr int BQ = 64;       // query rows per block: 16 ty x 4
constexpr int BK = 64;       // keys per tile: 16 tx x 4
constexpr int PAD = 4;       // row pad of the Q and K tiles (floats)
constexpr int PT = BQ + 4;   // row stride of the transposed P tile
constexpr float NEG = -1e30f;

struct Strides {
  long long b, h, s;
};

template <int D>
constexpr size_t smem_bytes() {
  return sizeof(float) * (static_cast<size_t>(BQ) * (D + PAD) +
                          static_cast<size_t>(BK) * (D + PAD) +
                          static_cast<size_t>(BK) * D +
                          static_cast<size_t>(BK) * PT);
}

// 16 bytes of the input type, widened to fp32 into shared memory.
__device__ __forceinline__ void widen_store(float* dst, const uint4& u,
                                            float) {
  *reinterpret_cast<float4*>(dst) =
      make_float4(__uint_as_float(u.x), __uint_as_float(u.y),
                  __uint_as_float(u.z), __uint_as_float(u.w));
}
// bf16 is the upper half of an fp32: element 2i is the low half-word.
__device__ __forceinline__ void widen_store(float* dst, const uint4& u,
                                            __nv_bfloat16) {
  *reinterpret_cast<float4*>(dst) = make_float4(
      __uint_as_float(u.x << 16), __uint_as_float(u.x & 0xffff0000u),
      __uint_as_float(u.y << 16), __uint_as_float(u.y & 0xffff0000u));
  *reinterpret_cast<float4*>(dst + 4) = make_float4(
      __uint_as_float(u.z << 16), __uint_as_float(u.z & 0xffff0000u),
      __uint_as_float(u.w << 16), __uint_as_float(u.w & 0xffff0000u));
}

__device__ __forceinline__ void narrow_store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void narrow_store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
}

// Rows r0 .. r0 + 63 of one (b, h) slice (row stride ss) into a shared tile
// of row stride LD; rows at or past S are zeros.
template <typename T, int D, int LD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long ss, int r0, int S) {
  constexpr int E = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int PER_ROW = D / E;
  constexpr int TOTAL = 64 * PER_ROW;
#pragma unroll
  for (int i = 0; i < (TOTAL + NT - 1) / NT; ++i) {
    const int t = threadIdx.x + i * NT;
    if (TOTAL % NT == 0 || t < TOTAL) {
      const int r = t / PER_ROW, c = (t % PER_ROW) * E;
      uint4 u = make_uint4(0u, 0u, 0u, 0u);
      if (r0 + r < S)
        u = *reinterpret_cast<const uint4*>(
            src + static_cast<long long>(r0 + r) * ss + c);
      widen_store(dst + r * LD + c, u, T());
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    local_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o, Strides sq,
                      Strides sk, Strides sv, Strides so, int S, int group,
                      int window, float scale, float softcap) {
  constexpr int LQ = D + PAD;
  constexpr int W = D >= 64 ? 4 : D / 16;   // consecutive output columns
  constexpr int NC = D / (16 * W);          // chunks of W, 16 W apart
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                          // [BQ][LQ]
  float* Ks = Qs + BQ * LQ;                  // [BK][LQ]
  float* Vs = Ks + BK * LQ;                  // [BK][D]
  float* Ps = Vs + BK * D;                   // [BK][PT], P transposed

  const int qt = gridDim.x - 1 - blockIdx.x;    // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q_lo = qt * BQ;
  const int q_hi = min(q_lo + BQ, S) - 1;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;

  const T* qb = q + b * sq.b + h * sq.h;
  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  stage<T, D, LQ>(Qs, qb, sq.s, q_lo, S);

  float acc[4][NC * W];
  float m[4], l[4];
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    m[r] = NEG;
    l[r] = 0.0f;
#pragma unroll
    for (int x = 0; x < NC * W; ++x) acc[r][x] = 0.0f;
  }

  const int t_first = max(0, q_lo - window + 1) / BK;
  const int t_last = q_hi / BK;
  for (int t = t_first; t <= t_last; ++t) {
    const int k0 = t * BK;
    __syncthreads();              // the previous tile's K, V and P are read
    stage<T, D, LQ>(Ks, kb, sk.s, k0, S);
    stage<T, D, D>(Vs, vb, sv.s, k0, S);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[r][c] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < D; d += 4) {
      float4 qa[4], ka[4];
#pragma unroll
      for (int r = 0; r < 4; ++r)
        qa[r] = *reinterpret_cast<const float4*>(&Qs[(ty * 4 + r) * LQ + d]);
#pragma unroll
      for (int c = 0; c < 4; ++c)
        ka[c] = *reinterpret_cast<const float4*>(&Ks[(tx + 16 * c) * LQ + d]);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          s[r][c] = fmaf(qa[r].x, ka[c].x, s[r][c]);
          s[r][c] = fmaf(qa[r].y, ka[c].y, s[r][c]);
          s[r][c] = fmaf(qa[r].z, ka[c].z, s[r][c]);
          s[r][c] = fmaf(qa[r].w, ka[c].w, s[r][c]);
        }
    }

    float alpha[4];
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int qi = q_lo + ty * 4 + r;
      bool live[4];
      float mx = NEG;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int kj = k0 + tx + 16 * c;
        float x = s[r][c] * scale;
        if (softcap > 0.0f) x = tanhf(x / softcap) * softcap;
        live[c] = kj <= qi && kj > qi - window;
        s[r][c] = live[c] ? x : NEG;
        mx = fmaxf(mx, s[r][c]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
      const float m_new = fmaxf(m[r], mx);
      alpha[r] = expf(m[r] - m_new);
      float rs = 0.0f;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        s[r][c] = live[c] ? expf(s[r][c] - m_new) : 0.0f;
        rs += s[r][c];
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        rs += __shfl_xor_sync(0xffffffffu, rs, off);
      l[r] = l[r] * alpha[r] + rs;
      m[r] = m_new;
    }
#pragma unroll
    for (int c = 0; c < 4; ++c)
      *reinterpret_cast<float4*>(&Ps[(tx + 16 * c) * PT + ty * 4]) =
          make_float4(s[0][c], s[1][c], s[2][c], s[3][c]);
#pragma unroll
    for (int r = 0; r < 4; ++r)
#pragma unroll
      for (int x = 0; x < NC * W; ++x) acc[r][x] *= alpha[r];
    __syncthreads();

#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 p = *reinterpret_cast<const float4*>(&Ps[j * PT + ty * 4]);
      const float pr[4] = {p.x, p.y, p.z, p.w};
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const float* vr = &Vs[j * D + cc * 16 * W + tx * W];
        float vv[W];
        if constexpr (W == 4) {
          const float4 t4 = *reinterpret_cast<const float4*>(vr);
          vv[0] = t4.x, vv[1] = t4.y, vv[2] = t4.z, vv[3] = t4.w;
        } else if constexpr (W == 2) {
          const float2 t2 = *reinterpret_cast<const float2*>(vr);
          vv[0] = t2.x, vv[1] = t2.y;
        } else {
          vv[0] = vr[0];
        }
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int w = 0; w < W; ++w)
            acc[r][cc * W + w] = fmaf(pr[r], vv[w], acc[r][cc * W + w]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int qi = q_lo + ty * 4 + r;
    if (qi >= S) continue;
    const float inv = 1.0f / fmaxf(l[r], 1e-30f);
    T* orow = o + b * so.b + h * so.h + static_cast<long long>(qi) * so.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int w = 0; w < W; ++w)
        narrow_store(orow + cc * 16 * W + tx * W + w, acc[r][cc * W + w] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, int B, int H,
           int Hkv, int S, const long long* st, int window, float scale,
           float softcap, cudaStream_t stream) {
  auto kern = local_attn_kernel<T, D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o),
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, S,
      H / Hkv, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int B,
             int H, int Hkv, int S, int D, const long long* st, int window,
             float scale, float softcap, cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, B, H, Hkv, S, st, window, scale,
                           softcap, s);
    case 32:
      return launch<T, 32>(q, k, v, o, B, H, Hkv, S, st, window, scale,
                           softcap, s);
    case 64:
      return launch<T, 64>(q, k, v, o, B, H, Hkv, S, st, window, scale,
                           softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, o, B, H, Hkv, S, st, window, scale,
                            softcap, s);
    case 256:
      return launch<T, 256>(q, k, v, o, B, H, Hkv, S, st, window, scale,
                            softcap, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_local_attention(const void* q, const void* k,
                                     const void* v, void* o, long long B,
                                     long long H, long long Hkv, long long S,
                                     long long D, const long long* strides,
                                     long long window, float scale,
                                     float softcap, int is_bf16,
                                     void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(window < S ? window : S);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, (int)B, (int)H, (int)Hkv,
                                   (int)S, (int)D, strides, w, scale, softcap,
                                   s);
  return dispatch<float>(q, k, v, o, (int)B, (int)H, (int)Hkv, (int)S, (int)D,
                         strides, w, scale, softcap, s);
}
