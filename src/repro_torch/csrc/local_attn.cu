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
// (:27-76): the score in fp32 from q and k widened to fp32, scale 1/sqrt(D),
// the soft-cap after the scale, mask kpos <= qpos and kpos > qpos - window,
// running max, denominator and accumulator in fp32, fp32 probabilities times
// v widened to fp32, output acc / max(l, 1e-30) in q's type.  Keys outside a
// row's window take p = 0 exactly (the TPU kernel reaches the same value
// through exp(-1e30 - m)).
//
// Bound on an H100 SXM: 4 D flop per live (query, key) pair on 2 B S D
// (H + Hkv) bytes, i.e. hundreds of flop a byte at D = 256 and window 4096:
// the arithmetic bounds it (0.83 ms a local layer of gemma2-9b at B = 2,
// S = 8192 on the bf16 tensor cores; the bytes take ~0.12 ms).  Beside it,
// not a bound: one exp a live pair on the special-function unit (~4e12 a
// second), and the soft-cap's polynomial on the FMA pipes.
//
// Two routes, one C entry point each; the caller (kernels/local_attn.py,
// route()) picks one and neither stands in for the other:
//
// * repro_local_attention_wgmma: bf16 at D in {64, 128, 256}, the head dims
//   of the configured models, on the tensor cores.
//   - Block: 128 query rows of one (head, batch), as two consumer warpgroups
//     of 64 rows, plus one producer warpgroup; 384 threads.  setmaxnreg
//     moves registers to the consumers: 24 a producer thread, 240 a
//     consumer thread (O 64 x D fp32 = D / 2 a thread, S 32, P 32), so the
//     bf16 D = 256 instance spills nothing.  Key tile 64.
//   - One producer thread stages Q once and then K and V tiles through TMA
//     (cp.async.bulk.tensor, one CUtensorMap per operand over the view's
//     (D, S, H, B) strides, boxes of 64 x 64 with the 128-byte swizzle that
//     wgmma reads) into a ring of two stages, completed on mbarriers; the
//     consumers release a stage on its "empty" mbarrier, so the next tile is
//     in flight while the current one is summed.  Rows past S arrive as the
//     tensor map's zero fill: nothing is padded in memory.
//   - S = Q K^T by wgmma (m64n64k16, both operands from shared memory, fp32
//     accumulators in registers).  A product of two bf16 values is exact in
//     fp32, so this is the TPU kernel's fp32 score up to the order of the sum.
//   - Softmax in registers: scale and log2(e) folded into one multiply,
//     ex2.approx; the soft-cap by an odd polynomial of tanh for |s / cap| <
//     1/8 (the warp takes the exact-division path 1 - 2 / (e^2y + 1) only
//     when one of its scores is larger), so no tanh.approx (2^-11).  Row max
//     by a 4-lane butterfly (equal bits in every lane), row sums per thread
//     and summed over the 4 lanes once at the end.
//   - P V by wgmma with P from registers (m64nDk16, V from shared memory,
//     MN-major): the fp32 probabilities are split as P_hi = bf16(P) and
//     P_lo = bf16(P - P_hi), and both products are summed into the same fp32
//     accumulator, so P keeps ~16 bits (2^-17 relative, against 2^-9 for one
//     bf16 P, which the kernel-vs-plain limits would not hold).  That costs
//     1.5x the tensor work of one bf16 P V; the bound above stays the
//     algorithm's 4 D flop a pair.
//   - A consumer skips (but still releases) a key tile that holds no live
//     pair of its 64 rows, masks only the tiles that cross the diagonal or
//     the window's lower edge, and rescales O only when a row's max moved.
//   - The two consumers interleave on their own: while one waits for its
//     products, the other runs its softmax.  An explicit turn order (named
//     barriers) and a software pipeline inside a warpgroup (the next
//     scores issued before this tile's softmax) both measured slower on an
//     H100 and are not used; the pipeline also spilled at D = 256.
// * repro_local_attention: fp32 at every D, and bf16 at D in {16, 32}, by
//   FFMA (67 TFLOP/s, never TF32).  One block of 256 threads per 64-row query
//   tile; Q, K and V tiles widened to fp32 in shared memory (216,064 bytes at
//   D = 256); thread (ty, tx) of a 16 x 16 grid owns 4 query rows and 4 keys
//   of the score tile, row statistics by 16-lane butterflies, P through shared
//   memory transposed.
//
// Kept by both: one block owns its output rows and loops over the live key
// tiles only, max(0, q_lo - window + 1) to q_hi, for O(S w) work; no atomics
// and no cross-block sum, so reruns are bitwise equal; the heaviest query
// tiles (the last ones under a causal mask) are launched first; GQA by index
// (the block of head h reads K/V head h / group, nothing repeated in memory).
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_local_attention(q, k, v, o, B, H, Hkv, S, D, strides[12],
//                             window, scale, softcap, lse, is_bf16, stream)
//   int repro_local_attention_wgmma(q, k, v, o, B, H, Hkv, S, D, strides[12],
//                                   window, scale, softcap, lse, stream)
//   long long repro_local_attention_smem(wgmma, D)
// strides: (b, h, s) of q, k, v, o in elements.  lse, when not null, is a
// (B, H, S) fp32 array that receives each row's natural log-sum-exp of its
// capped, scaled logits, for the backward (csrc/local_attn_bwd.cu); prefill
// passes null.  The launchers return
// cudaGetLastError() after the launch (0 on success), cudaErrorInvalidValue
// for a (dtype, D) outside their route or views a tensor map cannot
// describe, or cudaErrorNotSupported without libcuda's tensor-map
// encoder; they allocate nothing.  _smem gives the
// dynamic shared memory of an instance, in bytes.
//
// The mbarrier, TMA, wgmma-descriptor and tensor-map helpers are shared with
// the block sweeps' tensor-core kernels in hopper.cuh; the wgmma forms with
// A in registers, ex2, tanh and the operands' tensor maps also with the
// backward, csrc/local_attn_bwd.cu.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr float NEG = -1e30f;

struct Strides {
  long long b, h, s;
};

namespace ffma {

constexpr int NT = 256;      // threads per block, 16 x 16
constexpr int BQ = 64;       // query rows per block: 16 ty x 4
constexpr int BK = 64;       // keys per tile: 16 tx x 4
constexpr int PAD = 4;       // row pad of the Q and K tiles (floats)
constexpr int PT = BQ + 4;   // row stride of the transposed P tile

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
    local_attn_ffma(const T* __restrict__ q, const T* __restrict__ k,
                      const T* __restrict__ v, T* __restrict__ o,
                      float* __restrict__ lse, Strides sq, Strides sk,
                      Strides sv, Strides so, int S, int group, int window,
                      float scale, float softcap) {
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
    if (lse != nullptr && tx == 0)
      lse[(static_cast<long long>(b) * gridDim.y + h) * S + qi] =
          m[r] + logf(l[r]);
    T* orow = o + b * so.b + h * so.h + static_cast<long long>(qi) * so.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int w = 0; w < W; ++w)
        narrow_store(orow + cc * 16 * W + tx * W + w, acc[r][cc * W + w] * inv);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int S, const long long* st, int window,
           float scale, float softcap, cudaStream_t stream) {
  auto kern = local_attn_ffma<T, D>;
  constexpr size_t bytes = smem_bytes<D>();
  cudaError_t err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(bytes));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((S + BQ - 1) / BQ, H, B);
  kern<<<grid, NT, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), lse,
      Strides{st[0], st[1], st[2]}, Strides{st[3], st[4], st[5]},
      Strides{st[6], st[7], st[8]}, Strides{st[9], st[10], st[11]}, S,
      H / Hkv, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace ffma

namespace tc {

using namespace repro_hopper;

constexpr int NCONS = 2;               // consumer warpgroups, 64 rows each
constexpr int NT = 128 * (NCONS + 1);  // + one producer warpgroup
constexpr int PRODUCER_REGS = 24;      // setmaxnreg: 128 x 24 + 256 x 240
constexpr int CONSUMER_REGS = 240;     //   <= 65,536 registers of the SM
constexpr int BQ = 64 * NCONS;         // query rows per block
constexpr int BK = 64;                 // keys per tile
constexpr int STAGES = 2;              // K/V ring
constexpr int BOX = 64 * 64 * 2;       // one TMA box: 64 rows x 64 bf16

// Dynamic shared memory, from a 1024-byte aligned base (the 128-byte
// swizzle repeats every 8 rows): Q [NCONS][D / 64][64][64], K and V
// [STAGES][D / 64][64][64] each, then the mbarriers.
template <int D>
struct Smem {
  static constexpr int NCH = D / 64;
  static constexpr int Q = 0;
  static constexpr int K = Q + NCONS * NCH * BOX;
  static constexpr int V = K + STAGES * NCH * BOX;
  static constexpr int BAR = V + STAGES * NCH * BOX;
  // full_q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

template <int D>
__global__ void __launch_bounds__(NT, 1)
    local_attn_wgmma(const __grid_constant__ CUtensorMap mq,
                     const __grid_constant__ CUtensorMap mk,
                     const __grid_constant__ CUtensorMap mv,
                     __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                     Strides so, int S, int H, int B, int group, int window,
                     float scale, float softcap) {
  using L = Smem<D>;
  constexpr int NCH = L::NCH;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_q = base + L::BAR;
  const uint32_t full_k = full_q + 8, full_v = full_k + 8 * STAGES;
  const uint32_t empty = full_v + 8 * STAGES;

  // heaviest query tiles first: the tile index varies slowest
  const int per = H * B, nqt = gridDim.x / per;
  const int qt = nqt - 1 - static_cast<int>(blockIdx.x) / per;
  const int h = static_cast<int>(blockIdx.x) % per % H;
  const int b = static_cast<int>(blockIdx.x) % per / H;
  const int hk = h / group;
  const int q_lo = qt * BQ;
  const int t_first = max(0, q_lo - window + 1) / BK;
  const int t_last = (min(q_lo + BQ, S) - 1) / BK;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 4 * NCONS);   // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 128 * NCONS) {          // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 128 * NCONS) return;   // one thread issues the TMA
    mbar_expect_tx(full_q, NCONS * NCH * BOX);
    for (int c = 0; c < NCONS; ++c)
      for (int ch = 0; ch < NCH; ++ch)
        tma_load_4d(base + L::Q + (c * NCH + ch) * BOX, &mq, full_q, 64 * ch,
                q_lo + 64 * c, h, b);
    for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
      mbar_expect_tx(full_k + 8 * s, NCH * BOX);
      for (int ch = 0; ch < NCH; ++ch)
        tma_load_4d(base + L::K + (s * NCH + ch) * BOX, &mk, full_k + 8 * s,
                64 * ch, t * BK, hk, b);
      mbar_expect_tx(full_v + 8 * s, NCH * BOX);
      for (int ch = 0; ch < NCH; ++ch)
        tma_load_4d(base + L::V + (s * NCH + ch) * BOX, &mv, full_v + 8 * s,
                64 * ch, t * BK, hk, b);
    }
    return;
  }

  // a consumer warpgroup: rows r_lo .. r_lo + 63 of the block
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int r_lo = q_lo + 64 * wg;
  const int r_hi = min(r_lo + 63, S - 1);
  const int row0 = r_lo + 16 * warp + lane / 4;   // and row0 + 8
  const int col = 2 * (lane % 4);                 // and col + 1, + 8 n
  const uint32_t q_base = base + L::Q + wg * NCH * BOX;
  const bool capped = softcap > 0.0f;
  const float k_plain = scale * LOG2E;            // s -> log2-scaled logit
  const float k_in = scale / softcap, k_out = softcap * LOG2E;

  float acc[D / 2];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.0f;
  float m[2] = {NEG, NEG}, l[2] = {0.0f, 0.0f};

  mbar_wait(full_q, 0);
  for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
    const int s = i % STAGES;
    const uint32_t par = (i / STAGES) & 1;
    const int k0 = t * BK;
    // a live pair of these rows in this tile: keys r_lo - w + 1 .. r_hi
    const bool active = r_lo < S && k0 <= r_hi && k0 + BK - 1 > r_lo - window;
    const bool masked = k0 + BK - 1 > r_lo || k0 < r_hi - window + 1;
    uint32_t p_hi[4][4], p_lo[4][4];

    mbar_wait(full_k + 8 * s, par);
    if (active) {
      float sc[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = 0.0f;
      const uint32_t k_base = base + L::K + s * NCH * BOX;
      hold(sc);
      wg_fence();
#pragma unroll
      for (int ks = 0; ks < D / 16; ++ks) {
        const uint32_t off = (ks / 4) * BOX + (ks % 4) * 32;
        wgmma_ss<64, 0>(sc, desc(q_base + off, 16, 1024),
                        desc(k_base + off, 16, 1024), ks > 0);
      }
      wg_commit();
      wg_wait_all();
      hold(sc);

      // log2-scaled logits: sc[4n + e] is row row0 + 8 (e / 2), key
      // k0 + 8 n + col + e % 2
      if (!capped) {
#pragma unroll
        for (int j = 0; j < 32; ++j) sc[j] *= k_plain;
      } else {
        float big = 0.0f;
#pragma unroll
        for (int j = 0; j < 32; ++j) big = fmaxf(big, fabsf(sc[j]));
        if (__any_sync(0xffffffffu, big * k_in >= 0.125f)) {
#pragma unroll
          for (int j = 0; j < 32; ++j) sc[j] = tanh_any(sc[j] * k_in) * k_out;
        } else {
#pragma unroll
          for (int j = 0; j < 32; ++j)
            sc[j] = tanh_small(sc[j] * k_in) * k_out;
        }
      }
      if (masked) {
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int qi = row0 + 8 * ((j % 4) / 2);
          const int kj = k0 + 8 * (j / 4) + col + j % 2;
          if (!(kj <= qi && kj > qi - window)) sc[j] = NEG;
        }
      }
      float alpha[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        float mx = NEG;
#pragma unroll
        for (int n = 0; n < 8; ++n)
          mx = fmaxf(mx, fmaxf(sc[4 * n + 2 * r], sc[4 * n + 2 * r + 1]));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
        const float m_new = fmaxf(m[r], mx);
        alpha[r] = ex2(m[r] - m_new);
        m[r] = m_new;
      }
      float rs[2] = {0.0f, 0.0f};
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j % 4) / 2;
        float p = ex2(sc[j] - m[r]);
        if (masked && sc[j] == NEG) p = 0.0f;       // masked keys: exactly 0
        sc[j] = p;
        rs[r] += p;
      }
#pragma unroll
      for (int r = 0; r < 2; ++r) l[r] = l[r] * alpha[r] + rs[r];
      // P as the A operand of m64nDk16: key step kk takes pairs 4 kk .. +3
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        const __nv_bfloat162 hi = __floats2bfloat162_rn(sc[2 * j],
                                                        sc[2 * j + 1]);
        const float2 hf = __bfloat1622float2(hi);
        const __nv_bfloat162 lo = __floats2bfloat162_rn(sc[2 * j] - hf.x,
                                                        sc[2 * j + 1] - hf.y);
        p_hi[j / 4][j % 4] = *reinterpret_cast<const uint32_t*>(&hi);
        p_lo[j / 4][j % 4] = *reinterpret_cast<const uint32_t*>(&lo);
      }
      // once a row's max has settled, alpha is 1: skip the D / 2 products
      if (!__all_sync(0xffffffffu, alpha[0] == 1.0f && alpha[1] == 1.0f)) {
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= alpha[0];
          acc[4 * n + 1] *= alpha[0];
          acc[4 * n + 2] *= alpha[1];
          acc[4 * n + 3] *= alpha[1];
        }
      }
    }

    mbar_wait(full_v + 8 * s, par);
    if (active) {
      const uint32_t v_base = base + L::V + s * NCH * BOX;
      hold(acc);
      wg_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(acc, p_hi[kk], desc(v_base + kk * 2048, 64 * 128, 1024));
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
        wgmma_rs<D>(acc, p_lo[kk], desc(v_base + kk * 2048, 64 * 128, 1024));
      wg_commit();
      wg_wait_all();
      hold(acc);
      hold(p_hi);
      hold(p_lo);
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

  __nv_bfloat16* ob = o + b * so.b + h * so.h;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    float lr = l[r];
    lr += __shfl_xor_sync(0xffffffffu, lr, 1);
    lr += __shfl_xor_sync(0xffffffffu, lr, 2);
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    const float inv = 1.0f / fmaxf(lr, 1e-30f);
    if (lse != nullptr && lane % 4 == 0)   // natural log: 2^m l = e^lse
      lse[(static_cast<long long>(b) * H + h) * S + qi] =
          (m[r] + log2f(lr)) * 0.6931471805599453f;
    __nv_bfloat16* orow = ob + static_cast<long long>(qi) * so.s + col;
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(orow + 8 * n) = __floats2bfloat162_rn(
          acc[4 * n + 2 * r] * inv, acc[4 * n + 2 * r + 1] * inv);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, float* lse,
           int B, int H, int Hkv, int S, const long long* st, int window,
           float scale, float softcap, cudaStream_t stream) {
  CUtensorMap mq, mk, mv;
  cudaError_t err = encode_attn(&mq, q, D, S, H, B, st);
  if (err == cudaSuccess) err = encode_attn(&mk, k, D, S, Hkv, B, st + 3);
  if (err == cudaSuccess) err = encode_attn(&mv, v, D, S, Hkv, B, st + 6);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto kern = local_attn_wgmma<D>;
  err = cudaFuncSetAttribute(
      kern, cudaFuncAttributeMaxDynamicSharedMemorySize, Smem<D>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int blocks = (S + BQ - 1) / BQ * H * B;
  kern<<<blocks, NT, Smem<D>::BYTES, stream>>>(
      mq, mk, mv, static_cast<__nv_bfloat16*>(o), lse,
      Strides{st[9], st[10], st[11]}, S, H, B, H / Hkv, window, scale,
      softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

template <typename T>
int dispatch_ffma(const void* q, const void* k, const void* v, void* o,
                  float* lse, int B, int H, int Hkv, int S, int D,
                  const long long* st, int window, float scale, float softcap,
                  cudaStream_t s) {
  switch (D) {
    case 16:
      return ffma::launch<T, 16>(q, k, v, o, lse, B, H, Hkv, S, st, window,
                                 scale, softcap, s);
    case 32:
      return ffma::launch<T, 32>(q, k, v, o, lse, B, H, Hkv, S, st, window,
                                 scale, softcap, s);
  }
  if constexpr (sizeof(T) == 4) {       // bf16 at these D is the wgmma route
    switch (D) {
      case 64:
        return ffma::launch<T, 64>(q, k, v, o, lse, B, H, Hkv, S, st, window,
                                   scale, softcap, s);
      case 128:
        return ffma::launch<T, 128>(q, k, v, o, lse, B, H, Hkv, S, st, window,
                                    scale, softcap, s);
      case 256:
        return ffma::launch<T, 256>(q, k, v, o, lse, B, H, Hkv, S, st, window,
                                    scale, softcap, s);
    }
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

extern "C" int repro_local_attention(const void* q, const void* k,
                                     const void* v, void* o, long long B,
                                     long long H, long long Hkv, long long S,
                                     long long D, const long long* strides,
                                     long long window, float scale,
                                     float softcap, void* lse, int is_bf16,
                                     void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(window < S ? window : S);
  float* l = static_cast<float*>(lse);
  if (is_bf16)
    return dispatch_ffma<__nv_bfloat16>(q, k, v, o, l, (int)B, (int)H,
                                        (int)Hkv, (int)S, (int)D, strides, w,
                                        scale, softcap, s);
  return dispatch_ffma<float>(q, k, v, o, l, (int)B, (int)H, (int)Hkv, (int)S,
                              (int)D, strides, w, scale, softcap, s);
}

extern "C" int repro_local_attention_wgmma(
    const void* q, const void* k, const void* v, void* o, long long B,
    long long H, long long Hkv, long long S, long long D,
    const long long* strides, long long window, float scale, float softcap,
    void* lse, void* stream) {
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(window < S ? window : S);
  float* l = static_cast<float*>(lse);
  switch (D) {
    case 64:
      return tc::launch<64>(q, k, v, o, l, (int)B, (int)H, (int)Hkv, (int)S,
                            strides, w, scale, softcap, s);
    case 128:
      return tc::launch<128>(q, k, v, o, l, (int)B, (int)H, (int)Hkv, (int)S,
                             strides, w, scale, softcap, s);
    case 256:
      return tc::launch<256>(q, k, v, o, l, (int)B, (int)H, (int)Hkv, (int)S,
                             strides, w, scale, softcap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

extern "C" long long repro_local_attention_smem(int wgmma, long long D) {
  if (wgmma)
    return D == 64 ? tc::Smem<64>::BYTES
           : D == 128 ? tc::Smem<128>::BYTES
           : D == 256 ? tc::Smem<256>::BYTES : 0;
  // the FFMA tiles are fp32 whatever the input type
  switch (D) {
    case 16: return static_cast<long long>(ffma::smem_bytes<16>());
    case 32: return static_cast<long long>(ffma::smem_bytes<32>());
    case 64: return static_cast<long long>(ffma::smem_bytes<64>());
    case 128: return static_cast<long long>(ffma::smem_bytes<128>());
    case 256: return static_cast<long long>(ffma::smem_bytes<256>());
  }
  return 0;
}
