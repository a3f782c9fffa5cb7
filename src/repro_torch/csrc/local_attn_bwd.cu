// The gradient of causal sliding-window (local) attention with GQA and
// optional logit soft-capping, written for Hopper (sm_90a): the backward of
// csrc/local_attn.cu's forward, for training.
//
// With s_ij = q_i . k_j * scale, c_ij = cap(s_ij) (softcap * tanh(s / softcap)
// or s), the forward's row log-sum-exp lse_i (fp32, written by the forward
// when it is given a pointer for it), and the live pairs i - window < j <= i:
//
//   P_ij   = exp(c_ij - lse_i)                     (0 off the window)
//   Dlt_i  = sum_d dO_id O_id
//   dC_ij  = P_ij (dO_i . v_j - Dlt_i)
//   dS_ij  = dC_ij (1 - tanh^2(s_ij / softcap))    (dC_ij without a cap)
//   dQ_i   = scale sum_j dS_ij k_j
//   dK_j   = scale sum_{h in j's group} sum_i dS_ij q_i
//   dV_j   = sum_{h in j's group} sum_i P_ij dO_i
//
// q, dO, O, dQ (B, H, S, D); k, v, dK, dV (B, Hkv, S, D); every operand
// addressed by element strides (b, h, s) with unit stride along D, as the
// forward takes them.  fp32 or bf16 in and out (one type for all); every sum
// is fp32.  It replaces no Pallas kernel: the JAX package takes this gradient
// by autodiff of its jnp attention (src/repro/models/layers.py:136-253); the
// Pallas kernel it shadows, src/repro/kernels/local_attn.py: local_attention
// (pallas_call at :104), is forward only.
//
// Bound on an H100 SXM: 10 D flop per live pair (the scores again, dO V^T,
// P^T dO, dS K, dS^T Q) against q, k, v, o, dO read once and dQ, dK, dV
// written once: the arithmetic bounds it at every configured shape (0.35
// ms for qwen3-0.6b's 8 x 16 x 2048 x 128 at the bf16 peak).
//
// Two routes, one C entry point each; the caller (kernels/local_attn.py,
// bwd_route()) picks one and neither stands in for the other.  Both launch
// three kernels in order on one stream, with no atomics and no sum across
// blocks (dK and dV of a K/V head are summed over its query heads and query
// tiles in a fixed order inside one block, dQ over its key tiles inside
// one block), so reruns are bitwise equal; both walk only the tiles that
// hold a live pair, and launch the heaviest first.  The first kernel is
// shared: bwd_delta, Dlt (B, H, S) fp32, one warp a row, a fixed butterfly.
//
// * repro_local_attention_bwd_wgmma: bf16 at D in {64, 128, 256}, on the
//   tensor cores; 384 threads a block, one producer warpgroup (one thread
//   issues TMA loads through tensor maps of q, k, v and dO, 64 x 64 boxes
//   with the 128-byte swizzle, rows past S zero-filled) and two consumer
//   warpgroups; setmaxnreg gives the producer 24 registers a thread, the
//   consumers 240, and no instance spills.
//   - bwd_dkdv_wgmma: one block a (64-key tile, K/V head, batch; at D = 256
//     also a half of the columns).  K and V stay in shared memory; Q, dO
//     of each (query head, query tile) of the group stream through a
//     two-stage mbarrier ring.  Both consumers compute S^T = K Q^T by wgmma
//     (m64n64k16, both operands in shared memory, K-major) and P^T from it;
//     the second also dP^T = V dO^T and dS^T.  The first then sums dV +=
//     P^T dO, the second dK += dS^T Q, with A (P^T, dS^T) from registers
//     and B (dO, Q) from shared memory, MN-major.
//   - bwd_dq_wgmma: one block a (128 query rows, or 64 at D = 256, head,
//     batch), 64 rows a consumer (at D = 256 both take the 64 rows, each
//     128 columns).  Q and dO stay; K and V tiles stream through the ring.
//     S = Q K^T, dP = dO V^T (shared memory, K-major), dS in registers,
//     dQ += dS K (K MN-major).
//   - Precision.  A product of two bf16 values is exact in fp32.  P and dS
//     are fp32 and enter the products split into three bf16 terms (x =
//     t0 + t1 + t2 to ~2^-24, as fp32 keeps): two terms (~2^-17) left
//     entries of dV that cancel to ~1e-4 of their terms 1.1e-5 off the
//     plain version, above the kernel-vs-plain limit (2^-8 |want| + 1e-5)
//     at the qwen3 shape.  Each tile's product starts from zero in the
//     tensor cores (smallest terms first) and is added to the sums in
//     registers by FADD: summed in the tensor cores across thousands of
//     query rows, dV and dK drifted to 3x that limit at gemma2-9b's shapes
//     (the accumulator's additions are not rounded to nearest).  Both
//     choices build as planted faults, -DREPRO_TWO_TERMS and
//     -DREPRO_TC_SUMS_ONLY, which chip_smoke.py reads beside the kernel at
//     the path's shapes.  exp is ex2
//     with log2 e folded in; the cap's tanh is hopper.cuh's tanh_small /
//     tanh_any, no tanh.approx (2^-11).
//   - Cost: 18 D flop of tensor work a live pair in bwd_dkdv_wgmma (S^T in
//     both consumers, dP^T, and the two products at three terms: 2 D +
//     2 D + 2 D + 6 D + 6 D) and 10 D in bwd_dq_wgmma (2 D + 2 D + 6 D):
//     28 D against the algorithm's 10 D, which the bound above keeps.  At
//     D = 256 both column halves of dK/dV compute S^T and dP^T, and both
//     dQ consumers S and dP: 24 D + 14 D.
//   - D = 256: dK and dV of 64 keys x 256 columns are 256 fp32 registers a
//     thread in one warpgroup.  Splitting them by product (one consumer
//     dV, one dK) and the columns over two blocks leaves a consumer 64
//     registers of sums, and a tile's product is formed 64 columns at a
//     time (32 more); ptxas -v reports no spills in any instance
//     (chip_smoke.py's build phase checks it), so D = 256 takes this
//     route too.
// * repro_local_attention_bwd: fp32 at every D, and bf16 at D in {16, 32},
//   by FFMA (67 TFLOP/s at most, never TF32) on fp32 tiles in shared
//   memory, recomputing the scores and dP in both passes (14 D flop a
//   pair).  bwd_dkdv: one block a (key tile of 64, K/V head, batch), K and
//   V in shared memory, dK, dV in registers, query tiles of 64 rows (32 at
//   D = 256, so the tiles fit 227 KB).  bwd_dq: one block a (query tile of
//   64, head, batch), Q and dO in shared memory, dQ in registers, key
//   tiles of 64 (32 at D = 256).  256 threads a block as a 16 x 16 grid;
//   thread (ty, tx) computes the score and dP entries of query rows ty * RQ
//   + r and keys tx + 16 c of a tile, as the forward's FFMA route does, and
//   the products with P and dS go through shared memory.  It takes bf16 at
//   every D too (the caller's yardstick; bwd_route never sends bf16 at D
//   >= 64 there).
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_local_attention_bwd(q, k, v, o, dO, lse, delta, dq, dk, dv,
//                                 B, H, Hkv, S, D, strides[24], window,
//                                 scale, softcap, is_bf16, stream)
//   int repro_local_attention_bwd_wgmma(q, k, v, o, dO, lse, delta, dq, dk,
//                                       dv, B, H, Hkv, S, D, strides[24],
//                                       window, scale, softcap, stream)
// strides: (b, h, s) of q, k, v, o, dO, dq, dk, dv in elements; lse and
// delta are (B, H, S) fp32 contiguous (delta is scratch the caller
// allocates).  The launchers return cudaGetLastError() after the last
// launch (0 on success), cudaErrorInvalidValue for a D they have no
// instance for or views a tensor map cannot describe (the wgmma route), or
// cudaErrorNotSupported without libcuda's tensor-map encoder; they
// allocate nothing.  The mbarrier, TMA, wgmma and tensor-map helpers and
// the softmax arithmetic are shared with the forward in hopper.cuh.

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

#include "hopper.cuh"

namespace {

constexpr int NT = 256;    // threads per block, 16 x 16
constexpr int PAD = 4;     // row pad of the operand tiles (floats)

struct Strides {
  long long b, h, s;
};

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void narrow_store(float* dst, float x) { *dst = x; }
__device__ __forceinline__ void narrow_store(__nv_bfloat16* dst, float x) {
  *dst = __float2bfloat16(x);
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

// Rows r0 .. r0 + ROWS - 1 of one (b, h) slice (row stride ss) into a shared
// tile of row stride LD, widened to fp32; rows at or past S are zeros.
template <typename T, int D, int ROWS, int LD>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      long long ss, int r0, int S) {
  constexpr int E = 16 / sizeof(T);     // elements per 16-byte load
  constexpr int PER_ROW = D / E;
  constexpr int TOTAL = ROWS * PER_ROW;
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

// One fp32 row vector (lse or Dlt) of a (b, h) slice: rows r0 .. r0 + ROWS - 1
// into shared memory, zeros past S.
template <int ROWS>
__device__ __forceinline__ void stage_rows(float* dst,
                                           const float* __restrict__ src,
                                           int r0, int S) {
  for (int t = threadIdx.x; t < ROWS; t += NT)
    dst[t] = r0 + t < S ? src[r0 + t] : 0.0f;
}

// s[r][c] = sum_d A[ty RQ + r][d] * Bm[tx + 16 c][d], both tiles of row
// stride LD in shared memory.
template <int D, int RQ, int RK, int LD>
__device__ __forceinline__ void tile_dot(float (&s)[RQ][RK],
                                         const float* A, const float* Bm,
                                         int ty, int tx) {
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int c = 0; c < RK; ++c) s[r][c] = 0.0f;
#pragma unroll 4
  for (int d = 0; d < D; d += 4) {
    float4 a[RQ], b[RK];
#pragma unroll
    for (int r = 0; r < RQ; ++r)
      a[r] = *reinterpret_cast<const float4*>(&A[(ty * RQ + r) * LD + d]);
#pragma unroll
    for (int c = 0; c < RK; ++c)
      b[c] = *reinterpret_cast<const float4*>(&Bm[(tx + 16 * c) * LD + d]);
#pragma unroll
    for (int r = 0; r < RQ; ++r)
#pragma unroll
      for (int c = 0; c < RK; ++c) {
        s[r][c] = fmaf(a[r].x, b[c].x, s[r][c]);
        s[r][c] = fmaf(a[r].y, b[c].y, s[r][c]);
        s[r][c] = fmaf(a[r].z, b[c].z, s[r][c]);
        s[r][c] = fmaf(a[r].w, b[c].w, s[r][c]);
      }
  }
}

// P and dS of a thread's entries from the scores s and dP = dO v: rows
// q0 + ty RQ + r, keys k0 + tx + 16 c; lse and Dlt of the tile's rows in
// shared memory.  Off the window both are exactly 0.
template <int RQ, int RK>
__device__ __forceinline__ void probs_and_ds(float (&s)[RQ][RK],
                                             float (&dp)[RQ][RK],
                                             const float* Ls, const float* Dl,
                                             int q0, int k0, int ty, int tx,
                                             int S, int window, float scale,
                                             float softcap) {
#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int li = ty * RQ + r, qi = q0 + li;
#pragma unroll
    for (int c = 0; c < RK; ++c) {
      const int kj = k0 + tx + 16 * c;
      const bool live = qi < S && kj <= qi && kj > qi - window;
      float x = s[r][c] * scale, slope = 1.0f;
      if (softcap > 0.0f) {
        const float t = tanhf(x / softcap);
        x = t * softcap;
        slope = 1.0f - t * t;
      }
      const float p = live ? expf(x - Ls[li]) : 0.0f;
      s[r][c] = p;
      dp[r][c] = p * (dp[r][c] - Dl[li]) * slope;
    }
  }
}

// ---------------------------------------------------------------------------
// 1. Dlt = rowsum(dO * O)
// ---------------------------------------------------------------------------

template <typename T, int D>
__global__ void __launch_bounds__(NT)
    bwd_delta(const T* __restrict__ o, const T* __restrict__ dO,
              float* __restrict__ delta, Strides so, Strides sd, int H, int S,
              long long rows) {
  const long long row = static_cast<long long>(blockIdx.x) * (NT / 32) +
                        threadIdx.x / 32;
  if (row >= rows) return;
  const int lane = threadIdx.x % 32;
  const int i = static_cast<int>(row % S);
  const long long bh = row / S;
  const int h = static_cast<int>(bh % H), b = static_cast<int>(bh / H);
  const T* orow = o + b * so.b + h * so.h + static_cast<long long>(i) * so.s;
  const T* drow = dO + b * sd.b + h * sd.h + static_cast<long long>(i) * sd.s;
  float acc = 0.0f;
#pragma unroll
  for (int d = lane; d < D; d += 32)
    acc = fmaf(to_f(orow[d]), to_f(drow[d]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) delta[row] = acc;
}

// ---------------------------------------------------------------------------
// 2. dK and dV: one block a key tile
// ---------------------------------------------------------------------------

template <int D>
struct KV {
  static constexpr int BK = 64;                 // keys per block
  static constexpr int BQ = D == 256 ? 32 : 64;  // query rows per step
  static constexpr int LD = D + PAD;
  static constexpr int PT = BK + 4;             // row stride of P and dS
  static constexpr size_t BYTES =
      sizeof(float) * (2 * static_cast<size_t>(BK) * LD +
                       2 * static_cast<size_t>(BQ) * LD +
                       2 * static_cast<size_t>(BQ) * PT + 2 * BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    bwd_dkdv(const T* __restrict__ q, const T* __restrict__ k,
             const T* __restrict__ v, const T* __restrict__ dO,
             const float* __restrict__ lse, const float* __restrict__ delta,
             T* __restrict__ dk, T* __restrict__ dv, Strides sq, Strides sk,
             Strides sv, Strides sdo, Strides sdk, Strides sdv, int H, int S,
             int group, int window, float scale, float softcap) {
  using L = KV<D>;
  constexpr int BK = L::BK, BQ = L::BQ, LD = L::LD, PT = L::PT;
  constexpr int RQ = BQ / 16, RK = BK / 16;       // RK = 4
  constexpr int W = D >= 64 ? 4 : D / 16;         // consecutive columns
  constexpr int NC = D / (16 * W);                // chunks of W, 16 W apart
  extern __shared__ __align__(16) float smem[];
  float* Ks = smem;                 // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* Qs = Vs + BK * LD;         // [BQ][LD]
  float* dOs = Qs + BQ * LD;        // [BQ][LD]
  float* Ps = dOs + BQ * LD;        // [BQ][PT]
  float* dSs = Ps + BQ * PT;        // [BQ][PT]
  float* Ls = dSs + BQ * PT;        // [BQ]
  float* Dl = Ls + BQ;              // [BQ]

  // the first key tiles see the most query rows: they launch first
  const int kt = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int k0 = kt * BK, k_hi = min(k0 + BK, S) - 1;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  stage<T, D, BK, LD>(Ks, k + b * sk.b + hk * sk.h, sk.s, k0, S);
  stage<T, D, BK, LD>(Vs, v + b * sv.b + hk * sv.h, sv.s, k0, S);

  float adk[RK][NC * W], adv[RK][NC * W];
#pragma unroll
  for (int r = 0; r < RK; ++r)
#pragma unroll
    for (int x = 0; x < NC * W; ++x) adk[r][x] = adv[r][x] = 0.0f;

  // query rows that see a key of this tile: k0 .. k_hi + window - 1
  const int qt_first = k0 / BQ;
  const int qt_last = min(S - 1, k_hi + window - 1) / BQ;
  for (int hh = 0; hh < group; ++hh) {
    const int h = hk * group + hh;
    const long long row0 = (static_cast<long long>(b) * H + h) * S;
    for (int qt = qt_first; qt <= qt_last; ++qt) {
      const int q0 = qt * BQ;
      __syncthreads();            // the previous step's tiles are read
      stage<T, D, BQ, LD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
      stage<T, D, BQ, LD>(dOs, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S);
      stage_rows<BQ>(Ls, lse + row0, q0, S);
      stage_rows<BQ>(Dl, delta + row0, q0, S);
      __syncthreads();

      float s[RQ][RK], dp[RQ][RK];
      tile_dot<D, RQ, RK, LD>(s, Qs, Ks, ty, tx);
      tile_dot<D, RQ, RK, LD>(dp, dOs, Vs, ty, tx);
      probs_and_ds<RQ, RK>(s, dp, Ls, Dl, q0, k0, ty, tx, S, window, scale,
                           softcap);
#pragma unroll
      for (int r = 0; r < RQ; ++r)
#pragma unroll
        for (int c = 0; c < RK; ++c) {
          Ps[(ty * RQ + r) * PT + tx + 16 * c] = s[r][c];
          dSs[(ty * RQ + r) * PT + tx + 16 * c] = dp[r][c];
        }
      __syncthreads();

      // keys ty * 4 + r of the tile, columns cc * 16 W + tx W + w
#pragma unroll 2
      for (int i = 0; i < BQ; ++i) {
        const float4 p4 =
            *reinterpret_cast<const float4*>(&Ps[i * PT + ty * 4]);
        const float4 s4 =
            *reinterpret_cast<const float4*>(&dSs[i * PT + ty * 4]);
        const float pr[4] = {p4.x, p4.y, p4.z, p4.w};
        const float sr[4] = {s4.x, s4.y, s4.z, s4.w};
#pragma unroll
        for (int cc = 0; cc < NC; ++cc) {
          const int col = cc * 16 * W + tx * W;
          float gv[W], qv[W];
          if constexpr (W == 4) {
            const float4 g4 =
                *reinterpret_cast<const float4*>(&dOs[i * LD + col]);
            const float4 q4 =
                *reinterpret_cast<const float4*>(&Qs[i * LD + col]);
            gv[0] = g4.x, gv[1] = g4.y, gv[2] = g4.z, gv[3] = g4.w;
            qv[0] = q4.x, qv[1] = q4.y, qv[2] = q4.z, qv[3] = q4.w;
          } else {
#pragma unroll
            for (int w = 0; w < W; ++w) {
              gv[w] = dOs[i * LD + col + w];
              qv[w] = Qs[i * LD + col + w];
            }
          }
#pragma unroll
          for (int r = 0; r < RK; ++r)
#pragma unroll
            for (int w = 0; w < W; ++w) {
              adv[r][cc * W + w] = fmaf(pr[r], gv[w], adv[r][cc * W + w]);
              adk[r][cc * W + w] = fmaf(sr[r], qv[w], adk[r][cc * W + w]);
            }
        }
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RK; ++r) {
    const int kj = k0 + ty * 4 + r;
    if (kj >= S) continue;
    T* krow = dk + b * sdk.b + hk * sdk.h + static_cast<long long>(kj) * sdk.s;
    T* vrow = dv + b * sdv.b + hk * sdv.h + static_cast<long long>(kj) * sdv.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int w = 0; w < W; ++w) {
        const int col = cc * 16 * W + tx * W + w;
        narrow_store(krow + col, adk[r][cc * W + w] * scale);
        narrow_store(vrow + col, adv[r][cc * W + w]);
      }
  }
}

// ---------------------------------------------------------------------------
// 3. dQ: one block a query tile
// ---------------------------------------------------------------------------

template <int D>
struct QT {
  static constexpr int BQ = 64;                  // query rows per block
  static constexpr int BK = D == 256 ? 32 : 64;  // keys per step
  static constexpr int LD = D + PAD;
  static constexpr int ST = BQ + 4;              // row stride of dS^T
  static constexpr size_t BYTES =
      sizeof(float) * (2 * static_cast<size_t>(BQ) * LD +
                       2 * static_cast<size_t>(BK) * LD +
                       static_cast<size_t>(BK) * ST + 2 * BQ);
};

template <typename T, int D>
__global__ void __launch_bounds__(NT, 1)
    bwd_dq(const T* __restrict__ q, const T* __restrict__ k,
           const T* __restrict__ v, const T* __restrict__ dO,
           const float* __restrict__ lse, const float* __restrict__ delta,
           T* __restrict__ dq, Strides sq, Strides sk, Strides sv,
           Strides sdo, Strides sdq, int H, int S, int group, int window,
           float scale, float softcap) {
  using L = QT<D>;
  constexpr int BK = L::BK, BQ = L::BQ, LD = L::LD, ST = L::ST;
  constexpr int RQ = BQ / 16, RK = BK / 16;       // RQ = 4
  constexpr int W = D >= 64 ? 4 : D / 16;
  constexpr int NC = D / (16 * W);
  extern __shared__ __align__(16) float smem[];
  float* Qs = smem;                 // [BQ][LD]
  float* dOs = Qs + BQ * LD;        // [BQ][LD]
  float* Ks = dOs + BQ * LD;        // [BK][LD]
  float* Vs = Ks + BK * LD;         // [BK][LD]
  float* dSt = Vs + BK * LD;        // [BK][ST], dS transposed
  float* Ls = dSt + BK * ST;        // [BQ]
  float* Dl = Ls + BQ;              // [BQ]

  const int qt = gridDim.x - 1 - blockIdx.x;    // heaviest tiles first
  const int h = blockIdx.y, b = blockIdx.z, hk = h / group;
  const int q0 = qt * BQ, q_hi = min(q0 + BQ, S) - 1;
  const int tid = threadIdx.x, tx = tid % 16, ty = tid / 16;
  const long long row0 = (static_cast<long long>(b) * H + h) * S;
  stage<T, D, BQ, LD>(Qs, q + b * sq.b + h * sq.h, sq.s, q0, S);
  stage<T, D, BQ, LD>(dOs, dO + b * sdo.b + h * sdo.h, sdo.s, q0, S);
  stage_rows<BQ>(Ls, lse + row0, q0, S);
  stage_rows<BQ>(Dl, delta + row0, q0, S);

  float adq[RQ][NC * W];
#pragma unroll
  for (int r = 0; r < RQ; ++r)
#pragma unroll
    for (int x = 0; x < NC * W; ++x) adq[r][x] = 0.0f;

  const T* kb = k + b * sk.b + hk * sk.h;
  const T* vb = v + b * sv.b + hk * sv.h;
  const int t_first = max(0, q0 - window + 1) / BK;
  const int t_last = q_hi / BK;
  for (int t = t_first; t <= t_last; ++t) {
    const int k0 = t * BK;
    __syncthreads();              // the previous tile's K, V and dS are read
    stage<T, D, BK, LD>(Ks, kb, sk.s, k0, S);
    stage<T, D, BK, LD>(Vs, vb, sv.s, k0, S);
    __syncthreads();

    float s[RQ][RK], dp[RQ][RK];
    tile_dot<D, RQ, RK, LD>(s, Qs, Ks, ty, tx);
    tile_dot<D, RQ, RK, LD>(dp, dOs, Vs, ty, tx);
    probs_and_ds<RQ, RK>(s, dp, Ls, Dl, q0, k0, ty, tx, S, window, scale,
                         softcap);
#pragma unroll
    for (int c = 0; c < RK; ++c)
      *reinterpret_cast<float4*>(&dSt[(tx + 16 * c) * ST + ty * 4]) =
          make_float4(dp[0][c], dp[1][c], dp[2][c], dp[3][c]);
    __syncthreads();

    // rows ty * 4 + r of the tile, columns cc * 16 W + tx W + w
#pragma unroll 2
    for (int j = 0; j < BK; ++j) {
      const float4 d4 = *reinterpret_cast<const float4*>(&dSt[j * ST + ty * 4]);
      const float dr[4] = {d4.x, d4.y, d4.z, d4.w};
#pragma unroll
      for (int cc = 0; cc < NC; ++cc) {
        const int col = cc * 16 * W + tx * W;
        float kv[W];
        if constexpr (W == 4) {
          const float4 k4 = *reinterpret_cast<const float4*>(&Ks[j * LD + col]);
          kv[0] = k4.x, kv[1] = k4.y, kv[2] = k4.z, kv[3] = k4.w;
        } else {
#pragma unroll
          for (int w = 0; w < W; ++w) kv[w] = Ks[j * LD + col + w];
        }
#pragma unroll
        for (int r = 0; r < RQ; ++r)
#pragma unroll
          for (int w = 0; w < W; ++w)
            adq[r][cc * W + w] = fmaf(dr[r], kv[w], adq[r][cc * W + w]);
      }
    }
  }

#pragma unroll
  for (int r = 0; r < RQ; ++r) {
    const int qi = q0 + ty * 4 + r;
    if (qi >= S) continue;
    T* qrow = dq + b * sdq.b + h * sdq.h + static_cast<long long>(qi) * sdq.s;
#pragma unroll
    for (int cc = 0; cc < NC; ++cc)
#pragma unroll
      for (int w = 0; w < W; ++w)
        narrow_store(qrow + cc * 16 * W + tx * W + w,
                     adq[r][cc * W + w] * scale);
  }
}

template <typename T, int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int B, int H, int Hkv, int S, const long long* st,
           int window, float scale, float softcap, cudaStream_t stream) {
  const Strides sq{st[0], st[1], st[2]}, sk{st[3], st[4], st[5]},
      sv{st[6], st[7], st[8]}, so{st[9], st[10], st[11]},
      sdo{st[12], st[13], st[14]}, sdq{st[15], st[16], st[17]},
      sdk{st[18], st[19], st[20]}, sdv{st[21], st[22], st[23]};
  const T* tq = static_cast<const T*>(q);
  const T* tk = static_cast<const T*>(k);
  const T* tv = static_cast<const T*>(v);
  const T* tdo = static_cast<const T*>(dO);
  const long long rows = static_cast<long long>(B) * H * S;
  bwd_delta<T, D><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)),
                    NT, 0, stream>>>(static_cast<const T*>(o), tdo, delta, so,
                                     sdo, H, S, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kv = bwd_dkdv<T, D>;
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(KV<D>::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gkv((S + KV<D>::BK - 1) / KV<D>::BK, Hkv, B);
  kv<<<gkv, NT, KV<D>::BYTES, stream>>>(
      tq, tk, tv, tdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      sq, sk, sv, sdo, sdk, sdv, H, S, H / Hkv, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kq = bwd_dq<T, D>;
  err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(QT<D>::BYTES));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 gq((S + QT<D>::BQ - 1) / QT<D>::BQ, H, B);
  kq<<<gq, NT, QT<D>::BYTES, stream>>>(tq, tk, tv, tdo, lse, delta,
                                       static_cast<T*>(dq), sq, sk, sv, sdo,
                                       sdq, H, S, H / Hkv, window, scale,
                                       softcap);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, const void* o,
             const void* dO, const float* lse, float* delta, void* dq,
             void* dk, void* dv, int B, int H, int Hkv, int S, int D,
             const long long* st, int window, float scale, float softcap,
             cudaStream_t s) {
  switch (D) {
    case 16:
      return launch<T, 16>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, Hkv,
                           S, st, window, scale, softcap, s);
    case 32:
      return launch<T, 32>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, Hkv,
                           S, st, window, scale, softcap, s);
    case 64:
      return launch<T, 64>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, Hkv,
                           S, st, window, scale, softcap, s);
    case 128:
      return launch<T, 128>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, Hkv,
                            S, st, window, scale, softcap, s);
    case 256:
      return launch<T, 256>(q, k, v, o, dO, lse, delta, dq, dk, dv, B, H, Hkv,
                            S, st, window, scale, softcap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}

// ---------------------------------------------------------------------------
// The tensor-core route: bf16 at D in {64, 128, 256}
// ---------------------------------------------------------------------------

namespace tc {

using namespace repro_hopper;

constexpr int BOX = 64 * 64 * 2;       // one TMA box: 64 rows x 64 bf16
constexpr int STAGES = 2;              // the streamed operands' ring
constexpr int PRODUCER_REGS = 24;      // setmaxnreg: 128 x 24 + 256 x 240
constexpr int CONSUMER_REGS = 240;     //   <= 65,536 registers of the SM

// dK/dV: one block a 64-key tile, two consumer warpgroups: the first sums
// dV = P^T dO, the second dK = dS^T Q, each over NCOL columns (D, or a
// half of D = 256: there two blocks share a key tile, the sums of 64 keys
// x 256 columns being 128 registers a thread), a tile's product 64 columns
// at a time.  Dynamic shared memory,
// from a 1024-byte aligned base: K and V [D / 64][64][64] each, then Q and
// dO [STAGES][D / 64][64][64] each, then the mbarriers.
template <int D>
struct KVL {
  static constexpr int NCH = D / 64;
  static constexpr int NT = 384;                  // 2 consumers + producer
  static constexpr int HALVES = D == 256 ? 2 : 1; // blocks a key tile
  static constexpr int NCOL = D / HALVES;         // columns a block
  static constexpr int K = 0;
  static constexpr int V = K + NCH * BOX;
  static constexpr int Q = V + NCH * BOX;
  static constexpr int DO = Q + STAGES * NCH * BOX;
  static constexpr int BAR = DO + STAGES * NCH * BOX;
  // full_kv, full_q[STAGES], full_do[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// dQ: two consumer warpgroups.  At D <= 128 each owns 64 query rows and
// all D columns of their dQ (128 rows a block); at D = 256 both take the
// block's 64 rows and each owns 128 of the columns, computing the 64 x 64
// S and dP itself (the sums of 64 rows x 256 columns are 128 registers a
// thread, and Q and dO of 128 rows beside a two-stage K/V ring 256 KB).
// Q and dO [ROWS / 64][D / 64][64][64] each, then K and V
// [STAGES][D / 64][64][64] each, then the mbarriers.
template <int D>
struct QL {
  static constexpr int NCH = D / 64;
  static constexpr int NT = 384;
  static constexpr int ROWS = D == 256 ? 64 : 128;       // query rows a block
  static constexpr int NCOL = D == 256 ? 128 : D;        // columns a consumer
  static constexpr int Q = 0;
  static constexpr int DO = Q + ROWS / 64 * NCH * BOX;
  static constexpr int K = DO + ROWS / 64 * NCH * BOX;
  static constexpr int V = K + STAGES * NCH * BOX;
  static constexpr int BAR = V + STAGES * NCH * BOX;
  // full_q, full_k[STAGES], full_v[STAGES], empty[STAGES]
  static constexpr int BYTES = BAR + 8 * (1 + 3 * STAGES) + 1024;
};

// `x`, unknown to the compiler from here on: descriptors of a tile held
// for the whole loop are then formed at each use, not kept in registers.
__device__ __forceinline__ uint32_t opaque(uint32_t x) {
  asm volatile("" : "+r"(x));
  return x;
}

// The 64 x 64 product tile `a` (A's rows by B's rows, fp32) of two tiles
// of 64 rows x D in shared memory, both K-major (D contiguous), as TMA
// wrote them: D / 16 steps of m64n64k16.  Issued, not waited for.
template <int D>
__device__ __forceinline__ void tile_product(float (&a)[32], uint32_t ta,
                                             uint32_t tb) {
#pragma unroll
  for (int ks = 0; ks < D / 16; ++ks) {
    const uint32_t off = (ks / 4) * BOX + (ks % 4) * 32;
    wgmma_ss<64, 0>(a, desc(ta + off, 16, 1024), desc(tb + off, 16, 1024),
                    ks > 0);
  }
}

// Whether any score of the tile needs tanh's exact-division path (|s k_in|
// >= 1/8): one answer for the whole warp, so its branch stays uniform.
__device__ __forceinline__ bool cap_is_big(const float (&s)[32],
                                           float k_in) {
  float big = 0.0f;
#pragma unroll
  for (int j = 0; j < 32; ++j) big = fmaxf(big, fabsf(s[j]));
  return __any_sync(0xffffffffu, big * k_in >= 0.125f);
}

// P of one pair from its score s = q . k and its row's log-sum-exp L, P =
// e^(c - L), exactly 0 off the window; *slope = c'(s), the cap's slope.
__device__ __forceinline__ float prob(float s, float L, bool live,
                                      bool capped, bool big, float scale,
                                      float k_in, float softcap,
                                      float* slope) {
  float c = s * scale;
  *slope = 1.0f;
  if (capped) {
    const float y = s * k_in;
    const float t = big ? tanh_any(y) : tanh_small(y);
    c = t * softcap;
    *slope = 1.0f - t * t;
  }
  return live ? ex2((c - L) * LOG2E) : 0.0f;
}

// The fp32 entries x of an m64n64 accumulator as the A operand of four
// m64nNk16 steps, split into three bf16 terms: t[0] = bf16(x), t[1] =
// bf16(x - t[0]), t[2] = bf16(x - t[0] - t[1]); together ~24 bits of x,
// as fp32 holds (two terms keep ~16, and an entry of dV or dK that
// cancels to ~1e-4 of its terms then misses the kernel-vs-plain limit).
// Step kk takes the pairs 4 kk .. 4 kk + 3.
__device__ __forceinline__ void split_a(const float (&x)[32],
                                        uint32_t (&t)[3][4][4]) {
#pragma unroll
  for (int j = 0; j < 16; ++j) {
    float r0 = x[2 * j], r1 = x[2 * j + 1];
#pragma unroll
    for (int u = 0; u < 3; ++u) {
      const __nv_bfloat162 h = __floats2bfloat162_rn(r0, r1);
      const float2 hf = __bfloat1622float2(h);
      r0 -= hf.x;
      r1 -= hf.y;
      t[u][j / 4][j % 4] = *reinterpret_cast<const uint32_t*>(&h);
    }
#ifdef REPRO_TWO_TERMS
    t[2][j / 4][j % 4] = 0u;   // planted fault: x to ~2^-17 only
#endif
  }
}

__device__ __forceinline__ void hold3(uint32_t (&t)[3][4][4]) {
#pragma unroll
  for (int u = 0; u < 3; ++u) hold(t[u]);
}

// acc (64 x N) = A (64 x 64, as three terms) * B (fresh; else +=), B 64
// rows x N columns in shared memory from `tb`, MN-major (boxes of 64
// columns BOX apart).  The smallest terms go first, so few of the
// accumulator's roundings fall at the sum's full size; the caller adds a
// fresh acc into its fp32 sums (FADD, rounding to nearest: the tensor
// cores' accumulator over thousands of steps drifts by ~1e-4 of the sum).
template <int N>
__device__ __forceinline__ void product_rs(float (&acc)[N / 2],
                                           const uint32_t (&t)[3][4][4],
                                           uint32_t tb, bool fresh) {
#pragma unroll
  for (int u = 2; u >= 0; --u)
#pragma unroll
    for (int kk = 0; kk < 4; ++kk)
      wgmma_rs<N>(acc, t[u][kk], desc(tb + kk * 2048, BOX, 1024),
                  !(fresh && u == 2 && kk == 0));
}

// The sums of a consumer: each tile's product `part` in fresh tensor-core
// accumulators, added into `sum` by FADD; with REPRO_TC_SUMS_ONLY (a
// planted fault) the products go straight into `sum` in the tensor cores.
template <int N>
__device__ __forceinline__ void add_product(float (&sum)[N / 2],
                                            float (&part)[N / 2],
                                            uint32_t (&t)[3][4][4],
                                            uint32_t tb) {
#ifdef REPRO_TC_SUMS_ONLY
  hold(sum);
  wg_fence();
  product_rs<N>(sum, t, tb, false);
  wg_commit();
  wg_wait_all();
  hold(sum);
#else
  // the product overwrites part; zeros tell the compiler so, and part
  // then holds no registers between tiles
#pragma unroll
  for (int x = 0; x < N / 2; ++x) part[x] = 0.0f;
  wg_fence();
  product_rs<N>(part, t, tb, true);
  wg_commit();
  wg_wait_all();
  hold(part);
#pragma unroll
  for (int x = 0; x < N / 2; ++x) sum[x] += part[x];
#endif
  hold3(t);
}

// One consumer warpgroup of bwd_dkdv_wgmma: DK false sums dV = P^T dO, DK
// true dK = dS^T Q (scaled at the store), over columns c0 .. c0 + NCOL - 1
// of the keys k0 .. k0 + 63, walking the query heads of the group and
// their query tiles qt_first .. qt_last in order.  No wgmma is in flight
// across a branch: ptxas would serialize around it.
template <int D, bool DK>
__device__ __forceinline__ void dkdv_consumer(
    uint32_t base, uint32_t full_q, uint32_t full_do, uint32_t empty,
    const float* __restrict__ lse, const float* __restrict__ delta,
    __nv_bfloat16* __restrict__ out, Strides so, int S, int H, int group,
    int window, float scale, float softcap, int b, int hk, int k0, int c0,
    int qt_first, int qt_last) {
  using L = KVL<D>;
  constexpr int NCH = L::NCH, NCOL = L::NCOL;
  const int warp = threadIdx.x % 128 / 32, lane = threadIdx.x % 32;
  const int key0 = k0 + 16 * warp + lane / 4;     // and key0 + 8
  const int col = 2 * (lane % 4);                 // and col + 1, + 8 n
  const uint32_t k_base = base + L::K, v_base = base + L::V;
  const bool capped = softcap > 0.0f;
  const float k_in = scale / softcap;

  // the sums, 64 columns a piece; each piece's product of a tile
  float sum[NCOL / 64][32], part[32];
#pragma unroll
  for (int h = 0; h < NCOL / 64; ++h)
#pragma unroll
    for (int x = 0; x < 32; ++x) sum[h][x] = 0.0f;

  int i = 0;
  for (int hh = 0; hh < group; ++hh) {
    const long long row0 = (static_cast<long long>(b) * H + hk * group + hh) *
                           S;
    for (int qt = qt_first; qt <= qt_last; ++qt, ++i) {
      const int s = i % STAGES;
      const uint32_t par = (i / STAGES) & 1;
      const int q0 = 64 * qt;
      const int q_hi = min(q0 + 63, S - 1);
      // a live pair of these keys among these rows; pairs to mask: past
      // the diagonal, below the window's lower edge, or rows past S
      const bool active = k0 <= q_hi && q0 - (k0 + 63) < window;
      const bool masked =
          q0 < k0 + 63 || q0 + 63 - k0 >= window || q0 + 63 >= S;
      const uint32_t q_base = base + L::Q + s * NCH * BOX;
      const uint32_t do_base = base + L::DO + s * NCH * BOX;
      mbar_wait(full_q + 8 * s, par);
      mbar_wait(full_do + 8 * s, par);
      if (active) {
        float st[32], dpt[32];        // S^T, dP^T: keys by query rows; st
                                      //   then holds P (dV) or dS (dK)
#pragma unroll
        for (int j = 0; j < 32; ++j) st[j] = dpt[j] = 0.0f;
        hold(st);
        if constexpr (DK) hold(dpt);
        wg_fence();
        tile_product<D>(st, opaque(k_base), q_base);
        if constexpr (DK) tile_product<D>(dpt, opaque(v_base), do_base);
        wg_commit();
        // lse (and Dlt) of query row q0 + 8 (j / 2) + col + j % 2, read
        // while the products run
        float Lq[16], Dq[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          const int qi = q0 + 8 * (j / 2) + col + j % 2;
          Lq[j] = qi < S ? lse[row0 + qi] : 0.0f;
          Dq[j] = DK && qi < S ? delta[row0 + qi] : 0.0f;
        }
        wg_wait_all();
        hold(st);
        if constexpr (DK) hold(dpt);
        const bool big = capped && cap_is_big(st, k_in);
        // st[4n + e]: key key0 + 8 (e / 2), query row q0 + 8 n + col + e % 2
#pragma unroll
        for (int j = 0; j < 32; ++j) {
          const int n = j / 4, r = (j % 4) / 2, e2 = j % 2;
          const int qi = q0 + 8 * n + col + e2, kj = key0 + 8 * r;
          const bool live =
              !masked || (qi < S && kj <= qi && qi - kj < window);
          float slope;
          const float p = prob(st[j], Lq[2 * n + e2], live, capped, big,
                               scale, k_in, softcap, &slope);
          if constexpr (DK)
            st[j] = live ? p * (dpt[j] - Dq[2 * n + e2]) * slope : 0.0f;
          else
            st[j] = p;
        }
        // P^T dO (dV) or dS^T Q (dK) over this tile's 64 query rows
        uint32_t terms[3][4][4];
        split_a(st, terms);
        const uint32_t b_base = (DK ? q_base : do_base) + (c0 / 64) * BOX;
#pragma unroll
        for (int h = 0; h < NCOL / 64; ++h)
          add_product<64>(sum[h], part, terms, b_base + h * BOX);
      }
      if (lane == 0) mbar_arrive(empty + 8 * s);
    }
  }

  const float f = DK ? scale : 1.0f;
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int kj = key0 + 8 * r;
    if (kj >= S) continue;
    __nv_bfloat16* row = out + b * so.b + hk * so.h +
                         static_cast<long long>(kj) * so.s + c0 + col;
#pragma unroll
    for (int h = 0; h < NCOL / 64; ++h)
#pragma unroll
      for (int n = 0; n < 8; ++n)
        *reinterpret_cast<__nv_bfloat162*>(row + 64 * h + 8 * n) =
            __floats2bfloat162_rn(sum[h][4 * n + 2 * r] * f,
                                  sum[h][4 * n + 2 * r + 1] * f);
  }
}

template <int D>
__global__ void __launch_bounds__(KVL<D>::NT, 1)
    bwd_dkdv_wgmma(const __grid_constant__ CUtensorMap mq,
                   const __grid_constant__ CUtensorMap mk,
                   const __grid_constant__ CUtensorMap mv,
                   const __grid_constant__ CUtensorMap mdo,
                   const float* __restrict__ lse,
                   const float* __restrict__ delta,
                   __nv_bfloat16* __restrict__ dk,
                   __nv_bfloat16* __restrict__ dv, Strides sdk, Strides sdv,
                   int S, int H, int Hkv, int B, int group, int window,
                   float scale, float softcap) {
  using L = KVL<D>;
  constexpr int NCH = L::NCH;
  extern __shared__ __align__(1024) uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023u) & ~1023u;
  const uint32_t full_kv = base + L::BAR;
  const uint32_t full_q = full_kv + 8, full_do = full_q + 8 * STAGES;
  const uint32_t empty = full_do + 8 * STAGES;

  // the first key tiles see the most query rows: the tile index varies
  // slowest, and they launch first
  const int per = Hkv * B, blk = static_cast<int>(blockIdx.x);
  const int kt = blk / (per * L::HALVES);
  const int c0 = blk / per % L::HALVES * L::NCOL;  // this block's columns
  const int hk = blk % per % Hkv, b = blk % per / Hkv;
  const int k0 = 64 * kt;
  const int k_hi = min(k0 + 63, S - 1);
  // query rows that see a key of this tile: k0 .. k_hi + window - 1
  const int qt_first = k0 / 64;
  const int qt_last = min(S - 1, k_hi + window - 1) / 64;

  if (threadIdx.x == 0) {
    mbar_init(full_kv, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_q + 8 * s, 1);
      mbar_init(full_do + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);      // lane 0 of each consumer warp
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {             // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 256) return;     // one thread issues the TMA
    mbar_expect_tx(full_kv, 2 * NCH * BOX);
    for (int ch = 0; ch < NCH; ++ch) {
      tma_load_4d(base + L::K + ch * BOX, &mk, full_kv, 64 * ch, k0, hk, b);
      tma_load_4d(base + L::V + ch * BOX, &mv, full_kv, 64 * ch, k0, hk, b);
    }
    int i = 0;
    for (int hh = 0; hh < group; ++hh)
      for (int qt = qt_first; qt <= qt_last; ++qt, ++i) {
        const int s = i % STAGES, h = hk * group + hh;
        if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
        mbar_expect_tx(full_q + 8 * s, NCH * BOX);
        for (int ch = 0; ch < NCH; ++ch)
          tma_load_4d(base + L::Q + (s * NCH + ch) * BOX, &mq, full_q + 8 * s,
                      64 * ch, 64 * qt, h, b);
        mbar_expect_tx(full_do + 8 * s, NCH * BOX);
        for (int ch = 0; ch < NCH; ++ch)
          tma_load_4d(base + L::DO + (s * NCH + ch) * BOX, &mdo,
                      full_do + 8 * s, 64 * ch, 64 * qt, h, b);
      }
    return;
  }

  // consumer warpgroup 0 sums dV, 1 sums dK; both need P, only 1 needs dS
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  mbar_wait(full_kv, 0);
  if (threadIdx.x >= 128)
    dkdv_consumer<D, true>(base, full_q, full_do, empty, lse, delta, dk, sdk,
                           S, H, group, window, scale, softcap, b, hk, k0, c0,
                           qt_first, qt_last);
  else
    dkdv_consumer<D, false>(base, full_q, full_do, empty, lse, delta, dv,
                            sdv, S, H, group, window, scale, softcap, b, hk,
                            k0, c0, qt_first, qt_last);
}

template <int D>
__global__ void __launch_bounds__(QL<D>::NT, 1)
    bwd_dq_wgmma(const __grid_constant__ CUtensorMap mq,
                 const __grid_constant__ CUtensorMap mk,
                 const __grid_constant__ CUtensorMap mv,
                 const __grid_constant__ CUtensorMap mdo,
                 const float* __restrict__ lse,
                 const float* __restrict__ delta,
                 __nv_bfloat16* __restrict__ dq, Strides sdq, int S, int H,
                 int B, int group, int window, float scale, float softcap) {
  using L = QL<D>;
  constexpr int NCH = L::NCH, NCOL = L::NCOL;
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
  const int q_lo = qt * L::ROWS;
  const int t_first = max(0, q_lo - window + 1) / 64;
  const int t_last = (min(q_lo + L::ROWS, S) - 1) / 64;

  if (threadIdx.x == 0) {
    mbar_init(full_q, 1);
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full_k + 8 * s, 1);
      mbar_init(full_v + 8 * s, 1);
      mbar_init(empty + 8 * s, 8);
    }
    mbar_init_fence();
  }
  __syncthreads();

  if (threadIdx.x >= 256) {             // the producer warpgroup
    asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(PRODUCER_REGS));
    if (threadIdx.x != 256) return;
    mbar_expect_tx(full_q, 2 * (L::ROWS / 64) * NCH * BOX);
    for (int c = 0; c < L::ROWS / 64; ++c)
      for (int ch = 0; ch < NCH; ++ch) {
        tma_load_4d(base + L::Q + (c * NCH + ch) * BOX, &mq, full_q, 64 * ch,
                    q_lo + 64 * c, h, b);
        tma_load_4d(base + L::DO + (c * NCH + ch) * BOX, &mdo, full_q,
                    64 * ch, q_lo + 64 * c, h, b);
      }
    for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
      const int s = i % STAGES;
      if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
      mbar_expect_tx(full_k + 8 * s, NCH * BOX);
      for (int ch = 0; ch < NCH; ++ch)
        tma_load_4d(base + L::K + (s * NCH + ch) * BOX, &mk, full_k + 8 * s,
                    64 * ch, 64 * t, hk, b);
      mbar_expect_tx(full_v + 8 * s, NCH * BOX);
      for (int ch = 0; ch < NCH; ++ch)
        tma_load_4d(base + L::V + (s * NCH + ch) * BOX, &mv, full_v + 8 * s,
                    64 * ch, 64 * t, hk, b);
    }
    return;
  }

  // a consumer warpgroup: rows r_lo .. r_lo + 63, columns c0 .. c0 + NCOL - 1
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(CONSUMER_REGS));
  const int wg = threadIdx.x / 128, warp = threadIdx.x % 128 / 32;
  const int lane = threadIdx.x % 32;
  const int rw = L::ROWS == 128 ? wg : 0;        // this warpgroup's rows
  const int c0 = L::ROWS == 128 ? 0 : NCOL * wg;
  const int r_lo = q_lo + 64 * rw;
  const int r_hi = min(r_lo + 63, S - 1);
  const int row0 = r_lo + 16 * warp + lane / 4;   // and row0 + 8
  const int col = 2 * (lane % 4);                 // and col + 1, + 8 n
  const uint32_t q_base = base + L::Q + rw * NCH * BOX;
  const uint32_t do_base = base + L::DO + rw * NCH * BOX;
  const bool capped = softcap > 0.0f;
  const float k_in = scale / softcap;
  const long long lrow = (static_cast<long long>(b) * H + h) * S;
  float Lr[2], Dr[2];
#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    Lr[r] = qi < S ? lse[lrow + qi] : 0.0f;
    Dr[r] = qi < S ? delta[lrow + qi] : 0.0f;
  }

  float sum[NCOL / 2], part[NCOL / 2];
#pragma unroll
  for (int x = 0; x < NCOL / 2; ++x) sum[x] = 0.0f;

  mbar_wait(full_q, 0);
  for (int t = t_first, i = 0; t <= t_last; ++t, ++i) {
    const int s = i % STAGES;
    const uint32_t par = (i / STAGES) & 1;
    const int k0 = 64 * t;
    // a live pair of these rows in this tile: keys r_lo - w + 1 .. r_hi
    const bool active = r_lo < S && k0 <= r_hi && k0 + 63 > r_lo - window;
    const bool masked = k0 + 63 > r_lo || k0 < r_hi - window + 1;
    const uint32_t k_base = base + L::K + s * NCH * BOX;
    const uint32_t v_base = base + L::V + s * NCH * BOX;
    mbar_wait(full_k + 8 * s, par);
    mbar_wait(full_v + 8 * s, par);
    if (active) {
      float sc[32], dp[32];
#pragma unroll
      for (int j = 0; j < 32; ++j) sc[j] = dp[j] = 0.0f;
      hold(sc);
      hold(dp);
      wg_fence();
      tile_product<D>(sc, opaque(q_base), k_base);
      tile_product<D>(dp, opaque(do_base), v_base);
      wg_commit();
      wg_wait_all();
      hold(sc);
      hold(dp);
      const bool big = capped && cap_is_big(sc, k_in);
      // sc[4n + e]: row row0 + 8 (e / 2), key k0 + 8 n + col + e % 2
#pragma unroll
      for (int j = 0; j < 32; ++j) {
        const int r = (j % 4) / 2, qi = row0 + 8 * r;
        const int kj = k0 + 8 * (j / 4) + col + j % 2;
        const bool live = !masked || (kj <= qi && qi - kj < window);
        float slope;
        const float p = prob(sc[j], Lr[r], live, capped, big, scale, k_in,
                             softcap, &slope);
        dp[j] = live ? p * (dp[j] - Dr[r]) * slope : 0.0f;
      }
      uint32_t terms[3][4][4];
      split_a(dp, terms);
      add_product<NCOL>(sum, part, terms, k_base + (c0 / 64) * BOX);  // dS K
    }
    if (lane == 0) mbar_arrive(empty + 8 * s);
  }

#pragma unroll
  for (int r = 0; r < 2; ++r) {
    const int qi = row0 + 8 * r;
    if (qi >= S) continue;
    __nv_bfloat16* qrow = dq + b * sdq.b + h * sdq.h +
                          static_cast<long long>(qi) * sdq.s + c0 + col;
#pragma unroll
    for (int n = 0; n < NCOL / 8; ++n)
      *reinterpret_cast<__nv_bfloat162*>(qrow + 8 * n) = __floats2bfloat162_rn(
          sum[4 * n + 2 * r] * scale, sum[4 * n + 2 * r + 1] * scale);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, const void* o,
           const void* dO, const float* lse, float* delta, void* dq, void* dk,
           void* dv, int B, int H, int Hkv, int S, const long long* st,
           int window, float scale, float softcap, cudaStream_t stream) {
  const Strides so{st[9], st[10], st[11]}, sdo{st[12], st[13], st[14]},
      sdq{st[15], st[16], st[17]}, sdk{st[18], st[19], st[20]},
      sdv{st[21], st[22], st[23]};
  // Dlt first: the launch also makes the device's primary context current
  // on this thread, which libcuda's tensor-map encoder below needs (the
  // autograd engine calls the backward from a thread of its own)
  using T = __nv_bfloat16;
  const long long rows = static_cast<long long>(B) * H * S;
  bwd_delta<T, D><<<static_cast<unsigned>((rows + NT / 32 - 1) / (NT / 32)),
                    NT, 0, stream>>>(static_cast<const T*>(o),
                                     static_cast<const T*>(dO), delta, so,
                                     sdo, H, S, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap mq, mk, mv, mdo;
  err = encode_attn(&mq, q, D, S, H, B, st);
  if (err == cudaSuccess) err = encode_attn(&mk, k, D, S, Hkv, B, st + 3);
  if (err == cudaSuccess) err = encode_attn(&mv, v, D, S, Hkv, B, st + 6);
  if (err == cudaSuccess) err = encode_attn(&mdo, dO, D, S, H, B, st + 12);
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kv = bwd_dkdv_wgmma<D>;
  err = cudaFuncSetAttribute(kv, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             KVL<D>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nkv = (S + 63) / 64 * KVL<D>::HALVES * Hkv * B;
  kv<<<nkv, KVL<D>::NT, KVL<D>::BYTES, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dk), static_cast<T*>(dv),
      sdk, sdv, S, H, Hkv, B, H / Hkv, window, scale, softcap);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);

  auto kq = bwd_dq_wgmma<D>;
  err = cudaFuncSetAttribute(kq, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             QL<D>::BYTES);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nq = (S + QL<D>::ROWS - 1) / QL<D>::ROWS * H * B;
  kq<<<nq, QL<D>::NT, QL<D>::BYTES, stream>>>(
      mq, mk, mv, mdo, lse, delta, static_cast<T*>(dq), sdq, S, H, B,
      H / Hkv, window, scale, softcap);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace tc

}  // namespace

extern "C" int repro_local_attention_bwd(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dq, void* dk,
    void* dv, long long B, long long H, long long Hkv, long long S,
    long long D, const long long* strides, long long window, float scale,
    float softcap, int is_bf16, void* stream) {
  cudaGetLastError();  // report this call's launches, not an older error
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(window < S ? window : S);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  if (is_bf16)
    return dispatch<__nv_bfloat16>(q, k, v, o, dO, l, dl, dq, dk, dv, (int)B,
                                   (int)H, (int)Hkv, (int)S, (int)D, strides,
                                   w, scale, softcap, s);
  return dispatch<float>(q, k, v, o, dO, l, dl, dq, dk, dv, (int)B, (int)H,
                         (int)Hkv, (int)S, (int)D, strides, w, scale, softcap,
                         s);
}

extern "C" int repro_local_attention_bwd_wgmma(
    const void* q, const void* k, const void* v, const void* o,
    const void* dO, const void* lse, void* delta, void* dq, void* dk,
    void* dv, long long B, long long H, long long Hkv, long long S,
    long long D, const long long* strides, long long window, float scale,
    float softcap, void* stream) {
  cudaGetLastError();
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const int w = static_cast<int>(window < S ? window : S);
  const float* l = static_cast<const float*>(lse);
  float* dl = static_cast<float*>(delta);
  switch (D) {
    case 64:
      return tc::launch<64>(q, k, v, o, dO, l, dl, dq, dk, dv, (int)B, (int)H,
                            (int)Hkv, (int)S, strides, w, scale, softcap, s);
    case 128:
      return tc::launch<128>(q, k, v, o, dO, l, dl, dq, dk, dv, (int)B,
                             (int)H, (int)Hkv, (int)S, strides, w, scale,
                             softcap, s);
    case 256:
      return tc::launch<256>(q, k, v, o, dO, l, dl, dq, dk, dv, (int)B,
                             (int)H, (int)Hkv, (int)S, strides, w, scale,
                             softcap, s);
  }
  return static_cast<int>(cudaErrorInvalidValue);
}
