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
// written once: the arithmetic bounds it at every configured shape.  This
// first version sums with FFMA (67 TFLOP/s at most, never TF32) on fp32
// tiles in shared memory, and recomputes the scores and dP in both of its
// passes (14 D flop a pair); the tensor cores are later work.
//
// Three kernels, launched in order on one stream; no atomics and no sum
// across blocks, so reruns are bitwise equal:
//
// 1. bwd_delta: Dlt (B, H, S) fp32, one warp a row, a fixed butterfly.
// 2. bwd_dkdv: one block a (key tile of 64, K/V head, batch); it keeps its
//    tile's K and V in shared memory and dK, dV in registers, and walks the
//    query heads of its group and, for each, the query tiles that see a key
//    of its tile, in a fixed order.  Query tiles of 64 rows (32 at D = 256,
//    so the tiles fit 227 KB).
// 3. bwd_dq: one block a (query tile of 64, head, batch); Q and dO stay in
//    shared memory, dQ in registers, and the block walks its live key
//    tiles (64 keys; 32 at D = 256).  The heaviest tiles launch first in
//    both passes.
//
// Threads: 256 a block as a 16 x 16 grid; thread (ty, tx) computes the score
// and dP entries of query rows ty * RQ + r and keys tx + 16 c of a tile, as
// the forward's FFMA route does, and the products with P and dS go through
// shared memory.
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_local_attention_bwd(q, k, v, o, dO, lse, delta, dq, dk, dv,
//                                 B, H, Hkv, S, D, strides[24], window,
//                                 scale, softcap, is_bf16, stream)
// strides: (b, h, s) of q, k, v, o, dO, dq, dk, dv in elements; lse and
// delta are (B, H, S) fp32 contiguous (delta is scratch the caller
// allocates).  The launcher returns cudaGetLastError() after the last launch
// (0 on success) or cudaErrorInvalidValue for a D it has no instance for;
// it allocates nothing.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <math.h>
#include <stdint.h>

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
