// RWKV-6's recurrence (rwkv6's time mix), written for Hopper (sm_90a).  All
// operands fp32, contiguous; r, k, v, w and S0 16-byte aligned.
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
// element: bytes bound it, 0.101 ms at the prefill's (2, 4096, 32, 64).  A
// state kept bitwise the plain loop's costs 4 FP32 instructions an
// element-step (below), 1.07e9 element-steps there: 0.128 ms on 132 x 128
// lanes at 1.98 GHz, the ceiling of any design that keeps it.
//
// The update S[i][j] <- w_i S[i][j] + k_i v_j is elementwise: no state
// element reads another, and only the output sums over i.  So the state is
// spread over the card and advanced a chunk of steps between barriers (one
// block a (b, h) and one thread a value column ran a step a barrier on 64
// SMs, at 3 % of the bound):
//   * A block holds JB value columns of one head (all hd keys), so a head
//     spans hd / JB blocks: 128 blocks at the prefill's shape.  Its first
//     NT threads own the state in registers, KI keys x JT columns each; a
//     warp's lanes run across the columns, its warps across the key groups
//     (r, k, w reach a warp as broadcast 16-byte reads).
//   * Its other NF = 128 threads (a warp on each scheduler) stage chunk c + 1
//     by cp.async into a three-stage ring and finish chunk c - 1's outputs
//     while the state threads take chunk c's steps: one barrier a chunk.
//   * A state thread writes, each step, its key group's partial o_t (an FMA
//     chain over its keys, from the state before the step) to one of two
//     shared buffers; the finishing threads sum the partials in group order
//     and store the chunk's outputs as 16-byte rows.
//   * The bonus term is factored: sum_i r_i u_i k_i v_j = v_j (sum_i r_i u_i
//     k_i), one scalar a step and head, summed by a finishing warp (lane l's
//     FMA chain over keys l, l + 32, ..., then a butterfly of shuffles).  A
//     step then costs an element 4 FP32 instructions (k v, w S, their sum,
//     the output's FMA), not 6.
//   * The state update rounds as the plain version's elementwise ops
//     (__fmul_rn, __fadd_rn: k v rounded, w S rounded, then the sum), so S_T
//     equals it bit for bit; the output sums in another order than its
//     einsum (held to a tolerance).  No atomics: reruns are bitwise.
//
// Training: where autograd records, the forward also writes S at the start
// of each of its chunks (Sc, (B, H, ceil(T / C), hd, hd)): one store a chunk
// from the state threads, in an instance of its own (STATES) behind an entry
// point of its own (repro_wkv6_states), so inference (repro_wkv6) runs the
// same code through the same interface as before it existed.
//
// The gradient (wkv6_bwd_kernel): with do = dL/dout and D = dL/dS_t (dS_T,
// or zeros where the state output is unused), from t = T - 1 down
// (b_t = v_t . do_t, q_t = sum_i r_t[i] u_i k_t[i]):
//   dr_t[i] = sum_j S_{t-1}[i][j] do_t[j] + u_i k_t[i] b_t
//   dk_t[i] = sum_j D[i][j] v_t[j] + u_i r_t[i] b_t
//   dv_t[j] = sum_i D[i][j] k_t[i] + q_t do_t[j]
//   dw_t[i] = sum_j D[i][j] S_{t-1}[i][j]
//   du_i += r_t[i] k_t[i] b_t;  then D <- w_t[i] D[i][j] + r_t[i] do_t[j]
// and dS0 is the last D.  dw needs S_{t-1} beside D at the same step, and
// undoing the decay ((S_t - k v) / w) is unstable (decays below 1e-30 occur):
// the states are recomputed forward from the chunk starts in the forward's
// rounding, so they are bitwise the forward's.  Bound at a training step's
// (8, 2048, 32, 64): 36 bytes an element (r, k, v, w, do read; dr, dk, dv, dw
// written), 0.36 ms, against ~13 FP32 instructions an element-step here (3
// recomputing S once to find the sub-chunk starts and again to keep their
// states, 3 updating D, 4 FMAs of the sums): 0.84 ms on 132 x 128 lanes at
// 1.98 GHz.  What the design does (a first, simple kernel: its redesign is
// later work):
//   * A block holds JB (<= 32) value columns of one head and all hd keys, a
//     thread KI = 2 keys x JT = 4 columns of D and S in registers; a warp's
//     lanes run across NCG = JB / 4 column groups, then key groups.
//   * Per chunk of the forward (C steps, newest first), all threads stage
//     r, k, w, v, do (whole rows) by cp.async; each warp sums b_t and q_t of
//     some steps (lane FMA chains, then a butterfly).  The chunk's states are
//     recomputed from its saved start, keeping one start a sub-chunk of
//     U = 8 steps in shared memory; each sub-chunk, newest first, is
//     recomputed again into registers (its U states) and walked back.
//   * Sums over j (dr, dk, dw) are FMA chains over a thread's 4 columns,
//     then a butterfly over the column lanes; they are written per block
//     (partials over its JB columns, the bonus terms by the first block)
//     and summed over the hd / JB blocks by the wrapper in a fixed order.
//     Sums over i (dv) are chains over the thread's 2 keys, a butterfly
//     over the key lanes, then the warps' sums in warp order through
//     shared memory.  du is the first block's chains over t, summed over b
//     by the wrapper.  No atomics: reruns are bitwise.
//   * D rounds as the plain reverse loop does (__fmul_rn w D, __fmul_rn
//     r do, __fadd_rn), so dS0 equals it bit for bit.
//
// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_wkv6(r, k, v, w, u, S0, out, S_T, B, T, H, hd, stream)
//   int repro_wkv6_states(r, k, v, w, u, S0, out, S_T, Sc, B, T, H, hd,
//                         stream)
//   int repro_wkv6_bwd(r, k, v, w, u, Sc, dout, dS_T, dr, dk, dv, dw, du,
//                      dS0, B, T, H, hd, stream)
//   int repro_wkv6_chunk(hd)       steps a chunk, C: Sc has ceil(T / C)
//   int repro_wkv6_bwd_parts(hd)   the backward's partials, hd / JB
// hd is one of 16, 32, 64, 128 (the last two return 0 for another); S0 and
// dS_T may be null.  repro_wkv6_states is the forward that also writes Sc
// (training); repro_wkv6 is inference.  The backward writes dr, dk, dw as
// (hd / JB, B, T, H, hd) partials, du as (B, H, hd), dv and dS0 whole.  The
// launching functions return cudaGetLastError() after their launch (0 on
// success, cudaErrorInvalidValue for another hd or a null Sc,
// cudaErrorMisalignedAddress for an operand not 16-byte aligned); none
// allocates.

#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"

namespace {

using repro_hopper::cp_async;
using repro_hopper::cp_async_commit;
using repro_hopper::cp_async_wait_group;
using repro_hopper::smem_u32;

constexpr int NS = 3;        // stages in the ring (see the chunk loop)
constexpr int NF = 128;      // threads that stage chunks and finish outputs
constexpr int UNROLL = 4;    // steps of the state loop unrolled
constexpr int JT = 2;        // value columns a state thread

__device__ __forceinline__ int64_t lmin(int64_t a, int64_t b) {
  return a < b ? a : b;
}

// keys a state thread (KI), value columns a block (JB), steps a chunk (C),
// by head size
template <int HD> struct Tile;
template <> struct Tile<16> { static constexpr int KI = 4, JB = 16, C = 32; };
template <> struct Tile<32> { static constexpr int KI = 4, JB = 16, C = 32; };
template <> struct Tile<64> { static constexpr int KI = 8, JB = 32, C = 32; };
template <> struct Tile<128> { static constexpr int KI = 8, JB = 32, C = 16; };

template <int HD>
struct Plan {
  static constexpr int KI = Tile<HD>::KI, JB = Tile<HD>::JB;
  static constexpr int C = Tile<HD>::C;
  static constexpr int G = HD / KI;           // key groups
  static constexpr int NCG = JB / JT;         // column groups
  static constexpr int NT = G * NCG;          // threads on the state
  static constexpr int KL = (HD + 31) / 32;   // keys a lane of the bonus sum
  static constexpr int RG = HD / 4;           // 16-byte copies a row of r
  static constexpr int VG = JB / 4;           // 16-byte copies a row of v
  static constexpr int SW = 32 / VG;          // steps a warp's output row
  // shared memory, in floats: NS stages of (r, k, w: C x HD; v: C x JB) and
  // two buffers of partial outputs (C x G x JB)
  static constexpr int STAGE = C * (3 * HD + JB);
  static constexpr int PART = C * G * JB;
  static constexpr size_t BYTES = sizeof(float) * (NS * STAGE + 2 * PART);
  static_assert(NT % 32 == 0 && KI % 4 == 0 && 32 % VG == 0 &&
                NF % RG == 0 && NF % VG == 0 && (C * VG) % 32 == 0, "tiles");
};

// N (2 or 4) consecutive floats, one 8- or 16-byte access
template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float (&x)[N]) {
  if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* p, const float (&x)[N]) {
  if constexpr (N == 2)
    *reinterpret_cast<float2*>(p) = make_float2(x[0], x[1]);
  else
    *reinterpret_cast<float4*>(p) = make_float4(x[0], x[1], x[2], x[3]);
}

__device__ __forceinline__ void copy16(float* dst, const float* src) {
  cp_async<16>(smem_u32(dst), src, 16);
}

// Steps [0, n) of a chunk of (b, h) from element `row` (step 0's row; rows
// ld apart) into a stage: rows of r, k, w (HD) and v (the block's JB columns
// from j0).  A thread keeps one 16-byte column of the rows it copies
// (consecutive threads on consecutive columns) and steps down the rows.
template <int HD>
__device__ __forceinline__ void stage_chunk(
    float* st, const float* __restrict__ r, const float* __restrict__ k,
    const float* __restrict__ w, const float* __restrict__ v, int64_t row,
    int64_t ld, int j0, int n, int tid) {
  using P = Plan<HD>;
  constexpr int C = P::C;
  const int c = 4 * (tid % P::RG);
  for (int t = tid / P::RG; t < n; t += NF / P::RG) {
    const int64_t src = row + t * ld + c;
    copy16(st + t * HD + c, r + src);
    copy16(st + C * HD + t * HD + c, k + src);
    copy16(st + 2 * C * HD + t * HD + c, w + src);
  }
  const int cv = 4 * (tid % P::VG);
  for (int t = tid / P::VG; t < n; t += NF / P::VG)
    copy16(st + 3 * C * HD + t * P::JB + cv, v + row + t * ld + j0 + cv);
}

// Step t's operands of a thread: r, k, w of its KI keys from i0 (16-byte
// broadcast reads), v of its JT columns from jt.
template <int HD>
__device__ __forceinline__ void load_step(const float* st, int t, int i0,
                                          int jt, float (&rr)[Plan<HD>::KI],
                                          float (&kk)[Plan<HD>::KI],
                                          float (&ww)[Plan<HD>::KI],
                                          float (&vv)[JT]) {
  using P = Plan<HD>;
  constexpr int C = P::C;
#pragma unroll
  for (int a = 0; a < P::KI; a += 4) {
    float r4[4], k4[4], w4[4];
    ld_vec<4>(st + t * HD + i0 + a, r4);
    ld_vec<4>(st + C * HD + t * HD + i0 + a, k4);
    ld_vec<4>(st + 2 * C * HD + t * HD + i0 + a, w4);
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      rr[a + e] = r4[e];
      kk[a + e] = k4[e];
      ww[a + e] = w4[e];
    }
  }
  ld_vec<JT>(st + 3 * C * HD + t * P::JB + jt, vv);
}

// One step of a thread's elements: its key group's partial output (an FMA
// chain over its keys, from the state before the step) stored at p, then
// S <- w S + k v, each product and the sum rounded as the plain loop does.
template <int HD>
__device__ __forceinline__ void advance(
    float (&S)[Plan<HD>::KI][JT], const float (&rr)[Plan<HD>::KI],
    const float (&kk)[Plan<HD>::KI], const float (&ww)[Plan<HD>::KI],
    const float (&vv)[JT], float* p) {
  float acc[JT];
#pragma unroll
  for (int b = 0; b < JT; ++b) acc[b] = 0.f;
#pragma unroll
  for (int a = 0; a < Plan<HD>::KI; ++a) {
#pragma unroll
    for (int b = 0; b < JT; ++b) {
      acc[b] = fmaf(rr[a], S[a][b], acc[b]);
      const float kv = __fmul_rn(kk[a], vv[b]);
      S[a][b] = __fadd_rn(__fmul_rn(ww[a], S[a][b]), kv);
    }
  }
  st_vec<JT>(p, acc);
}

// The outputs of a chunk's steps [0, n) staged at st, whose partials are at
// part: o_t[j] = (the partials in group order) + v_j b_t, where the bonus
// sum b_t = sum_i (r_i u_i) k_i is lane l's FMA chain over keys l, l + 32,
// ... met with the other lanes' in a butterfly of shuffles (the same order
// on every lane).  A warp takes SW whole steps of outputs (16-byte rows) a
// pass, and sums their SW bonus terms itself.
template <int HD>
__device__ __forceinline__ void finish_chunk(
    const float* st, const float* part, const float (&ul)[Plan<HD>::KL],
    float* __restrict__ out, int64_t row, int64_t ld, int j0, int n,
    int tid) {
  using P = Plan<HD>;
  constexpr int C = P::C, JB = P::JB, G = P::G, VG = P::VG, SW = P::SW;
  const int lane = tid % 32;
#pragma unroll 1
  for (int idx = tid; idx < C * VG; idx += NF) {
    const int t0 = (idx - lane) / VG;         // the warp's first step
    float bt = 0.f;
#pragma unroll
    for (int s = 0; s < SW; ++s) {
      const float* rs = st + (t0 + s) * HD;
      float b = 0.f;
#pragma unroll
      for (int m = 0; m < P::KL; ++m) {
        const int i = lane + 32 * m;
        if (i < HD) b = fmaf(rs[i] * ul[m], rs[C * HD + i], b);
      }
#pragma unroll
      for (int d = 16; d >= 1; d /= 2) b += __shfl_xor_sync(~0u, b, d);
      if (s == lane / VG) bt = b;
    }
    const int t = idx / VG, c4 = 4 * (idx % VG);
    if (t < n) {
      float o[4], p[4], vq[4];
      ld_vec<4>(part + t * G * JB + c4, o);
#pragma unroll
      for (int g = 1; g < G; ++g) {
        ld_vec<4>(part + (t * G + g) * JB + c4, p);
#pragma unroll
        for (int e = 0; e < 4; ++e) o[e] += p[e];
      }
      ld_vec<4>(st + 3 * C * HD + t * JB + c4, vq);
#pragma unroll
      for (int e = 0; e < 4; ++e) o[e] = fmaf(vq[e], bt, o[e]);
      st_vec<4>(out + row + t * ld + j0 + c4, o);
    }
  }
}

template <int HD, bool STATES>
__global__ void __launch_bounds__(Plan<HD>::NT + NF, 1)
wkv6_kernel(const float* __restrict__ r, const float* __restrict__ k,
            const float* __restrict__ v, const float* __restrict__ w,
            const float* __restrict__ u, const float* __restrict__ S0,
            float* __restrict__ out, float* __restrict__ ST,
            float* __restrict__ Sc, int64_t T, int H) {
  using P = Plan<HD>;
  constexpr int KI = P::KI, JB = P::JB, G = P::G, NCG = P::NCG;
  constexpr int C = P::C, KL = P::KL;
  extern __shared__ __align__(16) float smem[];
  float* parts = smem + NS * P::STAGE;        // [2][C][G][JB]

  const int jblocks = HD / JB;
  const int64_t bh = blockIdx.x / jblocks;    // b * H + h
  const int j0 = (int)(blockIdx.x - bh * jblocks) * JB;
  const int hh = (int)(bh % H);
  const int64_t bi = bh / H;
  const int64_t ld = (int64_t)H * HD;         // one step of (B, T, H, hd)
  const int64_t row0 = (bi * T * H + hh) * HD;
  const int64_t chunks = (T + C - 1) / C;

  // Threads NT .. NT + NF - 1 stage chunk c + 1 into stage (c + 1) % 3 and
  // finish chunk c - 1 (stage (c - 1) % 3, partial buffer (c - 1) % 2)
  // while threads 0 .. NT - 1 take chunk c's steps (stage c % 3, into
  // buffer c % 2).  One barrier a chunk: past it, chunk c has landed and
  // every thread is done with chunk c - 1's steps and chunk c - 2's outputs.
  if (threadIdx.x >= P::NT) {
    const int f = threadIdx.x - P::NT, lane = f % 32;
    float ul[KL];                             // u of keys lane, lane + 32, ..
#pragma unroll
    for (int m = 0; m < KL; ++m)
      ul[m] = lane + 32 * m < HD ? u[hh * HD + lane + 32 * m] : 0.f;
    stage_chunk<HD>(smem, r, k, w, v, row0, ld, j0, (int)lmin(C, T), f);
    cp_async_commit();
    for (int64_t c = 0; c < chunks; ++c) {
      cp_async_wait_group<0>();
      __syncthreads();
      if (c + 1 < chunks)
        stage_chunk<HD>(smem + ((c + 1) % NS) * P::STAGE, r, k, w, v,
                        row0 + (c + 1) * C * ld, ld, j0,
                        (int)lmin(C, T - (c + 1) * C), f);
      cp_async_commit();
      if (c > 0)
        finish_chunk<HD>(smem + ((c - 1) % NS) * P::STAGE,
                         parts + ((c - 1) & 1) * P::PART, ul, out,
                         row0 + (c - 1) * C * ld, ld, j0, C, f);
    }
    __syncthreads();
    const int64_t last = chunks - 1;
    finish_chunk<HD>(smem + (last % NS) * P::STAGE,
                     parts + (last & 1) * P::PART, ul, out,
                     row0 + last * C * ld, ld, j0, (int)(T - last * C), f);
    return;
  }

  const int kg = threadIdx.x / NCG, cg = threadIdx.x - kg * NCG;
  const int i0 = kg * KI, jt = JT * cg;       // this thread's first key, column
  float S[KI][JT];
#pragma unroll
  for (int a = 0; a < KI; ++a) {
#pragma unroll
    for (int b = 0; b < JT; ++b) S[a][b] = 0.f;
    if (S0 != nullptr) ld_vec<JT>(S0 + (bh * HD + i0 + a) * HD + j0 + jt, S[a]);
  }
  for (int64_t c = 0; c < chunks; ++c) {
    const int n = (int)lmin(C, T - c * C);
    const float* st = smem + (c % NS) * P::STAGE;
    float* part = parts + (c & 1) * P::PART;
    if constexpr (STATES) {                   // the chunk's start, for training
      float* dst = Sc + ((bh * chunks + c) * HD + i0) * HD + j0 + jt;
#pragma unroll
      for (int a = 0; a < KI; ++a) st_vec<JT>(dst + a * HD, S[a]);
    }
    __syncthreads();
    // step t + 1's operands are read before step t's partial is stored (a
    // read past the chunk's last step stays inside shared memory and is
    // not used)
    float rr[KI], kk[KI], ww[KI], vv[JT];
    load_step<HD>(st, 0, i0, jt, rr, kk, ww, vv);
#pragma unroll UNROLL
    for (int t = 0; t < n; ++t) {
      float rn[KI], kn[KI], wn[KI], vn[JT];
      load_step<HD>(st, t + 1, i0, jt, rn, kn, wn, vn);
      advance<HD>(S, rr, kk, ww, vv, part + (t * G + kg) * JB + jt);
#pragma unroll
      for (int a = 0; a < KI; ++a) {
        rr[a] = rn[a];
        kk[a] = kn[a];
        ww[a] = wn[a];
      }
#pragma unroll
      for (int b = 0; b < JT; ++b) vv[b] = vn[b];
    }
  }
  __syncthreads();
#pragma unroll
  for (int a = 0; a < KI; ++a)
    st_vec<JT>(ST + (bh * HD + i0 + a) * HD + j0 + jt, S[a]);
}

// The backward's tiles: KI keys x JT columns a thread, JB columns a block,
// sub-chunks of U steps; C is the forward's chunk (its saved starts).
template <int HD>
struct BPlan {
  static constexpr int KI = 2, JT = 4, U = 8;
  static constexpr int JB = HD < 32 ? HD : 32;
  static constexpr int C = Tile<HD>::C;
  static constexpr int NCG = JB / JT;         // column lanes
  static constexpr int KGW = 32 / NCG;        // key groups a warp
  static constexpr int G = HD / KI;           // key groups
  static constexpr int NT = G * NCG;          // threads
  static constexpr int NW = NT / 32;          // warps
  static constexpr int E = KI * JT;           // elements a thread
  static constexpr int NSUB = C / U;          // sub-chunks a chunk
  static constexpr int KL = (HD + 31) / 32;   // keys a lane of the dot sums
  // shared memory, in floats: a chunk's r, k, w, v, do (C x HD each), its
  // b_t and q_t, the sub-chunk starts (NSUB x E x NT), the warps' dv sums
  // of a sub-chunk (U x NW x JB)
  static constexpr int STAGE = 5 * C * HD;
  static constexpr int CP = NSUB * E * NT;
  static constexpr int DVB = U * NW * JB;
  static constexpr size_t BYTES = sizeof(float) * (STAGE + 2 * C + CP + DVB);
  static_assert(NT % 32 == 0 && C % U == 0 && NCG >= KI && HD % 4 == 0 &&
                32 % NCG == 0, "backward tiles");
};

// S <- w S + k v for a thread's elements, rounded as the forward
template <int KI, int JT>
__device__ __forceinline__ void bwd_advance(float (&S)[KI][JT],
                                            const float* wr, const float* kr,
                                            const float* vr) {
  float w2[KI], k2[KI], v4[JT];
#pragma unroll
  for (int a = 0; a < KI; ++a) { w2[a] = wr[a]; k2[a] = kr[a]; }
#pragma unroll
  for (int b = 0; b < JT; ++b) v4[b] = vr[b];
#pragma unroll
  for (int a = 0; a < KI; ++a)
#pragma unroll
    for (int b = 0; b < JT; ++b)
      S[a][b] = __fadd_rn(__fmul_rn(w2[a], S[a][b]), __fmul_rn(k2[a], v4[b]));
}

template <int HD>
__global__ void __launch_bounds__(BPlan<HD>::NT)
wkv6_bwd_kernel(const float* __restrict__ r, const float* __restrict__ k,
                const float* __restrict__ v, const float* __restrict__ w,
                const float* __restrict__ u, const float* __restrict__ Sc,
                const float* __restrict__ dout,
                const float* __restrict__ dST, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du,
                float* __restrict__ dS0, int64_t B, int64_t T, int H) {
  using P = BPlan<HD>;
  constexpr int KI = P::KI, JT = P::JT, JB = P::JB, C = P::C, U = P::U;
  constexpr int NCG = P::NCG, NT = P::NT, NW = P::NW, E = P::E;
  extern __shared__ __align__(16) float smem[];
  float* st = smem;                           // [5][C][HD]: r k w v do
  float* bt = st + P::STAGE;                  // [C] v . do
  float* qt = bt + C;                         // [C] sum r u k
  float* cps = qt + C;                        // [NSUB][E][NT]
  float* dvb = cps + P::CP;                   // [U][NW][JB]

  const int jblocks = HD / JB;
  const int64_t bh = blockIdx.x / jblocks;    // b * H + h
  const int jb = (int)(blockIdx.x - bh * jblocks);
  const int j0 = jb * JB;
  const int hh = (int)(bh % H);
  const int64_t bi = bh / H;
  const int64_t ld = (int64_t)H * HD;
  const int64_t row0 = (bi * T * H + hh) * HD;
  const int64_t chunks = (T + C - 1) / C;
  const int64_t part = B * T * ld;            // one block column's partials

  const int tid = threadIdx.x, warp = tid / 32, lane = tid % 32;
  const int cg = lane % NCG, kg = warp * P::KGW + lane / NCG;
  const int i0 = kg * KI, jt = JT * cg;
  float ul[P::KL], uu[KI], dua[KI], D[KI][JT];
#pragma unroll
  for (int m = 0; m < P::KL; ++m)
    ul[m] = lane + 32 * m < HD ? u[hh * HD + lane + 32 * m] : 0.f;
#pragma unroll
  for (int a = 0; a < KI; ++a) {
    uu[a] = u[hh * HD + i0 + a];
    dua[a] = 0.f;
#pragma unroll
    for (int b = 0; b < JT; ++b) D[a][b] = 0.f;
    if (dST != nullptr)
      ld_vec<JT>(dST + (bh * HD + i0 + a) * HD + j0 + jt, D[a]);
  }

  for (int64_t c = chunks - 1; c >= 0; --c) {
    const int n = (int)lmin(C, T - c * C);
    const int64_t crow = row0 + c * C * ld;   // the chunk's first row
    __syncthreads();                          // the last chunk's reads done
    for (int idx = tid; idx < 5 * n * (HD / 4); idx += NT) {
      const int arr = idx / (n * (HD / 4));
      const int rest = idx - arr * n * (HD / 4);
      const int t = rest / (HD / 4), c4 = 4 * (rest % (HD / 4));
      const float* src = arr == 0 ? r : arr == 1 ? k : arr == 2 ? w
                         : arr == 3 ? v : dout;
      copy16(st + (arr * C + t) * HD + c4, src + crow + t * ld + c4);
    }
    cp_async_commit();
    cp_async_wait_group<0>();
    __syncthreads();
    // b_t and q_t of the chunk's steps, a warp a step at a time
    for (int t = warp; t < n; t += NW) {
      float bs = 0.f, qs = 0.f;
#pragma unroll
      for (int m = 0; m < P::KL; ++m) {
        const int i = lane + 32 * m;
        if (i < HD) {
          bs = fmaf(st[(3 * C + t) * HD + i], st[(4 * C + t) * HD + i], bs);
          qs = fmaf(st[t * HD + i] * ul[m], st[(C + t) * HD + i], qs);
        }
      }
#pragma unroll
      for (int d = 16; d >= 1; d /= 2) {
        bs += __shfl_xor_sync(~0u, bs, d);
        qs += __shfl_xor_sync(~0u, qs, d);
      }
      if (lane == 0) { bt[t] = bs; qt[t] = qs; }
    }
    // the sub-chunks' starts, from the chunk's saved start
    const int nsub = (n + U - 1) / U;
    float S[KI][JT];
#pragma unroll
    for (int a = 0; a < KI; ++a)
      ld_vec<JT>(Sc + ((bh * chunks + c) * HD + i0 + a) * HD + j0 + jt, S[a]);
    for (int s = 0; s < nsub; ++s) {
#pragma unroll
      for (int a = 0; a < KI; ++a)
#pragma unroll
        for (int b = 0; b < JT; ++b) cps[(s * E + a * JT + b) * NT + tid] = S[a][b];
      if (s + 1 < nsub) {
#pragma unroll 2
        for (int t = s * U; t < s * U + U; ++t)
          bwd_advance<KI, JT>(S, st + (2 * C + t) * HD + i0,
                              st + (C + t) * HD + i0,
                              st + (3 * C + t) * HD + j0 + jt);
      }
    }
    __syncthreads();                          // b_t, q_t visible
    for (int s = nsub - 1; s >= 0; --s) {
      const int m = (int)lmin(U, n - s * U);
      float hist[U][KI][JT];
#pragma unroll
      for (int a = 0; a < KI; ++a)
#pragma unroll
        for (int b = 0; b < JT; ++b) S[a][b] = cps[(s * E + a * JT + b) * NT + tid];
#pragma unroll
      for (int x = 0; x < U; ++x) {
        if (x < m) {
          const int t = s * U + x;
#pragma unroll
          for (int a = 0; a < KI; ++a)
#pragma unroll
            for (int b = 0; b < JT; ++b) hist[x][a][b] = S[a][b];
          bwd_advance<KI, JT>(S, st + (2 * C + t) * HD + i0,
                              st + (C + t) * HD + i0,
                              st + (3 * C + t) * HD + j0 + jt);
        }
      }
#pragma unroll
      for (int x = U - 1; x >= 0; --x) {
        if (x < m) {
          const int t = s * U + x;
          float rr[KI], kk[KI], ww[KI], vv[JT], dd[JT];
#pragma unroll
          for (int a = 0; a < KI; ++a) {
            rr[a] = st[t * HD + i0 + a];
            kk[a] = st[(C + t) * HD + i0 + a];
            ww[a] = st[(2 * C + t) * HD + i0 + a];
          }
          ld_vec<JT>(st + (3 * C + t) * HD + j0 + jt, vv);
          ld_vec<JT>(st + (4 * C + t) * HD + j0 + jt, dd);
          float pr[KI], pk[KI], pw[KI], pv[JT];
#pragma unroll
          for (int b = 0; b < JT; ++b) pv[b] = 0.f;
#pragma unroll
          for (int a = 0; a < KI; ++a) {
            pr[a] = pk[a] = pw[a] = 0.f;
#pragma unroll
            for (int b = 0; b < JT; ++b) {
              pr[a] = fmaf(hist[x][a][b], dd[b], pr[a]);
              pk[a] = fmaf(D[a][b], vv[b], pk[a]);
              pw[a] = fmaf(D[a][b], hist[x][a][b], pw[a]);
              pv[b] = fmaf(D[a][b], kk[a], pv[b]);
              D[a][b] = __fadd_rn(__fmul_rn(ww[a], D[a][b]),
                                  __fmul_rn(rr[a], dd[b]));
            }
          }
          // sums over the column lanes (dr, dk, dw), the key lanes (dv)
#pragma unroll
          for (int d = 1; d < NCG; d *= 2) {
#pragma unroll
            for (int a = 0; a < KI; ++a) {
              pr[a] += __shfl_xor_sync(~0u, pr[a], d);
              pk[a] += __shfl_xor_sync(~0u, pk[a], d);
              pw[a] += __shfl_xor_sync(~0u, pw[a], d);
            }
          }
#pragma unroll
          for (int d = NCG; d < 32; d *= 2) {
#pragma unroll
            for (int b = 0; b < JT; ++b)
              pv[b] += __shfl_xor_sync(~0u, pv[b], d);
          }
          const float bb = bt[t];
          if (jb == 0) {                      // the bonus terms, once
#pragma unroll
            for (int a = 0; a < KI; ++a) {
              pr[a] = fmaf(uu[a] * kk[a], bb, pr[a]);
              pk[a] = fmaf(uu[a] * rr[a], bb, pk[a]);
              dua[a] = fmaf(rr[a] * kk[a], bb, dua[a]);
            }
          }
          if (cg < KI) {
            float xr = pr[0], xk = pk[0], xw = pw[0];
#pragma unroll
            for (int a = 1; a < KI; ++a)
              if (cg == a) { xr = pr[a]; xk = pk[a]; xw = pw[a]; }
            const int64_t o = jb * part + crow + t * ld + i0 + cg;
            dr[o] = xr;
            dk[o] = xk;
            dw[o] = xw;
          }
          if (lane < NCG) st_vec<JT>(dvb + (x * NW + warp) * JB + jt, pv);
        }
      }
      __syncthreads();                        // the warps' dv sums
      for (int idx = tid; idx < m * JB; idx += NT) {
        const int x = idx / JB, j = idx - x * JB, t = s * U + x;
        float acc = dvb[x * NW * JB + j];
#pragma unroll
        for (int q = 1; q < NW; ++q) acc += dvb[(x * NW + q) * JB + j];
        acc = fmaf(qt[t], st[(4 * C + t) * HD + j0 + j], acc);
        dv[crow + t * ld + j0 + j] = acc;
      }
      __syncthreads();                        // dvb free again
    }
  }
#pragma unroll
  for (int a = 0; a < KI; ++a)
    st_vec<JT>(dS0 + (bh * HD + i0 + a) * HD + j0 + jt, D[a]);
  if (jb == 0 && cg < KI) {
    float x = dua[0];
#pragma unroll
    for (int a = 1; a < KI; ++a)
      if (cg == a) x = dua[a];
    du[bh * HD + i0 + cg] = x;
  }
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

template <int HD>
int launch(const float* r, const float* k, const float* v, const float* w,
           const float* u, const float* S0, float* out, float* ST, float* Sc,
           int64_t B, int64_t T, int H, cudaStream_t s) {
  using P = Plan<HD>;
  static unsigned done[2] = {0, 0};   // devices whose smem limit is raised
  const auto kernel = Sc != nullptr ? wkv6_kernel<HD, true>
                                    : wkv6_kernel<HD, false>;
  const cudaError_t e = allow_smem(kernel, P::BYTES, done[Sc != nullptr]);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = (unsigned)(B * H * (HD / P::JB));
  kernel<<<blocks, P::NT + NF, P::BYTES, s>>>(r, k, v, w, u, S0, out, ST, Sc,
                                              T, H);
  return static_cast<int>(cudaGetLastError());
}

struct BwdArgs {
  const float *r, *k, *v, *w, *u, *Sc, *dout, *dST;
  float *dr, *dk, *dv, *dw, *du, *dS0;
};

template <int HD>
int launch_bwd(const BwdArgs& x, int64_t B, int64_t T, int H,
               cudaStream_t s) {
  using P = BPlan<HD>;
  static unsigned done = 0;
  const cudaError_t e = allow_smem(wkv6_bwd_kernel<HD>, P::BYTES, done);
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = (unsigned)(B * H * (HD / P::JB));
  wkv6_bwd_kernel<HD><<<blocks, P::NT, P::BYTES, s>>>(
      x.r, x.k, x.v, x.w, x.u, x.Sc, x.dout, x.dST, x.dr, x.dk, x.dv, x.dw,
      x.du, x.dS0, B, T, H);
  return static_cast<int>(cudaGetLastError());
}

int forward(const void* r, const void* k, const void* v, const void* w,
            const void* u, const void* S0, void* out, void* ST, void* Sc,
            long long B, long long T, long long H, long long hd,
            void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  if (B * H == 0 || T == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(S0) | reinterpret_cast<uintptr_t>(Sc)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const auto* r_ = static_cast<const float*>(r);
  const auto* k_ = static_cast<const float*>(k);
  const auto* v_ = static_cast<const float*>(v);
  const auto* w_ = static_cast<const float*>(w);
  const auto* u_ = static_cast<const float*>(u);
  const auto* s0 = static_cast<const float*>(S0);
  auto* o_ = static_cast<float*>(out);
  auto* st = static_cast<float*>(ST);
  auto* sc = static_cast<float*>(Sc);
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16:
      return launch<16>(r_, k_, v_, w_, u_, s0, o_, st, sc, B, T, (int)H, s);
    case 32:
      return launch<32>(r_, k_, v_, w_, u_, s0, o_, st, sc, B, T, (int)H, s);
    case 64:
      return launch<64>(r_, k_, v_, w_, u_, s0, o_, st, sc, B, T, (int)H, s);
    case 128:
      return launch<128>(r_, k_, v_, w_, u_, s0, o_, st, sc, B, T, (int)H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

extern "C" int repro_wkv6(const void* r, const void* k, const void* v,
                          const void* w, const void* u, const void* S0,
                          void* out, void* ST, long long B, long long T,
                          long long H, long long hd, void* stream) {
  return forward(r, k, v, w, u, S0, out, ST, nullptr, B, T, H, hd, stream);
}

extern "C" int repro_wkv6_states(const void* r, const void* k, const void* v,
                                 const void* w, const void* u, const void* S0,
                                 void* out, void* ST, void* Sc, long long B,
                                 long long T, long long H, long long hd,
                                 void* stream) {
  if (Sc == nullptr) return static_cast<int>(cudaErrorInvalidValue);
  return forward(r, k, v, w, u, S0, out, ST, Sc, B, T, H, hd, stream);
}

extern "C" int repro_wkv6_chunk(long long hd) {
  switch (hd) {
    case 16: return Tile<16>::C;
    case 32: return Tile<32>::C;
    case 64: return Tile<64>::C;
    case 128: return Tile<128>::C;
    default: return 0;
  }
}

extern "C" int repro_wkv6_bwd_parts(long long hd) {
  switch (hd) {
    case 16: return 16 / BPlan<16>::JB;
    case 32: return 32 / BPlan<32>::JB;
    case 64: return 64 / BPlan<64>::JB;
    case 128: return 128 / BPlan<128>::JB;
    default: return 0;
  }
}

extern "C" int repro_wkv6_bwd(const void* r, const void* k, const void* v,
                              const void* w, const void* u, const void* Sc,
                              const void* dout, const void* dST, void* dr,
                              void* dk, void* dv, void* dw, void* du,
                              void* dS0, long long B, long long T,
                              long long H, long long hd, void* stream) {
  cudaGetLastError();  // report this call's launch, not an older error
  if (B * H == 0 || T == 0) return 0;
  if ((reinterpret_cast<uintptr_t>(r) | reinterpret_cast<uintptr_t>(k) |
       reinterpret_cast<uintptr_t>(v) | reinterpret_cast<uintptr_t>(w) |
       reinterpret_cast<uintptr_t>(Sc) | reinterpret_cast<uintptr_t>(dout) |
       reinterpret_cast<uintptr_t>(dST) | reinterpret_cast<uintptr_t>(dS0)) %
      16)
    return static_cast<int>(cudaErrorMisalignedAddress);
  const BwdArgs x{static_cast<const float*>(r), static_cast<const float*>(k),
                  static_cast<const float*>(v), static_cast<const float*>(w),
                  static_cast<const float*>(u), static_cast<const float*>(Sc),
                  static_cast<const float*>(dout),
                  static_cast<const float*>(dST), static_cast<float*>(dr),
                  static_cast<float*>(dk), static_cast<float*>(dv),
                  static_cast<float*>(dw), static_cast<float*>(du),
                  static_cast<float*>(dS0)};
  const auto s = static_cast<cudaStream_t>(stream);
  switch (hd) {
    case 16: return launch_bwd<16>(x, B, T, (int)H, s);
    case 32: return launch_bwd<32>(x, B, T, (int)H, s);
    case 64: return launch_bwd<64>(x, B, T, (int)H, s);
    case 128: return launch_bwd<128>(x, B, T, (int)H, s);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}
