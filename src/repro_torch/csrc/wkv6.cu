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
// written), 0.36 ms, against ~12 FP32 instructions an element-step (3
// recomputing S, 1.6 times over: once to find the sub-chunk starts, once
// more into registers; 3 updating D; 4 FMAs of the sums), which on 132 x
// 128 lanes at 1.98 GHz is 0.76 ms.  What the design does:
//   * A block holds one head's keys and JB (<= 64) of its value columns:
//     one block a head up to hd 64, two at hd 128 (BTile, BPlan).  A thread
//     holds 2 keys x 8 columns of D (4 x 8 at hd 128, 2 x 4 at hd 16); a
//     warp every column of the block, so the sums over columns (dr, dk, dw)
//     stay in the warp.
//   * Per forward chunk (C steps), newest first: thread 0 stages the next
//     chunk's rows of r, k, w, v, do by TMA (one box an operand a half
//     chunk, OOB steps as zeros) and its saved start (one box) while the
//     chunk is walked; the chunk's states are recomputed from its start,
//     keeping one start a sub-chunk of U steps in shared memory; each
//     sub-chunk, newest first, is recomputed again into registers (its U
//     states) and walked back as straight-line code.
//   * A step's sums are FMA chains over a thread's columns (and keys, dv);
//     its partials go to the warp's scratch and are summed over the lanes
//     in a fixed tree order (pairs, pairs of pairs), during the next step's
//     arithmetic where two scratch buffers fit; dr, dk, dw are stored by the
//     lanes that sum them (the bonus terms in the first block of a head), dv
//     a sub-chunk later from the warps' sums in warp order, once the split
//     barrier (an mbarrier each thread arrives at after its walk) has
//     completed.  du is the first block's chains over t, summed over b by the
//     wrapper; hd 128's two blocks write dr, dk, dw as partials the wrapper
//     sums in a fixed order.  No atomics: reruns are bitwise.
//   * D rounds as the plain reverse loop does (__fmul_rn w D, __fmul_rn
//     r do, __fadd_rn), so dS0 equals it bit for bit.

// C interface (bound with ctypes; every pointer and the stream as void*):
//   int repro_wkv6(r, k, v, w, u, S0, out, S_T, B, T, H, hd, stream)
//   int repro_wkv6_states(r, k, v, w, u, S0, out, S_T, Sc, B, T, H, hd,
//                         stream)
//   int repro_wkv6_bwd(r, k, v, w, u, Sc, dout, dS_T, dr, dk, dv, dw, du,
//                      dS0, B, T, H, hd, stream)
//   int repro_wkv6_chunk(hd)       steps a chunk, C: Sc has ceil(T / C)
//   int repro_wkv6_bwd_parts(hd)   the backward's partials, hd / JB
//   int repro_wkv6_bwd_sub(hd)     the backward's sub-chunk, U steps
//   int repro_wkv6_bwd_blocks_per_sm(hd)  its blocks an SM can hold
// hd is one of 16, 32, 64, 128 (the last four return 0 for another); S0
// and dS_T may be null.  repro_wkv6_states is the forward that also writes Sc
// (training); repro_wkv6 is inference.  The backward writes dr, dk, dw as
// (hd / JB, B, T, H, hd) partials, du as (B, H, hd), dv and dS0 whole.  The
// launching functions return cudaGetLastError() after their launch (0 on
// success, cudaErrorInvalidValue for another hd, a null Sc or a tensor map
// the driver refuses, cudaErrorMisalignedAddress for an operand not 16-byte
// aligned); none allocates.

#include <cuda_runtime.h>

#include <stdint.h>

#include "hopper.cuh"

namespace {

using repro_hopper::cp_async;
using repro_hopper::cp_async_commit;
using repro_hopper::cp_async_wait_group;
using repro_hopper::fence_proxy_async;
using repro_hopper::mbar_arrive;
using repro_hopper::mbar_expect_tx;
using repro_hopper::mbar_init;
using repro_hopper::mbar_init_fence;
using repro_hopper::mbar_wait;
using repro_hopper::smem_u32;
using repro_hopper::tma_load_4d;

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

// N (1, 2 or 4) consecutive floats, one 4-, 8- or 16-byte access
template <int N>
__device__ __forceinline__ void ld_vec(const float* p, float* x) {
  if constexpr (N == 1) {
    x[0] = *p;
  } else if constexpr (N == 2) {
    const float2 q = *reinterpret_cast<const float2*>(p);
    x[0] = q.x; x[1] = q.y;
  } else {
    const float4 q = *reinterpret_cast<const float4*>(p);
    x[0] = q.x; x[1] = q.y; x[2] = q.z; x[3] = q.w;
  }
}

template <int N>
__device__ __forceinline__ void st_vec(float* p, const float* x) {
  if constexpr (N == 1)
    *p = x[0];
  else if constexpr (N == 2)
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

// The backward's tiles by head size: a block holds JB value columns of one
// head and all its keys; a thread KI keys x JT columns (JT / 4 runs of four
// columns, JB / NV apart); a warp's lanes run across CL = JB / JT column
// groups, then KL = 32 / CL key groups, so a warp holds WK = KL KI keys and
// every column of the block, and the block NW = HD / WK warps.  E = KI JT
// elements a thread: 16, and 32 at hd 128, whose 16384 elements a head take
// two blocks.  U steps a sub-chunk; MINB blocks an SM (launch bounds); JDB
// scratch buffers a warp (two: a step's partials are summed during the
// step before it); NH half chunks of staged rows (four: a whole chunk is
// staged ahead).  JDB and NH are cut to 1 and 3 where shared memory would
// otherwise hold fewer blocks (hd 32: four of 54 KB) or not fit (hd 128).
template <int HD> struct BTile;
template <> struct BTile<16> {
  static constexpr int JB = 16, KI = 2, JT = 4, U = 8, MINB = 8;
  static constexpr int JDB = 2, NH = 4;
};
template <> struct BTile<32> {
  static constexpr int JB = 32, KI = 2, JT = 8, U = 8, MINB = 4;
  static constexpr int JDB = 1, NH = 3;
};
template <> struct BTile<64> {
  static constexpr int JB = 64, KI = 2, JT = 8, U = 8, MINB = 1;
  static constexpr int JDB = 2, NH = 4;
};
template <> struct BTile<128> {
  static constexpr int JB = 64, KI = 4, JT = 8, U = 4, MINB = 1;
  static constexpr int JDB = 1, NH = 3;
};

template <int HD>
struct BPlan {
  static constexpr int JB = BTile<HD>::JB, KI = BTile<HD>::KI;
  static constexpr int JT = BTile<HD>::JT, U = BTile<HD>::U;
  static constexpr int JDB = BTile<HD>::JDB, NH = BTile<HD>::NH;
  static constexpr int C = Tile<HD>::C;       // the forward's chunk
  static constexpr int NV = JT / 4;           // runs of 4 columns a thread
  static constexpr int RUN = JB / NV;         // columns from run to run
  static constexpr int CL = JB / JT;          // column lanes
  static constexpr int KL = 32 / CL;          // key lanes
  static constexpr int WK = KL * KI;          // keys a warp
  static constexpr int NW = HD / WK;          // warps
  static constexpr int NT = 32 * NW;          // threads
  static constexpr int E = KI * JT;           // elements a thread
  static constexpr int NSUB = C / U;          // sub-chunks a chunk
  static constexpr int H2 = C / 2;            // steps a half chunk
  static constexpr int ROW = 5 * HD;          // a step's r, k, w, v, do
  static constexpr int AS = H2 * HD;          // an operand's rows a half
  static constexpr int LPS = NT / C;          // lanes of a step's b_t, q_t
  static constexpr int KPL = HD / LPS;        // keys a lane of those
  static constexpr int JS = (CL + 1) * WK;    // one sum's rows in J (padded)
  static constexpr int WS = 3 * JS + KL * JB; // a warp's scratch: J, V
  static constexpr int CPL = JB < 32 ? 1 : JB / 32;  // dv columns a lane
  static constexpr int OUTS = (3 * WK + 31) / 32;    // column sums a lane
  // shared memory, in floats: NH half chunks of staged rows, the sub-chunk
  // starts, the warps' dv sums of two sub-chunks, b_t and q_t, u, four
  // mbarriers, the warps' scratch
  static constexpr int STAGE = NH * H2 * ROW;
  static constexpr int STARTS = NSUB * E * NT;
  static constexpr int DVB = 2 * U * NW * JB;
  static constexpr int SCR = JDB * NW * WS;
  static constexpr size_t BYTES =
      sizeof(float) * (STAGE + STARTS + DVB + 2 * C + HD + 8 + SCR);
  static_assert(JT % 4 == 0 && (KI == 2 || KI == 4) && 32 % CL == 0 &&
                    HD % WK == 0 && C % U == 0 && NSUB >= 2 &&
                    NSUB % 2 == 0 && NT % C == 0 && 32 % LPS == 0 &&
                    KPL % 4 == 0 && WS % 4 == 0 && JS % 4 == 0 &&
                    HD % JB == 0 && H2 % U == 0 && BYTES <= 232448,
                "backward tiles");
};

template <bool B> struct Bool { static constexpr bool value = B; };

#ifdef REPRO_WKV6_BWD_PHASES
// A measurement build (launch/time_recurrent.py --phases): lane 0 of each
// warp of the first 64 blocks sums clock64() cycles by phase, from one mark
// to the next: 0 barrier A (rows and start landed), 1 the next chunk's
// staging and b_t, q_t, 2 the first pass, 3 barrier B, 4 before a
// sub-chunk, 5 its states, 6 the wait for the sub-chunk before's dv sums,
// 7 those sums, 8 its steps, 9 the end.
__device__ unsigned long long bwd_phases[64][16][10];
#define PHASE(i)                                                  \
  do {                                                            \
    const long long now_ = clock64();                             \
    phase_[i] += now_ - mark_;                                    \
    mark_ = now_;                                                 \
  } while (0)
#else
#define PHASE(i) do {} while (0)
#endif

// The sums of W consecutive floats over N rows STRIDE apart from p (N a
// power of 2), each in pairs, then pairs of pairs, ... (x0 + x1) + (x2 +
// x3) ..., a tree of depth log2 N.
template <int N, int STRIDE, int W = 1>
__device__ __forceinline__ void lane_sums(const float* p, float* out) {
  float x[N][W];
#pragma unroll
  for (int i = 0; i < N; ++i) ld_vec<W>(p + i * STRIDE, x[i]);
#pragma unroll
  for (int w = N / 2; w >= 1; w /= 2)
#pragma unroll
    for (int i = 0; i < w; ++i)
#pragma unroll
      for (int e = 0; e < W; ++e) x[i][e] = x[2 * i][e] + x[2 * i + 1][e];
#pragma unroll
  for (int e = 0; e < W; ++e) out[e] = x[0][e];
}

template <int N, int STRIDE>
__device__ __forceinline__ float lane_sum(const float* p) {
  float x;
  lane_sums<N, STRIDE>(p, &x);
  return x;
}

// Four floats of shared memory, read anew each time it is called (the
// compiler neither merges nor keeps it): a sub-chunk's start, whose
// registers would otherwise stay taken through the sub-chunk's walk.
__device__ __forceinline__ void lds4_anew(const float* p, float* x) {
  asm volatile("ld.shared.v4.f32 {%0, %1, %2, %3}, [%4];\n"
               : "=f"(x[0]), "=f"(x[1]), "=f"(x[2]), "=f"(x[3])
               : "r"(smem_u32(p)));
}

// A half chunk's rows: each operand's (r, k, w, v, do) H2 rows of HD,
// AS apart.  Half h (0, 1) of a chunk of parity p is staged in half chunk
// p (h 0), 2 + p (h 1, four halves) or 2 (h 1, three halves).
template <int HD>
__device__ __forceinline__ float* bwd_half(float* stage, int p, int h) {
  using P = BPlan<HD>;
  return stage + (h == 0 ? p : P::NH == 4 ? 2 + p : 2) * P::H2 * P::ROW;
}

// Step t's (0 .. C - 1) row of r (of k, w, v, do: AS, 2 AS, ... further).
template <int HD>
__device__ __forceinline__ float* bwd_slot(float* stage, int p, int t) {
  using P = BPlan<HD>;
  return bwd_half<HD>(stage, p, t >= P::H2) + (t % P::H2) * HD;
}

// The backward's tensor maps: r, k, w, v, do as (hd, H, T, B) fp32 in
// boxes of hd x 1 x H2 x 1 (a half chunk of one head; steps past T arrive
// as zeros), the chunk starts Sc as (hd, hd, chunks, B H) in boxes of JB x
// hd x 1 x 1 (a block's columns of one start).
struct BwdMaps {
  CUtensorMap op[5];                          // r, k, w, v, do
  CUtensorMap sc;
};

// Halves [h0, h1) of the chunk of parity p whose first step is t0 (of
// batch row b, head h), by one thread: one TMA box an operand a half,
// their bytes posted on bar.
template <int HD>
__device__ __forceinline__ void bwd_stage(float* stage, int p, int h0,
                                          int h1, const BwdMaps& maps,
                                          int hh, int bi, int t0,
                                          uint32_t bar) {
  using P = BPlan<HD>;
  fence_proxy_async();
  mbar_expect_tx(bar, (uint32_t)((h1 - h0) * 5 * P::AS * sizeof(float)));
  for (int h = h0; h < h1; ++h)
#pragma unroll
    for (int a = 0; a < 5; ++a)
      tma_load_4d(smem_u32(bwd_half<HD>(stage, p, h) + a * P::AS), &maps.op[a],
                  bar, 0, hh, t0 + h * P::H2, bi);
}

// Chunk c's start (the block's JB columns from j0, of head bh) into dst as
// rows of JB, by one thread.
template <int HD>
__device__ __forceinline__ void start_stage(float* dst, const BwdMaps& maps,
                                            int j0, int c, int bh,
                                            uint32_t bar) {
  using P = BPlan<HD>;
  fence_proxy_async();
  mbar_expect_tx(bar, HD * P::JB * sizeof(float));
  tma_load_4d(smem_u32(dst), &maps.sc, bar, j0, 0, c, bh);
}

// A thread's elements (keys i0 .., runs of columns from jc) of a (hd, hd)
// matrix at m, or into it.
template <int HD>
__device__ __forceinline__ void ld_tile(
    const float* m, int i0, int jc,
    float (&X)[BPlan<HD>::KI][BPlan<HD>::JT], int rows = HD) {
  using P = BPlan<HD>;
#pragma unroll
  for (int a = 0; a < P::KI; ++a)
#pragma unroll
    for (int g = 0; g < P::NV; ++g)
      ld_vec<4>(m + (int64_t)(i0 + a) * rows + jc + g * P::RUN, &X[a][4 * g]);
}

template <int HD>
__device__ __forceinline__ void st_tile(
    float* m, int i0, int jc,
    const float (&X)[BPlan<HD>::KI][BPlan<HD>::JT]) {
  using P = BPlan<HD>;
#pragma unroll
  for (int a = 0; a < P::KI; ++a)
#pragma unroll
    for (int g = 0; g < P::NV; ++g)
      st_vec<4>(m + (int64_t)(i0 + a) * HD + jc + g * P::RUN, &X[a][4 * g]);
}

// A sub-chunk start of a thread: its E floats as E / 4 float4, NT apart
// (thread tid's at p = starts + 4 tid).
template <int HD>
__device__ __forceinline__ void start_store(
    float* p, const float (&X)[BPlan<HD>::KI][BPlan<HD>::JT]) {
  using P = BPlan<HD>;
#pragma unroll
  for (int a = 0; a < P::KI; ++a)
#pragma unroll
    for (int g = 0; g < P::NV; ++g)
      st_vec<4>(p + 4 * P::NT * (a * P::NV + g), &X[a][4 * g]);
}

template <int HD>
__device__ __forceinline__ void start_load(
    const float* p, float (&X)[BPlan<HD>::KI][BPlan<HD>::JT]) {
  using P = BPlan<HD>;
#pragma unroll
  for (int a = 0; a < P::KI; ++a)
#pragma unroll
    for (int g = 0; g < P::NV; ++g)
      lds4_anew(p + 4 * P::NT * (a * P::NV + g), &X[a][4 * g]);
}

// S <- w S + k v for a thread's elements from the step staged at st, rounded
// as the forward (k v rounded, w S rounded, then the sum)
template <int HD>
__device__ __forceinline__ void bwd_advance(
    float (&S)[BPlan<HD>::KI][BPlan<HD>::JT], const float* st, int i0,
    int jc) {
  using P = BPlan<HD>;
  constexpr int KI = P::KI, JT = P::JT;
  float ww[KI], kk[KI], vv[JT];
  ld_vec<KI>(st + 2 * P::AS + i0, ww);
  ld_vec<KI>(st + P::AS + i0, kk);
#pragma unroll
  for (int g = 0; g < P::NV; ++g)
    ld_vec<4>(st + 3 * P::AS + jc + g * P::RUN, vv + 4 * g);
#pragma unroll
  for (int a = 0; a < KI; ++a)
#pragma unroll
    for (int b = 0; b < JT; ++b)
      S[a][b] = __fadd_rn(__fmul_rn(ww[a], S[a][b]), __fmul_rn(kk[a], vv[b]));
}

template <int HD>
__global__ void __launch_bounds__(BPlan<HD>::NT, BTile<HD>::MINB)
wkv6_bwd_kernel(const __grid_constant__ BwdMaps maps,
                const float* __restrict__ u,
                const float* __restrict__ dST, float* __restrict__ dr,
                float* __restrict__ dk, float* __restrict__ dv,
                float* __restrict__ dw, float* __restrict__ du,
                float* __restrict__ dS0, int64_t B, int64_t T, int H) {
  using P = BPlan<HD>;
  constexpr int KI = P::KI, JT = P::JT, JB = P::JB, C = P::C, U = P::U;
  constexpr int NW = P::NW, NT = P::NT, E = P::E, CL = P::CL, KL = P::KL;
  constexpr int WK = P::WK, NV = P::NV, JS = P::JS, CPL = P::CPL;
  constexpr int JDB = P::JDB;
  extern __shared__ __align__(16) float smem[];
  float* stage = smem;                        // [NH][5][H2][HD]
  float* starts = stage + P::STAGE;           // [NSUB][E / 4][NT][4]
  float* scr = starts + P::STARTS;            // [NW][JDB]: J [3][CL + 1]
                                              //   [WK], V [KL][JB]
  float* dvb = scr + P::SCR;                  // [2][U][NW][JB]
  float* bq = dvb + P::DVB;                   // [2][C]: b_t, q_t
  float* us = bq + 2 * C;                     // [HD]: u of the head
  // barriers: dvbar, the warps' dv sums of a sub-chunk written (each thread
  // arrives after its walk of the sub-chunk and waits before summing them,
  // a sub-chunk later; parity dvph); rbar0 and rbar1, the rows of a
  // chunk's first and second half landed (rbar0 all of them with four
  // halves), and scbar, its saved start landed (one phase a chunk, parity
  // cph)
  const uint32_t dvbar = smem_u32(us + HD), rbar0 = dvbar + 8;
  const uint32_t rbar1 = dvbar + 16, scbar = dvbar + 24;
  uint32_t dvph = 0, cph = 0;

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
  const int kl = lane / CL, cl = lane % CL;
  const int wk0 = warp * WK;                  // the warp's first key
  const int i0 = wk0 + kl * KI, jc = j0 + 4 * cl;
  float* J = scr + warp * JDB * P::WS;        // the warp's scratch
  for (int i = tid; i < HD; i += NT) us[i] = u[hh * HD + i];
  if (tid == 0) {
    mbar_init(dvbar, NT);
    mbar_init(rbar0, 1);
    mbar_init(rbar1, 1);
    mbar_init(scbar, 1);
    mbar_init_fence();
  }
#ifdef REPRO_WKV6_BWD_PHASES
  long long phase_[10] = {}, mark_ = clock64();
#endif
  // a lane's column sums: (q, key) = (o / WK, o % WK), o = lane + 32 m;
  // the bonus terms of dr (q 0) and dk (q 1) and du (q 0) use u of its key
  int jof[P::OUTS];
  bool jon[P::OUTS];
  float* jout[P::OUTS];
#pragma unroll
  for (int mo = 0; mo < P::OUTS; ++mo) {
    const int o = lane + 32 * mo, oc = o < 3 * WK ? o : 0;
    const int q = oc / WK, key = oc % WK;
    jof[mo] = q * JS + key;
    jon[mo] = o < 3 * WK;
    jout[mo] = (q == 0 ? dr : q == 1 ? dk : dw) + jb * part + wk0 + key;
  }
  const bool isr = lane < WK;                 // dr (and du); else dk or dw
  const bool bon = jb == 0 && lane < 2 * WK;  // a bonus term in round 0
  const int bkey = wk0 + lane % WK, vcol = (lane * CPL) % JB;
  const float ul = u[hh * HD + bkey];
  float dua = 0.f;
  float D[KI][JT];
#pragma unroll
  for (int a = 0; a < KI; ++a)
#pragma unroll
    for (int b = 0; b < JT; ++b) D[a][b] = 0.f;
  if (dST != nullptr) ld_tile<HD>(dST + bh * HD * HD, i0, jc, D);

  // A chunk's saved start lands, as rows of JB, in the last sub-chunk
  // start's slot (free once that sub-chunk is walked): the next chunk's
  // while the chunk is walked.  Thread 0 issues the TMA loads.
  float* scslot = starts + (P::NSUB - 1) * E * NT;
  if (tid == 0) {                             // the last chunk's rows, start
    const int c0 = (int)(chunks - 1);
    bwd_stage<HD>(stage, c0 & 1, 0, P::NH == 4 ? 2 : 1, maps, hh, (int)bi,
                  c0 * C, rbar0);
    if (P::NH == 3)
      bwd_stage<HD>(stage, c0 & 1, 1, 2, maps, hh, (int)bi, c0 * C, rbar1);
    start_stage<HD>(scslot, maps, j0, c0, (int)bh, scbar);
  }
  __syncthreads();                            // the barriers initialised
  // Chunks newest first.  Chunk c's rows are staged in half chunks c % 2
  // and 2 (with four halves, 2 + c % 2); chunk c - 1's rows are staged
  // while chunk c is walked (with three halves, the second half once chunk
  // c's walk is below step C / 2).  Barriers a chunk: A (its rows and
  // start landed; chunk c + 1 done), B (its b_t, q_t written), and the
  // split dvbar a sub-chunk.
  for (int64_t c = chunks - 1; c >= 0; --c) {
    const int n = (int)lmin(C, T - c * C);
    const int p = (int)(c & 1);
    const int64_t crow = row0 + c * C * ld;
    mbar_wait(rbar0, cph);
    if (P::NH == 3) mbar_wait(rbar1, cph);
    mbar_wait(scbar, cph);
    cph ^= 1;
    __syncthreads();                          // A
    PHASE(0);
    float S[KI][JT];                          // the chunk's saved start
    ld_tile<HD>(scslot, i0, jc - j0, S, JB);
    if (c > 0 && tid == 0)    // chunk c - 1's first half (with four, all)
      bwd_stage<HD>(stage, 1 - p, 0, P::NH == 4 ? 2 : 1, maps, hh, (int)bi,
                    (int)(c - 1) * C, rbar0);
    {  // b_t = v_t . do_t and q_t = sum_i (r_t[i] u_i) k_t[i]: LPS lanes a
       // step, each an FMA chain over KPL keys, then a butterfly
      const int t = tid / P::LPS, pl = tid % P::LPS, kb = pl * P::KPL;
      const float* st = bwd_slot<HD>(stage, p, t);
      float bs = 0.f, qs = 0.f;
#pragma unroll
      for (int m = 0; m < P::KPL; m += 4) {
        float r4[4], k4[4], v4[4], d4[4], u4[4];
        ld_vec<4>(st + kb + m, r4);
        ld_vec<4>(st + P::AS + kb + m, k4);
        ld_vec<4>(st + 3 * P::AS + kb + m, v4);
        ld_vec<4>(st + 4 * P::AS + kb + m, d4);
        ld_vec<4>(us + kb + m, u4);
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          bs = fmaf(v4[e], d4[e], bs);
          qs = fmaf(r4[e] * u4[e], k4[e], qs);
        }
      }
#pragma unroll
      for (int d = 1; d < P::LPS; d *= 2) {
        bs += __shfl_xor_sync(~0u, bs, d);
        qs += __shfl_xor_sync(~0u, qs, d);
      }
      if (pl == 0 && t < n) { bq[t] = bs; bq[C + t] = qs; }
    }
    PHASE(1);
    // the sub-chunks' starts, from the chunk's (the last one, whose slot
    // holds the chunk's start as rows until every thread has read it, past
    // barrier B)
    const int nsub = (n + U - 1) / U;
    start_store<HD>(starts + 4 * tid, S);
    for (int s = 0; s + 1 < nsub; ++s) {
#pragma unroll
      for (int x = 0; x < U; ++x)
        bwd_advance<HD>(S, bwd_slot<HD>(stage, p, s * U + x), i0, jc);
      if (s + 2 < nsub)
        start_store<HD>(starts + (s + 1) * E * NT + 4 * tid, S);
    }
    PHASE(2);
    __syncthreads();                          // B
    if (nsub > 1) start_store<HD>(starts + (nsub - 1) * E * NT + 4 * tid, S);
    PHASE(3);
    const int spf = (nsub < P::NSUB / 2 ? nsub : P::NSUB / 2) - 1;
    // dv of the chunk's sub-chunk s2 once every warp has written its sums
    // (the walk of sub-chunk s2 - 1 has started): the warps' sums in warp
    // order, then the bonus term q_t do_t
    auto dv_sums = [&](int s2) {
      mbar_wait(dvbar, dvph);
      dvph ^= 1;
      // with three halves, chunk c - 1's second half once every thread is
      // past the steps from C / 2 (walked, their dv summed); chunk c - 1's
      // start once every thread is past the last slot's sub-chunk
      if (c > 0 && tid == 0) {
        if (P::NH == 3 && s2 == spf)
          bwd_stage<HD>(stage, 1 - p, 1, 2, maps, hh, (int)bi,
                        (int)(c - 1) * C, rbar1);
        if (s2 == nsub - 1)
          start_stage<HD>(scslot, maps, j0, (int)c - 1, (int)bh, scbar);
      }
      PHASE(6);
      const int m2 = (int)lmin(U, n - s2 * U);
      const float* vb2 = dvb + (s2 & 1) * (U * NW * JB);
#pragma unroll
      for (int it = 0; it < (U * JB + NT - 1) / NT; ++it) {
        const int idx = tid + it * NT;
        if (idx < m2 * JB) {
          const int x = idx / JB, j = idx - x * JB, t = s2 * U + x;
          const float acc = lane_sum<NW, JB>(vb2 + x * NW * JB + j);
          dv[crow + t * ld + j0 + j] = fmaf(
              bq[C + t], bwd_slot<HD>(stage, p, t)[4 * P::AS + j0 + j], acc);
        }
      }
      PHASE(7);
    };
    for (int s = nsub - 1; s >= 0; --s) {
      const int m = (int)lmin(U, n - s * U);
      const float* start = starts + s * E * NT + 4 * tid;
      float* vb = dvb + (s & 1) * (U * NW * JB);
      // the warp's sums of the sub-chunk's step x (staged at st) from its
      // scratch: over the column lanes (and the bonus terms in the first
      // block of a head) to dr, dk, dw, over the key lanes to vb
      auto reduce = [&](int x, const float* st) {
        const int t = s * U + x;
        const float* Jx = J + (x % JDB) * P::WS;
#pragma unroll
        for (int mo = 0; mo < P::OUTS; ++mo) {
          float acc = lane_sum<CL, WK>(Jx + jof[mo]);
          if (mo == 0) {
            const float bb = bq[t], ri = st[bkey], ki = st[P::AS + bkey];
            const float bo = fmaf(ul * (isr ? ki : ri), bb, acc);
            const float du2 = fmaf(ri * ki, bb, dua);
            acc = bon ? bo : acc;
            dua = bon && isr ? du2 : dua;
          }
          if (jon[mo]) jout[mo][crow + t * ld] = acc;
        }
        float a2[CPL];
        lane_sums<KL, JB, CPL>(Jx + 3 * JS + vcol, a2);
        if (lane * CPL < JB)
          st_vec<CPL>(vb + (x * NW + warp) * JB + vcol, a2);
      };
      // the sub-chunk's steps, as straight-line code where it is whole;
      // with two scratch buffers a step's partials are summed during the
      // step before it (one __syncwarp a step)
      auto walk = [&](auto whole) {
        constexpr bool W = decltype(whole)::value;
        const float* sb = bwd_slot<HD>(stage, p, s * U);  // steps HD apart
        // its states: h[x] before its step x (h[0], its start, is read
        // again at step 0)
        PHASE(4);
        float h[U][KI][JT];
        start_load<HD>(start, h[0]);
#pragma unroll
        for (int x = 1; x < U; ++x) {
          if (W || x < m) {
#pragma unroll
            for (int a = 0; a < KI; ++a)
#pragma unroll
              for (int b = 0; b < JT; ++b) h[x][a][b] = h[x - 1][a][b];
            bwd_advance<HD>(h[x], sb + (x - 1) * HD, i0, jc);
          }
        }
        PHASE(5);
        if (s + 1 < nsub) dv_sums(s + 1);
#pragma unroll
        for (int x = U - 1; x >= 0; --x) {
          if (W || x < m) {
            const float* st = sb + x * HD;
            float* Jx = J + (x % JDB) * P::WS;
            float Sp[KI][JT], rr[KI], kk[KI], ww[KI], vv[JT], dd[JT];
            if (x == 0) {
              start_load<HD>(start, Sp);
            } else {
#pragma unroll
              for (int a = 0; a < KI; ++a)
#pragma unroll
                for (int b = 0; b < JT; ++b) Sp[a][b] = h[x][a][b];
            }
            ld_vec<KI>(st + i0, rr);
            ld_vec<KI>(st + P::AS + i0, kk);
            ld_vec<KI>(st + 2 * P::AS + i0, ww);
#pragma unroll
            for (int g = 0; g < NV; ++g) {
              ld_vec<4>(st + 3 * P::AS + jc + g * P::RUN, vv + 4 * g);
              ld_vec<4>(st + 4 * P::AS + jc + g * P::RUN, dd + 4 * g);
            }
            // a thread's sums: over its columns (dr, dk, dw), its keys (dv)
            float pr[KI], pk[KI], pw[KI], pv[JT];
#pragma unroll
            for (int b = 0; b < JT; ++b) pv[b] = 0.f;
#pragma unroll
            for (int a = 0; a < KI; ++a) {
              pr[a] = pk[a] = pw[a] = 0.f;
#pragma unroll
              for (int b = 0; b < JT; ++b) {
                pr[a] = fmaf(Sp[a][b], dd[b], pr[a]);
                pk[a] = fmaf(D[a][b], vv[b], pk[a]);
                pw[a] = fmaf(D[a][b], Sp[a][b], pw[a]);
                pv[b] = fmaf(D[a][b], kk[a], pv[b]);
                D[a][b] = __fadd_rn(__fmul_rn(ww[a], D[a][b]),
                                    __fmul_rn(rr[a], dd[b]));
              }
            }
            if (JDB == 2 && x + 1 < U && (W || x + 1 < m))
              reduce(x + 1, st + HD);
            // to the warp's scratch: J[q][cl][key], V[kl][column]
            st_vec<KI>(Jx + cl * WK + kl * KI, pr);
            st_vec<KI>(Jx + JS + cl * WK + kl * KI, pk);
            st_vec<KI>(Jx + 2 * JS + cl * WK + kl * KI, pw);
#pragma unroll
            for (int g = 0; g < NV; ++g)
              st_vec<4>(Jx + 3 * JS + kl * JB + g * P::RUN + 4 * cl,
                        pv + 4 * g);
            __syncwarp();
            if (JDB == 1) {
              reduce(x, st);
              __syncwarp();                   // the scratch free again
            }
          }
        }
        if (JDB == 2) reduce(0, sb);
        PHASE(8);
      };
      if (m == U)
        walk(Bool<true>{});
      else
        walk(Bool<false>{});
      mbar_arrive(dvbar);
    }
    dv_sums(0);
  }
  PHASE(9);
  st_tile<HD>(dS0 + bh * HD * HD, i0, jc, D);
  if (jb == 0 && lane < WK) du[bh * HD + wk0 + lane] = dua;
#ifdef REPRO_WKV6_BWD_PHASES
  if (lane == 0 && blockIdx.x < 64 && warp < 16)
    for (int i = 0; i < 10; ++i) bwd_phases[blockIdx.x][warp][i] = phase_[i];
#endif
}

// A contiguous fp32 tensor of dims (innermost first) at ptr, as a tensor
// map of boxes `box` (no swizzle; elements past its edge arrive as zeros):
// cudaErrorInvalidValue where the encoder refuses it, cudaErrorNotSupported
// without the encoder.
cudaError_t encode_f32(CUtensorMap* map, const void* ptr,
                       const cuuint64_t (&dims)[4],
                       const cuuint32_t (&box)[4]) {
  const repro_hopper::EncodeTiled fn = repro_hopper::encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  cuuint64_t strides[3];
  cuuint64_t st = dims[0] * sizeof(float);
  for (int i = 0; i < 3; ++i) {
    strides[i] = st;
    st *= dims[i + 1];
  }
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
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

// The backward's shared memory limit, raised once a device.
template <int HD>
cudaError_t allow_bwd_smem() {
  static unsigned done = 0;
  return allow_smem(wkv6_bwd_kernel<HD>, BPlan<HD>::BYTES, done);
}

// Blocks of the backward an SM holds at once (registers, shared memory,
// threads), or minus the CUDA error.
template <int HD>
int bwd_blocks_per_sm() {
  cudaError_t e = allow_bwd_smem<HD>();
  int blocks = 0;
  if (e == cudaSuccess)
    e = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &blocks, wkv6_bwd_kernel<HD>, BPlan<HD>::NT, BPlan<HD>::BYTES);
  return e == cudaSuccess ? blocks : -static_cast<int>(e);
}

template <int HD>
int launch_bwd(const BwdArgs& x, int64_t B, int64_t T, int H,
               cudaStream_t s) {
  using P = BPlan<HD>;
  cudaError_t e = allow_bwd_smem<HD>();
  if (e != cudaSuccess) return static_cast<int>(e);
  const unsigned blocks = (unsigned)(B * H * (HD / P::JB));
  BwdMaps maps;
  const float* ops[5] = {x.r, x.k, x.w, x.v, x.dout};
  for (int a = 0; a < 5 && e == cudaSuccess; ++a)
    e = encode_f32(&maps.op[a], ops[a],
                   {(cuuint64_t)HD, (cuuint64_t)H, (cuuint64_t)T,
                    (cuuint64_t)B},
                   {(cuuint32_t)HD, 1, (cuuint32_t)P::H2, 1});
  if (e == cudaSuccess)
    e = encode_f32(&maps.sc, x.Sc,
                   {(cuuint64_t)HD, (cuuint64_t)HD,
                    (cuuint64_t)((T + P::C - 1) / P::C), (cuuint64_t)(B * H)},
                   {(cuuint32_t)P::JB, (cuuint32_t)HD, 1, 1});
  if (e != cudaSuccess) return static_cast<int>(e);
  wkv6_bwd_kernel<HD><<<blocks, P::NT, P::BYTES, s>>>(
      maps, x.u, x.dST, x.dr, x.dk, x.dv, x.dw, x.du, x.dS0, B, T, H);
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

#ifdef REPRO_WKV6_BWD_PHASES
extern "C" int repro_wkv6_bwd_phases(void* host) {
  return static_cast<int>(
      cudaMemcpyFromSymbol(host, bwd_phases, sizeof(bwd_phases)));
}
#endif

extern "C" int repro_wkv6_bwd_sub(long long hd) {
  switch (hd) {
    case 16: return BPlan<16>::U;
    case 32: return BPlan<32>::U;
    case 64: return BPlan<64>::U;
    case 128: return BPlan<128>::U;
    default: return 0;
  }
}

extern "C" int repro_wkv6_bwd_blocks_per_sm(long long hd) {
  switch (hd) {
    case 16: return bwd_blocks_per_sm<16>();
    case 32: return bwd_blocks_per_sm<32>();
    case 64: return bwd_blocks_per_sm<64>();
    case 128: return bwd_blocks_per_sm<128>();
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
