// Hopper (sm_90a) building blocks shared by the port's tensor-core kernels
// (local_attn.cu, local_attn_bwd.cu, block_matvec_tc.cu,
// block_matvec_tf32.cu, gram_tf32.cu, gram_bf16.cu): mbarriers, TMA tile loads through tensor maps (multicast
// to the blocks of a cluster, with remote barrier arrivals and the
// cluster's barrier), bulk copies of a block's finished box into another
// block's shared memory (distributed shared memory), cp.async copies that
// complete on an mbarrier (the cp.async producer of a stage, fp32 or bf16,
// and the register copies of bf16 rows 2 bytes off a 4-byte boundary), the
// stage ring a producer fills for consumer warps, wgmma shared-memory
// descriptors, the bf16 wgmma forms with both operands in shared memory and
// with A in registers (attention's P V and its gradient's products), the
// tf32 forms with A in registers (ldmatrix, the tf32 rounding and 3xTF32
// split), attention's exp and tanh, and the lookup of libcuda's tensor-map
// encoder through the runtime (no -lcuda at link time), with the tensor
// maps of a matrix and of an attention operand.
//
// Layouts (128-byte swizzle, as TMA writes a box of 128-byte rows: 64 bf16
// or 32 fp32 columns):
// * K-major operand (the reduction axis contiguous): rows of 128 bytes,
//   8-row groups 1024 bytes apart; desc(addr + 32 * s, 16, 1024) is the
//   operand of the s-th 32-byte step of a box (16 deep in bf16, 8 in tf32).
//   Within each 8-row group, the 16-byte chunk c of row r lies at chunk
//   c ^ (r % 8).
// * MN-major operand (the output axis contiguous; A too in bf16): boxes of 64
//   output columns x R reduction rows, `lbo` = R * 128 bytes between the
//   boxes, 8-row groups `sbo` = 1024 bytes apart; the s-th 16-deep step
//   starts 16 rows (2048 bytes) further.
// Every box starts on a 1024-byte boundary (the swizzle repeats every 8 rows).

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <stdint.h>

namespace repro_hopper {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make the initialised barriers visible to the TMA unit (the async proxy).
__device__ __forceinline__ void mbar_init_fence() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n" ::"r"(
          bar),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.shared::cta.b64 state, [%0];\n}\n" ::"r"(bar)
      : "memory");
}

// Wait until the phase of parity `parity` of the barrier has completed.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  while (!done) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  }
}

// One box of a 2-D tensor map at (column c0, row c1) into shared memory;
// completes its bytes on the barrier.  Elements past the tensor's edge
// arrive as zeros.
__device__ __forceinline__ void tma_load_2d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

// The same for a 4-D tensor map at (c0, c1, c2, c3).
__device__ __forceinline__ void tma_load_4d(uint32_t dst,
                                            const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::
          "r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// The same 2-D box, written at the same shared-memory offset `dst` in every
// block of the cluster whose rank is set in `mask`, each completing its
// bytes on the barrier at offset `bar` of its own shared memory.
__device__ __forceinline__ void tma_load_2d_multicast(uint32_t dst,
                                                      const CUtensorMap* map,
                                                      uint32_t bar, int c0,
                                                      int c1, uint16_t mask) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile"
      ".mbarrier::complete_tx::bytes.multicast::cluster"
      " [%0], [%1, {%3, %4}], [%2], %5;\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "h"(mask)
      : "memory");
}

// `bytes` (a multiple of 16) of this block's shared memory at offset `src`
// to the same offset in the shared memory of the cluster's block `rank`, by
// the TMA unit: it reads through the async proxy, so the source's writes by
// cp.async or st.shared are ordered before it by fence_proxy_async.
// Completes its bytes on the barrier at offset `bar` of that block.
__device__ __forceinline__ void push_to_cluster(uint32_t src, uint32_t bar,
                                                uint32_t bytes,
                                                uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 rdst, rbar;\n"
      "mapa.shared::cluster.u32 rdst, %0, %3;\n"
      "mapa.shared::cluster.u32 rbar, %1, %3;\n"
      "cp.async.bulk.shared::cluster.shared::cta.mbarrier::complete_tx::bytes"
      " [rdst], [%0], %2, [rbar];\n}\n" ::"r"(src),
      "r"(bar), "r"(bytes), "r"(rank)
      : "memory");
}

// One arrival on the barrier at offset `bar` of the shared memory of the
// cluster's block `rank` (this block's own included).
__device__ __forceinline__ void mbar_arrive_cluster(uint32_t bar,
                                                    uint32_t rank) {
  asm volatile(
      "{\n.reg .b32 remote;\n"
      "mapa.shared::cluster.u32 remote, %0, %1;\n"
      "mbarrier.arrive.shared::cluster.b64 _, [remote];\n}\n" ::"r"(bar),
      "r"(rank)
      : "memory");
}

// Every thread of every block of the cluster arrives, then waits for the
// others: barriers initialised before any block touches another's, and no
// block gone while another may still arrive on its barriers.
__device__ __forceinline__ void cluster_sync() {
  asm volatile("barrier.cluster.arrive;\n" ::: "memory");
  asm volatile("barrier.cluster.wait;\n" ::: "memory");
}

// wgmma shared-memory descriptor, 128-byte swizzle (see the layouts above).
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>(lbo >> 4) << 16) |
         (static_cast<uint64_t>(sbo >> 4) << 32) | (1ull << 62);
}

__device__ __forceinline__ void wg_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wg_wait_all() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}
// Pin registers that an asynchronous wgmma reads or writes to this point of
// the program, so the compiler neither reads them early nor reuses them.
template <int N>
__device__ __forceinline__ void hold(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void hold(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// D (64 x 16, fp32) += A (64 x 16) * B (16 x 16), both from shared memory;
// A K-major (TRANS_A = 0) or MN-major (TRANS_A = 1), B likewise by TRANS_B.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_n16(float (&d)[8], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %10, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "%8, %9, p, 1, 1, %12, %11;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B),
        "n"(TRANS_A));
}

// D (64 x 32, fp32) += A (64 x 16) * B (16 x 32), both from shared memory;
// A K-major (TRANS_A = 0) or MN-major (TRANS_A = 1), B likewise by TRANS_B.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_n32(float (&d)[16], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, %20, %19;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B),
        "n"(TRANS_A));
}

// D (64 x 64, fp32) += A (64 x 16) * B (16 x 64), both from shared memory;
// A K-major (TRANS_A = 0) or MN-major (TRANS_A = 1), B likewise by TRANS_B.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, %36, %35;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B),
        "n"(TRANS_A));
}

// D (64 x 128, fp32) += A (64 x 16) * B (16 x 128), both from shared memory;
// A K-major (TRANS_A = 0) or MN-major (TRANS_A = 1), B likewise by TRANS_B.
template <int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, %68, %67;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d), "n"(TRANS_B),
        "n"(TRANS_A));
}

// D (64 x N) += A (64 x 16) * B (16 x N), N in {16, 32, 64, 128}; A
// MN-major (the output rows contiguous) with TRANS_A = 1, as B with
// TRANS_B = 1 (bf16 only: tf32 has no transposed forms).
template <int N, int TRANS_B, int TRANS_A = 0>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 16)
    wgmma_ss_n16<TRANS_B, TRANS_A>(d, da, db, scale_d);
  else if constexpr (N == 32)
    wgmma_ss_n32<TRANS_B, TRANS_A>(d, da, db, scale_d);
  else if constexpr (N == 64)
    wgmma_ss_n64<TRANS_B, TRANS_A>(d, da, db, scale_d);
  else
    wgmma_ss_n128<TRANS_B, TRANS_A>(d, da, db, scale_d);
}

// D (64 x 64, fp32) += A (64 x 16, registers) * B (16 x 64, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t (&a)[4],
                                             uint64_t db,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, registers) * B (16 x 128, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t (&a)[4],
                                             uint64_t db,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 256, fp32) += A (64 x 16, registers) * B (16 x 256, smem, MN-major).
__device__ __forceinline__ void wgmma_rs_n256(float (&d)[128],
                                             const uint32_t (&a)[4],
                                             uint64_t db,
                                             int scale_d = 1) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %133, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n256k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63,"
      "%64, %65, %66, %67, %68, %69, %70, %71,"
      "%72, %73, %74, %75, %76, %77, %78, %79,"
      "%80, %81, %82, %83, %84, %85, %86, %87,"
      "%88, %89, %90, %91, %92, %93, %94, %95,"
      "%96, %97, %98, %99, %100, %101, %102, %103,"
      "%104, %105, %106, %107, %108, %109, %110, %111,"
      "%112, %113, %114, %115, %116, %117, %118, %119,"
      "%120, %121, %122, %123, %124, %125, %126, %127}, "
      "{%128, %129, %130, %131}, %132, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]),
        "+f"(d[64]), "+f"(d[65]), "+f"(d[66]), "+f"(d[67]),
        "+f"(d[68]), "+f"(d[69]), "+f"(d[70]), "+f"(d[71]),
        "+f"(d[72]), "+f"(d[73]), "+f"(d[74]), "+f"(d[75]),
        "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79]),
        "+f"(d[80]), "+f"(d[81]), "+f"(d[82]), "+f"(d[83]),
        "+f"(d[84]), "+f"(d[85]), "+f"(d[86]), "+f"(d[87]),
        "+f"(d[88]), "+f"(d[89]), "+f"(d[90]), "+f"(d[91]),
        "+f"(d[92]), "+f"(d[93]), "+f"(d[94]), "+f"(d[95]),
        "+f"(d[96]), "+f"(d[97]), "+f"(d[98]), "+f"(d[99]),
        "+f"(d[100]), "+f"(d[101]), "+f"(d[102]), "+f"(d[103]),
        "+f"(d[104]), "+f"(d[105]), "+f"(d[106]), "+f"(d[107]),
        "+f"(d[108]), "+f"(d[109]), "+f"(d[110]), "+f"(d[111]),
        "+f"(d[112]), "+f"(d[113]), "+f"(d[114]), "+f"(d[115]),
        "+f"(d[116]), "+f"(d[117]), "+f"(d[118]), "+f"(d[119]),
        "+f"(d[120]), "+f"(d[121]), "+f"(d[122]), "+f"(d[123]),
        "+f"(d[124]), "+f"(d[125]), "+f"(d[126]), "+f"(d[127])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x N) += A (64 x 16, bf16, registers) * B (16 x N, smem, MN-major),
// N in {64, 128, 256}.  A's registers, as mma.m16n8k16's per warp (warp w:
// rows 16 w .. + 15), two bf16 each: a[0] (row lane / 4, columns 2 (lane %
// 4) and + 1), a[1] row + 8, a[2] columns + 8, a[3] both: the accumulator
// layout of an m64n16 product, so a product's fp32 accumulators, rounded
// to bf16 in pairs, are the next product's A.  scale_d = 0: D = A B.
template <int N>
__device__ __forceinline__ void wgmma_rs(float (&d)[N / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db, int scale_d = 1) {
  static_assert(N == 64 || N == 128 || N == 256, "wgmma_rs width");
  if constexpr (N == 64)
    wgmma_rs_n64(d, a, db, scale_d);
  else if constexpr (N == 128)
    wgmma_rs_n128(d, a, db, scale_d);
  else
    wgmma_rs_n256(d, a, db, scale_d);
}


// D (64 x 16, fp32) += A (64 x 8, tf32, registers) * B (8 x 16, tf32, smem,
// K-major).
__device__ __forceinline__ void wgmma_rs_tf32_n16(float (&d)[8],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %13, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n16k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7}, "
      "{%8, %9, %10, %11}, %12, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 32, fp32) += A (64 x 8, tf32, registers) * B (8 x 32, tf32, smem,
// K-major).
__device__ __forceinline__ void wgmma_rs_tf32_n32(float (&d)[16],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 64, fp32) += A (64 x 8, tf32, registers) * B (8 x 64, tf32, smem,
// K-major).
__device__ __forceinline__ void wgmma_rs_tf32_n64(float (&d)[32],
                                                  const uint32_t (&a)[4],
                                                  uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 8, tf32, registers) * B (8 x 128, tf32,
// smem, K-major).
__device__ __forceinline__ void wgmma_rs_tf32_n128(float (&d)[64],
                                                   const uint32_t (&a)[4],
                                                   uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7,"
      "%8, %9, %10, %11, %12, %13, %14, %15,"
      "%16, %17, %18, %19, %20, %21, %22, %23,"
      "%24, %25, %26, %27, %28, %29, %30, %31,"
      "%32, %33, %34, %35, %36, %37, %38, %39,"
      "%40, %41, %42, %43, %44, %45, %46, %47,"
      "%48, %49, %50, %51, %52, %53, %54, %55,"
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(scale_d));
}

// D (64 x N) += A (64 x 8, tf32 in registers) * B (8 x N), N in {16, 32, 64,
// 128}.  A's registers, as mma.m16n8k8's per warp (warp w: rows 16 w ..
// + 15): a[0] (row lane / 4, column lane % 4), a[1] row + 8, a[2] column + 4,
// a[3] both.  tf32 has no transposed forms: B is K-major, A in registers.
template <int N>
__device__ __forceinline__ void wgmma_rs_tf32(float (&d)[N / 2],
                                              const uint32_t (&a)[4],
                                              uint64_t db, int scale_d) {
  static_assert(N == 16 || N == 32 || N == 64 || N == 128, "wgmma width");
  if constexpr (N == 16)
    wgmma_rs_tf32_n16(d, a, db, scale_d);
  else if constexpr (N == 32)
    wgmma_rs_tf32_n32(d, a, db, scale_d);
  else if constexpr (N == 64)
    wgmma_rs_tf32_n64(d, a, db, scale_d);
  else
    wgmma_rs_tf32_n128(d, a, db, scale_d);
}

// x rounded to tf32, to nearest with ties away from zero (the low 13 bits
// zero).
__device__ __forceinline__ uint32_t tf32_rna(float x) {
  uint32_t r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return r;
}

// The fragment x split into its tf32 halves for 3xTF32: hi = tf32(x), lo =
// tf32(x - hi).
__device__ __forceinline__ void split(const uint32_t (&x)[4], uint32_t (&hi)[4],
                                      uint32_t (&lo)[4]) {
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    const float v = __uint_as_float(x[e]);
    hi[e] = tf32_rna(v);
    lo[e] = tf32_rna(v - __uint_as_float(hi[e]));
  }
}

// The column of A, within its 32-column box, that output row i (0 .. 31)
// of an m64 tile's box-half stands for, where the tf32 A operand is a tile
// of A^T read element by element out of a row-major stage of A: bits 0-1
// of i stay, bit 2 of i becomes bit 4, bit 3 becomes bit 2 and bit 4
// becomes bit 3.  A warp's reads of A^T's fragment (8 rows of output,
// lane / 4, by 4 reduction rows, lane % 4) then fall on 32 distinct banks
// of the swizzled stage.
__device__ __forceinline__ int rmatvec_col(int i) {
  return (i & 3) | ((i >> 2 & 1) << 4) | ((i >> 3 & 1) << 2) |
         ((i >> 4 & 1) << 3);
}

// Order this thread's shared-memory stores before later reads by the async
// proxy (wgmma, TMA) that another thread's barrier wait lets through.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// Four 8 x 8 b16 matrices from shared memory (lane j gives the address of
// row j % 8 of matrix j / 8): of 16-byte rows of 4 fp32, lane l receives
// element l % 4 of row l / 4 of each, the tf32 A fragment's layout.
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ uint32_t lds_u32(uint32_t addr) {
  uint32_t r;
  asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(r) : "r"(addr) : "memory");
  return r;
}

// CP bytes (4, 8 or 16) from global into shared memory by cp.async (LDGSTS;
// `dst` and `src` aligned to CP); the bytes past `src_bytes` (0 .. CP) are
// not read and arrive as zeros.  L2 fetches 256 bytes around a miss, as the
// tensor maps of encode_2d ask (CU_TENSOR_MAP_L2_PROMOTION_L2_256B).
template <int CP>
__device__ __forceinline__ void cp_async(uint32_t dst, const void* src,
                                         int src_bytes) {
  asm volatile("cp.async.ca.shared.global.L2::256B [%0], [%1], %2, %3;\n" ::
                   "r"(dst),
               "l"(src), "n"(CP), "r"(src_bytes)
               : "memory");
}

// One arrival on the barrier once every cp.async this thread issued before
// has landed; .noinc: the barrier's expected count includes the arrival.
__device__ __forceinline__ void cp_async_arrive(uint32_t bar) {
  asm volatile("cp.async.mbarrier.arrive.noinc.shared::cta.b64 [%0];\n" ::"r"(
                   bar)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// Close this thread's group of the cp.async issued since the last one.
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's latest groups are still in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait_group() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The producer thread t's (0 .. 127) share of a stage of A by cp.async:
// rows r0 .. r0 + R - 1 and columns c0 .. c0 + W BOXES - 1 of A (elements
// of type T, fp32 or bf16; rows lda apart), as BOXES boxes of R rows x W
// elements, W = 128 bytes (32 fp32 or 64 bf16), box b the columns c0 + W b
// .., each row of 128 bytes in the 128-byte swizzle (16-byte chunk c of
// row r at chunk c ^ (r % 8)), exactly as TMA writes the box.  Copies of
// CP elements (4 or 8 bytes).  Rows from r_end and columns from n arrive
// as zeros and are not read, a copy that straddles n reading only its
// elements inside (2 bytes of 4 where a bf16 row of odd n ends half way
// into it); ZFILL = false, a planted fault: the columns past n are copied
// from past the end of the row.  A thread keeps its columns (consecutive
// threads on consecutive copies of a row: coalesced) and steps down the
// rows by a fixed stride; its rows fall on 8 swizzle patterns, whose
// destinations it computes once, so a stage with no row past the edge
// costs a copy and a pointer step a copy.  UNROLL: the rows' loop unrolled
// whole, else in groups of 8.
template <int CP, int R, int BOXES, bool UNROLL, bool ZFILL = true,
          typename T>
__device__ __forceinline__ void copy_stage(uint32_t dst,
                                           const T* __restrict__ A,
                                           long long lda, int r0, int r_end,
                                           int c0, int n, int t) {
  constexpr int E = sizeof(T);               // bytes an element
  constexpr int W = 128 / E;                 // elements a row of a box
  constexpr int S = E == 4 ? 2 : 3;          // log2 of elements a chunk
  constexpr int UPR = W * BOXES / CP;        // copies in a row of the stage
  constexpr int TPR = UPR < 128 ? UPR : 128; // threads on one row
  constexpr int RPP = 128 / TPR;             // rows a pass of the 128 threads
  constexpr int P = R / RPP;                 // copies a thread a column
  static_assert(P % 8 == 0, "rows in whole swizzle patterns");
  const int rt = TPR == 128 ? 0 : t / TPR;   // the thread's first row
  const bool whole = r0 + R <= r_end;        // no row past the edge
#pragma unroll 1
  for (int cs = 0; cs < UPR / TPR; ++cs) {   // the thread's columns, in turn
    const int c = (t % TPR + cs * TPR) * CP, j = c % W;
    const int left = ZFILL ? max(0, min(CP, n - c0 - c)) : CP;
    uint32_t d[8];                           // rows rt + q RPP, q < 8
#pragma unroll
    for (int q = 0; q < 8; ++q) {
      const int r = rt + q * RPP;
      d[q] = dst + (c / W) * R * 128 + r * 128 +
             (((j >> S) ^ (r & 7)) << 4) + E * (j & ((1 << S) - 1));
    }
    // a column past n reads nothing: the source stays at A's base
    const T* src = left > 0 ? A + (r0 + rt) * lda + c0 + c : A;
    const long long step = left > 0 ? RPP * lda : 0;
    // 8 rows a group, one of each swizzle pattern
    auto group = [&](int p) {
      const uint32_t off = p * RPP * 128;
      if (whole) {
#pragma unroll
        for (int q = 0; q < 8; ++q, src += step)
          cp_async<E * CP>(d[q] + off, src, E * left);
      } else {
#pragma unroll
        for (int q = 0; q < 8; ++q, src += step) {
          const int bytes = r0 + rt + (p + q) * RPP < r_end ? E * left : 0;
          cp_async<E * CP>(d[q] + off, bytes > 0 ? src : A, bytes);
        }
      }
    };
    if constexpr (UNROLL) {
#pragma unroll
      for (int p = 0; p < P; p += 8) group(p);
    } else {
#pragma unroll 1
      for (int p = 0; p < P; p += 8) group(p);
    }
  }
}

__device__ __forceinline__ void sts_v4(uint32_t addr, uint32_t a, uint32_t b,
                                       uint32_t c, uint32_t d) {
  asm volatile("st.shared.v4.b32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(a), "r"(b), "r"(c), "r"(d)
               : "memory");
}

__device__ __forceinline__ uint32_t ldg_u32(const char* p) {
  return __ldg(reinterpret_cast<const unsigned int*>(p));
}

// One 16-byte chunk of a bf16 stage whose rows no tensor map describes
// (gram_bf16.cu's "wgmma_ld", block_matvec_tc.cu's): 8 bf16 of A from
// `src`, of which the first v (1 .. 8) exist, into shared memory at `dst`,
// zeros after them.  Where `src` is 4-byte aligned, cp.async of the widest
// size its address allows (16, 8 or 4 bytes), the bytes past v arriving as
// zeros; else (2 bytes off) the 4-byte words around it, w[k] holding
// elements 2k - 1 and 2k, each loaded only where it holds an element that
// exists, and stored by put_chunk once they have landed.
__device__ __forceinline__ void load_words(const char* src, int v,
                                           uint32_t (&w)[5]) {
  const char* p = src - 2;                  // 4-byte aligned
  w[0] = ldg_u32(p);
  w[1] = v > 1 ? ldg_u32(p + 4) : 0u;
  w[2] = v > 3 ? ldg_u32(p + 8) : 0u;
  w[3] = v > 5 ? ldg_u32(p + 12) : 0u;
  w[4] = v > 7 ? ldg_u32(p + 16) : 0u;
}

__device__ __forceinline__ void copy_chunk(uint32_t dst, const char* src,
                                           int v, bool by16, bool by8) {
  const int bytes = 2 * v;
  if (by16) {
    cp_async<16>(dst, src, bytes);
  } else if (by8) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int b = min(8, max(0, bytes - 8 * h));
      cp_async<8>(dst + 8 * h, b > 0 ? src + 8 * h : src, b);
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int b = min(4, max(0, bytes - 4 * q));
      cp_async<4>(dst + 4 * q, b > 0 ? src + 4 * q : src, b);
    }
  }
}

// The register half of a chunk: elements 2k and 2k + 1 are the high half
// of w[k] and the low half of w[k + 1]; those from v on are zero (all of
// them where v == 0: a chunk past A's edge).  The caller orders the store
// before the async proxy's reads with fence_proxy_async.
__device__ __forceinline__ void put_chunk(uint32_t dst, int v,
                                          const uint32_t (&w)[5]) {
  uint32_t o[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint32_t x = __byte_perm(w[k], w[k + 1], 0x5432);
    o[k] = 2 * k + 1 < v ? x : (2 * k < v ? x & 0xffffu : 0u);
  }
  sts_v4(dst, o[0], o[1], o[2], o[3]);
}

// The producer that reads an fp32 A (m, n), rows lda apart, on a 3xTF32
// route: "tf32x3" (cpasync false) TMA, 0; "tf32x3_cpasync" cp.async of 2
// fp32 where every row starts 8-byte aligned (lda even, base 8-byte
// aligned), else of 1.  -1 where the route cannot read A.
inline int fp32_producer(const void* A, long long lda, long long n,
                         bool cpasync) {
  const uintptr_t a = reinterpret_cast<uintptr_t>(A);
  if (a % 4 != 0 || lda < n) return -1;
  if (!cpasync) return a % 16 == 0 && lda % 4 == 0 ? 0 : -1;
  return a % 8 == 0 && lda % 2 == 0 ? 2 : 1;
}

// The ring of shared-memory stages that a producer fills for the consumer
// warps: full[s] completes when stage s's bytes have landed (FULL_ARRIVALS
// arrivals: 1 for a single TMA thread, which also announces the bytes),
// empty[s] when lane 0 of each of the CONSUMER_WARPS consumer warps has
// released it.  Barriers are 8 bytes apart from `full` and `empty`.
template <int STAGES, int CONSUMER_WARPS, int FULL_ARRIVALS = 1>
__device__ __forceinline__ void init_barriers(uint32_t full, uint32_t empty) {
  if (threadIdx.x == 0) {
    for (int s = 0; s < STAGES; ++s) {
      mbar_init(full + 8 * s, FULL_ARRIVALS);
      mbar_init(empty + 8 * s, CONSUMER_WARPS);
    }
    mbar_init_fence();
  }
  __syncthreads();
}

// The producer's turn for stage i: wait until the consumers released the
// slot's previous tile, then announce `bytes` on its full barrier.
template <int STAGES>
__device__ __forceinline__ uint32_t claim(uint32_t full, uint32_t empty, int i,
                                          uint32_t bytes) {
  const int s = i % STAGES;
  if (i >= STAGES) mbar_wait(empty + 8 * s, ((i / STAGES) - 1) & 1);
  mbar_expect_tx(full + 8 * s, bytes);
  return full + 8 * s;
}

// Blocks of a persistent launch: one a streaming multiprocessor, at most
// one a job.
inline int resident_blocks(long long jobs) {
  int dev = 0, sms = 132;
  if (cudaGetDevice(&dev) == cudaSuccess)
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  return static_cast<int>(jobs < sms ? jobs : sms);
}

// Attention's softmax arithmetic (local_attn.cu, local_attn_bwd.cu): 2^x
// on the special-function unit, and tanh without tanh.approx (2^-11).
constexpr float LOG2E = 1.4426950408889634f;

__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

// tanh(y) for |y| < 1/8: y + y^3 (c1 + y^2 (c2 + y^2 (c3 + y^2 c4))), the
// Taylor series; the next term is below 1e-11 relative there.
__device__ __forceinline__ float tanh_small(float y) {
  const float y2 = y * y;
  float p = fmaf(y2, 62.0f / 2835.0f, -17.0f / 315.0f);
  p = fmaf(y2, p, 2.0f / 15.0f);
  p = fmaf(y2, p, -1.0f / 3.0f);
  return fmaf(y * y2, p, y);
}
// tanh(y) for any y: 1 - 2 / (e^2|y| + 1) with an IEEE division, signed.
__device__ __forceinline__ float tanh_any(float y) {
  if (fabsf(y) < 0.125f) return tanh_small(y);
  const float e = exp2f(2.0f * LOG2E * fabsf(y));
  return copysignf(1.0f - 2.0f / (e + 1.0f), y);
}

// cuTensorMapEncodeTiled of libcuda, found through the runtime: no -lcuda.
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

inline EncodeTiled encoder() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (err == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// A row-major matrix of `rows` x `cols` at `ptr`, bf16 (`elem` = 2) or
// fp32 (`elem` = 4), rows `ld` elements apart, in boxes of 128 bytes of
// columns (64 bf16, 32 fp32) x `box_rows` rows with the 128-byte swizzle.
// TMA wants the base and `ld * elem` to be multiples of 16 bytes;
// cudaErrorInvalidValue where the encoder refuses the map,
// cudaErrorNotSupported without the encoder.
inline cudaError_t encode_2d(CUtensorMap* map, const void* ptr, long long rows,
                             long long cols, long long ld, int box_rows,
                             int elem = 2) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(cols),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(ld) * elem};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(128 / elem),
                             static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t unit[2] = {1, 1};
  return fn(map,
            elem == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                      : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16,
            2, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

// An attention operand: the bf16 (D, S, heads, B) view at `ptr` with element
// strides `st` = (b, h, s), in boxes of 64 x 64 (64 rows of S, 64 columns
// of D) with the 128-byte swizzle.  A dimension of size 1 takes any
// stride; TMA wants a multiple of 16 bytes there too.
inline cudaError_t encode_attn(CUtensorMap* map, const void* ptr, int D,
                               int S, int heads, int B,
                               const long long* st) {
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return cudaErrorNotSupported;
  const cuuint64_t dims[4] = {static_cast<cuuint64_t>(D),
                              static_cast<cuuint64_t>(S),
                              static_cast<cuuint64_t>(heads),
                              static_cast<cuuint64_t>(B)};
  const long long el[3] = {st[2], st[1], st[0]};   // s, h, b
  cuuint64_t strides[3];
  for (int i = 0; i < 3; ++i)
    strides[i] = dims[i + 1] == 1 ? 16 : static_cast<cuuint64_t>(el[i]) * 2;
  const cuuint32_t box[4] = {64, 64, 1, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  return fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, const_cast<void*>(ptr),
            dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
            CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
            CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS
             ? cudaSuccess
             : cudaErrorInvalidValue;
}

}  // namespace repro_hopper
