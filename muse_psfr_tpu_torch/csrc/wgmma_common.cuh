// Warpgroup helpers for Hopper (sm_90a) as inline PTX, no external headers
// beyond the CUDA toolkit's (mma_common.cuh gives smem_addr): the
// shared-memory matrix descriptors of the no-swizzle and the 64-byte-swizzle
// K-major layouts, the wgmma fences, commit and wait, the m64n32k16 bf16
// products with A from shared memory (SS) or from registers (RS), the
// m64n160k16 and m64n40k16 RS products, the per-warpgroup named barrier,
// and the pieces of a TMA pipeline: mbarriers, tensor-map loads,
// setmaxnreg.  K2 at "high" (conv_dft_tc.cu) uses the first group;
// K1/K3/K5 (zoom_dft_tc.cu) the wider RS products, the 64-byte-swizzle
// descriptor and the pipeline.
//
// Operand layout (K-major, no swizzle).  A tile of R rows (the M rows of an
// A operand, or the N columns of a B operand) by 64 contraction values k is
// stored as eight column chunks of 8 k each; chunk kc holds its R rows of 16
// bytes one after the other:
//
//     element (r, k) at  (k / 8) * R * 8 + r * 8 + k % 8      [bf16]
//
// so each 8 x 8 core matrix (8 rows of 16 bytes) is 128 contiguous bytes,
// the next 8 rows lie 128 bytes on (the stride byte offset, SBO) and the
// next 8 k lie R * 16 bytes on (the leading byte offset, LBO).  A product of
// 16 contraction values starts at chunk 2 s; a block of rows at row r0
// starts r0 * 16 bytes on.
//
// Operand layout (K-major, 64-byte swizzle), as a TMA load with
// CU_TENSOR_MAP_SWIZZLE_64B writes a box of 32 bf16 contraction values by R
// rows: row r at r * 64 bytes, its four 16-byte chunks c at
// ((c ^ (r / 2 % 4)) * 16), the pattern repeating every 8 rows (512 bytes,
// the SBO).  The tile starts on a 512-byte boundary; the 16 contraction
// values from k0 = 16 s start s * 32 bytes on, a block of rows at r0 (a
// multiple of 8) r0 * 64 bytes on, and the hardware applies the swizzle to
// the addresses it forms.
#pragma once

#include <cuda.h>

#include "mma_common.cuh"

namespace {

// element offset of (r, k) in a K-major tile of `rows` rows (see above)
__device__ __forceinline__ int kmajor_offset(int rows, int r, int k) {
  return (k >> 3) * rows * 8 + r * 8 + (k & 7);
}

// descriptor of a no-swizzle K-major operand at shared address `addr` in a
// tile of `rows` rows: LBO = rows * 16 bytes (next 8 contraction values),
// SBO = 128 bytes (next 8 rows), layout type 0 (no swizzle)
__device__ __forceinline__ uint64_t kmajor_desc(uint32_t addr, int rows) {
  const uint64_t lbo = static_cast<uint64_t>(rows * 16) >> 4;
  const uint64_t sbo = 128 >> 4;
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (lbo << 16) |
         (sbo << 32);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// keeps the compiler from moving reads or writes of a register across the
// asynchronous products that use it
__device__ __forceinline__ void fence_reg(float& r) {
  asm volatile("" : "+f"(r)::"memory");
}
__device__ __forceinline__ void fence_reg(uint32_t& r) {
  asm volatile("" : "+r"(r)::"memory");
}
template <typename T, int K>
__device__ __forceinline__ void fence_regs(T (&r)[K]) {
#pragma unroll
  for (int i = 0; i < K; ++i) fence_reg(r[i]);
}
template <typename T, int K, int J>
__device__ __forceinline__ void fence_regs(T (&r)[K][J]) {
#pragma unroll
  for (int i = 0; i < K; ++i) fence_regs(r[i]);
}

// the generic proxy's shared-memory writes made visible to wgmma's reads
__device__ __forceinline__ void fence_async_shared() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// barrier `id` (1..15) over the 128 threads of one warpgroup
__device__ __forceinline__ void warpgroup_bar(int id) {
  asm volatile("bar.sync %0, 128;\n" ::"r"(id) : "memory");
}

// d (+)= A . B on a 64 x 32 x 16 bf16 product, float32 accumulators; A and
// B from shared memory (K-major descriptors); `accumulate` 0 overwrites d
__device__ __forceinline__ void wgmma_m64n32k16_ss(float (&d)[16],
                                                   uint64_t desc_a,
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %18, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "%16, %17, p, 1, 1, 0, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "l"(desc_a), "l"(desc_b), "r"(accumulate));
}

// the same with A from registers: a[0..3] the A fragment (bf16 pairs) of
// this thread's rows, see above
__device__ __forceinline__ void wgmma_m64n32k16_rs(float (&d)[16],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15}, "
      "{%16, %17, %18, %19}, %20, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// descriptor of a 64-byte-swizzle K-major operand at shared address `addr`
// (see above): SBO = 512 bytes (next 8 rows), LBO unused, layout type 2
__device__ __forceinline__ uint64_t sw64_desc(uint32_t addr) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) | (1ull << 16) |
         (static_cast<uint64_t>(512 >> 4) << 32) | (2ull << 62);
}

// d (+)= A . B on a 64 x 160 x 16 bf16 product, float32 accumulators, A
// from registers (the fragment of wgmma_m64n32k16_rs), B from shared memory
__device__ __forceinline__ void wgmma_m64n160k16_rs(float (&d)[80],
                                                    const uint32_t (&a)[4],
                                                    uint64_t desc_b,
                                                    int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %85, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n160k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, %25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, %37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, %49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, %61, %62, %63, %64, %65, %66, %67, %68, %69, %70, %71, %72, %73, %74, %75, %76, %77, %78, %79}, "
      "{%80, %81, %82, %83}, %84, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63]), "+f"(d[64]),
        "+f"(d[65]), "+f"(d[66]), "+f"(d[67]), "+f"(d[68]), "+f"(d[69]),
        "+f"(d[70]), "+f"(d[71]), "+f"(d[72]), "+f"(d[73]), "+f"(d[74]),
        "+f"(d[75]), "+f"(d[76]), "+f"(d[77]), "+f"(d[78]), "+f"(d[79])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// the same on a 64 x 40 x 16 product
__device__ __forceinline__ void wgmma_m64n40k16_rs(float (&d)[20],
                                                   const uint32_t (&a)[4],
                                                   uint64_t desc_b,
                                                   int accumulate) {
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "setp.ne.b32 p, %25, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n40k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, %16, %17, %18, %19}, "
      "{%20, %21, %22, %23}, %24, p, 1, 1, 0;\n"
      "}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(accumulate));
}

// ---- the pieces of a TMA pipeline -----------------------------------------

__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// the barriers' initialisation made visible to the async proxy (TMA)
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

// one arrival that also expects `bytes` of TMA transactions
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::
                   "r"(bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(bar)
               : "memory");
}

__device__ __forceinline__ bool mbar_try_wait(uint32_t bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n"
      ".reg .pred p;\n"
      "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
      "selp.u32 %0, 1, 0, p;\n"
      "}\n"
      : "=r"(done)
      : "r"(bar), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ uint64_t global_ns() {
  uint64_t t;
  asm volatile("mov.u64 %0, %%globaltimer;\n" : "=l"(t));
  return t;
}

// waits until the phase of parity `parity` of barrier `bar` has completed;
// a phase that has not completed after 10 s (a stage that never lands)
// aborts the kernel with an error instead of hanging the card
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  if (mbar_try_wait(bar, parity)) return;
  const uint64_t t0 = global_ns();
  while (!mbar_try_wait(bar, parity))
    if (global_ns() - t0 > 10000000000ull) __trap();
}

// TMA loads of the box at the given coordinates (innermost first) of the
// tensor map `map` (a __grid_constant__ kernel parameter) into shared
// memory at `dst`, completing `bytes` on barrier `bar`
__device__ __forceinline__ void tma_load_2d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1)
      : "memory");
}

__device__ __forceinline__ void tma_load_3d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2)
      : "memory");
}

__device__ __forceinline__ void tma_load_4d(uint32_t dst, const CUtensorMap* map,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%3, %4, %5, %6}], [%2];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(bar), "r"(c0), "r"(c1),
      "r"(c2), "r"(c3)
      : "memory");
}

// the register budget of a warpgroup, raised for consumers and lowered for
// a producer (every warp of the warpgroup executes it)
template <int N>
__device__ __forceinline__ void reg_alloc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void reg_dealloc() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}

}  // namespace
