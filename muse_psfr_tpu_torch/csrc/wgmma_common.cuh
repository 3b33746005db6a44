// Warpgroup helpers for Hopper (sm_90a) as inline PTX, no external headers
// (mma_common.cuh gives smem_addr):
// the shared-memory matrix descriptor of the no-swizzle K-major layout, the
// wgmma fences, commit and wait, the m64n32k16 bf16 products with A from
// shared memory (SS) or from registers (RS), and the per-warpgroup named
// barrier.  K2 at "high" (conv_dft_tc.cu) uses them; they are written so that
// the zoom kernels can take them up as well.
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
// Accumulators.  The m64nNk16 f32 accumulator of thread t of the warpgroup
// (warp w = t / 32, lane l = t % 32) holds rows r = 16 w + l / 4 and r + 8,
// columns c = 8 j + 2 (l % 4) and c + 1 of each 8-column block j:
//
//     d[4 j] = (r, c), d[4 j + 1] = (r, c + 1),
//     d[4 j + 2] = (r + 8, c), d[4 j + 3] = (r + 8, c + 1).
//
// The A fragment of a register-sourced wgmma (rows 16 w.., 16 contraction
// values) is the same four pairs for two blocks j = 2 s, 2 s + 1: the
// accumulator of one product packed as bf16 pairs is the A operand of the
// next, with no shared memory between them (FlashAttention-3's P V).

#pragma once

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

}  // namespace
