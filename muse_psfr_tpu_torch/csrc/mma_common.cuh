// What the tensor-core bodies share (zoom_dft_tc.cu: K1, K3, K5;
// zoom_anchor_tc.cu: K6; conv_dft_tc.cu: K2 at "high"): the cp.async,
// ldmatrix and mma.sync.m16n8k16 bf16 wrappers, and for the zoom kernels
// the output store and the contraction of zoom_precision "highest".
//
// "highest" is the port of the JAX package's Precision.HIGHEST contraction
// (muse_psfr_tpu/ops/zoom_dft.py:_mxu_contract), which the TPU's matrix
// unit runs as six bf16 passes.  The same six passes run here: each float32
// value as three bf16 parts
//
//     x0 = bf16(x), x1 = bf16(x - x0), x2 = bf16(x - x0 - x1)
//
// (round to nearest even; 3 x 8 significand bits, so the parts sum to x bit
// for bit while x2 stays in the normal range) and the six products of
// order up to two, a0 g0 + (a0 g1 + a1 g0) + (a0 g2 + a1 g1 + a2 g0), with
// float32 accumulation.  The dropped terms are ~2^-24 relative: a float32
// grade product.  It was chosen over three TF32 passes on a two-part TF32
// split (the same tensor-core time): that split keeps 22 significand bits,
// this one all 24, it is what the reference computes, and it shares its
// mma, its G tiles and its ldmatrix reads with the 3-pass body of "high".
//
// A2 is staged as float32 (TI x KS floats a tile, 20 KB, less than the
// "high" body's bf16 hi/lo pair) and split into its parts in registers as
// each warp loads its A fragments, so a third bf16 copy of A2 never takes
// shared memory and the wrapper makes no split.  A2 holds DFT twiddles
// (finite), so its split has no guard for infinities.  A tile row is 32
// floats with its 32-byte chunks XOR-swizzled by (row & 3): the fragment
// loads (one float2 a thread, rows lane / 4 and columns 2 (lane % 4)) of a
// half warp then fall in 16 different bank pairs, without padding.  G's
// three parts are split once per block where G is built (part 1 and 2 are
// zero where part 0 is infinite, so no NaN is made) and read by
// ldmatrix.trans as in the 3-pass body.  Parts below the normal range are
// subnormal bf16 values; they lie under 2^-126, below anything compared.
//
// An mma truncates inside its sum.  So each 32-row step sums its five
// small passes (orders one and two) in one fresh fragment and its a0 g0
// passes in another, and the two are added to the running sum with rounded
// float32 adds: the truncation acts once on a 32-row partial, and the
// running sum over 1280 rows that cost the float32 FMA body its last
// digits (6.7e-6 of max|U| from float64) is a sum of 40 partials.

#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KS = 32;            // contraction rows per step
constexpr int TI = 160;           // output rows per block (2M at dimpsf = 40)
constexpr int A_F32 = TI * KS;    // floats per float32 A2 tile (swizzled)
constexpr int WM = 80;            // output rows per warp of the 6-pass body
constexpr int MT6 = WM / 16;      // its m16 fragments
constexpr int MAX_SMEM = 232448;  // a block's share of an SM on Hopper

__device__ __forceinline__ uint32_t smem_addr(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16-byte global -> shared copy of which the first `bytes` come from src
// and the rest are zeros
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           int bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0, %1, %2, %3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

__device__ __forceinline__ void ldsm_x4_trans(uint32_t (&r)[4],
                                              uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr)
      : "memory");
}

// d += a . b on one 16 x 8 x 16 bf16 fragment, float32 accumulators
__device__ __forceinline__ void mma_bf16(float (&d)[4], const uint32_t (&a)[4],
                                         uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

__device__ __forceinline__ void store_pair(float* ub, int row, int col,
                                           int m2, int ncols, float v0,
                                           float v1) {
  if (row >= m2 || col >= ncols) return;
  float* p = ub + (size_t)row * ncols + col;
  if (col + 1 < ncols && (ncols & 1) == 0) {
    *reinterpret_cast<float2*>(p) = make_float2(v0, v1);
  } else {
    p[0] = v0;
    if (col + 1 < ncols) p[1] = v1;
  }
}

// ---- the six-pass contraction of "highest" --------------------------------

// float offset of element (row, col) of a float32 A2 tile: rows of KS
// floats, the four 8-float chunks of a row XOR-swizzled by (row & 3)
__device__ __forceinline__ int a_f32_offset(int row, int col) {
  return row * KS + ((((col >> 3) ^ (row & 3)) << 3) | (col & 7));
}

// one step's float32 A2 tile, rows [i0, i0 + TI) x contraction rows
// [n0, n0 + KS) of a2 (m2 x n, n a multiple of 4), by cp.async in 16-byte
// chunks, zeros outside rows below m2 and columns below n_hi
__device__ __forceinline__ void stage_a_f32(float* tile, const float* a2,
                                            int m2, int n, int i0, int n0,
                                            int n_hi, int t, int nt) {
  constexpr int CH = KS / 4;
  for (int q = t; q < TI * CH; q += nt) {
    const int row = q / CH, c = q % CH;
    const int grow = i0 + row, gcol = n0 + c * 4;
    const bool ok = grow < m2 && gcol < n_hi;
    cp_async16(smem_addr(tile + a_f32_offset(row, c * 4)),
               ok ? a2 + (size_t)grow * n + gcol : a2, ok ? 16 : 0);
  }
}

// the three bf16 parts of two adjacent float32 values, each packed with
// the lower column in the lower half, as the mma's A fragment wants them
__device__ __forceinline__ void split3(float2 v, uint32_t& p0, uint32_t& p1,
                                       uint32_t& p2) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v.x, v.y);
  const float2 f0 = __bfloat1622float2(h0);
  const float rx = __fsub_rn(v.x, f0.x), ry = __fsub_rn(v.y, f0.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(rx, ry);
  const float2 f1 = __bfloat1622float2(h1);
  const __nv_bfloat162 h2 =
      __floats2bfloat162_rn(__fsub_rn(rx, f1.x), __fsub_rn(ry, f1.y));
  p0 = *reinterpret_cast<const uint32_t*>(&h0);
  p1 = *reinterpret_cast<const uint32_t*>(&h1);
  p2 = *reinterpret_cast<const uint32_t*>(&h2);
}

// the three bf16 parts of one element of G into the [k][n] tiles g0,
// g0 + tile, g0 + 2 tile at offset `at`
__device__ __forceinline__ void store_g3(__nv_bfloat16* g0, int tile, int at,
                                         float v) {
  const __nv_bfloat16 h0 = __float2bfloat16_rn(v);
  const float f0 = __bfloat162float(h0);
  const float r1 = isinf(f0) ? 0.f : __fsub_rn(v, f0);
  const __nv_bfloat16 h1 = __float2bfloat16_rn(r1);
  const __nv_bfloat16 h2 =
      __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(h1)));
  g0[at] = h0;
  g0[tile + at] = h1;
  g0[2 * tile + at] = h2;
}

// One 32-row step of the six-pass contraction for a warp's 80 x 16 output
// tile: acc += A . G with A the warp's rows [row0, row0 + 80) of the
// step's float32 A2 tile `af` and G the warp's 16 columns of the step's
// three bf16 G tiles ([k][n], pitch GP, KS * GP apart), `g_lane` this
// lane's ldmatrix.trans row address in part 0.  Only the first mt_live
// m16 fragments (rows below m2) are computed.
template <int GP>
__device__ __forceinline__ void contract6_step(const float* af, int row0,
                                               uint32_t g_lane, int mt_live,
                                               int lane,
                                               float (&acc)[MT6][2][4]) {
  constexpr int G_TILE = KS * GP;
  // (b0, b1) of n8 fragments 0 and 1, per k16 half and part
  uint32_t b[2][3][4];
#pragma unroll
  for (int k = 0; k < 2; ++k)
#pragma unroll
    for (int p = 0; p < 3; ++p)
      ldsm_x4_trans(b[k][p], g_lane + (p * G_TILE + k * 16 * GP) * 2);
  // A fragment: rows lane / 4 and + 8, columns 2 (lane % 4) and + 8 of the
  // k16 half; (row & 3) is the same for both rows
  const float* ar = af + (row0 + (lane >> 2)) * KS + 2 * (lane & 3);
  const int sx = ((lane >> 2) & 3) << 3;
#pragma unroll
  for (int mt = 0; mt < MT6; ++mt) {
    if (mt < mt_live) {
      float big[2][4] = {}, small[2][4] = {};
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        uint32_t a[3][4];
#pragma unroll
        for (int f = 0; f < 4; ++f) {
          const float* p = ar + (mt * 16 + (f & 1) * 8) * KS +
                           (((2 * k + (f >> 1)) << 3) ^ sx);
          split3(*reinterpret_cast<const float2*>(p), a[0][f], a[1][f],
                 a[2][f]);
        }
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          mma_bf16(small[nt], a[0], b[k][2][2 * nt], b[k][2][2 * nt + 1]);
          mma_bf16(small[nt], a[1], b[k][1][2 * nt], b[k][1][2 * nt + 1]);
          mma_bf16(small[nt], a[2], b[k][0][2 * nt], b[k][0][2 * nt + 1]);
          mma_bf16(small[nt], a[0], b[k][1][2 * nt], b[k][1][2 * nt + 1]);
          mma_bf16(small[nt], a[1], b[k][0][2 * nt], b[k][0][2 * nt + 1]);
          mma_bf16(big[nt], a[0], b[k][0][2 * nt], b[k][0][2 * nt + 1]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 2; ++nt)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[mt][nt][e] = __fadd_rn(
              acc[mt][nt][e], __fadd_rn(big[nt][e], small[nt][e]));
    }
  }
}

}  // namespace
