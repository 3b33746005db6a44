// K2 at conv_precision "high": the fused final-PSF convolution chain on
// Hopper's warpgroup tensor-core products (wgmma, sm_90a).
//
// Replaces muse_psfr_tpu/ops/conv_dft.py:fused_conv_chain with
// precision="high" (body _kernel / _conv_pack, whose every product is
// ops/zoom_dft.py:_mxu_contract at "high").  It computes what conv_dft.cu
// computes, the tip-tilt and then the intrinsic 'same' convolution of every
// (n x n) plane as trimmed circular DFTs at the alias-free size L, with
// W = C - iS and off = (n_ker - 1) / 2:
//
//   S1  A = C[:, :n] X,  B = S[:, :n] X                        (L x n)
//   S2  Fr = A C[:n] - B S[:n],  Fi = -(A S[:n] + B C[:n]),  H = F * G
//   S3  a = Cw Hr - Sw Hi,  b = Cw Hi + Sw Hr                   (n x L)
//   S4  Y = (a Cw^T - b Sw^T) / L^2                             (n x n)
//
// (Cw, Sw = C, S[off:off+n, :]), each of its twelve real products as the
// 3-pass bf16 split
//
//     P Q  ~  P_hi Q_hi + P_hi Q_lo + P_lo Q_hi
//
// with x_hi = bf16(x), x_lo = bf16(x - x_hi) (round to nearest even; lo = 0
// where hi is infinite) and float32 accumulation.  The products of bf16
// values are exact in float32, so this is the arithmetic of the plain
// version (ops/conv_dft.py:fused_conv_chain_reference at "high") up to the
// order of the float32 sums; the dropped lo*lo term is ~2^-16 relative per
// product.  Every operand is split inside the kernel from its float32
// value: C and S once per block, every intermediate from its float32
// accumulators, the second convolution's input from the first one's
// float32 result.  A product truncates inside its sum, so each step of 32
// contraction values runs its passes in a fresh accumulator and the steps
// (at most two: the contractions are n <= 64 or L <= 64 long) are added with
// rounded float32 adds, the order of ops/zoom_dft.py:contract.  The spectrum
// product, the sums of two products and the scale by 1/L^2 are float32
// operations with the plain version's roundings (no fused multiply-add).
//
// What bounds it: 12.0 GFLOP of contraction at 50 rows x 35 planes, three
// passes: 36 GFLOP of bf16 tensor-core work, 0.04 ms at the 989 TFLOP/s
// peak, against 25 MB of device-memory traffic.  The design:
//
// - Every stage is one 64-row warpgroup product per 32 output columns
//   (wgmma.mma_async m64n32k16, wgmma_common.cuh), the plane side padded
//   with zeros to the next multiple of 16 (a template parameter: one
//   instantiation per n / 16) and the contractions over the transform to
//   64.  The products of a batch are compile-time constants: a run-time
//   branch between two wgmma makes ptxas fence the warpgroup there.  Zero
//   rows and columns add exact zeros, so the padding leaves every float32
//   sum as it is.  S1 and S3 read both operands
//   from shared memory; S2 and S4 take their A operands (S1's A, B and S3's
//   a, b) from registers: the accumulator of a wgmma is laid out as the A
//   fragment of the next, so those four intermediates are split into bf16
//   (hi, lo) pairs in registers and never stored.  Only X (S1's B operand)
//   and H (S3's) go through shared memory, written straight from the
//   accumulators (or from the plane) into the K-major layout the
//   descriptors read.
// - C and S are staged once per block as four K-major tile pairs: C, S
//   (S1's A operand and, being symmetric, S2's B) and the window slices
//   Cw, Sw, zero past row n (S3's A operand and S4's B): off = 20 at
//   dimpsf 40 is no multiple of the 8-row core matrix, so the window is a
//   tile of its own.
// - Two warpgroups a block, each with its own plane, its own X and H tiles
//   and its own named barrier: no block-wide barrier in the plane loop.  A
//   warpgroup copies its next plane in by cp.async while it computes the
//   current one.
// - A persistent grid of `blocks` blocks (one per SM, from the wrapper's
//   launch plan, ops/conv_dft.py:tc_launch_plan) walks the flattened
//   (row, plane) list: warpgroup w of block b takes items
//   b + w * blocks + k * 2 * blocks.  No atomics and a fixed order of sums,
//   so a rerun is bit-identical.
//
// Shared memory: 8 constant and 2 x 6 own tiles of 64 x 64 bf16 (160 KB)
// and each warpgroup's float32 plane double buffer: 185.6 KB at n = 40, one
// block per SM.  The transform size and the plane side are at most 64.

#include "wgmma_common.cuh"

namespace {

constexpr int WGS = 2;              // warpgroups per block
constexpr int NT = WGS * 128;       // threads per block
constexpr int MAXL = 64;            // largest transform size (and plane side)
constexpr int TILE = MAXL * MAXL;   // bf16 per tile
constexpr int TILE_B = TILE * 2;    // bytes per tile
constexpr int NCONST = 8;           // C, S, Cw, Sw: (hi, lo) each
constexpr int NOWN = 6;             // a warpgroup's X, Hr, Hi: (hi, lo) each
constexpr int NK16 = MAXL / 16;     // steps of 16 contraction values
// the first tile of each pair: constants from the block's base, the
// warpgroup's own from its own base
constexpr int T_C = 0, T_S = 2, T_CW = 4, T_SW = 6;
constexpr int O_X = 0, O_HR = 2, O_HI = 4;

// shared addresses of a tile pair (hi, lo), for stores
struct Pair {
  uint32_t hi, lo;
};

// descriptors of a tile pair's first 16 contraction values, for products
struct DPair {
  uint64_t hi, lo;
};

__device__ __forceinline__ Pair pair(uint32_t base, int first) {
  return Pair{base + first * TILE_B, base + (first + 1) * TILE_B};
}

// from the descriptor of the tile at `base`: the descriptor's address
// field counts 16 bytes and stays below 2^14, so an offset adds to it
__device__ __forceinline__ DPair dpair(uint64_t base, int first) {
  return DPair{base + first * TILE_B / 16, base + (first + 1) * TILE_B / 16};
}

// descriptor of the 16 contraction values of step s from row r0 on
__device__ __forceinline__ uint64_t desc_at(uint64_t tile, int r0, int s) {
  return tile + (s * (2 * 8 * MAXL * 2) + r0 * 16) / 16;
}

// a value the compiler cannot see through: what is computed from it stays
// next to its use instead of being hoisted out of the plane loop, where
// every descriptor of the chain would hold registers at once
__device__ __forceinline__ uint32_t opaque(uint32_t v) {
  asm volatile("" : "+r"(v));
  return v;
}
__device__ __forceinline__ uint64_t opaque64(uint64_t v) {
  asm volatile("" : "+l"(v));
  return v;
}

// element offset of (r, k) in a tile
__device__ __forceinline__ int at(int r, int k) {
  return kmajor_offset(MAXL, r, k);
}

__device__ __forceinline__ void st_bf16(uint32_t addr, __nv_bfloat16 v) {
  asm volatile("st.shared.b16 [%0], %1;\n" ::"r"(addr),
               "h"(*reinterpret_cast<const unsigned short*>(&v))
               : "memory");
}

// the two parts of v into tile pair (hi, lo) at byte offset o
__device__ __forceinline__ void store_split(const Pair& t, int o, float v) {
  const __nv_bfloat16 hi = __float2bfloat16_rn(v);
  const float f = __bfloat162float(hi);
  st_bf16(t.hi + o, hi);
  st_bf16(t.lo + o, __float2bfloat16_rn(isinf(f) ? 0.f : __fsub_rn(v, f)));
}

// the two parts of two adjacent float32 values as bf16 pairs (the lower
// column in the lower half), as an A fragment holds them
__device__ __forceinline__ void split2(float v0, float v1, uint32_t& hi,
                                       uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(v0, v1);
  const float2 f = __bfloat1622float2(h);
  const __nv_bfloat162 l =
      __floats2bfloat162_rn(isinf(f.x) ? 0.f : __fsub_rn(v0, f.x),
                            isinf(f.y) ? 0.f : __fsub_rn(v1, f.y));
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}

// Steps s0 and s0 + 1 (those below nk) of acc = A B, three passes a step,
// for 32 output columns: A the 64 rows of tile pair `a`, B the rows n0..
// of tile pair `b`; the step's first pass overwrites acc.  The
// descriptors come from opaque copies of the bases, so they are computed
// here, next to their products, and hold no registers in between.
__device__ __forceinline__ void prod_ss(float (&acc)[16], const DPair& a,
                                        const DPair& b, int n0, int s0,
                                        int nk) {
  const uint64_t a_hi = opaque64(a.hi), a_lo = opaque64(a.lo);
  const uint64_t b_hi = opaque64(b.hi), b_lo = opaque64(b.lo);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = s0 + h;
    if (s < nk) {
      const uint64_t ah = desc_at(a_hi, 0, s), al = desc_at(a_lo, 0, s);
      const uint64_t bh = desc_at(b_hi, n0, s), bl = desc_at(b_lo, n0, s);
      wgmma_m64n32k16_ss(acc, ah, bh, h);
      wgmma_m64n32k16_ss(acc, ah, bl, 1);
      wgmma_m64n32k16_ss(acc, al, bh, 1);
    }
  }
}

// the same with A from registers: the fragments (hi, lo) of every step
template <int NK>
__device__ __forceinline__ void prod_rs(float (&acc)[16],
                                        const uint32_t (&ah)[NK][4],
                                        const uint32_t (&al)[NK][4],
                                        const DPair& b, int n0, int s0,
                                        int nk) {
  const uint64_t b_hi = opaque64(b.hi), b_lo = opaque64(b.lo);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int s = s0 + h;
    if (s < NK && s < nk) {
      const uint64_t bh = desc_at(b_hi, n0, s), bl = desc_at(b_lo, n0, s);
      wgmma_m64n32k16_rs(acc, ah[s], bh, h);
      wgmma_m64n32k16_rs(acc, ah[s], bl, 1);
      wgmma_m64n32k16_rs(acc, al[s], bh, 1);
    }
  }
}

__device__ __forceinline__ void fence_all(float (&a)[16], float (&b)[16],
                                          float (&c)[16]) {
  fence_regs(a);
  fence_regs(b);
  fence_regs(c);
}

// Two products p1 = A1 B1 and p2 = A2 B2 of nk steps of 16 contraction
// values, each 32-value step in a fresh accumulator and the steps added
// in float32: the first steps of both and the second of p1 (into t) run
// as one group, the second of p2 (into t again) after it.  SS: A and B
// from shared memory.
__device__ __forceinline__ void batch_ss(float (&p1)[16], const DPair& a1,
                                         const DPair& b1, float (&p2)[16],
                                         const DPair& a2, const DPair& b2,
                                         int n0, int nk) {
  float t[16] = {};
  fence_all(p1, p2, t);
  wgmma_fence();
  prod_ss(p1, a1, b1, n0, 0, nk);
  prod_ss(p2, a2, b2, n0, 0, nk);
  prod_ss(t, a1, b1, n0, 2, nk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(p1, p2, t);
  if (nk > 2) {
#pragma unroll
    for (int e = 0; e < 16; ++e) p1[e] = __fadd_rn(p1[e], t[e]);
    fence_regs(t);
    wgmma_fence();
    prod_ss(t, a2, b2, n0, 2, nk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(t);
#pragma unroll
    for (int e = 0; e < 16; ++e) p2[e] = __fadd_rn(p2[e], t[e]);
  }
}

// the same with A1, A2 from registers
template <int NK>
__device__ __forceinline__ void batch_rs(
    float (&p1)[16], const uint32_t (&a1h)[NK][4],
    const uint32_t (&a1l)[NK][4], const DPair& b1, float (&p2)[16],
    const uint32_t (&a2h)[NK][4], const uint32_t (&a2l)[NK][4],
    const DPair& b2, int n0, int nk) {
  float t[16] = {};
  fence_all(p1, p2, t);
  wgmma_fence();
  prod_rs<NK>(p1, a1h, a1l, b1, n0, 0, nk);
  prod_rs<NK>(p2, a2h, a2l, b2, n0, 0, nk);
  prod_rs<NK>(t, a1h, a1l, b1, n0, 2, nk);
  wgmma_commit();
  wgmma_wait<0>();
  fence_all(p1, p2, t);
  if (nk > 2) {
#pragma unroll
    for (int e = 0; e < 16; ++e) p1[e] = __fadd_rn(p1[e], t[e]);
    fence_regs(t);
    wgmma_fence();
    prod_rs<NK>(t, a2h, a2l, b2, n0, 2, nk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(t);
#pragma unroll
    for (int e = 0; e < 16; ++e) p2[e] = __fadd_rn(p2[e], t[e]);
  }
}

// 32 accumulator columns of chunk C split into the A fragments of their two
// steps of 16 (fragment register q = accumulators 8 h + 2 q, + 1)
template <int NK>
__device__ __forceinline__ void to_frags(int C, const float (&d)[16],
                                         uint32_t (&hi)[NK][4],
                                         uint32_t (&lo)[NK][4]) {
#pragma unroll
  for (int h = 0; h < 2; ++h)
    if (2 * C + h < NK) {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        split2(d[8 * h + 2 * q], d[8 * h + 2 * q + 1], hi[2 * C + h][q],
               lo[2 * C + h][q]);
    }
}

// accumulator e of this thread: row r0 + row_of(e), column
// 32 (chunk) + c0 + col_of(e)
__device__ __forceinline__ int row_of(int e) { return ((e >> 1) & 1) * 8; }
__device__ __forceinline__ int col_of(int e) {
  return (e >> 2) * 8 + (e & 1);
}

// what a warpgroup works with: the shared address of the constant tiles
// and of its own, for stores, and the descriptors of each first tile, for
// products; this thread's accumulator position (rows r0, r0 + 8; columns
// c0, c0 + 1 of each 8-column block) and the byte offset in a [N][K] tile
// of its element (row r0 of the product, column c0), where an
// accumulator's element (r, c) goes to tile row c, contraction value r
struct Ctx {
  uint32_t base, own;
  uint64_t dbase, down;
  int r0, c0, o0;
};

// the byte offset, from o0, of accumulator e of chunk c in a [N][K] tile:
// tile row 32 c + c0 + col_of(e), contraction value r0 + row_of(e)
__device__ __forceinline__ int nk_offset(int c, int e) {
  return 2 * (((e >> 1) & 1) * 8 * MAXL + (32 * c + col_of(e)) * 8);
}

// S1: A = C X, B = S X as S2's A fragments (NKN steps of 16 over n)
template <int NKN>
__device__ __forceinline__ void stage1(const Ctx& cx, uint32_t (&ah)[NKN][4],
                                       uint32_t (&al)[NKN][4],
                                       uint32_t (&bh)[NKN][4],
                                       uint32_t (&bl)[NKN][4]) {
#pragma unroll
  for (int j = 0; j < (NKN + 1) / 2; ++j) {
    float pa[16] = {}, pb[16] = {};
    batch_ss(pa, dpair(cx.dbase, T_C), dpair(cx.down, O_X), pb,
             dpair(cx.dbase, T_S), dpair(cx.down, O_X), 32 * j, NKN);
    to_frags<NKN>(j, pa, ah, al);
    to_frags<NKN>(j, pb, bh, bl);
  }
}

// S2: F = (A - iB)(C - iS)[:n, :], H = F * G into this warpgroup's H tiles
template <int NKN>
__device__ __forceinline__ void stage2(const Ctx& cx,
                                       const float* __restrict__ g_r,
                                       const float* __restrict__ g_i, int L,
                                       uint32_t (&ah)[NKN][4],
                                       uint32_t (&al)[NKN][4],
                                       uint32_t (&bh)[NKN][4],
                                       uint32_t (&bl)[NKN][4]) {
  const DPair c_t = dpair(cx.dbase, T_C), s_t = dpair(cx.dbase, T_S);
  const Pair hr_t = pair(cx.own, O_HR), hi_t = pair(cx.own, O_HI);
  // this thread's spectrum elements: rows r0 (+ 8), columns from c0 on
  const int g0 = cx.r0 * L + cx.c0;
#pragma unroll
  for (int c = 0; c < NK16 / 2; ++c) {
    if (c * 32 >= L) break;   // see stage3
    float fr[16];
    {
      float p1[16] = {}, p2[16] = {};
      // A C, B S
      batch_rs<NKN>(p1, ah, al, c_t, p2, bh, bl, s_t, 32 * c, NKN);
#pragma unroll
      for (int e = 0; e < 16; ++e) fr[e] = __fsub_rn(p1[e], p2[e]);
    }
    float p1[16] = {}, p2[16] = {};
    // A S, B C
    batch_rs<NKN>(p1, ah, al, s_t, p2, bh, bl, c_t, 32 * c, NKN);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const int r = cx.r0 + row_of(e), col = 32 * c + cx.c0 + col_of(e);
      const int g = g0 + row_of(e) * L + 32 * c + col_of(e);
      const bool ok = r < L && col < L;
      const float gr = ok ? __ldg(g_r + g) : 0.f;
      const float gi = ok ? __ldg(g_i + g) : 0.f;
      const float fi = -__fadd_rn(p1[e], p2[e]);
      const int o = cx.o0 + nk_offset(c, e);
      store_split(hr_t, o, __fsub_rn(__fmul_rn(fr[e], gr),
                                     __fmul_rn(fi, gi)));
      store_split(hi_t, o, __fadd_rn(__fmul_rn(fr[e], gi),
                                     __fmul_rn(fi, gr)));
    }
  }
}

// S3: a = Cw Hr - Sw Hi, b = Cw Hi + Sw Hr as S4's A fragments
__device__ __forceinline__ void stage3(const Ctx& cx, int L,
                                       uint32_t (&ah)[NK16][4],
                                       uint32_t (&al)[NK16][4],
                                       uint32_t (&bh)[NK16][4],
                                       uint32_t (&bl)[NK16][4]) {
  const DPair cw_t = dpair(cx.dbase, T_CW), sw_t = dpair(cx.dbase, T_SW);
  const DPair hr_t = dpair(cx.down, O_HR), hi_t = dpair(cx.down, O_HI);
#pragma unroll
  for (int c = 0; c < NK16 / 2; ++c) {
    // a chunk past L is zero; the branch also keeps the compiler from
    // hoisting the second chunk's work into the first, where it would hold
    // registers through the products
    if (c * 32 >= L) break;
    float p1[16] = {}, p2[16] = {};
    batch_ss(p1, cw_t, hr_t, p2, sw_t, hi_t, 32 * c, NK16);
#pragma unroll
    for (int e = 0; e < 16; ++e) p1[e] = __fsub_rn(p1[e], p2[e]);
    to_frags<NK16>(c, p1, ah, al);
    float p3[16] = {}, p4[16] = {};
    batch_ss(p3, cw_t, hi_t, p4, sw_t, hr_t, 32 * c, NK16);
#pragma unroll
    for (int e = 0; e < 16; ++e) p3[e] = __fadd_rn(p3[e], p4[e]);
    to_frags<NK16>(c, p3, bh, bl);
  }
}

// S4: Y = (a Cw^T - b Sw^T) / L^2: into this warpgroup's X tiles (zero
// outside the n x n plane) or, when dst is not null, to dst (n x n)
template <int NKN>
__device__ __forceinline__ void stage4(const Ctx& cx, float* __restrict__ dst,
                                       int n, float inv_l2,
                                       uint32_t (&ah)[NK16][4],
                                       uint32_t (&al)[NK16][4],
                                       uint32_t (&bh)[NK16][4],
                                       uint32_t (&bl)[NK16][4]) {
  const DPair cw_t = dpair(cx.dbase, T_CW), sw_t = dpair(cx.dbase, T_SW);
  const Pair x_t = pair(cx.own, O_X);
#pragma unroll
  for (int j = 0; j < (NKN + 1) / 2; ++j) {
    float p1[16] = {}, p2[16] = {};
    batch_rs<NK16>(p1, ah, al, cw_t, p2, bh, bl, sw_t, 32 * j, NK16);
#pragma unroll
    for (int e = 0; e < 16; ++e) {
      const float y = __fmul_rn(__fsub_rn(p1[e], p2[e]), inv_l2);
      const int r = cx.r0 + row_of(e), col = 32 * j + cx.c0 + col_of(e);
      const bool in = r < n && col < n;
      if (dst != nullptr) {
        if (in) dst[r * n + col] = y;
      } else {
        store_split(x_t, cx.o0 + nk_offset(j, e), in ? y : 0.f);
      }
    }
  }
}

// One 'same' convolution of the plane in this warpgroup's X tiles with the
// spectrum (g_r, g_i) ([L][L] in device memory): the result back into the
// X tiles, or, when dst is not null, into dst.
template <int NKN>
__device__ __forceinline__ void conv_same(const Ctx& cx0,
                                          const float* __restrict__ g_r,
                                          const float* __restrict__ g_i,
                                          float* __restrict__ dst, int n,
                                          int L, int bar) {
  Ctx cx = cx0;
  cx.own = opaque(cx0.own);
  cx.dbase = kmajor_desc(opaque(cx0.base), MAXL);
  cx.down = kmajor_desc(cx.own, MAXL);
  {
    uint32_t ah[NKN][4] = {}, al[NKN][4] = {}, bh[NKN][4] = {},
             bl[NKN][4] = {};
    stage1<NKN>(cx, ah, al, bh, bl);
    fence_regs(ah);
    fence_regs(al);
    fence_regs(bh);
    fence_regs(bl);
    stage2<NKN>(cx, g_r, g_i, L, ah, al, bh, bl);
    // the fragments live until S2's last product has completed
    fence_regs(ah);
    fence_regs(al);
    fence_regs(bh);
    fence_regs(bl);
  }
  fence_async_shared();
  warpgroup_bar(bar);   // H complete for S3
  uint32_t ah[NK16][4] = {}, al[NK16][4] = {}, bh[NK16][4] = {},
           bl[NK16][4] = {};
  stage3(cx, L, ah, al, bh, bl);
  fence_regs(ah);
  fence_regs(al);
  fence_regs(bh);
  fence_regs(bl);
  stage4<NKN>(cx, dst, n, 1.0f / (float)(L * L), ah, al, bh, bl);
  fence_regs(ah);
  fence_regs(al);
  fence_regs(bh);
  fence_regs(bl);
  if (dst == nullptr) {
    fence_async_shared();
    warpgroup_bar(bar);   // X complete for the next S1
  }
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// NKN = ceil(n / 16): the steps of 16 over the plane side
template <int NKN>
__global__ void __launch_bounds__(NT, 1)
fused_conv_chain_tc_kernel(const float* __restrict__ planes,  // (B, nl, n, n)
                           const float* __restrict__ gtt_r,   // (B, L, L)
                           const float* __restrict__ gtt_i,
                           const float* __restrict__ gi_r,    // (nl, L, L)
                           const float* __restrict__ gi_i,
                           const float* __restrict__ cmat,    // (L, L) C
                           const float* __restrict__ smat,    // (L, L) S
                           float* __restrict__ out,           // (B, nl, n, n)
                           int B, int nl, int n, int L, int off) {
  extern __shared__ __align__(1024) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  constexpr int N_TILES = NCONST + WGS * NOWN;
  const int t = threadIdx.x, wg = t >> 7, wt = t & 127;
  const uint32_t base = smem_addr(tiles);
  const int r0 = 16 * (wt >> 5) + ((wt & 31) >> 2), c0 = 2 * (wt & 3);
  const Ctx cx{base, base + (NCONST + wg * NOWN) * TILE_B, 0, 0, r0, c0,
               2 * at(c0, r0)};
  const int bar = 1 + wg;
  const int nn = n * n;
  // this warpgroup's float32 plane double buffer
  float* xs = reinterpret_cast<float*>(tiles + N_TILES * TILE) + wg * 2 * nn;
  const int items = B * nl, stride = WGS * gridDim.x;

  auto stage = [&](int buf, int item) {
    const float* src = planes + (size_t)item * nn;
    float* dst = xs + buf * nn;
    for (int q = wt; q < nn; q += 128) cp_async4(dst + q, src + q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  int item = blockIdx.x + wg * gridDim.x;
  if (item < items) stage(0, item);

  // every tile zeroed (the padding of every operand), then C, S and the
  // window slices Cw, Sw split into their parts
  for (int q = t; q < N_TILES * TILE / 8; q += NT)
    reinterpret_cast<uint4*>(tiles)[q] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int q = t; q < L * L; q += NT) {
    const int r = q / L, k = q % L;
    const bool win = r >= off && r < off + n;
    store_split(pair(base, T_C), 2 * at(r, k), cmat[q]);
    store_split(pair(base, T_S), 2 * at(r, k), smat[q]);
    if (win) {
      store_split(pair(base, T_CW), 2 * at(r - off, k), cmat[q]);
      store_split(pair(base, T_SW), 2 * at(r - off, k), smat[q]);
    }
  }
  fence_async_shared();
  __syncthreads();

  const Pair x_t = pair(cx.own, O_X);
  for (int buf = 0; item < items; item += stride, buf ^= 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    warpgroup_bar(bar);   // the plane landed; the other buffer is free
    if (item + stride < items) stage(buf ^ 1, item + stride);
    // the plane into the X tiles ([N][K]: row = column of X, k = its row)
    const float* x = xs + buf * nn;
    for (int q = wt; q < nn; q += 128) {
      const int r = q / n, c = q % n;
      store_split(x_t, 2 * at(c, r), x[q]);
    }
    fence_async_shared();
    warpgroup_bar(bar);
    const int b = item / nl, p = item % nl;
    const size_t gt = (size_t)b * L * L, gp = (size_t)p * L * L;
    conv_same<NKN>(cx, gtt_r + gt, gtt_i + gt, nullptr, n, L, bar);
    conv_same<NKN>(cx, gi_r + gp, gi_i + gp, out + (size_t)item * nn, n, L,
                   bar);
  }
}

template <int NKN>
cudaError_t launch(const float* planes, const float* gtt_r,
                   const float* gtt_i, const float* gi_r, const float* gi_i,
                   const float* cmat, const float* smat, float* out, int B,
                   int nl, int n, int L, int off, int blocks, int smem,
                   cudaStream_t stream) {
  const cudaError_t err = cudaFuncSetAttribute(
      fused_conv_chain_tc_kernel<NKN>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return err;
  fused_conv_chain_tc_kernel<NKN><<<blocks, NT, smem, stream>>>(
      planes, gtt_r, gtt_i, gi_r, gi_i, cmat, smat, out, B, nl, n, L, off);
  return cudaGetLastError();
}

}  // namespace

// Launches K2 at "high" on `stream`: out (B, nl, n, n) from the planes, the
// rows' tip-tilt spectra, the planes' intrinsic spectra and the (L, L) DFT
// matrices C, S in float32, for n, L <= 64 and off + n <= L, on a persistent
// grid of `blocks` blocks (ops/conv_dft.py:tc_launch_plan); returns the
// first CUDA error (0 = launched).
extern "C" int muse_fused_conv_chain_tc(const float* planes,
                                        const float* gtt_r,
                                        const float* gtt_i, const float* gi_r,
                                        const float* gi_i, const float* cmat,
                                        const float* smat, float* out, int B,
                                        int nl, int n, int L, int off,
                                        int blocks, void* stream) {
  if (n < 1 || L > MAXL || n > L || off < 0 || off + n > L || B < 1 ||
      nl < 1 || blocks < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (NCONST + WGS * NOWN) * TILE_B + WGS * 2 * n * n * 4;
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t (*go)(const float*, const float*, const float*, const float*,
                    const float*, const float*, const float*, float*, int,
                    int, int, int, int, int, int, cudaStream_t) =
      n <= 16 ? launch<1> : n <= 32 ? launch<2> : n <= 48 ? launch<3>
                                                          : launch<4>;
  return static_cast<int>(go(planes, gtt_r, gtt_i, gi_r, gi_i, cmat, smat,
                             out, B, nl, n, L, off, blocks, smem, s));
}
