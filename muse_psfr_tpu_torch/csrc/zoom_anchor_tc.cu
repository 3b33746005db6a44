// K6: the anchored-Taylor damping x zoom-DFT stage 1 on Hopper's warpgroup
// tensor-core products (wgmma, sm_90a) fed by TMA, one body for both
// settings of zoom_precision.
//
// Replaces muse_psfr_tpu/ops/zoom_dft.py:fused_exp_zoom_anchor (body
// _kernel_anchor, whose contraction is _mxu_contract: the 3-pass bf16
// split at "high", Precision.HIGHEST at "highest").  Per telemetry row b
// and wavelength group g (group consecutive wavelengths, anchor astar[g],
// the midpoint of their alphas) it computes
//
//     x      = astar[g] * (D[b, d, n, j] - centre[b, d])
//     H_i    = sum_d e^x x^i                    i = 0..degree
//     G_l    = (sum_i coef[l, i] H_i) * dl      l in group g
//     U[b,l] = A2_l @ G_l                       (2M x N) @ (N x ncols)
//
// with ONE exponential per (direction, element, group) instead of one per
// (direction, element, wavelength) as in K1; coef carries the Taylor
// weights (alpha_l/astar - 1)^i / i! and the DC normaliser 1/(ndir dl_c).
// The centre values are subtracted here: the JAX package's shifted copy of
// D (a second 1.56 GB at 44 rows of the full window) is never made.  The
// product, the kernel's PASSES template parameter, is
//
//     3 ("high"):    A2_hi @ G_hi + A2_hi @ G_lo + A2_lo @ G_hi
//     6 ("highest"): the six products of order up to two of the three-part
//                    split, a float32-grade product (mma_common.cuh)
//
// with x_hi = bf16(x), x_lo = bf16(x - x_hi) (round to nearest even; lo = 0
// where hi is infinite) and float32 accumulation: at "high" the arithmetic
// of the plain version (ops/zoom_dft.py:fused_exp_zoom_anchor_reference)
// up to the order of the float32 sums.  G never reaches device memory.
//
// What bounds it: at the 9-direction shape (4 rows x 35 wavelengths in 5
// groups of 7, degree 8, N = 1280, ncols = 768, 2M = 160) the three or six
// passes are 132 or 264 GFLOP of bf16 tensor-core work (0.13 or 0.27 ms at
// the 989 TFLOP/s peak); the 177 M exponentials take 0.04 ms on the SFU
// and the power sums and combinations ~6 GFLOP of float32 (0.09 ms).  In
// practice (PERF.md) the G build, the products and the staging of A2 (3.6
// GB from L2 at "high", 5.4 GB at "highest") each take a share of the time
// and overlap little.
//
// The design.  The exponential and its power chain pay only if one block
// serves every wavelength of the group: split the group over blocks and
// each block repeats the power sums, which cost more than K1's
// exponentials.  A warpgroup product has 64 rows, and a group's outputs in
// K1's transposed layout (64 columns x 160 rows x 7 wavelengths) would not
// fit the register file; so the product is not transposed here:
//
// - U = A2 . G as wgmma.mma_async m64n24k16 with both operands in shared
//   memory (wgmma_common.cuh): M = 64 rows of A2 (A, K-major as A2 is
//   stored), N = the block's 24 output columns (TJ), K = the contraction.
//   A block owns one (row b, group g, 24-column tile, 192 rows of A2) and
//   every wavelength of the group: 8 x 192 x 24 outputs at the cap, in the
//   registers of its two warpgroups (255 registers a thread, which is why
//   no third, producer warpgroup: 384 threads would cap them at 168),
//   wavelengths l = w, w + 2, ... to warpgroup w, three 64-row tiles each
//   (rows past 2M are read but never stored).  Its G tiles are built once
//   per step for the whole group, one exponential and power chain per
//   element.
// - A2 is split into its bf16 parts once by the wrapper and kept beside A2
//   (ops/zoom_dft.py:_a2_parts, zoom_dft.cu:split_bf16), the parts one
//   after the other, padded to a multiple of 8 contraction rows.  TMA
//   stages, with a full and an empty mbarrier a stage, every part of one
//   (step, wavelength) in one box (32 x 192 bf16 a part at most, 64-byte
//   swizzle, the layout the A descriptor reads): each warpgroup owns half
//   the ring, and its thread 0 refills a stage as soon as the warpgroup is
//   done with it.  Thread 0 of the block stages the step's D tile of every
//   direction and its dl tile (24 x 32 floats each, one stage, refilled as
//   soon as the power sums have read it).  Where D's base or strides (or
//   dl's) are not 16-byte aligned, or its directions do not fit, the
//   threads read D and dl from device memory instead (the direct path,
//   far slower).  The plan (stages, staged) comes from ops/zoom_dft.py:
//   anchor_launch_plan, and this file checks it.
// - Every thread builds 3 elements of the next step's G tiles (a warp
//   covers 8 columns x 4 rows, so its D reads and its bf16 stores into the
//   64-byte-swizzle B layout are free of bank conflicts), in eleven
//   pieces: three thirds of the directions of the power sums, the three
//   elements side by side, then one wavelength's combination each, all
//   with the plain version's roundings and order of sums, no fused
//   multiply-add, so G and its parts are bit-identical to it.  The pieces
//   run between the issue and the wait of the current step's twelve
//   batches of products (wavelength slot x 64-row tile).  G is
//   double-buffered; one barrier of the block a step.
// - Tensor-core accumulation rounds toward zero inside each product.  So
//   every batch (one wavelength, one 64-row tile, the step's 32 rows of
//   the contraction) sums its passes in fresh accumulators in the
//   mma.sync body's order, which are then added to the running sum with a
//   rounded float32 add; at "highest" the five small passes and the a0 g0
//   pass keep separate accumulators, added to each other and then to the
//   sum.  No branch lies inside a batch.  The two bodies agree bit for bit.
//
// Shared memory a block: stages x parts x 2M (at most 192) x 64 bytes of
// A2, 2 x group x parts x 1.5 KB of G, staged (ndir + 1) x 3 KB of D and
// dl, and the row's centre values; at the 9-direction shape with groups
// of 7, "high" 6 A2 stages (120 + 42 + 30 KB), "highest" 4 (120 + 63 + 30
// KB).
//
// The mma.sync body this one replaced lives in
// tools/mma_sync_bodies/zoom_anchor_tc_mma.cu and the float32 FMA body
// before it in tools/fma_bodies/zoom_anchor_fma.cu, the yardsticks of
// tools/ab_zoom_tc.py and tools/ab_zoom_highest.py; nothing in the
// package builds or launches them.

#include "wgmma_common.cuh"

namespace {

constexpr int KB = 8;             // most wavelengths per group
constexpr int DMAX = 12;          // most Taylor terms (degree + 1)
constexpr int TJ = 24;            // output columns per block (N)
constexpr int TM = 64;            // A2 rows per product (M)
constexpr int MT = 3;             // 64-row tiles per block
constexpr int TIB = TM * MT;      // A2 rows per block
constexpr int SLOTS = KB / 2;     // wavelengths per warpgroup
constexpr int NT = 256;           // threads: two warpgroups
constexpr int EPT = KS * TJ / NT; // G elements a thread and step
constexpr int BOX_ROWS = 32;              // A2 rows a stage holds: a multiple
constexpr int A_BOX = BOX_ROWS * KS * 2;  // of 32 (bytes of 32 rows, bf16)
constexpr int G_TILE = TJ * KS * 2;       // bytes of one G tile (bf16)
constexpr int D_BOX = KS * TJ * 4;        // bytes of one D or dl tile
constexpr int MAX_STAGES = 8;             // A2 stages, half to a warpgroup
constexpr int SLACK = 1024;               // for the stages' alignment

// bytes of the three regions: one A2 stage (every part of one wavelength's
// step), the double-buffered G tiles, one D stage (every direction and dl)
__host__ __device__ constexpr int a_stage_bytes(int passes, int nbox) {
  return (passes / 3 + 1) * nbox * A_BOX;
}
__host__ __device__ constexpr int g_bytes(int passes, int group) {
  return 2 * group * (passes / 3 + 1) * G_TILE;
}
__host__ __device__ constexpr int d_stage_bytes(int ndir) {
  return (ndir + 1) * D_BOX;
}
// and the row's centre values, one float a direction, to 16 bytes
__host__ __device__ constexpr int centre_bytes(int ndir) {
  return (ndir + 3) / 4 * 16;
}

// One batch: the step's products of one wavelength on one 64-row tile,
// both 16-row k-steps; "high" the three passes into p0; "highest" the five
// small passes into p1 and a0 g0 into p0, in the mma.sync body's order.
// a_base is the tile's rows in the stage's first A2 part (parts `a_part`
// bytes apart), g_base the wavelength's first G tile (parts G_TILE apart).
// The first product of each accumulator overwrites it.
template <int PASSES>
__device__ __forceinline__ void issue_batch(float (&p0)[12], float (&p1)[12],
                                            uint32_t a_base, int a_part,
                                            uint32_t g_base) {
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint32_t a = a_base + k * 32, g = g_base + k * 32;
    const uint64_t a0 = sw64_desc(a), a1 = sw64_desc(a + a_part);
    const uint64_t g0 = sw64_desc(g), g1 = sw64_desc(g + G_TILE);
    if constexpr (PASSES == 3) {
      wgmma_m64n24k16_ss(p0, a0, g0, k);   // A2_hi G_hi
      wgmma_m64n24k16_ss(p0, a0, g1, 1);   // A2_hi G_lo
      wgmma_m64n24k16_ss(p0, a1, g0, 1);   // A2_lo G_hi
    } else {
      const uint64_t a2 = sw64_desc(a + 2 * a_part);
      const uint64_t g2 = sw64_desc(g + 2 * G_TILE);
      wgmma_m64n24k16_ss(p1, a0, g2, k);   // a0 g2
      wgmma_m64n24k16_ss(p1, a1, g1, 1);   // a1 g1
      wgmma_m64n24k16_ss(p1, a2, g0, 1);   // a2 g0
      wgmma_m64n24k16_ss(p1, a0, g1, 1);   // a0 g1
      wgmma_m64n24k16_ss(p1, a1, g0, 1);   // a1 g0
      wgmma_m64n24k16_ss(p0, a0, g0, k);   // a0 g0
    }
  }
}

template <int PASSES>
__global__ void __launch_bounds__(NT, 1)
fused_exp_zoom_anchor_wg_kernel(
    const __grid_constant__ CUtensorMap map_a,
    const __grid_constant__ CUtensorMap map_d,
    const __grid_constant__ CUtensorMap map_dl,
    const float* __restrict__ dphi,            // (B, ndir, n, ncols)
    long long sb, long long sd, long long sr,  // its strides
    const float* __restrict__ dl,              // (n, ncols)
    const float* __restrict__ centre,          // (B, ndir)
    const float* __restrict__ astar,           // (groups,)
    const float* __restrict__ coef,            // (nl, deg1)
    float* __restrict__ out,                   // (B, nl, m2, ncols)
    int ndir, int n, int ncols, int nl, int m2, int group, int deg1,
    int nib, int ng, int nbox, int stages, int staged) {
  constexpr int PARTS = PASSES / 3 + 1;
  // A2 full and empty, then D full and empty
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES + 2];
  __shared__ __align__(16) float cs[KB][DMAX];   // the group's coefficients
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + SLACK - 1) & ~(SLACK - 1);
  unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
  const int a_stage = a_stage_bytes(PASSES, nbox);
  const int a_part = nbox * A_BOX;
  const uint32_t g_base = base + stages * a_stage;
  const int g_half = g_bytes(PASSES, group) / 2;
  const int d_stage = d_stage_bytes(ndir);
  const uint32_t d_base = g_base + 2 * g_half;
  const uint32_t a_full = smem_addr(bars), a_empty = a_full + 8 * MAX_STAGES;
  const uint32_t d_full = a_empty + 8 * MAX_STAGES, d_empty = d_full + 8;

  const int t = threadIdx.x;
  const int g = blockIdx.x % ng;
  const int ib = blockIdx.x / ng % nib;
  const int jt = blockIdx.x / ng / nib;
  const int b = blockIdx.y;
  const int l0 = g * group;
  const int kg = min(group, nl - l0);
  const int j0 = jt * TJ;
  const int i0 = ib * TIB;
  const int rows = min(TIB, m2 - i0);
  const int mts = (rows + TM - 1) / TM;          // live 64-row tiles
  const int ns = (n + KS - 1) / KS;

  // warpgroup w serves wavelengths w, w + 2, ... of the group: kw of them,
  // and owns the A2 stages [w sw, (w + 1) sw), its steps' wavelengths in
  // turn; its thread 0 stages them, thread 0 of the block D and dl
  const int w = t >> 7;
  const int kw = (kg - w + 1) / 2;
  const int sw = stages / 2;
  const int uses = ns * kw;            // A2 stages this warpgroup consumes
  auto load_a2 = [&](int u) {          // u-th of this warpgroup's stages
    const int st = w * sw + u % sw;
    const int l = l0 + w + 2 * (u % kw), n0 = u / kw * KS;
    const uint32_t bar = a_full + 8 * st;
    mbar_expect_tx(bar, PARTS * a_part);
    tma_load_4d(base + st * a_stage, &map_a, bar, n0, i0, l, 0);
  };
  auto load_d = [&](int s) {           // step s's D and dl tiles
    mbar_expect_tx(d_full, d_stage);
    tma_load_4d(d_base, &map_d, d_full, j0, s * KS, 0, b);
    tma_load_2d(d_base + ndir * D_BOX, &map_dl, d_full, j0, s * KS);
  };

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(a_full + 8 * s, 1);
      mbar_init(a_empty + 8 * s, 128);
    }
    mbar_init(d_full, 1);
    mbar_init(d_empty, NT);
    fence_mbar_init();
  }
  __syncthreads();
  if ((t & 127) == 0)
    for (int u = 0; u < min(sw, uses); ++u) load_a2(u);
  if (t == 0 && staged) load_d(0);

  const int wq = (t >> 5) & 3;
  const int lane = t & 31;
  for (int q = t; q < KB * DMAX; q += NT) {
    const int l = q / DMAX, i = q % DMAX;
    cs[l][i] = (l < kg && i < deg1) ? coef[(size_t)(l0 + l) * deg1 + i] : 0.f;
  }
  {   // the row's centre values, after the D stages
    float* c = reinterpret_cast<float*>(smem + (d_base - base) +
                                        (staged ? d_stage : 0));
    for (int d = t; d < ndir; d += NT)
      c[d] = centre[(size_t)b * ndir + d];
  }
  named_bar(1, NT);   // the coefficients and centre values

  const float ast = astar[g];
  const float* db = dphi + (size_t)b * sb;
  const float* cen = reinterpret_cast<const float*>(
      smem + (d_base - base) + (staged ? d_stage : 0));

  // This thread's G elements: element e is column jj[e], contraction row
  // kk[e] of the step's tile; warp t / 32 covers 8 columns x 4 rows of it
  // at tile t / 32 + 8 e of 24 (3 column groups x 8 row groups).
  int jj[EPT], kk[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e) {
    const int tile = (t >> 5) + 8 * e;
    jj[e] = 8 * (tile % 3) + (lane & 7);
    kk[e] = 4 * (tile / 3) + (lane >> 3);
  }

  // the element's byte offset in a G tile (64-byte-swizzle B layout)
  int goff[EPT];
#pragma unroll
  for (int e = 0; e < EPT; ++e)
    goff[e] = jj[e] * 64 + ((((kk[e] >> 3) ^ ((jj[e] >> 1) & 3)) << 4) |
                            ((kk[e] & 7) << 1));
  const int dq = (ndir + 2) / 3;   // directions a piece of the power sums
  float hv[EPT][DMAX], dlv[EPT];   // the elements' power sums, dl values

  // running sums: [wavelength slot][64-row tile][accumulator]
  float acc[SLOTS][MT][12];
#pragma unroll
  for (int li = 0; li < SLOTS; ++li)
#pragma unroll
    for (int mt = 0; mt < MT; ++mt)
#pragma unroll
      for (int i = 0; i < 12; ++i) acc[li][mt][i] = 0.f;
  float p0[12], p1[12];
#pragma unroll
  for (int i = 0; i < 12; ++i) p0[i] = p1[i] = 0.f;

  // s = -1 builds step 0 alone; step s issues its twelve batches with the
  // pieces of step s + 1's build between the issue and the wait of each
  for (int s = -1; s < ns; ++s) {
    const bool more = s + 1 < ns;
    const uint32_t g_cur = g_base + (s & 1) * g_half;
    const uint32_t g_nxt = g_base + ((s + 1) & 1) * g_half;
#pragma unroll
    for (int q = 0; q < SLOTS * MT; ++q) {
      const int li = q / MT, mt = q % MT;
      const int l = w + 2 * li;
      const bool run = s >= 0 && li < kw && mt < mts;
      const int u = s * kw + li, st = w * sw + u % sw;
      if (run) {
        if (mt == 0) mbar_wait(a_full + 8 * st, (u / sw) & 1);
        fence_regs(p0);
        if constexpr (PASSES == 6) fence_regs(p1);
        wgmma_fence();
        issue_batch<PASSES>(p0, p1, base + st * a_stage + mt * TM * 64,
                            a_part, g_cur + l * PARTS * G_TILE);
        wgmma_commit();
      }
      // piece q of step s + 1's build: q < 3 adds directions [q dq,
      // (q + 1) dq) to the power sums of the thread's elements (all three
      // side by side: their exponentials and power chains are independent,
      // and each sum over the directions runs in order, as in the plain
      // version); q >= 3 combines them for wavelength q - 3 of the group,
      // splits the three values of G into bf16 parts and stores them
      if (more && q < 3 + KB) {
        const int n1 = (s + 1) * KS;
        if (q < 3) {
          const float* dsm =
              reinterpret_cast<const float*>(smem + (d_base - base));
          if (q == 0) {
            if (staged) mbar_wait(d_full, (s + 1) & 1);
#pragma unroll
            for (int e = 0; e < EPT; ++e)
#pragma unroll
              for (int i = 0; i < DMAX; ++i) hv[e][i] = 0.f;
          }
          for (int d = q * dq; d < min(ndir, (q + 1) * dq); ++d) {
            const float c = cen[d];
            float x[EPT], f[EPT];
#pragma unroll
            for (int e = 0; e < EPT; ++e) {
              const int row = n1 + kk[e], col = j0 + jj[e];
              x[e] = f[e] = 0.f;
              if (row < n && col < ncols) {
                const float v =
                    staged ? dsm[d * (KS * TJ) + kk[e] * TJ + jj[e]]
                           : db[(size_t)d * sd + (size_t)row * sr + col];
                x[e] = __fmul_rn(ast, __fsub_rn(v, c));
                f[e] = expf(x[e]);
              }
            }
#pragma unroll
            for (int i = 0; i < DMAX; ++i) {
              if (i < deg1) {
#pragma unroll
                for (int e = 0; e < EPT; ++e) {
                  hv[e][i] = __fadd_rn(hv[e][i], f[e]);
                  f[e] = __fmul_rn(f[e], x[e]);
                }
              }
            }
          }
          if (q == 2) {
#pragma unroll
            for (int e = 0; e < EPT; ++e) {
              const int row = n1 + kk[e], col = j0 + jj[e];
              dlv[e] = 0.f;
              if (row < n && col < ncols)
                dlv[e] = staged ? dsm[ndir * (KS * TJ) + kk[e] * TJ + jj[e]]
                                : dl[(size_t)row * ncols + col];
            }
            // the D stage is read: thread 0 refills it with step s + 2's
            if (staged) {
              mbar_arrive(d_empty);
              if (t == 0 && s + 2 < ns) {
                mbar_wait(d_empty, (s + 1) & 1);
                load_d(s + 2);
              }
            }
          }
        } else if (q - 3 < kg) {
          const int l = q - 3;
          float c[DMAX];
#pragma unroll
          for (int i = 0; i < DMAX; i += 4) {
            const float4 c4 = *reinterpret_cast<const float4*>(&cs[l][i]);
            c[i] = c4.x, c[i + 1] = c4.y, c[i + 2] = c4.z, c[i + 3] = c4.w;
          }
#pragma unroll
          for (int e = 0; e < EPT; ++e) {
            float gv = __fmul_rn(c[0], hv[e][0]);
#pragma unroll
            for (int i = 1; i < DMAX; ++i)
              if (i < deg1) gv = __fadd_rn(gv, __fmul_rn(c[i], hv[e][i]));
            const float v = __fmul_rn(gv, dlv[e]);
            // the parts: later ones 0 where part 0 is infinite
            unsigned char* gl = smem + (g_nxt - base) + l * PARTS * G_TILE +
                                goff[e];
            const __nv_bfloat16 h0 = __float2bfloat16_rn(v);
            const float f0 = __bfloat162float(h0);
            const float r1 = isinf(f0) ? 0.f : __fsub_rn(v, f0);
            const __nv_bfloat16 h1 = __float2bfloat16_rn(r1);
            *reinterpret_cast<__nv_bfloat16*>(gl) = h0;
            *reinterpret_cast<__nv_bfloat16*>(gl + G_TILE) = h1;
            if constexpr (PARTS == 3)
              *reinterpret_cast<__nv_bfloat16*>(gl + 2 * G_TILE) =
                  __float2bfloat16_rn(__fsub_rn(r1, __bfloat162float(h1)));
          }
        }
      }
      wgmma_wait<0>();   // no-op where no batch was issued
      if (run) {
        fence_regs(p0);
        if constexpr (PASSES == 6) fence_regs(p1);
#pragma unroll
        for (int i = 0; i < 12; ++i) {
          if constexpr (PASSES == 3)
            acc[li][mt][i] = __fadd_rn(acc[li][mt][i], p0[i]);
          else
            acc[li][mt][i] =
                __fadd_rn(acc[li][mt][i], __fadd_rn(p0[i], p1[i]));
        }
        if (mt == mts - 1) {
          // the stage is free once every thread of the warpgroup is done
          // with it: its thread 0 refills it with the stage sw on
          mbar_arrive(a_empty + 8 * st);
          if ((t & 127) == 0 && u + sw < uses) {
            mbar_wait(a_empty + 8 * st, (u / sw) & 1);
            load_a2(u + sw);
          }
        }
      }
    }
    if (more) fence_async_shared();   // G's stores visible to the products
    named_bar(1, NT);
  }

  // accumulator (8-column block jb, element e) of a 64-row tile: A2 row
  // 16 wq + lane / 4 + 8 (e / 2), output column 8 jb + 2 (lane % 4) + e % 2
#pragma unroll
  for (int li = 0; li < SLOTS; ++li) {
    const int l = w + 2 * li;
    if (l >= kg) continue;
    float* ub = out + ((size_t)b * nl + l0 + l) * m2 * ncols;
#pragma unroll
    for (int mt = 0; mt < MT; ++mt) {
      const int row = i0 + mt * TM + 16 * wq + (lane >> 2);
#pragma unroll
      for (int jb = 0; jb < TJ / 8; ++jb) {
        const int col = j0 + 8 * jb + 2 * (lane & 3);
        const float* a = acc[li][mt] + 4 * jb;
        store_pair(ub, row, col, m2, ncols, a[0], a[1]);
        store_pair(ub, row + 8, col, m2, ncols, a[2], a[3]);
      }
    }
  }
}

struct AnchorArgs {
  const float *dphi, *dl;
  const void* a2[3];
  const float *centre, *astar, *coef;
  float* u;
  long long sb, sd, sr;
  int B, ndir, n, ncols, nl, m2, n_pad, group, deg1, stages, staged;
};

template <int PASSES>
int launch(const AnchorArgs& a, void* stream) {
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  // the launch plan: checked here, chosen by
  // ops/zoom_dft.py:anchor_launch_plan
  const int nbox = (min(TIB, a.m2) + BOX_ROWS - 1) / BOX_ROWS;
  const int smem = a.stages * a_stage_bytes(PASSES, nbox) +
                   g_bytes(PASSES, a.group) +
                   (a.staged ? d_stage_bytes(a.ndir) : 0) +
                   centre_bytes(a.ndir) + SLACK;
  const int static_smem = sizeof(uint64_t) * (2 * MAX_STAGES + 2) +
                          sizeof(float) * KB * DMAX;
  if (a.group < 1 || a.group > KB || a.deg1 < 1 || a.deg1 > DMAX ||
      a.stages < 2 || a.stages > MAX_STAGES || a.stages % 2 ||
      smem + static_smem > MAX_SMEM || a.n_pad % 8 || a.n_pad < a.n)
    return bad;
  // size-1 dimensions may carry any stride; give them an aligned one
  const long long sd = a.ndir > 1 ? a.sd : a.n * a.sr;
  const long long sb = a.B > 1 ? a.sb : a.ndir * sd;
  if (a.staged &&
      ((reinterpret_cast<uintptr_t>(a.dphi) |
        reinterpret_cast<uintptr_t>(a.dl)) % 16 ||
       a.sr % 4 || sd % 4 || sb % 4 || a.ncols % 4 || a.ndir > 256))
    return bad;

  // A2's parts lie one after the other (ops/zoom_dft.py:_a2_parts): one
  // box of every part a stage
  const long long part = (long long)a.nl * a.m2 * a.n_pad * 2;
  for (int p = 1; p < PASSES / 3 + 1; ++p)
    if (static_cast<const char*>(a.a2[p]) !=
        static_cast<const char*>(a.a2[0]) + p * part)
      return bad;
  CUtensorMap maps[3];
  const cuuint64_t a_dims[4] = {(cuuint64_t)a.n_pad, (cuuint64_t)a.m2,
                                (cuuint64_t)a.nl, PASSES / 3 + 1};
  const cuuint64_t a_str[3] = {(cuuint64_t)a.n_pad * 2,
                               (cuuint64_t)a.m2 * a.n_pad * 2,
                               (cuuint64_t)part};
  const cuuint32_t a_box[4] = {KS, (cuuint32_t)(nbox * BOX_ROWS), 1,
                               PASSES / 3 + 1};
  if (!make_map(&maps[0], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4, a.a2[0],
                a_dims, a_str, a_box, CU_TENSOR_MAP_SWIZZLE_64B))
    return bad;
  maps[1] = maps[2] = maps[0];   // unused on the direct path
  if (a.staged) {
    const cuuint64_t d_dims[4] = {(cuuint64_t)a.ncols, (cuuint64_t)a.n,
                                  (cuuint64_t)a.ndir, (cuuint64_t)a.B};
    const cuuint64_t d_str[3] = {(cuuint64_t)a.sr * 4, (cuuint64_t)sd * 4,
                                 (cuuint64_t)sb * 4};
    const cuuint32_t d_box[4] = {TJ, KS, (cuuint32_t)a.ndir, 1};
    const cuuint64_t l_dims[2] = {(cuuint64_t)a.ncols, (cuuint64_t)a.n};
    const cuuint64_t l_str[1] = {(cuuint64_t)a.ncols * 4};
    const cuuint32_t l_box[2] = {TJ, KS};
    if (!make_map(&maps[1], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dphi,
                  d_dims, d_str, d_box, CU_TENSOR_MAP_SWIZZLE_NONE) ||
        !make_map(&maps[2], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.dl, l_dims,
                  l_str, l_box, CU_TENSOR_MAP_SWIZZLE_NONE))
      return bad;
  }

  const int nib = (a.m2 + TIB - 1) / TIB;
  const int njt = (a.ncols + TJ - 1) / TJ;
  const int ng = (a.nl + a.group - 1) / a.group;
  const dim3 grid(njt * nib * ng, a.B);
  const auto kernel = fused_exp_zoom_anchor_wg_kernel<PASSES>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
      maps[0], maps[1], maps[2], a.dphi, sb, sd, a.sr,
      a.dl, a.centre, a.astar, a.coef, a.u, a.ndir, a.n, a.ncols, a.nl, a.m2,
      a.group, a.deg1, nib, ng, nbox, a.stages, a.staged);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K6 at "high" on `stream`: u (B, nl, m2, ncols) from the
// wavelengths in groups of `group` (at most KB), deg1 = degree + 1 Taylor
// terms (at most DMAX); a2hi/a2lo are the bf16 split of A2 (nl, m2, n_pad),
// zero past the n contraction rows, n_pad a multiple of 8; stages and
// staged are the launch plan (ops/zoom_dft.py:anchor_launch_plan).
// Returns the first CUDA error (0 = launched; cudaErrorInvalidValue for a
// plan or operands it refuses).
extern "C" int muse_fused_exp_zoom_anchor_tc(
    const float* dphi, const float* dl, const void* a2hi, const void* a2lo,
    const float* centre, const float* astar, const float* coef, float* u,
    long long sb, long long sd, long long sr, int B, int ndir, int n,
    int ncols, int nl, int m2, int n_pad, int group, int deg1, int stages,
    int staged, void* stream) {
  const AnchorArgs a{dphi, dl, {a2hi, a2lo, nullptr}, centre, astar, coef,
                     u, sb, sd, sr, B, ndir, n, ncols, nl, m2, n_pad, group,
                     deg1, stages, staged};
  return launch<3>(a, stream);
}

// The same at "highest": a2p0, a2p1, a2p2 are the three bf16 parts of A2.
extern "C" int muse_fused_exp_zoom_anchor(
    const float* dphi, const float* dl, const void* a2p0, const void* a2p1,
    const void* a2p2, const float* centre, const float* astar,
    const float* coef, float* u, long long sb, long long sd, long long sr,
    int B, int ndir, int n, int ncols, int nl, int m2, int n_pad, int group,
    int deg1, int stages, int staged, void* stream) {
  const AnchorArgs a{dphi, dl, {a2p0, a2p1, a2p2}, centre, astar, coef, u,
                     sb, sd, sr, B, ndir, n, ncols, nl, m2, n_pad, group,
                     deg1, stages, staged};
  return launch<6>(a, stream);
}
