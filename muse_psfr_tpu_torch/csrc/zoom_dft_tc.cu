// K1, K3 and K5: the fused direction-averaged system OTF x zoom-DFT stage 1
// on Hopper's warpgroup tensor-core products (wgmma, sm_90a) fed by TMA,
// one body for both settings of zoom_precision.
//
// Replaces muse_psfr_tpu/ops/zoom_dft.py:fused_exp_zoom (bodies
// _kernel_dirfull, _kernel, _kernel_dirblock, _kernel_rowacc and, through
// the live-row table, fused_exp_zoom_disc), whose contraction is
// _mxu_contract: the 3-pass bf16 split at "high", Precision.HIGHEST (six
// bf16 passes on the TPU's matrix unit) at "highest".  Per telemetry row b
// and wavelength l it computes
//
//     G[n, j] = sum_d exp(alpha_l * D[b, d, n, j]) * w[b, l, d] * dl[n, j]
//     U[b, l] = A2_l @ G                       (2M x N) @ (N x ncols)
//
// with the product, the kernel's PASSES template parameter, as
//
//     3 ("high"):    A2_hi @ G_hi + A2_hi @ G_lo + A2_lo @ G_hi
//     6 ("highest"): the six products of order up to two of the three-part
//                    split, a float32-grade product (mma_common.cuh)
//
// where x_hi = bf16(x), x_lo = bf16(x - x_hi) (round to nearest even; lo = 0
// where hi is infinite) and the accumulation is float32.  The products of
// bf16 values are exact in float32, so "high" is the plain version's
// arithmetic (ops/zoom_dft.py:contract) up to the order of the float32
// sums; its dropped lo*lo term is ~2^-16 relative.  G never reaches device
// memory, nor shared memory.
//
// What bounds it: at the full-window chunk (50 rows x 35 wavelengths,
// 2M = 160, N = 1280, ncols = 768) the passes are 3 or 6 x 550.5 GFLOP of
// bf16 tensor-core work, 1.67 or 3.34 ms at the 989 TFLOP/s peak, and the
// 1.72 G exponentials take 0.41 ms on the SFU (16 a clock per SM); at
// ndir = 9 the exponentials bound it.  The design:
//
// - The product is transposed, U^T = G^T . A2^T, as wgmma.mma_async with
//   A from registers (wgmma_common.cuh): M = 64 output columns per
//   consumer warpgroup, N = the block's 160 rows of A2 (TI) as one
//   m64n160k16 product at "high" and four m64n40k16 at "highest", K = the
//   contraction.  G^T is the A operand: each thread builds exactly the G
//   elements of its A fragment (two columns, eight contraction rows per
//   16-row k-step) from the D and dl tiles in shared memory, with the
//   plain version's roundings (no fused multiply-add, so G is
//   bit-identical to it), and splits them into bf16 parts in place.  No G
//   tile goes through shared memory, and no barrier separates the build
//   from the products.  A2^T is the B operand: A2_l, stored (m2, n), is
//   K-major as it is.
// - The wrapper splits A2 into its two ("high") or three ("highest") bf16
//   parts once per launch (zoom_dft.cu:split_bf16; they depend on the
//   wavelengths only), padded to a multiple of 8 contraction rows.  A
//   producer warpgroup (one thread working, its registers given to the
//   consumers by setmaxnreg) stages every step's operands by TMA into a
//   ring of `stages` buffers with a full and an empty mbarrier each: the
//   A2 parts (a 32 x 160 box each, 64-byte swizzle, the layout the B
//   descriptor reads), and each consumer warpgroup's D tile of every
//   direction and its dl tile (32 x 32 float boxes, 128-byte swizzle, so
//   the fragment reads are free of bank conflicts).  D may be a strided
//   view: where its base or strides (or dl's rows) are not 16-byte
//   aligned, or its directions do not fit two stages, the consumers read D
//   and dl from device memory instead (the direct path, far slower) and
//   TMA stages A2 alone.
// - One or two consumer warpgroups a block (two column tiles sharing the
//   block's A2 stages), 2-4 stages: the wrapper's launch plan
//   (ops/zoom_dft.py:tc_launch_plan) chooses them and this file checks
//   them.  A warpgroup issues a step's products, builds the next step's G
//   while they run, then waits and adds: the exponentials overlap the
//   tensor cores.  Each batch of products is free of run-time branches.
// - Tensor-core accumulation rounds toward zero inside each product.  So
//   every step's passes accumulate in fresh accumulators (32 rows of the
//   contraction), which are then added to the running sum with rounded
//   float32 adds: the truncation acts on a 32-row partial, not on U.  At
//   "highest" the five small passes and the a0 g0 pass keep separate
//   accumulators, added to each other and then to the sum.  The order of
//   every sum is the mma.sync body's, and the two agree bit for bit.
//
// Shared memory per block: stages x (A2 parts + warpgroups x (ndir + 1) x
// 8 KB), "high" 20 KB and "highest" 30 KB of A2 a stage; at ndir = 1 two
// warpgroups and 4 / 3 stages (209 / 187 KB), at ndir = 9 one warpgroup and
// 2 stages (201 / 221 KB).
//
// K3 (row_splits R > 1): the block of row slice r contracts only rows
// [r*n/R, (r+1)*n/R) and writes its partial product to the workspace slab
// r; muse_sum_row_slices (zoom_dft.cu) adds the slabs in the fixed order
// r = 0..R-1.  K5 (live != nullptr): each warpgroup keeps only its 64-column
// tile's live rows [lo, hi), intersected with its slice; the block's steps
// cover the union of its warpgroups' ranges.

#include "wgmma_common.cuh"

extern "C" int muse_sum_row_slices(const float* ws, float* u, long long total,
                                   int R, void* stream);

namespace {

constexpr int TJ = 64;            // output columns per consumer warpgroup
constexpr int MAX_WGS = 2;        // consumer warpgroups per block
constexpr int MAX_STAGES = 4;
constexpr int A_PART = TI * KS * 2;         // bytes of one A2 part a stage
constexpr int BOX_COLS = 32;                // floats per row of a D/dl box
constexpr int BOX = KS * BOX_COLS * 4;      // bytes of one D/dl box
constexpr int SLACK = 1024;                 // for the stages' alignment
constexpr int CONSUMER_REGS = 240, PRODUCER_REGS = 24;

// bytes of one stage: the A2 parts and, when D is staged, each
// warpgroup's two column halves of every direction and of dl
__host__ __device__ constexpr int stage_bytes(int passes, int wgs, int ndir,
                                              int staged) {
  return (passes / 3 + 1) * A_PART + (staged ? wgs * 2 * (ndir + 1) * BOX : 0);
}

// the damping term of one direction, with the plain version's roundings
// (a product, then a sum: no fused multiply-add)
template <bool EXP2>
__device__ __forceinline__ float damp(float al, float x, float wd) {
  return EXP2 ? exp2f(__fadd_rn(__fmul_rn(al, x), wd))
              : __fmul_rn(expf(__fmul_rn(al, x)), wd);
}

// the bf16 parts of two adjacent values of G as A-fragment pairs (the
// lower contraction row in the lower half): two parts ("high") or three
// ("highest"); the later parts are 0 where part 0 is infinite
template <int PARTS>
__device__ __forceinline__ void split_pair(float v0, float v1,
                                           uint32_t (&f)[PARTS]) {
  const __nv_bfloat162 h0 = __floats2bfloat162_rn(v0, v1);
  const float2 f0 = __bfloat1622float2(h0);
  const float r0 = isinf(f0.x) ? 0.f : __fsub_rn(v0, f0.x);
  const float r1 = isinf(f0.y) ? 0.f : __fsub_rn(v1, f0.y);
  const __nv_bfloat162 h1 = __floats2bfloat162_rn(r0, r1);
  f[0] = *reinterpret_cast<const uint32_t*>(&h0);
  f[1] = *reinterpret_cast<const uint32_t*>(&h1);
  if constexpr (PARTS == 3) {
    const float2 g1 = __bfloat1622float2(h1);
    const __nv_bfloat162 h2 =
        __floats2bfloat162_rn(__fsub_rn(r0, g1.x), __fsub_rn(r1, g1.y));
    f[2] = *reinterpret_cast<const uint32_t*>(&h2);
  }
}

// The products of one step are split over the rows of A2 into NP parts
// of NN rows: one of 160 at "high", four of 40 at "highest", whose two
// accumulators (the a0 g0 pass and the five small ones) would not fit the
// registers at more rows beside the running sum.
template <int PASSES>
struct Parts {
  static constexpr int NP = PASSES == 3 ? 1 : 4;
  static constexpr int NN = TI / NP;      // A2 rows a product
  static constexpr int ACC = NN / 2;      // accumulators a thread
};

template <int N>
__device__ __forceinline__ void mma_rs(float (&d)[N / 2],
                                       const uint32_t (&a)[4], uint64_t desc,
                                       int accumulate) {
  if constexpr (N == 160)
    wgmma_m64n160k16_rs(d, a, desc, accumulate);
  else
    wgmma_m64n40k16_rs(d, a, desc, accumulate);
}

// One part's products (A2 rows [NN part, NN (part + 1)) of the step), both
// 16-row k-steps: "high" the three passes into p0; "highest" the five
// small passes into p1 and a0 g0 into p0.  g[k][part] is the k-step's G
// fragment, a_base the stage's first A2 part (parts A_PART apart).  The
// first product of each accumulator overwrites it.
template <int PASSES>
__device__ __forceinline__ void issue_part(
    float (&p0)[Parts<PASSES>::ACC], float (&p1)[Parts<PASSES>::ACC],
    const uint32_t (&g)[2][PASSES / 3 + 1][4], uint32_t a_base, int part) {
  constexpr int NN = Parts<PASSES>::NN;
  constexpr uint64_t PART = A_PART >> 4;   // in descriptor address units
#pragma unroll
  for (int k = 0; k < 2; ++k) {
    const uint64_t a0 = sw64_desc(a_base + part * NN * 64 + k * 32);
    if constexpr (PASSES == 3) {
      mma_rs<NN>(p0, g[k][0], a0, k);          // G_hi A2_hi
      mma_rs<NN>(p0, g[k][1], a0, 1);          // G_lo A2_hi
      mma_rs<NN>(p0, g[k][0], a0 + PART, 1);   // G_hi A2_lo
    } else {
      mma_rs<NN>(p1, g[k][2], a0, k);              // g2 a0
      mma_rs<NN>(p1, g[k][1], a0 + PART, 1);       // g1 a1
      mma_rs<NN>(p1, g[k][0], a0 + 2 * PART, 1);   // g0 a2
      mma_rs<NN>(p1, g[k][1], a0, 1);              // g1 a0
      mma_rs<NN>(p1, g[k][0], a0 + PART, 1);       // g0 a1
      mma_rs<NN>(p0, g[k][0], a0, k);              // g0 a0
    }
  }
}

template <int PASSES, bool EXP2>
__global__ void __launch_bounds__((MAX_WGS + 1) * 128, 1)
fused_exp_zoom_wg_kernel(const __grid_constant__ CUtensorMap map_a0,
                         const __grid_constant__ CUtensorMap map_a1,
                         const __grid_constant__ CUtensorMap map_a2,
                         const __grid_constant__ CUtensorMap map_d,
                         const __grid_constant__ CUtensorMap map_dl,
                         const float* __restrict__ dphi,  // (B, ndir, n, ncols)
                         long long sb, long long sd, long long sr,
                         const float* __restrict__ dl,     // (n, ncols)
                         const float* __restrict__ alpha,  // (nl,)
                         const float* __restrict__ w,      // (B, nl, ndir)
                         const int* __restrict__ live,     // (ncols/TJ, 2)
                         float* __restrict__ out,  // (R, B, nl, m2, ncols)
                         int B, int ndir, int n, int ncols, int nl, int m2,
                         int nib, int R, int wgs, int stages, int staged) {
  constexpr int PARTS = PASSES / 3 + 1;
  constexpr int NP = Parts<PASSES>::NP, NN = Parts<PASSES>::NN;
  constexpr int ACC = Parts<PASSES>::ACC;
  __shared__ __align__(8) uint64_t bars[2 * MAX_STAGES];  // full, empty
  extern __shared__ unsigned char smem_raw[];
  const uint32_t base = (smem_addr(smem_raw) + SLACK - 1) & ~(SLACK - 1);
  unsigned char* smem = smem_raw + (base - smem_addr(smem_raw));
  const int sbytes = stage_bytes(PASSES, wgs, ndir, staged);
  const uint32_t full0 = smem_addr(bars), empty0 = full0 + MAX_STAGES * 8;

  const int t = threadIdx.x;
  const int r = blockIdx.x % R;
  const int ib = blockIdx.x / R % nib;
  const int jp = blockIdx.x / R / nib;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int i0 = ib * TI;
  const int njt = (ncols + TJ - 1) / TJ;
  const int h = n / R;               // rows of this slice: [r*h, (r+1)*h)

  // the rows of warpgroup g's column tile, and the block's steps over
  // their union
  auto rows_of = [&](int g, int& lo, int& hi) {
    const int jt = jp * wgs + g;
    lo = r * h;
    hi = jt < njt ? lo + h : lo;
    if (live != nullptr && jt < njt) {
      lo = max(lo, live[2 * jt]);
      hi = min(hi, live[2 * jt + 1]);
    }
  };
  int n_lo = n, n_hi = 0;
  for (int g = 0; g < wgs; ++g) {
    int lo, hi;
    rows_of(g, lo, hi);
    if (lo < hi) {
      n_lo = min(n_lo, lo);
      n_hi = max(n_hi, hi);
    }
  }
  const int ns = n_lo < n_hi ? (n_hi - n_lo + KS - 1) / KS : 0;

  if (t == 0) {
    for (int s = 0; s < stages; ++s) {
      mbar_init(full0 + 8 * s, 1);
      mbar_init(empty0 + 8 * s, wgs * 128);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (t >= wgs * 128) {
    // ---- producer: one thread stages every step by TMA ----
    reg_dealloc<PRODUCER_REGS>();
    if (t != wgs * 128) return;
    for (int s = 0; s < ns; ++s) {
      const int st = s % stages;
      if (s >= stages) mbar_wait(empty0 + 8 * st, (s / stages - 1) & 1);
      const uint32_t bar = full0 + 8 * st;
      mbar_expect_tx(bar, sbytes);
      const uint32_t dst = base + st * sbytes;
      const int n0 = n_lo + s * KS;
      tma_load_3d(dst, &map_a0, bar, n0, i0, l);
      tma_load_3d(dst + A_PART, &map_a1, bar, n0, i0, l);
      if constexpr (PARTS == 3)
        tma_load_3d(dst + 2 * A_PART, &map_a2, bar, n0, i0, l);
      if (staged) {
        for (int g = 0; g < wgs; ++g) {
          const uint32_t wdst = dst + PARTS * A_PART + g * 2 * (ndir + 1) * BOX;
          const int j0 = (jp * wgs + g) * TJ;
          for (int ch = 0; ch < 2; ++ch) {
            const int c0 = j0 + ch * BOX_COLS;
            tma_load_4d(wdst + ch * ndir * BOX, &map_d, bar, c0, n0, 0, b);
            tma_load_2d(wdst + (2 * ndir + ch) * BOX, &map_dl, bar, c0, n0);
          }
        }
      }
    }
    return;
  }

  // ---- consumers: warpgroup g, warp wq of it, lane ----
  reg_alloc<CONSUMER_REGS>();
  const int g = t >> 7;
  const int wq = (t >> 5) & 3;
  const int lane = t & 31;
  const int q = lane & 3;
  int own_lo, own_hi;
  rows_of(g, own_lo, own_hi);
  const int j0 = (jp * wgs + g) * TJ;
  const float al = alpha[l];
  const float* wl = w + ((size_t)b * nl + l) * ndir;
  const float* db = dphi + (size_t)b * sb;

  // This thread's G elements, per 16-row k-step: fragment register f
  // (column jr + 8 (f & 1), rows 2q + {0, 1} + 8 (f >> 1)).  Staged, the
  // D box of column half ch = wq / 2 holds column c at chunk c / 4 of its
  // 128-byte row, XOR-swizzled by the row (which here is 2q + e mod 8).
  const int jr = 16 * wq + (lane >> 2);
  int soff[2][2];   // [f & 1][e]: float offset of rows 2q + e, k-step 0
#pragma unroll
  for (int i = 0; i < 2; ++i)
#pragma unroll
    for (int e = 0; e < 2; ++e) {
      const int c = (jr + 8 * i) & 31, row = 2 * q + e;
      soff[i][e] = row * BOX_COLS + ((((c >> 2) ^ (row & 7)) << 2) | (c & 3));
    }
  const int ch = wq >> 1;

  // G of the nk k-steps k0.. of step s into frag[k][part][reg], their
  // elements in flight together: element i is k-step k0 + i / 8,
  // fragment register f = i / 2 % 4, contraction row 16 k + 2q + i % 2 +
  // 8 (f / 2); the first direction's term is G's first value, as in the
  // plain version (no add to zero)
  auto build = [&](uint32_t (&frag)[2][PARTS][4], int s, int k0, int nk) {
    constexpr int E = 16;
    const int n0 = n_lo + s * KS + 16 * k0;
    auto row_of = [&](int i) {         // of the step, from n0
      return 16 * (i >> 3) + 2 * q + (i & 1) + 8 * ((i >> 2) & 1);
    };
    float gv[E], dlv[E];
    if (staged) {
      const float* ws = reinterpret_cast<const float*>(
          smem + (s % stages) * sbytes + PARTS * A_PART +
          g * 2 * (ndir + 1) * BOX);
      const float* dsm = ws + ch * ndir * (BOX / 4) + 16 * k0 * BOX_COLS;
      const float* lsm = ws + (2 * ndir + ch) * (BOX / 4) + 16 * k0 * BOX_COLS;
      auto at = [&](int i) {
        return soff[(i >> 1) & 1][i & 1] +
               (16 * (i >> 3) + 8 * ((i >> 2) & 1)) * BOX_COLS;
      };
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (i < 8 * nk) gv[i] = damp<EXP2>(al, dsm[at(i)], wl[0]);
      for (int d = 1; d < ndir; ++d) {
        const float wd = wl[d];
#pragma unroll
        for (int i = 0; i < E; ++i)
          if (i < 8 * nk)
            gv[i] = __fadd_rn(
                gv[i], damp<EXP2>(al, dsm[d * (BOX / 4) + at(i)], wd));
      }
#pragma unroll
      for (int i = 0; i < E; ++i)
        if (i < 8 * nk) dlv[i] = lsm[at(i)];
    } else {
#pragma unroll
      for (int i = 0; i < E; ++i) gv[i] = 0.f;
      for (int d = 0; d < ndir; ++d) {
        const float wd = wl[d];
        const float* dp = db + (size_t)d * sd;
#pragma unroll
        for (int i = 0; i < E; ++i) {
          const int row = n0 + row_of(i);
          const int col = j0 + jr + 8 * ((i >> 1) & 1);
          if (i < 8 * nk && row < own_hi && row >= own_lo && col < ncols) {
            const float t = damp<EXP2>(al, dp[(size_t)row * sr + col], wd);
            gv[i] = d == 0 ? t : __fadd_rn(gv[i], t);
          }
        }
      }
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int row = n0 + row_of(i);
        const int col = j0 + jr + 8 * ((i >> 1) & 1);
        dlv[i] = (i < 8 * nk && row < own_hi && row >= own_lo && col < ncols)
                     ? dl[(size_t)row * ncols + col]
                     : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < E; ++i)
      if (i < 8 * nk) gv[i] = __fmul_rn(gv[i], dlv[i]);
    // rows outside this warpgroup's range (K3's slice, K5's live rows, the
    // contraction's end) add nothing
    if (n0 < own_lo || n0 + 16 * nk > own_hi) {
#pragma unroll
      for (int i = 0; i < E; ++i) {
        const int row = n0 + row_of(i);
        if (i < 8 * nk) gv[i] = (row < own_hi && row >= own_lo) ? gv[i] : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < E; i += 2) {
      if (i < 8 * nk) {
        uint32_t parts[PARTS];
        split_pair<PARTS>(gv[i], gv[i + 1], parts);
#pragma unroll
        for (int p = 0; p < PARTS; ++p)
          frag[k0 + (i >> 3)][p][(i >> 1) & 3] = parts[p];
      }
    }
  };

  float acc[NP][ACC];
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int i = 0; i < ACC; ++i) acc[pp][i] = 0.f;
  float p0[ACC], p1[ACC];
#pragma unroll
  for (int i = 0; i < ACC; ++i) p0[i] = p1[i] = 0.f;

  // step s with its G fragments in `cur`, building step s + 1's in `nxt`
  // while the products run: both k-steps during the one part at "high",
  // k-step k during part (k + 1) NP / 2 - 1 at "highest"
  auto step = [&](uint32_t (&cur)[2][PARTS][4], uint32_t (&nxt)[2][PARTS][4],
                  int s) {
    const int st = s % stages;
    const bool more = s + 1 < ns;
    const uint32_t a_base = base + st * sbytes;
#pragma unroll
    for (int pp = 0; pp < NP; ++pp) {
      fence_regs(p0);
      if constexpr (PASSES == 6) fence_regs(p1);
      fence_regs(cur[0]);
      fence_regs(cur[1]);
      wgmma_fence();
      issue_part<PASSES>(p0, p1, cur, a_base, pp);
      wgmma_commit();
      if (more) {
        if constexpr (NP == 1) {
          mbar_wait(full0 + 8 * ((s + 1) % stages), ((s + 1) / stages) & 1);
          build(nxt, s + 1, 0, 2);
        } else if (pp % (NP / 2) == NP / 2 - 1) {
          if (pp == NP / 2 - 1)
            mbar_wait(full0 + 8 * ((s + 1) % stages),
                      ((s + 1) / stages) & 1);
          build(nxt, s + 1, pp / (NP / 2), 1);
        }
      }
      wgmma_wait<0>();
      fence_regs(p0);
      if constexpr (PASSES == 6) fence_regs(p1);
      fence_regs(cur[0]);
      fence_regs(cur[1]);
#pragma unroll
      for (int i = 0; i < ACC; ++i) {
        if constexpr (PASSES == 3)
          acc[pp][i] = __fadd_rn(acc[pp][i], p0[i]);
        else
          acc[pp][i] = __fadd_rn(acc[pp][i], __fadd_rn(p0[i], p1[i]));
      }
    }
    mbar_arrive(empty0 + 8 * st);
  };

  uint32_t fa[2][PARTS][4], fb[2][PARTS][4];
  if (ns > 0) {
    mbar_wait(full0, 0);
    build(fa, 0, 0, 2);
  }
  for (int s = 0; s < ns; s += 2) {
    step(fa, fb, s);
    if (s + 1 < ns) step(fb, fa, s + 1);
  }

  // accumulator (part pp, 8-row block jb, element e): output column
  // j0 + jr + 8 (e / 2), A2 row i0 + NN pp + 8 jb + 2q + e % 2
  float* ub = out + (((size_t)r * B + b) * nl + l) * m2 * ncols;
#pragma unroll
  for (int pp = 0; pp < NP; ++pp)
#pragma unroll
    for (int jb = 0; jb < NN / 8; ++jb)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int row = i0 + pp * NN + 8 * jb + 2 * q + (e & 1);
        const int col = j0 + jr + 8 * (e >> 1);
        if (row < m2 && col < ncols)
          ub[(size_t)row * ncols + col] = acc[pp][4 * jb + e];
      }
}

// ---- host side ---------------------------------------------------------

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                                 void*, const cuuint64_t*, const cuuint64_t*,
                                 const cuuint32_t*, const cuuint32_t*,
                                 CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// the driver's cuTensorMapEncodeTiled, through the runtime (no libcuda at
// link time)
EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (err == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// a tensor map of `rank` dimensions (innermost first; strides in bytes of
// dimensions 1..rank-1), boxes of `box`, zeros outside the tensor
bool make_map(CUtensorMap* map, CUtensorMapDataType type, int rank,
              const void* ptr, const cuuint64_t* dims,
              const cuuint64_t* strides, const cuuint32_t* box,
              CUtensorMapSwizzle swizzle) {
  const EncodeTiled enc = encode_tiled();
  const cuuint32_t ones[4] = {1, 1, 1, 1};
  return enc != nullptr &&
         enc(map, type, rank, const_cast<void*>(ptr), dims, strides, box,
             ones, CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
             CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
             CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

struct ZoomArgs {
  const float *dphi, *dl;
  const void* a2[3];
  const float *alpha, *w;
  const int* live;
  float *ws, *u;
  long long sb, sd, sr;
  int B, ndir, n, ncols, nl, m2, n_pad, R, wgs, stages, staged;
};

// one launch of K1/K3/K5 with PASSES passes, then K3's ordered sum
template <int PASSES, bool EXP2>
int launch(const ZoomArgs& a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int bad = static_cast<int>(cudaErrorInvalidValue);
  // the launch plan: checked here, chosen by ops/zoom_dft.py:tc_launch_plan
  const int sbytes = stage_bytes(PASSES, a.wgs, a.ndir, a.staged);
  const int smem = a.stages * sbytes + SLACK;
  if (a.wgs < 1 || a.wgs > MAX_WGS || a.stages < 2 ||
      a.stages > MAX_STAGES ||
      smem + (int)sizeof(uint64_t) * 2 * MAX_STAGES > MAX_SMEM ||
      a.n_pad % 8 || a.n_pad < a.n)
    return bad;
  // size-1 dimensions may carry any stride; give them an aligned one
  const long long sd = a.ndir > 1 ? a.sd : a.n * a.sr;
  const long long sb = a.B > 1 ? a.sb : a.ndir * sd;
  if (a.staged &&
      ((reinterpret_cast<uintptr_t>(a.dphi) |
        reinterpret_cast<uintptr_t>(a.dl)) % 16 ||
       a.sr % 4 || sd % 4 || sb % 4 || a.ncols % 4 || a.ndir > 256))
    return bad;

  CUtensorMap maps[5];
  const cuuint64_t a_dims[3] = {(cuuint64_t)a.n_pad, (cuuint64_t)a.m2,
                                (cuuint64_t)a.nl};
  const cuuint64_t a_str[2] = {(cuuint64_t)a.n_pad * 2,
                               (cuuint64_t)a.m2 * a.n_pad * 2};
  const cuuint32_t a_box[3] = {KS, TI, 1};
  for (int p = 0; p < 3; ++p)
    if (!make_map(&maps[p], CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 3,
                  a.a2[p < PASSES / 3 + 1 ? p : 0], a_dims, a_str, a_box,
                  CU_TENSOR_MAP_SWIZZLE_64B))
      return bad;
  maps[3] = maps[4] = maps[0];   // unused on the direct path
  if (a.staged) {
    const cuuint64_t d_dims[4] = {(cuuint64_t)a.ncols, (cuuint64_t)a.n,
                                  (cuuint64_t)a.ndir, (cuuint64_t)a.B};
    const cuuint64_t d_str[3] = {(cuuint64_t)a.sr * 4, (cuuint64_t)sd * 4,
                                 (cuuint64_t)sb * 4};
    const cuuint32_t d_box[4] = {BOX_COLS, KS, (cuuint32_t)a.ndir, 1};
    const cuuint64_t l_dims[2] = {(cuuint64_t)a.ncols, (cuuint64_t)a.n};
    const cuuint64_t l_str[1] = {(cuuint64_t)a.ncols * 4};
    const cuuint32_t l_box[2] = {BOX_COLS, KS};
    if (!make_map(&maps[3], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 4, a.dphi,
                  d_dims, d_str, d_box, CU_TENSOR_MAP_SWIZZLE_128B) ||
        !make_map(&maps[4], CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, a.dl, l_dims,
                  l_str, l_box, CU_TENSOR_MAP_SWIZZLE_128B))
      return bad;
  }

  const int nib = (a.m2 + TI - 1) / TI;
  const int njp = ((a.ncols + TJ - 1) / TJ + a.wgs - 1) / a.wgs;
  const dim3 grid(njp * nib * a.R, a.nl, a.B);
  const auto kernel = fused_exp_zoom_wg_kernel<PASSES, EXP2>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  kernel<<<grid, (a.wgs + 1) * 128, smem, st>>>(
      maps[0], maps[1], maps[2], maps[3], maps[4], a.dphi, sb, sd, a.sr,
      a.dl, a.alpha, a.w, a.live, a.R > 1 ? a.ws : a.u, a.B, a.ndir, a.n,
      a.ncols, a.nl, a.m2, nib, a.R, a.wgs, a.stages, a.staged);
  err = cudaGetLastError();
  if (err != cudaSuccess || a.R == 1) return static_cast<int>(err);
  return muse_sum_row_slices(a.ws, a.u,
                             (long long)a.B * a.nl * a.m2 * a.ncols, a.R,
                             stream);
}

}  // namespace

// Launches K1/K3/K5 at "high" on `stream` (row_splits == 1: writes u, ws is
// unused; R > 1: the R slices into the workspace ws of R * B * nl * m2 *
// ncols floats, then their ordered sum into u), with K5's table of live
// rows per 64-column tile when `live` is not null; a2hi/a2lo are the bf16
// split of A2 (nl, m2, n_pad), zero past the n contraction rows, n_pad a
// multiple of 8; wgs, stages and staged are the launch plan
// (ops/zoom_dft.py:tc_launch_plan).  Returns the first CUDA error (0 =
// launched; cudaErrorInvalidValue for a plan or operands it refuses).
extern "C" int muse_fused_exp_zoom_tc(const float* dphi, const float* dl,
                                      const void* a2hi, const void* a2lo,
                                      const float* alpha, const float* w,
                                      const int* live, float* ws, float* u,
                                      long long sb, long long sd, long long sr,
                                      int B, int ndir, int n, int ncols,
                                      int nl, int m2, int n_pad,
                                      int row_splits, int use_exp2, int wgs,
                                      int stages, int staged, void* stream) {
  const ZoomArgs a{dphi, dl, {a2hi, a2lo, nullptr}, alpha, w, live, ws, u,
                   sb, sd, sr, B, ndir, n, ncols, nl, m2, n_pad, row_splits,
                   wgs, stages, staged};
  return use_exp2 ? launch<3, true>(a, stream) : launch<3, false>(a, stream);
}

// The same at "highest": a2p0, a2p1, a2p2 are the three bf16 parts of A2.
extern "C" int muse_fused_exp_zoom(const float* dphi, const float* dl,
                                   const void* a2p0, const void* a2p1,
                                   const void* a2p2, const float* alpha,
                                   const float* w, const int* live,
                                   float* ws, float* u,
                                   long long sb, long long sd, long long sr,
                                   int B, int ndir, int n, int ncols, int nl,
                                   int m2, int n_pad, int row_splits,
                                   int use_exp2, int wgs, int stages,
                                   int staged, void* stream) {
  const ZoomArgs a{dphi, dl, {a2p0, a2p1, a2p2}, alpha, w, live, ws, u,
                   sb, sd, sr, B, ndir, n, ncols, nl, m2, n_pad, row_splits,
                   wgs, stages, staged};
  return use_exp2 ? launch<6, true>(a, stream) : launch<6, false>(a, stream);
}
