// K6 as it ran before the wgmma body, with mma.sync: the yardstick of
// muse_psfr_tpu_torch/csrc/zoom_anchor_tc.cu, built apart from the package
// with -I muse_psfr_tpu_torch/csrc by tools/ab_zoom_tc.py and
// chip_smoke.py; the package never builds or launches it.  Its entry
// points are muse_fused_exp_zoom_anchor_tc_mma and
// muse_fused_exp_zoom_anchor_mma, with the arguments the package's entry
// points had before they took the launch plan.
//
// The anchored-Taylor damping x zoom-DFT stage 1 on Hopper tensor
// cores, one body for both settings of zoom_precision.
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
// practice two things set its pace, in about equal parts (PERF.md): the G
// build, latency-bound at one block per SM, and L2 traffic, since every
// block re-reads its group's A2 (4 bytes a value at either setting, 5.4 GB
// at that shape) for its 16 columns.
//
// The design: one exponential per direction, element and group with the
// power sums in registers, and the contraction of zoom_dft_tc.cu
// (mma.sync.m16n8k16 bf16, each 32-row step summed in fresh fragments and
// added to the running sum with rounded float32 adds, since the tensor
// cores truncate inside an mma).  A block owns one (row, group, 16-column
// tile, 160-row block) and 16 warps, two per wavelength l of the group: at
// "high" 160 x 8 outputs each (10 fragments), at "highest" 80 x 16 each
// (5 x 2 fragments, so that no A2 value is split into its parts twice);
// 40 accumulator registers a thread either way.  Per 32-row step the
// block
// - starts the cp.async copies of every wavelength's A2 tile (one buffer).
//   At "high" A2 was split once per launch by the wrapper into bf16 hi/lo
//   tiles of 80-byte row pitch: 28 KB a wavelength with its G tiles, 196
//   KB at the planner's group of 7, 224 KB at the cap of 8.  At "highest"
//   it is staged as float32 (swizzled, no padding) and split in registers,
//   24.5 KB a wavelength with the three G parts: 171.5 KB at 7, 196 KB at
//   8, of the 227 KB a block may have;
// - builds the group's G tiles while they land: each thread one element,
//   its D values of the first 9 directions loaded a step ahead (their
//   latency hides behind the previous step's contraction) and the centre
//   values held in registers; the power sums once, the directions' power
//   chains side by side, then each wavelength's combination with
//   coefficients read as float4s from shared memory (read one by one, as
//   volatile scalars next to each product, they stalled the build), all
//   with the plain version's roundings and order of sums, no fused
//   multiply-adds, so G and its bf16 parts are bit-identical to it;
// - waits, and each warp contracts its fragments: at "high" A by ldmatrix
//   from the A2 tiles, B by ldmatrix.trans from the 48-byte-pitch G tiles,
//   both conflict-free.
// The group index runs fastest in the grid, so the blocks that read the
// same D tile run together and share it in L2.
//
// Requires the contraction length n to be a multiple of 8 at "high" and of
// 4 at "highest" (16-byte rows of A2 for cp.async); the wrapper checks it.
// D may be a strided view with contiguous columns.
//

#include "mma_common.cuh"

namespace {

constexpr int KB = 8;             // most wavelengths per group
constexpr int DMAX = 12;          // most Taylor terms (degree + 1)
constexpr int TJ = 16;            // output columns per block
constexpr int NT = 64 * KB;       // threads: two warps per wavelength
constexpr int MT = TI / 16;       // m16 fragments per warp
constexpr int AP = KS + 8;        // A2 tile pitch [bf16]: 80 B, conflict-free
constexpr int GP = TJ + 8;        // G tile pitch [bf16]: 48 B, conflict-free
constexpr int A_TILE = TI * AP;   // bf16 per A2 tile (one of hi, lo)
constexpr int G_TILE = KS * GP;   // bf16 per G tile (one part)
constexpr int GE = KS * TJ / NT;  // G elements built per thread and step
constexpr int DPRE = 9;           // directions of D loaded a step ahead

template <int PASSES>
__global__ void __launch_bounds__(NT, 1)
fused_exp_zoom_anchor_tc_kernel(
    const float* __restrict__ dphi,            // (B, ndir, n, ncols)
    long long sb, long long sd, long long sr,  // its strides
    const float* __restrict__ dl,              // (n, ncols)
    // (nl, m2, n): PASSES == 3 the bf16 hi and lo parts of A2; PASSES == 6
    // A2 in float32, a2b unused
    const void* __restrict__ a2a, const void* __restrict__ a2b,
    const float* __restrict__ centre,          // (B, ndir)
    const float* __restrict__ astar,           // (groups,)
    const float* __restrict__ coef,            // (nl, deg1)
    float* __restrict__ out,                   // (B, nl, m2, ncols)
    int ndir, int n, int ncols, int nl, int m2, int group, int deg1,
    int nib, int ng) {
  extern __shared__ __align__(128) unsigned char smem[];
  __shared__ __align__(16) float cs[KB][DMAX];   // the group's coefficients

  const int g = blockIdx.x % ng;
  const int ib = blockIdx.x / ng % nib;
  const int jt = blockIdx.x / ng / nib;
  const int b = blockIdx.y;
  const int l0 = g * group;
  const int kg = min(group, nl - l0);
  const int j0 = jt * TJ;
  const int i0 = ib * TI;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int l = t >> 6;              // this warp's wavelength in the group
  // and its half of the tile: the n8 column fragment ("high") or the 80
  // output rows ("highest")
  const int nh = (t >> 5) & 1;
  constexpr int PARTS = PASSES / 3 + 1;   // bf16 parts of G: 2 or 3
  // A2 tiles ("high": [kg][hi, lo][TI][AP] bf16; "highest": [kg][TI][KS]
  // float32, swizzled), then [kg][part][KS][GP] G tiles
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  float* af = reinterpret_cast<float*>(smem);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(
      smem + kg * (PASSES == 6 ? A_F32 * 4 : 2 * A_TILE * 2));

  const float ast = astar[g];
  const float* db = dphi + (size_t)b * sb;
  const float* cb = centre + (size_t)b * ndir;
  for (int q = t; q < KB * DMAX; q += NT) {
    const int w = q / DMAX, i = q % DMAX;
    cs[w][i] = (w < kg && i < deg1) ? coef[(size_t)(l0 + w) * deg1 + i] : 0.f;
  }

  // one step's A2 tiles of every wavelength, rows [i0, i0 + TI) and
  // contraction rows [n0, n0 + KS) in 16-byte chunks, zeros outside
  auto stage = [&](int n0) {
    if constexpr (PASSES == 6) {
      for (int w = 0; w < kg; ++w)
        stage_a_f32(af + w * A_F32,
                    static_cast<const float*>(a2a) + (size_t)(l0 + w) * m2 * n,
                    m2, n, i0, n0, n, t, NT);
    } else {
      constexpr int CH = KS / 8;
      for (int q = t; q < kg * 2 * TI * CH; q += NT) {
        const int c = q % CH;
        const int row = q / CH % TI;
        const int part = q / (CH * TI) % 2;
        const int w = q / (CH * TI * 2);
        const int grow = i0 + row, gcol = n0 + c * 8;
        const bool ok = grow < m2 && gcol < n;
        const __nv_bfloat16* src =
            static_cast<const __nv_bfloat16*>(part ? a2b : a2a) +
            (ok ? ((size_t)(l0 + w) * m2 + grow) * n + gcol : 0);
        cp_async16(smem_addr(as + (w * 2 + part) * A_TILE + row * AP + c * 8),
                   src, ok ? 16 : 0);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // the D values (first DPRE directions) and dl values of the elements
  // thread t builds in the step at n0: element t + e NT is row kk, column jj
  // of the step's G tile.  Loaded a step ahead, so that their latency
  // hides behind the previous step's contraction.
  auto load_d = [&](int n0, float (&dv)[GE][DPRE], float (&dlv)[GE]) {
#pragma unroll
    for (int e = 0; e < GE; ++e) {
      const int q = t + e * NT;
      const int row = n0 + q / TJ, col = j0 + q % TJ;
      const bool ok = row < n && col < ncols;
      const float* dp = db + (size_t)row * sr + col;
#pragma unroll
      for (int d = 0; d < DPRE; ++d)
        dv[e][d] = (ok && d < ndir) ? dp[(size_t)d * sd] : 0.f;
      dlv[e] = ok ? dl[(size_t)row * ncols + col] : 0.f;
    }
  };

  // the centre values of the first DPRE directions: in registers at
  // "high"; at "highest", whose contraction needs those registers (it
  // spilled with them), in shared memory
  float cen[DPRE];
  __shared__ float cen_s[DPRE];
#pragma unroll
  for (int d = 0; d < DPRE; ++d) cen[d] = d < ndir ? cb[d] : 0.f;
  if (PASSES == 6 && t < DPRE) cen_s[t] = t < ndir ? cb[t] : 0.f;

  // the group's G tiles of contraction rows [n0, n0 + KS): the power sums
  // of both elements of the thread, one exponential per direction, then
  // every wavelength's combination of them with its coefficients (three
  // float4 reads of shared memory a wavelength), split into its bf16 parts
  auto build_g = [&](int n0, const float (&dv)[GE][DPRE],
                     const float (&dlv)[GE]) {
    float hs[GE][DMAX];
#pragma unroll
    for (int e = 0; e < GE; ++e) {
#pragma unroll
      for (int i = 0; i < DMAX; ++i) hs[e][i] = 0.f;
      const int q = t + e * NT;
      const int row = n0 + q / TJ, col = j0 + q % TJ;
      if (row < n && col < ncols) {
        // the prefetched directions side by side: their exponentials and
        // power chains are independent, and only the sums over the
        // directions run in order, as in the plain version
        float x[DPRE], f[DPRE];
#pragma unroll
        for (int d = 0; d < DPRE; ++d) {
          x[d] = __fmul_rn(
              ast, __fsub_rn(dv[e][d], PASSES == 6 ? cen_s[d] : cen[d]));
          f[d] = expf(x[d]);
        }
#pragma unroll
        for (int i = 0; i < DMAX; ++i) {
          if (i < deg1) {
#pragma unroll
            for (int d = 0; d < DPRE; ++d) {
              if (d < ndir) {
                hs[e][i] = __fadd_rn(hs[e][i], f[d]);
                f[d] = __fmul_rn(f[d], x[d]);
              }
            }
          }
        }
        const float* dp = db + (size_t)row * sr + col;
        for (int d = DPRE; d < ndir; ++d) {
          const float xd = __fmul_rn(ast, __fsub_rn(dp[(size_t)d * sd],
                                                    cb[d]));
          float fd = expf(xd);
#pragma unroll
          for (int i = 0; i < DMAX; ++i) {
            if (i < deg1) {
              hs[e][i] = __fadd_rn(hs[e][i], fd);
              fd = __fmul_rn(fd, xd);
            }
          }
        }
      }
    }
#pragma unroll
    for (int w = 0; w < KB; ++w) {
      if (w < kg) {
        float c[DMAX];
#pragma unroll
        for (int i = 0; i < DMAX; i += 4) {
          const float4 c4 = *reinterpret_cast<const float4*>(&cs[w][i]);
          c[i] = c4.x, c[i + 1] = c4.y, c[i + 2] = c4.z, c[i + 3] = c4.w;
        }
#pragma unroll
        for (int e = 0; e < GE; ++e) {
          const int q = t + e * NT;
          const int kk = q / TJ, jj = q % TJ;
          float gv = __fmul_rn(c[0], hs[e][0]);
#pragma unroll
          for (int i = 1; i < DMAX; ++i)
            if (i < deg1) gv = __fadd_rn(gv, __fmul_rn(c[i], hs[e][i]));
          const float v = __fmul_rn(gv, dlv[e]);
          if constexpr (PASSES == 6) {
            store_g3(gs + w * 3 * G_TILE, G_TILE, kk * GP + jj, v);
          } else {
            const __nv_bfloat16 hi = __float2bfloat16_rn(v);
            const float hf = __bfloat162float(hi);
            const __nv_bfloat16 lo =
                __float2bfloat16_rn(isinf(hf) ? 0.f : v - hf);
            gs[(w * 2) * G_TILE + kk * GP + jj] = hi;
            gs[(w * 2 + 1) * G_TILE + kk * GP + jj] = lo;
          }
        }
      }
    }
  };

  // live m16 fragments (rows below m2): of the tile ("high") or of this
  // warp's 80 rows ("highest")
  const int mt_live =
      PASSES == 6 ? min(MT6, max(0, (m2 - i0 - nh * WM + 15) / 16))
                  : min(MT, max(0, (m2 - i0 + 15) / 16));
  // ldmatrix row addresses: A (row-major bf16 A2 tile) row lane % 16,
  // column (lane / 16) * 8; B (.trans of the [k][n] G tile) k = lane % 8 +
  // (lane / 8 % 2) * 8, n = (lane / 16) * 8
  const uint32_t a_base = smem_addr(as + l * 2 * A_TILE) +
                          ((lane & 15) * AP + (lane >> 4) * 8) * 2;
  const uint32_t g_base =
      smem_addr(gs + l * PARTS * G_TILE) +
      (((lane & 7) + ((lane >> 3) & 1) * 8) * GP + (lane >> 4) * 8) * 2;

  // "high": m16 fragment mt of the warp's n8 column at [mt / 2][mt % 2];
  // "highest": [m16 fragment][n8 fragment]
  float acc[MT6][2][4];
#pragma unroll
  for (int mt = 0; mt < MT6; ++mt)
#pragma unroll
    for (int nt = 0; nt < 2; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  float dv[GE][DPRE], dlv[GE];
  load_d(0, dv, dlv);
  __syncthreads();   // the coefficients
  for (int n0 = 0; n0 < n; n0 += KS) {
    stage(n0);
    build_g(n0, dv, dlv);
    if (n0 + KS < n) load_d(n0 + KS, dv, dlv);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // A2 and G tiles of this step visible
    if constexpr (PASSES == 6) {
      if (l < kg)
        contract6_step<GP>(af + l * A_F32, nh * WM, g_base, mt_live, lane,
                           acc);
    } else if (l < kg) {
      // (b0, b1) of this warp's n8 fragment, hi and lo, per k16 half
      uint32_t bh[2][2], bl[2][2];
#pragma unroll
      for (int k = 0; k < 2; ++k) {
        uint32_t r[4];
        ldsm_x4_trans(r, g_base + k * 16 * GP * 2);
        bh[k][0] = nh ? r[2] : r[0], bh[k][1] = nh ? r[3] : r[1];
        ldsm_x4_trans(r, g_base + (G_TILE + k * 16 * GP) * 2);
        bl[k][0] = nh ? r[2] : r[0], bl[k][1] = nh ? r[3] : r[1];
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt) {
        if (mt < mt_live) {
          float part[4] = {};
#pragma unroll
          for (int k = 0; k < 2; ++k) {
            uint32_t ah[4], alo[4];
            ldsm_x4(ah, a_base + (mt * 16 * AP + k * 16) * 2);
            ldsm_x4(alo, a_base + (A_TILE + mt * 16 * AP + k * 16) * 2);
            mma_bf16(part, ah, bh[k][0], bh[k][1]);
            mma_bf16(part, ah, bl[k][0], bl[k][1]);
            mma_bf16(part, alo, bh[k][0], bh[k][1]);
          }
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt / 2][mt % 2][e] = __fadd_rn(acc[mt / 2][mt % 2][e], part[e]);
        }
      }
    }
    __syncthreads();   // both tiles free for the next step
  }

  if (l >= kg) return;
  // accumulator fragment: rows lane / 4 and + 8, columns 2 (lane % 4), + 1
  float* ub = out + ((size_t)b * nl + l0 + l) * m2 * ncols;
  const int row0 = i0 + (lane >> 2);
  const int col0 = j0 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    // fragment mt of "high" is rows 16 mt.. of column nh; of "highest"
    // fragment (mt / 2, mt % 2) of the warp's 80 rows
    const int row = row0 + (PASSES == 6 ? nh * WM + mt / 2 * 16 : mt * 16);
    const int col = col0 + (PASSES == 6 ? mt % 2 : nh) * 8;
    const float(&a)[4] = acc[mt / 2][mt % 2];
    store_pair(ub, row, col, m2, ncols, a[0], a[1]);
    store_pair(ub, row + 8, col, m2, ncols, a[2], a[3]);
  }
}

template <int PASSES>
int launch(const float* dphi, const float* dl, const void* a2a,
           const void* a2b, const float* centre, const float* astar,
           const float* coef, float* u, long long sb, long long sd,
           long long sr, int B, int ndir, int n, int ncols, int nl, int m2,
           int group, int deg1, void* stream) {
  if (group < 1 || group > KB || deg1 < 1 || deg1 > DMAX ||
      n % (PASSES == 6 ? 4 : 8))
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = group * (PASSES == 6 ? A_F32 * 4 + 3 * G_TILE * 2
                                        : 2 * (A_TILE + G_TILE) * 2);
  cudaError_t err = cudaFuncSetAttribute(
      fused_exp_zoom_anchor_tc_kernel<PASSES>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nib = (m2 + TI - 1) / TI;
  const int njt = (ncols + TJ - 1) / TJ;
  const int ng = (nl + group - 1) / group;
  const dim3 grid(njt * nib * ng, B);
  fused_exp_zoom_anchor_tc_kernel<PASSES>
      <<<grid, NT, smem, static_cast<cudaStream_t>(stream)>>>(
          dphi, sb, sd, sr, dl, a2a, a2b, centre, astar, coef, u, ndir, n,
          ncols, nl, m2, group, deg1, nib, ng);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Launches K6 at "high" on `stream`: u (B, nl, m2, ncols) from the
// wavelengths in groups of `group` (at most KB), deg1 = degree + 1 Taylor
// terms (at most DMAX); a2hi/a2lo are the bf16 split of A2 (nl, m2, n), n a
// multiple of 8.  Returns the first CUDA error (0 = launched).
extern "C" int muse_fused_exp_zoom_anchor_tc_mma(
    const float* dphi, const float* dl, const void* a2hi, const void* a2lo,
    const float* centre, const float* astar, const float* coef, float* u,
    long long sb, long long sd, long long sr, int B, int ndir, int n,
    int ncols, int nl, int m2, int group, int deg1, void* stream) {
  return launch<3>(dphi, dl, a2hi, a2lo, centre, astar, coef, u, sb, sd, sr,
                   B, ndir, n, ncols, nl, m2, group, deg1, stream);
}

// The same at "highest": a2 is A2 (nl, m2, n) in float32, n a multiple
// of 4.
extern "C" int muse_fused_exp_zoom_anchor_mma(
    const float* dphi, const float* dl, const float* a2, const float* centre,
    const float* astar, const float* coef, float* u, long long sb,
    long long sd, long long sr, int B, int ndir, int n, int ncols, int nl,
    int m2, int group, int deg1, void* stream) {
  return launch<6>(dphi, dl, a2, nullptr, centre, astar, coef, u, sb, sd, sr,
                   B, ndir, n, ncols, nl, m2, group, deg1, stream);
}
