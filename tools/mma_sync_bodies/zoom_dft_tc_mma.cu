// K1, K3 and K5 as they ran before the wgmma body, with mma.sync: the
// yardstick of muse_psfr_tpu_torch/csrc/zoom_dft_tc.cu, built apart from the
// package with -I muse_psfr_tpu_torch/csrc and beside
// muse_psfr_tpu_torch/csrc/zoom_dft.cu (K3's slab sum) by
// tools/ab_zoom_tc.py and chip_smoke.py; the package never builds or
// launches it.  Its entry points are muse_fused_exp_zoom_tc_mma and
// muse_fused_exp_zoom_mma, with the arguments the package's entry points
// had before they took the launch plan.
//
// The fused direction-averaged system OTF x zoom-DFT stage 1 on Hopper
// tensor cores, one body for both settings of zoom_precision.
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
// memory.
//
// What bounds it: at the full-window chunk (50 rows x 35 wavelengths,
// 2M = 160, N = 1280, ncols = 768) the passes are 3 or 6 x 550.5 GFLOP of
// bf16 tensor-core work, 1.67 or 3.34 ms at the 989 TFLOP/s peak, and the
// 1.72 G exponentials take 0.41 ms on the SFU (16 a clock per SM); at
// ndir = 9 the exponentials bound it.  The design, per block of 256 threads
// (8 warps) owning one (row, wavelength, 64-column tile, 160-row block, row
// slice):
//
// - mma.sync.m16n8k16 bf16 with float32 accumulators: U = A2 . G with A2
//   as the row-major A operand and G as the column-major B operand, so the
//   accumulators hold rows of U and the epilogue stores pairs of adjacent
//   columns.  Each warp owns an 80 x 16 output tile (5 x 2 fragments).
// - At "high" A2 is split into bf16 hi/lo once per launch by the wrapper
//   (it depends on the wavelengths only) and read by ldmatrix from tiles of
//   80-byte row pitch, conflict-free.  At "highest" it is staged as float32
//   and split in registers (mma_common.cuh).  Each step (32 contraction
//   rows) stages its A2 tiles, its D tile of every direction and its dl
//   tile by cp.async into a double buffer, the next step's copies in flight
//   while the current step's G is built and contracted: the exponentials
//   read shared memory, not device memory.  Shared memory per block, A2
//   and G tiles + 16 KB per staged direction and for dl: "high" 59.0 KB +
//   (ndir + 1) x 16 KB, "highest" 53.5 KB + (ndir + 1) x 16 KB; at ndir = 9
//   219.0 and 213.5 KB of the 227 KB a block may have, one block per SM; at
//   ndir = 1 91.0 and 85.5 KB, two.  Past 9 directions, or for D rows not
//   16-byte aligned, the body reads D and dl from device memory instead.
// - Each step's G tile (32 x 64) is built once per block (every element of
//   D is read by one thread, with the damping summed over the directions
//   in registers), split into its two or three bf16 parts and stored in
//   shared memory; the warps read their B fragments with ldmatrix.trans.
//   The damping is evaluated with the same roundings as the plain version
//   (no fused multiply-adds), so G is bit-identical to it.
// - Tensor-core accumulation rounds toward zero inside each mma.  So every
//   step's passes accumulate in fresh fragments (32 rows of the
//   contraction), which are then added to the running sum with rounded
//   float32 adds: the truncation acts on a 32-row partial, not on U.
//
// On an H100 the 3-pass body runs at ~6x its tensor-core bound at ndir = 1:
// a step's phases (staging, ldmatrix, G build, mma) run nearly in series
// (PERF.md); the package's body now runs wgmma with TMA staging.
//
// K3 (row_splits R > 1): the block of row slice r contracts only rows
// [r*n/R, (r+1)*n/R) and writes its partial product to the workspace slab
// r; muse_sum_row_slices (zoom_dft.cu) adds the slabs in the fixed order
// r = 0..R-1.  K5 (live != nullptr): each block loops only over its 64-column
// tile's live rows [lo, hi), intersected with its slice.
//
// Requires the contraction length n to be a multiple of 8 at "high" and of
// 4 at "highest" (16-byte rows of A2 for cp.async); the wrapper checks it.
// D may be a strided view with contiguous columns.

#include "mma_common.cuh"

extern "C" int muse_sum_row_slices(const float* ws, float* u, long long total,
                                   int R, void* stream);

namespace {

constexpr int TJ = 64;        // output columns per block
constexpr int NT = 256;       // threads: 8 warps, 2 (rows) x 4 (columns)
constexpr int WN = 16;        // output columns per warp
constexpr int MT = WM / 16;   // m16 fragments per warp
constexpr int NW = WN / 8;    // n8 fragments per warp
constexpr int AP = KS + 8;    // bf16 A2 tile pitch: 80 B, conflict-free
constexpr int GP = TJ + 8;    // G tile pitch [bf16]: 144 B, conflict-free
constexpr int A_TILE = TI * AP;   // bf16 per A2 tile (one of hi, lo)
constexpr int G_TILE = KS * GP;   // bf16 per G tile (one part)
constexpr int F_TILE = KS * TJ;   // floats per staged D (one direction) or dl tile
constexpr int GE = KS * TJ / NT;  // G elements built per thread and step

// bytes of the A2 tiles (both buffers) and the G tiles of a block
__host__ __device__ constexpr int a_smem(int passes) {
  return passes == 3 ? 4 * A_TILE * 2 : 2 * A_F32 * 4;
}
__host__ __device__ constexpr int base_smem(int passes) {
  return a_smem(passes) + (passes / 3 + 1) * G_TILE * 2;
}

// the most directions whose D tiles a step stages in shared memory (two
// buffers of (ndir + 1) float tiles beside the A2 and G tiles); beyond it
// the body reads D from device memory
__host__ __device__ constexpr int max_staged_ndir(int passes) {
  return (MAX_SMEM - base_smem(passes)) / (2 * F_TILE * 4) - 1;
}

// the damping term of one direction, with the plain version's roundings
// (a product, then a sum: no fused multiply-add)
template <bool EXP2>
__device__ __forceinline__ float damp(float al, float x, float wd) {
  return EXP2 ? exp2f(__fadd_rn(__fmul_rn(al, x), wd))
              : __fmul_rn(expf(__fmul_rn(al, x)), wd);
}

// PASSES == 3: a2a, a2b are the bf16 hi and lo parts of A2; PASSES == 6:
// a2a is A2 in float32 and a2b unused
template <int PASSES, bool EXP2>
__global__ void __launch_bounds__(NT, 2)
fused_exp_zoom_tc_kernel(const float* __restrict__ dphi,  // (B, ndir, n, ncols)
                         long long sb, long long sd, long long sr,
                         const float* __restrict__ dl,    // (n, ncols)
                         const void* __restrict__ a2a,    // (nl, m2, n)
                         const void* __restrict__ a2b,
                         const float* __restrict__ alpha,  // (nl,)
                         const float* __restrict__ w,      // (B, nl, ndir)
                         const int* __restrict__ live,     // (ncols/TJ, 2)
                         float* __restrict__ out,  // (R, B, nl, m2, ncols)
                         int B, int ndir, int n, int ncols, int nl, int m2,
                         int nib, int R, int staged) {
  extern __shared__ __align__(128) unsigned char smem[];
  constexpr int PARTS = PASSES / 3 + 1;   // bf16 parts of G: 2 or 3
  // A2 tiles ("high": [buffer][hi, lo][TI][AP] bf16; "highest": [buffer]
  // [TI][KS] float32, swizzled), [part][KS][GP] G tiles, then when staged
  // [buffer][ndir D tiles, dl tile][KS][TJ] floats
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  float* af = reinterpret_cast<float*>(smem);
  __nv_bfloat16* gs = reinterpret_cast<__nv_bfloat16*>(smem + a_smem(PASSES));
  float* fs = reinterpret_cast<float*>(gs + PARTS * G_TILE);
  const int fbuf = (ndir + 1) * F_TILE;   // floats per staged buffer

  const int r = blockIdx.x % R;
  const int jt = blockIdx.x / R / nib;
  const int ib = blockIdx.x / R % nib;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = jt * TJ;
  const int i0 = ib * TI;
  const int t = threadIdx.x;
  const int lane = t & 31;
  const int wm = (t >> 5) >> 2;      // warp's row half
  const int wn = (t >> 5) & 3;       // warp's column quarter
  const int h = n / R;               // rows of this slice: [r*h, (r+1)*h)
  int n_lo = r * h, n_hi = n_lo + h;
  if (live != nullptr) {             // K5: only the tile's live rows
    n_lo = max(n_lo, live[2 * jt]);
    n_hi = min(n_hi, live[2 * jt + 1]);
  }

  const float al = alpha[l];
  const float* wl = w + ((size_t)b * nl + l) * ndir;
  const float* db = dphi + (size_t)b * sb;
  const size_t a_off = (size_t)l * m2 * n;

  // one step's operands into buffer `buf` by cp.async, zeros outside
  // rows [n0, n_hi) and columns [0, ncols): A2 rows [i0, i0 + TI) in
  // 16-byte chunks, and when staged each direction's D tile and the dl
  // tile (KS x TJ floats, 16 chunks a row)
  auto stage = [&](int buf, int n0) {
    if constexpr (PASSES == 6) {
      stage_a_f32(af + buf * A_F32, static_cast<const float*>(a2a) + a_off,
                  m2, n, i0, n0, n_hi, t, NT);
    } else {
      constexpr int CH = KS / 8;
      for (int q = t; q < 2 * TI * CH; q += NT) {
        const int part = q / (TI * CH);
        const int row = q / CH % TI;
        const int c = q % CH;
        const int grow = i0 + row, gcol = n0 + c * 8;
        const bool ok = grow < m2 && gcol < n_hi;
        const __nv_bfloat16* src =
            static_cast<const __nv_bfloat16*>(part ? a2b : a2a) +
            (ok ? a_off + (size_t)grow * n + gcol : 0);
        cp_async16(
            smem_addr(as + (buf * 2 + part) * A_TILE + row * AP + c * 8), src,
            ok ? 16 : 0);
      }
    }
    if (staged) {
      float* dst = fs + buf * fbuf;
      for (int q = t; q < (ndir + 1) * KS * (TJ / 4); q += NT) {
        const int d = q / (KS * (TJ / 4));   // d == ndir: the dl tile
        const int kk = q / (TJ / 4) % KS;
        const int c = q % (TJ / 4) * 4;
        const int row = n0 + kk, col = j0 + c;
        const int nv = row < n_hi ? max(0, min(4, ncols - col)) : 0;
        const float* src =
            nv == 0 ? dl
            : d < ndir ? db + (size_t)d * sd + (size_t)row * sr + col
                       : dl + (size_t)row * ncols + col;
        cp_async16(smem_addr(dst + d * F_TILE + kk * TJ + c), src, 4 * nv);
      }
    }
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  // G tile of contraction rows [n0, n0 + KS): thread t builds column
  // jj = t % TJ, rows kb + 4 i, from the staged tiles of `buf` or from
  // device memory; the damping summed over the directions, times dl, split
  // into its bf16 parts
  const int jj = t % TJ, kb = t / TJ;
  auto build_g = [&](int buf, int n0) {
    const int col = j0 + jj;
    float g[GE], dlv[GE];
#pragma unroll
    for (int i = 0; i < GE; ++i) g[i] = 0.f;
    if (staged) {
      const float* src = fs + buf * fbuf + (kb * TJ + jj);
      for (int d = 0; d < ndir; ++d) {
        const float wd = wl[d];
#pragma unroll
        for (int i = 0; i < GE; ++i)
          g[i] = __fadd_rn(g[i], damp<EXP2>(al, src[d * F_TILE + 4 * i * TJ],
                                            wd));
      }
#pragma unroll
      for (int i = 0; i < GE; ++i) dlv[i] = src[ndir * F_TILE + 4 * i * TJ];
    } else {
      const float* dp = db + col;
      for (int d = 0; d < ndir; ++d) {
        const float wd = wl[d];
#pragma unroll
        for (int i = 0; i < GE; ++i) {
          const int row = n0 + kb + 4 * i;
          if (row < n_hi && col < ncols)
            g[i] = __fadd_rn(g[i], damp<EXP2>(al, dp[(size_t)d * sd +
                                                     (size_t)row * sr], wd));
        }
      }
#pragma unroll
      for (int i = 0; i < GE; ++i) {
        const int row = n0 + kb + 4 * i;
        dlv[i] = (row < n_hi && col < ncols) ? dl[(size_t)row * ncols + col]
                                             : 0.f;
      }
    }
#pragma unroll
    for (int i = 0; i < GE; ++i) {
      const float v = __fmul_rn(g[i], dlv[i]);
      if constexpr (PASSES == 6) {
        store_g3(gs, G_TILE, (kb + 4 * i) * GP + jj, v);
      } else {
        const __nv_bfloat16 hi = __float2bfloat16_rn(v);
        const float hf = __bfloat162float(hi);
        const __nv_bfloat16 lo =
            __float2bfloat16_rn(isinf(hf) ? 0.f : v - hf);
        gs[(kb + 4 * i) * GP + jj] = hi;
        gs[G_TILE + (kb + 4 * i) * GP + jj] = lo;
      }
    }
  };

  // this warp's live m16 fragments (rows below m2); warp-uniform
  const int mt_live = min(MT, max(0, (m2 - i0 - wm * WM + 15) / 16));
  // ldmatrix row addresses: A (row-major bf16 A2 tile) row lane % 16,
  // column (lane / 16) * 8; B (.trans of the [k][n] G tile) k = lane % 8 +
  // (lane / 8 % 2) * 8, n = (lane / 16) * 8
  const uint32_t a_lane =
      ((wm * WM + (lane & 15)) * AP + (lane >> 4) * 8) * 2;
  const uint32_t g_lane = smem_addr(
      gs + ((lane & 7) + ((lane >> 3) & 1) * 8) * GP + wn * WN +
      (lane >> 4) * 8);

  float acc[MT][NW][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NW; ++nt)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[mt][nt][e] = 0.f;

  if (n_lo < n_hi) stage(0, n_lo);
  int buf = 0;
  for (int n0 = n_lo; n0 < n_hi; n0 += KS, buf ^= 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // this step's tiles landed; the last step's are free
    if (n0 + KS < n_hi) stage(buf ^ 1, n0 + KS);
    build_g(buf, n0);
    __syncthreads();   // G of this step visible

    if constexpr (PASSES == 6) {
      contract6_step<GP>(af + buf * A_F32, wm * WM, g_lane, mt_live, lane,
                         acc);
    } else {
      float part[MT][NW][4];
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e) part[mt][nt][e] = 0.f;
      const uint32_t a_hi = smem_addr(as + buf * 2 * A_TILE) + a_lane;
      const uint32_t a_lo = a_hi + A_TILE * 2;
#pragma unroll
      for (int k16 = 0; k16 < KS; k16 += 16) {
        uint32_t bh[4], bl[4];         // (b0, b1) of n8 fragments 0 and 1
        ldsm_x4_trans(bh, g_lane + k16 * GP * 2);
        ldsm_x4_trans(bl, g_lane + (G_TILE + k16 * GP) * 2);
#pragma unroll
        for (int mt = 0; mt < MT; ++mt) {
          if (mt < mt_live) {
            uint32_t ah[4], alo[4];
            ldsm_x4(ah, a_hi + (mt * 16 * AP + k16) * 2);
            ldsm_x4(alo, a_lo + (mt * 16 * AP + k16) * 2);
#pragma unroll
            for (int nt = 0; nt < NW; ++nt) {
              mma_bf16(part[mt][nt], ah, bh[2 * nt], bh[2 * nt + 1]);
              mma_bf16(part[mt][nt], ah, bl[2 * nt], bl[2 * nt + 1]);
              mma_bf16(part[mt][nt], alo, bh[2 * nt], bh[2 * nt + 1]);
            }
          }
        }
      }
#pragma unroll
      for (int mt = 0; mt < MT; ++mt)
#pragma unroll
        for (int nt = 0; nt < NW; ++nt)
#pragma unroll
          for (int e = 0; e < 4; ++e)
            acc[mt][nt][e] = __fadd_rn(acc[mt][nt][e], part[mt][nt][e]);
    }
  }

  // accumulator fragment: rows lane / 4 and + 8, columns 2 (lane % 4), + 1
  float* ub = out + (((size_t)r * B + b) * nl + l) * m2 * ncols;
  const int row0 = i0 + wm * WM + (lane >> 2);
  const int col0 = j0 + wn * WN + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int nt = 0; nt < NW; ++nt) {
      const int row = row0 + mt * 16, col = col0 + nt * 8;
      store_pair(ub, row, col, m2, ncols, acc[mt][nt][0], acc[mt][nt][1]);
      store_pair(ub, row + 8, col, m2, ncols, acc[mt][nt][2],
                 acc[mt][nt][3]);
    }
}

struct ZoomArgs {
  const float *dphi, *dl;
  const void *a2a, *a2b;
  const float *alpha, *w;
  const int* live;
  float *ws, *u;
  long long sb, sd, sr;
  int B, ndir, n, ncols, nl, m2, R;
};

// one launch of K1/K3/K5 with PASSES passes, then K3's ordered sum
template <int PASSES, bool EXP2>
int launch(const ZoomArgs& a, void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int nib = (a.m2 + TI - 1) / TI;
  const int njt = (a.ncols + TJ - 1) / TJ;
  const dim3 grid(njt * nib * a.R, a.nl, a.B);
  // D and dl go through shared memory when their rows are 16-byte
  // aligned for cp.async and the directions fit
  const bool aligned = (reinterpret_cast<uintptr_t>(a.dphi) |
                        reinterpret_cast<uintptr_t>(a.dl)) % 16 == 0 &&
                       a.sb % 4 == 0 && a.sd % 4 == 0 && a.sr % 4 == 0 &&
                       a.ncols % 4 == 0;
  const int staged = aligned && a.ndir <= max_staged_ndir(PASSES);
  const int smem =
      base_smem(PASSES) + (staged ? 2 * (a.ndir + 1) * F_TILE * 4 : 0);
  cudaError_t err = cudaFuncSetAttribute(
      fused_exp_zoom_tc_kernel<PASSES, EXP2>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  fused_exp_zoom_tc_kernel<PASSES, EXP2><<<grid, NT, smem, st>>>(
      a.dphi, a.sb, a.sd, a.sr, a.dl, a.a2a, a.a2b, a.alpha, a.w, a.live,
      a.R > 1 ? a.ws : a.u, a.B, a.ndir, a.n, a.ncols, a.nl, a.m2, nib, a.R,
      staged);
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
// split of A2 (nl, m2, n), n a multiple of 8.  Returns the first CUDA
// error (0 = launched).
extern "C" int muse_fused_exp_zoom_tc_mma(const float* dphi, const float* dl,
                                      const void* a2hi, const void* a2lo,
                                      const float* alpha, const float* w,
                                      const int* live, float* ws, float* u,
                                      long long sb, long long sd, long long sr,
                                      int B, int ndir, int n, int ncols,
                                      int nl, int m2, int row_splits,
                                      int use_exp2, void* stream) {
  if (n % 8) return static_cast<int>(cudaErrorInvalidValue);
  const ZoomArgs a{dphi, dl, a2hi, a2lo, alpha, w, live, ws, u, sb, sd, sr,
                   B, ndir, n, ncols, nl, m2, row_splits};
  return use_exp2 ? launch<3, true>(a, stream) : launch<3, false>(a, stream);
}

// The same at "highest": a2 is A2 (nl, m2, n) in float32, n a multiple
// of 4.
extern "C" int muse_fused_exp_zoom_mma(const float* dphi, const float* dl,
                                   const float* a2, const float* alpha,
                                   const float* w, const int* live,
                                   float* ws, float* u,
                                   long long sb, long long sd, long long sr,
                                   int B, int ndir, int n, int ncols, int nl,
                                   int m2, int row_splits, int use_exp2,
                                   void* stream) {
  if (n % 4) return static_cast<int>(cudaErrorInvalidValue);
  const ZoomArgs a{dphi, dl, a2, nullptr, alpha, w, live, ws, u, sb, sd, sr,
                   B, ndir, n, ncols, nl, m2, row_splits};
  return use_exp2 ? launch<6, true>(a, stream) : launch<6, false>(a, stream);
}
