// K6 at zoom_precision "high": the anchored-Taylor damping x zoom-DFT
// stage 1 on Hopper tensor cores.
//
// Replaces muse_psfr_tpu/ops/zoom_dft.py:fused_exp_zoom_anchor with
// precision "high" (body _kernel_anchor, whose contraction is
// _mxu_contract's 3-pass bf16 split).  Per telemetry row b and wavelength
// group g (group consecutive wavelengths, anchor astar[g]) it computes
//
//     x      = astar[g] * (D[b, d, n, j] - centre[b, d])
//     H_i    = sum_d e^x x^i                    i = 0..degree
//     G_l    = (sum_i coef[l, i] H_i) * dl      l in group g
//     U[b,l] = A2_hi @ G_hi + A2_hi @ G_lo + A2_lo @ G_hi
//
// with x_hi = bf16(x), x_lo = bf16(x - x_hi) (round to nearest even; lo = 0
// where hi is infinite) and float32 accumulation: the arithmetic of the
// plain version (ops/zoom_dft.py:fused_exp_zoom_anchor_reference at
// "high") up to the order of the float32 sums.  G never reaches device
// memory.
//
// What bounds it: at the 9-direction shape (4 rows x 35 wavelengths in 5
// groups of 7, degree 8, N = 1280, ncols = 768, 2M = 160) the three passes
// are 132 GFLOP of bf16 tensor-core work (0.13 ms at the 989 TFLOP/s
// peak); the 177 M exponentials take 0.04 ms on the SFU and the power sums
// and combinations ~6 GFLOP of float32 (0.09 ms).  In practice two things
// set its pace, in about equal parts (PERF.md): the G build, latency-bound
// at one block per SM, and L2 traffic, since every block re-reads its
// group's A2 (hi and lo, 4 bytes a value, 5.4 GB at that shape) for its
// 16 columns.
//
// The design takes the G build of csrc/zoom_anchor.cu (one exponential per
// direction, element and group; the power sums in registers) and the
// contraction of csrc/zoom_dft_tc.cu (mma.sync.m16n8k16 bf16, three
// passes, A2 split once per launch by the wrapper, each 32-row step summed
// in a fresh fragment and added to the running sum with a rounded float32
// add, since the tensor cores truncate inside an mma).  A block owns one
// (row, group, 16-column tile, 160-row block) and 16 warps; warps 2l and
// 2l + 1 own wavelength l of the group, 160 x 8 outputs each (10
// fragments: 40 accumulator registers a thread, where the float32 body's
// 8 x 160 x 32 tile took 218 registers and a fragment layout of that tile
// would not fit).  Per 32-row step the block
// - starts the cp.async copies of every wavelength's A2 hi/lo tile (one
//   buffer: at a group of 8 they fill 200 of the 224 KB the block takes);
// - builds the group's G tiles while they land: each thread one element,
//   its D values of the first 9 directions loaded a step ahead (their
//   latency hides behind the previous step's contraction) and the centre
//   values held in registers; the power sums once, the directions' power
//   chains side by side, then each wavelength's combination with
//   coefficients read as float4s from shared memory (read one by one, as
//   volatile scalars next to each product, they stalled the build), all
//   with the plain version's roundings and order of sums, no fused
//   multiply-adds, so G and its bf16 hi/lo split are bit-identical to it;
// - waits, and each warp contracts its fragment: A by ldmatrix from the
//   80-byte-pitch A2 tiles, B by ldmatrix.trans from the 48-byte-pitch G
//   tiles, both conflict-free.
// The group index runs fastest in the grid, so the blocks that read the
// same D tile run together and share it in L2.
//
// Requires the contraction length n to be a multiple of 8 (16-byte rows of
// A2 for cp.async); the wrapper checks it.  D may be a strided view with
// contiguous columns.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int KB = 8;             // most wavelengths per group
constexpr int DMAX = 12;          // most Taylor terms (degree + 1)
constexpr int TJ = 16;            // output columns per block
constexpr int TI = 160;           // output rows per block (2M at dimpsf = 40)
constexpr int KS = 32;            // contraction rows per step
constexpr int NT = 64 * KB;       // threads: two warps per wavelength
constexpr int MT = TI / 16;       // m16 fragments per warp
constexpr int AP = KS + 8;        // A2 tile pitch [bf16]: 80 B, conflict-free
constexpr int GP = TJ + 8;        // G tile pitch [bf16]: 48 B, conflict-free
constexpr int A_TILE = TI * AP;   // bf16 per A2 tile (one of hi, lo)
constexpr int G_TILE = KS * GP;   // bf16 per G tile (one of hi, lo)
constexpr int GE = KS * TJ / NT;  // G elements built per thread and step
constexpr int DPRE = 9;           // directions of D loaded a step ahead

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

__global__ void __launch_bounds__(NT, 1)
fused_exp_zoom_anchor_tc_kernel(
    const float* __restrict__ dphi,            // (B, ndir, n, ncols)
    long long sb, long long sd, long long sr,  // its strides
    const float* __restrict__ dl,              // (n, ncols)
    const __nv_bfloat16* __restrict__ a2hi,    // (nl, m2, n)
    const __nv_bfloat16* __restrict__ a2lo,
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
  const int nh = (t >> 5) & 1;       // and its n8 column fragment
  // [kg][hi, lo][TI][AP] A2 tiles, then [kg][hi, lo][KS][GP] G tiles
  __nv_bfloat16* as = reinterpret_cast<__nv_bfloat16*>(smem);
  __nv_bfloat16* gs = as + kg * 2 * A_TILE;

  const float ast = astar[g];
  const float* db = dphi + (size_t)b * sb;
  const float* cb = centre + (size_t)b * ndir;
  for (int q = t; q < KB * DMAX; q += NT) {
    const int w = q / DMAX, i = q % DMAX;
    cs[w][i] = (w < kg && i < deg1) ? coef[(size_t)(l0 + w) * deg1 + i] : 0.f;
  }

  // one step's A2 hi/lo tiles of every wavelength, rows [i0, i0 + TI) and
  // contraction rows [n0, n0 + KS) in 16-byte chunks, zeros outside
  auto stage = [&](int n0) {
    constexpr int CH = KS / 8;
    for (int q = t; q < kg * 2 * TI * CH; q += NT) {
      const int c = q % CH;
      const int row = q / CH % TI;
      const int part = q / (CH * TI) % 2;
      const int w = q / (CH * TI * 2);
      const int grow = i0 + row, gcol = n0 + c * 8;
      const bool ok = grow < m2 && gcol < n;
      const __nv_bfloat16* src =
          (part ? a2lo : a2hi) +
          (ok ? ((size_t)(l0 + w) * m2 + grow) * n + gcol : 0);
      cp_async16(smem_addr(as + (w * 2 + part) * A_TILE + row * AP + c * 8),
                 src, ok ? 16 : 0);
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

  // the centre values of the first DPRE directions, in registers
  float cen[DPRE];
#pragma unroll
  for (int d = 0; d < DPRE; ++d) cen[d] = d < ndir ? cb[d] : 0.f;

  // the group's G tiles of contraction rows [n0, n0 + KS): the power sums
  // of both elements of the thread, one exponential per direction, then
  // every wavelength's combination of them with its coefficients (three
  // float4 reads of shared memory a wavelength), split into bf16 hi/lo
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
          x[d] = __fmul_rn(ast, __fsub_rn(dv[e][d], cen[d]));
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
          const __nv_bfloat16 hi = __float2bfloat16_rn(v);
          const float hf = __bfloat162float(hi);
          const __nv_bfloat16 lo =
              __float2bfloat16_rn(isinf(hf) ? 0.f : v - hf);
          gs[(w * 2) * G_TILE + kk * GP + jj] = hi;
          gs[(w * 2 + 1) * G_TILE + kk * GP + jj] = lo;
        }
      }
    }
  };

  // live m16 fragments (rows below m2)
  const int mt_live = min(MT, max(0, (m2 - i0 + 15) / 16));
  // ldmatrix row addresses: A (row-major A2 tile) row lane % 16, column
  // (lane / 16) * 8; B (.trans of the [k][n] G tile) k = lane % 8 +
  // (lane / 8 % 2) * 8, n = (lane / 16) * 8
  const uint32_t a_base = smem_addr(as + l * 2 * A_TILE) +
                          ((lane & 15) * AP + (lane >> 4) * 8) * 2;
  const uint32_t g_base =
      smem_addr(gs + l * 2 * G_TILE) +
      (((lane & 7) + ((lane >> 3) & 1) * 8) * GP + (lane >> 4) * 8) * 2;

  float acc[MT][4];
#pragma unroll
  for (int mt = 0; mt < MT; ++mt)
#pragma unroll
    for (int e = 0; e < 4; ++e) acc[mt][e] = 0.f;

  float dv[GE][DPRE], dlv[GE];
  load_d(0, dv, dlv);
  __syncthreads();   // the coefficients
  for (int n0 = 0; n0 < n; n0 += KS) {
    stage(n0);
    build_g(n0, dv, dlv);
    if (n0 + KS < n) load_d(n0 + KS, dv, dlv);
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // A2 and G tiles of this step visible
    if (l < kg) {
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
            acc[mt][e] = __fadd_rn(acc[mt][e], part[e]);
        }
      }
    }
    __syncthreads();   // both tiles free for the next step
  }

  if (l >= kg) return;
  // accumulator fragment: rows lane / 4 and + 8, columns 2 (lane % 4), + 1
  float* ub = out + ((size_t)b * nl + l0 + l) * m2 * ncols;
  const int row0 = i0 + (lane >> 2);
  const int col = j0 + nh * 8 + 2 * (lane & 3);
#pragma unroll
  for (int mt = 0; mt < MT; ++mt) {
    store_pair(ub, row0 + mt * 16, col, m2, ncols, acc[mt][0], acc[mt][1]);
    store_pair(ub, row0 + mt * 16 + 8, col, m2, ncols, acc[mt][2],
               acc[mt][3]);
  }
}

}  // namespace

// Launches K6 at "high" on `stream`: u (B, nl, m2, ncols) from the
// wavelengths in groups of `group` (at most KB), deg1 = degree + 1 Taylor
// terms (at most DMAX); a2hi/a2lo are the bf16 split of A2 (nl, m2, n), n a
// multiple of 8.  Returns the first CUDA error (0 = launched).
extern "C" int muse_fused_exp_zoom_anchor_tc(
    const float* dphi, const float* dl, const void* a2hi, const void* a2lo,
    const float* centre, const float* astar, const float* coef, float* u,
    long long sb, long long sd, long long sr, int B, int ndir, int n,
    int ncols, int nl, int m2, int group, int deg1, void* stream) {
  if (group < 1 || group > KB || deg1 < 1 || deg1 > DMAX || n % 8)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = group * 2 * (A_TILE + G_TILE) * 2;
  cudaError_t err = cudaFuncSetAttribute(
      fused_exp_zoom_anchor_tc_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nib = (m2 + TI - 1) / TI;
  const int njt = (ncols + TJ - 1) / TJ;
  const int ng = (nl + group - 1) / group;
  const dim3 grid(njt * nib * ng, B);
  fused_exp_zoom_anchor_tc_kernel<<<grid, NT, smem,
                                    static_cast<cudaStream_t>(stream)>>>(
      dphi, sb, sd, sr, dl, static_cast<const __nv_bfloat16*>(a2hi),
      static_cast<const __nv_bfloat16*>(a2lo), centre, astar, coef, u, ndir,
      n, ncols, nl, m2, group, deg1, nib, ng);
  return static_cast<int>(cudaGetLastError());
}
