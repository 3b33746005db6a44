// The float32 FMA body of K6: anchored-Taylor damping x zoom-DFT stage 1,
// for Hopper.
//
// A yardstick, not part of the package: this body ran zoom_precision
// "highest" until the six-pass tensor-core body of
// muse_psfr_tpu_torch/csrc/zoom_anchor_tc.cu took its place.
// tools/ab_zoom_highest.py and chip_smoke.py build it into a library of
// their own and time it in turns with that body; nothing under
// muse_psfr_tpu_torch/ builds or launches it.
//
// Replaces muse_psfr_tpu/ops/zoom_dft.py:fused_exp_zoom_anchor (body
// _kernel_anchor).  Per telemetry row b and wavelength group g (group
// consecutive wavelengths, anchor astar[g], the midpoint of their alphas)
// it computes
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
// D (a second 1.56 GB at 44 rows of the full window) is never made.
//
// Design: a block owns one (row, group, 32-column tile) and all 160
// output rows, so the power sums of its tile are built once and serve
// every wavelength of the group.  It keeps the group's accumulators, KB x
// (160 x 32), in registers: 5 x 4 outputs of each wavelength per thread,
// 256 threads, one block per SM.  Per 32-row step it first starts
// asynchronous copies (cp.async) of every wavelength's A2 tile into shared
// memory, then builds the group's G tiles straight from D while they land
// (the power sums stay in registers), waits once, and contracts each
// wavelength.  On the TPU the power sums were VMEM scratch rewritten on
// every direction step; here they never leave registers.  The coefficients
// are read from shared memory where they are used: held in registers next
// to the accumulators they made the kernel spill.
//
// What bounds it: fp32 arithmetic.  At a 44-row full-window chunk (ndir
// 9, 35 wavelengths in 5 groups, N = 1280, ncols = 768) the contraction
// is 484 GFLOP (7.2 ms at the 67 TFLOP/s fp32 CUDA-core peak), the power
// sums and combinations ~70 GFLOP and 1.95 G exponentials (K1: 13.6 G),
// against 2.3 GB of traffic (0.7 ms at 3.35 TB/s).  What limits this
// version is occupancy (8 warps per SM, set by the register-held
// accumulators: ~218 registers a thread), plain fp32 FMAs from shared
// memory and A2 tiles copied by 4-byte cp.async: 4.70 ms at 4 rows x 35
// wavelengths x 9 directions, where the six-pass tensor-core body takes
// 2.93 ms (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py).
//
// Grid: (32-column tiles x 160-row output blocks, groups, rows).  The last
// group may hold fewer wavelengths; a block skips the missing ones.

#include <cuda_runtime.h>

namespace {

constexpr int KB = 8;           // most wavelengths per group
constexpr int DMAX = 12;        // most Taylor terms (degree + 1)
constexpr int TJ = 32;          // output columns per block
constexpr int TK = 32;          // contraction rows per step
constexpr int TI = 160;         // output rows per block (2M at dimpsf = 40)
constexpr int RX = 4;           // columns per thread
constexpr int RY = 5;           // rows per thread
constexpr int NTX = TJ / RX;    // 8
constexpr int NT = NTX * (TI / RY);   // 256 threads
constexpr int AS = TI + 1;      // +1: conflict-free transposed stores
constexpr int SMEM = KB * TK * (TJ + AS) * (int)sizeof(float);

// 4-byte asynchronous copy from global to shared memory; zero-filled (and
// src not read) when !ok
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool ok) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(ok ? 4 : 0));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::);
}

__global__ void __launch_bounds__(NT, 1)
fused_exp_zoom_anchor_kernel(
    const float* __restrict__ dphi,            // (B, ndir, n, ncols)
    long long sb, long long sd, long long sr,  // its strides
    const float* __restrict__ dl,              // (n, ncols)
    const float* __restrict__ a2,              // (nl, m2, n)
    const float* __restrict__ centre,          // (B, ndir)
    const float* __restrict__ astar,           // (groups,)
    const float* __restrict__ coef,            // (nl, deg1)
    float* __restrict__ out,                   // (B, nl, m2, ncols)
    int ndir, int n, int ncols, int nl, int m2, int group, int deg1,
    int nib) {
  extern __shared__ __align__(16) float smem[];
  float* gs = smem;                  // [KB][TK][TJ]: the group's G tiles
  float* as = smem + KB * TK * TJ;   // [KB][TK][AS]: their A2 tiles
  __shared__ float cs[KB][DMAX];     // the group's coefficients

  const int jt = blockIdx.x / nib;
  const int ib = blockIdx.x % nib;
  const int g = blockIdx.y;
  const int b = blockIdx.z;
  const int l0 = g * group;
  const int kg = min(group, nl - l0);
  const int j0 = jt * TJ;
  const int i0 = ib * TI;
  const int t = threadIdx.x;
  const int tx = t % NTX;
  const int ty = t / NTX;

  const float ast = astar[g];
  const float* db = dphi + (size_t)b * sb;
  const float* cb = centre + (size_t)b * ndir;
  for (int q = t; q < KB * DMAX; q += NT) {
    const int l = q / DMAX, i = q % DMAX;
    cs[l][i] = (l < kg && i < deg1) ? coef[(size_t)(l0 + l) * deg1 + i] : 0.f;
  }
  __syncthreads();

  float acc[KB][RY][RX];
#pragma unroll
  for (int l = 0; l < KB; ++l)
#pragma unroll
    for (int r = 0; r < RY; ++r)
#pragma unroll
      for (int c = 0; c < RX; ++c) acc[l][r][c] = 0.f;

  for (int n0 = 0; n0 < n; n0 += TK) {
    // every wavelength's A2 tile for rows n0..n0+TK, transposed to
    // (TK, TI), copied while the G tiles are built
    for (int l = 0; l < kg; ++l) {
      const float* al2 = a2 + (size_t)(l0 + l) * m2 * n;
      float* asl = as + l * TK * AS;
      for (int q = t; q < TK * TI; q += NT) {
        const int ii = q / TK, kk = q % TK;
        const int row = i0 + ii, col = n0 + kk;
        const bool ok = row < m2 && col < n;
        cp_async4(&asl[kk * AS + ii], ok ? al2 + (size_t)row * n + col : al2,
                  ok);
      }
    }
    cp_async_commit();
    // the group's G tiles, from one exp per direction
    for (int q = t; q < TK * TJ; q += NT) {
      const int kk = q / TJ, jj = q % TJ;
      const int row = n0 + kk, col = j0 + jj;
      float hs[DMAX];
#pragma unroll
      for (int i = 0; i < DMAX; ++i) hs[i] = 0.f;
      float dv = 0.f;
      if (row < n && col < ncols) {
        const float* dp = db + (size_t)row * sr + col;
        for (int d = 0; d < ndir; ++d) {
          const float x = ast * (dp[(size_t)d * sd] - cb[d]);
          float f = expf(x);
#pragma unroll
          for (int i = 0; i < DMAX; ++i) {
            if (i < deg1) {
              hs[i] += f;
              f *= x;
            }
          }
        }
        dv = dl[(size_t)row * ncols + col];
      }
#pragma unroll
      for (int l = 0; l < KB; ++l) {
        if (l < kg) {
          const volatile float* cl = cs[l];   // read here, not hoisted
          float gv = cl[0] * hs[0];
#pragma unroll
          for (int i = 1; i < DMAX; ++i)
            if (i < deg1) gv = fmaf(cl[i], hs[i], gv);
          gs[(l * TK + kk) * TJ + jj] = gv * dv;
        }
      }
    }
    cp_async_wait_all();
    __syncthreads();
#pragma unroll
    for (int l = 0; l < KB; ++l) {
      if (l < kg) {
        const float* gl = gs + l * TK * TJ;
        const float* asl = as + l * TK * AS;
#pragma unroll 4
        for (int kk = 0; kk < TK; ++kk) {
          const float4 g4 =
              *reinterpret_cast<const float4*>(&gl[kk * TJ + tx * RX]);
          const float gv[RX] = {g4.x, g4.y, g4.z, g4.w};
          float av[RY];
#pragma unroll
          for (int r = 0; r < RY; ++r) av[r] = asl[kk * AS + ty * RY + r];
#pragma unroll
          for (int r = 0; r < RY; ++r)
#pragma unroll
            for (int c = 0; c < RX; ++c)
              acc[l][r][c] = fmaf(av[r], gv[c], acc[l][r][c]);
        }
      }
    }
    __syncthreads();   // both tiles free for the next step
  }

#pragma unroll
  for (int l = 0; l < KB; ++l) {
    if (l >= kg) continue;
    float* ub = out + ((size_t)b * nl + l0 + l) * m2 * ncols;
#pragma unroll
    for (int r = 0; r < RY; ++r) {
      const int row = i0 + ty * RY + r;
      if (row >= m2) continue;
#pragma unroll
      for (int c = 0; c < RX; ++c) {
        const int col = j0 + tx * RX + c;
        if (col < ncols) ub[(size_t)row * ncols + col] = acc[l][r][c];
      }
    }
  }
}

}  // namespace

// Launches K6 on `stream`: u (B, nl, m2, ncols) from the wavelengths in
// groups of `group` (at most KB), deg1 = degree + 1 Taylor terms (at most
// DMAX); returns the first CUDA error (0 = launched).
extern "C" int muse_fused_exp_zoom_anchor(
    const float* dphi, const float* dl, const float* a2, const float* centre,
    const float* astar, const float* coef, float* u, long long sb,
    long long sd, long long sr, int B, int ndir, int n, int ncols, int nl,
    int m2, int group, int deg1, void* stream) {
  if (group < 1 || group > KB || deg1 < 1 || deg1 > DMAX)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaError_t err = cudaFuncSetAttribute(
      fused_exp_zoom_anchor_kernel,
      cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int nib = (m2 + TI - 1) / TI;
  const int njt = (ncols + TJ - 1) / TJ;
  const int groups = (nl + group - 1) / group;
  const dim3 grid(njt * nib, groups, B);
  fused_exp_zoom_anchor_kernel<<<grid, NT, SMEM,
                                 static_cast<cudaStream_t>(stream)>>>(
      dphi, sb, sd, sr, dl, a2, centre, astar, coef, u, ndir, n, ncols, nl,
      m2, group, deg1, nib);
  return static_cast<int>(cudaGetLastError());
}
