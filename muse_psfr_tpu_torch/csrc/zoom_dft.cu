// K1: fused direction-averaged system OTF x zoom-DFT stage 1, for Hopper.
//
// Replaces muse_psfr_tpu/ops/zoom_dft.py:fused_exp_zoom with its
// single-step body _kernel_dirfull (the ndir=1 main path).  Per telemetry
// row b and wavelength l it computes
//
//     G[n, j] = sum_d exp(alpha_l * D[b, d, n, j]) * w[b, l, d] * dl[n, j]
//     U[b, l] = A2_l @ G                       (2M x N) @ (N x ncols)
//
// and G never reaches device memory: each block builds the (TK x TJ) tile
// of G it is about to contract in shared memory, straight from D.
//
// What bounds it: fp32 arithmetic.  At the production shape (2M = 160,
// N = 1280, ncols = 768 under the symmetry fold, 35 wavelengths) one row
// is 2*35*160*1280*768 = 11 GFLOP of contraction against ~140 MB of D
// re-read (35 wavelengths x 3.9 MB) -- ~80 FLOP per byte, above the
// card's fp32 ridge.  This first version is the simple one: plain fp32
// FMAs from shared-memory tiles, a (160 x 64) accumulator tile spread over
// 256 threads' registers (10 x 4 each).  True fp32 meets both TPU
// settings of the contraction (zoom_precision "highest" and the 3-pass
// "high").  Tensor cores (wgmma with a 3-pass bf16/tf32 split, the
// analogue of "high") and TMA staging are later work.
//
// Grid: (column tiles x output-row blocks, wavelengths, rows).  The
// damping is exp(alpha*D)*w, or with use_exp2 != 0 exp2(alpha*D + w),
// where the caller passed alpha*log2(e) and log2(w) (cfg.zoom_exp2).

#include <cuda_runtime.h>

namespace {

constexpr int TJ = 64;        // output columns per block
constexpr int TK = 32;        // contraction rows per step
constexpr int TI = 160;       // output rows per block (2M at dimpsf = 40)
constexpr int NT = 256;       // threads per block: 16 (cols) x 16 (rows)
constexpr int RX = TJ / 16;   // columns per thread
constexpr int RY = TI / 16;   // rows per thread

__global__ void __launch_bounds__(NT)
fused_exp_zoom_kernel(const float* __restrict__ dphi,   // (B, ndir, n, ncols)
                      const float* __restrict__ dl,     // (n, ncols)
                      const float* __restrict__ a2,     // (nl, m2, n)
                      const float* __restrict__ alpha,  // (nl,)
                      const float* __restrict__ w,      // (B, nl, ndir)
                      float* __restrict__ u,            // (B, nl, m2, ncols)
                      int ndir, int n, int ncols, int nl, int m2,
                      int use_exp2, int nib) {
  __shared__ __align__(16) float gs[TK][TJ];
  __shared__ float as[TK][TI + 1];   // +1: conflict-free transposed stores

  const int jt = blockIdx.x / nib;
  const int ib = blockIdx.x % nib;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = jt * TJ;
  const int i0 = ib * TI;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;

  const float al = alpha[l];
  const float* wl = w + ((size_t)b * nl + l) * ndir;
  const size_t dstride = (size_t)n * ncols;
  const float* db = dphi + (size_t)b * ndir * dstride;
  const float* al2 = a2 + (size_t)l * m2 * n;

  float acc[RY][RX];
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int c = 0; c < RX; ++c) acc[r][c] = 0.f;

  for (int n0 = 0; n0 < n; n0 += TK) {
    // G tile: the direction-averaged, damped OTF for rows n0..n0+TK
    for (int q = t; q < TK * TJ; q += NT) {
      const int kk = q / TJ, jj = q % TJ;
      const int row = n0 + kk, col = j0 + jj;
      float g = 0.f;
      if (row < n && col < ncols) {
        const size_t off = (size_t)row * ncols + col;
        for (int d = 0; d < ndir; ++d) {
          const float x = db[d * dstride + off];
          g += use_exp2 ? exp2f(al * x + wl[d]) : expf(al * x) * wl[d];
        }
        g *= dl[off];
      }
      gs[kk][jj] = g;
    }
    // matching A2 tile, transposed to (TK, TI)
    for (int q = t; q < TK * TI; q += NT) {
      const int ii = q / TK, kk = q % TK;
      const int row = i0 + ii, col = n0 + kk;
      as[kk][ii] = (row < m2 && col < n) ? al2[(size_t)row * n + col] : 0.f;
    }
    __syncthreads();
#pragma unroll 4
    for (int kk = 0; kk < TK; ++kk) {
      const float4 g4 = *reinterpret_cast<const float4*>(&gs[kk][tx * RX]);
      const float gv[RX] = {g4.x, g4.y, g4.z, g4.w};
      float av[RY];
#pragma unroll
      for (int r = 0; r < RY; ++r) av[r] = as[kk][ty * RY + r];
#pragma unroll
      for (int r = 0; r < RY; ++r)
#pragma unroll
        for (int c = 0; c < RX; ++c) acc[r][c] = fmaf(av[r], gv[c], acc[r][c]);
    }
    __syncthreads();
  }

  float* ub = u + ((size_t)b * nl + l) * m2 * ncols;
#pragma unroll
  for (int r = 0; r < RY; ++r) {
    const int row = i0 + ty * RY + r;
    if (row >= m2) continue;
#pragma unroll
    for (int c = 0; c < RX; ++c) {
      const int col = j0 + tx * RX + c;
      if (col < ncols) ub[(size_t)row * ncols + col] = acc[r][c];
    }
  }
}

}  // namespace

// Launches K1 on `stream`; returns cudaGetLastError() (0 = launched).
extern "C" int muse_fused_exp_zoom(const float* dphi, const float* dl,
                                   const float* a2, const float* alpha,
                                   const float* w, float* u, int B, int ndir,
                                   int n, int ncols, int nl, int m2,
                                   int use_exp2, void* stream) {
  const int nib = (m2 + TI - 1) / TI;
  const int njt = (ncols + TJ - 1) / TJ;
  const dim3 grid(njt * nib, nl, B);
  fused_exp_zoom_kernel<<<grid, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      dphi, dl, a2, alpha, w, u, ndir, n, ncols, nl, m2, use_exp2, nib);
  return static_cast<int>(cudaGetLastError());
}
