// The float32 FMA body of K1, K3 and K5: fused direction-averaged system
// OTF x zoom-DFT stage 1, for Hopper.
//
// A yardstick, not part of the package: this body ran zoom_precision
// "highest" until the six-pass tensor-core body of
// muse_psfr_tpu_torch/csrc/zoom_dft_tc.cu took its place.
// tools/ab_zoom_highest.py and chip_smoke.py build it into a library of
// their own and time it in turns with that body; nothing under
// muse_psfr_tpu_torch/ builds or launches it.
//
// Replaces muse_psfr_tpu/ops/zoom_dft.py:fused_exp_zoom with its bodies
// _kernel_dirfull (K1), _kernel and _kernel_dirblock (K1', K4: the same
// function with the directions summed over VMEM grid steps; here every
// element of the G tile sums all ndir directions in registers before it
// reaches shared memory, which is what those bodies compute for any
// dir_block) and _kernel_rowacc (K3).  Per telemetry row b and wavelength
// l it computes
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
// card's fp32 ridge.  This body is the simple one: plain fp32 FMAs from
// shared-memory tiles, a (160 x 64) accumulator tile spread over 256
// threads' registers (10 x 4 each), one running float32 sum over all
// contraction rows.  That is not what the JAX package computes at
// "highest" (Precision.HIGHEST: six bf16 passes on the matrix unit), and
// the running sum leaves it 6.6e-06 of max|U| from float64 on the worst
// row of a full-window chunk, where the six-pass body lies 3.7e-07
// (NVIDIA H100 80GB HBM3, 700.00 W, chip_smoke.py).
//
// Grid: (column tiles x output-row blocks x row slices, wavelengths,
// rows).  The damping is exp(alpha*D)*w, or with use_exp2 != 0
// exp2(alpha*D + w), where the caller passed alpha*log2(e) and log2(w)
// (cfg.zoom_exp2).  D may be a strided view (the blue sub-window of a
// structure function): the kernel takes its row, direction and batch
// strides; its columns are contiguous.
//
// K3 (row_splits R > 1): the block of row slice r contracts only rows
// [r*n/R, (r+1)*n/R) with the same tile loop and writes its partial
// (160 x 64) product to a workspace slab r of shape (B, nl, m2, ncols);
// sum_row_slices then adds the R slabs in the fixed order r = 0..R-1
// (no atomics, so reruns are bit-identical).  On the TPU the slices ran
// in sequence into a VMEM-resident output block, to fit VMEM; here they
// run in parallel, to give a launch of one or a few rows enough blocks
// to fill the 132 SMs (otf/psf.py:_zoom_row_splits).
//
// K5 (live != nullptr; replaces zoom_dft.py:fused_exp_zoom_disc): the
// same body, given a table of live contraction rows [lo, hi) per 64-column
// tile, derived on the host from the diffraction OTF's 128 x 128 block mask
// (otf/psf.py:_disc_block_mask).  Each block loops only over the live rows
// of its tile, intersected with its row slice, so the dead corner blocks of
// the full window cost neither exponentials nor FMAs (6 of 60 blocks at
// dim 1280, 10% of the work).  The TPU split the columns into groups, one
// launch each, and concatenated; here it is one launch and no copy, and a
// block with no live rows in its slice writes zeros.  What bounds it is what
// bounds K1, on 10% less work.

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
                      long long sb, long long sd, long long sr,  // its strides
                      const float* __restrict__ dl,     // (n, ncols)
                      const float* __restrict__ a2,     // (nl, m2, n)
                      const float* __restrict__ alpha,  // (nl,)
                      const float* __restrict__ w,      // (B, nl, ndir)
                      const int* __restrict__ live,     // (ncols/TJ, 2)
                      float* __restrict__ out,  // (R, B, nl, m2, ncols)
                      int B, int ndir, int n, int ncols, int nl, int m2,
                      int use_exp2, int nib, int R) {
  __shared__ __align__(16) float gs[TK][TJ];
  __shared__ float as[TK][TI + 1];   // +1: conflict-free transposed stores

  const int r = blockIdx.x % R;
  const int jt = blockIdx.x / R / nib;
  const int ib = blockIdx.x / R % nib;
  const int l = blockIdx.y;
  const int b = blockIdx.z;
  const int j0 = jt * TJ;
  const int i0 = ib * TI;
  const int t = threadIdx.x;
  const int tx = t % 16;
  const int ty = t / 16;
  const int h = n / R;               // rows of this slice: [r*h, (r+1)*h)
  int n_lo = r * h, n_hi = n_lo + h;
  if (live != nullptr) {             // K5: only the tile's live rows
    n_lo = max(n_lo, live[2 * jt]);
    n_hi = min(n_hi, live[2 * jt + 1]);
  }

  const float al = alpha[l];
  const float* wl = w + ((size_t)b * nl + l) * ndir;
  const float* db = dphi + (size_t)b * sb;
  const float* al2 = a2 + (size_t)l * m2 * n;

  float acc[RY][RX];
#pragma unroll
  for (int r = 0; r < RY; ++r)
#pragma unroll
    for (int c = 0; c < RX; ++c) acc[r][c] = 0.f;

  for (int n0 = n_lo; n0 < n_hi; n0 += TK) {
    // G tile: the direction-averaged, damped OTF for rows n0..n0+TK
    for (int q = t; q < TK * TJ; q += NT) {
      const int kk = q / TJ, jj = q % TJ;
      const int row = n0 + kk, col = j0 + jj;
      float g = 0.f;
      if (row < n_hi && col < ncols) {
        const float* dp = db + (size_t)row * sr + col;
        for (int d = 0; d < ndir; ++d) {
          const float x = dp[(size_t)d * sd];
          g += use_exp2 ? exp2f(al * x + wl[d]) : expf(al * x) * wl[d];
        }
        g *= dl[(size_t)row * ncols + col];
      }
      gs[kk][jj] = g;
    }
    // matching A2 tile, transposed to (TK, TI)
    for (int q = t; q < TK * TI; q += NT) {
      const int ii = q / TK, kk = q % TK;
      const int row = i0 + ii, col = n0 + kk;
      as[kk][ii] =
          (row < m2 && col < n_hi) ? al2[(size_t)row * n + col] : 0.f;
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

  float* ub = out + (((size_t)r * B + b) * nl + l) * m2 * ncols;
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

// K3's second pass: u[i] = ((ws[0][i] + ws[1][i]) + ...) + ws[R-1][i],
// in that order.
__global__ void sum_row_slices(const float* __restrict__ ws,  // (R, total)
                               float* __restrict__ u, long long total,
                               int R) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    float s = ws[i];
    for (int r = 1; r < R; ++r) s += ws[(size_t)r * total + i];
    u[i] = s;
  }
}

}  // namespace

// K3's ordered sum of R partial slabs of `total` floats, also used by the
// tensor-core body (zoom_dft_tc.cu); returns cudaGetLastError().
extern "C" int muse_sum_row_slices(const float* ws, float* u, long long total,
                                   int R, void* stream) {
  const long long want = (total + NT - 1) / NT;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  sum_row_slices<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      ws, u, total, R);
  return static_cast<int>(cudaGetLastError());
}

// Launches K1 (row_splits == 1: writes u, ws is unused) or K3 (the R row
// slices into the workspace ws of R * B * nl * m2 * ncols floats, then
// their ordered sum into u) on `stream`, with K5's table of live rows per
// column tile when `live` is not null; returns cudaGetLastError() (0 =
// launched).
extern "C" int muse_fused_exp_zoom(const float* dphi, const float* dl,
                                   const float* a2, const float* alpha,
                                   const float* w, const int* live,
                                   float* ws, float* u,
                                   long long sb, long long sd, long long sr,
                                   int B, int ndir, int n, int ncols, int nl,
                                   int m2, int row_splits, int use_exp2,
                                   void* stream) {
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int R = row_splits;
  const int nib = (m2 + TI - 1) / TI;
  const int njt = (ncols + TJ - 1) / TJ;
  const dim3 grid(njt * nib * R, nl, B);
  fused_exp_zoom_kernel<<<grid, NT, 0, st>>>(
      dphi, sb, sd, sr, dl, a2, alpha, w, live, R > 1 ? ws : u, B, ndir, n,
      ncols, nl, m2, use_exp2, nib, R);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || R == 1) return static_cast<int>(err);
  const long long total = (long long)B * nl * m2 * ncols;
  const long long want = (total + NT - 1) / NT;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  sum_row_slices<<<blocks, NT, 0, st>>>(ws, u, total, R);
  return static_cast<int>(cudaGetLastError());
}
