// Two passes around K1/K3/K5 (zoom_dft_tc.cu): the split of A2 into the
// bf16 parts its products read, and K3's ordered sum of the row slices'
// partial products.
//
// The split replaces the bf16 casts of muse_psfr_tpu/ops/zoom_dft.py:
// _mxu_contract for A2, once per launch: parts p0 = bf16(x), p1 = bf16(x -
// p0), p2 = bf16(x - p0 - p1) (round to nearest even; later parts 0 where
// p0 is infinite), the plain version being ops/zoom_dft.py:split_bf16, bit
// for bit, padded with zeros to a row length the TMA boxes take.  One
// launch in place of the dozen elementwise ones of the plain version.
// What bounds it: bytes (4 in, 2 per part out per value).
//
// The ordered sum replaces the accumulation of muse_psfr_tpu/ops/zoom_dft.py:_kernel_rowacc
// (K3), which on the TPU ran its row slices in sequence into a
// VMEM-resident output block, to fit VMEM.  Here the slices of
// fused_exp_zoom_wg_kernel (zoom_dft_tc.cu, both settings of
// zoom_precision) run in parallel, to give a launch of one or a few rows
// enough blocks to fill the 132 SMs (otf/psf.py:_zoom_row_splits); each
// writes its partial (160 x 64 or 128) products to workspace slab r of shape
// (B, nl, m2, ncols), and this kernel adds the R slabs in the fixed order
// r = 0..R-1 (no atomics, so reruns are bit-identical).  What bounds it:
// bytes, R + 1 passes over the output.
//
// The float32 FMA body of K1/K3/K5 that this file held (zoom_precision
// "highest" until the six-pass tensor-core body took its place) is kept
// as tools/fma_bodies/zoom_dft_fma.cu, the yardstick of
// tools/ab_zoom_highest.py; nothing in the package builds or launches it.

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int NT = 256;       // threads per block

// u[i] = ((ws[0][i] + ws[1][i]) + ...) + ws[R-1][i], in that order
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

// parts[p][row][c] of x[row][c] (zero for c >= n), rows of n_pad values
__global__ void split_bf16(const float* __restrict__ x,
                           __nv_bfloat16* __restrict__ p0,
                           __nv_bfloat16* __restrict__ p1,
                           __nv_bfloat16* __restrict__ p2, long long total,
                           int n, int n_pad) {
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < total; i += (long long)gridDim.x * blockDim.x) {
    const long long row = i / n_pad;
    const int c = static_cast<int>(i - row * n_pad);
    const float v = c < n ? x[row * n + c] : 0.f;
    const __nv_bfloat16 h0 = __float2bfloat16_rn(v);
    const float f0 = __bfloat162float(h0);
    const float r = isinf(f0) ? 0.f : __fsub_rn(v, f0);
    const __nv_bfloat16 h1 = __float2bfloat16_rn(r);
    p0[i] = h0;
    p1[i] = h1;
    if (p2 != nullptr)
      p2[i] = __float2bfloat16_rn(__fsub_rn(r, __bfloat162float(h1)));
  }
}

}  // namespace

// The bf16 parts of the (rows, n) float32 matrix x into p0, p1 and, when
// not null, p2, each (rows, n_pad), zero past column n; returns
// cudaGetLastError().
extern "C" int muse_split_bf16(const float* x, void* p0, void* p1, void* p2,
                               long long rows, int n, int n_pad,
                               void* stream) {
  const long long total = rows * n_pad;
  const long long want = (total + NT - 1) / NT;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  split_bf16<<<blocks > 0 ? blocks : 1, NT, 0,
               static_cast<cudaStream_t>(stream)>>>(
      x, static_cast<__nv_bfloat16*>(p0), static_cast<__nv_bfloat16*>(p1),
      static_cast<__nv_bfloat16*>(p2), total, n, n_pad);
  return static_cast<int>(cudaGetLastError());
}

// K3's ordered sum of R partial slabs of `total` floats; returns
// cudaGetLastError().
extern "C" int muse_sum_row_slices(const float* ws, float* u, long long total,
                                   int R, void* stream) {
  const long long want = (total + NT - 1) / NT;
  const int blocks = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  sum_row_slices<<<blocks, NT, 0, static_cast<cudaStream_t>(stream)>>>(
      ws, u, total, R);
  return static_cast<int>(cudaGetLastError());
}
