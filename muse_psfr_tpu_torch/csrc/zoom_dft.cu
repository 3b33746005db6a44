// K3's second pass: the ordered sum of the row slices' partial products.
//
// Replaces the accumulation of muse_psfr_tpu/ops/zoom_dft.py:_kernel_rowacc
// (K3), which on the TPU ran its row slices in sequence into a
// VMEM-resident output block, to fit VMEM.  Here the slices of
// fused_exp_zoom_tc_kernel (zoom_dft_tc.cu, both settings of
// zoom_precision) run in parallel, to give a launch of one or a few rows
// enough blocks to fill the 132 SMs (otf/psf.py:_zoom_row_splits); each
// writes its partial (160 x 64) products to workspace slab r of shape
// (B, nl, m2, ncols), and this kernel adds the R slabs in the fixed order
// r = 0..R-1 (no atomics, so reruns are bit-identical).  What bounds it:
// bytes, R + 1 passes over the output.
//
// The float32 FMA body of K1/K3/K5 that this file held (zoom_precision
// "highest" until the six-pass tensor-core body took its place) is kept
// as tools/fma_bodies/zoom_dft_fma.cu, the yardstick of
// tools/ab_zoom_highest.py; nothing in the package builds or launches it.

#include <cuda_runtime.h>

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

}  // namespace

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
