// K2: fused final-PSF convolution chain, for Hopper.
//
// Replaces muse_psfr_tpu/ops/conv_dft.py:fused_conv_chain (body _kernel /
// _conv_pack).  One block per (row b, wavelength plane p) runs both 'same'
// linear convolutions of the (n x n) PSF plane as trimmed circular DFTs at
// the alias-free size L (64 at dimpsf = 40): the tip-tilt Moffat of row b,
// then the MUSE-intrinsic Moffat of plane p.  The whole chain (forward
// transform over the n nonzero rows/columns, spectrum product, inverse
// restricted to the 'same' window, and again) stays in shared memory; only
// the input plane is read and the final (n x n) plane written.
//
// What bounds it: per plane ~6.9 MFLOP of small (<= 64-deep) contractions
// against 12.8 KB of plane traffic, so arithmetic and shared-memory
// bandwidth, not device memory.  The transform matrices (80 KB) are read
// by every block through the cache.  Plain fp32 FMAs; no lane packing
// (the TPU kernel's pack is a vector-register layout choice).
//
// Shared memory: x (n*n) + a/b then aa/bb (2*L*n) + hr/hi (2*L*L) floats,
// 59.6 KB at n = 40, L = 64 -- above the 48 KB default, so the entry point
// raises the kernel's dynamic shared-memory limit first.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;

// One 'same' convolution of the plane in x (n x n, overwritten with the
// result).  Matrices as in _trimmed_mats with pack = 1:
//   csn (2L, n) = [C; S][:, :n]     crc/crs (n, L) = C/S[:n, :]
//   csel (2n, L) = [C; S][off:off+n, :]   cdc/cds (L, n) = C/S[:, off:off+n]
__device__ void conv_same(float* x, const float* __restrict__ gr,
                          const float* __restrict__ gi,
                          const float* __restrict__ csn,
                          const float* __restrict__ crc,
                          const float* __restrict__ crs,
                          const float* __restrict__ csel,
                          const float* __restrict__ cdc,
                          const float* __restrict__ cds, float* ab, float* h,
                          int n, int L) {
  const int tid = threadIdx.x;
  // [A; B] = [C; S][:, :n] @ x                                   (2L, n)
  for (int e = tid; e < 2 * L * n; e += NT) {
    const int r = e / n, c = e % n;
    const float* row = csn + (size_t)r * n;
    float acc = 0.f;
    for (int k = 0; k < n; ++k) acc = fmaf(row[k], x[k * n + c], acc);
    ab[e] = acc;
  }
  __syncthreads();
  // F = A CRc - B CRs - i (A CRs + B CRc);  H = F * G            (L, L)
  const float* a = ab;
  const float* bm = ab + L * n;
  for (int e = tid; e < L * L; e += NT) {
    const int r = e / L, c = e % L;
    float ac = 0.f, bs = 0.f, as = 0.f, bc = 0.f;
    for (int k = 0; k < n; ++k) {
      const float av = a[r * n + k], bv = bm[r * n + k];
      const float cv = crc[k * L + c], sv = crs[k * L + c];
      ac = fmaf(av, cv, ac);
      bs = fmaf(bv, sv, bs);
      as = fmaf(av, sv, as);
      bc = fmaf(bv, cv, bc);
    }
    const float fr = ac - bs, fi = -(as + bc);
    const float g_r = gr[e], g_i = gi[e];
    h[e] = fr * g_r - fi * g_i;
    h[L * L + e] = fr * g_i + fi * g_r;
  }
  __syncthreads();
  // inverse rows restricted to the 'same' window                  (n, L)
  const float* hr = h;
  const float* hi = h + L * L;
  float* aa = ab;
  float* bb = ab + n * L;
  for (int e = tid; e < n * L; e += NT) {
    const int r = e / L, c = e % L;
    const float* top = csel + (size_t)r * L;
    const float* bot = csel + (size_t)(n + r) * L;
    float ut = 0.f, vb = 0.f, vt = 0.f, ub = 0.f;
    for (int k = 0; k < L; ++k) {
      const float hrv = hr[k * L + c], hiv = hi[k * L + c];
      ut = fmaf(top[k], hrv, ut);
      vb = fmaf(bot[k], hiv, vb);
      vt = fmaf(top[k], hiv, vt);
      ub = fmaf(bot[k], hrv, ub);
    }
    aa[e] = ut - vb;
    bb[e] = vt + ub;
  }
  __syncthreads();
  // inverse columns restricted to the window, / L^2                (n, n)
  const float inv_l2 = 1.0f / (float)(L * L);
  for (int e = tid; e < n * n; e += NT) {
    const int r = e / n, c = e % n;
    float p = 0.f, q = 0.f;
    for (int k = 0; k < L; ++k) {
      p = fmaf(aa[r * L + k], cdc[k * n + c], p);
      q = fmaf(bb[r * L + k], cds[k * n + c], q);
    }
    x[e] = (p - q) * inv_l2;
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT)
fused_conv_chain_kernel(const float* __restrict__ planes,  // (B, nl, n, n)
                        const float* __restrict__ gtt_r,   // (B, L, L)
                        const float* __restrict__ gtt_i,
                        const float* __restrict__ gi_r,    // (nl, L, L)
                        const float* __restrict__ gi_i,
                        const float* __restrict__ csn,
                        const float* __restrict__ crc,
                        const float* __restrict__ crs,
                        const float* __restrict__ csel,
                        const float* __restrict__ cdc,
                        const float* __restrict__ cds,
                        float* __restrict__ out,            // (B, nl, n, n)
                        int nl, int n, int L) {
  extern __shared__ float smem[];
  float* x = smem;                 // n * n
  float* ab = x + n * n;           // 2 * L * n
  float* h = ab + 2 * L * n;       // 2 * L * L
  const int p = blockIdx.x, b = blockIdx.y;
  const size_t plane = ((size_t)b * nl + p) * n * n;
  for (int e = threadIdx.x; e < n * n; e += NT) x[e] = planes[plane + e];
  __syncthreads();
  const size_t gtt = (size_t)b * L * L, gpl = (size_t)p * L * L;
  conv_same(x, gtt_r + gtt, gtt_i + gtt, csn, crc, crs, csel, cdc, cds, ab,
            h, n, L);
  conv_same(x, gi_r + gpl, gi_i + gpl, csn, crc, crs, csel, cdc, cds, ab, h,
            n, L);
  for (int e = threadIdx.x; e < n * n; e += NT) out[plane + e] = x[e];
}

}  // namespace

// Launches K2 on `stream`; returns the first CUDA error (0 = launched).
extern "C" int muse_fused_conv_chain(const float* planes, const float* gtt_r,
                                     const float* gtt_i, const float* gi_r,
                                     const float* gi_i, const float* csn,
                                     const float* crc, const float* crs,
                                     const float* csel, const float* cdc,
                                     const float* cds, float* out, int B,
                                     int nl, int n, int L, void* stream) {
  const int smem = (n * n + 2 * L * n + 2 * L * L) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_conv_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(nl, B);
  fused_conv_chain_kernel<<<grid, NT, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      planes, gtt_r, gtt_i, gi_r, gi_i, csn, crc, crs, csel, cdc, cds, out,
      nl, n, L);
  return static_cast<int>(cudaGetLastError());
}
