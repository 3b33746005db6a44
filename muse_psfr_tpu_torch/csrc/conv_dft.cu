// K2: fused final-PSF convolution chain, for Hopper.
//
// Replaces muse_psfr_tpu/ops/conv_dft.py:fused_conv_chain (body _kernel /
// _conv_pack).  Every (n x n) PSF plane of a (row b, plane p) pair goes
// through two 'same' linear convolutions, each a trimmed circular DFT at
// the alias-free size L (64 at dimpsf = 40): the tip-tilt Moffat of row b,
// then the MUSE-intrinsic Moffat of plane p.  One convolution, with
// W = C - iS the symmetric DFT matrix of size L and off = (n_ker - 1) / 2:
//
//   S1  A = C[:, :n] X,  B = S[:, :n] X                        (L x n)
//   S2  F = (A - iB) W[:n, :] ,  H = F * G                      (L x L)
//   S3  a + ib = conj(W)[off:off+n, :] H                        (n x L)
//   S4  Y = Re((a + ib) conj(W)[:, off:off+n]) / L^2            (n x n)
//
// the operations of fused_conv_chain_reference (ops/conv_dft.py) up to the
// order of the float32 sums.  The whole chain stays in shared memory: only
// the input plane and the spectra are read and the final plane written.
//
// What bounds it: ~6.9 MFLOP of float32 FMAs per plane (12.0 GFLOP at 50
// rows x 35 planes: 0.18 ms at the 67 TFLOP/s fp32 peak) against 0.7 MB
// of device-memory traffic, so the FMA pipes, and behind them the issue of
// shared-memory loads: a body with one block per plane, every output
// element its own k-loop and one load per FMA is bound by load issue far
// below the peak.
//
// The design:
// - Only C and S are read, once per block.  The six trimmed matrices of the
//   plain version are their sub-blocks, and by symmetry (C[r][k] = C[k][r])
//   each is a row-major slice of one of two staged pairs: Cn/Sn = C/S[:n, :]
//   and Cs/Ss = C/S[:, off:off+n], zero-padded to multiples of 4.
// - Every stage is the same register-tiled contraction: each thread owns a
//   4 x 4 output tile (two tiles where the stage has a real and an imaginary
//   part), and per contraction step reads three or four float4 rows of
//   shared memory that all 32 lanes of a warp take at the same step k, so
//   each float4 feeds 8-16 FMAs and no read is transposed: a stage writes
//   its output transposed where the next stage contracts over its rows
//   (A^T, B^T, a^T, b^T), with its tiles laid along the stored rows so that
//   the stores are free of bank conflicts too.  The spectrum product is
//   S2's epilogue, with the spectrum read from device memory (L2) there.
// - A block owns one row b and a group of planes, looping over them with
//   the next plane copied in by cp.async while the current one computes:
//   C and S are staged once for the group, and the launch picks the group
//   size so that every block of the grid is resident at once (two blocks
//   per SM at L = 64, n = 40: 107 KB of shared memory each).
//
// The transform size and plane side are run-time values up to 64.

#include <cuda_runtime.h>

namespace {

constexpr int NT = 256;      // threads per block
constexpr int MAXL = 64;     // largest transform size (and plane side)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// One 4 x 4 output tile of a contraction over k < K in the complex form
//   acc1[i][j] = sum_k u[k][r0+i] p[k][c0+j] - sum_k v[k][r0+i] q[k][c0+j]
//   acc2[i][j] = sum_k u[k][r0+i] q[k][c0+j] + sum_k v[k][r0+i] p[k][c0+j]
// MODE 0: no q (acc1 = u p, acc2 = v p); 1: both; 2: acc1 only.  Each of
// the sums runs in its own accumulator in the order k = 0..K-1, as the
// plain version's matmuls sum them: one accumulator for u p - v q lies
// ~1.5x farther from the float64 chain on random planes and kernels.
template <int MODE>
__device__ __forceinline__ void tile(const float* __restrict__ u,
                                     const float* __restrict__ v, int ldu,
                                     const float* __restrict__ p,
                                     const float* __restrict__ q, int ldp,
                                     int K, int r0, int c0,
                                     float (&acc1)[4][4],
                                     float (&acc2)[4][4]) {
  float up[4][4], vq[4][4], uq[4][4], vp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) up[i][j] = vq[i][j] = uq[i][j] = vp[i][j] = 0.f;
#pragma unroll 2
  for (int k = 0; k < K; ++k) {
    const float4 u4 = ld4(u + k * ldu + r0), v4 = ld4(v + k * ldu + r0);
    const float4 p4 = ld4(p + k * ldp + c0);
    const float4 q4 = MODE == 0 ? p4 : ld4(q + k * ldp + c0);
    const float uu[4] = {u4.x, u4.y, u4.z, u4.w};
    const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
    const float pp[4] = {p4.x, p4.y, p4.z, p4.w};
    const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        up[i][j] = fmaf(uu[i], pp[j], up[i][j]);
        if (MODE == 0) {
          vp[i][j] = fmaf(vv[i], pp[j], vp[i][j]);
        } else {
          vq[i][j] = fmaf(vv[i], qq[j], vq[i][j]);
          if (MODE == 1) {
            uq[i][j] = fmaf(uu[i], qq[j], uq[i][j]);
            vp[i][j] = fmaf(vv[i], pp[j], vp[i][j]);
          }
        }
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      acc1[i][j] = MODE == 0 ? up[i][j] : up[i][j] - vq[i][j];
      acc2[i][j] = MODE == 0 ? vp[i][j] : uq[i][j] + vp[i][j];
    }
}

// the 4 x 4 tile (rows r0.., columns c0..) written transposed into
// t[c][r] (pitch ld)
__device__ __forceinline__ void store_t(float* t, int ld, int r0, int c0,
                                        const float (&a)[4][4]) {
#pragma unroll
  for (int j = 0; j < 4; ++j)
    *reinterpret_cast<float4*>(t + (c0 + j) * ld + r0) =
        make_float4(a[0][j], a[1][j], a[2][j], a[3][j]);
}

struct Smem {
  const float *cn, *sn;   // [NP][LP]: C/S[k][c], k < n, c < L
  const float *cs, *ss;   // [LP][NP]: C/S[k][off + r], k < L, r < n
  float *ta, *tb;         // [NP][LP] A^T, B^T, then [LP][NP] a^T, b^T
  float *hr, *hi;         // [LP][LP] H
};

// One 'same' convolution of the zero-padded plane x ([NP][NP]) with the
// spectrum (g_r, g_i) ([L][L] in device memory): the result into x, or,
// when dst is not null, into dst ([n][n] in device memory).
__device__ void conv_same(float* x, const float* __restrict__ g_r,
                          const float* __restrict__ g_i, const Smem& s,
                          float* __restrict__ dst, int n, int L, int NP,
                          int LP) {
  const int t = threadIdx.x;
  float acc1[4][4], acc2[4][4];
  // S1: A, B (L x n), stored as A^T, B^T ([NP][LP])
  for (int T = t; T < (LP / 4) * (NP / 4); T += NT) {
    const int r0 = T % (LP / 4) * 4, c0 = T / (LP / 4) * 4;
    tile<0>(s.cn, s.sn, LP, x, nullptr, NP, NP, r0, c0, acc1, acc2);
    store_t(s.ta, LP, r0, c0, acc1);
    store_t(s.tb, LP, r0, c0, acc2);
  }
  __syncthreads();
  // S2: Fr = A C - B S, Fi = -(A S + B C) over k < n; H = F * G
  for (int T = t; T < (LP / 4) * (LP / 4); T += NT) {
    const int r0 = T / (LP / 4) * 4, c0 = T % (LP / 4) * 4;
    tile<1>(s.ta, s.tb, LP, s.cn, s.sn, LP, NP, r0, c0, acc1, acc2);
    float gr[4][4], gi[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = r0 + i;
      if ((L & 3) == 0 && r < L) {
        const float4 a = __ldg(reinterpret_cast<const float4*>(g_r + r * L
                                                               + c0));
        const float4 e = __ldg(reinterpret_cast<const float4*>(g_i + r * L
                                                               + c0));
        gr[i][0] = a.x, gr[i][1] = a.y, gr[i][2] = a.z, gr[i][3] = a.w;
        gi[i][0] = e.x, gi[i][1] = e.y, gi[i][2] = e.z, gi[i][3] = e.w;
      } else {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const bool ok = r < L && c0 + j < L;
          gr[i][j] = ok ? __ldg(g_r + r * L + c0 + j) : 0.f;
          gi[i][j] = ok ? __ldg(g_i + r * L + c0 + j) : 0.f;
        }
      }
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float hr[4], hi[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float fr = acc1[i][j], fi = -acc2[i][j];
        hr[j] = fr * gr[i][j] - fi * gi[i][j];
        hi[j] = fr * gi[i][j] + fi * gr[i][j];
      }
      *reinterpret_cast<float4*>(s.hr + (r0 + i) * LP + c0) =
          make_float4(hr[0], hr[1], hr[2], hr[3]);
      *reinterpret_cast<float4*>(s.hi + (r0 + i) * LP + c0) =
          make_float4(hi[0], hi[1], hi[2], hi[3]);
    }
  }
  __syncthreads();
  // S3: a = Cs^T Hr - Ss^T Hi, b = Cs^T Hi + Ss^T Hr (n x L), stored as
  // a^T, b^T ([LP][NP]) over the dead A^T, B^T
  for (int T = t; T < (NP / 4) * (LP / 4); T += NT) {
    const int r0 = T % (NP / 4) * 4, c0 = T / (NP / 4) * 4;
    tile<1>(s.cs, s.ss, NP, s.hr, s.hi, LP, LP, r0, c0, acc1, acc2);
    store_t(s.ta, NP, r0, c0, acc1);
    store_t(s.tb, NP, r0, c0, acc2);
  }
  __syncthreads();
  // S4: Y = (a Cs - b Ss) / L^2 (n x n)
  const float inv_l2 = 1.0f / (float)(L * L);
  for (int T = t; T < (NP / 4) * (NP / 4); T += NT) {
    const int r0 = T / (NP / 4) * 4, c0 = T % (NP / 4) * 4;
    tile<2>(s.ta, s.tb, NP, s.cs, s.ss, NP, LP, r0, c0, acc1, acc2);
    if (dst == nullptr) {
#pragma unroll
      for (int i = 0; i < 4; ++i)
        *reinterpret_cast<float4*>(x + (r0 + i) * NP + c0) = make_float4(
            acc1[i][0] * inv_l2, acc1[i][1] * inv_l2, acc1[i][2] * inv_l2,
            acc1[i][3] * inv_l2);
    } else {
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j)
          if (r0 + i < n && c0 + j < n)
            dst[(r0 + i) * n + c0 + j] = acc1[i][j] * inv_l2;
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 2)
fused_conv_chain_kernel(const float* __restrict__ planes,  // (B, nl, n, n)
                        const float* __restrict__ gtt_r,   // (B, L, L)
                        const float* __restrict__ gtt_i,
                        const float* __restrict__ gi_r,    // (nl, L, L)
                        const float* __restrict__ gi_i,
                        const float* __restrict__ cmat,    // (L, L) C
                        const float* __restrict__ smat,    // (L, L) S
                        float* __restrict__ out,           // (B, nl, n, n)
                        int nl, int n, int L, int off, int group) {
  extern __shared__ __align__(16) float smem[];
  const int NP = (n + 3) & ~3, LP = (L + 3) & ~3;
  float* cn = smem;
  float* sn = cn + NP * LP;
  float* cs = sn + NP * LP;
  float* ss = cs + LP * NP;
  float* ta = ss + LP * NP;
  float* tb = ta + NP * LP;
  float* hr = tb + NP * LP;
  float* hi = hr + LP * LP;
  float* xs = hi + LP * LP;        // [2][NP][NP]: the plane double buffer
  const Smem s{cn, sn, cs, ss, ta, tb, hr, hi};
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * group;
  const int p1 = min(nl, p0 + group);

  for (int q = t; q < NP * LP; q += NT) {
    const int k = q / LP, c = q % LP;
    const bool ok = k < n && c < L;
    cn[q] = ok ? cmat[k * L + c] : 0.f;
    sn[q] = ok ? smat[k * L + c] : 0.f;
  }
  for (int q = t; q < LP * NP; q += NT) {
    const int k = q / NP, r = q % NP;
    const bool ok = k < L && r < n && off + r < L;
    cs[q] = ok ? cmat[k * L + off + r] : 0.f;
    ss[q] = ok ? smat[k * L + off + r] : 0.f;
  }
  for (int q = t; q < 2 * NP * NP; q += NT) xs[q] = 0.f;   // the padding
  __syncthreads();

  // the plane p (its n x n values; the padding stays zero) into buffer buf
  auto stage = [&](int buf, int p) {
    const float* src = planes + ((size_t)b * nl + p) * n * n;
    float* dst = xs + buf * NP * NP;
    for (int q = t; q < n * n; q += NT) cp_async4(dst + q / n * NP + q % n,
                                                  src + q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };

  if (p0 < p1) stage(0, p0);
  int buf = 0;
  for (int p = p0; p < p1; ++p, buf ^= 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // plane p landed; the other buffer is free
    if (p + 1 < p1) stage(buf ^ 1, p + 1);
    float* x = xs + buf * NP * NP;
    const size_t gt = (size_t)b * L * L, gp = (size_t)p * L * L;
    conv_same(x, gtt_r + gt, gtt_i + gt, s, nullptr, n, L, NP, LP);
    conv_same(x, gi_r + gp, gi_i + gp, s, out + ((size_t)b * nl + p) * n * n,
              n, L, NP, LP);
  }
}

}  // namespace

// Launches K2 on `stream`: out (B, nl, n, n) from the planes, the rows'
// tip-tilt spectra, the planes' intrinsic spectra and the (L, L) DFT
// matrices C, S, for n, L <= 64 and off + n <= L; returns the first CUDA
// error (0 = launched).
extern "C" int muse_fused_conv_chain(const float* planes, const float* gtt_r,
                                     const float* gtt_i, const float* gi_r,
                                     const float* gi_i, const float* cmat,
                                     const float* smat, float* out, int B,
                                     int nl, int n, int L, int off,
                                     void* stream) {
  if (n < 1 || L > MAXL || n > L || off < 0 || off + n > L || B < 1 ||
      nl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int NP = (n + 3) & ~3, LP = (L + 3) & ~3;
  const int smem =
      (6 * NP * LP + 2 * LP * LP + 2 * NP * NP) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      fused_conv_chain_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_conv_chain_kernel, NT, smem)) != cudaSuccess)
    return static_cast<int>(err);
  // the fewest planes per block that keep every block of the grid
  // resident at once: C and S are staged once per block
  const int groups = max(1, min(nl, max(1, per_sm) * sms / B));
  const int group = (nl + groups - 1) / groups;
  const dim3 grid((nl + group - 1) / group, B);
  fused_conv_chain_kernel<<<grid, NT, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      planes, gtt_r, gtt_i, gi_r, gi_i, cmat, smat, out, nl, n, L, off,
      group);
  return static_cast<int>(cudaGetLastError());
}
