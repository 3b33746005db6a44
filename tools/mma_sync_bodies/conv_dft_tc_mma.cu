// K2 at conv_precision "high" as it was first written, with mma.sync: the
// yardstick of the wgmma body in muse_psfr_tpu_torch/csrc/conv_dft_tc.cu,
// built apart from the package (tools/ab_conv_chain.py --tc, chip_smoke.py)
// with -I muse_psfr_tpu_torch/csrc; the package never builds or launches it.
// Its entry point is muse_fused_conv_chain_tc_mma, with the arguments the
// package's entry point had before it took the launch plan.
//
// Replaces muse_psfr_tpu/ops/conv_dft.py:fused_conv_chain with
// precision="high" (body _kernel / _conv_pack, whose every product is
// ops/zoom_dft.py:_mxu_contract at "high").  It computes what conv_dft.cu
// computes, the tip-tilt and then the intrinsic 'same' convolution of every
// (n x n) plane as trimmed circular DFTs at the alias-free size L, with
// W = C - iS and off = (n_ker - 1) / 2:
//
//   S1  A = C[:, :n] X,  B = S[:, :n] X                        (L x n)
//   S2  F = (A - iB) W[:n, :] ,  H = F * G                      (L x L)
//   S3  a + ib = conj(W)[off:off+n, :] H                        (n x L)
//   S4  Y = Re((a + ib) conj(W)[:, off:off+n]) / L^2            (n x n)
//
// but each of its twelve real products as the 3-pass bf16 split
//
//     P Q  ~  P_hi Q_hi + P_hi Q_lo + P_lo Q_hi
//
// with x_hi = bf16(x), x_lo = bf16(x - x_hi) (round to nearest even; lo = 0
// where hi is infinite) and float32 accumulation: mma.sync.m16n8k16 on the
// tensor cores.  The products of bf16 values are exact in float32, so this
// is the arithmetic of the plain version (ops/conv_dft.py:
// fused_conv_chain_reference at "high") up to the order of the float32 sums;
// the dropped lo*lo term is ~2^-16 relative per product.  Both operands of
// every product are split inside the kernel: C and S once per block when
// they are staged, every intermediate (X, A, B, H, a, b) from its float32
// accumulators when its stage stores it, so each product sees the float32
// value of the stage before it and never a bf16-rounded copy; the second
// convolution takes the first one's float32 result the same way.  The
// spectrum product, the sums of two products and the scale by 1/L^2 are
// float32 operations with the plain version's roundings (no fused
// multiply-add).
//
// What bounds it: 12.0 GFLOP of contraction at 50 rows x 35 planes, three
// passes: 36 GFLOP of bf16 tensor-core work, 0.04 ms at the 989 TFLOP/s
// peak, against 25 MB of device-memory traffic; in this body the ldmatrix
// reads of shared memory (about two for every three mma) and the barriers
// between the stages.
//
// The design, per block of 256 threads (8 warps) owning one row b and a
// group of planes (the next plane copied in by cp.async while the current
// one computes, as in conv_dft.cu):
//
// - Every operand lives in shared memory as a pair of bf16 tiles (hi, lo)
//   of 144-byte row pitch, which ldmatrix reads without bank conflicts.
//   C and S are symmetric, so one staged copy serves as the row-major A
//   operand (rows = output rows) and, read as [n][k], as the column-major
//   B operand.  An intermediate is stored row-major as its stage's
//   accumulators hold it: that is the A operand layout [m][k] where the
//   next stage contracts over its columns (A, B, a, b), and the [k][n]
//   layout read by ldmatrix.trans where it contracts over its rows (X, H).
//   No stage transposes anything.
// - A stage is a list of m16 x n8 output tiles dealt round-robin to the
//   warps.  A tile runs the complex form acc1 = u p - v q, acc2 = u q + v p
//   (u, v the A operands; p, q the B operands; S1 and S4 need half of it)
//   with each of the four products in its own accumulators, as the plain
//   version's four matmuls, then one rounded float32 add or subtract.
// - An mma truncates inside its sum.  So each step of 32 contraction rows
//   runs its passes (hi*hi, hi*lo, lo*hi of each k16 half) in a fresh
//   fragment, and the steps (at most two: the contractions are n <= 64 or
//   L <= 64 long) are added with rounded float32 adds, the order of
//   ops/zoom_dft.py:contract.
// - Padding is zeros by construction: tiles are zeroed once, n is padded
//   to a multiple of 16 where it is contracted over (40 -> 48: X's rows
//   40..47 and A's, B's columns 40..47 are never written), and C, S are
//   staged with zero rows and columns past L, so no stage masks an operand;
//   only the stores of S4 are masked to the plane.
//
// Shared memory: 4 constant tiles of 80 x 72 and 14 operand tiles of
// 64 x 72 bf16, and the float32 plane double buffer: 187.8 KB at n = 40,
// one block per SM.  The transform size and plane side are run-time values
// up to 64.

#include "mma_common.cuh"

namespace {

constexpr int NT = 256;        // threads per block
constexpr int NWARP = NT / 32;
constexpr int MAXL = 64;       // largest transform size (and plane side)
constexpr int P = MAXL + 8;    // tile pitch [bf16]: 144 B, conflict-free
constexpr int CROWS = MAXL + 16;  // rows of a constant tile: off + n + 15 at most
constexpr int C_TILE = CROWS * P;   // bf16 per constant tile
constexpr int T_TILE = MAXL * P;    // bf16 per operand tile

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src)
               : "memory");
}

// the two parts of two adjacent float32 values, packed as the tiles hold
// them (the lower column in the lower half)
__device__ __forceinline__ void split2(float v0, float v1, __nv_bfloat162& hi,
                                       __nv_bfloat162& lo) {
  hi = __floats2bfloat162_rn(v0, v1);
  const float2 hf = __bfloat1622float2(hi);
  lo = __floats2bfloat162_rn(isinf(hf.x) ? 0.f : __fsub_rn(v0, hf.x),
                             isinf(hf.y) ? 0.f : __fsub_rn(v1, hf.y));
}

// a pair of bf16 tiles (hi, lo), T_TILE or C_TILE elements each
struct Pair {
  __nv_bfloat16 *hi, *lo;
};

// (v0, v1) at (row, col), col even, into a tile pair
__device__ __forceinline__ void store_split(const Pair& t, int row, int col,
                                            float v0, float v1) {
  __nv_bfloat162 hi, lo;
  split2(v0, v1, hi, lo);
  *reinterpret_cast<__nv_bfloat162*>(t.hi + row * P + col) = hi;
  *reinterpret_cast<__nv_bfloat162*>(t.lo + row * P + col) = lo;
}

// s += a_hi b_hi + a_hi b_lo + a_lo b_hi on one m16n8k16 fragment
__device__ __forceinline__ void pass3(float (&s)[4], const uint32_t (&ah)[4],
                                      const uint32_t (&al)[4], uint32_t bh0,
                                      uint32_t bh1, uint32_t bl0,
                                      uint32_t bl1) {
  mma_bf16(s, ah, bh0, bh1);
  mma_bf16(s, ah, bl0, bl1);
  mma_bf16(s, al, bh0, bh1);
}

// this lane's ldmatrix row address of an A operand: tile rows m0 + lane % 16,
// column (lane / 16) * 8 of a k16 step
__device__ __forceinline__ uint32_t a_addr(const __nv_bfloat16* tile, int m0,
                                           int lane) {
  return smem_addr(tile + (m0 + (lane & 15)) * P + (lane >> 4) * 8);
}

// this lane's ldmatrix row address of a B operand over one n8 tile and one
// step of 32 contraction rows: the four 8 x 8 matrices are k = 0..7, 8..15,
// 16..23, 24..31, so registers (0, 1) are the fragment of the first k16 half
// and (2, 3) of the second.  TRANS: the tile is [k][n] (an intermediate),
// read by ldmatrix.trans, this lane's row k = lane; else it is [n][k] (C or
// S, symmetric), row n0 + lane % 8, column (lane / 8) * 8
template <bool TRANS>
__device__ __forceinline__ uint32_t b_addr(const __nv_bfloat16* tile, int n0,
                                           int lane) {
  return TRANS ? smem_addr(tile + lane * P + n0)
               : smem_addr(tile + (n0 + (lane & 7)) * P + (lane >> 3) * 8);
}

template <bool TRANS>
__device__ __forceinline__ void ld_b(uint32_t (&r)[4], uint32_t addr) {
  if (TRANS)
    ldsm_x4_trans(r, addr);
  else
    ldsm_x4(r, addr);
}

// One m16 x n8 output tile of a contraction over k16s steps of 16 in the
// complex form
//   acc1 = u p - v q,   acc2 = u q + v p
// MODE 0: no q (acc1 = u p, acc2 = v p); 1: both; 2: acc1 only.  u, v: the
// A operands' rows m0.., p, q: the B operands' columns n0...  Each product
// keeps its own sum: per step of 32 contraction rows its passes run in a
// fresh fragment, and the steps are added in float32.
template <int MODE, bool TRANS>
__device__ __forceinline__ void tile_mma(const Pair& u, const Pair& v, int m0,
                                         const Pair& p, const Pair& q, int n0,
                                         int k16s, int lane, float (&acc1)[4],
                                         float (&acc2)[4]) {
  // bytes from one step of 32 contraction rows to the next in a B operand
  constexpr uint32_t B_STEP = TRANS ? 32 * P * 2 : 32 * 2;
  const uint32_t uh = a_addr(u.hi, m0, lane), ul = a_addr(u.lo, m0, lane);
  const uint32_t vh = a_addr(v.hi, m0, lane), vl = a_addr(v.lo, m0, lane);
  const uint32_t ph = b_addr<TRANS>(p.hi, n0, lane);
  const uint32_t pl = b_addr<TRANS>(p.lo, n0, lane);
  const uint32_t qh = b_addr<TRANS>(q.hi, n0, lane);
  const uint32_t ql = b_addr<TRANS>(q.lo, n0, lane);
  float up[4] = {}, vq[4] = {}, uq[4] = {}, vp[4] = {};
  for (int k16 = 0; k16 < k16s; k16 += 2) {
    float s_up[4] = {}, s_vq[4] = {}, s_uq[4] = {}, s_vp[4] = {};
    uint32_t bph[4], bpl[4], bqh[4], bql[4];
    ld_b<TRANS>(bph, ph + (k16 >> 1) * B_STEP);
    ld_b<TRANS>(bpl, pl + (k16 >> 1) * B_STEP);
    if (MODE != 0) {
      ld_b<TRANS>(bqh, qh + (k16 >> 1) * B_STEP);
      ld_b<TRANS>(bql, ql + (k16 >> 1) * B_STEP);
    }
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      if (k16 + h < k16s) {
        const uint32_t ka = (k16 + h) * 16 * 2;   // bytes along an A row
        uint32_t auh[4], aul[4], avh[4], avl[4];
        ldsm_x4(auh, uh + ka);
        ldsm_x4(aul, ul + ka);
        ldsm_x4(avh, vh + ka);
        ldsm_x4(avl, vl + ka);
        pass3(s_up, auh, aul, bph[2 * h], bph[2 * h + 1], bpl[2 * h],
              bpl[2 * h + 1]);
        if (MODE == 0) {
          pass3(s_vp, avh, avl, bph[2 * h], bph[2 * h + 1], bpl[2 * h],
                bpl[2 * h + 1]);
        } else {
          pass3(s_vq, avh, avl, bqh[2 * h], bqh[2 * h + 1], bql[2 * h],
                bql[2 * h + 1]);
          if (MODE == 1) {
            pass3(s_uq, auh, aul, bqh[2 * h], bqh[2 * h + 1], bql[2 * h],
                  bql[2 * h + 1]);
            pass3(s_vp, avh, avl, bph[2 * h], bph[2 * h + 1], bpl[2 * h],
                  bpl[2 * h + 1]);
          }
        }
      }
    }
#pragma unroll
    for (int e = 0; e < 4; ++e) {
      up[e] = __fadd_rn(up[e], s_up[e]);
      vq[e] = __fadd_rn(vq[e], s_vq[e]);
      uq[e] = __fadd_rn(uq[e], s_uq[e]);
      vp[e] = __fadd_rn(vp[e], s_vp[e]);
    }
  }
#pragma unroll
  for (int e = 0; e < 4; ++e) {
    acc1[e] = MODE == 0 ? up[e] : __fsub_rn(up[e], vq[e]);
    acc2[e] = MODE == 0 ? vp[e] : __fadd_rn(uq[e], vp[e]);
  }
}

struct Smem {
  Pair c, s;        // C, S: [CROWS][P], zeros past L
  Pair x;           // the plane, [k][n]
  Pair a, b;        // S1's A, B, [m][k]
  Pair hr, hi;      // S2's H, [k][n]
  Pair aa, bb;      // S3's a, b, [m][k]
};

// a tile pair's rows from row `off` on
__device__ __forceinline__ Pair rows_from(const Pair& t, int off) {
  return Pair{t.hi + off * P, t.lo + off * P};
}

// One 'same' convolution of the plane in s.x with the spectrum (g_r, g_i)
// ([L][L] in device memory): the result back into s.x, or, when dst is not
// null, into dst ([n][n] in device memory).
__device__ void conv_same(const Smem& s, const float* __restrict__ g_r,
                          const float* __restrict__ g_i,
                          float* __restrict__ dst, int n, int L, int off) {
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int n8 = (n + 7) / 8, n16 = (n + 15) / 16;
  const int l8 = (L + 7) / 8, l16 = (L + 15) / 16;
  // an accumulator fragment holds rows lane / 4 and + 8, columns
  // 2 (lane % 4) and + 1 of its tile
  const int fr = lane >> 2, fc = 2 * (lane & 3);
  float acc1[4], acc2[4];
  // S1: A = C[:, :n] X, B = S[:, :n] X (L x n), over k < n
  for (int t = warp; t < l16 * n8; t += NWARP) {
    const int m0 = t % l16 * 16, n0 = t / l16 * 8;
    tile_mma<0, true>(s.c, s.s, m0, s.x, s.x, n0, n16, lane, acc1, acc2);
    store_split(s.a, m0 + fr, n0 + fc, acc1[0], acc1[1]);
    store_split(s.a, m0 + fr + 8, n0 + fc, acc1[2], acc1[3]);
    store_split(s.b, m0 + fr, n0 + fc, acc2[0], acc2[1]);
    store_split(s.b, m0 + fr + 8, n0 + fc, acc2[2], acc2[3]);
  }
  __syncthreads();
  // S2: Fr = A C - B S, Fi = -(A S + B C) over k < n; H = F * G
  for (int t = warp; t < l16 * l8; t += NWARP) {
    const int m0 = t % l16 * 16, n0 = t / l16 * 8;
    tile_mma<1, false>(s.a, s.b, m0, s.c, s.s, n0, n16, lane, acc1, acc2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + fr + 8 * half, c = n0 + fc;
      float hr[2], hi[2];
#pragma unroll
      for (int j = 0; j < 2; ++j) {
        const bool ok = r < L && c + j < L;
        const float gr = ok ? __ldg(g_r + r * L + c + j) : 0.f;
        const float gi = ok ? __ldg(g_i + r * L + c + j) : 0.f;
        const float f_r = acc1[2 * half + j], f_i = -acc2[2 * half + j];
        hr[j] = __fsub_rn(__fmul_rn(f_r, gr), __fmul_rn(f_i, gi));
        hi[j] = __fadd_rn(__fmul_rn(f_r, gi), __fmul_rn(f_i, gr));
      }
      store_split(s.hr, r, c, hr[0], hr[1]);
      store_split(s.hi, r, c, hi[0], hi[1]);
    }
  }
  __syncthreads();
  // S3: a = Cs Hr - Ss Hi, b = Cs Hi + Ss Hr (n x L) over k < L, with
  // Cs, Ss the rows off.. of C, S
  const Pair cs = rows_from(s.c, off), ss = rows_from(s.s, off);
  for (int t = warp; t < n16 * l8; t += NWARP) {
    const int m0 = t % n16 * 16, n0 = t / n16 * 8;
    tile_mma<1, true>(cs, ss, m0, s.hr, s.hi, n0, l16, lane, acc1, acc2);
    store_split(s.aa, m0 + fr, n0 + fc, acc1[0], acc1[1]);
    store_split(s.aa, m0 + fr + 8, n0 + fc, acc1[2], acc1[3]);
    store_split(s.bb, m0 + fr, n0 + fc, acc2[0], acc2[1]);
    store_split(s.bb, m0 + fr + 8, n0 + fc, acc2[2], acc2[3]);
  }
  __syncthreads();
  // S4: Y = (a Cs^T - b Ss^T) / L^2 (n x n) over k < L
  const float inv_l2 = 1.0f / (float)(L * L);
  for (int t = warp; t < n16 * n8; t += NWARP) {
    const int m0 = t % n16 * 16, n0 = t / n16 * 8;
    tile_mma<2, false>(s.aa, s.bb, m0, cs, ss, n0, l16, lane, acc1, acc2);
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int r = m0 + fr + 8 * half, c = n0 + fc;
      const float y0 = __fmul_rn(acc1[2 * half], inv_l2);
      const float y1 = __fmul_rn(acc1[2 * half + 1], inv_l2);
      if (r >= n) continue;
      if (dst != nullptr) {
        if (c < n) dst[r * n + c] = y0;
        if (c + 1 < n) dst[r * n + c + 1] = y1;
      } else {
        // the plane's padding stays zero
        store_split(s.x, r, c, c < n ? y0 : 0.f, c + 1 < n ? y1 : 0.f);
      }
    }
  }
  __syncthreads();
}

__global__ void __launch_bounds__(NT, 1)
fused_conv_chain_tc_kernel(const float* __restrict__ planes,  // (B, nl, n, n)
                           const float* __restrict__ gtt_r,   // (B, L, L)
                           const float* __restrict__ gtt_i,
                           const float* __restrict__ gi_r,    // (nl, L, L)
                           const float* __restrict__ gi_i,
                           const float* __restrict__ cmat,    // (L, L) C
                           const float* __restrict__ smat,    // (L, L) S
                           float* __restrict__ out,           // (B, nl, n, n)
                           int nl, int n, int L, int off, int group) {
  extern __shared__ __align__(128) unsigned char smem[];
  __nv_bfloat16* tiles = reinterpret_cast<__nv_bfloat16*>(smem);
  // 4 constant tiles, 14 operand tiles, then [2][n][n] floats: the plane
  // double buffer
  constexpr int N_BF16 = 4 * C_TILE + 14 * T_TILE;
  auto ctile = [&](int i) { return tiles + i * C_TILE; };
  auto ttile = [&](int i) { return tiles + 4 * C_TILE + i * T_TILE; };
  const Smem s{{ctile(0), ctile(1)},  {ctile(2), ctile(3)},
               {ttile(0), ttile(1)},  {ttile(2), ttile(3)},
               {ttile(4), ttile(5)},  {ttile(6), ttile(7)},
               {ttile(8), ttile(9)},  {ttile(10), ttile(11)},
               {ttile(12), ttile(13)}};
  float* xs = reinterpret_cast<float*>(tiles + N_BF16);
  const int t = threadIdx.x;
  const int b = blockIdx.y;
  const int p0 = blockIdx.x * group;
  const int p1 = min(nl, p0 + group);

  // the plane p into the float buffer buf
  auto stage = [&](int buf, int p) {
    const float* src = planes + ((size_t)b * nl + p) * n * n;
    float* dst = xs + buf * n * n;
    for (int q = t; q < n * n; q += NT) cp_async4(dst + q, src + q);
    asm volatile("cp.async.commit_group;\n" ::: "memory");
  };
  if (p0 < p1) stage(0, p0);

  // every tile zeroed (the padding of every operand), then C and S split
  // into their parts, zeros past L
  for (int q = t; q < N_BF16 / 8; q += NT)
    reinterpret_cast<uint4*>(tiles)[q] = make_uint4(0, 0, 0, 0);
  __syncthreads();
  for (int q = t; q < L * (L / 2 + (L & 1)); q += NT) {
    const int half = L / 2 + (L & 1);
    const int r = q / half, c = q % half * 2;
    const bool two = c + 1 < L;
    store_split(s.c, r, c, cmat[r * L + c], two ? cmat[r * L + c + 1] : 0.f);
    store_split(s.s, r, c, smat[r * L + c], two ? smat[r * L + c + 1] : 0.f);
  }

  int buf = 0;
  for (int p = p0; p < p1; ++p, buf ^= 1) {
    asm volatile("cp.async.wait_all;\n" ::: "memory");
    __syncthreads();   // plane p landed; the other buffer and s.x are free
    if (p + 1 < p1) stage(buf ^ 1, p + 1);
    // the plane's n x n values into s.x (its padding stays zero)
    const float* x = xs + buf * n * n;
    const int half = n / 2 + (n & 1);
    for (int q = t; q < n * half; q += NT) {
      const int r = q / half, c = q % half * 2;
      store_split(s.x, r, c, x[r * n + c], c + 1 < n ? x[r * n + c + 1] : 0.f);
    }
    __syncthreads();
    const size_t gt = (size_t)b * L * L, gp = (size_t)p * L * L;
    conv_same(s, gtt_r + gt, gtt_i + gt, nullptr, n, L, off);
    conv_same(s, gi_r + gp, gi_i + gp, out + ((size_t)b * nl + p) * n * n, n,
              L, off);
  }
}

}  // namespace

// Launches K2 at "high" on `stream`: out (B, nl, n, n) from the planes, the
// rows' tip-tilt spectra, the planes' intrinsic spectra and the (L, L) DFT
// matrices C, S in float32, for n, L <= 64 and off + n <= L; returns the
// first CUDA error (0 = launched).
extern "C" int muse_fused_conv_chain_tc_mma(
    const float* planes, const float* gtt_r, const float* gtt_i,
    const float* gi_r, const float* gi_i, const float* cmat, const float* smat,
    float* out, int B, int nl, int n, int L, int off, void* stream) {
  if (n < 1 || L > MAXL || n > L || off < 0 || off + n > L || B < 1 ||
      nl < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (4 * C_TILE + 14 * T_TILE) * 2 + 2 * n * n * 4;
  cudaError_t err = cudaFuncSetAttribute(
      fused_conv_chain_tc_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess ||
      (err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess ||
      (err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, fused_conv_chain_tc_kernel, NT, smem)) != cudaSuccess)
    return static_cast<int>(err);
  // the fewest planes per block that keep every block of the grid
  // resident at once: C and S are staged and split once per block
  const int groups = max(1, min(nl, max(1, per_sm) * sms / B));
  const int group = (nl + groups - 1) / groups;
  const dim3 grid((nl + group - 1) / group, B);
  fused_conv_chain_tc_kernel<<<grid, NT, smem,
                               static_cast<cudaStream_t>(stream)>>>(
      planes, gtt_r, gtt_i, gi_r, gi_i, cmat, smat, out, nl, n, L, off,
      group);
  return static_cast<int>(cudaGetLastError());
}
