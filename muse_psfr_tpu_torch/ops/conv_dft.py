"""K2: fused final-PSF convolution chain.

The final-PSF stage (reference convolve_final_psf, psfrec.py:874-930)
convolves each (n, n) PSF plane with the row's tip-tilt Moffat and then
the plane's MUSE-intrinsic Moffat: two 'same' linear convolutions, each
exact as a circular DFT product at the alias-free size L
(``otf/convolve.py:_same_fft_size``; L=64 at dimpsf=40).  The transforms
are trimmed to the support (see :func:`_trimmed_mats`): the forward
transform contracts only the n nonzero rows/columns and the inverse
computes only the n 'same'-window rows/columns, so the crop is free.

:func:`fused_conv_chain` launches the hand-written CUDA kernels
(counterpart of ``muse_psfr_tpu/ops/conv_dft.py:fused_conv_chain``) for
CUDA tensors: a block per (row, group of planes), the whole chain of each
plane in shared memory, every transform a contraction against the two DFT
matrices C and S, of which the six trimmed matrices are sub-blocks.
``precision`` (``cfg.conv_precision``) chooses the body, as it chooses
``_mxu_contract``'s scheme in the JAX kernel: "highest"
(``csrc/conv_dft.cu``) contracts in register-tiled float32 FMAs; "high"
(``csrc/conv_dft_tc.cu``) runs every contraction as the 3-pass bf16 split
``a_hi@b_hi + a_hi@b_lo + a_lo@b_hi`` with float32 accumulation on the
tensor cores (warpgroup products, two planes in flight a block on a
persistent grid, :func:`tc_launch_plan`), both operands split inside the
kernel and every intermediate kept in float32 between the products.
Anything else raises.
For CPU tensors it runs :func:`fused_conv_chain_reference`, the same
operations in plain PyTorch.  The kernel spectra come from
``otf/convolve.py:_dft_spectra``.
"""

import numpy as np
import torch

from . import _build
from ..otf.convolve import _dft_mats, _dft_mats_np, _same_fft_size
from ..utils.device import host_const
from .zoom_dft import contract

#: successful launches of the float32 body ("highest") and of the
#: tensor-core body ("high"); see ops/_build.py
LAUNCHES = 0
TC_LAUNCHES = 0

#: the tiers K2 computes (``fused_conv_chain`` of the JAX package takes
#: the same two)
CONV_PRECISIONS = ("highest", "high")

#: largest plane side and transform size the kernel takes
MAX_SIZE = 64


def tc_launch_plan(B, nl, sms):
    """Blocks of the tensor-core body's persistent grid for ``B`` rows x
    ``nl`` planes on a card of ``sms`` SMs: one block per SM (its shared
    memory admits one), fewer only when there are fewer (row, plane)
    items than SMs.  Each block stages and splits C and S once; its two
    warpgroups walk the flattened items (``csrc/conv_dft_tc.cu``)."""
    return max(1, min(sms, B * nl))


def _trimmed_mats(L: int, n: int, off: int):
    """Host float64 trimmed transform matrices (``_trimmed_mats`` of the
    JAX package with pack=1), sub-blocks of the symmetric DFT matrix
    ``C - iS`` (``otf/convolve.py:_dft_mats_np``), which the CUDA kernel
    stages in their place:

    csn (2L, n): [C; S] columns restricted to the nonzero plane rows;
    crc/crs (n, L): right-multiplies of the forward transform
    (Fr = A crc - B crs, Fi = -(A crs + B crc));
    csel (2n, L): inverse rows restricted to the 'same' window;
    cdc/cds (L, n): inverse right-multiplies with only the window columns.
    """
    c, s = _dft_mats_np(L)
    csn = np.concatenate([c[:, :n], s[:, :n]], axis=0)
    csel = np.concatenate([c[off:off + n, :], s[off:off + n, :]], axis=0)
    return (csn, c[:n, :], s[:n, :], csel, c[:, off:off + n],
            s[:, off:off + n])


def _mats(L, n, off, device, dtype):
    return tuple(host_const(("conv_trimmed", L, n, off, i),
                            lambda i=i: _trimmed_mats(L, n, off)[i],
                            device, dtype)
                 for i in range(6))


def check_precision(precision):
    if precision not in CONV_PRECISIONS:
        raise ValueError(f"unsupported conv precision {precision!r}; the "
                         "fused conv chain supports 'highest' and 'high'")


def _conv_same(x, gr, gi, mats, precision="highest"):
    """One trimmed circular-DFT 'same' convolution of planes ``x``
    (..., n, n) with kernel spectra ``(gr, gi)`` (..., L, L), every
    product at ``precision``: one float32 matmul at "highest"; at "high"
    in the tensor-core body's order of sums
    (``ops/zoom_dft.py:contract``): each operand is split anew before each
    product (``_mxu_contract`` of the JAX package), the product of each 32
    contraction rows is the sum of its three passes, and the steps (at
    most two: the contractions are 40 or 64 long at dimpsf = 40) add up in
    float32."""
    csn, crc, crs, csel, cdc, cds = mats
    L = csn.shape[0] // 2
    n = x.shape[-1]

    def mm(a, b):
        return (torch.matmul(a, b) if precision == "highest"
                else contract(a, b, precision))

    ab = mm(csn, x)                                       # (..., 2L, n)
    a, b = ab[..., :L, :], ab[..., L:, :]
    fr = mm(a, crc) - mm(b, crs)
    fi = -(mm(a, crs) + mm(b, crc))
    hr = fr * gr - fi * gi
    hi = fr * gi + fi * gr
    u = mm(csel, hr)                                      # (..., 2n, L)
    v = mm(csel, hi)
    aa = u[..., :n, :] - v[..., n:, :]
    bb = v[..., :n, :] + u[..., n:, :]
    return (mm(aa, cdc) - mm(bb, cds)) * (1.0 / (L * L))


def fused_conv_chain_reference(planes, gtt_r, gtt_i, gi_r, gi_i, n_ker,
                               precision="highest"):
    """Plain PyTorch K2.  planes (B, nl, n, n); gtt_r/gtt_i (B, L, L) the
    rows' tip-tilt kernel spectra; gi_r/gi_i (nl, L, L) the planes'
    intrinsic spectra.  Returns (B, nl, n, n): the tip-tilt then the
    intrinsic 'same' convolution of every plane, every contraction at
    ``precision`` (:func:`_conv_same`); the second convolution takes the
    first one's float32 result."""
    check_precision(precision)
    L, n = gtt_r.shape[-1], planes.shape[-1]
    mats = _mats(L, n, (n_ker - 1) // 2, planes.device, planes.dtype)
    y = _conv_same(planes, gtt_r[:, None], gtt_i[:, None], mats, precision)
    return _conv_same(y, gi_r[None], gi_i[None], mats, precision)


def fused_conv_chain(planes, gtt_r, gtt_i, gi_r, gi_i, n_ker,
                     precision="highest"):
    """K2 on the tensors' device: a CUDA kernel for CUDA tensors (float32
    only, plane side and transform size at most :data:`MAX_SIZE`; anything
    else raises), the float32 body at ``precision`` "highest" and the
    tensor-core body at "high", each with its own launch counter and
    neither standing in for the other;
    :func:`fused_conv_chain_reference` for CPU tensors.  Shapes as in the
    reference; every tensor contiguous."""
    global LAUNCHES, TC_LAUNCHES
    check_precision(precision)
    if planes.device.type == "cpu":
        return fused_conv_chain_reference(planes, gtt_r, gtt_i, gi_r, gi_i,
                                          n_ker, precision)
    B, nl, n, _ = planes.shape
    L = _same_fft_size(n, n_ker)
    _build.check_operands("fused_conv_chain", planes.device, {
        "planes": (planes, (B, nl, n, n)), "gtt_r": (gtt_r, (B, L, L)),
        "gtt_i": (gtt_i, (B, L, L)), "gi_r": (gi_r, (nl, L, L)),
        "gi_i": (gi_i, (nl, L, L))})
    if B > 65535 or L > MAX_SIZE:
        raise ValueError(f"fused_conv_chain: {B} rows of planes at transform "
                         f"size {L}; the kernel takes at most 65535 rows and "
                         f"size {MAX_SIZE}")
    c, s = _dft_mats(L, planes.device, torch.float32)
    out = torch.empty_like(planes)
    lib = _build.library()
    ptrs = (planes.data_ptr(), gtt_r.data_ptr(), gtt_i.data_ptr(),
            gi_r.data_ptr(), gi_i.data_ptr(), c.data_ptr(), s.data_ptr(),
            out.data_ptr(), B, nl, n, L, (n_ker - 1) // 2)
    stream = torch.cuda.current_stream(planes.device).cuda_stream
    if precision == "high":
        sms = torch.cuda.get_device_properties(
            planes.device).multi_processor_count
        err = lib.muse_fused_conv_chain_tc(
            *ptrs, tc_launch_plan(B, nl, sms), stream)
    else:
        err = lib.muse_fused_conv_chain(*ptrs, stream)
    _build.check_launch(err, f"fused_conv_chain at {precision}")
    if precision == "high":
        TC_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return out
