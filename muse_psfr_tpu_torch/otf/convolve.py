"""Tip-tilt and instrument-PSF convolutions (PyTorch, batched).

Counterpart of ``muse_psfr_tpu/otf/convolve.py`` (reference
``convolve_final_psf``, psfrec.py:874-930): each row's PSF cube is
convolved with (a) a beta=2 Moffat modelling residual tip-tilt from the
uncorrected high layer, its width set by the outer-scale attenuation
table, and (b) the per-wavelength MUSE-intrinsic Moffat.  Both are 'same'
linear convolutions done as circular transforms at the minimal alias-free
size (:func:`_same_fft_size`), exact on the kept window.

On the FFT-free route (``cfg.use_fft=False``) with ``cfg.use_fused_conv``
both convolutions run as one K2 launch (``ops/conv_dft.py``).  On that
route ``cfg.conv_precision`` chooses the tier of every DFT product, of the
plain ones (``ops/zoom_dft.py:matmul_tier``) and of K2's body, where the
card runs them (:func:`_conv_precision`).
"""

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..config import GalacsiConfig
from ..core.coeff_l0 import tt_attenuation
from ..core.moffat import (moffat_fwhm_to_alpha, moffat_kernel,
                           muse_intrinsic_psf)
from ..utils.device import host_const


def _same_fft_size(n_img: int, n_ker: int) -> int:
    """Smallest alias-free circular-transform size for the 'same' window
    (``L >= n_img + n_ker - 1 - off``, off = (n_ker-1)//2), rounded up to
    a multiple of 8 and never above the full size: 64 at dimpsf=40."""
    full = n_img + n_ker - 1
    lmin = full - (n_ker - 1) // 2
    return min(full, -(-lmin // 8) * 8)


def _fft_convolve_same(planes, kernels, n_img: int, n_ker: int):
    """Batched 'same' linear convolution via circular FFT (torch.fft).
    planes (..., n_img, n_img); kernels broadcast against them."""
    nfft = _same_fft_size(n_img, n_ker)
    fp = torch.fft.rfft2(planes, s=(nfft, nfft))
    fk = torch.fft.rfft2(kernels, s=(nfft, nfft))
    full = torch.fft.irfft2(fp * fk, s=(nfft, nfft))
    off = (n_ker - 1) // 2
    return full[..., off:off + n_img, off:off + n_img]


def _dft_mats_np(n: int):
    a = np.arange(n)
    ang = np.mod(np.outer(a, a), n) * (2.0 * np.pi / n)
    return np.cos(ang), np.sin(ang)


def _dft_mats(n: int, device, dtype):
    """Symmetric real/imag DFT matrices W = C - iS, W[a,b]=exp(-2i pi ab/n),
    phases reduced mod n in integers before the trig."""
    return tuple(host_const(("dft", n, i), lambda i=i: _dft_mats_np(n)[i],
                            device, dtype) for i in range(2))


def _mm(precision):
    """``matmul`` at a tier of ``cfg.conv_precision``."""
    from ..ops.zoom_dft import matmul_tier
    return partial(matmul_tier, precision=precision)


def _dft_spectra(x, nfft: int, precision="highest"):
    """(re, im) of the symmetric circular DFT ``W x W`` of zero-padded
    ``x`` (..., h, w) at size ``nfft``: the kernel spectra of
    :func:`_dft_convolve_same` and of K2, every product at ``precision``
    (``ops/zoom_dft.py:matmul_tier``)."""
    c, s = _dft_mats(nfft, x.device, x.dtype)
    mm = _mm(precision)
    xp = F.pad(x, (0, nfft - x.shape[-1], 0, nfft - x.shape[-2]))
    a = mm(c, xp)
    b = mm(s, xp)
    return mm(a, c) - mm(b, s), -(mm(a, s) + mm(b, c))


def _dft_convolve_same(planes, kernels, n_img: int, n_ker: int,
                       precision="highest"):
    """'same' linear convolution via circular DFTs as real matmuls: the
    maths of :func:`_fft_convolve_same` with every transform a dense
    (nfft, nfft) product (6 real matmuls forward, 6 for the real part of
    the inverse), each at ``precision``."""
    nfft = _same_fft_size(n_img, n_ker)
    c, s = _dft_mats(nfft, planes.device, planes.dtype)
    mm = _mm(precision)
    fr, fi = _dft_spectra(planes, nfft, precision)
    gr, gi = _dft_spectra(kernels, nfft, precision)
    hr = fr * gr - fi * gi
    hi = fr * gi + fi * gr
    # real part of conj(W) H conj(W) / nfft^2
    a = mm(c, hr) - mm(s, hi)
    b = mm(c, hi) + mm(s, hr)
    full = (mm(a, c) - mm(b, s)) / (nfft * nfft)
    off = (n_ker - 1) // 2
    return full[..., off:off + n_img, off:off + n_img]


def _direct_convolve_same(planes, kernels, n_img: int, n_ker: int):
    """'same' linear convolution as a grouped direct convolution (a
    reference backend, as in the JAX package).  planes (nl, n, n);
    kernels (nl or 1, k, k).  True convolution (kernel flipped), to match
    ``scipy.signal.fftconvolve`` semantics."""
    nl = planes.shape[0]
    if kernels.shape[0] == 1:
        kernels = kernels.expand(nl, -1, -1)
    rhs = torch.flip(kernels, dims=(-2, -1))[:, None]    # (nl, 1, kh, kw)
    pad = (n_ker - 1) // 2
    return F.conv2d(planes[None], rhs, padding=pad, groups=nl)[0]


def tip_tilt_fwhm(seeing, GL, L0, cfg: GalacsiConfig):
    """Residual tip-tilt FWHM [px] from the high-layer seeing and the
    outer-scale attenuation coefficient (reference psfrec.py:881-903)."""
    seeing_hl = seeing * (1.0 - GL) ** 0.6
    r0_hl = 0.976 * 0.5 / seeing_hl / 4.85
    c_hl = tt_attenuation(L0)
    return (torch.sqrt(c_hl * 0.97 * 6.88 * (0.5e-6 / (2.0 * np.pi)) ** 2 *
                       8.0 ** (-1.0 / 3.0) * r0_hl ** (-5.0 / 3.0)) /
            4.85e-6 * 2.35 / cfg.pixscale)


def _conv_precision(cfg: GalacsiConfig, device) -> str:
    """The tier of the FFT-free convolution products for tensors on
    ``device``: ``cfg.conv_precision`` on the card, "highest" on the CPU.
    The JAX package hands the field to ``jnp.matmul`` and to its Pallas
    chain, which means passes of the TPU's matrix unit; off the TPU XLA
    contracts in full precision whatever the field says, and so does the
    port's CPU run, which the CPU tests hold to the JAX package's (the
    rule of ``otf/psf.py:_zoom_precision``)."""
    return cfg.conv_precision if torch.device(device).type == "cuda" \
        else "highest"


def convolve_final(psf, lbda_nm, seeing, GL, L0, cfg: GalacsiConfig):
    """AO PSF cubes (B, nl, n, n) -> final PSF cubes (tip-tilt, then the
    MUSE-intrinsic Moffat).  ``lbda_nm`` (nl,), ``seeing``/``GL``/``L0``
    (B,) tensors on the PSF's device.  On the FFT-free route every DFT
    product runs at :func:`_conv_precision`; K2 takes "highest" and
    "high" and raises on "default", as the JAX package's fused chain
    does."""
    n_img = psf.shape[-1]
    n_ker = n_img + (n_img % 2 == 0)  # force odd (psfrec.py:911-915)

    alpha_tt = moffat_fwhm_to_alpha(tip_tilt_fwhm(seeing, GL, L0, cfg), 2.0)
    k_tt = moffat_kernel(alpha_tt, 2.0, n_ker)            # (B, k, k)
    fwhm_i, beta_i, _, _ = muse_intrinsic_psf(lbda_nm)
    alpha_i = moffat_fwhm_to_alpha(fwhm_i / cfg.pixscale, beta_i)
    k_i = moffat_kernel(alpha_i, beta_i, n_ker)           # (nl, k, k)

    if not cfg.use_fft and cfg.use_fused_conv:
        # K2: both convolutions + the middle crop in one launch; the
        # kernel spectra stay plain contractions (the intrinsic set is
        # shared by all rows, the tip-tilt one is one kernel per row)
        from ..ops.conv_dft import fused_conv_chain
        nfft = _same_fft_size(n_img, n_ker)
        prec = _conv_precision(cfg, psf.device)
        gtt_r, gtt_i = _dft_spectra(k_tt, nfft, prec)
        gi_r, gi_i = _dft_spectra(k_i, nfft, prec)
        return fused_conv_chain(psf.contiguous(), gtt_r.contiguous(),
                                gtt_i.contiguous(), gi_r.contiguous(),
                                gi_i.contiguous(), n_ker, precision=prec)
    conv = _fft_convolve_same if cfg.use_fft else partial(
        _dft_convolve_same, precision=_conv_precision(cfg, psf.device))
    out = conv(psf, k_tt[:, None], n_img, n_ker)
    return conv(out, k_i[None], n_img, n_ker)
