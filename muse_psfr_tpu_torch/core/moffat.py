"""Moffat profiles: discrete kernels and the MUSE intrinsic PSF model.

PyTorch counterpart of ``muse_psfr_tpu/core/moffat.py``; replaces
``astropy.convolution.Moffat2DKernel`` (reference psfrec.py:916, 927) and
``muse_intrinsic_psf`` (psfrec.py:1144-1171).
"""

import numpy as np
import torch

from ..utils.device import host_const


def _radius2(size: int):
    """Squared distance of each pixel centre from the kernel's centre."""
    c = (size - 1) / 2.0
    y = (np.arange(size) - c)[:, None]
    x = (np.arange(size) - c)[None, :]
    return y * y + x * x


def _on_device(v, like):
    """``v`` (a tensor or a Python float) as a tensor of ``like``'s dtype
    on its device; a float is filled there, never copied from the
    host."""
    if torch.is_tensor(v):
        return v.to(like.dtype)
    return torch.full((), v, dtype=like.dtype, device=like.device)


def moffat_kernel(alpha, beta, size: int):
    """Discrete circular Moffat kernels, one per entry of ``alpha``.

    ``alpha``/``beta``: tensors of shape (B,) (``beta`` may also be a
    Python float).  Returns (B, size, size) with
    ``K(r) = (beta-1)/(pi alpha^2) * (1 + r^2/alpha^2)^(-beta)`` at pixel
    centres, centre ``(size-1)/2``: the analytic unit-integral amplitude
    with NO discrete renormalisation, as astropy's
    ``Moffat2DKernel(gamma=alpha, alpha=beta)`` array that the reference
    feeds to ``fftconvolve`` (psfrec.py:917, 928).  The absolute PSF scale
    (flux/peak columns, PSF_MEAN values) depends on this; FWHM/beta do not.
    """
    r2 = host_const(("moffat_r2", size), lambda: _radius2(size),
                    alpha.device, alpha.dtype)
    a = alpha[:, None, None]
    b = _on_device(beta, alpha)
    if b.ndim:
        b = b[:, None, None]
    rr = r2 / (a * a)
    return (b - 1.0) / (np.pi * a * a) * (1.0 + rr) ** (-b)


def moffat_fwhm_to_alpha(fwhm, beta):
    """Moffat core width from FWHM: ``alpha = fwhm/(2 sqrt(2^(1/b)-1))``."""
    k = _on_device(2.0 ** (1.0 / beta) - 1.0, fwhm)
    return fwhm / (2.0 * torch.sqrt(k))


# MUSE intrinsic PSF: degree-5 polynomials in the normalised wavelength
# (10*lbda_nm - 4750)/(9350 - 4750), fitted on commissioning data
# (reference psfrec.py:1160-1165).
_POL_BETA = (-0.83704697, 1.1337153, 0.0609222, -1.35581762,
             1.15237178, 2.2106042)
_POL_FWHM = (0.60467385, -1.58905792, 1.75293264, -1.0368302,
             0.21487023, 0.34851139)
_POL_BETA_STD = (0.18187424, -0.17841793, 0.30962616)
_POL_FWHM_STD = (0.00707504, -0.0303464, 0.04596354)


def _polyval(coeffs, x):
    acc = torch.zeros_like(x) + coeffs[0]
    for c in coeffs[1:]:
        acc = acc * x + c
    return acc


def muse_intrinsic_psf(lbda_nm):
    """MUSE-intrinsic Moffat ``(fwhm [arcsec], beta, fwhm_std, beta_std)``
    at wavelength(s) ``lbda_nm`` [nm] (a tensor)."""
    lb = (10.0 * lbda_nm - 4750.0) / (9350.0 - 4750.0)
    return (_polyval(_POL_FWHM, lb), _polyval(_POL_BETA, lb),
            _polyval(_POL_FWHM_STD, lb), _polyval(_POL_BETA_STD, lb))
