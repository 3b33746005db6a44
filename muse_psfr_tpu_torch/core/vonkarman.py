"""von Karman turbulence spectra (PyTorch).

Two prefactor conventions coexist in the reference and are kept distinct:
the PSD driver uses the rounded ``0.0229`` (psfrec.py:544) while the
fitting-error PSD uses the exact gamma-function expression
(psfrec.py:622-623).  Mixing them shifts the PSD by ~2e-4 relative.
"""

from math import gamma, pi

import numpy as np
import torch

#: rounded prefactor used for the reconstruction/true-layer PSDs
CST_VK = 0.0229

#: exact Kolmogorov prefactor used for the fitting-error PSD
CST_VK_EXACT = ((gamma(11 / 6) ** 2 / (2 * pi ** (11 / 3))) *
                (24 * gamma(6 / 5) / 5) ** (5 / 6))


def vk_psd(f, r0, L0, cst=CST_VK):
    """von Karman phase PSD [rad^2 m^2] at spatial frequency ``f`` [1/m];
    ``r0``/``L0`` broadcast against ``f``."""
    return cst * r0 ** (-5.0 / 3.0) * (f ** 2 + 1.0 / L0 ** 2) ** (-11.0 / 6.0)


def fitting_psd(f_centered, r0, L0, fc):
    """Fitting-error PSD: von Karman (exact prefactor) for ``f >= fc``,
    zero below (reference psd_fit, psfrec.py:616-626).  ``f_centered`` is
    a tensor; ``r0``/``L0`` broadcast against it."""
    vk = vk_psd(f_centered, r0, L0, cst=CST_VK_EXACT)
    return torch.where(f_centered >= fc, vk, torch.zeros_like(vk))


def fitting_expansion_spec(l0_min: float, degree: int):
    """Taylor expansion of the fitting-PSD outer-scale dependence in
    ``u = 1/L0^2`` about ``u0 = u_max/2`` (see the JAX counterpart for the
    error analysis).  Returns ``(u0, binoms)`` as numpy float64."""
    u_max = 1.0 / (l0_min * l0_min)
    u0 = u_max / 2.0
    binoms = np.ones(degree + 1)
    for k in range(1, degree + 1):
        binoms[k] = binoms[k - 1] * (-11.0 / 6.0 - (k - 1)) / k
    return u0, binoms


def fitting_expansion_max_rel_error(l0_min: float, degree: int, fc: float,
                                    l0_grid=None):
    """Certified max relative error of :func:`fitting_expansion_spec` over
    ``L0 in [l0_min, 10000]`` and ``f >= fc`` (worst case ``f = fc``)."""
    u0, binoms = fitting_expansion_spec(l0_min, degree)
    if l0_grid is None:
        l0_grid = np.geomspace(l0_min, 1e4, 2001)
    u = 1.0 / l0_grid ** 2
    base = fc * fc + u0
    exact = (fc * fc + u) ** (-11.0 / 6.0)
    approx = sum(binoms[k] * (u - u0) ** k * base ** (-11.0 / 6.0 - k)
                 for k in range(degree + 1))
    return float(np.max(np.abs(approx - exact) / exact))
