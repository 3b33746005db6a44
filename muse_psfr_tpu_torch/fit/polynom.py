"""Polynomial fits of the Moffat FWHM(lambda) and beta(lambda) trends.

Equivalent of reference ``fit_psf_with_polynom`` (psfrec.py:1174-1210):
degree-(5, 5) least-squares polynomials over the normalised wavelength
``(lbda - 475)/(935 - 475) - 0.5``, with optional 50-point evaluation.
NumPy host-side (post-processing of fit tables); the port's own copy of
``muse_psfr_tpu/fit/polynom.py``.
"""

import numpy as np


def norm_lbda(lbda, lb1=475.0, lb2=935.0):
    return (np.asarray(lbda, float) - lb1) / (lb2 - lb1) - 0.5


def fit_psf_with_polynom(lbda, fwhm, beta, deg=(5, 5), output=0):
    """Fit FWHM(lambda) and beta(lambda) with polynomials.

    Returns a dict with ``fwhm_pol``, ``beta_pol`` (highest degree first,
    like ``np.polyfit``), ``lbda``, ``lbda_lim``; with ``output=1`` also a
    50-point evaluation (``lbda_fit``, ``fwhm_fit``, ``beta_fit``).
    """
    lb = norm_lbda(lbda)
    fwhm_pol = np.polyfit(lb, np.asarray(fwhm, float), deg[0])
    beta_pol = np.polyfit(lb, np.asarray(beta, float), deg[1])
    res = dict(fwhm_pol=fwhm_pol, beta_pol=beta_pol,
               lbda=np.asarray(lbda, float), lbda_lim=(475, 935))
    if output > 0:
        lbda_fit = np.linspace(475, 935, 50)
        lbf = norm_lbda(lbda_fit)
        res["lbda_fit"] = lbda_fit
        res["fwhm_fit"] = np.polyval(fwhm_pol, lbf)
        res["beta_fit"] = np.polyval(beta_pol, lbf)
    return res
