"""Public API: PSF reconstruction from one atmospheric condition.

Counterparts of ``muse_psfr_tpu/api.py:compute_psf`` and
``fit_table_from_arrays`` (reference psfrec.py:933-978), with an explicit
``device`` (default ``"cuda"``; raises when CUDA is unavailable).
"""

import numpy as np
import torch

from .config import DEFAULT_CONFIG
from .fit.moffat_fit import fit_moffat_cube
from .io.table import FitTable
from .parallel.batch import reconstruct_batch
from .utils.log import get_logger

logger = get_logger("api")

#: column order of the per-wavelength Moffat fit tables
_FIT_COLUMNS = ("center", "flux", "fwhm", "n", "peak", "err_center",
                "err_flux", "err_fwhm", "err_n", "err_peak")


def fit_table_from_arrays(lbda, fit, pixscale=0.2):
    """Moffat-fit arrays (leading axis = wavelength) -> FitTable, FWHM
    converted px -> arcsec (reference psfrec.py:868-869); the per-plane
    ``ok`` flag, when present, is appended as a float column."""
    t = FitTable()
    t["lbda"] = np.asarray(lbda, float)
    for k in _FIT_COLUMNS:
        v = np.asarray(fit[k], float)
        if k in ("fwhm", "err_fwhm"):
            v = v * pixscale
        t[k] = v
    if "ok" in fit:
        t["ok"] = np.asarray(fit["ok"], float)
    return t


def compute_psf(lbda, seeing, GL, L0, npsflin=1, h=(100, 10000),
                three_lgs_mode=False, verbose=True, cfg=DEFAULT_CONFIG,
                device="cuda"):
    """Reconstruct a PSF cube from one (seeing, GL, L0) condition.

    Returns ``(FitTable, psf ndarray (nl, dimpsf, dimpsf))``, the contract
    of the reference ``compute_psf`` (psfrec.py:933-978).
    """
    if verbose:
        logger.info("Compute PSF with seeing=%.2f GL=%.2f L0=%.2f",
                    seeing, GL, L0)
        if three_lgs_mode:
            logger.info("Using three lasers mode")
    lbda = np.atleast_1d(np.asarray(lbda, float))
    gs_mask = np.array([[1.0, 1.0, 1.0, 0.0 if three_lgs_mode else 1.0]])
    psf = reconstruct_batch([seeing], [GL], [L0], gs_mask, lbda, h=h,
                            npsflin=npsflin, cfg=cfg, device=device)[0]
    fit = fit_moffat_cube(torch.as_tensor(psf, device=device),
                          dtype=cfg.fit_dtype)
    res = fit_table_from_arrays(lbda, fit, cfg.pixscale)
    res.meta.update({"SEEING": seeing, "GL": GL, "L0": L0})
    res["SEEING"] = seeing
    res["GL"] = GL
    res["L0"] = L0
    return res, psf
