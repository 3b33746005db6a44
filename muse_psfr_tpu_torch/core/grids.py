"""Frequency/pupil grid primitives (host numpy, float64).

Counterpart of ``muse_psfr_tpu/core/grids.py`` for the grids the port's
pipeline uses; they are host constants placed on the device by the
callers.
"""

import numpy as np


def centered_freq_radius(dim: int, L: float):
    """|f| on the image-centred grid used by the fitting-error PSD.

    The reference centres this grid on ``(dim-1)/2`` and fftshifts it
    twice (psd_fit:618 plus simul_psd_wfm:144), the identity for even
    ``dim``; the grid is built centred directly (``dim`` must be even).
    """
    if dim % 2:
        raise ValueError("PSD grid size must be even")
    c = (dim - 1) / 2.0
    fx = ((np.arange(dim) - c) / L)[:, None]
    fy = fx.T
    return np.hypot(fx, fy)


def direction_grid(npts: int, field_size: float = 60.0):
    """``npts^2`` field evaluation positions [arcsec] (psfrec.py:154-158)."""
    g = (np.mgrid[:npts, :npts] - npts // 2) * field_size / 2.0
    return g.reshape(2, -1).astype(np.float64)


def lgs_positions(sep_lgs: float = 63.0):
    """The 4-LGS square geometry [arcsec]; 3-LGS mode keeps columns 0..2
    (the reference's fixed triangle, psfrec.py:86-91)."""
    pos = np.array([[1.0, -1.0, -1.0, 1.0],
                    [1.0, -1.0, 1.0, -1.0]]) * sep_lgs
    return pos
