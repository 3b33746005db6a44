"""Frequency/pupil grid primitives (host numpy, float64).

Counterpart of ``muse_psfr_tpu/core/grids.py``: the grids are host
constants, placed on the device by the callers; :func:`fft_freq_polar`
and :func:`pupil_mask` return tensors, as their JAX counterparts return
device arrays.
"""

import numpy as np
import torch


def fft_freq_polar(n: int, step: float, dtype=torch.float32, device="cpu"):
    """FFT-ordered spatial-frequency grids ``(f, f_x, f_y)`` as tensors.

    ``f_x``/``f_y`` reproduce the reference's polar decomposition through
    ``arctan(fy/fx)`` with ``arg_f[0,0] = 0`` (psfrec.py:548-554), not
    ``arctan2``: ``f_x = |fx|`` and ``f_y = sign(fx)*fy``, a consistent
    per-frequency phasor conjugation that leaves the outputs unchanged and
    is kept so that the intermediates match bit for bit.
    """
    fx = np.fft.fftfreq(n, step)[:, None].astype(np.float64)
    fy = fx.T
    f = np.hypot(fx, fy)
    with np.errstate(all="ignore"):
        t = np.where((fx == 0.0) & (fy == 0.0), 0.0, fy / fx)
    arg = np.arctan(t)
    return tuple(torch.as_tensor(a, dtype=dtype, device=device)
                 for a in (f, f * np.cos(arg), f * np.sin(arg)))


def pupil_mask(radius: float, width: int, oc: float = 0.0,
               inverse: bool = False, dtype=torch.float32, device="cpu"):
    """Annular pupil as a tensor: 1 where ``oc <= rho < 1`` (rho in units
    of ``radius``), centred on ``(width-1)/2`` as the reference's
    ``pupil_mask`` (psfrec.py:190-203)."""
    c = (width - 1) / 2.0
    y = np.arange(width, dtype=np.float64)[:, None] - c
    x = np.arange(width, dtype=np.float64)[None, :] - c
    rho = np.hypot(y, x) / radius
    m = (rho < 1.0) & (rho >= oc)
    if inverse:
        m = ~m
    return torch.as_tensor(m.astype(np.float64), dtype=dtype, device=device)


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
