"""Diagnostic plotting (PSF image, AO geometry, radial profile, fit trends).

Equivalent of reference ``plot_psf`` / ``radial_profile``
(psfrec.py:810-858), reading either an in-memory HDUList or a FITS path.
The port's own copy of ``muse_psfr_tpu/plotting.py`` (host numpy;
matplotlib is imported inside the functions that draw).
"""

import numpy as np

from .core.grids import direction_grid, lgs_positions
from .io.fits import fits_open
from .io.table import FitTable


def radial_profile(arr, binsize=1):
    """Azimuthally averaged profile around the (rounded) image centre."""
    y, x = np.ogrid[:arr.shape[0], :arr.shape[1]]
    r = np.hypot(y - int(arr.shape[0] / 2 + 0.5),
                 x - int(arr.shape[1] / 2 + 0.5))
    nbins = int(np.round(r.max() / binsize) + 1)
    bins = np.linspace(0, nbins * binsize, nbins + 1)
    counts = np.histogram(r, bins)[0]
    prof = np.histogram(r, bins, weights=arr)[0]
    centers = (bins[1:] + bins[:-1]) / 2
    return centers, prof / counts


def plot_directions(npts, lgs=None, ngs=None, ax=None):
    """Scatter of reconstruction directions and LGS/NGS positions
    (arcsec)."""
    import matplotlib.pyplot as plt
    if ax is None:
        _, ax = plt.subplots()
    d = direction_grid(npts)
    span = d.max()
    ax.scatter(d[0], d[1], marker="o", s=10, label="Reconstruction directions")
    if lgs is not None:
        span = max(span, lgs.max())
        ax.scatter(lgs[0], lgs[1], marker="*", s=60, label="LGS")
    if ngs is not None:
        span = max(span, ngs.max())
        ax.scatter(ngs[0], ngs[1], marker="*", s=40, label="NGS")
    ax.set_xlim((-1.25 * span, 1.25 * span))
    ax.set_ylim((-1.25 * span, 1.25 * span))
    ax.set_xlabel("arcsecond")
    ax.set_ylabel("arcsecond")
    ax.legend(loc="upper center")
    return ax


def plot_psf(source, npsflin=1):
    """2x3 diagnostic figure from a result HDUList or FITS file."""
    import matplotlib.pyplot as plt
    from matplotlib.colors import LogNorm

    hdul = fits_open(source)
    psf = hdul["PSF_MEAN"].data
    fit = FitTable.from_hdu(hdul["FIT_MEAN"])

    fig, axes = plt.subplots(2, 3, figsize=(12, 6), tight_layout=True)
    ax1, ax2, ax3 = axes[0]
    im = ax1.imshow(psf[1], origin="lower", norm=LogNorm())
    fig.colorbar(im, ax=ax1)
    ax1.set_title("PSF")
    ax2.axis("off")
    plot_directions(npsflin, lgs=lgs_positions(), ax=ax3)

    ax1, ax2, ax3 = axes[1]
    centers, prof = radial_profile(psf[1])
    ax1.plot(centers[1:], prof[1:], lw=1)
    ax1.set_yscale("log")
    ax1.set_title("radial profile")
    ax2.plot(fit["lbda"], fit["fwhm"][:, 0])
    ax2.set_title(r"$FWHM(\lambda)$")
    ax3.plot(fit["lbda"], fit["n"])
    ax3.set_title(r"$\beta(\lambda)$")
    return fig
