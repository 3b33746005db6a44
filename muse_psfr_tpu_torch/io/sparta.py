"""SPARTA telemetry table I/O.

``create_sparta_table`` is the library's synthetic-telemetry backend
(reference psfrec.py:1123-1141): a SPARTA_ATM_DATA binary table with
per-laser SEEING / TUR_GND (ground-layer fraction) / L0 columns; also used
by the CLI ``--values`` path and by every test as the fake instrument.

``read_sparta_values`` extracts the (nrows, 4 lasers, 3 quantities) array
consumed by the batch pipeline.

The port's own copy of ``muse_psfr_tpu/io/sparta.py`` (host numpy only).
"""

import numpy as np

from .fits import BinTableHDU, fits_open

LASER_COLUMNS = ("SEEING", "TUR_GND", "L0")


def create_sparta_table(nlines=1, seeing=1, L0=25, GL=0.7, bad_l0=False,
                        outfile=None):
    """Synthesize a SPARTA_ATM_DATA table HDU with uniform laser values.

    ``bad_l0`` gives laser 4 an outlier L0 of 150 m (fault injection for
    the outlier-rejection path).  If ``outfile`` is given (path or
    file-like), a complete FITS file is written there.
    """
    names, values = [], []
    for k in range(1, 5):
        for col, v in (("SEEING", seeing), ("TUR_GND", GL), ("L0", L0)):
            names.append("LGS%d_%s" % (k, col))
            values.append(float(v))
    arr = np.empty(nlines, dtype=np.dtype([(n, "f8") for n in names]))
    for n, v in zip(names, values):
        arr[n] = v
    if bad_l0:
        arr["LGS4_L0"] = 150.0

    hdu = BinTableHDU(data=arr, name="SPARTA_ATM_DATA")
    if outfile is not None:
        hdu.writeto(outfile, overwrite=True)
    return hdu


def read_sparta_values(source, extname="SPARTA_ATM_DATA"):
    """-> (values (nrows, 4, 3) float array, source HDUList).

    Quantity order along the last axis follows :data:`LASER_COLUMNS`.
    """
    hdul = fits_open(source)
    data = hdul[extname].data
    nrows = len(data)
    values = np.empty((nrows, 4, 3))
    for k in range(4):
        for c, col in enumerate(LASER_COLUMNS):
            values[:, k, c] = data["LGS%d_%s" % (k + 1, col)]
    return values, hdul
