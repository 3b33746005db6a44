"""Reconstruct a full night of SPARTA telemetry and write the results.

Counterpart of ``examples/full_night.py`` of the JAX package:

    python -m muse_psfr_tpu_torch.examples.full_night [sparta.fits] \\
        [out.fits] [--device DEVICE]

Without a file a synthetic 100-row night is generated, the same
telemetry as the JAX script's.  ``--device`` defaults to ``cuda`` and
never falls back to the CPU (``--device cpu`` asks for it).
"""

import argparse
import os
import time

import numpy as np

from ..api import (compute_psf_from_sparta, create_sparta_table,
                   fit_psf_with_polynom)
from ..config import DEFAULT_CONFIG, TINY_CONFIG
from ..io.fits import HDUList
from ..io.table import FitTable

# MUSE_PSFR_TINY=1 runs the same code path on the tiny test grids (used
# by the example smoke test; also handy on CPU-only machines)
TINY = bool(os.environ.get("MUSE_PSFR_TINY"))
CFG = TINY_CONFIG if TINY else DEFAULT_CONFIG


def synthetic_night(nrows=4 if TINY else 100, seed=0):
    rng = np.random.default_rng(seed)
    hdu = create_sparta_table(nlines=nrows)
    for k in range(1, 5):
        hdu.data["LGS%d_SEEING" % k] = rng.uniform(0.6, 1.6, nrows)
        hdu.data["LGS%d_TUR_GND" % k] = rng.uniform(0.3, 0.9, nrows)
        hdu.data["LGS%d_L0" % k] = rng.uniform(9, 29, nrows)
    return HDUList([hdu])


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("sparta", nargs="?",
                        help="SPARTA telemetry file (default: a synthetic "
                             "night)")
    parser.add_argument("outfile", nargs="?", default="night_psf.fits")
    parser.add_argument("--device", default="cuda",
                        help="torch device the night runs on (default: "
                             "cuda)")
    args = parser.parse_args(argv)
    source = args.sparta if args.sparta is not None else synthetic_night()

    t0 = time.perf_counter()
    res = compute_psf_from_sparta(source, cfg=CFG, nl=9 if TINY else 35,
                                  device=args.device)
    print(f"reconstructed in {time.perf_counter() - t0:.2f}s")

    fit = FitTable.from_hdu(res["FIT_MEAN"])
    pol = fit_psf_with_polynom(fit["lbda"], fit["fwhm"][:, 0], fit["n"])
    print("FWHM(lambda) poly:", np.round(pol["fwhm_pol"], 4))
    print("beta(lambda) poly:", np.round(pol["beta_pol"], 4))
    res.writeto(args.outfile)
    print("wrote", args.outfile)


if __name__ == "__main__":
    main()
