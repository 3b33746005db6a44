#!/usr/bin/env python3
"""Write a golden PSF cube from the float64 numpy oracle.

    python3 tools/make_golden_psf.py [--dim 2048] [--L0 25] [--out PATH]

The pinned telemetry row (seeing 1.0", GL 0.7) at outer scale ``--L0``
on the PSD grid ``--dim``, 35 wavelengths 490-930 nm, one direction,
through ``benchmarks/oracle_numpy.py`` (read only): the residual PSD,
the per-wavelength PSF at the MUSE sampling, the tip-tilt and intrinsic
convolutions.  The cube, (35, 40, 40) float64, goes to ``--out``, by
default ``tests/data/golden_psf_35l_s1.0_gl0.7_l0<L0>[_dim<dim>].npy``
(the suffix only off the default ``dim=1280``).  This writes

    tests/data/golden_psf_35l_s1.0_gl0.7_l025_dim2048.npy  (--dim 2048)
    tests/data/golden_psf_35l_s1.0_gl0.7_l02.0.npy         (--L0 2.0)

which ``tests/test_torch_highres.py`` ties to the port's float64 result
and ``chip_smoke.py`` reads on the card.  CPU only; under a minute at
``--dim 2048``.
"""

import argparse
import os
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
LBDA = np.linspace(490, 930, 35)


def golden_cube(dim, L0, seeing=1.0, GL=0.7):
    """The oracle's final PSF cube (35, 40, 40) of the pinned row."""
    sys.path.insert(0, ROOT)
    from benchmarks import oracle_numpy as orc
    psd = orc.simulate_psd([GL, 1 - GL], (100, 10000), seeing, L0,
                           npsflin=1, dim=dim)[0]
    psf = orc.psf_cube_from_psd(psd, LBDA)
    return orc.convolve_tt_and_instrument(psf, LBDA, seeing, GL, L0)


def default_name(dim, L0):
    """``L0`` as it was written on the command line."""
    suffix = "" if dim == 1280 else f"_dim{dim}"
    return os.path.join(ROOT, "tests", "data",
                        f"golden_psf_35l_s1.0_gl0.7_l0{L0}{suffix}.npy")


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--dim", type=int, default=1280)
    parser.add_argument("--L0", default="25")
    parser.add_argument("--out")
    args = parser.parse_args(argv)
    out = args.out or default_name(args.dim, args.L0)
    t0 = time.perf_counter()
    cube = golden_cube(args.dim, float(args.L0))
    np.save(out, cube)
    print(f"wrote {out}: {cube.shape} {cube.dtype} in "
          f"{time.perf_counter() - t0:.1f} s")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
