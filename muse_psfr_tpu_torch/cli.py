"""``muse-psfr-torch`` command line interface.

Counterpart of ``muse_psfr_tpu/cli.py``: behaviourally identical to the
reference CLI (same flags, same log/text output — the exact
LBDA/FWHM/BETA block is a test contract, reference
test_psfrec.py:121-128), organised around small helpers: input
resolution, reconstruction, formatting, and sinks.  One option more:
``--device`` (default ``cuda``), the CLI's form of the ``device=`` every
entry point of this package takes; without a CUDA card the default
raises, and ``--device cpu`` runs the plain PyTorch path.
"""

import argparse
import io
import logging
import sys

from . import __version__
from .api import compute_psf_from_sparta
from .io.fits import fits_getheader
from .io.sparta import create_sparta_table
from .utils.log import LOGGER_NAME

logger = logging.getLogger(LOGGER_NAME + ".cli")

_RULE = "-" * 68


def build_parser():
    parser = argparse.ArgumentParser(
        description=f"MUSE-PSFR version {__version__}")
    add = parser.add_argument
    add("raw", nargs="?",
        help="MUSE raw exposure (FITS) carrying a SPARTA_ATM_DATA "
             "telemetry extension")
    add("--values",
        help="skip the raw file and reconstruct directly from a "
             "'seeing,GL,L0' triple (arcsec, fraction, metres)")
    add("--logfile", default="muse_psfr.log",
        help="append the result block to this text file")
    add("-o", "--outfile",
        help="write the full result (per-row and mean Moffat fit tables "
             "+ mean PSF cube) to this FITS file")
    add("--njobs", default=-1, type=int,
        help="accepted for compatibility with the reference CLI; the "
             "rows run as one batch on --device regardless")
    add("--device", default="cuda",
        help="torch device the reconstruction runs on (default: cuda; "
             "there is no fallback to the CPU, ask for it with 'cpu')")
    add("--verbose", "-v", action="store_true",
        help="DEBUG-level logging (per-stage numerics)")
    add("--no-color", action="store_true",
        help="plain-text result block (no ANSI styling)")
    add("--plot", action="store_true",
        help="show the diagnostic figure (PSF image, geometry, radial "
             "profile, FWHM/beta trends)")
    add("--version", action="version", version="%(prog)s " + __version__)
    return parser


def _resolve_input(args):
    """-> (telemetry source, optional observation header line)."""
    if args.values:
        parts = [float(x) for x in args.values.split(",")]
        if len(parts) != 3:
            sys.exit("--values must contain a list of 3 comma-separated "
                     "values for seeing, GL, and L0")
        stream = io.BytesIO()
        create_sparta_table(outfile=stream, seeing=parts[0], GL=parts[1],
                            L0=parts[2])
        stream.seek(0)
        return stream, None

    if args.raw is None:
        sys.exit("no input file provided")
    hdr = fits_getheader(args.raw)
    line = "OB %s %s Airmass %.2f-%.2f" % (
        hdr.get("HIERARCH ESO OBS NAME"),
        hdr.get("DATE"),
        hdr.get("HIERARCH ESO TEL AIRM START", 0),
        hdr.get("HIERARCH ESO TEL AIRM END", 0),
    )
    logger.info(line)
    return args.raw, line


def _set_verbose():
    root = logging.getLogger(LOGGER_NAME)
    root.setLevel("DEBUG")
    root.handlers[0].setLevel("DEBUG")


def _colors_available(args):
    if args.no_color:
        return False
    try:
        import colorama  # noqa: F401
        return True
    except ImportError:
        return False


def _format_block(header_line, seeing, gl, l0, lbda, fwhm, beta, colored):
    """The result text block; colored variant wraps each line in ANSI
    styles via colorama (one color per wavelength)."""
    buf = io.StringIO()
    if header_line:
        buf.write(header_line + "\n")
    buf.write(_RULE + "\n")
    buf.write(f"Sparta Seeing: {seeing:.2f} arcsec GL: {gl:.2f} "
              f"L0:{l0:.2f} m\n")
    rows = (("LBDA", "%.0f", lbda), ("FWHM", "%.2f", fwhm),
            ("BETA", "%.2f", beta))
    if not colored:
        for name, fmt, vals in rows:
            buf.write(name + " " + " ".join(fmt % v for v in vals) + "\n")
    else:
        from colorama import Back, Fore, Style
        open_style = Back.BLACK + Style.BRIGHT + Fore.WHITE
        close_style = Fore.RESET + Style.NORMAL + Back.RESET
        tints = (Fore.BLUE, Fore.GREEN, Fore.RED)
        for name, fmt, vals in rows:
            cells = " ".join(t + fmt % v for t, v in zip(tints, vals))
            buf.write(f"{open_style}{name} {cells}{close_style}\n")
        buf.write(Style.RESET_ALL)
    buf.write(_RULE + "\n")
    return buf


def _emit(block, args):
    block.seek(0)
    for line in block:
        logger.info(line.rstrip("\n"))
    if args.logfile is not None:
        block.seek(0)
        with open(args.logfile, "a") as fd:
            fd.write("\nFile: {}\n".format(args.raw))
            fd.write(block.read())
        logger.info("Results saved to %s" % args.logfile)


def main(args=None):
    args = build_parser().parse_args(args)
    logger.info("MUSE-PSFR version %s", __version__)

    source, header_line = _resolve_input(args)

    logger.info("Computing PSF Reconstruction from Sparta data")
    if args.verbose:
        _set_verbose()

    res = compute_psf_from_sparta(source, lmin=500, lmax=900, nl=3,
                                  n_jobs=args.njobs, plot=args.plot,
                                  device=args.device)
    if not res:
        sys.exit("No results")

    data = res["FIT_MEAN"].data
    hdr = res["FIT_MEAN"].header
    block = _format_block(header_line, hdr["SEEING"], hdr["GL"], hdr["L0"],
                          data["lbda"] * 10, data["fwhm"][:, 0], data["n"],
                          colored=_colors_available(args))
    _emit(block, args)

    if args.outfile is not None:
        res.writeto(args.outfile, overwrite=True)
        logger.info("FITS file saved to %s" % args.outfile)
