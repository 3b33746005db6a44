"""The ``muse-psfr-torch`` CLI on ``--device cpu``: the reference's exact
result block at the production config (1 row x 3 wavelengths), the raw
file path, the error exits, the options (the JAX CLI's plus ``--device``),
and the same block through ``python -m muse_psfr_tpu_torch``.
"""

import logging
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu import cli as jcli  # noqa: E402
from muse_psfr_tpu_torch import cli  # noqa: E402
from muse_psfr_tpu_torch.io.fits import (Header, HDUList, ImageHDU,  # noqa: E402
                                         PrimaryHDU, fits_open)
from muse_psfr_tpu_torch.io.sparta import create_sparta_table  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BLOCK = [
    "-" * 68,
    "Sparta Seeing: 1.00 arcsec GL: 0.70 L0:25.00 m",
    "LBDA 5000 7000 9000",
    "FWHM 0.85 0.73 0.62",
    "BETA 2.73 2.55 2.23",
    "-" * 68,
]
HDUS = ["PRIMARY", "SPARTA_ATM_DATA", "FIT_ROWS", "FIT_MEAN", "PSF_MEAN"]


def _log_lines(path):
    with open(path) as fh:
        return fh.read().splitlines()


def test_values_block_is_exact_at_the_production_config(tmp_path, caplog):
    logfile, outfile = str(tmp_path / "run.log"), str(tmp_path / "out.fits")
    with caplog.at_level(logging.INFO, logger="muse_psfr"):
        caplog.clear()
        cli.main(["--values", "1,0.7,25", "--device", "cpu", "--no-color",
                  "-o", outfile, "--logfile", logfile])
        messages = [r.getMessage() for r in caplog.records
                    if r.levelno == logging.INFO]
    assert _log_lines(logfile) == ["", "File: None"] + BLOCK
    assert messages[:4] == [
        "MUSE-PSFR version %s" % cli.__version__,
        "Computing PSF Reconstruction from Sparta data",
        "Processing SPARTA table with 1 values, njobs=1 ...",
        "Compute PSF with seeing=1.00 GL=0.70 L0=25.00"]
    assert messages[4:10] == BLOCK
    assert messages[10:] == ["Results saved to %s" % logfile,
                             "FITS file saved to %s" % outfile]
    hdul = fits_open(outfile)
    assert [h.name for h in hdul] == HDUS
    assert os.path.getsize(outfile) % 2880 == 0
    assert hdul["PSF_MEAN"].data.shape == (3, 40, 40)
    assert np.allclose(hdul["FIT_MEAN"].data["lbda"], [500.0, 700.0, 900.0])


def test_raw_file_path_prints_the_observation_line(tmp_path):
    testfile = str(tmp_path / "sparta.fits")
    create_sparta_table(outfile=testfile)
    logfile, outfile = str(tmp_path / "run.log"), str(tmp_path / "out.fits")
    cli.main([testfile, "--device", "cpu", "--no-color", "--logfile",
              logfile, "--outfile", outfile])
    assert _log_lines(logfile) == (["", "File: %s" % testfile,
                                    "OB None None Airmass 0.00-0.00"] + BLOCK)
    with open(outfile, "rb") as fh:
        assert [h.name for h in fits_open(fh.read())] == HDUS


def test_raw_exposure_header_is_read_without_decoding_images(tmp_path):
    """OBS cards in the primary header and a BZERO-convention uint16 CHAN
    image beside the SPARTA table, as a raw exposure carries them."""
    hdr = Header()
    hdr["HIERARCH ESO OBS NAME"] = "TestOB"
    hdr["DATE"] = "2026-08-19"
    hdr["HIERARCH ESO TEL AIRM START"] = 1.2
    hdr["HIERARCH ESO TEL AIRM END"] = 1.3
    chan = (np.arange(64 * 48) % 65536).astype(np.uint16).reshape(64, 48)
    testfile = str(tmp_path / "raw.fits")
    HDUList([PrimaryHDU(header=hdr), ImageHDU(data=chan, name="CHAN01"),
             create_sparta_table(L0=1000)]).writeto(testfile)

    class Args:
        values, raw = None, testfile

    source, line = cli._resolve_input(Args)
    assert source == testfile
    assert line == "OB TestOB 2026-08-19 Airmass 1.20-1.30"
    with pytest.raises(SystemExit, match="No results"):
        cli.main([testfile, "--device", "cpu", "--no-color", "--logfile",
                  str(tmp_path / "run.log")])


@pytest.mark.parametrize("argv,message", [
    (["--values", "1,0.7"], "--values must contain a list of 3"),
    ([], "no input file provided"),
    (["--values", "1,0.7,1000", "--device", "cpu"], "No results"),
])
def test_error_exits(tmp_path, monkeypatch, argv, message):
    monkeypatch.chdir(tmp_path)          # the default logfile lands here
    with pytest.raises(SystemExit, match=message):
        cli.main(argv)


def test_default_device_raises_without_a_card(tmp_path, monkeypatch):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--values", "1,0.7,25", "--no-color"])
    assert not os.path.exists(tmp_path / "muse_psfr.log")


def test_options_are_the_jax_clis_plus_device():
    def options(parser):
        return {a.dest: (tuple(a.option_strings), a.default, a.nargs)
                for a in parser._actions}

    got, want = options(cli.build_parser()), options(jcli.build_parser())
    assert got.pop("device") == (("--device",), "cuda", None)
    assert got == want


@pytest.mark.parametrize("header", [None, "OB x y Airmass 1.00-1.10"])
def test_format_block_equals_jax(header):
    args = (header, 1.0, 0.7, 25.0, np.array([5000.0, 7000.0, 9000.0]),
            np.array([0.853, 0.728, 0.624]), np.array([2.731, 2.549, 2.23]))
    got = cli._format_block(*args, colored=False).getvalue()
    assert got == jcli._format_block(*args, colored=False).getvalue()
    assert got.splitlines()[-5:] == BLOCK[1:]

    class NoColor:
        no_color = True

    assert cli._colors_available(NoColor) is False


def test_module_entry_point_in_a_fresh_process(tmp_path):
    """``python -m muse_psfr_tpu_torch`` runs the CLI; the block goes to
    the log file and to stdout, and no JAX module is loaded."""
    env = dict(os.environ, PYTHONPATH=ROOT)
    logfile = str(tmp_path / "run.log")
    out = subprocess.run(
        [sys.executable, "-m", "muse_psfr_tpu_torch", "--values", "1,0.7,25",
         "--device", "cpu", "--no-color", "--logfile", logfile],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=600)
    assert out.returncode == 0, out.stderr
    assert _log_lines(logfile)[2:] == BLOCK
    assert "[INFO] FWHM 0.85 0.73 0.62" in out.stdout
    assert "[INFO] BETA 2.73 2.55 2.23" in out.stdout

    bad = subprocess.run(
        [sys.executable, "-m", "muse_psfr_tpu_torch", "--values", "1,0.7"],
        env=env, cwd=str(tmp_path), capture_output=True, text=True,
        timeout=600)
    assert bad.returncode != 0 and "--values must contain" in bad.stderr


def test_verbose_switches_the_package_logger_to_debug():
    root = logging.getLogger("muse_psfr")
    level, handler_level = root.level, root.handlers[0].level
    try:
        cli._set_verbose()
        assert root.level == logging.DEBUG
        assert root.handlers[0].level == logging.DEBUG
    finally:
        root.setLevel(level)
        root.handlers[0].setLevel(handler_level)
