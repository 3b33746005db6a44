"""The PyTorch port's ``compute_psf_from_sparta`` and ``compute_psf``
against the JAX package's, on ``device="cpu"`` at ``TINY_CONFIG`` in
float64.

One seeded six-row SPARTA table mixes valid rows, three-laser rows (an
outlier L0, a non-positive ground-layer fraction) and an all-invalid row.
Tolerances are those ``tests/test_torch_batch.py`` holds the float64 night
to: the mean PSF <= 1e-10 x its max, fitted values <= 1e-8 relative
(<= 1e-6 on the planes whose fitted beta exceeds 5: a nearly Gaussian
profile leaves alpha and beta almost degenerate, and the fit amplifies
the 1e-10 difference of the cubes); names, order, bookkeeping columns and
log lines must be equal.
"""

import dataclasses
import io
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu import api as japi  # noqa: E402
from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu.io import fits as jfits  # noqa: E402
from muse_psfr_tpu.io import sparta as jsparta  # noqa: E402
from muse_psfr_tpu_torch import api as tapi  # noqa: E402
from muse_psfr_tpu_torch import state  # noqa: E402
from muse_psfr_tpu_torch.io import fits as tfits  # noqa: E402
from muse_psfr_tpu_torch.io import sparta as tsparta  # noqa: E402
from muse_psfr_tpu_torch.io.table import FitTable  # noqa: E402

JCFG = JTINY.with_(dtype="float64", fit_dtype="float64")
TCFG = state.config_from_reference(dataclasses.asdict(JCFG))
LB = np.array([700.0, 800.0, 900.0])
#: error columns divide by near-zero residuals in float64, so they are
#: held absolutely; everything else relatively
VALUE_COLUMNS = ("lbda", "center", "flux", "fwhm", "n", "peak", "ok",
                 "SEEING", "GL", "L0")


def _telemetry(sparta, fits):
    """The seeded six-row table, built with the given package's classes:
    rows 1 and 4 valid on four lasers, row 2 with an outlier L0 on laser
    4, row 3 invalid on every laser, row 5 with GL <= 0 on laser 2, row 6
    with two lasers out of range."""
    rng = np.random.default_rng(20260816)
    hdu = sparta.create_sparta_table(nlines=6)
    for k in range(1, 5):
        hdu.data["LGS%d_SEEING" % k] = rng.uniform(0.6, 1.6, 6)
        hdu.data["LGS%d_TUR_GND" % k] = rng.uniform(0.3, 0.9, 6)
        hdu.data["LGS%d_L0" % k] = rng.uniform(9.0, 29.0, 6)
    hdu.data["LGS4_L0"][1] = 150.0
    for k in range(1, 5):
        hdu.data["LGS%d_L0" % k][2] = 1000.0
    hdu.data["LGS2_TUR_GND"][4] = 0.0
    hdu.data["LGS1_L0"][5] = 5.0
    hdu.data["LGS3_L0"][5] = 31.0
    return fits.HDUList([fits.PrimaryHDU(), hdu])


def _lines(caplog):
    """The API's own log lines (the JAX batch layer also reports its
    compile warm-up, which the port does not have)."""
    return [(r.levelname, r.getMessage()) for r in caplog.records
            if r.name == "muse_psfr.api" and r.levelno >= logging.INFO]


def _run_both(caplog, **kw):
    """The port's result and log lines, then the JAX package's: both log
    under ``muse_psfr.api``, so each runs in its own captured block."""
    with caplog.at_level(logging.INFO, logger="muse_psfr"):
        caplog.clear()
        got = tapi.compute_psf_from_sparta(_telemetry(tsparta, tfits),
                                           lbda=LB, cfg=TCFG, chunk=4,
                                           device="cpu", **kw)
        got_lines = _lines(caplog)
        caplog.clear()
        want = japi.compute_psf_from_sparta(_telemetry(jsparta, jfits),
                                            lbda=LB, cfg=JCFG, chunk=4, **kw)
        want_lines = _lines(caplog)
    return got, got_lines, want, want_lines


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


@pytest.mark.parametrize("mean_of_lgs", [True, False])
def test_compute_psf_from_sparta_matches_jax(caplog, mean_of_lgs):
    got, got_lines, want, want_lines = _run_both(caplog,
                                                 mean_of_lgs=mean_of_lgs)
    names = ["PRIMARY", "SPARTA_ATM_DATA", "FIT_ROWS", "FIT_MEAN",
             "PSF_MEAN"]
    assert [h.name for h in got] == [h.name for h in want] == names
    assert got_lines == want_lines
    assert ("INFO", "3/6 : No valid values, skipping this row") in got_lines
    assert ("INFO", "2/6 : Using only 3 values out of 4 after outliers "
            "rejection") in got_lines
    assert ("INFO", "6/6 : Using only 2 values out of 4 after outliers "
            "rejection") in got_lines
    assert sum(m == "Using three lasers mode" for _, m in got_lines) == \
        (3 if mean_of_lgs else 3 + 3 + 2)

    assert got["SPARTA_ATM_DATA"].data.tobytes() == \
        want["SPARTA_ATM_DATA"].data.tobytes()
    for name in ("FIT_ROWS", "FIT_MEAN"):
        g, w = got[name].data, want[name].data
        assert g.dtype.names == w.dtype.names and g.dtype == w.dtype, name
        assert len(g) == len(w)
        limit = np.where(w["n"] > 5.0, 1e-6, 1e-8)
        for k in VALUE_COLUMNS:
            if k in g.dtype.names:
                rel = _rel(g[k], w[k])
                assert np.all(rel.reshape(len(g), -1).max(axis=1)
                              <= limit), (name, k)
        for k in g.dtype.names:
            if k.startswith("err_"):
                assert np.allclose(g[k], w[k], rtol=1e-5, atol=1e-12), \
                    (name, k)
    rows = got["FIT_ROWS"].data
    n_items = 5 if mean_of_lgs else 4 + 3 + 4 + 3 + 2
    assert len(rows) == n_items * LB.size
    assert np.array_equal(rows["row_idx"], want["FIT_ROWS"].data["row_idx"])
    assert np.array_equal(rows["lgs_idx"], want["FIT_ROWS"].data["lgs_idx"])
    assert np.array_equal(rows["row_idx"],
                          np.repeat(np.arange(1, n_items + 1), LB.size))
    if mean_of_lgs:
        assert set(rows["lgs_idx"]) == {-1}
    else:
        assert rows["lgs_idx"][::LB.size].tolist() == [
            1, 2, 3, 4, 1, 2, 3, 1, 2, 3, 4, 1, 3, 4, 2, 4]
    assert got["FIT_MEAN"].header.items() == want["FIT_MEAN"].header.items()
    assert [k for k in ("SEEING", "GL", "L0")
            if k in got["FIT_MEAN"].header] == ["SEEING", "GL", "L0"]

    g, w = got["PSF_MEAN"].data, want["PSF_MEAN"].data
    assert g.dtype == w.dtype == np.float64 and g.shape == (3, 8, 8)
    assert np.abs(g - w).max() <= 1e-10 * np.abs(w).max()

    # the file both writers produce opens in either package
    raw = io.BytesIO()
    got.writeto(raw)
    assert len(raw.getvalue()) % 2880 == 0
    back = jfits.fits_open(raw.getvalue())
    assert np.array_equal(back["FIT_ROWS"].data["row_idx"], rows["row_idx"])


def test_fit_mean_is_the_host_float64_refit_of_psf_mean():
    res = tapi.compute_psf_from_sparta(
        _telemetry(tsparta, tfits), lbda=LB, device="cpu", verbose=False,
        cfg=state.config_from_reference(dataclasses.asdict(JTINY)))
    from muse_psfr_tpu_torch.fit.moffat_fit import fit_moffat_cube_host64
    mean = res["PSF_MEAN"].data
    refit = fit_moffat_cube_host64(mean)
    table = FitTable.from_hdu(res["FIT_MEAN"])
    assert np.array_equal(table["n"], refit["n"])
    assert np.array_equal(table["fwhm"], refit["fwhm"] * 0.2)
    assert table.meta["SEEING"] == pytest.approx(
        np.median(FitTable.from_hdu(res["FIT_ROWS"])["SEEING"][::LB.size]))


@pytest.mark.parametrize("source", ["hdulist", "bytesio", "path"])
def test_input_forms(tmp_path, source):
    hdul = _telemetry(tsparta, tfits)
    if source == "bytesio":
        buf = io.BytesIO()
        hdul.writeto(buf)
        buf.seek(0)
        hdul = buf
    elif source == "path":
        path = str(tmp_path / "sparta.fits")
        hdul.writeto(path)
        hdul = path
    res = tapi.compute_psf_from_sparta(hdul, lmin=700, lmax=900, nl=2,
                                       cfg=TCFG, device="cpu",
                                       verbose=False)
    assert [h.name for h in res][2:] == ["FIT_ROWS", "FIT_MEAN", "PSF_MEAN"]
    assert np.allclose(res["FIT_MEAN"].data["lbda"], [700.0, 900.0])


def test_all_invalid_file_returns_none_with_a_warning(caplog):
    with caplog.at_level(logging.INFO, logger="muse_psfr"):
        caplog.clear()
        got = tapi.compute_psf_from_sparta(
            tfits.HDUList([tsparta.create_sparta_table(nlines=2, L0=1000)]),
            lbda=LB, cfg=TCFG, device="cpu")
        got_lines = _lines(caplog)
        caplog.clear()
        want = japi.compute_psf_from_sparta(
            jfits.HDUList([jsparta.create_sparta_table(nlines=2, L0=1000)]),
            lbda=LB, cfg=JCFG)
        want_lines = _lines(caplog)
    assert got is None and want is None
    assert got_lines == want_lines
    assert got_lines[-1] == ("WARNING", "No valid values")
    assert got_lines[1] == ("INFO",
                            "1/2 : No valid values, skipping this row")


def test_validation_bounds_equal_the_reference():
    assert (tapi.MIN_L0, tapi.MAX_L0) == (japi.MIN_L0, japi.MAX_L0) == (8, 30)


@pytest.mark.parametrize("three", [False, True])
def test_compute_psf_debug_summary_equals_jax(caplog, three):
    """``compute_psf`` logs the six-line DEBUG condition summary (r0,
    seeing, hbarre, vbarre with the truncated wind speed) like the JAX
    function, letter for letter."""
    args = (np.array([800.0, 900.0]), 0.9, 0.6, 17.0)

    def debug_lines(fn, **kw):
        with caplog.at_level(logging.DEBUG, logger="muse_psfr.api"):
            caplog.clear()
            fn(*args, h=(150, 12000), three_lgs_mode=three, **kw)
            return [r.getMessage() for r in caplog.records
                    if r.name == "muse_psfr.api"
                    and r.levelno == logging.DEBUG]

    got = debug_lines(tapi.compute_psf, cfg=TCFG, device="cpu")
    want = debug_lines(japi.compute_psf, cfg=JCFG)
    assert len(got) == 6
    assert got == want
    assert got[0].startswith("r0 0.5um (zenith)        = ")
    assert got[-1].startswith("vbarre                   = ")
    # silent above DEBUG
    with caplog.at_level(logging.INFO, logger="muse_psfr.api"):
        caplog.clear()
        tapi.compute_psf(*args, cfg=TCFG, device="cpu")
        assert all(r.levelno > logging.DEBUG for r in caplog.records)


def test_package_exports_the_user_layer():
    import muse_psfr_tpu as jpkg
    import muse_psfr_tpu_torch as tpkg
    missing = set(jpkg.__all__) - set(tpkg.__all__)
    # fft_available is the TPU runtime's probe, left out on purpose
    assert missing == {"fft_available"}
    assert len(tpkg.__all__) == len(jpkg.__all__) - 1
    assert set(tpkg.__all__) <= set(jpkg.__all__)
    for name in tpkg.__all__:
        assert hasattr(tpkg, name), name
