"""The PyTorch port's FITS codec, fit table, SPARTA table, polynomial
fit, plotting helpers and profiling hooks against the JAX package's.

The port keeps its own copies of these host-side modules, so the checks
are equalities: the same HDUs serialise to the same bytes, each package
reads the other's files, and the numpy helpers return identical arrays.
"""

import io
import logging

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu.fit import polynom as jpoly  # noqa: E402
from muse_psfr_tpu.io import fits as jfits  # noqa: E402
from muse_psfr_tpu.io import sparta as jsparta  # noqa: E402
from muse_psfr_tpu.io.table import FitTable as JFitTable  # noqa: E402
from muse_psfr_tpu import plotting as jplot  # noqa: E402
from muse_psfr_tpu_torch.fit import polynom as tpoly  # noqa: E402
from muse_psfr_tpu_torch.io import fits as tfits  # noqa: E402
from muse_psfr_tpu_torch.io import sparta as tsparta  # noqa: E402
from muse_psfr_tpu_torch.io.table import FitTable  # noqa: E402
from muse_psfr_tpu_torch import plotting as tplot  # noqa: E402
from muse_psfr_tpu_torch.utils import profiling  # noqa: E402


def _fit_table(cls, rng_seed=3, n=6):
    """A fit-result table as ``compute_psf_from_sparta`` builds it: scalar
    and 2-vector float columns, an integer column, meta."""
    rng = np.random.default_rng(rng_seed)
    t = cls()
    t["lbda"] = np.linspace(490.0, 930.0, n)
    t["center"] = rng.normal(size=(n, 2))
    t["fwhm"] = rng.uniform(2.0, 5.0, (n, 2))
    t["n"] = rng.uniform(1.5, 3.0, n)
    t["ok"] = np.ones(n)
    t["row_idx"] = np.arange(1, n + 1)
    t["lgs_idx"] = -1
    t.meta.update({"SEEING": 1.0, "GL": 0.7, "L0": 25.0})
    return t


def _result_hdus(mod, table_cls):
    """A result file's five HDUs, built from the given package's classes."""
    rng = np.random.default_rng(11)
    sparta = (jsparta if mod is jfits else tsparta).create_sparta_table(
        nlines=3, seeing=0.9, GL=0.6, L0=17.0, bad_l0=True)
    mean = _fit_table(table_cls, 5, 4)
    mean.remove_columns(["row_idx", "lgs_idx"])
    return mod.HDUList([
        mod.PrimaryHDU(), sparta,
        _fit_table(table_cls).to_hdu(name="FIT_ROWS"),
        mean.to_hdu(name="FIT_MEAN"),
        mod.ImageHDU(data=rng.random((4, 8, 8)), name="PSF_MEAN")])


def _sweep_hdus(mod, table_cls):
    """A sweep file's HDUs (``save_sweep``'s layout)."""
    rng = np.random.default_rng(12)
    grid = table_cls()
    for name, vals in (("SEEING", [0.8, 1.0, 1.2]), ("GL", [0.7, np.nan,
                                                            np.nan]),
                       ("L0", [25.0, 18.0, np.nan])):
        grid[name] = np.array(vals)[None, :]
    return mod.HDUList([
        mod.PrimaryHDU(),
        mod.ImageHDU(data=rng.random((3, 1, 2, 5)), name="FWHM"),
        mod.ImageHDU(data=rng.random((3, 1, 2, 5)), name="BETA"),
        grid.to_hdu(name="GRID")])


def _bytes(hdul):
    buf = io.BytesIO()
    hdul.writeto(buf)
    return buf.getvalue()


def _same_hdus(a, b):
    assert [h.name for h in a] == [h.name for h in b]
    for x, y in zip(a, b):
        assert x.header.items() == y.header.items(), x.name
        if x.data is None:
            assert y.data is None
        elif x.data.dtype.names:
            assert x.data.dtype == y.data.dtype
            for k in x.data.dtype.names:
                assert np.array_equal(x.data[k], y.data[k], equal_nan=True)
        else:
            assert np.array_equal(x.data, y.data)


@pytest.mark.parametrize("build", [_result_hdus, _sweep_hdus])
def test_writer_gives_the_jax_writers_bytes(build):
    got = _bytes(build(tfits, FitTable))
    want = _bytes(build(jfits, JFitTable))
    assert got == want
    assert len(got) % 2880 == 0


@pytest.mark.parametrize("build", [_result_hdus, _sweep_hdus])
def test_each_package_reads_the_others_file(build):
    raw = _bytes(build(tfits, FitTable))
    _same_hdus(tfits.fits_open(raw), jfits.fits_open(raw))
    jraw = _bytes(build(jfits, JFitTable))
    _same_hdus(tfits.fits_open(jraw), jfits.fits_open(raw))


def test_file_path_round_trip_and_overwrite(tmp_path):
    path = str(tmp_path / "res.fits")
    hdul = _result_hdus(tfits, FitTable)
    hdul.writeto(path)
    _same_hdus(tfits.fits_open(path), tfits.fits_open(_bytes(hdul)))
    assert tfits.fits_getheader(path, 1)["EXTNAME"] == "SPARTA_ATM_DATA"
    assert np.array_equal(tfits.fits_getdata(path, "PSF_MEAN"),
                          hdul["PSF_MEAN"].data)
    with pytest.raises(OSError, match="already exists"):
        hdul.writeto(path, overwrite=False)


def test_header_long_strings_hierarch_and_unsupported_hdu():
    """Cards a raw MUSE header carries: HIERARCH keys, a CONTINUE'd long
    string, an undefined value; an ASCII-table extension opens with a
    usable header and raises only at its data."""
    hdr = tfits.Header()
    hdr["HIERARCH ESO OBS NAME"] = ("WFM-AO-N_01", "OB name")
    hdr["LONGSTR"] = "x" * 150
    hdr["UNDEF"] = None
    jhdr = jfits.Header(list(hdr._cards))
    assert hdr.tobytes() == jhdr.tobytes()
    raw = _bytes(tfits.HDUList([tfits.PrimaryHDU(header=hdr)]))
    back = tfits.fits_getheader(raw)
    assert back["ESO OBS NAME"] == "WFM-AO-N_01"
    assert back.comments["HIERARCH ESO OBS NAME"] == "OB name"
    assert back["LONGSTR"] == "x" * 150 and back["UNDEF"] is None

    ascii_hdr = tfits.Header([("XTENSION", "TABLE", ""), ("BITPIX", 8, ""),
                              ("NAXIS", 2, ""), ("NAXIS1", 4, ""),
                              ("NAXIS2", 1, ""), ("PCOUNT", 0, ""),
                              ("GCOUNT", 1, ""), ("EXTNAME", "ASC", "")])
    raw = (_bytes(tfits.HDUList([tfits.PrimaryHDU()]))
           + ascii_hdr.tobytes() + b"abcd".ljust(2880, b"\x00"))
    hdul = tfits.fits_open(raw)
    assert isinstance(hdul["ASC"], tfits.UnsupportedHDU)
    with pytest.raises(NotImplementedError):
        hdul["ASC"].data


def test_fit_table_hdu_round_trip():
    t = _fit_table(FitTable)
    back = FitTable.from_hdu(tfits.fits_open(_bytes(
        tfits.HDUList([tfits.PrimaryHDU(), t.to_hdu(name="FIT_ROWS")]))
    )["FIT_ROWS"])
    assert back.colnames == t.colnames
    for k in t.colnames:
        assert back[k].dtype == t[k].dtype and back[k].shape == t[k].shape
        assert np.array_equal(back[k], t[k])
    assert back.meta == t.meta
    jback = JFitTable.from_hdu(_fit_table(JFitTable).to_hdu())
    assert jback.colnames == back.colnames and jback.meta == back.meta


@pytest.mark.parametrize("kw", [{}, {"bad_l0": True},
                                {"nlines": 4, "seeing": 0.8, "GL": 0.5,
                                 "L0": 12.0}])
def test_sparta_table_equals_jax(kw):
    got, want = tsparta.create_sparta_table(**kw), \
        jsparta.create_sparta_table(**kw)
    assert got.name == want.name == "SPARTA_ATM_DATA"
    assert got.data.dtype == want.data.dtype
    assert got.data.tobytes() == want.data.tobytes()
    values, hdul = tsparta.read_sparta_values(tfits.HDUList([got]))
    jvalues, _ = jsparta.read_sparta_values(jfits.HDUList([want]))
    assert values.shape == (kw.get("nlines", 1), 4, 3)
    assert np.array_equal(values, jvalues)
    assert values[0, 3, 2] == (150.0 if kw.get("bad_l0") else
                               kw.get("L0", 25))
    assert tsparta.LASER_COLUMNS == jsparta.LASER_COLUMNS


def test_sparta_table_through_bytesio():
    buf, jbuf = io.BytesIO(), io.BytesIO()
    tsparta.create_sparta_table(nlines=2, outfile=buf)
    jsparta.create_sparta_table(nlines=2, outfile=jbuf)
    assert buf.getvalue() == jbuf.getvalue()
    buf.seek(0)
    values, hdul = tsparta.read_sparta_values(buf)
    assert values.shape == (2, 4, 3) and np.all(values[:, :, 1] == 0.7)
    assert [h.name for h in hdul] == ["PRIMARY", "SPARTA_ATM_DATA"]


@pytest.mark.parametrize("output", [0, 1])
def test_fit_psf_with_polynom_equals_jax(output):
    rng = np.random.default_rng(5)
    lbda = np.linspace(490.0, 930.0, 12)
    fwhm = 0.9 - 3e-4 * (lbda - 490) + rng.normal(0, 1e-3, 12)
    beta = 2.8 - 1e-3 * (lbda - 490) + rng.normal(0, 1e-3, 12)
    got = tpoly.fit_psf_with_polynom(lbda, fwhm, beta, output=output)
    want = jpoly.fit_psf_with_polynom(lbda, fwhm, beta, output=output)
    assert got.keys() == want.keys()
    for k in want:
        assert np.array_equal(np.asarray(got[k]), np.asarray(want[k])), k
    assert np.array_equal(tpoly.norm_lbda(lbda), jpoly.norm_lbda(lbda))


@pytest.mark.parametrize("shape,binsize", [((8, 8), 1), ((12, 9), 2)])
def test_radial_profile_equals_jax(shape, binsize):
    arr = np.random.default_rng(6).random(shape)
    got = tplot.radial_profile(arr, binsize)
    want = jplot.radial_profile(arr, binsize)
    assert np.array_equal(got[0], want[0])
    assert np.array_equal(got[1], want[1], equal_nan=True)


def test_plot_psf_smoke():
    matplotlib = pytest.importorskip("matplotlib")
    matplotlib.use("Agg")
    import matplotlib.pyplot as plt
    fig = tplot.plot_psf(_result_hdus(tfits, FitTable), npsflin=3)
    assert len(fig.axes) >= 6
    plt.close(fig)


def test_span_logs_its_wall_at_debug(caplog):
    """A span logs its wall at DEBUG on ``muse_psfr.profile``; with no
    profiler active it records nothing."""
    profiling.reset()
    with caplog.at_level(logging.DEBUG, logger="muse_psfr.profile"):
        with profiling.span("a stage"):
            pass
    lines = [r.getMessage() for r in caplog.records
             if r.name == "muse_psfr.profile"]
    assert len(lines) == 1 and lines[0].startswith("span a stage")
    assert lines[0].endswith(" ms")
    assert caplog.records[0].levelno == logging.DEBUG
    assert profiling.spans() == []


def test_maybe_trace_is_a_no_op_without_the_variable(tmp_path, monkeypatch):
    monkeypatch.delenv("MUSE_PSFR_PROFILE_DIR", raising=False)
    with profiling.maybe_trace("region"):
        torch.ones(4).sum()
    assert list(tmp_path.iterdir()) == []


def test_maybe_trace_writes_a_chrome_trace(tmp_path, monkeypatch):
    import json
    monkeypatch.setenv("MUSE_PSFR_PROFILE_DIR", str(tmp_path))
    with profiling.maybe_trace("region", "cpu"):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = tmp_path / "region" / "trace.json"
    assert trace.exists()
    with open(trace) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)
