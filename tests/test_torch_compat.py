"""compat.py of the PyTorch port against ``muse_psfr_tpu.compat``: every
public name of the reference on the same numpy inputs, on the CPU in
float64.

Tolerances: 1e-10 relative to max|ref| for everything computed on tensors
(both packages run float64; the differences measured are 1e-16 to 2e-13,
the order of the sums in the transforms), exact equality for the
pure-numpy helpers and the integer pupil masks.  Small grids where the
function takes ``dim``; one production-size chain (dim 1280) reproduces
the CLI's result block.
"""

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

import muse_psfr_tpu.compat as jc  # noqa: E402
import muse_psfr_tpu_torch.compat as tc  # noqa: E402
from muse_psfr_tpu_torch import api as tapi  # noqa: E402
from _one_thread import one_thread  # noqa: E402

CPU = dict(device="cpu")
LB3 = np.array([500.0, 700.0, 900.0])
H2 = (100, 10000)

#: what ``muse_psfr/__init__.py`` re-exports from the JAX compat module
REFERENCE_NAMES = (
    "MIN_L0", "MAX_L0", "compute_psf", "compute_psf_from_sparta",
    "create_sparta_table", "fit_psf_with_polynom", "plot_psf",
    "radial_profile", "simul_psd_wfm", "psf_muse", "psd_to_psf", "dsp4muse",
    "seeing2r01", "pupil_mask", "direction_perf", "calc_var_from_psd",
    "psd_fit", "crop", "interpolate", "calc_mat_rec_glao_finale",
    "calc_dsp_res_glao_finale", "muse_intrinsic_psf", "convolve_final_psf",
    "fit_psf_cube")

#: the names that compute on tensors, with arguments small enough to fail
#: fast: each takes a keyword-only ``device`` that defaults to the card
_TENSOR_CALLS = {
    "calc_var_from_psd": (np.ones((8, 8)), 1.0 / 16, 8.0),
    "psd_fit": (16, 16.0, 0.1, 25.0, 1.5),
    "simul_psd_wfm": ([0.7, 0.3], H2, 1.0, 25.0),
    "psf_muse": (np.ones((320, 320)), LB3),
    "psd_to_psf": (np.ones((16, 16)), np.ones((4, 4)), 8.0, 5e-7),
    "muse_intrinsic_psf": (LB3,),
    "convolve_final_psf": (LB3, 1.0, 0.7, 25.0, np.ones((3, 8, 8))),
    "fit_psf_cube": (LB3, np.ones((3, 8, 8))),
}


def _close(got, want, tol=1e-10):
    got, want = np.asarray(got), np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert got.dtype == want.dtype, (got.dtype, want.dtype)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _grids(s=64, step=8 / 40):
    """Reference-style (f, arg_f) of an s x s FFT-ordered grid."""
    fx = np.fft.fftfreq(s, step)[:, None]
    fy = fx.T
    f = np.hypot(fx, fy)
    with np.errstate(all="ignore"):
        t = np.where(f == 0, 0.0, fy / fx)
    return f, np.arctan(t)


def _vk(f, r0, L0=25.0):
    return 0.0229 * r0 ** (-5 / 3) * (f ** 2 + 1.0 / L0 ** 2) ** (-11 / 6)


POSLGS = np.array([[1, 1], [-1, -1], [-1, 1], [1, -1]], float).T * 63 / 60
PITCHS = np.array([8 / 24, 8 / 24, 8 / 32, 8 / 16])


@pytest.mark.parametrize("name", REFERENCE_NAMES)
def test_every_reference_name_is_there(name):
    assert hasattr(jc, name) and hasattr(tc, name)
    if name in ("MIN_L0", "MAX_L0"):
        assert getattr(tc, name) == getattr(jc, name)
    elif name in ("compute_psf", "compute_psf_from_sparta"):
        assert getattr(tc, name) is getattr(tapi, name)
    else:
        assert callable(getattr(tc, name))


@pytest.mark.parametrize("name", sorted(_TENSOR_CALLS))
def test_tensor_functions_raise_without_a_card(name):
    """``device`` defaults to "cuda" and nothing falls back to the CPU."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        getattr(tc, name)(*_TENSOR_CALLS[name])
    with pytest.raises(TypeError):           # keyword-only
        getattr(tc, name)(*_TENSOR_CALLS[name], "cpu", "cpu", "cpu", "cpu",
                          "cpu", "cpu", "cpu")


def test_grid_functions_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    f, arg_f = _grids(16)
    with pytest.raises(RuntimeError, match="cuda"):
        tc.calc_mat_rec_glao_finale(f, arg_f, PITCHS, PITCHS, POSLGS,
                                    np.ones(4), None, 1.0, LSE=True)
    with pytest.raises(RuntimeError, match="cuda"):
        tc.calc_dsp_res_glao_finale(
            f, arg_f, PITCHS, POSLGS, np.zeros(2), np.ones(4),
            np.ones((2, 16, 16)), np.array([100.0, 1e4]), 1.0,
            np.ones((4, 16, 16)), 0.0, np.zeros(4), np.zeros((2, 2)))
    with pytest.raises(RuntimeError, match="cuda"):
        tc.dsp4muse(8.0, 40, 80, np.array([0.7, 0.3]),
                    np.array([100.0, 1e4]), 25.0, 0.1, 1, 1.0,
                    np.full(2, 12.0), np.zeros(2), "LSE", 24.0, 24.0, 1000.0,
                    2.5, 1.0, 0.5, POSLGS * 60, tc.direction_perf(1))


def test_seeing2r01():
    for args in ((1.0, 0.5, 0.0), (0.7, 0.6, 35.0),
                 (np.array([0.6, 1.4]), 0.5, 10.0)):
        got, want = tc.seeing2r01(*args), jc.seeing2r01(*args)
        assert got.dtype == np.float64
        assert_allclose(got, want, rtol=1e-14, atol=0)


@pytest.mark.parametrize("args,kw", [((5, 20), dict(oc=0.2)),
                                     ((160, 320), dict(oc=0.14)),
                                     ((4.5, 17), dict(inverse=True)),
                                     ((3, 8.0), {})])
def test_pupil_mask(args, kw):
    got, want = tc.pupil_mask(*args, **kw), jc.pupil_mask(*args, **kw)
    assert got.dtype.kind == "i" and got.dtype == want.dtype
    assert np.array_equal(got, want)


def test_numpy_helpers():
    for n in (1, 2, 3):
        assert np.array_equal(tc.direction_perf(n), jc.direction_perf(n))
    assert np.array_equal(tc.direction_perf(3, field_size=30),
                          jc.direction_perf(3, field_size=30))
    arr = np.random.default_rng(0).random((12, 12))
    assert np.array_equal(tc.crop(arr, 6, 3), jc.crop(arr, 6, 3))
    assert tc.crop(arr, 6.0, 3.0).shape == (6, 6)
    xout = np.random.default_rng(1).uniform(0, 11, (2, 5, 5))
    assert np.array_equal(tc.interpolate(arr, xout),
                          jc.interpolate(arr, xout))
    for mod in (tc, jc):
        with pytest.raises(NotImplementedError):
            mod.interpolate(arr, xout, method="cubic")


def test_psd_fit_and_var():
    got = tc.psd_fit(256, 16.0, 0.1, 25.0, 1.5, **CPU)
    want = jc.psd_fit(256, 16.0, 0.1, 25.0, 1.5)
    _close(got, want, 1e-12)
    assert got[0, 0] == 0.0 and got[128, 128] > 0.0
    v = tc.calc_var_from_psd(want, 1.0 / 16, 8.0, **CPU)
    assert isinstance(v, float)
    assert_allclose(v, jc.calc_var_from_psd(want, 1.0 / 16, 8.0), rtol=1e-12)


def test_muse_intrinsic_psf():
    lb = np.linspace(465.0, 930.0, 9)
    got, want = tc.muse_intrinsic_psf(lb, **CPU), jc.muse_intrinsic_psf(lb)
    assert len(got) == len(want) == 4
    for g, w in zip(got, want):
        _close(g, w, 1e-13)


@pytest.mark.parametrize("lse", [True, False])
def test_reconstructor_both_laws_unequal_pitches(lse):
    f, arg_f = _grids()
    sigr = np.array([1.0, 2.0, 0.5, 1.0])
    dsp = _vk(f, 0.15)[None]
    args = (f, arg_f, PITCHS, PITCHS, POSLGS, sigr, dsp, np.array([1.0]))
    got = tc.calc_mat_rec_glao_finale(*args, LSE=lse, **CPU)
    want = jc.calc_mat_rec_glao_finale(*args, LSE=lse)
    assert got.shape == (4, 1, 64, 64) and got.dtype == np.complex128
    _close(got, want)
    assert np.all(got[:, 0, 0, 0] == 0)                  # DC zeroed
    # the differing cutoffs bite
    assert np.any((got[3, 0] == 0) & (got[2, 0] != 0))


def test_reconstructor_rejects_several_layers():
    f, arg_f = _grids(16)
    for mod, kw in ((tc, CPU), (jc, {})):
        with pytest.raises(NotImplementedError):
            mod.calc_mat_rec_glao_finale(f, arg_f, PITCHS, PITCHS, POSLGS,
                                         np.ones(4), None,
                                         np.array([1.0, 5000.0]), LSE=True,
                                         **kw)


def _residual_inputs():
    f, arg_f = _grids()
    layers = _vk(f, np.array([0.7, 0.3])[:, None, None] ** (-3 / 5) * 0.15)
    wind = np.stack([12.0 * np.cos([0.6, -0.3]), 12.0 * np.sin([0.6, -0.3])])
    W = jc.calc_mat_rec_glao_finale(f, arg_f, PITCHS, PITCHS, POSLGS,
                                    np.ones(4), None, np.array([1.0]),
                                    LSE=True)
    return dict(f=f, arg_f=arg_f, layers=layers, wind=wind, W=W,
                h=np.array([100.0, 10000.0]), ti=np.full(4, 1e-3),
                beta=np.array([0.1, -0.2]))


@pytest.mark.parametrize("tempo,fitting", [(True, True), (False, False),
                                           (True, False), (False, True)])
def test_residual_psd_tempo_and_band_cut(tempo, fitting):
    d = _residual_inputs()
    args = (d["f"], d["arg_f"], PITCHS, POSLGS, d["beta"],
            np.array([1.0, 2.0, 0.5, 1.0]), d["layers"], d["h"], 1.0, d["W"],
            2.5e-3, d["ti"], d["wind"])
    got = tc.calc_dsp_res_glao_finale(*args, tempo=tempo, fitting=fitting,
                                      **CPU)
    want = jc.calc_dsp_res_glao_finale(*args, tempo=tempo, fitting=fitting)
    _close(got, want)
    assert got[0, 0] == 0
    if not fitting:
        assert got[30, 0] == 0 and got[4, 4] > 0   # beyond / inside the cut


@pytest.mark.parametrize("case", ["two_dm", "broadcast", "three_d_wmap"])
def test_residual_psd_dm_layers(case):
    d = _residual_inputs()
    W = d["W"][:, 0]
    wmap, h_dm = {"two_dm": (np.stack([0.6 * W, 0.4 * W], axis=1),
                             np.array([1.0, 10000.0])),
                  "broadcast": (W[:, None], np.array([1.0, 10000.0])),
                  "three_d_wmap": (W, 1.0)}[case]
    args = (d["f"], d["arg_f"], PITCHS, POSLGS, d["beta"], np.ones(4),
            d["layers"], d["h"], h_dm, wmap, 2.5e-3, d["ti"], d["wind"])
    got = tc.calc_dsp_res_glao_finale(*args, tempo=True, fitting=True, **CPU)
    want = jc.calc_dsp_res_glao_finale(*args, tempo=True, fitting=True)
    _close(got, want)


@pytest.mark.parametrize("law,npts", [("LSE", 1), ("MAP", 2)])
def test_dsp4muse(law, npts):
    r0ref = float(jc.seeing2r01(1.0, 0.5, 0))
    args = (8.0, 40, 80, np.array([0.7, 0.3]), np.array([100.0, 10000.0]),
            25.0, r0ref, 1, 1.0, np.full(2, 12.0),
            np.array([0.628163, -0.326497]), law, 24.0, 24.0, 1000.0, 2.5,
            1.0, 0.5, POSLGS * 60, jc.direction_perf(npts))
    got, want = tc.dsp4muse(*args, **CPU), jc.dsp4muse(*args)
    assert got.shape == (npts * npts, 80, 80)
    _close(got, want)
    # the IDL transpose: an off-axis direction's PSD is not symmetric
    if npts > 1:
        assert not np.allclose(got[1], got[1].T)


@pytest.mark.parametrize("kw", [{}, dict(npsflin=2, three_lgs_mode=True),
                                dict(zenith=40.0),
                                dict(npsflin=3, verbose=False)])
def test_simul_psd_wfm(kw):
    args = ([0.7, 0.3], H2, 1.0, 25.0)
    got = tc.simul_psd_wfm(*args, dim=320, **kw, **CPU)
    want = jc.simul_psd_wfm(*args, dim=320, **kw)
    assert got.shape == (kw.get("npsflin", 1) ** 2, 320, 320)
    _close(got, want, 1e-12)


def test_simul_psd_wfm_rejects_non_two_layer_profiles():
    for mod, kw in ((tc, CPU), (jc, {})):
        with pytest.raises(NotImplementedError):
            mod.simul_psd_wfm([0.5, 0.3, 0.2], (0, 5000, 10000), 1.0, 25.0,
                              verbose=False, **kw)


def test_three_lgs_mode_logs(caplog):
    with caplog.at_level("INFO", logger="muse_psfr.compat"):
        tc.simul_psd_wfm([0.7, 0.3], H2, 1.0, 25.0, dim=320,
                         three_lgs_mode=True, **CPU)
    assert "Using three lasers mode" in caplog.text


def _small_psd(dim=256, npup=64, D=8.0):
    L = D * dim / npup
    c = (dim - 1) / 2.0
    fx = (np.arange(dim) - c)[:, None] / L
    psd = _vk(np.hypot(fx, fx.T), 0.15) * (500.0 / (2 * np.pi)) ** 2
    return psd, np.asarray(jc.pupil_mask(npup / 2, npup, oc=0.14), float)


@pytest.mark.parametrize("samp", [None, 2, 1.5, 1.25, 1.0])
def test_psd_to_psf_live_branches(samp):
    """Nyquist and above (``samp`` None = the grid's own 4) and the
    sub-Nyquist central crop; ``return_all``."""
    psd, pup = _small_psd()
    got = tc.psd_to_psf(psd, pup, 8.0, 600e-9, samp=samp, return_all=True,
                        **CPU)
    want = jc.psd_to_psf(psd, pup, 8.0, 600e-9, samp=samp, return_all=True)
    assert isinstance(got[0], np.ndarray) and got[0].dtype == np.float64
    _close(got[0], np.asarray(want[0]))
    assert float(got[1]) == float(want[1])
    assert_allclose(got[2], want[2], rtol=1e-14)
    with one_thread():
        again = tc.psd_to_psf(psd, pup, 8.0, 600e-9, samp=samp,
                              return_all=True, **CPU)[0]
        alone = tc.psd_to_psf(psd, pup, 8.0, 600e-9, samp=samp, **CPU)
    assert np.array_equal(alone, again)


def test_psd_to_psf_static_phase():
    psd, pup = _small_psd()
    phase = 40.0 * np.random.default_rng(3).standard_normal(pup.shape)
    got = tc.psd_to_psf(psd, pup, 8.0, 700e-9, samp=2, phase_static=phase,
                        **CPU)
    want = np.asarray(jc.psd_to_psf(psd, pup, 8.0, 700e-9, samp=2,
                                    phase_static=phase))
    # the pupil angle reaches ~1e9 rad (phase in nm over lbda in m): one
    # rounding of it moves the PSF by ~1e-8 of its peak
    _close(got, want, 1e-6)
    flat = tc.psd_to_psf(psd, pup, 8.0, 700e-9, samp=2,
                         phase_static=np.zeros_like(pup), **CPU)
    assert_allclose(flat, tc.psd_to_psf(psd, pup, 8.0, 700e-9, samp=2,
                                        **CPU), atol=1e-12)
    assert np.abs(got - flat).max() > 1e-3 * flat.max()


@pytest.mark.parametrize("kw", [dict(samp=5), dict(samp=2, FoV=99.0)])
def test_psd_to_psf_rejects_the_reference_s_crashing_branches(kw):
    psd, pup = _small_psd()
    for mod, dev in ((tc, CPU), (jc, {})):
        with pytest.raises(NotImplementedError):
            mod.psd_to_psf(psd, pup, 8.0, 600e-9, **kw, **dev)


def test_psd_to_psf_logs_the_reference_s_notes(caplog):
    psd, pup = _small_psd(dim=96, npup=64)
    with caplog.at_level("INFO"):
        tc.psd_to_psf(psd, pup, 8.0, 600e-9, **CPU)
    assert "two time larger" in caplog.text
    assert "nyquist sampled" in caplog.text


@pytest.mark.parametrize("two_d", [False, True])
def test_psf_muse_convolve_and_fit(two_d):
    psd = jc.simul_psd_wfm([0.7, 0.3], H2, 1.0, 25.0, dim=320, npsflin=2,
                           verbose=False)
    psd = psd[0] if two_d else psd
    lam = LB3[:1] if two_d else LB3
    cube = tc.psf_muse(psd, lam, **CPU)
    want = jc.psf_muse(psd, lam)
    _close(cube, want)
    final = tc.convolve_final_psf(lam, 1.0, 0.7, 25.0, want, **CPU)
    want_final = jc.convolve_final_psf(lam, 1.0, 0.7, 25.0, want)
    _close(final, want_final)
    tbl, jtbl = tc.fit_psf_cube(lam, want_final, **CPU), \
        jc.fit_psf_cube(lam, want_final)
    assert tbl.colnames == jtbl.colnames
    for col in jtbl.colnames:
        assert_allclose(np.asarray(tbl[col], float),
                        np.asarray(jtbl[col], float), rtol=1e-8, atol=1e-10)
    # an iterable of planes, as the reference passes an mpdaf Cube
    with one_thread():
        tbl1 = tc.fit_psf_cube(lam, want_final, **CPU)
        tbl2 = tc.fit_psf_cube(lam, list(want_final), **CPU)
    assert np.array_equal(np.asarray(tbl2["fwhm"]), np.asarray(tbl1["fwhm"]))


def test_scalar_wavelength():
    psd = jc.simul_psd_wfm([0.7, 0.3], H2, 1.0, 25.0, dim=320, verbose=False)
    _close(tc.psf_muse(psd, 700.0, **CPU), jc.psf_muse(psd, 700.0))


def test_production_chain_reproduces_the_cli_block():
    """The reference's documented usage at dim 1280: (1.0", 0.7, 25 m) at
    500/700/900 nm gives the CLI's FWHM/BETA block."""
    args = ([0.7, 0.3], H2, 1.0, 25.0)
    psd = tc.simul_psd_wfm(*args, npsflin=1, dim=1280, **CPU)
    want_psd = jc.simul_psd_wfm(*args, npsflin=1, dim=1280)
    assert psd.shape == (1, 1280, 1280)
    _close(psd, want_psd, 1e-12)
    cube = tc.psf_muse(psd, LB3, **CPU)
    _close(cube, jc.psf_muse(want_psd, LB3))
    final = tc.convolve_final_psf(LB3, 1.0, 0.7, 25.0, cube, **CPU)
    tbl = tc.fit_psf_cube(LB3, final, **CPU)
    fwhm = ["%.2f" % v for v in np.asarray(tbl["fwhm"])[:, 0]]
    beta = ["%.2f" % v for v in np.asarray(tbl["n"])]
    assert fwhm == ["0.85", "0.73", "0.62"]
    assert beta == ["2.73", "2.55", "2.23"]
    assert_allclose(np.asarray(tbl["center"], float), 20, atol=1e-4)
