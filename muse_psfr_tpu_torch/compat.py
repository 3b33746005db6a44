"""Reference-compatible API: every public name of ``muse_psfr.psfrec``.

The reference package exports its whole module namespace
(``from .psfrec import *``); code written against it can

    import muse_psfr_tpu_torch.compat as muse_psfr

and keep working.  Counterpart of ``muse_psfr_tpu/compat.py``: each
function keeps the reference's positional signature and output
conventions (NumPy float64 arrays, int pupil masks) while computing on
PyTorch tensors.

The reference runs float64 end to end, and PyTorch has float64 on the CPU
and on the card alike, so everything here computes in float64 on either.
The functions that compute on tensors take a keyword-only ``device``
(default ``"cuda"``; no card, no result, as everywhere in this package);
the pure-numpy helpers (:func:`crop`, :func:`interpolate`,
:func:`direction_perf`, :func:`seeing2r01`, :func:`pupil_mask`) take
none.  The hand-written kernels are float32 only, so on the card the shim
switches them off (``use_fused_zoom=False, use_fused_conv=False``): compat
launches no kernel, as the JAX package's shim on its CPU backend runs no
Pallas kernel.

Reference citations are per function; reference source is
``muse_psfr/psfrec.py`` unless stated.
"""

import logging

import numpy as np
import torch

from .api import (MIN_L0, MAX_L0, compute_psf, compute_psf_from_sparta,  # noqa: F401
                  fit_table_from_arrays)
from .config import DEFAULT_CONFIG
from .core.grids import (centered_freq_radius, direction_grid,
                         fft_freq_polar, lgs_positions,
                         pupil_mask as _pupil_mask_f)
from .core.moffat import muse_intrinsic_psf as _intrinsic
from .core.vonkarman import fitting_psd
from .fit.moffat_fit import fit_moffat_cube
from .fit.polynom import fit_psf_with_polynom  # noqa: F401
from .io.sparta import create_sparta_table  # noqa: F401
from .otf.convolve import convolve_final
from .otf.psf import psf_cube, psd_to_psf as _psd_to_psf_impl
from .plotting import plot_psf, radial_profile, plot_directions  # noqa: F401
from .psd import model as _m
from .utils.device import resolve_device

logger = logging.getLogger("muse_psfr.compat")

_F64, _C128 = torch.float64, torch.complex128


def _t(x, dev):
    """``x`` as a float64 tensor on ``dev`` (a copy: the caller's array
    may be read-only)."""
    return torch.as_tensor(np.array(x, np.float64), device=dev)


def _np(t):
    return t.cpu().numpy()


def _cfg64(**kw):
    """The float64 config of the shim: the float32-only kernels off."""
    return DEFAULT_CONFIG.with_(dtype="float64", use_fused_zoom=False,
                                use_fused_conv=False, **kw)


def psd_to_psf(psd, pup, D, lbda, phase_static=None, samp=None, FoV=None,
               return_all=False, *, device="cuda"):
    """General PSD->PSF forward model in float64 (see
    ``muse_psfr_tpu_torch.otf.psf.psd_to_psf``); NumPy out."""
    out = _psd_to_psf_impl(np.array(psd, np.float64),
                           np.array(pup, np.float64), D, lbda,
                           phase_static=phase_static, samp=samp, FoV=FoV,
                           return_all=return_all, dtype=_F64, device=device)
    if return_all:
        return (_np(out[0]),) + tuple(out[1:])
    return _np(out)


def seeing2r01(seeing, lbda, zenith):
    """Fried parameter from seeing (reference psfrec.py:183-187)."""
    return np.asarray(_m.seeing_to_r0(np.asarray(seeing, float), lbda,
                                      zenith), float)


def pupil_mask(radius, width, oc=0, inverse=False):
    """Annular pupil mask, int array (reference psfrec.py:190-203)."""
    return _np(_pupil_mask_f(radius, int(width), oc, inverse,
                             _F64)).astype(int)


def direction_perf(npts, field_size=60, plot=False, lgs=None, ngs=None,
                   ax=None):
    """Field evaluation grid [arcsec] (reference psfrec.py:154-180)."""
    if plot:
        plot_directions(npts, lgs=lgs, ngs=ngs, ax=ax)
    return direction_grid(npts, field_size)


def calc_var_from_psd(psd, pixsize, Dpup, *, device="cuda"):
    """Residual variance excluding the 1/D box (psfrec.py:206-215)."""
    return float(_m.residual_variance(_t(psd, resolve_device(device)),
                                      pixsize, Dpup))


def psd_fit(dim, L, r0, L0, fc, *, device="cuda"):
    """Fitting-error PSD, FFT-ordered (reference psfrec.py:616-626)."""
    out = fitting_psd(_t(centered_freq_radius(int(dim), L),
                         resolve_device(device)), r0, L0, fc)
    # the reference returns the fftshifted-grid (= FFT-ordered) variant
    return np.fft.fftshift(_np(out))


def crop(arr, center, size):
    """Central square crop (reference psfrec.py:629-632)."""
    center, size = int(center), int(size)
    sl = slice(center - size, center + size)
    return arr[sl, sl]


def interpolate(arr, xout, method="linear"):
    """IDL-``interpolate`` shim on index coordinates (psfrec.py:635-641)."""
    if method == "cubic":
        raise NotImplementedError("cubic interpolation is unimplemented in "
                                  "the reference as well")
    from scipy.interpolate import interpn
    xin = np.arange(arr.shape[0])
    return interpn((xin, xin), np.asarray(arr), np.asarray(xout).T,
                   method="linear").T


def _grids_from_ref(f, arg_f, dev):
    """Reference-style (f, arg_f) -> (f, f_x, f_y) tensors."""
    f, arg_f = _t(f, dev), _t(arg_f, dev)
    return f, f * torch.cos(arg_f), f * torch.sin(arg_f)


def calc_mat_rec_glao_finale(f, arg_f, pitchs_wfs, pitchs_dm, poslgs, sigr,
                             DSP_tab_recons, h_recons, LSE=False, *,
                             device="cuda"):
    """GLAO/tomographic reconstructor (reference psfrec.py:218-364).

    Output shape (nb_gs, nb_h_recons, s, s); only one reconstructed layer
    is supported (the reference raises NotImplementedError for more,
    psfrec.py:341).
    """
    h_recons = np.atleast_1d(h_recons)
    if h_recons.size > 1:
        raise NotImplementedError("multi-layer tomographic inversion is "
                                  "unimplemented in the reference as well")
    dev = resolve_device(device)
    f, f_x, f_y = _grids_from_ref(f, arg_f, dev)
    poslgs = _t(poslgs, dev)
    nb_gs = poslgs.shape[1]
    dsp_recons = None
    if not LSE:
        dsp_recons = _t(np.atleast_3d(DSP_tab_recons)
                        .reshape(-1, f.shape[0], f.shape[1])[0], dev)
    W = _m.glao_reconstructor(f, f_x, f_y, poslgs,
                              torch.ones(nb_gs, dtype=_F64, device=dev),
                              _t(sigr, dev), _t(pitchs_wfs, dev),
                              float(h_recons[0]), _C128,
                              dsp_recons=dsp_recons)
    return _np(W)[:, None]


def calc_dsp_res_glao_finale(f, arg_f, pitchs_wfs, poslgs, beta, sigv,
                             DSP_tab_vrai, h_vrai, h_dm, Wmap, td, ti, wind,
                             tempo=False, fitting=False, err_recons=None,
                             err_noise=None, *, device="cuda"):
    """Residual phase PSD for one direction (reference psfrec.py:367-528)."""
    dev = resolve_device(device)
    f, f_x, f_y = _grids_from_ref(f, arg_f, dev)
    poslgs = _t(poslgs, dev)
    nb_gs = poslgs.shape[1]
    h_vrai = np.atleast_1d(np.asarray(h_vrai, float))
    if not tempo:
        wind = np.zeros((2, h_vrai.size))
        ti = np.zeros(nb_gs)
        td = 0.0
    W = np.asarray(Wmap, complex)
    if W.ndim == 3:
        W = W[:, None]                        # (nb_gs, 1, s, s)
    h_dm_arr = np.atleast_1d(np.asarray(h_dm, float))
    if h_dm_arr.size > 1 or W.shape[1] > 1:
        # multiple DM layers: the reference sums the per-DM phasor
        # against Wmap (psfrec.py:460-471, 'sum on nb_h_dm', with numpy
        # broadcasting when the axes mismatch).  Fold that sum into an
        # effective per-GS reconstructor and hand the single-DM core
        # h_dm=0: its own phasor is then exactly 1, reproducing the
        # reference computation in host float64.
        bx, by = float(np.asarray(beta)[0]), float(np.asarray(beta)[1])
        fxn, fyn = _np(f_x), _np(f_y)
        proj_dm = np.exp(1j * 2 * np.pi * h_dm_arr[:, None, None]
                         * 60 / 206265 * (bx * fxn + by * fyn))
        W_eff = np.sum(proj_dm[None] * W, axis=1)
        h_dm_eff = 0.0
    else:
        W_eff, h_dm_eff = W[:, 0], float(h_dm_arr[0])
    res = _np(_m.residual_psd_one_dir(
        f, f_x, f_y, poslgs, torch.ones(nb_gs, dtype=_F64, device=dev),
        _t(beta, dev), _t(sigv, dev), _t(DSP_tab_vrai, dev), _t(h_vrai, dev),
        h_dm_eff, torch.as_tensor(np.array(W_eff), dtype=_C128, device=dev), float(td),
        _t(ti, dev), _t(wind, dev), _t(pitchs_wfs, dev), _C128))
    if fitting:
        return res
    fc = np.max(1.0 / (2.0 * np.asarray(pitchs_wfs)))
    fn, fxn, fyn = (_np(a) for a in (f, f_x, f_y))
    return np.where((fn != 0) & (abs(fxn) <= fc) & (abs(fyn) <= fc), res, 0)


def dsp4muse(Dpup, pupdim, dimall, Cn2, hh, L0, r0ref, recons_cn2, h_recons,
             vent, arg_v, law, nsspup, nact, Fsamp, delay, bruitLGS2,
             lambdaref, poslgs, dirperf, *, device="cuda"):
    """Correction-zone PSD routine (reference psfrec.py:531-613): von Karman
    layer PSDs, one reconstructor, one residual PSD per direction, IDL
    row/column transpose."""
    dev = resolve_device(device)
    poslgs1 = np.asarray(poslgs, float) / 60.0
    dirperf1 = np.atleast_2d(np.asarray(dirperf, float)) / 60.0
    dimall = int(dimall)
    f, f_x, f_y = fft_freq_polar(dimall, Dpup / pupdim, _F64, dev)
    f_np = _np(f)

    cst = 0.0229
    recons_cn2 = np.atleast_1d(recons_cn2)
    dsp_recons = (cst * (recons_cn2[0] ** (-3 / 5) * r0ref) ** (-5 / 3)
                  * (f_np ** 2 + 1.0 / L0 ** 2) ** (-11 / 6))
    hh = np.atleast_1d(np.asarray(hh, float))
    Cn2 = np.atleast_1d(np.asarray(Cn2, float))
    dsp_vrai = (cst * (Cn2[:, None, None] ** (-3 / 5) * r0ref) ** (-5 / 3)
                * (f_np[None] ** 2 + 1.0 / L0 ** 2) ** (-11 / 6))

    nb_gs = poslgs1.shape[1]
    sig2 = _t(np.repeat(bruitLGS2, nb_gs), dev)
    ti = _t(np.repeat(1.0 / Fsamp, nb_gs), dev)
    td = delay * 1e-3
    pitchs_wfs = _t(np.repeat(Dpup / nsspup, nb_gs), dev)
    h_dm = 1.0
    wind = _t(np.stack([vent * np.cos(arg_v), vent * np.sin(arg_v)]), dev)
    ones = torch.ones(nb_gs, dtype=_F64, device=dev)
    pos = _t(poslgs1, dev)

    W = _m.glao_reconstructor(
        f, f_x, f_y, pos, ones, sig2, pitchs_wfs,
        float(np.atleast_1d(h_recons)[0]), _C128,
        dsp_recons=(None if law == "LSE" else _t(dsp_recons, dev)))

    L = Dpup * dimall / pupdim
    pixsize = 1.0 / L
    out = np.empty((dirperf1.shape[1], dimall, dimall))
    dsp_vrai, hh = _t(dsp_vrai, dev), _t(hh, dev)
    for b in range(dirperf1.shape[1]):
        res = _m.residual_psd_one_dir(
            f, f_x, f_y, pos, ones, _t(dirperf1[:, b], dev), sig2, dsp_vrai,
            hh, h_dm, W, td, ti, wind, pitchs_wfs, _C128)
        out[b] = _np(res)
        if logger.isEnabledFor(logging.DEBUG):
            resval = float(_m.residual_variance(res, pixsize, Dpup))
            logger.debug("dirperf=%d, %.2f", b,
                         np.sqrt(resval) * lambdaref * 1e3 / (2 * np.pi))
    # QUIRK: IDL row/column convention (psfrec.py:611-613)
    return np.swapaxes(out, -1, -2)


def simul_psd_wfm(Cn2, h, seeing, L0, zenith=0., plot=False, npsflin=1,
                  dim=1280, three_lgs_mode=False, verbose=True, *,
                  device="cuda"):
    """Full-grid residual PSD per direction [nm^2] (psfrec.py:36-151)."""
    if three_lgs_mode and verbose:
        logger.info("Using three lasers mode")
    dev = resolve_device(device)
    cfg = _cfg64(dim=int(dim))
    Cn2 = np.asarray(Cn2, float)
    if Cn2.size != 2 or np.asarray(h).size != 2:
        # the reference has the same limitation: its wind-direction array
        # is pinned to two IDL values (psfrec.py:66), so any profile with
        # != 2 layers crashes there with a broadcast error
        raise NotImplementedError(
            "only two-layer (ground + high) Cn2/h profiles are supported, "
            "as in the reference implementation")
    GL = Cn2[0] / Cn2.sum()
    gs_mask = _t([[1.0, 1.0, 1.0, 0.0 if three_lgs_mode else 1.0]], dev)
    ws = _m.effective_wind_speed(h, cfg)
    out = _m.simulate_psd(_t([seeing], dev), _t([GL], dev), _t([L0], dev),
                          gs_mask, tuple(np.asarray(h, float).ravel()), ws,
                          int(npsflin), cfg, zenith=float(zenith))[0]
    if plot:
        plot_directions(npsflin, lgs=lgs_positions(cfg.sep_lgs))
    return _np(out)


def psf_muse(psd, lambdamuse, *, device="cuda"):
    """PSD cube -> PSF cube at the MUSE sampling (psfrec.py:644-686)."""
    lam = np.atleast_1d(np.asarray(lambdamuse, float))
    psd = np.array(psd, np.float64)
    return _np(psf_cube(psd, lam, _cfg64(dim=int(psd.shape[-1])),
                        device=device))


def muse_intrinsic_psf(lbda, *, device="cuda"):
    """MUSE intrinsic Moffat polynomials (psfrec.py:1144-1171)."""
    return tuple(_np(x) for x in _intrinsic(_t(lbda, resolve_device(device))))


def convolve_final_psf(lbda, seeing, GL, L0, psf, *, device="cuda"):
    """Tip-tilt + instrument convolutions (psfrec.py:874-930)."""
    dev = resolve_device(device)
    lam = np.atleast_1d(np.asarray(lbda, float))
    out = convolve_final(_t(psf, dev)[None], _t(lam, dev),
                         _t([seeing], dev), _t([GL], dev), _t([L0], dev),
                         _cfg64())[0]
    return _np(out)


def fit_psf_cube(lbda, psfcube, *, device="cuda"):
    """Circular Moffat fit of every wavelength plane (psfrec.py:861-871).

    ``psfcube`` may be an ndarray or any iterable of 2-D planes (the
    reference passes an mpdaf Cube).  Returns a FitTable with the
    reference's columns, FWHM in arcsec.
    """
    cube = np.asarray([np.asarray(p, float) for p in psfcube])
    fit = fit_moffat_cube(_t(cube, resolve_device(device)), dtype="float64")
    return fit_table_from_arrays(np.asarray(lbda, float), fit)
