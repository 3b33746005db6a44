"""GLAO residual-phase PSD model (PyTorch, batched over telemetry rows).

Counterpart of ``muse_psfr_tpu/psd/model.py``.  With the system geometry,
altitudes, wind, noise and loop timing fixed per configuration, the whole
reconstruction machinery (Shack-Hartmann transfer functions, the
closed-form reconstructor, servo-lag model matrices, direction
projectors) is independent of the telemetry and is precomputed on the
host in float64 (:func:`_glao_static_transfer`, copied from the JAX
package as is).  Per row only two multiply-adds with the von Karman
spectra remain; the rows are the leading batch dimension of every tensor
of the batched model (the JAX package vmaps one row at a time).

The general building blocks of the reference's PSD layer
(:func:`wfs_transfer`, :func:`gs_phasors`, :func:`glao_reconstructor`,
:func:`residual_psd_one_dir`, :func:`residual_variance`) are ported too,
one frequency grid at a time on tensors of any device, with an explicit
complex dtype; ``compat.py`` builds the reference's functions from them.
"""

import math

import numpy as np
import torch

from ..config import GalacsiConfig
from ..core.grids import (centered_freq_radius, direction_grid,
                          lgs_positions, pupil_mask)
from ..core.vonkarman import (CST_VK_EXACT, fitting_expansion_spec,
                              fitting_psd)
from ..utils.device import host_const

ARCMIN_TO_RAD = 60.0 / 206265.0


def seeing_to_r0(seeing, lbda_um=0.5, zenith_deg=0.0):
    """Fried parameter [m] from seeing [arcsec @0.5um] (psfrec.py:183-187)."""
    r0_half = 0.976 * 0.5 / seeing / 4.85
    z = math.cos(math.radians(zenith_deg)) ** 0.6
    return r0_half * (2.0 * lbda_um) ** 1.2 * z


def wfs_transfer(f, f_x, f_y, pitch, strict, cdtype):
    """Shack-Hartmann transfer function ``2*pi*i*f*sinc(p fx)*sinc(p fy)``,
    zeroed past the cutoff.

    ``pitch`` may be a scalar (one transfer function shared by all guide
    stars, the GALACSI case) or a (nb_gs,) tensor (per-WFS pitches, giving
    a (nb_gs, s, s) result as in the reference's general code path).

    QUIRK (psfrec.py:251-257, 429-435): the zeroing mask is
    ``((f != 0) & (|f_x| >= fc)) | (|f_y| >= fc)``: '&' binds before '|'
    in the original's un-parenthesised expression.  The reconstructor uses
    '>=', the residual model '>' (``strict``); the cutoff lands exactly on
    grid frequencies, so the two differ.
    """
    pitch = torch.as_tensor(pitch, dtype=f.dtype, device=f.device)
    if pitch.ndim == 1:
        pitch = pitch[:, None, None]
    amp = 2.0 * np.pi * f * torch.sinc(pitch * f_x) * torch.sinc(pitch * f_y)
    fc = 1.0 / (2.0 * pitch)
    if strict:
        kill = ((f != 0) & (torch.abs(f_x) > fc)) | (torch.abs(f_y) > fc)
    else:
        kill = ((f != 0) & (torch.abs(f_x) >= fc)) | (torch.abs(f_y) >= fc)
    return torch.where(kill, torch.zeros_like(amp), amp).to(cdtype) * 1j


def gs_phasors(f_x, f_y, poslgs_amin):
    """Per-guide-star pupil-plane phase slopes (nb_gs, s, s) [rad/m of
    altitude]; ``poslgs_amin`` (2, nb_gs) in arcmin."""
    return (f_x[None] * poslgs_amin[0, :, None, None] +
            f_y[None] * poslgs_amin[1, :, None, None]) * ARCMIN_TO_RAD


def _phasor(angle, cdtype):
    """``exp(i * angle)`` in ``cdtype``."""
    return torch.polar(torch.ones_like(angle), angle).to(cdtype)


def _zero_dc(x):
    x = x.clone()
    x[..., 0, 0] = 0.0
    return x


def glao_reconstructor(f, f_x, f_y, poslgs_amin, gs_mask, sigr, pitch,
                       h_recons, cdtype, dsp_recons=None):
    """Closed-form GLAO reconstructor ``W`` of shape (nb_gs, s, s).

    Replaces reference ``calc_mat_rec_glao_finale`` (psfrec.py:218-364):
    with a single reconstructed layer the per-frequency system is scalar,
    so ``W_g = conj(M_g)/sigma_g / (sum_k |M_k|^2/sigma_k [+ prior])``
    stands for its per-pixel inversion loop.  A masked guide star has
    ``M_g = 0``, which is the 3-star algebra exactly.  ``dsp_recons``
    enables the MAP prior (law != LSE); the shipped GALACSI pipeline is
    LSE.  The DC term is zeroed (psfrec.py:351-352).
    """
    w = wfs_transfer(f, f_x, f_y, pitch, strict=False, cdtype=cdtype)
    if w.ndim == 2:
        w = w[None]                      # shared transfer fn -> (1, s, s)
    ph = gs_phasors(f_x, f_y, poslgs_amin)
    M = (w * _phasor(2.0 * np.pi * h_recons * ph, cdtype)
         * gs_mask[:, None, None])
    num = M.conj() / sigr[:, None, None]
    den = torch.sum((M * num).real, dim=0)
    if dsp_recons is not None:
        # piston filtered (psfrec.py:305)
        den = den + _zero_dc(1.0 / dsp_recons)
    inv = torch.where(den != 0,
                      1.0 / torch.where(den == 0, torch.ones_like(den), den),
                      torch.zeros_like(den))
    return num * _zero_dc(inv)[None]


def residual_psd_one_dir(f, f_x, f_y, poslgs_amin, gs_mask, beta_amin, sigv,
                         dsp_layers, h_layers, h_dm, W, td, ti, wind, pitch,
                         cdtype):
    """Residual phase PSD (s, s) for one evaluation direction.

    Reconstruction error + propagated WFS noise with servo-lag phasors
    (reference ``calc_dsp_res_glao_finale`` psfrec.py:367-525 with
    tempo=True, fitting=True, the shipped path; the final band-cut branch
    there is dead).  ``dsp_layers`` (l, s, s), ``h_layers`` (l,), ``wind``
    (2, l), ``ti``/``sigv``/``gs_mask`` (g,), ``W`` (g, s, s) complex.
    """
    w = wfs_transfer(f, f_x, f_y, pitch, strict=True, cdtype=cdtype)
    if w.ndim == 2:
        w = w[None]                      # shared transfer fn -> (1, s, s)
    ph = gs_phasors(f_x, f_y, poslgs_amin)                # (g, s, s)

    # model matrix for the true profile, with the servo-lag sinc
    # (l = true layer, g = guide star)
    lag = torch.sinc(
        wind[0, :, None, None, None] * ti[None, :, None, None] * f_x
        + wind[1, :, None, None, None] * ti[None, :, None, None] * f_y)
    Mv = (lag * w[None] *
          _phasor(2.0 * np.pi * h_layers[:, None, None, None] * ph[None],
                  cdtype) *
          gs_mask[None, :, None, None])                         # (l, g, s, s)

    # projector onto the evaluation direction, with frozen-flow back-shift
    dT = torch.max(ti) + td
    bdot = beta_amin[0] * f_x + beta_amin[1] * f_y
    p_beta = _phasor(2.0 * np.pi * (
        h_layers[:, None, None] * ARCMIN_TO_RAD * bdot[None]
        - dT * (wind[0, :, None, None] * f_x + wind[1, :, None, None] * f_y)),
        cdtype)
    p_dm = _phasor(2.0 * np.pi * h_dm * ARCMIN_TO_RAD * bdot, cdtype)

    p_w = p_dm[None] * W                                        # (g, s, s)
    p_model = torch.einsum("gxy,lgxy->lxy", p_w, Mv)
    proj = p_beta - p_model

    err_recons = torch.sum(torch.abs(proj) ** 2 * dsp_layers, dim=0)
    err_noise = torch.sum(torch.abs(p_w) ** 2 * sigv[:, None, None], dim=0)
    return _zero_dc(err_recons) + _zero_dc(err_noise)


def residual_variance(psd, pixsize, dpup):
    """Residual variance [rad^2] from an FFT-ordered PSD, excluding the
    central 1/D box (reference ``calc_var_from_psd``, psfrec.py:206-215).
    Debug metric reported per direction at DEBUG level."""
    box = (1.0 / dpup) / pixsize
    mask = pupil_mask(box / 2.0, psd.shape[-1], inverse=True,
                      dtype=psd.dtype, device=psd.device)
    shifted = torch.fft.fftshift(psd, dim=(-2, -1)) * pixsize ** 2
    return torch.sum(shifted * mask, dim=(-2, -1))


def effective_wind_speed(h, cfg: GalacsiConfig) -> float:
    """Wind speed actually used for the altitude array ``h``.

    QUIRK (psfrec.py:61): the reference builds the wind-speed array with
    ``np.full_like(h, 12.5)``, which inherits ``h``'s dtype — the default
    integer altitudes (100, 10000) silently truncate 12.5 -> 12 m/s.
    """
    return float(np.full(2, cfg.wind_speed, dtype=np.asarray(h).dtype)[0])


_STATIC_TRANSFER_CACHE = {}


def _static_key(h, wind_speed, npsflin, cfg: GalacsiConfig):
    return (tuple(float(x) for x in np.asarray(h, np.float64).ravel()),
            float(wind_speed), npsflin, cfg.dimall, cfg.dpup, cfg.dim_pup,
            cfg.sep_lgs, cfg.noise_lgs2, cfg.fsamp, cfg.delay_ms,
            cfg.alt_dm, cfg.wfs_pitch, cfg.wind_dir_0, cfg.wind_dir_1)


def _glao_static_transfer(h, wind_speed, npsflin, cfg: GalacsiConfig):
    """Host float64 GLAO transfer functions (NumPy, cached).

    The residual PSD collapses to ``PSD_d(f) = sum_l |proj_{l,d}(f)|^2 *
    VK_l(f) + noise_d(f)``; ``|proj|^2`` and ``noise`` (and the MAP-law
    pieces) are computed here for both the 4- and 3-laser geometries
    (psfrec.py:86-91), post IDL transpose and fftshift.  Same code as
    ``muse_psfr_tpu/psd/model.py:_glao_static_transfer``.
    """
    key = _static_key(h, wind_speed, npsflin, cfg)
    if key in _STATIC_TRANSFER_CACHE:
        return _STATIC_TRANSFER_CACHE[key]

    s = cfg.dimall
    c = 60.0 / 206265.0
    fx = np.fft.fftfreq(s, cfg.dpup / cfg.dim_pup)[:, None]
    fy = fx.T
    f = np.hypot(fx, fy)
    # QUIRK: arctan polar with arg[0, 0] = 0, not arctan2 (psfrec.py:548)
    with np.errstate(all="ignore"):
        t = np.where((fx == 0.0) & (fy == 0.0), 0.0, fy / fx)
    arg = np.arctan(t)
    f_x = f * np.cos(arg)
    f_y = f * np.sin(arg)

    h_arr = np.asarray(h, np.float64)
    wind_dir = np.array([cfg.wind_dir_0, cfg.wind_dir_1])
    wind = wind_speed * np.stack([np.cos(wind_dir), np.sin(wind_dir)])
    dirs = direction_grid(npsflin) / 60.0                # (2, ndir)
    ndir = dirs.shape[1]
    nl = h_arr.size
    td = cfg.delay_ms * 1e-3

    def wfs_np(pitch, strict):
        # QUIRK (psfrec.py:251-257, 429-435): '&' binds before '|'
        w = 2j * np.pi * f * np.sinc(pitch * f_x) * np.sinc(pitch * f_y)
        fc = 1.0 / (2.0 * pitch)
        if strict:
            kill = ((f != 0) & (np.abs(f_x) > fc)) | (np.abs(f_y) > fc)
        else:
            kill = ((f != 0) & (np.abs(f_x) >= fc)) | (np.abs(f_y) >= fc)
        return np.where(kill, 0.0, w)

    out = {}
    for tag, nb_gs in (("4", 4), ("3", 3)):
        pos = lgs_positions(cfg.sep_lgs)[:, :nb_gs] / 60.0
        sig = np.full(nb_gs, cfg.noise_lgs2)
        ti = np.full(nb_gs, 1.0 / cfg.fsamp)

        ph = (f_x[None] * pos[0, :, None, None] +
              f_y[None] * pos[1, :, None, None]) * c      # (g, s, s)
        w_rec = wfs_np(cfg.wfs_pitch, strict=False)
        M = w_rec[None] * np.exp(2j * np.pi * cfg.alt_dm * ph)
        num = M.conj() / sig[:, None, None]
        den = np.sum((M * num).real, axis=0)
        inv = np.where(den != 0, 1.0 / np.where(den == 0, 1.0, den), 0.0)
        inv[0, 0] = 0.0
        W = num * inv[None]                               # (g, s, s)

        w_res = wfs_np(cfg.wfs_pitch, strict=True)
        lag = np.sinc(wind[0, :, None, None, None] * ti[None, :, None, None]
                      * f_x +
                      wind[1, :, None, None, None] * ti[None, :, None, None]
                      * f_y)
        Mv = (lag * w_res[None, None] *
              np.exp(2j * np.pi * h_arr[:, None, None, None] * ph[None]))

        # MAP-law pieces: S_l = sum_g conj(M_g)/sig_g * Mv_{l,g} and
        # D0 = sum_g |M_g|^2/sig_g (psfrec.py:297-324, made algebraic)
        S = np.einsum("gxy,lgxy->lxy", num, Mv)          # (l, s, s)

        dT = ti.max() + td
        proj2 = np.empty((nl, ndir, s, s))
        noise = np.empty((ndir, s, s))
        p_re = np.empty((nl, ndir, s, s))
        p_im = np.empty((nl, ndir, s, s))
        for d in range(ndir):
            bdot = dirs[0, d] * f_x + dirs[1, d] * f_y
            p_beta = np.exp(2j * np.pi * (
                h_arr[:, None, None] * c * bdot[None]
                - dT * (wind[0, :, None, None] * f_x
                        + wind[1, :, None, None] * f_y)))
            p_dm = np.exp(2j * np.pi * cfg.alt_dm * c * bdot)
            p_w = p_dm[None] * W
            p_model = np.einsum("gxy,lgxy->lxy", p_w, Mv)
            proj2[:, d] = np.abs(p_beta - p_model) ** 2
            noise[d] = np.sum(np.abs(p_w) ** 2 * sig[:, None, None], axis=0)
            P = p_beta.conj() * p_dm[None] * S           # (l, s, s)
            p_re[:, d] = P.real
            p_im[:, d] = P.imag
        # DC zeroing (psfrec.py:490, 516)
        proj2[:, :, 0, 0] = 0.0
        noise[:, 0, 0] = 0.0
        # QUIRK: IDL row/column transpose, then DC to centre for the merge
        shift = lambda a: np.fft.fftshift(np.swapaxes(a, -1, -2),  # noqa
                                          axes=(-2, -1))
        out["proj2_" + tag] = shift(proj2)
        out["noise_" + tag] = shift(noise)
        out["p_re_" + tag] = shift(p_re)
        out["p_im_" + tag] = shift(p_im)
        out["d0_" + tag] = shift(den)

    out["f2"] = np.fft.fftshift(f * f)
    dc = np.ones((s, s))
    dc[s // 2, s // 2] = 0.0        # original [0, 0] after the fftshift
    out["dc_mask"] = dc
    _STATIC_TRANSFER_CACHE[key] = out
    return out


def _glao_block_psd(seeing, GL, L0, gs_mask, h, wind_speed, npsflin: int,
                    cfg: GalacsiConfig, zenith=0.0):
    """Correction-zone GLAO residual PSD (B, ndir, s, s) [rad^2] and r0 (B,).

    ``seeing``/``GL``/``L0``: (B,) tensors; ``gs_mask``: (B, 4)."""
    dev, dtype = seeing.device, seeing.dtype
    cn2 = torch.stack([GL, 1.0 - GL])                     # (2, B)
    cn2 = cn2 / torch.sum(cn2, dim=0)
    r0ref = seeing_to_r0(seeing, cfg.lambda_ref, zenith)

    key = _static_key(h, wind_speed, npsflin, cfg)
    const = _glao_static_transfer(h, wind_speed, npsflin, cfg)

    def c(name):
        return host_const(("glao", key, name), lambda: const[name], dev,
                          dtype)

    f2 = c("f2")
    L0b = L0[:, None, None]
    radial = 0.0229 * r0ref[:, None, None] ** (-5.0 / 3.0) * \
        (f2 + 1.0 / (L0b * L0b)) ** (-11.0 / 6.0)          # (B, s, s)
    wl = cn2.T[:, :, None, None, None]                    # (B, 2, 1, 1, 1)

    def variant(tag):
        if cfg.lse:
            # LSE: |proj|^2 and the noise term are float64 host constants
            err = torch.sum(c("proj2_" + tag)[None] * radial[:, None, None]
                            * wl, dim=1)                  # (B, ndir, s, s)
            return err + c("noise_" + tag)[None]
        # MAP: inv = 1/(D0 + Cphi^-1) depends on (r0, L0); |proj|^2 =
        # |1 - P*inv|^2 with P precomputed (psfrec.py:300-324)
        d0 = c("d0_" + tag)
        dc = c("dc_mask")
        prior_inv = ((f2 + 1.0 / (L0b * L0b)) ** (11.0 / 6.0)
                     * r0ref[:, None, None] ** (5.0 / 3.0) / 0.0229)
        den = d0 + prior_inv
        inv = torch.where(den != 0,
                          1.0 / torch.where(den == 0, torch.ones_like(den),
                                            den),
                          torch.zeros_like(den))
        inv = inv * dc                  # piston filtered (psfrec.py:305,352)
        re = 1.0 - c("p_re_" + tag)[None] * inv[:, None, None]
        im = c("p_im_" + tag)[None] * inv[:, None, None]
        proj2 = re * re + im * im                         # (B, l, ndir, s, s)
        err = torch.sum(proj2 * radial[:, None, None] * wl, dim=1)
        return (err + (d0 * inv * inv)[:, None]) * dc

    # the mask's 4th entry selects the 4- vs 3-laser geometry, as the
    # reference's 3-laser mode does (psfrec.py:86-91)
    four = (gs_mask[:, 3] > 0.5)[:, None, None, None]
    return torch.where(four, variant("4"), variant("3")), r0ref


def _f_block(cfg: GalacsiConfig):
    """Central (dimall, dimall) block of the image-centred |f| grid."""
    lo = cfg.dim // 2 - cfg.dim_pup
    s = cfg.dimall
    f = centered_freq_radius(cfg.dim, 2.0 * cfg.dpup)
    return f[lo:lo + s, lo:lo + s]


def simulate_psd(seeing, GL, L0, gs_mask, h, wind_speed, npsflin: int,
                 cfg: GalacsiConfig, zenith=0.0):
    """Residual-phase PSD cubes (B, ndir, dim, dim), image-centred, nm^2.

    Counterpart of ``muse_psfr_tpu/psd/model.py:simulate_psd`` (reference
    ``simul_psd_wfm``, psfrec.py:36-151): correction-zone GLAO PSD merged
    (max) with the fitting-error PSD on the full grid.  The rows are the
    leading dimension; ``gs_mask`` is (B, 4).
    """
    dev, dtype = seeing.device, seeing.dtype
    psd_dir, r0ref = _glao_block_psd(seeing, GL, L0, gs_mask, h, wind_speed,
                                     npsflin, cfg, zenith)
    f_full = host_const(("f_full", cfg.dim, cfg.dpup),
                        lambda: centered_freq_radius(cfg.dim, 2.0 * cfg.dpup),
                        dev, dtype)
    full = fitting_psd(f_full, r0ref[:, None, None], L0[:, None, None],
                       cfg.fc)                            # (B, dim, dim)
    s = cfg.dimall
    lo = cfg.dim // 2 - cfg.dim_pup
    ndir = npsflin * npsflin
    out = full[:, None].repeat(1, ndir, 1, 1)
    out[:, :, lo:lo + s, lo:lo + s] = torch.maximum(
        full[:, None, lo:lo + s, lo:lo + s], psd_dir)
    return out * (cfg.lambda_ref * 1000.0 / (2 * np.pi)) ** 2


def simulate_psd_split(seeing, GL, L0, gs_mask, h, wind_speed, npsflin: int,
                       cfg: GalacsiConfig, zenith=0.0):
    """Split-form residual PSD ``(w, delta)``: (B, degree+1) fitting-basis
    weights and the (B, ndir, dimall, dimall) correction-zone excess
    [nm^2], such that ``simulate_psd = sum_k w_k B_k + embed(delta)``.

    Exact to the certified expansion error for ``L0 >= dphi_split_l0_min``
    (callers check the range on the host; see ``parallel/batch.py``).
    """
    dev, dtype = seeing.device, seeing.dtype
    psd_dir, r0ref = _glao_block_psd(seeing, GL, L0, gs_mask, h, wind_speed,
                                     npsflin, cfg, zenith)
    nm2 = (cfg.lambda_ref * 1000.0 / (2 * np.pi)) ** 2
    fblk = host_const(("f_block", cfg.dim, cfg.dpup, cfg.dim_pup),
                      lambda: _f_block(cfg), dev, dtype)
    fit_blk = fitting_psd(fblk, r0ref[:, None, None], L0[:, None, None],
                          cfg.fc)
    delta = torch.clamp_min(psd_dir - fit_blk[:, None], 0.0) * nm2

    u0, binoms = fitting_expansion_spec(cfg.dphi_split_l0_min,
                                        cfg.dphi_split_degree)
    du = 1.0 / (L0 * L0) - u0                             # (B,)
    # du^k by cumulative product (a float power of a negative base is NaN)
    powers = torch.cat([torch.ones_like(du)[:, None],
                        torch.cumprod(du[:, None].expand(
                            -1, len(binoms) - 1), dim=1)], dim=1)
    amp = nm2 * CST_VK_EXACT * r0ref ** (-5.0 / 3.0)
    bin_t = host_const(("binoms", cfg.dphi_split_l0_min,
                        cfg.dphi_split_degree), lambda: binoms, dev, dtype)
    return amp[:, None] * bin_t[None] * powers, delta
