"""Batched float64 PyTorch reference of the PSF reconstruction, for the card.

The same mathematics as ``oracle_numpy.py`` beside it (the frozen copy of
the float64 NumPy oracle), laid out so that a block of telemetry rows runs
at once on any torch device:

* the constant pieces (frequency grids, the GLAO reconstructor, the
  diffraction-limited OTF, the kernels of the instrument) come from
  ``oracle_numpy``'s own functions, on the host, once;
* the correction-zone residual PSD of one direction is linear in the layer
  PSDs, so it is ``sum_l A_l dsp_l + N`` with ``A_l`` and ``N`` taken from
  ``oracle_numpy.residual_psd`` on unit layers and on zero layers;
* the structure function is linear in ``convnm^2``, so one inverse FFT per
  direction serves every wavelength;
* every direction's PSF has the same normaliser (the OTF at the origin,
  where the structure function is 0), so the direction mean of the PSFs is
  the PSF of the summed OTFs: one inverse FFT per wavelength;
* the final convolutions are ``fftconvolve(..., mode="same")`` as a
  zero-padded FFT product.

Each of these is a rearrangement of the oracle's float64 arithmetic, not an
approximation: the tests hold this module to ``oracle_numpy`` at the
benchmark's sizes.  It imports numpy, scipy (through ``oracle_numpy``) and
torch only, and nothing of the program under test.
"""

import numpy as np
import torch

from . import oracle_numpy as onp

F64 = torch.float64


def crop_sizes(lbda_nm, dimpsf, pixscale):
    """The oracle's crop size per wavelength (banker's rounding, as the
    reference)."""
    return (np.round((dimpsf * pixscale * 2 * onp.DPUP * 4.85 * 1000
                      / np.asarray(lbda_nm, np.float64)) / 2) * 2).astype(int)


def _zone_operators(npsflin, h, dim_pup=onp.DIM_PUP):
    """``(A, N)`` per laser count: ``A[nb_gs]`` (ndir, nlayers, s, s) and
    ``N[nb_gs]`` (ndir, s, s) with ``residual_psd = sum_l A_l dsp_l + N``
    before the IDL transpose, from ``oracle_numpy.residual_psd`` itself."""
    h = np.asarray(h)
    wind_speed = np.full_like(h, onp.WIND_SPEED).astype(float)   # QUIRK
    h = h.astype(float)
    dimall = 2 * dim_pup
    f, f_x, f_y = onp.freq_grids(dimall, onp.DPUP / dim_pup)
    dirperf_amin = onp.direction_grid(npsflin) / 60.0
    ti_one = 1.0 / onp.FSAMP
    td = onp.DELAY_MS * 1e-3
    pitch = onp.DPUP / onp.NACT
    wind = np.stack([wind_speed * np.cos(onp.WIND_DIR),
                     wind_speed * np.sin(onp.WIND_DIR)])
    nlay = len(h)
    out = {}
    for nb_gs in (3, 4):
        poslgs_amin = onp.POSLGS4[:, :nb_gs] / 60.0
        sigr = np.full(nb_gs, onp.NOISE_LGS2)
        ti = np.full(nb_gs, ti_one)
        W = onp.glao_reconstructor(f, f_x, f_y, poslgs_amin, sigr, pitch)
        A = np.empty((dirperf_amin.shape[1], nlay, dimall, dimall))
        N = np.empty((dirperf_amin.shape[1], dimall, dimall))
        for b in range(dirperf_amin.shape[1]):
            beta = dirperf_amin[:, b]
            N[b] = onp.residual_psd(f, f_x, f_y, poslgs_amin, beta, sigr,
                                    np.zeros((nlay,) + f.shape), h,
                                    onp.ALT_DM, W, td, ti, wind)
            for layer in range(nlay):
                unit = np.zeros((nlay,) + f.shape)
                unit[layer] = 1.0
                A[b, layer] = onp.residual_psd(
                    f, f_x, f_y, poslgs_amin, beta, np.zeros(nb_gs), unit,
                    h, onp.ALT_DM, W, td, ti, wind)
        out[nb_gs] = (A, N)
    return f, out


def _fitting_grid(dim):
    """Centred |f| of ``psd_fitting_error`` (grid centred on (dim-1)/2)."""
    L = 2 * onp.DPUP
    c = (dim - 1) / 2.0
    fx = (np.arange(dim) - c)[:, None] / L
    return np.hypot(fx, fx.T)


def _dl_otf(dim):
    """The diffraction-limited OTF of ``oracle_numpy.psd_to_psf`` (centred)
    and the pupil width."""
    pup = onp.pupil(dim / 4, dim // 2, oc=onp.OCC)
    npup = pup.shape[0]
    tab = np.zeros((dim, dim), dtype=complex)
    tab[:npup, :npup] = pup
    dl = np.fft.fftshift(np.abs(np.fft.fft2(np.abs(np.fft.ifft2(tab)) ** 2))
                         / pup.sum())
    return dl, npup


def _regrid_weights(npixc, dimpsf):
    """Floor indices and weights of ``oracle_numpy.bilinear_regrid``."""
    pos = np.arange(dimpsf) * (npixc / dimpsf)
    i0 = np.minimum(np.floor(pos).astype(int), npixc - 2)
    return i0, pos - i0


class TorchOracle:
    """The float64 reference of one configuration, on ``device``.

    ``cube(seeing, GL, L0, mask)`` gives the final PSF cubes (B, nl,
    dimpsf, dimpsf) of a block of rows, as ``oracle_numpy`` computes them
    row by row (``compute_psf_oracle``'s PSF, before the fit); a row with
    ``mask[:, 3] == 0`` runs the 3-laser geometry, as the reference does.
    """

    def __init__(self, lbda_nm, npsflin=1, dim=1280, dimpsf=40,
                 pixscale=0.2, h=(100, 10000), dim_pup=onp.DIM_PUP,
                 device="cpu"):
        self.dev = torch.device(device)
        self.lbda = np.asarray(lbda_nm, np.float64)
        self.dim, self.dimpsf, self.pixscale = dim, dimpsf, pixscale
        self.ndir = npsflin * npsflin
        t = lambda a: torch.as_tensor(np.ascontiguousarray(a), dtype=F64,
                                      device=self.dev)
        self.dim_pup = dim_pup
        f_zone, ops = _zone_operators(npsflin, h, dim_pup)
        self.f_zone = t(f_zone)
        self.zone = {k: (t(A), t(N)) for k, (A, N) in ops.items()}
        self.f_fit = t(_fitting_grid(dim))
        dl, npup = _dl_otf(dim)
        self.dl = t(dl)
        self.L = onp.DPUP * (dim / npup)
        self.fc = 1.0 / (2.0 * onp.DPUP / onp.NACT)
        self.npixc = crop_sizes(self.lbda, dimpsf, pixscale)
        self.regrid = [tuple(t(a) if a.dtype.kind == "f" else
                             torch.as_tensor(a, device=self.dev)
                             for a in _regrid_weights(int(n), dimpsf))
                       for n in self.npixc]
        self.grid_tt, self.coeff_tt = onp.load_tt_coeff_table()
        n = dimpsf + (dimpsf % 2 == 0)                # force odd kernel
        self.nker = n
        fwhm_i, beta_i = onp.muse_intrinsic_psf(self.lbda)
        alpha_i = (fwhm_i / pixscale) / (2 * np.sqrt(2 ** (1 / beta_i) - 1))
        self.k_instr = t(np.stack([onp.moffat_kernel(a, b, n)
                                   for a, b in zip(alpha_i, beta_i)]))

    def psd(self, seeing, GL, L0, mask):
        """Residual-phase PSD (B, ndir, dim, dim) [nm^2], as
        ``oracle_numpy.simulate_psd([GL, 1 - GL], h, seeing, L0, ...)``."""
        dim, s = self.dim, 2 * self.dim_pup
        seeing, GL, L0 = (torch.as_tensor(np.asarray(a, np.float64),
                                          device=self.dev)
                          for a in (seeing, GL, L0))
        three = torch.as_tensor(np.asarray(mask)[:, 3] <= 0.5, device=self.dev)
        B = seeing.shape[0]
        cn2 = torch.stack([GL, 1.0 - GL], dim=1)
        cn2 = cn2 / cn2.sum(dim=1, keepdim=True)
        r0ref = 0.976 * 0.5 / seeing / 4.85
        r0_l = cn2 ** (-3.0 / 5.0) * r0ref[:, None]               # (B, 2)
        dsp_l = (onp.CST_VK * r0_l[..., None, None] ** (-5.0 / 3.0)
                 * (self.f_zone ** 2 + 1.0 / L0[:, None, None, None] ** 2)
                 ** (-11.0 / 6.0))                                # (B,2,s,s)
        zone = torch.empty((B, self.ndir, s, s), dtype=F64, device=self.dev)
        for nb_gs, sel in ((4, ~three), (3, three)):
            if not bool(sel.any()):
                continue
            A, N = self.zone[nb_gs]
            zone[sel] = (torch.einsum("dlxy,blxy->bdxy", A, dsp_l[sel])
                         + N[None])
        zone = torch.fft.fftshift(zone.transpose(-1, -2), dim=(-2, -1))
        cst = ((onp._gamma(11 / 6) ** 2 / (2 * np.pi ** (11 / 3)))
               * (24 * onp._gamma(6 / 5) / 5) ** (5 / 6))
        full = torch.where(
            self.f_fit >= self.fc,
            cst * r0ref[:, None, None] ** (-5.0 / 3.0)
            * (self.f_fit ** 2 + 1.0 / L0[:, None, None] ** 2)
            ** (-11.0 / 6.0), 0.0)                                # (B,d,d)
        out = full[:, None].expand(B, self.ndir, dim, dim).clone()
        lo, hi = dim // 2 - self.dim_pup, dim // 2 + self.dim_pup
        out[..., lo:hi, lo:hi] = torch.maximum(full[:, None, lo:hi, lo:hi],
                                               zone)
        return out * (onp.LAMBDA_REF * 1000.0 / (2 * np.pi)) ** 2

    def dphi(self, psd):
        """Structure function at ``convnm = 1`` (B, ndir, dim, dim),
        centred: ``psd_to_psf``'s ``Dphi`` is ``convnm**2`` times it."""
        bg = torch.fft.ifft2(torch.fft.fftshift(psd, dim=(-2, -1)))
        bg = bg.real * (self.dim * self.dim / self.L ** 2)
        return torch.fft.fftshift(2.0 * (bg[..., :1, :1] - bg), dim=(-2, -1))

    def ao_cube(self, dphi):
        """Direction-averaged, cropped, clipped and regridded AO PSF cubes
        (B, nl, dimpsf, dimpsf), normalised per plane, as
        ``oracle_numpy.psf_cube_from_psd``."""
        B, c = dphi.shape[0], self.dim // 2
        out = torch.empty((B, len(self.lbda), self.dimpsf, self.dimpsf),
                          dtype=F64, device=self.dev)
        for i, lb in enumerate(self.lbda):
            convnm = 2 * np.pi / (lb * 1e-9 * 1e9)
            otf = torch.exp(dphi * (-0.5 * convnm ** 2)).sum(dim=1) * self.dl
            psf = torch.fft.fftshift(torch.fft.ifft2(
                torch.fft.fftshift(otf, dim=(-2, -1))).real, dim=(-2, -1))
            h = int(self.npixc[i]) // 2
            acc = psf[:, c - h:c + h, c - h:c + h]
            acc = acc / acc.sum(dim=(-2, -1), keepdim=True)
            acc = torch.clamp_min(acc, 0.0)
            i0, t = self.regrid[i]
            rows = (acc[:, i0] * (1 - t)[None, :, None]
                    + acc[:, i0 + 1] * t[None, :, None])
            out[:, i] = (rows[:, :, i0] * (1 - t)[None, None, :]
                         + rows[:, :, i0 + 1] * t[None, None, :])
        return out / out.sum(dim=(-2, -1), keepdim=True)

    def _fftconvolve_same(self, x, k):
        """``scipy.signal.fftconvolve(x, k, mode="same")`` over the last
        two axes (``k`` broadcast against ``x``)."""
        n, m = x.shape[-1], k.shape[-1]
        full = n + m - 1
        y = torch.fft.irfft2(torch.fft.rfft2(x, s=(full, full))
                             * torch.fft.rfft2(k, s=(full, full)),
                             s=(full, full))
        lo = (full - n) // 2
        return y[..., lo:lo + n, lo:lo + n]

    def convolve(self, cube, seeing, GL, L0):
        """The tip-tilt and MUSE-intrinsic convolutions of
        ``oracle_numpy.convolve_tt_and_instrument``."""
        seeing, GL, L0 = (np.asarray(a, np.float64) for a in (seeing, GL, L0))
        seeing_hl = seeing * (1 - GL) ** 0.6
        r0_hl = 0.976 * 0.5 / seeing_hl / 4.85
        c_hl = np.interp(L0, self.grid_tt, self.coeff_tt)
        fwhm_tt = (np.sqrt(c_hl * 0.97 * 6.88 * (0.5e-6 / (2 * np.pi)) ** 2
                           * 8.0 ** (-1 / 3) * r0_hl ** (-5 / 3))
                   / 4.85e-6 * 2.35 / self.pixscale)
        alpha_tt = fwhm_tt / (2 * np.sqrt(2 ** (1 / 2.0) - 1))
        k_tt = torch.as_tensor(np.stack([onp.moffat_kernel(a, 2.0, self.nker)
                                         for a in alpha_tt]),
                               dtype=F64, device=self.dev)
        cube = self._fftconvolve_same(cube, k_tt[:, None])
        return self._fftconvolve_same(cube, self.k_instr[None])

    def cube(self, seeing, GL, L0, mask):
        """Final PSF cubes (B, nl, dimpsf, dimpsf) of a block of rows."""
        psd = self.psd(seeing, GL, L0, mask)
        dphi = self.dphi(psd)
        del psd
        return self.convolve(self.ao_cube(dphi), seeing, GL, L0)

    def cubes(self, seeing, GL, L0, mask, block=8):
        """:meth:`cube` over many rows in blocks of ``block``, on the host
        (float64 numpy)."""
        out = []
        for i in range(0, len(seeing), block):
            sl = slice(i, i + block)
            out.append(self.cube(seeing[sl], GL[sl], L0[sl],
                                 np.asarray(mask)[sl]).cpu().numpy())
        return np.concatenate(out)


def fit_planes_scipy(cube):
    """``oracle_numpy.fit_moffat_circular`` (MINPACK's LM through scipy) on
    every plane of a (P, n, n) cube: (|fwhm| [px], beta) per plane."""
    fits = [onp.fit_moffat_circular(np.asarray(p, np.float64)) for p in cube]
    return (np.abs(np.array([f["fwhm"][0] for f in fits])),
            np.array([f["n"] for f in fits]))


def fit_planes(cube, iters=100, device=None):
    """The circular Moffat fit of ``oracle_numpy.fit_moffat_circular`` on
    every plane of a (P, n, n) cube at once, in float64: the same model
    ``peak * (1 + r^2/alpha^2)^-beta``, the same start, and a
    Levenberg-Marquardt iteration (Marquardt's diagonal scaling) run
    ``iters`` times, past convergence.  Returns (|fwhm| [px], beta) per
    plane as float64 numpy; the tests hold it to :func:`fit_planes_scipy`.
    """
    img = torch.as_tensor(np.asarray(cube) if not torch.is_tensor(cube)
                          else cube, dtype=F64, device=device)
    P, ny, nx = img.shape
    yy = torch.arange(ny, dtype=F64, device=img.device)[:, None]
    xx = torch.arange(nx, dtype=F64, device=img.device)[None, :]
    flat = img.reshape(P, -1)
    peak0, am = flat.max(dim=1)
    cy0, cx0 = (am // nx).to(F64), (am % nx).to(F64)
    tot = flat.sum(dim=1)
    var = (img * ((yy - cy0[:, None, None]) ** 2
                  + (xx - cx0[:, None, None]) ** 2)).sum(dim=(1, 2)) / tot
    fwhm0 = torch.clamp_min(2.355 * torch.sqrt(torch.clamp_min(var, 0.25)
                                               / 2), 1.0)
    a0 = fwhm0 / (2 * np.sqrt(2 ** 0.5 - 1))
    p = torch.stack([cy0, cx0, peak0, a0, torch.full_like(a0, 2.0)], dim=1)

    def model(p):
        cy, cx, pk, a, n = (q[:, None, None] for q in p.unbind(1))
        dy, dx = yy - cy, xx - cx
        rr = (dy * dy + dx * dx) / (a * a)
        u = 1.0 + rr
        un = u ** (-n)
        return pk * un, (dy, dx, rr, u, un, pk, a, n)

    def cost(p):
        m, _ = model(p)
        return ((m - img) ** 2).sum(dim=(1, 2))

    c = cost(p)
    lam = torch.full_like(c, 1e-3)
    eye = torch.eye(5, dtype=F64, device=img.device)
    for _ in range(iters):
        m, (dy, dx, rr, u, un, pk, a, n) = model(p)
        r = (m - img).reshape(P, -1)
        dm_du = -n * pk * un / u
        jac = torch.stack([dm_du * (-2 * dy / (a * a)),
                           dm_du * (-2 * dx / (a * a)),
                           un,
                           dm_du * (-2 * rr / a),
                           -pk * un * torch.log(u)], dim=1).reshape(P, 5, -1)
        A = jac @ jac.transpose(1, 2)
        g = (jac @ r[:, :, None])[..., 0]
        D = torch.diagonal(A, dim1=1, dim2=2)
        step = torch.linalg.solve(A + lam[:, None, None] * D[:, :, None]
                                  * eye, -g)
        p_new = p + step
        c_new = cost(p_new)
        better = torch.isfinite(c_new) & (c_new < c)
        p = torch.where(better[:, None], p_new, p)
        c = torch.where(better, c_new, c)
        lam = torch.where(better, lam / 10, lam * 10).clamp(1e-15, 1e15)
    a, n = p[:, 3], p[:, 4]
    fwhm = torch.abs(a) * 2 * torch.sqrt(2 ** (1 / n) - 1)
    return fwhm.cpu().numpy(), n.cpu().numpy()
