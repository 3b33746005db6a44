"""PSD -> structure function -> OTF -> PSF chain (PyTorch, batched).

Counterpart of ``muse_psfr_tpu/otf/psf.py`` (reference ``psd_to_psf``,
psfrec.py:689-807, and ``psf_muse``, 644-686), with the telemetry rows as
the leading batch dimension of every tensor.  The same exact
reformulations carry over:

1. the structure function is wavelength-free up to ``(2 pi/lbda)^2``, so
   one transform per row and direction serves every wavelength;
2. the diffraction OTF (pupil autocorrelation) is a host float64 constant;
3. the direction average of DC-normalised PSFs is the PSF of the average
   of DC-normalised OTFs, and the crop-and-regrid is a zoom DFT (two real
   contractions per stage) at the bilinear nodes, never the full
   inverse FFT;
4. under the point-symmetry fold only the OTF columns ``0..N/2`` are
   computed, mirrors weighted 2 in the second zoom stage.

The fused step :func:`_psf_chunk_fused` runs the first zoom stage through
K1, or K3 where a launch has too few blocks for the card, K5 with the
diffraction-disc skip, K6 with the anchored-Taylor damping
(``ops/zoom_dft.py``); :func:`_psf_chunk_plain` is the unfused
per-wavelength body.  ``cfg.otf_blue`` runs the bluest wavelengths on a
smaller centred sub-window of the same structure function.
"""

from functools import partial

import numpy as np
import torch
import torch.nn.functional as F

from ..config import GalacsiConfig
from ..core.grids import centered_freq_radius
from ..core.vonkarman import (fitting_expansion_max_rel_error,
                              fitting_expansion_spec)
from ..utils.device import host_const, resolve_device, torch_dtype
from ..utils.log import get_logger

logger = get_logger("psf")

_PUPIL_OTF_CACHE = {}
_DPHI_BASIS_CACHE = {}
_BASIS_RING_CACHE = {}


def _pupil_key(cfg: GalacsiConfig):
    return (cfg.dim, cfg.npup, cfg.occ)


def pupil_otf(cfg: GalacsiConfig):
    """Diffraction-limited OTF: normalised pupil autocorrelation (dim, dim),
    image-centred, host numpy float64, cached (reference psfrec.py:783-790
    computes it per wavelength; it is wavelength-independent)."""
    key = _pupil_key(cfg)
    if key not in _PUPIL_OTF_CACHE:
        c = (cfg.npup - 1) / 2.0
        y = np.arange(cfg.npup)[:, None] - c
        x = np.arange(cfg.npup)[None, :] - c
        rho = np.hypot(y, x) / (cfg.dim / 4.0)
        pup = ((rho < 1.0) & (rho >= cfg.occ)).astype(np.float64)
        tab = np.zeros((cfg.dim, cfg.dim), np.complex128)
        tab[:cfg.npup, :cfg.npup] = pup
        amp = np.abs(np.fft.ifft2(tab)) ** 2
        otf = np.abs(np.fft.fft2(amp)) / pup.sum()
        _PUPIL_OTF_CACHE[key] = np.fft.fftshift(otf)
    return _PUPIL_OTF_CACHE[key]


_DISC_MASK_CACHE = {}


def _disc_block_mask(cfg: GalacsiConfig, tile_j: int = 128,
                     row_block: int = 128):
    """Live-block mask of the fused zoom kernel over the diffraction OTF's
    support (``cfg.disc_skip``; counterpart of the JAX package's
    ``_disc_block_mask``, at its 128 x 128 granularity).

    ``dl`` (:func:`pupil_otf`) is supported on the disc of radius dim/2
    about the grid centre; outside it, it is FFT roundoff.  A (row_block,
    tile_j) block of the computed slab is dead iff its max ``|dl|`` is
    ``<= 1e-12 * max |dl|`` on the float64 host table: the full window's
    corner blocks (6 of 60 at dim=1280), never a block of a window inside
    the disc.  Returns int32 (ncols // tile_j, nrows // row_block), 1 =
    compute, or None when nothing is dead or the slab is not
    block-aligned.
    """
    r_lo, r_hi, col_hi, _ = _window_bounds(cfg)
    key = (_pupil_key(cfg), r_lo, r_hi, col_hi, tile_j, row_block)
    if key in _DISC_MASK_CACHE:
        return _DISC_MASK_CACHE[key]
    dl = pupil_otf(cfg)
    slab = dl[r_lo:r_hi, r_lo:col_hi]
    nrows, ncols = slab.shape
    mask = None
    if nrows % row_block == 0 and ncols % tile_j == 0:
        bmax = np.abs(slab).reshape(nrows // row_block, row_block,
                                    ncols // tile_j, tile_j).max(axis=(1, 3))
        live = (bmax > 1e-12 * np.abs(dl).max()).T       # (J, RB)
        if not live.all():
            mask = np.ascontiguousarray(live.astype(np.int32))
    _DISC_MASK_CACHE[key] = mask
    return mask


def _centered_idft_np(dim: int, cols=None):
    """Real/imag matrices of the shifted inverse DFT, centred in and out:
    ``fftshift(ifft2(fftshift(X))).real = C X C^T - S X S^T`` for real X.
    Phases reduced mod N in integers before the trig.  ``cols=(lo, n)``
    restricts to input columns ``lo:lo+n``."""
    k = np.mod(np.arange(dim) - dim // 2, dim)
    g = np.arange(dim) if cols is None else np.arange(cols[0],
                                                      cols[0] + cols[1])
    ph = np.mod(np.outer(k, g), dim).astype(np.float64)
    ang = ph * (2.0 * np.pi / dim)
    sign = np.where(k % 2 == 0, 1.0, -1.0)[:, None]
    c = sign * np.cos(ang) / dim
    s = sign * np.sin(ang) / dim
    return c, s


def _idft(dim, device, dtype, cols=None):
    return tuple(host_const(("idft", dim, cols, i),
                            lambda i=i: _centered_idft_np(dim, cols)[i],
                            device, dtype) for i in range(2))


def _mm(cfg: GalacsiConfig, device):
    """``matmul`` at the tier of ``cfg.matmul_precision`` for tensors on
    ``device`` (counterpart of the JAX package's ``_mm``): on the card
    ``ops/zoom_dft.py:matmul_tier`` at the configured tier; on the CPU
    ``torch.matmul``, whatever the field says.  The field counts passes of
    the TPU's matrix unit, and the JAX package's run off the TPU contracts
    in full precision (XLA); the port's CPU run does the same, so the CPU
    tests hold the two to each other (the rule of
    :func:`_zoom_precision`)."""
    if torch.device(device).type != "cuda":
        return torch.matmul
    from ..ops.zoom_dft import matmul_tier
    return partial(matmul_tier, precision=cfg.matmul_precision)


def _fold_weights(dim: int, S: int, ncw: int):
    """Column weights of the point-symmetry fold for the ``ncw`` computed
    columns (global ``[c-S, c+128)``): local ``[0, S)`` -> 2, the
    self-paired centre ``S`` -> 1, the tile-pad tail -> 0; when the window
    reaches the grid edge, global column 0 (self-paired Nyquist) -> 1."""
    v = np.zeros(ncw)
    v[:S] = 2.0
    v[S] = 1.0
    if dim // 2 - S == 0:
        v[0] = 1.0
    return v


def _half_weights(nh: int):
    """Column weights of the exact transform's fold onto columns
    ``0..N/2``: 2, with 1 on the two self-paired columns."""
    v = np.full(nh, 2.0)
    v[0] = v[-1] = 1.0
    return v


def _fold_weights_on(dim: int, S: int, ncw: int, device, dtype):
    """:func:`_fold_weights` as a device constant."""
    return host_const(("fold", dim, S, ncw),
                      lambda: _fold_weights(dim, S, ncw), device, dtype)


def _window_bounds(cfg: GalacsiConfig):
    """(r_lo, r_hi, col_hi, S) of the computed OTF block."""
    win = cfg.otf_window
    if win is None:                              # unfolded: full grid
        return 0, cfg.dim, cfg.dim, cfg.dim // 2
    r_lo, S = win
    return r_lo, r_lo + 2 * S, cfg.dim // 2 + 128, S


def _basis_key(cfg: GalacsiConfig):
    return (cfg.dim, cfg.npup, cfg.dpup, cfg.fc, cfg.dphi_split_degree,
            cfg.dphi_split_l0_min)


def fitting_dphi_basis(cfg: GalacsiConfig):
    """Structure-function transforms ``T_k`` of the fitting-PSD Taylor
    basis, (degree+1, dim, dim) host numpy float64, cached.

    The PSD decomposes as ``sum_k w_k B_k + embed(delta)``
    (``psd/model.py:simulate_psd_split``), and the transform is linear, so
    ``dphi_base(PSD) = sum_k w_k T_k + block_transform(delta)`` with the
    full-grid ``T_k`` computed once per configuration here.
    """
    key = _basis_key(cfg)
    if key not in _DPHI_BASIS_CACHE:
        err = fitting_expansion_max_rel_error(
            cfg.dphi_split_l0_min, cfg.dphi_split_degree, cfg.fc)
        if err > 1e-7:
            raise ValueError(
                f"fitting-PSD expansion error {err:.2e} exceeds the 1e-7 "
                f"budget for L0 >= {cfg.dphi_split_l0_min}; raise "
                f"dphi_split_degree or dphi_split_l0_min")
        dim = cfg.dim
        L = cfg.dpup * dim / cfg.npup
        scale = dim * dim / (L * L)
        f = centered_freq_radius(dim, 2.0 * cfg.dpup)
        mask = (f >= cfg.fc).astype(np.float64)
        u0, binoms = fitting_expansion_spec(cfg.dphi_split_l0_min,
                                            cfg.dphi_split_degree)
        f2u = f * f + u0
        ts = []
        for k in range(len(binoms)):
            b = mask * f2u ** (-11.0 / 6.0 - k)
            bg = np.fft.ifft2(np.fft.fftshift(b)).real * scale
            ts.append(np.fft.fftshift(2.0 * (bg[0, 0] - bg)))
        _DPHI_BASIS_CACHE[key] = np.stack(ts)
    return _DPHI_BASIS_CACHE[key]


def fitting_dphi_ring_envelopes(cfg: GalacsiConfig):
    """Ring-wise min/max of the fitting structure-function basis: for each
    ``T_k`` (:func:`fitting_dphi_basis`) and each inf-norm radius ``r =
    max(|i-c|, |j-c|)`` in ``0..dim/2``, float64 ``(tmin, tmax)`` of shape
    (degree+1, dim/2+1), host numpy, cached in memory.  The planner's
    admission model (``parallel/batch.py:_ring_damping``) lower-bounds
    ``D_fit = sum_k w_k T_k`` per ring with them, whatever the signs of the
    telemetry-dependent weights."""
    key = _basis_key(cfg)
    if key not in _BASIS_RING_CACHE:
        arr = fitting_dphi_basis(cfg)
        c = cfg.dim // 2
        ii = np.abs(np.arange(cfg.dim) - c)
        ring = np.maximum(ii[:, None], ii[None, :]).ravel()
        flat = arr.reshape(arr.shape[0], -1)
        # segment reductions by sort + reduceat; every ring 0..c is
        # non-empty
        order = np.argsort(ring, kind="stable")
        bounds = np.searchsorted(ring[order], np.arange(c + 1))
        tmin = np.stack([np.minimum.reduceat(f[order], bounds)
                         for f in flat])
        tmax = np.stack([np.maximum.reduceat(f[order], bounds)
                         for f in flat])
        _BASIS_RING_CACHE[key] = (tmin, tmax)
    return _BASIS_RING_CACHE[key]


def _windowed_basis(cfg, device, dtype):
    r_lo, r_hi, col_hi, _ = _window_bounds(cfg)
    return host_const(("dphi_basis", _basis_key(cfg), r_lo, r_hi, col_hi),
                      lambda: fitting_dphi_basis(cfg)[:, r_lo:r_hi,
                                                      r_lo:col_hi],
                      device, dtype)


def _dl_window(cfg, device, dtype):
    """The diffraction OTF over the computed block (rows, cols)."""
    r_lo, r_hi, col_hi, _ = _window_bounds(cfg)
    return host_const(("pupil_otf", _pupil_key(cfg), r_lo, r_hi, col_hi),
                      lambda: pupil_otf(cfg)[r_lo:r_hi, r_lo:col_hi],
                      device, dtype)


def dphi_base_split(w, delta, cfg: GalacsiConfig):
    """Wavelength-free structure function from the split PSD form.

    ``w``: (B, degree+1) fitting-basis weights; ``delta``: (B, ndir,
    dimall, dimall) correction-zone excess [nm^2].  Returns (B, ndir,
    rows, cols) over the config's fold window (``cfg.otf_window``), or the
    full (dim, dim) grid when the fold is off.  The full-grid transform is
    the precomputed basis; only the centrally supported block is
    transformed per row, through the matching columns of the inverse-DFT
    matrices.
    """
    dev, dtype = delta.device, delta.dtype
    dim = cfg.dim
    L = cfg.dpup * dim / cfg.npup
    scale = dim * dim / (L * L)

    T = _windowed_basis(cfg, dev, dtype)             # (K+1, rows, cols)
    shared = w[:, 0, None, None] * T[0]
    for k in range(1, T.shape[0]):
        shared = shared + w[:, k, None, None] * T[k]

    lo = dim // 2 - cfg.dim_pup
    s = delta.shape[-1]
    x = delta
    bg00 = torch.sum(x, dim=(-2, -1))[..., None, None] / (L * L)
    mm = _mm(cfg, dev)
    if cfg.otf_window is None:
        c_blk, s_blk = _idft(dim, dev, dtype, cols=(lo, s))
        re_blk = (mm(mm(c_blk, x), c_blk.T)
                  - mm(mm(s_blk, x), s_blk.T))
    else:
        # fold: symmetrise the correction block first (delta is NOT
        # f -> -f symmetric; its global mirror spans [lo, lo + s], one
        # row/column wider, hence the pad by one), then emit only the
        # window rows/columns the zoom path reads
        r_lo, r_hi, col_hi, _ = _window_bounds(cfg)
        xp = F.pad(x, (0, 1, 0, 1))
        xs = 0.5 * (xp + torch.flip(xp, dims=(-2, -1)))
        c_blk, s_blk = _idft(dim, dev, dtype, cols=(lo, s + 1))
        re_blk = (mm(mm(c_blk[r_lo:r_hi], xs), c_blk[r_lo:col_hi].T)
                  - mm(mm(s_blk[r_lo:r_hi], xs), s_blk[r_lo:col_hi].T))
    return shared[:, None] + 2.0 * (bg00 - re_blk * scale)


def dphi_base(psd, cfg: GalacsiConfig):
    """Wavelength-free structure function (B, ndir, rows, cols) from full
    PSD cubes (B, ndir, dim, dim) [nm^2]: ``Dphi(lbda) = (2 pi/lbda_nm)^2
    * dphi_base`` (reference psfrec.py:716-722).  ``cfg.use_fft`` selects
    torch.fft, otherwise two DFT matmuls per side (exact to rounding)."""
    dev, dtype = psd.device, psd.dtype
    dim = cfg.dim
    L = cfg.dpup * dim / cfg.npup
    scale = dim * dim / (L * L)
    r_lo, r_hi, col_hi, _ = _window_bounds(cfg)
    if cfg.use_fft:
        cdtype = torch.complex64 if dtype == torch.float32 else \
            torch.complex128
        bg = torch.fft.ifft2(torch.fft.fftshift(psd, dim=(-2, -1)).to(
            cdtype)) * scale
        d = 2.0 * (bg[..., :1, :1].real - bg.real)
        d = torch.fft.fftshift(d, dim=(-2, -1))
        return d[..., r_lo:r_hi, r_lo:col_hi]

    c, s = _idft(dim, dev, dtype)
    x = psd
    mm = _mm(cfg, dev)
    if cfg.otf_window is None:
        re_bg = mm(mm(c, x), c.T) - mm(mm(s, x), s.T)
    else:
        # fold: the real part of the inverse transform equals the
        # transform of the symmetrised PSD, whose contractions fold onto
        # columns 0..N/2 (the raw GLAO PSD is not f -> -f symmetric)
        nh = dim // 2 + 1
        vh = host_const(("fold_half", nh), lambda: _half_weights(nh), dev,
                        dtype)
        xs = 0.5 * (x + torch.roll(torch.flip(x, dims=(-2, -1)), (1, 1),
                                   dims=(-2, -1)))
        xh = xs[..., :nh]
        re_bg = (mm(mm(c[r_lo:r_hi], xh) * vh, c[r_lo:col_hi, :nh].T)
                 - mm(mm(s[r_lo:r_hi], xh) * vh, s[r_lo:col_hi, :nh].T))
    bg00 = torch.sum(x, dim=(-2, -1))[..., None, None] / (L * L)
    return 2.0 * (bg00 - re_bg * scale)


def lambda_crop_size(lbda_nm, cfg: GalacsiConfig):
    """Even crop size ``npixc(lbda)`` [px] (reference psfrec.py:663-664),
    decided on the host in float64.

    QUIRK: ``np.round`` is round-half-to-even, and the MUSE grids land on
    exact .5 boundaries for some wavelengths (plane 19 of linspace(500,
    900, 37): 436.5 -> 872); a float32 quotient lands on the other side
    and shifts that plane's regrid by 2 px.
    """
    scale = cfg.dimpsf * cfg.pixscale * 2.0 * cfg.dpup * 4.85 * 1000.0
    raw = scale / np.asarray(lbda_nm, np.float64)
    return (np.round(raw / 2.0) * 2.0).astype(np.int64)


def _crop_grid(npix, cfg: GalacsiConfig, dtype):
    """Bilinear floor indices (k, nout) int64 and weights (k, nout) of the
    per-wavelength crop-and-regrid (crop ``npix`` px, ``nout`` samples)."""
    dim, nout = cfg.dim, cfg.dimpsf
    start = (dim // 2 - npix // 2).to(dtype)
    step = npix.to(dtype) / nout
    pos = start[:, None] + torch.arange(nout, dtype=dtype,
                                        device=npix.device)[None] * \
        step[:, None]
    i0f = torch.floor(pos)
    t = pos - i0f
    i0 = torch.clamp(i0f.to(torch.int64), 0, dim - 2)
    return i0, t


def _zoom_dft_matrices(idx, dim: int, dtype):
    """Real/imag inverse-DFT rows for PSF pixel indices ``idx`` (..., npts)
    int64: ``psf[p, q] = Re sum_g G[g1, g2] A[p, g1] A[q, g2]`` with
    ``A[p, g] = exp(2i pi (p - N/2)(g + N/2) / N) / N``.  The phase is
    reduced mod N in integers before the trig.  Returns (..., npts, dim)."""
    kk = (idx - dim // 2)[..., None]
    gg = torch.arange(dim, device=idx.device) + dim // 2
    ph = torch.remainder(kk * gg, dim).to(dtype)
    ang = ph * (2.0 * np.pi / dim)
    return torch.cos(ang) / dim, torch.sin(ang) / dim


def _combine_bilinear(p, t, nout: int):
    """(..., 2n, 2n) PSF node values -> (..., n, n) bilinear samples with
    per-plane weights ``t`` (..., n)."""
    w0 = 1.0 - t
    tr, tc = t[..., :, None], t[..., None, :]
    w0r, w0c = w0[..., :, None], w0[..., None, :]
    return (w0r * w0c * p[..., :nout, :nout]
            + w0r * tc * p[..., :nout, nout:]
            + tr * w0c * p[..., nout:, :nout]
            + tr * tc * p[..., nout:, nout:])


def _zoom_operands(base, lb_k, npix_k, cfg: GalacsiConfig):
    """K1's inputs for one wavelength chunk, plus what the second zoom
    stage needs: ``(a2, alpha, w, ar2, ai2, t)``.

    ``a2`` (k, 4n, rows) stacked [Ar; Ai] rows over the window rows;
    ``alpha`` (k,) damping exponents; ``w`` (B, k, ndir) per-direction DC
    weights; ``ar2/ai2`` (k, 2n, cols) second-stage rows with the fold
    weights applied; ``t`` (k, n) bilinear weights.
    """
    dtype = base.dtype
    dim, ndir = cfg.dim, base.shape[1]
    r_lo, r_hi, col_hi, S = _window_bounds(cfg)
    i0, t = _crop_grid(npix_k, cfg, dtype)
    idx = torch.cat([i0, i0 + 1], dim=1)                 # (k, 2n)
    ar, ai = _zoom_dft_matrices(idx, dim, dtype)          # (k, 2n, dim)
    a2 = torch.cat([ar, ai], dim=1)[..., r_lo:r_hi].contiguous()

    alpha = -0.5 * (2.0 * np.pi / lb_k) ** 2              # (k,)
    c = dim // 2
    dlc = float(pupil_otf(cfg)[c, c])
    norm = torch.exp(alpha[None, :, None]
                     * base[:, None, :, c - r_lo, c - r_lo]) * dlc
    w = (1.0 / (ndir * norm)).contiguous()               # (B, k, ndir)
    ar2, ai2 = ar[..., r_lo:col_hi], ai[..., r_lo:col_hi]
    if cfg.otf_window is not None:
        v = _fold_weights_on(dim, S, base.shape[-1], base.device, dtype)
        ar2, ai2 = ar2 * v, ai2 * v
    return a2, alpha.contiguous(), w, ar2, ai2, t


def _zoom_row_splits(n_blocks: int, n: int, sm_count: int) -> int:
    """Contraction-row slices R of the fused zoom launch on the card
    (counterpart of ``_pallas_zoom_plan``).  ``n_blocks`` is K1's grid
    (rows x wavelengths x 64-column tiles x 160-row output blocks), ``n``
    the contraction length.  Among R in (1, 2, 4, 8) with ``n % R == 0``
    and ``(n // R) % 32 == 0``, the smallest whose grid ``n_blocks * R``
    gives every SM a block, else the largest valid R.  On the TPU a split
    let a block fit VMEM; here it only fills the SMs when a launch is too
    small to (single-row calls: the CLI block, ``compute_psf``)."""
    valid = [r for r in (1, 2, 4, 8) if n % r == 0 and (n // r) % 32 == 0]
    for r in valid:
        if n_blocks * r >= sm_count:
            return r
    return valid[-1] if valid else 1


def _anchor_lambda_chunk(cfg: GalacsiConfig, nl: int) -> int:
    """Wavelengths per anchor group of K6 (``fused_exp_zoom_anchor``):
    ``min(cfg.lambda_chunk, nl, ANCHOR_MAX_GROUP)``, shared by the chunk
    path and the host certification (:func:`resolve_zoom_anchor`).

    The JAX package sizes its groups by the TPU's VMEM model, which means
    nothing here.  On the card one launch takes every group, and a block
    keeps the accumulators of all its group's wavelengths in registers,
    which caps a group at ``ANCHOR_MAX_GROUP`` (8).  Within that, fewer
    groups mean fewer exponentials, and the certified bound grows with the
    group: on the bench grid (35 wavelengths, 490-930 nm, degree 8) groups
    of 7 certify 1.6e-8 and of 8 7.4e-8, against the 1e-6 budget.  The
    default 7 keeps the JAX package's ``lambda_chunk``.
    """
    from ..ops.zoom_dft import ANCHOR_MAX_GROUP
    return max(1, min(int(cfg.lambda_chunk), int(nl), ANCHOR_MAX_GROUP))


def zoom_anchor_bound(lbda_nm, k: int, degree: int) -> float:
    """Certified per-pixel OTF abs-error bound of the anchored-Taylor
    damping (``cfg.zoom_anchor``), maximised over the groups of ``k``
    consecutive wavelengths (counterpart of the JAX package's function of
    the same name).

    Per group the kernel evaluates ``e^{alpha_l D} = e^x sum_j u^j/j!``
    truncated at ``degree``, with ``x = alpha* D`` (``alpha*`` the
    midpoint of the group's alphas) and ``u = (alpha_l/alpha* - 1) x``.
    With ``r = max_l |alpha_l/alpha* - 1|``, ``t = -x >= 0`` and ``p =
    degree + 1`` the truncation error is at most ``e^{-t} (r t)^p/p!
    e^{r t}``, whose supremum over t is ``(r p/(1 - r))^p e^{-p}/p!``:
    uniform in D, so it certifies every pixel, direction and row at once.
    A ragged last group is padded with its last wavelength, which leaves
    its bound unchanged.  +inf when any group has ``r >= 1`` or the grid
    is not finite and positive.
    """
    from math import factorial
    lb = np.asarray(lbda_nm, np.float64).ravel()
    if lb.size == 0 or not np.all(np.isfinite(lb)) or np.any(lb <= 0):
        return np.inf
    pad = (-lb.size) % k
    if pad:
        lb = np.concatenate([lb, np.repeat(lb[-1], pad)])
    al = -0.5 * (2.0 * np.pi / lb) ** 2
    p = degree + 1
    worst = 0.0
    for c in al.reshape(-1, k):
        astar = 0.5 * (c.min() + c.max())
        r = np.max(np.abs(c / astar - 1.0))
        if r >= 1.0:
            return np.inf
        worst = max(worst, (r * p / (1.0 - r)) ** p
                    * np.exp(-p) / factorial(p))
    return worst


def resolve_zoom_anchor(cfg: GalacsiConfig, lbda_nm, ndir: int,
                        device="cuda") -> GalacsiConfig:
    """Resolve ``cfg.zoom_anchor == "auto"`` on the host: "on" iff the
    night runs on CUDA through the fused kernels (``use_fused_zoom``,
    ``use_zoom_dft``, float32, ``dim % 128 == 0``, a degree K6 takes),
    has at least
    ``cfg.zoom_anchor_min_ndir`` directions, and the certified bound
    (:func:`zoom_anchor_bound` at :func:`_anchor_lambda_chunk`) is within
    ``cfg.zoom_anchor_budget``.  Otherwise "auto" is kept, which the chunk
    path runs as "off" (as the JAX package does off the TPU); "on" and
    "off" pass through.  ``device`` is the night's target: a CPU process
    may plan a card night."""
    if cfg.zoom_anchor != "auto" or ndir < cfg.zoom_anchor_min_ndir:
        return cfg
    from ..ops.zoom_dft import ANCHOR_MAX_DEGREE
    if not (torch.device(device).type == "cuda" and cfg.use_fused_zoom
            and cfg.use_zoom_dft and cfg.dtype == "float32"
            and cfg.dim % 128 == 0
            and cfg.zoom_anchor_degree <= ANCHOR_MAX_DEGREE):
        return cfg
    lb = np.asarray(lbda_nm, np.float64).ravel()
    k = _anchor_lambda_chunk(cfg, lb.size)
    bound = zoom_anchor_bound(lb, k, cfg.zoom_anchor_degree)
    if bound > cfg.zoom_anchor_budget:
        logger.warning(
            "zoom_anchor auto-disabled: certified bound %.2e exceeds "
            "budget %.2e (degree %d, group %d)", bound,
            cfg.zoom_anchor_budget, cfg.zoom_anchor_degree, k)
        return cfg
    return cfg.with_(zoom_anchor="on")


def _anchor_operands(alpha, k: int, degree: int, norm: float):
    """K6's per-group anchors and per-wavelength coefficients: ``astar``
    (ceil(nl/k),) the midpoint alpha of each group of ``k`` wavelengths,
    ``coef`` (nl, degree+1) = ``(alpha_l/astar_g - 1)^j / j! / norm``.
    The powers are cumulative products, as in the JAX package: a negative
    base has no real power."""
    from math import factorial
    nl = alpha.shape[0]
    astar = torch.stack([0.5 * (torch.min(alpha[i:i + k])
                                + torch.max(alpha[i:i + k]))
                         for i in range(0, nl, k)])
    rho1 = alpha / astar[:, None].expand(-1, k).reshape(-1)[:nl] - 1.0
    cols = [torch.ones_like(rho1)]
    for _ in range(degree):
        cols.append(cols[-1] * rho1)
    fact = host_const(("factorials", degree),
                      lambda: [float(factorial(j))
                               for j in range(degree + 1)],
                      alpha.device, alpha.dtype)
    coef = torch.stack(cols, dim=1) / fact[None, :] / norm
    return astar.contiguous(), coef.contiguous()


def _zoom_precision(cfg: GalacsiConfig, device) -> str:
    """The contraction precision of the fused zoom kernels for a chunk on
    ``device``: ``cfg.zoom_precision`` on the card, where the kernels run
    (three bf16 passes at "high", six at "highest", both on the tensor
    cores), and "highest" on the CPU.

    A chunk of the exact structure-function transform
    (``use_dphi_split=False``: the batch planner's group of rows with
    ``L0 < cfg.dphi_split_l0_min``) contracts at "highest" on the card
    whatever ``zoom_precision`` says.  Such a small outer scale makes the
    tip-tilt kernel nearly a delta, which the reference does not
    renormalise: the L0 = 2.0 m pinned row's cube sums to ~490 a plane
    (``tests/data/golden_psf_35l_s1.0_gl0.7_l02.0.npy``) where the L0 =
    25 m row's sums to ~1.5, so the zoom stage's relative error meets the
    absolute 1e-5 rms budget ~300x sooner.  At "high" that row lies
    1.2e-5 rms from the float64 oracle on an H100; at "highest" 7.9e-6
    (``chip_smoke.py`` phase 25).

    The JAX package reads
    ``zoom_precision`` only in its Pallas path, which runs only on the
    TPU; off the TPU its chunk contracts in full precision (XLA), and so
    does the port's CPU chunk, which the CPU tests hold to the JAX
    package's.  The CPU chunk runs the kernels' plain version
    (``ops/zoom_dft.py:contract``): in float32 a matmul per 32 contraction
    rows, then a running sum over the steps, the order the card's night at
    "highest" sums in (XLA sums in one dot, within the tests' tolerances
    of it); in float64 one matmul, as XLA does."""
    if torch.device(device).type != "cuda" or not cfg.use_dphi_split:
        return "highest"
    return cfg.zoom_precision


def _psf_chunk_fused(base, lb_k, npix_k, cfg: GalacsiConfig):
    """Fused path for one wavelength chunk (counterpart of
    ``_psf_chunk_pallas``): K1 builds the direction-averaged system OTF
    tile by tile and contracts it with the first zoom stage (split over
    contraction-row slices, K3, where the launch alone would leave SMs
    idle); the second stage and the bilinear combine follow as plain
    contractions.

    ``cfg.zoom_anchor == "on"`` runs K6 instead: the structure function
    shifted by each direction's centre value (which makes every DC
    normaliser exactly 1, so the weights fold into the coefficients), one
    exponential per direction and wavelength group.  ``cfg.disc_skip`` at
    ``ndir >= cfg.disc_min_ndir`` runs K5 where the window has dead
    diffraction blocks (:func:`_disc_block_mask`).  Every one of them
    contracts at :func:`_zoom_precision`.

    ``base``: (B, ndir, rows, cols) windowed structure function, which
    may be a strided view (the blue sub-window); ``lb_k``/``npix_k``: (k,)
    wavelengths [nm] and crop sizes.  Returns (B, k, dimpsf, dimpsf)
    normalised PSF samples.
    """
    from ..ops import zoom_dft
    nout = cfg.dimpsf
    ndir = base.shape[1]
    a2, alpha, w, ar2, ai2, t = _zoom_operands(base, lb_k, npix_k, cfg)
    dl = _dl_window(cfg, base.device, base.dtype)
    if cfg.zoom_anchor == "on":
        c = cfg.dim // 2
        cc = c - _window_bounds(cfg)[0]
        k = _anchor_lambda_chunk(cfg, alpha.shape[0])
        astar, coef = _anchor_operands(alpha, k, cfg.zoom_anchor_degree,
                                       ndir * float(pupil_otf(cfg)[c, c]))
        u = zoom_dft.fused_exp_zoom_anchor(
            base, dl, a2, base[:, :, cc, cc].contiguous(), astar, coef, k,
            precision=_zoom_precision(cfg, base.device))
    else:
        splits = 1
        if base.device.type == "cuda":
            B, _, n, ncols = base.shape
            n_blocks = (B * a2.shape[0] * -(-ncols // zoom_dft.N_TILE)
                        * -(-a2.shape[1] // zoom_dft.M_TILE))
            sms = torch.cuda.get_device_properties(
                base.device).multi_processor_count
            splits = _zoom_row_splits(n_blocks, n, sms)
        msk = (_disc_block_mask(cfg)
               if cfg.disc_skip and ndir >= cfg.disc_min_ndir else None)
        kw = dict(exp2=cfg.zoom_exp2, row_splits=splits,
                  precision=_zoom_precision(cfg, base.device))
        if msk is not None:
            u = zoom_dft.fused_exp_zoom_disc(base, dl, a2, alpha, w, msk,
                                             **kw)
        else:
            u = zoom_dft.fused_exp_zoom(base, dl, a2, alpha, w, **kw)
    m = 2 * nout                                          # u: (B, k, 4n, cols)
    mm = _mm(cfg, base.device)
    p = (mm(u[:, :, :m], ar2.transpose(-1, -2))
         - mm(u[:, :, m:], ai2.transpose(-1, -2)))        # (B, k, m, m)
    out = _combine_bilinear(torch.clamp_min(p, 0.0), t, nout)
    return out / torch.sum(out, dim=(-2, -1), keepdim=True)


def _psf_samples_zoom(mean_otf, i0, t, cfg: GalacsiConfig):
    """Bilinear PSF samples of direction-averaged OTFs (B, k, rows, cols)
    by zoom DFT, without the full-resolution PSF; exactly the FFT path
    followed by :func:`_bilinear_regrid`, clip at zero included."""
    dtype = mean_otf.dtype
    dim = cfg.dim
    r_lo, r_hi, col_hi, S = _window_bounds(cfg)
    idx = torch.cat([i0, i0 + 1], dim=-1)                # (k, 2n)
    ar, ai = _zoom_dft_matrices(idx, dim, dtype)
    mm = _mm(cfg, mean_otf.device)
    u_r = mm(ar[..., r_lo:r_hi], mean_otf)               # (B, k, 2n, cols)
    u_i = mm(ai[..., r_lo:r_hi], mean_otf)
    if cfg.otf_window is not None:
        v = _fold_weights_on(dim, S, mean_otf.shape[-1], mean_otf.device,
                             dtype)
        u_r, u_i = u_r * v, u_i * v
    p = (mm(u_r, ar[..., r_lo:col_hi].transpose(-1, -2))
         - mm(u_i, ai[..., r_lo:col_hi].transpose(-1, -2)))
    return _combine_bilinear(torch.clamp_min(p, 0.0), t, cfg.dimpsf)


def _psf_plane_fft(mean_otf):
    """Full-resolution PSF planes from direction-averaged OTFs (centred)."""
    cdtype = torch.complex64 if mean_otf.dtype == torch.float32 else \
        torch.complex128
    sys_otf = torch.fft.fftshift(mean_otf, dim=(-2, -1)).to(cdtype)
    psf = torch.fft.ifft2(sys_otf).real
    return torch.fft.fftshift(psf, dim=(-2, -1))


def _bilinear_regrid(img, i0, t):
    """out[.., i, j] = bilinear(img, (pos_i, pos_j)) per plane, with floor
    indices ``i0`` and weights ``t`` (k, nout) from :func:`_crop_grid`;
    ``img`` (B, k, N, N).  Replaces the reference's crop + ``interpn``
    regrid (psfrec.py:672-683)."""
    k = i0.shape[0]
    kk = torch.arange(k, device=img.device)[:, None]
    rows = (img[:, kk, i0] * (1.0 - t)[None, :, :, None]
            + img[:, kk, i0 + 1] * t[None, :, :, None])  # (B, k, n, N)
    ix = i0[None, :, None, :].expand(img.shape[0], k, i0.shape[1], -1)
    return (torch.gather(rows, -1, ix) * (1.0 - t)[None, :, None, :]
            + torch.gather(rows, -1, ix + 1) * t[None, :, None, :])


def _psf_chunk_plain(base, lb_k, npix_k, cfg: GalacsiConfig):
    """Unfused path for one wavelength chunk (the batched ``one_lambda``
    body): the system OTF per direction, its DC-normalised direction
    average, then the zoom DFT (or the full inverse FFT and a bilinear
    regrid when ``cfg.use_zoom_dft`` is off).  Returns (B, k, n, n)."""
    dim = cfg.dim
    r_lo = _window_bounds(cfg)[0]
    cc = dim // 2 - r_lo                                   # local centre
    i0, t = _crop_grid(npix_k, cfg, base.dtype)
    convnm2 = (2.0 * np.pi / lb_k) ** 2                    # (k,)
    ao = torch.exp(-0.5 * convnm2[None, :, None, None, None]
                   * base[:, None])                        # (B, k, ndir, ..)
    prod = ao * _dl_window(cfg, base.device, base.dtype)
    norm = prod[..., cc, cc]                               # (B, k, ndir)
    mean_otf = torch.mean(prod / norm[..., None, None], dim=2)
    if cfg.use_zoom_dft:
        out = _psf_samples_zoom(mean_otf, i0, t, cfg)
    else:
        psf = torch.clamp_min(_psf_plane_fft(mean_otf), 0.0)
        out = _bilinear_regrid(psf, i0, t)
    return out / torch.sum(out, dim=(-2, -1), keepdim=True)


def psd_to_psf(psd, pup, D, lbda, phase_static=None, samp=None, FoV=None,
               return_all=False, dtype=torch.float64, device="cuda"):
    """General long-exposure PSF from one residual PSD [nm^2] and a pupil.

    Standalone equivalent of the reference ``psd_to_psf``
    (psfrec.py:689-807) for single transforms (the batched pipeline uses
    :func:`psf_cube`): supports sub-Nyquist output sampling (central crop
    of the structure function), an optional static pupil phase [nm], and
    ``return_all`` -> (psf, sampout, FoV).  ``lbda`` in metres.  Runs on
    ``device`` in ``dtype`` (float64 by default, on the card too) and
    returns a tensor there.

    The reference's oversampling branches are unreachable in its shipped
    pipeline and crash when forced (``np.zeros(dimnum, dimnum)`` at
    psfrec.py:738 is a TypeError; cubic ``interpolate`` raises
    NotImplementedError at psfrec.py:640); they are rejected here with the
    matching exception.
    """
    dev = resolve_device(device)
    psd = torch.as_tensor(psd, dtype=dtype, device=dev)
    pup = torch.as_tensor(pup, dtype=dtype, device=dev)
    cdtype = torch.complex128 if dtype == torch.float64 else torch.complex64
    dim = psd.shape[0]
    npup = pup.shape[0]
    sampnum = dim / npup
    L = D * sampnum
    if dim < 2 * npup:
        logger.info("the PSD horizon must be at least two time larger than "
                    "the pupil diameter")

    convnm = 2 * np.pi / (lbda * 1e9)
    bg = torch.fft.ifft2(torch.fft.fftshift(psd * convnm ** 2).to(cdtype))
    bg = bg * (psd.numel() / L ** 2)
    dphi = torch.fft.fftshift(2.0 * (bg[0, 0].real - bg.real))

    sampin = samp if samp is not None else sampnum
    if sampin < 2:
        logger.info("PSF should be at least nyquist sampled")
    dimnum = int(np.fix(dim * (sampin / sampnum) / 2)) * 2
    sampout = dimnum / npup
    if sampin <= sampnum:
        ns = int(sampout * npup / 2)
        lo = dim // 2 - ns
        dphi2 = dphi[lo:lo + 2 * ns, lo:lo + 2 * ns]
    else:
        raise NotImplementedError(
            "samp > dim/npup requires structure-function extrapolation, "
            "which crashes in the reference (psfrec.py:738-744)")

    fov_num = (lbda / (sampnum * D)) * dim / 4.85e-6
    if FoV is not None and not np.allclose(float(FoV), fov_num):
        raise NotImplementedError(
            "FoV oversampling needs cubic interpolation, unimplemented in "
            "the reference (psfrec.py:640)")
    dimover, npupover = dimnum, npup

    tab = torch.zeros((dimover, dimover), dtype=cdtype, device=dev)
    pup_sum = torch.sum(pup)      # normaliser uses the unmodified pupil
    if phase_static is not None:
        phase = torch.as_tensor(phase_static, dtype=dtype, device=dev)
        # the angle in the reference's order of operations: it reaches
        # ~1e8 rad (phase in nm over lbda in m), where one rounding of
        # the angle moves the PSF by ~1e-8
        pup = pup * torch.polar(torch.ones_like(phase),
                                phase * 2 * np.pi / lbda)
    tab[:npupover, :npupover] = pup.to(cdtype)
    dl_otf = torch.fft.fftshift(
        torch.abs(torch.fft.fft2(torch.abs(torch.fft.ifft2(tab)) ** 2))
        / pup_sum)

    sys_otf = torch.fft.fftshift(torch.exp(-dphi2 / 2.0) * dl_otf)
    psf = torch.fft.fftshift(torch.fft.ifft2(sys_otf.to(cdtype)).real)
    psf = psf / torch.sum(psf)
    if return_all:
        return psf, sampout, fov_num * dimover / dim
    return psf


def psf_cube(psd, lbda_nm, cfg: GalacsiConfig, device="cuda"):
    """PSF cube (nl, dimpsf, dimpsf) at the MUSE sampling from the PSD cube
    of one telemetry row, a tensor on ``device``.

    ``psd``: (ndir, dim, dim) image-centred residual PSD [nm^2/freq^2], or
    (dim, dim) for a single direction (array or tensor); ``lbda_nm``: (nl,)
    wavelengths [nm].  The crop sizes are decided in host float64 before
    anything else (the .5-boundary QUIRK of :func:`lambda_crop_size`);
    then :func:`dphi_base` and :func:`psf_cube_from_base` run in
    ``cfg.dtype`` on ``device``.  The batched pipeline calls those two with
    the rows as the leading dimension; this is the one-row entry point.
    """
    dev = resolve_device(device)
    lb_host = np.asarray(lbda_nm.cpu() if torch.is_tensor(lbda_nm)
                         else lbda_nm, np.float64)
    npixc = lambda_crop_size(lb_host, cfg)
    psd = torch.as_tensor(psd, dtype=torch_dtype(cfg.dtype), device=dev)
    if psd.ndim == 2:
        psd = psd[None]
    base = dphi_base(psd[None], cfg)                # (1, ndir, rows, cols)
    return psf_cube_from_base(base, lb_host, cfg, npixc=npixc)[0]


def _blue_split_cfgs(cfg: GalacsiConfig, nl: int):
    """Validate ``cfg.otf_blue`` and return ``(nb, cfg_blue, cfg_red)``:
    the same config re-rooted on the centred sub-window
    (``otf_support=S_blue``), and the bucket config with the split
    cleared."""
    nb, Sb = (int(x) for x in cfg.otf_blue)
    win = cfg.otf_window
    if win is None:
        raise ValueError("otf_blue requires the fold/window machinery "
                         "(cfg.otf_window is None)")
    S = win[1]
    if Sb % 128 != 0 or not 0 < Sb < S:
        raise ValueError(
            f"otf_blue window {Sb} must be a positive multiple of 128 "
            f"smaller than the bucket window {S}")
    if not 0 < nb < nl:
        raise ValueError(
            f"otf_blue segment length {nb} must satisfy 0 < nb < nl={nl}")
    cfg_red = cfg.with_(otf_blue=None)
    return nb, cfg_red.with_(otf_support=Sb), cfg_red


def psf_cube_from_base(base, lbda_nm, cfg: GalacsiConfig, npixc=None):
    """PSF cubes (B, nl, dimpsf, dimpsf) from the wavelength-free structure
    function ``base`` (B, ndir, rows, cols), produced by
    :func:`dphi_base`/:func:`dphi_base_split` under the SAME config.

    ``lbda_nm``: (nl,) wavelengths [nm] (host array or tensor);
    ``npixc``: crop sizes, decided on the host in float64 from ``lbda_nm``
    when not given (:func:`lambda_crop_size`).  With
    ``cfg.use_fused_zoom`` the whole cube is one K1 launch; otherwise the
    plain body runs ``cfg.lambda_chunk`` wavelengths per step.  With
    ``cfg.otf_blue = (nb, S_blue)`` the first ``nb`` wavelengths run on the
    centred ``S_blue`` sub-window of ``base``.
    """
    dev, dtype = base.device, base.dtype
    dim = cfg.dim
    if npixc is None:
        lb_host = (lbda_nm.cpu().numpy() if torch.is_tensor(lbda_nm)
                   else lbda_nm)
        npixc = lambda_crop_size(lb_host, cfg)
    if cfg.otf_blue is not None:
        # blue-segment window split: the damping exponent scales as
        # (2 pi/lbda)^2, so the bluest nb wavelengths run on the smaller
        # centred sub-window, a strided view of the same structure
        # function, through this very body re-rooted on that window
        nb, cfg_blue, cfg_red = _blue_split_cfgs(cfg, len(npixc))
        S, Sb = cfg.otf_window[1], cfg_blue.otf_window[1]
        lo = S - Sb
        return torch.cat([
            psf_cube_from_base(base[..., lo:S + Sb, lo:], lbda_nm[:nb],
                               cfg_blue, npixc=npixc[:nb]),
            psf_cube_from_base(base, lbda_nm[nb:], cfg_red,
                               npixc=npixc[nb:])], dim=1)
    win = cfg.otf_window
    expect = (dim, dim) if win is None else (2 * win[1], win[1] + 128)
    if tuple(base.shape[-2:]) != expect:
        raise ValueError(
            f"structure-function block {tuple(base.shape[-2:])} does not "
            f"match the config's fold/support window {expect}; produce "
            "`base` with dphi_base/dphi_base_split under the same config")
    if not cfg.use_fft and not cfg.use_zoom_dft:
        raise ValueError("the FFT-free mode (use_fft=False) requires the "
                         "zoom-DFT resampling path (use_zoom_dft=True)")
    lb = torch.as_tensor(lbda_nm, dtype=dtype, device=dev)
    npix = torch.as_tensor(npixc, dtype=torch.int64, device=dev)
    if cfg.use_fused_zoom and cfg.use_zoom_dft:
        return _psf_chunk_fused(base, lb, npix, cfg)
    k = max(1, cfg.lambda_chunk)
    return torch.cat([_psf_chunk_plain(base, lb[i:i + k], npix[i:i + k],
                                       cfg)
                      for i in range(0, lb.shape[0], k)], dim=1)
