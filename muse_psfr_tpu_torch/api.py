"""Public API: PSF reconstruction from atmospheric telemetry.

Counterparts of ``muse_psfr_tpu/api.py`` (the reference package's
``compute_psf`` and ``compute_psf_from_sparta``, psfrec.py:933-1120, plus
the condition sweep): identical FITS output layout (PRIMARY /
SPARTA_ATM_DATA copy / FIT_ROWS / FIT_MEAN / PSF_MEAN), identical
telemetry-validation semantics and log-message contract, with the batch
run on an explicit ``device`` (default ``"cuda"``; raises when CUDA is
unavailable) in place of the reference's joblib process pool.
"""

import json
import os

import numpy as np
import torch

from .config import DEFAULT_CONFIG
from .fit.moffat_fit import (N_PACKED, fit_moffat_cube,
                             fit_moffat_cube_host64, unpack_fit)
from .fit.polynom import fit_psf_with_polynom, norm_lbda  # noqa: F401
from .io.fits import HDUList, PrimaryHDU, ImageHDU
from .io.sparta import create_sparta_table, read_sparta_values  # noqa: F401
from .io.table import FitTable
from .parallel.batch import reconstruct_batch, process_batch
from .utils.log import get_logger
from .utils.profiling import maybe_trace

logger = get_logger("api")


def _atomic_write_npy(path, arr):
    """Crash-atomic ``np.save``: a SIGKILL mid-write must never leave a
    truncated checkpoint (resume would crash at ``np.load`` and ALL
    completed work would be unrecoverable)."""
    tmp = path + ".tmp"
    with open(tmp, "wb") as fh:
        np.save(fh, arr)
    os.replace(tmp, path)


def _atomic_write_json(path, obj):
    """Crash-atomic sidecar write: a torn sidecar is silently treated
    as missing, sending resume down the NaN fallback that trusts
    guard-unvalidated values — the hazard the sidecar exists to
    prevent."""
    tmp = path + ".tmp"
    with open(tmp, "w") as fh:
        json.dump(obj, fh)
    os.replace(tmp, path)


MIN_L0 = 8    # minimum valid outer scale [m] (psfrec.py:30)
MAX_L0 = 30   # maximum valid outer scale [m] (psfrec.py:31)

#: column order of the per-wavelength Moffat fit tables
_FIT_COLUMNS = ("center", "flux", "fwhm", "n", "peak", "err_center",
                "err_flux", "err_fwhm", "err_n", "err_peak")


def _debug_condition_summary(seeing, GL, h, cfg):
    """Per-condition DEBUG parameter summary (reference psfrec.py:116-124).

    The wind speed follows the integer-altitude truncation quirk of the
    PSD model so the logged value matches what is actually simulated.
    """
    if not logger.isEnabledFor(10):  # logging.DEBUG
        return
    from .psd.model import effective_wind_speed
    cn2 = np.array([GL, 1 - GL])
    cn2 = cn2 / cn2.sum()
    hz = np.asarray(h, float)
    r0 = 0.976 * 0.5 / seeing / 4.85
    vent = np.full(2, effective_wind_speed(h, cfg))
    logger.debug("r0 0.5um (zenith)        = %.2f", r0)
    logger.debug("r0 0.5um (line of sight) = %.2f", r0)
    logger.debug("Seeing   (line of sight) = %.2f", 0.987 * 0.5 / r0 / 4.85)
    logger.debug("hbarre   (zenith)        = %.2f",
                 np.sum(hz ** (5 / 3) * cn2) ** (3 / 5))
    logger.debug("hbarre   (line of sight) = %.2f",
                 np.sum(hz ** (5 / 3) * cn2) ** (3 / 5))
    logger.debug("vbarre                   = %.2f",
                 np.sum(vent ** (5 / 3) * cn2) ** (3 / 5))


def fit_table_from_arrays(lbda, fit, pixscale=0.2):
    """Moffat-fit arrays (leading axis = wavelength) -> FitTable.

    FWHM converted px -> arcsec (reference psfrec.py:868-869).  When the
    fit dict carries the per-plane ``ok`` convergence flag (see
    :data:`muse_psfr_tpu_torch.fit.moffat_fit.PACKED_FIELDS`) it is appended
    as an extra float column (1.0/0.0) — an ADDITIVE extension of the
    reference's table layout, the analog of the scipy-leastsq status
    the reference's mpdaf fit computes but does not surface
    (psfrec.py:861-871).  All reference columns keep their names and
    order; consumers indexing columns by name are unaffected.
    """
    t = FitTable()
    t["lbda"] = np.asarray(lbda, float)
    for k in _FIT_COLUMNS:
        v = np.asarray(fit[k], float)
        if k in ("fwhm", "err_fwhm"):
            v = v * pixscale
        t[k] = v
    if "ok" in fit:
        t["ok"] = np.asarray(fit["ok"], float)
    return t


def compute_psf(lbda, seeing, GL, L0, npsflin=1, h=(100, 10000),
                three_lgs_mode=False, verbose=True, cfg=DEFAULT_CONFIG,
                device="cuda"):
    """Reconstruct a PSF cube from one (seeing, GL, L0) condition.

    Returns ``(FitTable, psf ndarray (nl, dimpsf, dimpsf))``, the contract
    of the reference ``compute_psf`` (psfrec.py:933-978).
    """
    if verbose:
        logger.info("Compute PSF with seeing=%.2f GL=%.2f L0=%.2f",
                    seeing, GL, L0)
        if three_lgs_mode:
            logger.info("Using three lasers mode")
    _debug_condition_summary(seeing, GL, h, cfg)
    lbda = np.atleast_1d(np.asarray(lbda, float))
    gs_mask = np.array([[1.0, 1.0, 1.0, 0.0 if three_lgs_mode else 1.0]])
    psf = reconstruct_batch([seeing], [GL], [L0], gs_mask, lbda, h=h,
                            npsflin=npsflin, cfg=cfg, device=device)[0]
    fit = fit_moffat_cube(torch.as_tensor(psf, device=device),
                          dtype=cfg.fit_dtype)
    res = fit_table_from_arrays(lbda, fit, cfg.pixscale)
    res.meta.update({"SEEING": seeing, "GL": GL, "L0": L0})
    res["SEEING"] = seeing
    res["GL"] = GL
    res["L0"] = L0
    return res, psf


def condition_sweep(seeing_vals, gl_vals, l0_vals, lbda=None, lmin=490,
                    lmax=930, nl=35, npsflin=1, h=(100, 10000),
                    three_lgs_mode=False, cfg=DEFAULT_CONFIG, chunk=64,
                    device="cuda", checkpoint=None, resume=False,
                    mesh=None):
    """Sensitivity sweep over a Cartesian (seeing, GL, L0) condition grid.

    Reconstructs and Moffat-fits the PSF for every combination of the
    given 1-D condition arrays, batched on ``device`` (or sharded over
    ``mesh``, see :func:`process_batch`).  Returns a dict
    with the condition grids and ``fwhm``/``beta`` arrays of shape (n_seeing, n_gl, n_l0, n_lbda)
    (FWHM in arcsec), plus the packed raw fit (same leading shape).

    This covers the '32x32 condition sweep' production configuration; the
    reference has no equivalent (a sweep there is an external loop over
    ``compute_psf``, one process per row).

    ``checkpoint``: optional ``.npy`` path — the packed fits completed so
    far are (re)written crash-atomically after every chunk (plus a
    ``<path>.meta.json`` sidecar recording the sweep's parameters and
    the grid points whose values are FINAL).  Completion granularity
    follows the window guard: chunks of guard-free groups (full-window /
    exact-transform) are final at delivery, so a crash loses at most one
    such chunk; reduced-window chunks are only provably final when the
    guard vector arrives with the batch's final pull, so a crash
    mid-batch recomputes them on resume (their provisional values are
    stored but never trusted as done).  With ``resume=True``, an
    existing checkpoint whose
    sidecar matches THIS sweep's parameters (grids, wavelengths, h,
    npsflin, config, laser mode) is loaded first and only the grid
    points not recorded done are recomputed; a checkpoint with a
    missing sidecar falls back to shape compatibility + NaN-based
    doneness with a warning, and an incompatible one is ignored with a
    warning (the sweep then runs in full).  The sidecar holds
    ``repr(cfg)``, so a checkpoint written by ``muse_psfr_tpu`` (another
    config class) counts as "different parameters" here, and the other
    way round: the two packages' checkpoints are not interchangeable.
    """
    if lbda is None:
        lbda = np.linspace(lmin, lmax, nl)
    lbda = np.asarray(lbda, float)
    sv = np.asarray(seeing_vals, float)
    gv = np.asarray(gl_vals, float)
    lv = np.asarray(l0_vals, float)
    ss, gg, ll = np.meshgrid(sv, gv, lv, indexing="ij")
    B = ss.size
    gs_mask = np.ones((B, 4))
    if three_lgs_mode:
        gs_mask[:, 3] = 0.0

    # provenance the checkpoint must match before being trusted: a
    # shape-compatible file from a sweep over DIFFERENT conditions must
    # not be silently reused
    meta = {
        "seeing": sv.tolist(), "GL": gv.tolist(), "L0": lv.tolist(),
        "lbda": lbda.tolist(),
        "h": [float(x) for x in np.ravel(h)],
        "npsflin": int(npsflin), "three_lgs_mode": bool(three_lgs_mode),
        "cfg": repr(cfg), "n_packed": int(N_PACKED),
    }
    if checkpoint is not None:
        # np.save silently appends '.npy' to a suffix-less path; without
        # this normalisation resume would then look for the unsuffixed
        # name, never find it, and silently recompute the full grid
        checkpoint = str(checkpoint)
        if not checkpoint.endswith(".npy"):
            checkpoint += ".npy"
    sidecar = None if checkpoint is None else checkpoint + ".meta.json"

    buf = {"done": set()}
    if resume and checkpoint is not None and os.path.exists(checkpoint):
        prior = np.load(checkpoint)
        if prior.ndim == 3 and prior.shape == (B, len(lbda), N_PACKED):
            prior_meta = None
            if sidecar and os.path.exists(sidecar):
                try:
                    with open(sidecar) as fh:
                        prior_meta = json.load(fh)
                except (OSError, ValueError):   # torn: treated as missing
                    prior_meta = None
            if prior_meta is not None:
                if all(prior_meta.get(k) == v for k, v in meta.items()):
                    buf["a"] = np.array(prior)
                    buf["done"] = set(prior_meta.get("done", []))
                else:
                    logger.warning(
                        "checkpoint %s was written by a sweep with "
                        "different parameters (sidecar mismatch); "
                        "recomputing the full grid", checkpoint)
            else:
                logger.warning(
                    "checkpoint %s has no provenance sidecar; resuming "
                    "on shape compatibility and NaN-based doneness only "
                    "— verify it belongs to this sweep", checkpoint)
                buf["a"] = np.array(prior)
                buf["done"] = set(
                    np.nonzero(~np.isnan(prior).any(axis=(1, 2)))[0]
                    .tolist())
        else:
            logger.warning(
                "checkpoint %s has shape %s, incompatible with this "
                "sweep's (%d, %d, %d); recomputing the full grid",
                checkpoint, prior.shape, B, len(lbda), N_PACKED)
    todo = np.arange(B)
    if "a" in buf:
        todo = np.array(sorted(set(range(B)) - buf["done"]), int)
        logger.info("resuming sweep from %s: %d of %d grid points left",
                    checkpoint, todo.size, B)

    on_chunk = None
    on_redo_start = None
    on_final = None
    if checkpoint is not None:
        def on_redo_start(indices):  # noqa: F811
            # a window-guard trip invalidates these rows' earlier
            # delivery.  With done-marking deferred to on_final the rows
            # were never marked done — but NaN them out so the
            # sidecar-less NaN-based resume fallback cannot trust the
            # stale (too-small-window) values either.
            rows = todo[indices]
            buf["done"].difference_update(int(r) for r in rows)
            if "a" in buf:
                buf["a"][rows] = np.nan
                _atomic_write_npy(checkpoint, buf["a"])
            _atomic_write_json(sidecar,
                               {**meta, "done": sorted(buf["done"])})

        def on_chunk(indices, packed_np):  # noqa: F811
            # chunks arrive bucket-ordered, not grid-ordered: keep rows
            # at their grid position.  `indices` are positions in the
            # `todo` subset -> map to grid rows.  Values only — an
            # on_chunk delivery is PROVISIONAL (the window guard is
            # evaluated at the night's final pull); completion is
            # recorded by on_final below, so a crash mid-night can never
            # persist a too-small-window fit as done across a resume.
            if "a" not in buf:
                buf["a"] = np.full((B,) + packed_np.shape[1:], np.nan,
                                   packed_np.dtype)
            rows = todo[indices]
            buf["a"][rows] = packed_np
            # the sidecar must be on disk BEFORE the .npy ever is:
            # a crash after a sidecar-less np.save would send resume
            # down the NaN-based fallback, which trusts these
            # provisional (guard-unvalidated) values
            _atomic_write_json(sidecar,
                               {**meta, "done": sorted(buf["done"])})
            _atomic_write_npy(checkpoint, buf["a"])

        def on_final(indices):  # noqa: F811
            # rows provably past the window guard (untripped chunks, or
            # redone with the full window).  Doneness is tracked in the
            # sidecar (NOT by NaN content: a degenerate plane's
            # legitimate fit stores NaN error bars).
            buf["done"].update(int(r) for r in todo[indices])
            _atomic_write_json(sidecar,
                               {**meta, "done": sorted(buf["done"])})

    if todo.size:
        with maybe_trace("condition_sweep", device):
            fit_d, _, _ = process_batch(
                ss.ravel()[todo], gg.ravel()[todo], ll.ravel()[todo],
                gs_mask[todo], lbda, h=h, npsflin=npsflin, cfg=cfg,
                chunk=chunk, device=device, on_chunk=on_chunk,
                on_redo_start=on_redo_start, on_final=on_final, mesh=mesh)
            sub = np.asarray(fit_d)
        if todo.size == B:
            packed = sub
        else:
            packed = np.array(buf["a"])
            packed[todo] = sub
    else:
        packed = buf["a"]
    shape = ss.shape + (len(lbda),)
    fit = unpack_fit(packed.reshape(shape + (packed.shape[-1],)))
    return {
        "seeing": sv, "GL": gv, "L0": lv, "lbda": lbda,
        "fwhm": fit["fwhm"][..., 0] * cfg.pixscale,
        "beta": fit["n"],
        "fit": fit,
    }


def save_sweep(res, outfile):
    """Write a :func:`condition_sweep` result as a FITS file.

    Layout: PRIMARY; FWHM and BETA image HDUs of shape
    (n_seeing, n_gl, n_l0, n_lbda); one GRID binary table with the four
    flattened condition axes stored as vector columns.
    """
    grid = FitTable()
    n = max(len(res["seeing"]), len(res["GL"]), len(res["L0"]),
            len(res["lbda"]))

    def padded(a):
        a = np.asarray(a, float)
        return np.concatenate([a, np.full(n - len(a), np.nan)])[None, :]

    grid["SEEING"] = padded(res["seeing"])
    grid["GL"] = padded(res["GL"])
    grid["L0"] = padded(res["L0"])
    grid["LBDA"] = padded(res["lbda"])
    out = HDUList([
        PrimaryHDU(),
        ImageHDU(data=np.asarray(res["fwhm"], np.float64), name="FWHM"),
        ImageHDU(data=np.asarray(res["beta"], np.float64), name="BETA"),
        grid.to_hdu(name="GRID"),
    ])
    out.writeto(outfile, overwrite=True)
    return out


def compute_psf_from_sparta(filename, extname="SPARTA_ATM_DATA", npsflin=1,
                            lmin=490, lmax=930, nl=35, lbda=None,
                            h=(100, 10000), n_jobs=-1, plot=False,
                            mean_of_lgs=True, verbose=True,
                            cfg=DEFAULT_CONFIG, chunk=50, device="cuda",
                            mesh=None):
    """Reconstruct PSFs for every row of a SPARTA telemetry table.

    Same contract as the reference (psfrec.py:981-1120): returns an
    ``HDUList`` [PRIMARY, SPARTA_ATM_DATA (copy), FIT_ROWS, FIT_MEAN,
    PSF_MEAN], or ``None`` if no row has valid telemetry.  ``n_jobs`` is
    accepted for API compatibility and unused; the rows run as one batch
    on ``device``, ``chunk`` rows at a time, or sharded over ``mesh``
    (:func:`process_batch`).
    """
    values, hdul = read_sparta_values(filename, extname)
    out = HDUList([PrimaryHDU(), hdul[extname].copy()])

    nrows = values.shape[0]
    if nrows == 1:
        n_jobs = 1
    if lbda is None:
        lbda = np.linspace(lmin, lmax, nl)
    lbda = np.asarray(lbda, float)

    if verbose:
        logger.info("Processing SPARTA table with %d values, njobs=%d ...",
                    nrows, n_jobs)

    # --- telemetry validation / work-item assembly (psfrec.py:1041-1076) --
    items = []           # (seeing, GL, L0, three_lgs_mode, lgs_idx)
    for irow in range(1, nrows + 1):
        vals = values[irow - 1]                       # (4 lasers, 3)
        valid = ((vals[:, 1] > 0) &                   # GL > 0
                 (vals[:, 2] < MAX_L0) &
                 (vals[:, 2] > MIN_L0))
        nb_gs = int(valid.sum())
        three = nb_gs < 4
        if nb_gs == 0:
            if verbose:
                logger.info("%d/%d : No valid values, skipping this row",
                            irow, nrows)
                logger.debug("Values: %s", vals.tolist())
            continue
        elif nb_gs < 4:
            if verbose:
                logger.info("%d/%d : Using only %d values out of 4 after "
                            "outliers rejection", irow, nrows, nb_gs)
        if mean_of_lgs:
            seeing, GL, L0 = vals[valid].mean(axis=0)
            items.append((seeing, GL, L0, three, -1))
        else:
            for i in np.where(valid)[0]:
                seeing, GL, L0 = vals[i]
                items.append((seeing, GL, L0, three, i + 1))

    if not items:
        logger.warning("No valid values")
        return None

    # per-item compute log lines, in order (parity with the reference's
    # sequential worker logs)
    if verbose:
        for seeing, GL, L0, three, _ in items:
            logger.info("Compute PSF with seeing=%.2f GL=%.2f L0=%.2f",
                        seeing, GL, L0)
            if three:
                logger.info("Using three lasers mode")

    seeing = np.array([it[0] for it in items])
    GL = np.array([it[1] for it in items])
    L0 = np.array([it[2] for it in items])
    gs_mask = np.array([[1.0, 1.0, 1.0, 0.0 if it[3] else 1.0]
                        for it in items])
    lgs_idx = np.array([it[4] for it in items])

    # --- batched reconstruction + batched fit (device resident; only the
    # packed fit parameters and the mean PSF cross the device->host link) --
    fit_d, psf_mean, _ = process_batch(
        seeing, GL, L0, gs_mask, lbda, h=h, npsflin=npsflin, cfg=cfg,
        chunk=chunk, device=device, mesh=mesh)
    fit = unpack_fit(fit_d)

    tables = []
    for b in range(len(items)):
        t = fit_table_from_arrays(lbda, {k: v[b] for k, v in fit.items()},
                                  cfg.pixscale)
        t["SEEING"] = seeing[b]
        t["GL"] = GL[b]
        t["L0"] = L0[b]
        t["row_idx"] = b + 1
        t["lgs_idx"] = lgs_idx[b]
        tables.append(t)

    big = FitTable.vstack(tables)
    hdu = big.to_hdu(name="FIT_ROWS")
    out.append(hdu)

    # --- mean PSF over work items + refit (psfrec.py:1103-1113) -----------
    # The mean cube is tiny, so its fit is refit in float64 on the host:
    # the reference contract (1e-2 polynomial coefficients,
    # test_psfrec.py:40-41) is tighter than float32 LM noise allows
    fit_m = fit_moffat_cube_host64(psf_mean)
    res = fit_table_from_arrays(lbda, fit_m, cfg.pixscale)
    med = np.median(np.stack([seeing, GL, L0], axis=1), axis=0)
    res.meta.update({"SEEING": med[0], "GL": med[1], "L0": med[2]})
    out.append(res.to_hdu(name="FIT_MEAN"))
    out.append(ImageHDU(data=psf_mean.astype(np.float64), name="PSF_MEAN"))

    if plot:
        import matplotlib.pyplot as plt
        from .plotting import plot_psf
        plot_psf(out, npsflin=npsflin)
        plt.show()

    return out
