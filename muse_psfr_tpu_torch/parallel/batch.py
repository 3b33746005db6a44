"""Batched PSF reconstruction over SPARTA work items (PyTorch).

Counterpart of ``muse_psfr_tpu/parallel/batch.py`` for the full-window
batch night: telemetry rows (seeing, GL, L0, guide-star mask) are the
batch dimension of each chunk, and every kernel takes the chunk's rows as
a launch dimension.  The host planner validates the inputs, decides the
per-wavelength crop sizes in float64 and groups rows only by transform:
rows outside the certified split range (``L0 < dphi_split_l0_min``) take
the exact full-grid transform.  Every group runs the full OTF window (the
planner's ``force_full`` branch), where nothing is dropped, so no window
guard is collected; the support buckets, the blue split and the
window-guard redo are queued in ROADMAP.md.
"""

import numpy as np
import torch

from ..config import GalacsiConfig
from ..fit.moffat_fit import fit_moffat_cube_packed
from ..otf.convolve import convolve_final
from ..otf.psf import (dphi_base, dphi_base_split, lambda_crop_size,
                       psf_cube_from_base)
from ..psd.model import effective_wind_speed, simulate_psd, \
    simulate_psd_split
from ..utils.device import resolve_device, torch_dtype


def _window_guard(base, lbda, cfg: GalacsiConfig):
    """Margin of the OTF-support window from the windowed structure
    function ``base`` (B, ndir, rows, cols): ``0.5 * convnm_max^2 *
    min(D on the window boundary) - ln(1e9)``, nonnegative when every
    dropped OTF value is below 1e-9 of the DC.  +inf on the full window,
    where nothing is dropped."""
    win = cfg.otf_window
    if win is None or win[1] >= cfg.dim // 2:
        return torch.full((base.shape[0],), float("inf"), dtype=base.dtype,
                          device=base.device)
    edge = torch.minimum(
        torch.minimum(torch.amin(base[:, :, 0, :], dim=(1, 2)),
                      torch.amin(base[:, :, -1, :], dim=(1, 2))),
        torch.amin(base[:, :, :, 0], dim=(1, 2)))
    convnm2 = (2.0 * np.pi / torch.max(lbda)) ** 2
    return 0.5 * convnm2 * edge - float(np.log(1e9))


def reconstruct_rows(seeing, GL, L0, gs_mask, lbda, h, wind_speed,
                     npsflin: int, cfg: GalacsiConfig, npixc=None):
    """Telemetry rows -> final PSF cubes (B, nl, dimpsf, dimpsf).
    Counterpart of ``reconstruct_one``
    (which the JAX package vmaps over rows): all arguments but the static
    ``h``/``wind_speed``/``npsflin``/``cfg`` are tensors, rows first.

    With ``cfg.use_dphi_split`` the full-grid PSD is never materialised
    (valid for ``L0 >= cfg.dphi_split_l0_min``; the planner routes other
    rows to ``use_dphi_split=False``).
    """
    if cfg.use_dphi_split:
        w, delta = simulate_psd_split(seeing, GL, L0, gs_mask, h,
                                      wind_speed, npsflin, cfg)
        base = dphi_base_split(w, delta, cfg)
    else:
        psd = simulate_psd(seeing, GL, L0, gs_mask, h, wind_speed, npsflin,
                           cfg)
        base = dphi_base(psd, cfg)
    psf = psf_cube_from_base(base, lbda, cfg, npixc=npixc)
    return convolve_final(psf, lbda, seeing, GL, L0, cfg)


def _fit_chunk(t, n_valid, lbda, npixc, h, wind_speed, npsflin, cfg,
               fit_dtype):
    """One chunk: reconstruction + packed Moffat fit + pad-masked PSF sum.
    ``t``: (chunk, 7) telemetry [seeing, GL, L0, gs_mask(4)] on the
    device; the first ``n_valid`` rows are real."""
    psf = reconstruct_rows(t[:, 0], t[:, 1], t[:, 2], t[:, 3:7],
                                  lbda, h, wind_speed, npsflin, cfg,
                                  npixc=npixc)
    fit = fit_moffat_cube_packed(psf, dtype=fit_dtype)
    psum = torch.sum(psf[:n_valid], dim=0)
    return fit, psum


def _plan_batch(seeing, GL, L0, gs_mask, lbda, h, cfg, chunk):
    """Host planning: validate, decide the crop sizes in float64, group
    rows by transform (full window), and build the telemetry table.

    Returns ``(cfg, groups, chunk, table, lbda, h, wind_speed, npixc)``
    with ``groups`` a list of ``(group_cfg, row_indices)``.
    """
    cfg = cfg or GalacsiConfig()
    wind_speed = effective_wind_speed(h, cfg)
    lb_np = np.atleast_1d(np.asarray(lbda, dtype=np.float64))
    if lb_np.size == 0:
        raise ValueError("empty wavelength array")
    npixc = lambda_crop_size(lb_np, cfg)
    if int(npixc.max()) > cfg.dim:
        raise ValueError(
            f"wavelength {lb_np.min():.1f} nm needs a {int(npixc.max())} px "
            f"crop, larger than the {cfg.dim}^2 PSD grid; raise cfg.dim or "
            f"the minimum wavelength")
    h_t = tuple(float(x) for x in np.asarray(h, dtype=np.float64).ravel())
    seeing = np.atleast_1d(np.asarray(seeing, dtype=np.float64))
    GL = np.atleast_1d(np.asarray(GL, dtype=np.float64))
    L0 = np.atleast_1d(np.asarray(L0, dtype=np.float64))
    gs_mask = np.atleast_2d(np.asarray(gs_mask, dtype=np.float64))
    B = seeing.shape[0]
    if B == 0:
        raise ValueError("empty batch: no telemetry rows to reconstruct "
                         "(seeing/GL/L0 arrays have length 0)")
    if not (GL.shape == L0.shape == (B,) and gs_mask.shape == (B, 4)):
        raise ValueError(
            f"telemetry shapes disagree: seeing {seeing.shape}, GL "
            f"{GL.shape}, L0 {L0.shape}, gs_mask {gs_mask.shape}")

    # the full window for every group (the planner's force_full branch)
    g0 = cfg.with_(otf_support=0, otf_blue=None)
    split_bad = np.zeros(B, bool)
    if cfg.use_dphi_split:
        split_bad = ~(np.isfinite(L0) & (L0 >= cfg.dphi_split_l0_min))
    groups = []
    if (~split_bad).any():
        groups.append((g0, np.nonzero(~split_bad)[0]))
    if split_bad.any():
        groups.append((g0.with_(use_dphi_split=False),
                       np.nonzero(split_bad)[0]))
    table = np.concatenate(
        [seeing[:, None], GL[:, None], L0[:, None], gs_mask], axis=1)
    return (cfg, groups, max(1, min(int(chunk), B)), table, lb_np, h_t,
            wind_speed, npixc)


def _check_device_dtype(cfg: GalacsiConfig, dev: torch.device):
    if (dev.type == "cuda" and cfg.dtype != "float32"
            and (cfg.use_fused_zoom
                 or (cfg.use_fused_conv and not cfg.use_fft))):
        raise ValueError(
            f"the fused CUDA kernels run float32 only, and cfg.dtype is "
            f"{cfg.dtype!r}; set use_fused_zoom=False and "
            "use_fused_conv=False for a float64 run on CUDA, or run on "
            "device='cpu'")


def _chunks(seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg, chunk, dev):
    """Plan the batch and place it on ``dev``.  Returns ``(static, it)``:
    ``static = (lbda, npixc, h, wind_speed)`` (the first two as device
    tensors) and an iterator of ``(group_cfg, rows, t)`` per chunk, ``t``
    the (chunk, 7) device telemetry padded with repeats of the group's
    last row, ``rows`` the input indices of its real rows."""
    (cfg, groups, chunk, table, lb_np, h_t, wind_speed,
     npixc) = _plan_batch(seeing, GL, L0, gs_mask, lbda, h, cfg, chunk)
    _check_device_dtype(cfg, dev)
    dtype = torch_dtype(cfg.dtype)
    static = (torch.as_tensor(lb_np, dtype=dtype, device=dev),
              torch.as_tensor(npixc, dtype=torch.int64, device=dev),
              h_t, wind_speed)

    def it():
        for gcfg, gidx in groups:
            gt = table[gidx]
            n_pad = (-gt.shape[0]) % chunk
            if n_pad:
                gt = np.concatenate([gt, np.repeat(gt[-1:], n_pad, axis=0)])
            table_d = torch.as_tensor(gt, dtype=dtype, device=dev)
            for lo in range(0, gidx.shape[0], chunk):
                yield gcfg, gidx[lo:lo + chunk], table_d[lo:lo + chunk]
    return static, it()


def reconstruct_batch(seeing, GL, L0, gs_mask, lbda, h=(100, 10000),
                      npsflin: int = 1, cfg: GalacsiConfig = None,
                      chunk: int = 8, device="cuda"):
    """Reconstruct PSF cubes for a batch of work items: (B,)-shaped
    telemetry (``gs_mask`` (B, 4)) -> (B, nl, dimpsf, dimpsf) numpy."""
    dev = resolve_device(device)
    (lbda_d, npixc_d, h_t, wind_speed), chunks = _chunks(
        seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg, chunk, dev)
    idxs, cubes = [], []
    for gcfg, rows, t in chunks:
        psf = reconstruct_rows(t[:, 0], t[:, 1], t[:, 2], t[:, 3:7],
                                      lbda_d, h_t, wind_speed, npsflin, gcfg,
                                      npixc=npixc_d)
        idxs.append(rows)
        cubes.append(psf[:len(rows)])
    out = torch.cat(cubes).cpu().numpy()
    return out[np.argsort(np.concatenate(idxs))]


def process_batch(seeing, GL, L0, gs_mask, lbda, h=(100, 10000),
                  npsflin: int = 1, cfg: GalacsiConfig = None,
                  chunk: int = 8, fit_dtype: str = None, device="cuda"):
    """Full batch: reconstruct, Moffat-fit and average on the device.

    Returns numpy ``(fit_packed, psf_mean, fit_mean_packed)``: per-row
    per-wavelength packed Moffat parameters (B, nl, N_PACKED) in input
    order (see ``fit.moffat_fit.PACKED_FIELDS``), the (nl, dimpsf, dimpsf)
    mean PSF over the rows (padding rows masked out) and its packed fit.
    The PSF cubes never leave the device.
    """
    dev = resolve_device(device)
    cfg = cfg or GalacsiConfig()
    fit_dtype = fit_dtype or cfg.fit_dtype
    (lbda_d, npixc_d, h_t, wind_speed), chunks = _chunks(
        seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg, chunk, dev)
    idxs, fits, psums = [], [], []
    for gcfg, rows, t in chunks:
        fit, psum = _fit_chunk(t, len(rows), lbda_d, npixc_d, h_t,
                               wind_speed, npsflin, gcfg, fit_dtype)
        idxs.append(rows)
        fits.append(fit[:len(rows)])
        psums.append(psum)
    order = np.concatenate(idxs)
    psf_mean = torch.sum(torch.stack(psums), dim=0) / order.size
    fit_mean = fit_moffat_cube_packed(psf_mean, dtype=fit_dtype)
    fit_np = torch.cat(fits).cpu().numpy()[np.argsort(order)]
    return fit_np, psf_mean.cpu().numpy(), fit_mean.cpu().numpy()
