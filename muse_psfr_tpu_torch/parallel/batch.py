"""Batched PSF reconstruction over SPARTA work items (PyTorch).

Counterpart of ``muse_psfr_tpu/parallel/batch.py``: telemetry rows
(seeing, GL, L0, guide-star mask) are the batch dimension of each chunk,
and every kernel takes the chunk's rows as a launch dimension.

The host planner (:func:`plan_batch`, numpy float64 and the CPU only, as
in the JAX package) validates the inputs, decides the per-wavelength crop
sizes, and groups rows:

* rows outside the certified split range (``L0 < dphi_split_l0_min``)
  take the exact full-grid transform;
* the others go to a reduced OTF-support window (``otf_support =
  default_support_bucket``) when the host admission model
  (:func:`rows_windowable`) certifies that their damped OTF is below
  1e-12 of the DC outside it, and to the full window otherwise;
* ``zoom_anchor="auto"`` is resolved per group (``otf/psf.py:
  resolve_zoom_anchor``) for the night's target device;
* within each group that is not anchored the bluest wavelengths may run on
  a smaller centred sub-window (``otf_blue``, :func:`_blue_split_plan`), in
  up to two tiers at ndir >= 9.

Every chunk of a reduced window returns its window guard (the margin of
the structure function on the window boundaries); after the night, the
rows of the chunks whose guard is negative are recomputed with the full
window and the mean PSF is corrected on the device (the surgical redo).
A pinned ``otf_support`` or ``otf_blue`` is kept as given, guarded and
redone the same way.

With ``mesh=`` (``parallel/mesh.py``) each chunk's rows are split over the
mesh's devices: shard ``i`` runs :func:`_fit_chunk` on its slice, on its
device, and the shards' results are gathered so that every process holds
the whole chunk (:func:`_replicate_for_host`).  Chunks are then multiples
of the mesh size and no group takes a tail chunk, as in the JAX package.

Each chunk step (:func:`_fit_chunk`, :func:`_reconstruct_chunk`) and the
mean refit run as programs (``parallel/programs.py``): on the card a
program is captured as a CUDA graph at its second dispatch and replayed
from then on, as the JAX package dispatches one compiled program per
chunk; on the CPU they run eagerly.  A step takes tensors only (``n_valid``
a 0-d int64 tensor on the device) and makes no host copy and no host
sync, so that it can be captured.
"""

import dataclasses
from contextlib import contextmanager
from functools import lru_cache, partial, reduce
from itertools import combinations

import numpy as np
import torch
import torch.distributed as dist

from ..config import GalacsiConfig
from ..fit.moffat_fit import fit_moffat_cube_packed
from ..otf.convolve import convolve_final
from ..otf.psf import (_centered_idft_np, dphi_base, dphi_base_split,
                       fitting_dphi_ring_envelopes, lambda_crop_size,
                       psf_cube_from_base, resolve_zoom_anchor)
from ..core.vonkarman import CST_VK_EXACT, fitting_expansion_spec
from ..psd.model import (effective_wind_speed, seeing_to_r0, simulate_psd,
                         simulate_psd_split)
from ..utils import profiling
from ..utils.device import resolve_device, torch_dtype
from ..utils.log import get_logger
from . import programs
from .mesh import rows_sharding

logger = get_logger("batch")


def _window_guard(base, lbda, cfg: GalacsiConfig):
    """Per-row margin of the OTF-support window from the windowed
    structure function ``base`` (B, ndir, rows, cols): ``0.5 * convnm_max^2
    * min(D on the window boundary) - ln(1e9)``, nonnegative when every
    dropped OTF value is below 1e-9 of the DC.  +inf on the full window,
    where nothing is dropped.

    With ``cfg.otf_blue = (nb, S_blue)`` it also checks the sub-window's
    boundary at ``max(lbda[:nb])``: its top and bottom rows and its left
    column (columns past ``c+128`` come through the symmetry fold, whose
    mirror lies inside the computed block)."""
    win = cfg.otf_window
    g = torch.full((base.shape[0],), float("inf"), dtype=base.dtype,
                   device=base.device)
    ln1e9 = float(np.log(1e9))

    def edge_min(top, bottom, left):
        return torch.minimum(torch.minimum(
            torch.amin(top, dim=(1, 2)), torch.amin(bottom, dim=(1, 2))),
            torch.amin(left, dim=(1, 2)))

    if win is not None and cfg.otf_blue is not None:
        nb, Sb = int(cfg.otf_blue[0]), int(cfg.otf_blue[1])
        S = win[1]
        lo, hi = S - Sb, S + Sb
        d_edge_b = edge_min(base[:, :, lo, lo:], base[:, :, hi - 1, lo:],
                            base[:, :, lo:hi, lo])
        convnm2_b = (2.0 * np.pi / torch.max(lbda[:nb])) ** 2
        g = 0.5 * convnm2_b * d_edge_b - ln1e9
    if win is None or win[1] >= cfg.dim // 2:
        return g
    d_edge = edge_min(base[:, :, 0, :], base[:, :, -1, :], base[:, :, :, 0])
    convnm2 = (2.0 * np.pi / torch.max(lbda)) ** 2
    return torch.minimum(g, 0.5 * convnm2 * d_edge - ln1e9)


def reconstruct_rows(seeing, GL, L0, gs_mask, lbda, h, wind_speed,
                     npsflin: int, cfg: GalacsiConfig, npixc=None):
    """Telemetry rows -> final PSF cubes (B, nl, dimpsf, dimpsf) and the
    per-row window guard (:func:`_window_guard`).  Counterpart of
    ``reconstruct_one(..., return_guard=True)`` (which the JAX package
    vmaps over rows): all arguments but the static ``h``/``wind_speed``/
    ``npsflin``/``cfg`` are tensors, rows first.

    With ``cfg.use_dphi_split`` the full-grid PSD is never materialised
    (valid for ``L0 >= cfg.dphi_split_l0_min``; the planner routes other
    rows to ``use_dphi_split=False``).

    On a card each stage starts with its marker
    (``utils/profiling.py:stage``): ``psd``, ``otf`` (the structure
    function, its window guard and the PSF cube), ``conv``.
    """
    dev = seeing.device
    profiling.stage("psd", dev)
    if cfg.use_dphi_split:
        w, delta = simulate_psd_split(seeing, GL, L0, gs_mask, h,
                                      wind_speed, npsflin, cfg)
        profiling.stage("otf", dev)
        base = dphi_base_split(w, delta, cfg)
    else:
        psd = simulate_psd(seeing, GL, L0, gs_mask, h, wind_speed, npsflin,
                           cfg)
        profiling.stage("otf", dev)
        base = dphi_base(psd, cfg)
    guard = _window_guard(base, lbda, cfg)
    psf = psf_cube_from_base(base, lbda, cfg, npixc=npixc)
    profiling.stage("conv", dev)
    return convolve_final(psf, lbda, seeing, GL, L0, cfg), guard


def _reconstruct_chunk(t, lbda, npixc, h, wind_speed, npsflin, cfg):
    """One chunk's PSF cubes and its window guard (minimum over its
    rows), the JAX package's function of the same name.  ``t``: (chunk,
    7) telemetry [seeing, GL, L0, gs_mask(4)] on the device."""
    psf, guard = reconstruct_rows(t[:, 0], t[:, 1], t[:, 2], t[:, 3:7],
                                  lbda, h, wind_speed, npsflin, cfg,
                                  npixc=npixc)
    profiling.stage("reduce", t.device)
    out = psf, torch.min(guard)
    profiling.stage("end", t.device)
    return out


def _fit_chunk(t, n_valid, lbda, npixc, h, wind_speed, npsflin, cfg,
               fit_dtype):
    """One chunk: reconstruction + packed Moffat fit + pad-masked PSF sum
    + the chunk's window guard (minimum over its rows), the JAX package's
    function of the same name.  ``t``: (chunk, 7) telemetry on the
    device; ``n_valid``: 0-d int64 tensor, the number of real rows first
    in ``t``.  The sum is the masked contraction of the JAX package, so
    that no row count is a Python value of the step.  The stages after
    :func:`reconstruct_rows`'s start with the markers ``fit`` and
    ``reduce``; ``end`` closes the step."""
    psf, guard = reconstruct_rows(t[:, 0], t[:, 1], t[:, 2], t[:, 3:7],
                                  lbda, h, wind_speed, npsflin, cfg,
                                  npixc=npixc)
    profiling.stage("fit", t.device)
    fit = fit_moffat_cube_packed(psf, dtype=fit_dtype)
    profiling.stage("reduce", t.device)
    w = (torch.arange(t.shape[0], device=t.device) < n_valid).to(psf.dtype)
    out = fit, torch.tensordot(w, psf, dims=1), torch.min(guard)
    profiling.stage("end", t.device)
    return out


def _program_key(kind, plan, gcfg, size, fit_dtype=None):
    """The JAX package's key of a chunk executable (``_warm_programs``)."""
    return (kind, gcfg, size, plan.lbda.size, gcfg.dtype, plan.h,
            plan.wind_speed, plan.npsflin, fit_dtype)


def _fit_mean(psf_mean, fit_dtype, graphs):
    """The packed fit of the mean PSF as the program "mean" (stage markers
    ``fit`` and ``end``)."""
    def step(x):
        profiling.stage("fit", x.device)
        fit = fit_moffat_cube_packed(x, dtype=fit_dtype)
        profiling.stage("end", x.device)
        return (fit,)

    key = ("mean", tuple(psf_mean.shape), str(psf_mean.dtype), fit_dtype)
    return programs.run(key, step, (psf_mean,), graphs)[0]


# ---- host planning ------------------------------------------------------

#: the planner's CPU tensor work (the split PSD of its admission model,
#: broadcasts and two-layer sums over (rows, 2, ndir, dimall, dimall)
#: blocks) runs on one intra-op thread up to this many elements of
#: (rows, ndir, dimall, dimall): a pool slows it there.  Above, a pool of
#: PLAN_THREADS gains (H100 host, 8 cores: ~40% at 1000 rows)
PLAN_SERIAL_ELEMS = 2 ** 21
PLAN_THREADS = 4
#: the admission model evaluates its rows padded to a multiple of this.
#: Torch's vectorised CPU kernels run the last elements of a loop in a
#: scalar tail, whose pow/exp round differently from the vector body (32
#: float32 lanes a step with AVX-512), and a pool of up to PLAN_THREADS
#: threads splits each (rows, ...) loop into equal parts of whole rows; so
#: no row lands in a tail, and a row's samples are the same bits whichever
#: rows and budget it runs with
ROW_QUANTUM = 32


def _plan_threads_for(n_elems):
    """The planner's intra-op threads for an evaluation of ``n_elems``
    elements: 1 up to :data:`PLAN_SERIAL_ELEMS`, else
    :data:`PLAN_THREADS`, never more than the caller's count (rounded down
    to a power of two, see :data:`ROW_QUANTUM`)."""
    if n_elems <= PLAN_SERIAL_ELEMS:
        return 1
    cap = 1 << (torch.get_num_threads().bit_length() - 1)
    return min(PLAN_THREADS, cap)


@contextmanager
def _plan_threads(n_elems):
    """Run the body at :func:`_plan_threads_for` intra-op threads, and give
    the caller back its own count after, also when the body raises."""
    threads = torch.get_num_threads()
    budget = _plan_threads_for(n_elems)
    if threads == budget:
        yield
        return
    torch.set_num_threads(budget)
    try:
        yield
    finally:
        torch.set_num_threads(threads)


def _split_on_cpu(seeing, GL, L0, gs_mask, h, wind_speed, npsflin, cfg):
    """(w, delta) of the split PSD for every row, computed on CPU tensors
    in ``cfg.dtype`` (as the JAX package computes them on its CPU backend)
    and returned as float64 numpy."""
    dt = torch_dtype(cfg.dtype)
    t = [torch.as_tensor(np.asarray(a), dtype=dt)
         for a in (seeing, GL, L0, gs_mask)]
    with torch.no_grad():
        w, delta = simulate_psd_split(*t, h, float(wind_speed), npsflin, cfg)
    return w.double().numpy(), delta.double().numpy()


def default_support_bucket(cfg: GalacsiConfig) -> int:
    """The one reduced OTF-support bucket of the batch layer: roughly
    dim/4, 128-aligned (dim=1280 -> 256, dim=2048 -> 512)."""
    return max(128, (cfg.dim // 4) // 128 * 128)


class _Admission:
    """The admission model of one batch's telemetry, each row evaluated
    once (:func:`_ring_damping`) when a probe first asks for it, and every
    probe answered from those samples by indexing.  The samples are kept
    per model: the config without its window fields (``otf_support``,
    ``otf_blue``), as the planner's probed groups differ from its base
    config only there."""

    def __init__(self, seeing, GL, L0, gs_mask, h_t, wind_speed, npsflin):
        self.tel = (seeing, GL, L0, gs_mask)
        self.model = (h_t, wind_speed, npsflin)
        self.tables = {}

    def windowable(self, rows, lbda_max_nm, cfg, S, thresh=1e-12):
        """:func:`rows_windowable` for the batch's rows ``rows``."""
        out = np.zeros(rows.shape[0], bool)
        if cfg.otf_window is None or S >= cfg.dim // 2 or S % 128 != 0:
            return out
        key = cfg.with_(otf_support=0, otf_blue=None)
        B = self.tel[0].shape[0]
        t = self.tables.setdefault(key, {"done": np.zeros(B, bool),
                                         "ok": np.zeros(B, bool),
                                         "d_tot": None, "r_of_pt": None})
        new = np.unique(rows[~t["done"][rows]])
        if new.size:
            idx, d_tot, r_of_pt = _ring_damping(
                *(a[new] for a in self.tel), key, *self.model)
            if idx.size:
                if t["d_tot"] is None:
                    t["d_tot"] = np.empty((B,) + d_tot.shape[1:])
                    t["r_of_pt"] = r_of_pt
                t["d_tot"][new[idx]] = d_tot
            t["ok"][new[idx]] = True
            t["done"][new] = True
        ok = t["ok"][rows]
        if ok.any():
            convnm2 = (2.0 * np.pi / float(lbda_max_nm)) ** 2
            sel = t["r_of_pt"] >= S - 1
            out[ok] = np.all(0.5 * convnm2 * t["d_tot"][rows[ok]][:, :, sel]
                             >= -np.log(thresh), axis=(1, 2))
        return out


_WINDOWABLE_MEMO = {}


def rows_windowable(seeing, GL, L0, gs_mask, lbda_max_nm, cfg, S,
                    h=(100, 10000), wind_speed=None, npsflin=1,
                    thresh: float = 1e-12):
    """Per-row host-side test: is ``otf_support=S`` safe for each row?

    The normalised system OTF is ``exp(-0.5 convnm^2 D) * dl/dl_max`` with
    ``D = D_fit + D_corr``: ``D_fit = sum_k w_k T_k`` lower-bounded per
    inf-norm ring by the basis envelopes, ``D_corr`` from the
    correction-zone block of the split PSD, both sampled along the 8
    inf-norm-ring extreme rays at 32-px steps from ``S-1`` outward
    (:func:`_ring_damping`).  A row is windowable when the sampled damping
    stays below ``thresh`` everywhere beyond the window; the window guard
    backstops the sampling at run time, three decades above ``thresh``.

    Rows outside the certified split range or with non-finite telemetry
    are not windowable.  Results are memoised on the telemetry content.
    The planner answers its own probes from one evaluation of the night
    (:class:`_Admission`); a row's answer is the same either way.
    """
    seeing = np.atleast_1d(np.asarray(seeing, np.float64))
    GL = np.atleast_1d(np.asarray(GL, np.float64))
    L0 = np.atleast_1d(np.asarray(L0, np.float64))
    gs_mask = np.atleast_2d(np.asarray(gs_mask, np.float64))
    if wind_speed is None:
        wind_speed = effective_wind_speed(h, cfg)
    h_t = tuple(float(x) for x in np.asarray(h, np.float64).ravel())
    key = (seeing.tobytes(), GL.tobytes(), L0.tobytes(), gs_mask.tobytes(),
           float(lbda_max_nm), S, h_t, float(wind_speed), npsflin, cfg,
           thresh)
    if key in _WINDOWABLE_MEMO:
        return _WINDOWABLE_MEMO[key]
    out = _Admission(seeing, GL, L0, gs_mask, h_t, float(wind_speed),
                     npsflin).windowable(np.arange(seeing.shape[0]),
                                         lbda_max_nm, cfg, S, thresh)
    if len(_WINDOWABLE_MEMO) > 64:
        _WINDOWABLE_MEMO.clear()
    _WINDOWABLE_MEMO[key] = out
    return out


@lru_cache(maxsize=8)
def _ray_geometry(dim, lo, s):
    """The admission rays' constants for a (dim, dim) grid whose split
    block is columns ``lo:lo+s``: the sampled radii, 32 px apart from 127
    (the smallest window's boundary) to the grid edge; each sample's index
    into them; and the centred inverse DFT (``otf/psf.py:
    _centered_idft_np``) at the samples: ``[C | S]`` over the samples'
    unique columns (s, 2 nq) with each sample's column among them, and
    ``C``, ``S`` at the samples' rows (npts, s)."""
    c = dim // 2
    cb, sb = _centered_idft_np(dim, cols=(lo, s))        # (dim, s) f64
    radii = np.arange(127, c, 32)
    if radii[-1] != c - 1:
        radii = np.append(radii, c - 1)
    pts = []
    for r in radii:
        r = int(r)
        pts += [(r, 0), (-r, 0), (0, r), (0, -r),
                (r, r), (-r, -r), (r, -r), (-r, r)]
    rows_p = np.array([c + dy for dy, _ in pts])
    cols_q = np.array([c + dx for _, dx in pts])
    uq, qinv = np.unique(cols_q, return_inverse=True)
    out = (radii, np.repeat(np.arange(radii.size), 8), qinv,
           np.concatenate([cb[uq].T, sb[uq].T], axis=1), cb[rows_p],
           sb[rows_p])
    for arr in out:
        arr.setflags(write=False)
    return out


def _ring_damping(seeing, GL, L0, gs_mask, cfg, h_t, wind_speed, npsflin):
    """Host-side structure-function samples on the admission rays.

    Returns ``(idx, d_tot, r_of_pt)``: the valid-row indices, their
    (R, ndir, npts) structure-function values on the 8 inf-norm-ring
    extreme rays at 32-px radius steps from 127 (the smallest window's
    boundary) to the grid edge, and each point's radius.  Independent of
    the wavelength and the window, so one evaluation serves every (lambda,
    S) probe of a planning pass (:class:`_Admission`).

    A row's samples are the same bits whichever rows it comes with: the
    split PSD runs on the rows padded to a multiple of :data:`ROW_QUANTUM`,
    on the planner's own threads (:func:`_plan_threads_for`), and each
    row's contraction is its own GEMM.  Counter ``plan_psd_rows`` counts
    the rows evaluated.
    """
    ok = (np.isfinite(seeing) & (seeing > 0) & np.isfinite(L0)
          & (L0 >= cfg.dphi_split_l0_min) & np.isfinite(GL)
          & np.all(np.isfinite(gs_mask), axis=1))
    idx = np.nonzero(ok)[0]
    if idx.size == 0:
        return idx, np.zeros((0, 1, 0)), np.zeros(0, int)
    n = idx.size
    profiling.count("plan_psd_rows", n)
    pad = np.concatenate([idx, np.full(-n % ROW_QUANTUM, idx[-1])])
    dim, s = cfg.dim, cfg.dimall
    with _plan_threads(pad.size * npsflin ** 2 * s * s):
        # r0 in cfg.dtype, as the split model computes it
        r0 = seeing_to_r0(torch.as_tensor(seeing[pad],
                                          dtype=torch_dtype(cfg.dtype)),
                          cfg.lambda_ref).double().numpy()[:n]
        _, delta = _split_on_cpu(seeing[pad], GL[pad], L0[pad],
                                 gs_mask[pad], h_t, wind_speed, npsflin, cfg)
    radii, ring, qinv, csq, cbp, sbp = _ray_geometry(
        dim, dim // 2 - cfg.dim_pup, s)

    # fit part: per-row ring lower bound of sum_k w_k T_k (exact), at the
    # sampled radii
    tmin, tmax = fitting_dphi_ring_envelopes(cfg)        # (K+1, c+1)
    tmin, tmax = tmin[:, radii], tmax[:, radii]
    u0, binoms = fitting_expansion_spec(cfg.dphi_split_l0_min,
                                        cfg.dphi_split_degree)
    nm2 = (cfg.lambda_ref * 1000.0 / (2 * np.pi)) ** 2
    l0_v = L0[idx]
    du = 1.0 / (l0_v * l0_v) - u0
    w = (nm2 * CST_VK_EXACT * r0[:, None] ** (-5.0 / 3.0) * binoms[None]
         * du[:, None] ** np.arange(len(binoms))[None])  # (R, K+1)
    d_fit = (np.where(w[:, :, None] >= 0, w[:, :, None] * tmin[None],
                      w[:, :, None] * tmax[None])).sum(axis=1)  # (R, nr)

    # correction part: the zone model, sampled on the 8 ring-extreme rays,
    # ROW_QUANTUM rows at a time.  The GEMM is stacked, one (ndir*s, s) @
    # (s, 2 nq) a row: BLAS picks its kernels and threads by the shape, so
    # one GEMM over several rows could round a row with the rows around it
    L = cfg.dpup * (dim / cfg.npup)
    scale = dim * dim / (L * L)
    nd, nq = delta.shape[1], csq.shape[1] // 2
    d_tot = np.empty((n, nd, ring.size))
    for lo in range(0, n, ROW_QUANTUM):
        dl = delta[lo:lo + ROW_QUANTUM]
        y = (dl.reshape(-1, nd * s, s) @ csq).reshape(-1, nd, s, 2 * nq)
        re = (np.einsum("ps,rdsp->rdp", cbp, y[..., qinv])
              - np.einsum("ps,rdsp->rdp", sbp, y[..., nq + qinv]))
        bg00 = dl.sum(axis=(-2, -1)) / (L * L)           # (r, ndir)
        d_corr = 2.0 * (bg00[..., None] - re * scale)    # (r, ndir, npts)
        hi = min(lo + ROW_QUANTUM, n)
        d_tot[lo:hi] = (d_fit[lo:hi, ring][:, None, :]
                        + d_corr[:hi - lo])
    return idx, d_tot, radii[ring]


def estimate_otf_support(seeing, GL, L0, gs_mask, lbda_max_nm, cfg,
                         h=(100, 10000), wind_speed=None, npsflin=1,
                         thresh: float = 1e-12) -> int:
    """Smallest 128-aligned ``otf_support`` safe for every given row
    (:func:`rows_windowable`), or 0 when only the full window is; for
    pinning one window explicitly.  The rows are evaluated once for every
    window probed."""
    seeing = np.atleast_1d(np.asarray(seeing, np.float64))
    GL = np.atleast_1d(np.asarray(GL, np.float64))
    L0 = np.atleast_1d(np.asarray(L0, np.float64))
    gs_mask = np.atleast_2d(np.asarray(gs_mask, np.float64))
    cfg_probe = cfg if cfg.otf_support == 0 else cfg.with_(otf_support=0)
    if wind_speed is None:
        wind_speed = effective_wind_speed(h, cfg)
    h_t = tuple(float(x) for x in np.asarray(h, np.float64).ravel())
    rows = np.arange(seeing.shape[0])
    adm = _Admission(seeing, GL, L0, gs_mask, h_t, float(wind_speed),
                     npsflin)
    for S in range(128, cfg.dim // 2, 128):
        if adm.windowable(rows, lbda_max_nm, cfg_probe, S, thresh).all():
            return S
    return 0


def _blue_tiers(cfg, ndir: int = 1) -> int:
    """Max blue tiers per group from ``cfg.blue_tiers``: 0 is auto (2 at
    ``ndir >= 9``, else 1); clamped to [1, 4] to bound the ladder
    enumeration."""
    raw = int(cfg.blue_tiers)
    if raw == 0:
        return 2 if ndir >= 9 else 1
    return min(4, max(1, raw))


def _blue_split_plan(groups, seeing, GL, L0, gs_mask, lb_np, h_t,
                     wind_speed, npsflin, chunk_c, adm=None):
    """Per-group blue-segment window planning (``cfg.otf_blue``).

    The damping exponent scales as ``(2pi/lambda)^2``, so the bluest
    wavelengths admit much smaller OTF windows than the band maximum that
    sized each group's bucket.  For every windowed or full group this
    probes :func:`rows_windowable` at the half-bucket window ``S_blue``
    for the segment lengths ``nb in {lambda_chunk, 2*lambda_chunk, ...}``
    and either annotates the whole group with the largest ``nb`` every row
    admits, or splits it into a ladder of up to :func:`_blue_tiers`
    blue subgroups (descending ``nb``, each rounded down to the dispatch
    quantum) plus the remainder, when that saves more exp area by a 4/3
    factor per extra subgroup and the subgroups cover at least a quarter
    of the group.  Requires an ascending wavelength grid; groups already
    annotated, anchored, or outside the split-certified range are left
    alone.  The probes read ``adm``, the caller's :class:`_Admission` of
    the batch (a new one when None), so each row is evaluated once.
    """
    if adm is None:
        adm = _Admission(seeing, GL, L0, gs_mask, h_t, wind_speed, npsflin)
    nl = lb_np.size
    if nl < 2 or np.any(np.diff(lb_np) < 0):
        return groups
    out = []
    for gcfg, gidx in groups:
        win = gcfg.otf_window
        if (win is None or not gcfg.use_dphi_split
                or gcfg.zoom_anchor == "on" or gcfg.otf_blue is not None
                or gidx.size == 0):
            out.append((gcfg, gidx))
            continue
        S = win[1]
        Sb = ((S // 2) // 128) * 128
        kl = max(1, int(gcfg.lambda_chunk))
        if Sb < 128 or Sb >= S or nl <= kl:
            out.append((gcfg, gidx))
            continue
        probe = gcfg if gcfg.otf_support == 0 else gcfg.with_(otf_support=0)
        n_rows = gidx.size
        quantum = (chunk_c if gcfg.otf_support == 0
                   else max(1, chunk_c // 4))
        # admission counts over the nb menu (monotone decreasing in nb;
        # every probe reads the night's one evaluation of each row)
        cnts, adms = {}, {}
        for nb in range(kl, nl, kl):
            ok = adm.windowable(gidx, float(lb_np[nb - 1]), probe, Sb)
            cnt = int(ok.sum())
            if cnt == 0:
                break
            cnts[nb], adms[nb] = cnt, ok
        if not cnts:
            out.append((gcfg, gidx))
            continue
        full_nb = max((nb for nb, c in cnts.items() if c == n_rows),
                      default=0)
        tiers = _blue_tiers(gcfg, npsflin * npsflin)
        nbs_asc = sorted(cnts)
        # bound C(menu, tiers): thin a long menu to <= 16 evenly spaced
        # entries, keeping full_nb and the largest nb
        if len(nbs_asc) > 16:
            idx = np.unique(np.round(
                np.linspace(0, len(nbs_asc) - 1, 16)).astype(int))
            keep_set = {nbs_asc[i] for i in idx}
            if full_nb:
                keep_set.add(full_nb)
            nbs_asc = sorted(keep_set)
        whole = ((float(full_nb * n_rows), full_nb * n_rows,
                  [(full_nb, n_rows)], 0) if full_nb else None)
        best = whole   # (value, score, ladder=[(nb, keep)], extra)
        for t in range(1, max(1, tiers) + 1):
            # ascending enumeration keeps the smallest-nb tie-break; each
            # ladder runs bluest (largest nb) tier first
            for asc in combinations(nbs_asc, t):
                taken, keeps = 0, []
                for nb in asc[::-1]:
                    avail = cnts[nb] - taken
                    # a tier that admits the whole group absorbs every
                    # remaining row (no plain remainder, no rounding)
                    keep = (n_rows - taken if cnts[nb] == n_rows
                            else (avail // quantum) * quantum)
                    if keep <= 0:
                        break
                    keeps.append((nb, keep))
                    taken += keep
                if len(keeps) < t:
                    continue    # a shorter ladder, already enumerated
                extra = len(keeps) - (1 if taken == n_rows else 0)
                score = sum(nb * k for nb, k in keeps)
                value = score * 0.75 ** extra
                if best is None or value > best[0]:
                    best = (value, score, keeps, extra)
        # the minimum-size guard applies to the selected candidate: a
        # failing argmax falls back to the whole-group annotation or none
        if best is not None and \
                sum(k for _, k in best[2]) < max(1, n_rows // 4):
            best = whole
        if best is None:
            out.append((gcfg, gidx))
            continue
        keeps = best[2]
        if len(keeps) == 1 and keeps[0][1] == n_rows:
            out.append((gcfg.with_(otf_blue=(keeps[0][0], Sb)), gidx))
            continue
        taken_rows = np.zeros(n_rows, bool)
        for nb, keep in keeps:
            sel = np.nonzero(adms[nb] & ~taken_rows)[0][:keep]
            tier_rows = np.zeros(n_rows, bool)
            tier_rows[sel] = True
            taken_rows |= tier_rows
            out.append((gcfg.with_(otf_blue=(nb, Sb)), gidx[tier_rows]))
        if not taken_rows.all():
            out.append((gcfg, gidx[~taken_rows]))
    return out


def clamped_chunk(chunk: int, B: int, mesh=None) -> int:
    """The chunk size the batch layer dispatches: clamped to the batch, at
    least the mesh size, rounded up to a multiple of it."""
    n_dev = 1 if mesh is None else mesh.size
    c = max(min(int(chunk), B), n_dev)
    return -(-c // n_dev) * n_dev


def _plan_batch(seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg, chunk,
                force_full=False, device="cuda", mesh=None):
    """Host planning: validate, decide the crop sizes in float64, bucket
    rows by OTF support, resolve the anchored-Taylor damping per group,
    split off blue sub-windows, and build the telemetry table.

    Returns ``(cfg, groups, chunk, table, lbda, h, wind_speed, npixc)``
    with ``groups`` a list of ``(group_cfg, row_indices)``.  A pinned
    ``otf_support``/``otf_blue`` is kept; ``force_full`` (the guard redo)
    runs every row on the full window at the caller's chunk.  ``device``
    is the night's target, which only ``zoom_anchor="auto"`` reads;
    ``mesh`` rounds the chunk to a multiple of its size.
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

    # the admission model: one evaluation per row, read by every probe
    adm = _Admission(seeing, GL, L0, gs_mask, h_t, wind_speed, npsflin)
    split_bad = np.zeros(B, bool)
    if cfg.use_dphi_split:
        split_bad = ~(np.isfinite(L0) & (L0 >= cfg.dphi_split_l0_min))
    if force_full:
        # the guard redo: the full window, any blue split cleared (the
        # guard may have tripped on the sub-window boundary)
        g0 = cfg.with_(otf_support=0, otf_blue=None)
        groups = []
        if (~split_bad).any():
            groups.append((g0, np.nonzero(~split_bad)[0]))
        if split_bad.any():
            groups.append((g0.with_(use_dphi_split=False),
                           np.nonzero(split_bad)[0]))
    else:
        groups = []
        if split_bad.any():
            groups.append((cfg.with_(use_dphi_split=False),
                           np.nonzero(split_bad)[0]))
        rest = np.nonzero(~split_bad)[0]
        if rest.size:
            # rows whose OTF provably fits the reduced window run it, the
            # rest the full one; a pinned window (otf_support or otf_blue)
            # is kept as given
            sub = [(cfg, rest)]
            if (cfg.otf_support == 0 and cfg.otf_window is not None
                    and cfg.otf_blue is None):
                bq = default_support_bucket(cfg)
                if bq < cfg.dim // 2:
                    okw = adm.windowable(rest, float(lb_np.max()), cfg, bq)
                    cfg_w = cfg.with_(otf_support=bq)
                    if okw.all():
                        sub = [(cfg_w, rest)]
                    elif okw.any():
                        sub = [(cfg_w, rest[okw]), (cfg, rest[~okw])]
            groups += sub
    # the anchor per group: certified on the host for the night's device
    # (the redo's full window resolves as the original night's groups do)
    groups = [(resolve_zoom_anchor(gcfg, lb_np, npsflin * npsflin, device),
               gidx) for gcfg, gidx in groups]
    if not force_full and cfg.otf_support == 0:
        groups = _blue_split_plan(groups, seeing, GL, L0, gs_mask, lb_np,
                                  h_t, wind_speed, npsflin,
                                  clamped_chunk(chunk, B, mesh), adm)
    # the redo keeps the caller's chunk (the original night's), padding
    # the redone rows up to it
    chunk = clamped_chunk(chunk, chunk if force_full else B, mesh)
    table = np.concatenate(
        [seeing[:, None], GL[:, None], L0[:, None], gs_mask], axis=1)
    return cfg, groups, chunk, table, lb_np, h_t, wind_speed, npixc


@dataclasses.dataclass(frozen=True)
class GroupPlan:
    """One group's dispatch schedule (host data only).  ``rows`` are
    input-row indices in dispatch order; the group's padded telemetry is
    ``table[rows]`` extended by ``n_pad`` repeats of its last row.
    ``sizes[i]`` is the i-th chunk's size, ``nvals[i]`` how many of its
    rows are real, ``offs[i]`` its offset into the padded group table."""
    cfg: GalacsiConfig
    rows: np.ndarray
    sizes: tuple
    nvals: tuple
    offs: tuple

    @property
    def n_pad(self) -> int:
        return int(sum(self.sizes)) - int(self.rows.shape[0])


@dataclasses.dataclass(frozen=True)
class BatchPlan:
    """The complete plan of a batch run, a pure function of (telemetry,
    wavelength grid, npsflin, cfg, chunk), produced by :func:`plan_batch`
    and executed by :func:`process_batch`/:func:`reconstruct_batch`."""
    cfg: GalacsiConfig
    chunk: int
    npsflin: int
    use_tail: bool
    lbda: np.ndarray
    npixc: np.ndarray
    h: tuple
    wind_speed: float
    table: np.ndarray             # (B, 7) telemetry
    groups: tuple                 # of GroupPlan, dispatch order

    def summary(self) -> dict:
        """JSON-serialisable summary, the same as the JAX package's: group
        configs as deltas against the base config."""
        def _j(v):
            if isinstance(v, np.integer):
                return int(v)
            if isinstance(v, np.floating):
                return float(v)
            if isinstance(v, (tuple, list)):
                return [_j(x) for x in v]
            return v

        groups = []
        for g in self.groups:
            delta = {f.name: _j(getattr(g.cfg, f.name))
                     for f in dataclasses.fields(GalacsiConfig)
                     if getattr(self.cfg, f.name) != getattr(g.cfg, f.name)}
            groups.append({
                "cfg_delta": delta,
                "rows": [int(i) for i in g.rows],
                "sizes": [int(s) for s in g.sizes],
                "nvals": [int(n) for n in g.nvals],
                "offs": [int(o) for o in g.offs],
            })
        return {
            "chunk": int(self.chunk),
            "npsflin": int(self.npsflin),
            "use_tail": bool(self.use_tail),
            "nl": int(self.lbda.size),
            "npixc": [int(n) for n in self.npixc],
            "n_rows": int(self.table.shape[0]),
            "groups": groups,
        }


def _tail_size(chunk_n: int, rem: int) -> int:
    """Smallest size from the fixed tail menu {c/4, c/2, 3c/4} covering
    ``rem`` leftover rows (else the full chunk)."""
    for num, den in ((1, 4), (1, 2), (3, 4)):
        t = max(1, chunk_n * num // den)
        if t >= rem:
            return t
    return chunk_n


_PLAN_MEMO = {}
_PLAN_MEMO_MAX = 8


def plan_batch(seeing, GL, L0, gs_mask, lbda, h=(100, 10000),
               npsflin: int = 1, cfg: GalacsiConfig = None,
               chunk: int = 8, force_full=False,
               use_tail: bool = None, device="cuda",
               mesh=None) -> BatchPlan:
    """The :class:`BatchPlan` of a batch run: host-only planning
    (:func:`_plan_batch`), then each group's chunk schedule.  The last
    partial chunk of a reduced-window group runs at the smallest covering
    size of the tail menu; full-window groups always pad to the chunk, and
    so does every group under a ``mesh``, whose chunks are multiples of
    its size.  ``device`` is the device the night will run on; it decides
    only how ``zoom_anchor="auto"`` resolves, so a CPU process can plan a
    card night.  Memoised on the inputs; the plan's arrays are
    read-only."""
    seeing = np.atleast_1d(np.asarray(seeing, np.float64))
    GL = np.atleast_1d(np.asarray(GL, np.float64))
    L0 = np.atleast_1d(np.asarray(L0, np.float64))
    gs_mask = np.atleast_2d(np.asarray(gs_mask, np.float64))
    if use_tail is None:
        use_tail = not force_full
    dev_type = torch.device(device).type
    memo_key = (seeing.tobytes(), GL.tobytes(), L0.tobytes(),
                gs_mask.tobytes(), np.asarray(lbda, np.float64).tobytes(),
                tuple(np.asarray(h, np.float64).ravel()), npsflin, cfg,
                int(chunk), bool(force_full), bool(use_tail), dev_type,
                None if mesh is None else (mesh.size, mesh.axis_names))
    hit = _PLAN_MEMO.get(memo_key)
    if hit is not None:
        profiling.count("plan_memo_hits")
        return hit
    profiling.count("plan_memo_misses")
    (cfg_r, groups, chunk_n, table, lb_np, h_t, wind_speed,
     npixc) = _plan_batch(seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg,
                          chunk, force_full, dev_type, mesh)
    gplans = []
    for gcfg, gidx in groups:
        n_main, rem = divmod(gidx.shape[0], chunk_n)
        if rem and use_tail and mesh is None and gcfg.otf_support:
            tail = _tail_size(chunk_n, rem)
        else:
            tail = chunk_n if rem else 0
        sizes = tuple([chunk_n] * n_main + ([tail] if rem else []))
        nvals = tuple([chunk_n] * n_main + ([rem] if rem else []))
        offs = tuple(int(o) for o in
                     np.concatenate([[0], np.cumsum(sizes)[:-1]]))
        gplans.append(GroupPlan(gcfg, gidx, sizes, nvals, offs))
    # frozen: the memo shares one plan across calls, and callbacks get
    # views of its rows
    lb_np = np.array(lb_np)
    for arr in (table, npixc, lb_np, *(g.rows for g in gplans)):
        arr.setflags(write=False)
    plan = BatchPlan(cfg_r, chunk_n, npsflin, bool(use_tail), lb_np, npixc,
                     h_t, float(wind_speed), table, tuple(gplans))
    if len(_PLAN_MEMO) >= _PLAN_MEMO_MAX:
        _PLAN_MEMO.pop(next(iter(_PLAN_MEMO)))
    _PLAN_MEMO[memo_key] = plan
    return plan


# ---- execution ----------------------------------------------------------

def _check_device_dtype(cfg: GalacsiConfig, dev: torch.device):
    if (dev.type == "cuda" and cfg.dtype != "float32"
            and (cfg.use_fused_zoom
                 or (cfg.use_fused_conv and not cfg.use_fft))):
        raise ValueError(
            f"the fused CUDA kernels run float32 only, and cfg.dtype is "
            f"{cfg.dtype!r}; set use_fused_zoom=False and "
            "use_fused_conv=False for a float64 run on CUDA, or run on "
            "device='cpu'")


def _night_device(device, mesh):
    """The device a night's results land on: ``device`` without a mesh,
    else the mesh's first local device; a ``device`` of another type than
    the mesh's is refused."""
    if mesh is None:
        return resolve_device(device)
    dev = resolve_device(mesh.local[0])
    if torch.device(device).type != dev.type:
        raise ValueError(f"device={str(device)!r} disagrees with the "
                         f"mesh's {dev.type} devices; pass "
                         f"device={dev.type!r} with this mesh")
    return dev


def _chunks(plan: BatchPlan, dev, mesh=None):
    """Place the plan on the night's devices and iterate its chunks:
    ``(group_cfg, rows, shards)`` per chunk, ``rows`` the input indices of
    its real rows and ``shards`` one ``(t, n_valid, lbda, npixc)`` per
    shard this process runs, ``t`` the shard's (rows, 7) telemetry on its
    device (the chunk padded with repeats of the group's last row) and
    ``n_valid`` how many of its rows are real, a 0-d int64 tensor there.
    Without a mesh the chunk is one shard on ``dev``.  The whole night's
    padded telemetry and every shard's ``n_valid`` go to each device in
    one copy each, before the first chunk."""
    dtype = torch_dtype(plan.cfg.dtype)
    tabs = [np.concatenate([plan.table[g.rows],
                            np.repeat(plan.table[g.rows[-1:]], g.n_pad,
                                      axis=0)]) for g in plan.groups]
    night_np = np.concatenate(tabs)
    sched, base = [], 0       # (cfg, rows, [(device, row 0, rows, n_valid)])
    for g in plan.groups:
        for size, nval, off in zip(g.sizes, g.nvals, g.offs):
            split = ([(dev, slice(0, size))] if mesh is None else
                     [(d, sl) for _, d, sl
                      in rows_sharding(mesh).local_slices(size)])
            sched.append((g.cfg, g.rows[off:off + nval], [
                (d, base + off + sl.start, sl.stop - sl.start,
                 min(max(nval - sl.start, 0), sl.stop - sl.start))
                for d, sl in split]))
        base += sum(g.sizes)
    nvals = np.array([s[3] for *_, shards in sched for s in shards],
                     np.int64)
    placed = {}
    with profiling.span("push"):
        for d in ((dev,) if mesh is None else mesh.local):
            if d not in placed:
                _check_device_dtype(plan.cfg, d)
                # (copies: the plan's arrays are read-only)
                placed[d] = (torch.as_tensor(night_np, dtype=dtype,
                                             device=d),
                             torch.tensor(np.array(plan.lbda), dtype=dtype,
                                          device=d),
                             torch.tensor(np.array(plan.npixc),
                                          dtype=torch.int64, device=d),
                             torch.as_tensor(nvals, device=d))
    j = 0
    for gcfg, rows, split in sched:
        shards = []
        for d, lo, n, _ in split:
            night, lbda, npixc, nv = placed[d]
            shards.append((night[lo:lo + n], nv[j], lbda, npixc))
            j += 1
        yield gcfg, rows, shards


def _replicate_for_host(mesh, dev, local):
    """Every shard's results, in shard order, on ``dev`` (this process's
    first local device), from ``local``: one tuple of tensors per shard
    this process ran.  Under a process group they are gathered from every
    rank, so every process holds the whole chunk (the JAX package's
    all-gather).  The shards' tensors are packed into one row per shard,
    so a chunk costs one collective."""
    if mesh is None:
        return local
    local = [tuple(x.to(dev) for x in p) for p in local]
    if mesh.backend is None:
        return local
    like = local[0]
    dt = reduce(torch.promote_types, [x.dtype for x in like])
    flat = torch.stack([torch.cat([x.reshape(-1).to(dt) for x in p])
                        for p in local])
    if mesh.backend == "gloo":
        # gloo moves tensors through the host: this copy is its transport
        flat = flat.cpu()
    blocks = [torch.empty_like(flat) for _ in range(mesh.world)]
    dist.all_gather(blocks, flat)
    parts = []
    for row in torch.cat(blocks).to(dev):
        p, off = [], 0
        for x in like:
            p.append(row[off:off + x.numel()].reshape(x.shape).to(x.dtype))
            off += x.numel()
        parts.append(tuple(p))
    return parts


def _cat(xs):
    return xs[0] if len(xs) == 1 else torch.cat(xs)


def _pull(*tensors):
    """Several device tensors to host numpy in ONE copy (their raveled
    concatenation in a common dtype), original shapes and dtypes
    restored."""
    dt = tensors[0].dtype
    for t in tensors[1:]:
        dt = torch.promote_types(dt, t.dtype)
    flat = torch.cat([t.reshape(-1).to(dt) for t in tensors]).cpu()
    out, off = [], 0
    for t in tensors:
        out.append(flat[off:off + t.numel()].reshape(tuple(t.shape))
                   .to(t.dtype).numpy())
        off += t.numel()
    return out


def reconstruct_batch(seeing, GL, L0, gs_mask, lbda, h=(100, 10000),
                      npsflin: int = 1, cfg: GalacsiConfig = None,
                      chunk: int = 8, device="cuda", _force_full=False,
                      mesh=None, _graphs=True):
    """Reconstruct PSF cubes for a batch of work items: (B,)-shaped
    telemetry (``gs_mask`` (B, 4)) -> (B, nl, dimpsf, dimpsf) numpy.  The
    rows of chunks whose window guard trips are recomputed with the full
    window.  With ``mesh`` each chunk's rows are split over its devices
    (``device`` then only names their type) and every process returns
    the whole batch.  Each chunk runs the program "recon"
    (:func:`_reconstruct_chunk`, ``parallel/programs.py``);
    ``_graphs=False`` runs it eagerly on the card too, for comparison."""
    dev = _night_device(device, mesh)
    seeing = np.atleast_1d(np.asarray(seeing, np.float64))
    GL = np.atleast_1d(np.asarray(GL, np.float64))
    L0 = np.atleast_1d(np.asarray(L0, np.float64))
    gs_mask = np.atleast_2d(np.asarray(gs_mask, np.float64))
    plan = plan_batch(seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg, chunk,
                      force_full=_force_full, device=dev, mesh=mesh)
    idxs, cubes, guards = [], [], []
    for gcfg, rows, shards in _chunks(plan, dev, mesh):
        step = partial(_reconstruct_chunk, h=plan.h,
                       wind_speed=plan.wind_speed, npsflin=npsflin, cfg=gcfg)
        parts = _replicate_for_host(mesh, dev, [
            programs.run(_program_key("recon", plan, gcfg, t.shape[0]),
                         step, (t, lbda_d, npixc_d), _graphs)
            for t, _, lbda_d, npixc_d in shards])
        idxs.append(rows)
        cubes.append(_cat([p[0] for p in parts])[:len(rows)])
        guards.append(reduce(torch.minimum, [p[1] for p in parts]))
    cube_np, guard_np = _pull(torch.cat(cubes), torch.stack(guards))
    out = np.empty_like(cube_np)
    out[np.concatenate(idxs)] = cube_np
    for i in np.nonzero(guard_np < 0.0)[0]:
        idx = idxs[i]
        logger.warning(
            "OTF-support window guard tripped (margin %.2f); recomputing "
            "%d rows with the full window", float(guard_np[i]), len(idx))
        out[idx] = reconstruct_batch(
            seeing[idx], GL[idx], L0[idx], gs_mask[idx], lbda, h, npsflin,
            cfg, plan.chunk, device, _force_full=True, mesh=mesh,
            _graphs=_graphs)
    return out


def process_batch(seeing, GL, L0, gs_mask, lbda, h=(100, 10000),
                  npsflin: int = 1, cfg: GalacsiConfig = None,
                  chunk: int = 8, fit_dtype: str = None, device="cuda",
                  on_chunk=None, on_redo_start=None, on_final=None,
                  _force_full=False, _return_parts=False, mesh=None,
                  _graphs=True):
    """Full batch: reconstruct, Moffat-fit and average on the device.

    Returns numpy ``(fit_packed, psf_mean, fit_mean_packed)``: per-row
    per-wavelength packed Moffat parameters (B, nl, N_PACKED) in input
    order (see ``fit.moffat_fit.PACKED_FIELDS``), the (nl, dimpsf, dimpsf)
    mean PSF over the rows (padding rows masked out) and its packed fit.
    The PSF cubes never leave the device; the fits, the mean and the
    reduced-window chunks' guards come back in one copy.

    When a chunk's window guard trips, only that chunk's rows are
    recomputed with the full window at the original chunk, and the mean
    is corrected on the device.

    ``on_chunk(row_indices, packed_numpy)`` is called after each chunk
    (rows are bucketed, so chunks do not arrive in input order; after a
    guard trip it is called again for the redone rows with the corrected
    values: treat the indices as keys).  ``on_redo_start(row_indices)`` is
    called once, before the redo, with the rows about to be recomputed.
    ``on_final(row_indices)`` is called when rows' values can no longer
    change: right after delivery for chunks of guard-free groups (full
    window, no blue sub-window), once for the untripped reduced-window
    chunks after the guards are read, and once for the redone rows after
    their corrected delivery.

    With ``mesh`` (:func:`parallel.mesh.default_mesh`) each chunk's rows
    are split over the mesh's devices, and ``device`` only names their
    type.  Shard ``i`` runs the chunk step on its slice, on its device,
    with only its real rows in its PSF sum; the fits are concatenated,
    the sums added and the guards' minimum taken in shard order, on this
    process's first device.  Under a process group every rank calls with
    the same telemetry, the shards are gathered from every rank after each
    chunk, and every rank returns the whole night, equal bit for bit, and
    calls ``on_chunk``, ``on_redo_start`` and ``on_final`` with the whole
    chunk.

    ``_return_parts`` (the redo, whose full window cannot trip): return
    the device tensors ``(fit in input order, psf_sum)`` without host
    copies.

    Each chunk runs the program "fit" (:func:`_fit_chunk`) and the mean's
    fit the program "mean" (``parallel/programs.py``): on the card each is
    captured as a CUDA graph at its second dispatch and replayed from then
    on; ``_graphs=False`` runs them eagerly on the card too, for
    comparison.
    """
    with profiling.span("batch", deltas=True) as attrs:
        dev = _night_device(device, mesh)
        cfg = cfg or GalacsiConfig()
        fit_dtype = fit_dtype or cfg.fit_dtype
        seeing = np.atleast_1d(np.asarray(seeing, np.float64))
        GL = np.atleast_1d(np.asarray(GL, np.float64))
        L0 = np.atleast_1d(np.asarray(L0, np.float64))
        gs_mask = np.atleast_2d(np.asarray(gs_mask, np.float64))
        attrs["rows"] = int(seeing.shape[0])
        with profiling.span("plan"):
            plan = plan_batch(seeing, GL, L0, gs_mask, lbda, h, npsflin, cfg,
                              chunk, force_full=_force_full, device=dev,
                              mesh=mesh)
        idxs, fits, psums = [], [], []
        guards, guarded = [], []      # guards of the reduced-window chunks
        count = 0
        for gcfg, rows, shards in _chunks(plan, dev, mesh):
            n = len(rows)
            step = partial(_fit_chunk, h=plan.h, wind_speed=plan.wind_speed,
                           npsflin=npsflin, cfg=gcfg, fit_dtype=fit_dtype)
            parts = _replicate_for_host(mesh, dev, [
                programs.run(_program_key("fit", plan, gcfg, t.shape[0],
                                          fit_dtype),
                             step, (t, n_valid, lbda_d, npixc_d), _graphs)
                for t, n_valid, lbda_d, npixc_d in shards])
            profiling.count("rows_computed",
                            sum(t.shape[0] for t, *_ in shards))
            fit = _cat([p[0] for p in parts])
            psum = reduce(torch.add, [p[1] for p in parts])  # shard order
            guard = reduce(torch.minimum, [p[2] for p in parts])
            idxs.append(rows)
            fits.append(fit[:n])
            psums.append(psum)
            # no reduced window and no blue sub-window: the guard is +inf by
            # construction, and the rows are final at delivery
            free = not gcfg.otf_support and gcfg.otf_blue is None
            if not free:
                guards.append(guard)
                guarded.append(len(idxs) - 1)
            if on_chunk is not None:
                on_chunk(rows, fits[-1].cpu().numpy())
            if on_final is not None and free:
                on_final(rows)
            count += n
        total_psum = torch.sum(torch.stack(psums), dim=0)
        order = np.concatenate(idxs)
        inv = np.argsort(order)
        if _return_parts:
            return (torch.cat(fits)[torch.as_tensor(inv, device=dev)],
                    total_psum)
        psf_mean = total_psum / count
        fit_mean = _fit_mean(psf_mean, fit_dtype, _graphs)
        with profiling.span("pull"):
            pulled = _pull(torch.cat(fits), psf_mean, fit_mean, *guards)
        fit_np, psf_mean_np, fit_mean_np = pulled[:3]
        fit_np = fit_np[inv]
        profiling.count("rows", fit_np.shape[0])
        guard_np = np.array([float(g) for g in pulled[3:]])
        tripped = [guarded[i] for i in np.nonzero(guard_np < 0.0)[0]]
        if on_final is not None:
            clear = [idxs[i] for i in guarded if i not in tripped]
            if clear:
                on_final(np.concatenate(clear))
        if not tripped:
            return fit_np, psf_mean_np, fit_mean_np

        # surgical redo: only the tripped chunks' rows, on the full window
        # at the original chunk; the mean swaps their contribution on the
        # device
        redo_idx = np.concatenate([idxs[i] for i in tripped])
        profiling.count("guard_trips", len(tripped))
        profiling.count("redo_rows", redo_idx.size)
        logger.warning(
            "OTF-support window guard tripped for %d of %d chunks (worst "
            "margin %.2f); recomputing %d of %d rows with the full window",
            len(tripped), len(idxs), float(guard_np.min()), redo_idx.size,
            count)
        if on_redo_start is not None:
            on_redo_start(redo_idx)
        on_chunk_redo = None
        if on_chunk is not None:
            def on_chunk_redo(local_idx, packed_np):
                on_chunk(redo_idx[local_idx], packed_np)
        with profiling.span("redo", rows=int(redo_idx.size)):
            fit_redo, psum_redo = process_batch(
                seeing[redo_idx], GL[redo_idx], L0[redo_idx],
                gs_mask[redo_idx], lbda, h, npsflin, cfg, plan.chunk,
                fit_dtype, device, on_chunk=on_chunk_redo, _force_full=True,
                _return_parts=True, mesh=mesh, _graphs=_graphs)
            old_sub = torch.sum(torch.stack([psums[i] for i in tripped]),
                                dim=0)
            psf_mean = (total_psum - old_sub + psum_redo) / count
            fit_mean = _fit_mean(psf_mean, fit_dtype, _graphs)
        with profiling.span("pull"):
            fit_redo_np, psf_mean_np, fit_mean_np = _pull(fit_redo, psf_mean,
                                                          fit_mean)
        fit_np[redo_idx] = fit_redo_np
        if on_final is not None:
            on_final(redo_idx)
        return fit_np, psf_mean_np, fit_mean_np
