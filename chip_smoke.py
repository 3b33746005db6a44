#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                     # the checks below, one card
    python3 chip_smoke.py --profile OUT.txt   # also a torch.profiler table
                                              # of one warmed night -> OUT
    python3 chip_smoke.py --profile-ndir9 OUT # the same for the
                                              # 9-direction night

Phases (any failure raises, so the exit code is non-zero):

1. the card's name and power limit (``nvidia-smi``); CUDA required;
2. build the hand-written kernels from ``muse_psfr_tpu_torch/csrc``;
3. K1 (fused exp + zoom DFT) against its plain PyTorch version at the
   production grid, structure function (1, 1280, 768) per row: 2 rows x
   12 wavelengths, then one main-path chunk of 50 rows x 35 wavelengths;
   then K1 at ndir=9 (K1', K4) on 4 rows x 35 wavelengths; relative
   max-abs <= 1e-5 of max|U|;
4. K3 (K1 over R contraction-row slices, summed in order) against its
   plain version (<= 1e-5) and against K1 (<= 1e-6) at the TPU's shape
   (ndir=9, 1280 rows, R=2, 4 rows x 35 wavelengths) and at the CLI
   block's (1 row, 3 wavelengths, the S=256 window, R from
   ``_zoom_row_splits``);
5. K2 (convolution chain) against its plain version at 50 rows x 35
   planes of 40 x 40 (transform size 64); relative max-abs <= 1e-6;
6. the 1-direction bench night (100 rows x 35 wavelengths, 490-930 nm,
   chunk=50, FFT-free config) through the auto planner: the plan equals
   ``tests/data/golden_plan_night100.json``, launch counts, finite and
   converged fits, five warmed nights and one warmed night with every
   row on the full window; the pinned row (1.0", 0.7, 25 m) against the
   float64 golden PSF (rms <= 1e-5); the CLI result block,
   exact, with K3 launched in it;
7. the 9-direction night (npsflin=3, 100 rows, chunk=44): the plan equals
   ``golden_plan_night100_npsflin3.json``, launch counts, fits, the mean
   PSF against the same night on the full window (relative max-abs <=
   1e-5) and the per-row FWHM/beta (<= 1e-3 relative), guard trips, five
   warmed nights and one warmed full-window night;
8. a forced redo: a pinned 128-px window too small for the ultra-weak
   damping row (0.2", 0.01, 30 m) at 930 nm trips the window guard, and
   the redone cube equals the full-window one to <= 2e-6 abs;
9. one JSON line of per-kernel results, the card line, and the final
   status line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.
"""

import json
import logging
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = os.path.join(DATA, "golden_psf_35l_s1.0_gl0.7_l025.npy")
CLI_BLOCK = ("FWHM 0.85 0.73 0.62", "BETA 2.73 2.55 2.23")
LBDA = np.linspace(490, 930, 35)
ZOOM_SRC = "muse_psfr_tpu_torch/csrc/zoom_dft.cu"
JAX_ZOOM = "muse_psfr_tpu/ops/zoom_dft.py"


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def build_rows(n):
    """The bench night's telemetry (``bench.py:build_rows``): row 0
    pinned to the golden condition, ~10% of rows in 3-laser mode."""
    rng = np.random.default_rng(20260816)
    seeing = rng.uniform(0.6, 1.6, n)
    GL = rng.uniform(0.3, 0.9, n)
    L0 = rng.uniform(9.0, 29.0, n)
    mask = np.ones((n, 4))
    mask[rng.random(n) < 0.1, 3] = 0.0
    seeing[0], GL[0], L0[0] = 1.0, 0.7, 25.0
    mask[0] = 1.0
    return seeing, GL, L0, mask


def cuda_ms(torch, fn, reps):
    """Mean device time of ``fn`` [ms] over ``reps`` launches after one
    warm-up, from CUDA events."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def rel_err(torch, got, want):
    got, want = got.double(), want.double()
    abs_err = float(torch.max(torch.abs(got - want)))
    return abs_err, abs_err / float(torch.max(torch.abs(want)))


class GuardLog(logging.Handler):
    """Counts the batch layer's window-guard warnings."""

    def __init__(self):
        super().__init__(logging.WARNING)
        self.trips = []

    def emit(self, record):
        if "guard tripped" in record.getMessage():
            self.trips.append(record.getMessage())


def zoom_operands(torch, cfg, dev, rows, nrow, lb, npsflin):
    """K1's operands for the first ``nrow`` bench rows at ``cfg``'s
    window and the wavelengths ``lb``."""
    from muse_psfr_tpu_torch.otf.psf import (_dl_window, _zoom_operands,
                                             dphi_base_split,
                                             lambda_crop_size)
    from muse_psfr_tpu_torch.psd.model import (effective_wind_speed,
                                               simulate_psd_split)
    seeing, GL, L0, mask = (torch.as_tensor(a[:nrow], dtype=torch.float32,
                                            device=dev) for a in rows)
    h = (100, 10000)
    w_fit, delta = simulate_psd_split(seeing, GL, L0, mask, h,
                                      effective_wind_speed(h, cfg), npsflin,
                                      cfg)
    base = dphi_base_split(w_fit, delta, cfg)
    a2, alpha, w, *_ = _zoom_operands(
        base, torch.as_tensor(lb, dtype=torch.float32, device=dev),
        torch.as_tensor(lambda_crop_size(lb, cfg), device=dev), cfg)
    return base, _dl_window(cfg, dev, torch.float32), a2, alpha, w


def check_zoom_kernel(torch, cfg, dev, rows, nrow, lb, npsflin=1,
                      row_splits=1, label="K1"):
    """K1 (``row_splits=1``) or K3 against its plain version, and K3
    against K1, on the first ``nrow`` bench rows at ``cfg``'s window."""
    from muse_psfr_tpu_torch.ops import zoom_dft
    args = zoom_operands(torch, cfg, dev, rows, nrow, lb, npsflin)
    base, a2 = args[0], args[2]
    kw = dict(exp2=cfg.zoom_exp2, row_splits=row_splits)
    got = zoom_dft.fused_exp_zoom(*args, **kw)
    want = zoom_dft.fused_exp_zoom_reference(*args, **kw)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(torch, got, want)
    del want
    print(f"{label} fused_exp_zoom(row_splits={row_splits}): dphi "
          f"{tuple(base.shape)} a2 {tuple(a2.shape)}; max abs err "
          f"{abs_err:.3e}, relative to max|U| {rel:.3e} (limit 1e-5)")
    if not rel <= 1e-5:
        raise RuntimeError(f"{label} disagrees with its plain version: "
                           f"{rel}")
    if row_splits > 1:
        k1 = zoom_dft.fused_exp_zoom(*args, exp2=cfg.zoom_exp2)
        again = zoom_dft.fused_exp_zoom(*args, **kw)
        torch.cuda.synchronize()
        _, rel1 = rel_err(torch, got, k1)
        same = bool(torch.equal(got, again))
        print(f"{label} against K1 (row_splits=1): relative {rel1:.3e} "
              f"(limit 1e-6); rerun bit-identical: {same}")
        if not (rel1 <= 1e-6 and same):
            raise RuntimeError(f"{label} against K1: {rel1}, rerun "
                               f"identical {same}")
        del k1, again
    del got
    reps = max(3, 240 // (nrow * len(lb)))
    ms = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom(*args, **kw), reps)
    plain_ms = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom_reference(
        *args, **kw), reps)
    flop = 2.0 * np.prod(a2.shape) * base.shape[-1] * base.shape[0]
    print(f"{label} time {ms:.4f} ms ({flop / ms / 1e9:.2f} TFLOP/s of "
          f"contraction), plain PyTorch {plain_ms:.4f} ms")
    del args, base, a2
    torch.cuda.empty_cache()
    return {"route": "cuda", "source": ZOOM_SRC, "max_abs_err": abs_err,
            "ms": ms, "plain_ms": plain_ms}


def check_conv_kernel(torch, cfg, dev, rows):
    """K2 vs its plain version at one production chunk (50 rows x 35
    planes), with the real tip-tilt and intrinsic Moffat spectra."""
    from muse_psfr_tpu_torch.core.moffat import (moffat_fwhm_to_alpha,
                                                 moffat_kernel,
                                                 muse_intrinsic_psf)
    from muse_psfr_tpu_torch.ops import conv_dft
    from muse_psfr_tpu_torch.otf.convolve import (_dft_spectra,
                                                  _same_fft_size,
                                                  tip_tilt_fwhm)
    n, nk, nl, B = cfg.dimpsf, cfg.dimpsf + 1, 35, 50
    L = _same_fft_size(n, nk)
    seeing, GL, L0 = (torch.as_tensor(a[:B], dtype=torch.float32,
                                      device=dev) for a in rows[:3])
    k_tt = moffat_kernel(moffat_fwhm_to_alpha(
        tip_tilt_fwhm(seeing, GL, L0, cfg), 2.0), 2.0, nk)
    lb = torch.as_tensor(LBDA, dtype=torch.float32, device=dev)
    fwhm_i, beta_i, _, _ = muse_intrinsic_psf(lb)
    k_i = moffat_kernel(moffat_fwhm_to_alpha(fwhm_i / cfg.pixscale, beta_i),
                        beta_i, nk)
    gtt_r, gtt_i = (x.contiguous() for x in _dft_spectra(k_tt, L))
    gi_r, gi_i = (x.contiguous() for x in _dft_spectra(k_i, L))
    planes = torch.as_tensor(np.random.default_rng(7).random((B, nl, n, n)),
                             dtype=torch.float32, device=dev)
    args = (planes, gtt_r, gtt_i, gi_r, gi_i, nk)
    got = conv_dft.fused_conv_chain(*args)
    want = conv_dft.fused_conv_chain_reference(*args)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(torch, got, want)
    print(f"K2 fused_conv_chain: planes {tuple(planes.shape)}, L={L}; max "
          f"abs err {abs_err:.3e}, relative {rel:.3e} (limit 1e-6)")
    if not rel <= 1e-6:
        raise RuntimeError(f"K2 disagrees with its plain version: {rel}")
    ms = cuda_ms(torch, lambda: conv_dft.fused_conv_chain(*args), 50)
    plain_ms = cuda_ms(torch,
                       lambda: conv_dft.fused_conv_chain_reference(*args), 50)
    print(f"K2 time {ms:.4f} ms, plain PyTorch {plain_ms:.4f} ms")
    return {"name": "fused_conv_chain", "route": "cuda",
            "source": "muse_psfr_tpu_torch/csrc/conv_dft.cu",
            "replaces": "muse_psfr_tpu/ops/conv_dft.py:139",
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms}


def check_plan(rows, night, golden):
    from muse_psfr_tpu_torch.parallel.batch import plan_batch
    kw = {k: night[k] for k in ("npsflin", "cfg", "chunk")}
    plan = plan_batch(*rows, LBDA, **kw)
    with open(os.path.join(DATA, golden)) as fh:
        if plan.summary() != json.load(fh):
            raise RuntimeError(f"the plan differs from {golden}")
    print(f"plan == {golden}: " + "; ".join(
        f"{g.cfg.otf_support or 'full'}/{g.cfg.otf_blue} x {len(g.rows)} "
        f"rows in {list(g.sizes)}" for g in plan.groups))


def check_fits(fit, n_rows, *arrays):
    from muse_psfr_tpu_torch.fit.moffat_fit import N_PACKED, unpack_fit
    if fit.shape != (n_rows, LBDA.size, N_PACKED):
        raise RuntimeError(f"fit array has shape {fit.shape}")
    if not all(np.all(np.isfinite(a)) for a in (fit,) + arrays):
        raise RuntimeError("non-finite values in the night's results")
    unpacked = unpack_fit(fit)
    if not unpacked["ok"].all():
        raise RuntimeError(f"{int((~unpacked['ok']).sum())} planes failed "
                           "to fit")
    return unpacked


def warmed_nights(process_batch, rows, night, card, label, n=5):
    walls = []
    for _ in range(n):
        t0 = time.perf_counter()
        process_batch(*rows, **night)
        walls.append(time.perf_counter() - t0)
    dt = float(np.median(walls))
    print(f"{label} warmed x{n}: wall {' '.join(f'{t:.4f}' for t in walls)}"
          f" s; median {dt:.4f} s, {len(rows[0]) / dt:.2f} rows/s ({card})")


def main_path(torch, cfg, rows, card):
    """The 1-direction bench night through the auto planner, counted;
    golden row; CLI block (counted).  Returns the counts of the night and
    of the CLI block, and the night's arguments."""
    from muse_psfr_tpu_torch.fit.moffat_fit import fit_moffat_cube_host64
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import (process_batch,
                                                    reconstruct_batch)
    night = dict(lbda=LBDA, npsflin=1, cfg=cfg, chunk=50, device="cuda")
    check_plan(rows, night, "golden_plan_night100.json")

    _build.reset_launch_counts()
    fit, psf_mean, fit_mean = process_batch(*rows, **night)
    counts = _build.launch_counts()
    print(f"1-direction night: process_batch on {len(rows[0])} rows x "
          f"{LBDA.size} wavelengths, launches {counts}")
    if counts["zoom_dft"] < 1 or counts["conv_dft"] < 1:
        raise RuntimeError(f"a kernel of the night never ran: {counts}")
    unpacked = check_fits(fit, len(rows[0]), psf_mean, fit_mean)
    print(f"all {unpacked['ok'].size} plane fits finite and converged; "
          f"fwhm range {unpacked['fwhm'][..., 0].min() * cfg.pixscale:.3f}"
          f"-{unpacked['fwhm'][..., 0].max() * cfg.pixscale:.3f} arcsec")
    warmed_nights(process_batch, rows, night, card, "1-direction night")
    warmed_nights(process_batch, rows, dict(night, _force_full=True), card,
                  "1-direction night, full window", n=1)

    cube = reconstruct_batch(*(a[:1] for a in rows), lbda=LBDA, cfg=cfg,
                             chunk=1, device="cuda")[0]
    rms = float(np.sqrt(np.mean((cube.astype(np.float64)
                                 - np.load(GOLDEN)) ** 2)))
    print(f"golden row (1.0, 0.7, 25), auto-planned: rms {rms:.3e} vs the "
          "float64 oracle (limit 1e-5)")
    if not rms <= 1e-5:
        raise RuntimeError(f"golden rms {rms} over the 1e-5 budget")

    lb3 = np.array([500.0, 700.0, 900.0])
    _build.reset_launch_counts()
    _, mean3, _ = process_batch([1.0], [0.7], [25.0], np.ones((1, 4)),
                                lbda=lb3, npsflin=1, cfg=cfg, chunk=1,
                                device="cuda")
    cli_counts = _build.launch_counts()
    fm = fit_moffat_cube_host64(mean3)
    block = ("FWHM " + " ".join("%.2f" % v
                                for v in fm["fwhm"][:, 0] * cfg.pixscale),
             "BETA " + " ".join("%.2f" % v for v in fm["n"]))
    print("LBDA 5000 7000 9000\n" + "\n".join(block))
    print(f"CLI block launches {cli_counts}")
    if block != CLI_BLOCK:
        raise RuntimeError(f"CLI block {block} != {CLI_BLOCK}")
    if cli_counts["zoom_dft_rowsplit"] < 1:
        raise RuntimeError(f"K3 never ran on the CLI block: {cli_counts}")
    return counts, cli_counts, night


def ndir9_path(torch, cfg, rows, card, guard_log):
    """The 9-direction night through the auto planner, counted, against
    the same night on the full window."""
    from muse_psfr_tpu_torch.fit.moffat_fit import unpack_fit
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    night = dict(lbda=LBDA, npsflin=3, cfg=cfg, chunk=44, device="cuda")
    check_plan(rows, night, "golden_plan_night100_npsflin3.json")

    guard_log.trips.clear()
    _build.reset_launch_counts()
    fit, psf_mean, fit_mean = process_batch(*rows, **night)
    counts = _build.launch_counts()
    print(f"9-direction night: process_batch on {len(rows[0])} rows x "
          f"{LBDA.size} wavelengths, launches {counts}; window-guard "
          f"trips: {len(guard_log.trips)}")
    if counts["zoom_dft"] < 1 or counts["conv_dft"] < 1:
        raise RuntimeError(f"a kernel of the night never ran: {counts}")
    got = check_fits(fit, len(rows[0]), psf_mean, fit_mean)

    full = process_batch(*rows, **night, _force_full=True)
    want = unpack_fit(full[0])
    rel = float(np.abs(psf_mean - full[1]).max() / np.abs(full[1]).max())
    dfw = float(np.max(np.abs(got["fwhm"] - want["fwhm"])
                       / np.abs(want["fwhm"])))
    dn = float(np.max(np.abs(got["n"] - want["n"]) / np.abs(want["n"])))
    print(f"9-direction night vs its full-window run: mean PSF relative "
          f"max-abs {rel:.3e} (limit 1e-5); per-row FWHM {dfw:.3e}, beta "
          f"{dn:.3e} relative (limit 1e-3)")
    if not (rel <= 1e-5 and dfw <= 1e-3 and dn <= 1e-3):
        raise RuntimeError("the auto-planned 9-direction night departs "
                           "from its full-window run")
    warmed_nights(process_batch, rows, night, card, "9-direction night")
    warmed_nights(process_batch, rows, dict(night, _force_full=True), card,
                  "9-direction night, full window", n=1)
    return counts, night


def forced_redo(cfg, guard_log):
    """A pinned too-small window must trip the guard and be redone."""
    from muse_psfr_tpu_torch.parallel.batch import reconstruct_batch
    tel = ([0.2], [0.01], [30.0], np.ones((1, 4)))
    guard_log.trips.clear()
    got = reconstruct_batch(*tel, [930.0], cfg=cfg.with_(otf_support=128),
                            chunk=1, device="cuda")
    trips = list(guard_log.trips)
    full = reconstruct_batch(*tel, [930.0], cfg=cfg, chunk=1, device="cuda",
                             _force_full=True)
    err = float(np.abs(got - full).max())
    print(f"forced redo (0.2, 0.01, 30) at 930 nm, otf_support=128: "
          f"{trips}; max abs vs the full window {err:.3e} (limit 2e-6)")
    if not trips:
        raise RuntimeError("the pinned too-small window did not trip")
    if not err <= 2e-6:
        raise RuntimeError(f"the redone cube is off by {err}")


def profile_night(torch, rows, night, path):
    """torch.profiler table of one warmed night, printed and written to
    ``path``."""
    from torch.profiler import ProfilerActivity, profile
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        process_batch(*rows, **night)
    table = prof.key_averages().table(sort_by="cuda_time_total",
                                      row_limit=40)
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "w") as fh:
        fh.write(table)
    print(table)


def main(argv):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT",
                        help="also profile one warmed 1-direction night; "
                             "table to OUT")
    parser.add_argument("--profile-ndir9", metavar="OUT",
                        help="also profile one warmed 9-direction night")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.otf.psf import _zoom_row_splits
    from muse_psfr_tpu_torch.utils.device import resolve_device

    t_start = time.perf_counter()
    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    dev = resolve_device("cuda")
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"built {[p.name for p in _build.sources()]} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s -> {lib._name}")
    for line in _build.BUILD_LOG.splitlines():
        if "registers" in line or "spill" in line:
            print("  ptxas:", line.strip())
    guard_log = GuardLog()
    logging.getLogger("muse_psfr.batch").addHandler(guard_log)

    cfg = GalacsiConfig(use_fft=False)
    rows = build_rows(100)
    check_zoom_kernel(torch, cfg, dev, rows, 2, LBDA[:12])
    k1 = dict(name="fused_exp_zoom", replaces=f"{JAX_ZOOM}:124",
              **check_zoom_kernel(torch, cfg, dev, rows, 50, LBDA))
    k1_9 = dict(name="fused_exp_zoom@ndir9 (K1' _kernel, K4 "
                "_kernel_dirblock)", replaces=f"{JAX_ZOOM}:44,85",
                **check_zoom_kernel(torch, cfg, dev, rows, 4, LBDA,
                                    npsflin=3, label="K1 ndir=9"))
    k3 = dict(name="fused_exp_zoom_rowsplit (K3 _kernel_rowacc)",
              replaces=f"{JAX_ZOOM}:145",
              **check_zoom_kernel(torch, cfg, dev, rows, 4, LBDA,
                                  npsflin=3, row_splits=2, label="K3"))
    lb3 = np.array([500.0, 700.0, 900.0])
    r_cli = _zoom_row_splits(1 * 3 * 6, 512,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    k3_cli = dict(name="fused_exp_zoom_rowsplit@cli (K3, 1 row x 3 "
                  f"wavelengths, S=256, R={r_cli})",
                  replaces=f"{JAX_ZOOM}:145",
                  **check_zoom_kernel(torch, cfg.with_(otf_support=256),
                                      dev, rows, 1, lb3, row_splits=r_cli,
                                      label="K3 CLI"))
    k2 = check_conv_kernel(torch, cfg, dev, rows)

    counts, cli_counts, night = main_path(torch, cfg, rows, card)
    counts9, night9 = ndir9_path(torch, cfg, rows, card, guard_log)
    forced_redo(cfg, guard_log)
    k1["launches"] = counts["zoom_dft"]
    k2["launches"] = counts["conv_dft"]
    k1_9["launches"] = counts9["zoom_dft"]
    k3["launches"] = k3_cli["launches"] = cli_counts["zoom_dft_rowsplit"]
    if args.profile:
        profile_night(torch, rows, night, args.profile)
    if args.profile_ndir9:
        profile_night(torch, rows, night9, args.profile_ndir9)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": [k1, k1_9, k3, k3_cli, k2]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
