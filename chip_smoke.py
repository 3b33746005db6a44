#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                    # the checks below, one card
    python3 chip_smoke.py --profile OUT.txt  # also a torch.profiler table
                                             # of one warmed night -> OUT.txt

Phases (any failure raises, so the exit code is non-zero):

1. the card's name and power limit (``nvidia-smi``); CUDA required;
2. build the hand-written kernels from ``muse_psfr_tpu_torch/csrc``;
3. K1 (fused exp + zoom DFT) against its plain PyTorch version at the
   production grid, structure function (1, 1280, 768) per row: 2 rows x
   12 wavelengths, then one main-path chunk of 50 rows x 35 wavelengths
   (zoom rows (35, 160, 1280)); relative max-abs <= 1e-5;
4. K2 (convolution chain) against its plain version at 50 rows x 35
   planes of 40 x 40 (transform size 64); relative max-abs <= 1e-6;
5. the main path: ``process_batch`` on the 100-row x 35-wavelength bench
   night (490-930 nm, npsflin=1, chunk=50, FFT-free config) with the
   launch counts of both kernels, finite fits with ``ok`` everywhere, the
   pinned row (1.0", 0.7, 25 m) against the float64 golden PSF (rms <=
   1e-5), the CLI result block, and five warmed nights' times;
6. one JSON line of per-kernel results, the card line, and the final
   status line ``{"ok": true, "device": {...}}``.

Imports nothing of JAX.
"""

import json
import os
import subprocess
import sys
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
GOLDEN = os.path.join(ROOT, "tests", "data",
                      "golden_psf_35l_s1.0_gl0.7_l025.npy")
CLI_BLOCK = ("FWHM 0.85 0.73 0.62", "BETA 2.73 2.55 2.23")


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


def check_zoom_kernel(torch, cfg, dev, rows, nrow, nl):
    """K1 vs its plain version on the first ``nrow`` bench rows and the
    first ``nl`` wavelengths, at the production grid."""
    from muse_psfr_tpu_torch.ops import zoom_dft
    from muse_psfr_tpu_torch.otf.psf import (_dl_window, _zoom_operands,
                                             dphi_base_split,
                                             lambda_crop_size)
    from muse_psfr_tpu_torch.psd.model import (effective_wind_speed,
                                               simulate_psd_split)
    seeing, GL, L0, mask = (torch.as_tensor(a[:nrow], dtype=torch.float32,
                                            device=dev) for a in rows)
    h = (100, 10000)
    w_fit, delta = simulate_psd_split(seeing, GL, L0, mask, h,
                                      effective_wind_speed(h, cfg), 1, cfg)
    base = dphi_base_split(w_fit, delta, cfg)         # (nrow, 1, 1280, 768)
    lb = np.linspace(490, 930, 35)[:nl]
    a2, alpha, w, *_ = _zoom_operands(
        base, torch.as_tensor(lb, dtype=torch.float32, device=dev),
        torch.as_tensor(lambda_crop_size(lb, cfg), device=dev), cfg)
    dl = _dl_window(cfg, dev, torch.float32)
    args = (base, dl, a2, alpha, w)
    got = zoom_dft.fused_exp_zoom(*args, exp2=cfg.zoom_exp2)
    want = zoom_dft.fused_exp_zoom_reference(*args, exp2=cfg.zoom_exp2)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(torch, got, want)
    del got, want
    print(f"K1 fused_exp_zoom: dphi {tuple(base.shape)} a2 "
          f"{tuple(a2.shape)}; max abs err {abs_err:.3e}, relative to "
          f"max|U| {rel:.3e} (limit 1e-5)")
    if not rel <= 1e-5:
        raise RuntimeError(f"K1 disagrees with its plain version: {rel}")
    reps = max(3, 240 // (nrow * nl))
    ms = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom(
        *args, exp2=cfg.zoom_exp2), reps)
    plain_ms = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom_reference(
        *args, exp2=cfg.zoom_exp2), reps)
    flop = 2.0 * np.prod(a2.shape) * base.shape[-1] * base.shape[0]
    print(f"K1 time {ms:.4f} ms ({flop / ms / 1e9:.2f} TFLOP/s of "
          f"contraction), plain PyTorch {plain_ms:.4f} ms")
    return {"name": "fused_exp_zoom", "route": "cuda",
            "source": "muse_psfr_tpu_torch/csrc/zoom_dft.cu",
            "replaces": "muse_psfr_tpu/ops/zoom_dft.py:380",
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms}


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
    lb = torch.as_tensor(np.linspace(490, 930, nl), dtype=torch.float32,
                         device=dev)
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


def main_path(torch, cfg, rows, card):
    """The bench night through process_batch, counted; golden row; CLI
    block.  Returns the launch counts of the counted night."""
    from muse_psfr_tpu_torch.fit.moffat_fit import (N_PACKED,
                                                    fit_moffat_cube_host64,
                                                    unpack_fit)
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import (process_batch,
                                                    reconstruct_batch)
    lbda = np.linspace(490, 930, 35)
    night = dict(lbda=lbda, npsflin=1, cfg=cfg, chunk=50, device="cuda")

    _build.reset_launch_counts()
    fit, psf_mean, fit_mean = process_batch(*rows, **night)
    counts = _build.launch_counts()
    print(f"main path: process_batch on {len(rows[0])} rows x "
          f"{lbda.size} wavelengths, launches {counts}")
    if min(counts.values()) < 1:
        raise RuntimeError(f"a kernel of the main path never ran: {counts}")
    if fit.shape != (len(rows[0]), lbda.size, N_PACKED):
        raise RuntimeError(f"fit array has shape {fit.shape}")
    unpacked = unpack_fit(fit)
    if not (np.all(np.isfinite(fit)) and np.all(np.isfinite(psf_mean))
            and np.all(np.isfinite(fit_mean))):
        raise RuntimeError("non-finite values in the night's results")
    if not unpacked["ok"].all():
        raise RuntimeError(f"{int((~unpacked['ok']).sum())} planes failed "
                           "to fit")
    print(f"all {unpacked['ok'].size} plane fits finite and converged; "
          f"fwhm range {unpacked['fwhm'][..., 0].min() * cfg.pixscale:.3f}"
          f"-{unpacked['fwhm'][..., 0].max() * cfg.pixscale:.3f} arcsec")

    walls = []
    for _ in range(5):
        t0 = time.perf_counter()
        process_batch(*rows, **night)
        walls.append(time.perf_counter() - t0)
    dt = float(np.median(walls))
    print(f"warmed night x5: wall {' '.join(f'{t:.4f}' for t in walls)} s;"
          f" median {dt:.4f} s, {len(rows[0]) / dt:.2f} rows/s ({card})")

    cube = reconstruct_batch(*(a[:1] for a in rows), lbda=lbda, cfg=cfg,
                             chunk=1, device="cuda")[0]
    rms = float(np.sqrt(np.mean((cube.astype(np.float64)
                                 - np.load(GOLDEN)) ** 2)))
    print(f"golden row (1.0, 0.7, 25): rms {rms:.3e} vs the float64 "
          "oracle (limit 1e-5)")
    if not rms <= 1e-5:
        raise RuntimeError(f"golden rms {rms} over the 1e-5 budget")

    lb3 = np.array([500.0, 700.0, 900.0])
    _, mean3, _ = process_batch([1.0], [0.7], [25.0], np.ones((1, 4)),
                                lbda=lb3, npsflin=1, cfg=cfg, chunk=1,
                                device="cuda")
    fm = fit_moffat_cube_host64(mean3)
    block = ("FWHM " + " ".join("%.2f" % v
                                for v in fm["fwhm"][:, 0] * cfg.pixscale),
             "BETA " + " ".join("%.2f" % v for v in fm["n"]))
    print("LBDA 5000 7000 9000\n" + "\n".join(block))
    if block != CLI_BLOCK:
        raise RuntimeError(f"CLI block {block} != {CLI_BLOCK}")
    return counts, night


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
                        help="also profile one warmed night; table to OUT")
    args = parser.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this check "
              "needs a CUDA card", file=sys.stderr)
        return 1
    sys.path.insert(0, ROOT)
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.utils.device import resolve_device

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

    cfg = GalacsiConfig(use_fft=False)
    rows = build_rows(100)
    check_zoom_kernel(torch, cfg, dev, rows, 2, 12)
    k1 = check_zoom_kernel(torch, cfg, dev, rows, 50, 35)   # one chunk
    k2 = check_conv_kernel(torch, cfg, dev, rows)
    counts, night = main_path(torch, cfg, rows, card)
    k1["launches"] = counts["zoom_dft"]
    k2["launches"] = counts["conv_dft"]
    if args.profile:
        profile_night(torch, rows, night, args.profile)
    print(json.dumps({"kernels": [k1, k2]}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
