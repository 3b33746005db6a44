#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU (Hopper, sm_90a).

Run from the repository root on a machine with a CUDA card:

    python3 chip_smoke.py                     # the checks below, one card
    python3 chip_smoke.py --profile OUT.txt   # also a torch.profiler table
                                              # of one warmed night -> OUT
                                              # (its chunk programs
                                              # replayed; the same night
                                              # run eagerly -> OUT-eager)
    python3 chip_smoke.py --profile-ndir9 OUT # the same for the
                                              # 9-direction night
    python3 chip_smoke.py --profile-anchor OUT  # and for it with
                                              # zoom_anchor="auto"
    python3 chip_smoke.py --profile-default OUT # and for the 1-direction
                                              # night at the default config
    python3 chip_smoke.py --profile-sweep OUT # and for the 32 x 32 sweep's
                                              # rows at the default config
    python3 chip_smoke.py --profile-highest OUT --profile-ndir9-highest OUT
                                              # and for the 1- and the
                                              # 9-direction night at
                                              # zoom_precision="highest"
    python3 chip_smoke.py --profile-2048 OUT  # and for the 1-direction
                                              # night on the 2048^2 grid,
                                              # FFT-free -> OUT-fft-free

Phases (any failure raises, so the exit code is non-zero):

1. the card's name and power limit (``nvidia-smi``); CUDA required;
2. build the hand-written kernels from ``muse_psfr_tpu_torch/csrc``
   (ptxas registers and spills printed), and beside them the mma.sync
   body of K1/K3/K5 of 7a (``tools/mma_sync_bodies/zoom_dft_tc_mma.cu``,
   one ``nvcc`` started first);
3. K1 at zoom_precision "highest" (six bf16 passes on the tensor cores
   as warpgroup products fed by TMA, ``csrc/zoom_dft_tc.cu``, the TPU's
   ``Precision.HIGHEST``) against its plain PyTorch version at
   the production grid, structure function (1, 1280, 768) per row: 2 rows
   x 12 wavelengths, then one main-path chunk of 50 rows x 35 wavelengths
   (there also against float64 on its worst row, <= 6.663e-06 of that
   row's max|U|, the float32 FMA body's distance, and against the plain
   six-pass product); then K1 at ndir=9 (K1', K4) on 4 rows x 35
   wavelengths; relative max-abs <= 1e-6 of max|U|; each beside the
   float32 FMA body that ran "highest" before
   (``tools/fma_bodies/zoom_dft_fma.cu``, built apart from the package):
   its distances and the two bodies' times in turns (old, new, new, old);
4. K3 at "highest" (K1 over R contraction-row slices, summed in order)
   against its plain version (<= 1e-6) and against K1 (<= 1e-6) at the
   TPU's shape (ndir=9, 1280 rows, R=2, 4 rows x 35 wavelengths) and at
   the CLI block's (1 row, 3 wavelengths, the S=256 window, R from
   ``_zoom_row_splits``), beside the FMA body as in 3;
5. the same body at "high" (the default: 3-pass bf16) at the same four
   shapes against its 3-pass plain version (<= 2e-6 of max|U|), with its
   error against K1 at "highest", its time, TFLOP/s and bound;
6. K2 (convolution chain) against its plain version at 50 rows x 35
   planes of 40 x 40 (transform size 64); relative max-abs <= 1e-6; both
   and the cuFFT route against the float64 chain (printed); the time of
   K2 beside that of the cuFFT route, which the default ``use_fft=True``
   takes instead;
7. K5 (the diffraction-disc skip) and K6 (the anchored-Taylor damping) at
   both precisions on the full window (4 rows x 35 wavelengths x 9
   directions, (1280, 768)): K5 against its plain version (<= 1e-6 at
   "highest", <= 2e-6 at "high") and against K1 at its precision on the
   same inputs with the real block mask (<= 1e-6 of max|U|), K6 against
   its plain version (<= 1e-6 at "highest", <= 2e-6 of max|U| at "high"
   against the 3-pass plain version) and against K1 at "highest" (within
   ndir x the certified bound x max row-L1(A2) + 1e-5 of max|U|), with
   the times of each; K5 and K6 at "highest" beside the float32 FMA
   bodies (``tools/fma_bodies/``), distances and times in turns;
7a. K1/K3/K5 on the wgmma body against the mma.sync body it replaced
   (``tools/ab_zoom_tc.py``) at both precisions: the full-window chunk
   (at "highest" also the exact group's six-pass chunk), ndir 9, K3 at
   the TPU's and the CLI's shape (device times by CUDA-graph replay), K5
   and the three 2048^2 window shapes on 25 rows: each body's error
   against the plain version (the wgmma body held to 2e-6 / 1e-6), their
   distance, times in turns (old, new, new, old); and the one-launch bf16
   split of A2 (``csrc/zoom_dft.cu``) against ``split_bf16`` bit for bit;
8. the 1-direction bench night (100 rows x 35 wavelengths, 490-930 nm,
   chunk=50, FFT-free config, zoom_precision "high") through the auto
   planner: the plan equals ``tests/data/golden_plan_night100.json``,
   launch counts (three-pass launches only), finite and converged fits,
   five warmed nights and one warmed night with every row on the full
   window; the pinned row (1.0", 0.7, 25 m) against the float64 golden
   PSF (rms <= 1e-5); the CLI result block, exact, with K3 launched in
   it; then the same night, golden row and CLI block at "highest" (six-pass
   launches only; mean PSF within 1e-5 relative of the "high" night);
9. the 9-direction night (npsflin=3, 100 rows, chunk=44): the plan
   equals ``golden_plan_night100_npsflin3.json``, launch counts, fits,
   the mean PSF against the same night on the full window (relative
   max-abs <= 1e-5) and the per-row FWHM/beta (<= 1e-3 relative), guard
   trips, five warmed nights and one warmed full-window night; then the
   night at "highest" against the night at "high" (mean PSF <= 1e-5,
   FWHM/beta <= 1e-3);
10. the same night with ``disc_skip=True`` at each precision: K5 launched,
    mean PSF within 1e-6 relative of the exact night; five warmed nights
    at "high";
11. the same night with ``zoom_anchor="auto"``: the plan (which groups
    resolved to "on"), K6 launched with three passes only, mean PSF
    within 1e-5 relative and per-row FWHM/beta within 1e-3 of the exact
    night, 0 guard trips; five warmed nights; the golden row at npsflin=1
    with the anchor forced (rms <= 1e-5); then the anchored night at
    "highest", K6 with six passes only, against the exact night at
    "highest";
12. a forced redo: a pinned 128-px window too small for the ultra-weak
    damping row (0.2", 0.01, 30 m) at 930 nm trips the window guard, and
    the redone cube equals the full-window one to <= 2e-6 abs;
13. the default config (``GalacsiConfig()``: ``use_fft=True``, so the
    cuFFT route instead of K2): the 1-direction night again, the
    three-pass K1 launched and K2 not, mean PSF within 1e-5 relative and
    per-row FWHM/beta within 1e-3 of the FFT-free night's; the golden row
    (rms <= 1e-5); five warmed nights in turns with the FFT-free night;
    the same for the 9-direction night with three warmed nights of each;
14. ``compute_psf_from_sparta`` on the 100-row night written as a
    SPARTA_ATM_DATA file (laser 4 of a masked row carries an outlier L0,
    so the validation decides three-laser mode), 35 wavelengths, chunk
    50: the five HDUs, FIT_ROWS bookkeeping, the derived telemetry
    (<= 1e-12), the three-laser rows, PSF_MEAN against a direct
    ``process_batch`` on the same items (<= 1e-6 relative), FIT_MEAN as
    the host float64 refit, a bit-exact file round trip, K1 launched on
    "high" and K2 not; three warmed calls;
15. the CLI itself, ``muse_psfr_tpu_torch.cli.main`` on ``--values
    1,0.7,25`` in process (K3 launched at "high") and once as
    ``python3 -m muse_psfr_tpu_torch`` in a subprocess: the log file
    holds the exact block, the output file opens; ``--values 1,0.7,1000``
    exits with "No results";
16. the 32 x 32 x 1 ``condition_sweep`` (1024 rows x 35 wavelengths,
    chunk 64) with a checkpoint: shapes, every fit finite, the grid point
    nearest (1.0, 0.7) against a one-row ``compute_psf`` there (<= 1e-3
    relative), 1024 rows done in the sidecar, a ``resume=True`` call that
    launches nothing and returns the same arrays, the ``save_sweep`` round
    trip; wall time with and without the checkpoint, guard trips;
16a. the port's ``examples/full_night.py`` at its defaults (the synthetic
    100-row night, 35 wavelengths, the default config) as ``python3 -m
    muse_psfr_tpu_torch.examples.full_night`` in a fresh process in a
    temporary directory: exit 0, the ``wrote`` line, the five HDUs, and
    PSF_MEAN against a direct ``compute_psf_from_sparta`` on the same
    night in this process (<= 1e-6 relative); then its ``main`` in this
    process, counted (K1 "high" launched, K2 not) and timed warm;
16b. the port's ``examples/sensitivity_sweep.py`` at n = 16 (256 rows x 3
    wavelengths) the same way, its figure drawn where matplotlib is
    installed (else its compute step alone, and a line that says so):
    ``sweep.fits`` against a direct ``condition_sweep`` (<= 1e-6
    relative), a ``resume=True`` call over its finished checkpoint that
    launches nothing, its compute step in this process, counted and timed
    warm;
16c. the port laid out as ``pip install`` lays it out (the modules of
    ``pyproject.toml``'s package list and the files its package data
    matches) in a temporary directory outside the checkout: ``python3 -m
    muse_psfr_tpu_torch --values 1,0.7,25`` there in a fresh process
    (``PYTHONPATH`` that directory alone, ``XDG_CACHE_HOME`` a temporary
    directory) builds the kernels from the installed sources into the
    cache, not the checkout's ``build/``, and logs the exact block; a
    second run reuses the cache; the build time is the difference of the
    two walls;
17. K2 at ``conv_precision="high"`` (the wgmma tensor-core body,
    ``csrc/conv_dft_tc.cu``: every contraction of the chain as the 3-pass
    bf16 split) at 50 rows x 35 planes, L 64, against its plain version
    (<= 3e-5 of max|out|: two float32 orders of this arithmetic, which
    splits every intermediate anew, lie as far apart as each lies from
    float64, ~1e-5) and against the float64 chain (no further than 1.5x
    the plain version, rms and max), beside the float32 body's distance;
    bit-identical on a rerun; timed in turns with the mma.sync body it
    replaced (``tools/mma_sync_bodies/conv_dft_tc_mma.cu``, built apart:
    old, new, new, old; the new body must be the faster in every turn),
    then with the float32 body, beside the cuFFT route; its ptxas
    registers and spills (0 spills required);
18. the 1- and the 9-direction FFT-free nights at ``conv_precision=
    "high"``: only the tensor-core K2 launched, never the float32 one;
    mean PSF within 3e-5 (the tier's own distance from float64 at the
    kernel is ~1e-5 of max|out|, and the mean over rows does not average
    the shared intrinsic spectra's error away) and per-row FWHM/beta
    within 1e-3 of the same nights at "highest"; the golden row (rms <=
    1e-5) and the CLI block,
    exact; three warmed nights of each tier in turns;
19. the 1-direction night at ``matmul_precision="high"``, at the default
    config (``use_fft=True``) and FFT-free: the golden row (rms <= 1e-5),
    the distance from the night at "highest" (printed), three warmed
    nights of each tier in turns; "default" (one bf16 pass) once, its
    golden rms printed as a finding and held to nothing;
20. ``compat.py`` on the card in float64: ``simul_psd_wfm`` ->
    ``psf_muse`` -> ``convolve_final_psf`` -> ``fit_psf_cube`` at (1.0,
    0.7, 25), 500/700/900 nm gives the CLI block to two decimals and
    equals the same chain on ``device="cpu"`` to <= 1e-10 relative;
    ``psd_to_psf`` and ``dsp4muse`` (9 directions) likewise; no kernel is
    launched; wall time of each on the card (first call and again) and on
    the CPU;
21. the 1-direction FFT-free night (100 rows x 35 wavelengths, chunk 50,
    K1 "high") under meshes (``parallel/mesh.py``), each against the same
    night on one device (mean PSF <= 1e-6 and packed fits <= 1e-4
    absolute, the JAX package's mesh limits, but FWHM and beta <= 1e-3
    relative, as in 8-11, since the LM fit turns a batch size's float32
    noise into ~4e-4 on beta) with K1 and K2 launched on
    every shard: ``default_mesh()`` (every card, one shard each); two
    shards on ``cuda:0`` (``default_mesh(["cuda:0", "cuda:0"])``), also
    at the default config (K2 not launched) and for the 9-direction night
    of 9 (chunk 44: shards of 22 rows), the golden row (rms <=
    1e-5) and the forced redo of 12 over the mesh; walls of the
    single-device and the two-shard night in turns; a one-rank NCCL
    group (``init_multihost``: its gather runs once per chunk); two
    ranks on the one card through gloo (NCCL refuses two ranks on a
    device), ``python -m muse_psfr_tpu_torch.parallel.multihost_demo``,
    ranks equal bit for bit, launches per rank, warmed walls;
22. the chunk programs (``parallel/programs.py``: each chunk step and the
    mean refit captured as a CUDA graph at its second dispatch, replayed
    after; every earlier phase already ran through them) against the
    eager step (``_graphs=False``): the FFT-free 1-direction night, the
    same at the default config, at ``zoom_precision="highest"`` and at
    ``conv_precision="high"``, the 9-direction night, anchored and with
    the disc skip, and the 32 x 32 sweep's 1024 rows, each replayed
    (nothing captured in that night) and equal to its eager night bit
    for bit on the fits, the mean PSF and its fit, with the same launch
    counts; the 1-direction night on a grid shifted by 2 nm (the same
    plan, so the same programs, replayed with other wavelengths) against
    its eager night; the forced redo of 12 through ``reconstruct_batch``
    and ``process_batch``, three graph runs against one eager run; the
    1-direction night over two shards on ``cuda:0``; the chunk loop of
    the 1-direction night, replayed and eager, under
    ``torch.cuda.set_sync_debug_mode("error")``; warmed walls in turns
    (eager, graphs, graphs, eager; six of each: median, minimum, spread)
    of the 1- and 9-direction nights, the default-config night and the
    sweep's rows; host self time, device time and the device's idle
    share under ``torch.profiler`` for one night of each, replayed and
    eager, of the 1- and 9-direction nights, the anchored night and the
    sweep's rows; every program's
    capture time, ``max_memory_reserved`` before and after, replays and
    launches per replay;
23. the port's headline bench, ``bench_torch.py`` (the counterpart of
    ``bench.py``), as a fresh ``python3 bench_torch.py`` process at its
    defaults (the 100-row night at the default config, chunk 50, two
    warm-up nights, 4 x 3 timed nights) and at ``BENCH_ROWS=1000``,
    ``BENCH_BLOCKS=1``, ``BENCH_REPS=5`` (chunk 100): exit 0, every key
    of ``bench.py``'s line plus ``median_s``, ``times_s`` and
    ``launches_per_night``, ``rms_vs_f64_oracle`` <= 1e-5, ``row0_plan``
    the golden plans' group of row 0, ``device`` the card's nvidia-smi
    name, and one timed night's launches: K1 "high" as often as the
    golden plan of the night says (one a chunk, two in a group that
    splits the blue wavelengths off: 5 at 100 rows, 20 at 1000) and
    nothing else; both lines printed with the card, the 100-row bench's
    median over phase 22's replayed median of the same night, and that
    night profiled in process as in 22 (``tools/profile_bench.py``
    profiles it in a fresh process);
24. the 2048^2 grid (``GalacsiConfig(dim=2048)``, the JAX package's
    high-resolution mode): (a) K1 "high" on one full-window chunk of the
    2048 bench night's plan (25 rows x 35 wavelengths) at each window
    shape of that plan, 2048 x 1152, 1024 x 640 and 512 x 384, against its
    3-pass plain version (<= 2e-6 of max|U|), and K3 at the one-row call's
    blue segment (1 row x 21 wavelengths on 512 x 384, R=2) against its
    plain version and K1, each with its time, TFLOP/s, bound and the row
    splits the main path takes there; (b) the 1-direction bench night
    (chunk 25) at the default config and FFT-free: the plan equals
    ``golden_plan_night100_dim2048.json``, the launches equal what the
    plan says (three passes only; K2 once a chunk FFT-free), every chunk's
    window and shape printed, fits finite and converged, the mean PSF
    within 1e-5 relative and the per-row FWHM/beta within 1e-3 of the
    same night on the full window, guard trips, replayed bit-equal to
    eager, five warmed nights, the pinned row against
    ``golden_psf_35l_s1.0_gl0.7_l025_dim2048.npy`` (rms <= 1e-5), and the
    memory after the captures; (c) the 9-direction night (chunk 25,
    ``golden_plan_night100_dim2048_npsflin3.json``) once at the default
    config, checked the same way, with its memory; (d) ``compute_psf`` of
    the pinned row at 35 wavelengths: K3 launched, the golden cube (rms
    <= 1e-5), FWHM within 0.02 arcsec of the same call at dim 1280.  The
    programs of earlier phases are dropped first (``programs.clear()``),
    and again before (c);
25. the exact structure-function group (rows with L0 < 2.5 m, which the
    planner sends to ``simulate_psd`` over the full grid and
    ``dphi_base``; its zoom contracts at "highest", six passes, whatever
    ``zoom_precision`` says): (a) the bench night with L0 = 2.0 on rows 0,
    10, ..., 90 (chunk 50) at the default config and FFT-free: the plan
    equals ``golden_plan_night100_exact.json``, the exact group launches
    the six-pass K1 once on the full window (1280 x 768), the rest as
    the plan says, fits finite and converged, replayed bit-equal to
    eager, three warmed nights, the pinned row (1.0, 0.7, 2.0) against
    ``golden_psf_35l_s1.0_gl0.7_l02.0.npy`` (rms <= 1e-5), memory; (b)
    ``compute_psf`` at L0 = 2.0 on the 2048^2 grid: finite, FWHM within
    0.02 arcsec of dim 1280; (c) the 16 x 16 x 8 ``condition_sweep`` of
    ``benchmarks/run_all.py:113-127`` (2048 points x 35 wavelengths,
    chunk 64, the default config): launches as its plan says, every fit
    finite, the grid point (1.0, 0.7, 2.0) against a one-row
    ``compute_psf`` (<= 1e-3 relative), its rows replayed bit-equal to
    eager, its first and a warmed wall.  The 2048^2 programs are dropped
    first;
26. one JSON line of per-kernel results, each with its launches on the
    path that runs it (the FFT-free default nights for the three-pass
    launches and K2, the "highest" nights for the six-pass launches, the
    switch nights for K5 and K6, each at its night's precision, the
    ``conv_precision="high"`` night for K2's tensor-core body; every one
    must be > 0; ``user_layer_launches`` on K1 and K3 "high" and on both
    K2 bodies gives their counts on the paths of phases 13-16b, K2's all
    0; ``mesh_launches`` on K1 "high" and K2 their counts on the mesh
    nights of phase 21, per rank for the two ranks; ``bench_launches`` on
    K1 "high" its launches in one timed night of each bench of 23;
    ``exact_group_launches`` on K1 at "highest" its launches on the
    exact-row nights of 25a; the 2048^2 records of 24a their launches on
    the default-config night of 24b at their shape, K3's on the call of
    24d) and its bound (the larger of its bytes
    over 3.35 TB/s and its operations, each over its unit's peak: fp32
    FLOPs over 67 TFLOP/s, bf16 tensor-core FLOPs (three or six passes)
    over 989 TFLOP/s, exponentials over the SFU's 16 a clock per SM), from
    this run's shapes; ``fma_body_ms`` on the "highest" records is the FMA
    body's time in turns, ``mma_sync_body_ms`` on K2 high's and on every
    K1/K1'/K3/K5 record (``mma_sync_body_device_ms`` at the CLI shape) the
    mma.sync body's of 17 and 7a, ``ab_ms``/``ab_device_ms`` the wgmma
    body's in the same turns, ``mma_sync_body_apart`` the two bodies'
    distance; the card line, and the final status line
    ``{"ok": true, "device": {...}}``.

The default-config nights must launch neither K5 nor K6, and no night
may launch a kernel of the other precision, nor a K2 body of the other
``conv_precision``; the one exception is the exact group's K1, six
passes at any ``zoom_precision`` (25).

Imports nothing of JAX.
"""

import contextlib
import glob
import importlib.util
import json
import logging
import os
import shutil
import socket
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = os.path.dirname(os.path.abspath(__file__))
DATA = os.path.join(ROOT, "tests", "data")
GOLDEN = os.path.join(DATA, "golden_psf_35l_s1.0_gl0.7_l025.npy")
#: the same row on the 2048^2 grid, and at L0 = 2.0 m (the exact group)
#: on the default grid (``tools/make_golden_psf.py``)
GOLDEN_2048 = os.path.join(DATA,
                           "golden_psf_35l_s1.0_gl0.7_l025_dim2048.npy")
GOLDEN_EXACT = os.path.join(DATA, "golden_psf_35l_s1.0_gl0.7_l02.0.npy")
CLI_BLOCK = ("FWHM 0.85 0.73 0.62", "BETA 2.73 2.55 2.23")
CLI_LOG = ["-" * 68, "Sparta Seeing: 1.00 arcsec GL: 0.70 L0:25.00 m",
           "LBDA 5000 7000 9000", *CLI_BLOCK, "-" * 68]
RESULT_HDUS = ["PRIMARY", "SPARTA_ATM_DATA", "FIT_ROWS", "FIT_MEAN",
               "PSF_MEAN"]
LBDA = np.linspace(490, 930, 35)
TC_SRC = "muse_psfr_tpu_torch/csrc/zoom_dft_tc.cu"
ANCHOR_TC_SRC = "muse_psfr_tpu_torch/csrc/zoom_anchor_tc.cu"
JAX_ZOOM = "muse_psfr_tpu/ops/zoom_dft.py"
#: NVIDIA H100 SXM datasheet peaks: fp32 outside the tensor cores, dense
#: bf16 tensor cores, HBM3; and the SFU's exponentials, 16 a clock per SM
#: on 132 SMs at the 1.98 GHz boost clock
PEAK_FP32, PEAK_BF16, HBM = 67e12, 989e12, 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9
#: the launch counters of zoom_precision "highest" (six passes), which a
#: night at "high" must leave at 0
HIGHEST_ZOOM = ("zoom_dft", "zoom_dft_rowsplit", "zoom_dft_disc",
                "zoom_dft_anchor")
#: the float32 FMA body's distance from float64 on the worst row of the
#: full-window chunk, which "highest" must not exceed
FMA_F64_ERR = 6.663e-06


def card_line():
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


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


def graph_ms(torch, fn, reps):
    """Mean device time of ``fn`` [ms] with the host out of the way:
    ``reps`` calls captured in one CUDA graph and replayed.  For launches
    so small that :func:`cuda_ms` times the Python wrapper instead."""
    fn()
    torch.cuda.synchronize()
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(reps):
            fn()
    return cuda_ms(torch, graph.replay, 3) / reps


def in_turns(torch, old, new, reps, timer=cuda_ms):
    """Times [ms] of two bodies on the same inputs, taken in turns: old,
    new, new, old."""
    t = [timer(torch, fn, reps) for fn in (old, new, new, old)]
    return {"old": [t[0], t[3]], "new": [t[1], t[2]]}


def fma_bodies():
    """The float32 FMA bodies that ran "highest" before, built from
    ``tools/fma_bodies/`` (``tools/ab_zoom_highest.py``)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import ab_zoom_highest
    return ab_zoom_highest.FmaBodies()


def roofline(label, nbytes, fp32=0.0, tc=0.0, exps=0.0):
    """The least time the card could take for a kernel's work: the larger
    of its bytes (each input read once, each output written once) over
    the memory rate and its operations, each over the peak of the unit
    that runs them: float32 FLOPs on the CUDA cores, bf16 FLOPs (of every
    pass) on the tensor cores, exponentials on the SFU.  The units run
    side by side, so the slowest one bounds the operations."""
    t = {"fp32 cores": fp32 / PEAK_FP32 * 1e3,
         "bf16 tensor cores": tc / PEAK_BF16 * 1e3,
         "SFU exp": exps / PEAK_EXP * 1e3}
    t_ops, t_bytes = max(t.values()), nbytes / HBM * 1e3
    print(f"{label} bound: {fp32 / 1e9:.2f} GFLOP fp32, {tc / 1e9:.2f} "
          f"GFLOP bf16, {exps / 1e9:.4f} G exp, {nbytes / 1e9:.4f} GB; "
          + ", ".join(f"{k} {v:.4f} ms" for k, v in t.items())
          + f", bytes {t_bytes:.4f} ms")
    return {"bound_ms": max(t_ops, t_bytes),
            "bound_by": "operations" if t_ops >= t_bytes else "bytes",
            "library_ms": None}


def zoom_work(B, ndir, n, ncols, nl, m2, precision, elems=None):
    """:func:`roofline`'s work of K1/K3/K5 on ``elems`` live OTF elements
    (all n x ncols by default): per (row, wavelength, direction, element)
    an exponential and three float32 operations (the argument's product
    and sum, the direction sum), then the product with dl; the
    contraction as three ("high") or six ("highest") bf16 passes on the
    tensor cores."""
    elems = n * ncols if elems is None else elems
    contraction = 2.0 * B * nl * m2 * elems
    other = float(B * nl * elems * (3 * ndir + 1))
    work = dict(nbytes=4.0 * (B * ndir * elems + elems + nl * m2 * n + nl
                              + B * nl * ndir + B * nl * m2 * ncols),
                exps=float(B * nl * ndir * elems))
    passes = 3 if precision == "high" else 6
    return dict(work, fp32=other, tc=passes * contraction)


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


def worst_row_f64(torch, zoom_dft, args, exp2, bodies, label):
    """The outputs ``bodies`` {name: U} against float64 on the row where
    the first two differ most, each relative to that row's max|U|; the
    plain six-pass product on that row joins them as "six-pass plain"."""
    names = list(bodies)
    diff = (bodies[names[0]] - bodies[names[1]]).abs().amax(dim=(1, 2, 3))
    b = int(torch.argmax(diff))
    one = [x.double() for x in args]
    u64 = zoom_dft.fused_exp_zoom_reference(
        one[0][b:b + 1], *one[1:4], one[4][b:b + 1], exp2=exp2)[0]
    scale = float(torch.max(torch.abs(u64)))
    errs = {k: float(torch.max(torch.abs(u[b] - u64))) / scale
            for k, u in bodies.items()}
    print(f"{label} row {b} against float64, relative to its max|U|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    del one, u64
    return b, errs


def six_pass_plain_row(zoom_dft, args, exp2, b):
    """Row ``b`` of K1 with every 32-row step contracted by the plain
    six-pass product, summed over the steps as the kernel does."""
    g = zoom_dft.damped_otf(args[0][b:b + 1], args[1], args[3],
                            args[4][b:b + 1], exp2)
    u = None
    for k in range(0, g.shape[-2], zoom_dft.K_STEP):
        part = zoom_dft.six_pass_product(
            args[2][None, :, :, k:k + zoom_dft.K_STEP],
            g[:, :, k:k + zoom_dft.K_STEP])
        u = part if u is None else u + part
    return u


def check_zoom_kernel(torch, cfg, dev, rows, nrow, lb, npsflin=1,
                      row_splits=1, label="K1", old=None, f64=False,
                      device_times=False):
    """K1 (``row_splits=1``) or K3 against its plain version, and K3
    against K1, on the first ``nrow`` bench rows at ``cfg``'s window, at
    ``cfg.zoom_precision``: "highest" (six passes; limit 1e-6 of max|U|)
    or "high" (three; limit 2e-6 against the 3-pass plain version; its
    error against K1 at "highest" is printed).  With ``old`` (the float32
    FMA bodies) at "highest": the FMA body's distances and the two bodies'
    times in turns; with ``f64`` also both against float64 on their worst
    row (limit: the FMA body's 6.663e-06); with ``device_times`` also the
    two bodies' times by CUDA-graph replay, for a launch so small that
    the host sets the other times (``tools/ab_zoom_highest.py`` asks)."""
    from muse_psfr_tpu_torch.ops import zoom_dft
    args = zoom_operands(torch, cfg, dev, rows, nrow, lb, npsflin)
    base, a2 = args[0], args[2]
    prec = cfg.zoom_precision
    kw = dict(exp2=cfg.zoom_exp2, row_splits=row_splits, precision=prec)
    limit = 2e-6 if prec == "high" else 1e-6
    got = zoom_dft.fused_exp_zoom(*args, **kw)
    want = zoom_dft.fused_exp_zoom_reference(*args, **kw)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(torch, got, want)
    print(f"{label} fused_exp_zoom(row_splits={row_splits}, precision="
          f"{prec}): dphi {tuple(base.shape)} a2 {tuple(a2.shape)}; max abs "
          f"err {abs_err:.3e}, relative to max|U| {rel:.3e} (limit "
          f"{limit:g})")
    if not rel <= limit:
        raise RuntimeError(f"{label} disagrees with its plain version: "
                           f"{rel}")
    extra = {}
    if prec == "high":
        exact = zoom_dft.fused_exp_zoom(*args, exp2=cfg.zoom_exp2,
                                        row_splits=row_splits)
        torch.cuda.synchronize()
        err_x, rel_x = rel_err(torch, got, exact)
        print(f"{label} against K1 at highest (six passes): max abs "
              f"{err_x:.3e}, relative to max|U| {rel_x:.3e}")
        worst_row_f64(torch, zoom_dft, args, cfg.zoom_exp2,
                      {"high": got, "highest": exact}, label)
        del exact
    elif old is not None:
        fma = old.zoom(*args, exp2=cfg.zoom_exp2, row_splits=row_splits)
        torch.cuda.synchronize()
        _, rel_o = rel_err(torch, fma, want)
        _, rel_on = rel_err(torch, got, fma)
        print(f"{label} float32 FMA body: relative to max|U| {rel_o:.3e} from "
              f"the plain version, {rel_on:.3e} from the six-pass body")
        if f64:
            b, errs = worst_row_f64(
                torch, zoom_dft, args, cfg.zoom_exp2,
                {"highest": got, "FMA body": fma, "plain": want}, label)
            six = six_pass_plain_row(zoom_dft, args, cfg.zoom_exp2, b)
            scale = float(torch.max(torch.abs(six)))
            d6 = float(torch.max(torch.abs(got[b] - six[0]))) / scale
            dm = float(torch.max(torch.abs(got[b] - want[b]))) / scale
            print(f"{label} row {b}: the kernel lies {d6:.3e} of max|U| from "
                  f"the plain six-pass product per step, {dm:.3e} from the "
                  f"plain float32 matmul per step")
            if not errs["highest"] <= FMA_F64_ERR:
                raise RuntimeError(f"{label} at highest is farther from "
                                   f"float64 than the FMA body was: {errs}")
            extra["f64_rel_err"] = errs["highest"]
            del six
        del fma
    del want
    if row_splits > 1:
        k1 = zoom_dft.fused_exp_zoom(*args, exp2=cfg.zoom_exp2,
                                     precision=prec)
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

    def new():
        return zoom_dft.fused_exp_zoom(*args, **kw)

    if prec == "highest" and old is not None:
        def fma_body():
            return old.zoom(*args, exp2=cfg.zoom_exp2, row_splits=row_splits)

        turns = in_turns(torch, fma_body, new, reps)
        ms = turns["new"][0]
        extra["fma_body_ms"] = turns["old"][0]
        print(f"{label} times [ms] in turns: FMA body {turns['old'][0]:.4f}, "
              f"six-pass {turns['new'][0]:.4f}, six-pass "
              f"{turns['new'][1]:.4f}, FMA body {turns['old'][1]:.4f}")
        if ms < 0.2:
            print(f"{label}: a launch this small takes the host longer to "
                  "issue than the card to run, so these are the host's "
                  "times, and the FMA body is called without the wrapper's "
                  "checks; tools/ab_zoom_highest.py times the device alone")
        if device_times:
            dev_t = in_turns(torch, fma_body, new, reps, graph_ms)
            extra["device_ms"] = dev_t["new"][0]
            extra["fma_body_device_ms"] = dev_t["old"][0]
            print(f"{label} device times [ms] by CUDA-graph replay, in "
                  f"turns: FMA body {dev_t['old'][0]:.4f}, six-pass "
                  f"{dev_t['new'][0]:.4f}, six-pass {dev_t['new'][1]:.4f}, "
                  f"FMA body {dev_t['old'][1]:.4f}")
    else:
        ms = cuda_ms(torch, new, reps)
    plain_ms = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom_reference(
        *args, **kw), reps)
    flop = 2.0 * np.prod(a2.shape) * base.shape[-1] * base.shape[0]
    passes = 3 if prec == "high" else 6
    print(f"{label} time {ms:.4f} ms ({flop / ms / 1e9:.2f} TFLOP/s of "
          f"contraction, {passes * flop / ms / 1e9:.2f} TFLOP/s of bf16 "
          f"tensor-core work in {passes} passes), plain PyTorch "
          f"{plain_ms:.4f} ms")
    bound = roofline(label, **zoom_work(*base.shape, *a2.shape[:2], prec))
    print(f"{label} at {bound['bound_ms'] / ms:.1%} of its bound")
    del args, base, a2
    torch.cuda.empty_cache()
    return {"route": "cuda", "source": TC_SRC, "max_abs_err": abs_err,
            "ms": ms, "plain_ms": plain_ms, **bound, **extra}


def conv_inputs(torch, cfg, dev, rows, B=50):
    """K2's inputs at one production chunk (``B`` rows x 35 planes of
    random values), with the real tip-tilt and intrinsic Moffat kernels:
    the kernels' arguments, the spatial kernels and their spectra in
    float64."""
    from muse_psfr_tpu_torch.core.moffat import (moffat_fwhm_to_alpha,
                                                 moffat_kernel,
                                                 muse_intrinsic_psf)
    from muse_psfr_tpu_torch.otf.convolve import (_dft_spectra,
                                                  _same_fft_size,
                                                  tip_tilt_fwhm)
    n, nk, nl = cfg.dimpsf, cfg.dimpsf + 1, LBDA.size
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
    s64 = [x.contiguous() for k in (k_tt, k_i)
           for x in _dft_spectra(k.double(), L)]
    return (planes, gtt_r, gtt_i, gi_r, gi_i, nk), (k_tt, k_i), s64


def conv_chain_flop(B, nl, n, L):
    """FLOPs of K2's contractions (two 'same' convolutions per plane):
    per convolution the forward (2L x n)(n x n), four (L x n)(n x L), four
    (n x L)(L x L) and two (n x L)(L x n) products."""
    per_conv = 2.0 * (2 * L * n * n + 4 * L * L * n + 4 * n * L * L
                      + 2 * n * n * L)
    return 2 * B * nl * per_conv


def conv_chain_bytes(B, nl, n, L):
    """Planes in and out once, the spectra and the DFT pair once."""
    return 4.0 * (2 * B * nl * n * n + 2 * (B + nl) * L * L + 2 * L * L)


def check_conv_kernel(torch, cfg, dev, rows):
    """K2 vs its plain version at one production chunk (50 rows x 35
    planes), with the real tip-tilt and intrinsic Moffat spectra; both
    against the float64 chain; and the time of the cuFFT route that the
    default config (``use_fft=True``) takes instead of K2."""
    from muse_psfr_tpu_torch.ops import conv_dft
    from muse_psfr_tpu_torch.otf.convolve import _fft_convolve_same
    args, (k_tt, k_i), s64 = conv_inputs(torch, cfg, dev, rows)
    planes, nk = args[0], args[-1]
    B, nl, n, _ = planes.shape
    L = args[1].shape[-1]
    got = conv_dft.fused_conv_chain(*args)
    want = conv_dft.fused_conv_chain_reference(*args)
    torch.cuda.synchronize()
    abs_err, rel = rel_err(torch, got, want)
    print(f"K2 fused_conv_chain: planes {tuple(planes.shape)}, L={L}; max "
          f"abs err {abs_err:.3e}, relative {rel:.3e} (limit 1e-6)")
    if not rel <= 1e-6:
        raise RuntimeError(f"K2 disagrees with its plain version: {rel}")

    def fft_route():
        y = _fft_convolve_same(planes, k_tt[:, None], n, nk)
        return _fft_convolve_same(y, k_i[None], n, nk)

    # the chain in float64 (spectra from the float64 kernels)
    w64 = conv_dft.fused_conv_chain_reference(planes.double(), *s64, nk)
    errs = {name: rel_err(torch, y, w64)[1] for name, y in
            (("K2", got), ("plain", want), ("cuFFT route", fft_route()))}
    print("K2 against the float64 chain, relative max-abs: " + ", ".join(
        f"{k} {v:.3e}" for k, v in errs.items()))
    del w64, s64
    ms = cuda_ms(torch, lambda: conv_dft.fused_conv_chain(*args), 50)
    plain_ms = cuda_ms(torch,
                       lambda: conv_dft.fused_conv_chain_reference(*args), 50)
    fft_ms = cuda_ms(torch, fft_route, 50)
    ms2 = cuda_ms(torch, lambda: conv_dft.fused_conv_chain(*args), 50)
    print(f"K2 time {ms:.4f} ms (again after the others: {ms2:.4f} ms), "
          f"plain PyTorch {plain_ms:.4f} ms, the cuFFT route of use_fft=True "
          f"(_fft_convolve_same twice) {fft_ms:.4f} ms")
    # the contractions and ~8 operations per spectrum element
    flop = conv_chain_flop(B, nl, n, L) + 2.0 * B * nl * 8 * L * L
    bound = roofline("K2", conv_chain_bytes(B, nl, n, L), fp32=flop)
    print(f"K2 at {bound['bound_ms'] / ms:.1%} of its bound, "
          f"{flop / ms / 1e9:.2f} TFLOP/s")
    return {"name": "fused_conv_chain", "route": "cuda",
            "source": "muse_psfr_tpu_torch/csrc/conv_dft.cu",
            "replaces": "muse_psfr_tpu/ops/conv_dft.py:139",
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "fft_route_ms": fft_ms, "f64_rel_err": errs["K2"], **bound}


def check_disc_anchor_kernels(torch, cfg, dev, rows, old):
    """K5 and K6 on the full window (4 rows x 35 wavelengths x 9
    directions): each against its plain version, K5 against K1 and K6
    against K1 at "highest" on the same inputs, and the times of all
    three, at both precisions; at "highest" beside the float32 FMA bodies
    ``old``, distances and times in turns."""
    from muse_psfr_tpu_torch.ops import zoom_dft
    from muse_psfr_tpu_torch.otf.psf import (_anchor_lambda_chunk,
                                             _anchor_operands,
                                             _disc_block_mask, pupil_otf,
                                             zoom_anchor_bound)
    args = zoom_operands(torch, cfg, dev, rows, 4, LBDA, 3)
    base, dl, a2 = args[:3]
    B, ndir, n, ncols = base.shape
    nl, m2 = a2.shape[:2]
    exp2 = cfg.zoom_exp2
    k1 = zoom_dft.fused_exp_zoom(*args, exp2=exp2)

    mask = _disc_block_mask(cfg)
    got = zoom_dft.fused_exp_zoom_disc(*args, mask, exp2=exp2)
    want = zoom_dft.fused_exp_zoom_disc_reference(*args, mask, exp2=exp2)
    torch.cuda.synchronize()
    err5, rel5 = rel_err(torch, got, want)
    _, rel51 = rel_err(torch, got, k1)
    print(f"K5 fused_exp_zoom_disc: dphi {tuple(base.shape)}, "
          f"{int((mask == 0).sum())} of {mask.size} blocks dead; max abs err "
          f"{err5:.3e}, relative to max|U| {rel5:.3e} (limit 1e-6); against "
          f"K1 {rel51:.3e} (limit 1e-6)")
    if not (rel5 <= 1e-6 and rel51 <= 1e-6):
        raise RuntimeError(f"K5 disagrees: plain {rel5}, K1 {rel51}")
    live = torch.as_tensor(zoom_dft.disc_live_rows(mask, n, ncols),
                           device=dev)
    fma = old.zoom(*args, exp2=exp2, live=live)
    torch.cuda.synchronize()
    print(f"K5 float32 FMA body: relative to max|U| "
          f"{rel_err(torch, fma, want)[1]:.3e} from the plain version, "
          f"{rel_err(torch, got, fma)[1]:.3e} from the six-pass body")
    del got, want, fma

    high = dict(exp2=exp2, precision="high")
    k1h = zoom_dft.fused_exp_zoom(*args, **high)
    got = zoom_dft.fused_exp_zoom_disc(*args, mask, **high)
    want = zoom_dft.fused_exp_zoom_disc_reference(*args, mask, **high)
    torch.cuda.synchronize()
    err5h, rel5h = rel_err(torch, got, want)
    _, rel51h = rel_err(torch, got, k1h)
    _, rel5x = rel_err(torch, got, k1)
    print(f"K5 at high (tensor cores): max abs err {err5h:.3e}, relative "
          f"to max|U| {rel5h:.3e} (limit 2e-6); against K1 at high "
          f"{rel51h:.3e} (limit 1e-6); against K1 at highest "
          f"{rel5x:.3e}")
    if not (rel5h <= 2e-6 and rel51h <= 1e-6):
        raise RuntimeError(f"K5 at high disagrees: plain {rel5h}, K1 "
                           f"{rel51h}")
    del got, want, k1h

    c = cfg.dim // 2                       # full window: local centre
    k, deg = _anchor_lambda_chunk(cfg, nl), cfg.zoom_anchor_degree
    astar, coef = _anchor_operands(args[3], k, deg,
                                   ndir * float(pupil_otf(cfg)[c, c]))
    a6 = (base, dl, a2, base[:, :, c, c].contiguous(), astar, coef, k)
    bound = zoom_anchor_bound(LBDA, k, deg)
    row_l1 = float(torch.max(torch.sum(torch.abs(a2.double()), dim=2)))
    scale = float(torch.max(torch.abs(k1)))
    atol = ndir * bound * row_l1 + 1e-5 * scale
    err6 = {}
    for prec, limit in (("highest", 1e-6), ("high", 2e-6)):
        got = zoom_dft.fused_exp_zoom_anchor(*a6, precision=prec)
        want = zoom_dft.fused_exp_zoom_anchor_reference(*a6, precision=prec)
        torch.cuda.synchronize()
        err6[prec], rel6 = rel_err(torch, got, want)
        err61 = float(torch.max(torch.abs(got.double() - k1.double())))
        print(f"K6 fused_exp_zoom_anchor at {prec}: groups of {k}, degree "
              f"{deg}, certified bound {bound:.3e}; max abs err "
              f"{err6[prec]:.3e}, relative to max|U| {rel6:.3e} (limit "
              f"{limit:g}); against K1 at highest {err61:.3e} = "
              f"{err61 / scale:.3e} of max|U| (limit {atol:.3e})")
        if not (rel6 <= limit and err61 <= atol):
            raise RuntimeError(f"K6 at {prec} disagrees: plain {rel6}, K1 "
                               f"{err61}")
        if prec == "highest":
            fma = old.anchor(*a6)
            torch.cuda.synchronize()
            print(f"K6 float32 FMA body: relative to max|U| "
                  f"{rel_err(torch, fma, want)[1]:.3e} from the plain "
                  f"version, {rel_err(torch, got, fma)[1]:.3e} from the "
                  f"six-pass body")
            del fma
        del got, want
    del k1

    reps = 3
    ms1 = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom(*args, exp2=exp2),
                  reps)
    turns5 = in_turns(torch, lambda: old.zoom(*args, exp2=exp2, live=live),
                      lambda: zoom_dft.fused_exp_zoom_disc(
                          *args, mask, exp2=exp2), reps)
    turns6 = in_turns(torch, lambda: old.anchor(*a6),
                      lambda: zoom_dft.fused_exp_zoom_anchor(*a6), reps)
    ms5, ms6 = turns5["new"][0], turns6["new"][0]
    for name, t in (("K5", turns5), ("K6", turns6)):
        print(f"{name} at highest, times [ms] in turns: FMA body "
              f"{t['old'][0]:.4f}, six-pass {t['new'][0]:.4f}, six-pass "
              f"{t['new'][1]:.4f}, FMA body {t['old'][1]:.4f}")
    ms6h = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom_anchor(
        *a6, precision="high"), reps)
    plain5 = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom_disc_reference(
        *args, mask, exp2=exp2), reps)
    plain6 = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom_anchor_reference(
        *a6), reps)
    plain6h = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom_anchor_reference(
        *a6, precision="high"), reps)
    ms1h = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom(*args, **high),
                   reps)
    ms5h = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom_disc(
        *args, mask, **high), reps)
    plain5h = cuda_ms(torch, lambda: zoom_dft.fused_exp_zoom_disc_reference(
        *args, mask, **high), reps)
    print(f"same inputs: K1 {ms1:.4f} ms, K5 {ms5:.4f} ms (plain "
          f"{plain5:.4f}), K6 {ms6:.4f} ms (plain {plain6:.4f}); at high: "
          f"K1 {ms1h:.4f} ms, K5 {ms5h:.4f} ms (plain {plain5h:.4f}), K6 "
          f"{ms6h:.4f} ms (plain {plain6h:.4f})")
    live = live.cpu().numpy()
    elems = int(np.sum(live[:, 1] - live[:, 0])) * zoom_dft.N_TILE
    ng = astar.shape[0]
    deg1 = deg + 1
    k5 = dict(name="fused_exp_zoom_disc (K5, 6-pass bf16 tensor cores)",
              route="cuda", source=TC_SRC, replaces=f"{JAX_ZOOM}:341",
              max_abs_err=err5, ms=ms5, plain_ms=plain5,
              fma_body_ms=turns5["old"][0],
              **roofline("K5", **zoom_work(B, ndir, n, ncols, nl, m2,
                                           "highest", elems)))
    k5h = dict(name="fused_exp_zoom_disc@high (K5, 3-pass bf16 tensor "
               "cores)", route="cuda", source=TC_SRC,
               replaces=f"{JAX_ZOOM}:341", max_abs_err=err5h, ms=ms5h,
               plain_ms=plain5h,
               **roofline("K5 high", **zoom_work(B, ndir, n, ncols, nl, m2,
                                                 "high", elems)))
    # per group and direction one exponential and its power sums (deg1
    # products and sums, the shift), per wavelength deg1 products and sums;
    # the contraction as six ("highest") or three ("high") bf16 passes
    nbytes = 4.0 * (B * ndir * n * ncols + n * ncols + nl * m2 * n + B * ndir
                    + ng + nl * deg1 + B * nl * m2 * ncols)
    other = float(B * n * ncols * (ng * ndir * (2 * deg1 + 1)
                                   + nl * 2 * deg1))
    contraction = 2.0 * B * nl * m2 * n * ncols
    exps = float(B * n * ncols * ng * ndir)
    k6 = dict(name="fused_exp_zoom_anchor (K6 _kernel_anchor, 6-pass bf16 "
              "tensor cores)", route="cuda", source=ANCHOR_TC_SRC,
              replaces=f"{JAX_ZOOM}:206,179", max_abs_err=err6["highest"],
              ms=ms6, plain_ms=plain6, fma_body_ms=turns6["old"][0],
              **roofline("K6", nbytes, fp32=other, tc=6 * contraction,
                         exps=exps))
    k6h = dict(name="fused_exp_zoom_anchor@high (K6 _kernel_anchor, 3-pass "
               "bf16 tensor cores)", route="cuda", source=ANCHOR_TC_SRC,
               replaces=f"{JAX_ZOOM}:206,179", max_abs_err=err6["high"],
               ms=ms6h, plain_ms=plain6h,
               **roofline("K6 high", nbytes, fp32=other, tc=3 * contraction,
                          exps=exps))
    print(f"K6 at {k6['bound_ms'] / ms6:.1%} of its bound, K6 high at "
          f"{k6h['bound_ms'] / ms6h:.1%} of its bound")
    del args, a6, base, a2
    torch.cuda.empty_cache()
    return k5, k6, k5h, k6h


def no_disc_or_anchor(counts, label):
    if (counts["zoom_dft_disc"] or counts["zoom_dft_tc_disc"]
            or counts["zoom_dft_anchor"] or counts["zoom_dft_tc_anchor"]):
        raise RuntimeError(f"{label} launched K5 or K6: {counts}")


def only_its_precision(counts, precision, label):
    """A night at "high" makes three-pass launches (``zoom_dft_tc*``) and
    never a six-pass one (:data:`HIGHEST_ZOOM`); one at "highest" the
    other way round."""
    six = sum(counts[k] for k in HIGHEST_ZOOM)
    three = sum(v for k, v in counts.items() if k.startswith("zoom_dft_tc"))
    if (precision == "high" and six) or (precision == "highest" and three):
        raise RuntimeError(f"{label} at {precision} launched a kernel of "
                           f"the other precision: {counts}")


def only_its_conv_body(counts, precision, label):
    """An FFT-free night launches K2's float32 body (``conv_dft``) at
    conv_precision "highest" and its tensor-core body (``conv_dft_tc``)
    at "high", and never the other one."""
    ran, idle = (("conv_dft_tc", "conv_dft") if precision == "high"
                 else ("conv_dft", "conv_dft_tc"))
    if counts[ran] < 1 or counts[idle] != 0:
        raise RuntimeError(f"{label} at conv_precision={precision} must "
                           f"launch {ran} only: {counts}")


def plan_line(plan):
    """A plan's groups: window/blue sub-window (exact: the exact
    structure-function transform), rows, chunk sizes."""
    return "; ".join(
        f"{g.cfg.otf_support or 'full'}/{g.cfg.otf_blue}"
        f"{'' if g.cfg.use_dphi_split else ' exact'} x {len(g.rows)} rows "
        f"in {list(g.sizes)}" for g in plan.groups)


def check_plan(rows, night, golden):
    from muse_psfr_tpu_torch.parallel.batch import plan_batch
    kw = {k: night[k] for k in ("npsflin", "cfg", "chunk")}
    plan = plan_batch(*rows, LBDA, **kw)
    with open(os.path.join(DATA, golden)) as fh:
        if plan.summary() != json.load(fh):
            raise RuntimeError(f"the plan differs from {golden}")
    print(f"plan == {golden}: {plan_line(plan)}")


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
          f" s; median {dt:.4f} s, spread {max(walls) - min(walls):.4f} s, "
          f"{len(rows[0]) / dt:.2f} rows/s ({card})")
    return dt


def zoom_key(cfg, kind=""):
    """The launch counter of the zoom kernel at ``cfg.zoom_precision``:
    ``kind`` "" (K1), "_rowsplit" (K3), "_disc" (K5) or "_anchor" (K6)."""
    return ("zoom_dft_tc" if cfg.zoom_precision == "high"
            else "zoom_dft") + kind


def cli_block(cfg):
    """The CLI's result block (1.0", 0.7, 25 m at 500/700/900 nm), counted;
    it must be exact and run K3 at ``cfg.zoom_precision``."""
    from muse_psfr_tpu_torch.fit.moffat_fit import fit_moffat_cube_host64
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    lb3 = np.array([500.0, 700.0, 900.0])
    _build.reset_launch_counts()
    _, mean3, _ = process_batch([1.0], [0.7], [25.0], np.ones((1, 4)),
                                lbda=lb3, npsflin=1, cfg=cfg, chunk=1,
                                device="cuda")
    counts = _build.launch_counts()
    fm = fit_moffat_cube_host64(mean3)
    block = ("FWHM " + " ".join("%.2f" % v
                                for v in fm["fwhm"][:, 0] * cfg.pixscale),
             "BETA " + " ".join("%.2f" % v for v in fm["n"]))
    print(f"CLI block at zoom_precision={cfg.zoom_precision}:\n"
          "LBDA 5000 7000 9000\n" + "\n".join(block))
    print(f"CLI block launches {counts}")
    if block != CLI_BLOCK:
        raise RuntimeError(f"CLI block {block} != {CLI_BLOCK}")
    if counts[zoom_key(cfg, "_rowsplit")] < 1:
        raise RuntimeError(f"K3 never ran on the CLI block: {counts}")
    no_disc_or_anchor(counts, "the CLI block")
    only_its_precision(counts, cfg.zoom_precision, "the CLI block")
    if not cfg.use_fft:
        only_its_conv_body(counts, cfg.conv_precision, "the CLI block")
    return counts


def main_path(torch, cfg, rows, card):
    """The 1-direction bench night through the auto planner, counted;
    golden row; CLI block (counted).  Returns the counts of the night and
    of the CLI block, the night's arguments and its (mean PSF, unpacked
    fits)."""
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    night = dict(lbda=LBDA, npsflin=1, cfg=cfg, chunk=50, device="cuda")
    check_plan(rows, night, "golden_plan_night100.json")

    _build.reset_launch_counts()
    fit, psf_mean, fit_mean = process_batch(*rows, **night)
    counts = _build.launch_counts()
    print(f"1-direction night at zoom_precision={cfg.zoom_precision}: "
          f"process_batch on {len(rows[0])} rows x {LBDA.size} wavelengths, "
          f"launches {counts}")
    if counts[zoom_key(cfg)] < 1 or counts["conv_dft"] < 1:
        raise RuntimeError(f"a kernel of the night never ran: {counts}")
    no_disc_or_anchor(counts, "the 1-direction night")
    only_its_precision(counts, cfg.zoom_precision, "the 1-direction night")
    only_its_conv_body(counts, cfg.conv_precision, "the 1-direction night")
    unpacked = check_fits(fit, len(rows[0]), psf_mean, fit_mean)
    print(f"all {unpacked['ok'].size} plane fits finite and converged; "
          f"fwhm range {unpacked['fwhm'][..., 0].min() * cfg.pixscale:.3f}"
          f"-{unpacked['fwhm'][..., 0].max() * cfg.pixscale:.3f} arcsec")
    warmed_nights(process_batch, rows, night, card, "1-direction night")
    warmed_nights(process_batch, rows, dict(night, _force_full=True), card,
                  "1-direction night, full window", n=1)

    golden_rms(cfg, rows, "auto-planned")
    return counts, cli_block(cfg), night, (psf_mean, unpacked)


def highest_night(cfg, rows, card, high_mean):
    """The 1-direction night at zoom_precision="highest" (six passes),
    counted, against the same night at "high"; then the golden row and
    the CLI block at "highest"."""
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    night = dict(lbda=LBDA, npsflin=1, cfg=cfg, chunk=50, device="cuda")
    _build.reset_launch_counts()
    fit, psf_mean, fit_mean = process_batch(*rows, **night)
    counts = _build.launch_counts()
    rel = float(np.abs(high_mean - psf_mean).max() / np.abs(psf_mean).max())
    print(f"1-direction night at highest: launches {counts}; the night at "
          f"high departs by {rel:.3e} relative max-abs (limit 1e-5)")
    if counts["zoom_dft"] < 1:
        raise RuntimeError(f"no six-pass launch: {counts}")
    only_its_precision(counts, "highest", "the 1-direction night")
    check_fits(fit, len(rows[0]), psf_mean, fit_mean)
    if not rel <= 1e-5:
        raise RuntimeError(f"high and highest nights differ by {rel}")
    warmed_nights(process_batch, rows, night, card,
                  "1-direction night at highest", n=3)
    golden_rms(cfg, rows, "zoom_precision=highest")
    return counts, cli_block(cfg)


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
    print(f"9-direction night at zoom_precision={cfg.zoom_precision}: "
          f"process_batch on {len(rows[0])} rows x {LBDA.size} wavelengths, "
          f"launches {counts}; window-guard trips: {len(guard_log.trips)}")
    if counts[zoom_key(cfg)] < 1 or counts["conv_dft"] < 1:
        raise RuntimeError(f"a kernel of the night never ran: {counts}")
    no_disc_or_anchor(counts, "the 9-direction night")
    only_its_precision(counts, cfg.zoom_precision, "the 9-direction night")
    only_its_conv_body(counts, cfg.conv_precision, "the 9-direction night")
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
    return counts, night, (psf_mean, got)


def compare_nights(label, got_mean, got_fit, want_mean, want_fit,
                   psf_limit=1e-5):
    """Mean PSF relative max-abs <= ``psf_limit`` and per-row FWHM/beta
    <= 1e-3."""
    rel = float(np.abs(got_mean - want_mean).max() / np.abs(want_mean).max())
    rfw = np.abs(got_fit["fwhm"] - want_fit["fwhm"]) / np.abs(want_fit["fwhm"])
    rn = np.abs(got_fit["n"] - want_fit["n"]) / np.abs(want_fit["n"])
    print(f"{label}: mean PSF relative max-abs {rel:.3e} (limit "
          f"{psf_limit:.0e}); "
          f"per-row FWHM {float(rfw.max()):.3e}, beta {float(rn.max()):.3e} "
          f"relative (limit 1e-3; median {float(np.median(rfw)):.3e}, "
          f"{float(np.median(rn)):.3e})")
    if not (rel <= psf_limit and rfw.max() <= 1e-3 and rn.max() <= 1e-3):
        raise RuntimeError(f"{label}: the nights depart")
    return rel


def ndir9_highest(cfg, rows, card, high):
    """The 9-direction night at zoom_precision="highest" (six passes),
    counted, against the same night at "high"."""
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    night = dict(lbda=LBDA, npsflin=3, cfg=cfg, chunk=44, device="cuda")
    _build.reset_launch_counts()
    fit, psf_mean, fit_mean = process_batch(*rows, **night)
    counts = _build.launch_counts()
    print(f"9-direction night at highest: launches {counts}")
    if counts["zoom_dft"] < 1:
        raise RuntimeError(f"no six-pass launch: {counts}")
    no_disc_or_anchor(counts, "the 9-direction night at highest")
    only_its_precision(counts, "highest", "the 9-direction night")
    got = check_fits(fit, len(rows[0]), psf_mean, fit_mean)
    compare_nights("9-direction night at high against highest", high[0],
                   high[1], psf_mean, got)
    warmed_nights(process_batch, rows, night, card,
                  "9-direction night at highest", n=3)
    return counts, (psf_mean, got)


def disc_night(cfg, rows, card, exact, warm=5):
    """The 9-direction night with the disc skip on: K5 on the full-window
    chunks, at ``cfg.zoom_precision``, the mean PSF against
    the exact night's at the same precision."""
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    night = dict(lbda=LBDA, npsflin=3, cfg=cfg.with_(disc_skip=True),
                 chunk=44, device="cuda")
    check_plan(rows, night, "golden_plan_night100_npsflin3.json")
    _build.reset_launch_counts()
    fit, psf_mean, fit_mean = process_batch(*rows, **night)
    counts = _build.launch_counts()
    rel = float(np.abs(psf_mean - exact[0]).max() / np.abs(exact[0]).max())
    print(f"9-direction night, disc_skip=True, zoom_precision="
          f"{cfg.zoom_precision}: launches {counts}; mean PSF relative "
          f"max-abs {rel:.3e} from the exact night (limit 1e-6)")
    if (counts[zoom_key(cfg, "_disc")] < 1 or counts["zoom_dft_anchor"]
            or counts["zoom_dft_tc_anchor"]):
        raise RuntimeError(f"K5 did not run on the disc night: {counts}")
    only_its_precision(counts, cfg.zoom_precision, "the disc night")
    check_fits(fit, len(rows[0]), psf_mean, fit_mean)
    if not rel <= 1e-6:
        raise RuntimeError(f"the disc night departs from the exact: {rel}")
    if warm:
        warmed_nights(process_batch, rows, night, card,
                      "9-direction night, disc_skip=True", n=warm)
    return counts


def anchor_night(cfg, rows, card, guard_log, exact, warm=5, golden=True):
    """The 9-direction night with zoom_anchor="auto": the plan, K6 on the
    certified groups at ``cfg.zoom_precision`` only, the mean
    PSF and per-row fits against the exact night's at the same precision;
    then the golden row with the anchor forced."""
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import (plan_batch,
                                                    process_batch,
                                                    reconstruct_batch)
    night = dict(lbda=LBDA, npsflin=3, cfg=cfg.with_(zoom_anchor="auto"),
                 chunk=44, device="cuda")
    plan = plan_batch(*rows, **night)
    print("anchored plan: " + "; ".join(
        f"{g.cfg.otf_support or 'full'}/{g.cfg.otf_blue} zoom_anchor="
        f"{g.cfg.zoom_anchor} x {len(g.rows)} rows in {list(g.sizes)}"
        for g in plan.groups))
    if not any(g.cfg.zoom_anchor == "on" for g in plan.groups):
        raise RuntimeError("no group of the night certified the anchor")
    guard_log.trips.clear()
    _build.reset_launch_counts()
    fit, psf_mean, fit_mean = process_batch(*rows, **night)
    counts = _build.launch_counts()
    got = check_fits(fit, len(rows[0]), psf_mean, fit_mean)
    want = exact[1]
    rel = float(np.abs(psf_mean - exact[0]).max() / np.abs(exact[0]).max())
    rfw = np.abs(got["fwhm"] - want["fwhm"]) / np.abs(want["fwhm"])
    rn = np.abs(got["n"] - want["n"]) / np.abs(want["n"])
    dfw, dn = float(rfw.max()), float(rn.max())
    worst = np.unravel_index(np.argmax(rn), rn.shape)
    print(f"9-direction night, zoom_anchor=auto, zoom_precision="
          f"{cfg.zoom_precision}: launches {counts}; "
          f"window-guard trips: {len(guard_log.trips)}; mean PSF relative "
          f"max-abs {rel:.3e} from the exact night (limit 1e-5); per-row "
          f"FWHM {dfw:.3e}, beta {dn:.3e} relative (limit 1e-3; median "
          f"{float(np.median(rfw)):.3e}, {float(np.median(rn)):.3e}; worst "
          f"beta at row {worst[0]}, {LBDA[worst[1]]:.1f} nm: "
          f"{float(got['n'][worst]):.6f} vs {float(want['n'][worst]):.6f})")
    key = zoom_key(cfg, "_anchor")
    if counts[key] < 1 or counts["zoom_dft_disc"]:
        raise RuntimeError(f"K6 did not run on the anchored night: {counts}")
    only_its_precision(counts, cfg.zoom_precision, "the anchored night")
    if guard_log.trips:
        raise RuntimeError(f"guard trips on the anchored night: "
                           f"{guard_log.trips}")
    if not (rel <= 1e-5 and dfw <= 1e-3 and dn <= 1e-3):
        raise RuntimeError("the anchored night departs from the exact one")
    if warm:
        warmed_nights(process_batch, rows, night, card,
                      "9-direction night, zoom_anchor=auto", n=warm)
    if not golden:
        return counts
    _build.reset_launch_counts()
    cube = reconstruct_batch(*(a[:1] for a in rows), lbda=LBDA,
                             cfg=cfg.with_(zoom_anchor="on"), chunk=1,
                             device="cuda")[0]
    golden_counts = _build.launch_counts()
    rms = float(np.sqrt(np.mean((cube.astype(np.float64)
                                 - np.load(GOLDEN)) ** 2)))
    print(f"golden row (1.0, 0.7, 25), zoom_anchor=on at npsflin=1: rms "
          f"{rms:.3e} vs the float64 oracle (limit 1e-5); launches "
          f"{golden_counts}")
    if golden_counts[key] < 1 or not rms <= 1e-5:
        raise RuntimeError(f"anchored golden row: rms {rms}, launches "
                           f"{golden_counts}")
    return counts


def forced_redo(cfg, guard_log, mesh=None, label=""):
    """A pinned too-small window must trip the guard and be redone (under
    ``mesh``: the redo too)."""
    from muse_psfr_tpu_torch.parallel.batch import reconstruct_batch
    tel = ([0.2], [0.01], [30.0], np.ones((1, 4)))
    guard_log.trips.clear()
    got = reconstruct_batch(*tel, [930.0], cfg=cfg.with_(otf_support=128),
                            chunk=1, device="cuda", mesh=mesh)
    trips = list(guard_log.trips)
    full = reconstruct_batch(*tel, [930.0], cfg=cfg, chunk=1, device="cuda",
                             _force_full=True)
    err = float(np.abs(got - full).max())
    print(f"forced redo{label} (0.2, 0.01, 30) at 930 nm, otf_support=128: "
          f"{trips}; max abs vs the full window {err:.3e} (limit 2e-6)")
    if not trips:
        raise RuntimeError("the pinned too-small window did not trip")
    if not err <= 2e-6:
        raise RuntimeError(f"the redone cube is off by {err}")


def golden_rms(cfg, rows, label, mesh=None, golden=GOLDEN):
    """The pinned row (row 0 of ``rows``) through ``reconstruct_batch`` at
    ``cfg`` (over ``mesh``) against the float64 oracle cube ``golden``."""
    from muse_psfr_tpu_torch.parallel.batch import reconstruct_batch
    cube = reconstruct_batch(*(a[:1] for a in rows), lbda=LBDA, cfg=cfg,
                             chunk=1, device="cuda", mesh=mesh)[0]
    rms = float(np.sqrt(np.mean((cube.astype(np.float64)
                                 - np.load(golden)) ** 2)))
    print(f"golden row ({rows[0][0]:g}, {rows[1][0]:g}, {rows[2][0]:g}), "
          f"{label}: rms {rms:.3e} vs the float64 oracle "
          f"{os.path.basename(golden)} (limit 1e-5)")
    if not rms <= 1e-5:
        raise RuntimeError(f"golden rms {rms} over the 1e-5 budget")


def default_config_night(cfg, rows, card, guard_log, fft_free, exact,
                         label, golden, warm):
    """The night ``fft_free`` (``process_batch`` arguments at
    ``use_fft=False``) again at ``cfg``, the default config a user gets
    (``use_fft=True``: the cuFFT route, K2 never launched), counted,
    against the FFT-free night's ``exact`` (mean PSF, unpacked fits); then
    ``warm`` warmed nights of each, in turns."""
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    if not cfg.use_fft or fft_free["cfg"].use_fft:
        raise RuntimeError("the default config must take the FFT route")
    night = dict(fft_free, cfg=cfg)
    check_plan(rows, night, golden)
    guard_log.trips.clear()
    _build.reset_launch_counts()
    fit, psf_mean, fit_mean = process_batch(*rows, **night)
    counts = _build.launch_counts()
    print(f"{label} at the default config (use_fft=True, zoom_precision="
          f"{cfg.zoom_precision}): launches {counts}; window-guard trips: "
          f"{len(guard_log.trips)}")
    if (counts["zoom_dft_tc"] < 1 or counts["conv_dft"] != 0
            or counts["conv_dft_tc"] != 0):
        raise RuntimeError(f"{label}: K1 must run at high and "
                           f"K2 not at all: {counts}")
    no_disc_or_anchor(counts, label)
    only_its_precision(counts, cfg.zoom_precision, label)
    got = check_fits(fit, len(rows[0]), psf_mean, fit_mean)
    if psf_mean.dtype != np.float32:
        raise RuntimeError(f"the FFT route left float32: {psf_mean.dtype}")
    compare_nights(f"{label}, default config against FFT-free", psf_mean,
                   got, *exact)
    nights_in_turns(rows, {"use_fft=True": night, "use_fft=False": fft_free},
                    warm, card, label)
    return counts


def mma_sync_body():
    """The mma.sync body of K2 at "high" that the wgmma body replaced,
    built from ``tools/mma_sync_bodies/`` (``tools/ab_conv_chain.py``)."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import ab_conv_chain
    return ab_conv_chain.MmaSyncBody()


def split_check(torch, dev):
    """The one-launch split of A2 (``csrc/zoom_dft.cu:split_bf16``)
    against ``ops/zoom_dft.py:split_bf16`` bit for bit, with infinities,
    subnormals and a padded row."""
    from muse_psfr_tpu_torch.ops import zoom_dft
    g = torch.Generator(device="cpu").manual_seed(5)
    x = (torch.randn((3, 40, 101), generator=g)
         * torch.exp(20 * torch.randn((3, 40, 101), generator=g)))
    x[0, 0, :3] = torch.tensor([float("inf"), -float("inf"), 1e-40])
    x = x.to(dev)
    for parts in (2, 3):
        got = zoom_dft._a2_parts(x, parts, 104)
        want = zoom_dft.split_bf16(torch.nn.functional.pad(x, (0, 3)), parts)
        same = all(torch.equal(a.view(torch.int16),
                               b.contiguous().view(torch.int16))
                   for a, b in zip(got, want))
        print(f"split of A2 into {parts} bf16 parts, one launch, against "
              f"split_bf16: bit for bit {same}")
        if not same:
            raise RuntimeError(f"the split kernel ({parts} parts) differs "
                               "from split_bf16")


def zoom_ab_phase(torch, dev, rows, build):
    """Phase 7a: K1/K3/K5 on the wgmma body against the mma.sync body it
    replaced (``tools/mma_sync_bodies/zoom_dft_tc_mma.cu``, whose ``nvcc``
    ``build`` ran beside the package's), at every shape of
    ``tools/ab_zoom_tc.py`` and both precisions: errors against the plain
    version, the bodies' distance, times in turns; and the split of A2.
    Returns {key: {precision: record}}."""
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import ab_zoom_tc
    split_check(torch, dev)
    t0 = time.perf_counter()
    old = ab_zoom_tc.MmaSyncZoom(build)
    print(f"the mma.sync body of K1/K3/K5 of tools/mma_sync_bodies/ ready "
          f"after {time.perf_counter() - t0:.1f} s more (the yardstick of "
          f"the wgmma body; the package never launches it)")
    return ab_zoom_tc.run(torch, dev, rows, old)


def with_ab(rec, ab):
    """``rec`` with the A/B record ``ab``: the mma.sync body's time in
    turns (and the wgmma body's beside it, by CUDA-graph replay at the
    CLI shape), their distance."""
    key = "device_ms" if ab["device_times"] else "ms"
    rec["mma_sync_body_" + key] = min(ab["mma_sync_ms"])
    rec["ab_" + key] = min(ab["ms"])
    rec["mma_sync_body_apart"] = ab["apart"]
    return rec


def ptxas_report(entry):
    """Registers and spills of the build's kernels whose name holds
    ``entry``, from the ptxas report of ``_build.BUILD_LOG``."""
    from muse_psfr_tpu_torch.ops import _build
    lines = _build.BUILD_LOG.splitlines()
    out = []
    for i, line in enumerate(lines):
        if "Compiling entry function" in line and entry in line:
            tail = [x.strip() for x in lines[i + 1:i + 4]]
            out.append(" ".join(x for x in tail
                                if "spill" in x or "registers" in x))
    return out


def check_conv_high_kernel(torch, cfg, dev, rows, old):
    """K2 at conv_precision "high" (the wgmma tensor-core body) at one
    production chunk, with the real Moffat spectra: against its plain
    version and the float64 chain, beside the float32 body; times in turns
    with the mma.sync body it replaced (``old``), beside the float32 body
    and the cuFFT route; its registers and spills."""
    from muse_psfr_tpu_torch.ops import _build, conv_dft
    from muse_psfr_tpu_torch.otf.convolve import _fft_convolve_same
    args, (k_tt, k_i), s64 = conv_inputs(torch, cfg, dev, rows)
    planes, nk = args[0], args[-1]
    B, nl, n, _ = planes.shape
    L = args[1].shape[-1]
    before = _build.launch_counts()
    bodies = {
        "K2 high": conv_dft.fused_conv_chain(*args, precision="high"),
        "plain high": conv_dft.fused_conv_chain_reference(
            *args, precision="high"),
        "K2 highest": conv_dft.fused_conv_chain(*args),
        "plain highest": conv_dft.fused_conv_chain_reference(*args)}
    torch.cuda.synchronize()
    after = _build.launch_counts()
    if after != dict(before, conv_dft=before["conv_dft"] + 1,
                     conv_dft_tc=before["conv_dft_tc"] + 1):
        raise RuntimeError(f"K2's bodies count on the wrong counters: "
                           f"{before} -> {after}")
    abs_err, rel = rel_err(torch, bodies["K2 high"], bodies["plain high"])
    print(f"K2 high fused_conv_chain(precision=\"high\"): planes "
          f"{tuple(planes.shape)}, L={L}; max abs err {abs_err:.3e}, "
          f"relative {rel:.3e} from the plain 3-pass version (limit 3e-5)")
    w64 = conv_dft.fused_conv_chain_reference(planes.double(), *s64, nk)
    scale = float(w64.abs().max())
    emax = {k: rel_err(torch, v, w64)[1] for k, v in bodies.items()}
    erms = {k: float((v.double() - w64).pow(2).mean().sqrt()) / scale
            for k, v in bodies.items()}
    print("K2 high against the float64 chain, relative max-abs: "
          + ", ".join(f"{k} {v:.3e}" for k, v in emax.items()))
    print("K2 high against the float64 chain, rms over max|out|: "
          + ", ".join(f"{k} {v:.3e}" for k, v in erms.items()))
    again = conv_dft.fused_conv_chain(*args, precision="high")
    same = bool(torch.equal(again, bodies["K2 high"]))
    print(f"K2 high rerun bit-identical: {same}")
    if not rel <= 3e-5:
        raise RuntimeError(f"K2 high disagrees with its plain version: {rel}")
    if not (emax["K2 high"] <= 1.5 * emax["plain high"]
            and erms["K2 high"] <= 1.5 * erms["plain high"] and same):
        raise RuntimeError(f"K2 high lies further from float64 than its "
                           f"plain version: {emax}, {erms}")
    del w64, s64, again

    def fft_route():
        y = _fft_convolve_same(planes, k_tt[:, None], n, nk)
        return _fft_convolve_same(y, k_i[None], n, nk)

    old_out = old(*args)
    torch.cuda.synchronize()
    print(f"K2 high mma.sync body (tools/mma_sync_bodies/): relative max-abs "
          f"{rel_err(torch, old_out, bodies['plain high'])[1]:.3e} from the "
          f"plain version, {rel_err(torch, old_out, bodies['K2 high'])[1]:.3e}"
          f" from the wgmma body (bit-identical: "
          f"{bool(torch.equal(old_out, bodies['K2 high']))})")
    del old_out

    def new():
        return conv_dft.fused_conv_chain(*args, precision="high")

    turns = in_turns(torch, lambda: old(*args), new, 50)
    f32 = in_turns(torch, lambda: conv_dft.fused_conv_chain(*args), new, 50)
    fft_ms = cuda_ms(torch, fft_route, 50)
    plain_ms = cuda_ms(torch, lambda: conv_dft.fused_conv_chain_reference(
        *args, precision="high"), 10)
    ms = min(turns["new"] + f32["new"])
    print(f"K2 high times [ms] in turns: mma.sync body {turns['old'][0]:.4f}"
          f", wgmma body {turns['new'][0]:.4f}, wgmma body "
          f"{turns['new'][1]:.4f}, mma.sync body {turns['old'][1]:.4f}; then "
          f"float32 body {f32['old'][0]:.4f}, wgmma body {f32['new'][0]:.4f},"
          f" wgmma body {f32['new'][1]:.4f}, float32 body "
          f"{f32['old'][1]:.4f}; the cuFFT route {fft_ms:.4f}; plain 3-pass "
          f"PyTorch {plain_ms:.4f}")
    ptxas = ptxas_report("fused_conv_chain_tc_kernel")
    print("K2 high ptxas (one instantiation per plane side / 16): "
          + "; ".join(ptxas))
    if not max(turns["new"]) < min(turns["old"]):
        raise RuntimeError(f"the wgmma body is not faster than the mma.sync "
                           f"body in turns: {turns}")
    if not ptxas:
        raise RuntimeError("no ptxas report of K2 high in the build log")
    if any(" 0 bytes spill stores" not in x for x in ptxas):
        raise RuntimeError(f"K2 high spills registers: {ptxas}")
    # the contractions in three bf16 passes on the tensor cores; the
    # spectrum product, the sums of two products and the splits (~8 + ~6
    # operations per element of every stage) in float32
    stage_elems = 2 * L * n + 2 * L * L + 2 * n * L + n * n
    fp32 = 2.0 * B * nl * (8 * L * L + 6 * stage_elems)
    tc = 3 * conv_chain_flop(B, nl, n, L)
    bound = roofline("K2 high", conv_chain_bytes(B, nl, n, L), fp32=fp32,
                     tc=tc)
    print(f"K2 high at {bound['bound_ms'] / ms:.1%} of its bound, "
          f"{tc / ms / 1e9:.2f} TFLOP/s bf16")
    return {"name": "fused_conv_chain@high (K2 _kernel/_conv_pack, 3-pass "
            "bf16 tensor cores)", "route": "cuda",
            "source": "muse_psfr_tpu_torch/csrc/conv_dft_tc.cu",
            "replaces": "muse_psfr_tpu/ops/conv_dft.py:139",
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "mma_sync_body_ms": min(turns["old"]),
            "float32_body_ms": min(f32["old"]), "fft_route_ms": fft_ms,
            "f64_rel_err": emax["K2 high"], "f64_rms": erms["K2 high"],
            "ptxas": ptxas, **bound}


def nights_in_turns(rows, nights, warm, card, label):
    """``warm`` warmed nights of each of ``nights`` {name: process_batch
    arguments}, taken in turns; the medians [s]."""
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    walls = {k: [] for k in nights}
    for _ in range(warm):
        for key, kw in nights.items():
            t0 = time.perf_counter()
            process_batch(*rows, **kw)
            walls[key].append(time.perf_counter() - t0)
    print(f"{label} warmed x{warm} in turns: " + "; ".join(
        f"{k} wall {' '.join(f'{t:.4f}' for t in v)} s, median "
        f"{float(np.median(v)):.4f} s, "
        f"{len(rows[0]) / float(np.median(v)):.2f} rows/s"
        for k, v in walls.items()) + f" ({card})")
    return {k: float(np.median(v)) for k, v in walls.items()}


def conv_high_nights(cfg, rows, card, night, night9, exact1, exact9):
    """The FFT-free nights at conv_precision="high": only K2's tensor-core
    body runs; against the same nights at "highest"; golden row; CLI
    block; warmed nights of both tiers in turns."""
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    high = cfg.with_(conv_precision="high")
    out = {}
    for label, base, exact in (("1-direction night", night, exact1),
                               ("9-direction night", night9, exact9)):
        kw = dict(base, cfg=high)
        _build.reset_launch_counts()
        fit, psf_mean, fit_mean = process_batch(*rows, **kw)
        counts = _build.launch_counts()
        print(f"{label} at conv_precision=high: launches {counts}")
        only_its_conv_body(counts, "high", label)
        only_its_precision(counts, cfg.zoom_precision, label)
        no_disc_or_anchor(counts, label)
        got = check_fits(fit, len(rows[0]), psf_mean, fit_mean)
        # the tier itself lies ~1e-5 of max|out| from float64 at the
        # kernel (phase 17), and the intrinsic spectra's split errors are
        # the same in every row, so the mean does not average them away:
        # the night is held to 3e-5, not to the 1e-5 of the other nights
        compare_nights(f"{label}, conv_precision high against highest",
                       psf_mean, got, *exact, psf_limit=3e-5)
        nights_in_turns(rows, {"conv_precision=highest": base,
                               "conv_precision=high": kw}, 3, card, label)
        out[label] = counts
    golden_rms(high, rows, "conv_precision=high")
    out["cli"] = cli_block(high)
    return out


def matmul_tier_nights(cfg, user_cfg, rows, card, night):
    """The 1-direction night at matmul_precision="high", at the default
    config and FFT-free: golden row, distance from the night at "highest",
    warmed nights in turns; "default" once, as a finding."""
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    for label, base in (("default config (use_fft=True)", user_cfg),
                        ("FFT-free", cfg)):
        top = dict(night, cfg=base)
        kw = dict(night, cfg=base.with_(matmul_precision="high"))
        want = process_batch(*rows, **top)
        _build.reset_launch_counts()
        fit, psf_mean, fit_mean = process_batch(*rows, **kw)
        counts = _build.launch_counts()
        got = check_fits(fit, len(rows[0]), psf_mean, fit_mean)
        from muse_psfr_tpu_torch.fit.moffat_fit import unpack_fit
        ref = unpack_fit(want[0])
        rel = float(np.abs(psf_mean - want[1]).max() / np.abs(want[1]).max())
        rfw = np.abs(got["fwhm"] - ref["fwhm"]) / np.abs(ref["fwhm"])
        rn = np.abs(got["n"] - ref["n"]) / np.abs(ref["n"])
        print(f"1-direction night, {label}, matmul_precision=high: launches "
              f"{counts}; from the night at highest: mean PSF relative "
              f"max-abs {rel:.3e}, per-row FWHM {float(rfw.max()):.3e}, beta "
              f"{float(rn.max()):.3e} relative (printed, no limit)")
        if counts["zoom_dft_tc"] < 1:
            raise RuntimeError(f"K1 never ran: {counts}")
        golden_rms(kw["cfg"], rows, f"{label}, matmul_precision=high")
        nights_in_turns(rows, {"matmul_precision=highest": top,
                               "matmul_precision=high": kw}, 3, card,
                        f"1-direction night, {label}")
    from muse_psfr_tpu_torch.parallel.batch import reconstruct_batch
    one = user_cfg.with_(matmul_precision="default")
    cube = reconstruct_batch(*(a[:1] for a in rows), lbda=LBDA, cfg=one,
                             chunk=1, device="cuda")[0]
    rms = float(np.sqrt(np.mean((cube.astype(np.float64)
                                 - np.load(GOLDEN)) ** 2)))
    print(f"golden row (1.0, 0.7, 25), default config, matmul_precision="
          f"default (one bf16 pass): rms {rms:.3e} vs the float64 oracle (a "
          f"finding: this tier is documented as outside the 1e-5 budget and "
          f"is held to nothing); finite: {bool(np.isfinite(cube).all())}")
    if not np.isfinite(cube).all():
        raise RuntimeError("matmul_precision=default gave non-finite values")


def compat_path(card):
    """``compat.py`` (the reference's names) in float64 on the card and on
    the CPU: the documented chain to the CLI block, ``psd_to_psf``,
    ``dsp4muse``; card against CPU <= 1e-10 relative; no kernel launched."""
    import muse_psfr_tpu_torch.compat as mp
    from muse_psfr_tpu_torch.ops import _build
    lb3 = np.array([500.0, 700.0, 900.0])
    pup = np.asarray(mp.pupil_mask(320, 640, oc=0.14), float)
    poslgs = np.array([[1, 1], [-1, -1], [-1, 1], [1, -1]], float).T * 63
    r0ref = float(mp.seeing2r01(1.0, 0.5, 0))

    def chain(device):
        t, out = {}, {}
        t0 = time.perf_counter()
        out["psd"] = mp.simul_psd_wfm([0.7, 0.3], (100, 10000), 1.0, 25.0,
                                      npsflin=1, dim=1280, verbose=False,
                                      device=device)
        t["simul_psd_wfm"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["cube"] = mp.psf_muse(out["psd"], lb3, device=device)
        t["psf_muse"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["final"] = mp.convolve_final_psf(lb3, 1.0, 0.7, 25.0,
                                             out["cube"], device=device)
        t["convolve_final_psf"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        tbl = mp.fit_psf_cube(lb3, out["final"], device=device)
        t["fit_psf_cube"] = time.perf_counter() - t0
        out["fwhm"] = np.asarray(tbl["fwhm"], float)
        out["beta"] = np.asarray(tbl["n"], float)
        t0 = time.perf_counter()
        out["psd_to_psf"] = mp.psd_to_psf(out["psd"][0], pup, 8.0, 500e-9,
                                          samp=2, device=device)
        t["psd_to_psf"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["dsp4muse"] = mp.dsp4muse(
            8.0, 40, 80, np.array([0.7, 0.3]), np.array([100.0, 10000.0]),
            25.0, r0ref, 1, 1.0, np.full(2, 12.0),
            np.array([0.628163, -0.326497]), "LSE", 24.0, 24.0, 1000.0, 2.5,
            1.0, 0.5, poslgs, mp.direction_perf(3), device=device)
        t["dsp4muse"] = time.perf_counter() - t0
        return out, t

    _build.reset_launch_counts()
    card_out, t_first = chain("cuda")
    _, t_again = chain("cuda")
    counts = _build.launch_counts()
    cpu_out, t_cpu = chain("cpu")
    block = ("FWHM " + " ".join("%.2f" % v for v in card_out["fwhm"][:, 0]),
             "BETA " + " ".join("%.2f" % v for v in card_out["beta"]))
    print("compat chain on the card (float64): simul_psd_wfm -> psf_muse -> "
          "convolve_final_psf -> fit_psf_cube\nLBDA 5000 7000 9000\n"
          + "\n".join(block))
    if block != CLI_BLOCK:
        raise RuntimeError(f"compat block {block} != {CLI_BLOCK}")
    if any(counts.values()):
        raise RuntimeError(f"compat launched a kernel: {counts}")
    rel = {}
    for k, want in cpu_out.items():
        got = card_out[k]
        if got.dtype != np.float64 or got.shape != want.shape:
            raise RuntimeError(f"compat {k}: {got.dtype} {got.shape}")
        rel[k] = float(np.abs(got - want).max() / np.abs(want).max())
    print("compat card against CPU, relative max-abs (limit 1e-10): "
          + ", ".join(f"{k} {v:.3e}" for k, v in rel.items())
          + f"; launches {counts}")
    if not all(v <= 1e-10 for v in rel.values()):
        raise RuntimeError(f"compat on the card departs from the CPU: {rel}")
    print(f"compat wall [s] ({card}; CPU: the host's cores): "
          + "; ".join(f"{k} card first {t_first[k]:.4f}, again "
                      f"{t_again[k]:.4f}, CPU {t_cpu[k]:.4f}"
                      for k in t_first))
    return counts


def sparta_table(fits, rows):
    """The night's telemetry as a SPARTA_ATM_DATA table: every laser of a
    row carries the row's values, and laser 4 of a row whose mask drops
    it carries an outlier L0 of 150 m (as ``create_sparta_table(
    bad_l0=True)`` does), so the validation decides three-laser mode."""
    seeing, GL, L0, mask = rows
    names = [f"LGS{k}_{col}" for k in range(1, 5)
             for col in ("SEEING", "TUR_GND", "L0")]
    arr = np.empty(len(seeing), dtype=np.dtype([(n, "f8") for n in names]))
    for k in range(1, 5):
        arr[f"LGS{k}_SEEING"] = seeing
        arr[f"LGS{k}_TUR_GND"] = GL
        arr[f"LGS{k}_L0"] = L0
    arr["LGS4_L0"][mask[:, 3] == 0.0] = 150.0
    return fits.BinTableHDU(data=arr, name="SPARTA_ATM_DATA")


class ApiLog(logging.Handler):
    """Collects the API's INFO lines while the package's own stream
    handler is held at WARNING (a 100-row file logs some 200 lines)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.lines = []

    def emit(self, record):
        self.lines.append(record.getMessage())

    def __enter__(self):
        self.stream = logging.getLogger("muse_psfr").handlers[0]
        self.level = self.stream.level
        self.stream.setLevel(logging.WARNING)
        logging.getLogger("muse_psfr.api").addHandler(self)
        return self

    def __exit__(self, *exc):
        logging.getLogger("muse_psfr.api").removeHandler(self)
        self.stream.setLevel(self.level)


def same_table(a, b):
    return (a.dtype == b.dtype and len(a) == len(b)
            and all(a[k].tobytes() == b[k].tobytes() for k in a.dtype.names))


def sparta_file_path(cfg, rows, card, tmp):
    """``compute_psf_from_sparta`` on the 100-row night written as a
    SPARTA file, at the default config on the card, counted."""
    from muse_psfr_tpu_torch import compute_psf_from_sparta
    from muse_psfr_tpu_torch.fit.moffat_fit import fit_moffat_cube_host64
    from muse_psfr_tpu_torch.io import fits
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    seeing, GL, L0, mask = rows
    n, nl = len(seeing), LBDA.size
    path = os.path.join(tmp, "sparta_night.fits")
    fits.HDUList([fits.PrimaryHDU(), sparta_table(fits, rows)]).writeto(path)

    kw = dict(lmin=490, lmax=930, nl=35, chunk=50, cfg=cfg, device="cuda")
    _build.reset_launch_counts()
    with ApiLog() as log:
        res = compute_psf_from_sparta(path, **kw)
    counts = _build.launch_counts()
    print(f"compute_psf_from_sparta on {n} rows x {nl} wavelengths, chunk "
          f"50, default config: launches {counts}")
    if counts["zoom_dft_tc"] < 1 or counts["conv_dft"] != 0:
        raise RuntimeError(f"the SPARTA file: K1 must run on the tensor "
                           f"cores and K2 not at all: {counts}")
    no_disc_or_anchor(counts, "the SPARTA file")
    only_its_precision(counts, cfg.zoom_precision, "the SPARTA file")

    if [h.name for h in res] != RESULT_HDUS:
        raise RuntimeError(f"HDUs {[h.name for h in res]}")
    fit_rows = res["FIT_ROWS"].data
    if not (len(fit_rows) == n * nl and np.array_equal(
            fit_rows["row_idx"], np.repeat(np.arange(1, n + 1), nl))
            and set(fit_rows["lgs_idx"]) == {-1}
            and np.array_equal(fit_rows["lbda"], np.tile(LBDA, n))):
        raise RuntimeError("FIT_ROWS bookkeeping is off")
    derived = max(float(np.abs(fit_rows[k][::nl] - want).max())
                  for k, want in (("SEEING", seeing), ("GL", GL), ("L0", L0)))
    three = sorted(int(m.split("/")[0]) - 1 for m in log.lines
                   if "Using only 3 values out of 4" in m)
    n_three = sum(m == "Using three lasers mode" for m in log.lines)
    masked = np.nonzero(mask[:, 3] == 0.0)[0].tolist()
    print(f"derived seeing/GL/L0 within {derived:.3e} of the night's "
          f"(limit 1e-12); three-laser rows {three} (masked {masked})")
    if not (derived <= 1e-12 and three == masked and n_three == len(masked)
            and log.lines[0] == f"Processing SPARTA table with {n} values, "
            "njobs=-1 ..."):
        raise RuntimeError("the telemetry validation departs from the night")
    if not np.all(np.isfinite(fit_rows["fwhm"])) or not fit_rows["ok"].all():
        raise RuntimeError("FIT_ROWS holds a failed fit")

    _, direct_mean, _ = process_batch(seeing, GL, L0, mask, lbda=LBDA, cfg=cfg,
                                      chunk=50, device="cuda")
    mean = res["PSF_MEAN"].data
    rel = float(np.abs(mean - direct_mean).max() / np.abs(direct_mean).max())
    refit = fit_moffat_cube_host64(mean)
    fit_mean = res["FIT_MEAN"].data
    hdr = res["FIT_MEAN"].header
    med = [float(np.median(a)) for a in (seeing, GL, L0)]
    print(f"PSF_MEAN {mean.dtype} {mean.shape}: relative max-abs {rel:.3e} "
          f"from a direct process_batch on the same rows (limit 1e-6); "
          f"FIT_MEAN header {hdr['SEEING']:.4f} {hdr['GL']:.4f} "
          f"{hdr['L0']:.4f}")
    if not (mean.dtype == np.float64 and mean.shape == (nl, 40, 40)
            and rel <= 1e-6):
        raise RuntimeError(f"PSF_MEAN departs from the direct night: {rel}")
    if not (np.array_equal(fit_mean["n"], refit["n"])
            and np.array_equal(fit_mean["fwhm"],
                               refit["fwhm"] * cfg.pixscale)
            and np.allclose([hdr["SEEING"], hdr["GL"], hdr["L0"]], med,
                            rtol=1e-12, atol=0)):
        raise RuntimeError("FIT_MEAN is not the float64 host refit of "
                           "PSF_MEAN with the night's medians")

    out = os.path.join(tmp, "night_result.fits")
    res.writeto(out, overwrite=True)
    back = fits.fits_open(out)
    size = os.path.getsize(out)
    same = ([h.name for h in back] == RESULT_HDUS and all(
        same_table(res[k].data, back[k].data)
        for k in ("SPARTA_ATM_DATA", "FIT_ROWS", "FIT_MEAN"))
        and back["PSF_MEAN"].data.tobytes() == mean.tobytes())
    print(f"result file: {size} bytes = {size // 2880} x 2880 + "
          f"{size % 2880}; every column read back bit for bit: {same}")
    if not same or size % 2880:
        raise RuntimeError("the result file does not round-trip")

    walls = []
    with ApiLog():
        for _ in range(3):
            t0 = time.perf_counter()
            compute_psf_from_sparta(path, **kw)
            walls.append(time.perf_counter() - t0)
    dt = float(np.median(walls))
    print(f"compute_psf_from_sparta warmed x3: wall "
          f"{' '.join(f'{t:.4f}' for t in walls)} s; median {dt:.4f} s, "
          f"{n / dt:.2f} rows/s ({card})")
    return counts


def read_lines(path):
    with open(path) as fh:
        return fh.read().splitlines()


def real_cli(cfg, tmp):
    """The CLI on ``--values 1,0.7,25``: ``cli.main`` in process, counted,
    and ``python3 -m muse_psfr_tpu_torch`` in a subprocess; then the "No
    results" exit."""
    from muse_psfr_tpu_torch import cli
    from muse_psfr_tpu_torch.io.fits import fits_open
    from muse_psfr_tpu_torch.ops import _build
    logfile, outfile = (os.path.join(tmp, n) for n in ("cli.log",
                                                       "cli.fits"))
    argv = ["--values", "1,0.7,25", "--no-color", "-o", outfile, "--logfile",
            logfile]
    _build.reset_launch_counts()
    cli.main(argv)
    counts = _build.launch_counts()
    lines = read_lines(logfile)
    print(f"cli.main({argv[:3]}) launches {counts}; log file:\n"
          + "\n".join(lines[2:]))
    if lines[2:] != CLI_LOG:
        raise RuntimeError(f"the CLI's block {lines[2:]} != {CLI_LOG}")
    if counts["zoom_dft_tc_rowsplit"] < 1 or counts["conv_dft"] != 0:
        raise RuntimeError(f"the CLI: K3 must run at high and "
                           f"K2 not at all: {counts}")
    no_disc_or_anchor(counts, "the CLI")
    only_its_precision(counts, cfg.zoom_precision, "the CLI")
    if [h.name for h in fits_open(outfile)] != RESULT_HDUS:
        raise RuntimeError("the CLI's output file lacks an HDU")

    sublog, subout = (os.path.join(tmp, n) for n in ("sub.log", "sub.fits"))
    t0 = time.perf_counter()
    out = subprocess.run(
        [sys.executable, "-m", "muse_psfr_tpu_torch", "--values", "1,0.7,25",
         "--no-color", "-o", subout, "--logfile", sublog], cwd=ROOT,
        env=dict(os.environ, PYTHONPATH=ROOT), capture_output=True,
        text=True, timeout=600)
    print(f"python3 -m muse_psfr_tpu_torch --values 1,0.7,25: exit "
          f"{out.returncode} in {time.perf_counter() - t0:.1f} s (a fresh "
          f"process)")
    if out.returncode != 0:
        raise RuntimeError(f"the CLI subprocess failed:\n{out.stdout}\n"
                           f"{out.stderr}")
    if read_lines(sublog)[2:] != CLI_LOG or \
            "[INFO] " + CLI_BLOCK[0] not in out.stdout:
        raise RuntimeError(f"the CLI subprocess printed {out.stdout}")
    if [h.name for h in fits_open(subout)] != RESULT_HDUS:
        raise RuntimeError("the subprocess's output file lacks an HDU")

    try:
        cli.main(["--values", "1,0.7,1000", "--no-color", "--logfile",
                  os.path.join(tmp, "none.log")])
    except SystemExit as exc:
        print(f"--values 1,0.7,1000 exits with {exc.code!r}")
        if exc.code != "No results":
            raise RuntimeError(f"wrong exit: {exc.code!r}")
    else:
        raise RuntimeError("all-invalid telemetry did not exit")
    return counts


def sweep_path(cfg, card, guard_log, tmp):
    """The 32 x 32 x 1 condition sweep at the default config with a
    checkpoint, counted; its resume, ``save_sweep``, and the wall time
    with and without the checkpoint."""
    from muse_psfr_tpu_torch import (compute_psf, condition_sweep, fits_open,
                                     save_sweep)
    from muse_psfr_tpu_torch.ops import _build
    sv, gv = np.linspace(0.6, 1.6, 32), np.linspace(0.3, 0.9, 32)
    ckpt = os.path.join(tmp, "sweep.npy")
    kw = dict(lbda=LBDA, chunk=64, cfg=cfg, device="cuda")
    guard_log.trips.clear()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = condition_sweep(sv, gv, [25.0], checkpoint=ckpt, **kw)
    wall_first = time.perf_counter() - t0
    counts = _build.launch_counts()
    trips = len(guard_log.trips)
    print(f"condition_sweep 32 x 32 x 1 x {LBDA.size} wavelengths, chunk 64, "
          f"checkpointed: launches {counts}; window-guard trips: {trips}")
    if counts["zoom_dft_tc"] < 1 or counts["conv_dft"] != 0:
        raise RuntimeError(f"the sweep: K1 must run at high and "
                           f"K2 not at all: {counts}")
    no_disc_or_anchor(counts, "the sweep")
    only_its_precision(counts, cfg.zoom_precision, "the sweep")
    shape = (32, 32, 1, LBDA.size)
    if res["fwhm"].shape != shape or res["beta"].shape != shape:
        raise RuntimeError(f"sweep shapes {res['fwhm'].shape}")
    if not (np.all(np.isfinite(res["fwhm"]))
            and np.all(np.isfinite(res["beta"]))):
        raise RuntimeError("the sweep holds a non-finite fit")
    print(f"sweep FWHM {res['fwhm'].min():.3f}-{res['fwhm'].max():.3f} "
          f"arcsec, beta {res['beta'].min():.3f}-{res['beta'].max():.3f}; "
          f"{int((~res['fit']['ok']).sum())} of {res['fit']['ok'].size} "
          "plane fits not converged")

    i, j = int(np.argmin(np.abs(sv - 1.0))), int(np.argmin(np.abs(gv - 0.7)))
    one, _ = compute_psf(LBDA, sv[i], gv[j], 25.0, verbose=False, cfg=cfg,
                         device="cuda")
    dfw = float(np.max(np.abs(res["fwhm"][i, j, 0] / one["fwhm"][:, 0] - 1)))
    dn = float(np.max(np.abs(res["beta"][i, j, 0] / one["n"] - 1)))
    print(f"grid point ({sv[i]:.4f}, {gv[j]:.4f}, 25) against a one-row "
          f"compute_psf: FWHM {dfw:.3e}, beta {dn:.3e} relative (limit "
          f"1e-3)")
    if not (dfw <= 1e-3 and dn <= 1e-3):
        raise RuntimeError("the sweep departs from compute_psf")

    with open(ckpt + ".meta.json") as fh:
        done = json.load(fh)["done"]
    if done != list(range(1024)):
        raise RuntimeError(f"the sidecar lists {len(done)} done rows")
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    again = condition_sweep(sv, gv, [25.0], checkpoint=ckpt, resume=True,
                            **kw)
    wall_resume = time.perf_counter() - t0
    resumed = _build.launch_counts()
    print(f"sidecar: {len(done)} rows done; resume=True in "
          f"{wall_resume:.4f} s, launches {resumed}")
    if any(resumed.values()) or not (
            np.array_equal(again["fwhm"], res["fwhm"])
            and np.array_equal(again["beta"], res["beta"])):
        raise RuntimeError("the resumed sweep recomputed or changed rows")

    out = os.path.join(tmp, "sweep.fits")
    save_sweep(res, out)
    back = fits_open(out)
    grid = back["GRID"].data
    if not ([h.name for h in back] == ["PRIMARY", "FWHM", "BETA", "GRID"]
            and np.array_equal(back["FWHM"].data, res["fwhm"])
            and np.array_equal(back["BETA"].data, res["beta"])
            and np.array_equal(grid["SEEING"][0][:32], sv)
            and np.array_equal(grid["GL"][0][:32], gv)
            and grid["L0"][0][0] == 25.0
            and np.array_equal(grid["LBDA"][0][:LBDA.size], LBDA)
            and os.path.getsize(out) % 2880 == 0):
        raise RuntimeError("save_sweep does not round-trip")

    walls = {"no checkpoint": [], "checkpoint": []}
    for k in range(2):
        t0 = time.perf_counter()
        condition_sweep(sv, gv, [25.0], **kw)
        walls["no checkpoint"].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        condition_sweep(sv, gv, [25.0],
                        checkpoint=os.path.join(tmp, f"timed{k}.npy"), **kw)
        walls["checkpoint"].append(time.perf_counter() - t0)
    print(f"sweep wall: first (checkpointed) {wall_first:.4f} s; warmed in "
          "turns: " + "; ".join(
              f"{k} {' '.join(f'{t:.4f}' for t in v)} s, "
              f"{1024 / min(v):.2f} rows/s at best" for k, v in walls.items())
          + f"; guard trips {trips} ({card})")
    return counts


def fresh_process(args, cwd, env=None):
    """``python3 *args`` in a fresh process in ``cwd`` (the checkout on
    ``PYTHONPATH`` unless ``env`` says otherwise): (stdout, wall s);
    raises on a non-zero exit."""
    env = env or dict(os.environ, PYTHONPATH=ROOT)
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, *args], cwd=cwd, env=env,
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode:
        raise RuntimeError(f"python3 {' '.join(args)} exited "
                           f"{out.returncode}:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-6000:]}")
    return out.stdout, wall


def example_launches(counts, label, cfg):
    print(f"{label}: launches {counts}")
    if counts["zoom_dft_tc"] < 1 or counts["conv_dft"] != 0:
        raise RuntimeError(f"{label}: K1 must run at high and K2 not at "
                           f"all: {counts}")
    no_disc_or_anchor(counts, label)
    only_its_precision(counts, cfg.zoom_precision, label)


def full_night_example(cfg, card, tmp):
    """The port's ``full_night`` example in a fresh process and in this
    one, against a direct ``compute_psf_from_sparta``."""
    from muse_psfr_tpu_torch import compute_psf_from_sparta, fits_open
    from muse_psfr_tpu_torch.examples import full_night
    from muse_psfr_tpu_torch.ops import _build
    if full_night.CFG != cfg:
        raise RuntimeError(f"the example runs {full_night.CFG}, not {cfg}")
    run, again = (os.path.join(tmp, d) for d in ("night", "night_again"))
    os.makedirs(run)
    os.makedirs(again)
    module = "muse_psfr_tpu_torch.examples.full_night"
    stdout, wall = fresh_process(["-m", module, "--device", "cuda"], run)
    said = [ln for ln in stdout.splitlines() if not ln.startswith("[")]
    print(f"python3 -m {module} --device cuda: exit 0 in {wall:.1f} s (a "
          f"fresh process); it printed:\n  " + "\n  ".join(said))
    if "wrote night_psf.fits" not in said:
        raise RuntimeError("the example did not write night_psf.fits")
    res = fits_open(os.path.join(run, "night_psf.fits"))
    if [h.name for h in res] != RESULT_HDUS:
        raise RuntimeError(f"HDUs {[h.name for h in res]}")
    with ApiLog():
        direct = compute_psf_from_sparta(full_night.synthetic_night(),
                                         cfg=cfg, nl=35, device="cuda")
    got, want = res["PSF_MEAN"].data, direct["PSF_MEAN"].data
    rel = float(np.abs(got - want).max() / np.abs(want).max())
    print(f"night_psf.fits PSF_MEAN {got.shape}: relative max-abs {rel:.3e} "
          f"from a direct compute_psf_from_sparta on the same night (limit "
          f"1e-6); bit-equal: {np.array_equal(got, want)}")
    if got.shape != (35, 40, 40) or not rel <= 1e-6:
        raise RuntimeError(f"the example's night departs: {rel}")

    cwd = os.getcwd()
    _build.reset_launch_counts()
    try:
        os.chdir(again)
        with ApiLog():
            t0 = time.perf_counter()
            full_night.main(["--device", "cuda"])
            warm = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = _build.launch_counts()
    example_launches(counts, "full_night.main in process", cfg)
    print(f"full_night walls: fresh process {wall:.4f} s, warm in process "
          f"{warm:.4f} s ({card})")
    return counts


def sweep_example(cfg, card, tmp):
    """The port's ``sensitivity_sweep`` example in a fresh process and in
    this one, against a direct ``condition_sweep``; its resume."""
    from muse_psfr_tpu_torch import condition_sweep, fits_open
    from muse_psfr_tpu_torch.examples import sensitivity_sweep
    from muse_psfr_tpu_torch.ops import _build
    if sensitivity_sweep.CFG != cfg:
        raise RuntimeError(f"the example runs {sensitivity_sweep.CFG}")
    run, again = (os.path.join(tmp, d) for d in ("sweep16", "sweep_again"))
    os.makedirs(run)
    os.makedirs(again)
    module = "muse_psfr_tpu_torch.examples.sensitivity_sweep"
    plots = importlib.util.find_spec("matplotlib") is not None
    args = (["-m", module, "16", "sweep.png", "--device", "cuda"] if plots
            else ["-c", f"from {module} import sweep; sweep(16, 'cuda')"])
    stdout, wall = fresh_process(args, run)
    print(f"python3 {' '.join(args)}: exit 0 in {wall:.1f} s (a fresh "
          f"process); it printed:\n  " + "\n  ".join(stdout.splitlines()))
    if plots:
        png = os.path.join(run, "sweep.png")
        if not os.path.getsize(png):
            raise RuntimeError("the example's figure is empty")
        print(f"figure: sweep.png, {os.path.getsize(png)} bytes")
    else:
        print("figure not drawn: matplotlib is not installed on this "
              "machine, so only the example's compute step ran")

    sv, gv = np.linspace(0.6, 1.6, 16), np.linspace(0.3, 0.9, 16)
    kw = dict(lbda=[500.0, 700.0, 900.0], cfg=cfg, device="cuda")
    direct = condition_sweep(sv, gv, [25.0], **kw)
    back = fits_open(os.path.join(run, "sweep.fits"))
    for key in ("fwhm", "beta"):
        got, want = back[key.upper()].data, direct[key]
        rel = float(np.max(np.abs(got / want - 1)))
        print(f"sweep.fits {key.upper()} {got.shape}: relative max "
              f"{rel:.3e} from a direct condition_sweep (limit 1e-6); "
              f"bit-equal: {np.array_equal(got, want)}")
        if got.shape != (16, 16, 1, 3) or not rel <= 1e-6:
            raise RuntimeError(f"the example's sweep departs: {key} {rel}")

    _build.reset_launch_counts()
    resumed = condition_sweep(sv, gv, [25.0], resume=True, checkpoint=(
        os.path.join(run, "sweep_progress.npy")), **kw)
    counts = _build.launch_counts()
    print(f"resume=True over the example's checkpoint: launches {counts}")
    if any(counts.values()) or not all(
            np.array_equal(resumed[k], back[k.upper()].data)
            for k in ("fwhm", "beta")):
        raise RuntimeError("the resumed sweep recomputed or changed rows")

    cwd = os.getcwd()
    _build.reset_launch_counts()
    try:
        os.chdir(again)
        t0 = time.perf_counter()
        sensitivity_sweep.sweep(16, "cuda")
        warm = time.perf_counter() - t0
    finally:
        os.chdir(cwd)
    counts = _build.launch_counts()
    example_launches(counts, "sensitivity_sweep.sweep in process", cfg)
    print(f"sensitivity_sweep walls: fresh process {wall:.4f} s, its "
          f"compute step warm in process {warm:.4f} s ({card})")
    return counts


def installed_layout(dest):
    """Copy the port as ``pip install`` lays it out into ``dest``: the
    modules of ``pyproject.toml``'s package list and the files its package
    data matches, nothing else of the checkout; the copied paths."""
    import tomllib
    with open(os.path.join(ROOT, "pyproject.toml"), "rb") as fh:
        tool = tomllib.load(fh)["tool"]["setuptools"]
    files = [p for pkg in tool["packages"]
             if pkg.split(".")[0] == "muse_psfr_tpu_torch"
             for p in glob.glob(os.path.join(ROOT, *pkg.split("."), "*.py"))]
    files += [p for pkg, patterns in tool["package-data"].items()
              for pattern in patterns
              for p in glob.glob(os.path.join(ROOT, *pkg.split("."),
                                              pattern))]
    rel = sorted(os.path.relpath(p, ROOT) for p in files)
    for path in rel:
        os.makedirs(os.path.join(dest, os.path.dirname(path)), exist_ok=True)
        shutil.copy2(os.path.join(ROOT, path), os.path.join(dest, path))
    return rel


def built_libraries(path):
    return {f: os.path.getmtime(os.path.join(path, f))
            for f in (os.listdir(path) if os.path.isdir(path) else [])
            if f.endswith(".so")}


def installed_cli(card, tmp):
    """The CLI of the port laid out as an install, outside the checkout:
    the first fresh process builds the kernels from the installed sources
    into ``$XDG_CACHE_HOME``, the second reuses them."""
    from muse_psfr_tpu_torch.ops import _build
    site, cache, run = (os.path.join(tmp, d) for d in ("site", "xdg_cache",
                                                       "installed_run"))
    files = installed_layout(site)
    os.makedirs(run)
    print(f"installed layout: {len(files)} files, csrc/ "
          f"{sorted(os.path.basename(f) for f in files if '/csrc/' in f)}")
    env = dict(os.environ, PYTHONPATH=site, XDG_CACHE_HOME=cache)
    cached = os.path.join(cache, "muse_psfr_tpu_torch", "build")
    checkout = built_libraries(_build.BUILD_DIR)
    walls, libs = [], []
    for k in range(2):
        log = os.path.join(run, f"cli{k}.log")
        stdout, wall = fresh_process(
            ["-m", "muse_psfr_tpu_torch", "--values", "1,0.7,25",
             "--no-color", "--logfile", log], run, env)
        lines = read_lines(log)[2:]
        walls.append(wall)
        libs.append(built_libraries(cached))
        print(f"installed python3 -m muse_psfr_tpu_torch --values 1,0.7,25 "
              f"({'cold' if k == 0 else 'warm'} cache): exit 0 in "
              f"{wall:.1f} s; cache {sorted(libs[-1])}; log:\n"
              + "\n".join(lines))
        if lines != CLI_LOG:
            raise RuntimeError(f"the installed CLI's block {lines}")
    name = os.path.basename(_build.library()._name)
    if list(libs[0]) != [name] or libs[1] != libs[0]:
        raise RuntimeError(f"the installed port did not build {name} once "
                           f"into {cached}: {libs}")
    if built_libraries(_build.BUILD_DIR) != checkout:
        raise RuntimeError("the installed port wrote into the checkout's "
                           f"{_build.BUILD_DIR}")
    print(f"installed port: kernels built from the installed sources into "
          f"$XDG_CACHE_HOME/muse_psfr_tpu_torch/build in "
          f"{walls[0] - walls[1]:.1f} s (cold-cache wall {walls[0]:.1f} s "
          f"minus warm {walls[1]:.1f} s); the checkout's build/ untouched "
          f"({card})")


def mesh_launches(counts, shards, label, fft_free=True):
    """K1 "high" (and K2 on an FFT-free night) launched on every shard:
    ``counts`` is this process's count over ``shards`` shards."""
    keys = ["zoom_dft_tc"] + (["conv_dft"] if fft_free else [])
    per = {k: counts[k] / shards for k in keys}
    print(f"{label}: launches {counts}; per shard "
          + ", ".join(f"{k} {v:g}" for k, v in per.items()))
    if any(counts[k] < shards for k in keys):
        raise RuntimeError(f"{label}: a shard launched no {keys}: {counts}")
    no_disc_or_anchor(counts, label)
    only_its_precision(counts, "high", label)
    if not fft_free and counts["conv_dft"] + counts["conv_dft_tc"]:
        raise RuntimeError(f"{label}: K2 ran on the cuFFT route: {counts}")
    return per


def same_night(label, got, want, card):
    """A mesh night against the same night on one device: the mean PSF
    <= 1e-6 absolute and every packed fit field <= 1e-4 absolute (the JAX
    package's mesh limits, tests/test_parallel.py:124-126), but FWHM and
    beta, held to 1e-3 relative, the per-row limit of section 2 for
    nights whose rows run in batches of other sizes: a batch size alone
    moves a row's float32 PSF by ~1e-7, and the LM fit turns that into up
    to ~4e-4 on beta (PERF.md section 6)."""
    from muse_psfr_tpu_torch.fit.moffat_fit import PACKED_FIELDS
    check_fits(got[0], len(want[0]), got[1], got[2])
    shape = [PACKED_FIELDS.index(k) for k in ("fwhm", "n")]
    diff = np.abs(got[0] - want[0])
    dshape = float((diff[..., shape] / np.abs(want[0][..., shape])).max())
    dfit = float(np.delete(diff, shape, axis=-1).max())
    dmean = float(np.abs(got[1] - want[1]).max())
    rel = dmean / float(np.abs(want[1]).max())
    moved = int(np.any(diff > 0, axis=(1, 2)).sum())
    print(f"{label} vs the single-device night: {moved} of {len(diff)} rows "
          f"not bit-equal; FWHM/beta {dshape:.3e} relative (limit 1e-3), "
          f"other fit fields {dfit:.3e} abs (limit 1e-4), mean PSF "
          f"{dmean:.3e} abs (limit 1e-6), {rel:.3e} relative; per field "
          f"{' '.join(f'{v:.2e}' for v in diff.max(axis=(0, 1)))} ({card})")
    if not (dshape <= 1e-3 and dfit <= 1e-4 and dmean <= 1e-6):
        raise RuntimeError(f"{label} departs from the single-device night")
    return dict(rows_moved=moved, fwhm_beta_rel=dshape, fit_abs=dfit,
                mean_abs=dmean, mean_rel=rel)


def mesh_phase(torch, cfg, user_cfg, rows, card, guard_log, night9):
    """The 1-direction night under meshes (phase 21): ``default_mesh()``,
    two shards on one card (FFT-free and default config, the 9-direction
    night ``night9``, golden row, forced redo), a one-rank NCCL group, and
    two processes on the card
    through gloo (``parallel/multihost_demo.py``); each against the
    single-device night, with launches per shard and walls in turns."""
    import torch.distributed as dist
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    from muse_psfr_tpu_torch.parallel.mesh import default_mesh, init_multihost
    night = dict(lbda=LBDA, npsflin=1, cfg=cfg, chunk=50, device="cuda")
    out = {}

    def counted(**kw):
        _build.reset_launch_counts()
        got = process_batch(*rows, **dict(night, **kw))
        return got, _build.launch_counts()

    want = process_batch(*rows, **night)
    one = default_mesh()
    if one.size != torch.cuda.device_count():
        raise RuntimeError(f"default_mesh() covers {one.devices}")
    got, counts = counted(mesh=one)
    mesh_launches(counts, one.size,
                  f"default_mesh() over {[str(d) for d in one.devices]}")
    out["default_mesh"] = dict(launches=counts, **same_night(
        "default_mesh()", got, want, card))

    two = default_mesh(["cuda:0", "cuda:0"])
    got, counts2 = counted(mesh=two)
    mesh_launches(counts2, 2, "two shards on cuda:0")
    if counts2["zoom_dft_tc"] != 2 * counts["zoom_dft_tc"]:
        raise RuntimeError(f"two shards launched K1 {counts2} against "
                           f"{counts} on one")
    out["two_shards"] = dict(launches=counts2, **same_night(
        "two shards on cuda:0", got, want, card))
    want_d = process_batch(*rows, **dict(night, cfg=user_cfg))
    got, counts_d = counted(cfg=user_cfg, mesh=two)
    mesh_launches(counts_d, 2, "two shards, default config", fft_free=False)
    out["two_shards_default"] = dict(launches=counts_d, **same_night(
        "two shards, default config", got, want_d, card))
    want9 = process_batch(*rows, **night9)
    _build.reset_launch_counts()
    got = process_batch(*rows, **night9, mesh=two)
    counts9 = _build.launch_counts()
    mesh_launches(counts9, 2, "9-direction night, two shards")
    out["two_shards_ndir9"] = dict(launches=counts9, **same_night(
        "9-direction night, two shards", got, want9, card))
    golden_rms(cfg, rows, "two shards on cuda:0", mesh=two)
    forced_redo(cfg, guard_log, mesh=two, label=" over two shards")

    walls = {"single": [], "two shards": []}
    for name in ("single", "two shards", "two shards", "single") * 2:
        t0 = time.perf_counter()
        process_batch(*rows, **night, mesh=two if name != "single" else None)
        walls[name].append(time.perf_counter() - t0)
    for name, w in walls.items():
        print(f"1-direction night, {name}, in turns x{len(w)}: wall "
              f"{' '.join(f'{t:.4f}' for t in w)} s; median "
              f"{np.median(w):.4f} s ({card})")
    out["walls_s"] = {k: [float(t) for t in w] for k, w in walls.items()}

    # one rank of NCCL: its gather runs once per chunk
    os.environ.setdefault("NCCL_SOCKET_IFNAME", "lo")
    with socket.socket() as sk:
        sk.bind(("localhost", 0))
        port = sk.getsockname()[1]
    group = init_multihost(f"localhost:{port}", 1, 0)
    gathers = [0]
    all_gather = dist.all_gather

    def counted_gather(*a, **k):
        gathers[0] += 1
        return all_gather(*a, **k)

    dist.all_gather = counted_gather
    try:
        got, counts_n = counted(mesh=default_mesh())
    finally:
        dist.all_gather = all_gather
        backend = dist.get_backend()
        dist.destroy_process_group()
    mesh_launches(counts_n, group.size, f"one-rank {backend} group")
    print(f"one-rank {backend} group: {gathers[0]} gathers")
    if backend != "nccl" or gathers[0] < 1:
        raise RuntimeError(f"no NCCL gather ran ({backend}, {gathers[0]})")
    out["nccl_one_rank"] = dict(launches=counts_n, gathers=gathers[0],
                                **same_night("one-rank NCCL group", got,
                                             want, card))

    # two processes on the one card: NCCL refuses two ranks on a device
    with tempfile.TemporaryDirectory() as tmp:
        cmd = [sys.executable, "-m",
               "muse_psfr_tpu_torch.parallel.multihost_demo", "--device",
               "cuda", "--backend", "gloo", "--nproc", "2", "--rows",
               str(len(rows[0])), "--repeat", "4", "--out", tmp]
        print("two ranks on cuda:0, backend gloo (NCCL refuses two ranks "
              "on one card): " + " ".join(cmd[1:]))
        t0 = time.perf_counter()
        run = subprocess.run(cmd, cwd=ROOT, capture_output=True, text=True,
                             timeout=600)
        for line in (run.stdout + run.stderr).splitlines():
            print("  demo:", line)
        if run.returncode:
            raise RuntimeError(f"the two-rank demo failed ({run.returncode})")
        demo = dict(np.load(os.path.join(tmp, "multihost_demo.npz")))
    print(f"two ranks: {time.perf_counter() - t0:.1f} s including start-up")
    if not all(np.array_equal(demo[k], r) for k, r in
               zip(("seeing", "GL", "L0", "gs_mask"), rows)):
        raise RuntimeError("the demo ran other telemetry than the night")
    counts_r = json.loads(str(demo["counts"]))
    for r, c in enumerate(counts_r):
        mesh_launches(c, 1, f"two ranks, rank {r}")
    pair = demo["walls"].max(axis=0)
    print(f"1-direction night, two ranks on cuda:0 (gloo), warmed x"
          f"{pair.size}: wall {' '.join(f'{t:.4f}' for t in pair)} s; "
          f"median {np.median(pair):.4f} s against the single-device "
          f"median {np.median(walls['single']):.4f} s ({card})")
    out["two_ranks"] = dict(launches=counts_r,
                            walls_s=[float(t) for t in pair], **same_night(
                                "two ranks (rank 0, equal bit for bit to "
                                "rank 1)", (demo["fit"], demo["mean"],
                                            demo["fitm"]), want, card))
    return out


def sweep_rows(n=32, l0=(25.0,)):
    """The n x n x len(l0) sweep's rows (seeing 0.6-1.6", GL 0.3-0.9), as
    ``condition_sweep`` hands them to ``process_batch``; by default the
    32 x 32 x 1 sweep's 1024."""
    grid = np.meshgrid(np.linspace(0.6, 1.6, n), np.linspace(0.3, 0.9, n),
                       l0, indexing="ij")
    return [g.ravel() for g in grid] + [np.ones((grid[0].size, 4))]


def counted_night(rows, night, **kw):
    """``process_batch`` on ``rows``, its launch counts and the number of
    programs it captured."""
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel import programs
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    n = len(programs.programs())
    _build.reset_launch_counts()
    out = process_batch(*rows, **dict(night, **kw))
    return out, _build.launch_counts(), len(programs.programs()) - n


def same_bits(label, got, want):
    """Every array of ``got`` equal bit for bit to ``want``'s; else the
    largest differences, printed, and a failure."""
    equal = all(np.array_equal(g, w) for g, w in zip(got, want))
    if not equal:
        diffs = [float(np.abs(g.astype(np.float64) - w).max())
                 for g, w in zip(got, want)]
        raise RuntimeError(f"{label}: graphs and eager differ, max abs "
                           f"{diffs}")


def graph_against_eager(label, rows, night, log=None):
    """The night with its programs replayed against the same night run
    eagerly (``_graphs=False``): fits, mean PSF and its fit bit for bit,
    launch counts equal, nothing captured in the replayed night (a night
    that still captured a program is run again).  With ``log`` (a list)
    the eager night's zoom calls are appended to it
    (:func:`zoom_calls`)."""
    got, counts, captured = counted_night(rows, night)
    if captured:
        got, counts, captured = counted_night(rows, night)
    with (zoom_calls(log) if log is not None else contextlib.nullcontext()):
        want, want_counts, _ = counted_night(rows, night, _graphs=False)
    same_bits(label, got, want)
    print(f"graphs {label}: bit-equal to eager; launches {counts}; "
          f"{captured} captured in the replayed night")
    if counts != want_counts or captured:
        raise RuntimeError(f"graphs {label}: launches {counts} against "
                           f"eager {want_counts}, {captured} captured")
    return counts


def walls_in_turns(rows, night, warm, card, label):
    """``warm`` warmed nights eager and with graphs, in turns (eager,
    graphs, graphs, eager): median, minimum and spread (max - min)."""
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    walls = {"eager": [], "graphs": []}
    for _ in range(-(-warm // 2)):
        for name in ("eager", "graphs", "graphs", "eager"):
            t0 = time.perf_counter()
            process_batch(*rows, **night, _graphs=name == "graphs")
            walls[name].append(time.perf_counter() - t0)
    out = {}
    for name, w in walls.items():
        med = float(np.median(w))
        out[name] = dict(median=med, min=float(min(w)),
                         spread=float(max(w) - min(w)), walls=w)
        print(f"{label}, {name}, in turns x{len(w)}: wall "
              f"{' '.join(f'{t:.4f}' for t in w)} s; median {med:.4f} s, "
              f"min {min(w):.4f} s, spread {max(w) - min(w):.4f} s, "
              f"{len(rows[0]) / med:.2f} rows/s ({card})")
    ratio = out["eager"]["median"] / out["graphs"]["median"]
    print(f"{label}: eager / graphs median {ratio:.3f}")
    return out


def profiled_shares(torch, rows, night, label, card, path=None, warm=1):
    """torch.profiler over one night after ``warm`` warm-up nights (two
    where the night's programs are new to the process: the first
    dispatches them eagerly, the second captures them): host self time
    (and the ops that hold most of it), device self time, the union of
    the device's busy intervals and its idle share of the night's wall
    (under the profiler); with ``path`` the profiler's table, printed and
    written there."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    for _ in range(warm):
        process_batch(*rows, **night)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        process_batch(*rows, **night)
        wall = time.perf_counter() - t0
    avg = prof.key_averages()
    host = sum(e.self_cpu_time_total for e in avg) / 1e3
    dev = sum(getattr(e, "self_device_time_total", 0) for e in avg) / 1e3
    spans = sorted((e.time_range.start, e.time_range.end)
                   for e in prof.events() if e.device_type == DeviceType.CUDA)
    busy, end = 0.0, -np.inf
    for a, b in spans:
        busy += max(0.0, b - max(a, end))
        end = max(end, b)
    busy /= 1e3
    idle = 1.0 - busy / (wall * 1e3)
    top = sorted(avg, key=lambda e: -e.self_cpu_time_total)[:6]
    print(f"profiled {label}: host self time {host:.3f} ms (most in "
          + ", ".join(f"{e.key} {e.self_cpu_time_total / 1e3:.3f} ms x"
                      f"{e.count}" for e in top)
          + f"), device self time {dev:.3f} ms, device busy {busy:.3f} ms "
          f"in {len(spans)} device events over a wall of {wall * 1e3:.3f} "
          f"ms: idle share {idle:.3f} ({card})")
    if path:
        table = avg.table(sort_by="cuda_time_total", row_limit=40)
        os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
        with open(path, "w") as fh:
            fh.write(table)
        print(table)
    return dict(host_self_ms=host, device_self_ms=dev, device_busy_ms=busy,
                wall_ms=wall * 1e3, idle_share=idle, events=len(spans))


def chunk_loop_without_sync(torch, rows, night, label):
    """The night's chunk loop (after its one telemetry copy, before its
    one host copy) under ``torch.cuda.set_sync_debug_mode("error")``: a
    synchronising call there raises."""
    from muse_psfr_tpu_torch.parallel import batch
    chunks = batch._chunks

    def strict(*a, **k):
        it = chunks(*a, **k)
        first = next(it)
        torch.cuda.set_sync_debug_mode("error")
        try:
            yield first
            yield from it
        finally:
            torch.cuda.set_sync_debug_mode(0)

    batch._chunks = strict
    try:
        batch.process_batch(*rows, **night)
    finally:
        batch._chunks = chunks
    print(f"{label}: the chunk loop ran under set_sync_debug_mode(\"error\")"
          " without a synchronising call")


def graphs_phase(torch, cfg, user_cfg, top, rows, card, guard_log, night,
                 night9):
    """Phase 22: the chunk programs (``parallel/programs.py``) replayed as
    CUDA graphs against the eager step (``_graphs=False``)."""
    from muse_psfr_tpu_torch.parallel import programs
    from muse_psfr_tpu_torch.parallel.batch import (process_batch,
                                                    reconstruct_batch)
    from muse_psfr_tpu_torch.parallel.mesh import default_mesh
    sweep = sweep_rows()
    sweep_night = dict(lbda=LBDA, cfg=user_cfg, chunk=64, device="cuda")
    default1 = dict(night, cfg=user_cfg)
    out = {"launches": {}}
    t0 = time.perf_counter()

    def lap(label):
        print(f"  (phase 22: {label} in {time.perf_counter() - t0:.1f} s)")
    for label, r, kw in [
            ("1-direction night", rows, night),
            ("1-direction night, default config", rows, default1),
            ("9-direction night", rows, night9),
            ("9-direction night, zoom_anchor=auto", rows,
             dict(night9, cfg=cfg.with_(zoom_anchor="auto"))),
            ("9-direction night, disc_skip", rows,
             dict(night9, cfg=cfg.with_(disc_skip=True))),
            ("1-direction night, zoom_precision=highest", rows,
             dict(night, cfg=top)),
            ("1-direction night, conv_precision=high", rows,
             dict(night, cfg=cfg.with_(conv_precision="high"))),
            ("32 x 32 sweep's rows", sweep, sweep_night)]:
        out["launches"][label] = graph_against_eager(label, r, kw)
    lap("the nights against eager")

    # the wavelengths are values of a program, not part of it: a shifted
    # grid of the same plan replays the same programs
    shifted = dict(night, lbda=LBDA + 2.0)
    got, counts, captured = counted_night(rows, shifted)
    want, want_counts, _ = counted_night(rows, shifted, _graphs=False)
    same_bits("shifted grid", got, want)
    moved = float(np.abs(got[1] - process_batch(*rows, **night)[1]).max())
    print(f"graphs, 1-direction night on 492-932 nm: bit-equal to eager, "
          f"{captured} captured (its programs are the 490-930 nm "
          f"night's), mean PSF {moved:.3e} from the 490-930 nm night's")
    if captured or counts != want_counts or not moved > 0:
        raise RuntimeError(f"the shifted night captured {captured} "
                           f"programs or ran as the unshifted one")

    # a forced guard trip: the pinned window's program, then the full
    # window's, through reconstruct_batch ("recon") and process_batch
    tel = ([0.2], [0.01], [30.0], np.ones((1, 4)))
    pinned = dict(cfg=cfg.with_(otf_support=128), chunk=1, device="cuda")
    for name, fn in (("reconstruct_batch", reconstruct_batch),
                     ("process_batch", process_batch)):
        runs = []
        for graphs in (True, True, True, False):
            guard_log.trips.clear()
            res = fn(*tel, [930.0], **pinned, _graphs=graphs)
            runs.append((res if name == "process_batch" else (res,),
                         len(guard_log.trips)))
        for res, trips in runs[:3]:
            same_bits(f"forced redo through {name}", res, runs[3][0])
        if not all(trips for _, trips in runs):
            raise RuntimeError(f"forced redo through {name}: no trip")
        print(f"graphs, forced redo through {name}: tripped in every run; "
              "three graph runs bit-equal to the eager run")
    lap("the shifted grid and the forced redo")

    two = default_mesh(["cuda:0", "cuda:0"])
    out["launches"]["two shards on cuda:0"] = graph_against_eager(
        "1-direction night, two shards on cuda:0", rows,
        dict(night, mesh=two))

    chunk_loop_without_sync(torch, rows, night,
                            "graphs, 1-direction night")
    chunk_loop_without_sync(torch, rows, dict(night, _graphs=False),
                            "eager, 1-direction night")
    lap("the mesh and the chunk loops without a sync")

    out["walls"] = {
        "1-direction night": walls_in_turns(rows, night, 6, card,
                                            "1-direction night"),
        "9-direction night": walls_in_turns(rows, night9, 6, card,
                                            "9-direction night"),
        "1-direction night, default config": walls_in_turns(
            rows, default1, 6, card, "1-direction night, default config"),
        "32 x 32 sweep's rows": walls_in_turns(
            sweep, sweep_night, 6, card, "32 x 32 sweep's rows")}
    lap("the walls")
    out["profile"] = {
        mode: profiled_shares(torch, rows,
                              dict(night, _graphs=mode == "graphs"),
                              f"1-direction night, {mode}", card)
        for mode in ("graphs", "eager")}
    lap("the profiles")

    progs = programs.programs()
    total = print_programs(torch, progs, card)
    out["programs"] = dict(count=len(progs), capture_s=total)
    return out


def print_programs(torch, progs, card):
    """Each captured program's key, capture time, memory and launches per
    replay, then the card's memory; returns the capture time in all."""
    for p in progs:
        k = p.key
        what = (f"{k[0]} {k[1]} {k[2]}" if k[0] == "mean" else
                f"{k[0]} dim {k[1].dim} window {k[1].otf_support or 'full'} "
                f"blue {k[1].otf_blue} split {k[1].use_dphi_split} anchor "
                f"{k[1].zoom_anchor} disc {k[1].disc_skip} fft "
                f"{k[1].use_fft} zoom {k[1].zoom_precision} conv "
                f"{k[1].conv_precision} rows {k[2]} nl {k[3]} npsflin "
                f"{k[7]}")
        print(f"program {what} on {k[-1]}: captured in {p.capture_s:.3f} s; "
              f"max_memory_reserved {p.reserved[0] / 2**30:.3f} -> "
              f"{p.reserved[1] / 2**30:.3f} GiB, reserved after "
              f"{p.reserved[2] / 2**30:.3f} GiB; {p.replays} replays; "
              f"launches per replay "
              f"{ {a: b for a, b in p.launches.items() if b} }")
    total = sum(p.capture_s for p in progs)
    print(f"{len(progs)} programs captured in {total:.3f} s in all; "
          f"memory reserved now {torch.cuda.memory_reserved() / 2**30:.3f} "
          f"GiB, at most {torch.cuda.max_memory_reserved() / 2**30:.3f} GiB "
          f"({card})")
    return total


#: the keys of ``bench.py``'s JSON line (:183-199), in its order, then the
#: three that ``bench_torch.py`` adds
BENCH_KEYS = ("metric", "value", "unit", "vs_baseline", "rows", "nl",
              "elapsed_s", "rms_vs_f64_oracle", "row0_plan",
              "block_minima_s", "block_spread", "vs_committed_calm_best",
              "baseline_rows_per_sec", "device", "dtype", "median_s",
              "times_s", "launches_per_night")


def bench_run(label, env, card, golden):
    """``python3 bench_torch.py`` in a fresh process with ``env`` added:
    its JSON line, checked (keys, accuracy, row 0's plan, the card) and
    printed with its warm-up line and the process's wall."""
    t0 = time.perf_counter()
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT, **env),
                         capture_output=True, text=True, timeout=600)
    wall = time.perf_counter() - t0
    if out.returncode:
        raise RuntimeError(f"bench_torch.py ({label}) exited "
                           f"{out.returncode}:\n{out.stdout[-2000:]}\n"
                           f"{out.stderr[-6000:]}")
    res = json.loads(out.stdout.strip().splitlines()[-1])
    for line in out.stderr.splitlines():
        if line.startswith("# warm-up"):
            print(f"bench {label}: {line[2:]}")
    print(f"bench {label} ({card}; the process {wall:.1f} s): "
          f"{json.dumps(res)}")
    if list(res) != list(BENCH_KEYS):
        raise RuntimeError(f"bench {label}: keys {list(res)}, expected "
                           f"{list(BENCH_KEYS)}")
    if not res["rms_vs_f64_oracle"] <= 1e-5:
        raise RuntimeError(f"bench {label}: rms_vs_f64_oracle "
                           f"{res['rms_vs_f64_oracle']} > 1e-5")
    if res["row0_plan"] != golden:
        raise RuntimeError(f"bench {label}: row0_plan {res['row0_plan']}, "
                           f"the golden plan's {golden}")
    if not res["device"].startswith(card.split(",")[0]):
        raise RuntimeError(f"bench {label}: device {res['device']!r} is "
                           f"not the card {card!r}")
    return res


def plan_row0(name):
    """Row 0's group in the golden plan ``name``."""
    with open(os.path.join(DATA, name)) as fh:
        return next(g["cfg_delta"] for g in json.load(fh)["groups"]
                    if 0 in g["rows"])


def plan_kernels(groups, fft_free):
    """The launches one night at zoom_precision "high" makes by the plan
    ``groups`` (its summary's, or the name of a golden plan): K1 once a
    chunk, twice in a group that splits the blue wavelengths off, with
    three passes, and with six in the exact group
    (``otf/psf.py:_zoom_precision``); on the FFT-free route, K2 once a
    chunk."""
    if isinstance(groups, str):
        with open(os.path.join(DATA, groups)) as fh:
            groups = json.load(fh)["groups"]
    want = {}
    for g in groups:
        delta = g["cfg_delta"]
        key = ("zoom_dft" if delta.get("use_dphi_split") is False
               else "zoom_dft_tc")
        want[key] = (want.get(key, 0)
                     + len(g["sizes"]) * (2 if delta.get("otf_blue") else 1))
    if fft_free:
        want["conv_dft"] = sum(len(g["sizes"]) for g in groups)
    return want


def bench_phase(torch, rows, card, replayed_median):
    """Phase 23: ``bench_torch.py`` at its defaults (the 100-row night)
    and at 1000 rows, each in a fresh process, each night launching K1
    "high" as often as its golden plan says and nothing else;
    ``replayed_median`` is phase 22's replayed median of the 100-row
    default-config night, which is then profiled here, in process, to
    set beside ``tools/profile_bench.py``'s fresh process.  Returns K1
    "high"'s launches in one timed night of each."""
    from muse_psfr_tpu_torch.config import GalacsiConfig
    torch.cuda.empty_cache()        # this process's unused cached blocks
    out = {}
    for label, env, name in (
            ("100 rows", {}, "golden_plan_night100.json"),
            ("1000 rows", dict(BENCH_ROWS="1000", BENCH_BLOCKS="1",
                               BENCH_REPS="5"),
             "golden_plan_night1000.json")):
        res = bench_run(label, env, card, plan_row0(name))
        counts = res["launches_per_night"]
        want = plan_kernels(name, False)
        if {k: v for k, v in counts.items() if v} != want:
            raise RuntimeError(f"bench {label}: one night must launch "
                               f"{want} ({name}) and nothing else: "
                               f"{counts}")
        out[label] = counts["zoom_dft_tc"]
        if label == "100 rows":
            print(f"bench 100 rows: median {res['median_s']:.4f} s over "
                  f"phase 22's replayed median {replayed_median:.4f} s of "
                  f"the same night in process: "
                  f"{res['median_s'] / replayed_median:.3f} ({card})")
    profiled_shares(torch, rows, dict(lbda=LBDA, npsflin=1,
                                      cfg=GalacsiConfig(), chunk=50,
                                      device="cuda"),
                    "the bench's 100-row night, replayed, in process", card)
    return out


@contextlib.contextmanager
def zoom_calls(log):
    """Appends to ``log`` every call of ``otf/psf.py:_psf_chunk_fused``
    (one per chunk and window segment) while the block runs: the group's
    route (the split PSD or the exact transform), its window, rows,
    directions, the structure function's shape, the wavelengths and the
    kernel launches the call made.  An eager step and a capture call it;
    a replayed graph does not."""
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.otf import psf
    fused = psf._psf_chunk_fused

    def logged(base, lb_k, npix_k, cfg):
        before = _build.launch_counts()
        out = fused(base, lb_k, npix_k, cfg)
        after = _build.launch_counts()
        B, ndir, n, ncols = base.shape
        log.append(dict(route="split" if cfg.use_dphi_split else "exact",
                        window=cfg.otf_support or "full", B=B, ndir=ndir,
                        shape=(n, ncols), nl=int(lb_k.shape[0]),
                        launched={k: after[k] - before[k] for k in after
                                  if after[k] != before[k]}))
        return out

    psf._psf_chunk_fused = logged
    try:
        yield log
    finally:
        psf._psf_chunk_fused = fused


def zoom_shapes(calls, label):
    """Prints a night's zoom calls (:func:`zoom_calls`) by kind and
    returns the K1/K3 launches per (n, ncols) window shape."""
    kinds, per_shape = {}, {}
    for c in calls:
        key = (c["route"], c["window"], c["B"], c["ndir"], c["shape"],
               c["nl"], tuple(sorted(c["launched"].items())))
        kinds[key] = kinds.get(key, 0) + 1
        per_shape[c["shape"]] = (per_shape.get(c["shape"], 0)
                                 + sum(c["launched"].values()))
    for (route, win, B, ndir, shape, nl, launched), n in kinds.items():
        print(f"  {label}: {n} x {route} window {win}, {B} rows x {ndir} "
              f"directions, {shape[0]} x {shape[1]}, {nl} wavelengths -> "
              f"{dict(launched)}")
    return per_shape


def memory_line(torch, label, card):
    """The card's reserved and allocated memory, and their peaks."""
    print(f"{label}: torch.cuda.max_memory_reserved "
          f"{torch.cuda.max_memory_reserved() / 2**30:.3f} GiB, "
          f"memory_reserved {torch.cuda.memory_reserved() / 2**30:.3f} GiB, "
          f"max_memory_allocated "
          f"{torch.cuda.max_memory_allocated() / 2**30:.3f} GiB ({card})")


def fresh_pools(torch, label, card):
    """Drops every captured program and its pool (the configurations
    that follow share none of them), returns the freed memory to the
    card and restarts the peak counters."""
    from muse_psfr_tpu_torch.parallel import programs
    n = len(programs.programs())
    programs.clear()
    torch.cuda.empty_cache()
    torch.cuda.reset_peak_memory_stats()
    print(f"{label}: dropped {n} programs; memory reserved now "
          f"{torch.cuda.memory_reserved() / 2**30:.3f} GiB ({card})")


def planned_night(torch, rows, night, golden, label, card, guard_log,
                  warm=5, full=True, pinned=None):
    """A night of phases 24-25 through ``process_batch``: the plan equals
    ``golden``; its first night launches what the plan says
    (:func:`plan_kernels`) and has finite, converged fits; with ``full``
    the mean PSF within 1e-5 relative and the per-row FWHM/beta within
    1e-3 of the same night on the full window; replayed equal to eager
    bit for bit; ``warm`` warmed nights; with ``pinned`` row 0 against
    that golden cube (rms <= 1e-5); the memory after the captures.
    Returns the first night's launches, the K1/K3 launches per window
    shape and the eager night's zoom calls (:func:`zoom_calls`)."""
    from muse_psfr_tpu_torch.fit.moffat_fit import unpack_fit
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    cfg = night["cfg"]
    check_plan(rows, night, golden)
    want = plan_kernels(golden, not cfg.use_fft)
    guard_log.trips.clear()
    t0 = time.perf_counter()
    (fit, mean, fit_mean), counts, captured = counted_night(rows, night)
    first = time.perf_counter() - t0
    ran = {k: v for k, v in counts.items() if v}
    print(f"{label}: first night {first:.3f} s ({captured} programs "
          f"captured); launches {ran}, the plan's {want}; window-guard "
          f"trips: {len(guard_log.trips)} {guard_log.trips}")
    if ran != want:
        raise RuntimeError(f"{label}: launches {ran}, the plan says {want}")
    got = check_fits(fit, len(rows[0]), mean, fit_mean)
    print(f"{label}: all {got['ok'].size} plane fits finite and converged; "
          f"fwhm {got['fwhm'][..., 0].min() * cfg.pixscale:.3f}-"
          f"{got['fwhm'][..., 0].max() * cfg.pixscale:.3f} arcsec, beta "
          f"{got['n'].min():.3f}-{got['n'].max():.3f}")
    if full:
        t0 = time.perf_counter()
        f = process_batch(*rows, **night, _force_full=True)
        print(f"{label}: the full-window night in "
              f"{time.perf_counter() - t0:.3f} s")
        compare_nights(f"{label} against its full-window night", mean, got,
                       f[1], unpack_fit(f[0]))
    calls = []
    graph_against_eager(label, rows, night, log=calls)
    shapes = zoom_shapes(calls, f"{label}, eager")
    if warm:
        warmed_nights(process_batch, rows, night, card, label, n=warm)
    if pinned:
        golden_rms(cfg, rows, label, golden=pinned)
    memory_line(torch, f"{label}, after its captures", card)
    return ran, shapes, calls


def one_row(cfg, L0, card, label, key):
    """``compute_psf`` of (1.0, 0.7, ``L0``) at 35 wavelengths and
    ``cfg``, counted: finite, the kernel ``key`` launched.  Returns the
    table, the cube and the launches."""
    from muse_psfr_tpu_torch import compute_psf
    from muse_psfr_tpu_torch.ops import _build
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    tbl, psf = compute_psf(LBDA, 1.0, 0.7, L0, verbose=False, cfg=cfg,
                           device="cuda")
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    print(f"compute_psf (1.0, 0.7, {L0:g}) x {LBDA.size} wavelengths, "
          f"{label}: {wall:.3f} s ({card}); launches {counts}")
    if not (np.all(np.isfinite(psf)) and np.all(np.isfinite(tbl["fwhm"]))
            and np.all(np.isfinite(tbl["n"]))):
        raise RuntimeError(f"compute_psf {label}: non-finite values")
    if counts.get(key, 0) < 1 or set(counts) - {key, "zoom_dft_tc"}:
        raise RuntimeError(f"compute_psf {label}: {key} must run, and no "
                           f"other kernel than K1 high: {counts}")
    return tbl, psf, counts


def against_1280(hi, lo, label):
    """FWHM within 0.02 arcsec of the same call at dim 1280 (the JAX
    package's ``test_highres_2048_mode`` bound); beta printed."""
    dfw = float(np.max(np.abs(hi["fwhm"][:, 0] - lo["fwhm"][:, 0])))
    dn = float(np.max(np.abs(hi["n"] - lo["n"])))
    print(f"{label} against dim 1280: FWHM {dfw:.3e} arcsec (limit 0.02), "
          f"beta {dn:.3e} at most")
    if not dfw < 0.02:
        raise RuntimeError(f"{label}: FWHM moved {dfw} from dim 1280")


def highres_kernels(torch, cfg, dev, rows, chunk_rows):
    """Phase 24a: K1 "high" at the three window shapes of the 2048 plan
    on its full-window chunk ``chunk_rows`` (25 rows x 35 wavelengths),
    and K3 at the one-row call's blue segment (1 row x 21 wavelengths,
    S=256), each against its plain version; the row splits the main
    path takes at each shape printed."""
    from muse_psfr_tpu_torch.ops.zoom_dft import M_TILE, N_TILE
    from muse_psfr_tpu_torch.otf.psf import _zoom_row_splits
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sub = tuple(a[chunk_rows] for a in rows)
    B = len(chunk_rows)

    def splits(nrow, nl, n, ncols):
        return _zoom_row_splits(nrow * nl * -(-ncols // N_TILE)
                                * -(-4 * cfg.dimpsf // M_TILE), n, sms)

    recs = {}
    for S in (0, 512, 256):
        c = cfg.with_(otf_support=S)
        half = c.otf_window[1]
        n, ncols = 2 * half, half + 128
        r = splits(B, LBDA.size, n, ncols)
        print(f"K1 high dim 2048, window {S or 'full'} ({n} x {ncols}), "
              f"{B} rows x {LBDA.size}: R={r} row splits on the main path")
        if r != 1:
            raise RuntimeError(f"a {B}-row chunk splits its rows: R={r}")
        recs[(n, ncols)] = dict(
            name=f"fused_exp_zoom@high,dim2048 (K1 _kernel_dirfull, {B} "
            f"rows x 35, window {n} x {ncols})",
            replaces=f"{JAX_ZOOM}:124,179",
            **check_zoom_kernel(torch, c, dev, sub, B, LBDA,
                                label=f"K1 high dim 2048 {n}x{ncols}"))
    blue, red = LBDA[:21], LBDA[21:]
    r = splits(1, blue.size, 512, 384)
    print(f"the one-row call at dim 2048 (S=512, 21 blue on S=256): R={r} "
          f"on its 512 x 384 segment, R={splits(1, red.size, 1024, 640)} "
          f"on its 1024 x 640 segment")
    if r < 2:
        raise RuntimeError(f"the one-row call's blue segment takes R={r}")
    k3 = dict(name=f"fused_exp_zoom_rowsplit@high,dim2048 (K3, 1 row x 21 "
              f"wavelengths, window 512 x 384, R={r})",
              replaces=f"{JAX_ZOOM}:145,179",
              **check_zoom_kernel(torch, cfg.with_(otf_support=256), dev,
                                  rows, 1, blue, row_splits=r,
                                  label="K3 high dim 2048 one row"))
    return recs, k3


def highres_phase(torch, dev, rows, card, guard_log):
    """Phase 24: the 2048^2 grid (``GalacsiConfig(dim=2048)``): the zoom
    kernels at its shapes (24a), the 1-direction night at the default
    config and FFT-free (24b), the 9-direction night (24c), one row
    through ``compute_psf`` (24d).  Returns the kernel records with their
    launches on the default-config night and on the one-row call."""
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.parallel import programs
    user = GalacsiConfig(dim=2048)
    with open(os.path.join(DATA, "golden_plan_night100_dim2048.json")) as fh:
        full_group = next(g for g in json.load(fh)["groups"]
                          if g["cfg_delta"].get("otf_support") is None
                          and g["nvals"] == g["sizes"])
    recs, k3 = highres_kernels(torch, user.with_(use_fft=False), dev, rows,
                               np.array(full_group["rows"]))
    fresh_pools(torch, "phase 24b, the 2048^2 nights", card)
    t0 = time.perf_counter()
    night = dict(lbda=LBDA, npsflin=1, cfg=user, chunk=25, device="cuda")
    golden = "golden_plan_night100_dim2048.json"
    _, shapes, _ = planned_night(
        torch, rows, night, golden, "2048^2 1-direction night, default "
        "config", card, guard_log, pinned=GOLDEN_2048)
    free = dict(night, cfg=user.with_(use_fft=False))
    planned_night(torch, rows, free, golden, "2048^2 1-direction night, "
                  "FFT-free", card, guard_log, pinned=GOLDEN_2048)
    print(f"  (phase 24b in {time.perf_counter() - t0:.1f} s)")
    for shape, rec in recs.items():
        rec["launches"] = shapes.get(shape, 0)
    print_programs(torch, programs.programs(), card)
    fresh_pools(torch, "phase 24c, the 9-direction 2048^2 night", card)
    t0 = time.perf_counter()
    planned_night(torch, rows, dict(night, npsflin=3),
                  "golden_plan_night100_dim2048_npsflin3.json",
                  "2048^2 9-direction night, default config", card,
                  guard_log, warm=1)
    print(f"  (phase 24c in {time.perf_counter() - t0:.1f} s)")
    print_programs(torch, programs.programs(), card)
    tbl, psf, counts = one_row(user, 25.0, card, "dim 2048",
                               "zoom_dft_tc_rowsplit")
    k3["launches"] = counts["zoom_dft_tc_rowsplit"]
    rms = float(np.sqrt(np.mean((psf - np.load(GOLDEN_2048)) ** 2)))
    print(f"compute_psf at dim 2048: rms {rms:.3e} vs the float64 oracle "
          f"{os.path.basename(GOLDEN_2048)} (limit 1e-5)")
    if not rms <= 1e-5:
        raise RuntimeError(f"compute_psf at dim 2048: rms {rms}")
    lo, _, _ = one_row(GalacsiConfig(), 25.0, card, "dim 1280",
                       "zoom_dft_tc_rowsplit")
    against_1280(tbl, lo, "compute_psf at dim 2048")
    return [*recs.values(), k3]


def exact_phase(torch, rows, card, guard_log):
    """Phase 25: the exact structure-function group (rows with L0 <
    ``dphi_split_l0_min``): the bench night with L0 = 2.0 on every tenth
    row at the default config and FFT-free (25a), one such row at dim 2048
    (25b), the 16 x 16 x 8 condition sweep with its L0 = 2.0 plane
    (25c).  Returns the exact-row nights' launches."""
    from muse_psfr_tpu_torch import compute_psf, condition_sweep
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.parallel import programs
    from muse_psfr_tpu_torch.parallel.batch import plan_batch
    user = GalacsiConfig()
    fresh_pools(torch, "phase 25, the exact group", card)
    L0 = rows[2].copy()
    L0[::10] = 2.0
    exact_rows = (rows[0], rows[1], L0, rows[3])
    night = dict(lbda=LBDA, npsflin=1, cfg=user, chunk=50, device="cuda")
    t0 = time.perf_counter()
    exact_launches = {}
    for label, kw in (("default config", night),
                      ("FFT-free", dict(night, cfg=user.with_(
                          use_fft=False)))):
        ran, _, calls = planned_night(
            torch, exact_rows, kw, "golden_plan_night100_exact.json",
            f"exact-row night, {label}", card, guard_log, warm=3,
            full=False, pinned=GOLDEN_EXACT)
        exact = [c for c in calls if c["route"] == "exact"]
        if not exact or any(c["window"] != "full" or c["shape"] != (
                user.dim, user.dim // 2 + 128) or c["launched"] != {
                "zoom_dft": 1} for c in exact):
            raise RuntimeError(f"the exact group must launch K1 at six "
                               f"passes once a chunk on the full window: "
                               f"{exact}")
        exact_launches[label] = ran
    print(f"  (phase 25a in {time.perf_counter() - t0:.1f} s)")

    hi, _, _ = one_row(user.with_(dim=2048), 2.0, card,
                       "dim 2048, exact group", "zoom_dft")
    lo, _, _ = one_row(user, 2.0, card, "dim 1280, exact group", "zoom_dft")
    against_1280(hi, lo, "compute_psf at L0 = 2.0, dim 2048")

    sv, gv = np.linspace(0.6, 1.6, 16), np.linspace(0.3, 0.9, 16)
    lv = np.array([2.0, 4.5, 8.0, 11.0, 14.0, 18.0, 23.0, 29.0])
    sweep = sweep_rows(16, lv)
    kw = dict(lbda=LBDA, cfg=user, chunk=64, device="cuda")
    plan = plan_batch(*sweep, LBDA, cfg=user, chunk=64)
    want = plan_kernels(plan.summary()["groups"], False)
    print(f"16 x 16 x 8 sweep's plan: {plan_line(plan)}")
    guard_log.trips.clear()
    _build.reset_launch_counts()
    t0 = time.perf_counter()
    res = condition_sweep(sv, gv, lv, **kw)
    wall = time.perf_counter() - t0
    counts = {k: v for k, v in _build.launch_counts().items() if v}
    print(f"condition_sweep 16 x 16 x 8 x {LBDA.size} wavelengths, chunk "
          f"64: {wall:.3f} s, the first sweep of the process ({card}); "
          f"launches {counts}; window-guard trips: {len(guard_log.trips)}")
    if counts != want:
        raise RuntimeError(f"the sweep launched {counts}, its plan says "
                           f"{want}")
    if not (res["fwhm"].shape == (16, 16, 8, LBDA.size)
            and np.all(np.isfinite(res["fwhm"]))
            and np.all(np.isfinite(res["beta"]))):
        raise RuntimeError(f"the sweep: shape {res['fwhm'].shape} or a "
                           "non-finite fit")
    i, j = int(np.argmin(np.abs(sv - 1.0))), int(np.argmin(np.abs(gv - 0.7)))
    one, _ = compute_psf(LBDA, sv[i], gv[j], 2.0, verbose=False, cfg=user,
                         device="cuda")
    dfw = float(np.max(np.abs(res["fwhm"][i, j, 0] / one["fwhm"][:, 0] - 1)))
    dn = float(np.max(np.abs(res["beta"][i, j, 0] / one["n"] - 1)))
    print(f"grid point ({sv[i]:.4f}, {gv[j]:.4f}, 2.0) against a one-row "
          f"compute_psf: FWHM {dfw:.3e}, beta {dn:.3e} relative (limit "
          f"1e-3)")
    if not (dfw <= 1e-3 and dn <= 1e-3):
        raise RuntimeError("the sweep departs from compute_psf")
    t0 = time.perf_counter()
    graph_against_eager("16 x 16 x 8 sweep's rows", sweep, kw)
    print(f"  (the sweep's rows replayed and eager in "
          f"{time.perf_counter() - t0:.1f} s)")
    t0 = time.perf_counter()
    condition_sweep(sv, gv, lv, **kw)
    print(f"condition_sweep 16 x 16 x 8, warmed (its programs replayed): "
          f"{time.perf_counter() - t0:.3f} s ({card})")
    print_programs(torch, programs.programs(), card)
    return exact_launches


def main(argv):
    import argparse
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", metavar="OUT",
                        help="also profile one warmed 1-direction night; "
                             "table to OUT")
    parser.add_argument("--profile-ndir9", metavar="OUT",
                        help="also profile one warmed 9-direction night")
    parser.add_argument("--profile-anchor", metavar="OUT",
                        help="also profile one warmed 9-direction night "
                             "with zoom_anchor=\"auto\"")
    parser.add_argument("--profile-default", metavar="OUT",
                        help="also profile one warmed 1-direction night at "
                             "the default config (use_fft=True)")
    parser.add_argument("--profile-sweep", metavar="OUT",
                        help="also profile process_batch on the 32 x 32 "
                             "sweep's 1024 rows at the default config")
    parser.add_argument("--profile-highest", metavar="OUT",
                        help="also profile one warmed 1-direction night at "
                             "zoom_precision=\"highest\"")
    parser.add_argument("--profile-ndir9-highest", metavar="OUT",
                        help="also profile one warmed 9-direction night at "
                             "zoom_precision=\"highest\"")
    parser.add_argument("--profile-2048", metavar="OUT",
                        help="also profile one warmed 1-direction night on "
                             "the 2048^2 grid at the default config, and "
                             "FFT-free -> OUT-fft-free")
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
    from muse_psfr_tpu_torch.utils.telemetry import night_rows

    t_start = time.perf_counter()

    def stamp(label):
        print(f"[{time.perf_counter() - t_start:.1f} s] {label}: done",
              flush=True)

    card = card_line()
    print(f"card: {card}")
    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    dev = resolve_device("cuda")
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import ab_zoom_tc
    zoom_mma_build = ab_zoom_tc.start_build()   # beside the package's
    t0 = time.perf_counter()
    lib = _build.library()
    print(f"built {[p.name for p in _build.sources()]} for sm_90a in "
          f"{time.perf_counter() - t0:.1f} s -> {lib._name}")
    for line in _build.BUILD_LOG.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print("  ptxas:", line.strip())
    guard_log = GuardLog()
    logging.getLogger("muse_psfr.batch").addHandler(guard_log)

    cfg = GalacsiConfig(use_fft=False)          # zoom_precision "high"
    top = cfg.with_(zoom_precision="highest")
    rows = night_rows(100)
    t0 = time.perf_counter()
    old = fma_bodies()
    print(f"built the float32 FMA bodies of tools/fma_bodies/ in "
          f"{time.perf_counter() - t0:.1f} s (the yardstick of \"highest\"; "
          f"the package never launches them)")
    # "highest": six bf16 passes, beside the FMA body that ran it before
    check_zoom_kernel(torch, top, dev, rows, 2, LBDA[:12], old=old)
    k1 = dict(name="fused_exp_zoom (K1 _kernel_dirfull, 6-pass bf16 tensor "
              "cores)", replaces=f"{JAX_ZOOM}:124,179",
              **check_zoom_kernel(torch, top, dev, rows, 50, LBDA, old=old,
                                  f64=True))
    k1_9 = dict(name="fused_exp_zoom@ndir9 (K1' _kernel, K4 "
                "_kernel_dirblock)", replaces=f"{JAX_ZOOM}:44,85,179",
                **check_zoom_kernel(torch, top, dev, rows, 4, LBDA,
                                    npsflin=3, label="K1 ndir=9", old=old))
    k3 = dict(name="fused_exp_zoom_rowsplit (K3 _kernel_rowacc)",
              replaces=f"{JAX_ZOOM}:145,179",
              **check_zoom_kernel(torch, top, dev, rows, 4, LBDA,
                                  npsflin=3, row_splits=2, label="K3",
                                  old=old))
    lb3 = np.array([500.0, 700.0, 900.0])
    r_cli = _zoom_row_splits(1 * 3 * 6, 512,
                             torch.cuda.get_device_properties(0)
                             .multi_processor_count)
    k3_cli = dict(name="fused_exp_zoom_rowsplit@cli (K3, 1 row x 3 "
                  f"wavelengths, S=256, R={r_cli})",
                  replaces=f"{JAX_ZOOM}:145,179",
                  **check_zoom_kernel(torch, top.with_(otf_support=256),
                                      dev, rows, 1, lb3, row_splits=r_cli,
                                      label="K3 CLI", old=old))
    # "high", the default: three passes, at the same shapes
    t1 = dict(name="fused_exp_zoom@high (K1 _kernel_dirfull, 3-pass bf16 "
              "tensor cores)", replaces=f"{JAX_ZOOM}:124,179",
              **check_zoom_kernel(torch, cfg, dev, rows, 50, LBDA,
                                  label="K1 high"))
    t1_9 = dict(name="fused_exp_zoom@high,ndir9 (K1' _kernel, K4 "
                "_kernel_dirblock)", replaces=f"{JAX_ZOOM}:44,85,179",
                **check_zoom_kernel(torch, cfg, dev, rows, 4, LBDA,
                                    npsflin=3, label="K1 high ndir=9"))
    t3 = dict(name="fused_exp_zoom_rowsplit@high (K3 _kernel_rowacc)",
              replaces=f"{JAX_ZOOM}:145,179",
              **check_zoom_kernel(torch, cfg, dev, rows, 4, LBDA,
                                  npsflin=3, row_splits=2, label="K3 high"))
    t3_cli = dict(name="fused_exp_zoom_rowsplit@high,cli (K3, 1 row x 3 "
                  f"wavelengths, S=256, R={r_cli})",
                  replaces=f"{JAX_ZOOM}:145,179",
                  **check_zoom_kernel(torch, cfg.with_(otf_support=256),
                                      dev, rows, 1, lb3, row_splits=r_cli,
                                      label="K3 high CLI"))
    k2 = check_conv_kernel(torch, cfg, dev, rows)
    t0 = time.perf_counter()
    mma_sync = mma_sync_body()
    print(f"built the mma.sync body of K2 high of tools/mma_sync_bodies/ in "
          f"{time.perf_counter() - t0:.1f} s (the yardstick of the wgmma "
          f"body; the package never launches it)")
    k2h = check_conv_high_kernel(torch, cfg, dev, rows, mma_sync)
    k5, k6, t5, t6 = check_disc_anchor_kernels(torch, cfg, dev, rows, old)
    ab = zoom_ab_phase(torch, dev, rows, zoom_mma_build)
    for rec, key, prec in ((t1, "k1", "high"), (k1, "k1", "highest"),
                           (t1_9, "k1_9", "high"), (k1_9, "k1_9", "highest"),
                           (t3, "k3", "high"), (k3, "k3", "highest"),
                           (t3_cli, "k3_cli", "high"),
                           (k3_cli, "k3_cli", "highest"),
                           (t5, "k5", "high"), (k5, "k5", "highest")):
        with_ab(rec, ab[key][prec])
    stamp("kernels against their plain versions and the mma.sync body "
          "(phases 2-7a, 17)")

    counts, cli_counts, night, exact1 = main_path(torch, cfg, rows, card)
    counts_top, cli_top = highest_night(top, rows, card, exact1[0])
    stamp("the 1-direction nights (phase 8)")
    counts9, night9, exact9 = ndir9_path(torch, cfg, rows, card, guard_log)
    counts9_top, exact9_top = ndir9_highest(top, rows, card, exact9)
    counts_disc = disc_night(cfg, rows, card, exact9)
    counts_disc_top = disc_night(top, rows, card, exact9_top, warm=0)
    counts_anchor = anchor_night(cfg, rows, card, guard_log, exact9)
    counts_anchor_top = anchor_night(top, rows, card, guard_log,
                                     exact9_top, warm=0, golden=False)
    stamp("the 9-direction nights (phases 9-11)")
    forced_redo(cfg, guard_log)
    counts_conv_high = conv_high_nights(cfg, rows, card, night, night9,
                                        exact1, exact9)
    stamp("the redo and the conv_precision=high nights (phases 12, 18)")

    # the user layer at the config a user gets (use_fft=True)
    user_cfg = GalacsiConfig()
    user = {"night1": default_config_night(
        user_cfg, rows, card, guard_log, night, exact1, "1-direction night",
        "golden_plan_night100.json", warm=5)}
    golden_rms(user_cfg, rows, "default config (use_fft=True)")
    user["night9"] = default_config_night(
        user_cfg, rows, card, guard_log, night9, exact9, "9-direction night",
        "golden_plan_night100_npsflin3.json", warm=3)
    stamp("the default-config nights (phase 13)")
    with tempfile.TemporaryDirectory() as tmp:
        user["sparta_file"] = sparta_file_path(user_cfg, rows, card, tmp)
        user["cli"] = real_cli(user_cfg, tmp)
        user["sweep"] = sweep_path(user_cfg, card, guard_log, tmp)
        stamp("the SPARTA file, the CLI and the sweep (phases 14-16)")
        user["full_night"] = full_night_example(user_cfg, card, tmp)
        user["sweep_example"] = sweep_example(user_cfg, card, tmp)
        installed_cli(card, tmp)
    stamp("the examples and the installed layout (phases 16a-16c)")
    matmul_tier_nights(cfg, user_cfg, rows, card, night)
    compat_path(card)
    stamp("the matmul tiers and compat (phases 19-20)")
    mesh = mesh_phase(torch, cfg, user_cfg, rows, card, guard_log, night9)
    stamp("the meshes (phase 21)")
    graphs = graphs_phase(torch, cfg, user_cfg, top, rows, card, guard_log,
                          night, night9)
    stamp("the chunk programs against the eager step (phase 22)")
    t1_bench = bench_phase(torch, rows, card, graphs["walls"][
        "1-direction night, default config"]["graphs"]["median"])
    stamp("the bench, bench_torch.py (phase 23)")
    highres = highres_phase(torch, dev, rows, card, guard_log)
    for rec in highres:
        for key in ((2048, 1152), (1024, 640), (512, 384)):
            if f"window {key[0]} x {key[1]})" in rec["name"]:
                with_ab(rec, ab[key]["high"])
    stamp("the 2048^2 grid (phase 24)")
    exact = exact_phase(torch, rows, card, guard_log)
    stamp("the exact structure-function group (phase 25)")
    k1["launches"] = counts_top["zoom_dft"]
    k1["exact_group_launches"] = {p: c["zoom_dft"] for p, c in exact.items()}
    k1_9["launches"] = counts9_top["zoom_dft"]
    k3["launches"] = k3_cli["launches"] = cli_top["zoom_dft_rowsplit"]
    k5["launches"] = counts_disc_top["zoom_dft_disc"]
    k6["launches"] = counts_anchor_top["zoom_dft_anchor"]
    t6["launches"] = counts_anchor["zoom_dft_tc_anchor"]
    k2["launches"] = counts["conv_dft"]
    k2h["launches"] = counts_conv_high["1-direction night"]["conv_dft_tc"]
    k2h["launches_ndir9"] = \
        counts_conv_high["9-direction night"]["conv_dft_tc"]
    t1["launches"] = counts["zoom_dft_tc"]
    t1["bench_launches"] = t1_bench
    t1_9["launches"] = counts9["zoom_dft_tc"]
    t3["launches"] = t3_cli["launches"] = cli_counts["zoom_dft_tc_rowsplit"]
    t5["launches"] = counts_disc["zoom_dft_tc_disc"]
    for rec, key in ((t1, "zoom_dft_tc"), (t3_cli, "zoom_dft_tc_rowsplit"),
                     (k2, "conv_dft"), (k2h, "conv_dft_tc")):
        rec["user_layer_launches"] = {p: c[key] for p, c in user.items()}
    for rec, key in ((t1, "zoom_dft_tc"), (k2, "conv_dft")):
        rec["mesh_launches"] = {
            p: ([c[key] for c in m["launches"]] if p == "two_ranks"
                else m["launches"][key])
            for p, m in mesh.items() if p != "walls_s"}
    kernels = [k1, k1_9, k3, k3_cli, k2, k5, k6, t1, t1_9, t3, t3_cli, t5,
               t6, k2h, *highres]
    idle = [k["name"] for k in kernels if k["launches"] < 1]
    if idle:
        raise RuntimeError(f"never launched on their paths: {idle}")
    stamp("every phase")
    flagged = [(args.profile, "1-direction night", rows, night),
               (args.profile_ndir9, "9-direction night", rows, night9),
               (args.profile_anchor, "9-direction night, zoom_anchor=auto",
                rows, dict(night9, cfg=cfg.with_(zoom_anchor="auto"))),
               (args.profile_default, "1-direction night, default config",
                rows, dict(night, cfg=user_cfg)),
               (args.profile_sweep, "32 x 32 sweep's rows", sweep_rows(),
                dict(lbda=LBDA, cfg=user_cfg, chunk=64, device="cuda")),
               (args.profile_highest, "1-direction night at highest", rows,
                dict(night, cfg=top)),
               (args.profile_ndir9_highest, "9-direction night at highest",
                rows, dict(night9, cfg=top))]
    if args.profile_2048:
        stem, ext = os.path.splitext(args.profile_2048)
        hi = dict(night, cfg=GalacsiConfig(dim=2048), chunk=25)
        flagged += [(args.profile_2048, "2048^2 1-direction night", rows, hi),
                     (stem + "-fft-free" + ext, "2048^2 1-direction night, "
                      "FFT-free", rows, dict(hi, cfg=hi["cfg"].with_(
                          use_fft=False)))]
    for path, label, r, kw in flagged:
        if path:
            stem, ext = os.path.splitext(path)
            for mode, out in (("graphs", path), ("eager", stem + "-eager"
                                                 + ext)):
                # phases 24-25 dropped every program, and a flagged
                # night may be new to the process
                profiled_shares(torch, r, dict(kw, _graphs=mode == "graphs"),
                                f"{label}, {mode}", card, out, warm=2)
    print(f"chip_smoke: all phases passed in "
          f"{time.perf_counter() - t_start:.1f} s")
    print(json.dumps({"kernels": kernels}))
    print(card)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
