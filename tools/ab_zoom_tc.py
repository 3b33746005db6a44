#!/usr/bin/env python3
"""K1/K3/K5 and K6 on their wgmma bodies
(``muse_psfr_tpu_torch/csrc/zoom_dft_tc.cu``, ``csrc/zoom_anchor_tc.cu``)
against the mma.sync bodies they replaced, at both zoom_precision
settings, on one CUDA card.

    python3 tools/ab_zoom_tc.py

The old body is ``tools/mma_sync_bodies/zoom_dft_tc_mma.cu`` (entry points
``muse_fused_exp_zoom_tc_mma``, three passes, with A2's bf16 hi/lo split,
and ``muse_fused_exp_zoom_mma``, six passes, with A2 in float32: dphi, dl,
A2, alpha, w, live, ws, u, the three dphi strides, B, ndir, n, ncols, nl,
m2, row_splits, exp2, stream), built with ``nvcc`` beside
``csrc/zoom_dft.cu`` (K3's slab sum) into ``build/ab_zoom_tc/``, apart
from the package's library, which never launches it.  At every shape of
:data:`SHAPES` (the full-window chunk of 50 rows x 35 wavelengths, which at
"highest" is also the exact group's six-pass chunk; 4 rows x 35 at 9
directions; K3 at the TPU's and the CLI's shape; K5; the three window
shapes of the 2048^2 grid on 25 rows), on the operands of
``chip_smoke.py``'s kernel phases, the script prints for each body its
relative max-abs error against the plain PyTorch version at the
precision, the two bodies' distance, and their times from CUDA events in
turns (old, new, new, old); at the CLI shape, where the host sets those
times, the device's own by CUDA-graph replay.  The new body is held to
the limits of ``chip_smoke.py`` (2e-6 of max|U| at "high", 1e-6 at
"highest"); the old one is only printed.  Every timed call is a whole
wrapper call, A2's split included: the new wrapper splits A2 into its
bf16 parts by one launch on every call, the old one by ``split_bf16`` at
"high" (at "highest" the old bodies stage A2 in float32).

K6's old body is ``tools/mma_sync_bodies/zoom_anchor_tc_mma.cu`` (entry
points ``muse_fused_exp_zoom_anchor_tc_mma``, three passes, with A2's
bf16 hi/lo split, and ``muse_fused_exp_zoom_anchor_mma``, six passes,
with A2 in float32: dphi, dl, A2, centre, astar, coef, u, the three dphi
strides, B, ndir, n, ncols, nl, m2, group, deg1, stream), built into the
same library.  Its rows (:data:`ANCHOR_SHAPES`: the 9-direction chunk of
4 rows x 35 wavelengths at the planner's groups of 7 and degree 8, and
at the kernel's caps, groups of 8 and degree 11) print the same and
hold the new body to the old one bit for bit as well.  Needs a CUDA card;
imports nothing of JAX.  ``chip_smoke.py`` runs :func:`run` as a phase.
"""

import ctypes
import os
import subprocess
import sys

import numpy as np

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SRC = os.path.join(ROOT, "tools", "mma_sync_bodies", "zoom_dft_tc_mma.cu")
SRC_ANCHOR = os.path.join(ROOT, "tools", "mma_sync_bodies",
                          "zoom_anchor_tc_mma.cu")
OUT = os.path.join(ROOT, "build", "ab_zoom_tc")
_LOG2E = 1.4426950408889634
LIMITS = {"high": 2e-6, "highest": 1e-6}
LB3 = np.array([500.0, 700.0, 900.0])
#: (key, label, config fields, rows, wavelengths (None:
#: chip_smoke.LBDA), npsflin, row splits (None: the CLI's, from
#: _zoom_row_splits), K5)
SHAPES = [
    ("k1", "K1 full window 50 x 35", {}, 50, None, 1, 1, False),
    ("k1_9", "K1' ndir 9, 4 x 35", {}, 4, None, 3, 1, False),
    ("k3", "K3 TPU shape, 4 x 35, ndir 9, R=2", {}, 4, None, 3, 2, False),
    ("k3_cli", "K3 CLI, 1 x 3, S=256", {"otf_support": 256}, 1, LB3, 1,
     None, False),
    ("k5", "K5 4 x 35, ndir 9", {}, 4, None, 3, 1, True),
    ((2048, 1152), "K1 dim 2048, 2048 x 1152, 25 x 35", {"dim": 2048}, 25,
     None, 1, 1, False),
    ((1024, 640), "K1 dim 2048, 1024 x 640, 25 x 35",
     {"dim": 2048, "otf_support": 512}, 25, None, 1, 1, False),
    ((512, 384), "K1 dim 2048, 512 x 384, 25 x 35",
     {"dim": 2048, "otf_support": 256}, 25, None, 1, 1, False),
]
#: K6: (key, label, group (None: the planner's), degree (None: the
#: config's)), on the 9-direction chunk of 4 rows x 35 wavelengths
ANCHOR_SHAPES = [
    ("k6", "K6 ndir 9, 4 x 35", None, None),
    ("k6_cap", "K6 ndir 9, 4 x 35 at the caps", 8, 11),
]


def start_build():
    """Starts ``nvcc`` on the old bodies; :class:`MmaSyncZoom` waits for
    it.  Returns (process, library path)."""
    sys.path.insert(0, ROOT)
    from muse_psfr_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"libzoom_mma.{os.getpid()}.so")
    proc = subprocess.Popen(
        [_build._nvcc(), *_build.NVCC_FLAGS, "-I", str(_build.CSRC),
         "-shared", "-o", so, SRC, SRC_ANCHOR,
         str(_build.CSRC / "zoom_dft.cu")],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
    return proc, so


class MmaSyncZoom:
    """The mma.sync bodies as callables with the wrappers' arguments
    (operands on the card, float32, contiguous except ``dphi``, which
    needs unit column stride and, at "high", n a multiple of 8; for K6 at
    "highest" a multiple of 4); no checks, no counters."""

    def __init__(self, build=None):
        proc, so = build or start_build()
        log = proc.communicate()[0]
        if proc.returncode:
            raise RuntimeError(f"nvcc failed on {SRC} ({proc.returncode}):"
                               f"\n{log}")
        lib = ctypes.CDLL(so)
        os.unlink(so)
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        self._high = lib.muse_fused_exp_zoom_tc_mma
        self._high.argtypes = [ptr] * 9 + [i64] * 3 + [i32] * 8 + [ptr]
        self._top = lib.muse_fused_exp_zoom_mma
        self._top.argtypes = [ptr] * 8 + [i64] * 3 + [i32] * 8 + [ptr]
        self._high.restype = self._top.restype = i32
        self._anchor_high = lib.muse_fused_exp_zoom_anchor_tc_mma
        self._anchor_high.argtypes = ([ptr] * 8 + [i64] * 3 + [i32] * 8
                                      + [ptr])
        self._anchor_top = lib.muse_fused_exp_zoom_anchor_mma
        self._anchor_top.argtypes = ([ptr] * 7 + [i64] * 3 + [i32] * 8
                                     + [ptr])
        self._anchor_high.restype = self._anchor_top.restype = i32

    def zoom(self, dphi, dl, a2, alpha, w, exp2=False, row_splits=1,
             precision="highest", live=None):
        """K1, K3 (``row_splits`` > 1) or K5 (``live``: the (ncols/64, 2)
        int32 device table of live rows per column tile)."""
        import torch
        from muse_psfr_tpu_torch.ops.zoom_dft import split_bf16
        B, ndir, n, ncols = dphi.shape
        nl, m2 = a2.shape[:2]
        if exp2:
            alpha, w = alpha * _LOG2E, torch.log2(w)
        u = torch.empty((B, nl, m2, ncols), dtype=torch.float32,
                        device=dphi.device)
        ws = (torch.empty((row_splits,) + tuple(u.shape), dtype=torch.float32,
                          device=dphi.device) if row_splits > 1 else u)
        a2p = split_bf16(a2) if precision == "high" else (a2,)
        fn = self._high if precision == "high" else self._top
        err = fn(dphi.data_ptr(), dl.data_ptr(), *(p.data_ptr() for p in a2p),
                 alpha.data_ptr(), w.data_ptr(),
                 0 if live is None else live.data_ptr(), ws.data_ptr(),
                 u.data_ptr(), *dphi.stride()[:3], B, ndir, n, ncols, nl, m2,
                 row_splits, int(exp2),
                 torch.cuda.current_stream(dphi.device).cuda_stream)
        if err:
            raise RuntimeError(f"the mma.sync zoom body failed to launch: "
                               f"{err}")
        return u

    def anchor(self, dphi, dl, a2, centre, astar, coef, group,
               precision="highest"):
        """K6 with the wrapper's arguments."""
        import torch
        from muse_psfr_tpu_torch.ops.zoom_dft import split_bf16
        B, ndir, n, ncols = dphi.shape
        nl, m2 = a2.shape[:2]
        u = torch.empty((B, nl, m2, ncols), dtype=torch.float32,
                        device=dphi.device)
        a2p = split_bf16(a2) if precision == "high" else (a2,)
        fn = self._anchor_high if precision == "high" else self._anchor_top
        err = fn(dphi.data_ptr(), dl.data_ptr(), *(p.data_ptr() for p in a2p),
                 centre.data_ptr(), astar.data_ptr(), coef.data_ptr(),
                 u.data_ptr(), *dphi.stride()[:3], B, ndir, n, ncols, nl, m2,
                 group, coef.shape[1],
                 torch.cuda.current_stream(dphi.device).cuda_stream)
        if err:
            raise RuntimeError(f"the mma.sync anchor body failed to launch: "
                               f"{err}")
        return u


def compare(torch, label, args, kw, old, mask=None, device_times=False):
    """Both bodies on ``args`` at ``kw`` (exp2, row_splits, precision; K5
    with the block ``mask``): errors against the plain version, their
    distance, times in turns.  Raises if the new body is outside its
    limit."""
    import chip_smoke as cs
    from muse_psfr_tpu_torch.ops import zoom_dft
    prec = kw["precision"]
    if mask is None:
        def new():
            return zoom_dft.fused_exp_zoom(*args, **kw)
        want = zoom_dft.fused_exp_zoom_reference(*args, **kw)
        live = None
    else:
        def new():
            return zoom_dft.fused_exp_zoom_disc(*args, mask, **kw)
        want = zoom_dft.fused_exp_zoom_disc_reference(*args, mask, **kw)
        n, ncols = args[0].shape[2:]
        live = torch.as_tensor(zoom_dft.disc_live_rows(mask, n, ncols),
                               device=args[0].device)

    def mma():
        return old.zoom(*args, live=live, **kw)

    got, ref = new(), mma()
    torch.cuda.synchronize()
    _, e_new = cs.rel_err(torch, got, want)
    _, e_old = cs.rel_err(torch, ref, want)
    _, dist = cs.rel_err(torch, got, ref)
    del got, ref, want
    nrow, nl = args[0].shape[0], args[2].shape[0]
    reps = max(3, 240 // (nrow * nl))
    timer = cs.graph_ms if device_times else cs.cuda_ms
    t = cs.in_turns(torch, mma, new, reps, timer)
    how = "device times by CUDA-graph replay" if device_times else "times"
    print(f"A/B {label} at {prec}: relative to max|U| from the plain "
          f"version: wgmma {e_new:.3e} (limit {LIMITS[prec]:g}), mma.sync "
          f"{e_old:.3e}; apart {dist:.3e}; {how} [ms] in turns: mma.sync "
          f"{t['old'][0]:.4f}, wgmma {t['new'][0]:.4f}, wgmma "
          f"{t['new'][1]:.4f}, mma.sync {t['old'][1]:.4f}; "
          f"{min(t['old']) / min(t['new']):.2f}x", flush=True)
    if not e_new <= LIMITS[prec]:
        raise RuntimeError(f"A/B {label} at {prec}: the wgmma body lies "
                           f"{e_new} from its plain version")
    return {"label": label, "precision": prec, "rel_err": e_new,
            "mma_sync_rel_err": e_old, "apart": dist, "ms": t["new"],
            "mma_sync_ms": t["old"], "device_times": device_times}


def anchor_operands(torch, cfg, dev, rows, group=None, degree=None):
    """K6's operands on the 9-direction chunk of ``chip_smoke.py`` (4
    rows x 35 wavelengths, full window), in groups of ``group`` at
    ``degree`` (None: the planner's and the config's)."""
    import chip_smoke as cs
    from muse_psfr_tpu_torch.otf.psf import (_anchor_lambda_chunk,
                                             _anchor_operands, pupil_otf)
    base, dl, a2, alpha = cs.zoom_operands(torch, cfg, dev, rows, 4,
                                           cs.LBDA, 3)[:4]
    c = cfg.dim // 2
    k = group or _anchor_lambda_chunk(cfg, a2.shape[0])
    deg = degree or cfg.zoom_anchor_degree
    astar, coef = _anchor_operands(alpha, k, deg, base.shape[1]
                                   * float(pupil_otf(cfg)[c, c]))
    return base, dl, a2, base[:, :, c, c].contiguous(), astar, coef, k


def compare_anchor(torch, label, a6, prec, old):
    """K6 on both bodies at ``prec``: errors against the plain version,
    their distance, times in turns.  Raises if the new body is outside
    its limit or not bit-identical to the old one."""
    import chip_smoke as cs
    from muse_psfr_tpu_torch.ops import zoom_dft

    def new():
        return zoom_dft.fused_exp_zoom_anchor(*a6, precision=prec)

    def mma():
        return old.anchor(*a6, precision=prec)

    want = zoom_dft.fused_exp_zoom_anchor_reference(*a6, precision=prec)
    got, ref = new(), mma()
    torch.cuda.synchronize()
    _, e_new = cs.rel_err(torch, got, want)
    _, e_old = cs.rel_err(torch, ref, want)
    _, dist = cs.rel_err(torch, got, ref)
    del got, ref, want
    t = cs.in_turns(torch, mma, new, 3)
    label = f"{label}, groups of {a6[-1]}, degree {a6[5].shape[1] - 1}"
    print(f"A/B {label} at {prec}: relative to max|U| from the plain "
          f"version: wgmma {e_new:.3e} (limit {LIMITS[prec]:g}), mma.sync "
          f"{e_old:.3e}; apart {dist:.3e} (must be 0); times [ms] in turns: "
          f"mma.sync {t['old'][0]:.4f}, wgmma {t['new'][0]:.4f}, wgmma "
          f"{t['new'][1]:.4f}, mma.sync {t['old'][1]:.4f}; "
          f"{min(t['old']) / min(t['new']):.2f}x", flush=True)
    if not (e_new <= LIMITS[prec] and dist == 0.0):
        raise RuntimeError(f"A/B {label} at {prec}: the wgmma body lies "
                           f"{e_new} from its plain version and {dist} "
                           "from the mma.sync body")
    return {"label": label, "precision": prec, "rel_err": e_new,
            "mma_sync_rel_err": e_old, "apart": dist, "ms": t["new"],
            "mma_sync_ms": t["old"], "device_times": False}


def run(torch, dev, rows, old, shapes=SHAPES, anchor_shapes=ANCHOR_SHAPES):
    """Every shape of ``shapes`` at "high" and "highest"
    (:func:`compare`), then K6 at every shape of ``anchor_shapes``
    (:func:`compare_anchor`); returns {key: {precision: record}}."""
    import chip_smoke as cs
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.otf.psf import _disc_block_mask, _zoom_row_splits
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    out = {}
    for key, label, fields, nrow, lb, npsflin, r, disc in shapes:
        cfg = GalacsiConfig(use_fft=False, **fields)
        lb = cs.LBDA if lb is None else lb
        args = cs.zoom_operands(torch, cfg, dev, rows, nrow, lb, npsflin)
        cli = r is None
        if cli:
            n, ncols = args[0].shape[2:]
            r = _zoom_row_splits(nrow * len(lb) * -(-ncols // 64)
                                 * -(-args[2].shape[1] // 160), n, sms)
            label = f"{label}, R={r}"
        mask = _disc_block_mask(cfg) if disc else None
        for prec in ("high", "highest"):
            kw = dict(exp2=cfg.zoom_exp2, row_splits=r, precision=prec)
            out.setdefault(key, {})[prec] = compare(
                torch, label, args, kw, old, mask, device_times=cli)
        del args
        torch.cuda.empty_cache()
    cfg = GalacsiConfig(use_fft=False)
    for key, label, group, degree in anchor_shapes:
        a6 = anchor_operands(torch, cfg, dev, rows, group, degree)
        for prec in ("high", "highest"):
            out.setdefault(key, {})[prec] = compare_anchor(torch, label, a6,
                                                           prec, old)
        del a6
        torch.cuda.empty_cache()
    return out


def main():
    sys.path.insert(0, ROOT)
    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch
    if not torch.cuda.is_available():
        print("ab_zoom_tc: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.utils.device import resolve_device
    from muse_psfr_tpu_torch.utils.telemetry import night_rows
    build = start_build()
    print(cs.card_line())
    dev = resolve_device("cuda")
    _build.library()
    for line in cs.ptxas_report("fused_exp_zoom_wg_kernel"):
        print("  ptxas (wgmma body):", line)
    for line in cs.ptxas_report("fused_exp_zoom_anchor_wg_kernel"):
        print("  ptxas (K6 wgmma body):", line)
    run(torch, dev, night_rows(100), MmaSyncZoom(build))
    return 0


if __name__ == "__main__":
    sys.exit(main())
