#!/usr/bin/env python3
"""K1/K3/K5/K6 at zoom_precision "highest" (six bf16 passes on the tensor
cores) against the float32 FMA bodies that ran "highest" before, on one
CUDA card.

    python3 tools/ab_zoom_highest.py [--zoom OLD_ZOOM_CU]
                                     [--anchor OLD_ANCHOR_CU]

The old bodies are ``tools/fma_bodies/zoom_dft_fma.cu`` (entry point
``muse_fused_exp_zoom``: K1, K3 and, with a live-row table, K5) and
``tools/fma_bodies/zoom_anchor_fma.cu`` (``muse_fused_exp_zoom_anchor``:
K6), or any earlier version with those entry points, for example one
written out by ``git show <commit>:muse_psfr_tpu_torch/csrc/zoom_dft.cu``.
They are built with ``nvcc`` into ``build/ab_zoom_highest/``, apart from
the package's library, which never launches them.  On the inputs of
``chip_smoke.py``'s kernel phases (the full-window chunk of 50 rows x 35
wavelengths with its worst row against float64, 4 rows x 35 at 9
directions, K3 at the TPU and CLI shapes, K5, K6) the script prints, for
both bodies, the relative max-abs error against the plain PyTorch version,
their distance from each other, and their times from CUDA events, taken in
turns (old, new, new, old); at the CLI shape, where the host sets those
times, also the device's own by CUDA-graph replay.  Needs a CUDA card;
imports nothing of JAX.

``chip_smoke.py`` builds :class:`FmaBodies` for the same comparison.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OLD_DIR = os.path.join(ROOT, "tools", "fma_bodies")
_LOG2E = 1.4426950408889634


class FmaBodies:
    """The float32 FMA bodies as callables with the wrappers' arguments
    (operands on the card, float32, contiguous except ``dphi``, which
    needs unit column stride); no checks, no counters."""

    def __init__(self, zoom_src=os.path.join(OLD_DIR, "zoom_dft_fma.cu"),
                 anchor_src=os.path.join(OLD_DIR, "zoom_anchor_fma.cu")):
        sys.path.insert(0, ROOT)
        from muse_psfr_tpu_torch.ops import _build
        out = os.path.join(ROOT, "build", "ab_zoom_highest")
        os.makedirs(out, exist_ok=True)
        so = os.path.join(out, f"libfma_bodies.{os.getpid()}.so")
        subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o",
                        so, zoom_src, anchor_src], check=True,
                       capture_output=True)
        lib = ctypes.CDLL(so)
        os.unlink(so)
        ptr, i64, i32 = ctypes.c_void_p, ctypes.c_longlong, ctypes.c_int
        self._zoom = lib.muse_fused_exp_zoom
        self._zoom.argtypes = [ptr] * 8 + [i64] * 3 + [i32] * 8 + [ptr]
        self._anchor = lib.muse_fused_exp_zoom_anchor
        self._anchor.argtypes = [ptr] * 7 + [i64] * 3 + [i32] * 8 + [ptr]
        self._zoom.restype = self._anchor.restype = i32

    def zoom(self, dphi, dl, a2, alpha, w, exp2=False, row_splits=1,
             live=None):
        """K1, K3 (``row_splits`` > 1) or K5 (``live``: the (ncols/64, 2)
        int32 device table of live rows per column tile)."""
        import torch
        B, ndir, n, ncols = dphi.shape
        nl, m2 = a2.shape[:2]
        if exp2:
            alpha, w = alpha * _LOG2E, torch.log2(w)
        u = torch.empty((B, nl, m2, ncols), dtype=torch.float32,
                        device=dphi.device)
        ws = (torch.empty((row_splits,) + tuple(u.shape), dtype=torch.float32,
                          device=dphi.device) if row_splits > 1 else u)
        err = self._zoom(
            dphi.data_ptr(), dl.data_ptr(), a2.data_ptr(), alpha.data_ptr(),
            w.data_ptr(), 0 if live is None else live.data_ptr(),
            ws.data_ptr(), u.data_ptr(), *dphi.stride()[:3], B, ndir, n,
            ncols, nl, m2, row_splits, int(exp2),
            torch.cuda.current_stream(dphi.device).cuda_stream)
        if err:
            raise RuntimeError(f"the FMA zoom body failed to launch: {err}")
        return u

    def anchor(self, dphi, dl, a2, centre, astar, coef, group):
        """K6."""
        import torch
        B, ndir, n, ncols = dphi.shape
        nl, m2 = a2.shape[:2]
        u = torch.empty((B, nl, m2, ncols), dtype=torch.float32,
                        device=dphi.device)
        err = self._anchor(
            dphi.data_ptr(), dl.data_ptr(), a2.data_ptr(), centre.data_ptr(),
            astar.data_ptr(), coef.data_ptr(), u.data_ptr(),
            *dphi.stride()[:3], B, ndir, n, ncols, nl, m2, group,
            coef.shape[1], torch.cuda.current_stream(dphi.device).cuda_stream)
        if err:
            raise RuntimeError(f"the FMA anchor body failed to launch: {err}")
        return u


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--zoom", default=os.path.join(OLD_DIR,
                                                       "zoom_dft_fma.cu"),
                        help="an earlier zoom_dft.cu (FMA body of K1/K3/K5)")
    parser.add_argument("--anchor", default=os.path.join(
        OLD_DIR, "zoom_anchor_fma.cu"),
        help="an earlier zoom_anchor.cu (FMA body of K6)")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("ab_zoom_highest: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.ops import _build
    from muse_psfr_tpu_torch.otf.psf import _zoom_row_splits
    from muse_psfr_tpu_torch.utils.device import resolve_device
    from muse_psfr_tpu_torch.utils.telemetry import night_rows

    print(cs.card_line())
    dev = resolve_device("cuda")
    _build.library()
    for line in _build.BUILD_LOG.splitlines():
        if any(w in line for w in ("entry function", "registers", "spill")):
            print("  ptxas:", line.strip())
    old = FmaBodies(args.zoom, args.anchor)
    top = GalacsiConfig(use_fft=False, zoom_precision="highest")
    rows = night_rows(100)
    cs.check_zoom_kernel(torch, top, dev, rows, 2, cs.LBDA[:12], old=old)
    cs.check_zoom_kernel(torch, top, dev, rows, 50, cs.LBDA, old=old,
                         f64=True)
    cs.check_zoom_kernel(torch, top, dev, rows, 4, cs.LBDA, npsflin=3,
                         label="K1 ndir=9", old=old)
    cs.check_zoom_kernel(torch, top, dev, rows, 4, cs.LBDA, npsflin=3,
                         row_splits=2, label="K3", old=old)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    cs.check_zoom_kernel(torch, top.with_(otf_support=256), dev, rows, 1,
                         np.array([500.0, 700.0, 900.0]),
                         row_splits=_zoom_row_splits(1 * 3 * 6, 512, sms),
                         label="K3 CLI", old=old, device_times=True)
    cs.check_disc_anchor_kernels(torch, top.with_(zoom_precision="high"), dev,
                                 rows, old)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
