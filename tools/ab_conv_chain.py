#!/usr/bin/env python3
"""K2 of this tree against an earlier body on one CUDA card.

    python3 tools/ab_conv_chain.py OLD_CONV_DFT_CU [--reps 50]
    python3 tools/ab_conv_chain.py --tc [--reps 50]

The first form holds the float32 body ("highest") against
``OLD_CONV_DFT_CU``, an earlier version of
``muse_psfr_tpu_torch/csrc/conv_dft.cu`` whose entry point
``muse_fused_conv_chain`` takes the six trimmed transform matrices
(planes, gtt_r, gtt_i, gi_r, gi_i, csn, crc, crs, csel, cdc, cds, out, B,
nl, n, L, stream), for example one written out by ``git show
<commit>:muse_psfr_tpu_torch/csrc/conv_dft.cu``.

The second holds the tensor-core body (``conv_precision="high"``, the
wgmma body of ``csrc/conv_dft_tc.cu``) against the mma.sync body it
replaced, ``tools/mma_sync_bodies/conv_dft_tc_mma.cu`` (entry point
``muse_fused_conv_chain_tc_mma``: planes, gtt_r, gtt_i, gi_r, gi_i, C, S,
out, B, nl, n, L, off, stream).

Either old body is built with ``nvcc`` into ``build/ab_conv_chain/``,
apart from the package's library, which never launches it.  On the inputs
of ``chip_smoke.py``'s K2 phases (50 rows x 35 planes of 40 x 40, the
real Moffat spectra) the script prints, for both bodies, the relative
max-abs error against the plain PyTorch version at their precision and
against the float64 chain, whether each is bit-identical on a rerun and
whether the two agree bit for bit, and their times from CUDA events,
taken in turns (old, new, new, old).  Needs a CUDA card; imports nothing
of JAX.  ``chip_smoke.py`` builds :class:`MmaSyncBody` for the same
comparison.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
OUT = os.path.join(ROOT, "build", "ab_conv_chain")


def _load(src, name, extra=()):
    sys.path.insert(0, ROOT)
    from muse_psfr_tpu_torch.ops import _build
    os.makedirs(OUT, exist_ok=True)
    so = os.path.join(OUT, f"lib{name}.{os.getpid()}.so")
    proc = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, *extra,
                           "-shared", "-o", so, src], capture_output=True,
                          text=True)
    if proc.returncode:
        raise RuntimeError(f"nvcc failed on {src} ({proc.returncode}):\n"
                           f"{proc.stdout}{proc.stderr}")
    lib = ctypes.CDLL(so)
    os.unlink(so)
    return lib


def build_old(src):
    fn = _load(src, "old_conv_chain").muse_fused_conv_chain
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


class MmaSyncBody:
    """The mma.sync body of K2 at "high" as a callable with the wrapper's
    arguments (operands on the card, float32, contiguous); no checks, no
    counter."""

    def __init__(self):
        csrc = os.path.join(ROOT, "muse_psfr_tpu_torch", "csrc")
        src = os.path.join(ROOT, "tools", "mma_sync_bodies",
                           "conv_dft_tc_mma.cu")
        self._fn = _load(src, "mma_sync_conv_chain",
                         ("-I", csrc)).muse_fused_conv_chain_tc_mma
        self._fn.argtypes = [ctypes.c_void_p] * 8 + [ctypes.c_int] * 5 \
            + [ctypes.c_void_p]
        self._fn.restype = ctypes.c_int

    def __call__(self, planes, gtt_r, gtt_i, gi_r, gi_i, n_ker):
        import torch
        from muse_psfr_tpu_torch.otf.convolve import _dft_mats
        B, nl, n, _ = planes.shape
        L = gtt_r.shape[-1]
        c, s = _dft_mats(L, planes.device, torch.float32)
        out = torch.empty_like(planes)
        err = self._fn(*(x.data_ptr() for x in (planes, gtt_r, gtt_i, gi_r,
                                                 gi_i, c, s, out)),
                       B, nl, n, L, (n_ker - 1) // 2,
                       torch.cuda.current_stream(planes.device).cuda_stream)
        if err:
            raise RuntimeError(f"the mma.sync body failed to launch: {err}")
        return out


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old", nargs="?",
                        help="an earlier conv_dft.cu (float32 body)")
    parser.add_argument("--tc", action="store_true",
                        help="hold the tensor-core body against the "
                             "mma.sync body")
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args(argv)
    if (args.old is None) != args.tc:
        parser.error("give either OLD_CONV_DFT_CU or --tc")
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("ab_conv_chain: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.ops import conv_dft
    from muse_psfr_tpu_torch.utils.device import resolve_device
    from muse_psfr_tpu_torch.utils.telemetry import night_rows

    print(cs.card_line())
    dev = resolve_device("cuda")
    cfg = GalacsiConfig(use_fft=False)
    kargs, _, s64 = cs.conv_inputs(torch, cfg, dev, night_rows(100))
    planes, nk = kargs[0], kargs[-1]
    B, nl, n, _ = planes.shape
    L = kargs[1].shape[-1]
    precision = "high" if args.tc else "highest"
    if not args.tc:
        mats = conv_dft._mats(L, n, (nk - 1) // 2, dev, torch.float32)
        old_fn = build_old(args.old)
        stream = torch.cuda.current_stream().cuda_stream

        def old():
            out = torch.empty_like(planes)
            err = old_fn(*(x.data_ptr() for x in kargs[:5]),
                         *(m.data_ptr() for m in mats), out.data_ptr(), B,
                         nl, n, L, stream)
            if err:
                raise RuntimeError(f"the old body failed to launch: {err}")
            return out
    else:
        body = MmaSyncBody()

        def old():
            return body(*kargs)

    def new():
        return conv_dft.fused_conv_chain(*kargs, precision=precision)

    want = conv_dft.fused_conv_chain_reference(*kargs, precision=precision)
    w64 = conv_dft.fused_conv_chain_reference(planes.double(), *s64, nk)
    outs = {"old": old(), "new": new()}
    again = {"old": old(), "new": new()}
    torch.cuda.synchronize()
    for name, y in outs.items():
        print(f"{name}: relative max-abs against the plain version at "
              f"{precision!r} {cs.rel_err(torch, y, want)[1]:.3e}, against "
              f"the float64 chain {cs.rel_err(torch, y, w64)[1]:.3e}; "
              f"bit-identical on a rerun: "
              f"{bool(torch.equal(y, again[name]))}")
    print(f"plain version against the float64 chain "
          f"{cs.rel_err(torch, want, w64)[1]:.3e}; old and new bit-identical:"
          f" {bool(torch.equal(outs['old'], outs['new']))}")
    times = []
    for name, fn in (("old", old), ("new", new), ("new", new), ("old", old)):
        times.append((name, cs.cuda_ms(torch, fn, args.reps)))
    print("times [ms] in turns: " + ", ".join(f"{k} {v:.4f}"
                                              for k, v in times))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
