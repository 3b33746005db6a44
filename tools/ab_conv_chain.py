#!/usr/bin/env python3
"""K2 of this tree against an earlier ``conv_dft.cu`` on one CUDA card.

    python3 tools/ab_conv_chain.py OLD_CONV_DFT_CU [--reps 50]

``OLD_CONV_DFT_CU`` is an earlier version of
``muse_psfr_tpu_torch/csrc/conv_dft.cu`` whose entry point
``muse_fused_conv_chain`` takes the six trimmed transform matrices
(planes, gtt_r, gtt_i, gi_r, gi_i, csn, crc, crs, csel, cdc, cds, out, B,
nl, n, L, stream), for example one written out by ``git show
<commit>:muse_psfr_tpu_torch/csrc/conv_dft.cu``.  It is built with ``nvcc``
into ``build/ab_conv_chain/``.  On the inputs of ``chip_smoke.py``'s K2
phase (50 rows x 35 planes of 40 x 40, the real Moffat spectra) the script
prints, for both bodies, the relative max-abs error against the plain
PyTorch version and against the float64 chain, whether the two agree bit
for bit, and their times from CUDA events, taken in turns (old, new, new,
old).  Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import ctypes
import os
import subprocess
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def build_old(src):
    from muse_psfr_tpu_torch.ops import _build
    out = os.path.join(ROOT, "build", "ab_conv_chain")
    os.makedirs(out, exist_ok=True)
    so = os.path.join(out, "libold_conv_chain.so")
    subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", so,
                    src], check=True)
    fn = ctypes.CDLL(so).muse_fused_conv_chain
    fn.argtypes = [ctypes.c_void_p] * 12 + [ctypes.c_int] * 4 \
        + [ctypes.c_void_p]
    fn.restype = ctypes.c_int
    return fn


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("old", help="an earlier conv_dft.cu")
    parser.add_argument("--reps", type=int, default=50)
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch
    if not torch.cuda.is_available():
        print("ab_conv_chain: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.ops import conv_dft
    from muse_psfr_tpu_torch.utils.device import resolve_device

    print(cs.card_line())
    dev = resolve_device("cuda")
    cfg = GalacsiConfig(use_fft=False)
    kargs, _, s64 = cs.conv_inputs(torch, cfg, dev, cs.build_rows(100))
    planes, nk = kargs[0], kargs[-1]
    B, nl, n, _ = planes.shape
    L = kargs[1].shape[-1]
    mats = conv_dft._mats(L, n, (nk - 1) // 2, dev, torch.float32)
    old_fn = build_old(args.old)
    stream = torch.cuda.current_stream().cuda_stream

    def old():
        out = torch.empty_like(planes)
        err = old_fn(*(x.data_ptr() for x in kargs[:5]),
                     *(m.data_ptr() for m in mats), out.data_ptr(), B, nl,
                     n, L, stream)
        if err:
            raise RuntimeError(f"the old body failed to launch: {err}")
        return out

    def new():
        return conv_dft.fused_conv_chain(*kargs)

    want = conv_dft.fused_conv_chain_reference(*kargs)
    w64 = conv_dft.fused_conv_chain_reference(planes.double(), *s64, nk)
    outs = {"old": old(), "new": new()}
    torch.cuda.synchronize()
    for name, y in outs.items():
        print(f"{name}: relative max-abs against the plain version "
              f"{cs.rel_err(torch, y, want)[1]:.3e}, against the float64 "
              f"chain {cs.rel_err(torch, y, w64)[1]:.3e}")
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
