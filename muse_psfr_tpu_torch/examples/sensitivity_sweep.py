"""Map the PSF FWHM over a (seeing, GL) condition grid and plot it.

Counterpart of ``examples/sensitivity_sweep.py`` of the JAX package:

    python -m muse_psfr_tpu_torch.examples.sensitivity_sweep [n_grid] \\
        [out.png] [--device DEVICE]

Writes ``sweep.fits`` (and the checkpoint ``sweep_progress.npy``) in the
working directory, then the figure; the figure needs matplotlib.
``--device`` defaults to ``cuda`` and never falls back to the CPU.
"""

import argparse
import os
import time

import numpy as np

from ..api import condition_sweep, save_sweep
from ..config import DEFAULT_CONFIG, TINY_CONFIG

TINY = bool(os.environ.get("MUSE_PSFR_TINY"))
CFG = TINY_CONFIG if TINY else DEFAULT_CONFIG


def sweep(n, device="cuda"):
    """The n x n sweep at 500/700/900 nm with its checkpoint, written to
    ``sweep.fits``; returns the :func:`condition_sweep` result."""
    seeing = np.linspace(0.6, 1.6, n)
    gl = np.linspace(0.3, 0.9, n)
    t0 = time.perf_counter()
    res = condition_sweep(seeing, gl, [25.0], lbda=[500.0, 700.0, 900.0],
                          cfg=CFG, device=device,
                          checkpoint="sweep_progress.npy")
    print(f"{n * n} conditions in {time.perf_counter() - t0:.2f}s")
    save_sweep(res, "sweep.fits")
    return res


def plot(res, out):
    """FWHM maps, one panel per wavelength, to ``out``."""
    import matplotlib
    matplotlib.use("agg")
    import matplotlib.pyplot as plt
    fig, axes = plt.subplots(1, 3, figsize=(14, 4), sharey=True)
    for k, ax in enumerate(axes):
        im = ax.pcolormesh(res["seeing"], res["GL"],
                           res["fwhm"][:, :, 0, k].T, shading="auto")
        ax.set_title(f"FWHM [\"] at {int(res['lbda'][k])} nm")
        ax.set_xlabel("seeing [\"]")
        fig.colorbar(im, ax=ax)
    axes[0].set_ylabel("ground-layer fraction")
    fig.tight_layout()
    fig.savefig(out, dpi=120)
    print("wrote", out, "and sweep.fits")


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("n_grid", nargs="?", type=int,
                        default=3 if TINY else 16)
    parser.add_argument("out", nargs="?", default="sweep.png")
    parser.add_argument("--device", default="cuda",
                        help="torch device the sweep runs on (default: "
                             "cuda)")
    args = parser.parse_args(argv)
    res = sweep(args.n_grid, args.device)
    plot(res, args.out)


if __name__ == "__main__":
    main()
