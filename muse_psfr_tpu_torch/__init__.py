"""muse_psfr_tpu_torch — PSF reconstruction for MUSE WFM-AO on PyTorch/CUDA.

The PyTorch port of ``muse_psfr_tpu`` (which stays the reference): the
GLAO residual-PSD model, the PSD -> structure function -> OTF -> PSF
chain, the tip-tilt and instrument convolutions and the batched Moffat
fit, with the TPU kernels written by hand in CUDA for Hopper
(``csrc/``; built on first use, never at import), and the user layer
around them: SPARTA/FITS I/O, ``compute_psf_from_sparta``, the condition
sweep, the ``muse-psfr-torch`` CLI and the reference's own names
(``compat.py``).  Entry points take ``device=``
(default ``"cuda"``) and never fall back to the CPU; the batch entry
points also take ``mesh=`` (``default_mesh``) to shard rows over several
devices, in one process or one process each (``torch.distributed``).  This package
imports no JAX.
"""

__version__ = "1.10.0"

from .utils.log import setup_logging as _setup_logging

_setup_logging()

from .config import GalacsiConfig, DEFAULT_CONFIG, TINY_CONFIG  # noqa: E402
from .api import (  # noqa: E402
    compute_psf,
    compute_psf_from_sparta,
    condition_sweep,
    create_sparta_table,
    fit_psf_with_polynom,
    fit_table_from_arrays,
    save_sweep,
    MIN_L0,
    MAX_L0,
)
from .fit.moffat_fit import fit_moffat_cube  # noqa: E402
from .io.fits import (  # noqa: E402
    HDUList, PrimaryHDU, ImageHDU, BinTableHDU, fits_open,
)
from .io.table import FitTable  # noqa: E402
from .plotting import plot_psf, radial_profile  # noqa: E402
from .psd.model import simulate_psd, seeing_to_r0  # noqa: E402
from .otf.psf import psf_cube, pupil_otf  # noqa: E402
from .otf.convolve import convolve_final  # noqa: E402
from .parallel.batch import process_batch, reconstruct_batch  # noqa: E402
from .parallel.mesh import default_mesh  # noqa: E402

__all__ = [
    "GalacsiConfig", "DEFAULT_CONFIG", "TINY_CONFIG",
    "compute_psf", "compute_psf_from_sparta", "create_sparta_table",
    "fit_psf_with_polynom", "fit_table_from_arrays", "fit_moffat_cube",
    "MIN_L0", "MAX_L0",
    "HDUList", "PrimaryHDU", "ImageHDU", "BinTableHDU", "fits_open",
    "FitTable", "plot_psf", "radial_profile",
    "simulate_psd", "seeing_to_r0", "psf_cube", "pupil_otf", "convolve_final",
    "reconstruct_batch", "process_batch", "default_mesh", "condition_sweep",
    "save_sweep",
    "__version__",
]
