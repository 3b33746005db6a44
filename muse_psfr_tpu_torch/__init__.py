"""muse_psfr_tpu_torch — PSF reconstruction for MUSE WFM-AO on PyTorch/CUDA.

The PyTorch port of ``muse_psfr_tpu`` (which stays the reference): the
GLAO residual-PSD model, the PSD -> structure function -> OTF -> PSF
chain, the tip-tilt and instrument convolutions and the batched Moffat
fit, with the two TPU kernels of the main path written by hand in CUDA
for Hopper (``csrc/``; built on first use, never at import).  Entry
points take ``device=`` (default ``"cuda"``) and never fall back to the
CPU.  This package imports no JAX.
"""

__version__ = "1.10.0"

from .utils.log import setup_logging as _setup_logging

_setup_logging()

from .config import GalacsiConfig, DEFAULT_CONFIG, TINY_CONFIG  # noqa: E402
from .api import compute_psf, fit_table_from_arrays  # noqa: E402
from .parallel.batch import process_batch, reconstruct_batch  # noqa: E402

__all__ = [
    "GalacsiConfig", "DEFAULT_CONFIG", "TINY_CONFIG", "compute_psf",
    "fit_table_from_arrays", "process_batch", "reconstruct_batch",
    "__version__",
]
