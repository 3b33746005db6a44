"""Device time [us] per row of the library kernels of the model step:
cuBLAS/CUTLASS GEMMs (the structure function's block transform, the zoom's
second stage) and cuFFT (the final convolutions), over the traced batches'
rows."""

from bench_port.metrics import _kernels


def read(rec):
    if not rec["kernels"] or not rec["rows"]:
        return None
    us = _kernels.device_us(rec, "library")
    return us / rec["rows"] if us > 0 else None
