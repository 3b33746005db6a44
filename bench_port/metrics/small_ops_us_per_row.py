"""Device time [us] per row of the model step's small ops: the kernels that
are neither the port's own, nor cuBLAS/CUTLASS or cuFFT, nor copies (the
PSD model's, the OTF combine's and the LM fit's elementwise and reduction
kernels), over the traced batches' rows."""

from bench_port.metrics import _kernels


def read(rec):
    if not rec["kernels"] or not rec["rows"]:
        return None
    return _kernels.device_us(rec, "small") / rec["rows"]
