"""Device time [us] per row of the model step's ``conv`` stage, from its
stage marker to the next: the final convolutions (``otf/convolve.py:
convolve_final``), over the traced batches' rows (``_stages.py``)."""

from bench_port.metrics import _stages


def read(rec):
    return _stages.per_row(rec, "conv")
