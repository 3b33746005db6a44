"""Device time [us] per row of the model step's ``psd`` stage, from its
stage marker to the next: the PSD model (``psd/model.py:
simulate_psd_split``, or ``simulate_psd``), over the traced batches' rows
(``_stages.py``)."""

from bench_port.metrics import _stages


def read(rec):
    return _stages.per_row(rec, "psd")
