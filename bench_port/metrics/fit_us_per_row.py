"""Device time [us] per row of the model step's ``fit`` stage, from its
stage marker to the next: the Moffat fit (``fit/moffat_fit.py:
fit_moffat_cube_packed``) of the chunk programs and of the mean refit,
over the traced batches' rows (``_stages.py``)."""

from bench_port.metrics import _stages


def read(rec):
    return _stages.per_row(rec, "fit")
