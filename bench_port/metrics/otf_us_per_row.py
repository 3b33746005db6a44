"""Device time [us] per row of the model step's ``otf`` stage, from its
stage marker to the next: the structure function and its window guard
(``otf/psf.py:dphi_base_split``) and the PSF cube (``psf_cube_from_base``:
the zoom kernel, its second stage and the combine), over the traced
batches' rows (``_stages.py``)."""

from bench_port.metrics import _stages


def read(rec):
    return _stages.per_row(rec, "otf")
