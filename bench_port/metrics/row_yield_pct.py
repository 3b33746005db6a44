"""Share [%] of the rows that the chunk programs computed that were rows
delivered: the program's counters ``rows`` over ``rows_computed``, summed
over the traced batches' ``batch`` spans (``_stages.py``).  Padding of
full-window and tail chunks, and rows redone after a tripped window guard,
lower it."""

from bench_port.metrics import _stages


def read(rec):
    c = _stages.counts(rec)
    if not c or not c.get("rows_computed"):
        return None
    return 100.0 * c["rows"] / c["rows_computed"]
