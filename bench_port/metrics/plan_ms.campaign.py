"""Host wall time [ms] of the program's planner, ``plan_batch``, on fresh
batches of the cell's mix (one per pool batch, each new telemetry so that
nothing is memoised), called by the harness with the arguments that
``process_batch`` passes it; the mean over them."""


def read(rec):
    ms = rec.get("plan_ms") or []
    return sum(ms) / len(ms) if ms else None
