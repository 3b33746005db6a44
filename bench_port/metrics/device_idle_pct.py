"""Share [%] of the traced batches' wall time in which no kernel or copy ran
on the card: 1 - (union of the device's event intervals) / (host wall from
the profiler's start to its stop around whole batches).  The profiler's own
host work lengthens that wall, so this reads above the share without it."""


def read(rec):
    if not rec["kernels"] or rec["window_s"] <= 0:
        return None
    return 100.0 * (1.0 - rec["busy_s"] / rec["window_s"])
