"""Profiling and tracing hooks.

Counterpart of ``muse_psfr_tpu/utils/profiling.py``: every batch API can
report per-stage wall times at DEBUG level, and a ``torch.profiler``
trace can be captured around any region by setting the environment
variable ``MUSE_PSFR_PROFILE_DIR`` (open the Chrome trace written under
``<dir>/<label>/`` with Perfetto or ``chrome://tracing``).
"""

import os
import time
from contextlib import contextmanager

from .log import get_logger

logger = get_logger("profile")


@contextmanager
def stage_timer(name):
    """Log the wall time of a stage at DEBUG level."""
    t0 = time.perf_counter()
    try:
        yield
    finally:
        logger.debug("stage %-24s %8.3f ms", name,
                     (time.perf_counter() - t0) * 1e3)


@contextmanager
def maybe_trace(label="muse_psfr", device="cpu"):
    """Capture a torch.profiler trace if MUSE_PSFR_PROFILE_DIR is set:
    CPU activity always, CUDA activity too when ``device`` is a card.  The
    Chrome trace is written to ``<dir>/<label>/trace.json``."""
    trace_dir = os.environ.get("MUSE_PSFR_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    import torch
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(trace_dir, label)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
