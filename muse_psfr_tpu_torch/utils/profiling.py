"""Profiling and tracing hooks.

Counterpart of ``muse_psfr_tpu/utils/profiling.py``, in three parts:

* **Stage markers** (:func:`stage`): an empty kernel per model stage
  (``csrc/stage_mark.cu``), launched on the card at the start of each
  stage of a chunk program and captured into its CUDA graph, so that a
  device trace can say which stage ran each kernel of a replay.  Always
  on; nothing on the CPU.
* **Spans** (:func:`span`): host intervals of the batch layer (``batch``
  with its ``plan``, ``push``, ``replay``, ``pull`` and ``redo``), kept in
  a bounded in-memory buffer (:func:`spans`) while a ``torch.profiler``
  session is active, and logged at DEBUG on the ``muse_psfr.profile``
  logger when that level is on.  With neither, a span costs one check.
  They are not ``record_function`` ranges: the profiler mirrors those onto
  the device's timeline, where they would read as device work.
* **Counters** (:func:`counters`): process-wide integers of the batch
  layer, always on.

A ``torch.profiler`` trace can be captured around a region by setting the
environment variable ``MUSE_PSFR_PROFILE_DIR`` (:func:`maybe_trace`; open
the Chrome trace written under ``<dir>/<label>/`` with Perfetto or
``chrome://tracing``).
"""

import itertools
import logging
import os
import threading
import time
from collections import deque, namedtuple
from contextlib import contextmanager

import torch

from ..ops import _build
from .log import get_logger

logger = get_logger("profile")

#: one recorded span; ``t0``/``t1`` from ``time.perf_counter_ns()``,
#: ``parent`` None for a span opened outside any other, ``batch`` the id of
#: the outermost ``batch`` span around it (None outside one)
Span = namedtuple("Span", "name batch id parent t0 t1 attrs")
#: the most spans the buffer keeps (the oldest go first)
MAX_SPANS = 65536
#: the counters, in the order :func:`counters` returns them: rows delivered
#: by ``process_batch``; rows its chunk programs computed (padding and redo
#: included); chunks whose window guard tripped; rows recomputed by the
#: surgical redo; ``plan_batch`` calls answered from its memo, and not;
#: rows whose split PSD the planner's admission model evaluated on the host
COUNTERS = ("rows", "rows_computed", "guard_trips", "redo_rows",
            "plan_memo_hits", "plan_memo_misses", "plan_psd_rows")

_SPANS = deque(maxlen=MAX_SPANS)
_COUNTS = dict.fromkeys(COUNTERS, 0)
_COUNTS_LOCK = threading.Lock()
_IDS = itertools.count(1)
_OPEN = threading.local()          # .stack: [(span id, batch id)]
_profiling = torch._C._autograd._profiler_enabled
#: the stage markers of ``csrc/stage_mark.cu``, in the order of their ids
STAGES = ("psd", "otf", "conv", "fit", "reduce", "end")


def stage(name, device):
    """Mark the start of model stage ``name`` (one of :data:`STAGES`) on
    the current stream of ``device``: one empty kernel on a card, nothing
    on the CPU."""
    if device.type == "cuda":
        _build.mark_stage(STAGES.index(name), device)


@contextmanager
def span(name, deltas=False, **attrs):
    """Time the body as span ``name`` with ``attrs``; the body may add
    attributes to the dict it is given.  Recorded while a
    ``torch.profiler`` session is active; with ``deltas`` the span also
    carries each counter's growth over the body, as ``attrs["counts"]``.
    Its wall is logged at DEBUG on ``muse_psfr.profile``."""
    record = _profiling()
    if not record and not logger.isEnabledFor(logging.DEBUG):
        yield attrs
        return
    stack = getattr(_OPEN, "stack", None)
    if stack is None:
        stack = _OPEN.stack = []
    parent, batch = stack[-1] if stack else (None, None)
    sid = next(_IDS)
    if batch is None and name == "batch":
        batch = sid
    before = counters() if record and deltas else None
    stack.append((sid, batch))
    t0 = time.perf_counter_ns()
    try:
        yield attrs
    finally:
        t1 = time.perf_counter_ns()
        stack.pop()
        logger.debug("span %-24s %8.3f ms", name, (t1 - t0) * 1e-6)
        if record:
            if before is not None:
                after = counters()
                attrs["counts"] = {k: after[k] - before[k] for k in COUNTERS}
            _SPANS.append(Span(name, batch, sid, parent, t0, t1, attrs))


def spans():
    """The recorded spans in the order they closed (a span after the spans
    inside it)."""
    return list(_SPANS)


def count(name, n=1):
    """Add ``n`` to counter ``name`` (one of :data:`COUNTERS`)."""
    with _COUNTS_LOCK:
        _COUNTS[name] += int(n)


def counters():
    """{counter: value} since the process started or the last reset."""
    with _COUNTS_LOCK:
        return dict(_COUNTS)


def reset():
    """Clear the spans and zero the counters."""
    _SPANS.clear()
    with _COUNTS_LOCK:
        for k in COUNTERS:
            _COUNTS[k] = 0


@contextmanager
def maybe_trace(label="muse_psfr", device="cpu"):
    """Capture a torch.profiler trace if MUSE_PSFR_PROFILE_DIR is set:
    CPU activity always, CUDA activity too when ``device`` is a card.  The
    Chrome trace is written to ``<dir>/<label>/trace.json``."""
    trace_dir = os.environ.get("MUSE_PSFR_PROFILE_DIR")
    if not trace_dir:
        yield
        return
    from torch.profiler import ProfilerActivity, profile
    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    out_dir = os.path.join(trace_dir, label)
    os.makedirs(out_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield
    prof.export_chrome_trace(os.path.join(out_dir, "trace.json"))
