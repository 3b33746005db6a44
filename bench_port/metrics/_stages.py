"""The traced batches by model stage and the program's own spans and
counters, shared by the readers of the stage and row-yield metrics.

Stages come from the program's stage markers: empty kernels named
``psfr_stage<stage::NAME>`` that each chunk program launches at the start
of each of its stages (``muse_psfr_tpu_torch/utils/profiling.py:stage``)
and that its CUDA graph replays.  Kernels on the one replay stream run in
order, so a kernel belongs to the stage of the last marker that started
before it.  After an ``end`` marker, and before the first marker, the
kernels and copies are ``outside`` the programs: the eager ops of
``process_batch`` and each replay's copies in and out.  A marker's own time
goes to the stage it opens, ``end``'s to ``outside``.

Spans are the program's (``profiling.spans()``), recorded only while the
profiler runs, so in a traced run they are the traced batches' own; the
outermost ``batch`` span of each carries the counters' growth over it.  A
program without markers or spans (one older than them) reads nothing here,
nor does a record without a device trace.
"""

import re

from bench_port import tracing

MARK = re.compile(r"psfr_stage<(?:\w+::)*(\w+)>")
STAGES = ("psd", "otf", "conv", "fit", "reduce")
OUTSIDE = "outside"


def walk(rec):
    """``[(stage, name, start, end)]`` of the traced device events [us], in
    the order they started, each with the stage of the marker before it;
    None when no marker was traced."""
    out, cur, seen = [], OUTSIDE, False
    for name, a, b in sorted(rec["kernels"], key=lambda k: k[1]):
        m = MARK.search(name)
        if m:
            seen = True
            cur = OUTSIDE if m.group(1) == "end" else m.group(1)
        out.append((cur, name, a, b))
    return out if seen else None


def stage_us(rec):
    """{stage: device time [us]} of the traced batches, ``outside``
    included; None when no marker was traced."""
    events = walk(rec)
    if events is None:
        return None
    out = dict.fromkeys(STAGES + (OUTSIDE,), 0.0)
    for st, _, a, b in events:
        out[st] = out.get(st, 0.0) + (b - a)
    return out


def per_row(rec, stage):
    """Device time [us] of ``stage`` per traced row, None without markers."""
    us = stage_us(rec)
    if us is None or not rec["rows"]:
        return None
    return us[stage] / rec["rows"]


def program_spans():
    """The program's recorded spans; [] for a program that records none."""
    from muse_psfr_tpu_torch.utils import profiling
    spans = getattr(profiling, "spans", None)
    return list(spans()) if spans is not None else []


def host_ranges(rec):
    """``(start, end)`` [us, profiler clock] of each traced batch's
    ``bench_port.batch`` range, in order."""
    return sorted((a, b) for name, a, b in rec["cpu_ops"]
                  if name == tracing.SPAN)


def batches(rec, spans=None):
    """``[(outermost batch span, [every span of that batch])]`` of the
    traced batches, in order: the last as many outermost ``batch`` spans as
    the record has ``bench_port.batch`` ranges.  Empty without a device
    trace, without spans, or with fewer spans than ranges."""
    if not rec["kernels"]:
        return []
    spans = program_spans() if spans is None else spans
    tops = sorted((s for s in spans
                   if s.name == "batch" and s.parent is None),
                  key=lambda s: s.t0)
    n = len(host_ranges(rec))
    if not n or len(tops) < n:
        return []
    by = {}
    for s in spans:
        by.setdefault(s.batch, []).append(s)
    return [(b, by[b.id]) for b in tops[-n:]]


def counts(rec, spans=None):
    """The counters' growth summed over the traced batches (their outermost
    ``batch`` spans' ``counts``); None without them."""
    bs = batches(rec, spans)
    if not bs or any("counts" not in b.attrs for b, _ in bs):
        return None
    out = {}
    for b, _ in bs:
        for k, v in b.attrs["counts"].items():
            out[k] = out.get(k, 0) + v
    return out
