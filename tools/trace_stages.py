#!/usr/bin/env python3
"""Where a traced run of a benchmark cell spends the card's time, by the
program's stage markers and spans (``utils/profiling.py``), on one CUDA
card:

    python3 tools/trace_stages.py --workload wfm1-night100 --seed <n> \\
        --seconds <s> [--out FILE]

from the root of a checkout.  It runs the cell as ``bench_port/run.py
--trace 1`` does (set-up, then the closed-loop window with the traced
batches under ``torch.profiler``; no output check) and prints one JSON
line: device time per stage and night (``psd``, ``otf``, ``conv``,
``fit``, ``reduce``, ``outside``), split by kernel class, and their sum
against ``busy_s``; the device's idle time per night by the host span
open over it (``plan``, ``push``, ``replay``, ``pull``, ``none``); the
host time per night of each span of the traced batches; the residual of
the spans' clock offset, and each batch's start and end offsets from it;
the markers' own device time per row; the traced
batches' walls against the untraced ones; the host walls of the spans of
untraced batches, from their DEBUG log lines; what a span costs the host
with the profiler off and on, and the span buffer's bytes; the counters'
growth over the traced batches; and every per-layer reader of the cell.
"""

import argparse
import json
import logging
import os
import statistics
import sys
import time

ROOT = os.getcwd()
sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(
    __file__))))
sys.path.insert(0, ROOT)

from bench_port import harness, tracing  # noqa: E402
from bench_port.metrics import _kernels, _stages  # noqa: E402
from bench_port.traffic.generator import Traffic  # noqa: E402


def _span_cost_ns(n=20000):
    """Host cost [ns] of one empty span with the profiler off and on."""
    from torch.profiler import ProfilerActivity, profile
    from muse_psfr_tpu_torch.utils import profiling

    def loop():
        t0 = time.perf_counter_ns()
        for _ in range(n):
            with profiling.span("cost"):
                pass
        return (time.perf_counter_ns() - t0) / n

    off = loop()
    with profile(activities=[ProfilerActivity.CPU]):
        on = loop()
    return off, on


#: the host spans an idle gap of the device is charged to (the program
#: never opens one inside another)
HOST = ("plan", "push", "replay", "pull")


def _class_ms(rec, nights):
    """{stage: {kernel class: device ms a night}}."""
    out = {}
    for st, name, a, b in _stages.walk(rec):
        cls = _kernels.kernel_class(name, rec["classes"])
        row = out.setdefault(st, {})
        row[cls] = row.get(cls, 0.0) + (b - a) * 1e-3 / nights
    return out


def span_ms(rec, spans):
    """{span name: host time [ms] a traced batch} (the nested redo's spans
    included); None without spans."""
    bs = _stages.batches(rec, spans)
    if not bs:
        return None
    out = {}
    for _, ss in bs:
        for s in ss:
            out[s.name] = out.get(s.name, 0.0) + (s.t1 - s.t0) * 1e-6
    return {k: v / len(bs) for k, v in out.items()}


def batch_offsets(rec, spans):
    """Each traced batch's offset [us] from the program's clock
    (``t1 / 1e3``) to the profiler's: its ``bench_port.batch`` range's end
    minus its outermost ``batch`` span's (the harness closes the range as
    the call returns; between the starts lies its ``synchronize``)."""
    return [e - b.t1 * 1e-3
            for (_, e), (b, _) in zip(_stages.host_ranges(rec),
                                      _stages.batches(rec, spans))]


def clock_offset(rec, spans):
    """``(offset, residual)`` [us]: the median of :func:`batch_offsets` and
    the largest distance of one batch's from it.  The first traced batch's
    range also holds the profiler's start-up, so one batch may stand apart.
    None without spans."""
    offs = sorted(batch_offsets(rec, spans))
    if not offs:
        return None
    med = statistics.median(offs)
    return med, max(abs(o - med) for o in offs)


def idle_by_span(rec, spans):
    """{host span or ``none``: device idle time [us]} within the traced
    batches' ``bench_port.batch`` ranges: each idle gap of the device
    charged to the host spans of :data:`HOST` of its batch open over it
    (placed by :func:`clock_offset`), the rest to ``none``.  None without
    spans."""
    off = clock_offset(rec, spans)
    if off is None:
        return None
    busy = tracing.merged([(a, b) for _, a, b in rec["kernels"]])
    out = dict.fromkeys(HOST + ("none",), 0.0)
    for (lo, hi), (_, ss) in zip(_stages.host_ranges(rec),
                                 _stages.batches(rec, spans)):
        host = sorted((s.t0 * 1e-3 + off[0], s.t1 * 1e-3 + off[0], s.name)
                      for s in ss if s.name in HOST)
        edges = [lo]
        for a, b in busy:
            if b > lo and a < hi:
                edges += [max(a, lo), min(b, hi)]
        edges.append(hi)
        for a, b in zip(edges[0::2], edges[1::2]):
            if b <= a:
                continue
            out["none"] += b - a
            for c, d, name in host:
                if c >= b:
                    break
                x = min(b, d) - max(a, c)
                if x > 0:
                    out[name] += x
                    out["none"] -= x
    return out


def _untraced_walls(program, traffic, args, k0, n):
    """Host wall [ms] a night of each span name over ``n`` untraced
    batches from ``k0`` on (fresh telemetry), read from the spans' DEBUG
    lines on ``muse_psfr.profile``."""
    from muse_psfr_tpu_torch.utils import profiling
    lines = []

    class Keep(logging.Handler):
        def emit(self, record):
            lines.append(record.getMessage())

    log = profiling.logger
    keep, level, propagate = Keep(logging.DEBUG), log.level, log.propagate
    log.addHandler(keep)
    log.setLevel(logging.DEBUG)
    log.propagate = False
    try:
        for k in range(k0, k0 + n):
            program.process(traffic.batch(k), *args)
    finally:
        log.removeHandler(keep)
        log.setLevel(level)
        log.propagate = propagate
    out = {}
    for line in lines:
        _, name, ms, _ = line.split()
        out[name] = out.get(name, 0.0) + float(ms) / n
    return out


def _span_bytes(spans):
    """Mean bytes of one recorded span: the tuple, its fields and its
    attributes, one level of nesting deep."""
    def size(x):
        n = sys.getsizeof(x)
        if isinstance(x, dict):
            n += sum(size(k) + size(v) for k, v in x.items())
        return n

    if not spans:
        return None
    return statistics.mean(sys.getsizeof(s) + sum(size(f) for f in s)
                           for s in spans)


def report(cell, seed, seconds, device="cuda"):
    """The stage table of one traced run of ``cell``
    (``harness.load_cell``)."""
    from muse_psfr_tpu_torch.utils import profiling
    config, mix, cellf = cell["config"], cell["mix"], cell["cell"]
    program = harness.Program(config["program"], device)
    lbda = harness.wavelengths(config)
    h = tuple(config["h_m"])
    npsflin = int(config["npsflin"])
    chunk = int(cellf["chunk"])
    traffic = Traffic(mix, seed)
    program.build()
    harness.warm(program, traffic, lbda, h, npsflin, chunk)
    profiling.reset()
    tracer = tracing.Tracer(program, int(mix["trace_batches"]))
    win = harness.window(program, traffic, lbda, h, npsflin, chunk, seconds,
                         profile=tracer.profile,
                         min_batches=tracer.last + 1)
    rec = tracer.record(traffic, lbda, h, npsflin, chunk, harness.load_json(
        os.path.join(harness.HERE, "metrics", "kernel_classes.json")))
    spans = profiling.spans()
    nights = len(tracer.batches)
    out = {"nights": nights, "rows": rec["rows"], "errors": win["errors"],
           "captured": win["captured"], "busy_ms": rec["busy_s"] * 1e3 /
           nights, "window_ms": rec["window_s"] * 1e3 / nights}
    us = _stages.stage_us(rec)
    if us is not None:
        out["stage_ms"] = {k: v * 1e-3 / nights for k, v in us.items()}
        out["stage_sum_over_busy"] = sum(us.values()) / (rec["busy_s"] * 1e6)
        out["stage_class_ms"] = _class_ms(rec, nights)
        out["marker_us_per_row"] = sum(
            b - a for name, a, b in rec["kernels"]
            if _stages.MARK.search(name)) / rec["rows"]
    idle = idle_by_span(rec, spans)
    if idle is not None:
        out["idle_ms"] = {k: v * 1e-3 / nights for k, v in idle.items()}
        out["span_ms"] = span_ms(rec, spans)
        off, out["clock_residual_us"] = clock_offset(rec, spans)
        out["batch_offsets_us"] = [
            (a - b.t0 * 1e-3 - off, e - b.t1 * 1e-3 - off)
            for (a, e), (b, _) in zip(_stages.host_ranges(rec),
                                      _stages.batches(rec, spans))]
    out["counts"] = _stages.counts(rec, spans)
    lat = win["latencies"]
    traced = lat[tracer.first:tracer.last + 1]
    rest = lat[:tracer.first] + lat[tracer.last + 1:]
    out["wall_ms"] = {"traced": [x * 1e3 for x in traced],
                      "untraced_median": statistics.median(rest) * 1e3
                      if rest else None,
                      "untraced_n": len(rest)}
    out["untraced_span_ms"] = _untraced_walls(
        program, traffic, (lbda, h, npsflin, chunk), win["attempted"] + 100,
        nights)
    out["span_ns"] = dict(zip(("off", "on"), _span_cost_ns()))
    out["span_bytes"] = _span_bytes(spans)
    out["spans"] = len(spans)
    out["metrics"] = {m["name"]: harness.reader(m["name"])(rec)
                      for m in cell["per_layer"]}
    out["breakdown"] = rec["breakdown"]
    program.free()
    return out


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, default=10.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(harness.manifest(ROOT), args.workload)
    line = json.dumps(dict(report(cell, args.seed, args.seconds),
                           device=torch.cuda.get_device_name(0)))
    print(line, flush=True)
    if args.out:
        with open(args.out, "a") as fh:
            fh.write(line + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
