"""The traced run's recording: ``torch.profiler`` over a bounded number of
whole batches of the window, the planner timed on fresh batches, and the
record that the per-layer readers (``metrics/<name>.py``) read.

The profiler records the host's torch ops and the device's kernels and
copies (CUPTI) of ``n`` consecutive batches from the window's second one
on, so that its buffers stay small; its own host work slows those batches,
so an idle share read under it is an upper bound.
"""

import os
import re
import sys
import time
from collections import Counter

import numpy as np

#: the window's first traced batch (the first one follows the warm-up)
FIRST = 1
#: the fresh batches the planner is timed on start at this index, far past
#: any window's batches
PLAN_BATCH0 = 10 ** 9
#: the range around each traced call of ``process_batch``
SPAN = "bench_port.batch"
#: the program's files, whose frames label the host's time
PROGRAM = os.sep + "muse_psfr_tpu_torch" + os.sep


class _Sampler:
    """Samples, every ``period`` seconds, where the main thread is in the
    program: the innermost frame of a file of ``muse_psfr_tpu_torch``
    (``file.py:function``), with the host clock.  It labels the device's
    idle gaps by what the host was doing, which the profiler's torch ops
    cannot say while the host runs Python and numpy."""

    def __init__(self, period=0.002):
        import threading
        self.period = period
        self.samples = []
        self.main = threading.main_thread().ident
        self.done = threading.Event()
        self.thread = threading.Thread(target=self._run, daemon=True)

    def _run(self):
        while not self.done.wait(self.period):
            frame = sys._current_frames().get(self.main)
            label = None
            while frame is not None:
                path = frame.f_code.co_filename
                if PROGRAM in path:
                    label = (os.path.basename(path) + ":"
                             + frame.f_code.co_name)
                    break
                frame = frame.f_back
            self.samples.append((time.perf_counter(), label))

    def start(self):
        self.thread.start()

    def stop(self):
        self.done.set()
        self.thread.join(timeout=10)


class _Session:
    """Starts the profiler before batch ``first`` and stops it after batch
    ``last``; each traced batch runs under a ``bench_port.batch`` range
    (the span of the call into ``process_batch``); other batches pass
    through."""

    def __init__(self, tracer, k):
        self.tracer, self.k = tracer, k

    def __enter__(self):
        from torch.profiler import ProfilerActivity, profile, record_function
        t = self.tracer
        if self.k == t.first:
            t.prof = profile(activities=[ProfilerActivity.CPU,
                                         ProfilerActivity.CUDA])
            t.program.sync()
            t.prof.start()
            t.sampler.start()
            t.t0 = time.perf_counter()
        self.span = record_function(SPAN)
        t.enter.append(time.perf_counter())
        self.span.__enter__()

    def __exit__(self, *exc):
        t = self.tracer
        self.span.__exit__(*exc)
        t.batches.append(self.k)
        if self.k == t.last:
            t.stop()


class Tracer:
    def __init__(self, program, n):
        self.program = program
        self.first, self.last = FIRST, FIRST + max(1, int(n)) - 1
        self.prof = None
        self.sampler = _Sampler()
        self.batches, self.enter = [], []
        self.t0 = self.t1 = None

    def profile(self, k):
        """The context of window batch ``k`` (None when it is not traced)."""
        if self.first <= k <= self.last:
            return _Session(self, k)
        return None

    def stop(self):
        if self.prof is not None and self.t1 is None:
            self.program.sync()
            self.t1 = time.perf_counter()
            self.prof.stop()
            self.sampler.stop()

    def record(self, traffic, lbda, h, npsflin, chunk, classes):
        """The record the readers take their numbers from."""
        from torch.autograd import DeviceType
        self.stop()
        rec = {"classes": classes, "cfg": self.program.cfg,
               "npsflin": npsflin, "rows": 0, "plans": [], "kernels": [],
               "cpu_ops": [], "busy_s": 0.0, "window_s": 0.0,
               "host_samples": []}
        if self.prof is not None:
            spans = []
            for e in self.prof.events():
                span = (e.name, float(e.time_range.start),
                        float(e.time_range.end))
                if e.device_type == DeviceType.CUDA:
                    # the batch range is mirrored on the device's timeline
                    if e.name != SPAN:
                        rec["kernels"].append(span)
                elif e.device_type == DeviceType.CPU:
                    rec["cpu_ops"].append(span)
                    if e.name == SPAN:
                        spans.append(span[1])
            rec["window_s"] = self.t1 - self.t0
            if spans and self.enter:
                # the profiler's clock [us] against the host clock [s], from
                # the first batch's range
                off = min(spans) - self.enter[0] * 1e6
                rec["host_samples"] = [(t * 1e6 + off, lab)
                                       for t, lab in self.sampler.samples]
        busy = merged([(a, b) for _, a, b in rec["kernels"]])
        rec["busy_s"] = sum(b - a for a, b in busy) * 1e-6
        for k in self.batches:
            rows = traffic.batch(k)
            rec["rows"] += len(rows[0])
            # the batch's own plan (the program memoises it)
            rec["plans"].append(self.program.plan(rows, lbda, h, npsflin,
                                                  chunk))
        rec["plan_ms"] = []
        for j in range(len(traffic.pool)):
            rows = traffic.batch(PLAN_BATCH0 + j)
            t0 = time.perf_counter()
            self.program.plan(rows, lbda, h, npsflin, chunk)
            rec["plan_ms"].append((time.perf_counter() - t0) * 1e3)
        rec["breakdown"] = breakdown(rec, busy)
        return rec


def merged(spans):
    """The union of ``(start, end)`` intervals as sorted disjoint ones."""
    out = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


_NOISE = re.compile(r"at::native::|\(anonymous namespace\)::|"
                    r"binary_internal::|std::array<char\*, \d+ul>|^void ")


def short(name, n=120):
    """A kernel or op name without its argument list and namespaces."""
    name = _NOISE.sub("", name)
    depth = 0
    for i, ch in enumerate(name):
        depth += ch == "<"
        depth -= ch == ">"
        if ch == "(" and depth == 0 and i > 0:
            name = name[:i]
            break
    return name[:n].strip()


def _label(rec, cpu, a, b):
    """What the host did during the device's idle gap ``[a, b]`` [us]: the
    program's function most sampled in it, else the innermost torch op at
    its middle."""
    labs = Counter(lab for t, lab in rec["host_samples"]
                   if a <= t <= b and lab is not None)
    if labs:
        return "host: " + labs.most_common(1)[0][0]
    mid = 0.5 * (a + b)
    if len(cpu):
        inside = np.nonzero((cpu[:, 0] <= mid) & (cpu[:, 1] >= mid))[0]
        if inside.size:
            i = inside[np.argmin(cpu[inside, 1] - cpu[inside, 0])]
            return "host: " + short(rec["cpu_ops"][i][0])
    return "host: no torch op"


def breakdown(rec, busy, top=10):
    """The device operations that took most time, and the longest idle
    gaps of the device with what the host did in each, in seconds."""
    tot = {}
    for name, a, b in rec["kernels"]:
        key = short(name)
        tot[key] = tot.get(key, 0.0) + (b - a) * 1e-6
    ops = sorted(tot.items(), key=lambda kv: -kv[1])[:top]
    gaps = []
    if busy and rec["cpu_ops"]:
        lo = min(a for _, a, _ in rec["cpu_ops"])
        hi = max(b for _, _, b in rec["cpu_ops"])
        edges = [lo] + [x for ab in busy for x in ab] + [hi]
        for a, b in zip(edges[0::2], edges[1::2]):
            if b > a:
                gaps.append((a, b))
    gaps = sorted(gaps, key=lambda g: g[0] - g[1])[:top]
    cpu = np.array([(a, b) for _, a, b in rec["cpu_ops"]], np.float64)
    return {"device_ops": [[n, s] for n, s in ops],
            "idle_gaps": [[_label(rec, cpu, a, b), (b - a) * 1e-6]
                          for a, b in gaps]}
