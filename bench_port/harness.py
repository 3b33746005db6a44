"""The port's benchmark: one run of one cell of ``BENCHMARK.json``.

A cell names a configuration (``configs/<name>.json``: the program's
``GalacsiConfig`` as run, the direction grid, the wavelengths), a traffic
mix (``traffic/<name>.json``, read by ``traffic/generator.py``) and, in
``cells/<cell>.json``, the chunk it runs at and the limits of its output
check.  Per-layer metrics are readers ``metrics/<metric>.py``, found by
name.  Nothing here names a cell, a configuration or a mix: a later cell
is files and entries.

A run (``run_cell``) is:

1. set-up: import the program (``muse_psfr_tpu_torch``), build or load its
   kernel library, draw the mix's pool, and run every pool batch twice
   through ``process_batch``, so that every chunk program it needs has had
   its eager first dispatch and its CUDA-graph capture;
2. the window: one client in a closed loop hands ``process_batch`` batch
   after batch (every one new telemetry, ``traffic/generator.py``) until
   ``seconds`` have passed, each timed by the host clock from a
   ``synchronize()`` to its results on the host; a program captured in the
   window makes that batch a failed one;
3. with ``trace``: a bounded number of the window's batches under
   ``torch.profiler``, the planner timed on fresh batches, and the
   per-layer readers on what was recorded;
4. the peak memory is read, the program's state is freed, and the output
   check (``check.py``) holds batches of the window, drawn from the seed
   with at least one whose plan runs a tail chunk, to the float64
   reference (``reference/``).

The result is one JSON line: ``correct``, ``attempted``, ``failed``,
``metrics``, ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``, each compared number beside its limit (also the last lines of
standard error).
"""

import importlib.util
import json
import os
import sys
import time

import numpy as np

from .traffic.generator import Traffic

HERE = os.path.dirname(os.path.abspath(__file__))
#: modules that no run may hold once its window has closed, compared by
#: the whole top-level name
FORBIDDEN = ("jax", "jaxlib", "flax", "muse_psfr_tpu")


def forbidden_modules(names=None):
    """The forbidden top-level names among ``names`` (default: the
    modules this process holds)."""
    names = sys.modules if names is None else names
    tops = {str(n).split(".")[0] for n in names}
    return sorted(t for t in tops if t in FORBIDDEN)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


def manifest(root):
    return load_json(os.path.join(root, "BENCHMARK.json"))


def _in_cell(metric, workload):
    return "workloads" not in metric or workload in metric["workloads"]


def cell_metrics(man, workload):
    """(end-to-end, per-layer) metric entries that ``workload`` reports."""
    e2e = [m for m in man["end_to_end"] if _in_cell(m, workload)]
    names = {m["name"] for m in e2e}
    per = [m for m in man["per_layer"]
           if m["moves"] in names and _in_cell(m, workload)]
    return e2e, per


def load_cell(man, workload, base=HERE):
    """Everything one cell needs, found by the names in ``BENCHMARK.json``:
    its entry, configuration, mix, cell file and metric entries."""
    entry = next((w for w in man["workloads"] if w["name"] == workload),
                 None)
    if entry is None:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    conf = next(c for c in man["configs"] if c["name"] == entry["config"])
    root = os.path.dirname(base)
    e2e, per = cell_metrics(man, workload)
    return {
        "entry": entry,
        "config": load_json(os.path.join(root, conf["file"])),
        "mix": load_json(os.path.join(base, "traffic",
                                      entry["traffic"] + ".json")),
        "cell": load_json(os.path.join(base, "cells", workload + ".json")),
        "end_to_end": e2e,
        "per_layer": per,
    }


def reader(name, base=HERE):
    """The ``read(rec)`` function of ``metrics/<name>.py``."""
    path = os.path.join(base, "metrics", name + ".py")
    spec = importlib.util.spec_from_file_location(
        "bench_port_metric_" + name.replace(".", "_").replace("-", "_"),
        path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


def wavelengths(config):
    lb = config["lbda_nm"]
    return np.linspace(lb["start"], lb["stop"], int(lb["num"]))


def percentile(values, q):
    """The ``q``-th percentile of ``values`` (linear interpolation)."""
    return float(np.percentile(np.asarray(values, np.float64), q))


class Program:
    """The system under test, as the harness drives it: the port's
    ``process_batch`` and ``plan_batch``, its captured programs and its
    device.  Tests put a broken one in its place."""

    def __init__(self, cfg_fields, device):
        import torch
        from muse_psfr_tpu_torch.config import GalacsiConfig
        from muse_psfr_tpu_torch.fit.moffat_fit import PACKED_FIELDS
        from muse_psfr_tpu_torch.parallel import batch, programs
        self.torch = torch
        self.cfg = GalacsiConfig(**cfg_fields)
        self.device = torch.device(device)
        self.batch = batch
        self.programs = programs
        #: the layout of the packed fits that ``process_batch`` returns
        self.fields = PACKED_FIELDS

    def build(self):
        if self.device.type == "cuda":
            from muse_psfr_tpu_torch.ops import _build
            _build.library()

    def process(self, rows, lbda, h, npsflin, chunk):
        return self.batch.process_batch(*rows, lbda, h=h, npsflin=npsflin,
                                        cfg=self.cfg, chunk=chunk,
                                        device=self.device)

    def plan(self, rows, lbda, h, npsflin, chunk):
        return self.batch.plan_batch(*rows, lbda, h=h, npsflin=npsflin,
                                     cfg=self.cfg, chunk=chunk,
                                     device=self.device)

    def n_programs(self):
        return len(self.programs.programs())

    def sync(self):
        if self.device.type == "cuda":
            self.torch.cuda.synchronize(self.device)

    def free(self):
        """Drop the captured programs and their memory."""
        self.programs.clear()
        if self.device.type == "cuda":
            self.torch.cuda.empty_cache()


def has_tail(plan):
    """Whether ``plan`` runs a tail chunk: a chunk below the chunk size, a
    program of its own."""
    return any(s < plan.chunk for g in plan.groups for s in g.sizes)


def warm(program, traffic, lbda, h, npsflin, chunk):
    """Every pool batch twice: each program the pool needs gets its eager
    first dispatch and then its capture, and nothing else is warmed.
    Returns, for each pool batch, whether its plan has a tail chunk (the
    plan that its first pass left in the planner's memo)."""
    tails = []
    for rows in traffic.pool:
        program.process(rows, lbda, h, npsflin, chunk)
        tails.append(has_tail(program.plan(rows, lbda, h, npsflin, chunk)))
    for rows in traffic.pool:
        program.process(rows, lbda, h, npsflin, chunk)
    program.sync()
    return tails


def window(program, traffic, lbda, h, npsflin, chunk, seconds,
           profile=None, min_batches=1):
    """The closed loop: batches back to back until ``seconds`` have passed
    and ``min_batches`` have run (every batch started before then runs to
    its end).  ``profile(k)``, when given, returns a context manager for
    batch ``k`` (the traced run's profiler).  Returns the record of the
    window."""
    n_prog = program.n_programs()
    lat, outs, errors, captured = [], {}, [], []
    rows = 0
    program.sync()
    w0 = time.perf_counter()
    k = 0
    while k < min_batches or time.perf_counter() - w0 < seconds:
        batch = traffic.batch(k)
        ctx = profile(k) if profile is not None else None
        if ctx is not None:
            ctx.__enter__()
        program.sync()
        t0 = time.perf_counter()
        try:
            outs[k] = program.process(batch, lbda, h, npsflin, chunk)
        except Exception as exc:                 # a batch with no answer
            errors.append(f"batch {k}: {type(exc).__name__}: {exc}")
        t1 = time.perf_counter()
        if ctx is not None:
            ctx.__exit__(None, None, None)
        if k in outs:
            lat.append(t1 - t0)
            rows += len(batch[0])
        n = program.n_programs()
        if n != n_prog:
            captured.append(k)
            n_prog = n
        k += 1
    return {"seconds": time.perf_counter() - w0,
            "attempted": k, "latencies": lat, "rows": rows,
            "outputs": outs, "errors": errors, "captured": captured}


def end_to_end(names, win, setup_s, peak_bytes):
    """The end-to-end metrics of ``names`` from the window's record."""
    values = {
        "rows_per_s": (win["rows"] / win["seconds"], "rows/s"),
        "night_p95_ms": (percentile(win["latencies"], 95) * 1e3
                         if win["latencies"] else None, "ms"),
        "peak_mem_gib": (peak_bytes / 2 ** 30, "GiB"),
        "setup_s": (setup_s, "s"),
    }
    return {n: {"value": values[n][0], "unit": values[n][1]}
            for n in names if values[n][0] is not None}


def device_info(program, peak_bytes):
    torch = program.torch
    if program.device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 0,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "gpu",
            "kind": torch.cuda.get_device_name(program.device),
            "count": 1, "memory_peak_bytes": int(peak_bytes)}


def run_cell(cell, seed, seconds, trace, device="cuda", program=None,
             t_start=None, log=sys.stderr):
    """One run of one cell (see the module's docstring); ``cell`` from
    :func:`load_cell`.  ``program`` replaces the port (tests).  Returns the
    result's dict, keys in the order the result line prints them."""
    from . import check, tracing
    t_start = time.perf_counter() if t_start is None else t_start
    config, mix, cellf = cell["config"], cell["mix"], cell["cell"]
    program = program or Program(config["program"], device)
    lbda = wavelengths(config)
    h = tuple(config["h_m"])
    npsflin = int(config["npsflin"])
    chunk = int(cellf["chunk"])
    traffic = Traffic(mix, seed)
    program.build()
    tails = warm(program, traffic, lbda, h, npsflin, chunk)
    setup_s = time.perf_counter() - t_start

    tracer = None
    if trace:
        tracer = tracing.Tracer(program, int(mix["trace_batches"]))
    win = window(program, traffic, lbda, h, npsflin, chunk, seconds,
                 profile=tracer.profile if tracer else None,
                 min_batches=tracer.last + 1 if tracer else 1)
    torch = program.torch
    peak = (torch.cuda.max_memory_reserved(program.device)
            if program.device.type == "cuda" else 0)

    if trace:
        rec = tracer.record(traffic, lbda, h, npsflin, chunk,
                            load_json(os.path.join(HERE, "metrics",
                                                   "kernel_classes.json")))
        metrics = {}
        for m in cell["per_layer"]:
            v = reader(m["name"])(rec)
            if v is not None:
                metrics[m["name"]] = {"value": v, "unit": m["unit"]}
    else:
        metrics = end_to_end([m["name"] for m in cell["end_to_end"]], win,
                             setup_s, peak)

    program.free()
    t_check = time.perf_counter()
    tail = [k for k in win["outputs"] if tails[traffic.pool_index(k)]]
    checks = check.check_window(win, traffic, config, cellf, mix, seed,
                                program, lbda, h, npsflin, tail)
    failed = len(win["errors"]) + len(win["captured"])
    correct = (not win["errors"]
               and all(v <= lim for v, lim in checks.values()))
    result = {"correct": bool(correct), "attempted": win["attempted"],
              "failed": failed, "metrics": metrics,
              "device": device_info(program, peak)}
    if trace:
        result["device"].update(busy_s=rec["busy_s"],
                                window_s=rec["window_s"])
        result["breakdown"] = rec["breakdown"]
    lat = win["latencies"] or [0.0]
    print(f"set-up {setup_s:.3f} s, window {win['seconds']:.3f} s with "
          f"{win['attempted']} batches (wall min {min(lat):.4f} median "
          f"{percentile(lat, 50):.4f} max {max(lat):.4f} s), check "
          f"{time.perf_counter() - t_check:.3f} s", file=log)
    for e in win["errors"]:
        print(e, file=log)
    if win["captured"]:
        print(f"programs captured in the window at batches "
              f"{win['captured']}", file=log)
    result["checks"] = {k: {"value": v, "limit": lim}
                        for k, (v, lim) in checks.items()}
    return result
