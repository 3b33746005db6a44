"""Time the port's host planner at several intra-op thread budgets.

``plan_batch`` runs the admission model's CPU tensor work on a thread
budget of its own (``parallel/batch.py:_plan_threads_for``, by the
evaluation's size).  This script fixes that budget to each of
``--threads`` in turn and plans fresh batches of a benchmark
mix (``bench_port/traffic/``) under a benchmark configuration
(``bench_port/configs/``), each batch new telemetry so that no memo
answers, with torch's own count left at its default around the planner.
It also checks, at every budget, that a row's admission samples are the
same bits in the whole batch and in a subset, and that the plans are the
same at every budget.  One JSON line a (config, rows) on stdout.

    python3 tools/plan_threads.py --config muse-wfm-9dir --rows 100 1000
"""

import argparse
import json
import os
import sys
import time

import numpy as np
import torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench_port import harness  # noqa: E402
from bench_port.traffic.generator import Traffic  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch  # noqa: E402


def samples_row_independent(rows, cfg, h, npsflin, rng):
    """Whether every row of a random half of ``rows`` has the same ring
    samples evaluated with the half as with the whole batch."""
    s, g, l0, m = rows
    h_t = tuple(float(x) for x in h)
    ws = batch.effective_wind_speed(h, cfg)
    idx, d_all, _ = batch._ring_damping(s, g, l0, m, cfg, h_t, ws, npsflin)
    sub = np.sort(rng.choice(s.shape[0], s.shape[0] // 2, replace=False))
    jdx, d_sub, _ = batch._ring_damping(s[sub], g[sub], l0[sub], m[sub],
                                        cfg, h_t, ws, npsflin)
    pos = np.searchsorted(idx, sub[jdx])
    return bool(np.array_equal(d_all[pos], d_sub))


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--config", default="muse-wfm-1dir")
    ap.add_argument("--mix", default="night100")
    ap.add_argument("--rows", type=int, nargs="+", default=[100])
    ap.add_argument("--threads", type=int, nargs="+", default=[1, 2, 4])
    ap.add_argument("--chunk", type=int, default=None,
                    help="the chunk (default: 50, 88 from 1000 rows)")
    ap.add_argument("--reps", type=int, default=6)
    ap.add_argument("--seed", type=int, default=3000000017)
    args = ap.parse_args(argv)

    conf = harness.load_json(os.path.join(ROOT, "bench_port", "configs",
                                          args.config + ".json"))
    cfg = GalacsiConfig(**conf["program"])
    lbda = harness.wavelengths(conf)
    h = tuple(conf["h_m"])
    npsflin = int(conf["npsflin"])
    mix = harness.load_json(os.path.join(ROOT, "bench_port", "traffic",
                                         args.mix + ".json"))
    rule = batch._plan_threads_for
    for n in args.rows:
        mix["rows"] = n
        traffic = Traffic(mix, args.seed)
        chunk = args.chunk or (88 if n >= 1000 else 50)
        # warm every constant of the model once
        batch.plan_batch(*traffic.batch(10 ** 6), lbda, h=h, npsflin=npsflin,
                         cfg=cfg, chunk=chunk)
        out = {"config": args.config, "rows": n, "chunk": chunk,
               "torch_threads": torch.get_num_threads(),
               "cpu": os.cpu_count(), "ms": {}, "same_plans": True,
               "row_independent": {}}
        k = 0
        plans = {}
        try:
            # budgets in turns, so that the host's drift falls on each
            for rep in range(args.reps):
                for t in args.threads:
                    batch._plan_threads_for = lambda n, t=t: t
                    k += 1
                    rows = traffic.batch(k if rep else 0)
                    t0 = time.perf_counter()
                    plan = batch._plan_batch(*rows, lbda, h, npsflin, cfg,
                                             chunk)
                    out["ms"].setdefault(t, []).append(
                        (time.perf_counter() - t0) * 1e3)
                    if rep == 0:
                        plans[t] = repr([(g[0], g[1].tolist())
                                         for g in plan[1]])
            for t in args.threads:
                batch._plan_threads_for = lambda n, t=t: t
                out["row_independent"][t] = samples_row_independent(
                    traffic.batch(0), cfg, h, npsflin,
                    np.random.default_rng(t))
        finally:
            batch._plan_threads_for = rule
        out["same_plans"] = len(set(plans.values())) == 1
        out["median_ms"] = {t: float(np.median(v))
                            for t, v in out["ms"].items()}
        print(json.dumps(out), flush=True)


if __name__ == "__main__":
    main()
