#!/usr/bin/env python3
"""Run one cell of the port's benchmark once, on one CUDA card.

    python3 bench_port/run.py --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

from the root of a checkout (the directory that holds ``BENCHMARK.json``
and ``muse_psfr_tpu_torch``).  The program under test is
``muse_psfr_tpu_torch``; nothing here imports JAX or the JAX package.
Without a CUDA card, or with fewer cards than the cell asks for, it exits
with code 2 and prints no result; there is no CPU fallback.  It exits with
code 3 and prints no result if the process holds ``jax``, ``jaxlib``,
``flax`` or ``muse_psfr_tpu`` once the window has closed.

The last line of standard output is the result (``harness.run_cell``); the
compared numbers and their limits are the last lines of standard error.
The kernel library builds into the checkout's ``build/`` on the first run
and is loaded from there after; the driver's ``HOME``, ``XDG_CACHE_HOME``
and ``TMPDIR`` hold nothing of this run's.  The program runs as a user
gets it: its host threads are torch's default, which the run leaves alone.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

ROOT = os.getcwd()
HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, ROOT)
# a library that the port uses must not load JAX on its own
os.environ.setdefault("USE_FLAX", "0")
os.environ.setdefault("USE_JAX", "0")

from bench_port import harness  # noqa: E402


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    man = harness.manifest(ROOT)
    cell = harness.load_cell(man, args.workload, base=HERE)
    import torch
    need = int(cell["entry"]["chips"])
    have = torch.cuda.device_count() if torch.cuda.is_available() else 0
    if have < need:
        print(f"this cell needs {need} CUDA card(s), {have} found",
              file=sys.stderr)
        return 2
    result = harness.run_cell(cell, args.seed, args.seconds,
                              bool(args.trace), device="cuda",
                              t_start=T_START)
    bad = harness.forbidden_modules()
    if bad:
        print(f"the process holds {', '.join(bad)} after the window: the "
              "run is refused", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        ok = "ok" if c["value"] <= c["limit"] else "FAILED"
        print(f"check {name} = {c['value']!r} limit {c['limit']!r} {ok}",
              file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
