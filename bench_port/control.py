#!/usr/bin/env python3
"""Readings of a cell's output check, for setting its limits: the program
on many seeds, and the control on three or more, in one process each.

    python3 bench_port/control.py --workload <cell> --seeds 1,2,...,12 \\
        --control-seeds 101,102,103 --seconds 3 [--out FILE]

The control is the program with its own lower-precision path switched on:
``matmul_precision="default"``, one bf16 pass for the plain products
around the kernels (the structure function's block transform and the zoom
DFT's second stage), where the configuration states float32 ("highest",
TF32 off).  Each seed runs the cell's mix for a short closed-loop window
(``--seconds``, at least one batch) after one warm-up of the pool, and the
check of ``check.py`` on it; one JSON line per seed goes to standard output
(and to ``--out``).  The benchmark's own runs never run this.
"""

import argparse
import json
import os
import sys
import time

HERE = os.path.dirname(os.path.abspath(__file__))
sys.path.insert(0, os.path.dirname(HERE))
sys.path.insert(0, os.getcwd())

from bench_port import check, harness  # noqa: E402
from bench_port.traffic.generator import Traffic  # noqa: E402

#: the control's switch, over the cell's configuration
CONTROL = {"matmul_precision": "default"}


def readings(cell, seeds, seconds, fields=None, device="cuda", out=None,
             label="program"):
    """``[{seed, numbers...}]`` of the cell's check with the program run at
    the cell's configuration updated by ``fields``."""
    config, mix, cellf = cell["config"], cell["mix"], cell["cell"]
    program = harness.Program(dict(config["program"], **(fields or {})),
                              device)
    lbda = harness.wavelengths(config)
    h = tuple(config["h_m"])
    npsflin = int(config["npsflin"])
    chunk = int(cellf["chunk"])
    program.build()
    tails = harness.warm(program, Traffic(mix, seeds[0]), lbda, h, npsflin,
                         chunk)
    rows = []
    for seed in seeds:
        t0 = time.perf_counter()
        traffic = Traffic(mix, seed)
        win = harness.window(program, traffic, lbda, h, npsflin, chunk,
                             seconds)
        tail = [k for k in win["outputs"] if tails[traffic.pool_index(k)]]
        nums = check.check_window(win, traffic, config, cellf, mix, seed,
                                  program, lbda, h, npsflin, tail)
        row = {"label": label, "seed": seed, "batches": win["attempted"],
               "errors": win["errors"], "captured": win["captured"],
               "seconds": time.perf_counter() - t0}
        row.update({k: v for k, (v, _) in nums.items()})
        rows.append(row)
        line = json.dumps(row)
        print(line, flush=True)
        if out:
            with open(out, "a") as fh:
                fh.write(line + "\n")
    program.free()
    return rows


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control-seeds", default="")
    ap.add_argument("--seconds", type=float, default=3.0)
    ap.add_argument("--out")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("no CUDA card", file=sys.stderr)
        return 2
    cell = harness.load_cell(harness.manifest(os.getcwd()), args.workload,
                             base=HERE)
    seeds = [int(s) for s in args.seeds.split(",") if s]
    readings(cell, seeds, args.seconds, out=args.out)
    cseeds = [int(s) for s in args.control_seeds.split(",") if s]
    if cseeds:
        readings(cell, cseeds, args.seconds, fields=CONTROL, out=args.out,
                 label="control")
    return 0


if __name__ == "__main__":
    sys.exit(main())
