#!/usr/bin/env python3
"""Where a fresh ``bench_torch.py`` process spends its 100-row night, on
one CUDA card.

    python3 tools/profile_bench.py [--profile PATH]

In one fresh process, the bench's night (the bench telemetry on 100
rows, 35 wavelengths, the default ``GalacsiConfig``, chunk 50, npsflin=1)
is warmed by two nights as ``bench_torch.py`` warms it, then timed both
ways the repo times it, in three rounds: four nights as the bench times
them (``sync``, then the host clock around ``process_batch``, back to
back), then four as ``chip_smoke.py`` phase 22 does (eager, replayed,
replayed, eager; no sync before the clock starts).  One replayed night
then runs under ``torch.profiler`` (``chip_smoke.profiled_shares``: host
self time, device busy time, the device's idle share of the wall).  The
card's SM clock, power draw and temperature, as ``nvidia-smi`` reads
them, are printed before and after.  With ``--profile`` the profiler's table is
written there.  Needs a CUDA card; imports nothing of JAX.
"""

import argparse
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def card_state():
    """The card's SM clock, its maximum, power draw and temperature."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm,power.draw,"
         "temperature.gpu", "--format=csv,noheader", "--id=0"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip()


def main(argv):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--profile", default=None,
                        help="write the profiler's table here")
    args = parser.parse_args(argv)
    sys.path.insert(0, ROOT)
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        print("profile_bench: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.parallel import programs
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    from muse_psfr_tpu_torch.utils.device import resolve_device
    from muse_psfr_tpu_torch.utils.telemetry import night_rows

    card = cs.card_line()
    print(card)
    dev = resolve_device("cuda")
    rows = night_rows(100)
    night = dict(lbda=cs.LBDA, npsflin=1, cfg=GalacsiConfig(), chunk=50,
                 device=dev)
    t0 = time.perf_counter()
    process_batch(*rows, **night)
    process_batch(*rows, **night)
    print(f"two warm-up nights in {time.perf_counter() - t0:.3f} s; "
          f"{len(programs.programs())} programs captured; card "
          f"{card_state()}")

    walls = {"bench": [], "phase 22, replayed": [], "phase 22, eager": []}
    for _ in range(3):
        for _ in range(4):
            torch.cuda.synchronize(dev)
            t0 = time.perf_counter()
            process_batch(*rows, **night)
            walls["bench"].append(time.perf_counter() - t0)
        turn = cs.walls_in_turns(rows, night, 2, card, "phase-22 timing")
        walls["phase 22, replayed"] += turn["graphs"]["walls"]
        walls["phase 22, eager"] += turn["eager"]["walls"]
    for label, w in walls.items():
        print(f"{label} timing x{len(w)}: {' '.join(f'{t:.4f}' for t in w)}"
              f" s; median {np.median(w):.4f} s, min {min(w):.4f} s ({card})")
    ratio = np.median(walls["bench"]) / np.median(walls["phase 22, replayed"])
    print(f"bench timing over phase-22 timing of the replayed nights, "
          f"medians: {ratio:.3f}")
    cs.profiled_shares(torch, rows, night, "the bench's 100-row night, "
                       "replayed, in a fresh process", card, args.profile)
    print(f"card after: {card_state()}")
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
