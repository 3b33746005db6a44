#!/usr/bin/env python3
"""Whether the first CPU ``torch.exp`` of a process returns the same bits
as the later ones, on the exponent of the first direction of
``tests/test_torch_anchor.py``'s K6 inputs (x = a*(D - centre), 2 x 256 x
256 float32), in many processes at once.

    python3 tools/exp_first_call.py [--procs 6] [--rounds 5] [--threads T]

Each round starts ``--procs`` processes together, at 3, 4, ... intra-op
threads (``--threads T``: all at T); each takes ``exp`` three times and
prints, when its first call differs from the two later ones (which
always agree), how many elements moved, their span, the thread chunk the
span lies in (ATen splits the elements evenly over the threads), the
largest relative change among the nonzero values, and one value of each
call.  Ends with the number of processes whose first call moved.  CPU
only; the load of the processes themselves is the point.
"""

import argparse
import json
import os
import subprocess
import sys

CHILD = r"""
import json, sys
import numpy as np, torch
threads = int(sys.argv[1])
torch.set_num_threads(threads)
rng = np.random.default_rng(7)
d = rng.uniform(0, 40, (2, 9, 256, 256)).astype(np.float32)
d[..., :32] *= 30.0
alpha = -0.1 * (1.0 + 0.38 * np.linspace(0, 1, 7))
a = np.float32(0.5 * (alpha.min() + alpha.max()))
x = torch.as_tensor(a) * torch.as_tensor(d[:, 0] - d[:, 0, 128:129, 128:129])
first, again, last = (torch.exp(x) for _ in range(3))
out = {"threads": threads, "later_agree": bool(torch.equal(again, last))}
moved = (first != again).flatten().nonzero().flatten()
if len(moved):
    i, j = int(moved[0]), int(moved[-1])
    chunk = -(-x.numel() // threads)
    nz = again != 0
    rel = ((first - again).abs()[nz] / again.abs()[nz]).max().item()
    out.update(moved=len(moved), span=[i, j], chunk=[i // chunk, j // chunk],
               max_rel=rel, x=x.flatten()[i].item(),
               first=first.flatten()[i].item(),
               later=again.flatten()[i].item())
print(json.dumps(out))
"""


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--procs", type=int, default=6)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--threads", type=int, default=0)
    args = ap.parse_args(argv)
    moved = total = 0
    for _ in range(args.rounds):
        procs = [subprocess.Popen([sys.executable, "-c", CHILD,
                                   str(args.threads or 3 + k)],
                                  stdout=subprocess.PIPE, text=True,
                                  env=dict(os.environ))
                 for k in range(args.procs)]
        for p in procs:
            rec = json.loads(p.communicate()[0])
            total += 1
            if "moved" in rec:
                moved += 1
                print(json.dumps(rec))
            if not rec["later_agree"]:
                raise RuntimeError(f"two later calls differ: {rec}")
    print(f"first exp moved in {moved} of {total} processes")
    return 0


if __name__ == "__main__":
    sys.exit(main())
