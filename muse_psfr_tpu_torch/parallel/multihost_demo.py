"""A night processed by several processes, one mesh over all of them.

Counterpart of ``examples/multihost_night.py`` and of the dry run
``dryrun_multichip`` of the JAX package.  Every rank joins the process
group (:func:`parallel.mesh.init_multihost`), calls ``process_batch`` with
the SAME full telemetry and ``mesh=``, computes only its shards, and
returns the complete night; the driver checks that the ranks agree bit
for bit.

    python -m muse_psfr_tpu_torch.parallel.multihost_demo --device cpu
    python -m muse_psfr_tpu_torch.parallel.multihost_demo --device cuda \\
        --backend gloo --nproc 2 --rows 100

On the CPU each rank runs the tiny float64 config on 8 rows (3
wavelengths); on CUDA the FFT-free production config (dim 1280, so that
both hand-written kernels K1 and K2 run) on the bench night's telemetry at
35 wavelengths, chunk 50.  Two ranks on one card need ``--backend gloo``:
NCCL refuses two ranks on one device.  ``--out DIR`` keeps rank 0's
results, its telemetry and every rank's walls and launch counts in
``DIR/multihost_demo.npz``.  On a cluster, run the worker under
``torchrun`` instead (``init_multihost()`` reads its environment).
"""

import argparse
import json
import os
import subprocess
import sys
import tempfile
import time

import numpy as np

from ..utils.telemetry import night_rows

_MODULE = "muse_psfr_tpu_torch.parallel.multihost_demo"
_ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def night(device):
    """``process_batch`` arguments of the demo night on ``device``."""
    from ..config import GalacsiConfig, TINY_CONFIG
    if device == "cpu":
        return dict(lbda=np.linspace(490, 930, 3), chunk=4, device="cpu",
                    cfg=TINY_CONFIG.with_(dtype="float64",
                                          fit_dtype="float64"))
    return dict(lbda=np.linspace(490, 930, 35), chunk=50, device=device,
                cfg=GalacsiConfig(use_fft=False))


def worker(rank, nproc, port, device, backend, rows, repeat, out):
    """One rank: join the group, run the night ``1 + repeat`` times (the
    timed ones after a barrier) and write its results to ``out``."""
    import torch.distributed as dist
    from ..ops import _build
    from .batch import process_batch
    from .mesh import init_multihost, shutdown_multihost
    mesh = init_multihost(f"localhost:{port}", nproc, rank, device=device,
                          backend=backend, hosted=True)
    tel = night_rows(rows)
    kw = night(device)
    _build.reset_launch_counts()
    fit, mean, fitm = process_batch(*tel, **kw, mesh=mesh)
    counts = _build.launch_counts()
    walls = []
    for _ in range(repeat):
        dist.barrier()
        t0 = time.perf_counter()
        process_batch(*tel, **kw, mesh=mesh)
        dist.barrier()
        walls.append(time.perf_counter() - t0)
    np.savez(out, fit=fit, mean=mean, fitm=fitm, walls=np.array(walls),
             counts=json.dumps(counts), mesh=str(mesh.devices))
    print(f"rank {rank}/{nproc}: {rows} rows on a {mesh.size}-device "
          f"{mesh.backend} mesh {[str(d) for d in mesh.devices]}; fit "
          f"{fit.shape}, mean PSF {mean.shape}; launches {counts}",
          flush=True)
    shutdown_multihost()


def run(nproc=2, device="cpu", backend=None, rows=8, repeat=0, out=None,
        timeout=600):
    """Spawn ``nproc`` ranks of :func:`worker`, check that they agree bit
    for bit, and return rank 0's ``(fit, mean, fitm)`` with every rank's
    walls and launch counts."""
    from .mesh import host_coordinator
    store = host_coordinator(nproc)   # held until every rank is done
    with tempfile.TemporaryDirectory() as tmp:
        paths = [os.path.join(tmp, f"rank{r}.npz") for r in range(nproc)]
        cmd = [sys.executable, "-m", _MODULE, "--worker"]
        env = dict(os.environ, PYTHONPATH=os.pathsep.join(
            [_ROOT] + [p for p in [os.environ.get("PYTHONPATH")] if p]))
        procs = [subprocess.Popen(cmd + [str(r), str(nproc), str(store.port),
                                         device, backend or "", str(rows),
                                         str(repeat), paths[r]], env=env)
                 for r in range(nproc)]
        try:
            for p in procs:
                p.wait(timeout=timeout)
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        bad = [r for r, p in enumerate(procs) if p.returncode]
        if bad:
            raise RuntimeError(f"ranks {bad} failed")
        res = [dict(np.load(p)) for p in paths]
    for r in res[1:]:
        for k in ("fit", "mean", "fitm"):
            if not np.array_equal(r[k], res[0][k]):
                raise RuntimeError(f"the ranks disagree on {k}")
    walls = np.stack([r["walls"] for r in res])
    counts = [json.loads(str(r["counts"])) for r in res]
    if out is not None:
        os.makedirs(out, exist_ok=True)
        tel = night_rows(rows)
        np.savez(os.path.join(out, "multihost_demo.npz"), fit=res[0]["fit"],
                 mean=res[0]["mean"], fitm=res[0]["fitm"], walls=walls,
                 counts=json.dumps(counts), seeing=tel[0], GL=tel[1],
                 L0=tel[2], gs_mask=tel[3])
    return res[0]["fit"], res[0]["mean"], res[0]["fitm"], walls, counts


def dryrun_multichip(n_devices: int, device="cpu"):
    """The batched step at ``TINY_CONFIG`` over an ``n_devices``-entry mesh
    of ``device`` (a device may repeat), against the same step without a
    mesh; returns the mesh's results."""
    from ..config import TINY_CONFIG
    from .batch import process_batch
    from .mesh import default_mesh
    rng = np.random.default_rng(0)
    B = n_devices
    tel = (rng.uniform(0.7, 1.3, B), rng.uniform(0.4, 0.9, B),
           rng.uniform(10, 28, B), np.ones((B, 4)))
    tel[3][::3, 3] = 0.0                        # mix 4- and 3-laser rows
    kw = dict(lbda=[600.0, 900.0], cfg=TINY_CONFIG, chunk=B, device=device)
    got = process_batch(*tel, **kw, mesh=default_mesh([device] * n_devices))
    want = process_batch(*tel, **kw)
    if got[0].shape != (B, 2, want[0].shape[-1]):
        raise RuntimeError(f"fit shape {got[0].shape}")
    if not all(np.all(np.isfinite(a)) for a in got):
        raise RuntimeError("non-finite values under the mesh")
    if not np.abs(got[1] - want[1]).max() <= 1e-6 * np.abs(want[1]).max():
        raise RuntimeError("the mesh's mean PSF departs from one device's")
    return got


def main(argv=None):
    argv = sys.argv[1:] if argv is None else argv
    if argv[:1] == ["--worker"]:
        r, n, port, dev, backend, rows, repeat, out = argv[1:]
        worker(int(r), int(n), port, dev, backend or None, int(rows),
               int(repeat), out)
        return 0
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--device", default="cuda", choices=("cuda", "cpu"))
    ap.add_argument("--backend", default=None,
                    help="torch.distributed backend (default: nccl for "
                         "cuda, gloo for cpu)")
    ap.add_argument("--nproc", type=int, default=2)
    ap.add_argument("--rows", type=int, default=None,
                    help="telemetry rows (default 8 on cpu, 100 on cuda)")
    ap.add_argument("--repeat", type=int, default=0,
                    help="timed nights per rank after the first")
    ap.add_argument("--out", default=None,
                    help="directory for multihost_demo.npz")
    args = ap.parse_args(argv)
    rows = args.rows or (8 if args.device == "cpu" else 100)
    fit, mean, _, walls, counts = run(args.nproc, args.device, args.backend,
                                      rows, args.repeat, args.out)
    print(f"{args.nproc} ranks agree bit for bit: fit {fit.shape}, mean PSF "
          f"{mean.shape}")
    if walls.size:
        print("walls per night (max over ranks) [s]: " + " ".join(
            f"{w:.4f}" for w in walls.max(axis=0)))
    print(json.dumps({"launches": counts}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
