"""Row sharding of the PyTorch port (``parallel/mesh.py`` and ``mesh=``
through the batch layer and the API) against the JAX package's.

The JAX side runs on the 8 virtual CPU devices of ``tests/conftest.py``;
the port's side on ``default_mesh(["cpu"] * n)`` with ``device="cpu"``,
whose shards run one after the other in this process, and in two
processes through ``torch.distributed`` with gloo
(``tests/test_parallel.py`` is the JAX package's counterpart)."""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from muse_psfr_tpu import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu import api as japi  # noqa: E402
from muse_psfr_tpu.config import GalacsiConfig as JConfig  # noqa: E402
from muse_psfr_tpu.parallel import batch as jbatch  # noqa: E402
from muse_psfr_tpu.parallel.mesh import default_mesh as jmesh  # noqa: E402
from muse_psfr_tpu_torch import TINY_CONFIG as TTINY  # noqa: E402
from muse_psfr_tpu_torch import api as tapi  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu_torch.io.fits import HDUList  # noqa: E402
from muse_psfr_tpu_torch.io.sparta import create_sparta_table  # noqa: E402
from muse_psfr_tpu_torch.io.table import FitTable  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch as tbatch  # noqa: E402
from muse_psfr_tpu_torch.parallel import multihost_demo  # noqa: E402
from muse_psfr_tpu_torch.parallel.mesh import (  # noqa: E402
    ROWS, default_mesh, rows_sharding)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench import build_rows  # noqa: E402
from _one_thread import ENV, one_thread  # noqa: E402

F64 = dict(dtype="float64", fit_dtype="float64")
#: tests/test_otf_support.py:CFG, the JAX package's mesh tests' config
CFG = GalacsiConfig(dim=512, dim_pup=24, dimpsf=12)
JCFG = JConfig(dim=512, dim_pup=24, dimpsf=12)
#: eight rows in both support buckets at CFG (tests/test_parallel.py:108)
MIXED = (np.array([1.0, 0.2, 1.3, 0.25, 1.1, 0.22, 1.2, 0.3]),
         np.array([0.7, 0.01, 0.5, 0.02, 0.6, 0.015, 0.65, 0.03]),
         np.array([25.0, 30.0, 18.0, 29.0, 22.0, 28.0, 24.0, 27.0]),
         np.ones((8, 4)))
#: row 3 is ultra-weak damping: it trips a 128-px window at 930 nm
TRIP = (np.array([1.0, 1.3, 1.1, 0.2]), np.array([0.7, 0.5, 0.6, 0.01]),
        np.array([25.0, 18.0, 22.0, 30.0]), np.ones((4, 4)))


def cpu_mesh(n):
    return default_mesh(["cpu"] * n)


def _tiny_night(B, seed=1):
    rng = np.random.default_rng(seed)
    mask = np.ones((B, 4))
    mask[min(2, B - 1), 3] = 0.0
    return (rng.uniform(0.6, 1.4, B), rng.uniform(0.3, 0.9, B),
            rng.uniform(10, 28, B), mask)


def test_mesh_layout_and_row_split():
    mesh = cpu_mesh(4)
    assert mesh.size == 4 and mesh.axis_names == (ROWS,) == ("rows",)
    assert (mesh.rank, mesh.world, mesh.backend) == (0, 1, None)
    assert mesh.local == (torch.device("cpu"),) * 4
    sl = rows_sharding(mesh).local_slices(8)
    assert [(i, s.start, s.stop) for i, _, s in sl] == \
        [(0, 0, 2), (1, 2, 4), (2, 4, 6), (3, 6, 8)]
    with pytest.raises(ValueError, match="split"):
        rows_sharding(mesh).local_slices(6)
    with pytest.raises(ValueError, match="one device type"):
        default_mesh(["cpu", "meta"])


def test_mesh_device_must_agree_with_device():
    with pytest.raises(ValueError, match="disagrees"):
        tbatch.process_batch(*_tiny_night(2), [800.0], cfg=TTINY, chunk=2,
                             mesh=cpu_mesh(2))          # device="cuda"


@pytest.mark.parametrize("n", [1, 2, 3, 4, 8])
def test_clamped_chunk_matches_jax(n):
    jm = jmesh(jax.devices()[:n])
    tm = cpu_mesh(n)
    for chunk in range(1, 11):
        for B in range(1, 13):
            got = tbatch.clamped_chunk(chunk, B, tm)
            assert got == jbatch.clamped_chunk(chunk, B, jm), (chunk, B)
            assert got % n == 0 and got >= n


@pytest.mark.parametrize("npsflin,chunk", [(1, 50), (3, 44)])
@pytest.mark.parametrize("n", [2, 4, 8])
def test_mesh_plan_matches_jax(n, npsflin, chunk):
    """The bench night's plan under a mesh: the JAX package's, every chunk
    a multiple of the mesh size, and no tail chunk."""
    rows = build_rows(100)
    lb = np.linspace(490, 930, 35)
    got = tbatch.plan_batch(*rows, lb, npsflin=npsflin, cfg=GalacsiConfig(),
                            chunk=chunk, mesh=cpu_mesh(n))
    want = jbatch.plan_batch(*rows, lb, npsflin=npsflin, cfg=JConfig(),
                             chunk=chunk, mesh=jmesh(jax.devices()[:n]))
    assert got.summary() == want.summary()
    assert all(s == got.chunk for g in got.groups for s in g.sizes)
    assert got.chunk % n == 0
    single = tbatch.plan_batch(*rows, lb, npsflin=npsflin,
                               cfg=GalacsiConfig(), chunk=chunk)
    assert single is not got


def test_mesh_plan_drops_the_tail_chunk():
    """The 57-row S=256 group of the 1-direction bench night pads to
    2 x 50 under a mesh, not 50 + 12."""
    rows = build_rows(100)
    lb = np.linspace(490, 930, 35)
    kw = dict(cfg=GalacsiConfig(), chunk=50)
    single = tbatch.plan_batch(*rows, lb, **kw)
    mesh = tbatch.plan_batch(*rows, lb, **kw, mesh=cpu_mesh(2))
    assert [list(g.sizes) for g in single.groups] == [[50, 12], [50]]
    assert [list(g.sizes) for g in mesh.groups] == [[50, 50], [50]]
    assert [list(g.nvals) for g in mesh.groups] == \
        [list(g.nvals) for g in single.groups]


def test_reconstruct_batch_under_mesh_matches_jax():
    """tests/test_parallel.py:33-49: eight rows over an 8-entry mesh."""
    night = _tiny_night(8)
    lb = np.linspace(600, 900, 3)
    got = tbatch.reconstruct_batch(*night, lb, cfg=TTINY.with_(**F64),
                                   chunk=8, device="cpu", mesh=cpu_mesh(8))
    want = jbatch.reconstruct_batch(*night, lb, cfg=JTINY.with_(**F64),
                                    chunk=8, mesh=jmesh())
    single = tbatch.reconstruct_batch(*night, lb, cfg=TTINY.with_(**F64),
                                      chunk=3, device="cpu")
    assert got.shape == (8, 3, TTINY.dimpsf, TTINY.dimpsf)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, single, rtol=0, atol=1e-12)


def test_batch_padding_with_mesh():
    """tests/test_parallel.py:52-66: five rows padded to the 8-entry
    mesh and cut back."""
    B = 5
    tel = (np.full(B, 1.0), np.full(B, 0.7), np.full(B, 25.0),
           np.ones((B, 4)))
    got = tbatch.reconstruct_batch(*tel, [700.0], cfg=TTINY.with_(**F64),
                                   chunk=8, device="cpu", mesh=cpu_mesh(8))
    want = jbatch.reconstruct_batch(*tel, [700.0], cfg=JTINY.with_(**F64),
                                    chunk=8, mesh=jmesh())
    assert got.shape[0] == B
    np.testing.assert_allclose(got, np.repeat(got[:1], B, axis=0),
                               rtol=0, atol=1e-12)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-12)


def test_process_batch_under_mesh_dim512_matches_jax():
    """tests/test_parallel.py:94-126: both support buckets at dim 512,
    float32, over the 8-entry mesh; against the JAX package's mesh run
    within tests/test_torch_batch.py's limits for the same comparison
    without a mesh (1e-4 on the fits, 2e-6 on the mean), and against the
    port's own single-device night within the JAX test's."""
    lb = np.array([930.0])
    ok = tbatch.rows_windowable(*MIXED, 930.0, CFG,
                                tbatch.default_support_bucket(CFG))
    assert ok.any() and (~ok).any()
    got = tbatch.process_batch(*MIXED, lb, cfg=CFG, chunk=8, device="cpu",
                               mesh=cpu_mesh(8))
    want = jbatch.process_batch(*MIXED, lb, cfg=JCFG, chunk=8, mesh=jmesh())
    single = tbatch.process_batch(*MIXED, lb, cfg=CFG, chunk=1,
                                  device="cpu")
    for g, w, atol in zip(got, want, (1e-4, 2e-6, 1e-4)):
        assert np.abs(g - w).max() <= atol
    for g, s, atol in zip(got, single, (1e-4, 1e-6, 1e-4)):
        assert np.abs(g - s).max() <= atol


def test_guard_redo_is_surgical_under_mesh():
    """tests/test_parallel.py:129-161: only the tripped chunk's rows are
    redone, with the mesh passed through; the corrected night matches the
    single-device one."""
    calls = []
    lb = np.array([930.0])
    cfg = CFG.with_(otf_support=128)
    fit, mean, _ = tbatch.process_batch(
        *TRIP, lb, cfg=cfg, chunk=2, device="cpu", mesh=cpu_mesh(2),
        on_chunk=lambda idx, p: calls.append(list(map(int, idx))))
    counts = {}
    for idx in calls:
        for j in idx:
            counts[j] = counts.get(j, 0) + 1
    assert counts == {0: 1, 1: 1, 2: 2, 3: 2}
    sfit, smean, _ = tbatch.process_batch(*TRIP, lb, cfg=cfg, chunk=2,
                                          device="cpu")
    assert np.abs(fit - sfit).max() <= 1e-4
    assert np.abs(mean - smean).max() <= 2e-6


def test_compute_psf_from_sparta_with_mesh():
    """tests/test_parallel.py:213-229."""
    cfg = TTINY.with_(**F64)
    hdu = create_sparta_table(nlines=5)
    kw = dict(lmin=700, lmax=900, nl=2, cfg=cfg, device="cpu")
    res_m = tapi.compute_psf_from_sparta(HDUList([hdu.copy()]), **kw,
                                         mesh=cpu_mesh(8), chunk=8)
    res_s = tapi.compute_psf_from_sparta(HDUList([hdu]), **kw)
    a = FitTable.from_hdu(res_m["FIT_ROWS"])
    b = FitTable.from_hdu(res_s["FIT_ROWS"])
    np.testing.assert_allclose(a["fwhm"], b["fwhm"], rtol=0, atol=1e-12)
    np.testing.assert_allclose(res_m["PSF_MEAN"].data,
                               res_s["PSF_MEAN"].data, rtol=0, atol=1e-12)


def test_condition_sweep_with_mesh_matches_jax():
    grid = ([0.8, 1.2], [0.5, 0.7], [15.0, 25.0])
    kw = dict(lbda=[800.0, 900.0], chunk=4)
    got = tapi.condition_sweep(*grid, cfg=TTINY.with_(**F64), device="cpu",
                               mesh=cpu_mesh(4), **kw)
    single = tapi.condition_sweep(*grid, cfg=TTINY.with_(**F64),
                                  device="cpu", **kw)
    want = japi.condition_sweep(*grid, cfg=JTINY.with_(**F64), **kw)
    assert got["fwhm"].shape == (2, 2, 2, 2)
    for k in ("fwhm", "beta"):
        np.testing.assert_allclose(got[k], single[k], rtol=1e-10)
        np.testing.assert_allclose(got[k], want[k], rtol=1e-8)


def test_dryrun_multichip():
    fit, mean, _ = multihost_demo.dryrun_multichip(8)
    assert fit.shape[:2] == (8, 2) and np.all(np.isfinite(mean))


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _run_ranks(script, n=2, timeout=240):
    """Run ``script`` (a worker taking its rank as argv[1]) in ``n``
    processes; each gets its own timeout and is killed on expiry."""
    env = dict(os.environ, PYTHONPATH=ROOT, OMP_NUM_THREADS="2")
    procs = [subprocess.Popen([sys.executable, str(script), str(r)],
                              env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(n)]
    outs = []
    for p in procs:
        try:
            outs.append(p.communicate(timeout=timeout)[0])
        except subprocess.TimeoutExpired:
            p.kill()
            outs.append(p.communicate()[0])
    for r, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"rank {r} failed:\n{out[-4000:]}"
    return outs


def test_init_multihost_collective_two_processes(tmp_path):
    """tests/test_parallel.py:164-210: two ranks of two entries each see
    the 4-entry global mesh and agree on a gather across processes."""
    worker = tmp_path / "mh_worker.py"
    worker.write_text(f"""
import sys
import torch
from muse_psfr_tpu_torch.parallel.batch import _replicate_for_host
from muse_psfr_tpu_torch.parallel.mesh import default_mesh, init_multihost
rank = int(sys.argv[1])
one = init_multihost('localhost:{_free_port()}', 2, rank, device='cpu')
assert (one.size, one.rank, one.world, one.backend) == (2, rank, 2, 'gloo')
mesh = default_mesh(['cpu', 'cpu'])
assert mesh.size == 4 and len(mesh.local) == 2
assert mesh.owners == (0, 0, 1, 1)
assert [i for i, _ in mesh.local_shards()] == [2 * rank, 2 * rank + 1]
cpu = torch.device('cpu')
parts = _replicate_for_host(mesh, cpu, [(torch.tensor(1.0 + rank),)] * 2)
tot = sum(float(p[0]) for p in parts)
assert tot == 6.0, tot
print('MULTIHOST_OK', rank)
""")
    outs = _run_ranks(worker)
    for r, out in enumerate(outs):
        assert f"MULTIHOST_OK {r}" in out


def test_process_batch_two_processes(tmp_path):
    """tests/test_parallel.py:551-664: ``process_batch`` over 2 ranks x 2
    entries (case A: eight rows, dim 512, three wavelengths; case B: the
    forced guard redo under the mesh) equals bit for bit across the
    ranks, and matches the port's single-process night and the JAX
    package's within the JAX test's limits."""
    worker = tmp_path / "mh_pipeline_worker.py"
    worker.write_text(f"""
import sys
import numpy as np
from muse_psfr_tpu_torch.config import GalacsiConfig
from muse_psfr_tpu_torch.parallel.batch import process_batch
from muse_psfr_tpu_torch.parallel.mesh import default_mesh, init_multihost
rank = sys.argv[1]
init_multihost('localhost:{_free_port()}', 2, int(rank), device='cpu')
mesh = default_mesh(['cpu', 'cpu'])
cfg = GalacsiConfig(dim=512, dim_pup=24, dimpsf=12, dtype='float64',
                    fit_dtype='float64')
rng = np.random.default_rng(1)
see = rng.uniform(0.6, 1.4, 8)
gl = rng.uniform(0.3, 0.9, 8)
l0 = rng.uniform(10, 28, 8)
mask = np.ones((8, 4)); mask[2, 3] = 0.0
a = process_batch(see, gl, l0, mask, np.linspace(600, 900, 3), cfg=cfg,
                  chunk=4, device='cpu', mesh=mesh)
calls = []
b = process_batch(
    np.array([1.0, 1.3, 1.1, 0.2]), np.array([0.7, 0.5, 0.6, 0.01]),
    np.array([25.0, 18.0, 22.0, 30.0]), np.ones((4, 4)), np.array([930.0]),
    cfg=cfg.with_(otf_support=128), chunk=2, device='cpu', mesh=mesh,
    on_chunk=lambda idx, p: calls.append(sorted(map(int, idx))))
# the chunk clamps to the 4-entry mesh: ONE chunk; row 3 trips the guard,
# so the whole chunk is delivered again with corrected values
assert calls.count([0, 1, 2, 3]) == 2, calls
np.savez(r'{tmp_path}/rank' + rank + '.npz', fit_a=a[0], mean_a=a[1],
         fitm_a=a[2], fit_b=b[0], mean_b=b[1])
print('MH_PIPELINE_OK', rank)
""")
    outs = _run_ranks(worker)
    for r, out in enumerate(outs):
        assert f"MH_PIPELINE_OK {r}" in out
    r0, r1 = (np.load(tmp_path / f"rank{r}.npz") for r in (0, 1))
    for k in r0.files:
        assert np.array_equal(r0[k], r1[k]), k

    cfg = CFG.with_(**F64)
    jcfg = JCFG.with_(**F64)
    a_night = (*_tiny_night(8), np.linspace(600, 900, 3))
    b_kw = dict(chunk=2)
    single_a = tbatch.process_batch(*a_night, cfg=cfg, chunk=4,
                                    device="cpu")
    single_b = tbatch.process_batch(*TRIP, [930.0],
                                    cfg=cfg.with_(otf_support=128),
                                    device="cpu", **b_kw)
    jax_a = jbatch.process_batch(*a_night, cfg=jcfg, chunk=4)
    jax_b = jbatch.process_batch(*TRIP, np.array([930.0]),
                                 cfg=jcfg.with_(otf_support=128), **b_kw)
    for want_a, want_b in ((single_a, single_b), (jax_a, jax_b)):
        for k, w, atol in zip(("fit_a", "mean_a", "fitm_a"), want_a,
                              (1e-4, 1e-6, 1e-4)):
            assert np.abs(r0[k] - w).max() <= atol, k
        for k, w, atol in zip(("fit_b", "mean_b"), want_b, (1e-4, 1e-6)):
            assert np.abs(r0[k] - w).max() <= atol, k


def test_multihost_demo_on_the_cpu(tmp_path):
    """The demo as a user runs it: two ranks, gloo, the tiny night; rank
    0's night equals the single-process one."""
    out = subprocess.run(
        [sys.executable, "-m", "muse_psfr_tpu_torch.parallel.multihost_demo",
         "--device", "cpu", "--out", str(tmp_path)],
        env=dict(os.environ, PYTHONPATH=ROOT, **ENV),
        cwd=tmp_path,
        capture_output=True, text=True, timeout=240)
    assert out.returncode == 0, out.stdout + out.stderr
    assert "2 ranks agree bit for bit" in out.stdout
    res = np.load(tmp_path / "multihost_demo.npz")
    tel = (res["seeing"], res["GL"], res["L0"], res["gs_mask"])
    with one_thread():             # as the ranks run
        single = tbatch.process_batch(*tel, **multihost_demo.night("cpu"))
    # float64 over two ranks and in one process, each on one thread: the
    # limits of tests/test_torch_batch.py for two float64 nights
    assert np.abs(res["mean"] - single[1]).max() <= \
        1e-10 * np.abs(single[1]).max()
    rel = np.abs(res["fit"] - single[0]) / np.maximum(np.abs(single[0]),
                                                      1e-300)
    assert rel[..., :-1].max() <= 1e-8
    assert np.array_equal(res["fit"][..., -1], single[0][..., -1])
