"""The chunk step as the JAX package's compiled program
(``parallel/batch.py:_fit_chunk``) and the programs that run it
(``parallel/programs.py``), on the CPU:

* the port's ``_fit_chunk`` with ``n_valid`` < chunk against the JAX
  package's ``_fit_chunk`` on the same numpy inputs, in float64: the
  masked PSF sum and the guard to 1e-12 relative, the fits within
  ``tests/test_torch_batch.py``'s 1e-8 relative;
* a second call of the step under a ``torch`` that raises on every tensor
  made from host data and on every host copy or sync (``.cpu()``,
  ``.item()``, ``.tolist()``, ``.numpy()``, ``float()``/``int()``/
  ``bool()`` of a tensor): what a CUDA graph capture needs, over the
  windows, the exact transform, the anchored and the disc-skip zoom, both
  ``use_fft`` routes and ``npsflin`` 1 and 3;
* the programs ``process_batch`` dispatches on the golden plans (and on
  the guard redo's plan) are the JAX package's distinct ``(group config,
  chunk size)`` executables;
* a CPU night captures nothing; a replay adds the launches its capture
  recorded; ``clear_device_consts`` drops the programs.

The capture and replay themselves need a card: ``tests/test_torch_cuda.py``
holds a graph night bit-equal to the eager night."""

import dataclasses
import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.config import GalacsiConfig as JConfig  # noqa: E402
from muse_psfr_tpu.otf.psf import lambda_crop_size as jcrop  # noqa: E402
from muse_psfr_tpu.parallel import batch as jbatch  # noqa: E402
from muse_psfr_tpu.psd.model import effective_wind_speed  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu_torch.fit.moffat_fit import N_PACKED  # noqa: E402
from muse_psfr_tpu_torch.ops import _build  # noqa: E402
from muse_psfr_tpu_torch.otf.psf import (  # noqa: E402
    _disc_block_mask, lambda_crop_size)
from muse_psfr_tpu_torch.parallel import batch as tbatch  # noqa: E402
from muse_psfr_tpu_torch.parallel import programs  # noqa: E402
from muse_psfr_tpu_torch.state import config_from_reference  # noqa: E402
from muse_psfr_tpu_torch.utils.device import clear_device_consts  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench import build_rows  # noqa: E402

H = (100.0, 10000.0)
LB = np.array([600.0, 750.0, 900.0])
LB35 = np.linspace(490, 930, 35)
#: a grid with a reduced S=256 window and an S=128 blue sub-window
MID = GalacsiConfig(dim=768, dim_pup=16, dimpsf=12, lambda_chunk=2)


def _telemetry(n=3):
    """(n, 7) rows [seeing, GL, L0, gs_mask(4)], row 1 in 3-laser mode."""
    t = np.array([[0.9, 0.8, 25.0, 1, 1, 1, 1],
                  [1.3, 0.5, 18.0, 1, 1, 1, 0],
                  [0.7, 0.6, 12.0, 1, 1, 1, 1]], np.float64)
    return t[:n]


def _rel(a, b):
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.mark.parametrize("pin", [{}, {"otf_support": 128},
                                 {"use_dphi_split": False}],
                         ids=["full", "s128", "exact"])
def test_fit_chunk_matches_jax(pin):
    kw = dict(dim=512, dim_pup=16, dimpsf=12, lambda_chunk=2,
              dtype="float64", fit_dtype="float64", **pin)
    jc, tc = JConfig(**kw), GalacsiConfig(**kw)
    t, n_valid = _telemetry(3), 2
    ws = effective_wind_speed(H, jc)
    want = jbatch._fit_chunk(jnp.asarray(t), jnp.asarray(np.int32(n_valid)),
                             jnp.asarray(LB), jnp.asarray(jcrop(LB, jc)), H,
                             ws, 1, jc, "float64")
    want = [np.asarray(w) for w in want]
    got = tbatch._fit_chunk(torch.as_tensor(t),
                            torch.tensor(n_valid, dtype=torch.int64),
                            torch.as_tensor(LB),
                            torch.as_tensor(lambda_crop_size(LB, tc)), H,
                            ws, 1, tc, "float64")
    fit, psum, guard = (g.numpy() for g in got)
    assert fit.shape == (3, LB.size, N_PACKED)
    assert psum.shape == (LB.size, 12, 12) and guard.shape == ()
    assert _rel(psum, want[1]) <= 1e-12
    if np.isinf(want[2]):
        assert guard == want[2]
    else:
        assert abs(guard - want[2]) <= 1e-12 * abs(want[2])
    rel = np.abs(fit - want[0]) / np.maximum(np.abs(want[0]), 1e-300)
    assert rel[..., :-1].max() <= 1e-8
    assert np.array_equal(fit[..., -1], want[0][..., -1])
    # the padding row is out of the sum
    one = tbatch._fit_chunk(torch.as_tensor(t[:2]),
                            torch.tensor(2, dtype=torch.int64),
                            torch.as_tensor(LB),
                            torch.as_tensor(lambda_crop_size(LB, tc)), H,
                            ws, 1, tc, "float64")[1].numpy()
    assert _rel(psum, one) <= 1e-12


def _strict(monkeypatch):
    """Make every tensor built from host data, and every host copy or
    sync of a tensor, raise."""
    for name in ("tensor", "as_tensor", "from_numpy"):
        orig = getattr(torch, name)

        def made(data, *a, _orig=orig, _name=name, **k):
            if not torch.is_tensor(data):
                raise AssertionError(f"torch.{_name} of a "
                                     f"{type(data).__name__} in the step")
            return _orig(data, *a, **k)

        monkeypatch.setattr(torch, name, made)
    for name in ("cpu", "item", "tolist", "numpy", "__float__", "__int__",
                 "__bool__", "__index__"):
        def synced(*a, _name=name, **k):
            raise AssertionError(f"Tensor.{_name} in the step")

        monkeypatch.setattr(torch.Tensor, name, synced)


_STEPS = {
    "full": (MID, 1),
    "s256": (MID.with_(otf_support=256), 1),
    "blue": (MID.with_(otf_support=256, otf_blue=(1, 128)), 1),
    "exact": (MID.with_(use_dphi_split=False), 1),
    "anchor": (MID.with_(zoom_anchor="on"), 3),
    # the full window at dim 1024 has dead corner blocks (dim 768 none)
    "disc": (GalacsiConfig(dim=1024, dim_pup=16, dimpsf=12, disc_skip=True,
                           disc_min_ndir=1), 1),
    "blue-ndir9": (MID.with_(otf_support=256, otf_blue=(1, 128)), 3),
}


@pytest.mark.parametrize("use_fft", [False, True], ids=["dft", "fft"])
@pytest.mark.parametrize("case", list(_STEPS))
def test_step_makes_no_host_copy_or_sync(monkeypatch, case, use_fft):
    cfg, npsflin = _STEPS[case]
    cfg = cfg.with_(use_fft=use_fft)
    if case == "disc":
        assert _disc_block_mask(cfg) is not None
    ws = effective_wind_speed(H, cfg)
    args = (torch.as_tensor(_telemetry(2), dtype=torch.float32),
            torch.tensor(1, dtype=torch.int64),
            torch.as_tensor(LB, dtype=torch.float32),
            torch.as_tensor(lambda_crop_size(LB, cfg)))
    first = tbatch._fit_chunk(*args, H, ws, npsflin, cfg, "float32")
    _strict(monkeypatch)
    again = tbatch._fit_chunk(*args, H, ws, npsflin, cfg, "float32")
    monkeypatch.undo()
    for a, b in zip(first, again):
        assert torch.equal(a, b)
    assert torch.isfinite(first[1]).all()


def _recording_run(keys):
    """A ``programs.run`` that records the keys and returns zeros of the
    outputs' shapes (a guard of 1: nothing trips)."""
    def run(key, fn, args, graphs=True):
        keys.append(key)
        if key[0] == "mean":
            return (torch.zeros(key[1][0], N_PACKED),)
        cfg, size, nl = key[1], key[2], key[3]
        return (torch.zeros(size, nl, N_PACKED),
                torch.zeros(nl, cfg.dimpsf, cfg.dimpsf), torch.tensor(1.0))
    return run


@pytest.mark.parametrize("name,n,chunk,npsflin,force_full", [
    ("night100", 100, 50, 1, False),
    ("night100", 100, 50, 1, True),
    ("night1000", 1000, 100, 1, False),
    ("night100_npsflin3", 100, 44, 3, False),
])
def test_program_keys_are_the_jax_executables(monkeypatch, name, n, chunk,
                                              npsflin, force_full):
    rows = build_rows(n)
    if not force_full:
        with open(os.path.join(ROOT, "tests", "data",
                               f"golden_plan_{name}.json")) as fh:
            assert tbatch.plan_batch(*rows, LB35, npsflin=npsflin,
                                     cfg=GalacsiConfig(), chunk=chunk,
                                     device="cpu").summary() == json.load(fh)
    keys = []
    monkeypatch.setattr(programs, "run", _recording_run(keys))
    tbatch.process_batch(*rows, LB35, npsflin=npsflin, cfg=GalacsiConfig(),
                         chunk=chunk, device="cpu", _force_full=force_full,
                         _return_parts=force_full)
    jplan = jbatch.plan_batch(*rows, LB35, npsflin=npsflin, cfg=JConfig(),
                              chunk=chunk, force_full=force_full)
    want = {(config_from_reference(dataclasses.asdict(g.cfg)), s)
            for g in jplan.groups for s in g.sizes}
    fits = [k for k in keys if k[0] == "fit"]
    assert {(k[1], k[2]) for k in fits} == want
    assert {k[3:] for k in fits} == {
        (35, "float32", H, 12.0, npsflin, "float32")}
    assert len(fits) == sum(len(g.sizes) for g in jplan.groups)
    means = [k for k in keys if k[0] == "mean"]
    assert means == ([] if force_full else
                     [("mean", (35, 40, 40), "torch.float32", "float32")])


def test_cpu_night_captures_nothing():
    programs.clear()
    tbatch.process_batch([1.0, 0.8, 1.3], [0.7, 0.5, 0.4], [25.0, 14.0, 2.0],
                         np.ones((3, 4)), [750.0, 900.0],
                         cfg=TINY_CONFIG.with_(use_fft=False), chunk=2,
                         device="cpu")
    tbatch.reconstruct_batch([1.0], [0.7], [25.0], np.ones((1, 4)), [750.0],
                             cfg=TINY_CONFIG, chunk=1, device="cpu")
    assert programs._PROGRAMS == {} and programs.programs() == []


class _Graph:
    """Stands for a captured graph: a replay doubles the input into the
    output, as the captured kernels would."""

    def __init__(self, x, out):
        self.x, self.out = x, out

    def replay(self):
        torch.mul(self.x, 2.0, out=self.out)


def test_a_replay_copies_in_clones_out_and_counts():
    x, out = torch.zeros(3), torch.zeros(3)
    prog = programs.Program(("fit",), _Graph(x, out), (x,), (out,),
                            {"zoom_dft_tc": 2, "conv_dft": 1}, 0.0, (0, 0))
    _build.reset_launch_counts()
    a = prog((torch.tensor([1.0, 2.0, 3.0]),))[0]
    b = prog((torch.tensor([4.0, 5.0, 6.0]),))[0]
    assert a.tolist() == [2.0, 4.0, 6.0] and b.tolist() == [8.0, 10.0, 12.0]
    counts = _build.launch_counts()
    assert counts["zoom_dft_tc"] == 4 and counts["conv_dft"] == 2
    assert sum(counts.values()) == 6 and prog.replays == 2
    _build.reset_launch_counts()


def test_clearing_the_constants_drops_the_programs():
    programs._PROGRAMS[("fit", "stale")] = None
    clear_device_consts()
    assert programs._PROGRAMS == {}
