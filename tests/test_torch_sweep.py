"""The PyTorch port's ``condition_sweep`` / ``save_sweep`` against the JAX
package's, and the checkpoint and resume rules, on ``device="cpu"`` at
``TINY_CONFIG`` in float64.

Tolerances: against the JAX sweep, FWHM and beta <= 1e-8 relative (the
float64 night's bound in ``tests/test_torch_batch.py``); a resumed sweep
against an uninterrupted one <= 1e-6 absolute, the JAX tests' bound.
"""

import dataclasses
import json
import logging
import os
import shutil

import numpy as np
import pytest
from numpy.testing import assert_allclose

torch = pytest.importorskip("torch")

from muse_psfr_tpu import api as japi  # noqa: E402
from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu.io import fits as jfits  # noqa: E402
from muse_psfr_tpu_torch import api  # noqa: E402
from muse_psfr_tpu_torch import state  # noqa: E402
from muse_psfr_tpu_torch.fit.moffat_fit import N_PACKED  # noqa: E402
from muse_psfr_tpu_torch.io.fits import fits_open  # noqa: E402

JCFG = JTINY.with_(dtype="float64", fit_dtype="float64")
CFG = state.config_from_reference(dataclasses.asdict(JCFG))
GRID = ([0.8, 1.0, 1.2], [0.7], [25.0])


def sweep(*grid, **kw):
    kw.setdefault("lbda", [800.0])
    kw.setdefault("chunk", 2)
    return api.condition_sweep(*(grid or GRID), cfg=CFG, device="cpu", **kw)


def spy_on_process_batch(monkeypatch, seen):
    real = api.process_batch

    def spy(seeing, *a, **k):
        seen["B"] = np.atleast_1d(np.asarray(seeing)).shape[0]
        return real(seeing, *a, **k)

    monkeypatch.setattr(api, "process_batch", spy)


def load_json(path):
    with open(path) as fh:
        return json.load(fh)


@pytest.mark.parametrize("three", [False, True])
def test_sweep_matches_jax(three):
    grid = ([0.7, 1.0, 1.4], [0.5, 0.8], [12.0, 25.0])
    lbda = np.array([700.0, 800.0, 900.0])
    got = sweep(*grid, lbda=lbda, chunk=5, three_lgs_mode=three)
    want = japi.condition_sweep(*grid, lbda=lbda, cfg=JCFG, chunk=5,
                                three_lgs_mode=three)
    assert got["fwhm"].shape == got["beta"].shape == (3, 2, 2, 3)
    for k in ("seeing", "GL", "L0", "lbda"):
        assert np.array_equal(got[k], want[k])
    assert_allclose(got["fwhm"], want["fwhm"], rtol=1e-8, atol=0)
    assert_allclose(got["beta"], want["beta"], rtol=1e-8, atol=0)
    assert got["fit"].keys() == want["fit"].keys()
    assert np.array_equal(got["fit"]["ok"], np.asarray(want["fit"]["ok"]))
    assert got["fit"]["center"].shape == (3, 2, 2, 3, 2)


def test_default_wavelengths_are_the_35_of_the_bench():
    res = sweep([1.0], [0.7], [25.0], lbda=None, nl=4)
    assert np.array_equal(res["lbda"], np.linspace(490, 930, 4))


def test_save_sweep_round_trip_and_jax_bytes(tmp_path):
    res = sweep([0.8, 1.2], [0.7], [25.0], lbda=[700.0, 900.0])
    path = str(tmp_path / "sweep.fits")
    out = api.save_sweep(res, path)
    back = fits_open(path)
    assert [h.name for h in back] == [h.name for h in out] == \
        ["PRIMARY", "FWHM", "BETA", "GRID"]
    assert np.array_equal(back["FWHM"].data, res["fwhm"])
    assert np.array_equal(back["BETA"].data, res["beta"])
    grid = back["GRID"].data
    assert_allclose(grid["SEEING"][0], [0.8, 1.2])
    assert_allclose(grid["LBDA"][0], [700.0, 900.0])
    assert np.isnan(grid["GL"][0][1]) and np.isnan(grid["L0"][0][1])
    # the JAX writer gives the same file for the same result
    jpath = str(tmp_path / "jsweep.fits")
    japi.save_sweep(res, jpath)
    with open(path, "rb") as a, open(jpath, "rb") as b:
        assert a.read() == b.read()
    assert np.array_equal(jfits.fits_open(path)["BETA"].data, res["beta"])


def test_sweep_checkpoint(tmp_path):
    ckpt = str(tmp_path / "sweep_ckpt.npy")
    res = sweep(checkpoint=ckpt)
    packed = np.load(ckpt)
    assert packed.shape == (3, 1, N_PACKED)    # all chunks checkpointed
    assert np.allclose(packed[..., 10].reshape(res["beta"].shape),
                       res["beta"])
    meta = load_json(ckpt + ".meta.json")
    assert meta["done"] == [0, 1, 2] and meta["cfg"] == repr(CFG)
    assert not os.path.exists(ckpt + ".tmp")


def test_sweep_resume_recomputes_only_missing_rows(tmp_path, monkeypatch,
                                                   caplog):
    """resume=True loads a compatible checkpoint and recomputes only the
    grid points its sidecar does not record done."""
    ckpt = str(tmp_path / "sweep_ckpt.npy")
    side = ckpt + ".meta.json"
    full = sweep(checkpoint=ckpt)

    # an interrupted run: grid point 1 never completed
    arr = np.load(ckpt)
    arr[1] = np.nan
    np.save(ckpt, arr)
    meta = load_json(side)
    meta["done"] = [0, 2]
    with open(side, "w") as fh:
        json.dump(meta, fh)

    seen = {}
    spy_on_process_batch(monkeypatch, seen)
    with caplog.at_level(logging.INFO, logger="muse_psfr.api"):
        res = sweep(checkpoint=ckpt, resume=True)
    assert seen["B"] == 1                  # only the missing point
    assert any("1 of 3 grid points left" in r.getMessage()
               for r in caplog.records)
    assert_allclose(res["beta"], full["beta"], rtol=0, atol=1e-6)
    assert_allclose(res["fwhm"], full["fwhm"], rtol=0, atol=1e-6)
    assert not np.isnan(np.load(ckpt)).any()   # checkpoint completed
    assert load_json(side)["done"] == [0, 1, 2]


def _warnings(caplog):
    return [r.getMessage() for r in caplog.records
            if r.name == "muse_psfr.api" and r.levelno == logging.WARNING]


def test_sidecar_mismatch_recomputes_the_full_grid(tmp_path, monkeypatch,
                                                   caplog):
    """A checkpoint of the same shape from a sweep over other conditions
    must not be reused."""
    ckpt = str(tmp_path / "sweep_ckpt.npy")
    full = sweep(checkpoint=ckpt)
    other = str(tmp_path / "x.npy")
    sweep([0.8, 1.0, 1.2], [0.7], [20.0], checkpoint=other)
    shutil.copy(other, ckpt)
    shutil.copy(other + ".meta.json", ckpt + ".meta.json")
    seen = {}
    spy_on_process_batch(monkeypatch, seen)
    with caplog.at_level(logging.WARNING, logger="muse_psfr.api"):
        caplog.clear()
        res = sweep(checkpoint=ckpt, resume=True)
    assert seen["B"] == 3
    assert any("different parameters" in m for m in _warnings(caplog))
    assert_allclose(res["beta"], full["beta"], rtol=0, atol=1e-6)


def test_checkpoint_of_the_jax_package_counts_as_different(tmp_path,
                                                           monkeypatch,
                                                           caplog):
    """The sidecar holds ``repr(cfg)``: the JAX package's checkpoint of
    the same sweep is "different parameters" to the port."""
    ckpt = str(tmp_path / "jax_ckpt.npy")
    japi.condition_sweep(*GRID, lbda=[800.0], cfg=JCFG, chunk=2,
                         checkpoint=ckpt)
    assert load_json(ckpt + ".meta.json")["cfg"] != repr(CFG)
    seen = {}
    spy_on_process_batch(monkeypatch, seen)
    with caplog.at_level(logging.WARNING, logger="muse_psfr.api"):
        caplog.clear()
        sweep(checkpoint=ckpt, resume=True)
    assert seen["B"] == 3
    assert any("different parameters" in m for m in _warnings(caplog))


def test_missing_or_torn_sidecar_falls_back_to_nan_doneness(tmp_path,
                                                            monkeypatch,
                                                            caplog):
    ckpt = str(tmp_path / "sweep_ckpt.npy")
    side = ckpt + ".meta.json"
    sweep(checkpoint=ckpt)
    arr = np.load(ckpt)
    arr[2] = np.nan
    np.save(ckpt, arr)
    for torn in (False, True):
        if torn:
            with open(side, "w") as fh:
                fh.write('{"seeing": [0.8')
        else:
            os.remove(side)
        np.save(ckpt, arr)
        seen = {}
        spy_on_process_batch(monkeypatch, seen)
        with caplog.at_level(logging.WARNING, logger="muse_psfr.api"):
            caplog.clear()
            res = sweep(checkpoint=ckpt, resume=True)
        monkeypatch.undo()
        assert seen["B"] == 1, torn
        assert any("no provenance sidecar" in m for m in _warnings(caplog))
        assert np.isfinite(res["beta"]).all()


@pytest.mark.parametrize("prior", ["narrow", "one_dim"])
def test_incompatible_checkpoint_warns_and_recomputes(tmp_path, monkeypatch,
                                                      caplog, prior):
    ckpt = str(tmp_path / "sweep_ckpt.npy")
    full = sweep(checkpoint=ckpt)
    np.save(ckpt, np.load(ckpt)[..., :5] if prior == "narrow"
            else np.zeros(3))
    seen = {}
    spy_on_process_batch(monkeypatch, seen)
    with caplog.at_level(logging.WARNING, logger="muse_psfr.api"):
        caplog.clear()
        res = sweep(checkpoint=ckpt, resume=True)
    assert seen["B"] == 3
    assert any("incompatible" in m for m in _warnings(caplog))
    assert_allclose(res["beta"], full["beta"], rtol=0, atol=1e-6)


class Boom(RuntimeError):
    pass


def test_crash_before_guard_resolution_never_marks_done(tmp_path,
                                                        monkeypatch):
    """A crash between an on_chunk delivery and the night's guard
    resolution leaves a checkpoint whose sidecar marks nothing done:
    deliveries of windowed chunks are provisional.  The sidecar exists
    from the first delivery."""
    ckpt = str(tmp_path / "crash_ckpt.npy")
    side = ckpt + ".meta.json"
    real = api.process_batch

    def crash_after_first_chunk(*a, **k):
        inner = k["on_chunk"]

        def wrapped(idx, packed):
            inner(idx, packed)
            raise Boom()                     # the process dies mid-night

        k["on_chunk"] = wrapped
        return real(*a, **k)

    monkeypatch.setattr(api, "process_batch", crash_after_first_chunk)
    with pytest.raises(Boom):
        sweep(checkpoint=ckpt)
    monkeypatch.setattr(api, "process_batch", real)

    assert os.path.exists(ckpt) and os.path.exists(side)
    assert load_json(side)["done"] == []
    assert not np.isnan(np.load(ckpt)).all()   # provisional values exist

    seen = {}
    spy_on_process_batch(monkeypatch, seen)
    res = sweep(checkpoint=ckpt, resume=True)
    assert seen["B"] == 3                      # nothing was trusted
    assert load_json(side)["done"] == [0, 1, 2]
    assert np.isfinite(res["beta"]).all()


def test_resume_after_crash_skips_guard_free_chunks(tmp_path, monkeypatch):
    """Guard-free chunks (full window: the guard is +inf by construction)
    are final at delivery: a crash later in the night leaves them marked
    done, and resume recomputes only the rest."""
    cfg_full = CFG.with_(otf_support=0)
    ckpt = str(tmp_path / "eager_ckpt.npy")
    side = ckpt + ".meta.json"
    real = api.process_batch

    def crash_at_second_chunk(*a, **k):
        inner, calls = k["on_chunk"], []

        def wrapped(idx, packed):
            if calls:
                raise Boom()          # dies before the 2nd delivery
            inner(idx, packed)
            calls.append(1)

        k["on_chunk"] = wrapped
        return real(*a, **k)

    kw = dict(lbda=[800.0], cfg=cfg_full, chunk=2, device="cpu",
              checkpoint=ckpt)
    monkeypatch.setattr(api, "process_batch", crash_at_second_chunk)
    with pytest.raises(Boom):
        api.condition_sweep(*GRID, **kw)
    monkeypatch.setattr(api, "process_batch", real)
    assert load_json(side)["done"] == [0, 1]

    seen = {}
    spy_on_process_batch(monkeypatch, seen)
    res = api.condition_sweep(*GRID, resume=True, **kw)
    assert seen["B"] == 1
    assert load_json(side)["done"] == [0, 1, 2]
    assert np.isfinite(res["beta"]).all()


def test_checkpoint_path_without_npy_suffix(tmp_path, monkeypatch):
    """np.save appends '.npy' to a suffix-less path; the path is
    normalised, so resume finds the file it wrote."""
    ck = str(tmp_path / "noext_ckpt")
    grid = ([0.8, 1.0], [0.7], [25.0])
    sweep(*grid, checkpoint=ck)
    assert os.path.exists(ck + ".npy")
    assert load_json(ck + ".npy.meta.json")["done"] == [0, 1]
    seen = {}
    spy_on_process_batch(monkeypatch, seen)
    res = sweep(*grid, checkpoint=ck, resume=True)
    assert seen == {}                          # nothing left to compute
    assert np.isfinite(res["beta"]).all()


def test_sidecar_on_disk_before_first_npy_write(tmp_path, monkeypatch):
    """The sidecar reaches the disk before the first checkpoint write: a
    crash after a sidecar-less save would send resume down the NaN-based
    fallback, which trusts provisional values."""
    ckpt = str(tmp_path / "order_ckpt.npy")
    side = ckpt + ".meta.json"
    orig_replace = os.replace
    sidecar_present = []

    def spy_replace(src, dst, *a, **k):
        if str(dst) == ckpt:
            sidecar_present.append(os.path.exists(side))
        return orig_replace(src, dst, *a, **k)

    monkeypatch.setattr(os, "replace", spy_replace)
    sweep(checkpoint=ckpt)
    assert sidecar_present and all(sidecar_present)


def test_guard_trip_during_a_checkpointed_sweep(tmp_path):
    """A pinned too-small window trips the guard on the ultra-weak row:
    the redo NaNs it out, delivers it again, and only then marks it done;
    the result equals the sweep on the full window."""
    from muse_psfr_tpu_torch.config import GalacsiConfig
    cfg = GalacsiConfig(dim=512, dim_pup=24, dimpsf=12)
    ckpt = str(tmp_path / "trip_ckpt.npy")
    kw = dict(lbda=[930.0], chunk=1, device="cpu")
    got = api.condition_sweep([0.2, 1.0], [0.01], [30.0],
                              cfg=cfg.with_(otf_support=128),
                              checkpoint=ckpt, **kw)
    want = api.condition_sweep([0.2, 1.0], [0.01], [30.0],
                               cfg=cfg.with_(otf_support=256), **kw)
    # the redone row within the redo's bound (tests/test_torch_batch.py);
    # the other row stayed on its 128-px window: the windowed-night bound
    assert_allclose(got["beta"][0], want["beta"][0], rtol=0, atol=1e-4)
    assert_allclose(got["beta"][1], want["beta"][1], rtol=1e-3, atol=0)
    assert load_json(ckpt + ".meta.json")["done"] == [0, 1]
    assert np.allclose(np.load(ckpt)[..., 10].ravel(), got["beta"].ravel())

