"""The port's example scripts (``muse_psfr_tpu_torch/examples/``) against
the JAX package, on the CPU at ``MUSE_PSFR_TINY=1``.

Each script runs as ``python -m ... --device cpu`` in a subprocess, as
``tests/test_examples.py`` runs the JAX scripts; the JAX package computes
the same night or grid in this process.  Both run the float32
``TINY_CONFIG``.  The night's FIT_MEAN is held to ``rtol=1e-5,
atol=1e-12`` (its fitted beta lies up to 9.96e-06 apart) and PSF_MEAN to
1e-5 of its peak (9.3e-07 apart; its faint wings differ by up to 2.6e-05
of their own value, so not per pixel).  The sweep's FWHM/beta are held to 1e-3 relative, the per-row FWHM/beta limit
of the card's float32 nights: at these 8 x 8 planes the LM fit turns the
two packages' float32 rounding (their cubes agree to ~1e-6) into up to
6.1e-4 on beta where beta is 35-46 (a nearly Gaussian profile) and 9e-5
on FWHM; bit for bit, the script equals the port's own
``condition_sweep``.
"""

import importlib
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu import api as japi  # noqa: E402
from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu_torch import api as tapi  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG  # noqa: E402
from muse_psfr_tpu_torch.io.fits import fits_open  # noqa: E402
from _one_thread import ENV, one_thread  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NIGHT = "muse_psfr_tpu_torch.examples.full_night"
SWEEP = "muse_psfr_tpu_torch.examples.sensitivity_sweep"
LBDA = [500.0, 700.0, 900.0]


def _run(args, cwd):
    env = dict(os.environ, MUSE_PSFR_TINY="1", PYTHONPATH=ROOT, **ENV)
    return subprocess.run([sys.executable, *args], env=env, cwd=str(cwd),
                          capture_output=True, text=True, timeout=300)


def _jax_night(monkeypatch):
    """The JAX script's own synthetic night at MUSE_PSFR_TINY=1."""
    monkeypatch.setenv("MUSE_PSFR_TINY", "1")
    path = os.path.join(ROOT, "examples", "full_night.py")
    spec = importlib.util.spec_from_file_location("jax_full_night", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.synthetic_night()


def test_full_night_matches_jax(tmp_path, monkeypatch):
    proc = _run(["-m", NIGHT, "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "wrote night_psf.fits" in proc.stdout
    assert "reconstructed in" in proc.stdout
    got = fits_open(str(tmp_path / "night_psf.fits"))
    want = japi.compute_psf_from_sparta(_jax_night(monkeypatch), cfg=JTINY,
                                        nl=9)
    assert [h.name for h in got] == [h.name for h in want]
    assert got["SPARTA_ATM_DATA"].data.tobytes() == \
        want["SPARTA_ATM_DATA"].data.tobytes()
    g, w = got["PSF_MEAN"].data, want["PSF_MEAN"].data
    assert g.shape == w.shape == (9, 8, 8)
    assert np.abs(g - w).max() <= 1e-5 * np.abs(w).max()
    for k in ("fwhm", "n"):
        np.testing.assert_allclose(got["FIT_MEAN"].data[k],
                                   want["FIT_MEAN"].data[k], rtol=1e-5,
                                   atol=1e-12, err_msg=k)


def test_sensitivity_sweep_matches_jax(tmp_path):
    proc = _run(["-m", SWEEP, "--device", "cpu"], tmp_path)
    assert proc.returncode == 0, proc.stdout + proc.stderr
    assert "9 conditions in" in proc.stdout
    assert "wrote sweep.png and sweep.fits" in proc.stdout
    assert (tmp_path / "sweep.png").stat().st_size > 0
    assert (tmp_path / "sweep_progress.npy").exists()
    got = fits_open(str(tmp_path / "sweep.fits"))
    grid = (np.linspace(0.6, 1.6, 3), np.linspace(0.3, 0.9, 3), [25.0])
    with one_thread():
        mine = tapi.condition_sweep(*grid, lbda=LBDA, cfg=TINY_CONFIG,
                                    device="cpu")
    want = japi.condition_sweep(*grid, lbda=LBDA, cfg=JTINY)
    for k in ("fwhm", "beta"):
        assert got[k.upper()].data.shape == (3, 3, 1, 3)
        assert np.array_equal(got[k.upper()].data, mine[k]), k
        np.testing.assert_allclose(got[k.upper()].data, want[k], rtol=1e-3,
                                   atol=0, err_msg=k)


def test_sweep_without_matplotlib_fails_after_its_compute_step(tmp_path):
    """The figure is never dropped silently: without matplotlib the
    script writes sweep.fits, then fails on the import, as the JAX
    script would."""
    code = ("import sys, runpy; sys.modules['matplotlib'] = None; "
            f"sys.argv = ['sweep', '2', '--device', 'cpu']; "
            f"runpy.run_module({SWEEP!r}, run_name='__main__', "
            "alter_sys=True)")
    proc = _run(["-c", code], tmp_path)
    assert proc.returncode != 0
    assert "4 conditions in" in proc.stdout
    assert "ModuleNotFoundError" in proc.stderr and \
        "matplotlib" in proc.stderr, proc.stderr
    assert (tmp_path / "sweep.fits").exists()
    assert not (tmp_path / "sweep.png").exists()


_IMPORT_PROBE = f"""
import os, sys
import {NIGHT}, {SWEEP}
from muse_psfr_tpu_torch.ops import _build
print("LIB", _build._LIB)
print("COUNTS", sorted(set(_build.launch_counts().values())))
print("MPL", sorted(k for k in sys.modules if k.startswith("matplotlib")))
print("FILES", sorted(os.listdir(".")))
"""


def test_importing_the_examples_runs_nothing(tmp_path):
    proc = _run(["-c", _IMPORT_PROBE], tmp_path)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.split("\n")[:4] == ["LIB None", "COUNTS [0]",
                                           "MPL []", "FILES []"]


@pytest.mark.parametrize("module", [NIGHT, SWEEP])
def test_default_device_raises_without_a_card(module, tmp_path,
                                              monkeypatch):
    """No fallback: ``--device`` defaults to cuda, as the CLI's does."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    monkeypatch.chdir(tmp_path)
    main = importlib.import_module(module).main
    with pytest.raises(RuntimeError, match="cuda"):
        main(["2"] if module == SWEEP else [])
    with pytest.raises(RuntimeError, match="cuda"):
        main(["2", "--device", "cuda"] if module == SWEEP
             else ["--device", "cuda"])
    assert not (tmp_path / "night_psf.fits").exists()
    assert not (tmp_path / "sweep.fits").exists()
