"""The PyTorch port imports no JAX, builds nothing at import, uses a
kernel's plain version only for CPU tensors, and never falls back to the
CPU when CUDA was asked for."""

import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu_torch.config import TINY_CONFIG  # noqa: E402
from muse_psfr_tpu_torch.ops import _build, conv_dft, zoom_dft  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch  # noqa: E402
from muse_psfr_tpu_torch.utils.device import resolve_device  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

_PROBE = """
import pkgutil, importlib, sys
import muse_psfr_tpu_torch as pkg
for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + "."):
    importlib.import_module(m.name)
from muse_psfr_tpu_torch.ops import _build
assert _build._LIB is None, "a kernel was built at import"
bad = sorted(k for k in sys.modules
             if k in ("jax", "muse_psfr_tpu")
             or k.startswith(("jax.", "jaxlib", "muse_psfr_tpu.")))
print("IMPORTED", len([k for k in sys.modules if k.startswith(pkg.__name__)]))
print("BAD", bad)
"""


def test_port_imports_no_jax():
    env = dict(os.environ, PYTHONPATH=ROOT)
    out = subprocess.run([sys.executable, "-c", _PROBE], env=env, cwd=ROOT,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "BAD []" in out.stdout, out.stdout
    n = int(out.stdout.split("IMPORTED")[1].split()[0])
    assert n >= 20, out.stdout


def test_cpu_tensors_take_the_plain_path_without_launching():
    before = _build.launch_counts()
    fit, psf_mean, _ = batch.process_batch(
        [1.0, 0.8], [0.7, 0.5], [25.0, 14.0], np.ones((2, 4)),
        [800.0, 900.0], cfg=TINY_CONFIG.with_(use_fft=False), chunk=2,
        device="cpu")
    assert np.all(np.isfinite(fit)) and np.all(np.isfinite(psf_mean))
    assert _build.launch_counts() == before
    assert set(before) == {"zoom_dft", "zoom_dft_rowsplit", "zoom_dft_disc",
                           "zoom_dft_tc", "zoom_dft_tc_rowsplit",
                           "zoom_dft_tc_disc", "zoom_dft_anchor",
                           "zoom_dft_tc_anchor", "conv_dft"}
    assert before["zoom_dft"] == zoom_dft.LAUNCHES
    assert before["zoom_dft_rowsplit"] == zoom_dft.ROWSPLIT_LAUNCHES
    assert before["zoom_dft_disc"] == zoom_dft.DISC_LAUNCHES
    assert before["zoom_dft_tc"] == zoom_dft.TC_LAUNCHES
    assert before["zoom_dft_tc_rowsplit"] == zoom_dft.TC_ROWSPLIT_LAUNCHES
    assert before["zoom_dft_tc_disc"] == zoom_dft.TC_DISC_LAUNCHES
    assert before["zoom_dft_anchor"] == zoom_dft.ANCHOR_LAUNCHES
    assert before["zoom_dft_tc_anchor"] == zoom_dft.TC_ANCHOR_LAUNCHES
    assert before["conv_dft"] == conv_dft.LAUNCHES


@pytest.mark.parametrize("cfg_kw", [{"zoom_anchor": "on"},
                                    {"disc_skip": True, "disc_min_ndir": 1,
                                     "otf_support": 0}])
def test_cpu_anchor_and_disc_nights_launch_nothing(cfg_kw):
    """The K5/K6 branches on CPU tensors run their plain versions."""
    before = _build.launch_counts()
    fit, psf_mean, _ = batch.process_batch(
        [1.0], [0.7], [25.0], np.ones((1, 4)), [800.0, 900.0],
        cfg=TINY_CONFIG.with_(use_fft=False, **cfg_kw), chunk=1,
        device="cpu")
    assert np.all(np.isfinite(fit)) and np.all(np.isfinite(psf_mean))
    assert _build.launch_counts() == before


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        batch.process_batch([1.0], [0.7], [25.0], np.ones((1, 4)), [900.0],
                            cfg=TINY_CONFIG)       # device defaults to cuda


def test_user_entry_points_raise_without_a_card(tmp_path, monkeypatch):
    """``compute_psf_from_sparta``, ``condition_sweep`` and the CLI pass
    their default device down unchanged: no card, no result."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from muse_psfr_tpu_torch import api, cli
    from muse_psfr_tpu_torch.io.fits import HDUList
    from muse_psfr_tpu_torch.io.sparta import create_sparta_table
    with pytest.raises(RuntimeError, match="cuda"):
        api.compute_psf_from_sparta(HDUList([create_sparta_table()]),
                                    lbda=[800.0], cfg=TINY_CONFIG)
    with pytest.raises(RuntimeError, match="cuda"):
        api.condition_sweep([0.8, 1.0], [0.7], [25.0], lbda=[800.0],
                            cfg=TINY_CONFIG)
    monkeypatch.chdir(tmp_path)
    with pytest.raises(RuntimeError, match="cuda"):
        cli.main(["--values", "1,0.7,25", "--no-color"])


def test_float64_with_fused_kernels_on_cuda_is_refused():
    cfg64 = TINY_CONFIG.with_(dtype="float64")
    with pytest.raises(ValueError, match="float32"):
        batch._check_device_dtype(cfg64, torch.device("cuda"))
    batch._check_device_dtype(cfg64, torch.device("cpu"))
    batch._check_device_dtype(cfg64.with_(use_fused_zoom=False,
                                          use_fused_conv=False),
                              torch.device("cuda"))


def test_reset_launch_counts():
    zoom_dft.LAUNCHES, conv_dft.LAUNCHES = 3, 4
    zoom_dft.ROWSPLIT_LAUNCHES = 5
    zoom_dft.DISC_LAUNCHES, zoom_dft.ANCHOR_LAUNCHES = 6, 7
    zoom_dft.TC_LAUNCHES, zoom_dft.TC_ROWSPLIT_LAUNCHES = 8, 9
    zoom_dft.TC_DISC_LAUNCHES, zoom_dft.TC_ANCHOR_LAUNCHES = 10, 11
    assert _build.launch_counts() == {"zoom_dft": 3, "zoom_dft_rowsplit": 5,
                                      "zoom_dft_disc": 6, "zoom_dft_tc": 8,
                                      "zoom_dft_tc_rowsplit": 9,
                                      "zoom_dft_tc_disc": 10,
                                      "zoom_dft_anchor": 7,
                                      "zoom_dft_tc_anchor": 11,
                                      "conv_dft": 4}
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}
    assert len(_build.launch_counts()) == 9
