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
             if k in ("jax", "muse_psfr_tpu", "muse_psfr")
             or k.startswith(("jax.", "jaxlib", "muse_psfr_tpu.",
                              "muse_psfr.")))
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
                           "zoom_dft_tc_anchor", "conv_dft",
                           "conv_dft_tc"}
    assert before["zoom_dft"] == zoom_dft.LAUNCHES
    assert before["zoom_dft_rowsplit"] == zoom_dft.ROWSPLIT_LAUNCHES
    assert before["zoom_dft_disc"] == zoom_dft.DISC_LAUNCHES
    assert before["zoom_dft_tc"] == zoom_dft.TC_LAUNCHES
    assert before["zoom_dft_tc_rowsplit"] == zoom_dft.TC_ROWSPLIT_LAUNCHES
    assert before["zoom_dft_tc_disc"] == zoom_dft.TC_DISC_LAUNCHES
    assert before["zoom_dft_anchor"] == zoom_dft.ANCHOR_LAUNCHES
    assert before["zoom_dft_tc_anchor"] == zoom_dft.TC_ANCHOR_LAUNCHES
    assert before["conv_dft"] == conv_dft.LAUNCHES
    assert before["conv_dft_tc"] == conv_dft.TC_LAUNCHES


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


@pytest.mark.parametrize("cfg_kw", [{"conv_precision": "high"},
                                    {"matmul_precision": "high"},
                                    {"matmul_precision": "default",
                                     "conv_precision": "high"}])
def test_cpu_nights_at_a_lower_tier_launch_nothing(cfg_kw):
    """The tier fields are read where the card runs: a CPU night launches
    nothing and equals the night at "highest" bit for bit."""
    before = _build.launch_counts()
    night = dict(lbda=[800.0, 900.0], chunk=1, device="cpu")
    tel = ([1.0], [0.7], [25.0], np.ones((1, 4)))
    cfg = TINY_CONFIG.with_(use_fft=False)
    got = batch.process_batch(*tel, cfg=cfg.with_(**cfg_kw), **night)
    want = batch.process_batch(*tel, cfg=cfg, **night)
    assert _build.launch_counts() == before
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _port_sources():
    pkg = os.path.join(ROOT, "muse_psfr_tpu_torch")
    found = [os.path.join(ROOT, "chip_smoke.py"),
             os.path.join(ROOT, "bench_torch.py")]
    for base, _, files in os.walk(pkg):
        found += [os.path.join(base, f) for f in files if f.endswith(".py")]
    return sorted(found)


@pytest.mark.parametrize("path", _port_sources(),
                         ids=lambda p: os.path.relpath(p, ROOT))
def test_source_names_no_jax_import(path):
    """No module of the port, ``compat.py``, ``chip_smoke.py`` and
    ``bench_torch.py`` included, has an import statement of ``jax``, of
    the JAX package or of the ``muse_psfr`` shim that is backed by it."""
    import ast
    with open(path) as fh:
        tree = ast.parse(fh.read())
    bad = []
    for node in ast.walk(tree):
        names = []
        if isinstance(node, ast.Import):
            names = [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names = [node.module or ""]
        bad += [n for n in names
                if n.split(".")[0] in ("jax", "jaxlib", "muse_psfr_tpu",
                                       "muse_psfr")]
    assert not bad, bad


def test_the_scan_covers_compat_and_the_new_modules():
    rel = {os.path.relpath(p, ROOT) for p in _port_sources()}
    assert {"chip_smoke.py", "bench_torch.py",
            "muse_psfr_tpu_torch/compat.py",
            "muse_psfr_tpu_torch/ops/conv_dft.py",
            "muse_psfr_tpu_torch/psd/model.py",
            "muse_psfr_tpu_torch/core/grids.py",
            "muse_psfr_tpu_torch/parallel/mesh.py",
            "muse_psfr_tpu_torch/parallel/multihost_demo.py",
            "muse_psfr_tpu_torch/examples/full_night.py",
            "muse_psfr_tpu_torch/examples/sensitivity_sweep.py"} <= rel


def test_cuda_request_without_cuda_raises():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="cuda"):
        resolve_device("cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        batch.process_batch([1.0], [0.7], [25.0], np.ones((1, 4)), [900.0],
                            cfg=TINY_CONFIG)       # device defaults to cuda


def test_default_mesh_raises_without_a_card():
    """No CPU fallback: a mesh of CUDA devices needs a card, whether it
    is every local device or named ones."""
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    from muse_psfr_tpu_torch.parallel.mesh import default_mesh
    with pytest.raises(RuntimeError, match="cuda"):
        default_mesh()
    with pytest.raises(RuntimeError, match="cuda"):
        default_mesh(["cuda:0", "cuda:0"])


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
    conv_dft.TC_LAUNCHES = 12
    assert _build.launch_counts() == {"zoom_dft": 3, "zoom_dft_rowsplit": 5,
                                      "zoom_dft_disc": 6, "zoom_dft_tc": 8,
                                      "zoom_dft_tc_rowsplit": 9,
                                      "zoom_dft_tc_disc": 10,
                                      "zoom_dft_anchor": 7,
                                      "zoom_dft_tc_anchor": 11,
                                      "conv_dft": 4, "conv_dft_tc": 12}
    _build.reset_launch_counts()
    assert set(_build.launch_counts().values()) == {0}
    assert len(_build.launch_counts()) == 10
