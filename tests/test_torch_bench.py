"""``bench_torch.py``, the port's counterpart of ``bench.py``, on the CPU.

The telemetry the bench runs (the port's ``utils.telemetry.night_rows``)
and the JSON keys are held to ``bench.py`` itself (loaded by path: its
module level imports only numpy); a run at ``TINY_CONFIG``
with ``--device cpu`` in a subprocess checks the line it prints; the
row-0 plan of the bench nights is held to the golden plans; the bench's
night, in float64 at ``TINY_CONFIG``, to the JAX package's; and without
a card the script exits non-zero.
"""

import ast
import hashlib
import importlib.util
import json
import math
import os
import subprocess
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import bench_torch  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG  # noqa: E402
from muse_psfr_tpu_torch.utils.telemetry import night_rows  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
BENCH_PY = os.path.join(ROOT, "bench.py")
DATA = os.path.join(ROOT, "tests", "data")
EXTRA_KEYS = ["median_s", "times_s", "launches_per_night"]

_TINY_RUN = """
import json, sys
import bench_torch
from muse_psfr_tpu_torch.config import TINY_CONFIG
rc = bench_torch.main(["--device", "cpu"], cfg=TINY_CONFIG)
print(json.dumps({"rc": rc, "jax_loaded": sorted(
    k for k in sys.modules if k.split(".")[0] in
    ("jax", "jaxlib", "muse_psfr_tpu", "muse_psfr"))}))
"""


def _bench_py():
    spec = importlib.util.spec_from_file_location("bench_reference",
                                                  BENCH_PY)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bench_py_keys():
    """The keys of the ``json.dumps({...})`` in ``bench.py``'s ``main``."""
    with open(BENCH_PY) as fh:
        tree = ast.parse(fh.read())
    main = next(n for n in tree.body
                if isinstance(n, ast.FunctionDef) and n.name == "main")
    call = next(n for n in ast.walk(main)
                if isinstance(n, ast.Call)
                and ast.unparse(n.func) == "json.dumps"
                and n.args and isinstance(n.args[0], ast.Dict))
    return [k.value for k in call.args[0].keys]


def _digest(path):
    with open(path, "rb") as fh:
        return hashlib.sha256(fh.read()).hexdigest()


@pytest.fixture(scope="module")
def tiny_run():
    """``main(["--device", "cpu"], cfg=TINY_CONFIG)`` on 2 rows, one block
    of two nights, in a subprocess: its two last stdout lines parsed, and
    the baseline file's digest before and after."""
    before = _digest(bench_torch.CACHE)
    env = dict(os.environ, PYTHONPATH=ROOT, BENCH_ROWS="2",
               BENCH_BLOCKS="1", BENCH_REPS="2")
    out = subprocess.run([sys.executable, "-c", _TINY_RUN], cwd=ROOT,
                         env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-4000:]
    lines = out.stdout.strip().splitlines()
    return dict(bench=json.loads(lines[-2]), probe=json.loads(lines[-1]),
                stderr=out.stderr, digests=(before,
                                            _digest(bench_torch.CACHE)))


@pytest.mark.parametrize("n", [1, 100, 1000])
def test_build_rows_is_bench_py_s(n):
    want = _bench_py().build_rows(n)
    got = night_rows(n)
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and np.array_equal(g, w)


def test_read_baseline_is_bench_py_s_and_never_writes(tmp_path):
    assert os.path.exists(bench_torch.CACHE)
    assert bench_torch.read_baseline() == _bench_py().measure_baseline()
    missing = tmp_path / "baseline_cache.json"
    with pytest.raises(FileNotFoundError, match="bench.py"):
        bench_torch.read_baseline(str(missing))
    assert not missing.exists()


def test_json_keys_are_bench_py_s_then_the_extras(tiny_run):
    keys = _bench_py_keys()
    assert keys[:3] == ["metric", "value", "unit"] and "device" in keys
    assert list(tiny_run["bench"]) == keys + EXTRA_KEYS


def test_tiny_run_values_are_finite(tiny_run):
    res = tiny_run["bench"]
    assert res["metric"] == "sparta_rows_per_sec"
    assert res["unit"] == "rows/s" and res["rows"] == 2 and res["nl"] == 35
    assert res["dtype"] == "float32" and res["device"] == "cpu"
    assert res["vs_committed_calm_best"] is None
    assert len(res["times_s"]) == 2 and len(res["block_minima_s"]) == 1
    # the oracle cube is the default config's: none at TINY_CONFIG
    assert res["rms_vs_f64_oracle"] is None
    for key in ("value", "vs_baseline", "elapsed_s", "block_spread",
                "baseline_rows_per_sec", "median_s"):
        assert isinstance(res[key], float) and math.isfinite(res[key]), key
        assert res[key] >= 0.0, key
    assert all(t > 0 and math.isfinite(t) for t in res["times_s"])
    assert res["median_s"] >= min(res["times_s"])
    assert res["value"] == round(2 / min(res["times_s"]), 3)
    assert res["row0_plan"] == {"otf_support": 0, "otf_blue": None}
    assert "# warm-up: 0 programs captured" in tiny_run["stderr"]


def test_tiny_run_launches_nothing_imports_no_jax_writes_no_baseline(
        tiny_run):
    launches = tiny_run["bench"]["launches_per_night"]
    assert set(launches) == {"zoom_dft", "zoom_dft_rowsplit",
                             "zoom_dft_disc", "zoom_dft_tc",
                             "zoom_dft_tc_rowsplit", "zoom_dft_tc_disc",
                             "zoom_dft_anchor", "zoom_dft_tc_anchor",
                             "conv_dft", "conv_dft_tc"}
    assert set(launches.values()) == {0}
    assert tiny_run["probe"] == {"rc": 0, "jax_loaded": []}
    before, after = tiny_run["digests"]
    assert before == after


@pytest.mark.parametrize("n_rows,chunk,golden", [
    (100, 50, "golden_plan_night100.json"),
    (1000, 100, "golden_plan_night1000.json")])
def test_row0_plan_of_the_bench_nights(n_rows, chunk, golden):
    """Row 0's plan in the first chunk, as the bench reports it, is the
    golden plan's group of row 0 (planning only, on the CPU)."""
    with open(os.path.join(DATA, golden)) as fh:
        plan = json.load(fh)
    delta = next(g["cfg_delta"] for g in plan["groups"] if 0 in g["rows"])
    assert delta == {"otf_support": 256, "otf_blue": [14, 128]}
    rows = night_rows(n_rows)
    first = [a[:min(chunk, n_rows)] for a in rows]
    assert bench_torch.row0_plan(*first, GalacsiConfig(), chunk,
                                 "cpu") == delta


def test_rms_vs_golden_compares_whole_cubes_only():
    golden = np.load(bench_torch.GOLDEN)
    assert bench_torch.rms_vs_golden(golden.astype(np.float32)) <= 1e-9
    step = np.zeros_like(golden)
    step[0, 0, 0] = 1.0
    want = 1.0 / math.sqrt(golden.size)
    assert math.isclose(bench_torch.rms_vs_golden(golden + step), want,
                        rel_tol=1e-9)
    assert bench_torch.rms_vs_golden(golden[:, 16:24, 16:24]) is None
    assert bench_torch.rms_vs_golden(golden[:12]) is None


def test_the_bench_night_matches_jax_in_float64():
    """The slice as a whole: the bench's night (its telemetry, its 35
    wavelengths, npsflin=1) through the port's ``process_batch`` and
    ``reconstruct_batch`` as ``bench_torch.main`` calls them, against the
    JAX package's on the same inputs, float64 at ``TINY_CONFIG``."""
    from muse_psfr_tpu.config import TINY_CONFIG as JTINY
    from muse_psfr_tpu.parallel import batch as jbatch
    from muse_psfr_tpu_torch.parallel import batch as tbatch
    kw = dict(dtype="float64", fit_dtype="float64")
    rows = night_rows(3)
    lb = bench_torch.LBDA
    got = tbatch.process_batch(*rows, lb, npsflin=1,
                               cfg=TINY_CONFIG.with_(**kw), chunk=50,
                               device="cpu")
    want = jbatch.process_batch(*rows, lb, npsflin=1, cfg=JTINY.with_(**kw),
                                chunk=50)
    assert got[1].shape == (35, 8, 8)
    assert np.abs(got[1] - want[1]).max() <= 1e-10 * np.abs(want[1]).max()
    # on these 8 x 8 planes the 20-iteration LM fit turns the cubes'
    # ~1e-12 apart into up to 3.6e-08 on n and 7.0e-08 on its error (row
    # 1 at 555 nm); the mean PSF's fit lies 1.0e-08 apart
    for g, w in ((got[0], want[0]), (got[2], want[2])):
        rel = np.abs(g - w) / np.maximum(np.abs(w), 1e-300)
        assert rel[..., :-1].max() <= 1e-6
        assert np.array_equal(g[..., -1], w[..., -1])
    psf0 = tbatch.reconstruct_batch(*rows, lb, npsflin=1,
                                    cfg=TINY_CONFIG.with_(**kw), chunk=50,
                                    device="cpu")[0]
    jpsf0 = np.asarray(jbatch.reconstruct_batch(
        *rows, lb, npsflin=1, cfg=JTINY.with_(**kw), chunk=50)[0])
    assert np.abs(psf0 - jpsf0).max() <= 1e-10 * np.abs(jpsf0).max()


def test_cuda_without_a_card_exits_nonzero():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    out = subprocess.run([sys.executable, "bench_torch.py"], cwd=ROOT,
                         env=dict(os.environ, PYTHONPATH=ROOT),
                         capture_output=True, text=True, timeout=120)
    assert out.returncode != 0
    assert "torch.cuda.is_available() is False" in out.stderr
    assert "sparta_rows_per_sec" not in out.stdout


def test_bench_torch_imports_neither_bench_py_nor_benchmarks():
    """Beyond the port's own scan (``test_torch_no_jax.py``): the script
    keeps its own copy of ``bench.py``'s baseline read and takes its
    telemetry from the port."""
    with open(os.path.join(ROOT, "bench_torch.py")) as fh:
        tree = ast.parse(fh.read())
    names = []
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names += [a.name for a in node.names]
        elif isinstance(node, ast.ImportFrom):
            names.append(node.module or "")
    tops = {n.split(".")[0] for n in names}
    assert tops == {"argparse", "json", "os", "subprocess", "sys", "time",
                    "numpy", "torch", "muse_psfr_tpu_torch"}, tops
