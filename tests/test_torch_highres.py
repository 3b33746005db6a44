"""The PyTorch port's two main-path configurations beyond the bench night,
against the JAX package on the CPU: the 2048^2 high-resolution grid
(``GalacsiConfig(dim=2048)``) and the exact structure-function group
(rows with ``L0 < cfg.dphi_split_l0_min``, 2.5 m, which leave the split
PSD for ``simulate_psd`` over the full grid and ``dphi_base``).

* The golden plans ``tests/data/golden_plan_night100_dim2048.json``
  (the bench night, chunk 25), ``..._dim2048_npsflin3.json`` (the same
  at 9 directions) and ``golden_plan_night100_exact.json`` (the bench
  night at dim 1280, chunk 50, with L0 = 2.0 on rows 0, 10, ..., 90),
  each ``json.dumps(plan.summary(), indent=1, sort_keys=True)`` of the
  JAX package's ``plan_batch``: equal to the port's plan and to the JAX
  package's live plan; the one-row 2048 plan (chunk 1) likewise.
* One row at dim 2048 in float64 through ``compute_psf``: the PSF within
  1e-10 of its max and the fits within 1e-8 relative of the JAX
  package's; FWHM within 0.02 and beta within 0.1 of dim 1280, the
  counterpart of ``tests/test_sweep_highres.py::test_highres_2048_mode``.
* Three rows, L0 = 2.0, 25 and 2.0, in float64 through ``process_batch``
  at ``use_fft`` True and False: the exact group planned and every output
  within the same tolerances of the JAX package's.
* The golden PSF cubes of ``tools/make_golden_psf.py`` (the float64
  oracle at dim 2048, and at L0 = 2.0): the port's float64 result at two
  wavelengths within 1e-5 rms of each.
* The exact group contracts its zoom at "highest" on the card
  (``otf/psf.py:_zoom_precision``): the L0 = 2.0 pinned row in float32,
  with the kernels' plain versions at the precisions the card takes,
  within 1e-5 rms of its golden, and over it at "high".
"""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu import api as japi  # noqa: E402
from muse_psfr_tpu.config import GalacsiConfig as JConfig  # noqa: E402
from muse_psfr_tpu.parallel import batch as jbatch  # noqa: E402
from muse_psfr_tpu_torch import api as tapi  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig as TConfig  # noqa: E402
from muse_psfr_tpu_torch.otf import psf as tpsf  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch as tbatch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DATA = os.path.join(ROOT, "tests", "data")
sys.path.insert(0, ROOT)

from bench import build_rows  # noqa: E402

LB35 = np.linspace(490, 930, 35)
LB2 = np.array([500.0, 900.0])
F64 = dict(dtype="float64", fit_dtype="float64")


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


def _exact_night():
    """The bench night with L0 = 2.0 on rows 0, 10, ..., 90."""
    seeing, GL, L0, mask = build_rows(100)
    L0 = L0.copy()
    L0[::10] = 2.0
    return seeing, GL, L0, mask


@pytest.mark.parametrize("name,exact,npsflin,dim,chunk", [
    ("night100_dim2048", False, 1, 2048, 25),
    ("night100_dim2048_npsflin3", False, 3, 2048, 25),
    ("night100_exact", True, 1, 1280, 50),
])
def test_golden_plan(name, exact, npsflin, dim, chunk):
    r = _exact_night() if exact else build_rows(100)
    with open(os.path.join(DATA, f"golden_plan_{name}.json")) as fh:
        golden = json.load(fh)
    got = tbatch.plan_batch(*r, LB35, npsflin=npsflin, cfg=TConfig(dim=dim),
                            chunk=chunk).summary()
    want = jbatch.plan_batch(*r, LB35, npsflin=npsflin,
                             cfg=JConfig(dim=dim), chunk=chunk).summary()
    assert got == golden
    assert want == golden


def test_golden_plan_groups():
    """What the golden plans say, spelled out: at dim 2048 the S=512
    bucket with blue sub-windows on S=256 and the full window with its
    7 bluest wavelengths on S=512; the exact rows as their own group."""
    def groups(name):
        with open(os.path.join(DATA, f"golden_plan_{name}.json")) as fh:
            return [(g["cfg_delta"], len(g["rows"]), g["sizes"])
                    for g in json.load(fh)["groups"]]

    assert groups("night100_dim2048") == [
        ({"otf_support": 512, "otf_blue": [28, 256]}, 48, [25, 25]),
        ({"otf_support": 512}, 14, [18]),
        ({"otf_blue": [7, 512]}, 25, [25]),
        ({}, 13, [25])]
    exact = groups("night100_exact")
    assert exact[0] == ({"use_dphi_split": False}, 10, [50])
    with open(os.path.join(DATA, "golden_plan_night100_exact.json")) as fh:
        assert json.load(fh)["groups"][0]["rows"] == list(range(0, 100, 10))


def test_one_row_plan_2048():
    args = ([1.0], [0.7], [25.0], np.ones((1, 4)), LB35)
    got = tbatch.plan_batch(*args, cfg=TConfig(dim=2048), chunk=1).summary()
    want = jbatch.plan_batch(*args, cfg=JConfig(dim=2048),
                             chunk=1).summary()
    assert got == want
    assert [g["cfg_delta"] for g in got["groups"]] == [
        {"otf_support": 512, "otf_blue": [21, 256]}]


@pytest.fixture(scope="module")
def psf_2048():
    """The port's float64 ``compute_psf`` of (1.0, 0.7, 25) at 500 and
    900 nm on the 2048^2 grid."""
    return tapi.compute_psf(LB2, 1.0, 0.7, 25.0, verbose=False,
                            cfg=TConfig(dim=2048, **F64), device="cpu")


def test_compute_psf_2048_float64_matches_jax(psf_2048):
    got, psf = psf_2048
    want, jpsf = japi.compute_psf(LB2, 1.0, 0.7, 25.0, verbose=False,
                                  cfg=JConfig(dim=2048, **F64))
    assert psf.shape == (2, 40, 40)
    assert got.colnames == want.colnames
    assert np.abs(psf - jpsf).max() <= 1e-10 * np.abs(jpsf).max()
    for k in ("fwhm", "n", "flux", "err_fwhm"):
        assert _rel(got[k], want[k]).max() <= 1e-8, k


def test_highres_2048_mode(psf_2048):
    """The port's counterpart of ``test_sweep_highres.py``'s test: the
    2048^2 grid moves FWHM by < 0.02 and beta by < 0.1 from 1280^2."""
    hi, _ = psf_2048
    lo, _ = tapi.compute_psf(LB2, 1.0, 0.7, 25.0, verbose=False,
                             cfg=TConfig(**F64), device="cpu")
    assert np.all(np.abs(hi["fwhm"][:, 0] - lo["fwhm"][:, 0]) < 0.02)
    assert np.all(np.abs(hi["n"] - lo["n"]) < 0.1)


@pytest.mark.parametrize("use_fft", [True, False])
def test_exact_group_float64_matches_jax(use_fft):
    rows = ([1.0, 0.8, 1.3], [0.7, 0.5, 0.6], [2.0, 25.0, 2.0],
            np.ones((3, 4)))
    kw = dict(use_fft=use_fft, **F64)
    plan = tbatch.plan_batch(*rows, LB2, cfg=TConfig(**kw), chunk=3)
    exact = [g for g in plan.groups if not g.cfg.use_dphi_split]
    assert [g.rows.tolist() for g in exact] == [[0, 2]]
    got = tbatch.process_batch(*rows, LB2, cfg=TConfig(**kw), chunk=3,
                               device="cpu")
    want = jbatch.process_batch(*rows, LB2, cfg=JConfig(**kw), chunk=3)
    fit, psf_mean, fit_mean = got
    assert fit.shape == (3, 2, 13) and psf_mean.shape == (2, 40, 40)
    assert (np.abs(psf_mean - want[1]).max()
            <= 1e-10 * np.abs(want[1]).max())
    assert _rel(fit, want[0])[..., :-1].max() <= 1e-8
    assert _rel(fit_mean, want[2])[..., :-1].max() <= 1e-8
    assert np.array_equal(fit[..., -1], want[0][..., -1])


@pytest.mark.parametrize("golden,L0,dim", [
    ("golden_psf_35l_s1.0_gl0.7_l025_dim2048.npy", 25.0, 2048),
    ("golden_psf_35l_s1.0_gl0.7_l02.0.npy", 2.0, 1280),
])
def test_golden_psf(golden, L0, dim):
    """The port's float64 cube of the pinned row at the first and the
    last wavelength of the golden grid, within 1e-5 rms of the file, and
    within 1e-8 of its max: the windows drop only OTF values below 1e-9
    of the DC, while the 1280^2 and 2048^2 goldens differ by 4.5e-4 of the
    max there, so the file pins its grid."""
    pick = [0, LB35.size - 1]
    cube = tbatch.reconstruct_batch([1.0], [0.7], [L0], np.ones((1, 4)),
                                    LB35[pick], cfg=TConfig(dim=dim, **F64),
                                    chunk=1, device="cpu")[0]
    want = np.load(os.path.join(DATA, golden))
    assert want.shape == (35, 40, 40) and want.dtype == np.float64
    rms = float(np.sqrt(np.mean((cube - want[pick]) ** 2)))
    assert rms <= 1e-5, rms
    assert np.abs(cube - want[pick]).max() <= 1e-8 * np.abs(want).max()


def test_exact_group_contracts_at_highest_on_the_card(monkeypatch):
    """The L0 = 2.0 pinned row at the default config (zoom_precision
    "high") in float32, each chunk contracting as it would on the card
    (the plain versions of the kernels at ``_zoom_precision(cfg,
    "cuda")``): within 1e-5 rms of the float64 oracle, because its exact
    group takes "highest" (6.3e-06 here); at "high" it lies over the
    budget (1.08e-05 here, 1.235e-05 on an H100), since its cube sums to
    ~490 a plane (the reference's tip-tilt kernel, nearly a delta at this
    outer scale, is not renormalised)."""
    for prec in ("high", "highest"):
        cfg = TConfig(zoom_precision=prec)
        assert tpsf._zoom_precision(cfg, "cuda") == prec
        exact = cfg.with_(use_dphi_split=False)
        assert tpsf._zoom_precision(exact, "cuda") == "highest"
        assert tpsf._zoom_precision(exact, "cpu") == "highest"
    want = np.load(os.path.join(DATA, "golden_psf_35l_s1.0_gl0.7_l02.0.npy"))

    def rms(rule):
        monkeypatch.setattr(tpsf, "_zoom_precision", rule)
        cube = tbatch.reconstruct_batch([1.0], [0.7], [2.0], np.ones((1, 4)),
                                        LB35, cfg=TConfig(), chunk=1,
                                        device="cpu")[0]
        assert cube.dtype == np.float32
        return float(np.sqrt(np.mean((cube - want) ** 2)))

    card = tpsf._zoom_precision
    assert rms(lambda cfg, device: card(cfg, "cuda")) <= 1e-5
    assert rms(lambda cfg, device: cfg.zoom_precision) > 1e-5
