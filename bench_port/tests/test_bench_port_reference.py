"""The frozen float64 references of the benchmark: the NumPy oracle copy
against the golden cube and the reference's CLI block, and the batched
PyTorch reference (the one the benchmark runs on the card) against it."""

import os
import sys

import numpy as np
import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port.reference import oracle_numpy as onp  # noqa: E402
from bench_port.reference import oracle_torch as ot  # noqa: E402

GOLDEN = os.path.join(ROOT, "tests", "data",
                      "golden_psf_35l_s1.0_gl0.7_l025.npy")
LBDA = np.linspace(490, 930, 35)
ALL_ON = np.ones((1, 4))


@pytest.fixture(scope="module")
def pinned_torch_cube():
    return ot.TorchOracle(LBDA).cube([1.0], [0.7], [25.0], ALL_ON)[0].numpy()


def test_torch_reference_is_the_golden_cube(pinned_torch_cube):
    golden = np.load(GOLDEN)
    assert pinned_torch_cube.shape == golden.shape
    rms = np.sqrt(np.mean((pinned_torch_cube - golden) ** 2))
    assert rms < 1e-15


def test_numpy_copy_gives_the_cli_block():
    """The reference's published block (test_psfrec.py:121-128): the mean
    PSF of (1.0", 0.7, 25 m) fitted at 500/700/900 nm."""
    fits, _ = onp.compute_psf_oracle(np.array([500.0, 700.0, 900.0]),
                                     1.0, 0.7, 25.0)
    assert " ".join(f"{f['fwhm'][0]:.2f}" for f in fits) == "0.85 0.73 0.62"
    assert " ".join(f"{f['n']:.2f}" for f in fits) == "2.73 2.55 2.23"


def test_numpy_copy_reads_its_own_tip_tilt_table():
    grid, coeff = onp.load_tt_coeff_table()
    assert grid.shape == coeff.shape == (200,)
    assert np.array_equal(grid, np.arange(1.0, 201.0))
    assert np.all(np.diff(coeff) > 0)


@pytest.mark.parametrize("npsflin,three", [(1, False), (3, True)])
def test_torch_reference_is_the_numpy_oracle(npsflin, three):
    """Two wavelengths, one row each of the 4- and 3-laser geometry, the
    9-direction grid: the batched torch reference against the row-by-row
    NumPy oracle, in float64."""
    lb = np.array([560.0, 880.0])
    _, want = onp.compute_psf_oracle(lb, 1.3, 0.45, 12.0, npsflin=npsflin,
                                     three_lgs_mode=three)
    mask = np.ones((2, 4))
    mask[1, 3] = 0.0 if three else 1.0
    got = ot.TorchOracle(lb, npsflin=npsflin).cube(
        [0.9, 1.3], [0.7, 0.45], [25.0, 12.0], mask)[1].numpy()
    assert np.max(np.abs(got - want)) / np.max(want) < 1e-12


def test_batched_fit_is_minpacks(pinned_torch_cube):
    planes = pinned_torch_cube[::5]
    fw, be = ot.fit_planes(planes)
    fs, bs = ot.fit_planes_scipy(planes)
    assert np.max(np.abs(fw / fs - 1)) < 1e-7
    assert np.max(np.abs(be / bs - 1)) < 1e-7


def test_crop_sizes_are_the_oracles():
    n = ot.crop_sizes(LBDA, 40, 0.2)
    assert n[0] <= 1280 and np.all(n % 2 == 0) and np.all(np.diff(n) <= 0)
