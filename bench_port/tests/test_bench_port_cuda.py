"""The control of the output check, on the card: the program at its
configuration passes the cell's limits, and the program with its own
lower-precision path switched on (``control.CONTROL``:
``matmul_precision="default"``, one bf16 pass for the plain products) fails
them.  At a size a test run holds: 20-row nights of the 1-direction night
cell.  Marked ``cuda``; skipped without a card:

    python -m pytest -q bench_port/tests/test_bench_port_cuda.py -m cuda

``bench_port/control.py`` takes the same readings at the cells' own sizes.
"""

import os
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))
sys.path.insert(0, ROOT)

from bench_port import control, harness  # noqa: E402

pytestmark = pytest.mark.cuda
CELL = "wfm1-night100"


@pytest.fixture(scope="module")
def small_cell():
    import torch
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    cell = harness.load_cell(harness.manifest(ROOT), CELL)
    cell["mix"] = dict(cell["mix"], rows=20, pool=2)
    cell["cell"] = dict(cell["cell"], chunk=10)
    return cell


def _fails(row, limits):
    return [k for k, lim in limits.items() if row[k] > lim]


def test_the_program_passes_and_its_control_fails(small_cell):
    limits = small_cell["cell"]["limits"]
    seeds = [3, 4, 2 ** 31 + 5]
    for row in control.readings(small_cell, seeds, 0.5):
        assert _fails(row, limits) == [], row
    for row in control.readings(small_cell, seeds, 0.5,
                                fields=control.CONTROL, label="control"):
        assert _fails(row, limits), row
