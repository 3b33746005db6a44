"""The 1000-row night at 9 directions and chunk 88, item 3a' of
``benchmarks/run_all.py`` (the JAX package's production list: the
reference's field-dependent signature over a long night), planned on the
CPU by the port and by the JAX package.

* The golden plan ``tests/data/golden_plan_night1000_npsflin3.json``,
  ``json.dumps(plan.summary(), indent=1, sort_keys=True)`` of the JAX
  package's ``plan_batch(*build_rows(1000), np.linspace(490, 930, 35),
  npsflin=3, cfg=GalacsiConfig(), chunk=88)``: equal to the port's plan
  and to the JAX package's live plan (each planned once: the first plan
  of a process builds the float64 basis).
* What it says, spelled out: four groups in twelve chunks, the S=256
  bucket with its blue sub-windows on S=128 and the full window with its
  14 bluest wavelengths on S=256; so 21 launches of K1 at "high" a night,
  and 12 of K2 on the FFT-free route (``chip_smoke.py:plan_kernels``).
* The full-window chunk's structure function, (88, 9, 1280, 768) float32,
  spans more than 2^31 bytes, the first on the main path to do so."""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu.config import GalacsiConfig as JConfig  # noqa: E402
from muse_psfr_tpu.parallel import batch as jbatch  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig as TConfig  # noqa: E402
from muse_psfr_tpu_torch.otf import psf as tpsf  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch as tbatch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402
from bench import build_rows  # noqa: E402

NAME = "golden_plan_night1000_npsflin3.json"
LB35 = np.linspace(490, 930, 35)


@pytest.fixture(scope="module")
def golden():
    with open(os.path.join(ROOT, "tests", "data", NAME)) as fh:
        return json.load(fh)


@pytest.fixture(scope="module")
def rows():
    return build_rows(1000)


@pytest.mark.parametrize("side", ["port", "jax"])
def test_golden_plan(golden, rows, side):
    if side == "port":
        got = tbatch.plan_batch(*rows, LB35, npsflin=3, cfg=TConfig(),
                                chunk=88, device="cpu").summary()
    else:
        got = jbatch.plan_batch(*rows, LB35, npsflin=3, cfg=JConfig(),
                                chunk=88).summary()
    assert got == golden


def test_golden_plan_groups(golden):
    groups = [(g["cfg_delta"], len(g["rows"]), g["sizes"], g["nvals"])
              for g in golden["groups"]]
    assert groups == [
        ({"otf_support": 256, "otf_blue": [28, 128]}, 352, [88] * 4,
         [88] * 4),
        ({"otf_support": 256, "otf_blue": [14, 128]}, 222, [88, 88, 66],
         [88, 88, 46]),
        ({"otf_blue": [14, 256]}, 176, [88, 88], [88, 88]),
        ({}, 250, [88, 88, 88], [88, 88, 74])]
    assert sorted(r for g in golden["groups"] for r in g["rows"]) == \
        list(range(1000))
    assert (golden["n_rows"], golden["nl"], golden["npsflin"],
            golden["chunk"]) == (1000, 35, 3, 88)


@pytest.mark.parametrize("fft_free,want", [
    (False, {"zoom_dft_tc": 21}),
    (True, {"zoom_dft_tc": 21, "conv_dft": 12})])
def test_launches_a_night(fft_free, want):
    assert chip_smoke.plan_kernels(NAME, fft_free) == want


def test_the_full_window_chunk_passes_2_31_bytes(golden):
    """D of a full-window chunk, (B, ndir, 2S, S + 128) float32 over the
    fold window (0, 640) of the default config: 2.90 GiB, its last row's
    part starting 2.87 GiB past the base, and every row from 61 on past
    2^31 bytes; the blue view of its S=256 sub-window starts 384 rows and
    384 columns in."""
    cfg = TConfig()
    r_lo, r_hi, col_hi, S = tpsf._window_bounds(cfg)
    n, ncols = r_hi - r_lo, col_hi - r_lo
    assert (r_lo, n, ncols, S) == (0, 1280, 768, 640)
    B = max(max(g["sizes"]) for g in golden["groups"]
            if "otf_support" not in g["cfg_delta"])
    ndir = golden["npsflin"] ** 2
    row = 4 * ndir * n * ncols
    assert (B, ndir) == (88, 9)
    # rows 61 to 87 of the chunk start past 2^31 bytes
    assert 60 * row < 2 ** 31 < 61 * row
    assert round(B * row / 2 ** 30, 2) == 2.90
    assert round((B - 1) * row / 2 ** 30, 2) == 2.87
    nb, cfg_blue, _ = tpsf._blue_split_cfgs(cfg.with_(otf_blue=(14, 256)),
                                            35)
    assert (nb, cfg_blue.otf_window) == (14, (384, 256))
