"""The launch plan of K6 (``ops/zoom_dft.py:anchor_launch_plan``), which
``csrc/zoom_anchor_tc.cu`` takes and checks: stages of the A2 ring, whether
TMA stages D, shared memory, grid, threads and the contraction rows A2's
parts are padded to.  Checked at every K6 launch of the anchored
9-direction nights as the planner makes them for a card, and over the
kernel's envelope: groups of 1 to 8 wavelengths, degree up to 11, 1, 2
and 9 directions and more, both precisions.  The constants the plan
shares with the CUDA source are read from it.  Host arithmetic only: no
card, no kernel."""

import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu_torch.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu_torch.ops import _build, zoom_dft  # noqa: E402
from muse_psfr_tpu_torch.ops.zoom_dft import (  # noqa: E402
    ANCHOR_MAX_DEGREE, ANCHOR_MAX_GROUP, ANCHOR_MAX_STAGES, ANCHOR_M_ROWS,
    ANCHOR_N_TILE, ANCHOR_SMEM_STATIC, SMEM_LIMIT, SMEM_SLACK,
    anchor_launch_plan, tma_aligned)
from muse_psfr_tpu_torch.otf import psf as tpsf  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch as tbatch  # noqa: E402
from muse_psfr_tpu_torch.utils.telemetry import night_rows  # noqa: E402

LB35 = np.linspace(490, 930, 35)
#: a thread's registers at most, and an SM's
REGS, SM_REGS = 255, 65536


def _check(plan, B, ndir, n, ncols, nl, m2, group, precision):
    """What every plan must give the kernel: shared memory within a
    block's share, an even ring of 2 to 8 A2 stages, two warpgroups of 255
    registers, the stage sizes of the source, whole TMA boxes."""
    parts = 2 if precision == "high" else 3
    rows = -(-min(ANCHOR_M_ROWS, m2) // 32) * 32
    assert plan.smem + ANCHOR_SMEM_STATIC <= SMEM_LIMIT == 227 * 1024
    assert 2 <= plan.stages <= ANCHOR_MAX_STAGES and plan.stages % 2 == 0
    assert plan.threads == 256 and plan.threads * REGS <= SM_REGS
    assert plan.stage_bytes == parts * rows * 32 * 2
    assert plan.g_bytes == 2 * group * parts * ANCHOR_N_TILE * 32 * 2
    assert plan.smem == (plan.stages * plan.stage_bytes + plan.g_bytes
                         + (plan.d_stage_bytes if plan.staged else 0)
                         + -(-ndir // 4) * 16 + SMEM_SLACK)
    assert plan.grid == (-(-ncols // ANCHOR_N_TILE) * -(-m2 // ANCHOR_M_ROWS)
                         * -(-nl // group), B)
    assert plan.n_pad % 8 == 0 and 0 <= plan.n_pad - n < 8


def _anchored_launches(precision, rows=100, chunk=44, **fields):
    """Every K6 launch of a 9-direction night (by default the bench's: 100
    rows, chunk 44) planned for a card with ``zoom_anchor="auto"``:
    (shape, wavelengths, 2M, group) per chunk, on the window of its
    group."""
    cfg = GalacsiConfig(zoom_anchor="auto", zoom_precision=precision,
                        **fields)
    summary = tbatch.plan_batch(*night_rows(rows), LB35, npsflin=3, cfg=cfg,
                                chunk=chunk, device="cuda").summary()
    out = []
    for g in summary["groups"]:
        c = cfg.with_(**g["cfg_delta"])
        assert c.zoom_anchor == "on" and c.otf_blue is None
        S = c.otf_window[1]
        for B in g["sizes"]:
            out.append(((B, 9, 2 * S, S + 128), summary["nl"],
                        4 * c.dimpsf, tpsf._anchor_lambda_chunk(c, 35)))
    return out


def _check_night(launches, sizes, precision):
    """The night's K6 launches have ``sizes`` rows, groups of 7 on 2M =
    160, and each plan fits and stages every operand by TMA with at least
    four A2 stages."""
    assert [s[0] for s, *_ in launches] == sizes
    for shape, nl, m2, group in launches:
        B, ndir, n, ncols = shape
        strides = (ndir * n * ncols, n * ncols, ncols, 1)
        assert group == 7 and m2 == 160
        aligned = tma_aligned(256, shape, strides, 256)
        plan = anchor_launch_plan(B, ndir, n, ncols, nl, m2, group,
                                  precision, aligned)
        _check(plan, B, ndir, n, ncols, nl, m2, group, precision)
        assert plan.staged and plan.stages >= 4
        assert plan.operands == {"a2": "tma", "dphi": "tma", "dl": "tma"}


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_every_launch_of_the_anchored_night_fits(precision):
    """The anchored night launches K6 three times (44 and 22 rows on the
    S = 256 window, 44 on the full one), groups of 7, and every launch
    stages D by TMA with at least four A2 stages."""
    _check_night(_anchored_launches(precision), [44, 22, 44], precision)


@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("rows,chunk,fields,sizes", [
    (1000, 100, {}, [100] * 5 + [75] + [100] * 5),
    (100, 25, {"dim": 2048}, [25, 25, 12, 25, 25])])
def test_every_launch_of_the_larger_anchored_nights_fits(precision, rows,
                                                          chunk, fields,
                                                          sizes):
    """The anchored 9-direction nights at 1000 rows (chunk 100) and on the
    2048^2 grid (chunk 25) plan K6 on their windows and full window in
    groups of 7; every launch fits and stages D by TMA with at least four
    A2 stages."""
    _check_night(_anchored_launches(precision, rows, chunk, **fields),
                 sizes, precision)


@pytest.mark.parametrize("precision", ["high", "highest"])
@pytest.mark.parametrize("ndir", [1, 2, 9, 10, 16, 25])
def test_the_envelope_fits(precision, ndir):
    """Groups of 1 to 8 wavelengths (at any degree up to 11: the
    coefficients take static shared memory), at 1, 2 and 9 directions and
    past them, on the full window and on 2M = 200 (two row blocks): every
    plan fits; D is staged at 9 directions and fewer, and
    past them whenever a D stage leaves two A2 stages, else read from
    device memory."""
    for group in range(1, ANCHOR_MAX_GROUP + 1):
        for m2 in (160, 200):
            plan = anchor_launch_plan(4, ndir, 1280, 768, 35, m2, group,
                                      precision)
            _check(plan, 4, ndir, 1280, 768, 35, m2, group, precision)
            if ndir <= 9:
                assert plan.staged
            room = (SMEM_LIMIT - ANCHOR_SMEM_STATIC - SMEM_SLACK
                    - plan.g_bytes - -(-ndir // 4) * 16)
            assert plan.staged == (room - plan.d_stage_bytes
                                   >= 2 * plan.stage_bytes)
    # the degree sets no shared memory: the coefficients are static
    assert ANCHOR_SMEM_STATIC == 8 * (2 * ANCHOR_MAX_STAGES + 2) \
        + 4 * ANCHOR_MAX_GROUP * (ANCHOR_MAX_DEGREE + 1)


@pytest.mark.parametrize("n,pad", [(36, 40), (250, 256), (1280, 1280),
                                   (513, 520), (1000, 1000)])
def test_contraction_rows_are_padded_not_refused(n, pad):
    """Any n is taken: A2's parts are padded to a multiple of 8 rows (the
    16-byte rows of a TMA box), where the mma.sync body needed n % 8 == 0
    at "high" and n % 4 == 0 at "highest"."""
    for precision in ("high", "highest"):
        plan = anchor_launch_plan(1, 9, n, 72, 16, 160, 8, precision)
        assert plan.n_pad == pad
        _check(plan, 1, 9, n, 72, 16, 160, 8, precision)


def test_an_unaligned_view_takes_the_direct_path():
    """A view of D whose base is 4 bytes off a 16-byte boundary, or whose
    rows are not a multiple of 16 bytes, is read from device memory; its
    plan still fits, with more A2 stages."""
    shape, strides = (1, 9, 250, 72), (9 * 250 * 80, 250 * 80, 80, 1)
    assert tma_aligned(256 + 16, shape, strides, 256)
    for ptr, st in ((256 + 4, strides), (256, (9 * 250 * 77, 250 * 77, 77,
                                               1))):
        assert not tma_aligned(ptr, shape, st, 256)
        for precision in ("high", "highest"):
            plan = anchor_launch_plan(1, 9, 250, 72, 16, 160, 8, precision,
                                      False)
            _check(plan, 1, 9, 250, 72, 16, 160, 8, precision)
            assert not plan.staged
            assert plan.operands == {"a2": "tma", "dphi": "direct",
                                     "dl": "direct"}
            assert plan.stages >= anchor_launch_plan(
                1, 9, 250, 72, 16, 160, 8, precision).stages


def test_the_plan_mirrors_the_cuda_source():
    """The tile sizes, stage limits, shared-memory budget and entry
    points as the CUDA source states them; the products are warpgroup
    MMAs fed by TMA, with no mma.sync, ldmatrix or cp.async left."""
    text = (_build.CSRC / "zoom_anchor_tc.cu").read_text()
    common = (_build.CSRC / "mma_common.cuh").read_text()

    def const(src, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", src)[1])

    assert const(text, "KB") == ANCHOR_MAX_GROUP
    assert const(text, "DMAX") == ANCHOR_MAX_DEGREE + 1
    assert const(text, "TJ") == ANCHOR_N_TILE == 24
    assert const(text, "TM") * const(text, "MT") == ANCHOR_M_ROWS
    assert const(text, "BOX_ROWS") == 32
    assert const(text, "MAX_STAGES") == ANCHOR_MAX_STAGES
    assert const(text, "SLACK") == SMEM_SLACK
    assert const(text, "NT") == 256
    assert const(common, "KS") == zoom_dft.K_STEP == 32
    assert const(common, "MAX_SMEM") == SMEM_LIMIT
    assert "bars[2 * MAX_STAGES + 2]" in text
    assert "float cs[KB][DMAX]" in text
    assert "__launch_bounds__(NT, 1)" in text
    for call in ("wgmma_m64n24k16_ss(", "tma_load_4d(", "tma_load_2d(",
                 "mbar_wait(", "mbar_expect_tx(", "fence_async_shared()"):
        assert call in text, call
    for old in ("mma.sync.aligned", "mma_bf16(", "ldmatrix.sync", "ldsm_x4",
                "cp.async.cg", "cp_async16(", "contract6_step",
                "stage_a_f32("):
        assert old not in text, old
    args = _build._SIGNATURES
    assert len(args["muse_fused_exp_zoom_anchor_tc"]) == 8 + 3 + 11 + 1
    assert len(args["muse_fused_exp_zoom_anchor"]) == 9 + 3 + 11 + 1
