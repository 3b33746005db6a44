"""The launch plan of K1/K3/K5 (``ops/zoom_dft.py:tc_launch_plan``), which
``csrc/zoom_dft_tc.cu`` takes and checks: consumer warpgroups a block,
stages of the TMA ring, shared memory, grid, and which operands TMA
stages.  Checked at every zoom launch of the golden plans (the 1280^2
nights at 1 and 9 directions, the 2048^2 nights, the exact group), of the
CLI block and of the 32 x 32 sweep, as ``otf/psf.py`` makes them: the
structure function's window or its blue sub-window (a strided view), the
row splits of ``_zoom_row_splits`` on 132 SMs, "high" but "highest" in the
exact group.  Every launch fits a block's 227 KB and stages D by TMA;
a view that is not 16-byte aligned takes the direct path; A2's rows past
160 take more blocks.  The constants the plan shares with the CUDA source
are read from it.  Host arithmetic only: no card, no kernel."""

import json
import os
import re

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu_torch.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu_torch.ops import _build, zoom_dft  # noqa: E402
from muse_psfr_tpu_torch.ops.zoom_dft import (  # noqa: E402
    SMEM_BARRIERS, SMEM_LIMIT, tc_launch_plan, tma_aligned)
from muse_psfr_tpu_torch.otf import psf as tpsf  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch as tbatch  # noqa: E402

DATA = os.path.join(os.path.dirname(os.path.abspath(__file__)), "data")
LB35 = np.linspace(490, 930, 35)
SMS = 132
ALIGN = 256        # a fresh CUDA allocation's alignment


def _segments(cfg, nl, B, ndir):
    """The zoom launches of one chunk of ``B`` rows: (shape, element
    strides, element offset of the view, wavelengths) per window segment,
    the blue one a view of the structure function (``psf_cube_from_base``)."""
    S = cfg.otf_window[1]
    parent = (B, ndir, 2 * S, S + 128)
    strides = (ndir * 2 * S * (S + 128), 2 * S * (S + 128), S + 128, 1)
    if cfg.otf_blue is None:
        return [(parent, strides, 0, nl)]
    nb, cfg_blue, _ = tpsf._blue_split_cfgs(cfg, nl)
    Sb = cfg_blue.otf_window[1]
    lo = S - Sb
    return [((B, ndir, 2 * Sb, Sb + 128), strides, lo * (S + 128) + lo, nb),
            (parent, strides, 0, nl - nb)]


def _launches(summary, cfg):
    """Every K1/K3/K5 launch of a night planned as ``summary``."""
    out = []
    ndir = summary["npsflin"] ** 2
    for g in summary["groups"]:
        delta = {k: tuple(v) if isinstance(v, list) else v
                 for k, v in g["cfg_delta"].items()}
        c = cfg.with_(**delta)
        prec = "high" if c.use_dphi_split else "highest"
        for B in g["sizes"]:
            for shape, strides, off, nl in _segments(c, summary["nl"], B,
                                                     ndir):
                n, ncols = shape[2:]
                m2 = 4 * c.dimpsf
                r = tpsf._zoom_row_splits(
                    B * nl * -(-ncols // zoom_dft.N_TILE)
                    * -(-m2 // zoom_dft.M_TILE), n, SMS)
                out.append(dict(shape=shape, strides=strides, off=off, nl=nl,
                                m2=m2, R=r, precision=prec))
    return out


def _golden(name):
    with open(os.path.join(DATA, f"golden_plan_{name}.json")) as fh:
        return json.load(fh)


def _sweep_summary():
    grid = np.meshgrid(np.linspace(0.6, 1.6, 32), np.linspace(0.3, 0.9, 32),
                       (25.0,), indexing="ij")
    rows = [x.ravel() for x in grid] + [np.ones((grid[0].size, 4))]
    return tbatch.plan_batch(*rows, LB35, cfg=GalacsiConfig(), chunk=64,
                             device="cpu").summary()


def _cli_summary():
    """The CLI block: one row, 500/700/900 nm, on the S=256 window."""
    return {"npsflin": 1, "nl": 3,
            "groups": [{"cfg_delta": {"otf_support": 256}, "sizes": [1]}]}


NIGHTS = {
    "night100": ("night100", {}),
    "night100_npsflin3": ("night100_npsflin3", {}),
    "night1000": ("night1000", {}),
    "dim2048": ("night100_dim2048", {"dim": 2048}),
    "dim2048_npsflin3": ("night100_dim2048_npsflin3", {"dim": 2048}),
    "exact": ("night100_exact", {}),
}


def _plan(launch, ptr=ALIGN):
    B, ndir, n, ncols = launch["shape"]
    aligned = tma_aligned(ptr + 4 * launch["off"], launch["shape"],
                          launch["strides"], ALIGN)
    return aligned, tc_launch_plan(B, ndir, n, ncols, launch["nl"],
                                   launch["m2"], launch["R"],
                                   launch["precision"], aligned, SMS)


def _check(launch):
    aligned, plan = _plan(launch)
    B, ndir, n, ncols = launch["shape"]
    assert aligned, launch
    assert plan.staged and plan.operands == {"a2": "tma", "dphi": "tma",
                                             "dl": "tma"}
    assert plan.smem + SMEM_BARRIERS <= SMEM_LIMIT == 227 * 1024
    assert 2 <= plan.stages <= zoom_dft.MAX_STAGES
    assert plan.threads == 128 * (plan.warpgroups + 1) <= 384
    parts = 2 if launch["precision"] == "high" else 3
    assert plan.stage_bytes == (parts * 160 * 32 * 2 + plan.warpgroups * 2
                                * (ndir + 1) * 32 * 32 * 4)
    njt = -(-ncols // 64)
    assert plan.grid == (-(-njt // plan.warpgroups) * -(-launch["m2"] // 160)
                         * launch["R"], launch["nl"], B)
    assert plan.n_pad == n and n % 8 == 0
    return plan


@pytest.mark.parametrize("night", sorted(NIGHTS))
def test_every_launch_of_the_golden_nights_fits(night):
    name, fields = NIGHTS[night]
    summary = _golden(name)
    cfg = GalacsiConfig(**fields)
    launches = _launches(summary, cfg)
    assert launches
    plans = [_check(x) for x in launches]
    # the row splits the main path takes: full chunks never split, a
    # blue segment of a short tail chunk may
    assert all(x["R"] == 1 for x in launches if x["shape"][0] >= 25)
    if night == "exact":
        assert {x["precision"] for x in launches} == {"high", "highest"}
        top = [p for x, p in zip(launches, plans)
               if x["precision"] == "highest"]
        assert {x["shape"][2:] for x in launches
                if x["precision"] == "highest"} == {(1280, 768)}
        assert all(p.stage_bytes == 3 * 10240 + 2 * 2 * 2 * 4096
                   for p in top)
    if "npsflin3" in night:
        # 9 directions: one warpgroup a block, two stages
        assert all((p.warpgroups, p.stages) == (1, 2) for p in plans)
    else:
        assert all(p.warpgroups == 2 for p in plans)


def test_the_blue_views_are_strided_and_aligned():
    """The blue sub-window is a view with the parent's strides at an
    offset of lo rows and lo columns, lo = S - S_blue a multiple of 128:
    16-byte aligned, so TMA stages it."""
    seen = set()
    for name, fields in NIGHTS.values():
        for x in _launches(_golden(name), GalacsiConfig(**fields)):
            if x["off"]:
                seen.add((x["shape"][2:], x["strides"][2], x["off"]))
                assert (4 * x["off"]) % 16 == 0
                assert _plan(x)[1].staged
    assert ((256, 256), 384, 128 * 384 + 128) in seen        # S=256 / 128
    assert any(shape == (512, 384) for shape, _, _ in seen)   # 2048^2


def test_cli_and_sweep_launches_fit():
    cli = _launches(_cli_summary(), GalacsiConfig())
    assert [(x["shape"], x["nl"], x["R"]) for x in cli] == \
        [((1, 1, 512, 384), 3, 8)]
    plan = _check(cli[0])
    # 1 x 3 x 6 tiles x R 8: two warpgroups a block would leave SMs idle
    assert plan.warpgroups == 1 and plan.grid == (48, 3, 1)
    sweep = _launches(_sweep_summary(), GalacsiConfig())
    assert len(sweep) >= 17
    for x in sweep:
        _check(x)


@pytest.mark.parametrize("precision", ["high", "highest"])
def test_unaligned_views_take_the_direct_path(precision):
    """A view one column in (4-byte offset, odd row stride) cannot be a
    TMA source: D and dl go through the direct path and TMA stages A2
    alone; a dimension of size 1 may carry any stride."""
    B, ndir, n, ncols = 2, 3, 128, 319
    assert not tma_aligned(ALIGN + 4 * (64 * 384 + 65), (B, ndir, n, ncols),
                           (3 * 256 * 384, 256 * 384, 384, 1), ALIGN)
    assert not tma_aligned(ALIGN, (B, ndir, n, 320), (3 * 256 * 385,
                                                       256 * 385, 385, 1),
                           ALIGN)
    assert not tma_aligned(ALIGN, (1, 1, n, 320), (n * 320, n * 320, 320, 1),
                           ALIGN + 4)
    assert tma_aligned(ALIGN, (1, 1, n, 320), (7, 5, 320, 1), ALIGN)
    plan = tc_launch_plan(B, ndir, n, ncols, 3, 160, 1, precision, False,
                          SMS)
    assert not plan.staged
    assert plan.operands == {"a2": "tma", "dphi": "direct", "dl": "direct"}
    parts = 2 if precision == "high" else 3
    assert plan.stage_bytes == parts * 160 * 32 * 2
    assert plan.smem + SMEM_BARRIERS <= SMEM_LIMIT
    # ten directions at "highest" do not fit two stages: direct as well
    top = tc_launch_plan(4, 10, 1280, 768, 35, 160, 1, "highest", True, SMS)
    assert not top.staged and top.operands["dphi"] == "direct"
    assert tc_launch_plan(4, 10, 1280, 768, 35, 160, 1, "high", True,
                          SMS).staged


@pytest.mark.parametrize("m2,nib", [(160, 1), (170, 2), (320, 2), (480, 3)])
def test_rows_of_a2_past_160_take_more_blocks(m2, nib):
    plan = tc_launch_plan(2, 1, 512, 200, 3, m2, 2, "high", True, SMS)
    assert plan.grid == (-(-4 // plan.warpgroups) * nib * 2, 3, 2)
    assert plan.stage_bytes == 2 * 160 * 32 * 2 + plan.warpgroups * 2 * 2 \
        * 4096


def test_contraction_rows_are_padded_to_whole_boxes():
    """A2's parts are padded to a multiple of 8 rows (16-byte rows of the
    TMA box); any n is taken."""
    for n, pad in ((36, 40), (34, 40), (1280, 1280), (513, 520)):
        assert tc_launch_plan(1, 1, n, 64, 1, 16, 1, "high", True,
                              SMS).n_pad == pad


def test_the_plan_mirrors_the_cuda_source():
    """The tile sizes, stage limits, shared-memory budget and the plan's
    arguments as the CUDA source states them."""
    tc = (_build.CSRC / "zoom_dft_tc.cu").read_text()
    common = (_build.CSRC / "mma_common.cuh").read_text()

    def const(text, name):
        return int(re.search(rf"constexpr int {name} = (\d+);", text)[1])

    assert const(common, "TI") == zoom_dft.M_TILE == 160
    assert const(common, "KS") == zoom_dft.K_STEP == 32
    assert const(common, "MAX_SMEM") == SMEM_LIMIT
    assert const(tc, "TJ") == zoom_dft.N_TILE == 64
    assert const(tc, "MAX_WGS") == zoom_dft.MAX_WARPGROUPS
    assert const(tc, "MAX_STAGES") == zoom_dft.MAX_STAGES
    assert const(tc, "SLACK") == zoom_dft.SMEM_SLACK
    assert const(tc, "BOX_COLS") == 32
    assert "bars[2 * MAX_STAGES]" in tc
    assert SMEM_BARRIERS == 2 * 8 * zoom_dft.MAX_STAGES
    assert re.search(r"return \(passes / 3 \+ 1\) \* A_PART \+ \(staged \? "
                     r"wgs \* 2 \* \(ndir \+ 1\) \* BOX : 0\);", tc)
    # the products: warpgroup MMA from registers, TMA staging, no mma.sync
    for call in ("wgmma_m64n160k16_rs(", "wgmma_m64n40k16_rs(",
                 "tma_load_3d(", "tma_load_4d(", "tma_load_2d(",
                 "mbar_wait(", "reg_alloc<", "reg_dealloc<"):
        assert call in tc, call
    for old in ("mma_bf16(", "ldsm_x4", "cp_async16(", "contract6_step"):
        assert old not in tc, old
    args = _build._SIGNATURES
    assert len(args["muse_fused_exp_zoom_tc"]) == 9 + 3 + 12 + 1
    assert len(args["muse_fused_exp_zoom"]) == 10 + 3 + 12 + 1


def test_the_mma_sync_body_is_a_tool_only():
    """K1/K3/K5's former mma.sync body lives under tools/mma_sync_bodies/
    with entry points of its own, which no source of the package defines;
    the package's body issues no mma.sync."""
    text = {p.name: p.read_text() for p in _build.sources()}
    tool = (_build.CSRC.parents[1] / "tools" / "mma_sync_bodies" /
            "zoom_dft_tc_mma.cu").read_text()
    for name in ("muse_fused_exp_zoom_tc_mma", "muse_fused_exp_zoom_mma"):
        assert f'extern "C" int {name}(' in tool
        assert not any(name in s for s in text.values())
        assert name not in _build._SIGNATURES
    assert "mma.sync.aligned" not in text["zoom_dft_tc.cu"]
    assert "mma_bf16(" in tool
