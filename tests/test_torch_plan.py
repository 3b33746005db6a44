"""The PyTorch port's batch planner against the JAX package's: the golden
plans of the three bench nights, the host admission model (row masks and
ring samples), the pinned-window rule, the window guard with a blue
sub-window, and the small scheduling helpers.  Everything here is host
numpy and CPU tensors, as the planner is on the card too."""

import json
import os
import sys

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.config import GalacsiConfig as JConfig  # noqa: E402
from muse_psfr_tpu.parallel import batch as jbatch  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig as TConfig  # noqa: E402
from muse_psfr_tpu_torch.otf.psf import _zoom_row_splits  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch as tbatch  # noqa: E402

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from bench import build_rows  # noqa: E402

LB35 = np.linspace(490, 930, 35)
H = (100, 10000)


@pytest.fixture(autouse=True)
def _clear_plan_env(monkeypatch):
    for var in ("MUSE_PSFR_NO_TAIL", "MUSE_PSFR_NO_BLUE",
                "MUSE_PSFR_BLUE_TIERS"):
        monkeypatch.delenv(var, raising=False)


@pytest.mark.parametrize("name,n,chunk,npsflin", [
    ("night100", 100, 50, 1),
    ("night1000", 1000, 100, 1),
    ("night100_npsflin3", 100, 44, 3),
])
def test_golden_plan(name, n, chunk, npsflin):
    plan = tbatch.plan_batch(*build_rows(n), LB35, npsflin=npsflin,
                             cfg=TConfig(), chunk=chunk)
    with open(os.path.join(ROOT, "tests", "data",
                           f"golden_plan_{name}.json")) as fh:
        golden = json.load(fh)
    assert plan.summary() == golden
    assert not plan.table.flags.writeable
    assert all(not g.rows.flags.writeable for g in plan.groups)
    assert tbatch.plan_batch(*build_rows(n), LB35, npsflin=npsflin,
                             cfg=TConfig(), chunk=chunk) is plan


def _margins(rows, lbda_max, S, d_tot, r_of_pt):
    """Each row's admission margin: min over the rays beyond the window
    of 0.5 convnm^2 D - ln(1e12) (>= 0 admits)."""
    convnm2 = (2.0 * np.pi / lbda_max) ** 2
    sel = r_of_pt >= S - 1
    return (0.5 * convnm2 * d_tot[:, :, sel]).min(axis=(1, 2)) \
        + np.log(1e-12)


@pytest.mark.parametrize("lbda_max", [658.2, 930.0])
@pytest.mark.parametrize("S", [128, 256, 384])
def test_rows_windowable_masks_match_jax(S, lbda_max):
    rows = build_rows(1000)
    got = tbatch.rows_windowable(*rows, lbda_max, TConfig(), S)
    want = jbatch.rows_windowable(*rows, lbda_max, JConfig(), S)
    if not np.array_equal(got, want):
        idx, d_tot, r_of_pt = tbatch._ring_damping(
            *rows, TConfig(), tuple(float(x) for x in H), 12.0, 1)
        m = _margins(rows, lbda_max, S, d_tot, r_of_pt)
        bad = np.nonzero(got != want)[0]
        pytest.fail(f"rows {bad.tolist()} disagree; port margins "
                    f"{m[bad].tolist()} (port {got[bad]}, jax {want[bad]})")
    assert 0 < got.sum() < got.size or S == 128


@pytest.mark.parametrize("npsflin", [1, 3])
def test_ring_damping_matches_jax(npsflin):
    s, g, l0, m = build_rows(40)
    l0[3] = 2.0                         # outside the split range: dropped
    h_t = tuple(float(x) for x in H)
    idx, d_tot, r = tbatch._ring_damping(s, g, l0, m, TConfig(), h_t, 12.0,
                                         npsflin)
    jidx, jd_tot, jr = jbatch._ring_damping(s, g, l0, m, JConfig(), h_t,
                                            12.0, npsflin)
    assert np.array_equal(idx, jidx) and 3 not in idx
    assert np.array_equal(r, jr)
    assert d_tot.shape == (39, npsflin * npsflin, r.size)
    assert np.abs(d_tot - jd_tot).max() <= 1e-6 * np.abs(jd_tot).max()


@pytest.mark.parametrize("pin", [{"otf_support": 256},
                                 {"otf_blue": (14, 128)},
                                 {"otf_support": 256, "otf_blue": (7, 128)}])
def test_pinned_window_is_kept(pin):
    """A caller's otf_support/otf_blue is honoured, not replaced by the
    full window: the plan equals the JAX package's (one pinned group
    plus the exact-transform row), and the window stays on its rows."""
    s, g, l0, m = build_rows(30)
    l0[4] = 2.0
    got = tbatch.plan_batch(s, g, l0, m, LB35, cfg=TConfig(**pin),
                            chunk=8).summary()
    want = jbatch.plan_batch(s, g, l0, m, LB35, cfg=JConfig(**pin),
                             chunk=8).summary()
    assert got == want
    windowed = [gr for gr in got["groups"]
                if "use_dphi_split" not in gr["cfg_delta"]]
    assert len(windowed) == 1 and len(windowed[0]["rows"]) == 29
    cfg_p = tbatch._plan_batch(s, g, l0, m, LB35, H, 1, TConfig(**pin),
                               8)[1][1][0]
    for k, v in pin.items():
        assert getattr(cfg_p, k) == v


def test_estimate_otf_support_matches_jax():
    for tel in [([1.0], [0.7], [25.0]), ([0.4], [0.05], [30.0]),
                ([1.6, 0.6], [0.9, 0.3], [9.0, 29.0])]:
        mask = np.ones((len(tel[0]), 4))
        cfg_kw = dict(dim=512, dim_pup=24, dimpsf=12)
        assert (tbatch.estimate_otf_support(*tel, mask, 930.0,
                                            TConfig(**cfg_kw))
                == jbatch.estimate_otf_support(*tel, mask, 930.0,
                                               JConfig(**cfg_kw)))


BLUE_KW = dict(dim=512, dim_pup=16, dimpsf=12, lambda_chunk=2)


def _guards(base, lb, **kw):
    got = float(tbatch._window_guard(torch.as_tensor(base)[None],
                                     torch.as_tensor(lb),
                                     TConfig(**kw))[0])
    want = float(jbatch._window_guard(jnp.asarray(base), jnp.asarray(lb),
                                      JConfig(**kw)))
    return got, want


def test_window_guard_blue_matches_jax():
    """The guard of tests/test_otf_support.py::test_window_guard_blue_
    boundary: each truncation boundary of the blue sub-window trips, a
    weak value strictly inside does not, the pure full window is +inf,
    and a bucket window's own boundary still trips; port == JAX."""
    S, Sb, nb = 256, 128, 3
    lb = np.linspace(500.0, 900.0, 6).astype(np.float32)
    base = np.full((1, 2 * S, S + 128), 1e9, np.float32)
    got, want = _guards(base, lb, **BLUE_KW)
    assert np.isinf(got) and np.isinf(want)
    blue = dict(BLUE_KW, otf_blue=(nb, Sb))
    cases = [(S - Sb, S, True), (S + Sb - 1, S, True), (S, S - Sb, True),
             (S, S, False)]
    for r, c, trips in [(None, None, False)] + cases:
        b = base.copy()
        if r is not None:
            b[0, r, c] = 0.0
        got, want = _guards(b, lb, **blue)
        assert got == pytest.approx(want, rel=1e-6)
        assert (got < 0) == trips, (r, c)
    wb = dict(dim=1024, dim_pup=16, dimpsf=12, otf_support=256,
              otf_blue=(3, 128))
    bw = np.full((1, 512, 384), 1e9, np.float32)
    for r, c, trips in [(None, None, False), (0, 5, True)]:
        b = bw.copy()
        if r is not None:
            b[0, r, c] = 0.0
        got, want = _guards(b, lb, **wb)
        assert got == pytest.approx(want, rel=1e-6)
        assert (got < 0) == trips


def test_blue_split_plan_matches_jax():
    """Graded admission at the small config: the port's groups equal the
    JAX package's, for blue_tiers 1 and 2 and chunks 1, 2 and 4."""
    lb = np.linspace(500.0, 900.0, 8)
    see = np.array([0.9, 1.0, 0.5, 1.4, 0.8, 1.2])
    gl = np.array([0.85, 0.85, 0.85, 0.8, 0.6, 0.7])
    l0 = np.full(6, 25.0)
    mask = np.ones((6, 4))
    for tiers in (1, 2):
        for chunk in (1, 2, 4):
            got = tbatch.plan_batch(see, gl, l0, mask, lb,
                                    cfg=TConfig(blue_tiers=tiers,
                                                **BLUE_KW),
                                    chunk=chunk).summary()
            want = jbatch.plan_batch(see, gl, l0, mask, lb,
                                     cfg=JConfig(blue_tiers=tiers,
                                                 **BLUE_KW),
                                     chunk=chunk).summary()
            assert got == want, (tiers, chunk)


def test_blue_tiers():
    assert tbatch._blue_tiers(TConfig(), 1) == 1
    assert tbatch._blue_tiers(TConfig(), 9) == 2
    assert tbatch._blue_tiers(TConfig(blue_tiers=3), 1) == 3
    assert tbatch._blue_tiers(TConfig(blue_tiers=9), 1) == 4


def test_force_full_plan():
    """The redo plan: full window, blue cleared, the caller's chunk kept
    (padding the redone rows up to it), no tail sizes."""
    s, g, l0, m = build_rows(5)
    l0[1] = 2.0
    cfg = TConfig(otf_support=256, otf_blue=(7, 128))
    plan = tbatch.plan_batch(s, g, l0, m, LB35, cfg=cfg, chunk=44,
                             force_full=True)
    assert plan.chunk == 44 and not plan.use_tail
    assert [(gr.cfg.otf_support, gr.cfg.otf_blue, gr.cfg.use_dphi_split,
             gr.rows.tolist(), gr.sizes) for gr in plan.groups] == [
        (0, None, True, [0, 2, 3, 4], (44,)), (0, None, False, [1], (44,))]


def test_tail_size_and_clamped_chunk():
    assert [tbatch._tail_size(44, r) for r in (1, 11, 12, 22, 23, 33, 34)] \
        == [11, 11, 22, 22, 33, 33, 44]
    assert [tbatch._tail_size(100, r) for r in (2, 25, 26, 98)] == \
        [25, 25, 50, 100]
    assert tbatch._tail_size(1, 1) == 1
    for chunk, B in [(25, 2), (25, 100), (50, 50), (8, 1), (0, 3)]:
        assert tbatch.clamped_chunk(chunk, B) == jbatch.clamped_chunk(
            max(chunk, 1), B)


def test_zoom_row_splits():
    """R on the card, at 132 SMs: 1 on every chunk of both bench nights,
    > 1 on single-row calls."""
    def blocks(B, nl, ncols, m2=160):
        return B * nl * -(-ncols // 64) * -(-m2 // 160)
    # bench nights: full window (1280, 768), S=256 (512, 384), blue S=128
    # (256, 256); chunks of 50 and 44 rows and their tails (12 and 22)
    for B in (50, 44, 22, 12):
        for nl, n, ncols in [(35, 1280, 768), (21, 512, 384),
                             (14, 256, 256), (21, 1280, 768)]:
            assert _zoom_row_splits(blocks(B, nl, ncols), n, 132) == 1
    # the CLI block: 1 row, 3 wavelengths, S=256 window -> 18 blocks
    assert blocks(1, 3, 384) == 18
    assert _zoom_row_splits(18, 512, 132) == 8
    # a blue sub-window of compute_psf: 14 wavelengths at S=128
    assert blocks(1, 14, 256) == 56
    assert _zoom_row_splits(56, 256, 132) == 4
    # its red segment: 21 wavelengths at S=256 -> 126 blocks
    assert _zoom_row_splits(126, 512, 132) == 2
    # no R reaches the SMs: the largest valid one; slices stay 32-aligned
    assert _zoom_row_splits(1, 512, 132) == 8
    assert _zoom_row_splits(1, 96, 132) == 1
    assert _zoom_row_splits(1, 128, 132) == 4


@pytest.mark.parametrize("name,n,chunk,npsflin", [
    ("night100", 100, 50, 1),
    ("night1000", 1000, 100, 1),
    ("night100_npsflin3", 100, 44, 3),
])
def test_golden_plan_with_auto_anchor_planned_for_the_cpu(name, n, chunk,
                                                          npsflin):
    """zoom_anchor="auto" planned for the CPU keeps "auto" (run as off):
    the three golden plans do not move."""
    plan = tbatch.plan_batch(*build_rows(n), LB35, npsflin=npsflin,
                             cfg=TConfig(zoom_anchor="auto"), chunk=chunk,
                             device="cpu")
    with open(os.path.join(ROOT, "tests", "data",
                           f"golden_plan_{name}.json")) as fh:
        assert plan.summary() == json.load(fh)


def _patch_jax_anchor_for_the_card(monkeypatch):
    """JAX's "auto" resolution as on the TPU, with its group size patched
    to the port's rule."""
    from muse_psfr_tpu.otf import psf as jpsf
    from muse_psfr_tpu_torch.otf.psf import _anchor_lambda_chunk
    monkeypatch.setattr(jpsf.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(jpsf, "_anchor_lambda_chunk",
                        lambda c, nl, nrows: _anchor_lambda_chunk(c, nl))


def test_auto_anchor_plan_for_the_card(monkeypatch):
    """The 9-direction bench night with zoom_anchor="auto" planned for
    CUDA: every group certifies (bound 1.6e-8 in groups of 7), is
    anchored and gets no blue split; the plan equals the JAX package's
    with the anchor resolved as on its TPU.  The 1-direction night keeps
    its golden plan (too few directions)."""
    rows = build_rows(100)
    cfg = TConfig(zoom_anchor="auto")
    plan = tbatch.plan_batch(*rows, LB35, npsflin=3, cfg=cfg, chunk=44,
                             device="cuda")
    assert [g.cfg.zoom_anchor for g in plan.groups] == ["on"] * 2
    assert all(g.cfg.otf_blue is None for g in plan.groups)
    assert [(g.cfg.otf_support, len(g.rows)) for g in plan.groups] == \
        [(256, 56), (0, 44)]
    _patch_jax_anchor_for_the_card(monkeypatch)
    want = jbatch.plan_batch(*rows, LB35, npsflin=3,
                             cfg=JConfig(zoom_anchor="auto"),
                             chunk=44).summary()
    assert plan.summary() == want
    one = tbatch.plan_batch(*rows, LB35, npsflin=1, cfg=cfg, chunk=50,
                            device="cuda")
    with open(os.path.join(ROOT, "tests", "data",
                           "golden_plan_night100.json")) as fh:
        assert one.summary() == json.load(fh)


def test_auto_anchor_redo_plan_resolves_on_the_full_window():
    s, g, l0, m = build_rows(5)
    plan = tbatch.plan_batch(s, g, l0, m, LB35, npsflin=3,
                             cfg=TConfig(zoom_anchor="auto"), chunk=44,
                             force_full=True, device="cuda")
    assert [(gr.cfg.otf_support, gr.cfg.zoom_anchor) for gr in plan.groups] \
        == [(0, "on")]
    # an uncertified bound keeps "auto": degree 2 on the bench grid
    plan = tbatch.plan_batch(s, g, l0, m, LB35, npsflin=3,
                             cfg=TConfig(zoom_anchor="auto",
                                         zoom_anchor_degree=2), chunk=44,
                             device="cuda")
    assert {gr.cfg.zoom_anchor for gr in plan.groups} == {"auto"}


def test_blue_split_leaves_anchored_groups_alone():
    rows = build_rows(30)
    lb = np.linspace(500.0, 900.0, 8)
    cfg = TConfig(zoom_anchor="on", **BLUE_KW)
    groups = [(cfg, np.arange(30)), (cfg.with_(zoom_anchor="off"),
                                     np.arange(30))]
    out = tbatch._blue_split_plan(groups, *rows, lb, H, 12.0, 3, 8)
    assert out[0] == groups[0]
    assert any(gc.otf_blue is not None for gc, _ in out[1:])


@pytest.fixture
def threads():
    """Set torch's intra-op threads for a test; the count before it comes
    back after."""
    before = torch.get_num_threads()
    yield torch.set_num_threads
    torch.set_num_threads(before)


@pytest.mark.parametrize("nthreads", [1, 8])
@pytest.mark.parametrize("npsflin", [1, 3])
def test_admission_samples_do_not_depend_on_the_other_rows(npsflin,
                                                           nthreads,
                                                           threads):
    """The planner evaluates each row of the split range once and reads
    every probe from that table: a row's ring samples are the same bits
    evaluated with the whole night as with each group of its plan alone,
    whatever the caller's thread count, and rows_windowable on a group
    equals the table indexed."""
    threads(nthreads)
    s, g, l0, m = build_rows(100)
    l0[7] = 2.0                         # outside the split range
    cfg = TConfig()
    h_t = tuple(float(x) for x in H)
    ws = tbatch.effective_wind_speed(H, cfg)
    rest = np.nonzero(l0 >= cfg.dphi_split_l0_min)[0]
    idx, d_night, r = tbatch._ring_damping(s[rest], g[rest], l0[rest],
                                           m[rest], cfg, h_t, ws, npsflin)
    assert np.array_equal(idx, np.arange(99))
    adm = tbatch._Admission(s, g, l0, m, h_t, ws, npsflin)
    plan = tbatch.plan_batch(s, g, l0, m, LB35, npsflin=npsflin, cfg=cfg,
                             chunk=50)
    groups = [gr.rows for gr in plan.groups if gr.cfg.use_dphi_split]
    assert len(groups) >= 2 and sum(map(len, groups)) == 99
    for rows in groups:
        jdx, d_group, r_group = tbatch._ring_damping(
            s[rows], g[rows], l0[rows], m[rows], cfg, h_t, ws, npsflin)
        assert np.array_equal(jdx, np.arange(rows.size))
        assert np.array_equal(r_group, r)
        assert np.array_equal(d_group, d_night[np.searchsorted(rest, rows)])
        for lbda_max, S in [(930.0, 256), (658.2, 128)]:
            want = tbatch.rows_windowable(s[rows], g[rows], l0[rows],
                                          m[rows], lbda_max, cfg, S,
                                          npsflin=npsflin)
            assert np.array_equal(adm.windowable(rows, lbda_max, cfg, S),
                                  want)
    assert torch.get_num_threads() == nthreads


@pytest.mark.parametrize("nthreads", [1, 8])
@pytest.mark.parametrize("name,n,chunk,npsflin", [
    ("night100", 100, 50, 1),
    ("night1000", 1000, 100, 1),
    ("night100_npsflin3", 100, 44, 3),
])
def test_golden_plan_at_the_callers_thread_count(name, n, chunk, npsflin,
                                                 nthreads, threads,
                                                 monkeypatch):
    """Planned afresh (no memo) with torch at 1 or 8 threads, each golden
    plan is the same, and the caller's count is left as it was."""
    monkeypatch.setattr(tbatch, "_PLAN_MEMO", {})
    threads(nthreads)
    plan = tbatch.plan_batch(*build_rows(n), LB35, npsflin=npsflin,
                             cfg=TConfig(), chunk=chunk)
    assert torch.get_num_threads() == nthreads
    with open(os.path.join(ROOT, "tests", "data",
                           f"golden_plan_{name}.json")) as fh:
        assert plan.summary() == json.load(fh)


def test_plan_batch_gives_the_callers_threads_back_when_it_raises(
        threads, monkeypatch):
    threads(3)
    with pytest.raises(ValueError, match="empty batch"):
        tbatch.plan_batch([], [], [], np.zeros((0, 4)), LB35)
    assert torch.get_num_threads() == 3

    def broken(*args, **kw):
        assert torch.get_num_threads() == 1
        raise RuntimeError("split PSD failed")

    monkeypatch.setattr(tbatch, "simulate_psd_split", broken)
    s, g, l0, m = build_rows(5)
    with pytest.raises(RuntimeError, match="split PSD failed"):
        tbatch.plan_batch(s, g, l0 * 1.0001, m, LB35)
    assert torch.get_num_threads() == 3


def test_plan_psd_rows_counts_each_row_of_the_split_range_once():
    """A fresh plan evaluates the admission model once per row of the
    split range, whatever its probes; a memo hit evaluates nothing."""
    from muse_psfr_tpu_torch.utils import profiling
    s, g, l0, m = build_rows(100)
    l0 = l0 * (1 + 1e-9)                # new telemetry: no memo answers
    l0[[7, 40]] = 2.0
    before = profiling.counters()
    plan = tbatch.plan_batch(s, g, l0, m, LB35, cfg=TConfig(), chunk=50)
    grew = {k: v - before[k] for k, v in profiling.counters().items()}
    assert grew["plan_psd_rows"] == 98
    assert grew["plan_memo_misses"] == 1
    assert any(gr.cfg.otf_blue for gr in plan.groups)
    before = profiling.counters()
    assert tbatch.plan_batch(s, g, l0, m, LB35, cfg=TConfig(),
                             chunk=50) is plan
    grew = {k: v - before[k] for k, v in profiling.counters().items()}
    assert grew["plan_psd_rows"] == 0 and grew["plan_memo_hits"] == 1


@pytest.mark.parametrize("budget", [2, 4])
def test_admission_samples_do_not_depend_on_the_planners_threads(
        budget, monkeypatch):
    """The planner's thread budget grows with the evaluation's size; the
    ring samples are the same bits at one thread and at a pool."""
    s, g, l0, m = build_rows(100)
    cfg = TConfig()
    h_t = tuple(float(x) for x in H)
    ws = tbatch.effective_wind_speed(H, cfg)
    got = {}
    for t in (1, budget):
        monkeypatch.setattr(tbatch, "_plan_threads_for", lambda n, t=t: t)
        got[t] = tbatch._ring_damping(s, g, l0, m, cfg, h_t, ws, 3)[1]
    assert np.array_equal(got[1], got[budget])
    monkeypatch.undo()
    assert tbatch._plan_threads_for(128 * 6400) == 1
    assert tbatch._plan_threads_for(128 * 9 * 6400) == min(
        tbatch.PLAN_THREADS, 1 << (torch.get_num_threads().bit_length() - 1))
