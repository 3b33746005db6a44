"""The PyTorch port's batch night against the JAX package's: the
full-window night (``process_batch(..., _force_full=True)``) on a 6-row
TINY night with a 3-laser row, an L0 < 2.5 m row (exact-transform group)
and a padded last chunk; the auto-planned night (reduced window, blue
sub-window, full window, exact transform, tail chunk) at a small config
for npsflin 1 and 3; the window-guard redo and its callbacks; plus the
production-shape golden row.

Tolerances: float64 mean PSF <= 1e-10 x max, fits <= 1e-8 relative; the
float32 mean PSF within the 1e-5 relative accuracy budget; a redone row
within 2e-6 abs of the full-window run (the JAX tests' bound); the
golden row <= 1e-5 rms against the float64 oracle."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu.config import GalacsiConfig as JConfig  # noqa: E402
from muse_psfr_tpu.parallel import batch as jbatch  # noqa: E402
from muse_psfr_tpu import api as japi  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG as TTINY  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch as tbatch  # noqa: E402
from muse_psfr_tpu_torch import api as tapi  # noqa: E402

GOLDEN = os.path.join(os.path.dirname(__file__), "data",
                      "golden_psf_35l_s1.0_gl0.7_l025.npy")
LB = np.array([750.0, 800.0, 850.0, 900.0])


def _night():
    rng = np.random.default_rng(0)
    seeing = rng.uniform(0.6, 1.6, 6)
    GL = rng.uniform(0.3, 0.9, 6)
    L0 = rng.uniform(9.0, 29.0, 6)
    mask = np.ones((6, 4))
    mask[2, 3] = 0.0            # 3-laser row
    L0[4] = 2.0                 # exact-transform row (L0 < 2.5 m)
    return seeing, GL, L0, mask


def _rel(a, b):
    return np.abs(a - b) / np.maximum(np.abs(b), 1e-300)


@pytest.mark.parametrize("use_fft", [False, True])
def test_night_float64_matches_jax_full_window(use_fft):
    kw = dict(dtype="float64", fit_dtype="float64", use_fft=use_fft)
    night = _night()
    want = jbatch.process_batch(*night, LB, cfg=JTINY.with_(**kw), chunk=4,
                                _force_full=True)
    got = tbatch.process_batch(*night, LB, cfg=TTINY.with_(**kw), chunk=4,
                               device="cpu")
    fit, psf_mean, fit_mean = got
    assert fit.shape == (6, LB.size, 13) and psf_mean.shape == (4, 8, 8)
    assert (np.abs(psf_mean - want[1]).max()
            <= 1e-10 * np.abs(want[1]).max())
    assert _rel(fit, want[0])[..., :-1].max() <= 1e-8
    assert _rel(fit_mean, want[2])[..., :-1].max() <= 1e-8
    assert np.array_equal(fit[..., -1], want[0][..., -1])

    cubes = tbatch.reconstruct_batch(*night, LB, cfg=TTINY.with_(**kw),
                                     chunk=4, device="cpu")
    jcubes = jbatch.reconstruct_batch(*night, LB, cfg=JTINY.with_(**kw),
                                      chunk=4, _force_full=True)
    assert np.abs(cubes - jcubes).max() <= 1e-10 * np.abs(jcubes).max()


def test_night_float32_within_budget():
    night = _night()
    want = jbatch.process_batch(*night, LB, cfg=JTINY.with_(use_fft=False),
                                chunk=4, _force_full=True)
    fit, psf_mean, _ = tbatch.process_batch(
        *night, LB, cfg=TTINY.with_(use_fft=False), chunk=4, device="cpu")
    assert psf_mean.dtype == np.float32
    assert np.abs(psf_mean - want[1]).max() <= 1e-5 * np.abs(want[1]).max()
    assert np.all(fit[..., -1] == 1.0)


def test_planner_groups_and_validation():
    cfg = TTINY.with_(otf_support=128)
    _, groups, chunk, table, _, _, ws, npixc = tbatch._plan_batch(
        *_night(), LB, (100, 10000), 1, cfg, 50)
    assert chunk == 6 and ws == 12.0 and table.shape == (6, 7)
    assert [g[1].tolist() for g in groups] == [[4], [0, 1, 2, 3, 5]]
    assert all(g[0].otf_support == 128 for g in groups)   # pinned: kept
    assert not groups[0][0].use_dphi_split
    with pytest.raises(ValueError):
        tbatch._plan_batch([], [], [], np.zeros((0, 4)), LB, (100, 10000),
                           1, TTINY, 4)
    with pytest.raises(ValueError):
        tbatch._plan_batch([1.0], [0.7], [25.0], np.ones((1, 4)),
                           [300.0], (100, 10000), 1, TTINY, 4)


def test_window_guard_matches_jax():
    """+inf on the full window; on a reduced window the same margin as the
    JAX guard, for a row that fits the window (margin > 0) and one that
    trips it (the sharp small-L0 row, margin < 0)."""
    import jax.numpy as jnp
    from muse_psfr_tpu_torch.otf.psf import dphi_base_split
    from muse_psfr_tpu_torch.psd.model import simulate_psd_split
    kw = dict(dtype="float64", dim=512, dim_pup=16)
    t = lambda a: torch.as_tensor(np.asarray(a, np.float64))  # noqa: E731
    s, g, l0 = t([1.0, 0.6]), t([0.7, 0.3]), t([25.0, 9.1])
    for support in (0, 128):
        tc = TTINY.with_(otf_support=support, **kw)
        jc = JTINY.with_(otf_support=support, **kw)
        w, delta = simulate_psd_split(s, g, l0, t(np.ones((2, 4))),
                                      (100.0, 10000.0), 12.0, 1, tc)
        base = dphi_base_split(w, delta, tc)
        got = tbatch._window_guard(base, t(LB), tc).numpy()
        for b in range(2):
            want = float(jbatch._window_guard(
                jnp.asarray(base[b].numpy()), jnp.asarray(LB), jc))
            if np.isinf(want):
                assert got[b] == want
            else:
                assert abs(got[b] - want) <= 1e-9 * abs(want)
        if support:
            assert got[0] > 0 > got[1]


def test_compute_psf_matches_jax():
    kw = dict(dtype="float64", fit_dtype="float64")
    lb = np.array([800.0, 900.0])
    got, psf = tapi.compute_psf(lb, 1.0, 0.7, 25.0, three_lgs_mode=True,
                                cfg=TTINY.with_(**kw), device="cpu")
    want, jpsf = japi.compute_psf(lb, 1.0, 0.7, 25.0, three_lgs_mode=True,
                                  cfg=JTINY.with_(**kw))
    assert got.colnames == want.colnames
    assert np.abs(psf - jpsf).max() <= 1e-10 * np.abs(jpsf).max()
    for k in ("fwhm", "n", "flux", "err_fwhm"):
        assert _rel(got[k], want[k]).max() <= 1e-8, k


def test_production_golden_row():
    """The pinned condition at 35 wavelengths on the default config,
    against the committed float64 oracle cube."""
    cube = tbatch.reconstruct_batch([1.0], [0.7], [25.0], np.ones((1, 4)),
                                    np.linspace(490, 930, 35),
                                    cfg=GalacsiConfig(), chunk=1,
                                    device="cpu")[0]
    rms = float(np.sqrt(np.mean((cube.astype(np.float64)
                                 - np.load(GOLDEN)) ** 2)))
    assert rms <= 1e-5, rms


SMALL = GalacsiConfig(dim=512, dim_pup=16, dimpsf=12, lambda_chunk=2)
LB4 = np.linspace(500.0, 900.0, 4)


def _mixed_night():
    """Six rows that fill every kind of group at SMALL: reduced window,
    full window with a blue sub-window, plain full window, and the exact
    transform (L0 < 2.5 m); row 3 in 3-laser mode."""
    see = np.array([0.9, 1.4, 0.5, 1.0, 1.3, 0.6])
    gl = np.array([0.85, 0.8, 0.85, 0.7, 0.5, 0.3])
    l0 = np.array([25.0, 25.0, 25.0, 18.0, 2.0, 12.0])
    mask = np.ones((6, 4))
    mask[3, 3] = 0.0
    return see, gl, l0, mask


@pytest.mark.parametrize("npsflin", [1, 3])
def test_auto_planned_night_matches_jax(npsflin):
    kw = dict(dtype="float64", fit_dtype="float64")
    tc = SMALL.with_(**kw)
    jc = JConfig(dim=512, dim_pup=16, dimpsf=12, lambda_chunk=2, **kw)
    night = _mixed_night()
    plan = tbatch.plan_batch(*night, LB4, npsflin=npsflin, cfg=tc, chunk=2)
    assert plan.summary() == jbatch.plan_batch(
        *night, LB4, npsflin=npsflin, cfg=jc, chunk=2).summary()
    kinds = {(g.cfg.otf_support, g.cfg.otf_blue is not None,
              g.cfg.use_dphi_split) for g in plan.groups}
    assert kinds == {(128, False, True), (0, True, True), (0, False, True),
                     (0, False, False)}
    want = jbatch.process_batch(*night, LB4, npsflin=npsflin, cfg=jc,
                                chunk=2)
    fit, psf_mean, fit_mean = tbatch.process_batch(
        *night, LB4, npsflin=npsflin, cfg=tc, chunk=2, device="cpu")
    assert (np.abs(psf_mean - want[1]).max()
            <= 1e-10 * np.abs(want[1]).max())
    assert _rel(fit, want[0])[..., :-1].max() <= 1e-8
    assert _rel(fit_mean, want[2])[..., :-1].max() <= 1e-8
    assert np.array_equal(fit[..., -1], want[0][..., -1])


def test_auto_planned_night_float32_within_budget():
    """The default float32 night through the planner against the
    port's own full-window night: the windows drop only what the
    admission model certified negligible."""
    night = _mixed_night()
    _, auto, _ = tbatch.process_batch(*night, LB4, cfg=SMALL, chunk=2,
                                      device="cpu")
    _, full, _ = tbatch.process_batch(*night, LB4, cfg=SMALL, chunk=2,
                                      device="cpu", _force_full=True)
    assert np.abs(auto - full).max() <= 1e-5 * np.abs(full).max()
    cubes = tbatch.reconstruct_batch(*night, LB4, cfg=SMALL, chunk=2,
                                     device="cpu")
    assert np.abs(cubes.mean(axis=0) - auto).max() <= \
        1e-6 * np.abs(auto).max()


GUARD_CFG = GalacsiConfig(dim=512, dim_pup=24, dimpsf=12)
#: row 2 is ultra-weak damping: its OTF outgrows a 128-px window at 930 nm
TRIP = (np.array([1.0, 1.3, 0.2, 1.1]), np.array([0.7, 0.5, 0.01, 0.6]),
        np.array([25.0, 18.0, 30.0, 22.0]), np.ones((4, 4)))


def test_guard_redo_on_too_small_window(caplog):
    """A pinned too-small window trips the guard and the row is
    recomputed with the full window (tests/test_otf_support.py), for a
    pinned otf_support and a pinned blue sub-window (its segment at
    930 nm, where this row's sub-window boundary margin is negative)."""
    tel = ([0.2], [0.01], [30.0], np.ones((1, 4)))
    for cfg, pin, lb in [(GUARD_CFG, {"otf_support": 128}, [930.0]),
                         (SMALL, {"otf_blue": (1, 128)}, [930.0, 935.0])]:
        full = tbatch.reconstruct_batch(*tel, lb,
                                        cfg=cfg.with_(otf_support=256),
                                        chunk=1, device="cpu")
        with caplog.at_level("WARNING", logger="muse_psfr.batch"):
            caplog.clear()
            got = tbatch.reconstruct_batch(*tel, lb, cfg=cfg.with_(**pin),
                                           chunk=1, device="cpu")
        assert "guard tripped" in caplog.text, pin
        assert np.abs(got - full).max() <= 2e-6, pin
    want = jbatch.reconstruct_batch(
        *tel, lb, cfg=JConfig(dim=512, dim_pup=16, dimpsf=12,
                              lambda_chunk=2, otf_blue=(1, 128)), chunk=1)
    assert np.abs(got - want).max() <= 2e-6


def test_guard_redo_is_surgical_and_ordered():
    """One tripping row re-runs only its own chunk; on_chunk delivers it
    twice (the second time corrected), on_redo_start names exactly it
    before the corrected delivery, on_final delivers every row once and
    the tripped row last; values match the full-window run and the JAX
    package's redo (tests/test_otf_support.py:217-258, 353-377,
    504-552)."""
    events, values = [], {}

    def on_chunk(idx, packed):
        events.append(("chunk", [int(i) for i in idx]))
        for j, row in zip(idx, packed):
            values[int(j)] = np.array(row)

    fit, psf_mean, fit_mean = tbatch.process_batch(
        *TRIP, [930.0], cfg=GUARD_CFG.with_(otf_support=128), chunk=1,
        device="cpu", on_chunk=on_chunk,
        on_redo_start=lambda idx: events.append(
            ("redo", [int(i) for i in idx])),
        on_final=lambda idx: events.append(
            ("final", sorted(int(i) for i in idx))))
    counts = {}
    for kind, idx in events:
        for j in idx if kind == "chunk" else ():
            counts[j] = counts.get(j, 0) + 1
    assert counts == {0: 1, 1: 1, 2: 2, 3: 1}
    assert np.array_equal(values[2], fit[2])
    redo = [i for i, e in enumerate(events) if e[0] == "redo"]
    assert len(redo) == 1 and events[redo[0]][1] == [2]
    assert [e for e in events[redo[0] + 1:] if e[0] == "chunk"] == \
        [("chunk", [2])]
    finals = [rows for kind, rows in events if kind == "final"]
    assert sorted(r for rows in finals for r in rows) == [0, 1, 2, 3]
    assert events[-1] == ("final", [2]) and events[-2] == ("chunk", [2])

    ref = tbatch.process_batch(*TRIP, [930.0],
                               cfg=GUARD_CFG.with_(otf_support=256),
                               chunk=1, device="cpu")
    assert np.abs(fit - ref[0]).max() <= 1e-4
    assert np.abs(psf_mean - ref[1]).max() <= 2e-6
    assert np.abs(fit_mean - ref[2]).max() <= 1e-4
    jfit, jmean, _ = jbatch.process_batch(
        *TRIP, [930.0],
        cfg=JConfig(dim=512, dim_pup=24, dimpsf=12, otf_support=128),
        chunk=1)
    assert np.abs(psf_mean - jmean).max() <= 2e-6
    assert np.abs(fit - jfit).max() <= 1e-4


def test_on_final_eager_for_guard_free_chunks():
    """Full-window chunks are final at delivery; windowed chunks only
    after the guards are read (tests/test_otf_support.py:474-502)."""
    events = []
    see = np.array([1.0, 0.2, 1.3, 0.25])
    gl = np.array([0.7, 0.01, 0.5, 0.02])
    l0 = np.array([25.0, 30.0, 18.0, 29.0])
    tbatch.process_batch(
        see, gl, l0, np.ones((4, 4)), [930.0], cfg=GUARD_CFG, chunk=2,
        device="cpu",
        on_chunk=lambda idx, _: events.append(
            ("chunk", sorted(int(i) for i in idx))),
        on_final=lambda idx: events.append(
            ("final", sorted(int(i) for i in idx))))
    i = events.index(("chunk", [1, 3]))
    assert events[i + 1] == ("final", [1, 3])
    assert events[-1] == ("final", [0, 2])
    assert sorted(r for k, rows in events if k == "final"
                  for r in rows) == [0, 1, 2, 3]
