"""The PyTorch port's batch night against the JAX package's full-window
night (``process_batch(..., _force_full=True)``) on a 6-row TINY night
with a 3-laser row, an L0 < 2.5 m row (exact-transform group) and a
padded last chunk; plus the production-shape golden row.

Tolerances: float64 mean PSF <= 1e-10 x max, fits <= 1e-8 relative; the
float32 mean PSF within the 1e-5 relative accuracy budget; the golden
row <= 1e-5 rms against the float64 oracle."""

import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
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
        *_night(), LB, (100, 10000), cfg, 50)
    assert chunk == 6 and ws == 12.0 and table.shape == (6, 7)
    assert [g[1].tolist() for g in groups] == [[0, 1, 2, 3, 5], [4]]
    assert all(g[0].otf_support == 0 for g in groups)
    assert not groups[1][0].use_dphi_split
    with pytest.raises(ValueError):
        tbatch._plan_batch([], [], [], np.zeros((0, 4)), LB, (100, 10000),
                           TTINY, 4)
    with pytest.raises(ValueError):
        tbatch._plan_batch([1.0], [0.7], [25.0], np.ones((1, 4)),
                           [300.0], (100, 10000), TTINY, 4)


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
