"""psd/model.py of the PyTorch port against the JAX package: the split PSD
(w, delta) and the exact full-grid PSD, LSE and MAP laws, 4- and 3-laser
rows, in float64 on the same numpy telemetry (<= 1e-10 x max|ref|); and
the reference's general building blocks (``wfs_transfer``,
``glao_reconstructor``, ``residual_psd_one_dir``, ``residual_variance``,
``gs_phasors``) against the JAX functions on an 80 x 80 grid in
float64/complex128 (<= 1e-10 x max|ref|)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu.psd import model as jpsd  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG as TTINY  # noqa: E402
from muse_psfr_tpu_torch.psd import model as tpsd  # noqa: E402

H = (100.0, 10000.0)


def _rows():
    rng = np.random.default_rng(5)
    seeing = rng.uniform(0.6, 1.6, 3)
    GL = rng.uniform(0.3, 0.9, 3)
    L0 = rng.uniform(9.0, 29.0, 3)
    mask = np.ones((3, 4))
    mask[1, 3] = 0.0                                   # 3-laser row
    return seeing, GL, L0, mask


def _t(a):
    return torch.as_tensor(a, dtype=torch.float64)


def _close(got, want, tol=1e-10):
    want = np.asarray(want)
    assert got.shape == want.shape
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


@pytest.mark.parametrize("lse", [True, False])
@pytest.mark.parametrize("npsflin", [1, 3])
def test_split_psd_matches_jax(lse, npsflin):
    jc = JTINY.with_(dtype="float64", lse=lse)
    tc = TTINY.with_(dtype="float64", lse=lse)
    seeing, GL, L0, mask = _rows()
    w, delta = tpsd.simulate_psd_split(_t(seeing), _t(GL), _t(L0),
                                       _t(mask), H, 12.0, npsflin, tc)
    for b in range(3):
        jw, jd = jpsd.simulate_psd_split(seeing[b], GL[b], L0[b],
                                         jnp.asarray(mask[b]), H, 12.0,
                                         npsflin, jc)
        _close(w[b].numpy(), jw)
        _close(delta[b].numpy(), jd)


@pytest.mark.parametrize("lse", [True, False])
def test_exact_psd_matches_jax(lse):
    jc = JTINY.with_(dtype="float64", lse=lse)
    tc = TTINY.with_(dtype="float64", lse=lse)
    seeing, GL, L0, mask = _rows()
    L0[2] = 2.0                              # below the split range
    psd = tpsd.simulate_psd(_t(seeing), _t(GL), _t(L0), _t(mask), H, 12.0,
                            1, tc)
    for b in range(3):
        want = jpsd.simulate_psd(seeing[b], GL[b], L0[b],
                                 jnp.asarray(mask[b]), H, 12.0, 1, jc)
        _close(psd[b].numpy(), want)


def test_static_transfer_is_the_jax_table():
    cfg_t, cfg_j = TTINY.with_(dtype="float64"), JTINY.with_(dtype="float64")
    got = tpsd._glao_static_transfer(H, 12.0, 3, cfg_t)
    want = jpsd._glao_static_transfer(H, 12.0, 3, cfg_j)
    assert set(got) == set(want)
    for k in want:
        assert np.array_equal(got[k], want[k]), k


def test_quirks_wind_speed_and_r0():
    cfg = TTINY
    assert tpsd.effective_wind_speed((100, 10000), cfg) == 12.0
    assert tpsd.effective_wind_speed((100.0, 10000.0), cfg) == 12.5
    s = np.array([0.6, 1.0, 1.6])
    assert np.allclose(tpsd.seeing_to_r0(_t(s), 0.5, 30.0).numpy(),
                       np.asarray(jpsd.seeing_to_r0(jnp.asarray(s), 0.5,
                                                    30.0)),
                       rtol=1e-14, atol=0)


def _grid64(s=80, step=8 / 40):
    from muse_psfr_tpu.core.grids import fft_freq_polar as jgrid
    from muse_psfr_tpu_torch.core.grids import fft_freq_polar as tgrid
    return tgrid(s, step, torch.float64), jgrid(s, step, jnp.float64)


POS = np.array([[1, 1], [-1, -1], [-1, 1], [1, -1]], float).T * 63 / 60


@pytest.mark.parametrize("strict", [True, False])
@pytest.mark.parametrize("pitch", [8 / 24, [8 / 24, 8 / 24, 8 / 32, 8 / 16]])
def test_wfs_transfer(strict, pitch):
    """Both masks ('>' and '>=': the cutoff lands on grid frequencies, so
    they differ) and the un-parenthesised ``&``/``|`` precedence quirk,
    scalar and per-WFS pitches."""
    tg, jg = _grid64()
    got = tpsd.wfs_transfer(*tg, pitch, strict, torch.complex128)
    want = jpsd.wfs_transfer(*jg, jnp.asarray(pitch), strict, jnp.complex128)
    assert got.dtype == torch.complex128
    _close(got.numpy(), want, 1e-13)
    assert np.array_equal(got.numpy() == 0, np.asarray(want) == 0)
    other = tpsd.wfs_transfer(*tg, pitch, not strict, torch.complex128)
    assert (got != other).any()
    # the quirk: a DC-row frequency past the cutoff in f_y only is zeroed
    # even where f == |f_y| != 0 and |f_x| is inside
    assert got.real.abs().max() == 0 and got.imag.abs().max() > 0


@pytest.mark.parametrize("lse", [True, False])
@pytest.mark.parametrize("mask", [[1.0, 1, 1, 1], [1.0, 1, 1, 0]])
def test_glao_reconstructor(lse, mask):
    """LSE and the MAP prior, four and three guide stars, DC zeroed."""
    tg, jg = _grid64()
    sigr = np.array([1.0, 2.0, 0.5, 1.0])
    dsp = 0.0229 * 0.15 ** (-5 / 3) * (np.asarray(jg[0]) ** 2
                                       + 1 / 625) ** (-11 / 6)
    got = tpsd.glao_reconstructor(
        *tg, _t(POS), _t(mask), _t(sigr), 8 / 24, 1.0, torch.complex128,
        dsp_recons=None if lse else _t(dsp))
    want = jpsd.glao_reconstructor(
        *jg, jnp.asarray(POS), jnp.asarray(mask), jnp.asarray(sigr), 8 / 24,
        1.0, jnp.complex128, dsp_recons=None if lse else jnp.asarray(dsp))
    assert got.shape == (4, 80, 80) and got.dtype == torch.complex128
    _close(got.numpy(), want)
    assert (got[:, 0, 0] == 0).all()
    if mask[3] == 0:
        assert (got[3] == 0).all()


@pytest.mark.parametrize("pitch", [8 / 24, [8 / 24, 8 / 24, 8 / 32, 8 / 16]])
@pytest.mark.parametrize("h_dm", [1.0, 0.0])
def test_residual_psd_one_dir_and_variance(pitch, h_dm):
    tg, jg = _grid64()
    f = np.asarray(jg[0])
    layers = 0.0229 * (np.array([0.7, 0.3])[:, None, None] ** (-3 / 5)
                       * 0.15) ** (-5 / 3) * (f ** 2 + 1 / 625) ** (-11 / 6)
    wind = np.stack([12.0 * np.cos([0.6, -0.3]), 12.0 * np.sin([0.6, -0.3])])
    ones, sigv = np.ones(4), np.array([1.0, 2.0, 0.5, 1.0])
    h, ti, beta = np.array([100.0, 1e4]), np.full(4, 1e-3), \
        np.array([0.1, -0.2])
    jW = jpsd.glao_reconstructor(*jg, jnp.asarray(POS), jnp.asarray(ones),
                                 jnp.asarray(sigv), jnp.asarray(pitch), 1.0,
                                 jnp.complex128)
    tW = torch.as_tensor(np.array(jW))
    got = tpsd.residual_psd_one_dir(
        *tg, _t(POS), _t(ones), _t(beta), _t(sigv), _t(layers), _t(h), h_dm,
        tW, 2.5e-3, _t(ti), _t(wind), pitch, torch.complex128)
    want = jpsd.residual_psd_one_dir(
        *jg, jnp.asarray(POS), jnp.asarray(ones), jnp.asarray(beta),
        jnp.asarray(sigv), jnp.asarray(layers), jnp.asarray(h), h_dm, jW,
        2.5e-3, jnp.asarray(ti), jnp.asarray(wind), jnp.asarray(pitch),
        jnp.complex128)
    assert got.dtype == torch.float64 and got.shape == (80, 80)
    _close(got.numpy(), want)
    assert got[0, 0] == 0
    v = tpsd.residual_variance(got, 1.0 / 16, 8.0)
    jv = jpsd.residual_variance(want, 1.0 / 16, 8.0)
    assert abs(float(v) - float(jv)) <= 1e-12 * abs(float(jv))
    # batched over leading dimensions, as the JAX function is
    both = tpsd.residual_variance(torch.stack([got, 2 * got]), 1.0 / 16, 8.0)
    assert both.shape == (2,) and abs(float(both[1]) - 2 * float(v)) \
        <= 1e-12 * float(v)


def test_gs_phasors():
    tg, jg = _grid64(16)
    got = tpsd.gs_phasors(tg[1], tg[2], _t(POS))
    want = jpsd.gs_phasors(jg[1], jg[2], jnp.asarray(POS), jnp.complex128)
    assert got.shape == (4, 16, 16)
    _close(got.numpy(), want, 1e-14)
