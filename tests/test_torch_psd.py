"""psd/model.py of the PyTorch port against the JAX package: the split PSD
(w, delta) and the exact full-grid PSD, LSE and MAP laws, 4- and 3-laser
rows, in float64 on the same numpy telemetry (<= 1e-10 x max|ref|)."""

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
