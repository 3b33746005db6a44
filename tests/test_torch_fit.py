"""fit/moffat_fit.py of the PyTorch port against the JAX package on the
same planes: the 20-iteration LM with per-plane accept/reject, the packed
layout, unpacking and the float64 host refit.

Tolerances: float64 <= 1e-9 relative on every packed field.  float32
<= 2e-6 relative on the parameters (centre, peak, FWHM, n, flux): the
float32 LM converges to ~1e-6 relative of the optimum (docs/precision.md,
LM row) and two independent float32 solves that sum in different orders
land up to twice that apart; the 1-sigma errors, which scale with the
residual cost, <= 1e-4."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.fit import moffat_fit as jfit  # noqa: E402
from muse_psfr_tpu_torch.fit import moffat_fit as tfit  # noqa: E402

PARAMS = [jfit.PACKED_FIELDS.index(k)
          for k in ("cy", "cx", "peak", "fwhm", "n", "flux")]
ERRORS = [jfit.PACKED_FIELDS.index(k)
          for k in ("err_cy", "err_cx", "err_peak", "err_fwhm", "err_n",
                    "err_flux")]


def _planes(n=40, count=8, noise=1e-4, seed=1):
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[:n, :n]
    out = []
    for _ in range(count):
        cy, cx = rng.uniform(n / 2 - 2, n / 2 + 1, 2)
        a, beta, pk = rng.uniform(1.5, 5), rng.uniform(1.6, 4), \
            rng.uniform(0.5, 2)
        m = pk * (1 + ((yy - cy) ** 2 + (xx - cx) ** 2) / a ** 2) ** (-beta)
        out.append(m + rng.normal(0, noise, m.shape))
    return np.stack(out)


def _rel(a, b):
    return np.abs(a - b) / np.abs(b)


def test_packed_fit_float64():
    cube = _planes().reshape(2, 4, 40, 40)
    got = tfit.fit_moffat_cube_packed(torch.as_tensor(cube),
                                      dtype="float64").numpy()
    want = np.asarray(jfit.fit_moffat_cube_packed(jnp.asarray(cube),
                                                  dtype="float64"))
    assert got.shape == want.shape == (2, 4, tfit.N_PACKED)
    assert tfit.PACKED_FIELDS == jfit.PACKED_FIELDS
    assert tfit.LM_ITERS == jfit.LM_ITERS == 20
    assert np.all(got[..., -1] == 1.0)
    assert _rel(got, want)[..., :-1].max() <= 1e-9


def test_packed_fit_float32():
    cube = _planes()
    got = tfit.fit_moffat_cube_packed(
        torch.as_tensor(cube, dtype=torch.float32)).numpy()
    want = np.asarray(jfit.fit_moffat_cube_packed(
        jnp.asarray(cube, jnp.float32)))
    assert _rel(got[:, PARAMS], want[:, PARAMS]).max() <= 2e-6
    assert _rel(got[:, ERRORS], want[:, ERRORS]).max() <= 1e-4
    assert np.array_equal(got[:, -1], want[:, -1])


def test_degenerate_plane_is_flagged_like_jax():
    cube = np.concatenate([_planes(count=1), np.zeros((1, 40, 40))])
    got = tfit.fit_moffat_cube_packed(torch.as_tensor(cube),
                                      dtype="float64").numpy()
    want = np.asarray(jfit.fit_moffat_cube_packed(jnp.asarray(cube),
                                                  dtype="float64"))
    assert got[1, -1] == want[1, -1] == 0.0
    assert got[0, -1] == want[0, -1] == 1.0


def test_unpack_and_host64_refit():
    cube = _planes(count=3)
    got = tfit.fit_moffat_cube_host64(torch.as_tensor(cube,
                                                      dtype=torch.float32))
    want = jfit.fit_moffat_cube_host64(np.asarray(cube, np.float32))
    assert set(got) == set(want)
    for k in want:
        assert got[k].shape == np.asarray(want[k]).shape, k
        if k == "ok":
            assert np.array_equal(got[k], want[k])
        else:
            assert _rel(got[k], np.asarray(want[k])).max() <= 1e-9, k
    with pytest.raises(ValueError):
        tfit.unpack_fit(np.zeros((2, 5)))
