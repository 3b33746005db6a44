"""core/ of the PyTorch port against the JAX package on the same numpy
inputs: grids, von Karman spectra, Moffat kernels, the MUSE intrinsic
PSF and the coeffL0 tip-tilt table (float64, <= 1e-12 relative)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
from numpy.testing import assert_allclose  # noqa: E402

from muse_psfr_tpu.core import coeff_l0 as jl0  # noqa: E402
from muse_psfr_tpu.core import grids as jgrids  # noqa: E402
from muse_psfr_tpu.core import moffat as jmof  # noqa: E402
from muse_psfr_tpu.core import vonkarman as jvk  # noqa: E402
from muse_psfr_tpu_torch.core import coeff_l0 as tl0  # noqa: E402
from muse_psfr_tpu_torch.core import grids as tgrids  # noqa: E402
from muse_psfr_tpu_torch.core import moffat as tmof  # noqa: E402
from muse_psfr_tpu_torch.core import vonkarman as tvk  # noqa: E402

T64 = dict(dtype=torch.float64)


def test_grids_equal():
    assert_allclose(tgrids.centered_freq_radius(256, 16.0),
                    jgrids.centered_freq_radius(256, 16.0), rtol=0, atol=0)
    for n in (1, 3):
        assert_allclose(tgrids.direction_grid(n), jgrids.direction_grid(n),
                        rtol=0, atol=0)
    assert_allclose(tgrids.lgs_positions(63.0), jgrids.lgs_positions(63.0))


def test_vonkarman_and_fitting_psd():
    f = np.linspace(0.0, 4.0, 101)
    r0, L0 = 0.12, 23.0
    got = tvk.vk_psd(torch.as_tensor(f, **T64), r0, L0).numpy()
    want = np.asarray(jvk.vk_psd(jnp.asarray(f), r0, L0))
    assert_allclose(got[1:], want[1:], rtol=1e-12)
    got = tvk.fitting_psd(torch.as_tensor(f, **T64), r0, L0, 1.5).numpy()
    want = np.asarray(jvk.fitting_psd(f, r0, L0, 1.5))
    assert_allclose(got, want, rtol=1e-12, atol=0)
    assert tvk.CST_VK_EXACT == jvk.CST_VK_EXACT
    for deg in (3, 5):
        u0, b = tvk.fitting_expansion_spec(2.5, deg)
        ju0, jb = jvk.fitting_expansion_spec(2.5, deg)
        assert u0 == ju0 and np.array_equal(b, jb)
        assert (tvk.fitting_expansion_max_rel_error(2.5, deg, 1.5)
                == jvk.fitting_expansion_max_rel_error(2.5, deg, 1.5))


@pytest.mark.parametrize("size", [9, 41])
def test_moffat_kernels_batched(size):
    alphas = np.array([1.3, 2.7, 5.0])
    betas = np.array([2.0, 2.5, 3.1])
    got = tmof.moffat_kernel(torch.as_tensor(alphas, **T64),
                             torch.as_tensor(betas, **T64), size).numpy()
    for k in range(3):
        want = np.asarray(jmof.moffat_kernel(alphas[k], betas[k], size,
                                             jnp.float64))
        assert_allclose(got[k], want, rtol=1e-13)
    # scalar beta (the tip-tilt kernel, beta = 2)
    got = tmof.moffat_kernel(torch.as_tensor(alphas, **T64), 2.0, size)
    want = np.asarray(jmof.moffat_kernel(alphas[1], 2.0, size, jnp.float64))
    assert_allclose(got[1].numpy(), want, rtol=1e-13)


def test_intrinsic_psf_and_fwhm_to_alpha():
    lb = np.linspace(465.0, 930.0, 17)
    got = tmof.muse_intrinsic_psf(torch.as_tensor(lb, **T64))
    want = jmof.muse_intrinsic_psf(jnp.asarray(lb))
    for g, w in zip(got, want):
        assert_allclose(g.numpy(), np.asarray(w), rtol=1e-13)
    fwhm = torch.as_tensor([3.0, 4.5], **T64)
    beta = torch.as_tensor([2.2, 2.9], **T64)
    assert_allclose(tmof.moffat_fwhm_to_alpha(fwhm, beta).numpy(),
                    np.asarray(jmof.moffat_fwhm_to_alpha(
                        jnp.asarray([3.0, 4.5]), jnp.asarray([2.2, 2.9]))),
                    rtol=1e-14)


def test_coeff_l0_table_and_interp():
    assert np.array_equal(tl0.COEFF_L0_GRID, jl0.COEFF_L0_GRID)
    assert np.array_equal(tl0.COEFF_L0_VALUES, jl0.COEFF_L0_VALUES)
    L0 = np.array([0.3, 1.0, 1.5, 9.1, 25.0, 25.37, 199.9, 200.0, 260.0])
    got = tl0.tt_attenuation(torch.as_tensor(L0, **T64)).numpy()
    want = np.asarray(jl0.tt_attenuation(jnp.asarray(L0)))
    assert_allclose(got, want, rtol=1e-15, atol=0)


@pytest.mark.parametrize("n,step", [(80, 8 / 40), (33, 0.25), (16, 1.0)])
def test_fft_freq_polar(n, step):
    """The reference's arctan(fy/fx) polar decomposition with
    arg_f[0, 0] = 0, bit for bit in float64 and as float32 tensors."""
    got = tgrids.fft_freq_polar(n, step, torch.float64)
    want = jgrids.fft_freq_polar(n, step, jnp.float64)
    for g, w in zip(got, want):
        assert g.dtype == torch.float64 and g.shape == (n, n)
        assert np.array_equal(g.numpy(), np.asarray(w))
    f, f_x, f_y = (g.numpy() for g in got)
    assert f[0, 0] == f_x[0, 0] == f_y[0, 0] == 0.0
    assert np.all(f_x >= 0)                      # f_x = |fx|: the quirk
    assert_allclose(np.hypot(f_x, f_y), f, atol=1e-12)
    got32 = tgrids.fft_freq_polar(n, step)
    want32 = jgrids.fft_freq_polar(n, step)
    for g, w in zip(got32, want32):
        assert g.dtype == torch.float32
        assert_allclose(g.numpy(), np.asarray(w), rtol=1e-6, atol=1e-7)


@pytest.mark.parametrize("radius,width,oc,inverse", [
    (160.0, 320, 0.14, False), (5, 20, 0.2, False), (4.5, 17, 0.0, True),
    (0.5, 8, 0.0, True), (3, 7, 0.5, False)])
def test_pupil_mask(radius, width, oc, inverse):
    got = tgrids.pupil_mask(radius, width, oc, inverse, torch.float64)
    want = jgrids.pupil_mask(radius, width, oc, inverse, jnp.float64)
    assert got.dtype == torch.float64 and got.shape == (width, width)
    assert np.array_equal(got.numpy(), np.asarray(want))
    assert set(np.unique(got.numpy())) <= {0.0, 1.0}
    assert tgrids.pupil_mask(radius, width, oc, inverse).dtype == \
        torch.float32
