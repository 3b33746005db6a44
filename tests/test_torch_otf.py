"""otf/psf.py of the PyTorch port against the JAX package: host tables, the
structure function (split and exact, FFT and DFT-matmul, with and without
the symmetry fold), the npixc .5 rounding quirk, and the fused chunk step
against the JAX XLA ``one_lambda`` path (float64, <= 1e-10 x max|ref|);
the standalone ``psd_to_psf`` and the one-row ``psf_cube`` against the JAX
functions."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu.config import GalacsiConfig as JConfig  # noqa: E402
from muse_psfr_tpu.otf import psf as jpsf  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG as TTINY  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig as TConfig  # noqa: E402
from muse_psfr_tpu_torch.otf import psf as tpsf  # noqa: E402
from muse_psfr_tpu_torch.psd import model as tpsd  # noqa: E402

H = (100.0, 10000.0)
LB = np.array([750.0, 800.0, 850.0, 900.0])
SEEING, GL, L0 = np.array([1.0, 0.7]), np.array([0.7, 0.4]), \
    np.array([25.0, 12.0])
MASK = np.array([[1.0, 1, 1, 1], [1, 1, 1, 0]])


def _t(a):
    return torch.as_tensor(np.asarray(a), dtype=torch.float64)


def _close(got, want, tol=1e-10):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    assert np.abs(got - want).max() <= tol * np.abs(want).max()


def _cfgs(**kw):
    return (TTINY.with_(dtype="float64", **kw),
            JTINY.with_(dtype="float64", **kw))


def _split_inputs(tc, npsflin=1):
    return tpsd.simulate_psd_split(_t(SEEING), _t(GL), _t(L0), _t(MASK), H,
                                   12.0, npsflin, tc)


def test_host_tables_equal():
    tc, jc = _cfgs()
    assert np.array_equal(tpsf.pupil_otf(tc),
                          np.asarray(jpsf.pupil_otf(jc)))
    assert np.array_equal(tpsf.fitting_dphi_basis(tc),
                          jpsf._fitting_dphi_basis_np(jc))
    for S in (64, 128):
        assert np.array_equal(tpsf._fold_weights(256, S, 256),
                              np.asarray(jpsf._fold_weights(256, S, 256,
                                                            jnp.float64)))


def test_ring_envelopes_equal():
    tc, jc = _cfgs(dim=512)
    tmin, tmax = tpsf.fitting_dphi_ring_envelopes(tc)
    jmin, jmax = jpsf.fitting_dphi_ring_envelopes(jc)
    assert tmin.shape == (tc.dphi_split_degree + 1, 257)
    assert np.array_equal(tmin, jmin) and np.array_equal(tmax, jmax)
    assert np.all(tmin <= tmax)


@pytest.mark.parametrize("kw", [{}, {"use_sym_fold": False},
                                {"otf_support": 128, "dim": 512,
                                 "dim_pup": 16}])
def test_dphi_base_split(kw):
    tc, jc = _cfgs(**kw)
    w, delta = _split_inputs(tc, npsflin=3 if not kw else 1)
    got = tpsf.dphi_base_split(w, delta, tc).numpy()
    for b in range(2):
        want = jpsf.dphi_base_split(jnp.asarray(w[b].numpy()),
                                    jnp.asarray(delta[b].numpy()), jc)
        _close(got[b], want)


@pytest.mark.parametrize("use_fft", [True, False])
@pytest.mark.parametrize("fold", [True, False])
def test_dphi_base_exact(use_fft, fold):
    tc, jc = _cfgs(use_fft=use_fft, use_sym_fold=fold)
    psd = tpsd.simulate_psd(_t(SEEING), _t(GL), _t(L0), _t(MASK), H, 12.0,
                            1, tc)
    got = tpsf.dphi_base(psd, tc).numpy()
    for b in range(2):
        _close(got[b], jpsf.dphi_base(jnp.asarray(psd[b].numpy()), jc))


def test_npixc_half_boundary_quirk():
    """Plane 19 of linspace(500, 900, 37) has raw/2 == 436.5 exactly in
    float64: banker's rounding gives 872 (a float32 quotient gives 874)."""
    lb = np.linspace(500, 900, 37)
    got = tpsf.lambda_crop_size(lb, TConfig())
    assert got[19] == 872
    assert np.array_equal(got, np.asarray(jpsf.lambda_crop_size(
        lb, JConfig())))


@pytest.mark.parametrize("kw", [{}, {"use_sym_fold": False},
                                {"zoom_exp2": False}])
def test_fused_chunk_matches_jax_one_lambda(kw):
    """The port's fused step (K1's plain version on the CPU) against the
    JAX package's XLA per-wavelength body on the same structure function."""
    tc, jc = _cfgs(**kw)
    w, delta = _split_inputs(tc)
    base = tpsf.dphi_base_split(w, delta, tc)
    npix = tpsf.lambda_crop_size(LB, tc)
    got = tpsf._psf_chunk_fused(base, _t(LB), torch.as_tensor(npix),
                                tc).numpy()
    plain = tpsf._psf_chunk_plain(base, _t(LB), torch.as_tensor(npix),
                                  tc).numpy()
    for b in range(2):
        want = jpsf.psf_cube_from_base(jnp.asarray(base[b].numpy()), LB, jc)
        _close(got[b], want)
        _close(plain[b], want)


def test_fft_regrid_path_matches_jax():
    """use_zoom_dft=False: full inverse FFT + bilinear regrid."""
    tc, jc = _cfgs(use_zoom_dft=False)
    psd = tpsd.simulate_psd(_t(SEEING), _t(GL), _t(L0), _t(MASK), H, 12.0,
                            1, tc)
    base = tpsf.dphi_base(psd, tc)
    got = tpsf.psf_cube_from_base(base, LB, tc).numpy()
    for b in range(2):
        want = jpsf.psf_cube_from_base(jnp.asarray(base[b].numpy()), LB, jc)
        _close(got[b], want)


def test_float32_fused_chunk_close_to_float64():
    tc, _ = _cfgs()
    w, delta = _split_inputs(tc)
    base = tpsf.dphi_base_split(w, delta, tc)
    ref = tpsf.psf_cube_from_base(base, LB, tc).numpy()
    c32 = tc.with_(dtype="float32")
    got = tpsf.psf_cube_from_base(base.float(), LB, c32).numpy()
    assert np.abs(got - ref).max() <= 1e-5 * np.abs(ref).max()


BLUE = dict(dim=512, dim_pup=16, dimpsf=12, lambda_chunk=2)


@pytest.mark.parametrize("fused", [True, False])
def test_blue_split_matches_jax(fused):
    """otf_blue: the bluest nb wavelengths on the centred S_blue
    sub-window (a strided view of the structure function).  Port ==
    JAX to 1e-5 relative in float32; the red segment is bit-identical to
    the unsplit cube and the blue planes differ from it only by the
    certified truncation (tests/test_otf_support.py)."""
    tc = TConfig(use_fused_zoom=fused, **BLUE)
    jc = JConfig(**BLUE)
    lb = np.linspace(600.0, 900.0, 6)
    w, delta = tpsd.simulate_psd_split(
        *(torch.as_tensor(a, dtype=torch.float32)
          for a in (SEEING, GL, L0, MASK)), H, 12.0, 3, tc)
    base = tpsf.dphi_base_split(w, delta, tc)            # (2, 9, 512, 384)
    ref = tpsf.psf_cube_from_base(base, lb, tc).numpy()
    for nb in (1, 3):
        got = tpsf.psf_cube_from_base(base, lb,
                                      tc.with_(otf_blue=(nb, 128))).numpy()
        assert np.array_equal(got[:, nb:], ref[:, nb:])
        assert np.abs(got[:, :nb] - ref[:, :nb]).max() < 5e-7
        for b in range(2):
            want = np.asarray(jpsf.psf_cube_from_base(
                jnp.asarray(base[b].numpy()), lb,
                jc.with_(otf_blue=(nb, 128))))
            assert np.abs(got[b] - want).max() <= 1e-5 * np.abs(want).max()


def test_unported_and_invalid_options_raise():
    tc, _ = _cfgs()
    base = torch.zeros((1, 1, 256, 256), dtype=torch.float64)
    with pytest.raises(ValueError, match="multiple of 128"):
        # TINY's window is S=128: no smaller sub-window exists
        tpsf.psf_cube_from_base(base, LB, tc.with_(otf_blue=(2, 128)))
    big = TConfig(**BLUE)
    base_b = torch.zeros((1, 1, 512, 384))
    for bad, msg in [((0, 128), "segment length"),
                     ((4, 128), "segment length"),
                     ((2, 64), "multiple of 128")]:
        with pytest.raises(ValueError, match=msg):
            tpsf.psf_cube_from_base(base_b, LB, big.with_(otf_blue=bad))
    with pytest.raises(ValueError, match="fold/window"):
        tpsf._blue_split_cfgs(big.with_(use_sym_fold=False,
                                        otf_blue=(2, 128)), 4)
    with pytest.raises(ValueError):
        tpsf.psf_cube_from_base(base[..., :128], LB, tc)
    with pytest.raises(ValueError):
        tpsf.psf_cube_from_base(base, LB, tc.with_(use_fft=False,
                                                   use_zoom_dft=False))


def _vk_psd(dim=256, npup=64, D=8.0):
    L = D * dim / npup
    c = (dim - 1) / 2.0
    fx = (np.arange(dim) - c)[:, None] / L
    psd = 0.0229 * 0.15 ** (-5 / 3) * (np.hypot(fx, fx.T) ** 2
                                       + 1 / 625) ** (-11 / 6)
    from muse_psfr_tpu_torch.core.grids import pupil_mask
    return (psd * (500.0 / (2 * np.pi)) ** 2,
            pupil_mask(npup / 2, npup, 0.14, dtype=torch.float64).numpy())


@pytest.mark.parametrize("samp", [None, 2, 1.5, 1.0])
@pytest.mark.parametrize("dtype,tol", [("float64", 1e-10),
                                       ("float32", 2e-5)])
def test_psd_to_psf_matches_jax(samp, dtype, tol):
    """The standalone forward model: Nyquist and the sub-Nyquist crop,
    ``return_all``, in float64 (<= 1e-10 x max) and float32 (two FFT
    libraries in single precision: <= 2e-5 x max)."""
    psd, pup = _vk_psd()
    got = tpsf.psd_to_psf(psd, pup, 8.0, 600e-9, samp=samp, return_all=True,
                          dtype=getattr(torch, dtype), device="cpu")
    want = jpsf.psd_to_psf(psd, pup, 8.0, 600e-9, samp=samp,
                           return_all=True, dtype=getattr(jnp, dtype))
    assert torch.is_tensor(got[0]) and got[0].dtype == getattr(torch, dtype)
    _close(got[0].double().numpy(), np.asarray(want[0], np.float64), tol)
    assert float(got[1]) == float(want[1])
    assert abs(got[2] - want[2]) <= 1e-12 * abs(want[2])
    assert abs(float(got[0].sum()) - 1.0) <= 1e-5


def test_psd_to_psf_static_phase_and_rejected_branches():
    psd, pup = _vk_psd()
    phase = 30.0 * np.random.default_rng(8).standard_normal(pup.shape)
    got = tpsf.psd_to_psf(psd, pup, 8.0, 700e-9, samp=2, phase_static=phase,
                          device="cpu").numpy()
    want = np.asarray(jpsf.psd_to_psf(psd, pup, 8.0, 700e-9, samp=2,
                                      phase_static=phase))
    # the pupil angle reaches ~1e9 rad; one rounding of it moves the PSF
    # by ~1e-8 of its peak
    _close(got, want, 1e-6)
    for kw in (dict(samp=5), dict(samp=2, FoV=99.0)):
        with pytest.raises(NotImplementedError):
            tpsf.psd_to_psf(psd, pup, 8.0, 600e-9, device="cpu", **kw)
    # a FoV equal to the grid's own is the live branch
    fov = tpsf.psd_to_psf(psd, pup, 8.0, 600e-9, return_all=True,
                          device="cpu")[2]
    tpsf.psd_to_psf(psd, pup, 8.0, 600e-9, FoV=fov, device="cpu")


@pytest.mark.parametrize("kw", [{}, {"use_fft": False},
                                {"use_fused_zoom": False}])
@pytest.mark.parametrize("ndim", [2, 3])
def test_psf_cube_matches_jax(kw, ndim):
    """The one-row entry point: a (dim, dim) PSD or a (ndir, dim, dim)
    cube, arrays or tensors, float64."""
    jkw = {k: v for k, v in kw.items() if k != "use_fused_zoom"}
    tc, jc = TTINY.with_(dtype="float64", **kw), \
        JTINY.with_(dtype="float64", **jkw)
    psd = tpsd.simulate_psd(_t(SEEING[:1]), _t(GL[:1]), _t(L0[:1]),
                            _t(MASK[:1]), H, 12.0, 2, tc)[0]
    psd = psd[0] if ndim == 2 else psd
    got = tpsf.psf_cube(psd.numpy(), LB, tc, device="cpu")
    want = jpsf.psf_cube(jnp.asarray(psd.numpy()), jnp.asarray(LB), jc)
    assert torch.is_tensor(got) and got.dtype == torch.float64
    _close(got.numpy(), want)
    again = tpsf.psf_cube(psd, _t(LB), tc, device="cpu")
    assert torch.equal(again, got)


def test_psf_cube_decides_npixc_in_host_float64():
    """The .5-plane trap: plane 19 of linspace(500, 900, 37) must crop at
    872 whatever ``cfg.dtype`` is (a float32 quotient gives 874)."""
    seen = {}
    real = tpsf.psf_cube_from_base

    def spy(base, lb, cfg, npixc=None):
        seen["npixc"] = np.asarray(npixc)
        seen["lb"] = np.asarray(lb)
        raise RuntimeError("stop")

    lb = np.linspace(500, 900, 37)
    cfg = TConfig(use_fft=True)
    tpsf.psf_cube_from_base = spy
    try:
        with pytest.raises(RuntimeError, match="stop"):
            tpsf.psf_cube(np.ones((256, 256), np.float32),
                          torch.as_tensor(lb, dtype=torch.float64),
                          TTINY, device="cpu")
    finally:
        tpsf.psf_cube_from_base = real
    assert seen["lb"].dtype == np.float64
    assert np.array_equal(seen["npixc"], tpsf.lambda_crop_size(lb, TTINY))
    assert tpsf.lambda_crop_size(lb, cfg)[19] == 872


def test_new_entry_points_raise_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    psd, pup = _vk_psd(64, 16)
    with pytest.raises(RuntimeError, match="cuda"):
        tpsf.psd_to_psf(psd, pup, 8.0, 600e-9)
    with pytest.raises(RuntimeError, match="cuda"):
        tpsf.psf_cube(np.ones((256, 256)), LB, TTINY)
    import muse_psfr_tpu_torch as pkg
    assert pkg.psf_cube is tpsf.psf_cube and "psf_cube" in pkg.__all__
