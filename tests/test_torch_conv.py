"""otf/convolve.py and K2's plain version (ops/conv_dft.py) of the PyTorch
port against the JAX package: the three 'same'-convolution backends and
convolve_final on both routes in float64 (<= 1e-10 x max|ref|), and the
plain K2 against the Pallas conv chain in interpret mode in float32
(<= 1e-6 x max|ref| at "highest", <= 2e-5 at "high")."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu.ops.conv_dft import fused_conv_chain as jchain  # noqa
from muse_psfr_tpu.otf import convolve as jconv  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG as TTINY  # noqa: E402
from muse_psfr_tpu_torch.ops import conv_dft as tchain  # noqa: E402
from muse_psfr_tpu_torch.ops.zoom_dft import split_bf16  # noqa: E402
from muse_psfr_tpu_torch.otf import convolve as tconv  # noqa: E402


def _close(got, want, tol):
    want = np.asarray(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    err = np.abs(got - want).max() / np.abs(want).max()
    assert err <= tol, err


def test_same_fft_size():
    for n_img, n_ker in ((40, 41), (8, 9), (9, 9), (16, 17), (3, 5)):
        assert (tconv._same_fft_size(n_img, n_ker)
                == jconv._same_fft_size(n_img, n_ker))


@pytest.mark.parametrize("nk", [1, 5])
def test_convolution_backends(nk):
    rng = np.random.default_rng(7)
    p = rng.standard_normal((5, 40, 40))
    k = rng.standard_normal((nk, 41, 41))
    pt, kt = torch.as_tensor(p), torch.as_tensor(k)
    for name in ("_fft_convolve_same", "_dft_convolve_same",
                 "_direct_convolve_same"):
        got = getattr(tconv, name)(pt, kt, 40, 41).numpy()
        want = getattr(jconv, name)(jnp.asarray(p), jnp.asarray(k), 40, 41)
        _close(got, want, 1e-10)


@pytest.mark.parametrize("use_fft,fused", [(True, False), (False, False),
                                           (False, True)])
def test_convolve_final_matches_jax(use_fft, fused):
    tc = TTINY.with_(dtype="float64", use_fft=use_fft,
                     use_fused_conv=fused)
    jc = JTINY.with_(dtype="float64", use_fft=use_fft)
    rng = np.random.default_rng(2)
    psf = rng.random((2, 3, 8, 8))
    lb = np.array([500.0, 700.0, 900.0])
    s, g, l0 = np.array([1.0, 0.6]), np.array([0.7, 0.3]), \
        np.array([25.0, 9.1])
    got = tconv.convolve_final(*(torch.as_tensor(x)
                                 for x in (psf, lb, s, g, l0)), tc).numpy()
    for b in range(2):
        want = jconv.convolve_final(jnp.asarray(psf[b]), jnp.asarray(lb),
                                    s[b], g[b], l0[b], jc)
        _close(got[b], want, 1e-10)


@pytest.mark.parametrize("n_img,nl", [(40, 35), (8, 3)])
def test_plain_k2_matches_pallas_interpret(n_img, nl):
    n_ker = n_img + 1
    L = tconv._same_fft_size(n_img, n_ker)
    rng = np.random.default_rng(1)
    B = 2
    planes = rng.random((B, nl, n_img, n_img)).astype(np.float32)
    ktt = rng.random((B, n_ker, n_ker)).astype(np.float32)
    ki = rng.random((nl, n_ker, n_ker)).astype(np.float32)
    gtt_r, gtt_i = tconv._dft_spectra(torch.as_tensor(ktt), L)
    gi_r, gi_i = tconv._dft_spectra(torch.as_tensor(ki), L)
    got = tchain.fused_conv_chain_reference(
        torch.as_tensor(planes), gtt_r, gtt_i, gi_r, gi_i, n_ker).numpy()
    for b in range(B):
        want = jchain(jnp.asarray(planes[b]), jnp.asarray(gtt_r[b].numpy()),
                      jnp.asarray(gtt_i[b].numpy()),
                      jnp.asarray(gi_r.numpy()), jnp.asarray(gi_i.numpy()),
                      n_img, n_ker, pack=2, interpret=True)
        _close(got[b], want, 1e-6)


def test_tip_tilt_fwhm():
    s, g, l0 = np.array([0.6, 1.0, 1.6]), np.array([0.3, 0.7, 0.9]), \
        np.array([9.1, 25.0, 28.9])
    got = tconv.tip_tilt_fwhm(*(torch.as_tensor(x) for x in (s, g, l0)),
                              TTINY).numpy()
    for b in range(3):
        want = float(jconv.tip_tilt_fwhm(s[b], g[b], jnp.asarray(l0[b]),
                                         JTINY))
        assert abs(got[b] - want) <= 1e-12 * abs(want)


def test_cpu_wrapper_is_the_plain_version():
    rng = np.random.default_rng(4)
    planes = torch.as_tensor(rng.random((1, 2, 8, 8)))
    spectra = [torch.as_tensor(rng.random(s))
               for s in ((1, 16, 16), (1, 16, 16), (2, 16, 16),
                         (2, 16, 16))]
    before = tchain.LAUNCHES
    got = tchain.fused_conv_chain(planes, *spectra, 9)
    assert torch.equal(got, tchain.fused_conv_chain_reference(planes,
                                                              *spectra, 9))
    assert tchain.LAUNCHES == before


@pytest.mark.parametrize("n_img", [40, 8, 3])
def test_trimmed_mats_are_blocks_of_the_dft_pair(n_img):
    """K2's six trimmed matrices are sub-blocks of the symmetric DFT pair
    C, S of ``_dft_mats_np(L)``, and each is a row slice of one of the two
    pairs the CUDA kernel stages (C/S[:n, :] and C/S[:, off:off+n]), by the
    symmetry it relies on."""
    n_ker = n_img + (n_img % 2 == 0)      # as convolve_final makes it
    L = tconv._same_fft_size(n_img, n_ker)
    off = (n_ker - 1) // 2
    c, s = tconv._dft_mats_np(L)
    assert np.array_equal(c, c.T) and np.array_equal(s, s.T)
    csn, crc, crs, csel, cdc, cds = tchain._trimmed_mats(L, n_img, off)
    assert np.array_equal(csn, np.concatenate([c[:, :n_img], s[:, :n_img]]))
    assert np.array_equal(crc, c[:n_img]) and np.array_equal(crs, s[:n_img])
    assert np.array_equal(csel, np.concatenate([c[off:off + n_img],
                                                s[off:off + n_img]]))
    assert np.array_equal(cdc, c[:, off:off + n_img])
    assert np.array_equal(cds, s[:, off:off + n_img])
    # what the kernel reads instead: transposes of its two staged pairs
    assert np.array_equal(csn, np.concatenate([crc.T, crs.T]))
    assert np.array_equal(csel, np.concatenate([cdc.T, cds.T]))
    assert off + n_img <= L


def _exact3_chain(planes, gtt, gi, n_ker):
    """The chain at "high" with the three products of every contraction
    summed exactly (float64) and rounded once to float32."""
    def exact3(a, b, precision):
        a_hi, a_lo = (p.double() for p in split_bf16(a))
        b_hi, b_lo = (p.double() for p in split_bf16(b))
        return (a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi).float()
    saved = tchain.contract
    tchain.contract = exact3
    try:
        return tchain.fused_conv_chain_reference(planes, *gtt, *gi, n_ker,
                                                 precision="high")
    finally:
        tchain.contract = saved


@pytest.mark.parametrize("n_img,nl", [(40, 35), (8, 3)])
def test_plain_k2_high_matches_pallas_interpret_high(n_img, nl):
    """Plain K2 at "high" against the Pallas chain in interpret mode at
    ``precision="high"``: both form hi*hi + hi*lo + lo*hi of every
    contraction with every operand split anew, but sum in different float32
    orders, and the split of an intermediate that moved by one float32
    rounding moves the next product by up to 2^-17 of it; two orders of
    the same arithmetic lie up to 7e-6 of max|out| apart at these shapes
    (each 8e-6 from float64).  Limit 2e-5 against JAX and against the chain
    with every product's three terms summed exactly; both at "high" must
    be 100x closer to float64 than a one-pass bf16 chain, and the port's
    no more than twice as far from it as the JAX kernel's."""
    n_ker = n_img + 1
    L = tconv._same_fft_size(n_img, n_ker)
    rng = np.random.default_rng(1)
    B = 2
    planes = torch.as_tensor(rng.random((B, nl, n_img, n_img)),
                             dtype=torch.float32)
    ktt = torch.as_tensor(rng.random((B, n_ker, n_ker)), dtype=torch.float32)
    ki = torch.as_tensor(rng.random((nl, n_ker, n_ker)), dtype=torch.float32)
    gtt, gi = tconv._dft_spectra(ktt, L), tconv._dft_spectra(ki, L)
    got = tchain.fused_conv_chain_reference(planes, *gtt, *gi, n_ker,
                                            precision="high").numpy()
    w64 = tchain.fused_conv_chain_reference(
        planes.double(), *(x.double() for x in gtt + gi), n_ker).numpy()
    scale = np.abs(w64).max()
    jax_err = 0.0
    for b in range(B):
        want = np.asarray(jchain(
            jnp.asarray(planes[b].numpy()), jnp.asarray(gtt[0][b].numpy()),
            jnp.asarray(gtt[1][b].numpy()), jnp.asarray(gi[0].numpy()),
            jnp.asarray(gi[1].numpy()), n_img, n_ker, pack=2,
            interpret=True, precision="high"))
        _close(got[b], want, 2e-5)
        jax_err = max(jax_err, np.abs(want - w64[b]).max() / scale)
    _close(got, _exact3_chain(planes, gtt, gi, n_ker).numpy(), 2e-5)

    def one_pass(a, b, precision):
        return split_bf16(a)[0].float() @ split_bf16(b)[0].float()
    saved, tchain.contract = tchain.contract, one_pass
    try:
        one = tchain.fused_conv_chain_reference(planes, *gtt, *gi, n_ker,
                                                precision="high").numpy()
    finally:
        tchain.contract = saved
    top = tchain.fused_conv_chain_reference(planes, *gtt, *gi,
                                            n_ker).numpy()
    err = {k: np.abs(v - w64).max() / scale
           for k, v in (("high", got), ("one", one), ("highest", top))}
    assert err["highest"] < err["high"] <= 2e-5
    assert err["one"] > 100 * err["high"]
    assert jax_err <= 2e-5 and err["high"] <= 2 * jax_err


def test_plain_k2_high_feeds_float32_between_the_convolutions():
    """The second convolution takes the first one's float32 result: the
    chain at "high" equals two separate 'same' convolutions at "high"."""
    rng = np.random.default_rng(6)
    planes = torch.as_tensor(rng.random((2, 3, 8, 8)), dtype=torch.float32)
    gtt = tconv._dft_spectra(torch.as_tensor(rng.random((2, 9, 9)),
                                             dtype=torch.float32), 16)
    gi = tconv._dft_spectra(torch.as_tensor(rng.random((3, 9, 9)),
                                            dtype=torch.float32), 16)
    mats = tchain._mats(16, 8, 4, planes.device, planes.dtype)
    y = tchain._conv_same(planes, gtt[0][:, None], gtt[1][:, None], mats,
                          "high")
    assert y.dtype == torch.float32
    want = tchain._conv_same(y, gi[0][None], gi[1][None], mats, "high")
    assert torch.equal(tchain.fused_conv_chain_reference(
        planes, *gtt, *gi, 9, precision="high"), want)
