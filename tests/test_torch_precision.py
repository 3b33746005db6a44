"""The ``matmul_precision``/``conv_precision`` tiers of the PyTorch port.

The tier contraction (``ops/zoom_dft.py:matmul_tier``): the bf16 split bit
for bit against ``jnp.astype(bfloat16)``, "high" against the exact float64
sum of its three products (<= 64 float32 roundings of sum|a||b|) and
within 2^-15 x sum|a||b| of the float64 product, "default" within 2^-7 of
it and far worse than "high", "highest" the plain matmul bit for bit.  The
plumbing: the two fields are read only where the card runs
(``otf/psf.py:_mm``, ``otf/convolve.py:_conv_precision``), so a CPU night
splits no operand into bf16 parts and ignores them bit for bit (two
nights on one intra-op thread); with the device rule lifted (monkeypatched) all
three tiers run through the four contraction sites of the OTF chain and
through the convolutions; K2 takes "highest" and "high" and raises on
anything else.  Against the JAX package on the CPU (where XLA also
contracts in float32 whatever the field says): ``convolve_final`` and the
TINY night with each field at "high", float32, <= 1e-5 x max|ref|.
"""

from functools import partial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu.otf import convolve as jconv  # noqa: E402
from muse_psfr_tpu.parallel import batch as jbatch  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG as TTINY  # noqa: E402
from muse_psfr_tpu_torch.ops import conv_dft, zoom_dft  # noqa: E402
from muse_psfr_tpu_torch.ops.zoom_dft import matmul_tier, split_bf16  # noqa
from muse_psfr_tpu_torch.otf import convolve as tconv  # noqa: E402
from muse_psfr_tpu_torch.otf import psf as tpsf  # noqa: E402
from muse_psfr_tpu_torch.parallel import batch as tbatch  # noqa: E402

from _one_thread import one_thread  # noqa: E402

LB = np.array([750.0, 800.0, 850.0, 900.0])
TIERS = ("default", "high", "highest")


def _operands(shape_a=(3, 48, 200), shape_b=(200, 56), seed=11):
    rng = np.random.default_rng(seed)
    a = rng.standard_normal(shape_a).astype(np.float32)
    b = (rng.standard_normal(shape_b) * np.exp(rng.uniform(-6, 6, shape_b))
         ).astype(np.float32)
    return torch.as_tensor(a), torch.as_tensor(b)


def _night():
    rng = np.random.default_rng(0)
    mask = np.ones((4, 4))
    mask[2, 3] = 0.0
    return (rng.uniform(0.6, 1.6, 4), rng.uniform(0.3, 0.9, 4),
            rng.uniform(9.0, 29.0, 4), mask)


def test_split_is_the_jax_split_bit_for_bit():
    """hi = bf16(x), lo = bf16(x - hi), round to nearest even: the same
    bits as ``_mxu_contract``'s ``astype(bfloat16)`` pair."""
    rng = np.random.default_rng(5)
    x = np.concatenate([
        rng.standard_normal(4096) * np.exp(rng.uniform(-30, 30, 4096)),
        [0.0, -0.0, 1.0, 1.00390625, 1.0 + 2.0 ** -8, 3.3895314e38,
         np.inf, -np.inf, 1e-40]]).astype(np.float32)
    hi, lo = split_bf16(torch.as_tensor(x))
    j_hi = jnp.asarray(x).astype(jnp.bfloat16)
    j_lo = (jnp.asarray(x) - j_hi.astype(jnp.float32)).astype(jnp.bfloat16)
    finite = np.isfinite(np.asarray(j_hi.astype(jnp.float32)))
    assert np.array_equal(hi.float().numpy().view(np.uint32),
                          np.asarray(j_hi.astype(jnp.float32)
                                     ).view(np.uint32))
    assert np.array_equal(lo.float().numpy()[finite],
                          np.asarray(j_lo.astype(jnp.float32))[finite])
    # where hi overflows the port's lo is 0 (JAX's is NaN or -inf)
    assert np.all(lo.float().numpy()[~finite] == 0)
    assert not torch.isnan(hi.float() + lo.float()).any()


def test_high_is_the_three_products_within_its_bound():
    a, b = _operands()
    a_hi, a_lo = (p.double() for p in split_bf16(a))
    b_hi, b_lo = (p.double() for p in split_bf16(b))
    exact3 = a_hi @ b_hi + a_hi @ b_lo + a_lo @ b_hi
    scale = a.double().abs() @ b.double().abs()          # sum |a||b|
    got = matmul_tier(a, b, "high").double()
    # float32 accumulation of exact products: three matmuls over 200
    # terms and two adds, far inside 64 roundings of sum|a||b|
    assert ((got - exact3).abs() <= 64 * 2.0 ** -24 * scale).all()
    # the dropped lo*lo term and the split's own residual: <= 2^-15
    err = (got - a.double() @ b.double()).abs()
    assert (err <= 2.0 ** -15 * scale).all()
    top = (matmul_tier(a, b, "highest").double()
           - a.double() @ b.double()).abs()
    one = (matmul_tier(a, b, "default").double()
           - a.double() @ b.double()).abs()
    assert (one <= 2.0 ** -7 * scale).all()
    assert top.max() < err.max() < 1e-2 * one.max()
    assert torch.equal(matmul_tier(a, b, "default"),
                       a_hi.float() @ b_hi.float())


def test_highest_is_the_plain_matmul_and_float64_is_one_product():
    a, b = _operands()
    assert torch.equal(matmul_tier(a, b), torch.matmul(a, b))
    assert torch.equal(matmul_tier(a, b, "highest"), torch.matmul(a, b))
    for tier in TIERS:
        assert torch.equal(matmul_tier(a.double(), b.double(), tier),
                           torch.matmul(a.double(), b.double()))
        assert matmul_tier(a, b, tier).dtype == torch.float32
    for bad in ("HIGH", "tf32", None):
        with pytest.raises(ValueError, match="matmul precision"):
            matmul_tier(a, b, bad)


@pytest.mark.parametrize("tier", TIERS)
def test_fields_are_read_only_where_the_card_runs(tier):
    a, b = _operands()
    cfg = TTINY.with_(matmul_precision=tier, conv_precision=tier)
    assert tpsf._mm(cfg, torch.device("cpu")) is torch.matmul
    assert tpsf._mm(cfg, "cpu") is torch.matmul
    on_card = tpsf._mm(cfg, torch.device("cuda"))
    assert torch.equal(on_card(a, b), matmul_tier(a, b, tier))
    assert tconv._conv_precision(cfg, torch.device("cpu")) == "highest"
    assert tconv._conv_precision(cfg, torch.device("cuda", 0)) == tier
    assert torch.equal(tconv._mm(tier)(a, b), matmul_tier(a, b, tier))


@pytest.mark.parametrize("field", ["matmul_precision", "conv_precision"])
@pytest.mark.parametrize("tier", TIERS)
def test_cpu_night_ignores_the_fields(monkeypatch, field, tier):
    """Bit for bit the night at "highest": the CPU contracts in float32
    whatever the fields say, as the JAX package's run off the TPU does.
    Directly: no operand of the night is split into bf16 parts, which
    every tier below "highest" does (``matmul_tier``, the plain K1/K2 at
    "high", through ``zoom_dft.split_bf16``)."""
    night = _night()
    kw = dict(cfg=TTINY.with_(use_fft=False, use_fused_conv=False), chunk=2,
              device="cpu")
    splits = []

    def spy(x, parts=2):
        splits.append(tuple(x.shape))
        return split(x, parts)

    split = zoom_dft.split_bf16
    with one_thread():
        want = tbatch.process_batch(*night, LB, **kw)
        monkeypatch.setattr(zoom_dft, "split_bf16", spy)
        kw["cfg"] = kw["cfg"].with_(**{field: tier})
        got = tbatch.process_batch(*night, LB, **kw)
    assert splits == []
    for g, w in zip(got, want):
        assert np.array_equal(g, w)


def _lift_device_rule(monkeypatch):
    """Make the CPU run read the fields, as the card does."""
    monkeypatch.setattr(tpsf, "_mm", lambda cfg, device: partial(
        matmul_tier, precision=cfg.matmul_precision))
    monkeypatch.setattr(tconv, "_conv_precision",
                        lambda cfg, device: cfg.conv_precision)


@pytest.mark.parametrize("split", [True, False])
@pytest.mark.parametrize("fused_zoom", [True, False])
def test_all_three_matmul_tiers_run_through_the_otf_chain(
        monkeypatch, split, fused_zoom):
    """The four contraction sites (``dphi_base``, ``dphi_base_split``, the
    second zoom stage, ``_psf_samples_zoom``) at each tier: "high" within
    5e-5 of max|PSF| of "highest" (measured 1.0e-5 with the split
    structure function, whose correction block TINY contracts over few
    terms), "default" finite and 10x further off."""
    _lift_device_rule(monkeypatch)
    night = _night()
    base = TTINY.with_(use_fft=False, use_dphi_split=split,
                       use_fused_zoom=fused_zoom)
    cubes = {t: tbatch.reconstruct_batch(
        *night, LB, cfg=base.with_(matmul_precision=t), chunk=2,
        device="cpu") for t in TIERS}
    top = cubes["highest"]
    err = {t: np.abs(cubes[t] - top).max() / top.max() for t in TIERS}
    assert all(np.isfinite(c).all() for c in cubes.values())
    assert 0 < err["high"] <= 5e-5
    assert err["default"] > 10 * err["high"]
    assert err["default"] < 0.1


@pytest.mark.parametrize("fused", [True, False])
def test_conv_tiers_run_and_k2_raises_on_default(monkeypatch, fused):
    _lift_device_rule(monkeypatch)
    rng = np.random.default_rng(2)
    args = [torch.as_tensor(x, dtype=torch.float32) for x in (
        rng.random((2, 3, 8, 8)), [500.0, 700.0, 900.0], [1.0, 0.6],
        [0.7, 0.3], [25.0, 9.1])]
    cfg = TTINY.with_(use_fft=False, use_fused_conv=fused)
    top = tconv.convolve_final(*args, cfg)
    high = tconv.convolve_final(*args, cfg.with_(conv_precision="high"))
    rel = float((high - top).abs().max() / top.abs().max())
    assert 0 < rel <= 2e-5
    if fused:
        with pytest.raises(ValueError, match="conv precision"):
            tconv.convolve_final(*args, cfg.with_(conv_precision="default"))
    else:
        one = tconv.convolve_final(*args,
                                   cfg.with_(conv_precision="default"))
        assert rel < float((one - top).abs().max() / top.abs().max()) < 0.1
    # the cuFFT route has no products to tier
    fft = cfg.with_(use_fft=True)
    assert torch.equal(
        tconv.convolve_final(*args, fft),
        tconv.convolve_final(*args, fft.with_(conv_precision="default")))


@pytest.mark.parametrize("bad", ["default", "HIGHEST", None])
def test_k2_raises_on_anything_but_its_two_tiers(bad):
    rng = np.random.default_rng(4)
    planes = torch.as_tensor(rng.random((1, 2, 8, 8)), dtype=torch.float32)
    spectra = [torch.as_tensor(rng.random(s), dtype=torch.float32)
               for s in ((1, 16, 16), (1, 16, 16), (2, 16, 16), (2, 16, 16))]
    assert conv_dft.CONV_PRECISIONS == ("highest", "high")
    for fn in (conv_dft.fused_conv_chain,
               conv_dft.fused_conv_chain_reference):
        with pytest.raises(ValueError, match="conv precision"):
            fn(planes, *spectra, 9, precision=bad)
    before = (conv_dft.LAUNCHES, conv_dft.TC_LAUNCHES)
    for tier in conv_dft.CONV_PRECISIONS:
        got = conv_dft.fused_conv_chain(planes, *spectra, 9, precision=tier)
        assert torch.equal(got, conv_dft.fused_conv_chain_reference(
            planes, *spectra, 9, precision=tier))
    assert (conv_dft.LAUNCHES, conv_dft.TC_LAUNCHES) == before


def test_dft_convolve_same_at_high_is_the_tier_of_every_product():
    """``_dft_spectra``/``_dft_convolve_same`` at "high" against float64:
    closer than one bf16 pass by 100x, and "highest" closer still."""
    rng = np.random.default_rng(7)
    p = torch.as_tensor(rng.random((5, 16, 16)), dtype=torch.float32)
    k = torch.as_tensor(rng.random((1, 17, 17)), dtype=torch.float32)
    want = tconv._dft_convolve_same(p.double(), k.double(), 16, 17)
    err = {t: float((tconv._dft_convolve_same(p, k, 16, 17, precision=t)
                     .double() - want).abs().max() / want.abs().max())
           for t in TIERS}
    assert err["highest"] < err["high"] <= 2e-5
    assert err["default"] > 100 * err["high"]
    fr, fi = tconv._dft_spectra(k, 32, "high")
    fr64, fi64 = tconv._dft_spectra(k.double(), 32)
    assert float((fr.double() - fr64).abs().max()
                 / fr64.abs().max()) <= 1e-5
    assert float((fi.double() - fi64).abs().max()
                 / fr64.abs().max()) <= 1e-5


@pytest.mark.parametrize("kw", [dict(conv_precision="high"),
                                dict(matmul_precision="high"),
                                dict(matmul_precision="high",
                                     conv_precision="high")])
def test_tiny_night_at_high_matches_jax(kw):
    night = _night()
    want = jbatch.process_batch(*night, LB,
                                cfg=JTINY.with_(use_fft=False, **kw),
                                chunk=2, _force_full=True)
    fit, psf_mean, _ = tbatch.process_batch(
        *night, LB, cfg=TTINY.with_(use_fft=False, **kw), chunk=2,
        device="cpu")
    assert psf_mean.dtype == np.float32
    assert np.abs(psf_mean - want[1]).max() <= 1e-5 * np.abs(want[1]).max()
    assert np.all(fit[..., -1] == 1.0)


@pytest.mark.parametrize("fused", [True, False])
@pytest.mark.parametrize("dtype,tol", [("float32", 1e-5),
                                       ("float64", 1e-10)])
def test_convolve_final_at_high_matches_jax(fused, dtype, tol):
    tc = TTINY.with_(dtype=dtype, use_fft=False, use_fused_conv=fused,
                     conv_precision="high")
    jc = JTINY.with_(dtype=dtype, use_fft=False, conv_precision="high")
    rng = np.random.default_rng(2)
    psf = rng.random((2, 3, 8, 8))
    lb = np.array([500.0, 700.0, 900.0])
    s, g, l0 = np.array([1.0, 0.6]), np.array([0.7, 0.3]), \
        np.array([25.0, 9.1])
    tdt = getattr(torch, dtype)
    got = tconv.convolve_final(*(torch.as_tensor(x, dtype=tdt)
                                 for x in (psf, lb, s, g, l0)), tc).numpy()
    for b in range(2):
        want = np.asarray(jconv.convolve_final(
            jnp.asarray(psf[b]), jnp.asarray(lb), s[b], g[b], l0[b], jc))
        assert got[b].shape == want.shape
        assert np.abs(got[b] - want).max() <= tol * np.abs(want).max()


def test_contract_and_matmul_tier_share_the_split():
    """``contract`` (the kernels' stepped order) and ``matmul_tier`` (one
    sum over the whole contraction) add the same exact products: equal up
    to the float32 order of the sums."""
    a, b = _operands(shape_a=(48, 64), shape_b=(64, 40))
    stepped = zoom_dft.contract(a, b, "high")
    whole = matmul_tier(a, b, "high")
    scale = a.abs() @ b.abs()
    assert ((stepped - whole).abs() <= 16 * 2.0 ** -24 * scale).all()
