"""``zoom_precision="high"`` of the PyTorch port against the JAX package:
the plain 3-pass versions of K1, K3 and K5 (ops/zoom_dft.py) against the
JAX package's ``fused_exp_zoom``/``fused_exp_zoom_disc(precision="high")``
run in interpret mode, the split itself, and the fused chunk at "high"
against the JAX package's Pallas chunk in interpret mode.

The JAX package warns (``ops/zoom_dft.py:_mxu_contract``) that XLA on the
TPU folds ``a - f32(bf16(a))`` to zero, which would leave one bf16 pass
(~3e-3).  Interpret mode on the CPU keeps the split: its "high" lies
~5e-6 of max|U| from the float64 value on these inputs, one pass ~2e-3.
So the plain versions are held to it directly, within 3e-6 of max|U|:
the two sides split G made by different exp implementations (XLA's and
PyTorch's), so hi/lo differ in the last bit where G does, and they sum
in other orders.  The port's "highest" lies 4-7e-6 from JAX's "high" on
the same inputs, and each test asserts that "high" is at least twice as
close, so a lost split would fail it.  The CUDA kernel itself runs only
on the card (tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu.ops import zoom_dft as jzoom  # noqa: E402
from muse_psfr_tpu.otf import psf as jpsf  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG as TTINY  # noqa: E402
from muse_psfr_tpu_torch.ops import _build  # noqa: E402
from muse_psfr_tpu_torch.ops import zoom_dft as tzoom  # noqa: E402
from muse_psfr_tpu_torch.otf import psf as tpsf  # noqa: E402

TOL = 3e-6


def _inputs(B, ndir, nl, n=256, m2=32, seed=3):
    rng = np.random.default_rng(seed)
    dphi = rng.uniform(0, 40, (B, ndir, n, n)).astype(np.float32)
    dphi[..., :64] *= 8.0                   # a deeply damped band
    dl = rng.uniform(0, 1, (n, n)).astype(np.float32)
    a2 = (rng.normal(size=(nl, m2, n)) / n).astype(np.float32)
    alpha = rng.uniform(-0.3, -0.1, nl).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (B, nl, ndir)).astype(np.float32)
    return dphi, dl, a2, alpha, w


def _rel(got, want):
    return float(np.abs(got - want).max() / np.abs(want).max())


@pytest.mark.parametrize("ndir", [1, 9])
@pytest.mark.parametrize("exp2", [False, True])
@pytest.mark.parametrize("row_splits", [1, 2])
def test_plain_high_matches_pallas_high_interpret(ndir, exp2, row_splits):
    """K1 (row_splits=1; at ndir=9 the TPU's full direction block) and K3
    (row_splits=2, ``_kernel_rowacc``) at "high"."""
    B = 2
    x = _inputs(B, ndir, 2)
    args = [torch.as_tensor(v) for v in x]
    kw = dict(exp2=exp2, row_splits=row_splits)
    got = tzoom.fused_exp_zoom_reference(*args, precision="high",
                                         **kw).numpy()
    fp32 = tzoom.fused_exp_zoom_reference(*args, **kw).numpy()
    jkw = dict(dir_block=ndir, row_splits=2) if row_splits == 2 else {}
    for b in range(B):
        want = np.asarray(jzoom.fused_exp_zoom(
            jnp.asarray(x[0][b]), jnp.asarray(x[1]), jnp.asarray(x[2]), x[3],
            x[4][b], tile_j=128, precision="high", exp2=exp2, interpret=True,
            **jkw))
        err = _rel(got[b], want)
        assert err <= TOL, err
        assert 2 * err <= _rel(fp32[b], want)


@pytest.mark.parametrize("exp2", [False, True])
def test_plain_k5_high_matches_pallas_disc_high_interpret(exp2):
    """K5 at "high" with a dead block (the JAX package's disc-kernel
    inputs: dl exactly zero there), on a row split too."""
    rng = np.random.default_rng(3)
    B, ndir, n, nl = 2, 9, 256, 2
    dphi = rng.uniform(0, 40, (B, ndir, n, n)).astype(np.float32)
    dl = rng.uniform(0, 1, (n, n)).astype(np.float32)
    dl[:128, :128] = 0.0
    a2 = (rng.standard_normal((nl, 8, n)) / n).astype(np.float32)
    alpha = rng.uniform(-0.3, -0.1, nl).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (B, nl, ndir)).astype(np.float32)
    mask = np.ones((2, 2), np.int32)
    mask[0, 0] = 0
    args = [torch.as_tensor(v) for v in (dphi, dl, a2, alpha, w)]
    for rs in (1, 2):
        got = tzoom.fused_exp_zoom_disc_reference(
            *args, mask, exp2=exp2, row_splits=rs, precision="high").numpy()
        fp32 = tzoom.fused_exp_zoom_disc_reference(
            *args, mask, exp2=exp2, row_splits=rs).numpy()
        for b in range(B):
            want = np.asarray(jzoom.fused_exp_zoom_disc(
                jnp.asarray(dphi[b]), jnp.asarray(dl), jnp.asarray(a2), alpha,
                w[b], mask, precision="high", exp2=exp2, interpret=True))
            err = _rel(got[b], want)
            assert err <= TOL, err
            assert 2 * err <= _rel(fp32[b], want)


def test_split_is_three_passes_and_never_nan():
    """hi + lo carries 16 significant bits (one bf16 pass would carry 8),
    lo is 0 where hi is infinite, and a zero weight (log2 0 = -inf in the
    exp2 form) gives zeros, not NaN."""
    x = torch.tensor([1.0 + 2.0 ** -12, -3.0e-7, 0.0, float("inf"),
                      -float("inf"), 3.4e38], dtype=torch.float32)
    hi, lo = tzoom.split_bf16(x)
    assert hi.dtype == lo.dtype == torch.bfloat16
    assert not torch.isnan(lo.float()).any()
    assert float(lo[0]) == 2.0 ** -12 and float(hi[0]) == 1.0
    assert lo[2:6].float().tolist() == [0.0, 0.0, 0.0, 0.0]   # hi(3.4e38)=inf
    fin = x[:2]
    res = (fin - hi[:2].float() - lo[:2].float()).abs() / fin.abs()
    assert float(res.max()) <= 2.0 ** -16
    x = _inputs(1, 3, 2, n=64, m2=16)
    x[4][0, 1, 1] = 0.0                                      # w = 0
    args = [torch.as_tensor(v) for v in x]
    u = tzoom.fused_exp_zoom_reference(*args, exp2=True, precision="high")
    assert torch.isfinite(u).all()
    want = tzoom.fused_exp_zoom_reference(*args, exp2=False, precision="high")
    assert _rel(u.numpy(), want.numpy()) <= 1e-5


def test_plain_high_is_stepped_like_the_kernel():
    """"high" sums its three passes per K_STEP rows and then over the
    steps, as the kernel does; a contraction length that is not a
    multiple of the step takes a short last step."""
    x = _inputs(1, 1, 2, n=200, m2=16)
    args = [torch.as_tensor(v) for v in x]
    got = tzoom.fused_exp_zoom_reference(*args, precision="high").double()
    al, w = args[3], args[4]
    g = (torch.exp(al[None, :, None, None] * args[0][:, 0, None])
         * w[:, :, 0, None, None]) * args[1]
    a_hi, a_lo = (p.double() for p in tzoom.split_bf16(args[2]))
    g_hi, g_lo = (p.double() for p in tzoom.split_bf16(g))
    exact = a_hi @ g_hi + a_hi @ g_lo + a_lo @ g_hi        # float64 sums
    assert tzoom.K_STEP == 32
    assert float((got - exact).abs().max() / exact.abs().max()) <= 1e-6


def test_cpu_wrapper_runs_the_plain_version_at_each_precision():
    x = [torch.as_tensor(v) for v in _inputs(1, 2, 2, n=128, m2=16)]
    mask = np.ones((1, 1), np.int32)
    before = _build.launch_counts()
    for prec in ("high", "highest"):
        assert torch.equal(
            tzoom.fused_exp_zoom(*x, exp2=True, row_splits=2, precision=prec),
            tzoom.fused_exp_zoom_reference(*x, exp2=True, row_splits=2,
                                           precision=prec))
        assert torch.equal(
            tzoom.fused_exp_zoom_disc(*x, mask, precision=prec),
            tzoom.fused_exp_zoom_disc_reference(*x, mask, precision=prec))
    assert _build.launch_counts() == before
    for bad in ("default", "fp32"):
        with pytest.raises(ValueError, match="zoom precision"):
            tzoom.fused_exp_zoom(*x, precision=bad)
        with pytest.raises(ValueError, match="zoom precision"):
            tzoom.fused_exp_zoom_reference(*x, precision=bad)
    meta = [torch.empty(v.shape, device="meta") for v in x]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tzoom.fused_exp_zoom(*meta, precision="high")


def test_chunk_precision_follows_the_device():
    """The chunk reads zoom_precision where the kernels run; on the CPU it
    contracts in full precision, as the JAX package's chunk off the TPU
    does."""
    for prec in ("high", "highest"):
        cfg = TTINY.with_(zoom_precision=prec)
        assert tpsf._zoom_precision(cfg, "cuda") == prec
        assert tpsf._zoom_precision(cfg, torch.device("cuda", 0)) == prec
        assert tpsf._zoom_precision(cfg, "cpu") == "highest"


def _tiny_base(npsflin):
    from muse_psfr_tpu.psd.model import effective_wind_speed, simulate_psd
    h = (100, 10000)
    psd = simulate_psd(1.0, 0.7, 25.0, jnp.ones(4, JTINY.dtype), h,
                       effective_wind_speed(h, JTINY), npsflin, JTINY)
    return np.array(jpsf.dphi_base(psd.astype(JTINY.dtype), JTINY))


@pytest.mark.parametrize("npsflin", [1, 2])
def test_high_chunk_matches_pallas_chunk_interpret(npsflin, monkeypatch):
    """The slice as a whole at TINY: the port's fused chunk with K1's
    plain "high" version against the JAX package's Pallas chunk at its
    default "high" in interpret mode (<= 1e-5 x max, the float32 budget),
    and "high" within 2e-6 of the port's "highest" chunk."""
    base = _tiny_base(npsflin)
    lb = np.array([760.0, 800.0, 840.0])
    npx = tpsf.lambda_crop_size(lb, TTINY)
    tb = torch.as_tensor(base)[None]
    tlb = torch.as_tensor(lb, dtype=torch.float32)
    exact = tpsf._psf_chunk_fused(tb, tlb, torch.as_tensor(npx),
                                  TTINY).numpy()[0]
    monkeypatch.setattr(tpsf, "_zoom_precision",
                        lambda cfg, device: cfg.zoom_precision)
    got = tpsf._psf_chunk_fused(tb, tlb, torch.as_tensor(npx),
                                TTINY).numpy()[0]
    assert JTINY.zoom_precision == TTINY.zoom_precision == "high"
    want = np.asarray(jpsf._psf_chunk_pallas(
        jnp.asarray(base), jpsf.pupil_otf(JTINY),
        jnp.asarray(lb, jnp.float32), jpsf.lambda_crop_size(lb, JTINY),
        JTINY, interpret=True))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got - exact).max() <= 2e-6
    assert not np.array_equal(got, exact)
