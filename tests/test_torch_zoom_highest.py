"""``zoom_precision="highest"`` of the PyTorch port: the three-part bf16
split and the six-pass product that the CUDA kernels run on the tensor
cores (the TPU's ``Precision.HIGHEST``), the stepped sum of the plain
version, and the plain "highest" K1, K3, K5 and K6 (ops/zoom_dft.py)
against the JAX package's functions at ``precision="highest"`` in
interpret mode.

Tolerance against JAX: 2e-6 of max|U| (the "high" tests use 3e-6 and, for
K6, 4e-6).  Both sides are float32 products of a G made by different exp
implementations (XLA's and PyTorch's) and sum in other orders: the port
per 32 contraction rows and then over the steps, as its kernels do, XLA
in one dot.  Measured here, on these strongly cancelling random inputs,
K1 and K3 agree to 3.2e-7 to 8.9e-7.  The CUDA kernels
themselves run only on the card (tests/test_torch_cuda.py, chip_smoke.py,
tools/ab_zoom_highest.py)."""

import re
from math import factorial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.ops import zoom_dft as jzoom  # noqa: E402
from muse_psfr_tpu_torch.ops import _build  # noqa: E402
from muse_psfr_tpu_torch.ops import zoom_dft as tzoom  # noqa: E402

TOL = 2e-6


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


def _parts64(x):
    return [p.double() for p in tzoom.split_bf16(x, 3)]


def test_three_part_split_sums_back_bit_for_bit():
    """Normal float32 values of every magnitude the kernels meet: three
    bf16 parts of 8 significant bits each carry all 24."""
    rng = np.random.default_rng(0)
    x = (rng.standard_normal(20000)
         * 10.0 ** rng.uniform(-25, 25, 20000)).astype(np.float32)
    x = torch.as_tensor(np.concatenate([x, np.float32(
        [1.0, -1.0, 1.0 + 2.0 ** -23, 1.0 - 2.0 ** -24, 3.0e38, 2.0 ** -100,
         0.0])]))
    parts = tzoom.split_bf16(x, 3)
    assert all(p.dtype == torch.bfloat16 for p in parts)
    p0, p1, p2 = (p.double() for p in parts)
    assert torch.equal(p0 + p1 + p2, x.double())
    assert torch.equal((p0.float() + p1.float()) + p2.float(), x)
    # two parts are the split of "high": 16 bits
    hi, lo = tzoom.split_bf16(x)
    assert torch.equal(hi, parts[0]) and torch.equal(lo, parts[1])
    nz = x != 0
    res = ((x.double() - hi.double() - lo.double()).abs() / x.double().abs())
    assert 2.0 ** -24 < float(res[nz].max()) <= 2.0 ** -16


def test_three_part_split_never_makes_nan():
    """An infinite first part zeroes the others; subnormal values and
    parts stay finite and lose less than the smallest bf16 subnormal."""
    x = torch.tensor([float("inf"), -float("inf"), 3.4e38, -3.4e38, 1e-40,
                      -3e-39, 2.0 ** -149, 1.1754944e-38, 2.0 ** -120 * 1.37],
                     dtype=torch.float32)
    p0, p1, p2 = _parts64(x)
    assert not any(torch.isnan(p).any() for p in (p0, p1, p2))
    assert torch.isinf(p0[:4]).all()                # bf16(3.4e38) is inf
    assert p1[:4].tolist() == p2[:4].tolist() == [0.0] * 4
    assert float((p0 + p1 + p2 - x.double())[4:].abs().max()) <= 2.0 ** -133
    # a zero weight in the exp2 form (log2 0 = -inf) gives zeros
    a = [torch.as_tensor(v) for v in _inputs(1, 3, 2, n=64, m2=16)]
    a[4][0, 1, 1] = 0.0
    assert torch.isfinite(tzoom.fused_exp_zoom_reference(*a, exp2=True)).all()


def test_six_pass_step_is_a_float32_grade_product():
    """One 32-row step.  The six products of order up to two, summed in
    float64, miss the float64 product only by the dropped order-three
    terms: within 2^-24 relative to sum |a||g| on operands spread over six
    decades (measured 2^-24.95; the three products of "high" 2^-15.8).
    Summed in float32, as the kernel and :func:`six_pass_product` do, they
    lie within 2^-21 on unit-normal operands (measured 2^-23.4), as does
    the float32 matmul of the step, the plain "highest" (2^-22.5); the
    three passes of "high" do not (2^-17.2), so the order-two terms are
    there."""
    rng = np.random.default_rng(1)

    def operands(spread):
        return [torch.as_tensor((rng.standard_normal(shape) * 10.0 **
                                 rng.uniform(-spread, spread, shape)
                                 ).astype(np.float32))
                for shape in ((3, 48, 32), (3, 32, 40))]

    def worst(u, a, g):
        exact = a.double() @ g.double()
        scale = a.double().abs() @ g.double().abs()
        return float(((u.double() - exact).abs() / scale).max())

    a, g = operands(3.0)
    a0, a1, a2 = _parts64(a)
    g0, g1, g2 = _parts64(g)
    three = a0 @ g0 + a0 @ g1 + a1 @ g0
    assert worst(three + a0 @ g2 + a1 @ g1 + a2 @ g0, a, g) <= 2.0 ** -24
    assert worst(three, a, g) > 2.0 ** -17
    a, g = operands(0.0)
    six = tzoom.six_pass_product(a, g)
    assert six.dtype == torch.float32
    assert worst(six, a, g) <= 2.0 ** -21
    assert worst(tzoom.contract(a, g, "high"), a, g) > 2.0 ** -21
    plain = tzoom.contract(a, g, "highest")
    assert torch.equal(plain, torch.matmul(a, g))     # one step: one matmul
    assert worst(plain, a, g) <= 2.0 ** -21


def test_stepped_highest_is_closer_to_float64_than_one_matmul():
    """N = 1280 rows of an OTF-like G (positive, smooth) against zoom-DFT
    rows: the sum per 32 rows and then over the 40 steps lies closer to
    the float64 product than one float32 matmul over all rows, and the
    six-pass product per step as close."""
    rng = np.random.default_rng(0)
    n, m2, nc = 1280, 160, 96
    k = np.arange(n)
    f = np.arange(m2 // 2) * 0.13 + 3.1
    a2 = np.concatenate([np.cos(2 * np.pi * np.outer(f, k) / n),
                         np.sin(2 * np.pi * np.outer(f, k) / n)])
    a2[0] = 1.0
    g = (np.exp(-((k[:, None] - 640) / 300.0) ** 2)
         * rng.uniform(0.5, 1.5, (n, nc)))
    a2, g = (torch.as_tensor(v.astype(np.float32))[None] for v in (a2, g))
    exact = a2.double() @ g.double()
    scale = float(exact.abs().max())

    def err(u):
        return float((u.double() - exact).abs().max()) / scale

    stepped = tzoom.contract(a2, g, "highest")
    six = None
    for s in range(0, n, tzoom.K_STEP):
        part = tzoom.six_pass_product(a2[..., s:s + tzoom.K_STEP],
                                      g[..., s:s + tzoom.K_STEP, :])
        six = part if six is None else six + part
    assert tzoom.K_STEP == 32
    assert err(stepped) < err(torch.matmul(a2, g))
    assert err(stepped) <= 5e-7 and err(six) <= 5e-7


def test_plain_highest_takes_a_short_last_step_and_float64_one_matmul():
    """200 rows are six steps and a short one; float64 operands (CPU only:
    no kernel takes them) contract in one matmul, as the JAX package's
    float64 night does."""
    x = [torch.as_tensor(v) for v in _inputs(1, 1, 2, n=200, m2=16)]
    got = tzoom.fused_exp_zoom_reference(*x)
    g = tzoom.damped_otf(x[0], x[1], x[3], x[4])
    exact = x[2].double()[None] @ g.double()
    assert got.shape == (1, 2, 16, 200)
    assert not torch.equal(got, torch.matmul(x[2][None], g))
    assert float((got - exact).abs().max() / exact.abs().max()) <= 5e-7
    x64 = [v.double() for v in x]
    assert torch.equal(tzoom.fused_exp_zoom_reference(*x64),
                       x64[2][None] @ tzoom.damped_otf(x64[0], x64[1],
                                                       x64[3], x64[4]))


@pytest.mark.parametrize("ndir", [1, 9])
@pytest.mark.parametrize("exp2", [False, True])
@pytest.mark.parametrize("row_splits", [1, 2])
def test_plain_highest_matches_pallas_highest_interpret(ndir, exp2,
                                                        row_splits):
    """K1 (row_splits=1; at ndir=9 the TPU's full direction block) and K3
    (row_splits=2, ``_kernel_rowacc``) at "highest"."""
    B = 2
    x = _inputs(B, ndir, 2)
    args = [torch.as_tensor(v) for v in x]
    got = tzoom.fused_exp_zoom_reference(*args, exp2=exp2,
                                         row_splits=row_splits,
                                         precision="highest").numpy()
    jkw = dict(dir_block=ndir, row_splits=2) if row_splits == 2 else {}
    for b in range(B):
        want = np.asarray(jzoom.fused_exp_zoom(
            jnp.asarray(x[0][b]), jnp.asarray(x[1]), jnp.asarray(x[2]), x[3],
            x[4][b], tile_j=128, precision="highest", exp2=exp2,
            interpret=True, **jkw))
        assert _rel(got[b], want) <= TOL


@pytest.mark.parametrize("exp2", [False, True])
def test_plain_k5_highest_matches_pallas_disc_highest_interpret(exp2):
    """K5 at "highest" with a dead block (the JAX package's disc-kernel
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
            *args, mask, exp2=exp2, row_splits=rs,
            precision="highest").numpy()
        for b in range(B):
            want = np.asarray(jzoom.fused_exp_zoom_disc(
                jnp.asarray(dphi[b]), jnp.asarray(dl), jnp.asarray(a2), alpha,
                w[b], mask, precision="highest", exp2=exp2, interpret=True))
            assert _rel(got[b], want) <= TOL


@pytest.mark.parametrize("ndir", [1, 9])
def test_plain_k6_highest_matches_pallas_highest_interpret(ndir):
    """K6 at "highest" on two groups of 4 wavelengths (degree 8, the
    MUSE-worst relative alpha spread) against the TPU kernel in interpret
    mode, one call per group."""
    rng = np.random.default_rng(7)
    n, nl, m2 = 128, 8, 32
    dphi = rng.uniform(0, 40, (1, ndir, n, n)).astype(np.float32)
    dl = rng.uniform(0, 1, (n, n)).astype(np.float32)
    a2 = (rng.normal(size=(nl, m2, n)) / n).astype(np.float32)
    centre = dphi[:, :, n // 2, n // 2].copy()
    alpha = (-0.1 * (1.0 + 0.38 * np.linspace(0, 1, nl))).astype(np.float32)
    astar = np.float32([0.5 * (alpha[i:i + 4].min() + alpha[i:i + 4].max())
                        for i in (0, 4)])
    rho1 = alpha / np.repeat(astar, 4) - np.float32(1.0)
    coef = np.stack([rho1 ** j / factorial(j) for j in range(9)],
                    axis=1).astype(np.float32)
    t = [torch.as_tensor(v) for v in (dphi, dl, a2, centre, astar, coef)]
    got = tzoom.fused_exp_zoom_anchor_reference(*t, 4,
                                                precision="highest").numpy()
    for g in (0, 1):
        sl = slice(4 * g, 4 * g + 4)
        want = np.asarray(jzoom.fused_exp_zoom_anchor(
            jnp.asarray(dphi[0] - centre[0][:, None, None]), jnp.asarray(dl),
            jnp.asarray(a2[sl]), astar[g], coef[sl], tile_j=128,
            precision="highest", degree=8, interpret=True))
        assert _rel(got[0, sl], want) <= TOL


def test_contraction_rows_the_kernels_take():
    """Any number of contraction rows: A2's bf16 parts are padded to a
    multiple of 8 rows (the 16-byte rows of a TMA box) for K1/K3/K5 and,
    since its wgmma body, for K6, at both precisions; no wrapper refuses
    a row count any more (K6's mma.sync body staged A2 by 16-byte copies
    and needed n % 8 == 0 at "high", n % 4 == 0 at "highest")."""
    for n in (34, 36, 40, 1280):
        for precision in ("high", "highest"):
            pad = -(-n // 8) * 8
            assert tzoom.tc_launch_plan(1, 1, n, 64, 1, 16, 1,
                                        precision).n_pad == pad
            assert tzoom.anchor_launch_plan(1, 1, n, 64, 1, 16, 1,
                                            precision).n_pad == pad
    assert not hasattr(tzoom, "_check_rows")


def test_every_entry_point_is_built_once_from_the_package_sources():
    """Both precisions come from the tensor-core sources; the float32 FMA
    bodies kept for tools/ab_zoom_highest.py are not under csrc/, so the
    package cannot build or launch them.  Every quoted include of a source
    is a header the build hashes."""
    text = {p.name: p.read_text() for p in _build.sources()}
    for name in _build._SIGNATURES:
        where = [f for f, s in text.items()
                 if re.search(rf'extern "C" int {name}\(', s)
                 and not re.search(rf'extern "C" int {name}\([^)]*\);', s)]
        assert len(where) == 1, (name, where)
    assert "muse_fused_exp_zoom(" in text["zoom_dft_tc.cu"]
    assert "muse_fused_exp_zoom_anchor(" in text["zoom_anchor_tc.cu"]
    assert "fmaf" not in text["zoom_dft.cu"]
    assert not any("fma" in f for f in text)
    headers = {p.name for p in _build.headers()}
    for s in text.values():
        assert set(re.findall(r'#include "([^"]+)"', s)) <= headers


def test_k2_high_runs_wgmma_and_the_mma_sync_body_is_a_tool_only():
    """K2 at "high" contracts with warpgroup products (wgmma.mma_async,
    written in the hashed header wgmma_common.cuh) and no longer with
    mma.sync or ldmatrix; the mma.sync body it replaced lives under
    tools/mma_sync_bodies/ with its own entry point, which no source of
    the package defines."""
    text = {p.name: p.read_text() for p in _build.sources()}
    headers = {p.name: p.read_text() for p in _build.headers()}
    tc = text["conv_dft_tc.cu"]
    assert re.findall(r'#include "([^"]+)"', tc) == ["wgmma_common.cuh"]
    assert "wgmma.mma_async" in headers["wgmma_common.cuh"]
    for call in ("wgmma_m64n32k16_ss(", "wgmma_m64n32k16_rs(",
                 "wgmma_commit()", "wgmma_wait<0>()", "warpgroup_bar("):
        assert call in tc, call
    for old in ("mma_bf16(", "ldsm_x4"):
        assert old not in tc, old
    for s in list(text.values()) + list(headers.values()):
        assert "muse_fused_conv_chain_tc_mma" not in s
        assert set(re.findall(r'#include "([^"]+)"', s)) <= set(headers)
    tool = _build.CSRC.parents[1] / "tools" / "mma_sync_bodies" / \
        "conv_dft_tc_mma.cu"
    assert 'extern "C" int muse_fused_conv_chain_tc_mma(' in tool.read_text()
    assert "muse_fused_conv_chain_tc_mma" not in _build._SIGNATURES
