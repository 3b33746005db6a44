"""K6, the anchored-Taylor damping, of the PyTorch port against the JAX
package: the plain version of ``fused_exp_zoom_anchor`` against the Pallas
kernel in interpret mode, the anchored chunk path against
``_psf_chunk_pallas(zoom_anchor="on")`` one group at a time, the certified
bound and the "auto" resolution.  float32 throughout, as on the card; the
CUDA kernel itself runs only there (tests/test_torch_cuda.py,
chip_smoke.py)."""

import dataclasses
from math import factorial

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.config import TINY_CONFIG as JTINY  # noqa: E402
from muse_psfr_tpu.config import GalacsiConfig as JConfig  # noqa: E402
from muse_psfr_tpu.ops import zoom_dft as jzoom  # noqa: E402
from muse_psfr_tpu.otf import psf as jpsf  # noqa: E402
from muse_psfr_tpu.psd.model import effective_wind_speed  # noqa: E402
from muse_psfr_tpu.psd.model import simulate_psd  # noqa: E402
from muse_psfr_tpu_torch import state  # noqa: E402
from muse_psfr_tpu_torch.config import TINY_CONFIG as TTINY  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig as TConfig  # noqa: E402
from muse_psfr_tpu_torch.ops import zoom_dft as tzoom  # noqa: E402
from muse_psfr_tpu_torch.otf import psf as tpsf  # noqa: E402
from _one_thread import one_thread  # noqa: E402

BENCH = np.linspace(490.0, 930.0, 35)
MUSE = np.linspace(465.0, 930.0, 35)


def _kernel_inputs(B=2, ndir=9, nl=7, degree=8, n=256, m2=32, seed=7,
                   band=30.0):
    """The JAX package's anchor-kernel test inputs (underflowing band
    included, MUSE-worst relative alpha spread), with a row axis and a
    centre value per (row, direction)."""
    rng = np.random.default_rng(seed)
    dphi = rng.uniform(0, 40, (B, ndir, n, n)).astype(np.float32)
    dphi[..., :32] *= band
    dl = rng.uniform(0, 1, (n, n)).astype(np.float32)
    a2 = (rng.normal(size=(nl, m2, n)) / n).astype(np.float32)
    alpha = (-0.1 * (1.0 + 0.38 * np.linspace(0, 1, nl))).astype(np.float32)
    centre = dphi[:, :, n // 2, n // 2].copy()
    astar = np.float32(0.5 * (alpha.min() + alpha.max()))
    rho1 = alpha / astar - 1.0
    coef = np.stack([rho1 ** j / factorial(j) for j in range(degree + 1)],
                    axis=1).astype(np.float32)
    return dphi, dl, a2, centre, astar, coef


def test_plain_k6_matches_pallas_interpret():
    """ndir 9, n 256, nl 7, degree 8: the plain version against the TPU
    kernel fed the shifted structure function, <= 1e-6 x max|U|.  The
    plain version runs on one intra-op thread: the first CPU
    ``torch.exp`` of a process, split over OpenMP threads under load,
    can return one thread's chunk less accurate (up to 1.5e-4 relative,
    ``tools/exp_first_call.py``; here 4.149e-06 of max|U|, while the JAX
    kernel's bits did not move); on one thread it never did."""
    dphi, dl, a2, centre, astar, coef = _kernel_inputs()
    with one_thread():
        got = tzoom.fused_exp_zoom_anchor_reference(
            *(torch.as_tensor(x) for x in (dphi, dl, a2, centre)),
            torch.as_tensor([astar]), torch.as_tensor(coef), 7).numpy()
    assert got.shape == (2, 7, 32, 256)
    for b in range(2):
        want = np.asarray(jzoom.fused_exp_zoom_anchor(
            jnp.asarray(dphi[b] - centre[b][:, None, None]), jnp.asarray(dl),
            jnp.asarray(a2), astar, coef, tile_j=128, precision="highest",
            degree=8, interpret=True))
        assert np.abs(got[b] - want).max() <= 1e-6 * np.abs(want).max()


def test_plain_k6_groups_are_independent():
    """A cube in groups (the last one ragged) equals each group run
    alone with its own anchor."""
    dphi, dl, a2, centre, _, _ = _kernel_inputs(B=1, ndir=3, nl=5, n=128,
                                                m2=16)
    rng = np.random.default_rng(1)
    coef = rng.normal(size=(5, 9)).astype(np.float32)
    astar = np.float32([-0.12, -0.15, -0.2])
    t = [torch.as_tensor(x) for x in (dphi, dl, a2, centre)]
    whole = tzoom.fused_exp_zoom_anchor_reference(
        *t, torch.as_tensor(astar), torch.as_tensor(coef), 2)
    for g, l0 in enumerate(range(0, 5, 2)):
        part = tzoom.fused_exp_zoom_anchor_reference(
            t[0], t[1], t[2][l0:l0 + 2], t[3],
            torch.as_tensor(astar[g:g + 1]), torch.as_tensor(coef[l0:l0 + 2]),
            2)
        assert torch.equal(whole[:, l0:l0 + 2], part)


def test_cpu_wrapper_is_the_plain_version_and_validates():
    dphi, dl, a2, centre, astar, coef = (
        torch.as_tensor(x) for x in _kernel_inputs(B=1, ndir=2, nl=3,
                                                   n=64, m2=16))
    astar = astar.reshape(1)
    before = tzoom.ANCHOR_LAUNCHES
    assert torch.equal(
        tzoom.fused_exp_zoom_anchor(dphi, dl, a2, centre, astar, coef, 3),
        tzoom.fused_exp_zoom_anchor_reference(dphi, dl, a2, centre, astar,
                                              coef, 3))
    assert tzoom.ANCHOR_LAUNCHES == before
    with pytest.raises(ValueError, match="groups of 2"):
        tzoom.fused_exp_zoom_anchor(dphi, dl, a2, centre, astar, coef, 2)
    meta = [torch.empty(x.shape, device="meta")
            for x in (dphi, dl, a2, centre, astar, coef)]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tzoom.fused_exp_zoom_anchor(*meta, 3)
    with pytest.raises(ValueError, match="at most"):
        tzoom.fused_exp_zoom_anchor(
            meta[0], meta[1], torch.empty((9, 16, 64), device="meta"),
            meta[3], meta[4], torch.empty((9, 17), device="meta"), 9)


def _tiny_base(npsflin=2):
    """A real TINY structure function (ndir = npsflin^2), as the JAX
    package's anchored chunk test builds it."""
    h = (100, 10000)
    cfg = JTINY
    psd = simulate_psd(1.0, 0.7, 25.0, jnp.ones(4, cfg.dtype), h,
                       effective_wind_speed(h, cfg), npsflin, cfg)
    return np.array(jpsf.dphi_base(psd.astype(cfg.dtype), cfg))


def _port_chunk(base, lb, cfg):
    npx = tpsf.lambda_crop_size(lb, cfg)
    return tpsf._psf_chunk_fused(
        torch.as_tensor(base)[None], torch.as_tensor(lb, dtype=torch.float32),
        torch.as_tensor(npx), cfg).numpy()[0]


def test_anchor_chunk_matches_jax_one_group():
    """TINY, ndir 4, three wavelengths (one group): the port's anchored
    chunk against JAX's ``_psf_chunk_pallas(zoom_anchor="on")`` in
    interpret mode, and both within the JAX package's 2e-6 of the exact
    chunk."""
    base = _tiny_base()
    lb = np.array([760.0, 800.0, 840.0])
    got = _port_chunk(base, lb, TTINY.with_(zoom_anchor="on"))
    exact = _port_chunk(base, lb, TTINY)
    lbj = jnp.asarray(lb, jnp.float32)
    want = np.asarray(jpsf._psf_chunk_pallas(
        jnp.asarray(base), jpsf.pupil_otf(JTINY), lbj,
        jpsf.lambda_crop_size(lb, JTINY), JTINY.with_(zoom_anchor="on"),
        interpret=True))
    assert np.abs(got - want).max() <= 1e-5 * np.abs(want).max()
    assert np.abs(got - exact).max() <= 2e-6


@pytest.mark.parametrize("k", [7, 4])
def test_anchor_cube_in_groups_matches_jax_per_group(k):
    """A 35-wavelength cube (490-930 nm) at TINY in groups of k (k=4
    leaves a ragged group of 3): one port call against JAX's anchored
    chunk called once per group."""
    base = _tiny_base()
    cfg = TTINY.with_(zoom_anchor="on", lambda_chunk=k)
    assert tpsf._anchor_lambda_chunk(cfg, BENCH.size) == k
    got = tpsf.psf_cube_from_base(torch.as_tensor(base)[None], BENCH,
                                  cfg).numpy()[0]
    lbj = jnp.asarray(BENCH, jnp.float32)
    npx = jpsf.lambda_crop_size(BENCH, JTINY)
    for i in range(0, BENCH.size, k):
        want = np.asarray(jpsf._psf_chunk_pallas(
            jnp.asarray(base), jpsf.pupil_otf(JTINY), lbj[i:i + k],
            npx[i:i + k], JTINY.with_(zoom_anchor="on"), interpret=True))
        assert np.abs(got[i:i + k] - want).max() <= \
            1e-5 * np.abs(want).max(), i


@pytest.mark.parametrize("grid", ["bench", "muse"])
@pytest.mark.parametrize("degree", [2, 8])
def test_zoom_anchor_bound_matches_jax(grid, degree):
    lb = BENCH if grid == "bench" else MUSE
    for k in range(1, 13):
        got = tpsf.zoom_anchor_bound(lb, k, degree)
        want = jpsf.zoom_anchor_bound(lb, k, degree)
        assert got == want, (k, got, want)
    assert tpsf.zoom_anchor_bound([np.nan], 1, 8) == np.inf
    assert tpsf.zoom_anchor_bound([100.0, 10000.0], 2, 8) > 1.0


def test_anchor_group_size():
    """The card's group: min(lambda_chunk, nl, 8); on the bench grid the
    default 7 certifies 1.6e-8, and groups up to 10 certify at degree 8."""
    assert tpsf._anchor_lambda_chunk(TConfig(), 35) == 7
    assert tpsf._anchor_lambda_chunk(TConfig(), 3) == 3
    assert tpsf._anchor_lambda_chunk(TConfig(lambda_chunk=12), 35) == 8
    b7 = tpsf.zoom_anchor_bound(BENCH, 7, 8)
    assert 1.5e-8 < b7 < 1.7e-8
    assert tpsf.zoom_anchor_bound(BENCH, 10, 8) < 1e-6 < \
        tpsf.zoom_anchor_bound(BENCH, 11, 8)


@pytest.mark.parametrize("mode", ["auto", "on", "off"])
@pytest.mark.parametrize("ndir", [1, 9])
@pytest.mark.parametrize("degree", [8, 2])
def test_resolve_zoom_anchor_matches_jax(monkeypatch, mode, ndir, degree):
    """The port on CUDA against the JAX package on the TPU, with JAX's
    group size patched to the port's rule; on the CPU "auto" stays
    "auto"."""
    monkeypatch.setattr(jpsf.jax, "default_backend", lambda: "tpu")
    monkeypatch.setattr(
        jpsf, "_anchor_lambda_chunk",
        lambda c, nl, nrows: tpsf._anchor_lambda_chunk(
            state.config_from_reference(dataclasses.asdict(c)), nl))
    for lb in (BENCH, MUSE):
        jc = JConfig(zoom_anchor=mode, zoom_anchor_degree=degree)
        tc = state.config_from_reference(dataclasses.asdict(jc))
        want = jpsf.resolve_zoom_anchor(jc, lb, ndir).zoom_anchor
        assert tpsf.resolve_zoom_anchor(tc, lb, ndir,
                                        "cuda").zoom_anchor == want
        assert tpsf.resolve_zoom_anchor(tc, lb, ndir,
                                        "cpu").zoom_anchor == mode
    expect = "on" if (mode == "on" or (mode == "auto" and ndir == 9
                                        and degree == 8)) else mode
    assert want == expect
    # off the fused float32 route, or past K6's degree, "auto" stays "auto"
    for off in ({"use_fused_zoom": False}, {"dtype": "float64"},
                {"zoom_anchor_degree": 12}):
        assert tpsf.resolve_zoom_anchor(
            TConfig(zoom_anchor="auto", **off), BENCH, 9).zoom_anchor == \
            "auto"


def test_anchor_operands_match_jax_coefficients():
    """astar per group and coef by cumulative products with the DC
    normaliser folded in, as JAX builds them per chunk."""
    lb = torch.as_tensor(BENCH, dtype=torch.float32)
    alpha = -0.5 * (2.0 * np.pi / lb) ** 2
    astar, coef = tpsf._anchor_operands(alpha, 7, 8, 9 * 0.5)
    assert astar.shape == (5,) and coef.shape == (35, 9)
    for g in range(5):
        a = alpha[7 * g:7 * g + 7].numpy()
        ast = np.float32(0.5 * (a.min() + a.max()))
        assert astar[g].item() == ast
        rho1 = a / ast - np.float32(1.0)
        want = np.stack([rho1 ** j / factorial(j) for j in range(9)],
                        axis=1) / np.float32(4.5)
        assert np.allclose(coef[7 * g:7 * g + 7].numpy(), want, rtol=1e-6,
                           atol=0)
    assert np.all(np.isfinite(coef.numpy()))


@pytest.mark.parametrize("ndir", [1, 9])
def test_plain_k6_high_matches_pallas_high_interpret(ndir):
    """zoom_precision "high": the plain K6 on two groups of 4 against the
    TPU kernel's 3-pass bf16 contraction in interpret mode, one call per
    group, and nearer to it than the plain "highest" is; and within 5e-7
    of the float64 sum of its own bf16 products.

    Against JAX the limit is 4e-6 x max|U|: on these inputs the plain
    version lies 1.2-1.6e-7 from the float64 sum of its products, while
    the interpret-mode "high" lies 1.2e-6 (ndir 9) to 3.4e-6 (ndir 1) from
    it; the two "highest" agree to 9e-8-1.9e-7, so the gap is in how XLA on
    the CPU carries out the split, not in G."""
    dphi, dl, a2, centre, _, _ = _kernel_inputs(B=1, ndir=ndir, nl=8,
                                                n=128, m2=32, band=1.0)
    alpha = (-0.1 * (1.0 + 0.38 * np.linspace(0, 1, 8))).astype(np.float32)
    astar = np.float32([0.5 * (alpha[i:i + 4].min() + alpha[i:i + 4].max())
                        for i in (0, 4)])
    rho1 = alpha / np.repeat(astar, 4) - np.float32(1.0)
    coef = np.stack([rho1 ** j / factorial(j) for j in range(9)],
                    axis=1).astype(np.float32)
    t = [torch.as_tensor(x) for x in (dphi, dl, a2, centre, astar, coef)]
    high = tzoom.fused_exp_zoom_anchor_reference(*t, 4,
                                                 precision="high").numpy()
    full = tzoom.fused_exp_zoom_anchor_reference(*t, 4).numpy()
    for g in (0, 1):
        sl = slice(4 * g, 4 * g + 4)
        want = np.asarray(jzoom.fused_exp_zoom_anchor(
            jnp.asarray(dphi[0] - centre[0][:, None, None]), jnp.asarray(dl),
            jnp.asarray(a2[sl]), astar[g], coef[sl], tile_j=128,
            precision="high", degree=8, interpret=True))
        scale = np.abs(want).max()
        err = np.abs(high[0, sl] - want).max() / scale
        err_full = np.abs(full[0, sl] - want).max() / scale
        assert err <= 4e-6, err
        assert err < err_full, (err, err_full)
        # G of the group, as the plain version builds it, and the float64
        # sum of the three passes' bf16 products
        x = astar[g] * (t[0][0] - t[3][0][:, None, None])
        pw = [torch.exp(x)]
        for _ in range(8):
            pw.append(pw[-1] * x)
        hs = [p.sum(0) if ndir > 1 else p[0] for p in pw]
        gl = []
        for c in t[5][sl]:
            acc = c[0] * hs[0]
            for j in range(1, 9):
                acc = acc + c[j] * hs[j]
            gl.append(acc * t[1])
        a_hi, a_lo = (p.double() for p in tzoom.split_bf16(t[2][sl]))
        g_hi, g_lo = (p.double() for p in tzoom.split_bf16(torch.stack(gl)))
        exact = (a_hi @ g_hi + a_hi @ g_lo + a_lo @ g_hi).numpy()
        assert np.abs(high[0, sl] - exact).max() <= \
            5e-7 * np.abs(exact).max()


def test_cpu_wrapper_runs_plain_k6_at_each_precision():
    dphi, dl, a2, centre, astar, coef = (
        torch.as_tensor(x) for x in _kernel_inputs(B=1, ndir=2, nl=3,
                                                   n=64, m2=16))
    args = (dphi, dl, a2, centre, astar.reshape(1), coef, 3)
    before = (tzoom.ANCHOR_LAUNCHES, tzoom.TC_ANCHOR_LAUNCHES)
    for prec in ("high", "highest"):
        assert torch.equal(
            tzoom.fused_exp_zoom_anchor(*args, precision=prec),
            tzoom.fused_exp_zoom_anchor_reference(*args, precision=prec))
    assert not torch.equal(
        tzoom.fused_exp_zoom_anchor(*args, precision="high"),
        tzoom.fused_exp_zoom_anchor(*args))
    assert (tzoom.ANCHOR_LAUNCHES, tzoom.TC_ANCHOR_LAUNCHES) == before
    for bad in ("default", "fp32"):
        with pytest.raises(ValueError, match="zoom precision"):
            tzoom.fused_exp_zoom_anchor(*args, precision=bad)
        with pytest.raises(ValueError, match="zoom precision"):
            tzoom.fused_exp_zoom_anchor_reference(*args, precision=bad)


def test_anchored_chunk_precision_follows_the_device(monkeypatch):
    """The anchored chunk hands K6 the precision of its device: the
    config's on CUDA (the device seen by ``_zoom_precision`` is
    monkeypatched, since the CPU has no card) and "highest" on the
    CPU."""
    base = torch.as_tensor(_tiny_base())[None]
    lb = np.array([760.0, 800.0, 840.0])
    npx = torch.as_tensor(tpsf.lambda_crop_size(lb, TTINY))
    tlb = torch.as_tensor(lb, dtype=torch.float32)
    seen = []
    real_k6 = tzoom.fused_exp_zoom_anchor

    def spy(*a, precision="highest"):
        seen.append(precision)
        return real_k6(*a, precision=precision)

    monkeypatch.setattr(tzoom, "fused_exp_zoom_anchor", spy)
    for prec in ("high", "highest"):
        cfg = TTINY.with_(zoom_anchor="on", zoom_precision=prec)
        tpsf._psf_chunk_fused(base, tlb, npx, cfg)
    assert seen == ["highest", "highest"]
    real_prec = tpsf._zoom_precision
    monkeypatch.setattr(tpsf, "_zoom_precision",
                        lambda cfg, device: real_prec(cfg, "cuda"))
    for prec in ("high", "highest"):
        cfg = TTINY.with_(zoom_anchor="on", zoom_precision=prec)
        tpsf._psf_chunk_fused(base, tlb, npx, cfg)
    assert seen[2:] == ["high", "highest"]
