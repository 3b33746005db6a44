"""K5, the diffraction-disc skip, of the PyTorch port against the JAX
package: the block mask (the 6 dead blocks of the production full window,
none on any windowed bucket), the column groups and K5's live-row table,
the plain version against ``fused_exp_zoom_disc`` in interpret mode, and
the disc chunk path against the plain fused path.  float32 throughout; the
CUDA kernel itself runs only on the card (tests/test_torch_cuda.py,
chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.config import GalacsiConfig as JConfig  # noqa: E402
from muse_psfr_tpu.ops import zoom_dft as jzoom  # noqa: E402
from muse_psfr_tpu.otf import psf as jpsf  # noqa: E402
from muse_psfr_tpu_torch.config import GalacsiConfig as TConfig  # noqa: E402
from muse_psfr_tpu_torch.ops import zoom_dft as tzoom  # noqa: E402
from muse_psfr_tpu_torch.otf import psf as tpsf  # noqa: E402

DIM1024 = dict(dim=1024, dim_pup=32, dimpsf=16)


@pytest.mark.parametrize("kw", [{}, DIM1024])
def test_disc_block_mask_matches_jax(kw):
    got = tpsf._disc_block_mask(TConfig(**kw))
    want = jpsf._disc_block_mask(JConfig(**kw))
    assert got is not None and np.array_equal(got, want)
    assert got.dtype == np.int32
    if not kw:
        assert got.shape == (6, 10) and int((got == 0).sum()) == 6


@pytest.mark.parametrize("S", [128, 256, 384, 512])
def test_disc_block_mask_none_inside_the_disc(S):
    assert tpsf._disc_block_mask(TConfig(otf_support=S)) is None
    assert jpsf._disc_block_mask(JConfig(otf_support=S)) is None


def test_disc_column_groups_match_jax():
    rng = np.random.default_rng(2)
    masks = [np.ones((3, 4), int), np.array([[0, 1, 1, 0], [0, 1, 1, 0],
                                             [1, 1, 1, 1]]),
             np.array([[1, 0, 1, 1], [0, 0, 0, 0]]),
             tpsf._disc_block_mask(TConfig())]
    masks += [(rng.random((5, 6)) > 0.3).astype(int) for _ in range(20)]
    for m in masks:
        assert tzoom.disc_column_groups(m) == jzoom.disc_column_groups(m)


def test_disc_live_rows_of_the_production_mask():
    """K5's table: per 64-column tile the live rows of its 128-column
    group; the mask's two dead-cornered column tiles become four kernel
    tiles."""
    live = tzoom.disc_live_rows(tpsf._disc_block_mask(TConfig()), 1280, 768)
    assert live.dtype == np.int32 and live.shape == (12, 2)
    assert live[:2].tolist() == [[256, 1024]] * 2
    assert live[2:4].tolist() == [[128, 1152]] * 2
    assert live[4:].tolist() == [[0, 1280]] * 8
    with pytest.raises(ValueError, match="does not tile"):
        tzoom.disc_live_rows(np.ones((2, 2)), 256, 384)


def _kernel_inputs(B=2, ndir=3, n=256, ncols=256, nl=2, m2=8, seed=3):
    """The JAX package's disc-kernel test: dl exactly zero on the masked
    block (column tile 0, rows 0..128)."""
    rng = np.random.default_rng(seed)
    dphi = rng.uniform(0, 5, (B, ndir, n, ncols)).astype(np.float32)
    dl = rng.uniform(0, 1, (n, ncols)).astype(np.float32)
    dl[:128, :128] = 0.0
    a2 = rng.standard_normal((nl, m2, n)).astype(np.float32)
    alpha = -np.abs(rng.standard_normal(nl)).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (B, nl, ndir)).astype(np.float32)
    mask = np.ones((2, 2), np.int32)
    mask[0, 0] = 0
    return dphi, dl, a2, alpha, w, mask


@pytest.mark.parametrize("exp2", [False, True])
def test_plain_k5_matches_pallas_disc_interpret(exp2):
    dphi, dl, a2, alpha, w, mask = _kernel_inputs()
    args = [torch.as_tensor(x) for x in (dphi, dl, a2, alpha, w)]
    got = tzoom.fused_exp_zoom_disc_reference(*args, mask,
                                              exp2=exp2).numpy()
    # with dl zero on the dead block, K5 and K1 compute the same sums
    full = tzoom.fused_exp_zoom_reference(*args, exp2=exp2).numpy()
    assert np.abs(got - full).max() <= 1e-6 * np.abs(full).max()
    for b in range(2):
        want = np.asarray(jzoom.fused_exp_zoom_disc(
            jnp.asarray(dphi[b]), jnp.asarray(dl), jnp.asarray(a2), alpha,
            w[b], mask, precision="highest", exp2=exp2, interpret=True))
        assert np.abs(got[b] - want).max() <= 1e-6 * np.abs(want).max()


def test_plain_k5_drops_exactly_the_dead_rows():
    """On nonzero dl the plain K5 equals K1 on dl zeroed outside the live
    rows, per row split too."""
    dphi, dl, a2, alpha, w, _ = _kernel_inputs(n=512, ncols=256)
    dl[:128, :128] = 1.0
    mask = np.array([[0, 1, 1, 0], [0, 1, 1, 1]], np.int32)
    args = [torch.as_tensor(x) for x in (dphi, dl, a2, alpha, w)]
    cut = dl.copy()
    cut[:128, :128] = cut[384:, :128] = cut[:128, 128:] = 0.0
    for r in (1, 2):
        got = tzoom.fused_exp_zoom_disc_reference(*args, mask, row_splits=r)
        want = tzoom.fused_exp_zoom_reference(
            args[0], torch.as_tensor(cut), *args[2:], row_splits=r)
        assert torch.equal(got, want)


def test_cpu_wrapper_is_the_plain_version():
    dphi, dl, a2, alpha, w, mask = (
        torch.as_tensor(x) if isinstance(x, np.ndarray) and x.ndim else x
        for x in _kernel_inputs(B=1))
    before = tzoom.DISC_LAUNCHES
    got = tzoom.fused_exp_zoom_disc(dphi, dl, a2, alpha, w, mask.numpy())
    want = tzoom.fused_exp_zoom_disc_reference(dphi, dl, a2, alpha, w,
                                               mask.numpy())
    assert torch.equal(got, want)
    assert tzoom.DISC_LAUNCHES == before


def _synthetic_base(cfg, ndir):
    """The JAX package's outward-growing synthetic structure function
    (nm^2) over the config's window."""
    _, S = cfg.otf_window
    rng = np.random.default_rng(5)
    rr = np.hypot(np.add.outer(np.arange(2 * S) - S, np.zeros(S + 128)),
                  np.add.outer(np.zeros(2 * S), np.arange(S + 128) - S))
    return (2e4 * (rr / S) ** 0.8 * (1.0 + 0.05 * rng.standard_normal(
        (ndir, 2 * S, S + 128)))).astype(np.float32)


def test_disc_chunk_matches_plain_fused(monkeypatch):
    """dim=1024 full window (2 dead blocks): the disc chunk path against
    the plain fused path to 1e-7, as the JAX package's test holds it; the
    ndir gate keeps fewer directions on K1."""
    cfg = TConfig(disc_skip=True, **DIM1024)
    ndir = cfg.disc_min_ndir
    base = torch.as_tensor(_synthetic_base(cfg, ndir))[None]
    lb = torch.as_tensor([700.0, 900.0])
    npx = torch.as_tensor(tpsf.lambda_crop_size(lb.numpy(), cfg))
    calls = []
    real = tzoom.fused_exp_zoom_disc
    monkeypatch.setattr(tzoom, "fused_exp_zoom_disc",
                        lambda *a, **k: calls.append(1) or real(*a, **k))
    want = tpsf._psf_chunk_fused(base, lb, npx,
                                 cfg.with_(disc_skip=False)).numpy()
    assert not calls
    got = tpsf._psf_chunk_fused(base, lb, npx, cfg).numpy()
    assert calls
    assert np.abs(got - want).max() <= 1e-7
    calls.clear()
    tpsf._psf_chunk_fused(base[:, :ndir - 1], lb, npx, cfg)
    assert not calls
