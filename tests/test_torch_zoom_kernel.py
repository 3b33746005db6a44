"""The plain PyTorch versions of K1 and K3 (ops/zoom_dft.py) against the
JAX package's Pallas kernels run in interpret mode, float32: K1 at ndir
in {1, 3} with the exp and exp2 damping forms, K1 at ndir=9 against each
TPU direction-block body (``dir_block`` 1, 3 and 9: K1', K4, K1), and K3
(``row_splits`` 2 and 4) against ``row_splits=2, dir_block=ndir``; all
<= 1e-5 x max|U| (the accuracy the CUDA kernels are held to on the
card).  The CUDA kernels themselves run only on the card
(tests/test_torch_cuda.py, chip_smoke.py)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402

from muse_psfr_tpu.ops import zoom_dft as jzoom  # noqa: E402
from muse_psfr_tpu_torch.ops import zoom_dft as tzoom  # noqa: E402


def _inputs(B, ndir, nl, n=256, m2=32, seed=3):
    rng = np.random.default_rng(seed)
    dphi = rng.uniform(0, 40, (B, ndir, n, n)).astype(np.float32)
    dphi[..., :64] *= 8.0                   # a deeply damped band
    dl = rng.uniform(0, 1, (n, n)).astype(np.float32)
    a2 = (rng.normal(size=(nl, m2, n)) / n).astype(np.float32)
    alpha = rng.uniform(-0.3, -0.1, nl).astype(np.float32)
    w = rng.uniform(0.5, 1.5, (B, nl, ndir)).astype(np.float32)
    return dphi, dl, a2, alpha, w


@pytest.mark.parametrize("ndir", [1, 3])
@pytest.mark.parametrize("exp2", [False, True])
def test_plain_k1_matches_pallas_interpret(ndir, exp2):
    B, nl = 2, 3
    dphi, dl, a2, alpha, w = _inputs(B, ndir, nl)
    got = tzoom.fused_exp_zoom_reference(
        *(torch.as_tensor(x) for x in (dphi, dl, a2, alpha, w)),
        exp2=exp2).numpy()
    assert got.shape == (B, nl, a2.shape[1], dphi.shape[-1])
    for b in range(B):
        want = np.asarray(jzoom.fused_exp_zoom(
            jnp.asarray(dphi[b]), jnp.asarray(dl), jnp.asarray(a2), alpha,
            w[b], tile_j=128, precision="highest", exp2=exp2,
            interpret=True))
        err = np.abs(got[b] - want).max() / np.abs(want).max()
        assert err <= 1e-5, err


def _jax_u(dphi, dl, a2, alpha, w, b, **kw):
    return np.asarray(jzoom.fused_exp_zoom(
        jnp.asarray(dphi[b]), jnp.asarray(dl), jnp.asarray(a2), alpha, w[b],
        tile_j=128, precision="highest", interpret=True, **kw))


@pytest.mark.parametrize("dir_block", [1, 3, 9])
def test_plain_k1_ndir9_matches_pallas_dir_blocks(dir_block):
    """ndir=9: the port sums the 9 directions per element, which is what
    the TPU's _kernel (db=1), _kernel_dirblock (db=3) and _kernel_dirfull
    (db=9) compute."""
    B, nl = 1, 2
    dphi, dl, a2, alpha, w = _inputs(B, 9, nl, n=128, m2=16)
    got = tzoom.fused_exp_zoom_reference(
        *(torch.as_tensor(x) for x in (dphi, dl, a2, alpha, w)),
        exp2=True).numpy()
    want = _jax_u(dphi, dl, a2, alpha, w, 0, exp2=True, dir_block=dir_block)
    assert np.abs(got[0] - want).max() <= 1e-5 * np.abs(want).max()


@pytest.mark.parametrize("ndir", [1, 9])
@pytest.mark.parametrize("row_splits", [2, 4])
def test_plain_k3_matches_pallas_rowacc(ndir, row_splits):
    """K3's plain version (R partial contractions summed in order) against
    the TPU's _kernel_rowacc (row_splits=2, dir_block=ndir)."""
    B, nl = 2, 2
    dphi, dl, a2, alpha, w = _inputs(B, ndir, nl, n=256, m2=16)
    args = [torch.as_tensor(x) for x in (dphi, dl, a2, alpha, w)]
    got = tzoom.fused_exp_zoom_reference(*args, exp2=True,
                                         row_splits=row_splits).numpy()
    one = tzoom.fused_exp_zoom_reference(*args, exp2=True).numpy()
    assert np.abs(got - one).max() <= 1e-6 * np.abs(one).max()
    for b in range(B):
        want = _jax_u(dphi, dl, a2, alpha, w, b, exp2=True, dir_block=ndir,
                      row_splits=2)
        assert np.abs(got[b] - want).max() <= 1e-5 * np.abs(want).max()


def test_row_splits_validated():
    args = [torch.as_tensor(x) for x in _inputs(1, 1, 1, n=96, m2=16)]
    with pytest.raises(ValueError, match="row_splits"):
        tzoom.fused_exp_zoom(*args, row_splits=2)       # 48-row slices
    with pytest.raises(ValueError, match="row_splits"):
        tzoom.fused_exp_zoom_reference(*args, row_splits=0)


def test_cpu_wrapper_is_the_plain_version():
    dphi, dl, a2, alpha, w = (torch.as_tensor(x)
                              for x in _inputs(1, 2, 2, n=64, m2=16))
    before = (tzoom.LAUNCHES, tzoom.ROWSPLIT_LAUNCHES)
    got = tzoom.fused_exp_zoom(dphi, dl, a2, alpha, w, exp2=True)
    want = tzoom.fused_exp_zoom_reference(dphi, dl, a2, alpha, w, exp2=True)
    assert torch.equal(got, want)
    got = tzoom.fused_exp_zoom(dphi, dl, a2, alpha, w, row_splits=2)
    want = tzoom.fused_exp_zoom_reference(dphi, dl, a2, alpha, w,
                                          row_splits=2)
    assert torch.equal(got, want)
    assert (tzoom.LAUNCHES, tzoom.ROWSPLIT_LAUNCHES) == before


def test_wrapper_rejects_other_devices():
    """A tensor that is not on the CPU never takes the plain path: it
    launches the kernel or raises."""
    args = [torch.empty(s, device="meta")
            for s in ((1, 1, 64, 64), (64, 64), (2, 16, 64), (2,),
                      (1, 2, 1))]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tzoom.fused_exp_zoom(*args)
