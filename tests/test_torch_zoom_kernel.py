"""K1's plain PyTorch version (ops/zoom_dft.py) against the JAX package's
Pallas kernel run in interpret mode, float32, ndir in {1, 3}, with the
exp and exp2 damping forms: <= 1e-5 x max|U| (the accuracy K1's CUDA
kernel is held to on the card).  The CUDA kernel itself runs only on the
card (tests/test_torch_cuda.py, chip_smoke.py)."""

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


def test_cpu_wrapper_is_the_plain_version():
    dphi, dl, a2, alpha, w = (torch.as_tensor(x)
                              for x in _inputs(1, 2, 2, n=64, m2=16))
    before = tzoom.LAUNCHES
    got = tzoom.fused_exp_zoom(dphi, dl, a2, alpha, w, exp2=True)
    want = tzoom.fused_exp_zoom_reference(dphi, dl, a2, alpha, w, exp2=True)
    assert torch.equal(got, want)
    assert tzoom.LAUNCHES == before


def test_wrapper_rejects_other_devices():
    """A tensor that is not on the CPU never takes the plain path: it
    launches the kernel or raises."""
    args = [torch.empty(s, device="meta")
            for s in ((1, 1, 64, 64), (64, 64), (2, 16, 64), (2,),
                      (1, 2, 1))]
    with pytest.raises(ValueError, match="CPU or CUDA"):
        tzoom.fused_exp_zoom(*args)
