"""K2 at conv_precision "high" (ops/conv_dft.py, csrc/conv_dft_tc.cu) on the
CPU: the persistent grid's launch plan, which the wgmma body walks, and the
plain "high" chain's distance from float64, which the kernel is held to on
the card (tests/test_torch_cuda.py, chip_smoke.py phase 17)."""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu_torch.ops import conv_dft  # noqa: E402
from muse_psfr_tpu_torch.otf import convolve as tconv  # noqa: E402

SMS = 132   # an H100 SXM
WARPGROUPS = 2   # per block of csrc/conv_dft_tc.cu (WGS)


def _walk(B, nl, blocks):
    """{(block, warpgroup): [flattened (row, plane) items]} as the kernel
    walks them: warpgroup w of block b takes b + w * blocks + k * 2 *
    blocks for k = 0, 1, ..."""
    stride = WARPGROUPS * blocks
    return {(b, w): list(range(b + w * blocks, B * nl, stride))
            for b in range(blocks) for w in range(WARPGROUPS)}


@pytest.mark.parametrize("B,nl", [(50, 35), (25, 35), (1, 3), (1, 1)])
def test_launch_plan_covers_every_item_once_on_every_sm(B, nl):
    """The night's chunk (50 x 35), a two-shard mesh's (25 x 35), the CLI's
    (1 x 3) and a single plane: one block per SM while there are items for
    each, every (row, plane) taken exactly once, every block busy, and no
    warpgroup more than one item ahead of another."""
    blocks = conv_dft.tc_launch_plan(B, nl, SMS)
    assert blocks == min(SMS, B * nl)
    walk = _walk(B, nl, blocks)
    assert len(walk) == blocks * WARPGROUPS
    taken = sorted(i for items in walk.values() for i in items)
    assert taken == list(range(B * nl))
    assert all(walk[(b, 0)] for b in range(blocks))
    counts = [len(items) for items in walk.values()]
    assert max(counts) - min(counts) <= 1


def test_launch_plan_fills_the_card_it_is_given():
    assert conv_dft.tc_launch_plan(50, 35, 114) == 114
    assert conv_dft.tc_launch_plan(3, 2, 132) == 6


def _inputs(n_img, nl, B=2):
    n_ker = n_img + 1
    L = tconv._same_fft_size(n_img, n_ker)
    rng = np.random.default_rng(1)
    planes = torch.as_tensor(rng.random((B, nl, n_img, n_img)),
                             dtype=torch.float32)
    ktt = torch.as_tensor(rng.random((B, n_ker, n_ker)), dtype=torch.float32)
    ki = torch.as_tensor(rng.random((nl, n_ker, n_ker)), dtype=torch.float32)
    return planes, tconv._dft_spectra(ktt, L), tconv._dft_spectra(ki, L), \
        n_ker


@pytest.mark.parametrize("n_img,nl,max_err,rms_err", [
    (40, 35, 8.100e-06, 2.012e-06), (8, 3, 8.469e-06, 2.906e-06)])
def test_plain_high_lies_no_further_from_float64(n_img, nl, max_err,
                                                 rms_err):
    """The plain "high" chain keeps the order of sums that the kernels
    follow; its distance from float64 (max and rms over max|out|) stays at
    what it was when the wgmma body came in, within 10% for the order of
    the CPU's matmul sums."""
    planes, gtt, gi, n_ker = _inputs(n_img, nl)
    got = conv_dft.fused_conv_chain_reference(planes, *gtt, *gi, n_ker,
                                              precision="high").numpy()
    w64 = conv_dft.fused_conv_chain_reference(
        planes.double(), *(x.double() for x in gtt + gi), n_ker).numpy()
    scale = np.abs(w64).max()
    assert np.abs(got - w64).max() / scale <= 1.1 * max_err
    assert np.sqrt(((got - w64) ** 2).mean()) / scale <= 1.1 * rms_err


def test_cpu_wrapper_at_high_is_the_plain_version():
    planes, gtt, gi, n_ker = _inputs(8, 2, B=1)
    before = (conv_dft.LAUNCHES, conv_dft.TC_LAUNCHES)
    got = conv_dft.fused_conv_chain(planes, *gtt, *gi, n_ker,
                                    precision="high")
    assert torch.equal(got, conv_dft.fused_conv_chain_reference(
        planes, *gtt, *gi, n_ker, precision="high"))
    assert (conv_dft.LAUNCHES, conv_dft.TC_LAUNCHES) == before
