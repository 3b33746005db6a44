"""The hand-written CUDA kernels against their plain PyTorch versions on
the card: K1, K3, K5 and K6 at zoom_precision "highest" (six bf16 passes
on the tensor cores against a float32 matmul per 32-row step, <= 2e-6 of
max|U|; K3 against K1 <= 2e-6, and bit-identical on a rerun) and at "high"
(three passes against their 3-pass plain versions, <= 2e-6: the same bf16
products summed in another order; against "highest" <= 2e-5), K2 <= 1e-6,
K2 at "high" (the wgmma tensor-core body, <= 3e-5 of max|out| from its
plain version: the tier's own distance from float64 is 1e-5, see
``test_conv_high_kernel_matches_plain``; the same bit for bit on any
grid), K1 on a strided structure
function, the batch night through the kernels (also over a two-shard
mesh on one card), a night of captured chunk programs bit-equal to the
eager night, with the eager night's launches, the nights at a lower
``conv_precision``/``matmul_precision`` and the float64 compat layer on
the card against the CPU.  Marked ``cuda``:
skipped where no CUDA card is present (CUDA kernels have no CPU mode).
On a GPU machine:

    python -m pytest --noconftest tests/test_torch_cuda.py -m cuda

(``--noconftest``: the repository's conftest imports JAX, which a GPU
machine need not have; this file imports none.)
"""

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from muse_psfr_tpu_torch.config import TINY_CONFIG  # noqa: E402
from muse_psfr_tpu_torch.ops import _build, conv_dft, zoom_dft  # noqa: E402
from muse_psfr_tpu_torch.otf.convolve import _same_fft_size  # noqa: E402

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from muse_psfr_tpu_torch.utils.device import resolve_device
    return resolve_device("cuda")


def _rel(got, want):
    return float((got.double() - want.double()).abs().max()
                 / want.double().abs().max())


@pytest.mark.parametrize("ndir,n,ncols,m2,exp2", [
    (1, 256, 256, 32, True), (3, 96, 80, 24, False), (1, 64, 128, 200, True)])
def test_zoom_kernel_matches_plain(dev, ndir, n, ncols, m2, exp2):
    g = torch.Generator(device="cpu").manual_seed(0)
    B, nl = 2, 3
    dphi = torch.rand((B, ndir, n, ncols), generator=g) * 40
    dl = torch.rand((n, ncols), generator=g)
    a2 = torch.randn((nl, m2, n), generator=g) / n
    alpha = -0.1 - 0.2 * torch.rand((nl,), generator=g)
    w = 0.5 + torch.rand((B, nl, ndir), generator=g)
    args = [x.to(dev) for x in (dphi, dl, a2, alpha, w)]
    before = zoom_dft.LAUNCHES
    got = zoom_dft.fused_exp_zoom(*args, exp2=exp2)
    assert zoom_dft.LAUNCHES == before + 1
    assert _rel(got, zoom_dft.fused_exp_zoom_reference(*args,
                                                       exp2=exp2)) <= 2e-6


def _zoom_args(dev, B, ndir, n, ncols, m2, nl=3, seed=0):
    g = torch.Generator(device="cpu").manual_seed(seed)
    dphi = torch.rand((B, ndir, n, ncols), generator=g) * 40
    dl = torch.rand((n, ncols), generator=g)
    a2 = torch.randn((nl, m2, n), generator=g) / n
    alpha = -0.1 - 0.2 * torch.rand((nl,), generator=g)
    w = 0.5 + torch.rand((B, nl, ndir), generator=g)
    return [x.to(dev) for x in (dphi, dl, a2, alpha, w)]


@pytest.mark.parametrize("ndir", [1, 9])
@pytest.mark.parametrize("R", [2, 4, 8])
def test_rowsplit_kernel_matches_plain(dev, ndir, R):
    """K3 with ncols = 200 (not a multiple of the 64-column tile) and two
    160-row output blocks.  Against K1 the bound is 2e-6: both are float32
    sums of the same 512 signed terms in two association orders, and on
    these random, strongly cancelling inputs each lies up to ~6e-7 of
    max|U| from the float64 value (measured with the plain versions)."""
    args = _zoom_args(dev, 2, ndir, 512, 200, 170)
    before = (zoom_dft.LAUNCHES, zoom_dft.ROWSPLIT_LAUNCHES)
    got = zoom_dft.fused_exp_zoom(*args, exp2=True, row_splits=R)
    assert (zoom_dft.LAUNCHES, zoom_dft.ROWSPLIT_LAUNCHES) == \
        (before[0], before[1] + 1)
    assert _rel(got, zoom_dft.fused_exp_zoom_reference(
        *args, exp2=True, row_splits=R)) <= 2e-6
    assert _rel(got, zoom_dft.fused_exp_zoom(*args, exp2=True)) <= 2e-6
    assert torch.equal(got, zoom_dft.fused_exp_zoom(*args, exp2=True,
                                                    row_splits=R))


# the last two read D from device memory: 10 directions do not fit the
# shared-memory stage, and 130 columns leave dl's rows unaligned
_TC_SHAPES = [(1, 256, 256, 32, True, 1), (3, 96, 80, 24, False, 1),
              (1, 64, 128, 200, True, 1), (9, 512, 200, 170, True, 2),
              (1, 512, 200, 170, False, 4), (10, 128, 64, 32, True, 1),
              (1, 128, 130, 40, True, 2)]


@pytest.mark.parametrize("ndir,n,ncols,m2,exp2,R", _TC_SHAPES)
def test_tc_kernel_matches_plain_high(dev, ndir, n, ncols, m2, exp2, R):
    """K1/K3 at "high" (three passes), with ragged columns, rows past one
    160-row block and ragged output fragments: against the plain 3-pass
    version <= 2e-6 of max|U|; against the kernel at "highest" <= 2e-5,
    the split's own error on these strongly cancelling random inputs
    (<= 7.5e-6 between the two plain versions); counted on its own
    counter only; bit-identical on a rerun."""
    args = _zoom_args(dev, 2, ndir, n, ncols, m2)
    kw = dict(exp2=exp2, row_splits=R, precision="high")
    key = "zoom_dft_tc" if R == 1 else "zoom_dft_tc_rowsplit"
    before = _build.launch_counts()
    got = zoom_dft.fused_exp_zoom(*args, **kw)
    after = _build.launch_counts()
    assert after == dict(before, **{key: before[key] + 1})
    assert _rel(got, zoom_dft.fused_exp_zoom_reference(*args, **kw)) <= 2e-6
    exact = zoom_dft.fused_exp_zoom(*args, exp2=exp2, row_splits=R)
    assert _rel(got, exact) <= 2e-5
    assert torch.equal(got, zoom_dft.fused_exp_zoom(*args, **kw))


@pytest.mark.parametrize("ndir,n,ncols,m2,exp2,R", _TC_SHAPES)
def test_six_pass_kernel_matches_plain_highest(dev, ndir, n, ncols, m2, exp2,
                                               R):
    """K1/K3 at "highest" (six passes, A2 staged as float32 and split in
    registers) on the shapes of the "high" test: against the plain version
    (a float32 matmul per 32-row step) <= 2e-6 of max|U|; against the
    float64 product of the same G closer than the plain "high" version
    is; counted on its own counter only; bit-identical on a rerun."""
    args = _zoom_args(dev, 2, ndir, n, ncols, m2)
    kw = dict(exp2=exp2, row_splits=R, precision="highest")
    key = "zoom_dft" if R == 1 else "zoom_dft_rowsplit"
    before = _build.launch_counts()
    got = zoom_dft.fused_exp_zoom(*args, **kw)
    after = _build.launch_counts()
    assert after == dict(before, **{key: before[key] + 1})
    assert _rel(got, zoom_dft.fused_exp_zoom_reference(*args, **kw)) <= 2e-6
    g = zoom_dft.damped_otf(args[0], args[1], args[3], args[4], exp2)
    exact = args[2].double()[None] @ g.double()
    high = zoom_dft.fused_exp_zoom_reference(*args, exp2=exp2, row_splits=R,
                                             precision="high")
    assert _rel(got, exact) < _rel(high, exact)
    assert torch.equal(got, zoom_dft.fused_exp_zoom(*args, **kw))


def test_tc_kernel_takes_a_strided_view_and_checks_rows(dev):
    dphi, dl, a2, alpha, w = _zoom_args(dev, 2, 3, 256, 384, 32)
    view = dphi[..., 64:192, 64:]
    args = (view, dl[64:192, 64:].contiguous(), a2[..., 64:192].contiguous(),
            alpha, w)
    got = zoom_dft.fused_exp_zoom(*args, precision="high")
    want = zoom_dft.fused_exp_zoom_reference(view.contiguous(), *args[1:],
                                             precision="high")
    assert _rel(got, want) <= 2e-6
    # a view one column in: its rows are not 16-byte aligned
    odd = (dphi[..., 64:192, 65:], dl[64:192, 65:].contiguous(), *args[2:])
    got = zoom_dft.fused_exp_zoom(*odd, precision="high")
    want = zoom_dft.fused_exp_zoom_reference(odd[0].contiguous(), *odd[1:],
                                             precision="high")
    assert _rel(got, want) <= 2e-6
    # contraction rows that are no whole 16-byte TMA row of A2's bf16
    # parts: the wrapper pads the parts with zeros, at both precisions
    for n in (36, 34):
        odd_n = _zoom_args(dev, 1, 1, n, 64, 16)
        for prec in ("high", "highest"):
            assert _rel(zoom_dft.fused_exp_zoom(*odd_n, precision=prec),
                        zoom_dft.fused_exp_zoom_reference(
                            *odd_n, precision=prec)) <= 2e-6
    # what the kernel refuses: row slices that are no multiple of 32 rows,
    # float64, a view without unit column stride
    with pytest.raises(ValueError, match="row_splits"):
        zoom_dft.fused_exp_zoom(*_zoom_args(dev, 1, 1, 96, 64, 16),
                                row_splits=2, precision="high")
    with pytest.raises(ValueError, match="float32"):
        zoom_dft.fused_exp_zoom(*(x.double() for x in odd_n))
    with pytest.raises(ValueError, match="unit stride"):
        zoom_dft.fused_exp_zoom(
            torch.rand((2, 3, 128, 640), device=dev)[..., ::2], *args[1:],
            precision="high")


def test_zoom_kernel_takes_a_strided_view(dev):
    """The blue sub-window is a view of the structure function: the kernel
    reads it through its strides, without a copy."""
    dphi, dl, a2, alpha, w = _zoom_args(dev, 2, 3, 256, 384, 32)
    view = dphi[..., 64:192, 64:]                       # (2, 3, 128, 320)
    assert not view.is_contiguous()
    args = (view, dl[64:192, 64:].contiguous(), a2[..., 64:192].contiguous(),
            alpha, w)
    got = zoom_dft.fused_exp_zoom(*args, row_splits=2)
    want = zoom_dft.fused_exp_zoom_reference(view.contiguous(), *args[1:],
                                             row_splits=2)
    assert _rel(got, want) <= 2e-6
    # a view one column in: its rows are not 16-byte aligned, so the body
    # reads D from device memory
    odd = (dphi[..., 64:192, 65:], dl[64:192, 65:].contiguous(), *args[2:])
    got = zoom_dft.fused_exp_zoom(*odd)
    want = zoom_dft.fused_exp_zoom_reference(odd[0].contiguous(), *odd[1:])
    assert _rel(got, want) <= 2e-6


@pytest.mark.parametrize("R", [1, 2])
def test_tc_disc_kernel_matches_plain_high(dev, R):
    """K5 at "high": the live-row table as the tensor-core body's K-loop
    bounds, against its 3-pass plain version and the "high" K1 on dl
    zeroed outside the live rows."""
    from muse_psfr_tpu_torch.ops.zoom_dft import disc_live_rows
    args = _zoom_args(dev, 2, 9, 512, 256, 170)
    mask = np.array([[0, 1, 1, 0], [0, 0, 1, 1]], np.int32)
    before = _build.launch_counts()
    got = zoom_dft.fused_exp_zoom_disc(*args, mask, exp2=True, row_splits=R,
                                       precision="high")
    after = _build.launch_counts()
    assert after == dict(before, zoom_dft_tc_disc=before["zoom_dft_tc_disc"]
                         + 1)
    assert _rel(got, zoom_dft.fused_exp_zoom_disc_reference(
        *args, mask, exp2=True, row_splits=R, precision="high")) <= 2e-6
    live = torch.as_tensor(disc_live_rows(mask, 512, 256), device=dev)
    rows = torch.arange(512, device=dev)[:, None]
    tiles = live[torch.arange(256, device=dev) // 64]
    keep = (rows >= tiles[:, 0]) & (rows < tiles[:, 1])
    k1 = zoom_dft.fused_exp_zoom(args[0], args[1] * keep, *args[2:],
                                 exp2=True, row_splits=R, precision="high")
    assert _rel(got, k1) <= 2e-6


@pytest.mark.parametrize("R", [1, 2])
def test_disc_kernel_matches_plain(dev, R):
    """K5 with ragged live ranges (a tile with a one-sided range, a fully
    dead tile, 200 columns so the last 64-column tile is partial): against
    its plain version, and against K1 on dl zeroed outside the live rows;
    counted on its own counter only."""
    from muse_psfr_tpu_torch.ops.zoom_dft import disc_live_rows
    args = _zoom_args(dev, 2, 9, 512, 256, 170)
    mask = np.array([[0, 1, 1, 0], [0, 0, 1, 1]], np.int32)
    before = _build.launch_counts()
    got = zoom_dft.fused_exp_zoom_disc(*args, mask, exp2=True, row_splits=R)
    after = _build.launch_counts()
    assert after["zoom_dft_disc"] == before["zoom_dft_disc"] + 1
    assert {k: v for k, v in after.items() if k != "zoom_dft_disc"} == \
        {k: v for k, v in before.items() if k != "zoom_dft_disc"}
    assert _rel(got, zoom_dft.fused_exp_zoom_disc_reference(
        *args, mask, exp2=True, row_splits=R)) <= 2e-6
    live = torch.as_tensor(disc_live_rows(mask, 512, 256), device=dev)
    rows = torch.arange(512, device=dev)[:, None]
    tiles = live[torch.arange(256, device=dev) // 64]
    keep = (rows >= tiles[:, 0]) & (rows < tiles[:, 1])
    k1 = zoom_dft.fused_exp_zoom(args[0], args[1] * keep, *args[2:],
                                 exp2=True, row_splits=R)
    assert _rel(got, k1) <= 2e-6


def _anchor_args(dev, B, ndir, n, ncols, m2, nl, k, deg, pad=0, seed=4):
    """K6's operands (dphi with ``pad`` more columns, for views) as the
    tests below build them: D - centre >= 0 as for a structure function
    and its centre value, deep enough that the anchor exponential
    underflows in places; Taylor coefficients of a MUSE-like alpha
    spread."""
    from math import factorial
    g = torch.Generator(device="cpu").manual_seed(seed)
    dphi = torch.rand((B, ndir, n, ncols + pad), generator=g) * 1000
    dl = torch.rand((n, ncols), generator=g)
    a2 = torch.randn((nl, m2, n), generator=g) / n
    centre = dphi.amin(dim=(2, 3)).contiguous()
    alpha = -0.1 * (1.0 + 0.5 * torch.linspace(0, 1, nl))
    astar = torch.stack([0.5 * (alpha[i:i + k].min() + alpha[i:i + k].max())
                         for i in range(0, nl, k)])
    rho1 = alpha / torch.repeat_interleave(astar, k)[:nl] - 1.0
    coef = torch.stack([rho1 ** j / factorial(j) for j in range(deg + 1)],
                       dim=1) / ndir
    return [x.to(dev) for x in (dphi, dl, a2, centre, astar, coef)]


def _anchor_envelope(dev, ndir, precision):
    """K6 at the edges of what it takes, against its plain version at
    ``precision``: groups of 8 at degree 11 (the caps) on 250 contraction
    rows (not a multiple of 8: A2's parts are padded), 35 wavelengths in 5
    groups of 7 on 1000 rows (the planner's groups, the last step partial),
    and D as a strided view, 16-byte aligned (staged by TMA) and not
    (read from device memory); each bit-identical on a rerun."""
    for n, nl, k, deg in ((250, 16, 8, 11), (1000, 35, 7, 8)):
        args = _anchor_args(dev, 1, ndir, n, 72, 160, nl, k, deg, pad=8)
        for view in (args[0][..., :72], args[0][..., 4:76],
                     args[0][..., 1:73]):
            a6 = [view] + args[1:] + [k]
            got = zoom_dft.fused_exp_zoom_anchor(*a6, precision=precision)
            want = zoom_dft.fused_exp_zoom_anchor_reference(
                view.contiguous(), *args[1:], k, precision=precision)
            assert _rel(got, want) <= (2e-6 if precision == "high"
                                       else 1e-6), (n, k, deg)
            assert torch.equal(got, zoom_dft.fused_exp_zoom_anchor(
                *a6, precision=precision))


@pytest.mark.parametrize("ndir", [1, 9])
def test_anchor_kernel_matches_plain(dev, ndir):
    """K6 at "highest" (six passes) on 10 wavelengths in groups of 4 (the
    last one ragged), degree 8, with Taylor coefficients of a MUSE-like
    alpha spread, 200 output rows (two row blocks) and 200 columns (a
    partial column tile); a group of 8, the cap, fits its shared memory;
    bit-identical on a rerun; and the envelope (:func:`_anchor_envelope`)."""
    B, n, ncols, m2, nl, k, deg = 2, 256, 200, 200, 10, 4, 8
    args = _anchor_args(dev, B, ndir, n, ncols, m2, nl, k, deg)
    before = zoom_dft.ANCHOR_LAUNCHES
    got = zoom_dft.fused_exp_zoom_anchor(*args, k)
    assert zoom_dft.ANCHOR_LAUNCHES == before + 1
    assert _rel(got, zoom_dft.fused_exp_zoom_anchor_reference(*args, k)) \
        <= 2e-6
    assert torch.equal(got, zoom_dft.fused_exp_zoom_anchor(*args, k))
    astar8 = torch.stack([args[4][0], args[4][-1]])
    for prec in ("highest", "high"):
        got8 = zoom_dft.fused_exp_zoom_anchor(*args[:4], astar8, args[5], 8,
                                              precision=prec)
        assert _rel(got8, zoom_dft.fused_exp_zoom_anchor_reference(
            *args[:4], astar8, args[5], 8, precision=prec)) <= 2e-6
    with pytest.raises(ValueError, match="at most"):
        zoom_dft.fused_exp_zoom_anchor(*args[:4], args[4][:2], args[5], 9)
    _anchor_envelope(dev, ndir, "highest")


@pytest.mark.parametrize("ndir", [1, 9])
def test_tc_anchor_kernel_matches_plain_high(dev, ndir):
    """K6 at "high" on tensor cores, on the inputs of the float32 test
    (groups of 4 with a ragged last one, two 160-row blocks, a partial
    16-column tile) and on a strided view: against its 3-pass plain version
    <= 2e-6 of max|U|, against K6 at "highest" <= 2e-5 (the split's own error
    on these cancelling random inputs); counted on its own counter only;
    bit-identical on a rerun; and the envelope (:func:`_anchor_envelope`)."""
    B, n, ncols, m2, nl, k, deg = 2, 256, 200, 200, 10, 4, 8
    args = _anchor_args(dev, B, ndir, n, ncols, m2, nl, k, deg, pad=8)
    for view in (args[0][..., :ncols].contiguous(), args[0][..., 8:]):
        a6 = [view] + args[1:]
        before = _build.launch_counts()
        got = zoom_dft.fused_exp_zoom_anchor(*a6, k, precision="high")
        assert _build.launch_counts() == dict(
            before, zoom_dft_tc_anchor=before["zoom_dft_tc_anchor"] + 1)
        assert _rel(got, zoom_dft.fused_exp_zoom_anchor_reference(
            view.contiguous(), *args[1:], k, precision="high")) <= 2e-6
        assert _rel(got, zoom_dft.fused_exp_zoom_anchor(*a6, k)) <= 2e-5
        assert torch.equal(got, zoom_dft.fused_exp_zoom_anchor(
            *a6, k, precision="high"))
    with pytest.raises(ValueError, match="at most"):
        zoom_dft.fused_exp_zoom_anchor(*args[:4], args[4][:2], args[5], 9,
                                       precision="high")
    _anchor_envelope(dev, ndir, "high")


@pytest.mark.parametrize("B,nl,n", [(2, 3, 8), (3, 35, 40)])
def test_conv_kernel_matches_plain(dev, B, nl, n):
    g = torch.Generator(device="cpu").manual_seed(1)
    L = _same_fft_size(n, n + 1)
    args = [torch.rand(s, generator=g).to(dev)
            for s in ((B, nl, n, n), (B, L, L), (B, L, L), (nl, L, L),
                      (nl, L, L))]
    before = conv_dft.LAUNCHES
    got = conv_dft.fused_conv_chain(*args, n + 1)
    assert conv_dft.LAUNCHES == before + 1
    assert _rel(got, conv_dft.fused_conv_chain_reference(*args,
                                                         n + 1)) <= 1e-6


def test_night_runs_both_kernels(dev):
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    _build.reset_launch_counts()
    cfg = TINY_CONFIG.with_(use_fft=False)
    args = ([1.0, 0.8, 1.3], [0.7, 0.5, 0.4], [25.0, 14.0, 2.0],
            np.ones((3, 4)), [750.0, 900.0])
    fit, psf_mean, _ = process_batch(*args, cfg=cfg, chunk=2, device="cuda")
    counts = _build.launch_counts()
    # 2 rows x 2 wavelengths of TINY fill 16 blocks: the zoom runs as K3,
    # with the three passes of the default zoom_precision "high"; the third
    # row (L0 = 2.0 m < 2.5) is the exact structure-function group, which
    # contracts at six passes on the card (otf/psf.py:_zoom_precision):
    # one six-pass K3 launch of its own
    assert counts["zoom_dft_tc_rowsplit"] > 0 and counts["conv_dft"] > 0
    assert counts["zoom_dft"] == 0 and counts["zoom_dft_rowsplit"] == 1
    ref = process_batch(*args, cfg=cfg, chunk=2, device="cpu")
    assert np.abs(psf_mean - ref[1]).max() <= 1e-5 * np.abs(ref[1]).max()
    assert np.all(fit[..., -1] == 1.0)


def test_two_shard_mesh_night_matches_the_single_device_night(dev):
    """A small dim-512 night with both support buckets over the mesh
    ``["cuda:0", "cuda:0"]``: within the JAX package's mesh limits of the
    night without a mesh (fits 1e-4, mean PSF 1e-6), each shard launching
    the zoom kernel."""
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    from muse_psfr_tpu_torch.parallel.mesh import default_mesh
    cfg = GalacsiConfig(dim=512, dim_pup=24, dimpsf=12, use_fft=False)
    tel = ([1.0, 0.2, 1.3, 0.25, 1.1, 0.22, 1.2, 0.3],
           [0.7, 0.01, 0.5, 0.02, 0.6, 0.015, 0.65, 0.03],
           [25.0, 30.0, 18.0, 29.0, 22.0, 28.0, 24.0, 27.0],
           np.ones((8, 4)), [750.0, 930.0])
    want = process_batch(*tel, cfg=cfg, chunk=8, device="cuda")
    _build.reset_launch_counts()
    got = process_batch(*tel, cfg=cfg, chunk=8, device="cuda",
                        mesh=default_mesh(["cuda:0", "cuda:0"]))
    counts = _build.launch_counts()
    assert counts["zoom_dft_tc"] + counts["zoom_dft_tc_rowsplit"] >= 2
    for g, w, atol in zip(got, want, (1e-4, 1e-6, 1e-4)):
        assert np.abs(g - w).max() <= atol


@pytest.mark.parametrize("use_fft", [False, True])
def test_graph_night_is_bit_equal_to_the_eager_night(dev, use_fft):
    """A dim-512 night with both support buckets, chunks of 2 rows: its
    programs (``parallel/programs.py``) run eagerly at their first
    dispatch, are captured at their second and replayed after; both graph
    nights equal the eager night (``_graphs=False``) bit for bit, and a
    night of replays counts the eager night's launches."""
    from muse_psfr_tpu_torch.config import GalacsiConfig
    from muse_psfr_tpu_torch.parallel import programs
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    cfg = GalacsiConfig(dim=512, dim_pup=24, dimpsf=12, use_fft=use_fft)
    tel = ([1.0, 0.2, 1.3, 0.25, 1.1, 0.22, 1.2, 0.3],
           [0.7, 0.01, 0.5, 0.02, 0.6, 0.015, 0.65, 0.03],
           [25.0, 30.0, 18.0, 29.0, 22.0, 28.0, 24.0, 27.0],
           np.ones((8, 4)), [750.0, 930.0])
    programs.clear()
    _build.reset_launch_counts()
    eager = process_batch(*tel, cfg=cfg, chunk=2, device="cuda",
                          _graphs=False)
    want = _build.launch_counts()
    assert not programs._PROGRAMS
    first = process_batch(*tel, cfg=cfg, chunk=2, device="cuda")
    assert programs.programs()
    _build.reset_launch_counts()
    replayed = process_batch(*tel, cfg=cfg, chunk=2, device="cuda")
    assert _build.launch_counts() == want
    assert all(p.replays >= 1 for p in programs.programs())
    for got in (first, replayed):
        for g, w in zip(got, eager):
            assert np.array_equal(g, w)


def test_anchored_night_runs_k6(dev):
    """zoom_anchor="on" forced at TINY, npsflin=2: K6 runs at the night's
    zoom_precision and the night matches the CPU run of the same config."""
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    cfg = TINY_CONFIG.with_(use_fft=False, zoom_anchor="on")
    args = ([1.0, 0.8], [0.7, 0.5], [25.0, 14.0], np.ones((2, 4)),
            [750.0, 800.0, 900.0])
    _build.reset_launch_counts()
    _, psf_mean, _ = process_batch(*args, npsflin=2, cfg=cfg, chunk=2,
                                   device="cuda")
    counts = _build.launch_counts()
    assert counts["zoom_dft_tc_anchor"] > 0 and counts["zoom_dft_anchor"] == 0
    ref = process_batch(*args, npsflin=2, cfg=cfg, chunk=2, device="cpu")
    assert np.abs(psf_mean - ref[1]).max() <= 1e-5 * np.abs(ref[1]).max()


@pytest.mark.parametrize("B,nl,n,nk", [(2, 3, 8, 9), (3, 2, 9, 9),
                                       (1, 5, 24, 25), (3, 35, 40, 41),
                                       (2, 4, 64, 1), (10, 35, 40, 41)])
def test_conv_high_kernel_matches_plain(dev, B, nl, n, nk):
    """K2 at "high" (the wgmma body) on its own counter, odd and padded
    plane sides, up to the largest transform, and with more planes than
    the persistent grid has warpgroups (10 x 35), so that each walks
    several.  The kernel and the plain version form the same
    three exact products per step and sum them in different float32 orders
    (an mma truncates inside its sum); every intermediate is split anew,
    and a split moves by up to 2^-17 of an operand that moved by one
    rounding, so two orders of this arithmetic lie as far apart as each
    lies from float64 (~1e-5 of max|out| at worst over these shapes).
    Limit 3e-5, and the kernel no further from float64 than 1.5x the plain
    version; bit-identical on a rerun."""
    g = torch.Generator(device="cpu").manual_seed(1)
    L = _same_fft_size(n, nk)
    from muse_psfr_tpu_torch.otf.convolve import _dft_spectra
    planes = torch.rand((B, nl, n, n), generator=g).to(dev)
    ktt = torch.rand((B, nk, nk), generator=g).to(dev)
    ki = torch.rand((nl, nk, nk), generator=g).to(dev)
    spectra = [x.contiguous() for k in (ktt, ki) for x in _dft_spectra(k, L)]
    before = _build.launch_counts()
    got = conv_dft.fused_conv_chain(planes, *spectra, nk, precision="high")
    assert _build.launch_counts() == dict(
        before, conv_dft_tc=before["conv_dft_tc"] + 1)
    want = conv_dft.fused_conv_chain_reference(planes, *spectra, nk,
                                               precision="high")
    assert _rel(got, want) <= 3e-5
    w64 = conv_dft.fused_conv_chain_reference(
        planes.double(), *(x.contiguous() for k in (ktt, ki)
                           for x in _dft_spectra(k.double(), L)), nk)
    assert _rel(got, w64) <= 3e-5
    assert _rel(got, w64) <= 1.5 * _rel(want, w64) + 1e-6
    assert torch.equal(got, conv_dft.fused_conv_chain(
        planes, *spectra, nk, precision="high"))
    with pytest.raises(ValueError, match="conv precision"):
        conv_dft.fused_conv_chain(planes, *spectra, nk, precision="default")
    with pytest.raises(ValueError):
        conv_dft.fused_conv_chain(planes.double(), *spectra, nk,
                                  precision="high")


def test_conv_high_kernel_is_the_same_on_any_grid(dev):
    """Each (row, plane) is computed by one warpgroup alone, in a fixed
    order of sums: one block walking all 70 items gives what the launch
    plan's grid gives, bit for bit.  The package's library has no entry
    point of the mma.sync body."""
    g = torch.Generator(device="cpu").manual_seed(3)
    B, nl, n, nk = 2, 35, 40, 41
    L = _same_fft_size(n, nk)
    from muse_psfr_tpu_torch.otf.convolve import _dft_mats, _dft_spectra
    planes = torch.rand((B, nl, n, n), generator=g).to(dev)
    spectra = [x.contiguous() for k in (torch.rand((B, nk, nk), generator=g),
                                        torch.rand((nl, nk, nk), generator=g))
               for x in _dft_spectra(k.to(dev), L)]
    want = conv_dft.fused_conv_chain(planes, *spectra, nk, precision="high")
    c, s = _dft_mats(L, dev, torch.float32)
    lib = _build.library()
    for blocks in (1, 7):
        out = torch.empty_like(planes)
        err = lib.muse_fused_conv_chain_tc(
            *(x.data_ptr() for x in (planes, *spectra, c, s, out)), B, nl, n,
            L, (nk - 1) // 2, blocks, torch.cuda.current_stream().cuda_stream)
        assert err == 0
        assert torch.equal(out, want)
    assert not hasattr(lib, "muse_fused_conv_chain_tc_mma")


def test_night_at_conv_high_runs_only_the_tensor_core_k2(dev):
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    cfg = TINY_CONFIG.with_(use_fft=False)
    args = ([1.0, 0.8, 1.3], [0.7, 0.5, 0.4], [25.0, 14.0, 2.0],
            np.ones((3, 4)), [750.0, 900.0])
    top = process_batch(*args, cfg=cfg, chunk=2, device="cuda")
    _build.reset_launch_counts()
    fit, psf_mean, _ = process_batch(
        *args, cfg=cfg.with_(conv_precision="high"), chunk=2, device="cuda")
    counts = _build.launch_counts()
    assert counts["conv_dft_tc"] > 0 and counts["conv_dft"] == 0
    assert np.abs(psf_mean - top[1]).max() <= 2e-5 * np.abs(top[1]).max()
    assert np.all(fit[..., -1] == 1.0)
    with pytest.raises(ValueError, match="conv precision"):
        process_batch(*args, cfg=cfg.with_(conv_precision="default"),
                      chunk=2, device="cuda")
    # the plain route takes all three tiers
    plain = cfg.with_(use_fused_conv=False)
    for tier in ("high", "default"):
        _build.reset_launch_counts()
        got = process_batch(*args, cfg=plain.with_(conv_precision=tier),
                            chunk=2, device="cuda")
        assert _build.launch_counts()["conv_dft_tc"] == 0
        assert np.isfinite(got[1]).all()


@pytest.mark.parametrize("tier,limit", [("high", 5e-5), ("default", 0.1)])
def test_night_at_a_lower_matmul_tier(dev, tier, limit):
    from muse_psfr_tpu_torch.parallel.batch import process_batch
    cfg = TINY_CONFIG.with_(use_fft=False)
    args = ([1.0, 0.8, 1.3], [0.7, 0.5, 0.4], [25.0, 14.0, 2.0],
            np.ones((3, 4)), [750.0, 900.0])
    top = process_batch(*args, cfg=cfg, chunk=2, device="cuda")
    got = process_batch(*args, cfg=cfg.with_(matmul_precision=tier), chunk=2,
                        device="cuda")
    rel = np.abs(got[1] - top[1]).max() / np.abs(top[1]).max()
    assert 0 < rel <= limit


def test_matmul_tier_on_the_card(dev):
    g = torch.Generator(device="cpu").manual_seed(2)
    a = torch.randn((3, 48, 200), generator=g)
    b = torch.randn((200, 56), generator=g)
    scale = a.double().abs() @ b.double().abs()
    for tier, bound in (("highest", 2.0 ** -20), ("high", 2.0 ** -15),
                        ("default", 2.0 ** -7)):
        got = zoom_dft.matmul_tier(a.to(dev), b.to(dev), tier)
        assert got.dtype == torch.float32
        err = (got.cpu().double() - a.double() @ b.double()).abs()
        assert (err <= bound * scale).all()


def test_compat_on_the_card_matches_the_cpu(dev):
    """The float64 shim launches no kernel and agrees with its CPU run to
    <= 1e-10 relative."""
    import muse_psfr_tpu_torch.compat as compat
    lb = np.array([500.0, 700.0, 900.0])
    _build.reset_launch_counts()
    out = {}
    for device in ("cuda", "cpu"):
        psd = compat.simul_psd_wfm([0.7, 0.3], (100, 10000), 1.0, 25.0,
                                   dim=320, npsflin=2, verbose=False,
                                   device=device)
        cube = compat.psf_muse(psd, lb, device=device)
        final = compat.convolve_final_psf(lb, 1.0, 0.7, 25.0, cube,
                                          device=device)
        tbl = compat.fit_psf_cube(lb, final, device=device)
        out[device] = (psd, cube, final, np.asarray(tbl["fwhm"], float),
                       np.asarray(tbl["n"], float))
    assert set(_build.launch_counts().values()) == {0}
    for got, want in zip(out["cuda"], out["cpu"]):
        assert got.dtype == np.float64
        assert np.abs(got - want).max() <= 1e-10 * np.abs(want).max()
