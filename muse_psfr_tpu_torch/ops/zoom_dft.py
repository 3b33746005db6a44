"""K1, K3, K5 and K6: fused direction-averaged OTF x zoom-DFT stage 1.

Per telemetry row ``b`` and wavelength ``l`` of a chunk,

    G_{b,l} = sum_d exp(alpha_l * Dphi_{b,d}) * w_{b,l,d} * dl
    U_{b,l} = A2_l @ G_{b,l}

with Dphi the wavelength-free structure function per evaluation direction
(under the symmetry fold (N, ncols) = (1280, 768) at production), dl the
diffraction OTF slab, A2_l the stacked [Ar; Ai] zoom-DFT rows of
wavelength l's crop grid and w the per-direction DC weights.

:func:`fused_exp_zoom` launches the hand-written CUDA kernels
(``csrc/zoom_dft_tc.cu``; counterpart of
``muse_psfr_tpu/ops/zoom_dft.py:fused_exp_zoom``) for CUDA tensors, which
never write G to device memory; for CPU tensors it runs
:func:`fused_exp_zoom_reference`, the plain PyTorch version.  Every
direction is summed per element in registers, which is what the TPU's
direction-block bodies (``_kernel``, ``_kernel_dirblock``,
``_kernel_dirfull``) compute for any ``dir_block``.  ``row_splits=R > 1``
is K3 (``_kernel_rowacc``): the contraction rows in R slices whose partial
products are summed in the fixed order r = 0..R-1.

:func:`fused_exp_zoom_disc` (K5, ``cfg.disc_skip``) is K1 with the dead
blocks of the diffraction OTF skipped: each 64-column tile contracts only
its live rows, from a table the wrapper derives from the 128 x 128 block
mask, in the same launch.  :func:`fused_exp_zoom_anchor` (K6,
``cfg.zoom_anchor``) evaluates the damping of a group of wavelengths from
shared power sums of one anchor exponential.

``precision`` (``cfg.zoom_precision``) chooses the contraction of every
one of them, as ``_mxu_contract`` does on the TPU, and both run on tensor
cores in one body (``csrc/zoom_dft_tc.cu``, warpgroup products fed by
TMA in the launch plan of :func:`tc_launch_plan`; K6
``csrc/zoom_anchor_tc.cu``): "high" is the 3-pass bf16 split
``a_hi@g_hi + a_hi@g_lo + a_lo@g_hi`` with float32 accumulation;
"highest" is the TPU's ``Precision.HIGHEST``, six bf16 passes on a
three-part split (:func:`six_pass_product`), a float32-grade product.
Either way the kernels sum per :data:`K_STEP` contraction rows and then
over the steps, and so do the plain versions (:func:`contract`).
"""

from typing import NamedTuple

import numpy as np
import torch

from . import _build
from ..config import MATMUL_PRECISIONS, ZOOM_PRECISIONS
from ..utils.device import host_const

#: successful launches of the six-pass body ("highest") with one row slice
#: (K1), with R > 1 row slices and the ordered sum of their partials (K3),
#: with the diffraction-disc skip (K5, any R); of the three-pass body
#: ("high") in the same three forms; and of the anchored-Taylor kernel
#: (K6) with six passes ("highest") and with three ("high"); see
#: ops/_build.py
LAUNCHES = 0
ROWSPLIT_LAUNCHES = 0
DISC_LAUNCHES = 0
TC_LAUNCHES = 0
TC_ROWSPLIT_LAUNCHES = 0
TC_DISC_LAUNCHES = 0
ANCHOR_LAUNCHES = 0
TC_ANCHOR_LAUNCHES = 0

#: A2 rows of one CUDA block and output columns of one consumer
#: warpgroup (``TI``/``TJ`` of csrc/zoom_dft_tc.cu)
M_TILE, N_TILE = 160, 64
#: contraction rows per step of the kernels (``KS``)
K_STEP = 32
#: the launch plan's limits (csrc/zoom_dft_tc.cu): consumer warpgroups a
#: block, stages of the TMA ring, a block's shared memory on Hopper (of
#: which the barriers take 8 bytes a stage twice) and the slack that
#: aligns the stages to 1024 bytes
MAX_WARPGROUPS, MAX_STAGES = 2, 4
SMEM_LIMIT, SMEM_BARRIERS, SMEM_SLACK = 232448, 16 * 4, 1024

#: K6 limits (``KB``/``DMAX`` of csrc/zoom_anchor_tc.cu): wavelengths per
#: group, whose A2 tiles a block stages together, and Taylor degree
ANCHOR_MAX_GROUP, ANCHOR_MAX_DEGREE = 8, 11

_LOG2E = float(np.log2(np.e))


def check_precision(precision):
    if precision not in ZOOM_PRECISIONS:
        raise ValueError(f"unsupported zoom precision {precision!r}, "
                         f"expected one of {ZOOM_PRECISIONS}; one bf16 pass "
                         "is outside the accuracy budget")


def split_bf16(x, parts=2):
    """The bf16 split of ``x`` in ``parts`` parts: ``p0 = bf16(x)``,
    ``p1 = bf16(x - p0)``, ``p2 = bf16(x - p0 - p1)`` (round to nearest
    even, as the kernels' ``__float2bfloat16_rn``), with every later part 0
    where ``p0`` is infinite, so that no NaN is made.  Two parts are the
    3-pass split of "high" (16 significant bits); three carry 3 x 8 = 24,
    so they sum back to a float32 ``x`` bit for bit as long as the last
    part stays in the normal range (below it, it is a subnormal bf16
    value or zero: a loss under 2^-126)."""
    out = [x.to(torch.bfloat16)]
    rest = torch.where(torch.isinf(out[0]), torch.zeros_like(x),
                       x - out[0].to(x.dtype))
    for _ in range(parts - 1):
        out.append(rest.to(torch.bfloat16))
        rest = rest - out[-1].to(x.dtype)
    return tuple(out)


def six_pass_product(a, g):
    """``a @ g`` as the "highest" kernels form it within one step of at
    most :data:`K_STEP` contraction rows (``Precision.HIGHEST`` on the
    TPU's matrix unit): the three-part bf16 split of both operands and the
    six products of order up to two, the five small ones summed first,
    ``(a0@g2 + a1@g1 + a2@g0 + a0@g1 + a1@g0) + a0@g0``, each product
    exact in float32 and the sums in float32.  The dropped terms are
    ~2^-24 relative.  It documents the kernel's arithmetic for the tests
    and for ``chip_smoke.py``; :func:`contract` does not call it."""
    a0, a1, a2 = (p.to(g.dtype) for p in split_bf16(a, 3))
    g0, g1, g2 = (p.to(g.dtype) for p in split_bf16(g, 3))
    small = (torch.matmul(a0, g2) + torch.matmul(a1, g1)
             + torch.matmul(a2, g0) + torch.matmul(a0, g1)
             + torch.matmul(a1, g0))
    return torch.matmul(a0, g0) + small


def contract(a2, g, precision="highest"):
    """``a2 @ g`` at ``precision``, in the kernels' order of sums: the
    product of each :data:`K_STEP` contraction rows, then a running
    float32 sum over the steps.  Within a step "high" is the sum
    ``a_hi@g_hi + a_hi@g_lo + a_lo@g_hi`` of three matmuls of bf16 values
    (``_mxu_contract`` of the JAX package), whose products are exact in
    float32, so it is the tensor-core kernel's arithmetic up to the order
    of the float32 sums; "highest" is one float32 matmul of the step's 32
    rows.  The kernel's six passes (:func:`six_pass_product`) drop only
    ~2^-24 per product, so the cheaper matmul can stand for them: on the
    worst row of the full-window chunk (35 wavelengths, 1280 x 768) the
    kernel lies 4.1e-08 of max|U| from the six-pass product per step and
    2.5e-07 from this matmul per step, and all three 3.7e-07 from float64
    (NVIDIA H100 80GB HBM3, 700.00 W, ``chip_smoke.py``); the kernels are
    held to 1e-6 of max|U| from this function.

    The steps are there because one float32 matmul over all 1280 rows of
    the production window lies up to ~7e-6 of max|U| from the exact sum
    of its products (same card; so did the float32 FMA kernel that summed
    in that order: 6.6e-06 from float64), more than the kernels are held
    to, while the stepped sums lie within ~5e-7 of it.  The float32 CPU
    chunk runs this too, so a CPU night and the card's night at "highest"
    sum alike.  Operands of another type (float64: CPU only, no kernel
    takes it) contract at "highest" in one matmul, as the JAX package's
    float64 night does: there the order of the sums is far below anything
    compared.
    """
    high = precision == "high"
    if not high and g.dtype != torch.float32:
        return torch.matmul(a2, g)
    if high:
        a_hi, a_lo = split_bf16(a2)
        g_hi, g_lo = split_bf16(g)
    u = None
    for k in range(0, g.shape[-2], K_STEP):
        if high:
            ah, al = (p[..., k:k + K_STEP].to(g.dtype) for p in (a_hi, a_lo))
            gh, gl = (p[..., k:k + K_STEP, :].to(g.dtype)
                      for p in (g_hi, g_lo))
            part = (torch.matmul(ah, gh) + torch.matmul(ah, gl)
                    + torch.matmul(al, gh))
        else:
            part = torch.matmul(a2[..., k:k + K_STEP],
                                g[..., k:k + K_STEP, :])
        u = part if u is None else u + part
    return u


def matmul_tier(a, b, precision="highest"):
    """``a @ b`` at a tier of ``cfg.matmul_precision``/``cfg.conv_precision``
    (``jnp.matmul(precision=...)`` of the JAX package on the TPU), for the
    plain large products around the kernels: "highest" is one float32
    matmul (TF32 off, ``utils/device.py``); "high" the three products
    ``a_hi@b_hi + a_hi@b_lo + a_lo@b_hi`` of the bf16 split
    (:func:`split_bf16`); "default" the one product ``a_hi@b_hi``.

    The bf16 parts are multiplied as float32 tensors: a matmul of two
    bf16 tensors returns bf16, which would round every sum to 8 bits and
    wreck the split, while a float32 matmul of bf16-valued operands forms
    each product exactly and sums in float32 on any device and PyTorch
    version.  The price is that nothing here runs on the tensor cores:
    "high" costs three float32 matmuls where "highest" costs one, and
    "default" costs as much as "highest"; the tiers reproduce the JAX
    package's arithmetic, not its pass counts.  Unlike :func:`contract`
    the sum runs over the whole contraction at once, as XLA's dot does.
    Operands of another type than float32 contract in one matmul."""
    if precision not in MATMUL_PRECISIONS:
        raise ValueError(f"unsupported matmul precision {precision!r}, "
                         f"expected one of {MATMUL_PRECISIONS}")
    if precision == "highest" or a.dtype != torch.float32:
        return torch.matmul(a, b)
    a_hi, a_lo = (p.to(a.dtype) for p in split_bf16(a))
    b_hi, b_lo = (p.to(b.dtype) for p in split_bf16(b))
    if precision == "default":
        return torch.matmul(a_hi, b_hi)
    return (torch.matmul(a_hi, b_hi) + torch.matmul(a_hi, b_lo)
            + torch.matmul(a_lo, b_hi))


def damped_otf(dphi, dl, alpha, w, exp2=False):
    """G of the module docstring, (B, nl, N, ncols): the damping summed
    over the directions in their order, times dl, with the roundings the
    kernels repeat (a product, then a sum; no fused multiply-add)."""
    if exp2:
        al = (alpha * _LOG2E)[None, :, None, None]
        lw = torch.log2(w)
    g = None
    for d in range(dphi.shape[1]):
        x = dphi[:, d, None]                              # (B, 1, N, ncols)
        if exp2:
            c = torch.exp2(al * x + lw[:, :, d, None, None])
        else:
            c = (torch.exp(alpha[None, :, None, None] * x)
                 * w[:, :, d, None, None])
        g = c if g is None else g + c                     # (B, nl, N, ncols)
    return g * dl


def fused_exp_zoom_reference(dphi, dl, a2, alpha, w, exp2=False,
                             row_splits=1, precision="highest"):
    """Plain PyTorch K1/K3: ``U[b, l] = A2[l] @ (sum_d exp(alpha[l] *
    D[b, d]) * w[b, l, d] * dl)``.

    dphi (B, ndir, N, ncols); dl (N, ncols); a2 (nl, 2M, N); alpha (nl,);
    w (B, nl, ndir).  Returns (B, nl, 2M, ncols).  ``exp2=True`` evaluates
    the damping as ``exp2(alpha*log2(e)*D + log2 w)`` (cfg.zoom_exp2): the
    same math up to argument rounding.  ``row_splits=R`` sums the R
    partial contractions over rows ``[r*N/R, (r+1)*N/R)`` in order, each
    at ``precision`` (:func:`contract`).
    """
    check_precision(precision)
    g = damped_otf(dphi, dl, alpha, w, exp2)
    n = dphi.shape[2]
    _check_splits(n, row_splits)
    h = n // row_splits
    u = None
    for r in range(row_splits):
        part = contract(a2[None, :, :, r * h:(r + 1) * h],
                        g[:, :, r * h:(r + 1) * h], precision)
        u = part if u is None else u + part
    return u


def _check_splits(n, row_splits):
    if row_splits != 1 and (row_splits < 1 or n % row_splits
                            or (n // row_splits) % 32):
        raise ValueError(f"row_splits={row_splits} must divide the {n} "
                         "contraction rows into slices of a multiple of 32")


def _check_rows(name, n, precision):
    """K6 stages A2 by 16-byte copies: rows of 8 bf16 values at "high", of
    4 float32 values at "highest" (K1/K3/K5 pad A2's bf16 parts
    instead, :func:`_a2_parts`)."""
    per = 8 if precision == "high" else 4
    if n % per:
        raise ValueError(f"{name}: the kernel stages A2 in rows of {per} "
                         f"values at {precision!r}; {n} contraction rows "
                         f"are not a multiple of {per}")


class ZoomLaunchPlan(NamedTuple):
    """How ``csrc/zoom_dft_tc.cu`` runs one K1/K3/K5 launch
    (:func:`tc_launch_plan`)."""
    warpgroups: int       # consumer warpgroups a block (64 columns each)
    stages: int           # buffers of the TMA ring
    staged: bool          # D and dl by TMA (else read from device memory)
    stage_bytes: int
    smem: int             # dynamic shared memory a block
    grid: tuple           # (column tiles / warpgroups x A2 blocks x row
    #                       slices, nl, B)
    threads: int          # the consumers and one producer warpgroup
    n_pad: int            # A2's contraction rows, padded to 8
    operands: dict        # {operand: "tma" or "direct"}


def tma_aligned(dphi_ptr, shape, strides, dl_ptr):
    """Whether TMA can stage D (a view of ``shape`` (B, ndir, n, ncols) at
    address ``dphi_ptr`` with element ``strides``, unit column stride) and
    dl (contiguous (n, ncols) at ``dl_ptr``): 16-byte aligned bases and
    row, direction and batch strides; a dimension of size 1 may carry any
    stride (the kernel gives it an aligned one)."""
    B, ndir, n, ncols = shape
    sb, sd, sr = strides[:3]
    used = [sr] + ([sd] if ndir > 1 else []) + ([sb] if B > 1 else [])
    return (dphi_ptr % 16 == 0 and dl_ptr % 16 == 0 and ncols % 4 == 0
            and all(x % 4 == 0 for x in used))


def tc_launch_plan(B, ndir, n, ncols, nl, m2, row_splits=1,
                   precision="high", aligned=True, sm_count=None):
    """The launch plan of K1/K3/K5 (``csrc/zoom_dft_tc.cu``, which checks
    it): each stage of the TMA ring holds the step's A2 parts (2 at
    "high", 3 at "highest": 160 x 32 bf16 each) and, when D is ``aligned``
    for TMA (:func:`tma_aligned`), each consumer warpgroup's 32-row tile
    of D in every direction and of dl (2 x 32 x 32 floats each).  Two
    warpgroups (two 64-column tiles sharing the A2 stages) where their
    stages fit twice in a block's shared memory, else one; else D and dl
    are read from device memory (the direct path) and TMA stages A2
    alone; then as many stages as fit, at most :data:`MAX_STAGES`.  A
    launch whose grid of two-warpgroup blocks would leave some of the
    ``sm_count`` SMs idle takes one warpgroup a block where that fits.
    A2's rows past 160 take more blocks (``m2 > 160`` is tiled)."""
    check_precision(precision)
    parts = 2 if precision == "high" else 3
    a_bytes = parts * M_TILE * K_STEP * 2
    tile = 2 * (ndir + 1) * K_STEP * 32 * 4
    room = SMEM_LIMIT - SMEM_BARRIERS - SMEM_SLACK
    njt, nib = -(-ncols // N_TILE), -(-m2 // M_TILE)

    def blocks(wgs):
        return -(-njt // wgs) * nib * row_splits * nl * B

    many = MAX_WARPGROUPS
    order = ((1, many) if sm_count and blocks(many) < sm_count
             else (many, 1))
    options = ([(w, True) for w in order] if aligned else []) + \
        [(w, False) for w in order]
    for wgs, staged in options:
        stage = a_bytes + (wgs * tile if staged else 0)
        stages = min(MAX_STAGES, room // stage)
        if stages >= 2:
            break
    how = "tma" if staged else "direct"
    return ZoomLaunchPlan(wgs, stages, staged, stage,
                          stages * stage + SMEM_SLACK,
                          (blocks(wgs) // (nl * B), nl, B),
                          128 * (wgs + 1), -(-n // 8) * 8,
                          {"a2": "tma", "dphi": how, "dl": how})


def _a2_parts(a2, parts, n_pad):
    """A2's bf16 parts (:func:`split_bf16`, bit for bit), each (nl, m2,
    n_pad), zero past A2's own rows, made on the card by one launch of
    ``csrc/zoom_dft.cu:split_bf16``: once per launch, never per row in the
    kernel (they depend on the wavelengths only)."""
    nl, m2, n = a2.shape
    out = [torch.empty((nl, m2, n_pad), dtype=torch.bfloat16,
                       device=a2.device) for _ in range(parts)]
    err = _build.library().muse_split_bf16(
        a2.data_ptr(), out[0].data_ptr(), out[1].data_ptr(),
        out[2].data_ptr() if parts == 3 else 0, nl * m2, n, n_pad,
        torch.cuda.current_stream(a2.device).cuda_stream)
    _build.check_launch(err, "split_bf16")
    return out


def _launch(name, dphi, dl, a2, alpha, w, exp2, row_splits, precision,
            live=None):
    """Check the operands and launch K1/K3 (``live`` None) or K5 (``live``
    the (ncols/64, 2) int32 device table of live rows per column tile) on
    the body of ``precision``."""
    B, ndir, n, ncols = dphi.shape
    nl, m2 = a2.shape[0], a2.shape[1]
    check_precision(precision)
    _check_splits(n, row_splits)
    _build.check_operands(name, dphi.device, {
        "dl": (dl, (n, ncols)), "a2": (a2, (nl, m2, n)),
        "alpha": (alpha, (nl,)), "w": (w, (B, nl, ndir))})
    _build.check_operands(name, dphi.device,
                          {"dphi": (dphi, (B, ndir, n, ncols))},
                          unit_stride_only=True)
    if nl > 65535 or B > 65535:
        raise ValueError(f"{name}: grid too large (nl={nl}, B={B})")
    plan = tc_launch_plan(
        B, ndir, n, ncols, nl, m2, row_splits, precision,
        tma_aligned(dphi.data_ptr(), dphi.shape, dphi.stride(),
                    dl.data_ptr()),
        torch.cuda.get_device_properties(dphi.device).multi_processor_count)
    if exp2:
        alpha = alpha * _LOG2E
        w = torch.log2(w)
    u = torch.empty((B, nl, m2, ncols), dtype=torch.float32,
                    device=dphi.device)
    # K3's partial products, one (B, nl, m2, ncols) slab per row slice
    ws = (torch.empty((row_splits,) + tuple(u.shape), dtype=torch.float32,
                      device=dphi.device) if row_splits > 1 else u)
    sb, sd, sr, _ = dphi.stride()
    stream = torch.cuda.current_stream(dphi.device).cuda_stream
    live_ptr = 0 if live is None else live.data_ptr()
    parts = _a2_parts(a2, 2 if precision == "high" else 3, plan.n_pad)
    lib = _build.library()
    entry = (lib.muse_fused_exp_zoom_tc if precision == "high"
             else lib.muse_fused_exp_zoom)
    err = entry(
        dphi.data_ptr(), dl.data_ptr(), *(p.data_ptr() for p in parts),
        alpha.data_ptr(), w.data_ptr(), live_ptr, ws.data_ptr(),
        u.data_ptr(), sb, sd, sr, B, ndir, n, ncols, nl, m2, plan.n_pad,
        row_splits, int(exp2), plan.warpgroups, plan.stages,
        int(plan.staged), stream)
    _build.check_launch(err, name)
    return u


def fused_exp_zoom(dphi, dl, a2, alpha, w, exp2=False, row_splits=1,
                   precision="highest"):
    """K1 (``row_splits=1``) or K3 on the tensors' device: for CUDA
    tensors (float32 only; anything else raises) the tensor-core kernel
    with the three passes of ``precision="high"`` or the six of "highest",
    for CPU tensors :func:`fused_exp_zoom_reference` at ``precision``.
    Shapes as in the reference; every tensor contiguous except ``dphi``,
    which may be any view with unit column stride (the blue sub-window of
    a structure function).  The default "highest" is the JAX function's."""
    global LAUNCHES, ROWSPLIT_LAUNCHES, TC_LAUNCHES, TC_ROWSPLIT_LAUNCHES
    if dphi.device.type == "cpu":
        return fused_exp_zoom_reference(dphi, dl, a2, alpha, w, exp2,
                                        row_splits, precision)
    u = _launch("fused_exp_zoom", dphi, dl, a2, alpha, w, exp2, row_splits,
                precision)
    if precision == "high" and row_splits > 1:
        TC_ROWSPLIT_LAUNCHES += 1
    elif precision == "high":
        TC_LAUNCHES += 1
    elif row_splits > 1:
        ROWSPLIT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return u


# ---- K5: the diffraction-disc skip ---------------------------------------

def disc_column_groups(block_mask, tile_j: int = 128,
                       row_block: int = 128):
    """Column groups of a diffraction-support block mask (the JAX
    package's function of the same name): ``block_mask`` (J, RB), 1 =
    live; per column tile the live row blocks form one contiguous range
    (the disc chord), and a tile whose live blocks are empty or not
    contiguous counts as fully live.  Returns maximal runs of adjacent
    column tiles with the same range as ``(col_lo, col_hi, row_lo,
    row_hi)`` element ranges."""
    mask = np.asarray(block_mask)
    nj, nrb = mask.shape
    ranges = []
    for j in range(nj):
        live = np.flatnonzero(mask[j])
        if live.size and live.size == live[-1] - live[0] + 1:
            ranges.append((int(live[0]), int(live[-1]) + 1))
        else:                       # empty or non-contiguous: full rows
            ranges.append((0, nrb))
    groups = []
    for j, rng in enumerate(ranges):
        if groups and groups[-1][2:] == (rng[0] * row_block,
                                         rng[1] * row_block):
            lo, hi, rlo, rhi = groups[-1]
            groups[-1] = (lo, (j + 1) * tile_j, rlo, rhi)
        else:
            groups.append((j * tile_j, (j + 1) * tile_j,
                           rng[0] * row_block, rng[1] * row_block))
    return groups


def disc_live_rows(block_mask, n: int, ncols: int, tile_j: int = 128,
                   row_block: int = 128):
    """K5's table: (ncols / 64, 2) int32 ``[lo, hi)`` contraction rows of
    each 64-column tile of the kernel (it tiles the columns by
    :data:`N_TILE`), from :func:`disc_column_groups` of the (ncols /
    tile_j, n / row_block) mask."""
    mask = np.asarray(block_mask)
    if (tile_j % N_TILE or ncols % tile_j or n % row_block
            or mask.shape != (ncols // tile_j, n // row_block)):
        raise ValueError(f"block mask of shape {mask.shape} does not tile "
                         f"a ({n}, {ncols}) slab in ({row_block}, "
                         f"{tile_j}) blocks")
    live = np.zeros((ncols // N_TILE, 2), np.int32)
    for col_lo, col_hi, row_lo, row_hi in disc_column_groups(
            mask, tile_j, row_block):
        live[col_lo // N_TILE:col_hi // N_TILE] = (row_lo, row_hi)
    return live


def _live_table(block_mask, n, ncols, device):
    """:func:`disc_live_rows` as an int32 device constant."""
    mask = np.ascontiguousarray(block_mask, dtype=np.int32)
    return host_const(("disc_live", mask.tobytes(), mask.shape, n, ncols),
                      lambda: disc_live_rows(mask, n, ncols), device,
                      torch.int32)


def fused_exp_zoom_disc_reference(dphi, dl, a2, alpha, w, block_mask,
                                  exp2=False, row_splits=1,
                                  precision="highest"):
    """Plain PyTorch K5: :func:`fused_exp_zoom_reference` with ``dl``
    zeroed outside each column tile's live rows
    (:func:`disc_live_rows`), which is the restricted contraction the
    kernel and the JAX package's column groups compute."""
    n, ncols = dl.shape
    live = _live_table(block_mask, n, ncols, dl.device)
    rows = torch.arange(n, device=dl.device)[:, None]
    tiles = live[torch.arange(ncols, device=dl.device) // N_TILE]
    keep = (rows >= tiles[:, 0]) & (rows < tiles[:, 1])  # (n, ncols)
    return fused_exp_zoom_reference(dphi, dl * keep, a2, alpha, w, exp2,
                                    row_splits, precision)


def fused_exp_zoom_disc(dphi, dl, a2, alpha, w, block_mask, exp2=False,
                        row_splits=1, precision="highest"):
    """K5 on the tensors' device: K1's CUDA body of ``precision`` with
    each 64-column tile looping only over its live rows (intersected with
    its K3 row slice when ``row_splits > 1``), in one launch, for CUDA
    tensors; :func:`fused_exp_zoom_disc_reference` for CPU tensors.
    Counterpart of the JAX package's ``fused_exp_zoom_disc``, which runs
    one launch per column group and concatenates; the result matches it
    up to summation order (the skipped blocks hold ``|dl| <= 1e-12`` of
    its peak)."""
    global DISC_LAUNCHES, TC_DISC_LAUNCHES
    if dphi.device.type == "cpu":
        return fused_exp_zoom_disc_reference(dphi, dl, a2, alpha, w,
                                             block_mask, exp2, row_splits,
                                             precision)
    n, ncols = dphi.shape[2], dphi.shape[3]
    live = _live_table(block_mask, n, ncols, dphi.device)
    u = _launch("fused_exp_zoom_disc", dphi, dl, a2, alpha, w, exp2,
                row_splits, precision, live)
    if precision == "high":
        TC_DISC_LAUNCHES += 1
    else:
        DISC_LAUNCHES += 1
    return u


# ---- K6: the anchored-Taylor damping -------------------------------------

def _anchor_shapes(dphi, a2, centre, astar, coef, group):
    B, ndir = dphi.shape[0], dphi.shape[1]
    nl, deg1 = coef.shape
    ng = -(-nl // group) if group >= 1 else 0
    if (group < 1 or a2.shape[0] != nl or tuple(astar.shape) != (ng,)
            or tuple(centre.shape) != (B, ndir)):
        raise ValueError(
            f"fused_exp_zoom_anchor: {nl} wavelengths in groups of {group} "
            f"need astar ({ng},) and centre ({B}, {ndir}); got "
            f"{tuple(astar.shape)}, {tuple(centre.shape)}, a2 "
            f"{tuple(a2.shape)}")
    return nl, deg1


def fused_exp_zoom_anchor_reference(dphi, dl, a2, centre, astar, coef,
                                    group, precision="highest"):
    """Plain PyTorch K6: ``U[b, l] = A2[l] @ ((sum_j coef[l, j] H_j[b]) *
    dl)``, ``H_j[b] = sum_d e^x x^j`` with ``x = astar[g] * (D[b, d] -
    centre[b, d])`` for the group ``g = l // group`` of wavelength l.

    dphi (B, ndir, N, ncols); dl (N, ncols); a2 (nl, 2M, N); centre (B,
    ndir) the values subtracted per (row, direction), so that the JAX
    package's shifted copy of D is never made; astar (ceil(nl/group),);
    coef (nl, degree+1).  Returns (B, nl, 2M, ncols).  The power sums and
    the per-wavelength combination run in the JAX kernel's order; the
    contraction at ``precision`` (:func:`contract`)."""
    check_precision(precision)
    nl, deg1 = _anchor_shapes(dphi, a2, centre, astar, coef, group)
    out = []
    for g, l0 in enumerate(range(0, nl, group)):
        hs = None
        for d in range(dphi.shape[1]):
            x = astar[g] * (dphi[:, d] - centre[:, d, None, None])
            f = torch.exp(x)
            pw = [f]
            for _ in range(deg1 - 1):
                pw.append(pw[-1] * x)
            hs = pw if hs is None else [h + p for h, p in zip(hs, pw)]
        gl = []
        for l in range(l0, min(l0 + group, nl)):
            acc = coef[l, 0] * hs[0]
            for j in range(1, deg1):
                acc = acc + coef[l, j] * hs[j]
            gl.append(acc * dl)
        out.append(contract(a2[l0:l0 + group], torch.stack(gl, dim=1),
                            precision))
    return torch.cat(out, dim=1)


def fused_exp_zoom_anchor(dphi, dl, a2, centre, astar, coef, group,
                          precision="highest"):
    """K6 on the tensors' device: for CUDA tensors (float32 only; groups of
    at most :data:`ANCHOR_MAX_GROUP` wavelengths, degree at most
    :data:`ANCHOR_MAX_DEGREE`; anything else raises) the tensor-core kernel
    (``csrc/zoom_anchor_tc.cu``) with the three passes of
    ``precision="high"`` or the six of "highest", for CPU tensors
    :func:`fused_exp_zoom_anchor_reference` at ``precision``.  Counterpart
    of the JAX package's ``fused_exp_zoom_anchor``, with every group of
    the cube in one launch.  ``dphi`` may be any view with unit column
    stride.  The default "highest" is the JAX function's."""
    global ANCHOR_LAUNCHES, TC_ANCHOR_LAUNCHES
    check_precision(precision)
    if dphi.device.type == "cpu":
        return fused_exp_zoom_anchor_reference(dphi, dl, a2, centre, astar,
                                               coef, group, precision)
    B, ndir, n, ncols = dphi.shape
    nl, deg1 = _anchor_shapes(dphi, a2, centre, astar, coef, group)
    m2 = a2.shape[1]
    if group > ANCHOR_MAX_GROUP or deg1 > ANCHOR_MAX_DEGREE + 1:
        raise ValueError(
            f"fused_exp_zoom_anchor: groups of {group} wavelengths at "
            f"degree {deg1 - 1}; the kernel takes at most "
            f"{ANCHOR_MAX_GROUP} and {ANCHOR_MAX_DEGREE}")
    _build.check_operands("fused_exp_zoom_anchor", dphi.device, {
        "dl": (dl, (n, ncols)), "a2": (a2, (nl, m2, n)),
        "centre": (centre, (B, ndir)), "astar": (astar, astar.shape),
        "coef": (coef, (nl, deg1))})
    _build.check_operands("fused_exp_zoom_anchor", dphi.device,
                          {"dphi": (dphi, (B, ndir, n, ncols))},
                          unit_stride_only=True)
    if B > 65535:
        raise ValueError(f"fused_exp_zoom_anchor: grid too large (B={B})")
    _check_rows("fused_exp_zoom_anchor", n, precision)
    u = torch.empty((B, nl, m2, ncols), dtype=torch.float32,
                    device=dphi.device)
    sb, sd, sr, _ = dphi.stride()
    stream = torch.cuda.current_stream(dphi.device).cuda_stream
    if precision == "high":
        a2_hi, a2_lo = split_bf16(a2)       # once per launch, as for K1
        err = _build.library().muse_fused_exp_zoom_anchor_tc(
            dphi.data_ptr(), dl.data_ptr(), a2_hi.data_ptr(),
            a2_lo.data_ptr(), centre.data_ptr(), astar.data_ptr(),
            coef.data_ptr(), u.data_ptr(), sb, sd, sr, B, ndir, n, ncols, nl,
            m2, group, deg1, stream)
    else:
        err = _build.library().muse_fused_exp_zoom_anchor(
            dphi.data_ptr(), dl.data_ptr(), a2.data_ptr(), centre.data_ptr(),
            astar.data_ptr(), coef.data_ptr(), u.data_ptr(), sb, sd, sr, B,
            ndir, n, ncols, nl, m2, group, deg1, stream)
    _build.check_launch(err, "fused_exp_zoom_anchor")
    if precision == "high":
        TC_ANCHOR_LAUNCHES += 1
    else:
        ANCHOR_LAUNCHES += 1
    return u
