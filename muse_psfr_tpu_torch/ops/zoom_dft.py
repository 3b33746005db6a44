"""K1 and K3: fused direction-averaged OTF x zoom-DFT stage 1.

Per telemetry row ``b`` and wavelength ``l`` of a chunk,

    G_{b,l} = sum_d exp(alpha_l * Dphi_{b,d}) * w_{b,l,d} * dl
    U_{b,l} = A2_l @ G_{b,l}

with Dphi the wavelength-free structure function per evaluation direction
(under the symmetry fold (N, ncols) = (1280, 768) at production), dl the
diffraction OTF slab, A2_l the stacked [Ar; Ai] zoom-DFT rows of
wavelength l's crop grid and w the per-direction DC weights.

:func:`fused_exp_zoom` launches the hand-written CUDA kernels
(``csrc/zoom_dft.cu``; counterpart of
``muse_psfr_tpu/ops/zoom_dft.py:fused_exp_zoom``) for CUDA tensors, which
never write G to device memory; for CPU tensors it runs
:func:`fused_exp_zoom_reference`, the plain PyTorch version.  Every
direction is summed per element in registers, which is what the TPU's
direction-block bodies (``_kernel``, ``_kernel_dirblock``,
``_kernel_dirfull``) compute for any ``dir_block``.  ``row_splits=R > 1``
is K3 (``_kernel_rowacc``): the contraction rows in R slices whose partial
products are summed in the fixed order r = 0..R-1.
"""

import numpy as np
import torch

from . import _build

#: successful launches of the CUDA kernel with one row slice (K1), and
#: with R > 1 row slices and the ordered sum of their partials (K3); see
#: ops/_build.py
LAUNCHES = 0
ROWSPLIT_LAUNCHES = 0

#: output rows and columns of one CUDA block (``TI``/``TJ`` of the .cu)
M_TILE, N_TILE = 160, 64

_LOG2E = float(np.log2(np.e))


def fused_exp_zoom_reference(dphi, dl, a2, alpha, w, exp2=False,
                             row_splits=1):
    """Plain PyTorch K1/K3: ``U[b, l] = A2[l] @ (sum_d exp(alpha[l] *
    D[b, d]) * w[b, l, d] * dl)``.

    dphi (B, ndir, N, ncols); dl (N, ncols); a2 (nl, 2M, N); alpha (nl,);
    w (B, nl, ndir).  Returns (B, nl, 2M, ncols).  ``exp2=True`` evaluates
    the damping as ``exp2(alpha*log2(e)*D + log2 w)`` (cfg.zoom_exp2): the
    same math up to argument rounding.  ``row_splits=R`` sums the R
    partial contractions over rows ``[r*N/R, (r+1)*N/R)`` in order.
    """
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
    g = g * dl
    n = dphi.shape[2]
    _check_splits(n, row_splits)
    h = n // row_splits
    u = None
    for r in range(row_splits):
        part = torch.matmul(a2[None, :, :, r * h:(r + 1) * h],
                            g[:, :, r * h:(r + 1) * h])
        u = part if u is None else u + part
    return u


def _check_splits(n, row_splits):
    if row_splits != 1 and (row_splits < 1 or n % row_splits
                            or (n // row_splits) % 32):
        raise ValueError(f"row_splits={row_splits} must divide the {n} "
                         "contraction rows into slices of a multiple of 32")


def fused_exp_zoom(dphi, dl, a2, alpha, w, exp2=False, row_splits=1):
    """K1 (``row_splits=1``) or K3 on the tensors' device: the CUDA
    kernels for CUDA tensors (float32 only; anything else raises),
    :func:`fused_exp_zoom_reference` for CPU tensors.  Shapes as in the
    reference; every tensor contiguous except ``dphi``, which may be any
    view with unit column stride (the blue sub-window of a structure
    function)."""
    global LAUNCHES, ROWSPLIT_LAUNCHES
    if dphi.device.type == "cpu":
        return fused_exp_zoom_reference(dphi, dl, a2, alpha, w, exp2,
                                        row_splits)
    B, ndir, n, ncols = dphi.shape
    nl, m2 = a2.shape[0], a2.shape[1]
    _check_splits(n, row_splits)
    _build.check_operands("fused_exp_zoom", dphi.device, {
        "dl": (dl, (n, ncols)), "a2": (a2, (nl, m2, n)),
        "alpha": (alpha, (nl,)), "w": (w, (B, nl, ndir))})
    _build.check_operands("fused_exp_zoom", dphi.device,
                          {"dphi": (dphi, (B, ndir, n, ncols))},
                          unit_stride_only=True)
    if nl > 65535 or B > 65535:
        raise ValueError(f"fused_exp_zoom: grid too large (nl={nl}, B={B})")
    if exp2:
        alpha = alpha * _LOG2E
        w = torch.log2(w)
    u = torch.empty((B, nl, m2, ncols), dtype=torch.float32,
                    device=dphi.device)
    # K3's partial products, one (B, nl, m2, ncols) slab per row slice
    ws = (torch.empty((row_splits,) + tuple(u.shape), dtype=torch.float32,
                      device=dphi.device) if row_splits > 1 else u)
    sb, sd, sr, _ = dphi.stride()
    err = _build.library().muse_fused_exp_zoom(
        dphi.data_ptr(), dl.data_ptr(), a2.data_ptr(), alpha.data_ptr(),
        w.data_ptr(), ws.data_ptr(), u.data_ptr(), sb, sd, sr, B, ndir, n,
        ncols, nl, m2, row_splits, int(exp2),
        torch.cuda.current_stream(dphi.device).cuda_stream)
    _build.check_launch(err, "fused_exp_zoom")
    if row_splits > 1:
        ROWSPLIT_LAUNCHES += 1
    else:
        LAUNCHES += 1
    return u
