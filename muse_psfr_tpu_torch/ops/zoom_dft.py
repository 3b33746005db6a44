"""K1: fused direction-averaged OTF x zoom-DFT stage 1.

Per telemetry row ``b`` and wavelength ``l`` of a chunk,

    G_{b,l} = sum_d exp(alpha_l * Dphi_{b,d}) * w_{b,l,d} * dl
    U_{b,l} = A2_l @ G_{b,l}

with Dphi the wavelength-free structure function per evaluation direction
(under the symmetry fold (N, ncols) = (1280, 768) at production), dl the
diffraction OTF slab, A2_l the stacked [Ar; Ai] zoom-DFT rows of
wavelength l's crop grid and w the per-direction DC weights.

:func:`fused_exp_zoom` launches the hand-written CUDA kernel
(``csrc/zoom_dft.cu``; counterpart of
``muse_psfr_tpu/ops/zoom_dft.py:fused_exp_zoom``) for CUDA tensors, which
never writes G to device memory; for CPU tensors it runs
:func:`fused_exp_zoom_reference`, the plain PyTorch version.
"""

import numpy as np
import torch

from . import _build

#: successful launches of the CUDA kernel (see ops/_build.py)
LAUNCHES = 0

_LOG2E = float(np.log2(np.e))


def fused_exp_zoom_reference(dphi, dl, a2, alpha, w, exp2=False):
    """Plain PyTorch K1: ``U[b, l] = A2[l] @ (sum_d exp(alpha[l] *
    D[b, d]) * w[b, l, d] * dl)``.

    dphi (B, ndir, N, ncols); dl (N, ncols); a2 (nl, 2M, N); alpha (nl,);
    w (B, nl, ndir).  Returns (B, nl, 2M, ncols).  ``exp2=True`` evaluates
    the damping as ``exp2(alpha*log2(e)*D + log2 w)`` (cfg.zoom_exp2): the
    same math up to argument rounding.
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
    return torch.matmul(a2[None], g * dl)


def fused_exp_zoom(dphi, dl, a2, alpha, w, exp2=False):
    """K1 on the tensors' device: the CUDA kernel for CUDA tensors (float32
    only; anything else raises), :func:`fused_exp_zoom_reference` for CPU
    tensors.  Shapes as in the reference; every tensor contiguous."""
    global LAUNCHES
    if dphi.device.type == "cpu":
        return fused_exp_zoom_reference(dphi, dl, a2, alpha, w, exp2)
    B, ndir, n, ncols = dphi.shape
    nl, m2 = a2.shape[0], a2.shape[1]
    _build.check_operands("fused_exp_zoom", dphi.device, {
        "dphi": (dphi, (B, ndir, n, ncols)), "dl": (dl, (n, ncols)),
        "a2": (a2, (nl, m2, n)), "alpha": (alpha, (nl,)),
        "w": (w, (B, nl, ndir))})
    if nl > 65535 or B > 65535:
        raise ValueError(f"fused_exp_zoom: grid too large (nl={nl}, B={B})")
    if exp2:
        alpha = alpha * _LOG2E
        w = torch.log2(w)
    u = torch.empty((B, nl, m2, ncols), dtype=torch.float32,
                    device=dphi.device)
    lib = _build.library()
    err = lib.muse_fused_exp_zoom(
        dphi.data_ptr(), dl.data_ptr(), a2.data_ptr(), alpha.data_ptr(),
        w.data_ptr(), u.data_ptr(), B, ndir, n, ncols, nl, m2, int(exp2),
        torch.cuda.current_stream(dphi.device).cuda_stream)
    _build.check_launch(err, "fused_exp_zoom")
    LAUNCHES += 1
    return u
