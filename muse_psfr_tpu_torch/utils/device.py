"""Explicit device selection and host-constant placement.

Entry points take ``device=`` (default ``"cuda"``) and never fall back:
asking for CUDA on a machine without it raises.  The CPU runs only when a
caller passes ``device="cpu"``.
"""

import numpy as np
import torch

_DEVICE_CONSTS = {}


def resolve_device(device="cuda") -> torch.device:
    """``device`` as a :class:`torch.device`; raises if it is CUDA and
    CUDA is unavailable.

    Also switches TF32 off for float32 matmuls and cuDNN convolutions: a
    one-pass TF32 contraction keeps ~3 decimal digits, which breaks the
    1e-5 rms accuracy budget (docs/precision.md, "default" tier), so every
    ``torch.matmul`` outside the kernels runs in full float32.
    """
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "device='cuda' requested but torch.cuda.is_available() is "
            "False; pass device='cpu' to run the plain PyTorch path")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return dev


def torch_dtype(name: str) -> torch.dtype:
    """Config dtype string (``"float32"``/``"float64"``) -> torch dtype."""
    return {"float32": torch.float32, "float64": torch.float64}[name]


def host_const(key, make, device, dtype) -> torch.Tensor:
    """Host numpy constant ``make()`` as a tensor on ``device`` in
    ``dtype``, made once per (key, device, dtype)."""
    k = (key, str(device), dtype)
    t = _DEVICE_CONSTS.get(k)
    if t is None:
        t = torch.tensor(np.ascontiguousarray(make()), dtype=dtype,
                         device=device)
        _DEVICE_CONSTS[k] = t
    return t


def clear_device_consts():
    """Drop every placed constant (after the host tables change), and the
    captured chunk programs, which hold the addresses of those they
    read."""
    from ..parallel import programs
    programs.clear()
    _DEVICE_CONSTS.clear()
