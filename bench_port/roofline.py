"""The yardstick of the kernels' roofline shares: the card's datasheet peaks
and the work of the zoom kernel (K1, K1'/K4, K3, K5) from its launch
shapes.  A frozen copy of ``chip_smoke.py:roofline`` and ``zoom_work``.

Peaks of one NVIDIA H100 SXM from NVIDIA's datasheet (dense, at the 700 W
limit): float32 outside the tensor cores, dense bf16 on the tensor cores,
HBM3; the SFU's exponentials at 16 a clock per SM on 132 SMs at the
1.98 GHz boost clock.
"""

PEAK_FP32 = 67e12
PEAK_BF16 = 989e12
HBM = 3.35e12
PEAK_EXP = 16 * 132 * 1.98e9


def roofline(nbytes, fp32=0.0, tc=0.0, exps=0.0):
    """The least time [ms] the card could take for a kernel's work: the
    larger of its bytes (each input read once, each output written once)
    over the memory rate and its operations, each over the peak of the
    unit that runs them (the units run side by side, so the slowest one
    bounds the operations).  Returns ``(bound_ms, bound_by)``."""
    t_ops = max(fp32 / PEAK_FP32, tc / PEAK_BF16, exps / PEAK_EXP) * 1e3
    t_bytes = nbytes / HBM * 1e3
    return max(t_ops, t_bytes), ("operations" if t_ops >= t_bytes
                                 else "bytes")


def zoom_work(B, ndir, n, ncols, nl, m2, precision, elems=None):
    """:func:`roofline`'s work of one zoom launch on ``elems`` live OTF
    elements (all n x ncols by default): per (row, wavelength, direction,
    element) an exponential and three float32 operations (the argument's
    product and sum, the direction sum), then the product with dl; the
    contraction with the (nl, m2, n) zoom matrix as three ("high") or six
    ("highest") bf16 passes on the tensor cores."""
    elems = n * ncols if elems is None else elems
    contraction = 2.0 * B * nl * m2 * elems
    other = float(B * nl * elems * (3 * ndir + 1))
    work = dict(nbytes=4.0 * (B * ndir * elems + elems + nl * m2 * n + nl
                              + B * nl * ndir + B * nl * m2 * ncols),
                exps=float(B * nl * ndir * elems))
    passes = 3 if precision == "high" else 6
    return dict(work, fp32=other, tc=passes * contraction)
