"""Share [%] of its roofline that the zoom kernel (K1, K1'/K4, K3, K5 of
``csrc/zoom_dft_tc.cu``, with its A2 split and K3's slab sum) reaches in
the traced batches: the least time the card could take for the launches'
work over the time they took.

The work is counted from each traced batch's plan (its groups, chunk sizes,
windows and blue split) with ``roofline.zoom_work``: what the algorithm and
the precision tier's pass count require, whatever body runs it.  The time
is the device time of the zoom kernels by name from the profiler.  A plan
with an anchored (K6) or disc-skipped (K5) group is not counted here: their
work needs a reader of its own, and this one then reads nothing."""

from bench_port import roofline as _roof
from bench_port.metrics import _kernels


def launches(plan, npsflin):
    """``zoom_work`` arguments of every zoom launch of a plan: one per
    chunk and window segment (the blue sub-window, then the rest)."""
    ndir = npsflin * npsflin
    nl = int(plan.lbda.size)
    for g in plan.groups:
        c = g.cfg
        if c.zoom_anchor == "on" or (c.disc_skip
                                     and ndir >= c.disc_min_ndir):
            raise ValueError("anchored or disc-skipped group")
        precision = c.zoom_precision if c.use_dphi_split else "highest"
        m2 = 4 * c.dimpsf
        win = c.otf_window
        if win is None:
            segs = [(nl, c.dim, c.dim)]
        else:
            S = win[1]
            if c.otf_blue is not None:
                nb, Sb = c.otf_blue
                segs = [(nb, 2 * Sb, Sb + 128), (nl - nb, 2 * S, S + 128)]
            else:
                segs = [(nl, 2 * S, S + 128)]
        for B in g.sizes:
            for k, n, ncols in segs:
                yield (int(B), ndir, n, ncols, k, m2, precision)


def bound_ms(plans, npsflin):
    return sum(_roof.roofline(**_roof.zoom_work(*args))[0]
               for plan in plans for args in launches(plan, npsflin))


def read(rec):
    us = _kernels.device_us(rec, "zoom")
    if us <= 0 or not rec["plans"]:
        return None
    try:
        bound = bound_ms(rec["plans"], rec["npsflin"])
    except ValueError:
        return None
    return 100.0 * bound / (us * 1e-3)
