"""The bench night's telemetry, shared by the port's bench, its demos and
its chip checks."""

import numpy as np


def night_rows(n):
    """Realistic full-night telemetry (``bench.py:build_rows``, seed
    20260816): row 0 pinned to the golden condition (1.0", 0.7, 25 m), the
    rest spread over observed ranges, ~10% of rows in 3-laser mode.
    Returns ``(seeing, GL, L0, mask)``."""
    rng = np.random.default_rng(20260816)
    seeing = rng.uniform(0.6, 1.6, n)
    GL = rng.uniform(0.3, 0.9, n)
    L0 = rng.uniform(9.0, 29.0, n)
    mask = np.ones((n, 4))
    mask[rng.random(n) < 0.1, 3] = 0.0
    seeing[0], GL[0], L0[0] = 1.0, 0.7, 25.0
    mask[0] = 1.0
    return seeing, GL, L0, mask
