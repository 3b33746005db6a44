"""The one traffic generator of the port's benchmark: SPARTA telemetry rows
in batches, from a mix file (``traffic/<name>.json``) and ``--seed``.

A mix draws a fixed pool of batches from its own ``base_seed`` with the
distribution of the bench night (``night_rows``, below, a copy of
``muse_psfr_tpu_torch/utils/telemetry.py:night_rows`` that takes its
generator): seeing, ground-layer fraction and outer scale uniform over the
observed ranges, a share of rows in 3-laser mode, the first row of each
pool batch pinned to the golden condition (``PIN``).  The conditions decide
how the planner buckets the rows (reduced window or full, blue sub-windows,
tail chunks), and so how much work a batch is; a pool drawn anew from every
seed changed that work by several percent from seed to seed.  So every seed sees
the same pool of conditions, and the seed decides the rest:

* the order in which the pool's batches come, cycle by cycle;
* the order of the rows inside every batch it hands out;
* a relative jitter of ``JITTER_REL`` on seeing, GL and L0 of every row.

So no two batches of a run, or of two seeds, are the same telemetry: the
program plans every batch anew, as it plans every night a user hands it,
and no cache keyed on the telemetry can answer for it.  The jitter is far
below anything that moves a row between the planner's buckets, so every
batch needs the programs that the pool needs.
"""

import numpy as np

#: the golden condition (seeing ["], GL, L0 [m]) of row 0 of every pool
#: batch, with every laser on
PIN = (1.0, 0.7, 25.0)
#: relative jitter of every row's seeing, GL and L0.  It describes no
#: traffic: it only makes every batch new telemetry, since ``plan_batch``
#: memoises its plans on the exact bytes of the telemetry, and it is far
#: too small to move a row between the planner's buckets
JITTER_REL = 1e-9


def night_rows(n, rng, seeing=(0.6, 1.6), GL=(0.3, 0.9), L0=(9.0, 29.0),
               three_laser_share=0.1, pin=PIN):
    """Realistic full-night telemetry: ``(seeing, GL, L0, mask)`` of ``n``
    rows, spread over the observed ranges, ~``three_laser_share`` of the
    rows in 3-laser mode, row 0 pinned to ``pin`` (seeing, GL, L0) with
    every laser on (no pin when ``pin`` is None)."""
    s = rng.uniform(*seeing, n)
    g = rng.uniform(*GL, n)
    l0 = rng.uniform(*L0, n)
    mask = np.ones((n, 4))
    mask[rng.random(n) < three_laser_share, 3] = 0.0
    if pin is not None:
        s[0], g[0], l0[0] = pin
        mask[0] = 1.0
    return s, g, l0, mask


class Traffic:
    """The batches of one mix under one seed.  ``batch(k)`` is the k-th
    batch a run hands the program: ``(seeing, GL, L0, mask)`` float64
    numpy, and ``pool_index(k)`` the pool batch it was made from."""

    def __init__(self, mix, seed):
        self.seed = int(seed) % 2 ** 64
        rng = np.random.default_rng(int(mix["base_seed"]))
        self.pool = [night_rows(int(mix["rows"]), rng,
                                seeing=mix["seeing_arcsec"], GL=mix["GL"],
                                L0=mix["L0_m"],
                                three_laser_share=mix["three_laser_share"])
                     for _ in range(int(mix["pool"]))]
        self.rows = int(mix["rows"])

    def _rng(self, *words):
        return np.random.default_rng(np.random.SeedSequence(
            [self.seed] + [int(w) for w in words]))

    def pool_index(self, k):
        n = len(self.pool)
        cycle, i = divmod(int(k), n)
        return int(self._rng(0, cycle).permutation(n)[i])

    def batch(self, k):
        s, g, l0, m = self.pool[self.pool_index(k)]
        rng = self._rng(1, k)
        p = rng.permutation(self.rows)
        jit = 1.0 + JITTER_REL * rng.uniform(-1.0, 1.0, (3, self.rows))
        return s[p] * jit[0], g[p] * jit[1], l0[p] * jit[2], m[p].copy()
