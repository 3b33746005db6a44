"""Lightweight column table (pure numpy).

Copy of ``muse_psfr_tpu/io/table.py`` (the ``astropy.table.Table`` usage of
the reference: fit-result tables and vstack, psfrec.py:866-871,
1086-1112): an ordered mapping of equal-length numpy columns plus a
``meta`` dict.  The FITS round-trip (``to_hdu``/``from_hdu``) comes with
the port of the FITS layer (ROADMAP.md, Queue 1).
"""

import numpy as np


class FitTable:
    """Ordered {name: ndarray} columns + meta; vector columns allowed."""

    def __init__(self, columns=None, meta=None):
        self._cols = {}
        self.meta = dict(meta or {})
        if columns:
            for k, v in (columns.items() if isinstance(columns, dict)
                         else columns):
                self[k] = v

    # -- column access ------------------------------------------------------
    def __getitem__(self, key):
        if isinstance(key, str):
            return self._cols[key]
        # integer -> row view as dict
        return {k: v[key] for k, v in self._cols.items()}

    def __setitem__(self, key, value):
        value = np.asarray(value)
        if self._cols:
            n = len(self)
            if value.ndim == 0:
                value = np.full((n,) , value)
            elif value.shape[0] != n:
                raise ValueError("column %r length %d != %d"
                                 % (key, value.shape[0], n))
        elif value.ndim == 0:
            value = value[None]
        self._cols[key] = value

    def __contains__(self, key):
        return key in self._cols

    def __len__(self):
        return 0 if not self._cols else len(next(iter(self._cols.values())))

    @property
    def colnames(self):
        return list(self._cols)

    def remove_columns(self, names):
        for n in names:
            self._cols.pop(n, None)

    @classmethod
    def vstack(cls, tables):
        out = cls()
        names = tables[0].colnames
        for k in names:
            out._cols[k] = np.concatenate([np.atleast_1d(t[k])
                                           for t in tables], axis=0)
        return out
