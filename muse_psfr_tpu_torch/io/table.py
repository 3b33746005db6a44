"""Lightweight column table with FITS round-trip (pure numpy).

Copy of ``muse_psfr_tpu/io/table.py`` (the ``astropy.table.Table`` usage of
the reference: fit-result tables, vstack, table_to_hdu; psfrec.py:866-871,
1086-1112): an ordered mapping of equal-length numpy columns plus a
``meta`` dict that lands in the FITS header.
"""

import numpy as np

from .fits import BinTableHDU, Header


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

    # -- FITS ------------------------------------------------------------------
    def to_hdu(self, name=""):
        dt = []
        for k, v in self._cols.items():
            base = v.dtype
            if v.ndim > 1:
                dt.append((k, base, v.shape[1:]))
            else:
                dt.append((k, base))
        arr = np.empty(len(self), dtype=np.dtype(dt))
        for k, v in self._cols.items():
            arr[k] = v
        hdr = Header()
        for k, v in self.meta.items():
            hdr[k] = v
        return BinTableHDU(data=arr, name=name, header=hdr)

    @classmethod
    def from_hdu(cls, hdu):
        t = cls()
        data = hdu.data
        for k in data.dtype.names:
            t._cols[k] = np.array(data[k])
        skip = ("XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2", "PCOUNT",
                "GCOUNT", "TFIELDS", "EXTNAME")
        for k, v in hdu.header.items():
            if k in skip or k.startswith(("TTYPE", "TFORM", "TDIM")):
                continue
            t.meta[k] = v
        return t

    @classmethod
    def vstack(cls, tables):
        out = cls()
        names = tables[0].colnames
        for k in names:
            out._cols[k] = np.concatenate([np.atleast_1d(t[k])
                                           for t in tables], axis=0)
        return out
