"""Minimal self-contained FITS codec (read/write) for the PSF-reconstruction
pipeline.

The reference package leans on ``astropy.io.fits`` for its I/O contract
(reference psfrec.py:1016-1026, 1094-1113): read a binary-table extension of
SPARTA telemetry, write a PRIMARY + table copies + two fit tables + one
image extension.  This module implements exactly the needed subset of the
FITS standard (primary/image HDUs with BITPIX 8/16/32/64/-32/-64 incl. the
unsigned BZERO convention and general BSCALE/BZERO scaling, binary tables
with L/B/I/J/K/E/D/A columns incl. vector repeats and TSCALn/TZEROn
scaling, CONTINUE long strings, undefined values), in pure NumPy/stdlib,
producing standard-conformant files that astropy can read.  Payloads
decode lazily at first ``.data`` access, so raw MUSE exposures carrying
two dozen CHAN image extensions (or extension types outside this subset)
cost nothing when only the primary header and the SPARTA table are used.

Supported inputs: file path, binary file-like object, bytes, or an
:class:`HDUList` (pass-through), covering every call pattern of the
reference API and CLI.

The port's own copy of ``muse_psfr_tpu/io/fits.py`` (host numpy only, no
tensor in it): the same HDUs serialise to the same bytes in both packages.
"""

import io

import numpy as np

from ..utils.log import get_logger

logger = get_logger()

BLOCK = 2880

# TFORM code <-> numpy dtype (big-endian on disk)
_TFORM_TO_DTYPE = {
    "L": ">i1", "B": ">u1", "I": ">i2", "J": ">i4", "K": ">i8",
    "E": ">f4", "D": ">f8",
}
_KIND_TO_TFORM = {
    # NOTE no ("i", 1): TFORM 'B' is UNSIGNED — writing int8 through it
    # would silently wrap negative values (the signed-byte convention
    # needs TZERO=-128, which this codec does not emit); int8 columns
    # fail loudly in _column_tform like every other unsupported dtype
    ("u", 1): "B", ("i", 2): "I", ("i", 4): "J",
    ("i", 8): "K", ("f", 4): "E", ("f", 8): "D", ("b", 1): "L",
}
_BITPIX_TO_DTYPE = {8: ">u1", 16: ">i2", 32: ">i4", 64: ">i8",
                    -32: ">f4", -64: ">f8"}
_DTYPE_TO_BITPIX = {"u1": 8, "i2": 16, "i4": 32, "i8": 64,
                    "f4": -32, "f8": -64}


class Header:
    """Ordered, case-insensitive FITS header (keyword -> value, comment)."""

    def __init__(self, cards=None):
        self._cards = []              # list of (KEY, value, comment)
        if cards:
            for c in cards:
                self.append(*c)

    # -- mapping-ish API ----------------------------------------------------
    @staticmethod
    def _norm_key(key):
        """Keyword lookup form: the optional 'HIERARCH ' prefix is not part
        of the keyword (astropy accepts both spellings)."""
        key = key.upper()
        if key.startswith("HIERARCH "):
            key = key[9:]
        return key

    def _find(self, key):
        key = self._norm_key(key)
        for i, (k, _, _) in enumerate(self._cards):
            if k == key:
                return i
        return -1

    def __contains__(self, key):
        return self._find(key) >= 0

    def __getitem__(self, key):
        i = self._find(key)
        if i < 0:
            raise KeyError(key)
        return self._cards[i][1]

    def get(self, key, default=None):
        i = self._find(key)
        return self._cards[i][1] if i >= 0 else default

    def __setitem__(self, key, value):
        comment = ""
        if isinstance(value, tuple):
            value, comment = value
        i = self._find(key)
        if i >= 0:
            self._cards[i] = (self._norm_key(key), value, comment)
        else:
            self._cards.append((self._norm_key(key), value, comment))

    def append(self, key, value, comment=""):
        self._cards.append((self._norm_key(key), value, comment))

    def remove(self, key):
        i = self._find(key)
        if i < 0:
            raise KeyError(key)
        del self._cards[i]

    def items(self):
        return [(k, v) for k, v, _ in self._cards]

    @property
    def comments(self):
        """Comment access by keyword — ``hdr.comments["KEY"]``, the same
        surface as astropy's ``Header.comments`` (the reference's
        consumers read comments through it)."""
        cards = self._cards

        class _Comments:
            def __getitem__(self, key):
                nk = Header._norm_key(key)
                for k, _, c in cards:
                    if k == nk:
                        return c
                raise KeyError(key)

        return _Comments()

    def keys(self):
        return [k for k, _, _ in self._cards]

    def copy(self):
        return Header(list(self._cards))

    # -- serialisation --------------------------------------------------------
    @staticmethod
    def _format_value(v):
        if v is None:
            # undefined value (legal FITS: blank value field) — raw-MUSE
            # headers copied through the reader can carry these; they
            # must round-trip instead of crashing the final writeto
            return ""
        if isinstance(v, bool) or isinstance(v, np.bool_):
            return "T" if v else "F"
        if isinstance(v, str):
            s = v.replace("'", "''")
            return ("'%-8s'" % s) if len(s) <= 8 else "'%s'" % s
        if isinstance(v, (int, np.integer)):
            return "%d" % v
        if isinstance(v, (float, np.floating)):
            s = repr(float(v))
            return s.upper() if "e" in s else s
        raise TypeError("unsupported header value %r" % (v,))

    def _card_image(self, key, value, comment):
        """One or more 80-char card images for (key, value, comment).

        Long VALUES never truncate silently: string values that overflow
        one card use the FITS long-string (CONTINUE) convention — the
        reference gets this behaviour from astropy, which the CLI relies
        on when copying long ``HIERARCH ESO ...`` cards out of raw MUSE
        headers (reference cli.py:44-55).  Values that cannot be
        continued (HIERARCH with an overlong value, overlong numerics)
        raise ``ValueError`` instead of corrupting the file.  An
        overlong COMMENT on a card whose value fits is truncated with a
        logged warning — astropy's behaviour (VerifyWarning + truncated
        write), which callers copying real raw-MUSE headers rely on.
        """
        if key in ("COMMENT", "HISTORY", ""):
            text = str(value)
            # wrap onto repeated COMMENT/HISTORY cards (astropy behaviour)
            chunks = [text[i:i + 72] for i in range(0, len(text), 72)] or [""]
            return "".join(("%-8s%s" % (key, c)).ljust(80) for c in chunks)
        if len(key) > 8 or " " in key:
            # HIERARCH convention: the standard's CONTINUE long-string
            # convention is defined only for 8-char keywords, so an
            # overflowing HIERARCH card must fail loudly.
            body = "HIERARCH %s = %s" % (key, self._format_value(value))
            if len(body) > 80:
                raise ValueError(
                    "FITS card too long and not continuable (HIERARCH "
                    "keyword %r, %d > 80 chars); shorten the value"
                    % (key, len(body)))
            if comment:
                body = self._append_comment(key, body, comment)
            return body.ljust(80)
        if isinstance(value, str):
            return self._string_card_images(key, value, comment)
        body = "%-8s= %20s" % (key, self._format_value(value))
        if len(body) > 80:
            raise ValueError("FITS card too long for keyword %r (%d > 80 "
                             "chars)" % (key, len(body)))
        if comment:
            body = self._append_comment(key, body, comment)
        return body.ljust(80)

    @staticmethod
    def _append_comment(key, body, comment):
        """Append ``/ comment``, truncating the comment (never the value)
        to the 80-column card with a logged warning — astropy writes the
        same truncated card under a VerifyWarning."""
        full = body + " / " + comment
        if len(full) <= 80:
            return full
        room = 80 - len(body) - len(" / ")
        logger.warning(
            "FITS comment for keyword %r truncated to fit the 80-column "
            "card (%d -> %d chars)", key, len(comment), max(0, room))
        return full[:80] if room > 0 else body

    @staticmethod
    def _string_card_images(key, value, comment):
        """String-valued card, continued per the FITS long-string
        convention when it overflows: every segment but the last ends
        with ``&`` inside the quotes, continuation cards start with
        ``CONTINUE``, and an overlong comment rides on ``'&'``
        continuation cards."""
        esc = value.replace("'", "''")
        # fixed-format: strings pad to >= 8 chars INSIDE the quotes
        # (closing quote in column 20 or later, FITS 4.0 sect 4.2.1.1);
        # padding after the closing quote would make every mandatory
        # card (XTENSION= 'IMAGE') fail fitsverify
        one = "%-8s= '%-8s'" % (key, esc)
        if comment:
            one += " / " + comment
        if len(one) <= 80:
            return one.ljust(80)
        # split the ESCAPED text so no card exceeds 70 value columns,
        # never splitting an escaped quote pair; keep one column for '&'
        segs, i, room = [], 0, 67
        while i < len(esc):
            j = min(i + room, len(esc))
            # don't split a '' pair: count trailing quotes of the cut
            k = j
            while k > i and esc[k - 1] == "'":
                k -= 1
            if (j - k) % 2 == 1 and j < len(esc):
                j -= 1
            segs.append(esc[i:j])
            i = j
        # an empty value reaches here only via an overlong comment: the
        # split loop never runs, but the keyword card must still be
        # emitted (else the header starts with orphan CONTINUE cards and
        # the key is silently lost on round-trip)
        if not segs:
            segs = [""]
        cards = []
        for n, seg in enumerate(segs):
            last = n == len(segs) - 1 and not comment
            s = "'%s%s'" % (seg, "" if last else "&")
            prefix = ("%-8s= " % key) if n == 0 else "CONTINUE  "
            cards.append((prefix + s).ljust(80))
        if comment:
            # comment continuation: '&' string segments carrying ' / ...'
            rest = comment
            room = 80 - len("CONTINUE  '&' / ")
            while rest:
                take = rest[:room]
                # never leave a chunk ending in a space: the 80-column
                # card padding would absorb it on read — shift it to the
                # next chunk's leading position, which the reader keeps
                # (it drops exactly one separator space after '/')
                while (take and take[-1] == " " and len(rest) > len(take)):
                    take = take[:-1]
                if not take:                 # all-space window
                    take = rest[:room]
                rest = rest[len(take):]
                s = "'&'" if rest else "''"
                cards.append(("CONTINUE  %s / %s" % (s, take)).ljust(80))
        return "".join(cards)

    def tobytes(self):
        out = [self._card_image(k, v, c) for k, v, c in self._cards]
        out.append("END".ljust(80))
        data = "".join(out).encode("ascii")
        pad = (-len(data)) % BLOCK
        return data + b" " * pad


def _parse_header_value(raw):
    raw = raw.strip()
    if not raw:
        return None
    if raw.startswith("'"):
        # find closing quote handling '' escapes
        s, i = [], 1
        while i < len(raw):
            if raw[i] == "'":
                if i + 1 < len(raw) and raw[i + 1] == "'":
                    s.append("'")
                    i += 2
                    continue
                break
            s.append(raw[i])
            i += 1
        return "".join(s).rstrip()
    token = raw.split("/")[0].strip()
    if not token:
        return None       # undefined value carrying only a comment
    if token == "T":
        return True
    if token == "F":
        return False
    try:
        return int(token)
    except ValueError:
        pass
    try:
        return float(token.replace("D", "E").replace("d", "e"))
    except ValueError:
        return token


def _parse_value_comment(raw):
    """(value, comment) of a card body (the text after ``'= '``).

    The comment is whatever follows the first ``/`` OUTSIDE the quoted
    string value; exactly one leading separator space is dropped (the
    writer emits ``" / "``) so spaces carried to a continuation chunk's
    front survive, and trailing card padding is stripped (trailing
    spaces at the very end of a FITS comment are unrecoverable — the
    same limitation astropy has).
    """
    s = raw
    if s.lstrip().startswith("'"):
        j = s.find("'") + 1
        while j < len(s):               # scan past '' escapes
            if s[j] == "'":
                if j + 1 < len(s) and s[j + 1] == "'":
                    j += 2
                    continue
                break
            j += 1
        after = s[j + 1:] if j < len(s) else ""
    else:
        after = s
    k = after.find("/")
    if k < 0:
        return _parse_header_value(raw), ""
    com = after[k + 1:]
    if com.startswith(" "):
        com = com[1:]
    return _parse_header_value(raw), com.rstrip()


def _read_header(stream):
    hdr = Header()
    while True:
        block = stream.read(BLOCK)
        if len(block) < BLOCK:
            if not hdr._cards and not block:
                return None
            raise IOError("truncated FITS header")
        text = block.decode("ascii", errors="replace")
        done = False
        for i in range(0, BLOCK, 80):
            card = text[i:i + 80]
            key = card[:8].strip()
            if key == "END":
                done = True
                break
            if key == "CONTINUE":
                # FITS long-string convention: append to the previous
                # card's string value if it ends with the '&' sentinel;
                # comment parts riding the continuation cards reassemble
                # onto the previous card's comment
                seg, com = _parse_value_comment(card[8:])
                if (hdr._cards and isinstance(hdr._cards[-1][1], str)
                        and hdr._cards[-1][1].endswith("&")
                        and isinstance(seg, str)):
                    k, v, c = hdr._cards[-1]
                    hdr._cards[-1] = (k, v[:-1] + seg, c + com)
                continue
            if key in ("COMMENT", "HISTORY", ""):
                if card[8:].strip():
                    hdr.append(key, card[8:].rstrip())
                continue
            if key == "HIERARCH":
                body = card[9:]
                eq = body.find("= ")
                if eq < 0:
                    continue
                val, com = _parse_value_comment(body[eq + 1:])
                hdr.append(body[:eq].strip(), val, com)
                continue
            if card[8:10] == "= ":
                val, com = _parse_value_comment(card[10:])
                hdr.append(key, val, com)
        if done:
            return hdr


def _skip_padding(stream, nbytes):
    stream.seek((-nbytes) % BLOCK, io.SEEK_CUR)


class _BaseHDU:
    name = "PRIMARY"
    _pending = None      # () -> ndarray: deferred payload decode

    @property
    def data(self):
        """Decoded payload.  Files are read with DEFERRED decoding: the
        reader records where each payload lives and only decodes (and,
        for path sources, only loads) it on first access — a raw MUSE
        exposure's 24 CHAN image extensions cost nothing when the
        caller only wants the primary header or the SPARTA table."""
        if self._pending is not None:
            self._data, self._pending = self._pending(), None
        return self._data

    @data.setter
    def data(self, value):
        self._data = value
        self._pending = None

    def copy(self):
        import copy as _copy
        return _copy.deepcopy(self)


class PrimaryHDU(_BaseHDU):
    def __init__(self, data=None, header=None):
        self.data = data
        self.header = header if header is not None else Header()
        self.name = "PRIMARY"


class ImageHDU(_BaseHDU):
    def __init__(self, data=None, name="", header=None):
        self.data = None if data is None else np.asarray(data)
        self.header = header if header is not None else Header()
        self.name = name or self.header.get("EXTNAME", "")


class BinTableHDU(_BaseHDU):
    """Binary table HDU holding a numpy structured array in ``.data``."""

    def __init__(self, data=None, name="", header=None):
        self.data = data
        self.header = header if header is not None else Header()
        self.name = name or self.header.get("EXTNAME", "")

    @property
    def columns(self):
        return list(self.data.dtype.names)

    def writeto(self, target, overwrite=True):
        HDUList([PrimaryHDU(), self]).writeto(target, overwrite=overwrite)


class UnsupportedHDU(_BaseHDU):
    """Extension type this codec cannot decode (ASCII TABLE, compressed,
    random groups).  The header is fully usable and name-based HDUList
    lookups skip past it; only a ``.data`` access raises — so a raw file
    carrying exotic extensions alongside the SPARTA table still opens
    (astropy behaviour: lazy section reading)."""

    def __init__(self, header, xtension):
        self.header = header
        self.name = header.get("EXTNAME", "")
        self._xt = xtension

    @property
    def data(self):
        raise NotImplementedError(
            "XTENSION %r not supported (data access)" % (self._xt,))


class HDUList(list):
    """A list of HDUs with name-based indexing and ``writeto``."""

    def __getitem__(self, key):
        if isinstance(key, str):
            for hdu in self:
                if hdu.name.upper() == key.upper():
                    return hdu
            raise KeyError(key)
        return super().__getitem__(key)

    def index_of(self, name):
        for i, hdu in enumerate(self):
            if hdu.name.upper() == name.upper():
                return i
        raise KeyError(name)

    def writeto(self, target, overwrite=True):
        buf = _serialize_hdulist(self)
        if hasattr(target, "write"):
            target.write(buf)
        else:
            import os
            if not overwrite and os.path.exists(target):
                # astropy's contract: never silently clobber
                raise OSError("File %r already exists; use overwrite=True "
                              "to replace it" % (str(target),))
            with open(target, "wb") as fh:
                fh.write(buf)

    def close(self):
        pass


# ---------------------------------------------------------------------------
# reading
# ---------------------------------------------------------------------------

def _parse_tform(tform):
    tform = tform.strip()
    i = 0
    while i < len(tform) and tform[i].isdigit():
        i += 1
    repeat = int(tform[:i]) if i else 1
    code = tform[i]
    if code == "A":
        return repeat, code, np.dtype("S%d" % repeat)
    if code not in _TFORM_TO_DTYPE:
        raise NotImplementedError("TFORM code %r not supported" % code)
    base = np.dtype(_TFORM_TO_DTYPE[code])
    return repeat, code, base


def _decode_bintable(raw, hdr):
    nrows = int(hdr["NAXIS2"])
    rowlen = int(hdr["NAXIS1"])
    tfields = int(hdr["TFIELDS"])
    names, formats = [], []
    for k in range(1, tfields + 1):
        names.append(str(hdr.get("TTYPE%d" % k, "col%d" % k)).strip())
        formats.append(str(hdr["TFORM%d" % k]).strip())
    dt = []
    for nm, tf in zip(names, formats):
        repeat, code, base = _parse_tform(tf)
        if code == "A":
            dt.append((nm, base))
        elif repeat == 1:
            dt.append((nm, base))
        else:
            dt.append((nm, base, (repeat,)))
    dtype = np.dtype(dt)
    if dtype.itemsize != rowlen:
        raise IOError("row size mismatch: %d vs NAXIS1=%d"
                      % (dtype.itemsize, rowlen))
    data = np.frombuffer(raw, dtype=dtype, count=nrows)
    data = data.astype(dtype.newbyteorder("="))  # native byte order copy
    # logical columns are stored as ASCII 'T'/'F' bytes -> bool
    logical = {nm for nm, tf in zip(names, formats)
               if _parse_tform(tf)[1] == "L"}
    # TSCALn/TZEROn columns scale to physical values on read (astropy
    # semantics): the unsigned convention maps to the matching unsigned
    # dtype, anything else promotes to float64 (see _apply_scaling)
    scaled = {}
    for k, nm in enumerate(names, start=1):
        ts = hdr.get("TSCAL%d" % k, 1)
        tz = hdr.get("TZERO%d" % k, 0)
        if ts != 1 or tz != 0:
            scaled[nm] = (ts, tz)
    if logical or scaled:
        fields = []
        for nm in names:
            ft = data.dtype.fields[nm][0]
            base, shape = ((ft.subdtype[0], ft.subdtype[1])
                           if ft.subdtype is not None else (ft, ()))
            if nm in logical:
                base = np.dtype(np.bool_)
            elif nm in scaled:
                ts, tz = scaled[nm]
                conv_u = _UNSIGNED_BZERO.get(base.itemsize)
                if (ts == 1 and base.kind == "i" and conv_u is not None
                        and tz == conv_u[0]):
                    base = np.dtype(conv_u[1])
                else:
                    base = np.dtype("f8")
            fields.append((nm, base, shape) if shape else (nm, base))
        conv = np.empty(nrows, dtype=np.dtype(fields))
        for nm in names:
            if nm in logical:
                conv[nm] = data[nm] == ord("T")
            elif nm in scaled:
                ts, tz = scaled[nm]
                conv[nm] = _apply_scaling(
                    np.ascontiguousarray(data[nm]), ts, tz)
            else:
                conv[nm] = data[nm]
        return conv
    return data


def _decode_image(raw, hdr):
    bitpix = int(hdr["BITPIX"])
    naxis = int(hdr["NAXIS"])
    if naxis == 0:
        return None
    shape = tuple(int(hdr["NAXIS%d" % k]) for k in range(naxis, 0, -1))
    count = int(np.prod(shape))
    dt = np.dtype(_BITPIX_TO_DTYPE[bitpix])
    data = np.frombuffer(raw, dtype=dt, count=count).reshape(shape)
    data = data.astype(dt.newbyteorder("="))
    return _apply_scaling(data, hdr.get("BSCALE", 1), hdr.get("BZERO", 0))


def _payload_nbytes(hdr):
    """Payload size from the header alone (FITS 4.0 eq. 1/2): every
    standard HDU's data length is computable without decoding it."""
    naxis = int(hdr.get("NAXIS", 0))
    nelem = 1
    for k in range(1, naxis + 1):
        nelem *= int(hdr.get("NAXIS%d" % k, 0))
    if naxis == 0:
        nelem = 0
    bitpix = abs(int(hdr.get("BITPIX", 8)))
    gcount = int(hdr.get("GCOUNT", 1))
    pcount = int(hdr.get("PCOUNT", 0))
    return (bitpix // 8) * gcount * (pcount + nelem)


# BZERO values of the FITS unsigned-integer convention per signed
# on-disk itemsize: flipping the sign bit recovers the unsigned value
_UNSIGNED_BZERO = {2: (1 << 15, "u2"), 4: (1 << 31, "u4"),
                   8: (1 << 63, "u8")}


def _apply_scaling(data, bscale, bzero):
    """Physical values from stored ones (astropy semantics).

    The unsigned convention (BSCALE 1, BZERO 2^(bits-1) on a signed
    integer array — every raw MUSE CHAN extension) maps to the matching
    unsigned dtype via a sign-bit flip; anything else promotes to
    float64 BEFORE scaling (``int16 * 1 + 32768`` would raise
    OverflowError on NumPy 2)."""
    if bscale == 1 and bzero == 0:
        return data
    conv = _UNSIGNED_BZERO.get(data.dtype.itemsize)
    if (bscale == 1 and data.dtype.kind == "i" and conv is not None
            and bzero == conv[0]):
        ud = np.dtype(conv[1])
        return data.view(ud) ^ ud.type(conv[0])
    return data.astype("f8") * bscale + bzero


def _path_loader(path, offset, nbytes, hdr, decode):
    """Deferred decode for path sources: the payload bytes are only read
    (and the file only re-opened) at first ``.data`` access."""
    def load():
        with open(path, "rb") as fh:
            fh.seek(offset)
            raw = fh.read(nbytes)
        if len(raw) < nbytes:
            raise IOError("truncated FITS data in %r" % (path,))
        return decode(raw, hdr)
    return load


def fits_open(source):
    """Open a FITS file (path, bytes, file-like, or HDUList pass-through).

    Headers are parsed eagerly; payloads decode LAZILY at first ``.data``
    access (for path sources they are not even read until then — the
    payload length is computable from the header, FITS 4.0 eq. 1/2).
    A raw exposure's two dozen CHAN image extensions therefore cost
    nothing when only the primary header or the SPARTA table is wanted,
    and extension types the codec cannot decode (ASCII tables,
    tile-compressed HDUs) only raise if their data is actually accessed.
    """
    if isinstance(source, HDUList):
        return source
    path = None
    if isinstance(source, (bytes, bytearray)):
        stream = io.BytesIO(source)
    elif hasattr(source, "read"):
        stream = source
    else:
        path = str(source)
        stream = open(path, "rb")
        import os
        fsize = os.fstat(stream.fileno()).st_size
    try:
        hdus = HDUList()
        first = True
        while True:
            hdr = _read_header(stream)
            if hdr is None:
                if first:
                    # astropy raises on an empty file too; an empty
                    # HDUList here would only defer to a confusing
                    # KeyError at the extension lookup
                    raise OSError("empty or corrupt FITS file "
                                  "(no HDUs found)")
                break
            if first:
                xt, decode, hdu = "IMAGE", _decode_image, PrimaryHDU(
                    header=hdr)
                first = False
            else:
                xt = str(hdr.get("XTENSION", "IMAGE")).strip().upper()
                if xt == "BINTABLE":
                    decode, hdu = _decode_bintable, BinTableHDU(header=hdr)
                elif xt == "IMAGE":
                    decode, hdu = _decode_image, ImageHDU(header=hdr)
                else:
                    decode, hdu = None, UnsupportedHDU(hdr, xt)
            nbytes = _payload_nbytes(hdr)
            if path is not None:
                offset = stream.tell()
                if offset + nbytes > fsize:
                    raise IOError("truncated FITS data in %r (HDU %r "
                                  "needs %d bytes past offset %d)"
                                  % (path, hdu.name, nbytes, offset))
                if decode is not None and nbytes:
                    hdu._pending = _path_loader(path, offset, nbytes,
                                                hdr, decode)
                stream.seek(nbytes + ((-nbytes) % BLOCK), io.SEEK_CUR)
            else:
                raw = stream.read(nbytes)
                if len(raw) < nbytes:
                    raise OSError("truncated FITS data (HDU %r)"
                                  % (hdu.name,))
                _skip_padding(stream, nbytes)
                if decode is not None and nbytes:
                    hdu._pending = (lambda raw=raw, hdr=hdr, d=decode:
                                    d(raw, hdr))
            hdus.append(hdu)
        return hdus
    finally:
        if not hasattr(source, "read") and not isinstance(
                source, (bytes, bytearray, HDUList)):
            stream.close()


def fits_getheader(source, ext=0):
    hdul = fits_open(source)
    return hdul[ext].header


def fits_getdata(source, extname=None):
    hdul = fits_open(source)
    return hdul[extname if extname is not None else 1].data


# ---------------------------------------------------------------------------
# writing
# ---------------------------------------------------------------------------

def _image_header(data, primary, extra=None, name=""):
    h = Header()
    dt = data.dtype if data is not None else None
    if primary:
        h.append("SIMPLE", True, "conforms to FITS standard")
    else:
        h.append("XTENSION", "IMAGE", "Image extension")
    key = None if data is None else dt.kind + str(dt.itemsize)
    if data is not None and key not in _DTYPE_TO_BITPIX:
        raise TypeError("unsupported image dtype %r (supported: uint8, "
                        "int16/32/64, float32/64)" % (dt,))
    h.append("BITPIX", _DTYPE_TO_BITPIX.get(key, 8), "array data type")
    h.append("NAXIS", 0 if data is None else data.ndim,
             "number of array dimensions")
    if data is not None:
        for k, n in enumerate(reversed(data.shape), start=1):
            h.append("NAXIS%d" % k, int(n))
    if primary:
        h.append("EXTEND", True)
    else:
        h.append("PCOUNT", 0, "number of parameters")
        h.append("GCOUNT", 1, "number of groups")
        if name:
            h.append("EXTNAME", name, "extension name")
    if extra is not None:
        for k, v, c in extra:
            # BSCALE/BZERO/BLANK are stripped: scaling was applied at
            # read time (_apply_scaling), so copying the cards back
            # would double-apply it on the next read; the writer emits
            # its own BZERO when serialising unsigned data
            if k.upper() in ("SIMPLE", "XTENSION", "BITPIX", "NAXIS",
                             "EXTEND", "PCOUNT", "GCOUNT", "BSCALE",
                             "BZERO", "BLANK") or \
                    k.upper().startswith("NAXIS"):
                continue
            h[k] = (v, c)
    return h


# unsigned table columns (like unsigned images) use the sign-flip
# convention on write: signed storage TFORM + TZEROn = 2^(bits-1)
_UNSIGNED_COLUMN = {2: ("I", 1 << 15), 4: ("J", 1 << 31), 8: ("K", 1 << 63)}


def _column_tform(dtype, shape):
    key = (dtype.kind, dtype.itemsize)
    if dtype.kind == "u" and dtype.itemsize in _UNSIGNED_COLUMN:
        code = _UNSIGNED_COLUMN[dtype.itemsize][0]
        repeat = int(np.prod(shape)) if shape else 1
        return ("%d%s" % (repeat, code)) if repeat != 1 else code
    if dtype.kind == "S":
        if shape:
            # an (S<n>, (k,)) column needs TFORM '<n*k>A' plus a TDIM to
            # round-trip the split, which this codec does not implement;
            # writing '<n>A' here would silently corrupt the row layout
            # (NAXIS1 disagrees with the TFORM sum).  No pipeline table
            # has vector strings — fail loudly rather than corrupt.
            raise TypeError("vector string columns (%r x %r) are not "
                            "supported by this FITS codec" % (dtype, shape))
        return "%dA" % dtype.itemsize
    if key not in _KIND_TO_TFORM:
        raise TypeError("unsupported column dtype %r" % (dtype,))
    code = _KIND_TO_TFORM[key]
    repeat = int(np.prod(shape)) if shape else 1
    return ("%d%s" % (repeat, code)) if repeat != 1 else code


def _bintable_bytes(hdu):
    data = hdu.data
    names = data.dtype.names
    # big-endian on-disk dtype
    fields = []
    for nm in names:
        ft, shape = data.dtype.fields[nm][0], ()
        if ft.subdtype is not None:
            base, shape = ft.subdtype
        else:
            base = ft
        # logical columns are one 'T'/'F' byte each on disk; unsigned
        # ints store sign-flipped signed values (TZEROn convention)
        if base.kind == "b":
            be = np.dtype("u1")
        elif base.kind == "u" and base.itemsize in _UNSIGNED_COLUMN:
            be = np.dtype(">i%d" % base.itemsize)
        else:
            be = base.newbyteorder(">")
        fields.append((nm, be, shape) if shape else (nm, be))
    disk_dtype = np.dtype(fields)
    disk = np.empty(len(data), dtype=disk_dtype)
    for nm in names:
        base = data.dtype.fields[nm][0]
        base = base.subdtype[0] if base.subdtype is not None else base
        if base.kind == "u" and base.itemsize in _UNSIGNED_COLUMN:
            off = _UNSIGNED_COLUMN[base.itemsize][1]
            disk[nm] = ((data[nm] ^ base.type(off))
                        .view("i%d" % base.itemsize))
        else:
            disk[nm] = data[nm]

    h = Header()
    h.append("XTENSION", "BINTABLE", "binary table extension")
    h.append("BITPIX", 8, "array data type")
    h.append("NAXIS", 2, "number of array dimensions")
    h.append("NAXIS1", disk_dtype.itemsize, "length of dimension 1")
    h.append("NAXIS2", len(data), "length of dimension 2")
    h.append("PCOUNT", 0, "number of group parameters")
    h.append("GCOUNT", 1, "number of groups")
    h.append("TFIELDS", len(names), "number of table fields")
    for k, nm in enumerate(names, start=1):
        ft = data.dtype.fields[nm][0]
        if ft.subdtype is not None:
            base, shape = ft.subdtype
        else:
            base, shape = ft, ()
        h.append("TTYPE%d" % k, nm)
        h.append("TFORM%d" % k, _column_tform(base, shape))
        if base.kind == "u" and base.itemsize in _UNSIGNED_COLUMN:
            h.append("TZERO%d" % k, _UNSIGNED_COLUMN[base.itemsize][1],
                     "offset for unsigned integers")
            h.append("TSCAL%d" % k, 1, "default scaling factor")
    if hdu.name:
        h.append("EXTNAME", hdu.name, "extension name")
    for key, val, com in hdu.header._cards:
        # TSCAL/TZERO/TNULL are stripped like the image BSCALE/BZERO:
        # scaling was applied at read time, copying the cards back
        # would double-apply it on the next read
        if key in ("XTENSION", "BITPIX", "NAXIS", "NAXIS1", "NAXIS2",
                   "PCOUNT", "GCOUNT", "TFIELDS", "EXTNAME") or \
                key.startswith(("TTYPE", "TFORM", "TDIM", "TSCAL",
                                "TZERO", "TNULL")):
            continue
        h[key] = (val, com)

    # logical columns: bool -> ASCII 'T'/'F' bytes (FITS standard)
    for nm in names:
        ft = data.dtype.fields[nm][0]
        base = ft.subdtype[0] if ft.subdtype is not None else ft
        if base.kind == "b":
            disk[nm] = np.where(data[nm], ord("T"), ord("F"))

    raw = disk.tobytes()
    pad = (-len(raw)) % BLOCK
    return h.tobytes() + raw + b"\x00" * pad


def _image_bytes(hdu, primary):
    data = hdu.data
    bzero = None
    if data is not None:
        data = np.asarray(data)
        if data.dtype.kind == "f" and data.dtype.itemsize not in (4, 8):
            data = data.astype("f8")
        if data.dtype.kind == "b":
            data = data.astype("u1")
        if data.dtype.kind == "u" and data.dtype.itemsize in (2, 4, 8):
            # unsigned convention: store sign-flipped signed ints plus
            # a BZERO card (the exact inverse of _apply_scaling)
            bzero = 1 << (8 * data.dtype.itemsize - 1)
            data = ((data ^ data.dtype.type(bzero))
                    .view("i%d" % data.dtype.itemsize))
    extra = (list(hdu.header._cards) if hdu.header is not None
             else None)                 # (key, value, comment) triples
    h = _image_header(data, primary, extra=extra,
                      name=getattr(hdu, "name", ""))
    if bzero is not None:
        h["BSCALE"] = (1, "default scaling factor")
        h["BZERO"] = (bzero, "offset data range to that of unsigned int")
    out = h.tobytes()
    if data is not None:
        raw = data.astype(data.dtype.newbyteorder(">")).tobytes()
        pad = (-len(raw)) % BLOCK
        out += raw + b"\x00" * pad
    return out


def _serialize_hdulist(hdus):
    out = b""
    for i, hdu in enumerate(hdus):
        if isinstance(hdu, BinTableHDU):
            if i == 0:
                out += _image_bytes(PrimaryHDU(), primary=True)
            out += _bintable_bytes(hdu)
        else:
            out += _image_bytes(hdu, primary=(i == 0))
    return out
