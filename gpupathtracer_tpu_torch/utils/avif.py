"""AVIF at open, as Pillow 12.1.0's AvifImagePlugin opens it: its
``_avif.AvifDecoder`` runs libavif 1.3.0's ``avifDecoderParse`` (the
ISOBMFF parse, then ``avifDecoderReset``) and ``get_info`` reads the size,
the frame count and RGB or RGBA from it. Nothing of the AV1 payload is
decoded here (ROADMAP.md C6): a file libavif parses is AVIF, and
utils/io.py raises NotImplementedError naming it.

- The top-level boxes (avifParse): ``ftyp`` (its brands: avif or avis
  needed), ``meta`` and ``moov`` read whole, other boxes skipped, the
  early end once what the brands need is there.
- ``meta`` (avifParseMetaBox): ``hdlr`` first ('pict'), ``iloc``
  (versions 0-2, field sizes, construction methods), ``pitm``, ``idat``,
  ``iinf`` / ``infe``, ``iref`` and ``iprp`` with ``ipco`` and ``ipma``
  (the essential flags), each at most once.
- The properties libavif parses: ``ispe``, ``auxC``, ``colr``, ``av1C``,
  ``pasp``, ``clap``, ``irot``, ``imir``, ``pixi``, ``a1op``, ``lsel``,
  ``a1lx``, ``clli``; the rest kept opaque.
- ``moov`` (avifParseMovieBox): ``trak`` with ``tkhd``, ``mdia`` /
  ``mdhd`` / ``minf`` / ``stbl`` (``stco``, ``co64``, ``stsc``, ``stsz``,
  ``stss``, ``stts``, ``stsd`` with its sample entries' properties),
  ``tref`` and ``edts``.
- avifDecoderParse's ispe checks, then avifDecoderReset: the source (the
  major brand), the primary colour item or colour track, the alpha item
  (``auxl`` and an alpha ``auxC``) or track, grids, each item's and
  sample's extent against the file's length, the ``colr`` boxes, and the
  mandatory ``av1C`` with ``pixi``'s depths.

libavif's results that Pillow turns into SyntaxError (BMFF parsing
failed, truncated data, an invalid ftyp, no content) pass the file on to
the next plugin; the others stop PIL (RuntimeError, ValueError), as does
the decompression-bomb check on the size. Nothing here imports PIL or the
JAX package.
"""

from __future__ import annotations

import struct

SIZE_LIMIT = 16384 * 16384       # AVIF_DEFAULT_IMAGE_SIZE_LIMIT
DIMENSION_LIMIT = 32768          # AVIF_DEFAULT_IMAGE_DIMENSION_LIMIT
COUNT_LIMIT = 12 * 3600 * 60     # AVIF_DEFAULT_IMAGE_COUNT_LIMIT
VISUAL_SAMPLE_ENTRY = 78
ALPHA_URNS = (b"urn:mpeg:mpegB:cicp:systems:auxiliary:alpha",
              b"urn:mpeg:hevc:2015:auxid:1")


class AvifError(Exception):
    """An avifResult other than OK; ``syntax`` where Pillow raises
    SyntaxError for it."""

    def __init__(self, result: str, why: str = "", syntax: bool = None):
        super().__init__(f"{result}: {why}" if why else result)
        self.syntax = syntax if syntax is not None else result in (
            "BMFF parsing failed", "Truncated data", "Invalid ftyp",
            "No content")


def _parse_failed(why: str = ""):
    return AvifError("BMFF parsing failed", why)


class _Stream:
    """avifROStream: bytes, an offset, and a partial byte for bit reads."""

    def __init__(self, data: bytes, start: int = 0, end: int = None):
        self.d = data
        self.pos = start
        self.end = len(data) if end is None else end
        self.bits = 0                 # bits used in the partial byte

    def left(self) -> int:
        return self.end - self.pos

    def _need(self, n: int) -> None:
        if self.bits:
            raise _parse_failed("a byte read inside a partial byte")
        if n > self.left():
            raise _parse_failed(f"Failed to read {n} bytes, truncated data?")

    def read(self, n: int) -> bytes:
        self._need(n)
        out = self.d[self.pos:self.pos + n]
        self.pos += n
        return out

    def u(self, n: int) -> int:
        return int.from_bytes(self.read(n), "big")

    def ux8(self, factor: int) -> int:
        if factor == 0:
            return 0
        if factor not in (1, 2, 4, 8):
            raise _parse_failed("an unsupported field size")
        return self.u(factor)

    def bits_u(self, count: int) -> int:
        v = 0
        for _ in range(count):
            if self.bits == 0:
                if self.left() < 1:
                    raise _parse_failed("Failed to read bits")
            byte = self.d[self.pos]
            v = (v << 1) | ((byte >> (7 - self.bits)) & 1)
            self.bits += 1
            if self.bits == 8:
                self.bits = 0
                self.pos += 1
        return v

    def skip(self, n: int) -> None:
        self._need(n)
        self.pos += n

    def version_flags(self) -> tuple:
        return self.u(1), self.u(3)

    def enforce_version(self, want: int) -> int:
        v, flags = self.version_flags()
        if v != want:
            raise _parse_failed(f"Expecting box version {want}, got {v}")
        return flags

    def string(self) -> bytes:
        self._need(0)
        at = self.d.find(b"\0", self.pos, self.end)
        if at < 0:
            raise _parse_failed("a string without its NUL")
        out = self.d[self.pos:at]
        self.pos = at + 1
        return out

    def box_header(self, top: bool = False):
        """(type, body size) or (type, None) for a size-0 top-level box."""
        start = self.pos
        size = self.u(4)
        typ = self.read(4)
        if size == 1:
            size = self.u(8)
        if typ == b"uuid":
            self.read(16)
        used = self.pos - start
        if size == 0:
            if not top:
                raise _parse_failed("Non-top-level box with size 0")
            return typ, None
        if size < used:
            raise _parse_failed("Header size overflow check failure")
        body = size - used
        if not top and body > self.left():
            raise _parse_failed("Child box too large, possibly truncated")
        return typ, body


class _Item:
    def __init__(self, item_id: int):
        self.id = item_id
        self.type = b"\0\0\0\0"
        self.size = 0
        self.extents = []
        self.props = []               # (type, parsed value)
        self.ipma_seen = False
        self.unsupported_essential = False
        self.thumbnail_for = self.aux_for = self.desc_for = 0
        self.dimg_for = 0
        self.has_dimg_from = False
        self.idat_stored = False
        self.width = self.height = 0
        self.content_type = b""

    def prop(self, typ: bytes):
        return next((v for t, v in self.props if t == typ), None)


class _Meta:
    def __init__(self):
        self.items = []
        self.props = []               # (type, value, opaque)
        self.primary = 0
        self.idat = b""

    def item(self, item_id: int) -> _Item:
        for it in self.items:
            if it.id == item_id:
                return it
        it = _Item(item_id)
        self.items.append(it)
        return it


def _check_id(item_id: int) -> None:
    if item_id == 0:
        raise _parse_failed("an item ID of 0")


# --- properties (avifParseItemPropertyContainerBox) --------------------------

_PARSED = (b"ispe", b"auxC", b"auxi", b"colr", b"av1C", b"pasp", b"clap",
           b"irot", b"imir", b"pixi", b"a1op", b"lsel", b"a1lx", b"clli")


def _prop(typ: bytes, s: _Stream):
    """A parsed property's value, or raises; None for an opaque one."""
    if typ == b"ispe":
        s.enforce_version(0)
        return s.u(4), s.u(4)
    if typ in (b"auxC", b"auxi"):
        s.enforce_version(0)
        return s.string()
    if typ == b"colr":
        kind = s.read(4)
        if kind in (b"rICC", b"prof"):
            return ("icc", s.left())
        if kind == b"nclx":
            s.u(2), s.u(2), s.u(2)
            s.bits_u(1)
            if s.bits_u(7):
                raise _parse_failed("Box[colr] contains nonzero reserved bits")
            return ("nclx",)
        return ("other",)
    if typ == b"av1C":
        return _av1c(s)
    if typ == b"pasp":
        return s.u(4), s.u(4)
    if typ == b"clap":
        return tuple(s.u(4) for _ in range(8))
    if typ == b"irot":
        angle = s.u(1)
        if angle & 0xFC:
            raise _parse_failed("Box[irot] contains nonzero reserved bits")
        return angle
    if typ == b"imir":
        mode = s.u(1)
        if mode & 0xFE:
            raise _parse_failed("Box[imir] contains nonzero reserved bits")
        return mode
    if typ == b"pixi":
        s.enforce_version(0)
        n = s.u(1)
        if n < 1 or n > 4:
            raise _parse_failed("Box[pixi] contains unsupported plane count")
        depths = []
        for _ in range(n):
            depths.append(s.u(1))
            if depths[-1] != depths[0]:
                raise _parse_failed("Box[pixi] mismatched plane depths")
        return depths
    if typ == b"a1op":
        op = s.u(1)
        if op > 31:
            raise _parse_failed("Box[a1op] contains an unsupported index")
        return op
    if typ == b"lsel":
        layer = s.u(2)
        if layer != 0xFFFF and layer >= 4:
            raise _parse_failed("Box[lsel] contains an unsupported layer")
        return layer
    if typ == b"a1lx":
        if s.bits_u(7):
            raise _parse_failed("Box[a1lx] contains nonzero reserved bits")
        large = s.bits_u(1)
        return tuple(s.u(4 if large else 2) for _ in range(3))
    if typ == b"clli":
        return s.u(2), s.u(2)
    return None


def _av1c(s: _Stream) -> dict:
    if not s.bits_u(1):
        raise _parse_failed("av1C contains illegal marker")
    if s.bits_u(7) != 1:
        raise _parse_failed("av1C contains illegal version")
    c = {"profile": s.bits_u(3)}
    s.bits_u(5)
    s.bits_u(1)
    c["high"] = s.bits_u(1)
    c["twelve"] = s.bits_u(1)
    c["mono"] = s.bits_u(1)
    c["ssx"] = s.bits_u(1)
    c["ssy"] = s.bits_u(1)
    c["pos"] = s.bits_u(2)
    s.bits_u(8)                 # reserved bits and delay, unchecked
    c["depth"] = 12 if c["twelve"] else 10 if c["high"] else 8
    return c


def _ipco(s: _Stream, end: int, props: list) -> None:
    while s.pos < end:
        typ, size = s.box_header()
        body = _Stream(s.d, s.pos, s.pos + size)
        value = _prop(typ, body)
        props.append((typ, value, typ not in _PARSED))
        s.skip(size)


_MUST_NOT_BE_ESSENTIAL = (b"a1lx",)
_MUST_BE_ESSENTIAL = (b"a1op", b"lsel", b"clap", b"irot", b"imir")


def _ipma(meta: _Meta, s: _Stream) -> int:
    version, flags = s.version_flags()
    wide = flags & 1
    count = s.u(4)
    prev = 0
    for _ in range(count):
        item_id = s.u(2) if version < 1 else s.u(4)
        _check_id(item_id)
        if item_id <= prev:
            raise _parse_failed("Box[ipma] item IDs are not increasing")
        prev = item_id
        item = meta.item(item_id)
        if item.ipma_seen:
            raise _parse_failed("Duplicate Box[ipma]")
        item.ipma_seen = True
        for _ in range(s.u(1)):
            essential = s.bits_u(1)
            index = s.bits_u(15 if wide else 7)
            if index == 0:
                if essential:
                    raise _parse_failed("an essential property index 0")
                continue
            index -= 1
            if index >= len(meta.props):
                raise _parse_failed("Box[ipma] contains an illegal index")
            typ, value, opaque = meta.props[index]
            if not opaque:
                if essential and typ in _MUST_NOT_BE_ESSENTIAL:
                    raise _parse_failed(f"{typ} must not be essential")
                if not essential and typ in _MUST_BE_ESSENTIAL:
                    raise _parse_failed(f"{typ} must be essential")
                item.props.append((typ, value))
            elif essential:
                item.unsupported_essential = True
    return (version << 24) | flags


def _iprp(meta: _Meta, s: _Stream, end: int) -> None:
    typ, size = s.box_header()
    if typ != b"ipco":
        raise _parse_failed("Failed to find Box[ipco] first in Box[iprp]")
    _ipco(_Stream(s.d, s.pos, s.pos + size), s.pos + size, meta.props)
    s.skip(size)
    seen = []
    while s.pos < end:
        typ, size = s.box_header()
        if typ != b"ipma":
            raise _parse_failed("Box[iprp] contains a box that isn't ipma")
        vf = _ipma(meta, _Stream(s.d, s.pos, s.pos + size))
        if vf in seen:
            raise _parse_failed("Multiple Box[ipma] with one version/flags")
        if len(seen) == 2:
            raise _parse_failed("Exceeded possible count of ipma tuples")
        seen.append(vf)
        s.skip(size)


# --- meta --------------------------------------------------------------------

def _iloc(meta: _Meta, s: _Stream) -> None:
    version, _ = s.version_flags()
    if version > 2:
        raise _parse_failed("Box[iloc] has an unsupported version")
    offset_size, length_size = s.bits_u(4), s.bits_u(4)
    base_size = s.bits_u(4)
    index_size = s.bits_u(4) if version in (1, 2) else (s.bits_u(4) and 0)
    for v in (offset_size, length_size, base_size, index_size):
        if v not in (0, 4, 8):
            raise _parse_failed("Box[iloc] has an invalid field size")
    count = s.u(2) if version < 2 else s.u(4)
    for _ in range(count):
        item_id = s.u(2) if version < 2 else s.u(4)
        _check_id(item_id)
        item = meta.item(item_id)
        if item.extents:
            raise _parse_failed("an item with duplicate sets of extents")
        if version in (1, 2):
            s.bits_u(12)
            method = s.bits_u(4)
            if method not in (0, 1):
                raise _parse_failed("an unsupported construction method")
            item.idat_stored = method == 1
        s.u(2)                               # data_reference_index
        base = s.ux8(base_size)
        for _ in range(s.u(2)):
            if version in (1, 2) and index_size > 0:
                s.ux8(index_size)
            off = s.ux8(offset_size)
            length = s.ux8(length_size)
            if off > (1 << 64) - 1 - base:
                raise _parse_failed("an extent offset which overflows")
            item.extents.append((base + off, length))
            item.size += length


def _iinf(meta: _Meta, s: _Stream) -> None:
    version, _ = s.version_flags()
    if version == 0:
        count = s.u(2)
    elif version == 1:
        count = s.u(4)
    else:
        raise _parse_failed("Box[iinf] has an unsupported version")
    for _ in range(count):
        typ, size = s.box_header()
        if typ != b"infe":
            raise _parse_failed("Box[iinf] contains a box that isn't infe")
        e = _Stream(s.d, s.pos, s.pos + size)
        v, _ = e.version_flags()
        if v not in (2, 3):
            raise _parse_failed("Box[infe]: expecting version 2 or 3")
        item_id = e.u(2) if v == 2 else e.u(4)
        _check_id(item_id)
        e.u(2)
        item_type = e.read(4)
        e.string()
        content = e.string() if item_type == b"mime" else b""
        item = meta.item(item_id)
        item.type, item.content_type = item_type, content
        s.skip(size)


def _iref(meta: _Meta, s: _Stream, end: int) -> None:
    version, _ = s.version_flags()
    if version > 1:
        return
    while s.pos < end:
        typ, _ = s.box_header()
        from_id = s.u(2) if version == 0 else s.u(4)
        _check_id(from_id)
        item = meta.item(from_id)
        if typ == b"dimg":
            if item.has_dimg_from:
                raise _parse_failed("duplicate dimg boxes with one from_ID")
            item.has_dimg_from = True
        for _ in range(s.u(2)):
            to_id = s.u(2) if version == 0 else s.u(4)
            _check_id(to_id)
            if typ == b"thmb":
                item.thumbnail_for = to_id
            elif typ == b"auxl":
                item.aux_for = to_id
            elif typ == b"cdsc":
                item.desc_for = to_id
            elif typ == b"dimg":
                dimg = meta.item(to_id)
                if dimg.dimg_for == from_id:
                    raise _parse_failed("a to_item_ID present twice")
                dimg.dimg_for = from_id


def _hdlr(s: _Stream, pict: bool) -> None:
    """avifParseHandlerBox; the meta box's must be 'pict'."""
    s.enforce_version(0)
    if s.u(4) != 0:
        raise _parse_failed("Box[hdlr] pre_defined is nonzero")
    if s.read(4) != b"pict" and pict:
        raise _parse_failed("Box[hdlr] handler_type is not 'pict'")
    s.u(4), s.u(4), s.u(4)
    s.string()


def _meta(meta: _Meta, s: _Stream, end: int) -> None:
    s.enforce_version(0)
    first, seen = True, set()
    while s.pos < end:
        typ, size = s.box_header()
        body_end = s.pos + size
        body = _Stream(s.d, s.pos, body_end)

        def unique(name):
            if name in seen:
                raise _parse_failed(f"a duplicate unique box {name}")
            seen.add(name)
        if first:
            if typ != b"hdlr":
                raise _parse_failed("Box[meta] does not start with hdlr")
            unique(typ)
            _hdlr(body, True)
            first = False
        elif typ == b"iloc":
            unique(typ)
            _iloc(meta, body)
        elif typ == b"pitm":
            unique(typ)
            if meta.primary > 0:
                raise _parse_failed("Multiple boxes of unique Box[pitm]")
            v, _ = body.version_flags()
            meta.primary = body.u(2) if v == 0 else body.u(4)
        elif typ == b"idat":
            unique(typ)
            if size == 0:
                raise _parse_failed("idat box has a length of 0")
            meta.idat = s.d[s.pos:body_end]
        elif typ == b"iprp":
            unique(typ)
            _iprp(meta, body, body_end)
        elif typ == b"iinf":
            unique(typ)
            _iinf(meta, body)
        elif typ == b"iref":
            unique(typ)
            _iref(meta, body, body_end)
        s.skip(size)
    if first:
        raise _parse_failed("Box[meta] has no child boxes")


# --- moov --------------------------------------------------------------------

class _Track:
    def __init__(self):
        self.id = 0
        self.width = self.height = 0
        self.aux_for = 0
        self.chunks = []
        self.stsc = []
        self.sizes = []
        self.all_size = 0
        self.entries = []             # (format, properties)
        self.has_stbl = False
        self.meta = None


def _stbl(t: _Track, s: _Stream, end: int) -> None:
    if t.has_stbl:
        raise _parse_failed("Duplicate Box[stbl] for a track")
    t.has_stbl = True
    while s.pos < end:
        typ, size = s.box_header()
        b = _Stream(s.d, s.pos, s.pos + size)
        if typ in (b"stco", b"co64"):
            b.enforce_version(0)
            for _ in range(b.u(4)):
                t.chunks.append(b.u(4 if typ == b"stco" else 8))
        elif typ == b"stsc":
            b.enforce_version(0)
            prev = 0
            for i in range(b.u(4)):
                first, per = b.u(4), b.u(4)
                b.u(4)
                if (i == 0 and first != 1) or (i and first <= prev):
                    raise _parse_failed("Box[stsc] chunks out of order")
                prev = first
                t.stsc.append((first, per))
        elif typ == b"stsz":
            b.enforce_version(0)
            t.all_size = b.u(4)
            n = b.u(4)
            if t.all_size == 0:
                t.sizes = [b.u(4) for _ in range(n)]
        elif typ in (b"stss", b"stts"):
            b.enforce_version(0)
            for _ in range(b.u(4)):
                b.u(4)
                if typ == b"stts":
                    b.u(4)
        elif typ == b"stsd":
            b.enforce_version(0)
            for _ in range(b.u(4)):
                fmt, esize = b.box_header()
                props = []
                if fmt == b"av01":
                    if esize < VISUAL_SAMPLE_ENTRY:
                        raise _parse_failed("Not enough bytes for a "
                                            "VisualSampleEntry")
                    sub = _Stream(s.d, b.pos + VISUAL_SAMPLE_ENTRY,
                                  b.pos + esize)
                    raw = []
                    _ipco(sub, sub.end, raw)
                    props = [(ty, v) for ty, v, opaque in raw if not opaque]
                t.entries.append((fmt, props))
                b.skip(esize)
        s.skip(size)


def _trak(tracks: list, s: _Stream, end: int) -> None:
    t = _Track()
    tracks.append(t)
    seen = set()
    tkhd = edts = False
    duration = None
    repeating = False
    while s.pos < end:
        typ, size = s.box_header()
        body_end = s.pos + size
        b = _Stream(s.d, s.pos, body_end)
        if typ in (b"tkhd", b"meta", b"mdia", b"tref", b"edts"):
            if typ in seen:
                raise _parse_failed(f"a duplicate {typ} in Box[trak]")
            seen.add(typ)
        if typ == b"tkhd":
            v, _ = b.version_flags()
            if v == 1:
                b.u(8), b.u(8)
                tid = b.u(4)
                b.u(4)
                duration = b.u(8)
            elif v == 0:
                b.u(4), b.u(4)
                tid = b.u(4)
                b.u(4)
                duration = b.u(4)      # 0xFFFFFFFF: indefinite, not 0
            else:
                raise _parse_failed("Box[tkhd] has an unsupported version")
            b.skip(52)
            w, h = b.u(4) >> 16, b.u(4) >> 16
            if w == 0 or h == 0:
                raise _parse_failed("a track of an invalid size")
            if _too_large(w, h):
                raise _parse_failed("track dimensions are too large")
            t.width, t.height, t.id = w, h, tid
            tkhd = True
        elif typ == b"meta":
            t.meta = _Meta()
            _meta(t.meta, b, body_end)
        elif typ == b"mdia":
            _mdia(t, b, body_end)
        elif typ == b"tref":
            while b.pos < body_end:
                rtyp, rsize = b.box_header()
                r = _Stream(s.d, b.pos, b.pos + rsize)
                ids = [r.u(4) for _ in range(rsize // 4)]
                if rtyp == b"auxl" and ids:
                    t.aux_for = ids[0]
                b.skip(rsize)
        elif typ == b"edts":
            repeating = _edts(b, body_end)
            edts = True
        s.skip(size)
    if not tkhd:
        raise _parse_failed("Box[trak] does not contain a tkhd box")
    if edts and repeating and duration == 0:
        raise _parse_failed("Invalid track duration 0.")


def _edts(b: _Stream, end: int) -> bool:
    """avifParseEditBox: whether its one elst repeats."""
    elst = False
    repeating = False
    while b.pos < end:
        typ, size = b.box_header()
        if typ == b"elst":
            if elst:
                raise _parse_failed("more than one elst box")
            e = _Stream(b.d, b.pos, b.pos + size)
            v, flags = e.version_flags()
            if v > 1:
                raise _parse_failed("Box[elst] has an unsupported version")
            repeating = bool(flags & 1)
            if e.u(4) != 1:
                raise _parse_failed("Box[elst] has more than one entry")
            if v == 1:
                seg = e.u(8)
                e.u(8)
            else:
                seg = e.u(4)
                e.u(4)
            e.u(2), e.u(2)
            if repeating and seg == 0:
                raise _parse_failed("Box[elst] repeats a segment of 0")
            elst = True
        b.skip(size)
    if not elst:
        raise _parse_failed("Box[edts] contains no elst box")
    return repeating


def _mdia(t: _Track, s: _Stream, end: int) -> None:
    seen = set()
    while s.pos < end:
        typ, size = s.box_header()
        b = _Stream(s.d, s.pos, s.pos + size)
        if typ in (b"mdhd", b"minf"):
            if typ in seen:
                raise _parse_failed(f"a duplicate {typ} in Box[mdia]")
            seen.add(typ)
        if typ == b"hdlr":
            _hdlr(b, False)
        elif typ == b"mdhd":
            v, _ = b.version_flags()
            if v == 1:
                b.u(8), b.u(8), b.u(4), b.u(8)
            elif v == 0:
                b.u(4), b.u(4), b.u(4), b.u(4)
            else:
                raise _parse_failed("Box[mdhd] has an unsupported version")
        elif typ == b"minf":
            stbl = False
            while b.pos < b.end:
                mtyp, msize = b.box_header()
                if mtyp == b"stbl":
                    if stbl:
                        raise _parse_failed("a duplicate stbl in Box[minf]")
                    stbl = True
                    _stbl(t, _Stream(s.d, b.pos, b.pos + msize),
                          b.pos + msize)
                b.skip(msize)
        s.skip(size)


def _too_large(w: int, h: int) -> bool:
    return w > SIZE_LIMIT // h or w > DIMENSION_LIMIT or h > DIMENSION_LIMIT


# --- avifParse, avifDecoderParse, avifDecoderReset ---------------------------

def _parse(d: bytes) -> tuple:
    """avifParse: (major brand, meta, tracks)."""
    pos, n = 0, len(d)
    ftyp = meta_seen = moov_seen = False
    major, brands = b"", []
    meta, tracks = _Meta(), []
    need_meta = need_moov = False
    while True:
        if pos > n:
            raise _parse_failed("Exceeded avifIO's sizeHint")
        if pos == n:
            break
        head = _Stream(d, pos, min(n, pos + 32))
        typ, size = head.box_header(top=True)
        pos = head.pos
        if typ in (b"ftyp", b"meta", b"moov"):
            if size is None:
                size = n - pos
            elif n - pos < size:
                raise AvifError("Truncated data")
            body = _Stream(d, pos, pos + size)
            if typ == b"ftyp":
                if ftyp:
                    raise _parse_failed("a second ftyp box")
                major = body.read(4)
                body.u(4)
                if body.left() % 4:
                    raise _parse_failed("Box[ftyp] brands not in 4s")
                brands = [major] + [body.read(4) for _ in range(
                    body.left() // 4)]
                if b"avif" not in brands and b"avis" not in brands:
                    raise AvifError("Invalid ftyp")
                ftyp = True
                need_meta = b"avif" in brands
                need_moov = b"avis" in brands
            elif typ == b"meta":
                if meta_seen:
                    raise _parse_failed("a second meta box")
                _meta(meta, body, pos + size)
                meta_seen = True
            else:
                if moov_seen:
                    raise _parse_failed("a second moov box")
                _moov(tracks, body, pos + size)
                moov_seen = True
        elif size is None:
            break
        pos += size
        if ftyp and (not need_meta or meta_seen) and (
                not need_moov or moov_seen):
            return major, meta, tracks
    if not ftyp:
        raise AvifError("Invalid ftyp")
    if (need_meta and not meta_seen) or (need_moov and not moov_seen):
        raise AvifError("Truncated data")
    return major, meta, tracks


def _moov(tracks: list, s: _Stream, end: int) -> None:
    has = False
    while s.pos < end:
        typ, size = s.box_header()
        if typ == b"trak":
            _trak(tracks, _Stream(s.d, s.pos, s.pos + size), s.pos + size)
            has = True
        s.skip(size)
    if not has:
        raise _parse_failed("Box[moov] has no trak boxes")


def _image_type(t: bytes) -> bool:
    return t == b"av01"


def _alpha(item) -> bool:
    aux = item.prop(b"auxC")
    return aux is not None and aux in ALPHA_URNS


def open_info(d: bytes) -> tuple:
    """avifDecoderParse and get_info: (width, height, frames, mode).
    Raises AvifError."""
    major, meta, tracks = _parse(d)
    for item in meta.items:
        if not item.size or item.unsupported_essential:
            continue
        if not _image_type(item.type) and item.type != b"grid":
            continue
        ispe = item.prop(b"ispe")
        if ispe is not None:
            item.width, item.height = ispe
            if item.width == 0 or item.height == 0:
                raise _parse_failed("an item of an invalid size")
            if _too_large(item.width, item.height):
                raise _parse_failed("item dimensions are too large")
        elif not _alpha(item):
            raise _parse_failed("an item without its mandatory ispe")
        else:
            raise _parse_failed("an alpha item without its ispe")
    if major == b"avis" or (major != b"avif" and tracks):
        return _reset_tracks(d, tracks)
    return _reset_items(d, meta)


def _reset_tracks(d: bytes, tracks: list) -> tuple:
    def usable(t):
        return t.has_stbl and t.id and t.chunks and any(
            f == b"av01" for f, _ in t.entries)
    color = next((t for t in tracks if usable(t) and not t.aux_for), None)
    if color is None:
        raise AvifError("No content", "Failed to find AV1 color track")
    props = next(p for f, p in color.entries if f == b"av01")
    if color.meta is not None:
        _metadata(d, color.meta, 0)
    def alpha_aux(t):                    # an auxi box, if any, says alpha
        auxi = next((v for f, p in t.entries if f == b"av01"
                     for ty, v in p if ty == b"auxi"), None)
        return auxi is None or auxi in ALPHA_URNS
    alpha = next((t for t in tracks if usable(t) and t.aux_for == color.id
                  and alpha_aux(t)), None)
    samples = _samples(d, color)
    sizes = [n for _, n in samples]
    if alpha is not None:
        sizes += [n for _, n in _samples(d, alpha)]
    _check_props(props, sizes)
    if not _nclx(props) and samples:
        off, n = samples[0]
        _search_sequence_header(lambda k: d[off:off + k], n)
    _need_av1c(props)
    return color.width, color.height, len(samples), (
        "RGBA" if alpha is not None else "RGB")


def _samples(d: bytes, t: _Track) -> list:
    """avifCodecDecodeInputFillFromSampleTable: each sample's (offset,
    size)."""
    def per_chunk(i):
        n = 0
        for first, per in t.stsc:
            if first > i + 1:
                break
            n = per
        return n
    left = COUNT_LIMIT
    for i in range(len(t.chunks)):
        c = per_chunk(i)
        if c == 0:
            raise _parse_failed("a chunk with 0 samples")
        if c > left:
            raise _parse_failed("Exceeded avifDecoder's imageCountLimit")
        left -= c
    out, k = [], 0
    for i, off in enumerate(t.chunks):
        for _ in range(per_chunk(i)):
            size = t.all_size
            if size == 0:
                if k >= len(t.sizes):
                    raise _parse_failed("Truncated sample table")
                size = t.sizes[k]
            if off + size > len(d):
                raise _parse_failed("Exceeded avifIO's sizeHint")
            out.append((off, size))
            off += size
            k += 1
    return out


def _skipped(item) -> bool:
    """avifDecoderItemShouldBeSkipped."""
    return (not item.size or item.unsupported_essential or (
        not _image_type(item.type) and item.type != b"grid") or
        item.thumbnail_for != 0)


def _reset_items(d: bytes, meta: _Meta) -> tuple:
    if meta.primary == 0:
        raise AvifError("Missing image item", "Primary item not specified")
    color = next((it for it in meta.items if not _skipped(it) and
                  it.id == meta.primary), None)
    if color is None:
        raise AvifError("Missing image item", "Primary item not found")
    if color.type == b"grid":
        _grid(d, meta, color)
    alpha = next((it for it in meta.items if not _skipped(it) and
                  it.aux_for == color.id and _alpha(it)), None)
    _metadata(d, meta, color.id)
    tiles = []
    for it in (color, alpha):
        if it is None:
            continue
        _validate(it)
        parts = [t for t in meta.items if t.dimg_for == it.id] \
            if it.type == b"grid" else [it]
        for t in parts:
            if t.size > len(d):
                raise _parse_failed("Exceeded avifIO's sizeHint")
            tiles.append(t)
    _check_props(color.props, [t.size for t in tiles])
    if not _nclx(color.props):
        _search_sequence_header(
            lambda n: _item_bytes(d, meta, tiles[0], n), tiles[0].size)
    _need_av1c(color.props)
    return color.width, color.height, 1, (
        "RGBA" if alpha is not None else "RGB")


def _grid(d: bytes, meta: _Meta, item) -> None:
    """The grid item's payload (avifParseImageGridBox) and its tiles."""
    g = _Stream(_item_bytes(d, meta, item, item.size))
    if g.u(1) != 0:
        raise _parse_failed("Box[grid] has unsupported version")
    flags = g.u(1)
    rows, cols = g.u(1) + 1, g.u(1) + 1
    field = 4 if flags & 1 else 2
    w, h = g.u(field), g.u(field)
    if w == 0 or h == 0 or _too_large(w, h) or g.left():
        raise _parse_failed("Grid box contains illegal dimensions")
    parts = [t for t in meta.items if t.dimg_for == item.id]
    if len(parts) != rows * cols:
        raise _parse_failed("a grid whose tile count differs from its "
                            "rows and columns")
    for t in parts:
        if not _image_type(t.type) or t.unsupported_essential:
            raise _parse_failed("a grid tile that is not an AV1 image")
        if t.prop(b"av1C") is None:
            raise _parse_failed("a grid tile without its av1C")
    item.width, item.height = w, h


def _item_bytes(d: bytes, meta: _Meta, item, n: int) -> bytes:
    """avifDecoderItemRead of the item's first n bytes."""
    if not item.extents:
        raise AvifError("Truncated data", "an item with zero extents")
    if item.idat_stored and not meta.idat:
        raise AvifError("No content", "an idat item without an idat box")
    if item.size > len(d):
        raise AvifError("Truncated data", "an item larger than the file")
    out, left = b"", min(n, item.size)
    for off, size in item.extents:
        take = min(size, left)
        if item.idat_stored:
            if off > len(meta.idat) or size > len(meta.idat) - off:
                raise _parse_failed("an impossible extent in idat")
            out += meta.idat[off:off + take]
        else:
            if off > len(d):
                raise _parse_failed("an extent offset beyond the file")
            got = d[off:off + take]
            if len(got) != take:
                raise AvifError("Truncated data", "a short item read")
            out += got
        left -= take
        if left == 0:
            break
    if left:
        raise AvifError("Truncated data", "unexpected trailing bytes")
    return out


def _metadata(d: bytes, meta: _Meta, color_id: int) -> None:
    """avifDecoderFindMetadata: each Exif item (its TIFF header where its
    exif_tiff_header_offset says) and XMP item describing the colour item
    (any, for a track's meta: color_id 0) read whole; then Pillow's
    Image.Exif.load, which needs the TIFF header first."""
    for item in meta.items:
        if not item.size or item.unsupported_essential:
            continue
        if color_id and item.desc_for != color_id:
            continue
        if item.type == b"Exif":
            body = _item_bytes(d, meta, item, item.size)
            if len(body) < 4:
                raise AvifError("Invalid Exif payload")
            want, rest = int.from_bytes(body[:4], "big"), body[4:]
            at = next((k for k in range(max(len(rest) - 4, 0))
                       if rest[k:k + 4] in (b"MM\0*", b"II*\0")), None)
            if at is None or at != want:
                raise AvifError("Invalid Exif payload")
            while rest.startswith(b"Exif\0\0"):
                rest = rest[6:]
            if rest and rest[:4] not in (b"MM\0*", b"II*\0", b"MM*\0",
                                         b"II\0*", b"MM\0+", b"II+\0"):
                raise AvifError("Pillow's Exif", "not a TIFF file",
                                syntax=True)
        elif item.type == b"mime" and \
                item.content_type == b"application/rdf+xml":
            _item_bytes(d, meta, item, item.size)


def _nclx(props) -> bool:
    return any(t == b"colr" and v[0] == "nclx" for t, v in props)


def _search_sequence_header(read, size: int) -> None:
    """avifDecoderReset's search for the CICP of the first sample's AV1
    sequence header, where no nclx colr gave it: reads of 64, 128, ...
    bytes (at most 4096, at most the sample) until one parses."""
    n = 0
    while True:
        n = min(n + 64, size)
        if _sequence_header(read(n)):
            return
        if n == size or n >= 4096:
            return


class _Bits:
    """avifBits: MSB first; reading past the end sets `error`."""

    def __init__(self, data: bytes):
        self.d, self.pos, self.error = data, 0, False

    def read(self, n: int) -> int:
        v = 0
        for _ in range(n):
            byte = self.pos >> 3
            if byte >= len(self.d):
                self.error = True
                return 0
            v = (v << 1) | ((self.d[byte] >> (7 - (self.pos & 7))) & 1)
            self.pos += 1
        return v

    def uleb128(self) -> int:
        v = 0
        for i in range(8):
            b = self.read(8)
            v |= (b & 0x7F) << (7 * i)
            if not b & 0x80:
                break
        if v > 0xFFFFFFFF:
            self.error = True
        return v

    def uvlc(self) -> int:
        zeros = 0
        while not self.read(1) and not self.error:
            zeros += 1
            if zeros >= 32:
                return 0xFFFFFFFF
        return (1 << zeros) - 1 + self.read(zeros) if zeros else 0


def _sequence_header(obus: bytes) -> bool:
    """avifSequenceHeaderParse: the sequence header OBU found and read."""
    while obus:
        b = _Bits(obus)
        if b.read(1):
            return False
        obu_type = b.read(4)
        ext = b.read(1)
        has_size = b.read(1)
        b.read(1)
        if ext:
            b.read(8)
        size = b.uleb128() if has_size else len(obus) - 1 - ext
        if b.error:
            return False
        start = b.pos >> 3
        if size > len(obus) - start:
            return False
        if obu_type == 1:
            return _sequence_header_body(_Bits(obus[start:start + size]))
        obus = obus[start + size:]
    return False


def _sequence_header_body(b: _Bits) -> bool:
    profile = b.read(3)
    if profile > 2:
        return False
    still = b.read(1)
    reduced = b.read(1)
    if reduced and not still:
        return False
    if reduced:
        b.read(5)
    else:
        model = 0
        delay_len = 0
        if b.read(1):                       # timing_info_present_flag
            b.read(32), b.read(32)
            if b.read(1) and b.uvlc() == 0xFFFFFFFF:
                return False
            model = b.read(1)
            if model:
                delay_len = b.read(5) + 1
                b.read(32), b.read(10)
        display = b.read(1)
        for _ in range(b.read(5) + 1):
            b.read(12)
            if b.read(5) > 7:
                b.read(1)
            if model and b.read(1):
                b.read(delay_len), b.read(delay_len), b.read(1)
            if display and b.read(1):
                b.read(4)
    wbits, hbits = b.read(4) + 1, b.read(4) + 1
    b.read(wbits), b.read(hbits)
    if not reduced and b.read(1):
        b.read(7)
    b.read(3)
    if not reduced:
        b.read(4)
        order_hint = b.read(1)
        if order_hint:
            b.read(2)
        force = 2 if b.read(1) else b.read(1)
        if force > 0 and not b.read(1):
            b.read(1)
        if order_hint:
            b.read(3)
    b.read(3)
    # color_config
    high = b.read(1)
    depth = (12 if b.read(1) else 10) if profile == 2 and high else (
        10 if high else 8)
    mono = b.read(1) if profile != 1 else 0
    cp = tc = mc = 2
    if b.read(1):
        cp, tc, mc = b.read(8), b.read(8), b.read(8)
    if mono:
        b.read(1)
    elif not (cp == 1 and tc == 13 and mc == 0):
        b.read(1)
        ssx = ssy = 0
        if profile == 0:
            ssx = ssy = 1
        elif profile == 2:
            if depth == 12:
                ssx = b.read(1)
                if ssx:
                    ssy = b.read(1)
            else:
                ssx, ssy = 1, 0
        if ssx and ssy:
            b.read(2)
    if not mono:
        b.read(1)
    b.read(1)                               # film_grain_params_present
    return not b.error


def _validate(item) -> None:
    """avifDecoderItemValidateProperties (Pillow clears the pixi and clap
    strict flags)."""
    cfg = item.prop(b"av1C")
    if cfg is None:
        raise _parse_failed("an item without its mandatory av1C")
    pixi = item.prop(b"pixi")
    if pixi is not None and any(p != cfg["depth"] for p in pixi):
        raise _parse_failed("pixi's depth differs from av1C's")


def _check_props(props: list, sizes: list) -> None:
    """The sample sizes and colr boxes avifDecoderReset checks."""
    if any(n == 0 for n in sizes):
        raise _parse_failed("a sample without data")
    icc = nclx = False
    for t, v in props:
        if t != b"colr":
            continue
        if v[0] == "icc":
            if icc:
                raise _parse_failed("Multiple colr boxes with ICC profiles")
            icc = True
        elif v[0] == "nclx":
            if nclx:
                raise _parse_failed("Multiple colr boxes with nclx")
            nclx = True


def _need_av1c(props) -> None:
    if not any(t == b"av1C" for t, _ in props):
        raise _parse_failed("the colour item is missing its av1C")


def probe(data: bytes) -> tuple:
    """Pillow's AvifImageFile._open and Image.open's checks: (width, height,
    frames, mode). Raises identify.PassOn where Pillow passes the file on,
    identify.Refused where it stops."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    from gpupathtracer_tpu_torch.utils.io import MAX_IMAGE_PIXELS
    try:
        w, h, frames, mode = open_info(data)
    except AvifError as e:
        if e.syntax:
            raise PassOn(f"libavif: {e}") from e
        raise Refused(f"libavif: {e}") from e
    except struct.error as e:
        raise PassOn(str(e)) from e
    if w <= 0 or h <= 0:
        raise PassOn("an image of no pixels")
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise Refused("decompression bomb")
    return w, h, frames, mode
