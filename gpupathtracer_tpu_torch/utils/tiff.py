"""TIFF files, read as PIL's TiffImagePlugin reads them (its own raw
decoder for uncompressed files, libtiff for the rest) and then
``convert("RGB")``: the first IFD only.

- Little- and big-endian files and BigTIFF; strips and tiles; planar
  configuration 1 (samples interleaved) and 2 (a plane a sample).
- Compression: none, LZW (5), Deflate (8, 32946), PackBits (32773), LZMA
  (34925) and JPEG (7, its JPEGTables spliced before each strip, decoded
  by utils/jpeg_cpp/jpeg.cpp). Predictor 2 (horizontal differencing at 8,
  16 and 32 bits) and 3 (floating point), except on uncompressed files,
  where PIL's raw decoder ignores the predictor.
- Photometric 0 and 1 (1, 8 and 16 bits; 16-bit grey clipped at 255 as
  PIL's mode I;16 converts; 32-bit float as mode F converts: truncated,
  clamped to 0-255), 2 (8 and 16 bits, the high byte; extra samples
  dropped, premultiplied alpha divided out first as PIL's RGBa unpacker
  does), 3 (1, 2, 4 and 8 bits; the 16-bit colour map's high bytes), 5
  (CMYK at 8 and 16 bits, PIL's CMYK -> RGB) and 6 (YCbCr, under JPEG).

Corrupt data and what PIL refuses raise ValueError naming the file; what
PIL reads and this reader does not (CCITT, ZSTD, WebP, LERC and old-style
JPEG compression, fill order 2, an orientation other than 1, and the
sample layouts not listed above) raises NotImplementedError naming it
(ROADMAP.md C6).
"""

from __future__ import annotations

import lzma
import struct
import zlib

import numpy as np

from gpupathtracer_tpu_torch.utils import codecs
from gpupathtracer_tpu_torch.utils.io import check_pixels, cmyk_to_rgb

# Tags.
(_WIDTH, _LENGTH, _BPS, _COMPRESSION, _PHOTO, _FILLORDER, _STRIPS,
 _ORIENTATION, _SPP, _ROWS, _STRIPBYTES, _PLANAR, _PREDICTOR, _COLORMAP,
 _TILEW, _TILEL, _TILES, _TILEBYTES, _EXTRA, _FORMAT, _JPEGTABLES) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 317, 320,
    322, 323, 324, 325, 338, 339, 347)

# Field type -> (struct code, size).
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8),
          5: ("II", 8), 10: ("ii", 8)}

_UNREAD_COMPRESSION = {2: "CCITT RLE", 3: "CCITT Group 3", 4: "CCITT Group 4",
                       6: "old-style JPEG", 32771: "RLE with 16-bit padding",
                       32809: "ThunderScan", 34676: "SGILog",
                       34677: "SGILog24", 50000: "ZSTD", 50001: "WebP",
                       34887: "LERC"}
_COMPRESSIONS = (1, 5, 7, 8, 32946, 32773, 34925)


# Tags PIL reads as one value; a field of another count, an unknown type
# or its data past the end of the file makes PIL fail (a tuple where it
# needs a number, or libtiff refusing the directory).
_SCALAR = (_WIDTH, _LENGTH, _COMPRESSION, _PHOTO, _FILLORDER, _ORIENTATION,
           _SPP, _ROWS, _PLANAR, _PREDICTOR, _TILEW, _TILEL)
_USED = _SCALAR + (_BPS, _STRIPS, _STRIPBYTES, _COLORMAP, _TILES, _TILEBYTES,
                   _EXTRA, _FORMAT)
# Fields of a type PIL does not know that it skips and the file reads on:
# Compression (PIL's own raw decoder then reads the strips) and Predictor
# (libtiff warns, and predicts nothing).
_SKIPPED_UNKNOWN = (_COMPRESSION, _PREDICTOR)


def _ifd(data: bytes, name: str) -> tuple:
    """The first IFD: (byte order, {tag: tuple of values}). A field of the
    decoder's that PIL would choke on raises ValueError."""
    order = "<" if data[:2] == b"II" else ">"
    big = data[2] == 43     # PIL's test: big-endian BigTIFF reads as classic
    if big:
        off = struct.unpack_from(order + "Q", data, 8)[0]
        (count,) = struct.unpack_from(order + "Q", data, off)
        entry, start, inline = 20, off + 8, 8
    else:
        off = struct.unpack_from(order + "I", data, 4)[0]
        (count,) = struct.unpack_from(order + "H", data, off)
        entry, start, inline = 12, off + 2, 4
    tags = {}
    for i in range(count):
        p = start + i * entry
        if big:
            tag, typ, n = struct.unpack_from(order + "HHQ", data, p)
        else:
            tag, typ, n = struct.unpack_from(order + "HHI", data, p)
        if typ not in _TYPES and tag in _SKIPPED_UNKNOWN:
            continue
        if typ not in _TYPES or (tag in _SCALAR and n != 1):
            if tag in _USED:
                raise ValueError(f"{name}: TIFF tag {tag} of type {typ}, "
                                 f"{n} values")
            continue
        code, size = _TYPES[typ]
        vp = p + entry - inline
        if size * n > inline:
            vp = struct.unpack_from(order + ("Q" if big else "I"), data,
                                    vp)[0]
        if vp + size * n > len(data):
            continue        # PIL warns and skips a field past the end
        if typ in (2, 7):
            tags[tag] = data[vp:vp + n]
            continue
        vals = struct.unpack_from(f"{order}{n * len(code)}{code[0]}", data, vp)
        if typ in (5, 10):
            vals = tuple(a / b if b else 0 for a, b in zip(vals[::2],
                                                           vals[1::2]))
        tags[tag] = vals
    return order, tags


def decode_tiff(data: bytes, name: str = "<tiff>") -> np.ndarray:
    """Decode a TIFF's first image to uint8 [H, W, 3] RGB, bit for bit
    PIL's ``convert("RGB")``."""
    try:
        order, tags = _ifd(data, name)
    except (struct.error, IndexError) as e:
        raise ValueError(f"{name}: corrupt TIFF header ({e})") from e

    for tag in _USED:
        if isinstance(tags.get(tag), bytes):
            # PIL reads an ASCII or UNDEFINED field as bytes or text, and
            # fails where it needs a number.
            raise ValueError(f"{name}: TIFF tag {tag} is not numeric")

    def one(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    comp = one(_COMPRESSION, 1)
    if comp in _UNREAD_COMPRESSION:
        raise NotImplementedError(
            f"{name}: a TIFF with {_UNREAD_COMPRESSION[comp]} compression "
            f"(not read: ROADMAP.md C6)")
    if comp not in _COMPRESSIONS:
        raise ValueError(f"{name}: TIFF compression {comp} (PIL refuses it)")
    if _WIDTH not in tags or _LENGTH not in tags:
        raise ValueError(f"{name}: a TIFF without its dimensions")
    w, h = one(_WIDTH), one(_LENGTH)
    if not isinstance(w, int) or not isinstance(h, int) or w <= 0 or h <= 0:
        raise ValueError(f"{name}: a TIFF of {w}x{h} pixels")
    check_pixels(h, w, name)
    photo = one(_PHOTO, 0)
    planar = one(_PLANAR, 1)
    if one(_FILLORDER, 1) != 1:
        raise NotImplementedError(f"{name}: a TIFF of fill order 2 (not read:"
                                  f" ROADMAP.md C6)")
    if one(_ORIENTATION, 1) != 1:
        raise NotImplementedError(f"{name}: a TIFF with orientation "
                                  f"{one(_ORIENTATION)} (not read: "
                                  f"ROADMAP.md C6)")
    layout = _layout(order, photo, tags, comp, name)
    spp, bps = layout["spp"], layout["bps"]
    # The samples a strip or tile row holds, in its plane.
    plane_spp = 1 if planar == 2 else spp
    nplanes = spp if planar == 2 else 1
    samples = np.zeros((h, w, spp), layout["dtype"])
    if _TILES in tags:
        tw, th = one(_TILEW), one(_TILEL)
        if not tw or not th:
            raise ValueError(f"{name}: TIFF tile dimensions missing")
        offsets, counts = tags[_TILES], tags.get(_TILEBYTES, ())
    elif _STRIPS in tags:
        tw, th = w, min(one(_ROWS, h) or h, h)
        offsets, counts = tags[_STRIPS], tags.get(_STRIPBYTES, ())
    else:
        raise ValueError(f"{name}: a TIFF with no strips or tiles")
    if comp == 1:
        pieces = _raw_pieces(offsets, w, h, tw, th, planar, spp, name)
    else:
        # libtiff's strips or tiles, plane after plane.
        boxes = [(x, y) for y in range(0, h, th) for x in range(0, w, tw)]
        if len(offsets) < nplanes * len(boxes):
            raise ValueError(f"{name}: TIFF strips or tiles missing")
        pieces = [(offsets[k], counts[k] if k < len(counts) else None, x, y,
                   k // len(boxes)) for k, (x, y) in enumerate(
                       boxes * nplanes)]
    tables = tags.get(_JPEGTABLES)
    for off, count, x0, y0, plane in pieces:
        cw, chh = min(tw, w - x0), min(th, h - y0)
        # libtiff decodes whole tiles, and a last strip of its own rows.
        rows = th if comp != 1 and _TILES in tags else chh
        vals = _chunk(data, off, count, comp, tw, rows, plane_spp, bps,
                      layout, order, tags, tables, name)
        ch = slice(plane, plane + 1) if planar == 2 else slice(None)
        samples[y0:y0 + chh, x0:x0 + cw, ch] = vals[:chh, :cw]
    return layout["convert"](samples)


def _raw_pieces(offsets, w, h, tw, th, planar, spp, name):
    """PIL's tiles of an uncompressed file (TiffImagePlugin._setup): every
    offset in turn, left to right, top to bottom, then again from the top
    in the next layer (plane), so that extra strips overwrite earlier
    ones; one strip that covers the image reads its last offset."""
    if tw == w and th == h and planar != 2:
        offsets = offsets[-1:]
    pieces, x, y, layer = [], 0, 0, 0
    for off in offsets:
        if planar == 2 and layer >= spp:
            raise ValueError(f"{name}: more TIFF planes than samples (PIL "
                             f"fails on them)")
        pieces.append((off, None, x, y, layer if planar == 2 else 0))
        x += tw
        if x >= w:
            x, y = 0, y + th
            if y >= h:
                y, layer = 0, layer + 1
    return pieces


def _pil_knows(order, photo, fmt, bps_t, extra) -> bool:
    """Is (byte order, photometric, sample format, bits, extra samples) a
    key of PIL's OPEN_INFO (fill order 1)? A file that is not raises
    SyntaxError in PIL's _setup: no plugin opens it."""
    n = len(bps_t)
    b = bps_t[0]
    if photo in (0, 1) and n == 1 and not extra:
        if fmt == (1,):
            return b in (1, 2, 4, 8) or (b == 16 and (order == "<"
                                                       or photo == 1)) or (
                photo == 1 and b == 32 and order == "<") or (
                photo == 1 and b == 12 and order == "<")
        if fmt == (2,):
            return photo == 1 and b in (8, 16, 32)
        return fmt == (3,) and b == 32
    if photo == 1:
        return bps_t == (8, 8) and extra == (2,) and fmt == (1,)
    if fmt != (1,):
        return False
    if photo == 2:
        if b == 8 and all(x == 8 for x in bps_t):
            return extra in {3: ((),), 4: ((), (0,), (1,), (2,), (999,)),
                             5: ((0, 0), (1, 0), (2, 0)),
                             6: ((0, 0, 0), (1, 0, 0), (2, 0, 0))}.get(n, ())
        return b == 16 and all(x == 16 for x in bps_t) and (
            (n == 3 and not extra) or (n == 4 and extra in ((), (0,), (1,),
                                                            (2,))))
    if photo == 3:
        return (n == 1 and b in (1, 2, 4, 8) and not extra) or (
            bps_t == (8, 8) and extra in ((0,), (2,)))
    if photo == 5:
        return (all(x == 8 for x in bps_t) and (n, extra) in (
            (4, ()), (5, (0,)), (6, (0, 0)))) or (
            bps_t == (16,) * 4 and not extra)
    if photo == 6:
        return bps_t in ((8,), (8, 8, 8)) and not extra
    return photo == 8 and bps_t == (8, 8, 8) and not extra


def _layout(order: str, photo: int, tags: dict, comp: int, name: str):
    """PIL's mode for the file (TiffImagePlugin._setup and OPEN_INFO), as
    the sample layout and the conversion to RGB."""
    extra = tuple(tags.get(_EXTRA, ()))
    fmt = tuple(tags.get(_FORMAT, (1,)))
    if len(fmt) > 1 and max(fmt) == min(fmt) == 1:
        fmt = (1,)
    bps_t = tuple(tags.get(_BPS, (1,)))
    spp = tags.get(_SPP, (3 if comp == 6 and photo in (2, 6) else 1,))[0]
    if spp < len(bps_t):
        bps_t = bps_t[:spp]
    elif spp > len(bps_t) and len(bps_t) == 1:
        bps_t = bps_t * spp
    if len(bps_t) != spp or spp == 0 or not _pil_knows(order, photo, fmt,
                                                       bps_t, extra):
        raise ValueError(f"{name}: TIFF of an unknown pixel mode (PIL: no "
                         f"plugin opens it)")
    bps = bps_t[0]
    planar = tags.get(_PLANAR, (1,))[0]
    out = dict(spp=spp, bps=bps, photo=photo, float=False,
               dtype=np.uint8 if bps <= 8 else np.uint16)
    unread = NotImplementedError(
        f"{name}: a TIFF of photometric {photo}, {bps_t} bits, sample format "
        f"{fmt}, extra samples {extra} (not read: ROADMAP.md C6)")
    if comp == 1 and planar == 2 and spp > 1 and bps != 8:
        raise unread       # PIL's raw decoder takes each plane at 8 bits
    if photo in (0, 1) and spp == 1:
        if fmt == (3,):
            # libtiff hands PIL a compressed big-endian file's floats in
            # native order, and PIL reads them as big-endian all the same.
            out.update(dtype=np.float32, float=True, convert=_from_float,
                       swap=order == ">" and comp != 1)
        elif bps == 16 and fmt == (1,):
            out["convert"] = lambda s: _grey(np.minimum(s[..., 0], 255)
                                             .astype(np.uint8))
        elif bps <= 8:
            invert = photo == 0
            out["convert"] = lambda s: _grey(_scale_low(s[..., 0], bps,
                                                        invert))
        else:
            raise unread
        return out
    if photo == 1:                                  # LA
        out["convert"] = lambda s: _grey(s[..., 0])
        return out
    if photo == 2:
        assoc = extra[:1] == (1,)
        out["convert"] = lambda s: _rgb(s, bps, assoc)
        return out
    if photo == 3:
        cmap = tags.get(_COLORMAP)
        if cmap is None:
            raise ValueError(f"{name}: a palette TIFF without a colour map")
        n = len(cmap) // 3
        pal = np.zeros((256, 3), np.uint8)
        cm = (np.asarray(cmap[:3 * n], np.int64) // 256).astype(np.uint8)
        pal[:min(n, 256)] = cm.reshape(3, n).T[:256]
        out["convert"] = lambda s: pal[s[..., 0]]
        return out
    if photo == 5:
        out["convert"] = lambda s: cmyk_to_rgb(_high(s[..., :4], bps))
        return out
    if photo == 6 and comp == 7 and spp == 3 and planar == 1:
        out["convert"] = lambda s: s
        return out
    raise unread


def _high(s: np.ndarray, bps: int) -> np.ndarray:
    """PIL's ;16 unpackers keep a sample's high byte."""
    return (s >> 8).astype(np.uint8) if bps == 16 else s


def _rgb(s: np.ndarray, bps: int, assoc: bool) -> np.ndarray:
    px = _high(s, bps)
    if not assoc:
        return np.ascontiguousarray(px[..., :3])
    # PIL's RGBa unpacker: premultiplied colour divided by alpha, clipped.
    a = px[..., 3:4].astype(np.int32)
    c = px[..., :3].astype(np.int32)
    div = np.where(a == 0, 1, a)
    out = np.minimum(c * 255 // div, 255)
    out = np.where(a == 255, c, np.where(a == 0, 0, out))
    return out.astype(np.uint8)


def _scale_low(g: np.ndarray, bps: int, invert: bool) -> np.ndarray:
    """1-, 2-, 4- and 8-bit grey to 0-255 (photometric 0 inverted)."""
    g = g.astype(np.int32)
    if invert:
        g = (1 << bps) - 1 - g
    return (g * (255 // ((1 << bps) - 1))).astype(np.uint8)


def _grey(g: np.ndarray) -> np.ndarray:
    return np.repeat(g[..., None], 3, axis=2)


def _from_float(s: np.ndarray) -> np.ndarray:
    """Mode F to L to RGB: truncated toward zero, clamped to 0-255 (NaN
    reads 0)."""
    v = s[..., 0]
    with np.errstate(invalid="ignore"):
        g = np.where(v >= 255, 255, np.where(v > 0, v, 0))
    return _grey(np.trunc(g).astype(np.uint8))


def _chunk(data, off, count, comp, bw, bh, ns, bps, layout, order, tags,
           tables, name):
    """One strip or tile -> its samples [bh, bw, ns] (uncompressed: the
    rows inside the image only, as PIL reads them)."""
    row_bytes = -(-bw * ns * bps // 8)
    need = row_bytes * bh
    if comp == 1:
        # PIL's raw decoder reads from the offset, whatever the byte count.
        raw = data[off:off + need]
        if len(raw) < need:
            raise ValueError(f"{name}: truncated TIFF image data")
        return _unpack(raw, bh, bw, ns, bps, layout, order)
    if count is None:
        raise ValueError(f"{name}: TIFF strip byte counts missing")
    src = data[off:off + count]
    if len(src) < count:
        raise ValueError(f"{name}: TIFF strip past the end of the file")
    if comp == 7:
        return _jpeg(src, tables, bh, bw, ns, layout, name)
    try:
        if comp == 5:
            if src[:1] == b"\0" and len(src) > 1 and src[1] & 1:
                raise NotImplementedError(
                    f"{name}: old-style (LSB-first) TIFF LZW (not read: "
                    f"ROADMAP.md C6)")
            raw = codecs.tiff_lzw(src, need)
        elif comp in (8, 32946):
            raw = zlib.decompressobj().decompress(src, need)
        elif comp == 32773:
            raw, used = codecs.packbits(src, 1, need, libtiff=True)
            if used < 0:
                raise ValueError("not enough PackBits data")
        else:
            raw = lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(src, need)
    except (ValueError, zlib.error, lzma.LZMAError) as e:
        raise ValueError(f"{name}: corrupt TIFF image data ({e})") from e
    if len(raw) < need:
        raise ValueError(f"{name}: not enough TIFF image data")
    # libtiff runs the predictor for LZW, Deflate and LZMA only.
    predictor = tags.get(_PREDICTOR, (1,))[0] if comp != 32773 else 1
    if predictor == 3:
        if bps not in (16, 32, 64) or not layout["float"]:
            raise ValueError(f"{name}: floating point predictor at {bps} "
                             f"bits (libtiff refuses it)")
        raw = _undo_fp(raw, bh, row_bytes, ns, bps // 8)
        order = "<"
    elif predictor == 2 and bps not in (8, 16, 32):
        raise ValueError(f"{name}: horizontal differencing at {bps} bits "
                         f"(libtiff refuses it)")
    elif predictor not in (1, 2, 3):
        raise ValueError(f"{name}: TIFF predictor {predictor}")
    vals = _unpack(raw, bh, bw, ns, bps, layout, order,
                   diff=predictor == 2)
    return vals


def _unpack(raw, bh, bw, ns, bps, layout, order, diff=False):
    """Row bytes -> samples [bh, bw, ns]; horizontal differencing undone
    on the integer samples when asked."""
    row_bytes = -(-bw * ns * bps // 8)
    rows = np.frombuffer(raw, np.uint8, row_bytes * bh).reshape(bh, row_bytes)
    if bps < 8:
        bits = np.unpackbits(rows, axis=1)[:, :bw * ns * bps]
        bits = bits.reshape(bh, bw * ns, bps).astype(np.uint8)
        vals = np.zeros((bh, bw * ns), np.uint8)
        for k in range(bps):
            vals = (vals << 1) | bits[..., k]
        return vals.reshape(bh, bw, ns)
    dt = {8: "u1", 16: "u2", 32: "u4"}[bps]
    ints = rows.view(order + dt).reshape(bh, bw, ns)
    if diff:
        ints = np.cumsum(ints, axis=1, dtype=ints.dtype.newbyteorder("="))
    if layout["float"]:
        f = ints.astype(order + "u4").view(order + "f4").astype(np.float32)
        return f.byteswap() if layout.get("swap") else f
    return ints.astype(np.uint8 if bps == 8 else np.uint16)


def _undo_fp(raw: bytes, bh: int, row_bytes: int, ns: int,
             nb: int) -> bytes:
    """libtiff's fpAcc, a row at a time: the bytes summed with a stride of
    the samples a pixel, then each sample's bytes gathered from their
    planes (most significant first) into little-endian order."""
    rows = np.frombuffer(raw, np.uint8, row_bytes * bh).reshape(bh, row_bytes)
    wc = row_bytes // nb
    cols = rows.reshape(bh, row_bytes // ns, ns)
    acc = np.cumsum(cols, axis=1, dtype=np.uint8).reshape(bh, row_bytes)
    planes = acc.reshape(bh, nb, wc)
    gathered = planes[:, ::-1, :].transpose(0, 2, 1)
    return np.ascontiguousarray(gathered).tobytes()


def _jpeg(src, tables, bh, bw, ns, layout, name):
    """A JPEG-compressed strip or tile: JPEGTables (SOI, tables, EOI)
    spliced before the strip's own stream; libtiff's colour handling
    (YCbCr -> RGB for photometric 6, the components as they are
    otherwise)."""
    from gpupathtracer_tpu_torch.utils.jpeg import decode_jpeg
    if tables and len(tables) > 4 and src[:2] == b"\xff\xd8":
        src = bytes(tables[:-2]) + src[2:]
    photo = layout["photo"]
    if layout["bps"] != 8:
        raise ValueError(f"{name}: JPEG-in-TIFF at {layout['bps']} bits")
    img = decode_jpeg(src, name, colour="ycbcr" if photo == 6 else "none",
                      source="libtiff")
    if img.shape[0] < bh or img.shape[1] < bw:
        raise ValueError(f"{name}: a JPEG strip smaller than its strip")
    img = img[:bh, :bw]
    if img.shape[2] < ns:
        raise ValueError(f"{name}: a JPEG strip of {img.shape[2]} "
                         f"components for {ns} samples")
    return img[..., :ns]
