"""TIFF files, read as PIL's TiffImagePlugin reads them (its own raw
decoder for uncompressed files, libtiff for the rest, libtiff's RGBA
interface for YCbCr outside contiguous JPEG) and then ``convert("RGB")``:
the first IFD only.

- Little- and big-endian files and BigTIFF; strips and tiles; planar
  configuration 1 (samples interleaved) and 2 (a plane a sample).
- Compression: none, CCITT (2, 3 with T4Options 1-D or 2-D, 4 and
  32771; utils/fax_cpp/fax.cpp), LZW (5, the old LSB-first variant too),
  JPEG (7, its JPEGTables spliced before each strip, decoded by
  utils/jpeg_cpp/jpeg.cpp), Deflate (8, 32946), PackBits (32773),
  ThunderScan (32809), LZMA (34925) and ZSTD (50000, utils/zstd.py).
  Predictor 2 (horizontal differencing at 8, 16 and 32 bits) and 3
  (floating point) after LZW, Deflate, LZMA and ZSTD, as libtiff runs
  them; PIL's raw decoder ignores the predictor.
- Fill order 2 where PIL's OPEN_INFO lists it: an uncompressed file
  through PIL's ``;R`` raw modes, a compressed one with each strip's bits
  reversed before its codec (CCITT reverses them itself, JPEG never).
- Orientation 2-8 as PIL's ``exif_transpose`` applies it after the decode
  (the size swapped for 5-8).
- Photometric 0 and 1 (1, 2, 4, 8, 12 and 16 bits unsigned, 8, 16 and 32
  bits signed, 32 bits unsigned and float, each as PIL's mode converts:
  I;16 and I clipped to 0-255, F truncated and clamped), 2 (8 and 16 bits,
  the high byte; extra samples dropped, premultiplied alpha divided out
  first as PIL's RGBa unpacker does; the planes of an uncompressed
  planar-2 16-bit file as PIL's raw decoder reads them, a byte a sample),
  3 (1, 2, 4 and 8 bits; the 16-bit colour map's high bytes), 5 (CMYK at 8
  and 16 bits, PIL's CMYK -> RGB), 6 (YCbCr: under contiguous JPEG as
  libjpeg converts it; otherwise through libtiff's RGBA interface, its
  subsampling, ReferenceBlackWhite, integer YCbCr -> RGB tables and its
  flips of each block of rows by the orientation; uncompressed, as PIL's
  raw decoder reads the samples, unconverted) and 8 (CIE Lab, through
  PIL's LittleCMS Lab -> sRGB transform, utils/lab.py).

The directory is read as PIL reads it: a field of unknown type or without
values skipped, the first value of a one-value field that has more, the
fields before one whose data runs past the end of the file kept (or
before the end of the directory itself). Where libtiff, which decodes
compressed files, reads the directory otherwise (it refuses a field it
needs that it cannot read, takes a Compression of one value a sample,
ignores a FillOrder or a Predictor of another count), the compressed file
follows libtiff.

Corrupt data and what PIL refuses raise ValueError naming the file: LERC
(Pillow has no name for it), WebP and SGILog (the libtiff Pillow bundles
has no libwebp, and decodes SGILog only under photometrics PIL does not
open) and the layouts OPEN_INFO lacks, fill order 2 among them. Old-style
JPEG (compression 6), which PIL reads, raises NotImplementedError naming
the file (ROADMAP.md C6).
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
 _ORIENTATION, _SPP, _ROWS, _STRIPBYTES, _PLANAR, _T4OPTIONS, _PREDICTOR,
 _COLORMAP, _TILEW, _TILEL, _TILES, _TILEBYTES, _EXTRA, _FORMAT,
 _JPEGTABLES, _YCC_COEFS, _YCC_SUB, _REFBW) = (
    256, 257, 258, 259, 262, 266, 273, 274, 277, 278, 279, 284, 292, 317,
    320, 322, 323, 324, 325, 338, 339, 347, 529, 530, 532)

# Field type -> (struct code, size).
_TYPES = {1: ("B", 1), 2: ("B", 1), 3: ("H", 2), 4: ("I", 4), 6: ("b", 1),
          7: ("B", 1), 8: ("h", 2), 9: ("i", 4), 11: ("f", 4), 12: ("d", 8),
          13: ("I", 4), 16: ("Q", 8), 17: ("q", 8), 18: ("Q", 8),
          5: ("II", 8), 10: ("ii", 8)}

_UNREAD_COMPRESSION = {6: "old-style JPEG"}
# Compressions the held Pillow (12.1.0, libtiff 4.7.1) does not read.
_REFUSED = {
    34887: "LERC compression (Pillow has no decoder name for it: no plugin "
           "opens the file)",
    50001: "WebP compression (the libtiff Pillow bundles is built without "
           "libwebp: PIL's load fails)",
    34676: "SGILog compression (libtiff decodes it under photometric LogL "
           "or LogLuv only, which PIL does not open)",
    34677: "SGILog24 compression (libtiff decodes it under photometric "
           "LogLuv only, which PIL does not open)"}
_COMPRESSIONS = (1, 2, 3, 4, 5, 7, 8, 32771, 32773, 32809, 32946, 34925,
                 50000)
_FAX = {2: codecs.FAX_RLE, 32771: codecs.FAX_RLEW, 3: codecs.FAX_G3,
        4: codecs.FAX_G4}
# The codecs libtiff runs its predictor after.
_PREDICTED = (5, 8, 32946, 34925, 50000)
# Each byte's bits reversed (fill order 2).
_REVERSE = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)


# Tags PIL and libtiff read as one value.
_SCALAR = (_WIDTH, _LENGTH, _COMPRESSION, _PHOTO, _FILLORDER, _SPP, _ROWS,
           _PLANAR, _PREDICTOR, _TILEW, _TILEL)
_USED = _SCALAR + (_BPS, _STRIPS, _STRIPBYTES, _COLORMAP, _TILES, _TILEBYTES,
                   _EXTRA, _FORMAT)
# Tags libtiff's TIFFReadDirectory fails on when it cannot read them.
_LIBTIFF_FATAL = (_WIDTH, _LENGTH, _BPS, _COMPRESSION, _STRIPS, _SPP, _ROWS,
                  _STRIPBYTES, _PLANAR, _TILEW, _TILEL, _TILES, _TILEBYTES,
                  _EXTRA, _FORMAT)


def _ifd(data: bytes, name: str) -> tuple:
    """The first IFD: (byte order, {tag: tuple of values}); a rational
    field's (numerator, denominator) pairs also under (tag, "ratio"). A
    field of the decoder's that PIL would choke on raises ValueError."""
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
        if p + entry > len(data):
            # PIL keeps the fields it read before the directory ends.
            tags["truncated"] = True
            break
        if big:
            tag, typ, n = struct.unpack_from(order + "HHQ", data, p)
        else:
            tag, typ, n = struct.unpack_from(order + "HHI", data, p)
        if typ not in _TYPES:
            # PIL skips a field of unknown type; libtiff refuses the
            # directory for one of these tags.
            if tag in _LIBTIFF_FATAL:
                tags["libtiff_fails"] = tag
            continue
        code, size = _TYPES[typ]
        vp = p + entry - inline
        if size * n > inline:
            vp = struct.unpack_from(order + ("Q" if big else "I"), data,
                                    vp)[0]
        if vp + size * n > len(data):
            # PIL's read of the field fails ("Truncated File Read") and it
            # keeps the fields before it.
            tags["truncated"] = True
            break
        if n == 0:
            continue        # PIL skips a field without values
        scalar_count = tag in _SCALAR and n != 1
        if typ in (2, 7):
            tags[tag] = data[vp:vp + n]
            continue
        vals = struct.unpack_from(f"{order}{n * len(code)}{code[0]}", data, vp)
        if typ in (5, 10):
            tags[(tag, "ratio")] = tuple(zip(vals[::2], vals[1::2]))
            vals = tuple(a / b if b else 0 for a, b in zip(vals[::2],
                                                           vals[1::2]))
        if scalar_count:
            # PIL warns and keeps the first value. libtiff ignores the field
            # (its default stands), refuses the directory for a field it
            # needs, and takes a Compression whose values agree.
            if tag in (_PHOTO, _FILLORDER, _ORIENTATION, _PREDICTOR):
                tags[("libtiff_default", tag)] = True
            elif tag == _COMPRESSION and len(set(vals)) == 1:
                tags[("libtiff_per_sample", tag)] = n
            else:
                tags["libtiff_fails"] = tag
            vals = vals[:1]
        tags[tag] = vals
    return order, tags


def _orientation(tags: dict):
    """The Orientation PIL's _setup and exif_transpose see: one number, or
    None (a field of another count or of text transposes nothing)."""
    v = tags.get(_ORIENTATION)
    if not isinstance(v, tuple) or len(v) != 1:
        return None
    v = v[0]
    return int(v) if float(v).is_integer() else None


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
            # fails where it needs a number, but for PlanarConfiguration
            # (not 2: 1; libtiff refuses it) and Predictor (PIL never reads
            # it; libtiff ignores it).
            if tag in (_PLANAR, _PREDICTOR):
                del tags[tag]
                if tag == _PLANAR:
                    tags["libtiff_fails"] = tag
                continue
            raise ValueError(f"{name}: TIFF tag {tag} is not numeric")

    def one(tag, default=None):
        v = tags.get(tag)
        return v[0] if v else default

    comp = one(_COMPRESSION, 1)
    per_sample = tags.get(("libtiff_per_sample", _COMPRESSION))
    if per_sample and per_sample != one(_SPP, 1):
        tags["libtiff_fails"] = _COMPRESSION
    if tags.get("libtiff_fails") and comp != 1:
        raise ValueError(f"{name}: TIFF tag {tags['libtiff_fails']} libtiff "
                         f"cannot read")
    if tags.get("truncated") and comp != 1:
        # PIL decides the mode from the fields it read; libtiff reads the
        # whole directory its own way, which the port does not model.
        raise ValueError(f"{name}: a TIFF directory PIL reads only in part, "
                         f"under compression")
    if comp in _REFUSED:
        raise ValueError(f"{name}: a TIFF with {_REFUSED[comp]}")
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
    fill = one(_FILLORDER, 1)
    orient = _orientation(tags)
    layout = _layout(order, photo, tags, comp, fill, name)
    spp, bps = layout["spp"], layout["bps"]
    # PIL's raw decoder takes strips where both are given; libtiff takes
    # tiles.
    if _TILES in tags and (comp != 1 or _STRIPS not in tags):
        tw, th = one(_TILEW), one(_TILEL)
        if not tw or not th:
            raise ValueError(f"{name}: TIFF tile dimensions missing")
        offsets, counts = tags[_TILES], tags.get(_TILEBYTES, ())
    elif _STRIPS in tags:
        tw, th = w, min(one(_ROWS, h) or h, h)
        offsets, counts = tags[_STRIPS], tags.get(_STRIPBYTES, ())
    else:
        raise ValueError(f"{name}: a TIFF with no strips or tiles")
    if not all(isinstance(v, int) for v in (tw, th, *offsets, *counts)):
        # PIL seeks to a float offset and fails; libtiff refuses the type.
        raise ValueError(f"{name}: TIFF strip or tile fields that are not "
                         f"integers")
    if comp != 1 and planar not in (1, 2):
        raise ValueError(f"{name}: TIFF PlanarConfiguration {planar} (libtiff "
                         f"refuses it)")
    if comp != 1 and _TILES not in tags and 0x7FFFFFFF < one(
            _ROWS, h) < 0xFFFFFFFF:
        # PIL's libtiff decoder takes RowsPerStrip as a signed 32-bit count.
        raise ValueError(f"{name}: TIFF RowsPerStrip {one(_ROWS)} (PIL's "
                         f"decoder fails)")
    if comp in _FAX and bps != 1:
        raise ValueError(f"{name}: CCITT compression at {bps} bits "
                         f"(libtiff: Bits/sample must be 1)")
    if comp == 32809 and (bps != 4 or _TILES in tags):
        raise ValueError(f"{name}: ThunderScan compression at {bps} bits "
                         f"or in tiles (libtiff refuses it)")
    # libtiff's fill order (a field of another count it ignores) and T.4
    # options (a field of another type it ignores).
    lib_fill = 1 if ("libtiff_default", _FILLORDER) in tags else fill
    t4 = one(_T4OPTIONS, 0)
    two_d = comp == 3 and isinstance(t4, int) and bool(t4 & 1)
    ctx = dict(comp=comp, fill=lib_fill, order=order, tags=tags, name=name,
               tables=tags.get(_JPEGTABLES), width=w, two_d=two_d,
               runs=codecs.fax_runs(tw, comp == 4 or two_d)
               if comp in _FAX else None, compat=None)
    if layout.get("rgba"):
        img = _ycbcr_rgba(data, layout, ctx, offsets, counts, w, h, tw, th,
                          planar)
        return _transpose(img, orient)
    # The samples a strip or tile row holds, in its plane.
    plane_spp = 1 if planar == 2 else spp
    nplanes = spp if planar == 2 else 1
    samples = np.zeros((h, w, spp), layout["dtype"])
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
    for off, count, x0, y0, plane in pieces:
        cw, chh = min(tw, w - x0), min(th, h - y0)
        ch = slice(plane, plane + 1) if planar == 2 else slice(None)
        if layout.get("plane8"):
            # PIL's raw decoder reads plane k with the k-th letter of the
            # raw mode, a byte a sample.
            bits, count = layout["plane8"]
            stride = int(tw * bits / 8 / count) if x0 + tw > w else cw
            if stride < cw:
                raise ValueError(f"{name}: a TIFF tile row shorter than its "
                                 f"pixels (PIL's raw decoder refuses it)")
            raw = data[off:off + stride * chh]
            if len(raw) < stride * chh:
                raise ValueError(f"{name}: truncated TIFF image data")
            vals = np.frombuffer(raw, np.uint8).reshape(chh, stride)[:, :cw]
            samples[y0:y0 + chh, x0:x0 + cw, ch] = vals[..., None]
            continue
        # libtiff decodes whole tiles, and a last strip of its own rows.
        rows = th if comp != 1 and _TILES in tags else chh
        vals = _chunk(data, off, count, tw, rows, plane_spp, bps, layout, ctx)
        samples[y0:y0 + chh, x0:x0 + cw, ch] = vals[:chh, :cw]
    return _transpose(layout["convert"](samples), orient)


def _transpose(img: np.ndarray, orient) -> np.ndarray:
    """PIL's exif_transpose for Orientation 2-8 (others: none)."""
    t = img.transpose(1, 0, 2)
    return {2: lambda: img[:, ::-1], 3: lambda: img[::-1, ::-1],
            4: lambda: img[::-1], 5: lambda: t, 6: lambda: t[:, ::-1],
            7: lambda: t[::-1, ::-1], 8: lambda: t[::-1]}.get(
                orient, lambda: img)()


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


def _pil_knows(order, photo, fmt, fill, bps_t, extra) -> bool:
    """Is (byte order, photometric, sample format, fill order, bits, extra
    samples) a key of PIL's OPEN_INFO? A file that is not raises
    SyntaxError in PIL's _setup: no plugin opens it."""
    n = len(bps_t)
    b = bps_t[0]
    if fill == 2:
        if fmt != (1,) or extra or n not in (1, 3):
            return False
        if n == 3:
            return photo == 2 and bps_t == (8, 8, 8)
        return (photo in (0, 1, 3) and b in (1, 2, 4, 8)) or (
            photo == 1 and b == 16 and order == "<")
    if fill != 1:
        return False
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


def _layout(order: str, photo: int, tags: dict, comp: int, fill: int,
            name: str):
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
    if len(bps_t) != spp or spp == 0 or not _pil_knows(
            order, photo, fmt, fill, bps_t, extra):
        raise ValueError(f"{name}: TIFF of an unknown pixel mode (PIL: no "
                         f"plugin opens it)")
    bps = bps_t[0]
    planar = tags.get(_PLANAR, (1,))[0]
    out = dict(spp=spp, bps=bps, photo=photo, float=False,
               dtype=np.uint8 if bps <= 8 else np.uint16)
    if fill == 2 and comp == 1:
        # PIL's raw decoder: the ;R raw modes reverse each byte's bits;
        # L;IR, P;1R, P;2R and P;4R are not raw modes PIL has.
        if (photo == 0 and bps == 8) or (photo == 3 and bps < 8):
            raise ValueError(f"{name}: an uncompressed TIFF of fill order 2 "
                             f"whose raw mode PIL lacks")
        out["reverse"] = True
    if comp == 1 and planar == 2 and spp > 1:
        # PIL's raw decoder reads plane k with the k-th letter of the raw
        # mode: RGBX and RGBa planes have none it knows.
        if 0 in extra or 1 in extra:
            raise ValueError(f"{name}: an uncompressed planar TIFF of "
                             f"extra samples {extra} (PIL: unknown raw mode)")
        # Each plane a byte a sample (16-bit planes too); a tile that
        # crosses the image's right edge steps a whole tile row, PIL's
        # int(tile width * bits a pixel / 8 / its count of bands).
        count = (3 if photo in (2, 6, 8) else 4 if photo == 5 else 1) + len(
            extra)
        out.update(plane8=(sum(bps_t), count), bps=8, dtype=np.uint8)
    if photo in (0, 1) and spp == 1:
        if fmt == (3,):
            # libtiff hands PIL a compressed big-endian file's floats in
            # native order, and PIL reads them as big-endian all the same.
            out.update(dtype=np.float32, float=True, convert=_from_float,
                       swap=order == ">" and comp != 1)
        elif fmt == (2,) and bps > 8:
            # Mode I from I;16S / I;16BS / I;32S / I;32BS: clipped to
            # 0-255; a compressed big-endian file read swapped, as floats.
            out.update(dtype=np.int32, signed=True,
                       swap=order == ">" and comp != 1,
                       convert=lambda s: _grey(np.clip(s[..., 0], 0, 255)
                                               .astype(np.uint8)))
        elif bps == 32:
            # I;32N: native unsigned read as signed int32, then clipped.
            out.update(dtype=np.int32, convert=lambda s: _grey(np.clip(
                s[..., 0], 0, 255).astype(np.uint8)))
        elif bps in (12, 16):
            out["convert"] = lambda s: _grey(np.minimum(s[..., 0], 255)
                                             .astype(np.uint8))
        else:
            invert = photo == 0
            out["convert"] = lambda s: _grey(_scale_low(s[..., 0], bps,
                                                        invert))
        return out
    if photo == 1:                                  # LA
        out["convert"] = lambda s: _grey(s[..., 0])
        return out
    if photo == 2:
        assoc = extra[:1] == (1,)
        b = out["bps"]
        out["convert"] = lambda s: _rgb(s, b, assoc)
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
        b = out["bps"]
        out["convert"] = lambda s: cmyk_to_rgb(_high(s[..., :4], b))
        return out
    if photo == 8:
        from gpupathtracer_tpu_torch.utils.lab import lab_to_rgb
        if planar == 2:
            # PIL's A and B raw modes, a plane each, flip a and b's top bit.
            out["convert"] = lambda s: lab_to_rgb(s ^ np.array(
                [0, 128, 128], np.uint8))
        else:
            out["convert"] = lab_to_rgb
        return out
    # YCbCr.
    if comp == 1:
        # PIL's raw decoder reads the samples unconverted: L, or raw mode
        # RGBX (four bytes a pixel; a plane a sample: R, G and B).
        if spp == 1:
            out["convert"] = lambda s: _grey(s[..., 0])
        elif planar == 2:
            out["convert"] = lambda s: s
        else:
            out.update(spp=4, convert=lambda s: np.ascontiguousarray(
                s[..., :3]))
        return out
    if spp != 3:
        raise ValueError(f"{name}: a compressed YCbCr TIFF of {spp} samples "
                         f"(libtiff refuses it)")
    if comp == 7 and planar == 1:
        out["convert"] = lambda s: s
        return out
    out["rgba"] = True
    return out


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


def _decompress(src: bytes, need: int, off: int, bw: int, bh: int,
                row_bytes: int, ctx: dict, partial: bool = False) -> bytes:
    """A compressed strip or tile's bytes (fill order 2 undone first where
    libtiff undoes it), ``need`` of them or fewer; ValueError where the
    codec fails, but with ``partial`` for data that ends too soon: the
    bytes the codec wrote before it stopped."""
    comp, name = ctx["comp"], ctx["name"]
    if ctx["fill"] == 2 and comp not in _FAX:
        src = _REVERSE[np.frombuffer(src, np.uint8)].tobytes()
    try:
        if comp in _FAX:
            mode = codecs.FAX_G3_2D if ctx["two_d"] else _FAX[comp]
            raw, _ = codecs.fax(src, mode, ctx["fill"], off, bw, bh,
                                row_bytes, ctx["runs"])
            return raw
        if comp == 32809:
            return codecs.thunderscan(src, ctx["width"], bh)
        if comp == 50000:
            from gpupathtracer_tpu_torch.utils.zstd import tiff_zstd
            return tiff_zstd(src, need, partial)
        if comp == 5:
            # libtiff picks the old LSB-first decoder by the first strip it
            # reads and keeps it for the rest.
            if ctx["compat"] is None:
                ctx["compat"] = bool(src[:1] == b"\0" and len(src) > 1
                                     and src[1] & 1)
            if ctx["compat"]:
                return codecs.tiff_lzw_compat(src, need)
            return codecs.tiff_lzw(src, need)
        if comp in (8, 32946):
            return zlib.decompressobj().decompress(src, need)
        if comp == 32773:
            raw, used = codecs.packbits(src, 1, need, libtiff=True)
            if used < 0 and not partial:
                raise ValueError("not enough PackBits data")
            return raw
        return lzma.LZMADecompressor(lzma.FORMAT_XZ).decompress(src, need)
    except (ValueError, zlib.error, lzma.LZMAError) as e:
        raise ValueError(f"{name}: corrupt TIFF image data ({e})") from e


def _chunk(data, off, count, bw, bh, ns, bps, layout, ctx):
    """One strip or tile -> its samples [bh, bw, ns] (uncompressed: the
    rows inside the image only, as PIL reads them)."""
    comp, name, order, tags = ctx["comp"], ctx["name"], ctx["order"], \
        ctx["tags"]
    row_bytes = -(-bw * ns * bps // 8)
    need = row_bytes * bh
    if comp == 1:
        # PIL's raw decoder reads from the offset, whatever the byte count.
        raw = data[off:off + need]
        if len(raw) < need:
            raise ValueError(f"{name}: truncated TIFF image data")
        if layout.get("reverse"):
            raw = _REVERSE[np.frombuffer(raw, np.uint8)].tobytes()
        return _unpack(raw, bh, bw, ns, bps, layout, order)
    src = _strip(data, off, count, name)
    if comp == 7:
        return _jpeg(src, ctx["tables"], bh, bw, ns, layout, name)
    raw = _decompress(src, need, off, bw, bh, row_bytes, ctx)
    if len(raw) < need:
        raise ValueError(f"{name}: not enough TIFF image data")
    raw, order = _predict(raw, bh, row_bytes, ns, bps, layout, order, tags,
                          comp, name)
    return _unpack(raw, bh, bw, ns, bps, layout, order,
                   diff=comp in _PREDICTED and _predictor(tags) == 2)


def _strip(data, off, count, name) -> bytes:
    if count is None:
        raise ValueError(f"{name}: TIFF strip byte counts missing")
    src = data[off:off + count]
    if len(src) < count:
        raise ValueError(f"{name}: TIFF strip past the end of the file")
    return src


def _predictor(tags) -> int:
    """libtiff's predictor: 1 for a field of another count or a type other
    than an integer's, which it ignores."""
    v = tags.get(_PREDICTOR, (1,))[0]
    if ("libtiff_default", _PREDICTOR) in tags or not isinstance(v, int):
        return 1
    return v


def _predict(raw, bh, row_bytes, ns, bps, layout, order, tags, comp, name):
    """libtiff's predictor after LZW, Deflate, LZMA and ZSTD: the floating
    point one undone here (horizontal differencing in _unpack); (bytes,
    their byte order)."""
    predictor = _predictor(tags) if comp in _PREDICTED else 1
    if predictor == 3:
        if bps not in (16, 32, 64) or not layout["float"]:
            raise ValueError(f"{name}: floating point predictor at {bps} "
                             f"bits (libtiff refuses it)")
        return _undo_fp(raw, bh, row_bytes, ns, bps // 8), "<"
    if predictor == 2 and bps not in (8, 16, 32):
        raise ValueError(f"{name}: horizontal differencing at {bps} bits "
                         f"(libtiff refuses it)")
    if predictor not in (1, 2, 3):
        raise ValueError(f"{name}: TIFF predictor {predictor}")
    return raw, order


def _unpack(raw, bh, bw, ns, bps, layout, order, diff=False):
    """Row bytes -> samples [bh, bw, ns]; horizontal differencing undone
    on the integer samples when asked."""
    row_bytes = -(-bw * ns * bps // 8)
    rows = np.frombuffer(raw, np.uint8, row_bytes * bh).reshape(bh, row_bytes)
    if bps < 8 or bps == 12:
        bits = np.unpackbits(rows, axis=1)[:, :bw * ns * bps]
        bits = bits.reshape(bh, bw * ns, bps).astype(np.uint16)
        vals = np.zeros((bh, bw * ns), np.uint16)
        for k in range(bps):
            vals = (vals << 1) | bits[..., k]
        return vals.reshape(bh, bw, ns).astype(layout["dtype"])
    dt = {8: "u1", 16: "u2", 32: "u4"}[bps]
    ints = rows.view(order + dt).reshape(bh, bw, ns)
    if diff:
        ints = np.cumsum(ints, axis=1, dtype=ints.dtype.newbyteorder("="))
    if layout["float"]:
        f = ints.astype(order + "u4").view(order + "f4").astype(np.float32)
        return f.byteswap() if layout.get("swap") else f
    if layout["dtype"] == np.int32:
        v = ints.astype(order + dt)
        if layout.get("swap"):
            v = v.byteswap()
        return v.view(order + ("i" + dt[1])).astype(np.int32) if layout.get(
            "signed") else v.view(order + "i4").astype(np.int32)
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


def _jpeg(src, tables, bh, bw, ns, layout, name, colour=None):
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
    if colour is None:
        colour = "ycbcr" if photo == 6 else "none"
    img = decode_jpeg(src, name, colour=colour, source="libtiff")
    if img.shape[0] < bh or img.shape[1] < bw:
        raise ValueError(f"{name}: a JPEG strip smaller than its strip")
    img = img[:bh, :bw]
    if img.shape[2] < ns:
        raise ValueError(f"{name}: a JPEG strip of {img.shape[2]} "
                         f"components for {ns} samples")
    return img[..., :ns]


# --- YCbCr through libtiff's RGBA interface ----------------------------------

def _floats(tags, tag, n, default):
    """A float array tag as libtiff reads it (a rational as float
    numerator / float denominator); the default where its count is not
    n."""
    v = tags.get(tag)
    if not isinstance(v, tuple) or len(v) != n:
        return np.asarray(default, np.float32)
    pairs = tags.get((tag, "ratio"))
    if pairs is None:
        return np.asarray(v, np.float32)
    return np.array([np.float32(a) / np.float32(b) if b else np.float32(0)
                     for a, b in pairs], np.float32)


def _ycbcr_tables(luma, rbw):
    """libtiff's TIFFYCbCrToRGBInit (tif_color.c) in float32 and int32:
    (Y, Cr->R, Cb->B, Cr->G, Cb->G) tables over the 256 codes."""
    f32 = np.float32

    def clamp(f, lo, hi):
        return lo if not f >= lo else (hi if f > hi else f)

    def fix(x):
        return int(float(f32(x) * f32(65536)) + 0.5)

    f1 = f32(2) - f32(2) * luma[0]
    d1 = fix(clamp(f1, f32(0), f32(2)))
    f2 = luma[0] * f1 / luma[1]
    d2 = -fix(clamp(f2, f32(0), f32(2)))
    f3 = f32(2) - f32(2) * luma[2]
    d3 = fix(clamp(f3, f32(0), f32(2)))
    f4 = luma[2] * f3 / luma[1]
    d4 = -fix(clamp(f4, f32(0), f32(2)))

    def code2v(c, rb, rw, cr):
        den = rw - rb
        return f32(c - int(rb)) * f32(cr) / (den if den != 0 else f32(1))

    def clampw(f):
        lo, hi = f32(-128.0 * 32), f32(128.0 * 32)
        return int(lo if f < lo else hi if f > hi else f)

    tabs = np.zeros((5, 256), np.int64)
    for i in range(256):
        x = i - 128
        cr = clampw(code2v(x, rbw[4] - f32(128), rbw[5] - f32(128), 127))
        cb = clampw(code2v(x, rbw[2] - f32(128), rbw[3] - f32(128), 127))
        tabs[0, i] = clampw(code2v(x + 128, rbw[0], rbw[1], 255))
        tabs[1, i] = np.int32(d1 * cr + 32768) >> 16
        tabs[2, i] = np.int32(d3 * cb + 32768) >> 16
        tabs[3, i] = np.int32(d2 * cr)
        tabs[4, i] = np.int32(d4 * cb + 32768)
    return tabs


def _ycbcr_rgb(y, cb, cr, tabs) -> np.ndarray:
    """TIFFYCbCrtoRGB on uint8 planes -> uint8 [..., 3]."""
    yv = tabs[0][y]
    r = yv + tabs[1][cr]
    g = yv + ((tabs[4][cb] + tabs[3][cr]).astype(np.int32) >> 16)
    b = yv + tabs[2][cb]
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


def _ycbcr_rgba(data, layout, ctx, offsets, counts, w, h, tw, th,
                planar) -> np.ndarray:
    """PIL's _decodeAsRGBA: libtiff's TIFFRGBAImage over blocks of a strip's
    (or a tile row's) rows, unflipped whatever the orientation (PIL's
    exif_transpose follows)."""
    tags, name, comp = ctx["tags"], ctx["name"], ctx["comp"]
    sub = tags.get(_YCC_SUB, ())
    sh, sv = sub if len(sub) == 2 and all(
        isinstance(v, int) for v in sub) else (2, 2)
    luma = _floats(tags, _YCC_COEFS, 3, (0.299, 0.587, 0.114))
    bw_default = (0, 255, 128, 255, 128, 255)
    rbw = _floats(tags, _REFBW, 6, bw_default)
    if (np.isnan(luma).any() or luma[1] == 0 or not np.all(
            (rbw > np.float32(-0x7FFFFFFF + 128))
            & (rbw < np.float32(0x7FFFFFFF)))):
        raise ValueError(f"{name}: YCbCr coefficients or reference black and "
                         f"white libtiff refuses")
    if planar == 2:
        if (sh, sv) != (1, 1):
            raise ValueError(f"{name}: planar YCbCr subsampled {sh}x{sv} "
                             f"(libtiff's RGBA interface refuses it)")
    elif sh not in (1, 2, 4) or sv not in (1, 2, 4) or (sh, sv) in (
            (1, 4), (2, 4)):
        raise ValueError(f"{name}: YCbCr subsampled {sh}x{sv} (libtiff's "
                         f"RGBA interface refuses it)")
    tabs = _ycbcr_tables(luma, rbw)
    tiled = _TILES in tags
    boxes = [(x, y) for y in range(0, h, th) for x in range(0, w, tw)]
    nplanes = 3 if planar == 2 else 1
    if len(offsets) < nplanes * len(boxes):
        raise ValueError(f"{name}: TIFF strips or tiles missing")
    out = np.zeros((h, w, 3), np.uint8)
    for k, (x0, y0) in enumerate(boxes):
        rows = th if tiled else min(th, h - y0)
        cw, chh = min(tw, w - x0), min(th, h - y0)
        if planar == 2:
            planes = []
            for p in range(3):
                j = p * len(boxes) + k
                src = _strip(data, offsets[j], counts[j] if j < len(counts)
                             else None, name)
                if comp == 7:
                    v = _jpeg(src, ctx["tables"], rows, tw, 1,
                              dict(layout, photo=1), name, colour="none")
                    planes.append(v[..., 0])
                    continue
                raw = _decompress(src, tw * rows, offsets[j], tw, rows, tw,
                                  ctx)
                if len(raw) < tw * rows:
                    raise ValueError(f"{name}: not enough TIFF image data")
                raw, _ = _predict(raw, rows, tw, 1, 8, layout, "<", tags,
                                  comp, name)
                v = _unpack(raw, rows, tw, 1, 8, layout, "<", diff=(
                    comp in _PREDICTED and _predictor(tags) == 2))
                planes.append(v[..., 0])
            y, cb, cr = (p[:chh, :cw] for p in planes)
        else:
            ux, uy = -(-tw // sh), -(-rows // sv)
            unit = sh * sv + 2
            need = ux * uy * unit
            # gtStripContig asks for the strip's rows (rounded up to whole
            # sample rows) of TIFFScanlineSize bytes, which rounds down;
            # each block's buffer starts zeroed, and a strip libtiff fails
            # keeps the bytes its codec wrote (stoponerr is off).
            ask = need if tiled else min(need, -(-rows // sv) * sv * (
                ux * unit // sv))
            src = _strip(data, offsets[k], counts[k] if k < len(counts)
                         else None, name)
            raw = _decompress(src, ask, offsets[k], tw, rows, ux * unit, ctx,
                              partial=not tiled)
            if len(raw) < ask and tiled:
                raise ValueError(f"{name}: not enough TIFF image data")
            if len(raw) >= ask and comp in _PREDICTED and _predictor(
                    tags) != 1:
                # libtiff differences rows of TIFFScanlineSize bytes.
                line = ux * unit // sv
                if _predictor(tags) != 2 or ask % line or line % 3:
                    raise ValueError(f"{name}: a predictor libtiff refuses "
                                     f"on subsampled YCbCr")
                v = np.frombuffer(raw, np.uint8, ask).reshape(-1, line // 3,
                                                              3)
                raw = np.cumsum(v, axis=1, dtype=np.uint8).tobytes()
            raw = raw[:ask].ljust(need, b"\0")
            units = np.frombuffer(raw, np.uint8, need).reshape(uy, ux, unit)
            yy, xx = np.mgrid[0:chh, 0:cw]
            u = units[yy // sv, xx // sh]
            y = np.take_along_axis(u, ((yy % sv) * sh + xx % sh)[..., None],
                                   2)[..., 0]
            cb, cr = u[..., sh * sv], u[..., sh * sv + 1]
        out[y0:y0 + chh, x0:x0 + cw] = _ycbcr_rgb(y, cb, cr, tabs)
    return out
