"""Write the image fixtures of tests/golden/images/: each image file beside
PIL's decode of it (``Image.open(path).convert("RGB")``) as an 8-bit RGB
PNG, and manifest.json with each file's sha256 and the sha256 of the
decoded pixels.

    python tools/torch_image_fixtures.py [--out tests/golden/images]
    python tools/torch_image_fixtures.py --time   # decode times, port and PIL
    python tools/torch_image_fixtures.py --ht-vlc-table   # utils/ht_vlc.bin
    python tools/torch_image_fixtures.py --avif-set   # tests/golden/avif

Needs Pillow, so it runs where the JAX package's tests run, never on the
card's machine; the port reads the files without it (utils/io.py
decode_image) and tests/test_torch_images.py, chip_smoke.py phase 20 (the
JPEGs), phase 21 (the rest but WebP and the simple formats), phase 22 (the
WebP files) and phase 24 (the simple formats) hold its decodes to the
PNGs. The files:

- JPEG, PIL's encoder: the generated town's four 128x128 maps
  (scene/samplegen.py), one encoding each: checker baseline 4:4:4 at q95,
  bricks progressive 4:2:0 at q75, roof 4:2:2 at q50 with restart markers
  every 5 MCUs, foliage with optimized Huffman tables 4:2:0 at q85; a grey
  JPEG (bricks' luma, q90); a 1024x1024 4:2:0 map at q75 (a decode at a
  real texture size); a 512x256 equirect sky at q90 (4:2:0);
- lossless re-encodings of the town maps' PNG twins (the JPEG decodes), so
  that a town on them renders bitwise the town on the PNG twins: checker
  as TIFF LZW (PIL), bricks as PSD RLE, roof as uncompressed DDS (PIL),
  foliage as 24-bit BMP (PIL), and the sky as a tiled, Deflate-compressed
  TIFF with horizontal differencing;
- lossy ones, each beside PIL's decode: bricks as DXT1 and foliage as
  DXT5 (PIL's BCn encoder), checker as BC5 (PIL), roof as a GIF (PIL's
  quantizer), bricks as a CMYK JPEG (PIL) and as the same file marked
  YCCK (its Adobe transform byte set to 2), and seeded random BC4, BC6H
  (UF16, SF16) and BC7 blocks under DX10 headers (PIL writes none of
  them), every BC7 mode and BC6H mode among them;
- WebP: lossless re-encodings of the four town twins (PIL, each at another
  method and quality), bricks lossy at q75, foliage as lossy RGBA (VP8X and
  ALPH), an animation whose 96x80 lossy first frame sits at (8, 16) on a
  128x128 canvas (PIL's decode: black around it), and two lossy files by
  libwebp's advanced encoder, which PIL's options do not reach: foliage
  with the simple loop filter, bricks in eight token partitions;
- the simple formats: the town's maps as checker P6 PPM and bricks QOI
  (PIL), roof run-length SGI and foliage 3-plane PCX (PIL), and small
  files of every PNM, PFM, QOI, ICO, CUR, SGI, PCX and DIB variant (the
  plain PNMs, run-length SGIs, planar PCXs, CURs and hand-made ICO
  directories by the writers below).

The writers of the containers PIL does not write (DDS headers, GIF, TIFF
with tiles, planar configuration 2, predictors, big-endian and BigTIFF,
PSD, WebP chunks and animations, plain PNM, run-length SGI, planar PCX,
CUR and ICO directories) live here too; tests/test_torch_image_formats.py,
tests/test_torch_webp.py and tests/test_torch_simple_formats.py build
their cases with them.

The PNGs use filters None, Sub and Up only (the port unfilters those
without a per-byte loop), chosen per row by the smallest sum of absolute
bytes, at zlib level 9.
"""

from __future__ import annotations

import argparse
import hashlib
import io
import json
import lzma
import os
import struct
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)


def _u8(img: np.ndarray) -> np.ndarray:
    """save_png's float -> uint8 rule."""
    return (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)


def town_maps() -> dict:
    from gpupathtracer_tpu_torch.scene import samplegen as sg
    return {"checker": _u8(sg._checker()), "bricks": _u8(sg._bricks()),
            "roof": _u8(sg._stripes()), "foliage": _u8(sg._foliage())}


def big_map(n: int = 1024) -> np.ndarray:
    """A 1024x1024 texture: tiles with soft gradients, grout lines and a
    little grain (a stone floor's kind of content)."""
    yy, xx = np.mgrid[0:n, 0:n].astype(np.float32) / n
    tile = (np.floor(xx * 8) + 3 * np.floor(yy * 8)) % 5
    base = 0.35 + 0.08 * tile[..., None] * np.float32([1.0, 0.9, 0.75])
    shade = 0.85 + 0.15 * np.sin(6.3 * xx + 2.0)[..., None] * np.cos(
        4.1 * yy)[..., None]
    grout = ((np.abs((xx * 8) % 1 - 0.5) > 0.47)
             | (np.abs((yy * 8) % 1 - 0.5) > 0.47))[..., None]
    img = np.where(grout, 0.2, base * shade)
    grain = np.random.RandomState(5).rand(n // 8, n // 8, 1)
    img = img + 0.02 * np.kron(grain, np.ones((8, 8, 1)))
    return _u8(img.astype(np.float32))


def sky(w: int = 512, h: int = 256) -> np.ndarray:
    v = np.linspace(0.0, 1.0, h, dtype=np.float32)[:, None, None]
    u = np.linspace(0.0, 1.0, w, dtype=np.float32)[None, :, None]
    img = np.concatenate([0.3 + 0.6 * v + 0 * u, 0.4 + 0.5 * v + 0 * u,
                          0.6 + 0.4 * v + 0.2 * np.sin(8 * np.pi * u) ** 2],
                         axis=-1)
    return _u8(img)


# --- containers PIL does not write -------------------------------------------

def write_dds(w: int, h: int, body: bytes, fourcc: bytes = None,
              dxgi: int = None, pfflags: int = 0, bitcount: int = 0,
              masks=(0, 0, 0, 0)) -> bytes:
    """A DDS file: the 124-byte header (a FourCC, or DX10 and its 20-byte
    header when ``dxgi`` is given, or uncompressed by ``pfflags``,
    ``bitcount`` and ``masks``), then ``body``."""
    if dxgi is not None:
        fourcc = b"DX10"
    if fourcc:
        pfflags |= 0x4
    pf = struct.pack("<4I", 32, pfflags, struct.unpack(
        "<I", fourcc or b"\0\0\0\0")[0], bitcount) + struct.pack("<4I", *masks)
    head = (struct.pack("<6I", 0x1007, h, w, 0, 0, 1) + b"\0" * 44 + pf
            + struct.pack("<5I", 0x1000, 0, 0, 0, 0))
    out = b"DDS " + struct.pack("<I", 124) + head
    if dxgi is not None:
        out += struct.pack("<5I", dxgi, 3, 0, 1, 0)
    return out + body


def random_blocks(n: int, size: int, seed: int, modes=None,
                  bc6h: bool = False) -> bytes:
    """n seeded random BCn blocks; ``modes`` cycles the block's mode bits
    (BC7: mode m is m zero bits and a one; BC6H: the 2- or 5-bit mode
    field)."""
    rng = np.random.RandomState(seed)
    blocks = bytearray(rng.bytes(n * size))
    if modes:
        for i in range(n):
            m = modes[i % len(modes)]
            b = blocks[i * size]
            if bc6h:
                keep = ~3 if m < 2 else ~31
                blocks[i * size] = (b & keep & 255) | m
            elif m < 8:
                blocks[i * size] = ((b >> (m + 1)) << (m + 1) | 1 << m) & 255
            else:
                blocks[i * size] = 0
    return bytes(blocks)


# BC6H's mode fields: 0, 1 (2 bits) and the 5-bit ones, the four reserved
# ones (19, 23, 27, 31) among them.
BC6H_MODES = (0, 1, 2, 6, 10, 14, 18, 22, 26, 30, 3, 7, 11, 15, 19, 23, 27,
              31)


def lzw_gif(indices, bits: int) -> bytes:
    """GIF LZW (LSB first) of a flat index sequence, code size ``bits``."""
    clear, end = 1 << bits, (1 << bits) + 1
    out, acc, nacc, size = bytearray(), 0, 0, bits + 1

    def emit(code):
        nonlocal acc, nacc
        acc |= code << nacc
        nacc += size
        while nacc >= 8:
            out.append(acc & 255)
            acc >>= 8
            nacc -= 8

    table = {(i,): i for i in range(clear)}
    nxt = end + 1
    emit(clear)
    w = ()
    for k in indices:
        wk = w + (int(k),)
        if wk in table:
            w = wk
            continue
        emit(table[w])
        if nxt < 4096:
            table[wk] = nxt
            nxt += 1
            if nxt - 1 == (1 << size) and size < 12:
                size += 1
        else:
            emit(clear)
            table = {(i,): i for i in range(clear)}
            nxt, size = end + 1, bits + 1
        w = (int(k),)
    if w:
        emit(table[w])
    emit(end)
    if nacc:
        out.append(acc & 255)
    return bytes(out)


def gif_blocks(data: bytes) -> bytes:
    out = bytearray()
    for i in range(0, len(data), 255):
        out += bytes([len(data[i:i + 255])]) + data[i:i + 255]
    return bytes(out + b"\0")


def _table(colours) -> tuple:
    """A GIF colour table padded to a power of two: (size field, bytes)."""
    n = len(colours)
    b = max(1, int(np.ceil(np.log2(n))))
    return b - 1, bytes(np.asarray(colours, np.uint8).reshape(-1)) + \
        b"\0" * (3 * ((1 << b) - n))


def write_gif(screen, index: np.ndarray, pos=(0, 0), gct=None, lct=None,
              bg: int = 0, interlace: bool = False, transparency=None,
              bits: int = None, data: bytes = None) -> bytes:
    """A one-frame GIF: ``index`` [h, w] at ``pos`` on a ``screen`` (w, h),
    global and local colour tables, a graphic control extension when
    ``transparency`` is given, rows interlaced if asked; ``data`` replaces
    the frame's sub-blocks."""
    w, h = screen
    fh, fw = index.shape
    out = bytearray(b"GIF89a" + struct.pack("<HH", w, h))
    if gct is not None:
        field, tab = _table(gct)
        out += bytes([0x80 | field, bg, 0]) + tab
    else:
        out += bytes([0, bg, 0])
    if transparency is not None:
        out += b"\x21\xf9\x04" + bytes([1, 0, 0, transparency]) + b"\0"
    flags, local = (0x40 if interlace else 0), b""
    if lct is not None:
        field, local = _table(lct)
        flags |= 0x80 | field
    out += b"," + struct.pack("<4H", pos[0], pos[1], fw, fh) + bytes([flags])
    out += local
    rows = index
    if interlace:
        rows = index[list(range(0, fh, 8)) + list(range(4, fh, 8))
                     + list(range(2, fh, 4)) + list(range(1, fh, 2))]
    if bits is None:
        bits = max(2, int(index.max()).bit_length())
    out += bytes([bits]) + (data if data is not None else gif_blocks(
        lzw_gif(rows.reshape(-1), bits))) + b";"
    return bytes(out)


def lzw_tiff(data: bytes, compat: bool = False) -> bytes:
    """TIFF LZW (MSB first, early change) of one strip; ``compat``: the old
    variant (LSB first, each width change a code later)."""
    out, acc, nacc, nbits = bytearray(), 0, 0, 9

    def emit(code):
        nonlocal acc, nacc
        if compat:
            acc |= code << nacc
            nacc += nbits
            while nacc >= 8:
                out.append(acc & 255)
                acc >>= 8
                nacc -= 8
            return
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 255)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def grow():
        nonlocal nbits
        if nxt - 1 > (1 << nbits) - (1 if compat else 2) and nbits < 12:
            nbits += 1

    table = {bytes([i]): i for i in range(256)}
    nxt = 258
    emit(256)
    w = b""
    for b in data:
        wk = w + bytes([b])
        if wk in table:
            w = wk
            continue
        emit(table[w])
        table[wk] = nxt
        nxt += 1
        grow()
        if nxt >= 4093:
            emit(256)
            table = {bytes([i]): i for i in range(256)}
            nxt, nbits = 258, 9
        w = bytes([b])
    if w:
        emit(table[w])
        nxt += 1
        grow()
    emit(257)
    if nacc:
        out.append(acc & 255 if compat else (acc << (8 - nacc)) & 255)
    return bytes(out)


def packbits(row: bytes) -> bytes:
    """PackBits of one row: runs of three or more, literals otherwise."""
    out, i, n = bytearray(), 0, len(row)
    while i < n:
        j = i
        while j + 1 < n and row[j + 1] == row[i] and j - i < 127:
            j += 1
        if j - i >= 2:
            out += bytes([257 - (j - i + 1), row[i]])
            i = j + 1
            continue
        lit = bytearray()
        j = i
        while j < n and len(lit) < 128:
            if j + 2 < n and row[j] == row[j + 1] == row[j + 2]:
                break
            lit.append(row[j])
            j += 1
        out += bytes([len(lit) - 1]) + lit
        i = j
    return bytes(out)


def _tiff_rows(a: np.ndarray, bps: int, order: str, predictor: int):
    """A strip's or tile's samples [rows, cols, n] -> its row bytes,
    differenced (predictor 2 on the integer samples, 3 on the bytes)."""
    if predictor == 2:
        if a.dtype.kind == "f":     # libtiff differences a float's bits
            a = a.astype(order + "f4").view(order + "u4").astype(np.uint32)
        d = a.copy()
        d[:, 1:] = a[:, 1:] - a[:, :-1]
        a = d
    rows = []
    for r in a:
        flat = r.reshape(-1)
        if predictor == 3:
            nb = flat.dtype.itemsize
            be = np.frombuffer(flat.astype(">" + flat.dtype.str[1:])
                               .tobytes(), np.uint8).reshape(-1, nb)
            planes = be.T.reshape(-1, a.shape[2]).astype(np.int16)
            diff = planes.copy()
            diff[1:] = planes[1:] - planes[:-1]
            rows.append((diff & 255).astype(np.uint8).tobytes())
        elif bps < 8 or bps == 12:
            bits = ((flat[:, None] >> np.arange(bps - 1, -1, -1)) & 1)
            rows.append(np.packbits(bits.astype(np.uint8).reshape(-1))
                        .tobytes())
        elif bps == 8:
            rows.append(flat.astype(np.uint8).tobytes())
        else:
            kind = "f" if flat.dtype.kind == "f" else "u"
            rows.append(flat.astype(f"{order}{kind}{bps // 8}").tobytes())
    return rows


def write_tiff(arr: np.ndarray, photometric: int, bps: int = 8,
               order: str = "<", big: bool = False, compression: int = 1,
               predictor: int = 1, planar: int = 1, tile=None,
               rows_per_strip: int = None, sample_format: int = None,
               extra=(), colormap=None, jpeg=None, tags=(), encode=None,
               fill_order: int = 1) -> bytes:
    """A one-IFD TIFF of ``arr`` [h, w] or [h, w, samples]: byte order
    ``order``, classic or BigTIFF, strips or ``tile`` (w, h) tiles,
    planar configuration 1 or 2, compression none, LZW, Deflate,
    PackBits, LZMA, CCITT (2, 3 1-D, 4, 32771), ThunderScan, ZSTD (the
    libzstd Pillow bundles, level 3), or JPEG (``jpeg(plane, x, y, w,
    h)`` gives each strip's or tile's stream); ``encode(rows, width)``
    compresses a strip's or tile's row bytes in place of the codec named;
    fill order 2 reverses the bits of every byte written (but JPEG's);
    ``tags`` adds (tag, (type, values))."""
    arr = np.asarray(arr)
    if arr.ndim == 2:
        arr = arr[..., None]
    h, w, spp = arr.shape
    planes = [arr[..., i:i + 1] for i in range(spp)] if planar == 2 else [arr]
    if tile:
        boxes = [(x, y, tile[0], tile[1]) for y in range(0, h, tile[1])
                 for x in range(0, w, tile[0])]
    else:
        rps = rows_per_strip or h
        boxes = [(0, y, w, min(rps, h - y)) for y in range(0, h, rps)]
    chunks = []
    for p in planes:
        for x, y, bw, bh in boxes:
            if jpeg is not None:
                chunks.append(jpeg(p, x, y, bw, bh))
                continue
            c = np.zeros((bh, bw, p.shape[2]), p.dtype)
            sub = p[y:y + bh, x:x + bw]
            c[:sub.shape[0], :sub.shape[1]] = sub
            rows = _tiff_rows(c, bps, order, predictor)
            raw = b"".join(rows)
            if encode is not None:
                chunks.append(encode(rows, bw))
                continue
            chunks.append({1: lambda: raw, 5: lambda: lzw_tiff(raw),
                           8: lambda: zlib.compress(raw, 6),
                           32946: lambda: zlib.compress(raw, 6),
                           32773: lambda: b"".join(packbits(r) for r in rows),
                           34925: lambda: lzma.compress(
                               raw, format=lzma.FORMAT_XZ),
                           2: lambda: fax_encode(rows, bw, "mh"),
                           32771: lambda: fax_encode(rows, bw, "mhw"),
                           3: lambda: fax_encode(rows, bw, "t4"),
                           4: lambda: fax_encode(rows, bw, "t6"),
                           32809: lambda: thunderscan_encode(rows, bw),
                           50000: lambda: zstd_compress(raw, 3)}[
                               compression]())
    if fill_order == 2:
        rev = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)],
                       np.uint8)
        chunks = [c if jpeg is not None else
                  rev[np.frombuffer(c, np.uint8)].tobytes() for c in chunks]
    head_len = 16 if big else 8
    data, offsets = bytearray(), []
    for c in chunks:
        offsets.append(head_len + len(data))
        data += c + b"\0" * (len(c) % 2)
    entries = {256: (4, [w]), 257: (4, [h]), 258: (3, [bps] * spp),
               259: (3, [compression]), 262: (3, [photometric]),
               277: (3, [spp]), 284: (3, [planar])}
    if tile:
        entries.update({322: (3, [tile[0]]), 323: (3, [tile[1]]),
                        324: (4, offsets), 325: (4, [len(c) for c in chunks])})
    else:
        entries.update({273: (4, offsets), 278: (4, [rows_per_strip or h]),
                        279: (4, [len(c) for c in chunks])})
    if predictor != 1:
        entries[317] = (3, [predictor])
    if fill_order != 1:
        entries[266] = (3, [fill_order])
    if sample_format:
        entries[339] = (3, [sample_format] * spp)
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    entries.update(dict(tags))
    codes = {1: "B", 3: "H", 4: "I", 5: "I", 7: "B", 11: "f", 16: "Q"}
    inline = 8 if big else 4
    base = head_len + len(data)
    ifd_len = (8 if big else 2) + (20 if big else 12) * len(entries) + inline
    ifd = bytearray(struct.pack(order + ("Q" if big else "H"), len(entries)))
    blob = bytearray()
    for tag, (typ, vals) in sorted(entries.items()):
        payload = struct.pack(f"{order}{len(vals)}{codes[typ]}", *vals)
        ifd += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ,
                           len(vals) // (2 if typ == 5 else 1))
        if len(payload) <= inline:
            ifd += payload.ljust(inline, b"\0")
        else:
            ifd += struct.pack(order + ("Q" if big else "I"),
                               base + ifd_len + len(blob))
            blob += payload + b"\0" * (len(payload) % 2)
    ifd += b"\0" * inline
    mark = b"II" if order == "<" else b"MM"
    head = mark + (struct.pack(order + "HHHQ", 43, 8, 0, base) if big
                   else struct.pack(order + "HI", 42, base))
    return bytes(head + data + ifd + blob)


# --- TIFF's CCITT, ThunderScan and ZSTD writers ------------------------------

def _fax_codes() -> dict:
    """The T.4 code tables, read out of utils/fax_cpp/fax.cpp (name ->
    {run or mode parameter: code string})."""
    import re
    with open(os.path.join(REPO, "gpupathtracer_tpu_torch", "utils",
                           "fax_cpp", "fax.cpp")) as f:
        src = f.read()
    out = {}
    for name in ("kTermW", "kMakeUpW", "kTermB", "kMakeUpB", "kMakeUp",
                 "kVR", "kVL"):
        body = src[src.index(f"const Code {name}[]"):]
        body = body[:body.index("};")]
        out[name] = {int(v): c for c, v in
                     re.findall(r'\{"([01]+)", (\d+)\}', body)}
    return out


def _fax_run(codes, run: int, black: bool) -> str:
    term = codes["kTermB" if black else "kTermW"]
    makeup = codes["kMakeUpB" if black else "kMakeUpW"]
    bits = ""
    while run > 2560:
        bits += codes["kMakeUp"][2560]
        run -= 2560
    if run >= 64:
        m = run // 64 * 64
        bits += makeup[m] if m <= 1728 else codes["kMakeUp"][m]
        run -= m
    return bits + term[run]


def _changes(row: np.ndarray) -> list:
    """A row's changing elements: the positions where the colour changes
    (white before the row), to black at even indices."""
    r = np.concatenate([[0], row.astype(np.int8)])
    return [int(p) for p in np.nonzero(np.diff(r))[0]]


def _fax_2d(codes, row, ref) -> str:
    """One row coded against the reference row (T.4 2-D / T.6): pass,
    vertical and horizontal modes, a0 starting before the row."""
    w = len(row)
    a_ch, b_ch = _changes(row), _changes(ref)
    bits, a0, colour = "", -1, 0
    while a0 < w:
        a1 = next((p for p in a_ch if p > a0), w)
        # b1: right of a0 and a change to the colour opposite a0's.
        i = next((i for i, p in enumerate(b_ch)
                  if p > a0 and (i % 2 == 0) == (colour == 0)), len(b_ch))
        b1 = b_ch[i] if i < len(b_ch) else w
        b2 = b_ch[i + 1] if i + 1 < len(b_ch) else w
        if b2 < a1:
            bits += "0001"
            a0 = b2
        elif abs(a1 - b1) <= 3:
            d = a1 - b1
            bits += "1" if d == 0 else (codes["kVR"][d] if d > 0
                                        else codes["kVL"][-d])
            a0, colour = a1, 1 - colour
        else:
            a2 = next((p for p in a_ch if p > a1), w)
            bits += "001" + _fax_run(codes, a1 - max(a0, 0), colour == 1) + \
                _fax_run(codes, a2 - a1, colour == 0)
            a0 = a2
    return bits


def fax_encode(rows, width: int, kind: str, k: int = 0,
               fill_bits: bool = False) -> bytes:
    """CCITT rows (1 bit a pixel, MSB first; 1 = black) as "mh" (Modified
    Huffman, rows byte-aligned: compression 2), "mhw" (16-bit aligned:
    32771), "t4" (EOL before each row; ``k`` > 0: T.4 2-D, the tag bit
    after each EOL, every k-th row 1-D; ``fill_bits``: each EOL ends on a
    byte boundary) or "t6" (2-D against the row above, an all-white row
    first, EOFB at the end)."""
    codes = _fax_codes()
    data = np.unpackbits(np.frombuffer(b"".join(rows), np.uint8)).reshape(
        len(rows), -1)[:, :width]
    bits = ""
    ref = np.zeros(width, np.uint8)
    for i, row in enumerate(data):
        one_d = "".join(_fax_run(codes, run, colour == 1)
                        for colour, run in _runs(row))
        if kind in ("mh", "mhw"):
            bits += one_d
            align = 8 if kind == "mh" else 16
            bits += "0" * (-len(bits) % align)
        elif kind == "t4":
            eol = "000000000001"
            if fill_bits:
                tail = 1 if k else 0
                bits += "0" * (-(len(bits) + len(eol) + tail) % 8)
            bits += eol
            if k:
                two_d = i % k != 0
                bits += ("0" + _fax_2d(codes, row, ref)) if two_d else (
                    "1" + one_d)
            else:
                bits += one_d
        else:
            bits += _fax_2d(codes, row, ref)
        ref = row
    if kind == "t6":
        bits += "000000000001" * 2
    elif kind == "t4":
        bits += ("000000000001" + ("1" if k else "")) * 6
    bits += "0" * (-len(bits) % 8)
    return bytes(int(bits[i:i + 8], 2) for i in range(0, len(bits), 8))


def _runs(row):
    """(colour, length) runs of a 0/1 row, a white one first (maybe 0)."""
    out, colour, n = [], 0, 0
    for v in row:
        if v == colour:
            n += 1
        else:
            out.append((colour, n))
            colour, n = int(v), 1
    out.append((colour, n))
    if len(out) % 2 == 1:
        out.append((1 - colour, 0))
    return out


def thunderscan_encode(rows, width: int) -> bytes:
    """4-bit rows as ThunderScan codes: runs of the last pixel (never the
    last code of a row), three 2-bit or two 3-bit deltas (a skip code fills
    a short tail), raw pixels."""
    out = bytearray()
    d2 = {0: 0, 1: 1, -1: 3}
    d3 = {0: 0, 1: 1, 2: 2, 3: 3, -3: 5, -2: 6, -1: 7}
    for r in rows:
        px = np.unpackbits(np.frombuffer(r, np.uint8)).reshape(-1, 4)
        px = (px @ np.array([8, 4, 2, 1]))[:width].tolist()
        last, i = 0, 0
        while i < width:
            k = 0
            while i + k < width and px[i + k] == last and k < 63:
                k += 1
            if k >= 2 and i + k < width:
                out.append(k)
                i += k
                continue
            deltas, cur = [], last
            for j in range(i, min(i + 3, width)):
                if px[j] - cur not in d2:
                    break
                deltas.append(d2[px[j] - cur])
                cur = px[j]
            if len(deltas) == 3 or (deltas and i + len(deltas) == width):
                n = len(deltas)
                deltas += [2] * (3 - n)
                out.append(0x40 | deltas[0] << 4 | deltas[1] << 2 | deltas[2])
                i += n
                last = cur
                continue
            deltas, cur = [], last
            for j in range(i, min(i + 2, width)):
                if px[j] - cur not in d3:
                    break
                deltas.append(d3[px[j] - cur])
                cur = px[j]
            if len(deltas) == 2 or (deltas and i + 1 == width):
                n = len(deltas)
                deltas += [4] * (2 - n)
                out.append(0x80 | deltas[0] << 3 | deltas[1])
                i += n
                last = cur
                continue
            out.append(0xC0 | px[i])
            last = px[i]
            i += 1
    return bytes(out)


def _libzstd():
    """The libzstd Pillow bundles (this tool runs where Pillow is)."""
    import ctypes
    import glob

    import PIL
    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libzstd-*.so*"))
    lib = ctypes.CDLL(libs[0])
    lib.ZSTD_createCCtx.restype = ctypes.c_void_p
    lib.ZSTD_CCtx_setParameter.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                           ctypes.c_int]
    lib.ZSTD_compress2.restype = ctypes.c_size_t
    lib.ZSTD_compress2.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                   ctypes.c_size_t, ctypes.c_void_p,
                                   ctypes.c_size_t]
    lib.ZSTD_compressBound.restype = ctypes.c_size_t
    lib.ZSTD_compressBound.argtypes = [ctypes.c_size_t]
    lib.ZSTD_freeCCtx.argtypes = [ctypes.c_void_p]
    return lib


def zstd_compress(data: bytes, level: int, checksum: bool = False,
                  content_size: bool = True, window_log: int = 0) -> bytes:
    """One Zstandard frame by libzstd: its level, the XXH64 checksum flag,
    the content size in the header or not, a window log (0: the level's)."""
    import ctypes
    lib = _libzstd()
    cctx = lib.ZSTD_createCCtx()
    for param, value in ((100, level), (201, int(checksum)),
                         (200, int(content_size)), (101, window_log)):
        lib.ZSTD_CCtx_setParameter(cctx, param, value)
    cap = lib.ZSTD_compressBound(len(data))
    out = ctypes.create_string_buffer(cap)
    n = lib.ZSTD_compress2(cctx, out, cap, data, len(data))
    lib.ZSTD_freeCCtx(cctx)
    if n > cap:
        raise RuntimeError("ZSTD_compress2 failed")
    return out.raw[:n]


def lab_table(path: str) -> None:
    """Write utils/lab_srgb.bin: the 33^3 x 3 16-bit table LittleCMS builds
    for PIL's LAB -> RGB conversion (ImageCms: the built-in Lab profile
    to sRGB, perceptual, PIL's LAB and RGB layouts), read out of the
    transform's optimized pipeline in the LittleCMS Pillow bundles, and
    checked against PIL's conversion of every LAB value."""
    import ctypes
    import glob

    import PIL
    from PIL import Image

    from gpupathtracer_tpu_torch.utils import lab as port_lab
    libs = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "liblcms2-*.so*"))
    lib = ctypes.CDLL(libs[0])
    for fn, res, args in (
            ("cmsCreateLab2Profile", ctypes.c_void_p, [ctypes.c_void_p]),
            ("cmsCreate_sRGBProfile", ctypes.c_void_p, []),
            ("cmsCreateTransform", ctypes.c_void_p,
             [ctypes.c_void_p, ctypes.c_uint32, ctypes.c_void_p,
              ctypes.c_uint32, ctypes.c_uint32, ctypes.c_uint32]),
            ("cmsPipelineGetPtrToFirstStage", ctypes.c_void_p,
             [ctypes.c_void_p]),
            ("cmsStageNext", ctypes.c_void_p, [ctypes.c_void_p]),
            ("cmsStageType", ctypes.c_uint32, [ctypes.c_void_p]),
            ("cmsStageData", ctypes.c_void_p, [ctypes.c_void_p])):
        getattr(lib, fn).restype = res
        getattr(lib, fn).argtypes = args
    # PIL's formats: LAB as PT_LabV2, 3 bytes and a pad; RGB 3 and a pad.
    fmt_lab = (30 << 16) | (1 << 7) | (3 << 3) | 1
    fmt_rgb = (4 << 16) | (1 << 7) | (3 << 3) | 1
    xf = lib.cmsCreateTransform(lib.cmsCreateLab2Profile(None), fmt_lab,
                                lib.cmsCreate_sRGBProfile(), fmt_rgb, 0, 0)
    # _cmsTRANSFORM: two formats, five function pointers and the 64-byte
    # cache come before the optimized pipeline (LittleCMS 2.17).
    lut = ctypes.cast(xf + 112, ctypes.POINTER(ctypes.c_void_p))[0]
    stage = lib.cmsPipelineGetPtrToFirstStage(lut)
    if lib.cmsStageType(stage) != int.from_bytes(b"clut", "big") or \
            lib.cmsStageNext(stage):
        raise RuntimeError("the transform is not one 16-bit table")
    clut_data = lib.cmsStageData(stage)
    tab = ctypes.cast(clut_data, ctypes.POINTER(ctypes.c_void_p))[0]
    n = ctypes.cast(clut_data + 16, ctypes.POINTER(ctypes.c_uint32))[0]
    table = np.ctypeslib.as_array(ctypes.cast(
        tab, ctypes.POINTER(ctypes.c_uint16)), (n,)).astype("<u2")
    with open(path, "wb") as f:
        f.write(zlib.compress(table.tobytes(), 9))
    port_lab._clut = None
    g = np.arange(256, dtype=np.uint8)
    lab = np.stack(np.meshgrid(g, g, g, indexing="ij"), -1).reshape(
        4096, 4096, 3)
    want = np.asarray(Image.frombytes("LAB", (4096, 4096), lab.tobytes())
                      .convert("RGB"))
    if port_lab.lab_to_rgb(lab).tobytes() != want.tobytes():
        raise AssertionError("the table does not give PIL's conversion")
    print(f"{path}: {n} entries, every LAB value bitwise PIL's")


def split_jpeg(jpg: bytes) -> tuple:
    """(JPEGTables: SOI, DQT and DHT, EOI; the abbreviated image: SOI,
    SOF, SOS and its data, no APPn) of a JPEG file."""
    tables, image, pos = bytearray(b"\xff\xd8"), bytearray(b"\xff\xd8"), 2
    while pos < len(jpg):
        m = jpg[pos + 1]
        if m == 0xDA:
            image += jpg[pos:]
            break
        n = struct.unpack(">H", jpg[pos + 2:pos + 4])[0]
        seg = jpg[pos:pos + 2 + n]
        if m in (0xDB, 0xC4):
            tables += seg
        elif not 0xE0 <= m <= 0xEF:
            image += seg
        pos += 2 + n
    return bytes(tables + b"\xff\xd9"), bytes(image)


def ycbcr_jpeg_tiff(rgb: np.ndarray, sub: int = 2, rows: int = 16,
                    quality: int = 80, tile=None) -> bytes:
    """A JPEG-in-TIFF of photometric 6 (YCbCr): each strip or tile PIL's
    JPEG at 4:4:4 (sub 1) or 4:2:0 (sub 2), its tables moved to
    JPEGTables, YCbCrSubsampling set to match."""
    from PIL import Image
    h = rgb.shape[0]
    tables = []

    def enc(p, x, y, bw, bh):
        c = np.zeros((bh, bw, 3), np.uint8)
        s = rgb[y:y + bh, x:x + bw]
        c[:s.shape[0], :s.shape[1]] = s
        if tile is None:
            c = c[:min(bh, h - y)]
        buf = io.BytesIO()
        Image.fromarray(c).save(buf, "JPEG", quality=quality,
                                subsampling={1: 0, 2: 2}[sub])
        t, img = split_jpeg(buf.getvalue())
        tables.append(t)
        return img

    write_tiff(rgb, 6, 8, compression=7, rows_per_strip=rows, tile=tile,
               jpeg=enc)
    return write_tiff(rgb, 6, 8, compression=7, rows_per_strip=rows,
                      tile=tile, jpeg=enc,
                      tags=((347, (7, list(tables[0]))),
                            (530, (3, [sub, sub]))))


def write_psd(planes, mode: int, bits: int = 8, rle: bool = False,
              palette=None, extra_channels: int = 0, width: int = None
              ) -> bytes:
    """A PSD of one layerless composite: ``planes`` [h, row bytes] uint8
    as stored (CMYK inverted, bitmaps packed), Photoshop colour ``mode``,
    raw or PackBits by rows, a 768-byte colour table for indexed files,
    ``extra_channels`` zero channels after them."""
    h = planes[0].shape[0]
    w = width or planes[0].shape[1]
    chans = list(planes) + [np.zeros_like(planes[0])] * extra_channels
    out = bytearray(b"8BPS" + struct.pack(">H", 1) + b"\0" * 6 + struct.pack(
        ">HIIHH", len(chans), h, w, bits, mode))
    table = bytes(palette) if palette is not None else b""
    out += struct.pack(">I", len(table)) + table + struct.pack(">II", 0, 0)
    if not rle:
        return bytes(out + struct.pack(">H", 0)
                     + b"".join(c.tobytes() for c in chans))
    rows = [[packbits(r.tobytes()) for r in c] for c in chans]
    out += struct.pack(">H", 1)
    out += b"".join(struct.pack(">H", len(r)) for c in rows for r in c)
    return bytes(out + b"".join(r for c in rows for r in c))


# --- WebP: the RIFF container, and what PIL's options cannot write ---------

def webp_chunk(tag: bytes, payload: bytes) -> bytes:
    """A RIFF chunk, padded to an even size."""
    return (tag + struct.pack("<I", len(payload)) + payload
            + b"\0" * (len(payload) & 1))


def webp_riff(chunks: bytes, riff_size: int = None) -> bytes:
    """A WebP file around ``chunks`` (its RIFF size given or true)."""
    if riff_size is None:
        riff_size = 4 + len(chunks)
    return b"RIFF" + struct.pack("<I", riff_size) + b"WEBP" + chunks


def webp_chunks(data: bytes) -> list:
    """(tag, payload) of each chunk of a well-formed WebP file."""
    out, pos = [], 12
    while pos + 8 <= len(data):
        (n,) = struct.unpack_from("<I", data, pos + 4)
        out.append((data[pos:pos + 4], data[pos + 8:pos + 8 + n]))
        pos += 8 + n + (n & 1)
    return out


def webp_vp8x(flags: int, w: int, h: int) -> bytes:
    """A VP8X chunk: the flags and the canvas size."""
    return webp_chunk(b"VP8X", struct.pack("<I", flags)
                      + (w - 1).to_bytes(3, "little")
                      + (h - 1).to_bytes(3, "little"))


def write_webp_anim(canvas, frames, loops: int = 0) -> bytes:
    """An animated WebP of ``canvas`` (w, h): VP8X (animation and alpha
    flags), ANIM, then an ANMF for each (x, y, still WebP file,
    duration ms, ANMF flags) of ``frames`` (even offsets) holding the
    still file's ALPH / VP8 / VP8L chunks; its size is the bitstream's."""
    body = b""
    for x, y, still, duration, flags in frames:
        image = [(t, p) for t, p in webp_chunks(still)
                 if t in (b"ALPH", b"VP8 ", b"VP8L")]
        tag, bits = image[-1]
        if tag == b"VP8L":
            v = struct.unpack_from("<I", bits, 1)[0]
            w, h = 1 + (v & 0x3FFF), 1 + ((v >> 14) & 0x3FFF)
        else:
            w, h = (struct.unpack_from("<H", bits, 6)[0] & 0x3FFF,
                    struct.unpack_from("<H", bits, 8)[0] & 0x3FFF)
        head = b"".join(v.to_bytes(3, "little") for v in (
            x // 2, y // 2, w - 1, h - 1, duration)) + bytes([flags])
        body += webp_chunk(b"ANMF", head + b"".join(
            webp_chunk(t, p) for t, p in image))
    return webp_riff(webp_vp8x(0x12, *canvas) + webp_chunk(
        b"ANIM", struct.pack("<IH", 0, loops)) + body)


# WebPConfig's fields, in order (libwebp 1.x, all 4 bytes: ints but the
# two floats).
_WEBP_CONFIG = (
    "lossless", "quality", "method", "image_hint", "target_size",
    "target_PSNR", "segments", "sns_strength", "filter_strength",
    "filter_sharpness", "filter_type", "autofilter", "alpha_compression",
    "alpha_filtering", "alpha_quality", "pass", "show_compressed",
    "preprocessing", "partitions", "partition_limit", "emulate_jpeg_size",
    "thread_level", "low_memory", "near_lossless", "exact",
    "use_delta_palette", "use_sharp_yuv", "qmin", "qmax")


def libwebp_encode(rgb: np.ndarray, **config) -> bytes:
    """A lossy WebP of uint8 [H, W, 3] by libwebp's advanced encoder (the
    library Pillow bundles, through ctypes), for what PIL's options do
    not reach: ``config`` sets WebPConfig fields (filter_type 0, the
    simple loop filter; partitions 3, eight token partitions, which
    libwebp writes at methods 0-2 only; ...)."""
    import ctypes
    import glob

    import PIL

    libs = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    for dep in sorted(glob.glob(os.path.join(libs, "libsharpyuv-*.so*"))):
        ctypes.CDLL(dep, mode=ctypes.RTLD_GLOBAL)
    found = glob.glob(os.path.join(libs, "libwebp-*.so*"))
    lib = ctypes.CDLL(found[0] if found else "libwebp.so")

    class Config(ctypes.Structure):
        _fields_ = [(f, ctypes.c_float if f in ("quality", "target_PSNR")
                     else ctypes.c_int) for f in _WEBP_CONFIG]

    class Writer(ctypes.Structure):
        _fields_ = [("mem", ctypes.POINTER(ctypes.c_uint8)),
                    ("size", ctypes.c_size_t), ("max_size", ctypes.c_size_t),
                    ("pad", ctypes.c_uint32)]

    abi = 0x0210    # WEBP_ENCODER_ABI_VERSION's major byte is what is held
    cfg = Config()
    if not lib.WebPConfigInitInternal(ctypes.byref(cfg), 0,
                                      ctypes.c_float(75.0), abi):
        raise RuntimeError("libwebp: WebPConfigInit failed")
    for k, v in config.items():
        setattr(cfg, k, v)
    if not lib.WebPValidateConfig(ctypes.byref(cfg)):
        raise ValueError(f"libwebp refuses the config {config}")
    # WebPPicture (256 bytes on LP64): use_argb at 0, width at 8, height
    # at 12, writer at 96, custom_ptr at 104, error_code at 136.
    pic = (ctypes.c_uint8 * 512)()
    if not lib.WebPPictureInitInternal(pic, abi):
        raise RuntimeError("libwebp: WebPPictureInit failed")
    h, w, _ = rgb.shape
    ctypes.c_int.from_buffer(pic, 8).value = w
    ctypes.c_int.from_buffer(pic, 12).value = h
    rgb = np.ascontiguousarray(rgb, np.uint8)
    writer = Writer()
    lib.WebPMemoryWriterInit(ctypes.byref(writer))
    try:
        if not lib.WebPPictureImportRGB(pic, rgb.ctypes.data_as(
                ctypes.c_void_p), w * 3):
            raise RuntimeError("libwebp: WebPPictureImportRGB failed")
        ctypes.c_void_p.from_buffer(pic, 96).value = ctypes.cast(
            lib.WebPMemoryWrite, ctypes.c_void_p).value
        ctypes.c_void_p.from_buffer(pic, 104).value = ctypes.addressof(writer)
        if not lib.WebPEncode(ctypes.byref(cfg), pic):
            raise RuntimeError(f"libwebp: WebPEncode failed (error "
                               f"{ctypes.c_int.from_buffer(pic, 136).value})")
        return ctypes.string_at(writer.mem, writer.size)
    finally:
        lib.WebPPictureFree(pic)
        lib.WebPMemoryWriterClear(ctypes.byref(writer))


# --- the fixtures -------------------------------------------------------------

# name -> (pixels, PIL save arguments): the JPEGs.
# --- JPEG processes PIL does not write: arithmetic coding and lossless --------
# Written from T.81 (Annex D's QM coder, F.1.4 and G.1.3's arithmetic
# coding models, Annex H's lossless predictors), with a small reader of
# baseline Huffman files for coefficients to transcode. None of it reads
# or shares the port's decoder.

# T.81 Table D.2: (Qe, Next_Index_LPS, Next_Index_MPS, Switch_MPS); entry
# 113 is the fixed estimate of 0.5 for signs and refinement bits (T.851).
QE_TABLE = (
    (0x5a1d, 1, 1, 1), (0x2586, 14, 2, 0), (0x1114, 16, 3, 0),
    (0x080b, 18, 4, 0), (0x03d8, 20, 5, 0), (0x01da, 23, 6, 0),
    (0x00e5, 25, 7, 0), (0x006f, 28, 8, 0), (0x0036, 30, 9, 0),
    (0x001a, 33, 10, 0), (0x000d, 35, 11, 0), (0x0006, 9, 12, 0),
    (0x0003, 10, 13, 0), (0x0001, 12, 13, 0), (0x5a7f, 15, 15, 1),
    (0x3f25, 36, 16, 0), (0x2cf2, 38, 17, 0), (0x207c, 39, 18, 0),
    (0x17b9, 40, 19, 0), (0x1182, 42, 20, 0), (0x0cef, 43, 21, 0),
    (0x09a1, 45, 22, 0), (0x072f, 46, 23, 0), (0x055c, 48, 24, 0),
    (0x0406, 49, 25, 0), (0x0303, 51, 26, 0), (0x0240, 52, 27, 0),
    (0x01b1, 54, 28, 0), (0x0144, 56, 29, 0), (0x00f5, 57, 30, 0),
    (0x00b7, 59, 31, 0), (0x008a, 60, 32, 0), (0x0068, 62, 33, 0),
    (0x004e, 63, 34, 0), (0x003b, 32, 35, 0), (0x002c, 33, 9, 0),
    (0x5ae1, 37, 37, 1), (0x484c, 64, 38, 0), (0x3a0d, 65, 39, 0),
    (0x2ef1, 67, 40, 0), (0x261f, 68, 41, 0), (0x1f33, 69, 42, 0),
    (0x19a8, 70, 43, 0), (0x1518, 72, 44, 0), (0x1177, 73, 45, 0),
    (0x0e74, 74, 46, 0), (0x0bfb, 75, 47, 0), (0x09f8, 77, 48, 0),
    (0x0861, 78, 49, 0), (0x0706, 79, 50, 0), (0x05cd, 48, 51, 0),
    (0x04de, 50, 52, 0), (0x040f, 50, 53, 0), (0x0363, 51, 54, 0),
    (0x02d4, 52, 55, 0), (0x025c, 53, 56, 0), (0x01f8, 54, 57, 0),
    (0x01a4, 55, 58, 0), (0x0160, 56, 59, 0), (0x0125, 57, 60, 0),
    (0x00f6, 58, 61, 0), (0x00cb, 59, 62, 0), (0x00ab, 61, 63, 0),
    (0x008f, 61, 32, 0), (0x5b12, 65, 65, 1), (0x4d04, 80, 66, 0),
    (0x412c, 81, 67, 0), (0x37d8, 82, 68, 0), (0x2fe8, 83, 69, 0),
    (0x293c, 84, 70, 0), (0x2379, 86, 71, 0), (0x1edf, 87, 72, 0),
    (0x1aa9, 87, 73, 0), (0x174e, 72, 74, 0), (0x1424, 72, 75, 0),
    (0x119c, 74, 76, 0), (0x0f6b, 74, 77, 0), (0x0d51, 75, 78, 0),
    (0x0bb6, 77, 79, 0), (0x0a40, 77, 48, 0), (0x5832, 80, 81, 1),
    (0x4d1c, 88, 82, 0), (0x438e, 89, 83, 0), (0x3bdd, 90, 84, 0),
    (0x34ee, 91, 85, 0), (0x2eae, 92, 86, 0), (0x299a, 93, 87, 0),
    (0x2516, 86, 71, 0), (0x5570, 88, 89, 1), (0x4ca9, 95, 90, 0),
    (0x44d9, 96, 91, 0), (0x3e22, 97, 92, 0), (0x3824, 99, 93, 0),
    (0x32b4, 99, 94, 0), (0x2e17, 93, 86, 0), (0x56a8, 95, 96, 1),
    (0x4f46, 101, 97, 0), (0x47e5, 102, 98, 0), (0x41cf, 103, 99, 0),
    (0x3c3d, 104, 100, 0), (0x375e, 99, 93, 0), (0x5231, 105, 102, 0),
    (0x4c0f, 106, 103, 0), (0x4639, 107, 104, 0), (0x415e, 103, 99, 0),
    (0x5627, 105, 106, 1), (0x50e7, 108, 107, 0), (0x4b85, 109, 103, 0),
    (0x5597, 110, 109, 0), (0x504f, 111, 107, 0), (0x5a10, 110, 111, 1),
    (0x5522, 112, 109, 0), (0x59eb, 112, 111, 1), (0x5a1d, 113, 113, 0))

# jcparam.c's jpeg_simple_progression for three components (and its first
# lines for one): (component indices, Ss, Se, Ah, Al).
PROGRESSION_3 = (((0, 1, 2), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                 ((2,), 1, 63, 0, 1), ((1,), 1, 63, 0, 1),
                 ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0, 1, 2), 0, 0, 1, 0), ((2,), 1, 63, 1, 0),
                 ((1,), 1, 63, 1, 0), ((0,), 1, 63, 1, 0))
PROGRESSION_1 = (((0,), 0, 0, 0, 1), ((0,), 1, 5, 0, 2),
                 ((0,), 6, 63, 0, 2), ((0,), 1, 63, 2, 1),
                 ((0,), 0, 0, 1, 0), ((0,), 1, 63, 1, 0))


def jpeg_segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class QMEncoder:
    """T.81 Annex D.1: the arithmetic encoder (Initenc, Code_0 / Code_1 as
    CodeLPS / CodeMPS with the conditional exchange, Renorm_e, Byte_out
    with its carry, Flush), over statistics bins held as bytearrays whose
    entries are (MPS << 7) | index."""

    def __init__(self):
        self.a, self.c, self.ct, self.out = 0x10000, 0, 11, []

    def code(self, st: bytearray, i: int, bit: int) -> None:
        sv = st[i]
        mps = sv >> 7
        qe, nlps, nmps, switch = QE_TABLE[sv & 0x7F]
        self.a -= qe
        if bit != mps:
            if self.a >= qe:
                self.c += self.a
                self.a = qe
            st[i] = ((mps ^ switch) << 7) | nlps
        else:
            if self.a >= 0x8000:
                return
            if self.a < qe:
                self.c += self.a
                self.a = qe
            st[i] = (mps << 7) | nmps
        while self.a < 0x8000:
            self.a <<= 1
            self.c <<= 1
            self.ct -= 1
            if self.ct == 0:
                self._byte_out()
                self.ct = 8

    def _byte_out(self):
        t = self.c >> 19
        if t > 0xFF:                    # the carry into the bytes out
            i = len(self.out) - 1
            while self.out[i] == 0xFF:
                self.out[i] = 0
                i -= 1
            self.out[i] += 1
            t &= 0xFF
        self.out.append(t)
        self.c &= 0x7FFFF

    def flush(self) -> bytes:
        t = (self.c + self.a - 1) & 0xFFFF0000       # Clear_final_bits
        self.c = t + 0x8000 if t < self.c else t
        self.c <<= self.ct
        self._byte_out()
        self.c <<= 8
        self._byte_out()
        while self.out and self.out[-1] == 0:       # Discard_final_zeros
            self.out.pop()
        return bytes(self.out).replace(b"\xff", b"\xff\x00")


class _ArithModel:
    """F.1.4 / G.1.3: the coding models of DC differences and AC
    coefficients, with DAC conditioning (L, U, Kx) per table."""

    def __init__(self, enc, dac):
        self.enc, self.dac = enc, dac
        self.fixed = bytearray([113])

    def value(self, st, i, v, x1, kx_bins=None):
        """Sign, magnitude category and magnitude bits of v != 0: S0 + 1 is
        the sign bin (DC), SP / SN follow; for AC the sign is coded at the
        fixed bin by the caller and i is already SP's."""
        e = self.enc
        v = abs(v) - 1
        if v == 0:
            e.code(st, i, 0)
            return 0
        e.code(st, i, 1)
        m, v2 = 1, v
        if kx_bins is None:             # DC: X1 ... at dc_stats + 20
            j = x1
            while True:
                v2 >>= 1
                if not v2:
                    break
                e.code(st, j, 1)
                m <<= 1
                j += 1
        else:                           # AC: X1 at SP, X2 ... at 189 / 217
            v2 >>= 1
            if v2:
                e.code(st, i, 1)
                m <<= 1
                j = kx_bins
                while True:
                    v2 >>= 1
                    if not v2:
                        break
                    e.code(st, j, 1)
                    m <<= 1
                    j += 1
            else:
                j = i
        e.code(st, j, 0)
        j += 14
        mm = m
        while mm > 1:
            mm >>= 1
            e.code(st, j, 1 if v & mm else 0)
        return m

    def dc(self, st, ctx, ci, diff, tbl):
        """F.1.4.1: one DC difference; updates ctx[ci]."""
        e = self.enc
        s0 = ctx[ci]
        if diff == 0:
            e.code(st, s0, 0)
            ctx[ci] = 0
            return
        e.code(st, s0, 1)
        sign = 1 if diff < 0 else 0
        e.code(st, s0 + 1, sign)
        m = self.value(st, s0 + 2 + sign, diff, 20)
        lo, hi = self.dac.get(tbl, (0, 1, 5))[:2]
        if m < (1 << lo) >> 1:
            ctx[ci] = 0
        elif m > (1 << hi) >> 1:
            ctx[ci] = 12 + 4 * sign
        else:
            ctx[ci] = 4 + 4 * sign

    def ac(self, st, zz, lo, hi, al, tbl):
        """F.1.4.2 / G.1.3.2: coefficients lo..hi of a zigzag block, each
        |v| >> al with its sign."""
        e = self.enc
        kx = self.dac.get(tbl, (0, 1, 5))[2]
        vals = [(abs(int(zz[k])) >> al) * (1 if zz[k] >= 0 else -1)
                for k in range(64)]
        ke = max([k for k in range(lo, hi + 1) if vals[k]], default=lo - 1)
        k = lo
        while k <= ke:
            s = 3 * (k - 1)
            e.code(st, s, 0)            # not EOB
            while vals[k] == 0:
                e.code(st, s + 1, 0)
                s += 3
                k += 1
            e.code(st, s + 1, 1)
            e.code(self.fixed, 0, 1 if vals[k] < 0 else 0)
            self.value(st, s + 2, vals[k], None,
                       189 if k <= kx else 217)
            k += 1
        if k <= hi:
            e.code(st, 3 * (k - 1), 1)  # EOB

    def ac_refine(self, st, zz, lo, hi, al):
        """G.1.3.3: the bit al of coefficients lo..hi."""
        e = self.enc
        mag = [abs(int(zz[k])) for k in range(64)]
        ke = max([k for k in range(lo, hi + 1) if mag[k] >> al],
                 default=lo - 1)
        kex = max([k for k in range(1, ke + 1) if mag[k] >> (al + 1)],
                  default=0)
        k = lo
        while k <= ke:
            s = 3 * (k - 1)
            if k > kex:
                e.code(st, s, 0)        # not EOB
            while True:
                v = mag[k] >> al
                if v:
                    if v >> 1:          # already nonzero: its next bit
                        e.code(st, s + 2, v & 1)
                    else:               # newly nonzero
                        e.code(st, s + 1, 1)
                        e.code(self.fixed, 0, 1 if zz[k] < 0 else 0)
                    break
                e.code(st, s + 1, 0)
                s += 3
                k += 1
            k += 1
        if k <= hi:
            e.code(st, 3 * (k - 1), 1)  # EOB


def read_huffman_jpeg(data: bytes) -> dict:
    """The coefficients of a baseline Huffman JPEG (SOF0 / SOF1, any
    scans, restart intervals): {"comps": [(id, h, v, tq)], "width",
    "height", "dqt": [DQT segment bodies], "app": [APPn segments],
    "restart", "blocks": [int array [rows, cols, 64] in zigzag order, MCU
    padded]}."""
    pos, out = 2, {"dqt": [], "app": [], "restart": 0}
    dc, ac = {}, {}
    while True:
        while data[pos] != 0xFF:
            pos += 1
        m = data[pos + 1]
        pos += 2
        if m == 0xD9:
            return out
        n = struct.unpack(">H", data[pos:pos + 2])[0]
        body = data[pos + 2:pos + n]
        pos += n
        if m == 0xDB:
            out["dqt"].append(body)
        elif 0xE0 <= m <= 0xEF:
            out["app"].append(jpeg_segment(m, body))
        elif m in (0xC0, 0xC1):
            h, w, nc = struct.unpack(">HHB", body[1:6])
            comps = [tuple(body[6 + 3 * i:9 + 3 * i]) for i in range(nc)]
            comps = [(i, hv >> 4, hv & 15, tq) for i, hv, tq in comps]
            maxh = max(c[1] for c in comps)
            maxv = max(c[2] for c in comps)
            out.update(width=w, height=h, comps=comps,
                       mcux=-(-w // (8 * maxh)), mcuy=-(-h // (8 * maxv)))
            out["blocks"] = [np.zeros((out["mcuy"] * v, out["mcux"] * hh, 64),
                                      np.int64) for _, hh, v, _ in comps]
        elif m == 0xDD:
            out["restart"] = struct.unpack(">H", body)[0]
        elif m == 0xC4:
            p = 0
            while p < len(body):
                tc, counts = body[p], body[p + 1:p + 17]
                syms = body[p + 17:p + 17 + sum(counts)]
                table, code, k = {}, 0, 0
                for length in range(1, 17):
                    for _ in range(counts[length - 1]):
                        table[(length, code)] = syms[k]
                        code += 1
                        k += 1
                    code <<= 1
                (ac if tc >> 4 else dc)[tc & 15] = table
                p += 17 + len(syms)
        elif m == 0xDA:
            pos = _read_huffman_scan(data, pos, body, out, dc, ac)


def _read_huffman_scan(data, pos, sos, out, dc, ac):
    """Decode one sequential scan into out["blocks"]; the position after
    its data."""
    ns = sos[0]
    ids = [c[0] for c in out["comps"]]
    scan = [(ids.index(sos[1 + 2 * i]), sos[2 + 2 * i] >> 4,
             sos[2 + 2 * i] & 15) for i in range(ns)]
    bits = []

    def load(p):                        # the bytes up to the next marker
        while True:
            b = data[p]
            if b == 0xFF:
                if data[p + 1] == 0:
                    bits.extend((0xFF >> (7 - i)) & 1 for i in range(8))
                    p += 2
                    continue
                return p
            bits.extend((b >> (7 - i)) & 1 for i in range(8))
            p += 1

    state = {"i": 0}

    def get(n):
        v = 0
        for _ in range(n):
            v = (v << 1) | bits[state["i"]]
            state["i"] += 1
        return v

    def sym(table):
        code, length = 0, 0
        while True:
            code = (code << 1) | get(1)
            length += 1
            if (length, code) in table:
                return table[(length, code)]

    def ext(v, s):
        return v - (1 << s) + 1 if v < (1 << (s - 1)) else v

    if ns == 1:
        c = scan[0][0]
        _, h, v, _ = out["comps"][c]
        maxh = max(x[1] for x in out["comps"])
        maxv = max(x[2] for x in out["comps"])
        bw = -(-(-(-out["width"] * h // maxh)) // 8)
        bh = -(-(-(-out["height"] * v // maxv)) // 8)
        units = [[(c, by, bx)] for by in range(bh) for bx in range(bw)]
    else:
        units = [[(c, my * out["comps"][c][2] + y, mx * out["comps"][c][1] + x)
                  for c, _, _ in scan for y in range(out["comps"][c][2])
                  for x in range(out["comps"][c][1])]
                 for my in range(out["mcuy"]) for mx in range(out["mcux"])]
    pos = load(pos)
    pred = {}
    tables = {c: (dc[td], ac[ta]) for c, td, ta in scan}
    for i, unit in enumerate(units):
        if i == 0 or (out["restart"] and i % out["restart"] == 0):
            if i:
                bits.clear()
                state["i"] = 0
                pos = load(pos + 2)     # past the RSTn marker
            pred = {c: 0 for c, _, _ in scan}
        for c, by, bx in unit:
            dct, act = tables[c]
            blk = out["blocks"][c][by, bx]
            s = sym(dct)
            pred[c] += ext(get(s), s) if s else 0
            blk[0] = pred[c]
            k = 1
            while k < 64:
                rs = sym(act)
                r, s = rs >> 4, rs & 15
                if s:
                    k += r
                    blk[k] = ext(get(s), s)
                    k += 1
                elif r == 15:
                    k += 16
                else:
                    break
    return pos


def _dqt_sof_dac(frame, sof, dac):
    """The DQT segments, the SOF, and DAC conditioning if any."""
    out = b"".join(jpeg_segment(0xDB, q) for q in frame["dqt"])
    out += jpeg_segment(sof, struct.pack(
        ">BHHB", 8, frame["height"], frame["width"], len(frame["comps"]))
        + b"".join(bytes([i, (h << 4) | v, tq])
                   for i, h, v, tq in frame["comps"]))
    if dac:
        body = b""
        for t, (lo, hi, kx) in sorted(dac.items()):
            body += bytes([t, (hi << 4) | lo, 16 + t, kx])
        out += jpeg_segment(0xCC, body)
    return out


def write_arith_jpeg(frame: dict, progression=None, restart: int = 0,
                     dac=None, tables=None, cut_after: int = None) -> bytes:
    """An arithmetic-coded JPEG of ``frame``'s coefficients (a dict as
    read_huffman_jpeg gives): SOF9 with one interleaved scan, or SOF10
    with ``progression`` [(components, Ss, Se, Ah, Al)]; ``restart``
    MCUs a restart interval; ``dac`` {table: (L, U, Kx)}; ``tables``
    the conditioning table of each component (default: 0 for the first,
    1 for the rest); ``cut_after`` ends the file (EOI) after that many
    scans."""
    comps = frame["comps"]
    nc = len(comps)
    dac = dac or {}
    tables = tables or [0] + [1] * (nc - 1)
    sof = 0xC9 if progression is None else 0xCA
    scans = progression or [(tuple(range(nc)), 0, 63, 0, 0)]
    out = b"\xff\xd8" + b"".join(frame["app"]) + _dqt_sof_dac(frame, sof, dac)
    if restart:
        out += jpeg_segment(0xDD, struct.pack(">H", restart))
    maxh = max(c[1] for c in comps)
    maxv = max(c[2] for c in comps)
    for si, (sc, ss, se, ah, al) in enumerate(scans):
        if cut_after is not None and si == cut_after:
            break
        out += jpeg_segment(0xDA, bytes([len(sc)]) + b"".join(
            bytes([comps[c][0], (tables[c] << 4) | tables[c]]) for c in sc)
            + bytes([ss, se, (ah << 4) | al]))
        if len(sc) == 1:
            c = sc[0]
            bw = -(-(-(-frame["width"] * comps[c][1] // maxh)) // 8)
            bh = -(-(-(-frame["height"] * comps[c][2] // maxv)) // 8)
            units = [[(c, by, bx)] for by in range(bh) for bx in range(bw)]
        else:
            units = [[(c, my * comps[c][2] + y, mx * comps[c][1] + x)
                      for c in sc for y in range(comps[c][2])
                      for x in range(comps[c][1])]
                     for my in range(frame["mcuy"])
                     for mx in range(frame["mcux"])]
        enc = None
        for i, unit in enumerate(units):
            if i == 0 or (restart and i % restart == 0):
                if enc is not None:
                    out += enc.flush() + bytes([0xFF, 0xD0 + (i // restart
                                                              - 1) % 8])
                enc = QMEncoder()
                model = _ArithModel(enc, dac)
                dcs = {t: bytearray(64) for t in set(tables)}
                acs = {t: bytearray(256) for t in set(tables)}
                ctx = {c: 0 for c in sc}
                pred = {c: 0 for c in sc}
            for c, by, bx in unit:
                zz = frame["blocks"][c][by, bx]
                t = tables[c]
                if ss == 0 and ah == 0:
                    v = int(zz[0]) >> al
                    model.dc(dcs[t], ctx, c, v - pred[c], t)
                    pred[c] = v
                elif ss == 0:
                    enc.code(model.fixed, 0, (int(zz[0]) >> al) & 1)
                if progression is None:
                    model.ac(acs[t], zz, 1, 63, 0, t)
                elif ss and ah == 0:
                    model.ac(acs[t], zz, ss, se, al, t)
                elif ss:
                    model.ac_refine(acs[t], zz, ss, se, al)
        out += enc.flush()
    return out + b"\xff\xd9"


def write_lossless_jpeg(planes, predictor: int, pt: int = 0,
                        sampling=None, restart_rows: int = 0, ids=None,
                        app: bytes = b"") -> bytes:
    """A lossless (SOF3) JPEG, T.81 Annex H: ``planes`` uint8 [h, w] (one
    per component, each at its own ``sampling`` (h, v) size), predictor
    1-7 and point transform ``pt``; one interleaved scan, a restart every
    ``restart_rows`` MCU rows; one Huffman table a component (each
    difference category used coded at one length)."""
    nc = len(planes)
    sampling = sampling or [(1, 1)] * nc
    ids = ids or list(range(1, nc + 1))
    maxh = max(s[0] for s in sampling)
    maxv = max(s[1] for s in sampling)
    height = planes[0].shape[0] * maxv // sampling[0][1]
    width = planes[0].shape[1] * maxh // sampling[0][0]
    mcux, mcuy = -(-width // maxh), -(-height // maxv)
    restart = restart_rows * mcux
    diffs = []
    for p, (sh, sv) in zip(planes, sampling):
        # Each component's differences, the predictors run over its
        # samples >> pt, the first row after each restart 1-D.
        x = p.astype(np.int64) >> pt
        d = np.zeros_like(x)
        rows_per = restart_rows * sv if restart_rows else x.shape[0]
        for y in range(x.shape[0]):
            first = y % rows_per == 0
            for i in range(x.shape[1]):
                if first:
                    pr = (1 << (8 - pt - 1)) if i == 0 else x[y, i - 1]
                elif i == 0:
                    pr = x[y - 1, 0]
                else:
                    ra, rb, rc = x[y, i - 1], x[y - 1, i], x[y - 1, i - 1]
                    pr = (ra, rb, rc, ra + rb - rc, ra + ((rb - rc) >> 1),
                          rb + ((ra - rc) >> 1), (ra + rb) >> 1)[predictor - 1]
                d[y, i] = x[y, i] - pr
        # padded to whole MCUs by repeating the last column and row
        ph, pw = mcuy * sv, mcux * sh
        d = np.pad(d, ((0, ph - d.shape[0]), (0, pw - d.shape[1])), "edge")
        diffs.append(d)
    cats = [np.vectorize(lambda v: abs(int(v)).bit_length())(d) for d in diffs]
    hts = []
    for c in range(nc):
        syms = sorted(set(int(s) for s in np.unique(cats[c])))
        length = 1
        while (1 << length) <= len(syms):
            length += 1
        counts = [0] * 16
        counts[length - 1] = len(syms)
        hts.append((bytes([c]) + bytes(counts) + bytes(syms),
                    {s: (i, length) for i, s in enumerate(syms)}))
    out = b"\xff\xd8" + app + jpeg_segment(0xC3, struct.pack(
        ">BHHB", 8, height, width, nc) + b"".join(
        bytes([ids[c], (sampling[c][0] << 4) | sampling[c][1], 0])
        for c in range(nc)))
    out += b"".join(jpeg_segment(0xC4, t[0]) for t in hts)
    if restart:
        out += jpeg_segment(0xDD, struct.pack(">H", restart))
    out += jpeg_segment(0xDA, bytes([nc]) + b"".join(
        bytes([ids[c], c << 4]) for c in range(nc))
        + bytes([predictor, 0, pt]))
    bitstr, acc, nbits = bytearray(), 0, 0
    marker = 0
    for my in range(mcuy):
        if restart and my and my % restart_rows == 0:
            if nbits:
                acc = (acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)
                bitstr.append(acc)
                if acc == 0xFF:
                    bitstr.append(0)
            acc, nbits = 0, 0
            bitstr += bytes([0xFF, 0xD0 + marker % 8])
            marker += 1
        for mx in range(mcux):
            for c, (sh, sv) in enumerate(sampling):
                for y in range(sv):
                    for x in range(sh):
                        v = int(diffs[c][my * sv + y, mx * sh + x])
                        s = cats[c][my * sv + y, mx * sh + x]
                        code, length = hts[c][1][s]
                        for val, n in ((code, length),
                                       (v if v >= 0 else v + (1 << s) - 1,
                                        s)):
                            for i in range(n - 1, -1, -1):
                                acc = (acc << 1) | ((val >> i) & 1)
                                nbits += 1
                                if nbits == 8:
                                    bitstr.append(acc)
                                    if acc == 0xFF:
                                        bitstr.append(0)
                                    acc, nbits = 0, 0
    if nbits:
        acc = (acc << (8 - nbits)) | ((1 << (8 - nbits)) - 1)
        bitstr.append(acc)
        if acc == 0xFF:
            bitstr.append(0)
    return out + bytes(bitstr) + b"\xff\xd9"


def _cut_after_scans(jpg: bytes, k: int) -> bytes:
    """The file up to its (k+1)-th SOS, then EOI: its first k scans."""
    sos = [i for i in range(len(jpg) - 1) if jpg[i:i + 2] == b"\xff\xda"]
    return jpg[:sos[k]] + b"\xff\xd9"


def jpeg_rest_fixtures(t: dict) -> dict:
    """The JPEG processes and recoveries PIL reads beside baseline and
    progressive Huffman files: arithmetic-coded transcodes of the checker
    (SOF9) and roof (SOF10) maps, which decode to their Huffman
    originals; lossless (SOF3) encodings of the bricks and foliage twins;
    small files of each kind (arithmetic: grey, 4:2:0 with restarts, 4:4:4
    under a DAC, progressive whole and cut; lossless: predictors 1-7, Pt 0
    and 2, one and three components, restarts, 2x2 sampling), a file with
    no DHT (libjpeg's standard tables), a PIL progressive file cut after
    scans 1, 3 and 7 (block smoothing), a scan cut by EOI and a dropped
    RST marker (libjpeg's recovery)."""
    from PIL import Image

    def jpg(img, **kw):
        return _pil(img, "JPEG", **kw)

    maps = fixtures()

    def frame(name):                    # the coefficients of name.jpg
        pixels, kw = maps[name]
        return read_huffman_jpeg(jpg(pixels, **kw))

    photo = t["sky"][100:140, 200:248]
    grey = t["grey"][20:60, 30:78, 0]
    out = {
        "checker_arith": ("checker_arith.jpg", write_arith_jpeg(
            frame("checker")), "checker.png",
            {"JPEG": "arithmetic sequential (SOF9), checker.jpg's "
                     "coefficients"}),
        "roof_arith": ("roof_arith.jpg", write_arith_jpeg(
            frame("roof"), PROGRESSION_3, restart=5), "roof.png",
            {"JPEG": "arithmetic progressive (SOF10), roof.jpg's "
                     "coefficients, 10 scans, restarts every 5 MCUs"}),
        "bricks_lossless": ("bricks_lossless.jpg", write_lossless_jpeg(
            [t["bricks"][..., c] for c in range(3)], 7), "bricks.png",
            {"JPEG": "lossless (SOF3), predictor 7, RGB"}),
        "foliage_lossless": ("foliage_lossless.jpg", write_lossless_jpeg(
            [t["foliage"][..., c] for c in range(3)], 4, restart_rows=16),
            "foliage.png",
            {"JPEG": "lossless (SOF3), predictor 4, RGB, restarts every 16 "
                     "rows"}),
        "arith_grey": ("arith_grey.jpg", write_arith_jpeg(
            read_huffman_jpeg(jpg(grey, quality=85)), restart=7), None,
            {"JPEG": "arithmetic sequential, grey, restarts every 7 MCUs"}),
        "arith_420": ("arith_420.jpg", write_arith_jpeg(
            read_huffman_jpeg(jpg(photo, quality=80, subsampling=2)),
            restart=3), None,
            {"JPEG": "arithmetic sequential, 4:2:0, restarts every 3 MCUs"}),
        "arith_444_dac": ("arith_444_dac.jpg", write_arith_jpeg(
            read_huffman_jpeg(jpg(photo, quality=90, subsampling=0)),
            dac={0: (2, 5, 12), 1: (1, 3, 2)}), None,
            {"JPEG": "arithmetic sequential, 4:4:4, DAC L/U/Kx 2/5/12 and "
                     "1/3/2"}),
    }
    prog = read_huffman_jpeg(jpg(photo, quality=75, subsampling=2))
    out["arith_prog"] = ("arith_prog.jpg", write_arith_jpeg(
        prog, PROGRESSION_3), None,
        {"JPEG": "arithmetic progressive (SOF10), 4:2:0, 10 scans"})
    out["arith_prog_cut"] = ("arith_prog_cut.jpg", write_arith_jpeg(
        prog, PROGRESSION_3, cut_after=4), None,
        {"JPEG": "arithmetic progressive, cut after scan 4 (block "
                 "smoothing)"})
    lossless = {1: (1, 0, {}), 2: (3, 2, {}), 3: (3, 0, {}),
                4: (1, 2, {}), 5: (3, 0, dict(restart_rows=5)),
                6: (3, 2, dict(sampling=[(2, 2), (1, 1), (1, 1)])),
                7: (1, 0, {})}
    for p, (nc, pt, kw) in lossless.items():
        if nc == 1:
            planes = [grey]
        elif "sampling" in kw:
            planes = [photo[..., 0], photo[::2, ::2, 1], photo[::2, ::2, 2]]
        else:
            planes = [photo[..., c] for c in range(3)]
        extra = ", restarts every 5 rows" if "restart_rows" in kw else (
            ", 2x2 sampling of the first component" if "sampling" in kw
            else "")
        data = write_lossless_jpeg(planes, p, pt, **kw)
        if pt == 0 and "sampling" not in kw:
            got = np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))
            want = np.stack(planes * 3 if nc == 1 else planes, -1)
            if got.tobytes() != want.tobytes():
                raise AssertionError(f"lossless_p{p}.jpg does not decode to "
                                     f"its samples")
        out[f"lossless_p{p}"] = (f"lossless_p{p}.jpg", data, None,
            {"JPEG": f"lossless, predictor {p}, Pt {pt}, {nc} "
                     f"component{'s' if nc > 1 else ''}{extra}"})
    base = jpg(photo, quality=80, subsampling=2)
    nodht = bytearray()
    pos = 2
    nodht += base[:2]
    while base[pos + 1] != 0xDA:
        n = struct.unpack(">H", base[pos + 2:pos + 4])[0]
        if base[pos + 1] != 0xC4:
            nodht += base[pos:pos + 2 + n]
        pos += 2 + n
    nodht += base[pos:]
    out["nodht"] = ("nodht.jpg", bytes(nodht), None,
                    {"JPEG": "baseline 4:2:0 without DHT (libjpeg's "
                             "standard tables)"})
    progressive = jpg(t["bricks"][:64, :80], quality=75, subsampling=2,
                      progressive=True)
    for k in (1, 3, 7):
        out[f"prog_cut{k}"] = (f"prog_cut{k}.jpg", _cut_after_scans(
            progressive, k), None,
            {"JPEG": f"PIL progressive 4:2:0 cut after scan {k} (block "
                     f"smoothing)"})
    seq = jpg(photo, quality=85, subsampling=1)
    sos = seq.find(b"\xff\xda")
    out["scan_cut"] = ("scan_cut.jpg", seq[:sos + (len(seq) - sos) * 2 // 3]
                       + b"\xff\xd9", None,
                       {"JPEG": "4:2:2, its scan cut by EOI two thirds in "
                                "(zero bits, then grey)"})
    rst = jpg(photo, quality=85, subsampling=2, restart_marker_blocks=2)
    marks = [i for i in range(len(rst) - 1)
             if rst[i] == 0xFF and 0xD0 <= rst[i + 1] <= 0xD7]
    k = marks[len(marks) // 2]
    out["rst_dropped"] = ("rst_dropped.jpg", rst[:k] + rst[k + 2:], None,
                          {"JPEG": "restarts every 2 MCUs, one RST marker "
                                   "dropped (libjpeg's resync)"})
    return out


def fixtures() -> dict:
    maps = town_maps()
    grey = (0.299 * maps["bricks"][..., 0] + 0.587 * maps["bricks"][..., 1]
            + 0.114 * maps["bricks"][..., 2] + 0.5).astype(np.uint8)
    return {
        "checker": (maps["checker"], dict(quality=95, subsampling=0)),
        "bricks": (maps["bricks"], dict(quality=75, subsampling=2,
                                        progressive=True)),
        "roof": (maps["roof"], dict(quality=50, subsampling=1,
                                    restart_marker_blocks=5)),
        "foliage": (maps["foliage"], dict(quality=85, subsampling=2,
                                          optimize=True)),
        "grey": (grey, dict(quality=90)),
        "map1024": (big_map(), dict(quality=75, subsampling=2)),
        "sky": (sky(), dict(quality=90, subsampling=2)),
    }


def _pil(img, fmt: str, **kw) -> bytes:
    """PIL's encoding of an array or an Image."""
    from PIL import Image
    buf = io.BytesIO()
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def other_fixtures(twins: dict) -> dict:
    """name -> (file name, bytes, twin PNG or None, encoding): the formats
    beside JPEG, made from the JPEG fixtures' decodes ``twins`` (a
    lossless file names the PNG twin it must decode to; a lossy one gets
    a PNG of PIL's decode)."""
    from PIL import Image
    t = twins
    rgba = {k: np.concatenate([v, np.full(v.shape[:2] + (1,), 255, np.uint8)],
                              -1) for k, v in t.items() if v.ndim == 3}
    cmyk = _pil(Image.fromarray(t["bricks"]).convert("CMYK"), "JPEG",
                quality=85)
    ycck = bytearray(cmyk)
    ycck[ycck.find(b"\xff\xee") + 4 + 11] = 2     # the Adobe transform
    pal = Image.fromarray(t["roof"]).quantize(64, dither=Image.Dither.NONE)
    return {
        "checker_tif": ("checker.tif", _pil(t["checker"], "TIFF",
                                            compression="tiff_lzw"),
                        "checker.png", {"TIFF": "LZW (PIL)"}),
        "bricks_psd": ("bricks.psd", write_psd(
            [t["bricks"][..., c] for c in range(3)], 3, rle=True),
            "bricks.png", {"PSD": "RGB, PackBits"}),
        "roof_dds": ("roof.dds", _pil(t["roof"], "DDS"), "roof.png",
                     {"DDS": "uncompressed RGB (PIL)"}),
        "foliage_bmp": ("foliage.bmp", _pil(t["foliage"], "BMP"),
                        "foliage.png", {"BMP": "24-bit (PIL)"}),
        "sky_tif": ("sky.tif", write_tiff(
            t["sky"], 2, 8, compression=8, predictor=2, tile=(128, 64)),
            "sky.png", {"TIFF": "tiles 128x64, Deflate, predictor 2"}),
        "bricks_bc1": ("bricks_bc1.dds", _pil(rgba["bricks"], "DDS",
                                              pixel_format="DXT1"), None,
                       {"DDS": "DXT1 (PIL)"}),
        "foliage_bc3": ("foliage_bc3.dds", _pil(rgba["foliage"], "DDS",
                                                pixel_format="DXT5"), None,
                        {"DDS": "DXT5 (PIL)"}),
        "checker_bc5": ("checker_bc5.dds", _pil(t["checker"], "DDS",
                                                pixel_format="BC5"), None,
                        {"DDS": "BC5 (PIL)"}),
        "bc4": ("bc4.dds", write_dds(32, 32, random_blocks(64, 8, 41),
                                     fourcc=b"ATI1"), None,
                {"DDS": "BC4 (ATI1), seeded random blocks"}),
        "bc6h_uf16": ("bc6h_uf16.dds", write_dds(
            72, 64, random_blocks(288, 16, 42, BC6H_MODES, bc6h=True),
            dxgi=95), None,
            {"DDS": "BC6H UF16, seeded random blocks, every mode"}),
        "bc6h_sf16": ("bc6h_sf16.dds", write_dds(
            72, 64, random_blocks(288, 16, 43, BC6H_MODES, bc6h=True),
            dxgi=96), None,
            {"DDS": "BC6H SF16, seeded random blocks, every mode"}),
        "bc7": ("bc7.dds", write_dds(
            70, 61, random_blocks(288, 16, 44, list(range(9))), dxgi=98),
            None, {"DDS": "BC7, seeded random blocks, modes 0-7 and "
                          "invalid"}),
        "roof_gif": ("roof.gif", _pil(pal, "GIF"), None,
                     {"GIF": "64 colours (PIL's quantizer)"}),
        "bricks_cmyk": ("bricks_cmyk.jpg", cmyk, None,
                        {"JPEG": "CMYK, q85 (PIL)"}),
        "bricks_ycck": ("bricks_ycck.jpg", bytes(ycck), None,
                        {"JPEG": "the CMYK file, Adobe transform 2 (YCCK)"}),
        **webp_fixtures(t),
        **jpeg_rest_fixtures(t),
        **simple_fixtures(t),
        **tiff_rest_fixtures(t),
        **{k: (f, d, tw, {"JPEG2000": e}) for k, (f, d, tw, e) in
           jpeg2000_fixtures(t).items()},
        **{k: (f, d, tw, {"ICNS": e}) for k, (f, d, tw, e) in
           icns_fixtures(t).items()},
        **{k: (f, d, tw, {"JPEG2000": e}) for k, (f, d, tw, e) in
           jpeg2000_rest_fixtures(t).items()},
    }


def webp_fixtures(t: dict) -> dict:
    """The WebP files: lossless re-encodings of the town's PNG twins (each
    at another method and quality), a lossy map at q75, lossy RGBA (VP8X
    and ALPH), an animation whose first frame is offset on its canvas,
    and two that PIL's options cannot write (libwebp_encode): the simple
    loop filter, and eight token partitions."""
    from PIL import Image
    lossless = {"checker": (6, 100), "bricks": (0, 0), "roof": (4, 50),
                "foliage": (2, 75)}
    out = {f"{k}_webp": (f"{k}.webp", _pil(t[k], "WEBP", lossless=True,
                                          method=m, quality=q), f"{k}.png",
                         {"WEBP": f"lossless, method {m}, q{q} (PIL)"})
           for k, (m, q) in lossless.items()}
    yy, xx = np.mgrid[0:128, 0:128]
    alpha = ((xx + yy) * 255 // 254).astype(np.uint8)[..., None]
    still = _pil(t["bricks"][16:96, 8:104], "WEBP", quality=70)
    second = _pil(t["roof"], "WEBP", lossless=True)
    out.update({
        "bricks_q75": ("bricks_q75.webp", _pil(t["bricks"], "WEBP",
                                               quality=75), None,
                       {"WEBP": "lossy, q75 (PIL)"}),
        "foliage_alpha": ("foliage_alpha.webp", _pil(Image.fromarray(
            np.concatenate([t["foliage"], alpha], -1)), "WEBP", quality=80,
            alpha_quality=60), None,
            {"WEBP": "lossy RGBA, q80, alpha q60: VP8X + ALPH (PIL)"}),
        "anim_offset": ("anim_offset.webp", write_webp_anim(
            (128, 128), [(8, 16, still, 100, 0), (0, 0, second, 100, 0)]),
            None, {"WEBP": "animated, a 96x80 lossy first frame at (8, 16) "
                           "then a lossless one"}),
        "foliage_simple": ("foliage_simple.webp", libwebp_encode(
            t["foliage"], quality=80.0, filter_type=0, filter_strength=60,
            filter_sharpness=2), None,
            {"WEBP": "lossy, the simple loop filter (libwebp)"}),
        "bricks_parts8": ("bricks_parts8.webp", libwebp_encode(
            t["bricks"], quality=70.0, method=2, partitions=3, segments=4),
            None, {"WEBP": "lossy, eight token partitions (libwebp)"}),
    })
    return out


# --- the simple formats PIL does not write: plain PNM, SGI RLE, PCX planes,
# --- CUR and ICO directories --------------------------------------------------

def ycbcr_units(rgb: np.ndarray, sh: int, sv: int) -> bytes:
    """RGB [h, w, 3] as subsampled YCbCr data units (sh * sv luma samples,
    then Cb and Cr, the block's means): any conversion serves, the file
    holds what the units hold."""
    h, w, _ = rgb.shape
    f = rgb.astype(np.float64)
    y = 0.299 * f[..., 0] + 0.587 * f[..., 1] + 0.114 * f[..., 2]
    cb = 128 + (f[..., 2] - y) * 0.564
    cr = 128 + (f[..., 0] - y) * 0.713
    H, Wd = -(-h // sv) * sv, -(-w // sh) * sh
    pad = lambda a: np.pad(a, ((0, H - h), (0, Wd - w)), mode="edge")  # noqa: E731
    y, cb, cr = (np.clip(np.rint(pad(a)), 0, 255).astype(np.uint8)
                 for a in (y, cb, cr))
    units = []
    for by in range(0, H, sv):
        for bx in range(0, Wd, sh):
            units.append(y[by:by + sv, bx:bx + sh].reshape(-1))
            units.append([int(cb[by:by + sv, bx:bx + sh].mean()),
                          int(cr[by:by + sv, bx:bx + sh].mean())])
    return np.concatenate(units).astype(np.uint8).tobytes()


# The town's maps as ZSTD TIFFs (chip_smoke.py phase 25b): file names, and
# the Orientation a map is stored under (its pixels stored so that PIL's
# exif_transpose gives the map).
TOWN_ZSTD = {"checker": "checker_zstd.tif", "bricks": "bricks_zstd.tif",
             "roof": "roof_zstd.tif", "foliage": "foliage_zstd.tif"}
ROOF_ORIENTATION = 6


def _untranspose(img: np.ndarray, orient: int) -> np.ndarray:
    """The pixels to store so that PIL's exif_transpose of ``orient``
    gives ``img``."""
    return {2: lambda: img[:, ::-1], 3: lambda: img[::-1, ::-1],
            4: lambda: img[::-1], 5: lambda: img.transpose(1, 0, 2),
            6: lambda: img[:, ::-1].transpose(1, 0, 2),
            7: lambda: img[::-1, ::-1].transpose(1, 0, 2),
            8: lambda: img[::-1].transpose(1, 0, 2)}[orient]()


def tiff_rest_fixtures(t: dict) -> dict:
    """The TIFF files of the sixth image slice: the town's four maps as ZSTD
    TIFFs with horizontal differencing (libzstd at levels 19 and 22, one
    with its checksum and no content size, one by PIL's own writer, roof
    stored transposed under Orientation 6), and small files of each CCITT
    variant (PIL's Group 3, Group 4, Modified Huffman and 16-bit-aligned
    writers; this tool's T.4 2-D with fill bits, T.6 in fill order 2 and
    in tiles), ThunderScan, old-style LZW, ZSTD (a frame of several
    blocks, fill order 2), fill order 2 raw and compressed, orientations
    2-8, 12-bit, signed and unsigned 32-bit grey, a planar 16-bit raw
    file, subsampled YCbCr, Lab, and a Lab PSD."""
    from PIL import Image
    rng = np.random.RandomState(23)
    zs = lambda lvl, cs=False, fcs=True, wl=0: (  # noqa: E731
        lambda rows, bw: zstd_compress(b"".join(rows), lvl, cs, fcs, wl))
    roof = np.ascontiguousarray(_untranspose(t["roof"], ROOF_ORIENTATION))
    foliage_buf = io.BytesIO()
    Image.fromarray(t["foliage"]).save(foliage_buf, "TIFF",
                                       compression="zstd")
    y, x = np.mgrid[0:40, 0:48]
    bilevel = (((x // 6 + y // 5) % 3 == 0) | (np.sin(x / 5.0) * np.cos(
        y / 3.0) > 0.5)).astype(np.uint8)
    bl = Image.fromarray(bilevel * 255).convert("1")
    grey4 = np.clip(np.cumsum(rng.randint(-1, 2, (24, 37)), 1) + 8, 0,
                    15).astype(np.uint8)
    grey4[:, -1] = 15 - grey4[:, -1]
    small = t["bricks"][40:64, 24:56]
    smooth = (np.sin(np.arange(300)[None, :, None] / 17.0 + np.arange(3))
              * 60 + np.arange(280)[:, None, None] * 0.4 + 60).astype(
                  np.uint8)
    g12 = rng.randint(0, 4096, (9, 14)).astype(np.uint16)
    g12[0, :6] = [0, 100, 254, 255, 256, 4095]
    s16 = rng.randint(-400, 400, (9, 14)).astype(np.int16).view(np.uint16)
    s32 = rng.randint(-600, 600, (9, 14)).astype(np.int32).view(np.uint32)
    u32 = rng.randint(0, 300, (9, 14)).astype(np.uint32)
    u32[0, :3] = [2 ** 31, 2 ** 32 - 1, 2 ** 31 - 1]
    p16 = (t["foliage"][:20, :18].astype(np.uint16) * 257
           + rng.randint(0, 256, (20, 18, 3)).astype(np.uint16))
    lab = small.copy()
    units = lambda sh, sv: (lambda rows, bw: lzw_tiff(ycbcr_units(  # noqa
        np.frombuffer(b"".join(rows), np.uint8).reshape(-1, bw, 3), sh,
        sv)))
    out = {
        "checker_zstd": (TOWN_ZSTD["checker"], write_tiff(
            t["checker"], 2, 8, compression=50000, predictor=2,
            encode=zs(19)), "checker.png",
            {"TIFF": "ZSTD level 19, predictor 2"}),
        "bricks_zstd": (TOWN_ZSTD["bricks"], write_tiff(
            t["bricks"], 2, 8, compression=50000, predictor=2,
            rows_per_strip=48, encode=zs(22, True, False)), "bricks.png",
            {"TIFF": "ZSTD level 22 with its checksum, no content size, "
                     "predictor 2, strips of 48 rows"}),
        "roof_zstd": (TOWN_ZSTD["roof"], write_tiff(
            roof, 2, 8, compression=50000, predictor=2, encode=zs(3),
            tags=[(274, (3, [ROOF_ORIENTATION]))]), "roof.png",
            {"TIFF": f"ZSTD level 3, predictor 2, stored transposed under "
                     f"Orientation {ROOF_ORIENTATION}"}),
        "foliage_zstd": (TOWN_ZSTD["foliage"], foliage_buf.getvalue(),
                         "foliage.png", {"TIFF": "ZSTD (PIL)"}),
        "fax_g3": ("fax_g3.tif", _pil(bl, "TIFF", compression="group3"),
                   None, {"TIFF": "CCITT T.4 1-D (PIL)"}),
        "fax_g4": ("fax_g4.tif", _pil(bl, "TIFF", compression="group4"),
                   None, {"TIFF": "CCITT T.6 (PIL)"}),
        "fax_mh": ("fax_mh.tif", _pil(bl, "TIFF", compression="tiff_ccitt"),
                   None, {"TIFF": "CCITT Modified Huffman (PIL)"}),
        "fax_raw16": ("fax_raw16.tif", _pil(bl, "TIFF",
                                            compression="tiff_raw_16"),
                      None, {"TIFF": "CCITT Modified Huffman, 16-bit rows "
                                     "(PIL; libtiff warns of a bad code "
                                     "word and reads on)"}),
        "fax_t4_2d": ("fax_t4_2d.tif", write_tiff(
            bilevel, 0, 1, compression=3, tags=[(292, (4, [5]))],
            encode=lambda rows, bw: fax_encode(rows, bw, "t4", k=4,
                                               fill_bits=True)), None,
            {"TIFF": "CCITT T.4 2-D, K = 4, fill bits"}),
        "fax_t6_fo2": ("fax_t6_fo2.tif", write_tiff(
            bilevel, 0, 1, compression=4, fill_order=2), None,
            {"TIFF": "CCITT T.6, fill order 2"}),
        "fax_t6_tiles": ("fax_t6_tiles.tif", write_tiff(
            bilevel, 1, 1, compression=4, tile=(32, 16)), None,
            {"TIFF": "CCITT T.6 in 32x16 tiles, photometric 1"}),
        "thunderscan": ("thunderscan.tif", write_tiff(
            grey4, 1, 4, compression=32809, rows_per_strip=10), None,
            {"TIFF": "ThunderScan, 4-bit grey"}),
        "thunderscan_fo2": ("thunderscan_fo2.tif", write_tiff(
            grey4, 0, 4, compression=32809, fill_order=2), None,
            {"TIFF": "ThunderScan, photometric 0, fill order 2"}),
        "lzw_old": ("lzw_old.tif", write_tiff(
            small, 2, 8, compression=5, predictor=2,
            encode=lambda rows, bw: lzw_tiff(b"".join(rows), compat=True)),
            None, {"TIFF": "old-style (LSB-first) LZW, predictor 2"}),
        "zstd_blocks": ("zstd_blocks.tif", write_tiff(
            smooth, 2, 8, compression=50000, encode=zs(1, True, True, 17)),
            None, {"TIFF": "ZSTD level 1, window 2^17, a strip of several "
                           "blocks"}),
        "zstd_fo2": ("zstd_fo2.tif", write_tiff(
            small, 2, 8, compression=50000, predictor=2, fill_order=2),
            None, {"TIFF": "ZSTD, predictor 2, fill order 2"}),
        "fo2_rgb": ("fo2_rgb.tif", write_tiff(small, 2, 8, fill_order=2),
                    None, {"TIFF": "uncompressed RGB, fill order 2"}),
        "fo2_grey2": ("fo2_grey2.tif", write_tiff(
            grey4 // 4, 0, 2, fill_order=2), None,
            {"TIFF": "uncompressed 2-bit grey, photometric 0, fill order 2"}),
        "fo2_i16": ("fo2_i16.tif", write_tiff(
            g12 * 3, 1, 16, fill_order=2), None,
            {"TIFF": "uncompressed 16-bit grey, fill order 2"}),
        "fo2_palette": ("fo2_palette.tif", write_tiff(
            grey4, 3, 4, compression=5, fill_order=2,
            colormap=list(rng.randint(0, 65536, 48))), None,
            {"TIFF": "4-bit palette, LZW, fill order 2"}),
        **{f"orient{o}": (f"orient{o}.tif", write_tiff(
            small[:9, :13], 2, 8, compression=5 if o % 2 else 1,
            tags=[(274, (3, [o]))]), None,
            {"TIFF": f"Orientation {o}, " + ("LZW" if o % 2 else
                                             "uncompressed")})
           for o in range(2, 9)},
        "grey12": ("grey12.tif", write_tiff(g12, 1, 12, compression=8),
                   None, {"TIFF": "12-bit grey, Deflate"}),
        "int16s": ("int16s.tif", write_tiff(
            s16, 1, 16, order=">", compression=5, sample_format=2), None,
            {"TIFF": "signed 16-bit grey, big-endian, LZW"}),
        "int32s": ("int32s.tif", write_tiff(s32, 1, 32, sample_format=2),
                   None, {"TIFF": "signed 32-bit grey"}),
        "uint32": ("uint32.tif", write_tiff(u32, 1, 32, compression=50000),
                   None, {"TIFF": "unsigned 32-bit grey, ZSTD"}),
        "planar16": ("planar16.tif", write_tiff(p16, 2, 16, planar=2),
                     None, {"TIFF": "uncompressed planar RGB at 16 bits "
                                    "(PIL reads a byte a sample)"}),
        "ycbcr22": ("ycbcr22.tif", write_tiff(
            small[:23, :29], 6, 8, compression=5, rows_per_strip=8,
            encode=units(2, 2), tags=[(530, (3, [2, 2]))]), None,
            {"TIFF": "YCbCr 4:2:0, LZW (libtiff's RGBA interface)"}),
        "ycbcr41": ("ycbcr41.tif", write_tiff(
            small[:9, :13], 6, 8, compression=8, encode=lambda rows, bw:
            zlib.compress(ycbcr_units(np.frombuffer(
                b"".join(rows), np.uint8).reshape(-1, bw, 3), 4, 1)),
            tags=[(530, (3, [4, 1])), (532, (5, [16, 1, 235, 1, 128, 1,
                                                  240, 1, 128, 1, 240, 1]))]),
            None, {"TIFF": "YCbCr 4:1:1, ReferenceBlackWhite 16-235, "
                           "Deflate"}),
        "lab": ("lab.tif", write_tiff(lab, 8, 8, compression=5), None,
                {"TIFF": "CIE Lab, LZW"}),
        "lab_psd": ("lab.psd", write_psd([lab[..., c] for c in range(3)],
                                         9), None,
                    {"PSD": "Lab, raw"}),
    }
    return out


def write_pnm(magic: bytes, px: np.ndarray, maxval: int = 255,
              comments: bool = False, per_line: int = 7,
              scale: float = -1.0) -> bytes:
    """A PNM / PFM file of ``px`` ([h, w] or [h, w, c] samples; 0/1 bits
    for P1 and P4, 1 black): plain (P1-P3) as decimal tokens,
    ``per_line`` a line (P1 without spaces), binary as bytes (two a
    sample, big-endian, from maxval 256 on), Pf as float32 rows bottom up
    (little-endian for a negative scale). ``comments``: a ``#`` comment
    between the header's tokens, one inside the height token and one
    among the data's lines."""
    px = np.asarray(px)
    h, w = px.shape[:2]
    c = b"#c\n" if comments else b""
    head = magic + b"\n" + c + b"%d " % w
    head += (b"%d%s%d" % (h // 10, c, h % 10)) if comments and h >= 10 \
        else b"%d" % h
    if magic in (b"P1", b"P4"):
        head += b"\n"
    elif magic == b"Pf":
        head += b"\n" + c + repr(scale).encode() + b"\n"
    else:
        head += b"\n" + c + b"%d\n" % maxval
    flat = px.reshape(-1)
    if magic == b"P1":
        lines = [b"".join(b"%d" % v for v in flat[i:i + per_line])
                 for i in range(0, len(flat), per_line)]
    elif magic in (b"P2", b"P3"):
        lines = [b" ".join(b"%d" % v for v in flat[i:i + per_line])
                 for i in range(0, len(flat), per_line)]
    if magic in (b"P1", b"P2", b"P3"):
        if comments and len(lines) > 2:
            lines.insert(2, b"# a comment among the samples")
        return head + b"\n".join(lines) + b"\n"
    if magic == b"P4":
        return head + np.packbits(px.astype(np.uint8), axis=1).tobytes()
    if magic == b"Pf":
        order = "<" if scale < 0 else ">"
        return head + px[::-1].astype(order + "f4").tobytes()
    dtype = ">u2" if maxval > 255 else np.uint8
    return head + flat.astype(dtype).tobytes()


def sgi_rle_row(samples: np.ndarray, bpc: int) -> bytes:
    """One channel of one row as SGI run-length chunks: runs of 3 or more
    equal samples, copies of the rest (at most 127 a chunk), then the 0
    terminator; at bpc 2 each atom is two bytes, the count in the low."""
    vals = [int(v) for v in samples]
    atom = (lambda v: bytes([v])) if bpc == 1 else (
        lambda v: struct.pack(">H", v))
    out, i, lit = bytearray(), 0, []

    def flush():
        while lit:
            part = lit[:127]
            del lit[:127]
            out.extend(atom(0x80 | len(part)))
            for v in part:
                out.extend(atom(v))

    while i < len(vals):
        j = i
        while j < len(vals) and vals[j] == vals[i] and j - i < 127:
            j += 1
        if j - i >= 3:
            flush()
            out.extend(atom(j - i) + atom(vals[i]))
            i = j
        else:
            lit.append(vals[i])
            i += 1
    flush()
    return bytes(out + atom(0))


def write_sgi(px: np.ndarray, bpc: int = 1, rle: bool = True,
              dimension: int = None, rows=None, lengths=None) -> bytes:
    """An SGI file of ``px`` ([h, w] grey or [h, w, 3 | 4]; uint8, or
    16-bit samples at bpc 2): raw planes, or run-length rows behind their
    start and length tables (channel-major, bottom row first), each row's
    chunks stored once. ``rows``: the chunks of row (y, c) instead of its
    samples' encoding (dict of (y, c) -> bytes); ``lengths``: the length
    table's entry of row (y, c) instead of its chunks' byte count."""
    px = np.asarray(px)
    if px.ndim == 2:
        px = px[..., None]
    h, w, z = px.shape
    dim = dimension or (3 if z > 1 else (1 if h == 1 else 2))
    head = struct.pack(">hBBHHHHii4s80si404s", 474, int(rle), bpc, dim, w, h,
                       z, 0, 255 if bpc == 1 else 65535, b"",
                       b"fixture", 0, b"")
    planes = px[::-1].transpose(2, 0, 1)       # [z, rows bottom up, w]
    if not rle:
        dtype = ">u2" if bpc == 2 else np.uint8
        return head + planes.astype(dtype).tobytes()
    data, starts, lens = bytearray(), [], []
    base = 512 + 8 * h * z
    for c in range(z):
        for y in range(h):
            row = (rows or {}).get((y, c))
            if row is None:
                row = sgi_rle_row(planes[c, y], bpc)
            starts.append(base + len(data))
            lens.append((lengths or {}).get((y, c), len(row)))
            data += row
    return (head + struct.pack(f">{h * z}I", *starts)
            + struct.pack(f">{h * z}I", *lens) + bytes(data))


def pcx_rle(line: bytes) -> bytes:
    """One PCX line run-length coded (runs of 2 or more, and any byte of
    the two top bits set, as a 0xC0 | count pair; runs within the
    line)."""
    out, i = bytearray(), 0
    while i < len(line):
        j = i
        while j < len(line) and line[j] == line[i] and j - i < 63:
            j += 1
        if j - i >= 2 or line[i] >= 0xC0:
            out += bytes([0xC0 | (j - i), line[i]])
            i = j
        else:
            out.append(line[i])
            i += 1
    return bytes(out)


def write_pcx(planes: np.ndarray, bits: int, version: int = 5,
              palette=None, stride: int = None, tail=None,
              box=(0, 0)) -> bytes:
    """A PCX file: ``planes`` [nplanes, h, w] of samples (0/1 at 1 bit),
    each line the planes one after another, each plane ``stride`` bytes
    (default: (w * bits + 7) // 8 made even) and written in the header,
    run-length coded line by line. ``palette``: the header's 16 colours
    (1 bit in 2 or 4 planes); ``tail``: the 256 colours after the 0x0C
    marker (8 bits, 1 plane)."""
    planes = np.asarray(planes)
    n, h, w = planes.shape
    base = (w * bits + 7) // 8
    stride = stride or base + base % 2
    head = bytearray(128)
    head[0:4] = bytes([10, version, 1, bits])
    x0, y0 = box
    head[4:12] = struct.pack("<4H", x0, y0, x0 + w - 1, y0 + h - 1)
    head[12:16] = struct.pack("<2H", 72, 72)
    if palette is not None:
        head[16:64] = np.asarray(palette, np.uint8).reshape(-1)[:48].tobytes()
    head[65] = n
    head[66:68] = struct.pack("<H", stride)
    head[68:70] = struct.pack("<H", 1)
    body = bytearray()
    for y in range(h):
        line = b""
        for p in range(n):
            row = planes[p, y].astype(np.uint8)
            rb = np.packbits(row).tobytes() if bits == 1 else row.tobytes()
            line += rb.ljust(stride, b"\0")
        body += pcx_rle(line)
    if tail is not None:
        body += b"\x0c" + np.asarray(tail, np.uint8).reshape(-1).tobytes()
    return bytes(head) + bytes(body)


def icon_bitmap(px: np.ndarray, bits: int, palette=None,
                and_mask: np.ndarray = None) -> bytes:
    """An icon's bitmap frame: BITMAPINFOHEADER at twice the height, the
    palette, the XOR rows bottom up (``px`` RGB at 24 or 32 bits, indices
    below), then the AND mask (1 bit, rows padded to 32 bits)."""
    px = np.asarray(px)
    h, w = px.shape[:2]
    colors = len(palette) if palette is not None else 0
    head = struct.pack("<IiiHHIIiiII", 40, w, 2 * h, 1, bits, 0, 0, 0, 0,
                       colors, 0)
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in (
        palette if palette is not None else ()))
    rows = b""
    for r in px[::-1]:
        if bits >= 24:
            rb = r[:, 2::-1].tobytes() if bits == 24 else np.concatenate(
                [r[:, 2::-1], np.full((w, 1), 255, np.uint8)], 1).tobytes()
        elif bits < 8:
            b = (r[:, None] >> np.arange(bits - 1, -1, -1)) & 1
            rb = np.packbits(b.astype(np.uint8).reshape(-1)).tobytes()
        else:
            rb = r.astype(np.uint8).tobytes()
        rows += rb + b"\0" * (-len(rb) % 4)
    mask = np.zeros((h, w), np.uint8) if and_mask is None else and_mask
    mrows = b""
    for r in mask[::-1]:
        rb = np.packbits(r.astype(np.uint8)).tobytes()
        mrows += rb + b"\0" * (-len(rb) % 4)
    return head + pal + rows + mrows


def write_icon(frames, kind: int = 1) -> bytes:
    """An ICO (``kind`` 1) or CUR (2) file: ``frames`` a list of (frame
    bytes, width byte, height byte, colours byte, planes or hotspot x,
    bpp or hotspot y), the directory in that order, the frames after
    it."""
    head = struct.pack("<HHH", 0, kind, len(frames))
    off = 6 + 16 * len(frames)
    dir_, body = b"", b""
    for data, wb, hb, nc, planes, bpp in frames:
        dir_ += struct.pack("<BBBBHHII", wb, hb, nc, 0, planes, bpp,
                            len(data), off + len(body))
        body += data
    return head + dir_ + body


def simple_fixtures(t: dict) -> dict:
    """The simple formats: the town's four maps as lossless re-encodings of
    their PNG twins (checker as binary PPM and bricks as QOI, both PIL's;
    roof as run-length SGI and foliage as 3-plane PCX, PCX by PIL), and
    small files of each mode and depth, by PIL where it writes them, else
    by the writers above."""
    from PIL import Image
    rng = np.random.RandomState(22)
    b32, r32 = t["bricks"][:32, :32], t["bricks"][64:96, 40:72]
    f24, c21 = t["foliage"][8:32, 16:40], t["foliage"][40:57, 60:81]
    g32 = b32[..., 1]
    rgba = np.concatenate([b32, r32[..., :1]], -1)
    pal16 = rng.randint(0, 256, (16, 3))
    ico = lambda img, **kw: _pil(img, "ICO", **kw)  # noqa: E731
    out = {
        "checker_ppm": ("checker.ppm", _pil(t["checker"], "PPM"),
                        "checker.png", {"PPM": "P6, maxval 255 (PIL)"}),
        "bricks_qoi": ("bricks.qoi", _pil(t["bricks"], "QOI"), "bricks.png",
                       {"QOI": "RGB (PIL)"}),
        "roof_sgi": ("roof.sgi", write_sgi(t["roof"]), "roof.png",
                     {"SGI": "run-length, 8 bits, 3 channels"}),
        "foliage_pcx": ("foliage.pcx", _pil(t["foliage"], "PCX"),
                        "foliage.png", {"PCX": "8 bits, 3 planes (PIL)"}),
        "pbm_raw": ("pbm_raw.pbm", _pil(Image.fromarray(g32).convert("1"),
                                        "PPM"), None, {"PPM": "P4 (PIL)"}),
        "pbm_plain": ("pbm_plain.pbm", write_pnm(b"P1", (g32 > 120).astype(
            int), comments=True), None, {"PPM": "P1 with comments"}),
        "pgm_plain": ("pgm_plain.pgm", write_pnm(
            b"P2", np.arange(32 * 32).reshape(32, 32) % 1001, maxval=1000,
            comments=True), None,
            {"PPM": "P2, maxval 1000 (values 0-1000: halves round to even)"}),
        "pgm2": ("pgm2.pgm", write_pnm(b"P5", rng.randint(0, 3, (16, 24)),
                                       maxval=2), None,
                 {"PPM": "P5, maxval 2 (1 reads 128)"}),
        "pgm16": ("pgm16.pgm", write_pnm(b"P5", g32.astype(int) % 3,
                                         maxval=300), None,
                  {"PPM": "P5, maxval 300: mode I (1 is 218), clipped at "
                          "255"}),
        "pgm65535": ("pgm65535.pgm", _pil(Image.fromarray(
            g32.astype(np.int32) * 129, "I"), "PPM"), None,
            {"PPM": "P5, maxval 65535 (PIL): clipped at 255"}),
        "ppm_plain": ("ppm_plain.ppm", write_pnm(b"P3", f24.astype(int) * 257,
                                                 maxval=65535), None,
                      {"PPM": "P3, maxval 65535"}),
        "ppm1000": ("ppm1000.ppm", write_pnm(b"P6", r32.astype(int) * 4 - 20,
                                             maxval=1000), None,
                    {"PPM": "P6, maxval 1000: two bytes a sample, past "
                            "maxval clipped"}),
        "pfm_grey": ("pfm_grey.pfm", _pil(Image.fromarray(
            g32.astype(np.float32) * 1.25 - 30.5, "F"), "PPM"), None,
            {"PPM": "Pf, little-endian (PIL): truncated and clipped"}),
        "pfm_be": ("pfm_be.pfm", write_pnm(b"Pf", rng.uniform(
            -2, 2, (12, 20)) * 100, scale=1.0), None,
            {"PPM": "Pf, big-endian"}),
        "p0cmyk": ("p0cmyk.pam", write_pnm(b"P0CMYK", rng.randint(
            0, 256, (16, 16, 4))), None, {"PPM": "P0CMYK"}),
        "pyrgba": ("pyrgba.ppm", write_pnm(b"PyRGBA", rgba, maxval=255),
                   None, {"PPM": "PyRGBA (PIL's test format)"}),
        "pycmyk": ("pycmyk.ppm", write_pnm(b"PyCMYK", rng.randint(
            0, 1024, (8, 12, 4)), maxval=1023), None,
            {"PPM": "PyCMYK, maxval 1023"}),
        "qoi_rgba": ("qoi_rgba.qoi", _pil(rgba, "QOI"), None,
                     {"QOI": "RGBA (PIL)"}),
        "ico_png": ("ico_png.ico", ico(t["foliage"][:64, :64],
                                       sizes=[(16, 16), (32, 32), (48, 48)]),
                    None, {"ICO": "PNG frames 16, 32, 48 (PIL)"}),
        **{f"ico_bmp{b}": (f"ico_bmp{b}.ico", ico(
            img, bitmap_format="bmp", sizes=[(16, 16), (32, 32)]), None,
            {"ICO": f"bitmap frames 16 and 32, {what} (PIL)"})
           for b, img, what in (
               (1, Image.fromarray(g32).convert("1"), "1 bit"),
               ("8", Image.fromarray(b32).quantize(
                   40, dither=Image.Dither.NONE), "8-bit palette"),
               ("8g", Image.fromarray(g32), "8-bit grey"),
               (24, Image.fromarray(b32), "24 bits"),
               (32, Image.fromarray(rgba), "32 bits"))},
        "ico_tied": ("ico_tied.ico", write_icon([
            (icon_bitmap(r32[:16, :16], 24), 16, 16, 0, 1, 24),
            (icon_bitmap(g32[:16, :16] % 16, 4, palette=pal16), 16, 16, 16,
             1, 0)]), None,
            {"ICO": "two 16x16 entries: the 4-bit one (bpp 0, 16 colours) "
                    "sorts first"}),
        "ico_zero": ("ico_zero.ico", write_icon([
            (icon_bitmap(r32, 24), 32, 32, 0, 1, 24),
            (icon_bitmap(f24, 24), 0, 0, 0, 1, 24)]), None,
            {"ICO": "a 0 byte is 256: the 24x24 frame of a 256x256 entry"}),
        "cur": ("cursor.cur", write_icon([
            (icon_bitmap(r32[:16, :12], 24), 12, 16, 0, 3, 4),
            (icon_bitmap(b32[:24, :16], 24), 16, 24, 0, 5, 5),
            (icon_bitmap(f24, 24), 24, 0, 0, 7, 7)], kind=2), None,
            {"CUR": "three cursors: the 16x24 one picked (24x0 is not "
                    "larger)"}),
        "sgi_raw": ("sgi_raw.rgb", _pil(f24, "SGI"), None,
                    {"SGI": "raw, 8 bits, 3 channels (PIL)"}),
        "sgi_raw16": ("sgi_raw16.sgi", _pil(r32, "SGI", bpc=2), None,
                      {"SGI": "raw, 16 bits (PIL)"}),
        "sgi_grey": ("sgi_grey.bw", _pil(g32, "SGI"), None,
                     {"SGI": "raw, 8 bits, grey (PIL)"}),
        "sgi_rle16": ("sgi_rle16.sgi", write_sgi(
            rgba.astype(np.uint16) * 257 + rng.randint(0, 256, rgba.shape),
            bpc=2), None, {"SGI": "run-length, 16 bits, 4 channels"}),
        "pcx_1": ("pcx_1.pcx", _pil(Image.fromarray(g32).convert("1"), "PCX"),
                  None, {"PCX": "1 bit (PIL)"}),
        "pcx_l": ("pcx_l.pcx", _pil(g32, "PCX"), None,
                  {"PCX": "8-bit grey (PIL)"}),
        "pcx_p": ("pcx_p.pcx", _pil(Image.fromarray(f24).quantize(
            40, dither=Image.Dither.NONE), "PCX"), None,
            {"PCX": "8-bit palette (PIL)"}),
        "pcx_planes2": ("pcx_planes2.pcx", write_pcx(
            rng.randint(0, 2, (2, 9, 21)), 1, palette=pal16, stride=4), None,
            {"PCX": "1 bit, 2 planes, header stride 4 (PIL's: 4)"}),
        "pcx_planes4": ("pcx_planes4.pcx", write_pcx(
            rng.randint(0, 2, (4, 11, 13)), 1, palette=pal16, stride=3),
            None, {"PCX": "1 bit, 4 planes, header stride 3 (PIL's: 2)"}),
        "pcx_odd": ("pcx_odd.pcx", write_pcx(
            c21.transpose(2, 0, 1), 8, stride=21), None,
            {"PCX": "8 bits, 3 planes, 21 wide, stride 21"}),
        "dib24": ("dib24.dib", _pil(f24, "BMP")[14:], None,
                  {"DIB": "24 bits (PIL's BMP without its file header)"}),
        "dib8": ("dib8.dib", _pil(Image.fromarray(b32).quantize(
            50, dither=Image.Dither.NONE), "BMP")[14:], None,
            {"DIB": "8-bit palette (PIL's BMP without its file header)"}),
    }
    return out


# --- JPEG 2000 and ICNS (the seventh image slice) ----------------------------

def _openjpeg_lib():
    """The OpenJPEG 2.5.4 that Pillow's wheel bundles (pillow.libs)."""
    import ctypes
    import glob

    import PIL
    base = os.path.join(os.path.dirname(os.path.dirname(PIL.__file__)),
                        "pillow.libs")
    return ctypes.CDLL(glob.glob(os.path.join(base, "libopenjp2-*.so*"))[0])


# Byte offsets in OpenJPEG 2.5's opj_cparameters_t (x86-64), checked against
# the defaults opj_set_default_encoder_parameters writes (_opj_offsets).
_OPJ = dict(tile_size_on=0, cp_tdx=12, cp_tdy=16, cp_disto_alloc=20,
            csty=48, poc=56, numpocs=4792, tcp_numlayers=4796,
            tcp_rates=4800, numresolution=5600, mode=5612, irreversible=5616,
            roi_compno=5620, roi_shift=5624, image_offset_x0=18188,
            tp_on=18696, tp_flag=18697, tcp_mct=18698)
_OPJ_POC = 148                          # sizeof(opj_poc_t)


def _opj_offsets(lib) -> None:
    import ctypes
    par = ctypes.create_string_buffer(1 << 16)
    lib.opj_set_default_encoder_parameters(par)
    ints = lambda off, n: struct.unpack_from(f"<{n}i", par, off)  # noqa: E731
    assert ints(_OPJ["numresolution"], 7) == (6, 64, 64, 0, 0, -1, 0)
    assert ints(_OPJ["image_offset_x0"], 6) == (0, 0, 1, 1, -1, -1)
    assert _OPJ["numpocs"] - _OPJ["poc"] == 32 * _OPJ_POC


def _openjpeg_encode_here(spec: dict) -> bytes:
    """One opj_encode of spec's planes with spec's opj_cparameters_t
    fields (the work of ``--openjpeg-encode``)."""
    import ctypes
    import tempfile
    lib = _openjpeg_lib()
    _opj_offsets(lib)
    planes = [np.asarray(p, np.int32) for p in spec["planes"]]
    n = len(planes)
    dx, dy = spec.get("dx", [1] * n), spec.get("dy", [1] * n)
    h = max(p.shape[0] * dy[i] for i, p in enumerate(planes))
    w = max(p.shape[1] * dx[i] for i, p in enumerate(planes))

    class Cmpt(ctypes.Structure):
        _fields_ = [(f, ctypes.c_uint32) for f in
                    ("dx", "dy", "w", "h", "x0", "y0", "prec", "bpp", "sgnd")]
    cm = (Cmpt * n)()
    for i, p in enumerate(planes):
        cm[i].dx, cm[i].dy = dx[i], dy[i]
        cm[i].w, cm[i].h = p.shape[1], p.shape[0]
        cm[i].prec = cm[i].bpp = spec.get("prec", 8)
        cm[i].sgnd = spec.get("sgnd", 0)
    lib.opj_image_create.restype = ctypes.c_void_p
    img = lib.opj_image_create(n, cm, 1 if n >= 3 else 2)
    (ctypes.c_uint32 * 4).from_address(img)[:] = [0, 0, w, h]
    comps = ctypes.c_void_p.from_address(img + 24).value
    for i, p in enumerate(planes):
        data = ctypes.c_void_p.from_address(comps + 64 * i + 48).value
        ctypes.memmove(data, np.ascontiguousarray(p).ctypes.data, p.size * 4)
    par = ctypes.create_string_buffer(1 << 16)
    lib.opj_set_default_encoder_parameters(par)
    for k, v in spec.get("params", {}).items():
        if k == "poc":                # (resno0, compno0, layno1, resno1,
            for j, e in enumerate(v):   # compno1, progression) each
                struct.pack_into("<5I", par, _OPJ["poc"] + _OPJ_POC * j,
                                 *e[:5])
                struct.pack_into("<i", par, _OPJ["poc"] + _OPJ_POC * j + 36,
                                 e[5])
            struct.pack_into("<I", par, _OPJ["numpocs"], len(v))
        elif k in ("tp_flag", "tcp_mct", "tp_on"):
            par[_OPJ[k]] = bytes([v])
        else:
            struct.pack_into("<i", par, _OPJ[k], v)
    if "mct" in spec:                   # opj_set_MCT: Part 2's array
        mat, shift = spec["mct"]        # transform, which sets 9/7
        lib.opj_set_MCT(par, (ctypes.c_float * (n * n))(*mat),
                        (ctypes.c_int32 * n)(*shift), ctypes.c_uint32(n))
        struct.pack_into("<i", par, _OPJ["irreversible"],
                         spec.get("params", {}).get("irreversible", 1))
    rates = spec.get("layers", [0])
    struct.pack_into("<i", par, _OPJ["tcp_numlayers"], len(rates))
    struct.pack_into(f"<{len(rates)}f", par, _OPJ["tcp_rates"], *rates)
    struct.pack_into("<i", par, _OPJ["cp_disto_alloc"], 1)
    lib.opj_create_compress.restype = ctypes.c_void_p
    codec = ctypes.c_void_p(lib.opj_create_compress(2 if spec.get("jp2")
                                                    else 0))
    extra = spec.get("extra", [])
    if extra:
        arr = (ctypes.c_char_p * (len(extra) + 1))(
            *[e.encode() for e in extra], None)
        assert lib.opj_encoder_set_extra_options(codec, arr)
    assert lib.opj_setup_encoder(codec, par, ctypes.c_void_p(img))
    fd, path = tempfile.mkstemp()
    os.close(fd)
    lib.opj_stream_create_default_file_stream.restype = ctypes.c_void_p
    st = ctypes.c_void_p(lib.opj_stream_create_default_file_stream(
        path.encode(), 0))
    ok = (lib.opj_start_compress(codec, ctypes.c_void_p(img), st)
          and lib.opj_encode(codec, st) and lib.opj_end_compress(codec, st))
    lib.opj_stream_destroy(st)
    with open(path, "rb") as f:
        out = f.read()
    os.unlink(path)
    assert ok, "opj_encode failed"
    return out


def openjpeg_encode(planes, **spec) -> bytes:
    """A codestream (or with jp2=True a JP2 file) by the OpenJPEG encoder
    that Pillow's wheel bundles, through ctypes: the code-block styles,
    regions of interest, SOP / EPH, tile-parts, TLM, POC, subsampling and
    precisions PIL's save options do not reach. ``spec`` holds dx, dy,
    prec, sgnd, jp2, layers (rates), extra (opj_encoder_set_extra_options)
    and params (opj_cparameters_t fields by name). Each encode runs in a
    process of its own: the encoder's output estimate can overrun on small
    code-blocks under TERMALL, so a process that writes past it dies
    alone."""
    import pickle
    import subprocess
    import tempfile
    spec = dict(spec, planes=[np.asarray(p).tolist() for p in planes])
    with tempfile.TemporaryDirectory() as d:
        src, dst = os.path.join(d, "spec"), os.path.join(d, "out")
        with open(src, "wb") as f:
            pickle.dump(spec, f)
        subprocess.run([sys.executable, os.path.abspath(__file__),
                        "--openjpeg-encode", src, dst], check=True)
        with open(dst, "rb") as f:
            return f.read()


def _boxes(data: bytes, pos: int = 0, end: int = None) -> list:
    """The boxes of a JP2 file (or of a superbox's body): [type, body]."""
    end = len(data) if end is None else end
    out = []
    while pos < end:
        n, t = struct.unpack_from(">I4s", data, pos)
        n = n or end - pos
        out.append([t, data[pos + 8:pos + n]])
        pos += n
    return out


def _box(t: bytes, body: bytes) -> bytes:
    return struct.pack(">I", len(body) + 8) + t + body


def jp2_edit(data: bytes, header=None, colr=None) -> bytes:
    """A JP2 file with jp2h's boxes replaced by ``header(boxes)`` and/or
    colr's enumerated colour space set to ``colr``."""
    out = b""
    for t, body in _boxes(data):
        if t == b"jp2h":
            inner = _boxes(body)
            if colr is not None:
                for b in inner:
                    if b[0] == b"colr":
                        b[1] = b[1][:3] + struct.pack(">I", colr)
            if header is not None:
                inner = header(inner)
            body = b"".join(_box(t2, b2) for t2, b2 in inner)
        out += _box(t, body)
    return out


def j2k_main_header(cs: bytes) -> int:
    """The offset of the first SOT in a codestream."""
    pos = 2
    while True:
        m, n = struct.unpack_from(">HH", cs, pos)
        if m == 0xFF90:
            return pos
        pos += 2 + n


def j2k_insert(cs: bytes, *segments) -> bytes:
    """The codestream with marker segments (marker, body) inserted at the
    end of its main header."""
    at = j2k_main_header(cs)
    extra = b"".join(struct.pack(">HH", m, len(b) + 2) + b
                     for m, b in segments)
    return cs[:at] + extra + cs[at:]


def j2k_cod_style(cs: bytes, style: int) -> bytes:
    """The codestream with its main COD's code-block style byte set."""
    pos = 2
    while True:
        m, n = struct.unpack_from(">HH", cs, pos)
        if m == 0xFF52:
            out = bytearray(cs)
            out[pos + 4 + 8] = style    # Scod, SGcod (4), SPcod: D E F G
            return bytes(out)
        pos += 2 + n


def j2k_packed(cs: bytes, where: str = "ppt") -> bytes:
    """A codestream written with SOP and EPH markers, its packet headers
    (each up to and with its EPH) moved into PPT segments, one run a
    tile-part (``where="ppt"``), or into the main header's PPM segments
    with an Nppm count a tile-part; SOP markers stay with the packet
    bodies. (EPH ends a header: a header stuffs a 0 bit after each 0xFF,
    and a body never holds 0xFF 0x91, so both split cleanly.)"""
    main = j2k_main_header(cs)
    pos, parts = main, []
    while cs[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack_from(">I", cs, pos + 6)[0]
        end = pos + psot if psot else len(cs) - 2
        sod = pos + 12
        while cs[sod:sod + 2] != b"\xff\x93":
            sod += 2 + struct.unpack_from(">H", cs, sod + 2)[0]
        data, heads, bodies = cs[sod + 2:end], [], []
        at = 0
        while at < len(data):
            assert data[at:at + 2] == b"\xff\x91"
            eph = data.index(b"\xff\x92", at + 6) + 2
            nxt = data.find(b"\xff\x91", eph)
            nxt = len(data) if nxt < 0 else nxt
            heads.append(data[at + 6:eph])
            bodies.append(data[at:at + 6] + data[eph:nxt])
            at = nxt
        parts.append((cs[pos:pos + 12], cs[pos + 12:sod], b"".join(heads),
                      b"".join(bodies)))
        pos = end
    seg = lambda m, z, d: struct.pack(">HHB", m, len(d) + 3, z) + d  # noqa
    out = b""
    zppt = {}
    for sot, markers, heads, bodies in parts:
        if where == "ppt":
            tile = struct.unpack_from(">H", sot, 4)[0]
            for k in range(0, len(heads), 65000):
                z = zppt.get(tile, 0)
                zppt[tile] = z + 1
                markers += seg(0xFF61, z, heads[k:k + 65000])
        body = markers + b"\xff\x93" + bodies
        out += sot[:6] + struct.pack(">I", 12 + len(body)) + sot[10:] + body
    head = cs[:main]
    if where == "ppm":
        stream = b"".join(struct.pack(">I", len(h)) + h for _, _, h, _ in
                          parts)
        head += b"".join(seg(0xFF60, z, stream[k:k + 65000]) for z, k in
                         enumerate(range(0, len(stream), 65000)))
    return head + out + cs[-2:]


def _cs(jp2: bytes) -> bytes:
    """A JP2 file's codestream."""
    return next(b for t, b in _boxes(jp2) if t == b"jp2c")


def jpeg2000_fixtures(t: dict) -> dict:
    """The JPEG 2000 files: the town's four maps as lossless (5/3)
    re-encodings of their PNG twins (checker and foliage as JP2, bricks as
    a tiled RPCL codestream by PIL; roof through an ICNS, icns_fixtures)
    and the 1024x1024 map's as a JP2 (a decode at a real texture size);
    small files of each of PIL's save options and modes; OpenJPEG's own
    encoder (openjpeg_encode) for each code-block style bit and mixes,
    ROI, SOP / EPH, tile-parts, TLM, POC, 4:2:0 and 4:2:2 subsampling and
    12 bits; and edits of PIL's files: COD's style byte, inserted RGN,
    POC, COC and QCC segments, and JP2 boxes for sYCC, CMYK, pclr + cmap
    and cdef."""
    from PIL import Image
    b48 = np.ascontiguousarray(t["bricks"][16:56, 8:56])
    f48 = np.ascontiguousarray(t["foliage"][40:80, 32:80])
    rgba = np.concatenate([b48, f48[..., :1]], -1)
    grey = b48[..., 1]
    pil = lambda img, **kw: _pil(img, "JPEG2000", **kw)  # noqa: E731
    cs = lambda img, **kw: pil(img, no_jp2=True, **kw)  # noqa: E731
    enc = lambda p, **kw: openjpeg_encode(  # noqa: E731
        [p[..., c] for c in range(p.shape[-1])], **kw)
    out = {
        "checker_jp2": ("checker.jp2", pil(t["checker"]), "checker.png",
                        "JP2, lossless 5/3 (PIL)"),
        "map1024_jp2": ("map1024.jp2", pil(t["map1024"]), "map1024.png",
                        "JP2, 1024x1024, lossless 5/3 (PIL)"),
        "bricks_j2k": ("bricks.j2k", cs(t["bricks"], tile_size=(64, 64),
                                         num_resolutions=3,
                                         progression="RPCL"),
                       "bricks.png", "J2K, 64x64 tiles, RPCL, 5/3 (PIL)"),
        "foliage_jp2": ("foliage.jp2", pil(t["foliage"], codeblock_size=(
            16, 16), precinct_size=(32, 32), progression="CPRL",
            quality_layers=[40, 10, 0]), "foliage.png",
            "JP2, precincts 32, 16x16 code-blocks, CPRL, three layers "
            "(PIL)"),
    }
    opts = {
        "irrev": dict(irreversible=True),
        "irrev_rate": dict(irreversible=True, quality_layers=[30, 12]),
        "irrev_db": dict(irreversible=True, quality_mode="dB",
                         quality_layers=[30, 38]),
        "mct0": dict(mct=0),
        "offset": dict(tile_offset=(3, 2), tile_size=(20, 24),
                       offset=(5, 7)),
        "res1": dict(num_resolutions=1),
        "cb4": dict(codeblock_size=(4, 4)),
        "rlcp": dict(progression="RLCP", quality_layers=[20, 5]),
        "pcrl": dict(progression="PCRL", precinct_size=(16, 16),
                     num_resolutions=3),
        "signed": dict(signed=True),
        "comment_plt": dict(comment="a comment", plt=True),
    }
    for k, kw in opts.items():
        out[f"j2k_{k}"] = (f"{k}.j2k", cs(b48, **kw), None,
                           f"J2K, {kw} (PIL)")
    for mode, img in (("l", grey), ("la", np.stack([grey, f48[..., 0]], -1)),
                      ("rgba", rgba)):
        im = Image.fromarray(img, {"l": "L", "la": "LA", "rgba": "RGBA"}[mode])
        out[f"jp2_{mode}"] = (f"{mode}.jp2", pil(im), None,
                              f"JP2, {mode.upper()} (PIL)")
    out["jp2_rgba_irrev"] = ("rgba_irrev.jp2", pil(rgba, irreversible=True),
                             None, "JP2, RGBA, 9/7 (PIL)")
    i16 = Image.fromarray(grey.astype(np.uint16) * 37 % 4096)
    out["jp2_i16"] = ("i16.jp2", pil(i16), None, "JP2, I;16 12 bits (PIL)")
    # OpenJPEG's encoder: code-block styles, ROI, packet markers, tiles.
    for style in (0x01, 0x02, 0x04, 0x08, 0x10, 0x20, 0x3F, 0x05, 0x0B,
                  0x22, 0x11):
        out[f"style{style:02x}"] = (
            f"style{style:02x}.j2k", enc(b48, params=dict(mode=style)), None,
            f"J2K, code-block style {style:#04x} (OpenJPEG)")
        if style != 0x04:               # 9/7 TERMALL alone overruns
            out[f"style{style:02x}_97"] = (
                f"style{style:02x}_97.j2k", enc(b48, layers=[30, 10],
                                                params=dict(mode=style,
                                                            irreversible=1)),
                None, f"J2K, code-block style {style:#04x}, 9/7, two "
                      f"layers (OpenJPEG)")
    out["roi"] = ("roi.j2k", enc(b48, params=dict(roi_compno=0, roi_shift=5)),
                  None, "J2K, RGN max-shift 5 on component 0 (OpenJPEG)")
    out["roi_97"] = ("roi_97.j2k", enc(b48, params=dict(
        roi_compno=2, roi_shift=9, irreversible=1)), None,
        "J2K, RGN max-shift 9 on component 2, 9/7 (OpenJPEG)")
    out["sop_eph"] = ("sop_eph.j2k", enc(b48, layers=[20, 0], params=dict(
        csty=6)), None, "J2K, SOP and EPH, two layers (OpenJPEG)")
    sopeph = enc(b48, layers=[30, 0], params=dict(
        csty=6, tile_size_on=1, cp_tdx=32, cp_tdy=24, numresolution=3,
        tp_on=1, tp_flag=ord("R")))
    out["ppt"] = ("ppt.j2k", j2k_packed(sopeph, "ppt"), None,
                  "J2K, packet headers in PPT segments, tiles and tile-parts "
                  "(OpenJPEG's file, headers moved)")
    out["ppm"] = ("ppm.j2k", j2k_packed(sopeph, "ppm"), None,
                  "J2K, packet headers in PPM segments (OpenJPEG's file, "
                  "headers moved)")
    out["tileparts"] = ("tileparts.j2k", enc(b48, params=dict(
        tile_size_on=1, cp_tdx=32, cp_tdy=24, numresolution=3, tp_on=1,
        tp_flag=ord("R"))), None,
        "J2K, 32x24 tiles, a tile-part a resolution (OpenJPEG)")
    out["tileparts_l"] = ("tileparts_l.jp2", enc(
        b48, jp2=True, layers=[40, 20, 0], params=dict(tp_on=1,
                                                       tp_flag=ord("L"))),
        None, "JP2, a tile-part a layer (OpenJPEG)")
    out["tlm"] = ("tlm.j2k", enc(b48, extra=["TLM=YES"], params=dict(
        tile_size_on=1, cp_tdx=24, cp_tdy=24, numresolution=3)), None,
        "J2K, TLM (OpenJPEG)")
    out["poc"] = ("poc.j2k", enc(b48, params=dict(poc=[(0, 0, 1, 2, 3, 1),
                                                      (2, 0, 1, 6, 3, 4)])),
                  None, "J2K, POC: RLCP to resolution 2, then CPRL "
                        "(OpenJPEG)")
    ycc = np.stack([grey, f48[..., 1], f48[..., 2]], -1)
    out["sub420"] = ("sub420.j2k", openjpeg_encode(
        [ycc[..., 0], ycc[::2, ::2, 1], ycc[::2, ::2, 2]], dx=[1, 2, 2],
        dy=[1, 2, 2], params=dict(tcp_mct=0)), None,
        "J2K, components 2 and 3 at 4:2:0 (Pillow reads it as sYCC; "
        "OpenJPEG)")
    out["sub422"] = ("sub422.j2k", openjpeg_encode(
        [ycc[..., 0], ycc[:, ::2, 1], ycc[:, ::2, 2]], dx=[1, 2, 2],
        params=dict(tcp_mct=0)), None,
        "J2K, components 2 and 3 at 4:2:2 (OpenJPEG)")
    out["prec12"] = ("prec12.j2k", openjpeg_encode(
        [b48[..., c].astype(np.int32) * 13 for c in range(3)], prec=12),
        None, "J2K, 12-bit RGB (OpenJPEG)")
    # Edits of PIL's files.
    base = cs(b48)
    base97 = cs(b48, irreversible=True, quality_layers=[25])
    for style in (0x01, 0x02, 0x08, 0x20, 0x28):
        out[f"cod_style{style:02x}"] = (
            f"cod_style{style:02x}.j2k", j2k_cod_style(base97, style), None,
            f"J2K, PIL's 9/7 file with COD's style byte set to {style:#04x}")
    out["rgn_insert"] = ("rgn_insert.j2k", j2k_insert(
        base, (0xFF5E, bytes([1, 0, 2]))), None,
        "J2K, PIL's file with an RGN segment (component 1, shift 2) inserted")
    out["poc_insert"] = ("poc_insert.j2k", j2k_insert(
        cs(b48, progression="RLCP"), (0xFF5F, bytes([0, 0, 0, 1, 6, 3, 0]))),
        None, "J2K, PIL's RLCP file with a POC segment (LRCP over "
              "everything) inserted")
    out["coc_insert"] = ("coc_insert.j2k", j2k_insert(
        base, (0xFF53, bytes([2, 0, 5, 4, 4, 0x08, 1]))), None,
        "J2K, PIL's file with a COC segment (component 2: vertically "
        "causal contexts) inserted")
    out["qcc_insert"] = ("qcc_insert.j2k", j2k_insert(
        base97, (0xFF5D, bytes([1, 0x42]) + struct.pack(">H", 0x4800))),
        None, "J2K, PIL's 9/7 file with a scalar-derived QCC segment "
              "(component 1) inserted")
    rgb_jp2 = pil(b48)
    out["sycc"] = ("sycc.jp2", jp2_edit(rgb_jp2, colr=18), None,
                   "JP2, PIL's RGB file marked sYCC (colr 18)")
    out["cmyk"] = ("cmyk.jp2", jp2_edit(pil(rgba), colr=12), None,
                   "JP2, PIL's RGBA file marked CMYK (colr 12)")
    rng = np.random.RandomState(24)
    idx = (grey // 16).astype(np.uint8)

    def pclr(npc, extra=()):
        entries = rng.randint(0, 256, (16, npc)).astype(np.uint8)
        body = struct.pack(">HB", 16, npc) + bytes([7] * npc) + \
            entries.tobytes()
        cmap = b"".join(struct.pack(">HBB", 0, 1, c) for c in range(npc))

        def header(boxes):
            for b in boxes:
                if b[0] == b"colr":
                    b[1] = b[1][:3] + struct.pack(">I", 16)
            return boxes + [[b"pclr", body], [b"cmap", cmap], *extra]
        return header
    pal_src = pil(Image.fromarray(idx, "L"))
    out["pclr"] = ("pclr.jp2", jp2_edit(pal_src, header=pclr(3)), None,
                   "JP2, 4-bit indices with pclr (16 RGB entries) and cmap")
    out["pclr_rgba"] = ("pclr_rgba.jp2", jp2_edit(pal_src, header=pclr(4)),
                        None, "JP2, 4-bit indices with pclr (16 RGBA "
                              "entries) and cmap")
    la = pil(Image.fromarray(np.stack([idx, grey], -1), "LA"))
    out["pclr_la"] = ("pclr_la.jp2", jp2_edit(la, header=pclr(3)), None,
                      "JP2, indices and alpha with pclr (Pillow's PA)")
    cdef = struct.pack(">H", 4) + b"".join(struct.pack(">HHH", c, t, a) for
                                           c, t, a in ((0, 0, 3), (1, 0, 2),
                                                       (2, 0, 1), (3, 1, 0)))
    out["cdef"] = ("cdef.jp2", jp2_edit(pil(rgba), header=lambda b: [
        x for x in b if x[0] != b"cdef"] + [[b"cdef", cdef]]), None,
        "JP2, PIL's RGBA file, its cdef box replaced by one reversing the "
        "colours")
    return out


# --- the rest of JPEG 2000 and AVIF at open (the eighth image slice) ---------

def htj2k():
    """tools/torch_htj2k.py, the HTJ2K writer beside this tool."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_htj2k", os.path.join(os.path.dirname(os.path.abspath(
            __file__)), "torch_htj2k.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def j2k_cod_mct(cs: bytes, mct: int) -> bytes:
    """The codestream with its main COD's SGcod (the component transform)
    set: OpenJPEG writes 2 for its array transform and reads 0 or 1 only."""
    pos = 2
    while True:
        m, n = struct.unpack_from(">HH", cs, pos)
        if m == 0xFF52:
            out = bytearray(cs)
            out[pos + 8] = mct          # Scod, progression, layers (2), SGcod
            return bytes(out)
        pos += 2 + n


def j2k_tile_insert(cs: bytes, *segments) -> bytes:
    """The codestream with marker segments inserted into its first
    tile-part header, Psot kept true."""
    pos = j2k_main_header(cs)
    body = b"".join(struct.pack(">HH", m, len(b) + 2) + b for m, b in segments)
    out = bytearray(cs[:pos + 12]) + body + cs[pos + 12:]
    psot = struct.unpack_from(">I", cs, pos + 6)[0]
    if psot:
        out[pos + 6:pos + 10] = struct.pack(">I", psot + len(body))
    return bytes(out)


def mct_segments(offsets, elem: int = 0, deco=None, index: int = 1) -> tuple:
    """Part 2 marker segments (marker, body): an MCT offset record of
    element type `elem` (0 int16, 1 int32, 2 float32, 3 float64), an
    optional decorrelation record, an MCC naming them and an MCO."""
    fmt = ">" + "hifd"[elem]
    out = []
    recs = [(index, 2, offsets)] + ([(index + 1, 1, deco)] if deco else [])
    for idx, array_type, values in recs:
        body = b"".join(struct.pack(fmt, v) for v in values)
        out.append((0xFF74, struct.pack(">HHH", 0, idx | array_type << 8 |
                                        elem << 10, 0) + body))
    n = len(offsets)
    tmcc = (index << 8) | ((index + 1) if deco else 0) | 1 << 16
    out.append((0xFF75, struct.pack(">HBHHBH", 0, 7, 0, 1, 1, n) + bytes(
        range(n)) + struct.pack(">H", n) + bytes(range(n)) + tmcc.to_bytes(
        3, "big")))
    out.append((0xFF77, bytes([1, 7])))   # one stage: the MCC above
    return tuple(out)


def jpeg2000_rest_fixtures(t: dict) -> dict:
    """JPEG 2000 beyond Part 1: HTJ2K codestreams by tools/torch_htj2k.py
    (5/3 and 9/7, the cleanup pass alone or with SigProp and MagRef,
    code-blocks from 8x8 to 64x64, layers, tiles, vertically causal
    contexts, 1-4 components, a JP2), Part 2 component transforms by
    OpenJPEG's own encoder (opj_set_MCT, 3 and 4 components, reversible
    and 9/7, with and without offsets; its COD's array transform edited to
    one OpenJPEG reads) and MCT / MCC / MCO / CBD segments inserted into
    PIL's files; and the town's four maps as lossless re-encodings of
    their PNG twins (checker and roof HTJ2K, bricks and foliage through an
    identity Part 2 transform whose offsets carry the DC level shift)."""
    from PIL import Image
    ht = htj2k()
    b48 = np.ascontiguousarray(t["bricks"][16:56, 8:56])
    f48 = np.ascontiguousarray(t["foliage"][40:80, 32:80])
    rgba = np.concatenate([b48, f48[..., :1]], -1)
    planes = lambda img: [img[..., c] for c in range(img.shape[-1])]  # noqa
    enc = lambda img, **kw: openjpeg_encode(planes(img), **kw)  # noqa: E731
    out = {}
    for name, img, kw, what in (
            ("53", b48, dict(levels=3), "5/3, the cleanup pass alone"),
            ("97", b48, dict(levels=3, cblk=(5, 4), real=True, p=2,
                             passes=3), "9/7, 32x16 code-blocks, cleanup + "
                                        "SigProp + MagRef"),
            ("spp", b48, dict(levels=2, p=2, passes=2),
             "5/3, cleanup + SigProp"),
            ("refine", f48[..., :3], dict(levels=2, cblk=(3, 3), p=2,
                                          passes=3),
             "5/3, 8x8 code-blocks, cleanup + SigProp + MagRef"),
            ("cb64", f48[..., :3], dict(levels=1, cblk=(6, 6)),
             "5/3, 64x64 code-blocks"),
            ("cb32x8", b48, dict(levels=2, cblk=(5, 3), real=True,
                                 steps=[1] * 7), "9/7, 32x8 code-blocks, "
                                                 "steps of 1/2"),
            ("layers", b48, dict(levels=2, cblk=(3, 3), layers=3,
                                 late=True), "5/3, three layers (a "
                                             "resolution's code-blocks a "
                                             "layer)"),
            ("tiles", f48[..., :3], dict(levels=2, tile=(16, 16), p=2,
                                         passes=3),
             "5/3, 16x16 tiles, three passes"),
            ("vsc", b48, dict(levels=2, p=2, passes=3, style=0x48),
             "5/3, vertically causal contexts, three passes"),
            ("grey", b48[..., :1], dict(levels=3, cblk=(5, 5)),
             "one component, 32x32 code-blocks"),
            ("rgba", rgba, dict(levels=2, real=True, p=2, passes=3),
             "four components, 9/7")):
        out[f"ht_{name}"] = (f"ht_{name}.j2k", ht.write_codestream(
            planes(img), **kw), None, f"J2K, HTJ2K {what} (tools/"
                                      f"torch_htj2k.py)")
    jp2 = _pil(b48, "JPEG2000")
    cs = ht.write_codestream(planes(b48), levels=2, p=2, passes=3)
    boxes = _boxes(jp2)
    out["ht_jp2"] = ("ht.jp2", b"".join(_box(ty, cs if ty == b"jp2c" else b)
                                        for ty, b in boxes), None,
                     "JP2, PIL's boxes around an HTJ2K codestream")
    mat3 = [1, 0.5, 0.25, 0, 1, 0.5, 0.25, 0, 1]
    mat4 = [1, 0, 0.5, 0, 0, 1, 0, 0.25, 0.5, 0, 1, 0, 0, 0.25, 0, 1]
    for name, img, mat, shift, irr, sgcod in (
            ("mct3_rev_off", b48, mat3, [128, 10, -5], 0, 1),
            ("mct3_irr", b48, mat3, [0, 0, 0], 1, 1),
            ("mct4_rev", rgba, mat4, [128] * 4, 0, 0),
            ("mct4_irr_off", rgba, mat4, [100, 0, -20, 7], 1, 1)):
        out[name] = (f"{name}.j2k", j2k_cod_mct(enc(
            img, mct=(mat, shift), params=dict(irreversible=irr)), sgcod),
            None, f"J2K, {img.shape[-1]} components through opj_set_MCT "
                  f"({'9/7' if irr else '5/3'}, offsets {shift}), COD's "
                  f"array transform edited to {sgcod} (OpenJPEG)")
    base = _pil(b48, "JPEG2000", no_jp2=True)
    base97 = _pil(b48, "JPEG2000", no_jp2=True, irreversible=True)
    for name, cs, segs, what in (
            ("mct_int16", base, mct_segments([100, 140, 60]),
             "int16 offsets"),
            ("mct_float", base97, mct_segments([127.5, -3.75, 1e3], 2),
             "float32 offsets, 9/7"),
            ("mct_double", base, mct_segments([128.0, 64.0, -1e10], 3,
                                              deco=[1.0] * 9),
             "float64 offsets (one out of int range) and a decorrelation "
             "matrix"),
            ("mct_zero", base, ((0xFF77, bytes([0])),),
             "an MCO of no stages (the DC level shifts zeroed)"),
            ("cbd", base, ((0xFF78, struct.pack(">H", 3) + bytes(
                [0x87, 0x06, 0x07])),),
             "a CBD: component 0 signed, component 1 of 7 bits")):
        out[name] = (f"{name}.j2k", j2k_insert(cs, *segs), None,
                     f"J2K, PIL's file with Part 2 segments inserted: {what}")
    tiled = _pil(b48, "JPEG2000", no_jp2=True, tile_size=(24, 24))
    out["mct_tilepart"] = ("mct_tilepart.j2k", j2k_tile_insert(
        tiled, *mct_segments([200, 128, 50])), None,
        "J2K, PIL's tiled file, Part 2 segments in the first tile-part "
        "header")
    # The town's maps, lossless.
    out["ht_checker"] = ("checker_ht.j2k", ht.write_codestream(
        planes(t["checker"]), levels=4, cblk=(5, 5)), "checker.png",
        "J2K, HTJ2K 5/3, 32x32 code-blocks (tools/torch_htj2k.py)")
    out["ht_roof"] = ("roof_ht.j2k", ht.write_codestream(
        planes(t["roof"]), levels=3, tile=(64, 64)), "roof.png",
        "J2K, HTJ2K 5/3, 64x64 tiles (tools/torch_htj2k.py)")
    ident = [1, 0, 0, 0, 1, 0, 0, 0, 1]
    for name in ("bricks", "foliage"):
        out[f"mct_{name}"] = (f"{name}_mct.j2k", j2k_cod_mct(enc(
            t[name], mct=(ident, [128] * 3), params=dict(irreversible=0)),
            0), f"{name}.png", "J2K, an identity opj_set_MCT transform "
                               "whose offsets are the DC level shift, 5/3, "
                               "COD's array transform edited to 0 "
                               "(OpenJPEG)")
    return out


def _avif_times_zeroed(data: bytes) -> bytes:
    """PIL's AVIF with the creation and modification times of its mvhd,
    tkhd and mdhd boxes set to 0, so that the file is the same each run."""
    out = bytearray(data)
    for tag in (b"mvhd", b"tkhd", b"mdhd"):
        at = out.find(tag)
        while at >= 0:
            wide = out[at + 4] == 1
            n = 8 if wide else 4
            out[at + 8:at + 8 + 2 * n] = bytes(2 * n)
            at = out.find(tag, at + 4)
    return bytes(out)


def avif_fixtures(t: dict) -> dict:
    """name -> bytes: AVIF files PIL writes (the town's roof as a still
    image, foliage with alpha, an animation of two frames of bricks) and,
    of each, the cuts and junk behind its ftyp box that libavif refuses at
    open. They are held against PIL's Image.open, not decoded
    (utils/avif.py)."""
    from PIL import Image
    rng = np.random.RandomState(25)
    roof = Image.fromarray(t["roof"])
    fol = Image.fromarray(np.concatenate(
        [t["foliage"], t["checker"][..., :1]], -1))
    bricks = Image.fromarray(t["bricks"])
    files = {
        "still": _pil(roof, "AVIF", quality=80),
        "alpha": _pil(fol, "AVIF", quality=80),
        "anim": _avif_times_zeroed(_pil(bricks, "AVIF", save_all=True,
                                        append_images=[roof],
                                        quality=60)),
    }
    out = {}
    for name, d in files.items():
        ftyp = struct.unpack_from(">I", d)[0]
        mdat = d.find(b"mdat") - 4
        out[name] = d
        out[f"{name}_cut32z"] = d[:32] + bytes(40)
        out[f"{name}_cut24"] = d[:24]
        out[f"{name}_half"] = d[:len(d) // 2]
        out[f"{name}_junk"] = d[:ftyp] + bytes(rng.randint(0, 256, 64)
                                               .astype(np.uint8))
        out[f"{name}_nomdat"] = d[:mdat]
    return out


def icns_fixtures(t: dict) -> dict:
    """The ICNS files: the town's roof as a 128x128 icon whose ic07 element
    is a lossless JPEG 2000 codestream beside its it32 run-length RGB and
    t8mk mask (PIL reads the JPEG 2000 element), and one icon of each
    element kind: is32 / il32 / ih32 run-length with their masks, il32
    raw, a JP2 element (PIL's own writer, PNG elements up to 1024x1024,
    is held in tests/test_torch_jpeg2000.py)."""
    def icns(elems):                    # (type, size) block headers
        body = b"".join(k + struct.pack(">I", len(d) + 8) + d
                        for k, d in elems)
        return b"icns" + struct.pack(">I", len(body) + 8) + body

    def rgb32(px, t32=False):
        data = b"".join(icns_rle(px[..., c].tobytes()) for c in range(3))
        return b"\0\0\0\0" + data if t32 else data

    roof = t["roof"]
    out = {"roof_icns": ("roof.icns", icns([
        (b"ic07", _pil(roof, "JPEG2000", no_jp2=True)),
        (b"it32", rgb32(roof, True)), (b"t8mk", roof[..., 0].tobytes())]),
        "roof.png", "ic07 lossless J2K beside it32 and t8mk")}
    b = t["bricks"]
    for n, tag, mk in ((16, b"is32", b"s8mk"), (32, b"il32", b"l8mk"),
                       (48, b"ih32", b"h8mk")):
        px = np.ascontiguousarray(b[:n, 8:8 + n])
        out[f"icns_{tag.decode()}"] = (f"{tag.decode()}.icns", icns([
            (tag, rgb32(px)), (mk, px[..., 1].tobytes())]), None,
            f"{tag.decode()} run-length RGB with {mk.decode()}")
    px = np.ascontiguousarray(t["foliage"][:32, :32])
    out["icns_il32_raw"] = ("il32_raw.icns", icns([(b"il32", px.tobytes())]),
                            None, "il32 raw RGB")
    out["icns_jp2"] = ("jp2.icns", icns([
        (b"icp6", _pil(t["foliage"][:64, 64:], "JPEG2000"))]), None,
        "icp6 JP2 element")
    return out


def icns_rle(band: bytes) -> bytes:
    """An icns band in the run-length code PIL's read_32 reads: runs of 3
    to 130 as (n + 125, byte), else literals of 1 to 128 as (n - 1,
    bytes)."""
    out, i, n = bytearray(), 0, len(band)
    while i < n:
        j = i
        while j < n and j - i < 130 and band[j] == band[i]:
            j += 1
        if j - i >= 3:
            out += bytes([j - i + 125, band[i]])
            i = j
            continue
        j = i + 1
        while j < n and j - i < 128 and not (
                j + 2 < n and band[j] == band[j + 1] == band[j + 2]):
            j += 1
        out += bytes([j - i - 1]) + band[i:j]
        i = j
    return bytes(out)


def ycbcr_table(path: str) -> None:
    """Pillow's YCbCr -> RGB tables (ConvertYCbCr.c: R_Cr, G_Cb, G_Cr,
    B_Cb, int16 at a scale of 2^6) as utils/ycbcr_rgb.bin, derived from
    PIL's conversion of every (Y, Cb, Cr): R and B need only each entry's
    value >> 6; G's two tables are fitted with the carries their sum shows
    and checked over all 2^24 inputs."""
    from PIL import Image
    c = np.arange(256)
    y, cb, cr = np.meshgrid(c, c, c, indexing="ij")
    ycc = np.stack([y, cb, cr], -1).astype(np.uint8).reshape(4096, 4096, 3)
    rgb = np.asarray(Image.frombytes("YCbCr", (4096, 4096), ycc.tobytes())
                     .convert("RGB")).reshape(256, 256, 256, 3).astype(int)

    def shift(ch, along_cr):           # each entry's value >> 6
        k = []
        for v in c:
            col = rgb[:, 128, v, ch] if along_cr else rgb[:, v, 128, ch]
            ys = np.nonzero((col > 0) & (col < 255))[0]
            k.append(col[ys[0]] - ys[0])
        return np.array(k)
    kr, kb = shift(0, True), shift(2, False)
    ka, kc = shift(1, False), shift(1, True)
    g = rgb[..., 1]
    valid = (g > 0) & (g < 255)
    first = np.argmax(valid, axis=0)
    kg = np.take_along_axis(g, first[None], 0)[0] - first
    carry = kg - ka[:, None] - kc[None, :]
    levels = np.unique(carry.sum(0))
    rb = np.searchsorted(levels, carry.sum(0)) + 1
    lo = np.array([rb[carry[i] == 1].min() if carry[i].any() else 64
                   for i in range(256)])
    ra = 64 - lo
    tables = np.stack([kr * 64, ka * 64 + ra, kc * 64 + rb, kb * 64])
    yy = y
    r = np.clip(yy + (tables[0][cr] >> 6), 0, 255)
    gg = np.clip(yy + ((tables[1][cb] + tables[2][cr]) >> 6), 0, 255)
    bb = np.clip(yy + (tables[3][cb] >> 6), 0, 255)
    assert (r == rgb[..., 0]).all() and (gg == rgb[..., 1]).all() and (
        bb == rgb[..., 2]).all()
    with open(path, "wb") as f:
        f.write(tables.astype("<i2").tobytes())


def _chunk(tag: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def write_png(path: str, img: np.ndarray) -> None:
    """An 8-bit RGB PNG, each row filtered None, Sub or Up (the smallest
    sum of absolute signed bytes)."""
    h, w, _ = img.shape
    rows = img.reshape(h, w * 3).astype(np.int16)
    prev = np.zeros(w * 3, np.int16)
    raw = bytearray()
    for row in rows:
        sub = row.copy()
        sub[3:] -= row[:-3]
        cands = [row, sub, row - prev]
        cands = [(c & 0xFF).astype(np.uint8) for c in cands]
        costs = [np.abs(c.view(np.int8).astype(np.int32)).sum()
                 for c in cands]
        k = int(np.argmin(costs))
        raw += bytes([k]) + cands[k].tobytes()
        prev = row
    png = (b"\x89PNG\r\n\x1a\n"
           + _chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _chunk(b"IDAT", zlib.compress(bytes(raw), 9))
           + _chunk(b"IEND", b""))
    with open(path, "wb") as f:
        f.write(png)


def _sha(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def time_decodes(folder: str) -> None:
    """Host ms (median of 5 after a warm-up) and MPix/s of each fixture's
    decode: the port's (utils/io.py decode_image) and PIL's
    ``convert("RGB")`` on the same bytes, and the port's decode of the PNG
    twin."""
    import statistics
    import subprocess
    import time

    from PIL import Image

    from gpupathtracer_tpu_torch.utils import io as port_io

    cpu = subprocess.run(["lscpu"], capture_output=True, text=True).stdout
    cpu = next((ln.split(":", 1)[1].strip() for ln in cpu.splitlines()
                if ln.startswith("Model name:")), "CPU model not reported")
    with open(os.path.join(folder, "manifest.json")) as f:
        manifest = json.load(f)
    for name, entry in sorted(manifest.items()):
        with open(os.path.join(folder, entry["file"]), "rb") as f:
            data = f.read()
        with open(os.path.join(folder, entry["png"]), "rb") as f:
            png = f.read()
        row = []
        for label, fn in (
                ("port", lambda: port_io.decode_image(data, name)),
                ("PIL", lambda: np.asarray(
                    Image.open(io.BytesIO(data)).convert("RGB"))),
                ("port PNG twin", lambda: port_io.decode_png(png, name))):
            fn()
            ts = []
            for _ in range(5):
                t0 = time.perf_counter()
                fn()
                ts.append(time.perf_counter() - t0)
            ms = statistics.median(ts) * 1e3
            mpix = entry["height"] * entry["width"] / 1e6 / (ms / 1e3)
            row.append(f"{label} {ms:.3f} ms ({mpix:.1f} MPix/s)")
        print(f"{name} {entry['format']} {entry['width']}x{entry['height']}: "
              + ", ".join(row) + f"; host {cpu}")


def main(argv=None) -> int:
    from PIL import Image

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=os.path.join(REPO, "tests", "golden",
                                                  "images"))
    ap.add_argument("--time", action="store_true",
                    help="time the decodes of the fixtures in --out "
                         "instead of writing them")
    ap.add_argument("--ycbcr-table", action="store_true",
                    help="write gpupathtracer_tpu_torch/utils/ycbcr_rgb.bin "
                         "(Pillow's YCbCr -> RGB tables) instead")
    ap.add_argument("--openjpeg-encode", nargs=2, metavar=("SPEC", "OUT"),
                    help=argparse.SUPPRESS)
    ap.add_argument("--ht-vlc-table", action="store_true",
                    help="write gpupathtracer_tpu_torch/utils/ht_vlc.bin "
                         "(OpenJPEG's HTJ2K VLC tables, read out of the "
                         "OpenJPEG Pillow bundles) instead")
    ap.add_argument("--avif-set", action="store_true",
                    help="write tests/golden/avif (PIL-written AVIFs, their "
                         "cuts and junk, PIL's verdicts) instead")
    ap.add_argument("--lab-table", action="store_true",
                    help="write gpupathtracer_tpu_torch/utils/lab_srgb.bin "
                         "(LittleCMS's Lab -> sRGB table) instead")
    args = ap.parse_args(argv)
    if args.time:
        time_decodes(args.out)
        return 0
    if args.openjpeg_encode:
        import pickle
        with open(args.openjpeg_encode[0], "rb") as f:
            spec = pickle.load(f)
        with open(args.openjpeg_encode[1], "wb") as f:
            f.write(_openjpeg_encode_here(spec))
        return 0
    if args.ycbcr_table:
        ycbcr_table(os.path.join(REPO, "gpupathtracer_tpu_torch", "utils",
                                 "ycbcr_rgb.bin"))
        return 0
    if args.ht_vlc_table:
        import glob

        import PIL
        lib = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
            PIL.__file__)), "pillow.libs", "libopenjp2-*.so*"))[0]
        ht = htj2k()
        with open(lib, "rb") as f:
            tables = ht.find_vlc_tables(f.read())
        with open(ht.VLC_BIN, "wb") as f:
            f.write(tables)
        return 0
    if args.avif_set:
        write_avif_set(os.path.join(REPO, "tests", "golden", "avif"))
        return 0
    if args.lab_table:
        lab_table(os.path.join(REPO, "gpupathtracer_tpu_torch", "utils",
                               "lab_srgb.bin"))
        return 0
    os.makedirs(args.out, exist_ok=True)
    manifest, twins = {}, {}

    def put(name, fname, data, png_name, decoded, fmt, encoding):
        with open(os.path.join(args.out, fname), "wb") as f:
            f.write(data)
        png_path = os.path.join(args.out, png_name)
        if not os.path.exists(png_path):
            write_png(png_path, decoded)
        with open(png_path, "rb") as f:
            png = f.read()
        manifest[name] = {
            "file": fname, "format": fmt, "png": png_name,
            "height": int(decoded.shape[0]), "width": int(decoded.shape[1]),
            "encoding": encoding, "file_sha256": _sha(data),
            "png_sha256": _sha(png),
            "pixels_sha256": _sha(np.ascontiguousarray(decoded).tobytes())}
        print(f"{name}: {decoded.shape[1]}x{decoded.shape[0]} {fmt}, "
              f"{len(data)} B, PNG {len(png)} B")

    def pil_decode(data):
        return np.asarray(Image.open(io.BytesIO(data)).convert("RGB"))

    for name in os.listdir(args.out):
        if name.endswith(".png"):       # twins are written afresh
            os.remove(os.path.join(args.out, name))
    for name, (pixels, kw) in fixtures().items():
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, "JPEG", **kw)
        jpg = buf.getvalue()
        twins[name] = pil_decode(jpg)
        put(name, f"{name}.jpg", jpg, f"{name}.png", twins[name], "JPEG",
            {k: v for k, v in kw.items()})
    for name, (fname, data, twin, encoding) in other_fixtures(twins).items():
        decoded = pil_decode(data)
        (fmt,) = encoding
        if twin is not None and decoded.tobytes() != twins[
                twin[:-4]].tobytes():
            raise AssertionError(f"{fname} does not decode to {twin}")
        put(name, fname, data, twin or f"{name}.png", decoded, fmt,
            encoding[fmt])
    with open(os.path.join(args.out, "manifest.json"), "w") as f:
        json.dump(manifest, f, indent=1, sort_keys=True)
        f.write("\n")
    return 0


def write_avif_set(folder: str) -> None:
    """avif_fixtures (of the JPEG fixtures' decodes) into ``folder`` with
    verdicts.json: each file's sha256 and the format PIL's Image.open
    gives it by its path (null where PIL fails)."""
    import warnings

    from PIL import Image
    twins = {}
    for name, (pixels, kw) in fixtures().items():
        buf = io.BytesIO()
        Image.fromarray(pixels).save(buf, "JPEG", **kw)
        buf.seek(0)
        twins[name] = np.asarray(Image.open(buf).convert("RGB"))
    os.makedirs(folder, exist_ok=True)
    verdicts = {}
    for name, data in avif_fixtures(twins).items():
        path = os.path.join(folder, f"{name}.avif")
        with open(path, "wb") as f:
            f.write(data)
        try:
            with warnings.catch_warnings():
                warnings.simplefilter("ignore")
                fmt = Image.open(path).format
        except Exception:
            fmt = None
        verdicts[name] = {"file": f"{name}.avif", "sha256": _sha(data),
                          "pil": fmt}
        print(f"avif/{name}: {len(data)} B, PIL: {fmt}")
    with open(os.path.join(folder, "verdicts.json"), "w") as f:
        json.dump(verdicts, f, indent=1, sort_keys=True)
        f.write("\n")


if __name__ == "__main__":
    sys.exit(main())
