"""Write the image fixtures of tests/golden/images/: each image file beside
PIL's decode of it (``Image.open(path).convert("RGB")``) as an 8-bit RGB
PNG, and manifest.json with each file's sha256 and the sha256 of the
decoded pixels.

    python tools/torch_image_fixtures.py [--out tests/golden/images]
    python tools/torch_image_fixtures.py --time   # decode times, port and PIL

Needs Pillow, so it runs where the JAX package's tests run, never on the
card's machine; the port reads the files without it (utils/io.py
decode_image) and tests/test_torch_images.py, chip_smoke.py phase 20 (the
JPEGs), phase 21 (the rest but WebP) and phase 22 (the WebP files) hold its
decodes to the PNGs. The files:

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
  with the simple loop filter, bricks in eight token partitions.

The writers of the containers PIL does not write (DDS headers, GIF, TIFF
with tiles, planar configuration 2, predictors, big-endian and BigTIFF,
PSD, WebP chunks and animations) live here too;
tests/test_torch_image_formats.py and tests/test_torch_webp.py build their
cases with them.

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


def lzw_tiff(data: bytes) -> bytes:
    """TIFF LZW (MSB first, early change) of one strip."""
    out, acc, nacc, nbits = bytearray(), 0, 0, 9

    def emit(code):
        nonlocal acc, nacc
        acc = (acc << nbits) | code
        nacc += nbits
        while nacc >= 8:
            out.append((acc >> (nacc - 8)) & 255)
            nacc -= 8
        acc &= (1 << nacc) - 1

    def grow():
        nonlocal nbits
        if nxt - 1 > (1 << nbits) - 2 and nbits < 12:
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
        out.append((acc << (8 - nacc)) & 255)
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
        elif bps < 8:
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
               extra=(), colormap=None, jpeg=None, tags=()) -> bytes:
    """A one-IFD TIFF of ``arr`` [h, w] or [h, w, samples]: byte order
    ``order``, classic or BigTIFF, strips or ``tile`` (w, h) tiles,
    planar configuration 1 or 2, compression none, LZW, Deflate,
    PackBits, LZMA, or JPEG (``jpeg(plane, x, y, w, h)`` gives each
    strip's or tile's stream); ``tags`` adds (tag, (type, values))."""
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
            chunks.append({1: lambda: raw, 5: lambda: lzw_tiff(raw),
                           8: lambda: zlib.compress(raw, 6),
                           32946: lambda: zlib.compress(raw, 6),
                           32773: lambda: b"".join(packbits(r) for r in rows),
                           34925: lambda: lzma.compress(
                               raw, format=lzma.FORMAT_XZ)}[compression]())
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
    if sample_format:
        entries[339] = (3, [sample_format] * spp)
    if extra:
        entries[338] = (3, list(extra))
    if colormap is not None:
        entries[320] = (3, list(colormap))
    entries.update(dict(tags))
    codes = {1: "B", 3: "H", 4: "I", 7: "B", 11: "f", 16: "Q"}
    inline = 8 if big else 4
    base = head_len + len(data)
    ifd_len = (8 if big else 2) + (20 if big else 12) * len(entries) + inline
    ifd = bytearray(struct.pack(order + ("Q" if big else "H"), len(entries)))
    blob = bytearray()
    for tag, (typ, vals) in sorted(entries.items()):
        payload = struct.pack(f"{order}{len(vals)}{codes[typ]}", *vals)
        ifd += struct.pack(order + ("HHQ" if big else "HHI"), tag, typ,
                           len(vals))
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
    args = ap.parse_args(argv)
    if args.time:
        time_decodes(args.out)
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


if __name__ == "__main__":
    sys.exit(main())
