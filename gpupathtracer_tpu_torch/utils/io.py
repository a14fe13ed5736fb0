"""Image I/O without third-party imaging packages: a PNG writer, the
entry point of the image readers (decode_image: the format told as PIL
tells it, utils/identify.py), the PNG, TGA and BMP readers (BMP's bitmap
also read as DIB and CUR, and in ICO frames), PIL's CMYK to RGB, and the
Radiance .hdr reader of the JAX package's utils/io.py. Every reader gives
what the JAX package gets from PIL, bit for bit."""

from __future__ import annotations

import os
import re
import struct
import time
import zlib

import numpy as np


def _png_chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def save_png(path: str, image: np.ndarray, flip_y: bool = False) -> str:
    """Save an [H, W, 3] image as an 8-bit RGB PNG.

    `image` is float (0..1, clipped) or uint8. The reference y-flips saved
    screenshots (Renderer.cpp:1170-1182); pass flip_y=True for parity.
    """
    arr = np.asarray(image)
    if arr.ndim != 3 or arr.shape[2] != 3:
        raise ValueError(f"save_png takes [H, W, 3] images, got {arr.shape}")
    if arr.dtype != np.uint8:
        arr = (np.clip(arr, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
    if flip_y:
        arr = arr[::-1]
    h, w = arr.shape[:2]
    raw = b"".join(b"\x00" + row.tobytes() for row in arr)  # filter: none
    png = (b"\x89PNG\r\n\x1a\n"
           + _png_chunk(b"IHDR", struct.pack(">IIBBBBB", w, h, 8, 2, 0, 0, 0))
           + _png_chunk(b"IDAT", zlib.compress(raw, 6))
           + _png_chunk(b"IEND", b""))
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    with open(path, "wb") as f:
        f.write(png)
    return path


def load_image(path: str) -> np.ndarray:
    """Load an image to float32 [H, W, 3], as the JAX package's PIL
    ``Image.open(path).convert("RGB")`` / 255 reads it, bit for bit; a
    .hdr file (by its name, as the JAX package) as linear floats. The
    format is told as PIL tells it (utils/identify.py); see decode_image
    for the formats read and what raises."""
    if path.lower().endswith(".hdr"):
        return load_hdr(path)
    with open(path, "rb") as f:
        data = f.read()
    return decode_image(data, path).astype(np.float32) / 255.0


def decode_image(data: bytes, name: str = "<image>") -> np.ndarray:
    """Decode an image file's bytes to uint8 [H, W, 3] RGB, bit for bit
    PIL's ``convert("RGB")``.

    The format is the one PIL's ``Image.open`` would pick
    (utils/identify.py). Read: PNG (every depth, Adam7), JPEG (utils/
    jpeg.py: every process PIL reads, Huffman or arithmetic coded and
    lossless, 1, 3 or 4 components), BMP (raw,
    RLE4, RLE8, bit fields; Windows and OS/2 headers) and its bitmap as
    DIB and CUR, TGA, GIF (utils/gif.py), TIFF (utils/tiff.py: every
    compression the held PIL reads but old-style JPEG, CCITT and ZSTD
    among them; fill order 2, orientations, YCbCr and Lab), DDS
    (utils/dds.py: BC1-BC7), PSD (utils/psd.py, Lab too), WebP
    (utils/webp.py: lossless, lossy with its alpha, extended and animated
    files' first frame), PNM and PFM (utils/pnm.py: P1-P6, P0CMYK, Pf and
    PIL's Py*), QOI (utils/qoi.py), ICO (utils/ico.py: PNG and bitmap
    frames), SGI (utils/sgi.py: raw and run-length, 8 and 16 bits), PCX
    (utils/pcx.py), JPEG 2000 (utils/jpeg2000.py: J2K codestreams and JP2
    files, every code-block style, HTJ2K's among them, and Part 2's
    component transform markers) and ICNS (utils/icns.py). A format PIL
    reads and the port does not yet read (AVIF's AV1 payload, XBM, IM,
    old-style JPEG in TIFF, ...; ROADMAP.md C6) raises
    NotImplementedError naming the file and the format; an AVIF file is
    first parsed as libavif parses it at open (utils/avif.py), so one PIL
    refuses is ValueError. Bytes PIL cannot
    open or cannot load (no plugin accepts them or a plugin's open-time
    checks refuse them, a corrupt or truncated file, the stub plugins,
    TIFFs of LERC, WebP or SGILog compression) raise ValueError naming the
    file: build_atlas skips such a map, as the JAX package's does."""
    from gpupathtracer_tpu_torch.utils.identify import CANNOT_LOAD, identify

    fmt = identify(data, name)
    reader = _readers().get(fmt)
    if reader is not None:
        return reader(data, name)
    if fmt in CANNOT_LOAD:
        raise ValueError(f"{name}: PIL identifies a {fmt} file but cannot "
                         f"load it")
    raise NotImplementedError(
        f"{name}: a {fmt} image (PIL reads it; the port does not: "
        f"ROADMAP.md C6)")


def _readers() -> dict:
    from gpupathtracer_tpu_torch.utils.dds import decode_dds
    from gpupathtracer_tpu_torch.utils.gif import decode_gif
    from gpupathtracer_tpu_torch.utils.icns import decode_icns
    from gpupathtracer_tpu_torch.utils.ico import decode_ico
    from gpupathtracer_tpu_torch.utils.jpeg import decode_jpeg
    from gpupathtracer_tpu_torch.utils.jpeg2000 import decode_jpeg2000
    from gpupathtracer_tpu_torch.utils.pcx import decode_pcx
    from gpupathtracer_tpu_torch.utils.pnm import decode_ppm
    from gpupathtracer_tpu_torch.utils.psd import decode_psd
    from gpupathtracer_tpu_torch.utils.qoi import decode_qoi
    from gpupathtracer_tpu_torch.utils.sgi import decode_sgi
    from gpupathtracer_tpu_torch.utils.tiff import decode_tiff
    from gpupathtracer_tpu_torch.utils.webp import decode_webp
    return {"PNG": decode_png, "JPEG": decode_jpeg, "BMP": decode_bmp,
            "TGA": decode_tga, "GIF": decode_gif, "TIFF": decode_tiff,
            "DDS": decode_dds, "PSD": decode_psd, "WEBP": decode_webp,
            "PPM": decode_ppm, "QOI": decode_qoi, "DIB": decode_dib,
            "CUR": decode_cur, "ICO": decode_ico, "SGI": decode_sgi,
            "PCX": decode_pcx, "JPEG2000": decode_jpeg2000,
            "ICNS": decode_icns}


def cmyk_to_rgb(cmyk: np.ndarray) -> np.ndarray:
    """PIL's CMYK -> RGB (Convert.c cmyk2rgb): each channel
    255 - k - c * (255 - k) / 255 with PIL's rounded division, clipped;
    uint8 [..., 4] -> uint8 [..., 3]."""
    nk = 255 - cmyk[..., 3:4].astype(np.int32)
    t = cmyk[..., :3].astype(np.int32) * nk + 128
    return np.clip(nk - (((t >> 8) + t) >> 8), 0, 255).astype(np.uint8)


# PIL's Image.MAX_IMAGE_PIXELS: past twice this it raises
# DecompressionBombError (and the JAX package's atlas builder skips the
# map).
MAX_IMAGE_PIXELS = 1024 * 1024 * 1024 // 4 // 3


def check_pixels(h: int, w: int, name: str) -> None:
    if h * w > 2 * MAX_IMAGE_PIXELS:
        raise ValueError(f"{name}: {w}x{h} pixels, past PIL's decompression "
                         f"bomb limit of {2 * MAX_IMAGE_PIXELS}")


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# Colour type -> samples a pixel (grey, RGB, palette, grey + alpha, RGBA).
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
# Colour type -> the bit depths the PNG spec allows.
_PNG_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8),
               4: (8, 16), 6: (8, 16)}
# Adam7 passes: (x0, y0, dx, dy).
_ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
          (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """Decode a PNG to uint8 [H, W, 3], bit for bit PIL's
    ``convert("RGB")``: grey replicated (1-, 2- and 4-bit grey scaled by
    255 / (2^d - 1)), palette indices looked up (an index past the palette
    reads black), alpha and tRNS dropped; 16-bit RGB, RGBA and grey +
    alpha keep each sample's high byte, 16-bit grey (PIL's mode I;16) is
    clipped at 255. Adam7-interlaced files are read pass by pass. The
    chunks are read as PIL reads them: up to the first IDAT each with its
    CRC, then the run of IDAT chunks only as far as the image needs (the
    zlib stream's checksum and what follows its last row are not read).
    What PIL cannot read raises ValueError naming the file."""
    pos, plte, ihdr = 8, None, None
    while True:
        if pos + 8 > len(data):
            raise ValueError(f"{name}: PNG ends before its image data")
        (n,) = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        if not _PNG_CID.match(tag):
            raise ValueError(f"{name}: broken PNG file (chunk {tag!r})")
        body = data[pos + 8:pos + 8 + n]
        if tag == b"IDAT":
            break
        if len(body) < n or pos + 12 + n > len(data):
            raise ValueError(f"{name}: truncated PNG chunk {tag!r}")
        (crc,) = struct.unpack_from(">I", data, pos + 8 + n)
        if zlib.crc32(tag + body) & 0xFFFFFFFF != crc:
            raise ValueError(f"{name}: broken PNG file (bad checksum in "
                             f"{tag!r})")
        pos += 12 + n
        if tag == b"IHDR":
            if n < 13:
                raise ValueError(f"{name}: truncated IHDR chunk")
            ihdr = struct.unpack(">IIBBBBB", body[:13])
        elif tag == b"PLTE":
            plte = np.frombuffer(body[:len(body) // 3 * 3],
                                 np.uint8).reshape(-1, 3)
        elif tag == b"IEND":
            raise ValueError(f"{name}: PNG without image data")
    if ihdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, filt, interlace = ihdr
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: PNG of {w}x{h} pixels")
    check_pixels(h, w, name)
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype}")
    if depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"{name}: PNG bit depth {depth} for colour type "
                         f"{ctype}")
    if filt:
        raise ValueError(f"{name}: PNG filter method {filt}")
    if interlace not in (0, 1):
        raise ValueError(f"{name}: PNG interlace method {interlace}")
    if ctype == 3 and plte is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    ch = _PNG_CHANNELS[ctype]
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    sizes = []
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw > 0 and ph > 0:           # an empty pass has no rows at all
            sizes.append((x0, y0, dx, dy, pw, ph, -(-pw * ch * depth // 8)))
    raw = np.frombuffer(_png_inflate(
        data, pos, sum(ph * (st + 1) for *_, ph, st in sizes), name),
        np.uint8)
    samples = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy, pw, ph, stride in sizes:
        size = ph * (stride + 1)
        rows = raw[off:off + size].reshape(ph, stride + 1)
        off += size
        bpp = max(1, ch * depth // 8)
        sub = _samples(_unfilter(rows, ph, stride, bpp, name), pw, ch, depth)
        samples[y0::dy, x0::dx] = sub
    return _to_rgb(samples, ctype, depth, plte)


_PNG_CID = re.compile(rb"\w\w\w\w")


def _png_inflate(data: bytes, pos: int, size: int, name: str) -> bytes:
    """The first ``size`` bytes of the zlib stream in the run of IDAT
    chunks at ``pos``, read as PIL's loader reads them: chunk by chunk,
    the next chunk's header only when more data is needed (a chunk that
    is not IDAT ends the data); a stream that ends early or is corrupt
    raises ValueError."""
    z = zlib.decompressobj()
    out = []
    have = 0
    while True:
        (n,) = struct.unpack_from(">I", data, pos)
        body = data[pos + 8:pos + 8 + n]
        try:
            part = z.decompress(body, size - have)
        except zlib.error as e:
            raise ValueError(f"{name}: broken PNG data stream ({e})") from e
        out.append(part)
        have += len(part)
        if have >= size:
            return b"".join(out)
        if z.eof or len(body) < n:
            raise ValueError(f"{name}: truncated PNG image data")
        pos += 12 + n
        if pos + 8 > len(data):
            raise ValueError(f"{name}: truncated PNG image data")
        tag = data[pos + 4:pos + 8]
        if not _PNG_CID.match(tag):
            raise ValueError(f"{name}: broken PNG file (chunk {tag!r})")
        if tag != b"IDAT":
            raise ValueError(f"{name}: truncated PNG image data")


def _samples(rows: np.ndarray, w: int, ch: int, depth: int) -> np.ndarray:
    """Unfiltered rows [h, stride] -> samples [h, w, ch] (uint16 at depth
    16, big-endian in the file; packed 1-, 2- and 4-bit samples unpacked,
    most significant bits first)."""
    h = rows.shape[0]
    if depth == 16:
        pairs = rows[:, :2 * w * ch].reshape(h, w, ch, 2).astype(np.uint16)
        return (pairs[..., 0] << 8) | pairs[..., 1]
    if depth == 8:
        return rows[:, :w * ch].reshape(h, w, ch)
    per = 8 // depth
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    vals = (rows[:, :, None] >> shifts) & ((1 << depth) - 1)
    return vals.reshape(h, -1)[:, :w * ch].reshape(h, w, ch).astype(np.uint8)


def _to_rgb(s: np.ndarray, ctype: int, depth: int, plte) -> np.ndarray:
    """PIL's mode for the file, then its convert("RGB")."""
    if ctype == 3:
        pal = np.zeros((256, 3), np.uint8)      # past the palette: black
        pal[:min(len(plte), 256)] = plte[:256]
        return pal[s[..., 0]]
    if depth == 16:
        if ctype == 0:          # I;16: convert("RGB") clips at 255
            g = np.minimum(s[..., 0], 255).astype(np.uint8)
            return np.repeat(g[..., None], 3, axis=2)
        s = (s >> 8).astype(np.uint8)
    elif depth < 8:             # grey at 1, 2, 4 bits: 0 .. 255
        s = (s * (255 // ((1 << depth) - 1))).astype(np.uint8)
    if ctype in (0, 4):
        return np.repeat(s[..., :1], 3, axis=2)
    return np.ascontiguousarray(s[..., :3])


def _unfilter(raw: np.ndarray, h: int, stride: int, bpp: int,
              name: str) -> np.ndarray:
    """Undo the per-row filters 0-4 (PNG spec section 9) on [h, 1 + stride]
    rows; returns [h, stride] uint8."""
    out = np.zeros((h, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(h):
        ftype, line = int(raw[y, 0]), raw[y, 1:]
        if ftype == 0:
            cur = line
        elif ftype == 1:    # Sub: a running sum of each channel, mod 256
            cur = np.cumsum(line.reshape(-1, bpp), axis=0,
                            dtype=np.uint8).reshape(-1)
        elif ftype == 2:    # Up
            cur = line + prev
        elif ftype in (3, 4):
            # Average and Paeth depend on the byte to the left as decoded:
            # one byte at a time.
            cur = bytearray(line.tobytes())
            up = prev.tobytes()
            for x in range(stride):
                a = cur[x - bpp] if x >= bpp else 0
                b = up[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = up[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (b if pb <= pc
                                                            else c)
                cur[x] = (cur[x] + pred) & 0xFF
            cur = np.frombuffer(bytes(cur), np.uint8)
        else:
            raise ValueError(f"{name}: PNG filter type {ftype} in row {y}")
        out[y] = cur
        prev = out[y]
    return out


# --- TGA and BMP (PIL's TgaImagePlugin / BmpImagePlugin) ---------------------

# (image type & 7, depth) -> bytes a pixel (PIL's TGA MODES).
_TGA_BPP = {(1, 8): 1, (3, 1): 1, (3, 8): 1, (3, 16): 2, (2, 16): 2,
            (2, 24): 3, (2, 32): 4}


def _bgr15(px: np.ndarray) -> np.ndarray:
    """PIL's BGR;15 / BGRA;15Z unpackers: little-endian 16-bit X1R5G5B5,
    each channel v * 255 // 31."""
    v = px[..., 0].astype(np.int32) | (px[..., 1].astype(np.int32) << 8)
    return np.stack([((v >> 10) & 31) * 255 // 31, ((v >> 5) & 31) * 255 // 31,
                     (v & 31) * 255 // 31], -1).astype(np.uint8)


def decode_tga(data: bytes, name: str = "<tga>") -> np.ndarray:
    """Decode a TGA to uint8 [H, W, 3], bit for bit PIL's convert("RGB"):
    types 1 and 9 (colour-mapped, 8-bit indices into 16-, 24- or 32-bit
    map entries, black below the map's first index and past its end), 2
    and 10 (16-bit X1R5G5B5, BGR at 24 bits, BGRA at 32), 3 and 11 (grey
    at 1 bit raw, 8 bits, grey + alpha at 16), raw or run-length encoded,
    rows bottom-up unless the origin bit (0x20) is set, mirrored when bit
    0x10 is (a grey image with a colour map is looked up in it, as PIL
    does). What PIL cannot load (another depth for the type, 1-bit
    run-length data or 1 bit with a map, a true-colour image with a
    colour map, a run past its row's end) raises ValueError."""
    id_len, cmap_type, itype = data[0], data[1], data[2]
    cm_start, cm_len, cm_depth = struct.unpack("<HHB", data[3:8])
    w, h, depth, flags = struct.unpack("<HHBB", data[12:18])
    check_pixels(h, w, name)
    kind = itype & 7
    pos = 18 + id_len
    pal = None
    if cmap_type:
        if kind == 2:
            raise ValueError(f"{name}: true-colour TGA with a colour map "
                             f"(PIL cannot load it)")
        entry = {16: 2, 24: 3, 32: 4}[cm_depth]
        table = data[pos:pos + entry * cm_len]
        pos += entry * cm_len
        if kind == 1 and entry == 4:
            raise ValueError(f"{name}: TGA colour map of 32-bit entries "
                             f"(PIL refuses it too)")
        # PIL's palette: `start` black entries, then the map's entries,
        # black past its end.
        ent = np.frombuffer(table[:len(table) // entry * entry],
                            np.uint8).reshape(-1, entry)
        rgb = _bgr15(ent) if entry == 2 else ent[:, 2::-1]
        pal = np.zeros((256, 3), np.uint8)
        pal[cm_start:cm_start + len(rgb)] = rgb[:max(0, 256 - cm_start)]
    bpp = _TGA_BPP.get((kind, depth))
    if bpp is None:
        raise ValueError(f"{name}: TGA image type {itype} at {depth} bits "
                         f"(PIL cannot load it)")
    if depth == 1 and (itype & 8 or pal is not None):
        raise ValueError(f"{name}: a 1-bit TGA run-length coded or with a "
                         f"colour map (PIL cannot load it)")
    if depth == 1:
        stride = (w + 7) // 8
        if pos + stride * h > len(data):
            raise ValueError(f"{name}: truncated TGA image data")
        rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h,
                                                                      stride)
        px = (_samples(rows, w, 1, 1) * 255).astype(np.uint8)
    else:
        n = w * h * bpp
        if itype & 8:
            px, pos = _tga_rle(data, pos, w * h, bpp, w, name)
        else:
            if pos + n > len(data):
                raise ValueError(f"{name}: truncated TGA image data")
            px = np.frombuffer(data, np.uint8, n, pos)
        px = px.reshape(h, w, bpp)
    if not flags & 0x20:
        px = px[::-1]                      # bottom-up rows
    if flags & 0x10:
        px = px[:, ::-1]
    if kind == 1:
        if pal is None:                    # no map: the indices as grey
            return np.repeat(px, 3, axis=2)
        return pal[px[..., 0]]
    if kind == 3:
        if pal is not None:                # PIL applies a grey image's map
            return pal[px[..., 0]]
        return np.repeat(px[..., :1], 3, axis=2)
    if depth == 16:
        return _bgr15(px)
    return np.ascontiguousarray(px[..., 2::-1])


def _tga_rle(data: bytes, pos: int, count: int, bpp: int, row: int,
             name: str):
    """TGA run-length packets -> count pixels, as PIL's decoder takes them:
    a literal packet may cross rows, a run past its row's end is an
    overrun (PIL raises)."""
    out = bytearray()
    want = count * bpp
    n = len(data)
    while len(out) < want:
        if pos >= n:
            raise ValueError(f"{name}: truncated TGA run-length data")
        head = data[pos]
        pos += 1
        k = (head & 0x7F) + 1
        if head & 0x80:
            if len(out) % (row * bpp) + k * bpp > row * bpp:
                raise ValueError(f"{name}: a TGA run past its row's end "
                                 f"(PIL: buffer overrun)")
            out += data[pos:pos + bpp] * k
            pos += bpp
        else:
            out += data[pos:pos + k * bpp]
            pos += k * bpp
        if pos > n:
            raise ValueError(f"{name}: truncated TGA run-length data")
    return np.frombuffer(bytes(out[:want]), np.uint8), pos


# BI_BITFIELDS masks PIL reads: (bits, masks) -> PIL's raw mode.
_BMP_MASKS = {
    (32, (0xFF0000, 0xFF00, 0xFF, 0x0)), (32, (0xFF000000, 0xFF0000, 0xFF00,
                                               0x0)),
    (32, (0xFF000000, 0xFF00, 0xFF, 0x0)), (32, (0xFF000000, 0xFF0000,
                                                 0xFF00, 0xFF)),
    (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)), (32, (0xFF0000, 0xFF00, 0xFF,
                                                      0xFF000000)),
    (32, (0xFF000000, 0xFF00, 0xFF, 0xFF0000)), (32, (0x0, 0x0, 0x0, 0x0)),
    (24, (0xFF0000, 0xFF00, 0xFF)), (16, (0xF800, 0x7E0, 0x1F)),
    (16, (0x7C00, 0x3E0, 0x1F))}


def decode_bmp(data: bytes, name: str = "<bmp>") -> np.ndarray:
    """Decode a BMP to uint8 [H, W, 3], bit for bit PIL's convert("RGB"):
    the 14-byte file header, then the bitmap (_bitmap) at the pixel offset
    it gives (0: right after the palette)."""
    if len(data) < 18:
        raise ValueError(f"{name}: truncated BMP header")
    (offset,) = struct.unpack("<I", data[10:14])
    return _bitmap(data, 14, offset, name)


def decode_dib(data: bytes, name: str = "<dib>") -> np.ndarray:
    """Decode a DIB (a BMP without its file header, PIL's DibImageFile) to
    uint8 [H, W, 3]: the bitmap at 0, its pixels right after its header
    and palette, as PIL computes the offset."""
    return _bitmap(data, 0, 0, name)


def decode_cur(data: bytes, name: str = "<cur>") -> np.ndarray:
    """Decode a Windows cursor (PIL's CurImagePlugin) to uint8 [H, W, 3]:
    the first entry, replaced by a later one only where both its width
    and its height byte are strictly larger (a 0 byte is 0), its bitmap at
    the entry's offset (at 0: where the directory ends, as PIL reads on
    from there), the bitmap's height halved (the AND mask left out)."""
    from gpupathtracer_tpu_torch.utils.identify import cur_bitmap_at
    try:
        at = cur_bitmap_at(data)
    except Exception as e:
        raise ValueError(f"{name}: PIL does not read this cursor ({e})") \
            from e
    return _bitmap(data, at, 0, name, halve=True)


def bitmap_header(data: bytes, at: int, offset: int) -> dict:
    """What PIL's BmpImageFile._bitmap reads when it opens the bitmap whose
    header starts at ``at`` (``offset``: the file header's pixel offset,
    0 for DIB, CUR and ICO frames): size, depth, compression, masks,
    palette, pixel offset. Raises identify.Refused where PIL's _open
    stops, identify.PassOn (or IndexError, struct.error) where it passes
    the file on to the next plugin."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    if len(data) < at + 4:
        raise PassOn("no BMP header size")
    (hsize,) = struct.unpack_from("<I", data, at)
    head = data[at + 4:at + hsize]
    if hsize > 4 and len(head) < hsize - 4:
        raise Refused("Truncated File Read")
    pos = at + hsize                    # where PIL reads on from
    direction = -1
    masks = None
    if hsize == 12:
        w, h, _, bits = struct.unpack("<HHHH", head[:8])
        comp, colors, padding = 0, 0, 3
    elif hsize in (40, 52, 56, 64, 108, 124):
        y_flip = head[7] == 0xFF
        direction = 1 if y_flip else -1
        w, h = struct.unpack("<II", head[:8])
        if y_flip:
            h = 2 ** 32 - h
        _, bits, comp = struct.unpack("<HHI", head[8:16])
        (colors,) = struct.unpack("<I", head[28:32])
        padding = 4
        if comp == 3:
            if len(head) >= 48:
                n = 4 if len(head) >= 52 else 3
                masks = struct.unpack(f"<{n}I", head[36:36 + 4 * n])
                masks += (0,) * (4 - n)
            else:
                if len(data) < pos + 12:
                    raise PassOn("BMP bit field masks cut short")
                masks = struct.unpack_from("<3I", data, pos) + (0,)
                pos += 12
    else:
        raise Refused(f"BMP header of {hsize} bytes")
    colors = colors or (1 << bits)
    if offset == 14 + hsize and bits <= 8:
        offset += 4 * colors
    if bits not in (1, 4, 8, 16, 24, 32):
        raise Refused(f"BMP of {bits} bits")
    if comp == 3:
        key = (bits, masks if bits == 32 else masks[:3])
        if key not in _BMP_MASKS:
            raise Refused(f"BMP bit field layout {masks}")
    elif comp not in (0, 1, 2):
        raise Refused(f"BMP compression {comp}")
    table = b""
    if bits <= 8:
        if not 0 < colors <= 65536:
            raise Refused(f"BMP palette of {colors} colours")
        table = data[pos:pos + padding * colors]
        pos += len(table)
    if w <= 0 or h <= 0:
        raise PassOn(f"BMP of {w}x{h} pixels")
    return dict(w=w, h=h, bits=bits, comp=comp, masks=masks, colors=colors,
                padding=padding, table=table, direction=direction,
                offset=offset or pos)


def _bitmap(data: bytes, at: int, offset: int, name: str,
            halve: bool = False, mapped: bool = True) -> np.ndarray:
    """The bitmap whose header starts at ``at`` (PIL's
    BmpImageFile._bitmap and its decoders), bit for bit PIL's
    convert("RGB"): BI_RGB at 1, 4, 8, 16 (X1R5G5B5), 24 and 32 bits; RLE8
    and RLE4 (PIL's Python decoder: end-of-line, end-of-bitmap, delta and
    absolute runs); BI_BITFIELDS at 16 (565, 555), 24 and 32 bits with the
    masks PIL lists. A palette of the grey ramp is dropped (PIL's mode L:
    an index is its grey level). Rows bottom-up unless the height is
    negative. The 12-byte OS/2 1.x header (BGR palette entries),
    BITMAPINFOHEADER, the 64-byte OS/2 2.x header and the V2-V5
    extensions. ``halve``: the height halved, as CUR and ICO read it.
    ``mapped``: PIL opened the file by its path and memory-maps it where
    its raw mode is the image's (mode L at 1 and 4 bits then reads a byte
    a pixel from each row's start; an ICO frame is read from a stream).
    The last row needs no padding (PIL's raw decoder stops before it).
    What PIL refuses raises ValueError naming the file."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    try:
        hd = bitmap_header(data, at, offset)
    except (PassOn, Refused, IndexError, struct.error) as e:
        raise ValueError(f"{name}: PIL does not read this bitmap ({e})") \
            from e
    w, h, bits, comp = hd["w"], hd["h"], hd["bits"], hd["comp"]
    masks, colors, padding = hd["masks"], hd["colors"], hd["padding"]
    direction, offset, table = hd["direction"], hd["offset"], hd["table"]
    check_pixels(h, w, name)
    if w >= 2 ** 31:
        raise ValueError(f"{name}: BMP of {w}x{h} pixels")
    if halve:
        h //= 2
        if h <= 0:
            raise ValueError(f"{name}: a bitmap of one row under its mask")
    pal = grey = None
    if bits <= 8:
        # PIL's test: each entry's first three bytes the ramp's (a short
        # palette is not grey).
        ramp = np.array([0, 255] if colors == 2 else range(colors)) & 255
        full = np.frombuffer(table.ljust(padding * colors, b"\0"),
                             np.uint8).reshape(colors, padding)
        grey = len(table) >= padding * (colors - 1) + 3 and bool(
            (full[:, :3] == ramp[:, None]).all())
        ent = np.frombuffer(table[:len(table) // padding * padding],
                            np.uint8).reshape(-1, padding)[:, 2::-1]
        pal = np.zeros((256, 3), np.uint8)
        pal[:min(len(ent), 256)] = ent[:256]
    if comp in (1, 2):
        if bits > 8:
            raise ValueError(f"{name}: run-length BMP at {bits} bits")
        if grey and colors == 2:
            raise ValueError(f"{name}: run-length BMP of a bilevel palette "
                             f"(PIL cannot load it)")
        idx = _bmp_rle(data, offset, w, h, comp == 2, name)
        rows = idx.reshape(h, w)
        if direction == -1:
            rows = rows[::-1]
        return np.repeat(rows[..., None], 3, axis=2) if grey else pal[rows]
    stride = ((w * bits + 31) >> 3) & ~3
    if grey and colors != 2 and bits < 8:
        # PIL's mode L with raw mode L: memory-mapped, a row is w bytes
        # from each row's start, one byte a pixel (past the end of the
        # file the map reads zeros up to its last page); from a stream,
        # or where the map is short, the raw decoder reads the same bytes
        # and refuses a stride shorter than w.
        end = offset + stride * (h - 1) + w
        if mapped and offset + stride * h <= len(data):
            if end > -(-len(data) // 4096) * 4096:
                raise ValueError(f"{name}: BMP rows past the end of the "
                                 f"file")
        elif w > stride:
            raise ValueError(f"{name}: BMP rows of {w} grey bytes in a "
                             f"stride of {stride} (PIL's raw decoder "
                             f"refuses it)")
        elif end > len(data):
            raise ValueError(f"{name}: truncated BMP image data")
        starts = offset + stride * np.arange(h)
        if direction == -1:
            starts = starts[::-1]
        buf = np.frombuffer(data.ljust(end, b"\0"), np.uint8)
        g = buf[starts[:, None] + np.arange(w)]
        return np.repeat(g[..., None], 3, axis=2)
    row_bits = 1 if grey and colors == 2 else bits
    row_bytes = (w * row_bits + 7) // 8
    if offset + stride * (h - 1) + row_bytes > len(data):
        raise ValueError(f"{name}: truncated BMP image data")
    rows = np.frombuffer(data.ljust(offset + stride * h, b"\0"), np.uint8,
                         stride * h, offset).reshape(h, stride)
    if direction == -1:
        rows = rows[::-1]
    if bits <= 8:
        if grey and colors == 2:
            # PIL's mode 1: the row's bytes unpacked as bits, whatever the
            # depth.
            bit = _samples(rows, w, 1, 1)[..., 0]
            return np.repeat((bit * 255).astype(np.uint8)[..., None], 3, 2)
        idx = _samples(rows, w, 1, bits)[..., 0]
        return np.repeat(idx[..., None], 3, axis=2) if grey else pal[idx]
    px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
    if bits == 16:
        if comp == 3 and masks[0] == 0xF800:   # PIL's BGR;16: 565
            v = px[..., 0].astype(np.int32) | (px[..., 1].astype(np.int32)
                                               << 8)
            return np.stack([((v >> 11) & 31) * 255 // 31,
                             ((v >> 5) & 63) * 255 // 63,
                             (v & 31) * 255 // 31], -1).astype(np.uint8)
        return _bgr15(px)
    if comp == 3 and bits == 32:
        v = px.astype(np.uint32)
        v = v[..., 0] | v[..., 1] << 8 | v[..., 2] << 16 | v[..., 3] << 24
        if masks[:3] == (0, 0, 0):             # PIL reads it as BGRA
            masks = (0xFF0000, 0xFF00, 0xFF)
        return np.stack([(v & np.uint32(m)) >> np.uint32(
            (m & -m).bit_length() - 1) for m in masks[:3]],
            -1).astype(np.uint8)
    return np.ascontiguousarray(px[..., 2::-1])


def _bmp_rle(data: bytes, pos: int, w: int, h: int, rle4: bool,
             name: str) -> np.ndarray:
    """PIL's BmpRleDecoder: indices, w * h of them, in file row order.
    Runs are cut at the row's end; an end-of-line pads the row with 0;
    a delta skips two bytes and then reads its (right, up) pair as PIL
    does; absolute runs keep the file's 16-bit alignment (RLE4 drops an
    odd run's last pixel, as PIL does). Data that stops short of w * h
    indices raises ValueError, as PIL does."""
    out = bytearray()
    want = w * h
    x = 0
    n = len(data)
    while len(out) < want:
        if pos + 2 > n:
            break
        count, byte = data[pos], data[pos + 1]
        pos += 2
        if count:
            if x + count > w:
                count = max(0, w - x)
            if rle4:
                pair = (byte >> 4, byte & 15)
                out += bytes(pair[i % 2] for i in range(count))
            else:
                out += bytes([byte]) * count
            x += count
        elif byte == 0:
            out += bytes(-len(out) % w)
            x = 0
        elif byte == 1:
            break
        elif byte == 2:
            if pos + 2 > n:
                break
            pos += 2
            if pos + 2 > n:
                raise ValueError(f"{name}: truncated BMP run-length delta")
            right, up = data[pos], data[pos + 1]
            pos += 2
            out += bytes(right + up * w)
            x = len(out) % w
        else:
            if rle4:
                chunk = data[pos:pos + byte // 2]
                pos += len(chunk)
                for b in chunk:
                    out += bytes((b >> 4, b & 15))
                short = len(chunk) < byte // 2
            else:
                chunk = data[pos:pos + byte]
                pos += len(chunk)
                out += chunk
                short = len(chunk) < byte
            if short:
                break
            x += byte
            if pos % 2:
                pos += 1
    if len(out) < want:
        raise ValueError(f"{name}: BMP run-length data ends early (PIL: not "
                         f"enough image data)")
    return np.frombuffer(bytes(out[:want]), np.uint8)


def timestamped_name(prefix: str, suffix: str = ".png") -> str:
    """Timestamped screenshot filename (Program.cpp:127-130 behavior)."""
    return f"{prefix}-{time.strftime('%Y%m%d-%H%M%S')}{suffix}"


def load_hdr(path: str) -> np.ndarray:
    """Minimal Radiance RGBE (.hdr) reader -> float32 [H, W, 3] linear.

    Supports the common `-Y H +X W` layout with new-style RLE scanlines.
    """
    with open(path, "rb") as f:
        data = f.read()
    # Header ends at the first blank line; next line is the resolution spec.
    pos = 0
    if not data.startswith(b"#?"):
        raise ValueError(f"{path}: not a Radiance file")
    while True:
        nl = data.index(b"\n", pos)
        line = data[pos:nl]
        pos = nl + 1
        if line == b"":
            break
    nl = data.index(b"\n", pos)
    res = data[pos:nl].split()
    pos = nl + 1
    if len(res) != 4 or res[0] != b"-Y" or res[2] != b"+X":
        raise ValueError(f"{path}: unsupported resolution spec {res}")
    height, width = int(res[1]), int(res[3])

    rgbe = np.zeros((height, width, 4), dtype=np.uint8)
    buf = np.frombuffer(data, dtype=np.uint8)
    for y in range(height):
        # New-style RLE scanline starts with 0x02 0x02 and 16-bit width.
        if (width >= 8 and width < 32768 and buf[pos] == 2 and buf[pos + 1] == 2
                and (int(buf[pos + 2]) << 8 | int(buf[pos + 3])) == width):
            pos += 4
            for c in range(4):
                x = 0
                while x < width:
                    count = int(buf[pos]); pos += 1
                    if count > 128:  # run
                        count -= 128
                        rgbe[y, x:x + count, c] = buf[pos]
                        pos += 1
                    else:            # literal
                        rgbe[y, x:x + count, c] = buf[pos:pos + count]
                        pos += count
                    x += count
        else:  # flat scanline
            flat = buf[pos:pos + width * 4].reshape(width, 4)
            rgbe[y] = flat
            pos += width * 4

    mantissa = rgbe[..., :3].astype(np.float32)
    exponent = rgbe[..., 3].astype(np.int32)
    scale = np.where(exponent == 0, 0.0,
                     np.ldexp(1.0, exponent - 136)).astype(np.float32)
    return mantissa * scale[..., None]
