"""Image I/O without third-party imaging packages: a PNG writer, readers
for PNG, JPEG (utils/jpeg.py, a native decoder), TGA and BMP that give
what the JAX package gets from PIL bit for bit, and the Radiance .hdr
reader of the JAX package's utils/io.py."""

from __future__ import annotations

import os
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
    ``Image.open(path).convert("RGB")`` / 255 reads it, bit for bit: PNG
    (every colour type, bit depth and interlace), JPEG (baseline and
    progressive Huffman, utils/jpeg.py), TGA and BMP; a .hdr file (by its
    name, as the JAX package) as linear floats. The format is told by the
    file's first bytes, as PIL tells it; other formats (GIF, TIFF, WebP,
    DDS, PSD, EXR, ...) and the JPEG variants the decoder does not read
    raise NotImplementedError naming the file (ROADMAP.md C6); corrupt
    files raise ValueError."""
    if path.lower().endswith(".hdr"):
        return load_hdr(path)
    with open(path, "rb") as f:
        data = f.read()
    return decode_image(data, path).astype(np.float32) / 255.0


def decode_image(data: bytes, name: str = "<image>") -> np.ndarray:
    """Decode an image file's bytes to uint8 [H, W, 3] RGB by its magic
    bytes (load_image's formats)."""
    if data.startswith(_PNG_MAGIC):
        return decode_png(data, name)
    if data.startswith(b"\xff\xd8\xff"):
        from gpupathtracer_tpu_torch.utils.jpeg import decode_jpeg
        return decode_jpeg(data, name)
    if data.startswith(b"BM") and len(data) >= 26:
        return decode_bmp(data, name)
    if data[:4] == b"RIFF" and data[8:12] == b"WEBP":
        raise NotImplementedError(
            f"{name}: a WebP image (not read: ROADMAP.md C6)")
    for magic, fmt in _UNREAD:
        if data.startswith(magic):
            raise NotImplementedError(
                f"{name}: a {fmt} image (not read: ROADMAP.md C6)")
    if _looks_like_tga(data):
        return decode_tga(data, name)
    raise NotImplementedError(
        f"{name}: an image format the port does not read (first bytes "
        f"{data[:8]!r}; ROADMAP.md C6)")


# Magic bytes of formats the port does not read (ROADMAP.md C6).
_UNREAD = ((b"GIF87a", "GIF"), (b"GIF89a", "GIF"), (b"II*\x00", "TIFF"),
           (b"MM\x00*", "TIFF"), (b"DDS ", "DDS"), (b"8BPS", "PSD"),
           (b"\x76\x2f\x31\x01", "OpenEXR"))

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
    """Decode a PNG to uint8 [H, W, 3] RGB, bit for bit PIL's
    ``convert("RGB")``: grey replicated (1-, 2- and 4-bit grey scaled by
    255 / (2^d - 1)), palette indices looked up (an index past the palette
    reads black), alpha and tRNS dropped; 16-bit RGB, RGBA and grey +
    alpha keep each sample's high byte, 16-bit grey (PIL's mode I;16) is
    clipped at 255. Adam7-interlaced files are read pass by pass."""
    pos, idat, plte = 8, [], None
    ihdr = None
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif tag == b"PLTE":
            plte = np.frombuffer(body[:len(body) // 3 * 3],
                                 np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    check_pixels(h, w, name)
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype}")
    if depth not in _PNG_DEPTHS[ctype]:
        raise ValueError(f"{name}: PNG bit depth {depth} for colour type "
                         f"{ctype}")
    if interlace not in (0, 1):
        raise ValueError(f"{name}: PNG interlace method {interlace}")
    if ctype == 3 and plte is None:
        raise ValueError(f"{name}: palette PNG without PLTE")
    ch = _PNG_CHANNELS[ctype]
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    passes = _ADAM7 if interlace else ((0, 0, 1, 1),)
    samples = np.zeros((h, w, ch), np.uint16 if depth == 16 else np.uint8)
    off = 0
    for x0, y0, dx, dy in passes:
        pw, ph = -(-(w - x0) // dx), -(-(h - y0) // dy)
        if pw <= 0 or ph <= 0:
            continue            # an empty pass has no rows at all
        stride = -(-pw * ch * depth // 8)
        size = ph * (stride + 1)
        if off + size > raw.size:
            raise ValueError(f"{name}: truncated PNG image data")
        rows = raw[off:off + size].reshape(ph, stride + 1)
        off += size
        bpp = max(1, ch * depth // 8)
        sub = _samples(_unfilter(rows, ph, stride, bpp, name), pw, ch, depth)
        samples[y0::dy, x0::dx] = sub
    return _to_rgb(samples, ctype, depth, plte)


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

def _looks_like_tga(data: bytes) -> bool:
    """PIL's TGA header checks (TGA has no magic bytes)."""
    if len(data) < 18:
        return False
    w, h = struct.unpack("<HH", data[12:16])
    return (data[1] in (0, 1) and data[2] in (1, 2, 3, 9, 10, 11)
            and w > 0 and h > 0 and data[16] in (1, 8, 16, 24, 32))


def decode_tga(data: bytes, name: str = "<tga>") -> np.ndarray:
    """Decode a TGA to uint8 [H, W, 3], bit for bit PIL's convert("RGB"):
    types 1 and 9 (colour-mapped, 8-bit indices, 24-bit map entries), 2
    and 10 (BGR at 24 bits, BGRA at 32), 3 and 11 (grey at 8
    bits, grey + alpha at 16), raw or run-length encoded, rows bottom-up
    unless the origin bit (0x20) is set, mirrored when bit 0x10 is."""
    id_len, cmap_type, itype = data[0], data[1], data[2]
    cm_start, cm_len, cm_depth = struct.unpack("<HHB", data[3:8])
    w, h, depth, flags = struct.unpack("<HHBB", data[12:18])
    check_pixels(h, w, name)
    kind = itype & 7
    bpp = {(1, 8): 1, (2, 24): 3, (2, 32): 4, (3, 8): 1, (3, 16): 2}.get(
        (kind, depth))
    if bpp is None:
        raise NotImplementedError(
            f"{name}: TGA image type {itype} at {depth} bits (not read: "
            f"ROADMAP.md C6)")
    pos = 18 + id_len
    pal = None
    if cmap_type:
        entry = {15: 2, 16: 2, 24: 3, 32: 4}.get(cm_depth)
        if entry is None:
            raise ValueError(f"{name}: TGA colour map depth {cm_depth}")
        if entry == 2 and kind == 1:
            raise NotImplementedError(
                f"{name}: TGA colour map of {cm_depth}-bit entries (not "
                f"read: ROADMAP.md C6)")
        if entry == 4 and kind == 1:
            raise ValueError(f"{name}: TGA colour map of 32-bit entries "
                             f"(PIL refuses it too)")
        table = data[pos:pos + entry * cm_len]
        pos += entry * cm_len
        if entry == 3:
            # PIL's palette: `start` black entries, then BGR(A) entries,
            # black past its end.
            pal = np.zeros((256, 3), np.uint8)
            bgr = np.frombuffer(table[:len(table) // entry * entry],
                                np.uint8).reshape(-1, entry)[:, 2::-1]
            pal[cm_start:cm_start + len(bgr)] = bgr[:256 - cm_start]
    n = w * h * bpp
    if itype & 8:
        px, pos = _tga_rle(data, pos, w * h, bpp, name)
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
        return np.repeat(px[..., :1], 3, axis=2)
    return np.ascontiguousarray(px[..., 2::-1])


def _tga_rle(data: bytes, pos: int, count: int, bpp: int, name: str):
    """TGA run-length packets (runs may cross rows) -> count pixels."""
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
            out += data[pos:pos + bpp] * k
            pos += bpp
        else:
            out += data[pos:pos + k * bpp]
            pos += k * bpp
        if pos > n:
            raise ValueError(f"{name}: truncated TGA run-length data")
    return np.frombuffer(bytes(out[:want]), np.uint8), pos


def decode_bmp(data: bytes, name: str = "<bmp>") -> np.ndarray:
    """Decode a BMP to uint8 [H, W, 3], bit for bit PIL's convert("RGB"):
    uncompressed (BI_RGB) 24- and 32-bit BGR(X) and 1-, 4- and 8-bit
    palette images (an index past the palette reads black), rows
    bottom-up unless the height is negative; BITMAPINFOHEADER and its V2-V5
    extensions."""
    (offset,) = struct.unpack("<I", data[10:14])
    (hsize,) = struct.unpack("<I", data[14:18])
    if hsize in (40, 52, 56, 64, 108, 124):
        w, h, _, bits, comp = struct.unpack("<iiHHI", data[18:34])
        (colors,) = struct.unpack("<I", data[46:50])
    else:
        raise NotImplementedError(
            f"{name}: BMP header of {hsize} bytes (not read: ROADMAP.md C6)")
    if comp != 0 or bits not in (1, 4, 8, 24, 32):
        raise NotImplementedError(
            f"{name}: BMP of {bits} bits, compression {comp} (only "
            f"uncompressed 1-, 4-, 8-, 24- and 32-bit files are read: "
            f"ROADMAP.md C6)")
    top_down = h < 0
    h = abs(h)
    if w <= 0 or h == 0:
        raise ValueError(f"{name}: BMP of {w}x{h} pixels")
    check_pixels(h, w, name)
    stride = ((w * bits + 31) >> 3) & ~3
    if offset + stride * h > len(data):
        raise ValueError(f"{name}: truncated BMP image data")
    rows = np.frombuffer(data, np.uint8, stride * h, offset).reshape(h,
                                                                     stride)
    if not top_down:
        rows = rows[::-1]
    if bits >= 24:
        px = rows[:, :w * bits // 8].reshape(h, w, bits // 8)
        return np.ascontiguousarray(px[..., 2::-1])
    colors = colors or (1 << bits)
    table = data[14 + hsize:14 + hsize + 4 * colors]
    pal = np.zeros((256, 3), np.uint8)
    bgr = np.frombuffer(table[:len(table) // 4 * 4],
                        np.uint8).reshape(-1, 4)[:256, 2::-1]
    pal[:len(bgr)] = bgr
    return pal[_samples(rows, w, 1, bits)[..., 0]]


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
