"""Image I/O without third-party imaging packages: a PNG writer and an
8-bit PNG reader on the standard library (zlib + struct), and the Radiance
.hdr reader of the JAX package's utils/io.py."""

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
    """Load an image to float32 [H, W, 3]: an 8-bit PNG as uint8 / 255
    (the JAX package's PIL ``convert("RGB")``: grey replicated, a palette
    looked up, alpha dropped), a .hdr file as linear floats. Other formats
    (JPEG, ...), 16-bit and interlaced PNGs raise NotImplementedError."""
    if path.lower().endswith(".hdr"):
        return load_hdr(path)
    with open(path, "rb") as f:
        data = f.read()
    if not data.startswith(_PNG_MAGIC):
        raise NotImplementedError(
            f"{path}: only PNG and .hdr images are read (no JPEG or other "
            f"formats; see ROADMAP.md C)")
    return decode_png(data, path).astype(np.float32) / 255.0


_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"
# Colour type -> samples a pixel (grey, RGB, palette, grey + alpha, RGBA).
_PNG_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def decode_png(data: bytes, name: str = "<png>") -> np.ndarray:
    """Decode an 8-bit, non-interlaced PNG to uint8 [H, W, 3] RGB."""
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
            plte = np.frombuffer(body, np.uint8).reshape(-1, 3)
        elif tag == b"IDAT":
            idat.append(body)
        elif tag == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{name}: PNG without IHDR")
    w, h, depth, ctype, _, _, interlace = ihdr
    if depth != 8:
        raise NotImplementedError(f"{name}: {depth}-bit PNG (only 8-bit "
                                  f"samples are read)")
    if interlace:
        raise NotImplementedError(f"{name}: interlaced PNG (not read)")
    if ctype not in _PNG_CHANNELS:
        raise ValueError(f"{name}: PNG colour type {ctype}")
    bpp = _PNG_CHANNELS[ctype]
    stride = w * bpp
    raw = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    if raw.size < h * (stride + 1):
        raise ValueError(f"{name}: truncated PNG image data")
    raw = raw[:h * (stride + 1)].reshape(h, stride + 1)
    img = _unfilter(raw, h, stride, bpp, name).reshape(h, w, bpp)
    if ctype == 3:
        if plte is None:
            raise ValueError(f"{name}: palette PNG without PLTE")
        return plte[img[..., 0]]
    if ctype in (0, 4):
        return np.repeat(img[..., :1], 3, axis=2)
    return np.ascontiguousarray(img[..., :3])


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
