"""Image I/O without third-party imaging packages: a PNG writer on the
standard library (zlib + struct) and the Radiance .hdr reader of the JAX
package's utils/io.py."""

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
