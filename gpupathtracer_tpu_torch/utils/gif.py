"""GIF files, read as PIL's GifImagePlugin reads them and then
``convert("RGB")``: the first frame only.

- The screen's size, grown to hold the frame where the frame passes it.
- The global colour table, or the frame's local one; a table that is the
  identity grey ramp is dropped (PIL's mode L: the indices are the grey
  levels). An index past the table reads black.
- Outside the frame: index 0, or the graphic control extension's
  transparency index where it has one (PIL fills the frame's image with
  it); the transparency itself is ignored by ``convert("RGB")``.
- The frame's LZW data (utils/codecs_cpp/codecs.cpp, as Pillow's
  GifDecode.c) in rows or in the four interlace passes; data that ends
  before the frame is full, or a corrupt code, raises ValueError naming
  the file, as PIL fails on it.
"""

from __future__ import annotations

import struct

import numpy as np

from gpupathtracer_tpu_torch.utils import codecs
from gpupathtracer_tpu_torch.utils.io import check_pixels


def _palette(p: bytes):
    """PIL keeps a colour table unless it is the identity grey ramp."""
    for i in range(0, len(p) - 2, 3):
        if not (i // 3 == p[i] == p[i + 1] == p[i + 2]):
            return p
    return None


def _sub_block(data: bytes, pos: int):
    """GifImageFile.data(): (the block or None, the next position)."""
    if pos < len(data) and data[pos]:
        n = data[pos]
        return data[pos + 1:pos + 1 + n], pos + 1 + n
    return None, pos + 1


def decode_gif(data: bytes, name: str = "<gif>") -> np.ndarray:
    """Decode a GIF's first frame to uint8 [H, W, 3] RGB, bit for bit
    PIL's ``convert("RGB")``."""
    if len(data) < 13:
        raise ValueError(f"{name}: truncated GIF header")
    w, h = struct.unpack_from("<HH", data, 6)
    flags = data[10]
    pos = 13
    palette = None
    if flags & 128:
        n = 3 << ((flags & 7) + 1)
        palette = _palette(data[pos:pos + n])
        pos += n
    transparency = None
    frame = None
    if pos >= len(data) or data[pos] == 0x3B:
        raise ValueError(f"{name}: a GIF without an image")
    while pos < len(data):
        s = data[pos]
        pos += 1
        if s == 0x3B:                           # trailer
            break
        if s == 0x21:                           # an extension
            if pos >= len(data):
                raise ValueError(f"{name}: truncated GIF extension")
            label = data[pos]
            block, pos = _sub_block(data, pos + 1)
            if label == 249 and block is not None:
                if block[0] & 1:
                    if len(block) < 4:
                        raise ValueError(f"{name}: short GIF graphic "
                                         f"control extension")
                    transparency = block[3]
            elif label == 254:
                while block:
                    block, pos = _sub_block(data, pos)
                continue
            elif label == 255 and block is not None:
                if block.startswith(b"NETSCAPE2.0"):
                    _, pos = _sub_block(data, pos)
            while True:
                block, pos = _sub_block(data, pos)
                if not block:
                    break
        elif s == 0x2C:                         # the image descriptor
            desc = data[pos:pos + 9]
            if len(desc) < 9:
                raise ValueError(f"{name}: truncated GIF image descriptor")
            pos += 9
            x0, y0, fw, fh = struct.unpack("<4H", desc[:8])
            w, h = max(w, x0 + fw), max(h, y0 + fh)
            if desc[8] & 128:
                n = 3 << ((desc[8] & 7) + 1)
                palette = _palette(data[pos:pos + n])
                pos += n
            if pos >= len(data):
                raise ValueError(f"{name}: truncated GIF image data")
            frame = (x0, y0, fw, fh, bool(desc[8] & 64), data[pos])
            pos += 1
            break
    if frame is None:
        raise ValueError(f"{name}: a GIF without an image")
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: a GIF of {w}x{h} pixels")
    check_pixels(h, w, name)
    x0, y0, fw, fh, interlace, bits = frame
    index = np.full((h, w), transparency or 0, np.uint8)
    rc = codecs.gif_lzw(data[pos:], bits, index, x0, y0, fw, fh, interlace)
    if rc == 1:
        raise ValueError(f"{name}: GIF image data ends before the frame is "
                         f"full (PIL: image file is truncated)")
    if rc:
        raise ValueError(f"{name}: corrupt GIF image data")
    if palette is None:
        return np.repeat(index[..., None], 3, axis=2)
    pal = np.zeros((256, 3), np.uint8)
    entries = np.frombuffer(palette[:len(palette) // 3 * 3],
                            np.uint8).reshape(-1, 3)
    pal[:len(entries)] = entries[:256]
    return pal[index]
