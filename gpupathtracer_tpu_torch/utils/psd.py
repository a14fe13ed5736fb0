"""Photoshop (PSD) files, read as PIL's PsdImagePlugin reads them and then
``convert("RGB")``: the merged composite image, which PIL opens as frame 0.

- Raw and PackBits (RLE) channel data, PackBits by
  utils/codecs_cpp/codecs.cpp as Pillow's decoder runs it (a run past a
  row's end is cut there).
- Bitmap (1 bit: a set bit reads white, as PIL's mode 1), grey,
  duotone and multichannel at 8 bits (the first channel), indexed (the
  768-byte colour table, stored a channel at a time; without one every
  index reads black, as in PIL), RGB and CMYK
  (stored inverted, PIL's "C;I") at 8 bits; alpha and extra channels
  dropped. PIL takes the RLE byte counts of the channels it reads only,
  so a file with more channels than its mode needs reads its data from
  where PIL reads it.

What PIL refuses (a depth or mode it does not list, fewer channels than
the mode needs, truncated data) raises ValueError naming the file.
"""

from __future__ import annotations

import struct

import numpy as np

from gpupathtracer_tpu_torch.utils import codecs
from gpupathtracer_tpu_torch.utils.io import check_pixels, cmyk_to_rgb

# (Photoshop mode, bits) -> (PIL mode, channels read).
_MODES = {(0, 1): ("1", 1), (0, 8): ("L", 1), (1, 8): ("L", 1),
          (2, 8): ("P", 1), (3, 8): ("RGB", 3), (4, 8): ("CMYK", 4),
          (7, 8): ("L", 1), (8, 8): ("L", 1), (9, 8): ("LAB", 3)}


def _u32(data: bytes, pos: int, name: str) -> int:
    if pos + 4 > len(data):
        raise ValueError(f"{name}: truncated PSD file")
    return struct.unpack_from(">I", data, pos)[0]


def decode_psd(data: bytes, name: str = "<psd>") -> np.ndarray:
    """Decode a PSD's composite image to uint8 [H, W, 3] RGB, bit for bit
    PIL's ``convert("RGB")``."""
    nch, h, w, bits, pmode = struct.unpack_from(">HIIHH", data, 12)
    key = (pmode, bits)
    if key not in _MODES:
        raise ValueError(f"{name}: PSD of colour mode {pmode} at {bits} bits "
                         f"(PIL refuses it)")
    mode, channels = _MODES[key]
    if channels > nch:
        raise ValueError(f"{name}: PSD with too few channels")
    if mode == "RGB" and nch == 4:
        channels = 4                      # PIL's RGBA: the alpha is read
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: a PSD of {w}x{h} pixels")
    check_pixels(h, w, name)
    pos = 26
    size = _u32(data, pos, name)
    palette = data[pos + 4:pos + 4 + size] if mode == "P" and size == 768 \
        else None
    pos += 4 + size
    pos += 4 + _u32(data, pos, name)      # image resources
    pos += 4 + _u32(data, pos, name)      # layer and mask information
    if pos + 2 > len(data):
        raise ValueError(f"{name}: truncated PSD file")
    (compression,) = struct.unpack_from(">H", data, pos)
    pos += 2
    row_bytes = (w + 7) // 8 if mode == "1" else w
    planes = []
    if compression == 0:
        for c in range(channels):
            need = row_bytes * h
            if pos + need > len(data):
                raise ValueError(f"{name}: truncated PSD image data")
            planes.append(np.frombuffer(data, np.uint8, need, pos))
            pos += w * h
    elif compression == 1:
        counts = data[pos:pos + 2 * channels * h]
        pos += 2 * channels * h
        sizes = np.frombuffer(counts.ljust(2 * channels * h, b"\0"), ">u2")
        for c in range(channels):
            raw, used = codecs.packbits(data[pos:], h, row_bytes)
            if used < 0:
                raise ValueError(f"{name}: truncated PSD RLE data")
            planes.append(np.frombuffer(raw, np.uint8))
            pos += int(sizes[c * h:(c + 1) * h].sum())
    else:
        raise ValueError(f"{name}: PSD compression {compression} (PIL "
                         f"cannot load it)")
    planes = [p.reshape(h, row_bytes) for p in planes]
    if mode == "1":
        bit = np.unpackbits(planes[0], axis=1)[:, :w]
        return np.repeat((bit * 255).astype(np.uint8)[..., None], 3, axis=2)
    if mode == "L":
        return np.repeat(planes[0][..., None], 3, axis=2)
    if mode == "P":
        pal = np.zeros((256, 3), np.uint8)   # no table: black, as in PIL
        if palette is not None:
            pal = np.frombuffer(palette, np.uint8).reshape(3, 256).T
        return pal[planes[0]]
    if mode == "CMYK":
        return cmyk_to_rgb(255 - np.stack(planes[:4], -1))
    if mode == "LAB":
        from gpupathtracer_tpu_torch.utils.lab import lab_to_rgb
        # PIL's A and B raw modes flip the top bit of a and b.
        return lab_to_rgb(np.stack(planes[:3], -1) ^ np.array(
            [0, 128, 128], np.uint8))
    return np.stack(planes[:3], -1)
