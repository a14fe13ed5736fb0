"""Windows icons (PIL's IcoImagePlugin), decoded bit for bit as PIL's
``convert("RGB")`` reads them: the entry PIL loads, then its PNG frame
(utils/io.py decode_png) or its bitmap frame (utils/io.py _bitmap, the
bitmap's height halved), with the checks PIL's AND mask and alpha bytes
make of the file although convert("RGB") drops what they give."""

from __future__ import annotations

import struct
from math import ceil, log

import numpy as np

_PNG_MAGIC = b"\x89PNG\r\n\x1a\n"


def _entries(data: bytes) -> list:
    """IcoFile's directory: (bpp, size, offset, square, color_depth) an
    entry, sorted as PIL sorts it: stably by colour depth, then by width x
    height, largest first."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn
    if len(data) < 6:
        raise PassOn("ICO header cut short")
    (count,) = struct.unpack_from("<H", data, 4)
    out = []
    for i in range(count):
        s = data[6 + 16 * i:22 + 16 * i]
        if len(s) < 16:
            raise PassOn("ICO directory cut short")
        width, height, nb_color = s[0] or 256, s[1] or 256, s[2]
        bpp, size, offset = struct.unpack_from("<HII", s, 6)
        depth = bpp or (nb_color != 0 and ceil(log(nb_color, 2))) or 256
        out.append((bpp, size, offset, width * height, depth))
    out = sorted(out, key=lambda e: e[4])
    return sorted(out, key=lambda e: e[3], reverse=True)


def open_ico(data: bytes, pixels: bool = True):
    """IcoImageFile._open, which loads the first entry's frame: uint8 [H,
    W, 3] (``pixels`` False: None once every check that can pass the file
    on is made, what PIL's load of the frame would refuse left to the
    decode). Raises identify.PassOn where PIL passes the file on (a short
    directory, no entry, a frame of no pixels, a bitmap header cut short),
    identify.Refused where PIL stops, ValueError where the frame's data
    fails to load."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    from gpupathtracer_tpu_torch.utils.io import (MAX_IMAGE_PIXELS,
                                                  _bitmap, bitmap_header,
                                                  decode_png)
    entries = _entries(data)
    if not entries:
        raise PassOn("an icon without entries")
    bpp, size, offset, _, _ = entries[0]
    if data[offset:offset + 8] == _PNG_MAGIC:
        if data[offset + 12:offset + 16] == b"IHDR" and 0 in struct.unpack(
                ">II", data[offset + 16:offset + 24].ljust(8, b"\1")):
            raise PassOn("a PNG frame of no pixels")
        if not pixels:
            return None
        out = decode_png(data[offset:], "ICO frame")
        if out.shape[0] * out.shape[1] > 2 * MAX_IMAGE_PIXELS:
            raise Refused("decompression bomb")
        return out
    hd = bitmap_header(data, offset, 0)
    w, h = hd["w"], hd["h"]
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise Refused("decompression bomb")
    if not pixels:
        return None
    h = int(h / 2)
    if h <= 0:
        raise ValueError("a bitmap frame of one row (PIL: tile cannot "
                         "extend outside image)")
    if bpp == 32:
        # The alpha bytes: every fourth of 4 * w * h from the pixel offset.
        if len(data) - hd["offset"] < 4 * w * h:
            raise ValueError("alpha bytes cut short (PIL: buffer is not "
                             "large enough)")
    else:
        w32 = w + (-w % 32)
        total = w32 * h // 8
        at = offset + size - total
        if at < 0:
            raise ValueError("negative seek position of the AND mask")
        if len(data[at:at + total]) < (h - 1) * (w32 // 8) + (w + 7) // 8:
            raise ValueError("AND mask cut short (PIL: not enough image "
                             "data)")
    return _bitmap(data, offset, 0, "ICO frame", halve=True, mapped=False)


def decode_ico(data: bytes, name: str = "<ico>") -> np.ndarray:
    """Decode a Windows icon to uint8 [H, W, 3], bit for bit PIL's
    ``convert("RGB")``. PIL loads the first entry of its sorted directory
    (stably by colour depth, bpp or ceil(log2(colours)) or 256, then by
    width x height largest first, a 0 byte 256): a PNG frame as a PNG, any
    other frame as a DIB whose height is halved; its size is the frame's,
    whatever the entry says. The AND mask and a 32-bit frame's alpha only
    change alpha, which convert("RGB") drops, but PIL reads them, so a
    file cut short there fails. What PIL cannot read raises ValueError
    naming the file."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    try:
        return open_ico(data)
    except (PassOn, Refused, ValueError, IndexError, struct.error) as e:
        raise ValueError(f"{name}: PIL does not read this icon ({e})") from e
