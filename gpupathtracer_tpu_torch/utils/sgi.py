"""SGI images (PIL's SgiImagePlugin), decoded bit for bit as PIL's
``convert("RGB")`` reads them: raw 8-bit planes, raw 16-bit planes (PIL's
SGI16 decoder), and run-length rows at 8 and 16 bits (Pillow's
SgiRleDecode.c, in utils/codecs_cpp/codecs.cpp)."""

from __future__ import annotations

import struct

import numpy as np

from gpupathtracer_tpu_torch.utils import codecs

# (bytes a channel, dimension, channels) -> PIL's mode.
_MODES = {(1, 1, 1): "L", (1, 2, 1): "L", (2, 1, 1): "L", (2, 2, 1): "L",
          (1, 3, 3): "RGB", (2, 3, 3): "RGB", (1, 3, 4): "RGBA",
          (2, 3, 4): "RGBA"}


def sgi_header(data: bytes) -> dict:
    """SgiImageFile._open, then Image.open's checks: compression, bytes a
    channel, size and mode. Raises identify.PassOn where PIL passes the
    file on (a header cut short, no pixels), identify.Refused where it
    stops (a mode PIL does not list)."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    from gpupathtracer_tpu_torch.utils.io import MAX_IMAGE_PIXELS
    if len(data) < 12:
        raise PassOn("SGI header cut short")
    comp, bpc = data[2], data[3]
    dim, w, h, z = struct.unpack_from(">4H", data, 4)
    mode = _MODES.get((bpc, dim, z))
    if mode is None:
        raise Refused("Unsupported SGI image mode")
    if w <= 0 or h <= 0:
        raise PassOn("an image of no pixels")
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise Refused("decompression bomb")
    return dict(comp=comp, bpc=bpc, w=w, h=h, mode=mode)


def decode_sgi(data: bytes, name: str = "<sgi>") -> np.ndarray:
    """Decode an SGI file to uint8 [H, W, 3]: rows bottom up; raw files one
    plane a channel (8 bits, or 16 big-endian bits of which PIL keeps the
    high byte); run-length files through their start and length tables
    (16-bit samples: the high byte). Grey replicated, alpha dropped. What
    PIL cannot read (a mode it does not list, a compression other than 0
    and 1, data cut short, a table or run past the data) raises
    ValueError naming the file."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    try:
        hd = sgi_header(data)
    except (PassOn, Refused) as e:
        raise ValueError(f"{name}: PIL does not read this SGI file ({e})") \
            from e
    w, h, bpc, mode = hd["w"], hd["h"], hd["bpc"], hd["mode"]
    bands = len(mode)
    if hd["comp"] == 0:
        n = w * h * bpc
        if 512 + bands * n > len(data):
            raise ValueError(f"{name}: truncated SGI image data")
        planes = np.frombuffer(data, np.uint8, bands * n, 512).reshape(
            bands, h, w, bpc)[..., 0]
        px = planes.transpose(1, 2, 0)[::-1]
    elif hd["comp"] == 1:
        rows = codecs.sgi_rle(data[512:], w, h, bands, bpc, name)
        px = rows[..., ::bpc][::-1]
    else:
        raise ValueError(f"{name}: SGI compression {hd['comp']} (PIL cannot "
                         f"load it)")
    if bands == 1:
        return np.repeat(px, 3, axis=2)
    return np.ascontiguousarray(px[..., :3])
