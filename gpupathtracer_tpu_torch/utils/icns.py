"""Apple icon files (PIL's IcnsImagePlugin), decoded bit for bit as PIL's
``convert("RGB")`` reads them.

- The open (``probe``): IcnsFile's walk over the blocks (the last block of
  a type wins; a block size of 0 or less passes the file on) and
  ``bestsize``, the largest (width, height, scale) of the sizes whose
  elements are present.
- The load: every element PIL's table lists for that size, in its order:
  ``read_png_or_jpeg2000`` (a PNG from the element's start, through
  utils/io.py decode_png; a JPEG 2000 codestream or JP2 file of the
  element's bytes, through utils/jpeg2000.py, which PIL converts to
  RGBA), ``read_32`` / ``read_32t`` (24-bit RGB, raw or in PIL's
  run-length bands), ``read_mk`` (an 8-bit mask, which PIL reads and
  ``convert("RGB")`` drops). A PNG or JPEG 2000 element wins over the RGB
  one; its size must be one PIL allows (a size of the file at some
  integer scale).

What PIL cannot open or load raises ValueError naming the file. Nothing
here imports PIL or the JAX package.
"""

from __future__ import annotations

import struct

import numpy as np

_PNG = b"\x89PNG\x0d\x0a\x1a\x0a"

# IcnsFile.SIZES, in PIL's order.
SIZES = {
    (512, 512, 2): [(b"ic10", "png_jp2")],
    (512, 512, 1): [(b"ic09", "png_jp2")],
    (256, 256, 2): [(b"ic14", "png_jp2")],
    (256, 256, 1): [(b"ic08", "png_jp2")],
    (128, 128, 2): [(b"ic13", "png_jp2")],
    (128, 128, 1): [(b"ic07", "png_jp2"), (b"it32", "32t"), (b"t8mk", "mk")],
    (64, 64, 1): [(b"icp6", "png_jp2")],
    (32, 32, 2): [(b"ic12", "png_jp2")],
    (48, 48, 1): [(b"ih32", "32"), (b"h8mk", "mk")],
    (32, 32, 1): [(b"icp5", "png_jp2"), (b"il32", "32"), (b"l8mk", "mk")],
    (16, 16, 2): [(b"ic11", "png_jp2")],
    (16, 16, 1): [(b"icp4", "png_jp2"), (b"is32", "32"), (b"s8mk", "mk")],
}


def blocks(data: bytes) -> dict:
    """IcnsFile.__init__: type -> (start, length). Raises identify.PassOn
    where PIL passes the file on."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn
    if len(data) < 8:
        raise PassOn("icns header cut short")
    sig, filesize = struct.unpack_from(">4sI", data)
    if sig != b"icns":
        raise PassOn("not an icns file")
    dct, i = {}, 8
    while i < filesize:
        if i + 8 > len(data):
            raise PassOn("block header cut short")
        sig, size = struct.unpack_from(">4sI", data, i)
        if size <= 0:
            raise PassOn("invalid block header")
        dct[sig] = (i + 8, size - 8)
        i += size
    return dct


def sizes(dct: dict) -> list:
    return [size for size, fmts in SIZES.items()
            if any(code in dct for code, _ in fmts)]


def probe(data: bytes) -> bool:
    """IcnsImageFile._open: the blocks and a best size."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn
    if not sizes(blocks(data)):
        raise PassOn("No 32bit icon resources found")
    return True


def _allowed(avail: list, w: int, h: int) -> bool:
    """IcnsImageFile's size setter."""
    for s in avail:
        sw, sh = s[0] * s[2], s[1] * s[2]
        if w and h and sw // w == sh / h:
            return True
    return False


def _band(data: bytes, pos: int, n: int) -> tuple:
    """One band of read_32's run-length code from `pos`: (its bytes, the
    position after it, the count still missing). A byte of 0x80 or more
    repeats the next byte (it - 125) times, a smaller one copies the next
    (it + 1) bytes; a run that ends the file gives what there is."""
    parts, left = [], n
    while left > 0:
        if pos >= len(data):
            break
        b = data[pos]
        pos += 1
        if b & 0x80:
            k = b - 125
            parts.append(data[pos:pos + 1] * k)
            pos = min(pos + 1, len(data))
        else:
            k = b + 1
            parts.append(data[pos:pos + k])
            pos = min(pos + k, len(data))
        left -= k
    return b"".join(parts), pos, left


def _rle32(data: bytes, start: int, length: int, size: tuple,
           name: str) -> np.ndarray:
    """read_32: raw RGB when the length is exactly the pixels', else three
    run-length bands read on from the start (past the block if need be)."""
    w, h = size[0] * size[2], size[1] * size[2]
    n = w * h
    if length == n * 3:
        raw = data[start:start + length]
        if len(raw) < n * 3:
            raise ValueError(f"{name}: not enough image data in an icon")
        return np.frombuffer(raw, np.uint8, n * 3).reshape(h, w, 3)
    out = np.empty((3, n), np.uint8)
    pos = start
    for band in range(3):
        got, pos, left = _band(data, pos, n)
        if left != 0:
            raise ValueError(f"{name}: Error reading channel [{left} left]")
        if len(got) < n:
            raise ValueError(f"{name}: not enough image data in an icon")
        out[band] = np.frombuffer(got, np.uint8, n)
    return out.reshape(3, h, w).transpose(1, 2, 0)


def decode_icns(data: bytes, name: str = "<icns>") -> np.ndarray:
    """Decode an icns file to uint8 [H, W, 3], bit for bit PIL's
    ``convert("RGB")``; ValueError naming the file where PIL fails."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn
    from gpupathtracer_tpu_torch.utils.io import MAX_IMAGE_PIXELS, decode_png
    from gpupathtracer_tpu_torch.utils.jpeg2000 import JP2_MAGIC, \
        decode_jpeg2000
    try:
        dct = blocks(data)
    except PassOn as e:
        raise ValueError(f"{name}: PIL does not open this icon ({e})") from e
    avail = sizes(dct)
    if not avail:
        raise ValueError(f"{name}: No 32bit icon resources found")
    best = max(avail)
    rgba = rgb = None
    for code, kind in SIZES[best]:
        if code not in dct:
            continue
        start, length = dct[code]
        if kind == "png_jp2":
            sig = data[start:start + 12]
            if sig.startswith(_PNG):
                png = data[start:]
                if png[12:16] == b"IHDR":
                    pw, ph = struct.unpack_from(">II", png.ljust(24, b"\0"),
                                                16)
                    if pw * ph > 2 * MAX_IMAGE_PIXELS:
                        raise ValueError(f"{name}: decompression bomb")
                rgba = ("png", png)
            elif (sig.startswith((b"\xff\x4f\xff\x51", b"\x0d\x0a\x87\x0a"))
                  or sig == JP2_MAGIC):
                stream = data[start:start + length] if length >= 0 else \
                    data[start:]
                rgba = ("jp2", decode_jpeg2000(stream, name))
            else:
                raise ValueError(f"{name}: Unsupported icon subimage format")
        elif kind in ("32", "32t"):
            if kind == "32t":
                if data[start:start + 4] != b"\0\0\0\0":
                    raise ValueError(f"{name}: Unknown signature, expecting "
                                     f"0x00000000")
                start, length = start + 4, length - 4
            rgb = _rle32(data, start, length, best, name)
        else:
            n = best[0] * best[2] * best[1] * best[2]
            if len(data[start:start + n]) < n:
                raise ValueError(f"{name}: not enough image data in an "
                                 f"icon's mask")
    if rgba is not None:
        kind, got = rgba
        if kind == "png":
            got = decode_png(got, name)
        h, w = got.shape[:2]
        if not _allowed(avail, w, h):
            raise ValueError(f"{name}: This is not one of the allowed sizes "
                             f"of this image")
        return got
    if rgb is None:
        raise ValueError(f"{name}: an icon size without its RGB element")
    return np.ascontiguousarray(rgb)
