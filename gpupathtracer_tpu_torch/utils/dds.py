"""DirectDraw Surface (DDS) files, read as PIL's DdsImagePlugin reads them
and then ``convert("RGB")``: the first surface's first mip level, under
the plain header or the DX10 one.

- uncompressed: RGB by bit masks (each channel scaled to 8 bits as PIL's
  Python decoder scales it, a pixel at a time), 8-bit luminance, 16-bit
  luminance + alpha, 8-bit palette (1,024 bytes of RGBA entries), and
  DXGI R8G8B8A8;
- block-compressed, decoded by utils/codecs_cpp/codecs.cpp: BC1 (DXT1),
  BC2 (DXT3), BC3 (DXT5), BC4 (ATI1, BC4U), BC5 (ATI2, BC5U, BC5S), BC6H
  (UF16 and SF16, to 8 bits as PIL takes them) and BC7.

What PIL refuses (another header size, a FourCC or DXGI format it leaves
unimplemented, truncated block data) raises ValueError naming the file,
so the atlas builder skips the map as the JAX package's does.
"""

from __future__ import annotations

import struct

import numpy as np

from gpupathtracer_tpu_torch.utils import codecs
from gpupathtracer_tpu_torch.utils.io import check_pixels

# DDPF flags.
_ALPHAPIXELS, _FOURCC, _PALETTE8, _RGB, _LUMINANCE = (0x1, 0x4, 0x20, 0x40,
                                                      0x20000)


def _fourcc(s: bytes) -> int:
    return struct.unpack("<I", s)[0]


# FourCC -> codecs.bcn format.
_FOURCCS = {_fourcc(b"DXT1"): codecs.BC1, _fourcc(b"DXT3"): codecs.BC2,
            _fourcc(b"DXT5"): codecs.BC3, _fourcc(b"BC4U"): codecs.BC4,
            _fourcc(b"ATI1"): codecs.BC4, _fourcc(b"BC5S"): codecs.BC5S,
            _fourcc(b"BC5U"): codecs.BC5, _fourcc(b"ATI2"): codecs.BC5}
_DX10 = _fourcc(b"DX10")
# DXGI format -> codecs.bcn format (the typeless and UNORM formats PIL
# lists; R8G8B8A8 is read uncompressed).
_DXGI = {70: codecs.BC1, 71: codecs.BC1, 73: codecs.BC2, 74: codecs.BC2,
         76: codecs.BC3, 77: codecs.BC3, 79: codecs.BC4, 80: codecs.BC4,
         82: codecs.BC5, 83: codecs.BC5, 84: codecs.BC5S,
         95: codecs.BC6H, 96: codecs.BC6HS, 97: codecs.BC7, 98: codecs.BC7,
         99: codecs.BC7}
_R8G8B8A8 = (27, 28, 29)


def decode_dds(data: bytes, name: str = "<dds>") -> np.ndarray:
    """Decode a DDS file's bytes to uint8 [H, W, 3] RGB, bit for bit PIL's
    ``convert("RGB")``."""
    if len(data) < 8:
        raise ValueError(f"{name}: truncated DDS header")
    (hsize,) = struct.unpack("<I", data[4:8])
    if hsize != 124:
        raise ValueError(f"{name}: DDS header size {hsize} (PIL refuses it)")
    header = data[8:128]
    if len(header) != 120:
        raise ValueError(f"{name}: incomplete DDS header")
    _, h, w = struct.unpack("<3I", header[:12])
    check_pixels(h, w, name)
    pfflags, fourcc, bitcount = struct.unpack("<3I", header[72:84])
    pos = 128
    if pfflags & _RGB:
        count = 4 if pfflags & _ALPHAPIXELS else 3
        masks = struct.unpack(f"<{count}I", header[84:84 + 4 * count])
        return _masked(data, pos, w, h, bitcount, masks[:3])
    if pfflags & _LUMINANCE:
        if bitcount == 8:
            return _grey(_raw(data, pos, h * w, name).reshape(h, w))
        if bitcount == 16 and pfflags & _ALPHAPIXELS:
            px = _raw(data, pos, 2 * h * w, name).reshape(h, w, 2)
            return _grey(px[..., 0])
        raise ValueError(f"{name}: DDS luminance of {bitcount} bits (PIL "
                         f"refuses it)")
    if pfflags & _PALETTE8:
        pal = np.zeros((256, 3), np.uint8)
        entries = np.frombuffer(data[pos:pos + 1024], np.uint8)
        entries = entries[:len(entries) // 4 * 4].reshape(-1, 4)
        pal[:len(entries)] = entries[:, :3]
        return pal[_raw(data, pos + 1024, h * w, name).reshape(h, w)]
    if not pfflags & _FOURCC:
        raise ValueError(f"{name}: DDS pixel format flags {pfflags:#x} (PIL "
                         f"refuses them)")
    if fourcc == _DX10:
        (dxgi,) = struct.unpack("<I", data[128:132].ljust(4, b"\0"))
        pos = 148
        if dxgi in _R8G8B8A8:
            px = _raw(data, pos, 4 * h * w, name).reshape(h, w, 4)
            return np.ascontiguousarray(px[..., :3])
        fmt = _DXGI.get(dxgi)
        if fmt is None:
            raise ValueError(f"{name}: DXGI format {dxgi} (PIL leaves it "
                             f"unimplemented)")
    else:
        fmt = _FOURCCS.get(fourcc)
        if fmt is None:
            code = struct.pack("<I", fourcc)
            raise ValueError(f"{name}: DDS FourCC {code!r} (PIL leaves it "
                             f"unimplemented)")
    return codecs.bcn(data[pos:], w, h, fmt, name)


def _raw(data: bytes, pos: int, n: int, name: str) -> np.ndarray:
    if pos + n > len(data):
        raise ValueError(f"{name}: truncated DDS image data")
    return np.frombuffer(data, np.uint8, n, pos)


def _grey(g: np.ndarray) -> np.ndarray:
    return np.repeat(g[..., None], 3, axis=2)


def _masked(data: bytes, pos: int, w: int, h: int, bitcount: int,
            masks) -> np.ndarray:
    """PIL's DdsRgbDecoder: a pixel is ``bitcount // 8`` little-endian
    bytes (zeros past the end of the file); each channel is
    int((v >> shift) / (mask >> shift) * 255) in double precision, its
    low byte kept."""
    nb = bitcount // 8
    n = w * h
    raw = np.frombuffer(data[pos:pos + n * nb].ljust(n * nb, b"\0"),
                        np.uint8).reshape(n, nb) if nb else np.zeros(
                            (n, 0), np.uint8)
    value = np.zeros(n, np.uint64)
    for k in range(min(nb, 4)):     # the masks are 32 bits
        value |= raw[:, k].astype(np.uint64) << np.uint64(8 * k)
    out = np.zeros((n, 3), np.uint8)
    for c, mask in enumerate(masks):
        if not mask:
            continue
        shift = (mask & -mask).bit_length() - 1
        total = mask >> shift
        v = (value & np.uint64(mask)) >> np.uint64(shift)
        scaled = np.floor(v.astype(np.float64) / total * 255).astype(np.int64)
        out[:, c] = (scaled & 255).astype(np.uint8)
    return out.reshape(h, w, 3)
