"""JPEG 2000 files (a bare J2K codestream or a JP2 file), read as Pillow
12.1.0's Jpeg2KImagePlugin reads them through OpenJPEG 2.5.4 and then
``convert("RGB")``.

- PIL's open (``probe``): the codestream's SIZ (``_parse_codestream``) or
  the JP2 boxes up to ``jp2h`` and in it ``ihdr``, ``colr``, ``pclr`` and
  ``res `` (``_parse_jp2_header``), then the walk to a COM marker: the
  mode (L, I;16, LA, RGB, RGBA, CMYK from ``colr`` enumcs 12, P / PA from
  ``pclr``), the size and the palette, with the errors that pass the file
  on to the next plugin and those that stop PIL.
- OpenJPEG's JP2 reader (``_jp2_open``, ``_jp2_walk``): the signature
  and file type boxes, ``jp2h`` with ``ihdr``, ``colr``, ``bpcc``,
  ``pclr``, ``cmap`` and ``cdef`` checked as opj_jp2_read_* checks them,
  the colour space from enumcs, ``jp2c``, and after the codestream the
  boxes that follow.
  OpenJPEG applies neither ``pclr`` nor ``cdef`` on Pillow's tile path:
  the samples come as they are, and a P image takes PIL's palette.
- The codestream and Pillow's unpackers: utils/j2k_cpp/j2k.cpp (built
  with g++ at first use, utils/native.py), HTJ2K code-blocks with
  OpenJPEG's VLC tables from ht_vlc.bin, and the Part 2 component
  transform markers (MCT, MCC, MCO, CBD) as OpenJPEG reads them.

Bytes PIL cannot open or load raise ValueError naming the file.
Nothing here imports PIL or the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional

import numpy as np

from gpupathtracer_tpu_torch.utils import native

_SRC = os.path.join(os.path.dirname(__file__), "j2k_cpp", "j2k.cpp")
_lib: Optional[ctypes.CDLL] = None

J2K_MAGIC = b"\xff\x4f\xff\x51"
JP2_MAGIC = b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"

# OpenJPEG's colour spaces (opj_image_t.color_space).
_UNKNOWN, _UNSPECIFIED, _SRGB, _GRAY, _SYCC, _EYCC, _CMYK = (-1, 0, 1, 2,
                                                             3, 4, 5)
_ENUMCS = {16: _SRGB, 17: _GRAY, 18: _SYCC, 24: _EYCC, 12: _CMYK}

# Jpeg2KDecode.c's unpackers, for the modes PIL opens a JPEG 2000 file in:
# (mode, colour space, components, takes subsampled components, unpacker).
_GRAY_L, _GRAY_I, _GRAYA_LA, _GRAY_RGB = 1, 2, 3, 4
_SRGB_RGB, _SYCC_RGB, _SRGBA_RGBA, _SYCCA_RGBA = 5, 6, 7, 8
_UNPACKERS = (
    ("L", _GRAY, 1, False, _GRAY_L), ("P", _SRGB, 1, False, _GRAY_L),
    ("PA", _SRGB, 2, False, _GRAYA_LA), ("I;16", _GRAY, 1, False, _GRAY_I),
    ("LA", _GRAY, 2, False, _GRAYA_LA),
    ("RGB", _GRAY, 1, False, _GRAY_RGB), ("RGB", _GRAY, 2, False, _GRAY_RGB),
    ("RGB", _SRGB, 3, True, _SRGB_RGB), ("RGB", _SYCC, 3, True, _SYCC_RGB),
    ("RGB", _SRGB, 4, True, _SRGB_RGB), ("RGB", _SYCC, 4, True, _SYCC_RGB),
    ("RGBA", _GRAY, 1, False, _GRAY_RGB),
    ("RGBA", _GRAY, 2, False, _GRAYA_LA),
    ("RGBA", _SRGB, 3, True, _SRGB_RGB), ("RGBA", _SYCC, 3, True, _SYCC_RGB),
    ("RGBA", _GRAY, 4, True, _SRGBA_RGBA),
    ("RGBA", _SRGB, 4, True, _SRGBA_RGBA),
    ("RGBA", _SYCC, 4, True, _SYCCA_RGBA),
    ("CMYK", _CMYK, 4, True, _SRGBA_RGBA),
)
_PIXEL = {"L": 1, "P": 1, "I;16": 2}


def ycbcr_tables() -> np.ndarray:
    """Pillow's ConvertYCbCr.c YCbCr -> RGB tables (R_Cr, G_Cb, G_Cr,
    B_Cb; int16 [4, 256], at its scale of 2^6), as ycbcr_rgb.bin holds
    them (tools/torch_image_fixtures.py --ycbcr-table derives them from
    PIL's conversion of every Y, Cb, Cr)."""
    return np.fromfile(os.path.join(os.path.dirname(__file__),
                                    "ycbcr_rgb.bin"), "<i2").reshape(4, 256)


def ht_vlc_tables() -> np.ndarray:
    """OpenJPEG's HTJ2K VLC tables (vlc_tbl0 for the first quad row,
    vlc_tbl1 for the others; uint16 [2, 1024], each entry rho << 4 |
    u_off << 3 | e_k << 12 | e_1 << 8 | codeword length), as ht_vlc.bin
    holds them (tools/torch_image_fixtures.py --ht-vlc-table reads them
    out of Pillow's OpenJPEG and checks that each is a prefix code)."""
    return np.fromfile(os.path.join(os.path.dirname(__file__),
                                    "ht_vlc.bin"), "<u2").reshape(2, 1024)


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native.load(_SRC, "j2k")
        p, i64, u32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_uint32
        lib.gpt_j2k_set_ycbcr.restype = None
        lib.gpt_j2k_set_ycbcr.argtypes = [p]
        lib.gpt_j2k_set_ht_tables.restype = None
        lib.gpt_j2k_set_ht_tables.argtypes = [p]
        lib.gpt_j2k_info.restype = ctypes.c_int
        lib.gpt_j2k_info.argtypes = [ctypes.c_char_p, i64, i64, u32, u32, p,
                                     ctypes.c_int, ctypes.c_char_p, i64]
        lib.gpt_j2k_decode.restype = ctypes.c_int
        lib.gpt_j2k_decode.argtypes = [ctypes.c_char_p, i64, i64, u32, u32,
                                       ctypes.c_int, p, u32, u32, u32, p,
                                       ctypes.c_char_p, i64]
        tables = np.ascontiguousarray(ycbcr_tables(), np.int16)
        lib.gpt_j2k_set_ycbcr(tables.ctypes.data)
        vlc = np.ascontiguousarray(ht_vlc_tables(), np.uint16)
        lib.gpt_j2k_set_ht_tables(vlc.ctypes.data)
        _lib = lib
    return _lib


# --- PIL's open --------------------------------------------------------------

class _Syntax(Exception):
    """PIL's _open raised SyntaxError (or IndexError / struct.error): the
    file passes on to the next plugin."""


class _Stop(Exception):
    """PIL's _open raised an error Image.open lets through: PIL fails."""


class _File:
    """A file object over the bytes: read, seek and tell as Python's."""

    def __init__(self, data: bytes, pos: int = 0):
        self.d, self.pos = data, pos

    def read(self, n: int = -1) -> bytes:
        if n < 0:
            n = max(len(self.d) - self.pos, 0)
        out = self.d[self.pos:self.pos + n]
        self.pos += len(out)
        return out

    def seek(self, off: int, whence: int = 0) -> None:
        pos = off if whence == 0 else self.pos + off
        if pos < 0:
            raise _Stop("negative seek position")
        self.pos = pos

    def tell(self) -> int:
        return self.pos


class _Boxes:
    """Jpeg2KImagePlugin.BoxReader."""

    def __init__(self, fp: _File, length: int = -1):
        self.fp, self.length = fp, length
        self.has_length = length >= 0
        self.remaining = -1

    def _can_read(self, n: int) -> bool:
        if self.has_length and self.fp.tell() + n > self.length:
            return False
        if self.remaining >= 0:
            return n <= self.remaining
        return True

    def read_bytes(self, n: int) -> bytes:
        if not self._can_read(n):
            raise _Syntax("Not enough data in header")
        data = self.fp.read(n)
        if len(data) < n:
            raise _Stop(f"Expected to read {n} bytes but only got "
                        f"{len(data)}.")
        if self.remaining > 0:
            self.remaining -= n
        return data

    def fields(self, fmt: str) -> tuple:
        return struct.unpack(fmt, self.read_bytes(struct.calcsize(fmt)))

    def sub(self) -> "_Boxes":
        size = self.remaining
        return _Boxes(_File(self.read_bytes(size)), size)

    def has_next(self) -> bool:
        if self.has_length:
            return self.fp.tell() + self.remaining < self.length
        return True

    def next_type(self) -> bytes:
        if self.remaining > 0:
            self.fp.seek(self.remaining, 1)
        self.remaining = -1
        lbox, tbox = self.fields(">I4s")
        if lbox == 1:
            lbox = self.fields(">Q")[0]
            hlen = 16
        else:
            hlen = 8
        if lbox < hlen or not self._can_read(lbox - hlen):
            raise _Syntax("Invalid header length")
        self.remaining = lbox - hlen
        return tbox


def _palette(entries: list, npc: int) -> tuple:
    """ImagePalette.getcolor over the pclr entries: (mode, palette
    bytes)."""
    mode = "RGBA" if npc == 4 else "RGB"
    colors, pal = {}, bytearray()
    for color in entries:
        if mode == "RGB" and len(color) == 4 and color[3] != 255:
            raise _Stop("cannot add non-opaque RGBA color to RGB palette")
        if mode == "RGB" and len(color) == 4:
            color = color[:3]
        elif mode == "RGBA" and len(color) == 3:
            color += (255,)
        if color in colors:
            continue
        index = len(pal) // len(mode)
        if index >= 256:
            raise _Stop("cannot allocate more than 256 colors")
        colors[color] = index
        pal += bytes(color)
    return mode, bytes(pal)


def _codestream_mode(fp: _File) -> tuple:
    """_parse_codestream."""
    hdr = fp.read(2)
    if len(hdr) < 2:
        raise _Syntax("struct.error")
    lsiz = struct.unpack(">H", hdr)[0]
    siz = hdr + fp.read(lsiz - 2)
    if len(siz) < 38:
        raise _Syntax("struct.error")
    f = struct.unpack_from(">HHIIIIIIIIH", siz)
    xsiz, ysiz, xosiz, yosiz, csiz = f[2], f[3], f[4], f[5], f[10]
    size = (xsiz - xosiz, ysiz - yosiz)
    if csiz == 1:
        if len(siz) < 39:
            raise _Syntax("struct.error")
        mode = "I;16" if (siz[38] & 0x7F) + 1 > 8 else "L"
    elif csiz in (2, 3, 4):
        mode = {2: "LA", 3: "RGB", 4: "RGBA"}[csiz]
    else:
        raise _Syntax("unable to determine J2K image mode")
    return size, mode


def _jp2_mode(fp: _File) -> tuple:
    """_parse_jp2_header: (size, mode, palette or None)."""
    reader = _Boxes(fp)
    header = None
    while reader.has_next():
        tbox = reader.next_type()
        if tbox == b"jp2h":
            header = reader.sub()
            break
        if tbox == b"ftyp":
            reader.fields(">4s")
    size = mode = nc = None
    palette = None
    while header.has_next():
        tbox = header.next_type()
        if tbox == b"ihdr":
            height, width, nc, bpc = header.fields(">IIHB")
            size = (width, height)
            if nc == 1 and (bpc & 0x7F) > 8:
                mode = "I;16"
            elif nc == 1:
                mode = "L"
            elif nc == 2:
                mode = "LA"
            elif nc == 3:
                mode = "RGB"
            elif nc == 4:
                mode = "RGBA"
        elif tbox == b"colr" and nc == 4:
            meth, _, _, enumcs = header.fields(">BBBI")
            if meth == 1 and enumcs == 12:
                mode = "CMYK"
        elif tbox == b"pclr" and mode in ("L", "LA"):
            ne, npc = header.fields(">HB")
            depths = header.fields(">" + "B" * npc)
            if max(depths, default=0) <= 8:
                entries = [header.fields(">" + "B" * npc)
                           for _ in range(ne)]
                palette = _palette(entries, npc)
                mode = "P" if mode == "L" else "PA"
        elif tbox == b"res ":
            res = header.sub()
            while res.has_next():
                if res.next_type() == b"resc":
                    res.fields(">HHHHBB")
                    break
    if size is None or mode is None:
        raise _Syntax("Malformed JP2 header")
    return size, mode, palette


def _skip_comment(fp: _File) -> None:
    """_parse_comment's walk over the markers after SIZ."""
    while True:
        marker = fp.read(2)
        if not marker:
            break
        if len(marker) < 2:
            raise _Syntax("IndexError")
        if marker[1] in (0x90, 0xD9):
            break
        hdr = fp.read(2)
        if len(hdr) < 2:
            raise _Syntax("struct.error")
        length = struct.unpack(">H", hdr)[0]
        if marker[1] == 0x64:
            fp.read(length - 2)
            break
        fp.seek(length - 2, 1)


def pil_open(data: bytes) -> tuple:
    """Jpeg2KImageFile._open and Image.open's checks: (codec, size, mode,
    palette). Raises identify.PassOn where PIL passes the file on,
    identify.Refused where PIL stops."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    from gpupathtracer_tpu_torch.utils.io import MAX_IMAGE_PIXELS
    fp = _File(data)
    palette = None
    try:
        sig = fp.read(4)
        if sig == J2K_MAGIC:
            codec = "j2k"
            size, mode = _codestream_mode(fp)
            _skip_comment(fp)
        else:
            sig += fp.read(8)
            if sig != JP2_MAGIC:
                raise _Syntax("not a JPEG 2000 file")
            codec = "jp2"
            size, mode, palette = _jp2_mode(fp)
            if fp.read(12).endswith(b"jp2c\xff\x4f\xff\x51"):
                hdr = fp.read(2)
                if len(hdr) < 2:
                    raise _Syntax("struct.error")
                fp.seek(struct.unpack(">H", hdr)[0] - 2, 1)
                _skip_comment(fp)
    except _Syntax as e:
        raise PassOn(str(e)) from e
    except _Stop as e:
        raise Refused(str(e)) from e
    if size[0] <= 0 or size[1] <= 0:
        raise PassOn("an image of no mode or no pixels")
    if size[0] * size[1] > 2 * MAX_IMAGE_PIXELS:
        raise Refused("decompression bomb")
    return codec, size, mode, palette


def probe(data: bytes) -> bool:
    pil_open(data)
    return True


# --- OpenJPEG's JP2 reader (jp2.c) -------------------------------------------

_S_SIGNATURE, _S_FILE_TYPE, _S_HEADER, _S_CODESTREAM = 1, 2, 4, 8
_S_UNKNOWN = 0x7FFFFFFF
_IMAGE_BOXES = (b"ihdr", b"colr", b"bpcc", b"pclr", b"cmap", b"cdef")


class _Jp2:
    def __init__(self):
        self.state = 0
        self.has_jp2h = self.has_ihdr = False
        self.w = self.h = self.nc = 0
        self.enumcs = 0
        self.has_colr = False
        self.pclr_channels = None
        self.has_cmap = self.has_cdef = False


def _box_header(d: bytes, pos: int):
    """opj_jp2_read_boxhdr on the stream: (length, type, header bytes) or
    None where the stream ends first."""
    if pos + 8 > len(d):
        return None
    length, typ = struct.unpack_from(">I4s", d, pos)
    if length == 0:
        left = len(d) - (pos + 8)
        if left > 0xFFFFFFFF - 8:
            raise ValueError("Cannot handle box sizes higher than 2^32")
        return left + 8, typ, 8
    if length == 1:
        if pos + 16 > len(d):
            return None
        hi, lo = struct.unpack_from(">II", d, pos + 8)
        if hi != 0:
            raise ValueError("Cannot handle box sizes higher than 2^32")
        return lo, typ, 16
    return length, typ, 8


def _image_box(j: _Jp2, typ: bytes, body: bytes) -> None:
    """The handlers of the boxes jp2h holds."""
    n = len(body)
    if typ == b"ihdr":
        if j.nc:
            return
        if n != 14:
            raise ValueError("Bad image header box (bad size)")
        j.h, j.w, j.nc = struct.unpack_from(">IIH", body)
        if j.h < 1 or j.w < 1 or j.nc < 1:
            raise ValueError("Wrong values for: w h numcomps (ihdr)")
        if j.nc - 1 >= 16384:
            raise ValueError("Invalid number of components (ihdr)")
        j.has_ihdr = True
    elif typ == b"colr":
        if n < 3:
            raise ValueError("Bad COLR header box (bad size)")
        if j.has_colr:
            return
        meth = body[0]
        if meth == 1:
            if n < 7:
                raise ValueError("Bad COLR header box (bad size)")
            j.enumcs = struct.unpack_from(">I", body, 3)[0]
            j.has_colr = True
        elif meth == 2:
            j.has_colr = True
    elif typ == b"bpcc":
        if n != j.nc:
            raise ValueError("Bad BPCC header box (bad size)")
    elif typ == b"pclr":
        if j.pclr_channels is not None:
            raise ValueError("a second PCLR box")
        if n < 3:
            raise ValueError("PCLR box too short")
        entries, channels = struct.unpack_from(">HB", body)
        if entries == 0 or entries > 1024:
            raise ValueError("Invalid PCLR box")
        if channels == 0:
            raise ValueError("Invalid PCLR box. Reports 0 palette columns")
        if n < 3 + channels:
            raise ValueError("PCLR box too short")
        sizes = [min(((b & 0x7F) + 8) >> 3, 4)
                 for b in body[3:3 + channels]]
        if 3 + channels + entries * sum(sizes) > n:
            raise ValueError("PCLR box too short")
        j.pclr_channels = channels
    elif typ == b"cmap":
        if j.pclr_channels is None:
            raise ValueError("Need to read a PCLR box before the CMAP box.")
        if j.has_cmap:
            raise ValueError("Only one CMAP box is allowed.")
        if n < j.pclr_channels * 4:
            raise ValueError("Insufficient data for CMAP box.")
        j.has_cmap = True
    elif typ == b"cdef":
        if j.has_cdef:
            raise ValueError("a second CDEF box")
        if n < 2:
            raise ValueError("Insufficient data for CDEF box.")
        count = struct.unpack_from(">H", body)[0]
        if count == 0:
            raise ValueError("Number of channel description is equal to "
                             "zero in CDEF box.")
        if n < 2 + count * 6:
            raise ValueError("Insufficient data for CDEF box.")
        j.has_cdef = True


def _jp2h(j: _Jp2, body: bytes) -> None:
    if (j.state & _S_FILE_TYPE) != _S_FILE_TYPE:
        raise ValueError("The jp2h box must follow the file type box")
    pos, has_ihdr = 0, False
    while pos < len(body):
        left = len(body) - pos
        if left < 8:
            raise ValueError("Cannot handle box of less than 8 bytes")
        length, typ = struct.unpack_from(">I4s", body, pos)
        hlen = 8
        if length == 1:
            if left < 16:
                raise ValueError("Cannot handle XL box of less than 16 "
                                 "bytes")
            hi, length = struct.unpack_from(">II", body, pos + 8)
            if hi != 0:
                raise ValueError("Cannot handle box sizes higher than 2^32")
            hlen = 16
            if length == 0:
                raise ValueError("Cannot handle box of undefined sizes")
        elif length == 0:
            raise ValueError("Cannot handle box of undefined sizes")
        if length < hlen:
            raise ValueError("Box length is inconsistent.")
        if length > left:
            raise ValueError("Stream error while reading JP2 Header box: "
                             "box length is inconsistent.")
        if typ in _IMAGE_BOXES:
            _image_box(j, typ, body[pos + hlen:pos + length])
        if typ == b"ihdr":
            has_ihdr = True
        pos += length
    if not has_ihdr:
        raise ValueError("Stream error while reading JP2 Header box: no "
                         "'ihdr' box.")
    j.state |= _S_HEADER
    j.has_jp2h = True


def _jp2_walk(j: _Jp2, d: bytes, pos: int, after_codestream: bool) -> int:
    """opj_jp2_read_header_procedure from `pos`: the position of the
    codestream (after the jp2c box header), or of the end."""
    while True:
        box = _box_header(d, pos)
        if box is None:
            return len(d)
        length, typ, hlen = box
        if typ == b"jp2c":
            if j.state & _S_HEADER:
                j.state |= _S_CODESTREAM
                return pos + hlen
            raise ValueError("bad placed jpeg codestream")
        if length < hlen:
            raise ValueError("invalid box size")
        size = length - hlen
        body_at = pos + hlen
        top = typ in (b"jP  ", b"ftyp", b"jp2h")
        if top or typ in _IMAGE_BOXES:
            if not top and not (j.state & _S_HEADER):
                j.state |= _S_UNKNOWN
                if body_at + size > len(d):
                    raise ValueError("Problem with skipping JPEG2000 box, "
                                     "stream error")
                pos = body_at + size
                continue
            if size > len(d) - body_at:
                raise ValueError("Invalid box size")
            body = d[body_at:body_at + size]
            if typ == b"jP  ":
                if j.state != 0:
                    raise ValueError("The signature box must be the first "
                                     "box in the file.")
                if size != 4 or body != b"\x0d\x0a\x87\x0a":
                    raise ValueError("Error with JP signature Box")
                j.state |= _S_SIGNATURE
            elif typ == b"ftyp":
                if j.state != _S_SIGNATURE:
                    raise ValueError("The ftyp box must be the second box "
                                     "in the file.")
                if size < 8 or (size - 8) & 3:
                    raise ValueError("Error with FTYP signature Box size")
                j.state |= _S_FILE_TYPE
            elif typ == b"jp2h":
                _jp2h(j, body)
            else:
                _image_box(j, typ, body)
            pos = body_at + size
        else:
            if not j.state & _S_SIGNATURE:
                raise ValueError("Malformed JP2 file format: first box must "
                                 "be JPEG 2000 signature box")
            if not j.state & _S_FILE_TYPE:
                raise ValueError("Malformed JP2 file format: second box "
                                 "must be file type box")
            j.state |= _S_UNKNOWN
            if body_at + size > len(d):
                if after_codestream:
                    return len(d)
                raise ValueError("Problem with skipping JPEG2000 box, "
                                 "stream error")
            pos = body_at + size


def _jp2_open(d: bytes) -> tuple:
    """opj_jp2_read_header up to the codestream: (its offset, the _Jp2)."""
    j = _Jp2()
    start = _jp2_walk(j, d, 0, False)
    if not j.state & _S_CODESTREAM:
        raise ValueError("no codestream box")
    if not j.has_jp2h:
        raise ValueError("JP2H box missing. Required.")
    if not j.has_ihdr:
        raise ValueError("IHDR box_missing. Required.")
    return start, j


# --- decoding ----------------------------------------------------------------

def _to_rgb(img: np.ndarray, mode: str, palette) -> np.ndarray:
    from gpupathtracer_tpu_torch.utils.io import cmyk_to_rgb
    if mode == "L":
        return np.repeat(img[..., None], 3, axis=2)
    if mode == "I;16":
        v = np.minimum(img, 255).astype(np.uint8)
        return np.repeat(v[..., None], 3, axis=2)
    if mode in ("P", "PA"):
        idx = img if mode == "P" else img[..., 0]
        pmode, pal = palette
        k = len(pmode)
        table = np.zeros((256, 3), np.uint8)
        n = len(pal) // k
        table[:n] = np.frombuffer(pal[:n * k], np.uint8).reshape(n, k)[:, :3]
        return table[idx]
    if mode == "CMYK":
        return cmyk_to_rgb(img)
    return np.ascontiguousarray(img[..., :3])


def decode_jpeg2000(data: bytes, name: str = "<jp2>") -> np.ndarray:
    """Decode a J2K codestream or a JP2 file to uint8 [H, W, 3], bit for bit
    PIL's ``convert("RGB")``. What PIL cannot open or load raises
    ValueError naming the file."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    try:
        codec, (w, h), mode, palette = pil_open(data)
    except (PassOn, Refused) as e:
        raise ValueError(f"{name}: PIL does not open this JPEG 2000 file "
                         f"({e})") from e
    if palette is not None and len(palette[1]) // len(palette[0]) > 256:
        raise ValueError(f"{name}: a palette of more than 256 entries")
    ihdr_w = ihdr_h = 0
    colour = _UNSPECIFIED
    start = 0
    j = None
    if codec == "jp2":
        try:
            start, j = _jp2_open(data)
        except ValueError as e:
            raise ValueError(f"{name}: OpenJPEG refuses the JP2 boxes ({e})"
                             ) from e
        ihdr_w, ihdr_h = j.w, j.h
        colour = _ENUMCS.get(j.enumcs, _UNKNOWN)
    lib = _load()
    msg = ctypes.create_string_buffer(256)
    info = np.zeros(5 + 4 * 4, np.int64)
    rc = lib.gpt_j2k_info(data, len(data), start, ihdr_w, ihdr_h,
                          info.ctypes.data, 4, msg, len(msg))
    _check(rc, msg, name)
    numcomps = int(info[4])
    if numcomps < 1 or numcomps > 4:
        raise ValueError(f"{name}: {numcomps} components in colour space "
                         f"{colour} (Pillow: broken data stream)")
    dx = [int(info[5 + 4 * c]) for c in range(numcomps)]
    dy = [int(info[6 + 4 * c]) for c in range(numcomps)]
    sub = next((c for c in range(numcomps) if dx[c] != 1 or dy[c] != 1), -1)
    if colour in (_UNSPECIFIED, _UNKNOWN):
        if numcomps in (1, 2):
            colour = _GRAY
        else:
            colour = _SYCC if sub in (1, 2) else _SRGB
    unpacker = next((u for m, cs, n, s, u in _UNPACKERS
                     if cs == colour and n == numcomps and (s or sub == -1)
                     and m == mode), None)
    if unpacker is None:
        raise ValueError(f"{name}: no Pillow unpacker for a {mode} image of "
                         f"{numcomps} components (broken data stream)")
    pixel = _PIXEL.get(mode, 4)
    im = np.zeros(h * w * pixel, np.uint8)
    end = ctypes.c_int64(0)
    rc = lib.gpt_j2k_decode(data, len(data), start, ihdr_w, ihdr_h,
                            unpacker, im.ctypes.data, w, h, pixel,
                            ctypes.byref(end), msg, len(msg))
    _check(rc, msg, name)
    if j is not None:
        try:
            _jp2_walk(j, data, end.value, True)
        except ValueError as e:
            raise ValueError(f"{name}: OpenJPEG refuses the boxes after the "
                             f"codestream ({e})") from e
    if mode == "I;16":
        img = im.view("<u2").reshape(h, w)
    else:
        img = im.reshape(h, w, pixel) if pixel > 1 else im.reshape(h, w)
    return _to_rgb(img, mode, palette)


def _check(rc: int, msg, name: str) -> None:
    if rc == 0:
        return
    why = msg.value.decode("latin-1")
    raise ValueError(f"{name}: OpenJPEG fails to decode this JPEG 2000 "
                     f"file ({why})")
