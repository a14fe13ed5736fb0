"""WebP files, read as Pillow's WebPImagePlugin reads them (libwebp's
WebPAnimDecoder, MODE_RGBA) and then ``convert("RGB")``: the first frame.

- The RIFF container is checked as libwebp checks it twice over: its
  WebPGetFeatures on the whole file (ParseHeadersInternal) and its
  demuxer (WebPDemux: the RIFF size against the file, chunk sizes and
  padding, the chunks and flags VP8X requires, frame bounds), then
  WebPGetFeatures and WebPDecode's header parse on the frame's bytes.
  Bytes that fail any of them raise ValueError naming the file, as PIL
  fails to open or to load them.
- Simple lossy (``VP8 ``) and lossless (``VP8L``) files, and extended
  ones (``VP8X``): ``ICCP``, ``EXIF``, ``XMP `` and unknown chunks are
  skipped; an ``ALPH`` chunk is decoded with its ``VP8 `` frame (and
  dropped where VP8X's alpha flag is off, as the demuxer drops it).
- Animations (``ANIM`` + ``ANMF``): the first frame, on a zeroed canvas
  of VP8X's size at the frame's offset, as WebPAnimDecoder composes
  frame 1 (a key frame: nothing is blended).
- The bitstreams: utils/webp_cpp/webp.cpp (built with g++ at first use,
  utils/native.py): VP8L, VP8 with libwebp's fancy upsampling and
  YUV -> RGB, ALPH.

Nothing here imports PIL or the JAX package.
"""

from __future__ import annotations

import ctypes
import os
import struct
from typing import Optional

import numpy as np

from gpupathtracer_tpu_torch.utils import native
from gpupathtracer_tpu_torch.utils.io import check_pixels

_SRC = os.path.join(os.path.dirname(__file__), "webp_cpp", "webp.cpp")
_lib: Optional[ctypes.CDLL] = None

_MAX_CHUNK_PAYLOAD = 0xFFFFFFFF - 8 - 1
_MAX_IMAGE_AREA = 1 << 32
_U32 = 0xFFFFFFFF
# VP8X flags.
_ANIMATION, _XMP, _EXIF, _ALPHA, _ICCP = 0x02, 0x04, 0x08, 0x10, 0x20
_VALID_FLAGS = _ANIMATION | _XMP | _EXIF | _ALPHA | _ICCP

# The statuses of libwebp's header parse that are not a refusal.
_OK, _NOT_ENOUGH_DATA = 0, 1


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native.load(_SRC, "webp")
        p, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int32
        lib.gpt_webp_vp8l.restype = ctypes.c_int
        lib.gpt_webp_vp8l.argtypes = [ctypes.c_char_p, i64, i32, i32, p,
                                      ctypes.c_char_p, ctypes.c_int]
        lib.gpt_webp_vp8.restype = ctypes.c_int
        lib.gpt_webp_vp8.argtypes = [ctypes.c_char_p, i64, ctypes.c_char_p,
                                     i64, i32, i32, p, ctypes.c_char_p,
                                     ctypes.c_int]
        _lib = lib
    return _lib


class _Refused(Exception):
    """What libwebp refuses; decode_webp turns it into ValueError."""


def _le24(d: bytes, pos: int) -> int:
    return d[pos] | d[pos + 1] << 8 | d[pos + 2] << 16


def _le32(d: bytes, pos: int) -> int:
    return struct.unpack_from("<I", d, pos)[0]


# --- the headers: libwebp's ParseHeadersInternal -----------------------------

def _vp8_info(d: bytes, pos: int, size: int, chunk_size: int):
    """VP8GetInfo: (width, height), or None for a refused frame header."""
    if size < 10 or d[pos + 3:pos + 6] != b"\x9d\x01\x2a":
        return None
    bits = _le24(d, pos)
    w = (d[pos + 7] << 8 | d[pos + 6]) & 0x3FFF
    h = (d[pos + 9] << 8 | d[pos + 8]) & 0x3FFF
    if (bits & 1 or (bits >> 1) & 7 > 3 or not (bits >> 4) & 1
            or bits >> 5 >= chunk_size or w == 0 or h == 0):
        return None
    return w, h


def _vp8l_info(d: bytes, pos: int, size: int):
    """VP8LGetInfo: (width, height, the alpha_is_used bit), or None."""
    if size < 5 or d[pos] != 0x2F or d[pos + 4] >> 5:
        return None
    bits = _le32(d, pos + 1)
    return (1 + (bits & 0x3FFF), 1 + ((bits >> 14) & 0x3FFF),
            bool((bits >> 28) & 1))


def _parse_headers(d: bytes, have_all_data: bool, headers: bool) -> dict:
    """ParseHeadersInternal over all of ``d``: WebPGetFeatures (headers
    False, not all data required) or WebPParseHeaders (headers True).
    Returns the features and, with headers, where the bitstream and the
    ALPH payload start; raises _Refused for any other status than OK."""
    size = len(d)
    if size < 12:
        raise _Refused("shorter than a RIFF header")
    pos, riff_size = 0, 0
    if d[:4] == b"RIFF":
        if d[8:12] != b"WEBP":
            raise _Refused("not a WEBP RIFF file")
        riff = _le32(d, 4)
        if riff < 12 or riff > _MAX_CHUNK_PAYLOAD:
            raise _Refused(f"RIFF size {riff}")
        if have_all_data and riff > size - 8:
            raise _Refused("RIFF size past the end of the file")
        riff_size, pos, size = riff, 12, size - 12
    found_riff = riff_size > 0
    if size < 8:
        raise _Refused("truncated before the first chunk")
    found_vp8x, flags, canvas = False, 0, (0, 0)
    if d[pos:pos + 4] == b"VP8X":
        if _le32(d, pos + 4) != 10:
            raise _Refused("VP8X chunk size is not 10")
        if size < 18:
            raise _Refused("truncated VP8X chunk")
        flags = _le32(d, pos + 8)
        canvas = (1 + _le24(d, pos + 12), 1 + _le24(d, pos + 15))
        if canvas[0] * canvas[1] >= _MAX_IMAGE_AREA:
            raise _Refused("canvas too large")
        pos, size, found_vp8x = pos + 18, size - 18, True
    if not found_riff and found_vp8x:
        raise _Refused("VP8X outside a RIFF file")
    out = {"width": canvas[0], "height": canvas[1], "alpha": None,
           "animation": bool(flags & _ANIMATION),
           "has_alpha": bool(flags & _ALPHA)}
    if found_vp8x and out["animation"] and not headers:
        return out
    status = _OK
    if size < 4:
        status = _NOT_ENOUGH_DATA
    elif (found_riff and found_vp8x) or (
            not found_riff and not found_vp8x and d[pos:pos + 4] == b"ALPH"):
        status, pos, size = _optional_chunks(d, pos, size, riff_size, out)
    if status == _OK:
        status, pos, size = _bitstream_header(d, pos, size, have_all_data,
                                              riff_size, out)
    if status == _OK:
        if out["compressed_size"] > _MAX_CHUNK_PAYLOAD:
            raise _Refused("chunk too large")
        if out["lossless"]:
            info = _vp8l_info(d, pos, size) if size >= 5 else False
        else:
            info = (_vp8_info(d, pos, size, out["compressed_size"])
                    if size >= 10 else False)
        if info is False:
            status = _NOT_ENOUGH_DATA
        elif info is None:
            raise _Refused("bad VP8/VP8L frame header")
        else:
            if found_vp8x and info[:2] != canvas:
                raise _Refused("frame size differs from the canvas")
            out["width"], out["height"] = info[:2]
            if out["lossless"]:
                out["has_alpha"] = info[2]
            out["offset"] = pos
    if status == _OK or (status == _NOT_ENOUGH_DATA and found_vp8x
                         and not headers):
        out["has_alpha"] |= out["alpha"] is not None
        return out
    raise _Refused("truncated chunk data")


def _optional_chunks(d, pos, size, riff_size, out):
    """ParseOptionalChunks: skip to the VP8/VP8L chunk, noting ALPH."""
    total = 4 + 8 + 10
    while True:
        if size < 8:
            return _NOT_ENOUGH_DATA, pos, size
        chunk_size = _le32(d, pos + 4)
        if chunk_size > _MAX_CHUNK_PAYLOAD:
            raise _Refused("chunk size too large")
        disk = ((8 + chunk_size + 1) & _U32) & ~1
        total = (total + disk) & _U32
        if riff_size > 0 and total > riff_size:
            raise _Refused("chunks past the RIFF size")
        if d[pos:pos + 4] in (b"VP8 ", b"VP8L"):
            return _OK, pos, size
        if size < disk:
            return _NOT_ENOUGH_DATA, pos, size
        if d[pos:pos + 4] == b"ALPH":
            out["alpha"] = (pos + 8, chunk_size)
        pos, size = pos + disk, size - disk


def _bitstream_header(d, pos, size, have_all_data, riff_size, out):
    """ParseVP8Header: past the VP8/VP8L chunk header (or raw data)."""
    if size < 8:
        return _NOT_ENOUGH_DATA, pos, size
    tag = d[pos:pos + 4]
    if tag in (b"VP8 ", b"VP8L"):
        n = _le32(d, pos + 4)
        if riff_size >= 12 and n > riff_size - 12:
            raise _Refused("VP8/VP8L chunk past the RIFF size")
        if have_all_data and n > size - 8:
            return _NOT_ENOUGH_DATA, pos, size
        out["compressed_size"], out["lossless"] = n, tag == b"VP8L"
        return _OK, pos + 8, size - 8
    out["compressed_size"] = size
    out["lossless"] = size >= 5 and d[pos] == 0x2F and d[pos + 4] >> 5 == 0
    return _OK, pos, size


def _features(d: bytes) -> dict:
    return _parse_headers(d, False, False)


# --- the demuxer: libwebp's WebPDemux ----------------------------------------

class _Frame:
    def __init__(self):
        self.x = self.y = self.width = self.height = 0
        self.complete = False
        self.num = 0
        self.image = (0, 0)     # (chunk offset, chunk size)
        self.alpha = (0, 0)


class _Demux:
    """The parse of a complete file (allow_partial off: a RIFF size past
    the end of the file fails, so every chunk that fits the RIFF size is
    whole)."""

    def __init__(self, d: bytes):
        if len(d) < 20:
            raise _Refused("shorter than a RIFF header and a chunk")
        riff_size = _le32(d, 4)
        if riff_size < 8 or riff_size > _MAX_CHUNK_PAYLOAD:
            raise _Refused(f"RIFF size {riff_size}")
        self.riff_end = riff_size + 8
        if len(d) < self.riff_end:
            raise _Refused("RIFF size past the end of the file (truncated)")
        self.d = d[:self.riff_end]
        self.start = 12
        self.frames = []
        self.flags = 0
        self.canvas = (0, 0)
        self.is_ext = False
        tag = self.d[12:16]
        if tag in (b"VP8 ", b"VP8L"):
            self._single_image()
            self._valid_simple()
        elif tag == b"VP8X":
            self._vp8x()
            self._valid_extended()
        else:
            raise _Refused(f"first chunk {tag!r}")

    def _left(self) -> int:
        return self.riff_end - self.start

    def _store_frame(self, frame_num: int, min_size: int, f: _Frame) -> None:
        """StoreFrame: the ALPH and image chunks from here into f."""
        if self._left() < max(8, min_size):
            raise _Refused("truncated frame")
        alpha_chunks = image_chunks = 0
        while True:
            chunk_start = self.start
            tag = self.d[self.start:self.start + 4]
            payload = _le32(self.d, self.start + 4)
            self.start += 8
            if payload > _MAX_CHUNK_PAYLOAD:
                raise _Refused("chunk size too large")
            padded = payload + (payload & 1)
            if padded > self._left():
                raise _Refused("chunk past the RIFF size")
            size = 8 + padded
            done = False
            if tag == b"ALPH" and alpha_chunks == 0:
                alpha_chunks = 1
                f.alpha, f.num = (chunk_start, size), frame_num
                self.start += padded
            elif tag == b"VP8L" and alpha_chunks > 0:
                raise _Refused("ALPH before VP8L")
            elif tag in (b"VP8 ", b"VP8L") and image_chunks == 0:
                feats = _features(self.d[chunk_start:chunk_start + size])
                image_chunks = 1
                f.image = (chunk_start, size)
                f.width, f.height = feats["width"], feats["height"]
                f.num, f.complete = frame_num, True
                self.start += padded
            else:
                self.start = chunk_start
                done = True
            if self.start == self.riff_end:
                return
            if self._left() < 8:
                raise _Refused("trailing bytes after a chunk")
            if done:
                return

    def _add(self, f: _Frame) -> None:
        if self.frames and not self.frames[-1].complete:
            raise _Refused("a frame after an incomplete one")
        self.frames.append(f)

    def _single_image(self) -> None:
        if self.frames or self._left() < 8:
            raise _Refused("a second image, or a truncated one")
        f = _Frame()
        self._store_frame(1, 0, f)
        if not self.flags & _ALPHA:     # an ALPH the flags do not announce
            f.alpha = (0, 0)
        if not self.is_ext and f.width > 0 and f.height > 0:
            self.canvas = (f.width, f.height)
        self._add(f)

    def _vp8x(self) -> None:
        self.is_ext = True
        self.start += 4
        size = _le32(self.d, self.start)
        self.start += 4
        if size > _MAX_CHUNK_PAYLOAD or size < 10:
            raise _Refused("VP8X chunk size")
        size += size & 1
        if size > self._left():
            raise _Refused("truncated VP8X chunk")
        self.flags = self.d[self.start]
        self.canvas = (1 + _le24(self.d, self.start + 4),
                       1 + _le24(self.d, self.start + 7))
        if self.canvas[0] * self.canvas[1] >= _MAX_IMAGE_AREA:
            raise _Refused("canvas too large")
        self.start += size
        if self._left() < 8:
            raise _Refused("no chunk after VP8X")
        self._vp8x_chunks()

    def _vp8x_chunks(self) -> None:
        """ParseVP8XChunks."""
        animation = bool(self.flags & _ANIMATION)
        anim_chunks = 0
        while True:
            chunk_start = self.start
            tag = self.d[self.start:self.start + 4]
            size = _le32(self.d, self.start + 4)
            self.start += 8
            if size > _MAX_CHUNK_PAYLOAD:
                raise _Refused("chunk size too large")
            padded = size + (size & 1)
            if padded > self._left():
                raise _Refused("chunk past the RIFF size")
            if tag == b"VP8X":
                raise _Refused("a second VP8X chunk")
            if tag in (b"ALPH", b"VP8 ", b"VP8L"):
                if anim_chunks > 0 or animation:
                    raise _Refused("an image outside ANMF in an animation")
                self.start = chunk_start
                self._single_image()
            elif tag == b"ANIM":
                if padded < 6:
                    raise _Refused("ANIM chunk too small")
                anim_chunks += 1
                self.start += padded
            elif tag == b"ANMF":
                if anim_chunks == 0:
                    raise _Refused("ANMF before ANIM")
                self._anmf(padded)
            else:               # ICCP, EXIF, XMP, unknown: skipped
                self.start += padded
            if self.start == self.riff_end:
                return
            if self._left() < 8:
                raise _Refused("trailing bytes after a chunk")

    def _anmf(self, chunk_size: int) -> None:
        """ParseAnimationFrame."""
        if self._left() < 16 or chunk_size < 16:
            raise _Refused("ANMF chunk too small")
        d, s = self.d, self.start
        f = _Frame()
        f.x, f.y = 2 * _le24(d, s), 2 * _le24(d, s + 3)
        f.width, f.height = 1 + _le24(d, s + 6), 1 + _le24(d, s + 9)
        self.start += 16
        if f.width * f.height >= _MAX_IMAGE_AREA:
            raise _Refused("frame too large")
        payload = chunk_size - 16
        start = self.start
        self._store_frame(len(self.frames) + 1, payload, f)
        if self.start - start > payload:
            raise _Refused("ANMF chunks past the frame")
        if self.flags & _ANIMATION and f.num > 0:
            self._add(f)

    def _valid_simple(self) -> None:
        if self.canvas[0] <= 0 or self.canvas[1] <= 0 or not self.frames:
            raise _Refused("no image")
        if self.frames[0].width <= 0 or self.frames[0].height <= 0:
            raise _Refused("no image size")

    def _valid_extended(self) -> None:
        """IsValidExtendedFormat."""
        animation = bool(self.flags & _ANIMATION)
        if not self.frames:
            raise _Refused("no frame")
        if self.flags & ~_VALID_FLAGS:
            raise _Refused("reserved VP8X flags set")
        cw, ch = self.canvas
        for f in self.frames:
            if not animation and f.num > 1:
                raise _Refused("frames in a still image")
            if not f.complete:
                raise _Refused("an incomplete frame")
            if f.alpha[1] > 0 and f.alpha[0] > f.image[0]:
                raise _Refused("ALPH after the image chunk")
            if f.width <= 0 or f.height <= 0:
                raise _Refused("no frame size")
            if not animation:
                if f.x or f.y or (f.width, f.height) != (cw, ch):
                    raise _Refused("frame differs from the canvas")
            elif f.x + f.width > cw or f.y + f.height > ch:
                raise _Refused("frame outside the canvas")

    def first_frame(self) -> tuple:
        """(frame, its bytes: ALPH through the image chunk)."""
        f = next((f for f in self.frames if f.num == 1), None)
        if f is None:
            raise _Refused("no first frame")
        start, size = f.image
        if f.alpha[1] > 0:
            size += f.alpha[1] + (start - (f.alpha[0] + f.alpha[1]))
            start = f.alpha[0]
        return f, self.d[start:start + size]


# --- decoding ----------------------------------------------------------------

def _decode_frame(fragment: bytes, width: int, height: int) -> np.ndarray:
    """WebPDecode of a frame's bytes into uint8 [height, width, 4]."""
    _features(fragment)
    hdr = _parse_headers(fragment, True, True)
    if hdr["animation"]:
        raise _Refused("an animation inside a frame")
    lib = _load()
    out = np.zeros((height, width, 4), np.uint8)
    err = ctypes.create_string_buffer(256)
    body = fragment[hdr["offset"]:]
    if hdr["lossless"]:
        rc = lib.gpt_webp_vp8l(body, len(body), width, height,
                               out.ctypes.data, err, len(err))
    else:
        alpha = None
        if hdr["alpha"] is not None:
            a0, n = hdr["alpha"]
            alpha = fragment[a0:a0 + n]
        rc = lib.gpt_webp_vp8(body, len(body), alpha,
                              0 if alpha is None else len(alpha), width,
                              height, out.ctypes.data, err, len(err))
    if rc:
        raise _Refused(err.value.decode(errors="replace"))
    return out


def decode_webp_rgba(data: bytes, name: str = "<webp>") -> np.ndarray:
    """The first frame's canvas as PIL holds it: libwebp's WebPAnimDecoder
    canvas, uint8 [H, W, 4] RGBA, not premultiplied (zeros outside an
    animation's first frame), its alpha 255 where WebPGetFeatures finds
    none (PIL's mode RGB)."""
    try:
        has_alpha = _features(data)["has_alpha"]
        demux = _Demux(data)
        check_pixels(demux.canvas[1], demux.canvas[0], name)
        f, fragment = demux.first_frame()
        frame = _decode_frame(fragment, f.width, f.height)
    except _Refused as e:
        raise ValueError(f"{name}: corrupt or refused WebP file ({e}); PIL "
                         f"cannot open or load it") from None
    cw, ch = demux.canvas
    canvas = frame
    if (f.x, f.y, f.width, f.height) != (0, 0, cw, ch):
        canvas = np.zeros((ch, cw, 4), np.uint8)
        canvas[f.y:f.y + f.height, f.x:f.x + f.width] = frame
    if not has_alpha:
        canvas[..., 3] = 255
    return canvas


def decode_webp(data: bytes, name: str = "<webp>") -> np.ndarray:
    """Decode a WebP file's bytes to uint8 [H, W, 3] RGB, bit for bit
    PIL's ``convert("RGB")`` (the first frame of an animation; alpha is
    decoded, and a corrupt alpha plane fails, but it is dropped)."""
    return np.ascontiguousarray(decode_webp_rgba(data, name)[..., :3])
