"""ctypes bindings for utils/codecs_cpp/codecs.cpp and utils/fax_cpp/fax.cpp
(built with g++ at first use, utils/native.py): the BCn block decoders of
DDS, GIF's and TIFF's LZW, PackBits, the byte-serial decoders of QOI, SGI's
run-length rows and PCX's run-length lines, and TIFF's CCITT, ThunderScan
and old-style LZW strips. Corrupt or short input raises ValueError naming the
file."""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from gpupathtracer_tpu_torch.utils import native

_SRC = os.path.join(os.path.dirname(__file__), "codecs_cpp", "codecs.cpp")
_FAX_SRC = os.path.join(os.path.dirname(__file__), "fax_cpp", "fax.cpp")
_lib: Optional[ctypes.CDLL] = None
_fax_lib: Optional[ctypes.CDLL] = None

# gpt_bcn_decode's formats.
BC1, BC2, BC3, BC4, BC5, BC5S, BC6H, BC6HS, BC7 = range(1, 10)

_P = ctypes.c_void_p
_I64 = ctypes.c_int64
_I32 = ctypes.c_int32


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native.load(_SRC, "codecs")
        for fn, res, args in (
                ("gpt_bcn_decode", ctypes.c_int,
                 [ctypes.c_char_p, _I64, _I32, _I32, _I32, _P]),
                ("gpt_gif_lzw", _I64,
                 [ctypes.c_char_p, _I64, _I32, _P, _I32, _I32, _I32, _I32,
                  _I32, _I32]),
                ("gpt_tiff_lzw", _I64, [ctypes.c_char_p, _I64, _P, _I64]),
                ("gpt_packbits", _I64,
                 [ctypes.c_char_p, _I64, _P, _I64, _I64, _I32]),
                ("gpt_qoi", _I64, [ctypes.c_char_p, _I64, _I64, _P, _I64]),
                ("gpt_sgi_rle", _I64,
                 [ctypes.c_char_p, _I64, _I32, _I32, _I32, _I32, _P]),
                ("gpt_pcx", _I64,
                 [ctypes.c_char_p, _I64, _I32, _I32, _I32, _I32, _P])):
            f = getattr(lib, fn)
            f.restype, f.argtypes = res, args
        _lib = lib
    return _lib


def _load_fax() -> ctypes.CDLL:
    global _fax_lib
    if _fax_lib is None:
        lib = native.load(_FAX_SRC, "fax")
        lib.gpt_fax.restype = _I64
        lib.gpt_fax.argtypes = [ctypes.c_char_p, _I64, _I32, _I32, _I64, _I32,
                                _P, _I64, _I64, _P, _I64, _P]
        lib.gpt_thunderscan.restype = _I64
        lib.gpt_thunderscan.argtypes = [ctypes.c_char_p, _I64, _I32, _P, _I64]
        lib.gpt_lzw_compat.restype = _I64
        lib.gpt_lzw_compat.argtypes = [ctypes.c_char_p, _I64, _P, _I64]
        _fax_lib = lib
    return _fax_lib


# gpt_fax's modes: compression 2, 32771, 3 (1-D and 2-D) and 4.
FAX_RLE, FAX_RLEW, FAX_G3, FAX_G3_2D, FAX_G4 = range(1, 6)


def fax_runs(width: int, two_d: bool) -> np.ndarray:
    """libtiff's state for an image's CCITT strips: its run arrays for rows
    of ``width`` pixels (two rows of nruns entries, zeroed once an image)
    and, last, the flag of a T.4 image found without EOLs."""
    nruns = -(-(width + 1) // 32) * 32 * (2 if two_d else 1)
    return np.zeros(2 * nruns + 1, np.uint32)


def fax(data: bytes, mode: int, fill_order: int, file_off: int, width: int,
        rows: int, rowbytes: int, runs: np.ndarray) -> tuple:
    """One CCITT strip or tile -> (rows * rowbytes bytes, rows filled): the
    rows a T.6 strip leaves undecoded after its end stay zero. ValueError
    where libtiff fails the strip."""
    out = np.zeros(rows * rowbytes, np.uint8)
    nruns = (len(runs) - 1) // 2
    n = _load_fax().gpt_fax(data, len(data), mode, fill_order, file_off,
                            width, out.ctypes.data, rows, rowbytes,
                            runs.ctypes.data, nruns,
                            runs[2 * nruns:].ctypes.data)
    if n < 0:
        raise ValueError("corrupt CCITT data")
    return out.tobytes(), int(n)


def thunderscan(data: bytes, width: int, rows: int) -> bytes:
    """One ThunderScan strip -> rows of (width + 1) // 2 bytes (4-bit
    pixels); ValueError where a row has not enough or too much data."""
    out = np.zeros(rows * ((width + 1) // 2), np.uint8)
    if _load_fax().gpt_thunderscan(data, len(data), width, out.ctypes.data,
                                   rows) < 0:
        raise ValueError("corrupt ThunderScan data")
    return out.tobytes()


def tiff_lzw_compat(data: bytes, size: int) -> bytes:
    """One old-style (LSB-first) TIFF LZW strip or tile -> ``size`` bytes;
    ValueError where libtiff's LZWDecodeCompat fails."""
    out = np.zeros(size, np.uint8)
    if _load_fax().gpt_lzw_compat(data, len(data), out.ctypes.data, size):
        raise ValueError("corrupt old-style LZW data")
    return out.tobytes()


def bcn(blocks: bytes, w: int, h: int, fmt: int, name: str) -> np.ndarray:
    """BCn blocks, row-major over ceil(h/4) x ceil(w/4) blocks -> uint8
    [h, w, 3] (BC4 grey in all three channels, BC5's blue 0)."""
    out = np.zeros((h, w, 3), np.uint8)
    if h and w and _load().gpt_bcn_decode(blocks, len(blocks), w, h, fmt,
                                          out.ctypes.data):
        raise ValueError(f"{name}: truncated block-compressed data")
    return out


def gif_lzw(data: bytes, bits: int, frame: np.ndarray, x0: int, y0: int,
            w: int, h: int, interlace: bool) -> int:
    """GIF image data (from the first sub-block's size byte on; LZW, LSB
    first, code size ``bits``) into ``frame`` [H, W] uint8 at (x0, y0),
    w x h, rows interlaced in GIF's four passes if asked. Returns 0 once
    the frame is full, 1 if the data ends first, -1 for a code past the
    table, -2 for a bad code size."""
    return _load().gpt_gif_lzw(data, len(data), bits, frame.ctypes.data,
                               frame.shape[1], x0, y0, w, h, int(interlace))


def tiff_lzw(data: bytes, size: int) -> bytes:
    """One TIFF LZW strip or tile (MSB first, early change) -> up to
    ``size`` bytes; -1 for a corrupt table."""
    out = np.zeros(size, np.uint8)
    n = _load().gpt_tiff_lzw(data, len(data), out.ctypes.data, size)
    if n < 0:
        raise ValueError("corrupt LZW data")
    return out[:n].tobytes()


def packbits(data: bytes, rows: int, row_bytes: int,
             libtiff: bool = False) -> tuple:
    """PackBits -> (rows * row_bytes bytes, bytes consumed). A run past a
    row's end is cut there, as PIL's decoder cuts it; ``libtiff``: one
    row of a whole strip, a literal cut at its end needing only the bytes
    it copies, as libtiff decodes a strip. -1 bytes consumed when the
    data ends first."""
    out = np.zeros(rows * row_bytes, np.uint8)
    used = _load().gpt_packbits(data, len(data), out.ctypes.data, rows,
                                row_bytes, int(libtiff))
    return out.tobytes(), int(used)


def qoi(data: bytes, pos: int, npix: int, name: str) -> np.ndarray:
    """QOI ops from byte ``pos`` on -> npix pixels' RGB, uint8 [npix, 3]
    (PIL's Python decoder); ValueError where the data ends first."""
    out = np.zeros((npix, 3), np.uint8)
    if _load().gpt_qoi(data, len(data), pos, out.ctypes.data, npix):
        raise ValueError(f"{name}: QOI data ends before the image's last "
                         f"pixel (PIL's load fails)")
    return out


def sgi_rle(data: bytes, w: int, h: int, bands: int, bpc: int,
            name: str) -> np.ndarray:
    """SGI run-length data (the file after its 512-byte header) -> uint8
    [h, w, bands * bpc], rows in the tables' order (bottom row first), as
    Pillow's SgiRleDecode.c fills them; ValueError where it overruns."""
    out = np.zeros((h, w, bands * bpc), np.uint8)
    if _load().gpt_sgi_rle(data, len(data), w, h, bands, bpc,
                           out.ctypes.data):
        raise ValueError(f"{name}: corrupt SGI run-length data (PIL: buffer "
                         f"overrun)")
    return out


def pcx(data: bytes, w: int, h: int, line: int, bits: int,
        name: str) -> np.ndarray:
    """PCX run-length data -> uint8 [h, line], each line's planes where
    Pillow's PcxDecode.c leaves them for a raw mode of ``bits`` bits a
    pixel (1-bit planes ceil(w / 8) bytes apart, byte planes w apart);
    ValueError where a run crosses a line's end (PIL: buffer overrun) or
    the data ends first."""
    out = np.zeros((h, line), np.uint8)
    rc = _load().gpt_pcx(data, len(data), w, h, line, bits, out.ctypes.data)
    if rc == -1:
        raise ValueError(f"{name}: a PCX run crosses a line's end (PIL: "
                         f"buffer overrun)")
    if rc:
        raise ValueError(f"{name}: truncated PCX image data")
    return out
