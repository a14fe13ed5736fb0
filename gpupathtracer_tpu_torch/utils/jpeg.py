"""ctypes binding for the JPEG decoder (jpeg_cpp/jpeg.cpp).

The decoder's output is bit for bit what libjpeg-turbo gives through
PIL's ``Image.open(path).convert("RGB")`` (the JAX package's reader):
baseline, extended and progressive Huffman-coded files at 8-bit precision,
grey, three components or four (CMYK and YCCK, then PIL's "CMYK;I"
inversion and its CMYK -> RGB), every sampling factor libjpeg reads. It
compiles on first use with g++ (utils/native.py), cached by source hash
under the package's ``_build/`` directory; it does integer arithmetic
only, so the host's instruction set cannot change a bit.
"""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from gpupathtracer_tpu_torch.utils import native
from gpupathtracer_tpu_torch.utils.io import check_pixels, cmyk_to_rgb

_SRC = os.path.join(os.path.dirname(__file__), "jpeg_cpp", "jpeg.cpp")
_lib: Optional[ctypes.CDLL] = None

# Return codes of the C interface.
_CORRUPT, _UNSUPPORTED = 1, 2


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native.load(_SRC, "jpeg")
        lib.gpt_jpeg_info.restype = ctypes.c_int
        lib.gpt_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_int]
        lib.gpt_jpeg_decode.restype = ctypes.c_int
        lib.gpt_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def _raise(rc: int, err, name: str) -> None:
    msg = f"{name}: {err.value.decode(errors='replace')}"
    if rc == _UNSUPPORTED:
        raise NotImplementedError(f"{msg} (not read: ROADMAP.md C6)")
    raise ValueError(f"{msg} (corrupt or refused JPEG)")


# decode_jpeg's colour argument: how three components are read.
_COLOUR = {"auto": 0, "none": 1, "ycbcr": 2}


def decode_jpeg(data: bytes, name: str = "<jpeg>",
                colour: str = "auto") -> np.ndarray:
    """Decode a JPEG file's bytes to uint8 [H, W, 3] RGB (grey replicated;
    four components as PIL reads them: CMYK, inverted, to RGB).

    ``colour`` picks three components' colour space: "auto" as libjpeg
    picks it (JFIF, Adobe marker, component ids), "none" keeps the
    components (libtiff's JPEG-in-TIFF of photometric RGB), "ycbcr" reads
    them as YCbCr; with "none" four components come back as they are,
    [H, W, 4]. Corrupt or truncated data, and what libjpeg itself
    refuses, raise ValueError naming ``name``; what this decoder does not
    read (arithmetic coding, lossless and hierarchical files, 12- and
    16-bit precision) raises NotImplementedError naming it."""
    lib = _load()
    err = ctypes.create_string_buffer(256)
    dims = (ctypes.c_int32 * 3)()
    rc = lib.gpt_jpeg_info(data, len(data), dims, err, len(err))
    if rc:
        _raise(rc, err, name)
    h, w, nc = int(dims[0]), int(dims[1]), int(dims[2])
    check_pixels(h, w, name)
    out = np.empty((h, w, 4 if nc == 4 else 3), np.uint8)
    rc = lib.gpt_jpeg_decode(data, len(data), out.ctypes.data, h, w,
                             _COLOUR[colour], err, len(err))
    if rc:
        _raise(rc, err, name)
    if nc == 4 and colour == "auto":
        return cmyk_to_rgb(255 - out)       # PIL's "CMYK;I"
    return out
