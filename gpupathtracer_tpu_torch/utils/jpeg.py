"""ctypes binding for the JPEG decoder (jpeg_cpp/jpeg.cpp).

The decoder's output is bit for bit what libjpeg-turbo gives through
PIL's ``Image.open(path).convert("RGB")`` (the JAX package's reader):
every process PIL reads at 8-bit precision, sequential and progressive,
Huffman or arithmetic coded, and lossless; grey, three components or four
(CMYK and YCCK, then PIL's "CMYK;I" inversion and its CMYK -> RGB), every
sampling factor libjpeg reads; libjpeg's standard Huffman tables, block
smoothing of progressive files that stop short, and its recovery from
corrupt scan data. It compiles on first use with g++ (utils/native.py),
cached by source hash under the package's ``_build/`` directory; it does
integer arithmetic only, so the host's instruction set cannot change a
bit.
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


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native.load(_SRC, "jpeg")
        lib.gpt_jpeg_info.restype = ctypes.c_int
        lib.gpt_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.c_char_p, ctypes.c_int]
        lib.gpt_jpeg_decode.restype = ctypes.c_int
        lib.gpt_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_int32, ctypes.c_void_p,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_int32, ctypes.c_char_p,
            ctypes.c_int]
        _lib = lib
    return _lib


def _raise(err, name: str) -> None:
    raise ValueError(f"{name}: {err.value.decode(errors='replace')} "
                     f"(corrupt or refused JPEG)")


# decode_jpeg's colour argument: how three components are read.
_COLOUR = {"auto": 0, "none": 1, "ycbcr": 2}
# decode_jpeg's source argument: who hands libjpeg the bytes.
_SOURCE = {"pil": 0, "libtiff": 1}


def decode_jpeg(data: bytes, name: str = "<jpeg>", colour: str = "auto",
                source: str = "pil") -> np.ndarray:
    """Decode a JPEG file's bytes to uint8 [H, W, 3] RGB (grey replicated;
    four components as PIL reads them: CMYK, inverted, to RGB).

    ``colour`` picks three components' colour space: "auto" as libjpeg
    picks it (JFIF, Adobe marker, component ids, the process), "none"
    keeps the components (libtiff's JPEG-in-TIFF of photometric RGB),
    "ycbcr" reads them as YCbCr; with "none" four components come back as
    they are, [H, W, 4]. ``source`` "pil" reads the bytes as PIL's JPEG
    plugin does (its open-time checks, then libjpeg fed in 64 KiB buffers:
    a file cut short is truncated); "libtiff" as libtiff feeds a strip
    (whole, a fake EOI past its end). Corrupt or truncated data, and what
    PIL or libjpeg refuses (12- and 16-bit precision, hierarchical files,
    arithmetic-coded lossless ones), raise ValueError naming ``name``."""
    if source == "pil":
        from gpupathtracer_tpu_torch.utils.identify import pil_jpeg_refuses
        why = pil_jpeg_refuses(data)
        if why:
            raise ValueError(f"{name}: PIL's JPEG plugin refuses the file "
                             f"({why})")
    lib = _load()
    err = ctypes.create_string_buffer(256)
    dims = (ctypes.c_int32 * 3)()
    src = _SOURCE[source]
    if lib.gpt_jpeg_info(data, len(data), src, dims, err, len(err)):
        _raise(err, name)
    h, w, nc = int(dims[0]), int(dims[1]), int(dims[2])
    check_pixels(h, w, name)
    out = np.empty((h, w, 4 if nc == 4 else 3), np.uint8)
    if lib.gpt_jpeg_decode(data, len(data), src, out.ctypes.data, h, w,
                           _COLOUR[colour], err, len(err)):
        _raise(err, name)
    if nc == 4 and colour == "auto":
        return cmyk_to_rgb(255 - out)       # PIL's "CMYK;I"
    return out
