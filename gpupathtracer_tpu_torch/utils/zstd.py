"""ctypes binding for utils/zstd_cpp/zstd.cpp (built with g++ at first use,
utils/native.py): Zstandard-compressed TIFF strips and tiles, decoded as
libtiff's ZSTDDecode drives libzstd (Python 3.12 has no zstd module)."""

from __future__ import annotations

import ctypes
import os
from typing import Optional

import numpy as np

from gpupathtracer_tpu_torch.utils import native

_SRC = os.path.join(os.path.dirname(__file__), "zstd_cpp", "zstd.cpp")
_lib: Optional[ctypes.CDLL] = None

_WHY = {-1: "corrupt Zstandard data", -2: "not enough Zstandard data",
        -3: "a Zstandard frame that needs a dictionary",
        -4: "a Zstandard window libzstd refuses",
        -5: "not a Zstandard frame"}


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = native.load(_SRC, "zstd")
        lib.gpt_zstd_tiff.restype = ctypes.c_int
        lib.gpt_zstd_tiff.argtypes = [ctypes.c_char_p, ctypes.c_int64,
                                      ctypes.c_void_p, ctypes.c_int64,
                                      ctypes.POINTER(ctypes.c_int64)]
        _lib = lib
    return _lib


def tiff_zstd(data: bytes, size: int, partial: bool = False) -> bytes:
    """One ZSTD strip or tile -> its ``size`` bytes; ValueError where
    libtiff's ZSTDDecode fails (corrupt data, a frame or an input that
    ends first, a dictionary, a window libzstd refuses), or with
    ``partial`` the bytes it wrote before it failed."""
    out = np.zeros(size, np.uint8)
    made = ctypes.c_int64(0)
    rc = _load().gpt_zstd_tiff(data, len(data), out.ctypes.data, size,
                               ctypes.byref(made))
    if rc and not partial:
        raise ValueError(_WHY.get(rc, "corrupt Zstandard data"))
    return out[:made.value].tobytes()
