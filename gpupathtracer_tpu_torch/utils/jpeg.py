"""ctypes binding for the JPEG decoder (jpeg_cpp/jpeg.cpp).

The decoder's output is bit for bit what libjpeg-turbo gives through
PIL's ``Image.open(path).convert("RGB")`` (the JAX package's reader):
baseline, extended and progressive Huffman-coded files at 8-bit precision,
grey or three components, every sampling factor libjpeg reads. It compiles
on first use with g++ (-O3), cached by source hash under the package's
``_build/`` directory, as bvh/cpp.py builds the SBVH builder; it does
integer arithmetic only, so the host's instruction set cannot change a bit.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
from typing import Optional

import numpy as np

from gpupathtracer_tpu_torch.utils.io import check_pixels

_SRC = os.path.join(os.path.dirname(__file__), "jpeg_cpp", "jpeg.cpp")
_lib: Optional[ctypes.CDLL] = None

# Return codes of the C interface.
_CORRUPT, _UNSUPPORTED = 1, 2


def _cache_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _compile() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    so_path = os.path.join(_cache_dir(), f"libjpeg-{digest}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"  # concurrent test workers
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
               "-fPIC", _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    return so_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_compile())
        lib.gpt_jpeg_info.restype = ctypes.c_int
        lib.gpt_jpeg_info.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.POINTER(ctypes.c_int32),
            ctypes.c_char_p, ctypes.c_int]
        lib.gpt_jpeg_decode.restype = ctypes.c_int
        lib.gpt_jpeg_decode.argtypes = [
            ctypes.c_char_p, ctypes.c_int64, ctypes.c_void_p, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_char_p, ctypes.c_int]
        _lib = lib
    return _lib


def _raise(rc: int, err, name: str) -> None:
    msg = f"{name}: {err.value.decode(errors='replace')}"
    if rc == _UNSUPPORTED:
        raise NotImplementedError(f"{msg} (not read: ROADMAP.md C6)")
    raise ValueError(f"{msg} (corrupt or refused JPEG)")


def decode_jpeg(data: bytes, name: str = "<jpeg>") -> np.ndarray:
    """Decode a JPEG file's bytes to uint8 [H, W, 3] RGB (grey replicated).

    Corrupt or truncated data, and what libjpeg itself refuses, raise
    ValueError naming ``name``; what this decoder does not read (arithmetic
    coding, lossless and hierarchical files, 12- and 16-bit precision, four
    components) raises NotImplementedError naming it."""
    lib = _load()
    err = ctypes.create_string_buffer(256)
    dims = (ctypes.c_int32 * 3)()
    rc = lib.gpt_jpeg_info(data, len(data), dims, err, len(err))
    if rc:
        _raise(rc, err, name)
    h, w = int(dims[0]), int(dims[1])
    check_pixels(h, w, name)
    out = np.empty((h, w, 3), np.uint8)
    rc = lib.gpt_jpeg_decode(data, len(data), out.ctypes.data, h, w, err,
                             len(err))
    if rc:
        _raise(rc, err, name)
    return out
