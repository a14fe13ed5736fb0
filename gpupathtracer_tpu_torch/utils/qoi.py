"""QOI (PIL's QoiImagePlugin), decoded bit for bit as PIL's Python decoder
and ``convert("RGB")`` read it: utils/codecs_cpp/codecs.cpp runs the ops."""

from __future__ import annotations

import struct

import numpy as np

from gpupathtracer_tpu_torch.utils import codecs


def decode_qoi(data: bytes, name: str = "<qoi>") -> np.ndarray:
    """Decode a QOI file to uint8 [H, W, 3]: the ops as PIL's decoder takes
    them (its index table starts empty, so a slot never written reads 0,
    0, 0, 0; runs do not enter the table; the channels byte 3 is RGB, any
    other RGBA, whose alpha convert("RGB") drops; the colourspace byte
    and the end marker are not read). Data that ends inside an op before
    the last pixel raises ValueError naming the file, as PIL's load
    fails."""
    from gpupathtracer_tpu_torch.utils.io import check_pixels
    if len(data) < 13 or not data.startswith(b"qoif"):
        raise ValueError(f"{name}: not a QOI file PIL opens")
    w, h = struct.unpack_from(">II", data, 4)
    if w <= 0 or h <= 0:
        raise ValueError(f"{name}: QOI of {w}x{h} pixels")
    check_pixels(h, w, name)
    return codecs.qoi(data, 14, w * h, name).reshape(h, w, 3)
