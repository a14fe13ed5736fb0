"""PCX (PIL's PcxImagePlugin), decoded bit for bit as PIL's
``convert("RGB")`` reads it: Pillow's PcxDecode.c (utils/codecs_cpp/
codecs.cpp) for the run-length lines, numpy for the planes and
palettes."""

from __future__ import annotations

import struct

import numpy as np

from gpupathtracer_tpu_torch.utils import codecs


def pcx_header(data: bytes) -> dict:
    """PcxImageFile._open, then Image.open's checks: mode, size, palette
    and the line length PIL computes. Raises identify.PassOn where PIL
    passes the file on (a header cut short, an empty or negative box),
    identify.Refused where it stops ("unknown PCX mode"; an 8-bit grey
    or palette file shorter than the 769 bytes PIL seeks back from its
    end)."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    from gpupathtracer_tpu_torch.utils.io import MAX_IMAGE_PIXELS
    if len(data) < 68:
        raise PassOn("PCX header cut short")
    x0, y0, x1, y1 = struct.unpack_from("<4H", data, 4)
    if x1 + 1 <= x0 or y1 + 1 <= y0:
        raise PassOn("bad PCX image size")
    version, bits, planes = data[1], data[3], data[65]
    (given,) = struct.unpack_from("<H", data, 66)
    pal = None
    if bits == 1 and planes == 1:
        mode = "1"
    elif bits == 1 and planes in (2, 4):
        mode = "P"
        pal = np.frombuffer(data, np.uint8, 48, 16).reshape(16, 3)
    elif version == 5 and bits == 8 and planes == 1:
        if len(data) < 769:
            raise Refused("[Errno 22] Invalid argument (seek before the "
                          "file's start)")
        mode = "L"
        tail = data[-769:]
        ramp = np.repeat(np.arange(256, dtype=np.uint8), 3)
        if tail[0] == 12 and (np.frombuffer(tail, np.uint8, 768, 1)
                              != ramp).any():
            mode = "P"
            pal = np.frombuffer(tail, np.uint8, 768, 1).reshape(256, 3)
    elif version == 5 and bits == 8 and planes == 3:
        mode = "RGB"
    else:
        raise Refused("unknown PCX mode")
    w, h = x1 + 1 - x0, y1 + 1 - y0
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise Refused("decompression bomb")
    stride = (w * bits + 7) // 8
    if given != stride:
        stride += stride % 2
    return dict(mode=mode, w=w, h=h, bits=bits, planes=planes,
                line=planes * stride, pal=pal)


def decode_pcx(data: bytes, name: str = "<pcx>") -> np.ndarray:
    """Decode a PCX file to uint8 [H, W, 3]: 1 bit in 1 plane (white for
    1), in 2 or 4 planes (indices into the header's 16-colour palette,
    PIL's P;2L / P;4L), 8 bits in 1 plane (grey, or the 256-colour
    palette after the 0x0C marker at the file's end when it is not the
    ramp) and in 3 (RGB, one line a plane). The line length is PIL's own,
    not the header's: (w * bits + 7) // 8, made even where it differs from
    the header's. A run that crosses a line's end, data cut short, or a
    mode PIL does not open raises ValueError naming the file."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    try:
        hd = pcx_header(data)
    except (PassOn, Refused) as e:
        raise ValueError(f"{name}: PIL does not read this PCX file ({e})") \
            from e
    w, h, mode, planes = hd["w"], hd["h"], hd["mode"], hd["planes"]
    rawbits = {"RGB": 24, "P": planes if hd["bits"] == 1 else 8}.get(
        mode, hd["bits"])
    lines = codecs.pcx(data[128:], w, h, hd["line"], rawbits, name)
    if mode == "RGB":
        return np.ascontiguousarray(
            lines[:, :3 * w].reshape(h, 3, w).transpose(0, 2, 1))
    if hd["bits"] == 1:
        s = (w + 7) // 8
        bits = [np.unpackbits(lines[:, p * s:(p + 1) * s], axis=1)[:, :w]
                for p in range(planes)]
        if mode == "1":
            return np.repeat((bits[0] * 255)[..., None], 3, axis=2)
        idx = sum(b.astype(np.int64) << p for p, b in enumerate(bits))
        return hd["pal"][idx]
    idx = lines[:, :w]
    if mode == "P":
        return hd["pal"][idx]
    return np.repeat(idx[..., None], 3, axis=2)
