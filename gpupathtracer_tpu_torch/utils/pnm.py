"""PNM and PFM (PIL's PpmImagePlugin): P1-P6, P0CMYK, grey PFM (Pf) and
PIL's test formats PyP, PyRGBA and PyCMYK, decoded bit for bit as PIL's
``convert("RGB")`` reads them. The header is read token by token as PIL
reads it (a ``#`` comment runs to the end of its line and may sit inside a
token); a magic PIL does not list (colour PFM ``PF``, ``P7``) passes the
file on to the next plugin, a bad token or maxval stops PIL. The plain
formats (P1-P3) are parsed in PIL's 1 MiB blocks, as its Python decoder
parses them; the binary ones are read with numpy."""

from __future__ import annotations

import math

import numpy as np

_WS = b"\x20\x09\x0a\x0b\x0c\x0d"
_MODES = {b"P1": "1", b"P2": "L", b"P3": "RGB", b"P4": "1", b"P5": "L",
          b"P6": "RGB", b"P0CMYK": "CMYK", b"Pf": "F", b"PyP": "P",
          b"PyRGBA": "RGBA", b"PyCMYK": "CMYK"}
_BANDS = {"1": 1, "L": 1, "I": 1, "P": 1, "F": 1, "RGB": 3, "RGBA": 4,
          "CMYK": 4}
# ImageFile.SAFEBLOCK: the plain decoder's read size.
_BLOCK = 1024 * 1024


class _File:
    """The reads PIL's plugin makes on its file."""

    def __init__(self, data: bytes, pos: int = 0):
        self.data, self.pos = data, pos

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + n]
        self.pos += len(out)
        return out


def _read_magic(f: _File) -> bytes:
    magic = b""
    for _ in range(6):
        c = f.read(1)
        if not c or c in _WS:
            break
        magic += c
    return magic


def _read_token(f: _File) -> bytes:
    from gpupathtracer_tpu_torch.utils.identify import Refused
    token = b""
    while len(token) <= 10:
        c = f.read(1)
        if not c:
            break
        if c in _WS:
            if not token:
                continue
            break
        if c == b"#":
            while f.read(1) not in b"\r\n":
                pass
            continue
        token += c
    if not token:
        raise Refused("Reached EOF while reading header")
    if len(token) > 10:
        raise Refused("Token too long in file header")
    return token


def _number(kind, token: bytes):
    from gpupathtracer_tpu_torch.utils.identify import Refused
    try:
        return kind(token)
    except ValueError as e:
        raise Refused(str(e)) from e


def ppm_header(data: bytes) -> dict:
    """PpmImageFile._open, then Image.open's checks: mode, size, decoder
    and its arguments, and where the data starts. Raises identify.PassOn
    where PIL passes the file on, identify.Refused where it stops."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    from gpupathtracer_tpu_torch.utils.io import MAX_IMAGE_PIXELS
    f = _File(data)
    magic = _read_magic(f)
    if magic not in _MODES:
        raise PassOn("not a PPM file")
    mode = _MODES[magic]
    w = _number(int, _read_token(f))
    h = _number(int, _read_token(f))
    decoder = "plain" if magic in (b"P1", b"P2", b"P3") else "raw"
    maxval = scale = None
    if mode == "F":
        scale = _number(float, _read_token(f))
        if scale == 0.0 or not math.isfinite(scale):
            raise Refused("scale must be finite and non-zero")
    elif mode != "1":
        maxval = _number(int, _read_token(f))
        if not 0 < maxval < 65536:
            raise Refused("maxval must be greater than 0 and less than 65536")
        if maxval > 255 and mode == "L":
            mode = "I"
        if decoder == "raw" and maxval != 255 and not (
                maxval == 65535 and mode == "I"):
            decoder = "ppm"
    if w <= 0 or h <= 0:
        raise PassOn("an image of no pixels")
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise Refused("decompression bomb")
    return dict(mode=mode, w=w, h=h, decoder=decoder, maxval=maxval,
                scale=scale, offset=f.pos)


def decode_ppm(data: bytes, name: str = "<ppm>") -> np.ndarray:
    """Decode a PNM / PFM file to uint8 [H, W, 3], bit for bit PIL's
    ``convert("RGB")``: bitmaps with 1 as black; grey and RGB at maxval
    255 as stored, at another maxval rescaled by Python's
    ``round(v / maxval * 255)`` (half to even; 2-byte samples from maxval
    256 on, values past maxval clipped in binary files and refused in
    plain ones); grey past maxval 255 is PIL's mode I, which
    ``convert("RGB")`` clips at 255; CMYK through PIL's CMYK -> RGB;
    PyRGBA's alpha dropped; PyP has no palette (black); PFM rows bottom
    up in the scale's byte order, each float truncated and clipped to 0 ..
    255 (NaN reads 0). What PIL cannot read raises ValueError naming the
    file."""
    from gpupathtracer_tpu_torch.utils.identify import PassOn, Refused
    try:
        hd = ppm_header(data)
    except (PassOn, Refused) as e:
        raise ValueError(f"{name}: PIL does not read this PNM file ({e})") \
            from e
    mode, w, h, maxval = hd["mode"], hd["w"], hd["h"], hd["maxval"]
    bands = _BANDS[mode]
    pos = hd["offset"]
    n = w * h * bands
    if hd["decoder"] == "plain":
        try:
            if mode == "1":
                v = _plain_bitonal(data, pos, w * h)
            else:
                v = _plain_values(data, pos, n, maxval,
                                  65535 if mode == "I" else 255)
        except ValueError as e:
            raise ValueError(f"{name}: {e}") from e
        if len(v) < n:
            raise ValueError(f"{name}: PNM data ends early (PIL: not enough "
                             f"image data)")
        px = np.asarray(v, np.int64).reshape(h, w, bands)
    elif mode == "1":
        stride = (w + 7) // 8
        if pos + stride * h > len(data):
            raise ValueError(f"{name}: truncated PBM image data")
        rows = np.frombuffer(data, np.uint8, stride * h, pos).reshape(h,
                                                                      stride)
        bits = np.unpackbits(rows, axis=1)[:, :w]
        px = ((1 - bits) * 255)[..., None]      # "1;I": 1 is black
    elif mode == "F":
        if pos + 4 * n > len(data):
            raise ValueError(f"{name}: truncated PFM image data")
        order = "<" if hd["scale"] < 0 else ">"
        f = np.frombuffer(data, order + "f4", n, pos).reshape(h, w)[::-1]
        g = np.where(np.isnan(f) | (f <= 0), 0,
                     np.where(f >= 255, 255, np.trunc(f)))
        px = g.astype(np.uint8)[..., None]
    else:
        size = 2 if maxval > 255 else 1
        if pos + size * n > len(data):
            raise ValueError(f"{name}: truncated PNM image data")
        raw = np.frombuffer(data, ">u2" if size == 2 else np.uint8, n, pos)
        px = raw.astype(np.int64).reshape(h, w, bands)
        if hd["decoder"] == "ppm":
            out_max = 65535 if mode == "I" else 255
            px = np.minimum(out_max, np.rint(px / maxval * out_max)).astype(
                np.int64)
    return _to_rgb(px, mode)


def _to_rgb(px: np.ndarray, mode: str) -> np.ndarray:
    """PIL's convert("RGB") of the mode's samples [h, w, bands]."""
    from gpupathtracer_tpu_torch.utils.io import cmyk_to_rgb
    if mode == "P":                     # no palette: every index is black
        return np.zeros(px.shape[:2] + (3,), np.uint8)
    if mode == "CMYK":
        return cmyk_to_rgb(px.astype(np.uint8))
    if mode in ("RGB", "RGBA"):
        return np.ascontiguousarray(px[..., :3].astype(np.uint8))
    g = np.minimum(px[..., 0], 255) if mode == "I" else px[..., 0]
    if mode == "1":
        g = np.where(g != 0, 255, 0)
    return np.repeat(g.astype(np.uint8)[..., None], 3, axis=2)


# --- PIL's PpmPlainDecoder ---------------------------------------------------

class _Plain:
    def __init__(self, data: bytes, pos: int):
        self.f = _File(data, pos)
        self.spans = False

    def block(self) -> bytes:
        return self.f.read(_BLOCK)

    @staticmethod
    def _comment_end(block: bytes, start: int = 0) -> int:
        a = block.find(b"\n", start)
        b = block.find(b"\r", start)
        return min(a, b) if a * b > 0 else max(a, b)

    def ignore_comments(self, block: bytes) -> bytes:
        if self.spans:
            while block:
                end = self._comment_end(block)
                if end != -1:
                    block = block[end + 1:]
                    break
                block = self.block()
        self.spans = False
        while True:
            start = block.find(b"#")
            if start == -1:
                break
            end = self._comment_end(block, start)
            if end != -1:
                block = block[:start] + block[end + 1:]
            else:
                block = block[:start]
                self.spans = True
                break
        return block


def _plain_bitonal(data: bytes, pos: int, total: int) -> list:
    """P1 pixels (1 black -> 0, 0 white -> 255): every byte of a block
    but whitespace must be 0 or 1."""
    p = _Plain(data, pos)
    out = b""
    while len(out) != total:
        block = p.block()
        if not block:
            break
        tokens = b"".join(p.ignore_comments(block).split())
        if tokens.strip(b"01"):
            raise ValueError("invalid token for a PBM file")
        out = (out + tokens)[:total]
    return [0 if c == 49 else 255 for c in out]


def _plain_values(data: bytes, pos: int, total: int, maxval: int,
                  out_max: int) -> list:
    """P2 / P3 samples, each ``round(v / maxval * out_max)``; a token of
    more than 10 bytes, a negative value or one past maxval raises."""
    p = _Plain(data, pos)
    out = []
    half = b""
    while len(out) != total:
        block = p.block()
        if not block:
            if not half:
                break
            block = b" "
        block = p.ignore_comments(block)
        if half:
            block, half = half + block, b""
        tokens = block.split()
        if block and not block[-1:].isspace():
            half = tokens.pop()
            if len(half) > 10:
                raise ValueError("token too long in PNM data")
        for token in tokens:
            if len(token) > 10:
                raise ValueError("token too long in PNM data")
            value = int(token)
            if value < 0:
                raise ValueError(f"channel value is negative: {value}")
            if value > maxval:
                raise ValueError(f"channel value too large: {value}")
            out.append(round(value / maxval * out_max))
            if len(out) == total:
                break
    return out
