"""Which of PIL's image plugins opens a file, decided as Pillow 12.1.0's
``Image.open`` decides it: the plugins in ``Image.ID`` order (the preinit
five, BMP, DIB, GIF, JPEG, PPM and PNG, then the rest as ``Image.init``
registers them), each first by its ``_accept(prefix)`` test on the first
16 bytes, then by the header checks of its ``_open``. A plugin whose
``_open`` raises SyntaxError (or reads past the end: IndexError,
struct.error) passes the file on to the next; any other exception stops
PIL there, and so does an opened image with no mode or no pixels.

``identify`` returns the plugin's format name, and raises ValueError
naming the file where PIL would fail to open it or where no plugin
accepts it ("cannot identify image file"). The header checks are copied
for the plugins the port reads (BMP, DIB, CUR, ICO, JPEG, JPEG2000, ICNS,
PPM, PCX, PSD, QOI, SGI, TGA), for those without an accept test (IM, IMT,
IPTC, PCD, SPIDER), for the unread plugins BLP, DCX, FITS, FLI, FTEX,
MCIDAS, MSP, PIXAR, SUN, XBM, XPM and XVTHUMB (so that junk behind their
magic bytes is refused as PIL refuses it), for AVIF libavif's whole parse
at open (utils/avif.py), and a few of GBR and WMF; for the rest the
accept test decides.
"""

from __future__ import annotations

import re
import struct

# Formats PIL opens but cannot load here (stubs; MPEG identifies only;
# EPS needs Ghostscript, WMF Windows).
CANNOT_LOAD = ("BUFR", "GRIB", "HDF5", "MPEG", "EPS", "WMF")


class Refused(Exception):
    """PIL's _open raised something other than SyntaxError: it stops."""


class PassOn(Exception):
    """PIL's _open raised SyntaxError (or an error ImageFile turns into
    one: IndexError, TypeError, KeyError, EOFError, struct.error), or
    opened an image of no pixels: the next plugin is tried."""


def _u16le(d, o):
    return struct.unpack_from("<H", d, o)[0]


def _u32le(d, o):
    return struct.unpack_from("<I", d, o)[0]


def _u32be(d, o):
    return struct.unpack_from(">I", d, o)[0]


# --- accept tests (each plugin's _accept) ------------------------------------

def _bmp(p):
    return p.startswith(b"BM")


def _dib(p):
    return len(p) >= 4 and _u32le(p, 0) in (12, 40, 52, 56, 64, 108, 124)


def _gif(p):
    return p.startswith((b"GIF87a", b"GIF89a"))


def _jpeg(p):
    return p.startswith(b"\xff\xd8\xff")


def _ppm(p):
    return len(p) >= 2 and p.startswith(b"P") and p[1] in b"0123456fy"


def _png(p):
    return p.startswith(b"\x89PNG\r\n\x1a\n")


def _avif(p):
    return p[4:8] == b"ftyp" and p[8:12] in (
        b"avif", b"avis", b"mif1", b"msf1")


def _starts(*magics):
    return lambda p: p.startswith(magics)


def _pcx(p):
    return len(p) >= 2 and p[0] == 10 and p[1] in (0, 2, 3, 5)


def _dcx(p):
    return len(p) >= 4 and _u32le(p, 0) == 987654321


def _eps(p):
    return p.startswith(b"%!PS") or (len(p) >= 4
                                     and _u32le(p, 0) == 0xC6D3D0C5)


def _fli(p):
    return (len(p) >= 16 and _u16le(p, 4) in (0xAF11, 0xAF12)
            and _u16le(p, 14) in (0, 3))


def _gbr(p):
    return len(p) >= 8 and _u32be(p, 0) >= 20 and _u32be(p, 4) in (1, 2)


def _grib(p):
    return len(p) >= 8 and p.startswith(b"GRIB") and p[7] == 1


def _tiff(p):
    return p.startswith((b"MM\x00\x2a", b"II\x2a\x00", b"MM\x2a\x00",
                         b"II\x00\x2a", b"MM\x00\x2b", b"II\x2b\x00"))


def _sgi(p):
    return len(p) >= 2 and struct.unpack_from(">H", p, 0)[0] == 474


def _sun(p):
    return len(p) >= 4 and _u32be(p, 0) == 0x59A66A95


def _webp(p):
    return (p.startswith(b"RIFF") and p[8:12] == b"WEBP"
            and p[12:16] in (b"VP8 ", b"VP8X", b"VP8L"))


def _xbm(p):
    return p.lstrip().startswith(b"#define")


def _always(p):
    return True


# --- header checks of _open: True opens, False passes on, Refused stops ------

def _bitmap_probe(d, at, offset, halve=False):
    """BmpImageFile._bitmap's checks (utils/io.py bitmap_header), then
    Image.open's: pixels in both directions, under the decompression bomb
    limit."""
    from gpupathtracer_tpu_torch.utils.io import MAX_IMAGE_PIXELS, \
        bitmap_header
    hd = bitmap_header(d, at, offset)
    h = hd["h"] // 2 if halve else hd["h"]
    if h <= 0:
        raise PassOn("a bitmap of no rows")
    if hd["w"] * h > 2 * MAX_IMAGE_PIXELS:
        raise Refused("decompression bomb")
    return True


def _probe_bmp(d):
    return _bitmap_probe(d, 14, _u32le(d, 10))


def _probe_dib(d):
    return _bitmap_probe(d, 0, 0)


def cur_bitmap_at(d):
    """CurImagePlugin: where the bitmap of the cursor PIL picks starts.
    The first entry, replaced by a later one only where both its width and
    its height byte are strictly larger (a 0 byte is 0); an entry offset
    of 0 reads on where the directory ends. No entry: TypeError, which
    passes the file on (a TGA of type 2 starts with CUR's magic bytes)."""
    m = b""
    count = _u16le(d, 4)
    for i in range(count):
        s = d[6 + 16 * i:22 + 16 * i]
        if not m:
            m = s
        elif s[0] > m[0] and s[1] > m[1]:
            m = s
    if not m:
        raise PassOn("no cursors were found")
    return _u32le(m, 12) or min(6 + 16 * count, len(d))


def _probe_cur(d):
    return _bitmap_probe(d, cur_bitmap_at(d), 0, halve=True)


def _probe_ico(d):
    """IcoImagePlugin's _open, which loads the first frame: its checks
    that pass the file on (utils/ico.py open_ico); what the load refuses
    stops PIL, so it is left to the decode."""
    from gpupathtracer_tpu_torch.utils.ico import open_ico
    open_ico(d, pixels=False)
    return True


def _probe_ppm(d):
    from gpupathtracer_tpu_torch.utils.pnm import ppm_header
    ppm_header(d)
    return True


def _probe_qoi(d):
    """QoiImagePlugin: the 14-byte header, a size above 0."""
    from gpupathtracer_tpu_torch.utils.io import MAX_IMAGE_PIXELS
    if len(d) < 13:
        return False                    # struct.error / IndexError
    w, h = _u32be(d, 4), _u32be(d, 8)
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise Refused("decompression bomb")
    return w > 0 and h > 0


def _probe_sgi(d):
    from gpupathtracer_tpu_torch.utils.sgi import sgi_header
    sgi_header(d)
    return True


# JpegImagePlugin.MARKER: the markers its _open walks, by handler.
_JPEG_SOF = (frozenset(range(0xC0, 0xD0)) - {0xC4, 0xC8, 0xCC}) | {0xDE}
_JPEG_SKIP = frozenset((0xC4, 0xCC, 0xDA, 0xDC, 0xDD, 0xDF))
_JPEG_NONE = frozenset([0xC8, *range(0xD0, 0xDA), *range(0xF0, 0xFE)])


def _read(d, pos, n):
    """ImageFile._safe_read: n bytes, nothing for n <= 0, OSError short."""
    if n <= 0:
        return b"", pos
    if pos + n > len(d):
        raise Refused("Truncated File Read")
    return d[pos:pos + n], pos + n


def _jpeg_app(marker, s):
    """The parts of JpegImagePlugin.APP that can raise."""
    if marker == 0xE0 and s.startswith(b"JFIF"):
        struct.unpack_from(">H", s, 5)
    elif marker == 0xED and s.startswith(b"Photoshop 3.0\x00"):
        offset = 14
        while s[offset:offset + 4] == b"8BIM":
            offset += 4
            if len(s) < offset + 2:
                break                   # struct.error: insufficient data
            code = struct.unpack_from(">H", s, offset)[0]
            offset += 2
            offset += 1 + s[offset]     # IndexError past the end
            offset += offset & 1
            if len(s) < offset + 4:
                break
            size = struct.unpack_from(">I", s, offset)[0]
            offset += 4
            if code == 0x03ED and len(s[offset:offset + size]) < 14:
                break                   # ResolutionInfo cut short
            offset += size
            offset += offset & 1
    elif marker == 0xEE and s.startswith(b"Adobe"):
        struct.unpack_from(">H", s, 5)


def _probe_jpeg(d):
    """JpegImagePlugin._open: the markers up to the first SOS, walked as
    PIL walks them (junk bytes skipped, FF FF and FF 00 passed over, any
    other unknown marker "no marker found"), with the checks of its SOF,
    DQT and APP handlers: 8-bit samples in 1, 3 or 4 layers, whole
    quantization tables. Then Image.open's: a mode and a size above 0."""
    pos, s = 3, 0xFF
    layers = width = height = 0
    icc = []
    while True:
        if s != 0xFF:
            if pos >= len(d):
                return False            # IndexError at the end
            s = d[pos]
            pos += 1
            continue
        if pos >= len(d):
            return False                # struct.error reading the marker
        m = d[pos]
        pos += 1
        if m in _JPEG_SOF or m in _JPEG_SKIP or m == 0xDB or 0xE0 <= m <= \
                0xEF or m == 0xFE:
            if pos + 2 > len(d):
                return False
            n = struct.unpack_from(">H", d, pos)[0] - 2
            body, pos = _read(d, pos + 2, n)
            if m in _JPEG_SOF:
                if len(body) < 5:
                    return False
                height, width = struct.unpack_from(">HH", body, 1)
                if body[0] != 8:
                    return False        # "cannot handle N-bit layers"
                if len(body) < 6:
                    return False
                layers = body[5]
                if layers not in (1, 3, 4):
                    return False        # "cannot handle N-layer images"
                if icc:
                    if len(min(icc)) < 14:
                        return False
                    icc = []
            elif m == 0xDB:
                while body:
                    size = 65 if body[0] // 16 == 0 else 129
                    if len(body) < size:
                        return False    # "bad quantization table marker"
                    body = body[size:]
            elif 0xE0 <= m <= 0xEF:
                if m == 0xE2 and body.startswith(b"ICC_PROFILE\0"):
                    icc.append(body)
                try:
                    _jpeg_app(m, body)
                except (IndexError, struct.error):
                    return False
            if m == 0xDA:
                break
            if pos >= len(d):
                return False
            s = d[pos]
            pos += 1
        elif m in _JPEG_NONE:
            if pos >= len(d):
                return False
            s = d[pos]
            pos += 1
        elif m == 0xFF:
            s = 0xFF
        elif m == 0x00:
            if pos >= len(d):
                return False
            s = d[pos]
            pos += 1
        else:
            return False                # "no marker found"
    return layers != 0 and width > 0 and height > 0


def pil_jpeg_refuses(data: bytes):
    """Why PIL's JPEG plugin would not open ``data`` (None if it would)."""
    try:
        if _jpeg(data[:16]) and _probe_jpeg(data):
            return None
        return "no SOS after a frame of 8-bit samples in 1, 3 or 4 layers"
    except Refused as e:
        return str(e)


def _probe_psd(d):
    return len(d) >= 26 and struct.unpack_from(">H", d, 4)[0] == 1


def _probe_tga(d):
    if len(d) < 18:
        return False
    w, h = _u16le(d, 12), _u16le(d, 14)
    if d[1] not in (0, 1) or w <= 0 or h <= 0 or d[16] not in (1, 8, 16, 24,
                                                               32):
        return False
    if d[2] not in (1, 2, 3, 9, 10, 11):
        return False
    if d[1] and d[7] not in (16, 24, 32):
        return False                    # "unknown TGA map depth"
    return True


def _probe_pcx(d):
    from gpupathtracer_tpu_torch.utils.pcx import pcx_header
    pcx_header(d)
    return True


def _probe_gbr(d):
    if len(d) < 20:
        return False
    hsize, version, w, h, depth = struct.unpack_from(">5I", d, 0)
    if hsize < 20 or version not in (1, 2) or w <= 0 or h <= 0 or (
            depth not in (1, 4)):
        return False
    return version == 1 or d[20:24] == b"GIMP"


def _probe_wmf(d):
    if d.startswith(b"\xd7\xcd\xc6\x9a\x00\x00"):
        return True
    return d[40:44] == b" EMF"


_IM_LINE = re.compile(rb"^([A-Za-z][^:]*):[ \t]*(.*)[ \t]*$")
_IM_TAGS = (b"Comment", b"Date", b"Digitalization equipment",
            b"File size (no of images)", b"Lut", b"Name",
            b"Scale (x,y)", b"Image size (x*y)", b"Image type")


def _probe_im(d):
    """ImImagePlugin: "Key: value" lines up to a 0 or 0x1A byte, at least
    one of them a known key, then the 0x1A that starts the data."""
    if b"\n" not in d[:100]:
        return False
    pos, known = 0, 0
    while pos < len(d):
        c = d[pos:pos + 1]
        if c == b"\r":
            pos += 1
            continue
        if c in (b"\0", b"\x1a"):
            break
        nl = d.find(b"\n", pos + 1)
        end = len(d) if nl < 0 else nl + 1
        line = d[pos:end]
        pos = end
        if len(line) > 100:
            return False
        line = line[:-2] if line.endswith(b"\r\n") else (
            line[:-1] if line.endswith(b"\n") else line)
        m = _IM_LINE.match(line)
        if not m:
            return False
        known += m.group(1) in _IM_TAGS
    if not known:
        return False
    return d.find(b"\x1a", pos) >= 0


_IMT_FIELD = re.compile(rb"([a-z]*) ([^ \r\n]*)")


def _probe_imt(d):
    """ImtImagePlugin: "width N", "height N" and "pixel n8" lines before
    a form feed; PIL needs the mode and a size above 0."""
    if b"\n" not in d[:100]:
        return False
    w = h = 0
    mode = False
    for line in d.split(b"\x0c", 1)[0].split(b"\n"):
        if len(line) == 0 or len(line) > 99:
            break
        if line[:1] == b"*":
            continue
        m = _IMT_FIELD.match(line)
        if not m:
            break
        k, v = m.group(1, 2)
        try:
            if k == b"width":
                w = int(v)
            elif k == b"height":
                h = int(v)
        except ValueError as e:
            raise Refused(str(e)) from e
        if k == b"pixel" and v == b"n8":
            mode = True
    return mode and w > 0 and h > 0


def _probe_iptc(d):
    return len(d) >= 5 and d[0] == 0x1C and d[1] in (1, 2, 3, 4, 5, 6, 7, 8,
                                                     9, 240)


def _probe_pcd(d):
    return d[2048:2052] == b"PCD_"


def _spider_header(t):
    h = (99,) + t
    for i in (1, 2, 5, 12, 13, 22, 23):
        v = h[i]
        if v != v or v in (float("inf"), float("-inf")) or v != int(v):
            return False
    if int(h[5]) not in (1, 3, -11, -12, -21, -22):
        return False
    return int(h[22]) == int(h[13]) * int(h[23])


def _probe_spider(d):
    if len(d) < 108:
        return False
    return (_spider_header(struct.unpack_from(">27f", d, 0))
            or _spider_header(struct.unpack_from("<27f", d, 0)))


def _probe_jpeg2000(d):
    from gpupathtracer_tpu_torch.utils.jpeg2000 import probe
    return probe(d)


# --- the open-time checks of the plugins the port does not read -------------
# Each copies the plugin's _open up to where PIL has opened the file, then
# ImageFile's checks: a mode and a size above 0 (else SyntaxError, the
# file passes on) and Image.open's decompression bomb limit. Errors that
# ImageFile turns into SyntaxError (IndexError, TypeError, KeyError,
# EOFError, struct.error) pass the file on; the others stop PIL.

def _opened(mode, w, h):
    from gpupathtracer_tpu_torch.utils.io import MAX_IMAGE_PIXELS
    if not mode or w <= 0 or h <= 0:
        raise PassOn("an image of no mode or no pixels")
    if w * h > 2 * MAX_IMAGE_PIXELS:
        raise Refused("decompression bomb")
    return True


def _unpack(fmt, d, o):
    """struct.unpack_from on what a file read of the size gets."""
    return struct.unpack(fmt, d[o:o + struct.calcsize(fmt)])


class _Lines:
    """readline over the bytes from `pos`."""

    def __init__(self, d, pos):
        self.d, self.pos = d, pos

    def readline(self):
        end = self.d.find(b"\n", self.pos)
        end = len(self.d) if end < 0 else end + 1
        line, self.pos = self.d[self.pos:end], end
        return line


def _int(v):
    try:
        return int(v)
    except ValueError as e:
        raise Refused(str(e)) from e


def _probe_blp(d):
    """BlpImagePlugin: the compression and alpha fields, then the size."""
    if d[:4] == b"BLP1":
        _unpack("<iI", d, 4)
        w, h = _unpack("<II", d, 12)
        _unpack("<i", d, 20)
        return _opened("RGB", w, h)
    _unpack("<i", d, 4)
    _unpack("<bbb", d, 8)
    w, h = _unpack("<II", d, 12)
    return _opened("RGB", w, h)


def _probe_dcx(d):
    """DcxImagePlugin: the frame directory, then the first frame's
    PcxImageFile._open at its offset."""
    offsets = []
    for i in range(1024):
        (off,) = _unpack("<I", d, 4 + 4 * i)
        if not off:
            break
        offsets.append(off)
    if not offsets:
        raise PassOn("attempt to seek outside sequence")
    from gpupathtracer_tpu_torch.utils.pcx import pcx_header
    if not _pcx(d[offsets[0]:offsets[0] + 16]):
        raise PassOn("not a PCX file")
    pcx_header(d[offsets[0]:])
    return True


def _probe_fits(d):
    """FitsImagePlugin: 80-byte header cards up to END and past it to the
    data unit, the size and mode from NAXIS* / BITPIX."""
    headers, progress, decoder, pos, mode, size = {}, False, "", 0, None, None
    while True:
        card = d[pos:pos + 80]
        pos += len(card)
        if not card:
            raise Refused("Truncated FITS file")
        key = card[:8].strip()
        if key in (b"SIMPLE", b"XTENSION"):
            progress = True
        elif headers and not progress:
            break
        elif key == b"END":
            pos = -(-pos // 2880) * 2880
            if not decoder:
                decoder, mode, size = _fits_headers(headers)
            progress = False
            continue
        if decoder:
            continue
        value = card[8:].split(b"/")[0].strip()
        if value.startswith(b"="):
            value = value[1:].strip()
        if not headers and (not key.startswith(b"SIMPLE") or value != b"T"):
            raise PassOn("Not a FITS file")
        headers[key] = value
    if not decoder:
        raise Refused("No image data")
    return _opened(mode, *size)


def _fits_headers(h):
    def size(prefix):
        naxis = _int(h[prefix + b"NAXIS"])
        if naxis == 0:
            return None
        if naxis == 1:
            return 1, _int(h[prefix + b"NAXIS1"])
        return _int(h[prefix + b"NAXIS1"]), _int(h[prefix + b"NAXIS2"])
    prefix, decoder = b"", "raw"
    if (h.get(b"XTENSION") == b"'BINTABLE'" and h.get(b"ZIMAGE") == b"T"
            and h[b"ZCMPTYPE"] == b"'GZIP_1  '"):
        size(prefix)
        _int(h[b"BITPIX"])
        prefix, decoder = b"Z", "fits_gzip"
    sz = size(prefix)
    if not sz:
        return "", None, None
    bits = _int(h[prefix + b"BITPIX"])
    mode = {8: "L", 16: "I;16", 32: "I", -32: "F", -64: "F"}.get(bits)
    return decoder, mode, sz


def _probe_fli(d):
    """FliImagePlugin: the 128-byte header's zero fields, the palette
    chunk of the first frame, then seek(0) reads the frame's size."""
    s = d[:128]
    if not (_fli(s[:16]) and s[20:22] == b"\0" * 2 and s[42:80] == b"\0" * 38
            and s[88:] == b"\0" * 40):
        raise PassOn("not an FLI/FLC file")
    w, h = _unpack("<HH", s, 8)
    s = d[128:144]
    at = 144
    if _unpack("<H", s, 4)[0] == 0xF100:
        at = 128 + _unpack("<I", s, 0)[0]
        s = d[at:at + 16]
        at += 16
    if _unpack("<H", s, 4)[0] == 0xF1FA:
        size = None
        for _ in range(_unpack("<H", s, 6)[0]):
            if size is not None:
                at += size - 6
                if at < 0:
                    raise Refused("[Errno 22] Invalid argument")
            s = d[at:at + 6]
            at += len(s)
            kind = _unpack("<H", s, 4)[0]
            if kind in (4, 11):
                at = _fli_palette(d, at)
                break
            size = _unpack("<I", s, 0)[0]
            if not size:
                break
    if not d[128:132]:
        raise PassOn("missing frame size")
    _unpack("<I", d, 128)
    return _opened("P", w, h)


def _fli_palette(d, at):
    i = 0
    (count,) = _unpack("<H", d, at)
    at += 2
    for _ in range(count):
        s = d[at:at + 2]
        at += len(s)
        i += s[0]
        n = s[1] or 256
        s = d[at:at + 3 * n]
        at += len(s)
        for k in range(0, len(s), 3):
            s[k + 2]
            if i >= 256:
                raise PassOn("list assignment index out of range")
            i += 1
    return at


def _probe_ftex(d):
    """FtexImagePlugin: one format, seek to its mipmap and read its size;
    DXT1 or uncompressed."""
    _unpack("<i", d, 4)
    w, h = _unpack("<2i", d, 8)
    _, count = _unpack("<2i", d, 16)
    if count != 1:
        raise Refused("AssertionError (a multi-format FTEX file)")
    fmt, where = _unpack("<2i", d, 24)
    if where < 0:
        raise Refused("[Errno 22] Invalid argument")
    _unpack("<i", d, where)
    if fmt not in (0, 1):
        raise Refused(f"Invalid texture compression format: {fmt}")
    return _opened("RGBA" if fmt == 0 else "RGB", w, h)


def _probe_mcidas(d):
    """McIdasImagePlugin: a 256-byte area directory of format 1, 2 or 4."""
    if len(d) < 256:
        raise PassOn("not an McIdas area file")
    w = (0,) + struct.unpack_from(">64i", d, 0)
    if w[11] not in (1, 2, 4):
        raise PassOn("unsupported McIdas format")
    return _opened("L", w[10], w[9])


def _probe_msp(d):
    """MspImagePlugin: the header's 16-bit words XOR to zero."""
    s = d[:32]
    checksum = 0
    for i in range(0, 32, 2):
        checksum ^= _unpack("<H", s, i)[0]
    if checksum != 0:
        raise PassOn("bad MSP checksum")
    w, h = _unpack("<HH", s, 4)
    return _opened("1", w, h)


def _probe_pixar(d):
    """PixarImagePlugin: 14-bit RGB, the only mode it names."""
    s = d[:512]
    h, w = _unpack("<HH", s, 416)
    mode = _unpack("<HH", s, 424)
    return _opened("RGB" if mode == (14, 2) else None, w, h)


def _probe_sun(d):
    """SunImagePlugin: depth 1, 4, 8, 24 or 32, an RGB palette of at most
    1024 bytes, file types 0-5."""
    s = d[:32]
    w, h, depth, _, kind, ptype, plen = _unpack(">7I", s, 4)
    if depth not in (1, 4, 8, 24, 32):
        raise PassOn("Unsupported Mode/Bit Depth")
    if plen:
        if plen > 1024:
            raise PassOn("Unsupported Color Palette Length")
        if ptype != 1:
            raise PassOn("Unsupported Palette Type")
    if kind not in (0, 1, 2, 3, 4, 5):
        raise PassOn("Unsupported Sun Raster file type")
    return _opened("1", w, h)


_XBM_HEAD = re.compile(
    rb"\s*#define[ \t]+.*_width[ \t]+(?P<width>[0-9]+)[\r\n]+"
    b"#define[ \t]+.*_height[ \t]+(?P<height>[0-9]+)[\r\n]+"
    b"(?P<hotspot>"
    b"#define[ \t]+[^_]*_x_hot[ \t]+(?P<xhot>[0-9]+)[\r\n]+"
    b"#define[ \t]+[^_]*_y_hot[ \t]+(?P<yhot>[0-9]+)[\r\n]+"
    b")?"
    rb"[\000-\377]*_bits\[]")


def _probe_xbm(d):
    """XbmImagePlugin: the #define header in the first 512 bytes."""
    m = _XBM_HEAD.match(d[:512])
    if not m:
        raise PassOn("not a XBM file")
    return _opened("1", int(m.group("width")), int(m.group("height")))


_XPM_HEAD = re.compile(b'"([0-9]*) ([0-9]*) ([0-9]*) ([0-9]*)')


def _probe_xpm(d):
    """XpmImagePlugin: the values line, then each colour line's "c" key."""
    f = _Lines(d, 9)
    while True:
        line = f.readline()
        if not line:
            raise PassOn("broken XPM file")
        m = _XPM_HEAD.match(line)
        if m:
            break
    w, h, colours, bpp = (_int(m.group(k)) for k in (1, 2, 3, 4))
    for _ in range(colours):
        line = f.readline().rstrip()
        s = line[bpp + 1:-2].split()
        for i in range(0, len(s), 2):
            if s[i] == b"c":
                if i + 1 >= len(s):
                    raise PassOn("list index out of range")
                rgb = s[i + 1]
                if rgb.startswith(b"#"):
                    try:
                        int(rgb[1:], 16)
                    except ValueError as e:
                        raise Refused(str(e)) from e
                elif rgb != b"None":
                    raise Refused("cannot read this XPM file")
                break
        else:
            raise Refused("cannot read this XPM file")
    return _opened("P", w, h)


def _probe_xvthumb(d):
    """XVThumbImagePlugin: comment lines, then "width height"."""
    f = _Lines(d, 6)
    f.readline()
    while True:
        s = f.readline()
        if not s:
            raise PassOn("Unexpected EOF reading XV thumbnail file")
        if s[0] != 35:
            break
    fields = s.strip().split(maxsplit=2)[:2]
    if len(fields) < 2:
        raise Refused("not enough values to unpack")
    return _opened("P", _int(fields[0]), _int(fields[1]))


def _probe_avif(d):
    from gpupathtracer_tpu_torch.utils.avif import probe
    probe(d)
    return True


def _probe_icns(d):
    from gpupathtracer_tpu_torch.utils.icns import probe
    return probe(d)


# (format, accept, probe) in Image.ID order.
PLUGINS = (
    ("BMP", _bmp, _probe_bmp), ("DIB", _dib, _probe_dib),
    ("GIF", _gif, None), ("JPEG", _jpeg, _probe_jpeg),
    ("PPM", _ppm, _probe_ppm), ("PNG", _png, None),
    ("AVIF", _avif, _probe_avif), ("BLP", _starts(b"BLP1", b"BLP2"), _probe_blp),
    ("BUFR", _starts(b"BUFR", b"ZCZC"), None),
    ("CUR", _starts(b"\0\0\2\0"), _probe_cur), ("PCX", _pcx, _probe_pcx),
    ("DCX", _dcx, _probe_dcx), ("DDS", _starts(b"DDS "), None),
    ("EPS", _eps, None), ("FITS", _starts(b"SIMPLE"), _probe_fits),
    ("FLI", _fli, _probe_fli),
    ("FTEX", _starts(b"FTEX"), _probe_ftex),
    ("GBR", _gbr, _probe_gbr), ("GRIB", _grib, None),
    ("HDF5", _starts(b"\x89HDF\r\n\x1a\n"), None),
    ("JPEG2000", _starts(b"\xff\x4f\xff\x51",
                         b"\x00\x00\x00\x0cjP  \x0d\x0a\x87\x0a"),
     _probe_jpeg2000),
    ("ICNS", _starts(b"icns"), _probe_icns),
    ("ICO", _starts(b"\0\0\1\0"), _probe_ico),
    ("IM", _always, _probe_im), ("IMT", _always, _probe_imt),
    ("IPTC", _always, _probe_iptc),
    ("MCIDAS", _starts(b"\x00\x00\x00\x00\x00\x00\x00\x04"),
     _probe_mcidas),
    ("MPEG", _starts(b"\x00\x00\x01\xb3"), None), ("TIFF", _tiff, None),
    ("MSP", _starts(b"DanM", b"LinS"), _probe_msp),
    ("PCD", _always, _probe_pcd),
    ("PIXAR", _starts(b"\200\350\000\000"), _probe_pixar),
    ("PSD", _starts(b"8BPS"), _probe_psd),
    ("QOI", _starts(b"qoif"), _probe_qoi), ("SGI", _sgi, _probe_sgi),
    ("SPIDER", _always, _probe_spider),
    ("SUN", _sun, _probe_sun), ("TGA", _always, _probe_tga),
    ("WEBP", _webp, None),
    ("WMF", _starts(b"\xd7\xcd\xc6\x9a\x00\x00", b"\x01\x00\x00\x00"),
     _probe_wmf),
    ("XBM", _xbm, _probe_xbm),
    ("XPM", _starts(b"/* XPM */"), _probe_xpm),
    ("XVTHUMB", _starts(b"P7 332"), _probe_xvthumb),
)


def identify(data: bytes, name: str = "<image>") -> str:
    """The format name of the PIL plugin that opens ``data``; ValueError
    naming ``name`` where PIL cannot open it."""
    prefix = data[:16]
    for fmt, accept, probe in PLUGINS:
        if not accept(prefix):
            continue
        try:
            if probe is None or probe(data):
                return fmt
        except Refused as e:
            raise ValueError(f"{name}: PIL's {fmt} plugin refuses the file "
                             f"({e})") from e
        except (PassOn, IndexError, TypeError, KeyError, EOFError,
                struct.error):
            continue
    raise ValueError(f"{name}: no image format identifies the file (PIL: "
                     f"cannot identify image file; first bytes "
                     f"{data[:8]!r})")
