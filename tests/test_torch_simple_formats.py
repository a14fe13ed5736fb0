"""The simple image formats PIL reads (ROADMAP.md C6, fifth part), held
bitwise to PIL's ``Image.open(path).convert("RGB")`` on the CPU: PNM and
PFM (P1-P6, P0CMYK, Pf and PIL's PyP, PyRGBA and PyCMYK; utils/pnm.py),
QOI (utils/qoi.py), ICO and CUR (utils/ico.py, utils/io.py decode_cur),
SGI (utils/sgi.py: raw and run-length, 8 and 16 bits), PCX (utils/pcx.py)
and DIB (a BMP without its file header). Every case writes a file and
holds the port's ``decode_image`` to PIL's decode of that path, the port's
``load_image`` to the JAX package's, and ``identify`` to the plugin PIL
picks; where PIL fails, the port raises ValueError naming the file and
both packages' build_atlas skip the map.

The files come from PIL's own writers and from the writers of
tools/torch_image_fixtures.py (plain PNM, run-length SGI, planar PCX, CUR
and ICO directories), which PIL's options do not reach. PIL and the JAX
package are imported inside the tests that use them: the card's test at
the end runs on the machine with the card, which has neither.

    python -m pytest tests/test_torch_simple_formats.py -m cuda --noconftest -q
"""

import hashlib
import importlib.util
import io as _bio
import json
import os
import shutil
import struct

import numpy as np
import pytest

from gpupathtracer_tpu_torch.utils import io
from gpupathtracer_tpu_torch.utils.identify import identify

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "golden", "images")
FORMATS = ("PPM", "QOI", "ICO", "CUR", "SGI", "PCX", "DIB")
# Phase 24b's town: each map's file, decoding to the map's PNG twin.
TOWN_SIMPLE = {"checker": "checker.ppm", "bricks": "bricks.qoi",
               "roof": "roof.sgi", "foliage": "foliage.pcx"}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_image_fixtures", os.path.join(REPO, "tools",
                                             "torch_image_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


W = _tool()


def _photo(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(x / 5.0 + c) * np.cos(y / 4.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def _pil_path(path):
    """PIL's (convert("RGB"), format) of the file opened by its path, as
    the JAX package opens it, or (None, None) where PIL fails."""
    import warnings

    from PIL import Image
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(path)
            return np.asarray(im.convert("RGB")), im.format
    except Exception:
        return None, None


def _pil_save(img, fmt, **kw) -> bytes:
    from PIL import Image
    buf = _bio.BytesIO()
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img.save(buf, fmt, **kw)
    return buf.getvalue()


def _hold(folder, name: str, data: bytes, pil_reads=True):
    """decode_image bitwise PIL's decode of the file and load_image bitwise
    the JAX package's, identify PIL's plugin; or (``pil_reads`` False)
    PIL fails, the JAX loader raises and the port raises ValueError naming
    the file. ``pil_reads=None``: whichever PIL does. Returns the port's
    decode or None."""
    from gpupathtracer_tpu.utils import io as jax_io

    path = os.path.join(str(folder), name)
    with open(path, "wb") as f:
        f.write(data)
    want, fmt = _pil_path(path)
    if pil_reads is not None:
        assert (want is not None) == pil_reads, name
    if want is None:
        with pytest.raises(ValueError, match=name):
            io.decode_image(data, path)
        with pytest.raises(ValueError, match=name):
            io.load_image(path)
        with pytest.raises(Exception):
            jax_io.load_image(path)
        return None
    assert identify(data, name) == fmt, name
    got = io.decode_image(data, name)
    assert got.dtype == np.uint8 and got.shape == want.shape, name
    assert got.tobytes() == want.tobytes(), name
    loaded = io.load_image(path)
    assert loaded.tobytes() == jax_io.load_image(path).tobytes(), name
    return got


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return tmp_path_factory.mktemp("simple")


# --- PNM and PFM -------------------------------------------------------------

def _pnm_cases():
    rng = np.random.RandomState(1)
    px = _photo(10, 13, 2)
    g = px[..., 0]
    bits = (g > 120).astype(int)
    F = np.array([[-1, 0.5, 3.7, 255.5, 254.999, 1e10, np.inf, -np.inf,
                   np.nan, -0.0, 128.25, 77.0]], np.float32)
    return {
        "p1_comments.pbm": W.write_pnm(b"P1", bits, comments=True),
        "p1_spaces.pbm": b"P1 13 10\n" + b" ".join(
            b"%d" % v for v in bits.reshape(-1)) + b"\n",
        "p2_1.pgm": W.write_pnm(b"P2", bits, maxval=1),
        "p2_2.pgm": W.write_pnm(b"P2", rng.randint(0, 3, (6, 5)), maxval=2),
        "p2_1000.pgm": W.write_pnm(b"P2", np.arange(30).reshape(5, 6) * 25,
                                   maxval=1000, comments=True),
        "p2_65535.pgm": W.write_pnm(b"P2", g.astype(int) * 200,
                                    maxval=65535),
        "p3_7.ppm": W.write_pnm(b"P3", px // 37, maxval=7, per_line=3),
        "p3_300.ppm": W.write_pnm(b"P3", px.astype(int) + 40, maxval=300),
        "p4.pbm": W.write_pnm(b"P4", bits),
        "p5_2.pgm": W.write_pnm(b"P5", rng.randint(0, 3, (6, 5)), maxval=2),
        "p5_255.pgm": W.write_pnm(b"P5", g),
        "p5_300.pgm": W.write_pnm(b"P5", g.astype(int) % 4, maxval=300),
        "p5_65535.pgm": W.write_pnm(b"P5", g.astype(int) * 7 + 3,
                                    maxval=65535),
        "p6_100.ppm": W.write_pnm(b"P6", px, maxval=100),
        "p6_1000.ppm": W.write_pnm(b"P6", px.astype(int) * 4, maxval=1000),
        "p0cmyk.pam": W.write_pnm(b"P0CMYK", rng.randint(0, 256, (5, 7, 4))),
        "p0cmyk_511.pam": W.write_pnm(b"P0CMYK", rng.randint(
            0, 512, (5, 7, 4)), maxval=511),
        "pyp.ppm": W.write_pnm(b"PyP", rng.randint(0, 256, (4, 6))),
        "pyrgba.ppm": W.write_pnm(b"PyRGBA", rng.randint(0, 256, (4, 6, 4))),
        "pyrgba_9.ppm": W.write_pnm(b"PyRGBA", rng.randint(0, 10, (4, 6, 4)),
                                    maxval=9),
        "pycmyk.ppm": W.write_pnm(b"PyCMYK", rng.randint(0, 256, (4, 6, 4))),
        "pf_le.pfm": W.write_pnm(b"Pf", F, scale=-1.0),
        "pf_be.pfm": W.write_pnm(b"Pf", F * 2, scale=3.5),
        "crlf.ppm": b"P6\r\n3 2\r\n255\r" + px[:2, :3].tobytes(),
        "token_comment.pgm": b"P5 1#x\n3 2 2#c\n55\n" + g[:2, :13].tobytes(),
        "plus_zeros.pgm": b"P2\n+3 002\n0255\n1 2 3\n4 5 +6\n",
        "tail_junk.pgm": b"P2 2 1 9 3 4 junk\n",
    }


@pytest.mark.parametrize("case", sorted(_pnm_cases()))
def test_pnm_modes(folder, case):
    """Every magic PIL lists at maxvals 1 to 65535 (half-way values round
    to even, grey past 255 is mode I and clips, binary values past maxval
    clip), PFM in both byte orders with NaN, infinities, negatives and
    fractions (truncated and clipped), headers with comments inside
    tokens, CR LF line ends, signs and leading zeros."""
    _hold(folder, case, _pnm_cases()[case])


def test_pnm_files_pil_writes(folder):
    from PIL import Image
    px = _photo(9, 14, 3)
    im = Image.fromarray(px)
    for name, img in (("w.ppm", im), ("w.pgm", im.convert("L")),
                      ("w.pbm", im.convert("1")),
                      ("w16.pgm", Image.fromarray(
                          px[..., 0].astype(np.int32) * 250, "I")),
                      ("wf.pfm", Image.fromarray(
                          px[..., 1].astype(np.float32) * 1.5 - 20, "F"))):
        _hold(folder, name, _pil_save(img, "PPM"))


def test_pnm_refusals(folder):
    """Colour PFM ("PF": PIL lists no such magic and no plugin takes the
    file), a bad maxval, scale or token, a plain value past maxval or
    negative, a plain bitmap with another digit, data cut short, a size of
    0: PIL fails, the port raises ValueError naming the file."""
    rng = np.random.RandomState(4)
    g = rng.randint(0, 256, (4, 5))
    cases = {
        "colour.pfm": b"PF\n2 2\n-1.0\n" + b"\0" * 48,
        "maxval0.pgm": b"P5\n2 2\n0\n" + b"\0" * 4,
        "maxval65536.pgm": b"P5\n2 2\n65536\n" + b"\0" * 8,
        "scale0.pfm": b"Pf\n2 2\n0.0\n" + b"\0" * 16,
        "scaleinf.pfm": b"Pf\n2 2\ninf\n" + b"\0" * 16,
        "word.ppm": b"P6\ntwo 2\n255\n" + b"\0" * 12,
        "long.pgm": b"P5\n000000000002 2\n255\n" + b"\0" * 4,
        "eof.pgm": b"P5\n2 2\n",
        "big.pgm": b"P2\n2 1\n10\n5 11\n",
        "neg.pgm": b"P2\n2 1\n10\n5 -1\n",
        "digit.pbm": b"P1\n2 1\n0 2\n",
        "short.ppm": W.write_pnm(b"P6", np.stack([g] * 3, -1))[:-1],
        "short_plain.pgm": b"P2\n2 2\n255\n1 2 3\n",
        "zero.pgm": b"P5\n0 2\n255\n",
    }
    for name, data in cases.items():
        _hold(folder, name, data, pil_reads=False)


# --- QOI ---------------------------------------------------------------------

def _qoi(w, h, ops: bytes, channels=4) -> bytes:
    return b"qoif" + struct.pack(">IIBB", w, h, channels, 0) + ops + \
        b"\0" * 7 + b"\1"


def test_qoi(folder):
    """PIL's writer (RGB, RGBA), and op streams PIL's decoder reads its own
    way: an index never written (0, 0, 0, 0, which then enters slot 0),
    runs that do not enter the table, every op, a channels byte of 0 or 7
    (RGBA), wrapping diffs and lumas, a stream without its end marker."""
    px = _photo(12, 9, 5)
    rgba = np.concatenate([px, px[..., :1]], -1)
    _hold(folder, "rgb.qoi", _pil_save(px, "QOI"))
    _hold(folder, "rgba.qoi", _pil_save(rgba, "QOI"))
    rgb_op = b"\xfe\x10\x20\x30"
    ops = (b"\x05"                      # an empty slot: 0, 0, 0, 0
           + rgb_op + b"\xc2"           # a pixel, then a run of 3
           + b"\x00"                    # slot 0: the index op's pixel
           + b"\x40\x7f"                # diffs that wrap below 0 and up
           + b"\x80\x88\x3f\xff"        # lumas at both ends
           + b"\xff\x01\x02\x03\x04" + b"\xc0"
           + bytes([(0x10 * 3 + 0x20 * 5 + 0x30 * 7 + 255 * 11) % 64])
           + b"\xc2")                  # the 16th pixel
    for channels in (3, 4, 0, 7):
        _hold(folder, f"ops{channels}.qoi", _qoi(4, 4, ops, channels))
    _hold(folder, "nomarker.qoi", _qoi(4, 4, ops)[:-8])
    _hold(folder, "run_past.qoi", _qoi(3, 1, b"\xfe\x01\x02\x03\xfd"))


def test_qoi_refusals(folder):
    """Data that ends inside an op or before the last pixel, and a size of
    0 (no plugin takes it)."""
    ops = b"\xfe\x10\x20\x30\xc2"
    for name, data in (("cut_op.qoi", _qoi(4, 4, ops[:3])),
                       ("few.qoi", _qoi(4, 4, ops)[:-8]),
                       ("luma_cut.qoi", _qoi(2, 1, b"\x80")[:-8]),
                       ("empty.qoi", _qoi(0, 4, ops))):
        _hold(folder, name, data, pil_reads=False)


# --- ICO and CUR -------------------------------------------------------------

def test_ico_files_pil_writes(folder):
    """PNG frames at three sizes, and bitmap frames of every depth PIL
    writes (1 bit, 8-bit palette and grey, 24 and 32 bits)."""
    from PIL import Image
    px = _photo(32, 32, 6)
    im = Image.fromarray(px)
    _hold(folder, "png.ico", _pil_save(im, "ICO", sizes=[(16, 16), (24, 24),
                                                         (32, 32)]))
    _hold(folder, "pal_png.ico", _pil_save(im.quantize(12), "ICO",
                                           sizes=[(32, 32)]))
    for tag, img in (("1", im.convert("1")), ("p", im.quantize(30)),
                     ("l", im.convert("L")), ("rgb", im),
                     ("rgba", im.convert("RGBA"))):
        _hold(folder, f"bmp_{tag}.ico", _pil_save(
            img, "ICO", bitmap_format="bmp", sizes=[(16, 16), (32, 32)]))


def test_ico_directories(folder):
    """The entry PIL loads: entries of one size sorted stably by colour
    depth (bpp, else ceil(log2(colours)), else 256), then by area largest
    first; a 0 byte is 256; a frame whose size differs from its entry's
    keeps its own; 4-bit frames (mode L at 4 bits from a stream: the raw
    decoder reads a byte a pixel where the stride holds it), a PNG frame
    beside bitmap ones."""
    rng = np.random.RandomState(7)
    px = _photo(24, 24, 8)
    pal = rng.randint(0, 256, (16, 3))
    grey16 = np.repeat(np.arange(16)[:, None], 3, 1)    # PIL's mode L
    a = W.icon_bitmap(px[:16, :16], 24)
    b = W.icon_bitmap(px[:16, :16, 0] % 16, 4, palette=pal)
    c = W.icon_bitmap(px[8:24, 8:24], 24)
    png = _pil_save(px[:8, :8], "PNG")
    cases = {
        "depth_tie.ico": [(a, 16, 16, 0, 1, 24), (b, 16, 16, 16, 1, 0)],
        "order_tie.ico": [(a, 16, 16, 0, 1, 24), (c, 16, 16, 0, 1, 24)],
        "colours8.ico": [(a, 16, 16, 0, 1, 0), (b, 16, 16, 8, 1, 0)],
        "colours1.ico": [(b, 16, 16, 1, 1, 0), (a, 16, 16, 0, 1, 8)],
        "zero_byte.ico": [(a, 255, 255, 0, 1, 24), (W.icon_bitmap(
            px, 24), 0, 0, 0, 1, 24)],
        "mismatch.ico": [(W.icon_bitmap(px[:20, :12], 24), 16, 16, 0, 1,
                          24)],
        "grey4.ico": [(W.icon_bitmap(px[:4, :4, 0] % 16, 4, palette=grey16),
                       4, 4, 16, 1, 4)],
        "grey4_wide.ico": [(W.icon_bitmap(px[:9, :9, 0] % 16, 4,
                                          palette=grey16), 9, 9, 16, 1, 4)],
        "png_and_bmp.ico": [(a, 16, 16, 0, 1, 24), (png, 8, 8, 0, 1, 32)],
        "png_first.ico": [(png, 0, 0, 0, 1, 32), (a, 16, 16, 0, 1, 24)],
    }
    for name, frames in cases.items():
        _hold(folder, name, W.write_icon(frames), pil_reads=None)


def test_ico_refusals(folder):
    """A frame cut inside its AND mask or its alpha bytes (they change
    only alpha, but PIL reads them), a bitmap of one row, an entry past
    the file, no entries, a directory cut short: PIL fails."""
    px = _photo(16, 16, 9)
    a = W.icon_bitmap(px, 24)
    full = W.write_icon([(a, 16, 16, 0, 1, 24)])
    alpha = W.write_icon([(W.icon_bitmap(px, 32), 16, 16, 0, 1, 32)])
    one = W.write_icon([(W.icon_bitmap(px[:1], 24)[:8] + struct.pack(
        "<i", 1) + W.icon_bitmap(px[:1], 24)[12:], 16, 1, 0, 1, 24)])
    for name, data in (("mask_cut.ico", full[:-40]),
                       ("alpha_cut.ico", alpha[:-64 - 200]),
                       ("one_row.ico", one),
                       ("past.ico", full[:18] + struct.pack("<I", 9999)
                        + full[22:]),
                       ("none.ico", b"\0\0\1\0\0\0"),
                       ("dir_cut.ico", full[:15])):
        _hold(folder, name, data, pil_reads=False)


def test_cur(folder):
    """CurImagePlugin's pick: the first entry, replaced only by a later
    one whose width and height bytes are both strictly larger (a 0 byte
    is 0, not 256); an entry offset of 0 reads the bitmap where the
    directory ends; the bitmap's height halved; 4-bit and 1-bit cursors."""
    rng = np.random.RandomState(10)
    px = _photo(24, 24, 11)
    a = W.icon_bitmap(px[:16, :12], 24)
    b = W.icon_bitmap(px[:24, :16], 24)
    c = W.icon_bitmap(px, 24)
    mono = W.icon_bitmap(px[:16, :16, 0] > 128, 1, palette=[(0, 0, 0),
                                                            (255, 255, 255)])
    cases = {
        "strict.cur": [(a, 12, 16, 0, 1, 1), (b, 16, 24, 0, 2, 2),
                       (c, 24, 0, 0, 3, 3)],
        "equal.cur": [(a, 16, 16, 0, 1, 1), (b, 16, 24, 0, 2, 2)],
        "zero_first.cur": [(c, 0, 0, 0, 1, 1), (a, 12, 16, 0, 2, 2)],
        "pal4.cur": [(W.icon_bitmap(px[:16, :16, 1] % 16, 4,
                                    palette=rng.randint(0, 256, (16, 3))),
                      16, 16, 16, 4, 4)],
        "mono.cur": [(mono, 16, 16, 2, 0, 0)],
    }
    for name, frames in cases.items():
        _hold(folder, name, W.write_icon(frames, kind=2))
    # An entry offset of 0: the bitmap right after the directory.
    data = W.write_icon([(a, 12, 16, 0, 1, 1)], kind=2)
    _hold(folder, "offset0.cur", data[:18] + b"\0" * 4 + data[22:])


def test_cur_and_tga_share_a_magic(folder):
    """A cursor whose bitmap is one row (none under its mask) and one with
    no entries: PIL passes both on, as the port does; the TGA of type 2
    they start as (its header is the cursor's directory) decides."""
    px = _photo(2, 16, 12)
    one = W.icon_bitmap(px[:1], 24)
    data = W.write_icon([(one, 16, 1, 0, 1, 1)], kind=2)
    _hold(folder, "one_row.cur", data, pil_reads=None)
    _hold(folder, "none.cur", b"\0\0\2\0\0\0" + b"\0" * 40, pil_reads=None)


# --- SGI ---------------------------------------------------------------------

def test_sgi(folder):
    """PIL's writer (grey, RGB and RGBA at 8 and 16 bits, raw), and
    run-length files at 8 and 16 bits in each mode PIL lists, dimension 1
    and 2 grey."""
    px = _photo(9, 11, 13)
    rgba = np.concatenate([px, px[..., 2:]], -1)
    for tag, img in (("l", px[..., 0]), ("rgb", px), ("rgba", rgba)):
        for bpc in (1, 2):
            _hold(folder, f"pil_{tag}{bpc}.sgi", _pil_save(img, "SGI",
                                                           bpc=bpc))
    w16 = px.astype(np.uint16) * 257 + np.arange(11, dtype=np.uint16)[:, None]
    for tag, img in (("l", px[..., 0]), ("rgb", px), ("rgba", rgba)):
        _hold(folder, f"rle_{tag}.sgi", W.write_sgi(img))
        w = {"l": w16[..., :1], "rgb": w16,
             "rgba": np.concatenate([w16, w16[..., :1]], -1)}[tag]
        _hold(folder, f"rle16_{tag}.sgi", W.write_sgi(w, bpc=2))
    _hold(folder, "dim1.bw", W.write_sgi(px[:1, :, 0], dimension=1))
    _hold(folder, "dim1_tall.bw", W.write_sgi(px[..., 0], dimension=1))
    _hold(folder, "raw16.sgi", W.write_sgi(w16, bpc=2, rle=False))


def test_sgi_rle_as_pillow_decodes_it(folder):
    """SgiRleDecode.c's reading of the tables and chunks: a row whose
    chunks stop short keeps the previous row's samples, a row whose last
    chunk is not the terminator stops the decode (later rows stay black),
    lengths that are only chunk counts (0, 1, past the file), rows shared
    by two table entries, 16-bit atoms whose high byte is ignored."""
    px = (np.arange(20).reshape(4, 5) * 9 + 3).astype(np.uint8)
    rgb = np.stack([px, px[::-1], 255 - px], -1)
    w16 = (np.arange(20).reshape(4, 5) * 3000 + 7).astype(np.uint16)
    cases = {
        "short_row.sgi": W.write_sgi(px, rows={(1, 0): b"\x82\x01\x02\0"}),
        "stop.sgi": W.write_sgi(px, rows={(1, 0): b"\x81\x32\x81\x3c\0"},
                                lengths={(1, 0): 2}),
        "stop_rgb.sgi": W.write_sgi(rgb, rows={(2, 1): b"\x81\x32\x81\x3c"},
                                    lengths={(2, 1): 2}),
        "len0.sgi": W.write_sgi(px, lengths={(1, 0): 0}),
        "len1.sgi": W.write_sgi(px, lengths={(1, 0): 1}),
        "len_past.sgi": W.write_sgi(px, lengths={(1, 0): 2 ** 31 + 5}),
        "run.sgi": W.write_sgi(rgb, rows={(0, 2): b"\x05\x4d\0"}),
        "hi16.sgi": W.write_sgi(w16, bpc=2, rows={
            (1, 0): b"\xff\x05\x12\x34\0\0"}),
    }
    for name, data in cases.items():
        _hold(folder, name, data)
    shared = bytearray(W.write_sgi(px))
    shared[512 + 4:512 + 8] = shared[512:512 + 4]      # rows 0 and 1 alike
    _hold(folder, "shared.sgi", bytes(shared))


def test_sgi_refusals(folder):
    """A mode PIL does not list, a compression PIL has no decoder for, raw
    data cut short, a run or copy past the data or past the row, a start
    below the header, tables longer than the data: PIL fails."""
    px = (np.arange(20).reshape(4, 5) * 9 + 3).astype(np.uint8)
    raw = W.write_sgi(np.stack([px] * 3, -1), rle=False)
    bad_mode = bytearray(raw)
    bad_mode[11] = 2                    # 2 channels at dimension 3
    comp2 = bytearray(raw)
    comp2[2] = 2
    rle = W.write_sgi(px)
    low = bytearray(rle)
    low[512:516] = struct.pack(">I", 100)
    cases = {
        "mode.sgi": bytes(bad_mode), "comp2.sgi": bytes(comp2),
        "raw_cut.sgi": raw[:-1], "rle_cut.sgi": rle[:-1],
        "wide.sgi": W.write_sgi(px, rows={(1, 0): b"\x86\1\2\3\4\5\6\0"}),
        "last_run.sgi": W.write_sgi(px, rows={(3, 0): b"\x05\x09"}),
        "low.sgi": bytes(low), "tables.sgi": rle[:512 + 20],
        "rle16_cut.sgi": W.write_sgi(px.astype(np.uint16) * 300, bpc=2)[:-2],
    }
    for name, data in cases.items():
        _hold(folder, name, data, pil_reads=False)


# --- PCX ---------------------------------------------------------------------

def test_pcx(folder):
    """PIL's writer (1, L, P, RGB), and files it does not write: 1-bit in
    2 and 4 planes at every header stride (PIL's own stride, made even
    where the header's differs, decides where each plane starts), 8 bits
    without the palette marker (grey) or with the grey ramp (grey), RGB
    at odd widths with and without padding, a box off the origin."""
    from PIL import Image
    rng = np.random.RandomState(14)
    px = _photo(9, 13, 15)
    im = Image.fromarray(px)
    for tag, img in (("1", im.convert("1")), ("l", im.convert("L")),
                     ("p", im.quantize(40)), ("rgb", im)):
        _hold(folder, f"pil_{tag}.pcx", _pil_save(img, "PCX"))
    pal = rng.randint(0, 256, (16, 3))
    for planes in (2, 4):
        for w in (3, 8, 13, 21):
            for stride in (None, (w + 7) // 8, 5):
                # A header stride PIL does not take moves its lines:
                # runs may then cross them, and PIL fails.
                name = f"planes{planes}_{w}_{stride}.pcx"
                _hold(folder, name, W.write_pcx(rng.randint(
                    0, 2, (planes, 5, w)), 1, version=rng.choice([0, 2, 3, 5]),
                    palette=pal, stride=stride), pil_reads=None)
    ramp = np.repeat(np.arange(256)[:, None], 3, 1)
    _hold(folder, "l_nomarker.pcx", W.write_pcx(px[None, ..., 0], 8) +
          b"\0" * 800)
    _hold(folder, "l_ramp.pcx", W.write_pcx(px[None, ..., 0], 8, tail=ramp))
    _hold(folder, "p_tail.pcx", W.write_pcx(
        px[None, ..., 0], 8, tail=rng.randint(0, 256, (256, 3))))
    for w, stride in ((13, 13), (13, 14), (1, 2), (3, 4), (5, 7)):
        _hold(folder, f"rgb_{w}_{stride}.pcx", W.write_pcx(
            px[:, :w].transpose(2, 0, 1), 8, stride=stride),
            pil_reads=None if stride == 7 else True)
    _hold(folder, "box.pcx", W.write_pcx(px.transpose(2, 0, 1), 8,
                                         box=(5, 300)))
    _hold(folder, "mono.pcx", W.write_pcx(rng.randint(0, 2, (1, 6, 19)), 1,
                                          stride=3))


def test_pcx_refusals(folder):
    """A run that crosses a line's end (PcxDecode.c's overrun), data cut
    short, an 8-bit file shorter than the 769 bytes PIL seeks back from
    its end, modes PIL does not know; an empty box passes the file on
    and no plugin takes it."""
    px = _photo(6, 8, 16)
    good = W.write_pcx(px.transpose(2, 0, 1), 8)
    # Line 0 (24 bytes: three planes of 8) ends inside a run of 2.
    cross = good[:128] + bytes([0xC0 | 23, 7, 0xC2, 7]) + b"".join(
        W.pcx_rle(px[y].transpose(1, 0).tobytes()) for y in range(1, 6))
    small = W.write_pcx(px[None, :4, :4, 0], 8)
    for name, data in (
            ("cross.pcx", bytes(cross)), ("cut.pcx", good[:-3]),
            ("small_l.pcx", small),
            ("bits2.pcx", good[:3] + b"\2" + good[4:]),
            ("planes3_1bit.pcx", W.write_pcx(np.zeros((3, 2, 8), int), 1)),
            ("v0_8bit.pcx", good[:1] + b"\0" + good[2:]),
            ("empty_box.pcx", good[:4] + struct.pack("<H", 9) + good[6:])):
        _hold(folder, name, data, pil_reads=False)


# --- DIB ---------------------------------------------------------------------

def test_dib(folder):
    """PIL's BMP files without their 14-byte file header, at every depth
    PIL writes, a 16-bit bit-field DIB (the masks after a 40-byte
    header), an OS/2 1.x header, RLE8; the pixels start where PIL's
    _bitmap puts them: after the header, the masks and the palette."""
    from PIL import Image
    px = _photo(7, 10, 17)
    im = Image.fromarray(px)
    for tag, img in (("1", im.convert("1")), ("l", im.convert("L")),
                     ("p", im.quantize(20)), ("rgb", im),
                     ("rgba", im.convert("RGBA"))):
        _hold(folder, f"{tag}.dib", _pil_save(img, "BMP")[14:])
    v = np.random.RandomState(18).randint(0, 65536, (7, 10)).astype("<u2")
    rows = b"".join(r.tobytes() + b"\0" * (-len(r.tobytes()) % 4)
                    for r in v.view(np.uint8).reshape(7, 20)[::-1])
    head = struct.pack("<IiiHHIIiiII", 40, 10, 7, 1, 16, 3, len(rows), 0, 0,
                       0, 0) + struct.pack("<3I", 0xF800, 0x7E0, 0x1F)
    _hold(folder, "bf565.dib", head + rows)
    os2 = struct.pack("<IHHHH", 12, 10, 7, 1, 24) + b"".join(
        r[:, ::-1].tobytes() + b"\0" * (-30 % 4) for r in px[::-1])
    _hold(folder, "os2.dib", os2)
    idx = np.arange(70).reshape(7, 10) % 4
    rle = b"".join(bytes([5, int(r[0]), 5, int(r[5]), 0, 0])
                   for r in idx[::-1]) + b"\0\1"
    pal = b"".join(bytes([b, g, r, 0]) for r, g, b in _photo(1, 4, 19)[0])
    _hold(folder, "rle8.dib", struct.pack(
        "<IiiHHIIiiII", 40, 10, 7, 1, 8, 1, len(rle), 0, 0, 4, 0) + pal + rle)
    _hold(folder, "cut.dib", _pil_save(im, "BMP")[14:-40], pil_reads=False)


# --- mutations ---------------------------------------------------------------

def _mutants(data: bytes, rng, count: int):
    for _ in range(count):
        d = bytearray(data)
        for _ in range(rng.randint(1, 4)):
            if not d:
                break
            k, r = rng.randint(0, len(d)), rng.rand()
            if r < 0.6:
                d[k] = rng.randint(0, 256)
            elif r < 0.8:
                del d[k]
            else:
                d = d[:k]
        yield bytes(d)


def _mutation_seeds(kind: str) -> list:
    from PIL import Image
    px = _photo(12, 10, 20)
    im = Image.fromarray(px)
    rng = np.random.RandomState(21)
    if kind == "ppm":
        return [_pil_save(im, "PPM"), W.write_pnm(
            b"P2", px[..., 0].astype(int) * 3, maxval=1000, comments=True),
            W.write_pnm(b"Pf", rng.uniform(-9, 300, (5, 6)), scale=1.0)]
    if kind == "qoi":
        return [_pil_save(im, "QOI"), _pil_save(im.convert("RGBA"), "QOI")]
    if kind == "ico":
        sq = Image.fromarray(_photo(16, 16, 22))
        return [_pil_save(sq, "ICO", sizes=[(16, 16)]),
                _pil_save(sq.quantize(20), "ICO", bitmap_format="bmp",
                          sizes=[(16, 16)])]
    if kind == "cur":
        return [W.write_icon([(W.icon_bitmap(px[:8, :8], 24), 8, 8, 0, 1, 1),
                              (W.icon_bitmap(px, 24), 10, 12, 0, 2, 2)],
                             kind=2)]
    if kind == "sgi":
        return [W.write_sgi(px), W.write_sgi(px.astype(np.uint16) * 257,
                                             bpc=2),
                _pil_save(im, "SGI")]
    if kind == "pcx":
        return [_pil_save(im, "PCX"), W.write_pcx(
            rng.randint(0, 2, (4, 7, 13)), 1, palette=rng.randint(
                0, 256, (16, 3)), stride=3)]
    return [_pil_save(im, "BMP")[14:], _pil_save(im.quantize(30),
                                                 "BMP")[14:]]


@pytest.mark.parametrize("kind", ["ppm", "qoi", "ico", "cur", "sgi", "pcx",
                                  "dib"])
@pytest.mark.parametrize("seed", [1, 2])
def test_mutations_never_decode_otherwise(tmp_path, kind, seed):
    """Bytes set, deleted or cut off in files of each format: the port
    decodes a mutant to the bits PIL reads from its path, or raises
    ValueError where PIL fails too; NotImplementedError only where PIL
    reads the mutant as a format the port leaves out. No mutant PIL reads
    is refused."""
    rng = np.random.RandomState(seed)
    path = str(tmp_path / "mutant")
    both = refused = 0
    for data in _mutation_seeds(kind):
        for mutant in _mutants(data, rng, 40):
            with open(path, "wb") as f:
                f.write(mutant)
            want, _ = _pil_path(path)
            try:
                got = io.decode_image(mutant, "mutant")
            except ValueError:
                refused += want is not None
                continue
            except NotImplementedError:
                assert want is not None
                continue
            assert want is not None, "the port decodes what PIL cannot"
            assert got.tobytes() == want.tobytes()
            both += 1
    assert both > 5
    assert refused == 0


# --- fixtures and scenes -----------------------------------------------------

def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def test_fixtures_bitwise_their_twins():
    """Every committed fixture of these formats (the card's machine reads
    them without PIL) decodes bitwise its PNG twin and the manifest's
    sha256s, and PIL reads the file to the same pixels; the town's four
    maps among them decode to the town's own PNG twins."""
    import warnings

    from PIL import Image
    manifest = _manifest()
    names = [k for k, e in sorted(manifest.items()) if e["format"] in FORMATS]
    assert len(names) >= 30
    assert {manifest[k]["format"] for k in names} == set(FORMATS)
    for name in names:
        e = manifest[name]
        with open(os.path.join(FIXTURES, e["file"]), "rb") as f:
            data = f.read()
        with open(os.path.join(FIXTURES, e["png"]), "rb") as f:
            png = f.read()
        assert hashlib.sha256(data).hexdigest() == e["file_sha256"], name
        assert hashlib.sha256(png).hexdigest() == e["png_sha256"], name
        got = io.decode_image(data, name)
        assert got.tobytes() == io.decode_png(png, name).tobytes(), name
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            e["pixels_sha256"], name
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            im = Image.open(os.path.join(FIXTURES, e["file"]))
            assert im.format == e["format"] == identify(data), name
            assert np.asarray(im.convert("RGB")).tobytes() == \
                got.tobytes(), name
    for name, fname in TOWN_SIMPLE.items():
        e = next(v for v in manifest.values() if v["file"] == fname)
        assert e["png"] == f"{name}.png"


def test_obj_with_maps_of_every_format(tmp_path):
    """An OBJ whose maps are one file of each format and two files PIL
    cannot read (a cut QOI, colour PFM): load_image bitwise the JAX
    package's, build_atlas's tables bitwise JAX's, the two skipped by
    both."""
    from gpupathtracer_tpu.scene import textures as jax_textures

    from gpupathtracer_tpu_torch.scene import textures
    from test_torch_images import _hold_atlas, _textured_obj

    manifest = _manifest()
    maps = []
    for fmt in FORMATS:
        e = next(v for k, v in sorted(manifest.items())
                 if v["format"] == fmt)
        shutil.copy(os.path.join(FIXTURES, e["file"]), tmp_path)
        maps.append(e["file"])
    (tmp_path / "cut.qoi").write_bytes(_qoi(4, 4, b"\xfe\1\2\3"))
    (tmp_path / "colour.pfm").write_bytes(b"PF\n1 1\n-1.0\n" + b"\0" * 12)
    maps += ["cut.qoi", "colour.pfm"]
    for levels in (1, 4):
        got = textures.build_atlas(maps, str(tmp_path), mip_levels=levels)
        want = jax_textures.build_atlas(maps, str(tmp_path),
                                        mip_levels=levels)
        assert got[2] == want[2] and len(got[2]) == len(FORMATS)
        for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()
    _hold_atlas(dict(scene_path=_textured_obj(str(tmp_path), maps),
                     mip_levels=4))


def test_cube_sky_of_simple_faces(tmp_path):
    """A .txt cube sky whose faces are PPM, QOI, SGI, PCX, ICO and DIB
    files of one size: the environment image bitwise the JAX package's."""
    from gpupathtracer_tpu.scene import envmap as jax_envmap

    from gpupathtracer_tpu_torch.scene import envmap

    faces = {"px.ppm": ("PPM", {}), "nx.qoi": ("QOI", {}),
             "py.sgi": ("SGI", {}), "ny.pcx": ("PCX", {}),
             "pz.ico": ("ICO", dict(sizes=[(16, 16)])), "nz.dib": ("BMP", {})}
    for i, (name, (fmt, kw)) in enumerate(faces.items()):
        data = _pil_save(_photo(16, 16, 30 + i), fmt, **kw)
        (tmp_path / name).write_bytes(data[14:] if fmt == "BMP" else data)
    (tmp_path / "cube.txt").write_text("\n".join(faces) + "\n")
    spec = str(tmp_path / "cube.txt")
    got = envmap.environment_image(spec)
    want = np.asarray(jax_envmap.load_environment(spec).image)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


# --- the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_town_on_simple_formats_on_cuda(tmp_path):
    """Phase 24b in small: the generated town on P6 PPM, QOI, run-length
    SGI and 3-plane PCX maps renders on the card bitwise as on their PNG
    twins (B1 walks the rays)."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paths run the port's kernels")
    import math

    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.render import Renderer
    from gpupathtracer_tpu_torch.scene.samplegen import \
        generate_textured_town

    town = generate_textured_town(str(tmp_path / "town"))
    films = []
    for kind in ("png", "simple"):
        folder = tmp_path / kind
        folder.mkdir()
        shutil.copy(town, folder)
        mtl = (tmp_path / "town" / "town.mtl").read_text()
        for name, fname in TOWN_SIMPLE.items():
            src = fname if kind == "simple" else f"{name}.png"
            shutil.copy(os.path.join(FIXTURES, src), folder)
            mtl = mtl.replace(f"{name}.png", src)
        (folder / "town.mtl").write_text(mtl)
        cfg = RenderConfig(scene_path=str(folder / os.path.basename(town)),
                           width=160, height=90, mip_levels=4,
                           skybox="GENERATE COLOR BLACK")
        cfg.camera = CameraConfig(position=(0.0, 9.0, -26.0), yaw=math.pi,
                                  pitch=-0.28, fov=math.radians(55),
                                  aspect=160 / 90)
        before = kt.LAUNCHES["trace_closest"]
        r = Renderer(cfg, "cuda")
        r.render_frame()
        assert kt.LAUNCHES["trace_closest"] > before
        films.append(r.film_hdr())
    assert films[0].max() > 0
    np.testing.assert_array_equal(films[1].view(np.int32),
                                  films[0].view(np.int32))
