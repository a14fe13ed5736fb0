"""The rest of TIFF as PIL reads it (ROADMAP.md C6, sixth part), held bitwise
to PIL's ``Image.open(path).convert("RGB")`` on the CPU: CCITT (Modified
Huffman byte- and 16-bit-aligned, T.4 1-D and 2-D, T.6; utils/fax_cpp),
ZSTD (utils/zstd_cpp), ThunderScan, old-style LZW, fill order 2,
orientations 2-8, 12-bit, signed and unsigned 32-bit grey, the 16-bit
planes of an uncompressed planar file, YCbCr outside JPEG (libtiff's RGBA
interface), Lab (PIL's LittleCMS transform, utils/lab.py) and a Lab PSD.
Every case writes a file and holds the port's ``decode_image`` to PIL's
decode of that path and ``load_image`` to the JAX package's; where PIL
fails, the port raises ValueError naming the file (LERC, WebP-in-TIFF and
SGILog, and the fill-order-2 layouts PIL's OPEN_INFO lacks, among them).

The files come from PIL's writers and from tools/torch_image_fixtures.py
(its CCITT, ThunderScan and old-style LZW encoders, and the libzstd
Pillow bundles, reached through ctypes). The card's test at the end runs
where neither PIL nor the JAX package is:

    python -m pytest tests/test_torch_tiff_rest.py -m cuda --noconftest -q

The seeded fuzz behind ROADMAP.md C6's counts runs the mutation test's
generator over more seeds:

    python tests/test_torch_tiff_rest.py --fuzz 1-100
"""

import hashlib
import io as _bio
import json
import os
import shutil
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The repository and this folder, for the --fuzz run as a script.
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
from gpupathtracer_tpu_torch.utils import io  # noqa: E402
from test_torch_simple_formats import (  # noqa: E402
    W, _hold, _mutants, _photo, _pil_path)

FIXTURES = os.path.join(REPO, "tests", "golden", "images")
# The fixtures of this slice (tools/torch_image_fixtures.py
# tiff_rest_fixtures).
REST_FIXTURES = (
    "checker_zstd", "bricks_zstd", "roof_zstd", "foliage_zstd", "fax_g3",
    "fax_g4", "fax_mh", "fax_raw16", "fax_t4_2d", "fax_t6_fo2",
    "fax_t6_tiles", "thunderscan", "thunderscan_fo2", "lzw_old",
    "zstd_blocks", "zstd_fo2", "fo2_rgb", "fo2_grey2", "fo2_i16",
    "fo2_palette", *(f"orient{o}" for o in range(2, 9)), "grey12", "int16s",
    "int32s", "uint32", "planar16", "ycbcr22", "ycbcr41", "lab", "lab_psd")
TOWN_ZSTD = {"checker": "checker_zstd.tif", "bricks": "bricks_zstd.tif",
             "roof": "roof_zstd.tif", "foliage": "foliage_zstd.tif"}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return tmp_path_factory.mktemp("tiff_rest")


def _bilevel(h, w, seed):
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w]
    a = ((x // (3 + seed % 5) + y // 4) % 3 == 0) | (
        np.sin(x / 7.0 + seed) * np.cos(y / 3.0) > 0.55)
    return (a ^ (rng.rand(h, w) > 0.97)).astype(np.uint8)


def _pil_tiff(img, **kw) -> bytes:
    from PIL import Image
    buf = _bio.BytesIO()
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img.save(buf, "TIFF", **kw)
    return buf.getvalue()


def _zs(level, checksum=False, content_size=True, window_log=0):
    return lambda rows, bw: W.zstd_compress(b"".join(rows), level, checksum,
                                            content_size, window_log)


# --- CCITT -------------------------------------------------------------------

@pytest.mark.parametrize("comp", ["group3", "group4", "tiff_ccitt",
                                  "tiff_raw_16"])
def test_ccitt_pil_writers(folder, comp):
    """PIL's CCITT writers (libtiff's encoders: T.4 1-D, T.6, Modified
    Huffman, Modified Huffman with 16-bit rows, whose files libtiff reads
    with a bad code word and recovers from) on pictures, a noise field,
    rows of 3,000 pixels with runs past 2,560 and one-pixel rows."""
    from PIL import Image
    rng = np.random.RandomState(7)
    pics = {"pic": _bilevel(37, 45, 1), "noise": (rng.rand(21, 33) > 0.5),
            "wide": np.zeros((5, 3000), np.uint8), "thin": _bilevel(9, 1, 2)}
    pics["wide"][:, 200:2900] = 1
    pics["wide"][2, 100:3000] = 0
    for name, a in pics.items():
        im = Image.fromarray(a.astype(np.uint8) * 255).convert("1")
        _hold(folder, f"{comp}_{name}.tif", _pil_tiff(im, compression=comp),
              pil_reads=None)


@pytest.mark.parametrize("photo", [0, 1])
def test_ccitt_options(folder, photo):
    """The options PIL's writers do not set: T.4 2-D (K = 1, 2 and 4, with
    and without fill bits), T.4 and T.6 in fill order 2, in tiles and in
    strips of a few rows; each compression at fill order 2; a 1-bit
    palette under T.6."""
    a = _bilevel(30, 41, 3 + photo)
    for k in (1, 2, 4):
        for fill in (False, True):
            enc = (lambda rows, bw, k=k, fill=fill: W.fax_encode(
                rows, bw, "t4", k=k, fill_bits=fill))
            _hold(folder, f"t4_2d_{photo}_{k}_{fill}.tif", W.write_tiff(
                a, photo, 1, compression=3, encode=enc,
                tags=[(292, (4, [1 | (4 if fill else 0)]))]))
    for comp in (2, 3, 4, 32771):
        _hold(folder, f"fo2_{photo}_{comp}.tif", W.write_tiff(
            a, photo, 1, compression=comp, fill_order=2))
        _hold(folder, f"rps_{photo}_{comp}.tif", W.write_tiff(
            a, photo, 1, compression=comp, rows_per_strip=7))
    _hold(folder, f"t6_tiles_{photo}.tif", W.write_tiff(
        a, photo, 1, compression=4, tile=(16, 16)))
    _hold(folder, f"t6_palette_{photo}.tif", W.write_tiff(
        a, 3, 1, compression=4, colormap=[0, 65535 - photo * 999] * 3))


def test_ccitt_recovery(folder):
    """libtiff's recovery, bit for bit: rows coded longer or shorter than
    the image (its clean-up of the run array), a bad code word in a
    Modified Huffman row, a T.4 strip that ends in a row and one at 16-bit
    alignment on an odd file offset (both as libtiff ends them), and the
    bits/sample refusal."""
    a = _bilevel(12, 40, 9)
    for delta in (-5, 3, 40):
        wide = _bilevel(12, 40 + delta, 9)
        enc = (lambda rows, bw, wide=wide: W.fax_encode(
            [np.packbits(r).tobytes() for r in wide], 40 + delta, "t4"))
        _hold(folder, f"t4_rows{delta}.tif", W.write_tiff(
            a, 0, 1, compression=3, encode=enc), pil_reads=None)
    mh = bytearray(W.fax_encode([np.packbits(r).tobytes() for r in a], 40,
                                "mh"))
    for pos in (3, 9, 17):
        bad = bytearray(mh)
        bad[pos] = 0
        _hold(folder, f"mh_bad{pos}.tif", W.write_tiff(
            a, 0, 1, compression=2, encode=lambda rows, bw, b=bytes(bad): b),
            pil_reads=None)
    t4 = W.fax_encode([np.packbits(r).tobytes() for r in a], 40, "t4")
    for cut in (3, len(t4) // 2, len(t4) - 2):
        # libtiff reads a strip that ends early: where the EOL scan runs out
        # of data it decodes the strip again, from its start, without EOLs.
        _hold(folder, f"t4_cut{cut}.tif", W.write_tiff(
            a, 0, 1, compression=3, encode=lambda rows, bw, c=cut: t4[:c]),
            pil_reads=None)
    # 32771 aligns rows by the strip's address in the file (libtiff reads
    # a mapped file in place): the same strip at an even and an odd offset.
    odd = _bilevel(9, 21, 4)
    data = W.write_tiff(odd, 0, 1, compression=32771)
    _hold(folder, "raw16_even.tif", data)
    _hold(folder, "raw16_odd.tif", _strip_to_odd_offset(data))
    _hold(folder, "g4_8bit.tif", W.write_tiff(
        (a * 255).astype(np.uint8), 1, 8, compression=4,
        encode=lambda rows, bw: W.fax_encode(
            [np.packbits(r > 0).tobytes() for r in np.frombuffer(
                b"".join(rows), np.uint8).reshape(-1, bw)], bw, "t6")),
          pil_reads=False)


def _strip_to_odd_offset(data: bytes) -> bytes:
    """A one-strip little-endian TIFF with its strip copied to an odd offset
    at the end of the file (StripOffsets patched in place)."""
    import struct
    ifd = struct.unpack_from("<I", data, 4)[0]
    fields = {}
    for i in range(struct.unpack_from("<H", data, ifd)[0]):
        p = ifd + 2 + 12 * i
        tag, _, _, val = struct.unpack_from("<HHII", data, p)
        fields[tag] = (p, val)
    (p, off), (_, size) = fields[273], fields[279]
    out = bytearray(data + b"\0" * (1 - len(data) % 2))
    struct.pack_into("<I", out, p + 8, len(out))
    return bytes(out + data[off:off + size])


# --- ZSTD, ThunderScan, old-style LZW ------------------------------------------

def test_zstd(folder):
    """ZSTD at levels -5, 1, 3, 19 and 22, with and without the checksum
    and the content size, in strips and tiles, predictors 2 (8, 16 and
    32 bits) and 3 (floats), a strip of several blocks (window 2^17),
    PIL's own writer; a first frame that fills the strip and a second one
    after it (read) and a first frame too short (PIL fails), a skippable
    frame first, a dictionary ID and a bad checksum (each PIL fails)."""
    px = _photo(40, 37, 5)
    for lvl in (-5, 1, 3, 19, 22):
        for cs in (False, True):
            for fcs in (False, True):
                _hold(folder, f"zstd_{lvl}_{cs}_{fcs}.tif", W.write_tiff(
                    px, 2, 8, compression=50000, predictor=2,
                    rows_per_strip=16, encode=_zs(lvl, cs, fcs)))
    _hold(folder, "zstd_tiles.tif", W.write_tiff(
        px, 2, 8, compression=50000, tile=(16, 32)))
    g16 = (px[..., 0].astype(np.uint16) * 251).astype(np.uint16)
    for order in "<>":
        _hold(folder, f"zstd16{order}.tif", W.write_tiff(
            g16, 1, 16, order=order, compression=50000, predictor=2))
        _hold(folder, f"zstd_f32{order}.tif", W.write_tiff(
            px[..., 1].astype(np.float32) * 1.7 - 20, 1, 32, order=order,
            compression=50000, predictor=3, sample_format=3))
    _hold(folder, "zstd32.tif", W.write_tiff(
        g16.astype(np.uint32) * 3, 1, 32, compression=50000, predictor=2))
    y, x = np.mgrid[0:150, 0:300]
    big = np.stack([(x * 3 + y) % 256, (x ^ y) % 256, (y * 5) % 256],
                   -1).astype(np.uint8)
    _hold(folder, "zstd_blocks.tif", W.write_tiff(
        big, 2, 8, compression=50000, encode=_zs(3, True, False, 17)))
    _hold(folder, "zstd_pil.tif", _pil_tiff(px, compression="zstd"))
    raw = px.tobytes()
    frames = {
        "two": (W.zstd_compress(raw, 3) + W.zstd_compress(b"xyz", 3), True),
        "short": (W.zstd_compress(raw[:-7], 3) + W.zstd_compress(
            raw[-7:], 3), False),
        "skip": (b"\x50\x2a\x4d\x18\x02\0\0\0ab" + W.zstd_compress(raw, 3),
                 False),
        "cut": (W.zstd_compress(raw, 3, True)[:-1], None)}
    dict_frame = bytearray(W.zstd_compress(raw, 3))
    dict_frame[4] |= 1                   # a 1-byte dictionary ID ...
    frames["dict"] = (bytes(dict_frame[:5]) + b"\x07" + bytes(
        dict_frame[5:]), False)          # ... that is not 0
    bad_sum = bytearray(W.zstd_compress(raw, 3, True))
    bad_sum[-1] ^= 1
    frames["checksum"] = (bytes(bad_sum), False)
    for name, (data, reads) in frames.items():
        _hold(folder, f"zstd_{name}.tif", W.write_tiff(
            px, 2, 8, compression=50000,
            encode=lambda rows, bw, d=data: d), pil_reads=reads)


def test_thunderscan_and_old_lzw(folder):
    """ThunderScan (runs, 2- and 3-bit deltas with skip codes, raw pixels;
    photometric 0 and 1, fill order 2, one-pixel rows, a row with too
    much data, refused at 8 bits) and old-style LZW (codes least
    significant bit first; predictor 2; the new decoder kept for strips
    after a first new-style one)."""
    rng = np.random.RandomState(8)
    cases = {"rand": rng.randint(0, 16, (9, 13)),
             "smooth": np.clip(np.cumsum(rng.randint(-2, 3, (11, 40)), 1)
                               + 8, 0, 15),
             "flat": np.repeat(rng.randint(0, 16, (6, 1)), 70, 1),
             "thin": rng.randint(0, 16, (5, 1))}
    cases["flat"][:, -1] = 15 - cases["flat"][:, -1]
    for name, g in cases.items():
        for photo in (0, 1):
            for fill in (1, 2):
                _hold(folder, f"thunder_{name}_{photo}_{fill}.tif",
                      W.write_tiff(g.astype(np.uint8), photo, 4,
                                   compression=32809, fill_order=fill,
                                   rows_per_strip=4))
    g = cases["rand"].astype(np.uint8)
    extra = W.thunderscan_encode([np.packbits(np.unpackbits(
        r[:, None], axis=1)[:, 4:].reshape(-1)).tobytes() for r in g], 13)
    _hold(folder, "thunder_much.tif", W.write_tiff(
        g, 1, 4, compression=32809,
        encode=lambda rows, bw: b"\xc5" + extra), pil_reads=None)
    _hold(folder, "thunder_8bit.tif", W.write_tiff(
        g * 16, 1, 8, compression=32809,
        encode=lambda rows, bw: b"\xc5" * len(rows) * bw), pil_reads=False)
    px = _photo(30, 29, 9)
    old = lambda rows, bw: W.lzw_tiff(b"".join(rows), compat=True)  # noqa
    _hold(folder, "lzw_old.tif", W.write_tiff(px, 2, 8, compression=5,
                                              encode=old))
    _hold(folder, "lzw_old_pred.tif", W.write_tiff(
        px, 2, 8, compression=5, encode=old, predictor=2, rows_per_strip=7))
    mixed = iter([W.lzw_tiff, lambda d: W.lzw_tiff(d, compat=True)] * 8)
    _hold(folder, "lzw_mixed.tif", W.write_tiff(
        px, 2, 8, compression=5, rows_per_strip=10,
        encode=lambda rows, bw: next(mixed)(b"".join(rows))),
          pil_reads=None)


# --- layouts -------------------------------------------------------------------

def test_fill_order_2(folder):
    """Fill order 2 on every layout PIL's OPEN_INFO lists for it (1-, 2-,
    4- and 8-bit grey, little-endian 16-bit grey, 8-bit RGB, palettes):
    uncompressed through PIL's ;R raw modes (L;IR, P;1R, P;2R and P;4R are
    not raw modes PIL has: it fails), LZW, Deflate, PackBits, LZMA and
    ZSTD with each strip's bits reversed, JPEG not; the layouts OPEN_INFO
    lacks at fill order 2 (CMYK, RGBA, signed, big-endian 16-bit) fail."""
    rng = np.random.RandomState(11)
    for photo, bps, n in [(0, 1, 1), (1, 1, 1), (0, 2, 1), (1, 4, 1),
                          (0, 8, 1), (1, 8, 1), (1, 16, 1), (2, 8, 3),
                          (3, 1, 1), (3, 2, 1), (3, 4, 1), (3, 8, 1)]:
        arr = rng.randint(0, 1 << bps, (9, 11, n)).astype(
            np.uint16 if bps > 8 else np.uint8)
        cm = list(rng.randint(0, 65536, 3 << bps)) if photo == 3 else None
        for comp in (1, 5, 8, 32773, 34925, 50000):
            _hold(folder, f"fo2_{photo}_{bps}_{comp}.tif", W.write_tiff(
                arr, photo, bps, compression=comp, colormap=cm,
                fill_order=2), pil_reads=None)
    px = _photo(16, 24, 12)
    _hold(folder, "fo2_jpeg_grey.tif", W.write_tiff(
        px[..., 0], 1, 8, compression=7, fill_order=2,
        jpeg=lambda p, x, y, w, h: W._pil(px[..., 0], "JPEG", quality=90)))
    for name, arr, photo, kw in (
            ("cmyk", px[..., :1].repeat(4, 2), 5, {}),
            ("rgba", px[..., :1].repeat(4, 2), 2, dict(extra=(2,))),
            ("signed", px[..., 0], 1, dict(sample_format=2)),
            ("i16be", px[..., 0].astype(np.uint16), 1, dict(order=">"))):
        bps = 16 if arr.dtype == np.uint16 else 8
        _hold(folder, f"fo2_{name}.tif", W.write_tiff(
            arr, photo, bps, fill_order=2, compression=5, **kw),
              pil_reads=False)
    _hold(folder, "fo3.tif", W.write_tiff(px, 2, 8, fill_order=3),
          pil_reads=False)


@pytest.mark.parametrize("orient", list(range(0, 10)))
def test_orientation(folder, orient):
    """Orientation 0-9 (2-8 transposed as PIL's exif_transpose does it, the
    size swapped for 5-8) on uncompressed, LZW, tiled and planar files,
    and on YCbCr through libtiff's RGBA interface, which first flips each
    block of rows to top-left by the orientation."""
    px = _photo(21, 13, orient)
    tag = [(274, (3, [orient]))]
    _hold(folder, f"o{orient}_raw.tif", W.write_tiff(px, 2, tags=tag))
    _hold(folder, f"o{orient}_lzw.tif", W.write_tiff(
        px, 2, compression=5, rows_per_strip=8, tags=tag))
    _hold(folder, f"o{orient}_tiles.tif", W.write_tiff(
        px, 2, compression=8, tile=(16, 16), tags=tag))
    _hold(folder, f"o{orient}_grey1.tif", W.write_tiff(
        _bilevel(21, 13, orient), 0, 1, compression=4, tags=tag))
    enc = (lambda rows, bw: W.lzw_tiff(W.ycbcr_units(np.frombuffer(
        b"".join(rows), np.uint8).reshape(-1, bw, 3), 2, 2)))
    _hold(folder, f"o{orient}_ycbcr.tif", W.write_tiff(
        px, 6, compression=5, rows_per_strip=6, encode=enc,
        tags=tag + [(530, (3, [2, 2]))]))


def test_grey_sample_layouts(folder):
    """12-bit grey (PIL's I;12 to I;16: clipped at 255), signed 8-, 16- and
    32-bit grey (I;16S, I;16BS, I;32S, I;32BS to mode I: clipped at 0 and
    255; a compressed big-endian file read swapped, as libtiff hands PIL
    native order), unsigned 32-bit (I;32N, read as signed), raw and
    compressed, with horizontal differencing where libtiff allows it."""
    rng = np.random.RandomState(13)
    g12 = rng.randint(0, 4096, (7, 10)).astype(np.uint16)
    g12[0, :5] = [0, 254, 255, 256, 4095]
    for comp in (1, 5, 8, 50000):
        _hold(folder, f"g12_{comp}.tif", W.write_tiff(
            g12, 1, 12, compression=comp))
        for order in "<>":
            for bps, dt in ((8, np.int8), (16, np.int16), (32, np.int32)):
                v = rng.randint(-700, 700, (7, 10)).astype(dt)
                v[0, :4] = [-1, 0, 127, 100] if bps == 8 else [
                    -1, 0, 255, 256]
                pred = 2 if comp != 1 else 1
                _hold(folder, f"s{bps}{order}_{comp}.tif", W.write_tiff(
                    v.view(f"u{bps // 8}"), 1, bps, order=order,
                    compression=comp, sample_format=2, predictor=pred))
        u32 = rng.randint(0, 400, (7, 10)).astype(np.uint32)
        u32[0, :3] = [2 ** 31, 2 ** 32 - 1, 2 ** 31 - 1]
        _hold(folder, f"u32_{comp}.tif", W.write_tiff(
            u32, 1, 32, compression=comp))
    _hold(folder, "g12_pred.tif", W.write_tiff(
        g12, 1, 12, compression=5, predictor=2), pil_reads=False)


def test_planar_16_bit(folder):
    """The 16-bit planes of an uncompressed planar-2 file, as PIL's raw
    decoder reads them: a byte a sample, rows a tile row's
    int(width * bits / 8 / bands) bytes apart in a tile that crosses the
    image's right edge (RGB, RGBA with and without ExtraSamples, CMYK,
    both byte orders); PIL has no raw mode for RGBX or RGBa planes."""
    rng = np.random.RandomState(14)
    a16 = rng.randint(0, 65536, (19, 21, 4)).astype(np.uint16)
    for n, extra, photo in [(3, (), 2), (4, (), 2), (4, (2,), 2),
                            (4, (), 5), (4, (0,), 2), (4, (1,), 2)]:
        for order in "<>":
            for tile in (None, (16, 16)):
                reads = not (0 in extra or 1 in extra)
                name = f"p16_{n}_{len(extra) and extra[0]}_{photo}_" \
                    f"{'le' if order == '<' else 'be'}_{bool(tile)}.tif"
                _hold(folder, name,
                      W.write_tiff(a16[..., :n], photo, 16, order=order,
                                   planar=2, extra=extra, tile=tile),
                      pil_reads=reads)


@pytest.mark.parametrize("comp", [1, 5, 8, 32773, 50000])
def test_ycbcr(folder, comp):
    """YCbCr outside contiguous JPEG: compressed, through libtiff's RGBA
    interface (subsampling 1x1 to 4x4, its default 2x2, ReferenceBlackWhite
    and YCbCrCoefficients, libtiff's integer YCbCr -> RGB tables, strips
    that end mid sample row, where libtiff decodes a rounded-down count of
    bytes and the rest of the block reads zero, tiles, planar 1x1, JPEG
    in planes);
    uncompressed, as PIL's raw decoder reads the samples (RGBX, or a
    plane a sample), unconverted."""
    px = _photo(23, 29, 15)
    for sub in ((1, 1), (2, 1), (1, 2), (2, 2), (4, 1), (4, 2), (4, 4),
                None):
        sh, sv = sub or (2, 2)
        tags = [(530, (3, list(sub)))] if sub else []
        if comp == 1:
            _hold(folder, f"ycc_raw_{sh}{sv}_{bool(sub)}.tif", W.write_tiff(
                px, 6, tags=tags), pil_reads=None)
            continue
        for rps in (6, 23):
            enc = (lambda rows, bw, sh=sh, sv=sv: {
                5: W.lzw_tiff, 8: zlib_compress, 32773: _packbits,
                50000: lambda d: W.zstd_compress(d, 3)}[comp](
                    W.ycbcr_units(np.frombuffer(b"".join(rows), np.uint8)
                                  .reshape(-1, bw, 3), sh, sv)))
            _hold(folder, f"ycc_{comp}_{sh}{sv}_{bool(sub)}_{rps}.tif",
                  W.write_tiff(
                      px, 6, compression=comp, rows_per_strip=rps,
                      encode=enc, tags=tags), pil_reads=None)
    if comp == 1:
        _hold(folder, "ycc_raw_planar.tif", W.write_tiff(px, 6, planar=2))
        return
    refbw = [(532, (5, [16, 1, 235, 1, 128, 1, 240, 1, 128, 1, 240, 1])),
             (529, (5, [2126, 10000, 7152, 10000, 722, 10000]))]
    enc = (lambda rows, bw: {5: W.lzw_tiff, 8: zlib_compress,
                             32773: _packbits,
                             50000: lambda d: W.zstd_compress(d, 3)}[comp](
        W.ycbcr_units(np.frombuffer(b"".join(rows), np.uint8).reshape(
            -1, bw, 3), 2, 2)))
    _hold(folder, f"ycc_{comp}_refbw.tif", W.write_tiff(
        px, 6, compression=comp, encode=enc,
        tags=refbw + [(530, (3, [2, 2]))]))
    _hold(folder, f"ycc_{comp}_tiles.tif", W.write_tiff(
        px, 6, compression=comp, tile=(16, 16), encode=enc,
        tags=[(530, (3, [2, 2]))]))
    _hold(folder, f"ycc_{comp}_planar.tif", W.write_tiff(
        px, 6, compression=comp, planar=2, tags=[(530, (3, [1, 1]))]))
    _hold(folder, f"ycc_{comp}_planar22.tif", W.write_tiff(
        px, 6, compression=comp, planar=2), pil_reads=False)
    _hold(folder, f"ycc_{comp}_grey.tif", W.write_tiff(
        px[..., 0], 6, compression=comp), pil_reads=False)
    if comp == 5:
        # JPEG in planes: libtiff's RGBA interface converts the planes'
        # JPEG components, at 1x1 only.
        def planes(p, x, y, w, h):
            c = np.zeros((h, w), np.uint8)
            sub = p[y:y + h, x:x + w, 0]
            c[:sub.shape[0], :sub.shape[1]] = sub
            return W._pil(c, "JPEG", quality=90)
        for sub, reads in (((1, 1), True), ((2, 2), False)):
            _hold(folder, f"ycc_jpeg_planar_{sub[0]}.tif", W.write_tiff(
                px, 6, compression=7, planar=2, rows_per_strip=8,
                jpeg=planes, tags=[(530, (3, list(sub)))]), pil_reads=reads)


def zlib_compress(d):
    import zlib
    return zlib.compress(d, 6)


def _packbits(d):
    return b"".join(W.packbits(d[i:i + 128]) for i in range(0, len(d), 128))


def test_lab(folder):
    """Lab TIFFs (raw, LZW, ZSTD, tiled, planar) and Lab PSDs (raw and
    PackBits), through PIL's LittleCMS Lab -> sRGB transform: every
    (L, a, b) corner and the neutral axis among the pixels."""
    px = _photo(17, 23, 16)
    px[0, :8] = [[0, 0, 0], [255, 255, 255], [255, 0, 255], [0, 255, 0],
                 [128, 0, 0], [128, 128, 128], [50, 127, 129],
                 [200, 128, 0]]
    for comp in (1, 5, 50000):
        _hold(folder, f"lab_{comp}.tif", W.write_tiff(px, 8, 8,
                                                      compression=comp))
    _hold(folder, "lab_tiles.tif", W.write_tiff(px, 8, 8, compression=8,
                                                tile=(16, 16)))
    _hold(folder, "lab_planar.tif", W.write_tiff(px, 8, 8, planar=2))
    _hold(folder, "lab_planar_lzw.tif", W.write_tiff(
        px, 8, 8, planar=2, compression=5), pil_reads=None)
    for rle in (False, True):
        _hold(folder, f"lab_{rle}.psd", W.write_psd(
            [px[..., c] for c in range(3)], 9, rle=rle))


def test_refused_compressions(folder):
    """What the held Pillow refuses, as ValueError naming the file: LERC
    (Pillow has no decoder name for 34887), WebP-in-TIFF (its libtiff has
    no libwebp), SGILog and SGILog24 under photometrics PIL opens and
    under LogL / LogLuv, which PIL does not open."""
    px = _photo(8, 9, 17)
    for comp in (34887, 50001, 34676, 34677):
        _hold(folder, f"c{comp}.tif", W.write_tiff(
            px, 2, 8, tags=[(259, (3, [comp]))]), pil_reads=False)
        with pytest.raises(ValueError, match=f"c{comp}.tif"):
            io.load_image(os.path.join(str(folder), f"c{comp}.tif"))
    for photo in (32844, 32845):
        _hold(folder, f"log{photo}.tif", W.write_tiff(
            px[..., :1].astype(np.uint16), photo, 16,
            tags=[(259, (3, [34676]))]), pil_reads=False)


def _patch(data: bytes, tag: int, typ=None, count=None, first=None,
           entries=None) -> bytes:
    """A little-endian one-IFD TIFF with one field's type, count or first
    value bytes changed, or (``entries``) its directory's entry count."""
    import struct
    out = bytearray(data)
    ifd = struct.unpack_from("<I", out, 4)[0]
    n = struct.unpack_from("<H", out, ifd)[0]
    if entries is not None:
        struct.pack_into("<H", out, ifd, entries)
        return bytes(out[:ifd + 2 + 12 * n])
    for k in range(n):
        p = ifd + 2 + 12 * k
        if struct.unpack_from("<H", out, p)[0] != tag:
            continue
        if typ is not None:
            struct.pack_into("<H", out, p + 2, typ)
        if count is not None:
            struct.pack_into("<I", out, p + 4, count)
        if first is not None:
            out[p + 8:p + 8 + len(first)] = first
    return bytes(out)


def test_directory_as_pil_reads_it(folder):
    """The directory as PIL reads it: a field of unknown type skipped, the
    first value of a one-value field that has more, the fields before one
    whose data runs past the end of the file kept, and those before the
    end of a cut directory; and where libtiff, which decodes compressed
    files, reads it otherwise: a Compression of a count other than the
    samples' and a field it needs of an unknown type refused, a Predictor
    of another count ignored, a cut directory refused."""
    px = _photo(9, 11, 24)
    raw = W.write_tiff(px, 2, 8, tags=[(305, (1, [7] * 9))])
    lzw = W.write_tiff(px, 2, 8, compression=5, predictor=2)
    cases = {
        "rows_type.tif": (_patch(raw, 278, typ=99), True),
        "planar_two.tif": (_patch(raw, 284, count=2), True),
        "past_end.tif": (_patch(raw, 305, count=1 << 20), True),
        "cut_dir.tif": (_patch(raw, 0, entries=40), None),
        "comp_two.tif": (_patch(lzw, 259, count=2,
                                first=bytes([5, 0, 5, 0])), False),
        "pred_two.tif": (_patch(lzw, 317, count=2), True),
        "spp_type.tif": (_patch(lzw, 277, typ=99), False),
        "lzw_cut_dir.tif": (_patch(lzw, 0, entries=40), False)}
    for name, (data, reads) in cases.items():
        _hold(folder, name, data, pil_reads=reads)


# --- mutations ---------------------------------------------------------------

def _mutation_seeds(kind: str) -> list:
    """The files of a kind, each as (make, strips): make(strips) writes the
    file around a list of strip bytes."""
    a = _bilevel(14, 30, 5)
    px = _photo(12, 10, 21)
    g = np.clip(np.cumsum(np.random.RandomState(3).randint(
        -2, 3, (8, 15)), 1) + 8, 0, 15).astype(np.uint8)
    if kind == "ccitt":
        t4 = (lambda rows, bw: W.fax_encode(rows, bw, "t4", k=2))
        makers = [
            lambda enc: W.write_tiff(a, 0, 1, compression=4, encode=enc),
            lambda enc: W.write_tiff(a, 1, 1, compression=2, encode=enc),
            lambda enc: W.write_tiff(a, 0, 1, compression=3, encode=enc,
                                     tags=[(292, (4, [1]))])]
        encoders = [None, None, t4]
    elif kind == "zstd":
        makers = [
            lambda enc: W.write_tiff(px, 2, 8, compression=50000,
                                     predictor=2, encode=enc),
            lambda enc: W.write_tiff(px, 2, 8, compression=50000,
                                     rows_per_strip=6, encode=enc)]
        encoders = [_zs(19, True), _zs(1, False, False)]
    else:
        makers = [
            lambda enc: W.write_tiff(g, 1, 4, compression=32809, encode=enc),
            lambda enc: W.write_tiff(g, 0, 4, compression=32809,
                                     fill_order=2, rows_per_strip=3,
                                     encode=enc)]
        encoders = [None, None]
    seeds = []
    for make, enc in zip(makers, encoders):
        # The strips as the file holds them (fill order 2 included).
        from gpupathtracer_tpu_torch.utils.tiff import _ifd
        data = make(enc)
        _, fields = _ifd(data, "seed")
        strips = [data[o:o + c] for o, c in zip(fields[273], fields[279])]
        fill2 = fields.get(266, (1,))[0] == 2
        seeds.append((make, strips, fill2))
    return seeds


def _rebuild(make, strips, fill2) -> bytes:
    rev = np.array([int(f"{b:08b}"[::-1], 2) for b in range(256)], np.uint8)
    # write_tiff reverses each written strip's bits at fill order 2.
    it = iter([rev[np.frombuffer(s, np.uint8)].tobytes() if fill2 else s
               for s in strips])
    return make(lambda rows, bw: next(it))


def _pil_defined(paths: list, wants: list) -> list:
    """Does PIL decode each file to its ``want`` whatever its heap holds?
    Two more decodes in fresh processes, glibc's MALLOC_PERTURB_ filling
    fresh allocations with other bytes each time: a T.6 strip that ends
    early leaves rows libtiff never writes, and PIL shows its buffer's
    old bytes there."""
    import subprocess
    if not paths:
        return []
    code = ("import hashlib, sys, warnings; import numpy as np; "
            "from PIL import Image; warnings.simplefilter('ignore')\n"
            "for p in sys.argv[1:]:\n"
            "    print(hashlib.sha256(np.asarray(Image.open(p).convert("
            "'RGB')).tobytes()).hexdigest())")
    digests = [hashlib.sha256(w.tobytes()).hexdigest() for w in wants]
    same = [True] * len(paths)
    for perturb in ("17", "119"):
        out = subprocess.run(
            [sys.executable, "-c", code, *paths], capture_output=True,
            text=True, env=dict(os.environ, MALLOC_PERTURB_=perturb))
        got = out.stdout.split()
        same = [s and i < len(got) and got[i] == d
                for i, (s, d) in enumerate(zip(same, digests))]
    return same


def _count(counts: dict, mutant: bytes, path: str, pending: list) -> None:
    """One mutant into ``counts``; a decode that differs from PIL's waits
    in ``pending`` for _pil_defined."""
    want, _ = _pil_path(path)
    try:
        got = io.decode_image(mutant, "mutant")
    except (ValueError, NotImplementedError):
        counts["refused" if want is not None else "both_fail"] += 1
        return
    if want is None:
        counts["extra"] += 1
    elif got.tobytes() == want.tobytes():
        counts["both"] += 1
    else:
        kept = f"{path}.{len(pending)}"
        os.replace(path, kept)
        pending.append((kept, want))


def _settle(counts: dict, pending: list) -> dict:
    for defined in _pil_defined([p for p, _ in pending],
                                [w for _, w in pending]):
        counts["otherwise" if defined else "undefined"] += 1
    return counts


def mutation_counts(kind: str, seed: int, count: int = 40) -> dict:
    """The mutation test's counts for one kind and seed, the generator run
    on the bytes of one strip of each file (the container's own mutations
    are the TIFF fixtures' in tests/test_torch_image_formats.py): mutants
    both read alike, PIL reads and the port refuses, PIL reads and the
    port decodes otherwise, the port decodes where PIL fails, and PIL's
    decode depends on memory it never wrote (``undefined``: the port's
    rows there are white)."""
    import tempfile
    rng = np.random.RandomState(seed)
    counts = dict(both=0, refused=0, otherwise=0, extra=0, both_fail=0,
                  undefined=0)
    with tempfile.TemporaryDirectory() as tmp:
        path, pending = os.path.join(tmp, "mutant"), []
        for make, strips, fill2 in _mutation_seeds(kind):
            for _ in range(count):
                k = rng.randint(len(strips))
                mutated = list(strips)
                mutated[k] = next(_mutants(strips[k], rng, 1))
                mutant = _rebuild(make, mutated, fill2)
                with open(path, "wb") as f:
                    f.write(mutant)
                _count(counts, mutant, path, pending)
        return _settle(counts, pending)


@pytest.mark.parametrize("kind", ["ccitt", "zstd", "thunderscan"])
@pytest.mark.parametrize("seed", [1, 2])
def test_mutations_never_decode_otherwise(kind, seed):
    """Bytes set, deleted or cut off (tests/test_torch_simple_formats.py's
    generator) in a strip of CCITT, ZSTD and ThunderScan files: the port
    decodes a mutant to the bits PIL reads from its path, or raises where
    PIL fails too. No mutant PIL reads is refused or decoded otherwise;
    where PIL's pixels depend on its heap (rows a T.6 strip that ends
    early never writes), the port decodes the mutant too."""
    c = mutation_counts(kind, seed)
    assert c["both"] > 5, c
    assert c["refused"] == c["otherwise"] == c["extra"] == 0, c


# --- fixtures and scenes -----------------------------------------------------

def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def test_fixtures_bitwise_their_twins():
    """Every committed fixture of this slice (the card's machine reads them
    without PIL) decodes bitwise its PNG twin and the manifest's sha256s,
    and PIL reads the file to the same pixels; the town's four ZSTD maps
    decode to the town's own PNG twins."""
    import warnings

    from PIL import Image
    manifest = _manifest()
    assert set(REST_FIXTURES) <= set(manifest)
    for name in REST_FIXTURES:
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
            assert np.asarray(im.convert("RGB")).tobytes() == \
                got.tobytes(), name
    for name, fname in TOWN_ZSTD.items():
        e = next(v for v in manifest.values() if v["file"] == fname)
        assert e["png"] == f"{name}.png"


def test_atlas_skips_refused_tiffs(tmp_path):
    """An OBJ whose maps are a ZSTD TIFF, a CCITT TIFF and three TIFFs PIL
    refuses (LERC, WebP, a fill-order-2 CMYK file): build_atlas's tables
    bitwise the JAX package's, the three skipped by both."""
    from gpupathtracer_tpu.scene import textures as jax_textures

    from gpupathtracer_tpu_torch.scene import textures
    px = _photo(8, 8, 18)
    shutil.copy(os.path.join(FIXTURES, "roof_zstd.tif"), tmp_path)
    shutil.copy(os.path.join(FIXTURES, "fax_g4.tif"), tmp_path)
    for name, data in (
            ("lerc.tif", W.write_tiff(px, 2, tags=[(259, (3, [34887]))])),
            ("webp.tif", W.write_tiff(px, 2, tags=[(259, (3, [50001]))])),
            ("cmyk_fo2.tif", W.write_tiff(px[..., :1].repeat(4, 2), 5,
                                          fill_order=2))):
        (tmp_path / name).write_bytes(data)
    maps = ["roof_zstd.tif", "fax_g4.tif", "lerc.tif", "webp.tif",
            "cmyk_fo2.tif"]
    got = textures.build_atlas(maps, str(tmp_path), mip_levels=2)
    want = jax_textures.build_atlas(maps, str(tmp_path), mip_levels=2)
    assert got[2] == want[2] and len(got[2]) == 2
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# --- the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_tiff_rest_fixtures_on_cuda():
    """Phase 25a where the card is: every fixture of this slice decodes
    bitwise its PNG twin and the manifest's sha256 on the card's machine
    (no PIL there), and a ZSTD map reaches the card as a texture."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase runs where the card is")
    manifest = _manifest()
    for name in REST_FIXTURES:
        e = manifest[name]
        with open(os.path.join(FIXTURES, e["file"]), "rb") as f:
            got = io.decode_image(f.read(), name)
        with open(os.path.join(FIXTURES, e["png"]), "rb") as f:
            assert got.tobytes() == io.decode_png(f.read(), name).tobytes()
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            e["pixels_sha256"], name
    img = io.load_image(os.path.join(FIXTURES, TOWN_ZSTD["roof"]))
    t = torch.from_numpy(img).to("cuda")
    assert t.shape == (128, 128, 3) and float(t.max()) > 0


def file_mutation_counts(kind: str, seed: int, count: int = 40) -> dict:
    """The generator on whole files (their IFDs too): the fill-order-2 and
    orientation fixtures of this slice, or ("tiff") the TIFFs of
    tests/test_torch_image_formats.py's mutation test."""
    import tempfile
    manifest = _manifest()
    rng = np.random.RandomState(seed)
    if kind == "tiff":
        # tests/test_torch_image_formats.py's TIFF mutation files.
        from test_torch_image_formats import _seeds
        files = _seeds()["tiff"]
    else:
        names = {"fill_order": ("fo2_rgb", "fo2_grey2", "fo2_i16",
                                "fo2_palette", "fax_t6_fo2",
                                "thunderscan_fo2", "zstd_fo2"),
                 "orientation": tuple(f"orient{o}" for o in range(2, 9))}[
                     kind]
        files = []
        for name in names:
            with open(os.path.join(FIXTURES, manifest[name]["file"]),
                      "rb") as f:
                files.append(f.read())
    counts = dict(both=0, refused=0, otherwise=0, extra=0, both_fail=0,
                  undefined=0)
    with tempfile.TemporaryDirectory() as tmp:
        path, pending = os.path.join(tmp, "mutant"), []
        for data in files:
            for mutant in _mutants(data, rng, count):
                with open(path, "wb") as f:
                    f.write(mutant)
                _count(counts, mutant, path, pending)
        return _settle(counts, pending)


def _fuzz(argv) -> int:
    """``--fuzz A-B [kind ...]``: the mutation counts over seeds A..B for
    each kind (ccitt, zstd, thunderscan: a strip's bytes; fill_order,
    orientation, tiff: whole files)."""
    i = argv.index("--fuzz")
    lo, hi = (int(v) for v in argv[i + 1].split("-"))
    kinds = argv[i + 2:] or ["ccitt", "zstd", "thunderscan", "fill_order",
                             "orientation"]
    for kind in kinds:
        fn = file_mutation_counts if kind in ("fill_order", "orientation",
                                             "tiff") else mutation_counts
        total = dict(both=0, refused=0, otherwise=0, extra=0, both_fail=0,
                     undefined=0)
        for seed in range(lo, hi + 1):
            for k, v in fn(kind, seed).items():
                total[k] += v
        n = sum(total.values())
        print(f"{kind}: seeds {lo}-{hi}, {n} mutants: {total}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(_fuzz(sys.argv))
