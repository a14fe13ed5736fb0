"""The image formats of the second image slice against the JAX package on
the CPU: DDS (uncompressed and BC1-BC7), TIFF, GIF, PSD, CMYK and YCCK
JPEG, and the rest of TGA and BMP. Files are written by PIL where it
writes the variant, else by the container writers of
tools/torch_image_fixtures.py from seeded data; the port's
``load_image`` must be bitwise the JAX package's (PIL's
``convert("RGB")`` / 255) on every case, and where PIL cannot read the
bytes the port raises ValueError (the atlas builders skip the map). Also:
which plugin PIL picks (utils/identify.py), mutated files, the maps and
skies of these formats through ``load_scene`` and the environment
loader, and PIL's CMYK -> RGB over every (c, k) pair."""

import importlib.util
import io as _bio
import os
import struct

import numpy as np
import pytest
from PIL import Image

from gpupathtracer_tpu.scene import envmap as jax_envmap
from gpupathtracer_tpu.scene import textures as jax_textures
from gpupathtracer_tpu.utils import io as jax_io
from gpupathtracer_tpu_torch.scene import envmap, textures
from gpupathtracer_tpu_torch.utils import io
from gpupathtracer_tpu_torch.utils.identify import identify
from test_torch_images import _hold_atlas, _photo, _textured_obj

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _load_tool():
    spec = importlib.util.spec_from_file_location(
        "torch_image_fixtures", os.path.join(REPO, "tools",
                                             "torch_image_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


W = _load_tool()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return tmp_path_factory.mktemp("formats")


def _pil(data: bytes):
    """PIL's convert("RGB") of the bytes, or None where PIL fails."""
    try:
        return np.asarray(Image.open(_bio.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def _hold(folder, name: str, data: bytes, pil_reads=True):
    """load_image bitwise the JAX package's on the file (PIL reads it), or
    both raise and the port's error is ValueError naming the file;
    ``pil_reads=None``: whichever PIL does (a file whose data PIL reads
    from the wrong place, so that it fails or not by the bytes)."""
    path = os.path.join(str(folder), name)
    with open(path, "wb") as f:
        f.write(data)
    if pil_reads is None:
        pil_reads = _pil(data) is not None
    if not pil_reads:
        with pytest.raises(Exception):
            jax_io.load_image(path)
        with pytest.raises(ValueError, match=name):
            io.load_image(path)
        return None
    want = jax_io.load_image(path)
    got = io.load_image(path)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape, name
    assert got.tobytes() == want.tobytes(), name
    return got


def _smooth(h, w, c, seed):
    rng = np.random.RandomState(seed)
    steps = rng.randint(-3, 4, (h, w, c))
    return np.clip(np.cumsum(steps, 1) + 128, 0, 255).astype(np.uint8)


# --- DDS ---------------------------------------------------------------------

# (label, FourCC or None, DXGI format or None, bytes a block)
BCN = [("dxt1", b"DXT1", None, 8), ("dxt3", b"DXT3", None, 16),
       ("dxt5", b"DXT5", None, 16), ("bc4u", b"BC4U", None, 8),
       ("ati1", b"ATI1", None, 8), ("ati2", b"ATI2", None, 16),
       ("bc5u", b"BC5U", None, 16), ("bc5s", b"BC5S", None, 16),
       ("bc1", None, 71, 8), ("bc2", None, 74, 16), ("bc3", None, 77, 16),
       ("bc4", None, 80, 8), ("bc5", None, 83, 16), ("bc5_snorm", None, 84, 16),
       ("bc6h_uf16", None, 95, 16), ("bc6h_sf16", None, 96, 16),
       ("bc7", None, 98, 16), ("bc7_srgb", None, 99, 16),
       ("bc1_typeless", None, 70, 8), ("bc7_typeless", None, 97, 16)]


@pytest.mark.parametrize("label,fourcc,dxgi,size", BCN,
                         ids=[c[0] for c in BCN])
def test_dds_block_formats(folder, label, fourcc, dxgi, size):
    """Seeded random blocks of every BCn format PIL reads, at a size that
    is not a multiple of 4 and at 64x64; BC6H with every mode field (the
    four reserved ones too) and BC7 with every mode and the invalid mode
    byte forced, so every partition and rotation turns up."""
    modes = None
    if dxgi in (95, 96):
        modes = W.BC6H_MODES
    elif dxgi in (97, 98, 99):
        modes = list(range(9))
    for (w, h), seed in (((13, 7), 1), ((64, 64), 2), ((128, 96), 3)):
        n = ((w + 3) // 4) * ((h + 3) // 4)
        blocks = W.random_blocks(n, size, seed + 10 * len(label), modes,
                                 bc6h=dxgi in (95, 96))
        _hold(folder, f"{label}_{w}x{h}.dds",
              W.write_dds(w, h, blocks, fourcc=fourcc, dxgi=dxgi))


@pytest.mark.parametrize("fmt", ["RGB", "RGBA", "L", "LA", "DXT1", "DXT3",
                                 "DXT5", "BC2", "BC3", "BC5"])
def test_dds_written_by_pil(folder, fmt):
    """Pillow's DDS writer: uncompressed RGB, RGBA, L and LA (by bit
    masks), and its BCn encoder."""
    px = _photo(37, 29, 5)
    im = Image.fromarray(px)
    kw = {}
    if fmt in ("L", "LA", "RGBA"):
        im = im.convert(fmt)
    elif fmt != "RGB":
        kw = dict(pixel_format=fmt)
        if fmt != "BC5":
            im = im.convert("RGBA")
    buf = _bio.BytesIO()
    im.save(buf, "DDS", **kw)
    _hold(folder, f"pil_{fmt}.dds", buf.getvalue())


def test_dds_uncompressed_layouts(folder):
    """RGB by masks at 8, 16, 24 and 32 bits (565, 555 + alpha, 4444,
    BGR, RGBA, a 10/6-bit split, a missing channel; the pixels short of
    the end read as zeros, as PIL's Python decoder pads them), 8-bit
    luminance, 16-bit luminance + alpha, an 8-bit palette and DXGI
    R8G8B8A8."""
    rng = np.random.RandomState(7)
    w, h = 7, 5
    for bits, masks in ((16, (0xF800, 0x7E0, 0x1F, 0)),
                        (16, (0x7C00, 0x3E0, 0x1F, 0x8000)),
                        (16, (0xF00, 0xF0, 0xF, 0xF000)),
                        (24, (0xFF0000, 0xFF00, 0xFF, 0)),
                        (32, (0xFF, 0xFF00, 0xFF0000, 0xFF000000)),
                        (8, (0xE0, 0x1C, 0x3, 0)),
                        (16, (0x3FF, 0xFC00, 0, 0))):
        body = rng.bytes(w * h * bits // 8 - 3)
        flags = 0x40 | (1 if masks[3] else 0)
        _hold(folder, f"masks_{bits}_{masks[0]:x}.dds",
              W.write_dds(w, h, body, pfflags=flags, bitcount=bits,
                          masks=masks))
    _hold(folder, "lum.dds", W.write_dds(w, h, rng.bytes(w * h),
                                         pfflags=0x20000, bitcount=8))
    _hold(folder, "lum_alpha.dds", W.write_dds(
        w, h, rng.bytes(2 * w * h), pfflags=0x20001, bitcount=16))
    _hold(folder, "palette.dds", W.write_dds(
        w, h, rng.bytes(1024 + w * h), pfflags=0x20, bitcount=8))
    _hold(folder, "r8g8b8a8.dds", W.write_dds(w, h, rng.bytes(4 * w * h),
                                              dxgi=28))


@pytest.mark.parametrize("case", ["bc4_snorm", "b8g8r8a8", "bc1_srgb",
                                  "dxt2", "bc4s", "header", "short",
                                  "lum16", "flags"])
def test_dds_refused_as_pil_refuses(folder, case):
    """What PIL leaves unimplemented or refuses (DXGI BC4_SNORM, B8G8R8A8
    and the sRGB BC1, FourCCs DXT2 and BC4S, another header size, block
    data short of the image, 16-bit luminance without alpha, no pixel
    format flag) raises ValueError naming the file: the JAX atlas builder
    skips such a map, and so does the port's."""
    rng = np.random.RandomState(8)
    data = {"bc4_snorm": W.write_dds(8, 8, rng.bytes(32), dxgi=81),
            "b8g8r8a8": W.write_dds(8, 8, rng.bytes(256), dxgi=87),
            "bc1_srgb": W.write_dds(8, 8, rng.bytes(32), dxgi=72),
            "dxt2": W.write_dds(8, 8, rng.bytes(64), fourcc=b"DXT2"),
            "bc4s": W.write_dds(8, 8, rng.bytes(32), fourcc=b"BC4S"),
            "header": b"DDS " + struct.pack("<I", 120) + b"\0" * 140,
            "short": W.write_dds(16, 16, rng.bytes(100), fourcc=b"DXT5"),
            "lum16": W.write_dds(8, 8, rng.bytes(128), pfflags=0x20000,
                                 bitcount=16),
            "flags": W.write_dds(8, 8, rng.bytes(64))}[case]
    _hold(folder, f"refused_{case}.dds", data, pil_reads=False)
    got = textures.build_atlas([f"refused_{case}.dds"], str(folder))
    want = jax_textures.build_atlas([f"refused_{case}.dds"], str(folder))
    assert got[2] == want[2] == {}


# --- TIFF --------------------------------------------------------------------

COMPRESSIONS = {"none": 1, "lzw": 5, "deflate": 8, "adobe": 32946,
                "packbits": 32773, "lzma": 34925}


@pytest.mark.parametrize("comp", sorted(COMPRESSIONS))
@pytest.mark.parametrize("order", ["<", ">"])
def test_tiff_layouts(folder, comp, order):
    """Each compression, little- and big-endian: RGB in strips (the last
    one short) and in 16x16 tiles past the image's edges, planar
    configuration 1 and 2, predictor 2 (libtiff ignores it under PackBits
    and no compression), and BigTIFF (PIL reads only the little-endian
    one: the big-endian one raises ValueError, as PIL fails on it)."""
    c = COMPRESSIONS[comp]
    px = _smooth(21, 19, 3, 3)
    for planar in (1, 2):
        for tile in (None, (16, 16)):
            for pred in (1, 2):
                _hold(folder, f"rgb_{comp}{order}{planar}{tile}{pred}.tif"
                      .replace("<", "le").replace(">", "be")
                      .replace(", ", "x").replace("(", "").replace(")", ""),
                      W.write_tiff(px, 2, 8, order=order, compression=c,
                                   planar=planar, tile=tile,
                                   rows_per_strip=5, predictor=pred))
    big = W.write_tiff(px, 2, 8, order=order, compression=c, big=True,
                       tile=(16, 16))
    _hold(folder, f"big_{comp}_{'le' if order == '<' else 'be'}.tif", big,
          pil_reads=order == "<")


@pytest.mark.parametrize("comp", ["none", "lzw", "deflate"])
@pytest.mark.parametrize("order", ["<", ">"])
def test_tiff_samples(folder, comp, order):
    """Bilevel, 2-, 4- and 8-bit grey (photometric 0 inverted), 16-bit grey
    (clipped at 255 as PIL's I;16; big-endian photometric 0 is a layout
    PIL refuses), 32-bit float with predictors 1, 2 and 3 (NaN, infinities
    and values past 0-255; a compressed big-endian float file reads as
    PIL's libtiff path reads it, its bytes swapped), palettes at 1, 2, 4
    and 8 bits, CMYK at 8 and 16 bits, RGB at 16 bits, RGB with an extra
    sample (unspecified, premultiplied and straight alpha), 16-bit RGBA,
    grey + alpha and two extra samples."""
    c = COMPRESSIONS[comp]
    rng = np.random.RandomState(11)
    h, w = 13, 11
    tag = f"{comp}_{'le' if order == '<' else 'be'}"
    f32 = (rng.randn(h, w) * 100 + 128).astype(np.float32)
    f32[0, :4] = [np.nan, np.inf, -np.inf, -5]
    for ph in (0, 1):
        _hold(folder, f"bilevel{ph}_{tag}.tif", W.write_tiff(
            rng.randint(0, 2, (h, w)), ph, 1, order=order, compression=c))
        for bps in (2, 4, 8):
            _hold(folder, f"grey{bps}_{ph}_{tag}.tif", W.write_tiff(
                rng.randint(0, 1 << bps, (h, w)), ph, bps, order=order,
                compression=c))
        g16 = rng.randint(0, 65536, (h, w)).astype(np.uint16)
        g16[0, :4] = [0, 1, 255, 256]
        _hold(folder, f"grey16_{ph}_{tag}.tif", W.write_tiff(
            g16, ph, 16, order=order, compression=c,
            predictor=2 if c != 1 else 1),
            pil_reads=ph == 1 or order == "<")
        for pred in (1, 2, 3):
            _hold(folder, f"float{ph}_{pred}_{tag}.tif", W.write_tiff(
                f32, ph, 32, order=order, compression=c, sample_format=3,
                predictor=pred if c != 1 else 1))
    for bps in (1, 2, 4, 8):
        cmap = rng.randint(0, 65536, 3 * (1 << bps))
        _hold(folder, f"palette{bps}_{tag}.tif", W.write_tiff(
            rng.randint(0, 1 << bps, (h, w)), 3, bps, order=order,
            compression=c, colormap=cmap))
    _hold(folder, f"cmyk8_{tag}.tif", W.write_tiff(
        rng.randint(0, 256, (h, w, 4)), 5, 8, order=order, compression=c))
    _hold(folder, f"cmyk16_{tag}.tif", W.write_tiff(
        rng.randint(0, 65536, (h, w, 4)).astype(np.uint16), 5, 16,
        order=order, compression=c))
    _hold(folder, f"rgb16_{tag}.tif", W.write_tiff(
        rng.randint(0, 65536, (h, w, 3)).astype(np.uint16), 2, 16,
        order=order, compression=c, predictor=2 if c != 1 else 1))
    for extra in ((), (0,), (1,), (2,)):
        rgba = rng.randint(0, 256, (h, w, 4))
        rgba[0, :3, 3] = [0, 255, 128]
        _hold(folder, f"rgba{extra}_{tag}.tif".replace(",", ""),
              W.write_tiff(rgba, 2, 8, order=order, compression=c,
                           extra=extra))
        _hold(folder, f"rgba16{extra}_{tag}.tif".replace(",", ""),
              W.write_tiff(rng.randint(0, 65536, (h, w, 4)).astype(
                  np.uint16), 2, 16, order=order, compression=c,
                  extra=extra))
    _hold(folder, f"la_{tag}.tif", W.write_tiff(
        rng.randint(0, 256, (h, w, 2)), 1, 8, order=order, compression=c,
        extra=(2,)))
    _hold(folder, f"rgbxx_{tag}.tif", W.write_tiff(
        rng.randint(0, 256, (h, w, 5)), 2, 8, order=order, compression=c,
        extra=(0, 0)))


@pytest.mark.parametrize("comp", ["raw", "tiff_lzw", "tiff_deflate",
                                  "tiff_adobe_deflate", "packbits", "lzma",
                                  "jpeg"])
def test_tiff_written_by_pil(folder, comp):
    """Pillow's (libtiff's) writer at each compression it has, every mode
    it writes under it, classic and BigTIFF (JPEG: RGB, grey, RGBA and
    CMYK, their components as libtiff hands them over), with the ASCII
    fields a real file carries (software, date, description)."""
    px = _photo(30, 41, 6)
    modes = ("RGB", "L", "RGBA", "CMYK") if comp == "jpeg" else (
        "RGB", "L", "RGBA", "CMYK", "1", "P", "I;16", "F", "LA")
    for mode in modes:
        for big in (False, True):
            buf = _bio.BytesIO()
            Image.fromarray(px).convert(mode).save(
                buf, "TIFF", compression=comp, big_tiff=big,
                tiffinfo={305: "a renderer", 306: "2026:10:18 12:00:00",
                          270: "a texture map"})
            _hold(folder, f"pil_{comp}_{mode.replace(';', '')}_{big}.tif",
                  buf.getvalue())


@pytest.mark.parametrize("sub", [1, 2])
def test_tiff_ycbcr_jpeg(folder, sub):
    """JPEG-in-TIFF of photometric 6 (YCbCr) at 4:4:4 and 4:2:0, in strips
    and in tiles, its tables in JPEGTables: libtiff has libjpeg convert
    to RGB with its fancy (triangular) upsampling, which the port's JPEG
    decoder runs."""
    px = _photo(40, 37, 12)
    for rows in (16, 40):
        _hold(folder, f"ycbcr{sub}_{rows}.tif", W.ycbcr_jpeg_tiff(px, sub,
                                                                  rows))
    _hold(folder, f"ycbcr{sub}_tiles.tif", W.ycbcr_jpeg_tiff(
        px, sub, tile=(16, 16)))


@pytest.mark.parametrize("comp,what", [("group4", "CCITT Group 4"),
                                       ("zstd", "ZSTD")])
def test_tiff_unread_compressions_raise(folder, comp, what):
    """CCITT Group 4 and ZSTD (no zstd in Python 3.12's standard library),
    unread before the sixth image slice: PIL reads them, and the port's
    load is now bitwise the JAX package's (utils/fax_cpp, utils/zstd_cpp)."""
    px = _photo(16, 24, 13)
    im = Image.fromarray(px).convert("1" if comp == "group4" else "RGB")
    buf = _bio.BytesIO()
    im.save(buf, "TIFF", compression=comp)
    path = os.path.join(str(folder), f"unread_{comp}.tif")
    with open(path, "wb") as f:
        f.write(buf.getvalue())
    want = jax_io.load_image(path)
    assert want.shape == (16, 24, 3)
    assert io.load_image(path).tobytes() == want.tobytes(), what


# --- GIF ---------------------------------------------------------------------

@pytest.mark.parametrize("colours", [2, 16, 256])
def test_gif_written_by_pil(folder, colours):
    """Pillow's GIF writer: a palette image of 2, 16 and 256 colours,
    plain and interlaced, grey and RGB images (PIL's quantizer)."""
    rng = np.random.RandomState(colours)
    idx = rng.randint(0, colours, (23, 31)).astype(np.uint8)
    im = Image.fromarray(idx, "P")
    im.putpalette(list(rng.randint(0, 256, 3 * colours)))
    for interlace in (False, True):
        buf = _bio.BytesIO()
        im.save(buf, "GIF", interlace=interlace)
        _hold(folder, f"pil_p{colours}_{interlace}.gif", buf.getvalue())
    for mode in ("L", "RGB"):
        buf = _bio.BytesIO()
        Image.fromarray(_photo(20, 24, colours)).convert(mode).save(buf,
                                                                    "GIF")
        _hold(folder, f"pil_{mode}{colours}.gif", buf.getvalue())


def test_gif_frames_and_tables(folder):
    """Frames off the screen's origin (outside them: index 0, or the
    transparency index where a graphic control extension sets one), a
    frame past the screen (PIL grows the image), local colour tables, no
    table (the indices as grey), the identity grey table (dropped, as
    PIL drops it), an index past the table (black), 13 interlaced rows,
    and a frame whose data ends early (PIL raises: ValueError)."""
    rng = np.random.RandomState(14)
    gct = rng.randint(0, 256, (4, 3))
    fr = rng.randint(0, 4, (4, 4))
    cases = {
        "off_origin": W.write_gif((8, 8), fr, pos=(2, 2), gct=gct, bg=1),
        "off_origin_transparent": W.write_gif((8, 8), fr, pos=(2, 2),
                                              gct=gct, bg=1, transparency=3),
        "past_screen": W.write_gif((5, 5), fr, pos=(3, 4), gct=gct),
        "local_table": W.write_gif((8, 8), rng.randint(0, 8, (8, 8)),
                                   gct=gct, lct=rng.randint(0, 256, (8, 3))),
        "local_table_off_origin": W.write_gif(
            (12, 9), rng.randint(0, 8, (5, 7)), pos=(4, 3),
            lct=rng.randint(0, 256, (8, 3))),
        "no_table": W.write_gif((8, 8), rng.randint(0, 8, (8, 8))),
        "grey_ramp": W.write_gif((8, 8), rng.randint(0, 4, (8, 8)),
                                 gct=np.repeat(np.arange(4)[:, None], 3, 1)),
        "past_table": W.write_gif((8, 8), rng.randint(0, 8, (8, 8)),
                                  gct=rng.randint(0, 256, (2, 3)), bits=3),
        "interlaced_13": W.write_gif((9, 13), rng.randint(0, 4, (13, 9)),
                                     gct=gct, interlace=True),
        "deep_256": W.write_gif((100, 100), rng.randint(0, 256, (100, 100)),
                                gct=rng.randint(0, 256, (256, 3))),
    }
    for name, data in cases.items():
        _hold(folder, f"{name}.gif", data)
    idx = rng.randint(0, 4, (6, 6))
    short = W.gif_blocks(W.lzw_gif(idx.reshape(-1)[:20], 2))
    _hold(folder, "short.gif", W.write_gif((6, 6), idx, gct=gct, data=short),
          pil_reads=False)


# --- PSD ---------------------------------------------------------------------

@pytest.mark.parametrize("rle", [False, True])
def test_psd(folder, rle):
    """Raw and RLE composites: RGB, RGB + alpha, RGB with two extra
    channels (PIL reads only the RLE counts of the channels it needs, and
    so fails on the RLE file), grey, grey + alpha, duotone, multichannel,
    CMYK (stored inverted) with and without an extra channel, indexed
    with its colour table and without one (every index black), and
    bitmaps; a 16-bit file and a truncated one raise ValueError, as PIL
    fails on them."""
    rng = np.random.RandomState(15)
    h, w = 9, 13

    def sm():
        return _smooth(h, w, 1, rng.randint(1000))[..., 0]

    cases = {"rgb": ([sm() for _ in range(3)], 3, {}),
             "rgba": ([sm() for _ in range(4)], 3, {}),
             "grey": ([sm()], 1, {}), "grey_alpha": ([sm(), sm()], 1, {}),
             "duotone": ([sm()], 8, {}), "multichannel": ([sm(), sm()], 7, {}),
             "cmyk": ([sm() for _ in range(4)], 4, {}),
             "cmyk_extra": ([sm() for _ in range(5)], 4, {}),
             "indexed": ([rng.randint(0, 256, (h, w)).astype(np.uint8)], 2,
                         dict(palette=rng.randint(0, 256, 768).astype(
                             np.uint8))),
             "indexed_no_table": ([rng.randint(0, 256, (h, w)).astype(
                 np.uint8)], 2, {}),
             "bitmap": ([rng.randint(0, 256, (h, 2)).astype(np.uint8)], 0,
                        dict(bits=1, width=w))}
    for name, (planes, mode, kw) in cases.items():
        # PIL takes the RLE counts of the channels it reads only: with more
        # channels in the file, it reads data from inside the count table,
        # and fails or not by the bytes; the port reads where PIL reads.
        extra = rle and name in ("grey_alpha", "multichannel", "cmyk_extra")
        _hold(folder, f"{name}_{rle}.psd", W.write_psd(planes, mode, rle=rle,
                                                       **kw),
              pil_reads=None if extra else True)
    _hold(folder, f"extra_{rle}.psd", W.write_psd(
        [sm() for _ in range(3)], 3, rle=rle, extra_channels=2),
        pil_reads=None if rle else True)
    _hold(folder, f"deep_{rle}.psd", W.write_psd(
        [sm() for _ in range(3)], 3, bits=16, rle=rle), pil_reads=False)
    good = W.write_psd([sm() for _ in range(3)], 3, rle=rle)
    _hold(folder, f"cut_{rle}.psd", good[:-20], pil_reads=False)


def test_psd_lab_stays_unread(folder):
    """A Lab PSD, which PIL reads (and which stayed unread before the sixth
    image slice), decodes bitwise the JAX package's load: PIL's LittleCMS
    Lab -> sRGB transform (utils/lab.py)."""
    planes = [_smooth(5, 6, 1, i)[..., 0] for i in range(3)]
    path = os.path.join(str(folder), "lab.psd")
    with open(path, "wb") as f:
        f.write(W.write_psd(planes, 9))
    want = jax_io.load_image(path)
    assert want.shape == (5, 6, 3)
    assert io.load_image(path).tobytes() == want.tobytes()


# --- four-component JPEG -----------------------------------------------------

@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("quality", [50, 90])
def test_cmyk_and_ycck_jpeg(folder, quality, progressive):
    """PIL's CMYK JPEG (an Adobe marker, transform 0), the same file marked
    YCCK (transform 2: libjpeg's ycck_cmyk_convert), marked with transform
    1 (libjpeg warns and reads YCCK) and without its Adobe marker
    (straight CMYK); PIL reads each as "CMYK;I" (inverted) and converts
    to RGB."""
    px = _photo(37, 45, quality)
    buf = _bio.BytesIO()
    Image.fromarray(px).convert("CMYK").save(buf, "JPEG", quality=quality,
                                             progressive=progressive)
    data = buf.getvalue()
    tag = f"{quality}_{progressive}"
    _hold(folder, f"cmyk_{tag}.jpg", data)
    at = data.find(b"\xff\xee")
    for xform in (2, 1):
        marked = bytearray(data)
        marked[at + 4 + 11] = xform
        _hold(folder, f"ycck{xform}_{tag}.jpg", bytes(marked))
    n = int.from_bytes(data[at + 2:at + 4], "big")
    _hold(folder, f"no_adobe_{tag}.jpg", data[:at] + data[at + 2 + n:])


def test_cmyk_to_rgb_is_pils_table():
    """io.cmyk_to_rgb over all 65,536 (c, k) pairs of a channel, bitwise
    PIL's compiled conversion (Convert.c cmyk2rgb)."""
    c = np.repeat(np.arange(256, dtype=np.uint8), 256)
    k = np.tile(np.arange(256, dtype=np.uint8), 256)
    px = np.stack([c, np.roll(c, 1), np.roll(c, 7), k], -1).reshape(256, 256,
                                                                    4)
    want = np.asarray(Image.fromarray(px, "CMYK").convert("RGB"))
    assert io.cmyk_to_rgb(px).tobytes() == want.tobytes()


# --- TGA and BMP -------------------------------------------------------------

def _tga(itype, depth, w, h, body, cmap=None, cmdepth=24, flags=0x20,
         cmstart=0):
    n = len(cmap) * 8 // cmdepth if cmap is not None else 0
    head = struct.pack("<BBBHHBHHHHBB", 0, 1 if cmap is not None else 0,
                       itype, cmstart, n, cmdepth if cmap is not None else 0,
                       0, 0, w, h, depth, flags)
    return head + (cmap or b"") + body


@pytest.mark.parametrize("flags", [0x00, 0x20, 0x10, 0x30])
def test_tga_rest(folder, flags):
    """16-bit colour (X1R5G5B5, raw and run-length), 16-bit colour-map
    entries (black below the map's first index and past its end), 1-bit
    grey, each at every origin; 15-bit colour and 15-bit map entries,
    1-bit run-length data, 16-bit indices and a true-colour image with a
    colour map raise ValueError, as PIL fails on them; PIL's writer in
    every mode, raw and run-length (its 1-bit run-length file PIL itself
    cannot read)."""
    rng = np.random.RandomState(flags + 1)
    w, h = 11, 5
    b16 = rng.randint(0, 65536, w * h).astype("<u2").tobytes()
    # Runs inside rows, literals of 8 pixels crossing into the next row.
    px16 = [b16[2 * i:2 * i + 2] for i in range(w * h)]
    rle = bytearray(bytes([0x80 | 4]) + px16[0])
    for r in range(h):
        n = 8 if r < h - 1 else 6
        rle += bytes([n - 1]) + b"".join(px16[r * w + 5:r * w + 5 + n])
        if r < h - 1:
            rle += bytes([0x80 | 2]) + px16[r * w + 13]
    rle = bytes(rle)
    idx = rng.randint(0, 20, w * h).astype(np.uint8).tobytes()
    cm16 = rng.randint(0, 65536, 16).astype("<u2").tobytes()
    bits = np.packbits(rng.randint(0, 2, (h, 16)).astype(np.uint8),
                       axis=1).tobytes()
    tag = f"{flags:02x}"
    _hold(folder, f"rgb16_{tag}.tga", _tga(2, 16, w, h, b16, flags=flags))
    _hold(folder, f"rgb16_rle_{tag}.tga", _tga(10, 16, w, h, rle,
                                               flags=flags))
    _hold(folder, f"cm16_{tag}.tga", _tga(1, 8, w, h, idx, cmap=cm16,
                                          cmdepth=16, flags=flags, cmstart=2))
    _hold(folder, f"grey1_{tag}.tga", _tga(3, 1, w, h, bits, flags=flags))
    _hold(folder, f"grey_cmap_{tag}.tga", _tga(
        3, 8, w, h, rng.bytes(w * h), cmap=rng.bytes(30), flags=flags))
    for name, data in (
            ("rgb15", _tga(2, 15, w, h, b16, flags=flags)),
            ("cm15", _tga(1, 8, w, h, idx, cmap=cm16, cmdepth=15,
                          flags=flags)),
            ("grey1_rle", _tga(11, 1, w, h, bits, flags=flags)),
            ("index16", _tga(1, 16, w, h, rng.bytes(2 * w * h),
                             cmap=rng.bytes(30), flags=flags)),
            ("rgb_cmap", _tga(2, 24, w, h, rng.bytes(3 * w * h),
                              cmap=rng.bytes(30), flags=flags))):
        _hold(folder, f"{name}_{tag}.tga", data, pil_reads=False)
    if flags == 0:
        for mode in ("1", "L", "LA", "P", "RGB", "RGBA"):
            for r in (False, True):
                buf = _bio.BytesIO()
                Image.fromarray(_photo(h, w, 3)).convert(mode).save(
                    buf, "TGA", rle=r)
                _hold(folder, f"pil_{mode}_{r}.tga", buf.getvalue(),
                      pil_reads=not (mode == "1" and r))


def _bmp(w, h, bits, body, hsize=40, comp=0, palette=None, colors=0,
         masks=None, top_down=False, entry=4):
    if hsize == 12:
        head = struct.pack("<IHHHH", 12, w, h, 1, bits)
    else:
        head = struct.pack("<IiiHHIIiiII", hsize, w, -h if top_down else h,
                           1, bits, comp, len(body), 2835, 2835, colors, 0)
        if hsize >= 52 and masks is not None:
            head += struct.pack("<3I", *masks[:3])
            if hsize >= 56:
                head += struct.pack("<I", masks[3])
        head = head.ljust(hsize, b"\0")
    if hsize == 40 and comp == 3:
        head += struct.pack("<3I", *masks[:3])
    pal = b"".join(bytes([b, g, r]) + b"\0" * (entry - 3)
                   for r, g, b in (palette if palette is not None else ()))
    off = 14 + len(head) + len(pal)
    return b"BM" + struct.pack("<IHHI", off + len(body), 0, 0, off) + \
        head + pal + body


def _rows(px, bits):
    """[h, w] indices or [h, w * bytes] -> bottom-up rows, padded to 4."""
    out = b""
    for r in px[::-1]:
        if bits < 8:
            b = ((r[:, None] >> np.arange(bits - 1, -1, -1)) & 1)
            rb = np.packbits(b.astype(np.uint8).reshape(-1)).tobytes()
        else:
            rb = r.astype(np.uint8).tobytes()
        out += rb + b"\0" * (-len(rb) % 4)
    return out


MASKS32 = [(0xFF0000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0),
           (0xFF000000, 0xFF00, 0xFF, 0), (0xFF000000, 0xFF0000, 0xFF00, 0xFF),
           (0xFF, 0xFF00, 0xFF0000, 0xFF000000),
           (0xFF0000, 0xFF00, 0xFF, 0xFF000000),
           (0xFF000000, 0xFF00, 0xFF, 0xFF0000), (0, 0, 0, 0)]


def test_bmp_rest(folder):
    """16-bit BI_RGB (X1R5G5B5), BI_BITFIELDS at 16 (565, 555), 24 and 32
    bits with every mask set PIL lists (a 40-byte header's masks after
    it, a V4 / V5 header's inside it), the 12-byte OS/2 1.x header (BGR
    palette entries) at 4, 8 and 24 bits, the 64-byte OS/2 2.x header,
    grey palettes (PIL's mode L: the index is the grey level; a 4-bit
    one PIL reads from the file a byte a pixel), a bilevel palette over 8-bit
    data (PIL reads its bytes as bits); bit fields PIL does not list
    raise ValueError."""
    rng = np.random.RandomState(16)
    w, h = 13, 7
    p16 = rng.randint(0, 65536, (h, w)).astype("<u2").view(np.uint8)
    p16 = p16.reshape(h, 2 * w)
    _hold(folder, "rgb16.bmp", _bmp(w, h, 16, _rows(p16, 8)))
    _hold(folder, "bf565.bmp", _bmp(w, h, 16, _rows(p16, 8), comp=3,
                                    masks=(0xF800, 0x7E0, 0x1F)))
    _hold(folder, "bf555.bmp", _bmp(w, h, 16, _rows(p16, 8), comp=3,
                                    masks=(0x7C00, 0x3E0, 0x1F)))
    _hold(folder, "bf565_v4.bmp", _bmp(w, h, 16, _rows(p16, 8), hsize=108,
                                       comp=3, masks=(0xF800, 0x7E0, 0x1F,
                                                      0)))
    p32 = rng.randint(0, 256, (h, 4 * w))
    for i, m in enumerate(MASKS32):
        _hold(folder, f"bf32_{i}.bmp", _bmp(w, h, 32, _rows(p32, 8),
                                            hsize=124, comp=3, masks=m))
        # After a 40-byte header PIL reads three masks and no alpha mask:
        # some layouts it lists become ones it refuses.
        _hold(folder, f"bf32_40_{i}.bmp", _bmp(w, h, 32, _rows(p32, 8),
                                               comp=3, masks=m),
              pil_reads=None)
    p24 = rng.randint(0, 256, (h, 3 * w))
    _hold(folder, "bf24.bmp", _bmp(w, h, 24, _rows(p24, 8), hsize=56, comp=3,
                                   masks=(0xFF0000, 0xFF00, 0xFF, 0)))
    pal = rng.randint(0, 256, (256, 3))
    _hold(folder, "os2_4.bmp", _bmp(w, h, 4, _rows(rng.randint(
        0, 16, (h, w)), 4), hsize=12, palette=pal[:16], entry=3))
    _hold(folder, "os2_8.bmp", _bmp(w, h, 8, _rows(rng.randint(
        0, 256, (h, w)), 8), hsize=12, palette=pal, entry=3))
    _hold(folder, "os2_24.bmp", _bmp(w, h, 24, _rows(p24, 8), hsize=12))
    _hold(folder, "os2v2_8.bmp", _bmp(w, h, 8, _rows(rng.randint(
        0, 256, (h, w)), 8), hsize=64, palette=pal))
    _hold(folder, "os2v2_24.bmp", _bmp(w, h, 24, _rows(p24, 8), hsize=64))
    ramp = np.repeat(np.arange(256)[:, None], 3, 1)
    idx8 = rng.randint(0, 256, (h, w))
    _hold(folder, "grey8.bmp", _bmp(w, h, 8, _rows(idx8, 8), palette=ramp))
    _hold(folder, "grey8_16.bmp", _bmp(w, h, 8, _rows(idx8, 8),
                                       palette=ramp[:16], colors=16))
    _hold(folder, "bw8.bmp", _bmp(w, h, 8, _rows(idx8, 8),
                                  palette=[(0, 0, 0), (255, 255, 255)],
                                  colors=2))
    _hold(folder, "grey4.bmp", _bmp(w, h, 4, _rows(rng.randint(
        0, 16, (h, w)), 4), palette=ramp[:16], colors=16))
    _hold(folder, "bf16_4444.bmp", _bmp(w, h, 16, _rows(p16, 8), comp=3,
                                        masks=(0xF00, 0xF0, 0xF)),
          pil_reads=False)


def _rle8(idx):
    """RLE8 of [h, w] indices, bottom-up: runs, absolute runs of three or
    more (padded to 16 bits), end-of-line codes, end-of-bitmap."""
    out = bytearray()
    for r in idx[::-1]:
        i = 0
        while i < len(r):
            j = i
            while j + 1 < len(r) and r[j + 1] == r[i] and j - i < 254:
                j += 1
            if j > i:
                out += bytes([j - i + 1, r[i]])
                i = j + 1
                continue
            k = i
            while k < len(r) and k - i < 255 and (k + 1 >= len(r)
                                                  or r[k + 1] != r[k]):
                k += 1
            if k - i >= 3:
                out += bytes([0, k - i]) + bytes(r[i:k].tolist())
                out += b"\0" * ((k - i) % 2)
                i = k
            else:
                out += bytes([1, r[i]])
                i += 1
        out += b"\0\0"
    return bytes(out + b"\0\1")


def test_bmp_run_length(folder):
    """RLE8 (runs, absolute runs, end-of-line, end-of-bitmap; bottom-up and
    top-down; a grey palette), RLE4 (a pixel pair's nibbles alternating,
    an odd absolute run losing its last pixel as in PIL), a delta code
    (PIL skips two bytes before its pair), data short of the image (PIL
    fails: ValueError) and 200 seeded random streams of each, every one
    either bitwise PIL's or a ValueError where PIL fails too."""
    rng = np.random.RandomState(17)
    w, h = 13, 7
    idx = rng.randint(0, 4, (h, w)).astype(np.uint8)
    idx[2, 3:9] = 2
    pal = rng.randint(0, 256, (256, 3))
    _hold(folder, "rle8.bmp", _bmp(w, h, 8, _rle8(idx), comp=1, palette=pal))
    _hold(folder, "rle8_top.bmp", _bmp(w, h, 8, _rle8(idx[::-1]), comp=1,
                                       palette=pal, top_down=True))
    _hold(folder, "rle8_grey.bmp", _bmp(
        w, h, 8, _rle8(idx), comp=1,
        palette=np.repeat(np.arange(256)[:, None], 3, 1)))
    _hold(folder, "rle8_delta.bmp", _bmp(w, h, 8, bytes(
        [3, 5, 0, 2, 9, 9, 2, 1, 4, 7, 0, 0] + [13, 6, 0, 0] * 5 + [0, 1]),
        comp=1, palette=pal))
    rle4 = bytearray()
    for _ in range(h):
        rle4 += bytes([5, 0x12, 0, 5, 0x34, 0x56, 0x70, 0, 4, 0x9A, 0, 0])
    _hold(folder, "rle4.bmp", _bmp(w, h, 4, bytes(rle4 + b"\0\1"), comp=2,
                                   palette=pal[:16]))
    _hold(folder, "rle8_short.bmp", _bmp(w, h, 8, bytes([3, 5, 0, 0, 0, 1]),
                                         comp=1, palette=pal),
          pil_reads=False)
    both = 0
    for t in range(200):
        body = bytes(rng.randint(0, 256, rng.randint(2, 120)))
        for comp, bits in ((1, 8), (2, 4)):
            data = _bmp(w, h, bits, body, comp=comp,
                        palette=pal[:1 << bits])
            want = _pil(data)
            if want is None:
                with pytest.raises(ValueError):
                    io.decode_image(data)
            else:
                both += 1
                assert io.decode_image(data).tobytes() == want.tobytes(), t
    assert both > 20


# --- which plugin PIL picks --------------------------------------------------

def test_bytes_no_plugin_reads_are_value_errors(folder):
    """Text, seeded random bytes, an EXR header (PIL has no EXR plugin),
    and the plugins PIL has but cannot load from here (EPS without
    Ghostscript, the HDF5, GRIB and BUFR stubs, an MPEG stream, a
    placeable WMF) raise ValueError naming the file; PIL fails on each."""
    cases = {
        "wood.png": b"this is not an image\n",
        "notes.tga": b"wood texture, see the readme\nsecond line\n",
        "noise.tex": np.random.RandomState(19).bytes(64),
        "sky.exr": b"\x76\x2f\x31\x01" + b"\0" * 64,
        "logo.eps": b"%!PS-Adobe-3.0 EPSF-3.0\n%%BoundingBox: 0 0 10 10\n",
        "data.h5": b"\x89HDF\r\n\x1a\n" + b"\0" * 40,
        "wx.grib": b"GRIB\0\0\0\x01" + b"\0" * 40,
        "obs.bufr": b"BUFR" + b"\0" * 40,
        "clip.mpg": b"\x00\x00\x01\xb3" + b"\x01\x40\x0f\x03" + b"\0" * 40,
        "chart.wmf": b"\xd7\xcd\xc6\x9a\x00\x00" + struct.pack(
            "<hhhhH", 0, 0, 100, 100, 1440) + b"\0" * 40,
    }
    for name, data in cases.items():
        _hold(folder, name, data, pil_reads=False)


@pytest.mark.parametrize("fmt,ext", [("PPM", "ppm"), ("XBM", "xbm"),
                                     ("JPEG2000", "jp2"), ("ICO", "ico"),
                                     ("QOI", "qoi"), ("PCX", "pcx"),
                                     ("SGI", "sgi"), ("IM", "im"),
                                     ("TIFF", "tif"), ("DIB", "dib")])
def test_formats_pil_reads_and_the_port_does_not(folder, fmt, ext):
    """A file PIL writes and reads in a format the port does not read
    raises NotImplementedError naming the file and the format
    (ROADMAP.md C6); the format is the one PIL's Image.open picks. Since
    the fifth image slice PPM, ICO, QOI, PCX, SGI and DIB (a BMP without
    its file header) are read, bitwise the JAX package's, since the sixth
    the CCITT TIFF and since the seventh JPEG 2000; XBM and IM stay
    unread."""
    px = _photo(16, 16, 20)
    im = Image.fromarray(px)
    buf = _bio.BytesIO()
    if fmt == "TIFF":
        im.convert("1").save(buf, "TIFF", compression="group3")
    elif fmt == "XBM":
        im.convert("1").save(buf, "XBM")
    elif fmt == "DIB":
        im.save(buf, "BMP")
        buf = _bio.BytesIO(buf.getvalue()[14:])
    else:
        im.save(buf, fmt)
    data = buf.getvalue()
    assert Image.open(_bio.BytesIO(data)).format == fmt
    assert identify(data) == fmt
    path = os.path.join(str(folder), f"photo.{ext}")
    with open(path, "wb") as f:
        f.write(data)
    assert jax_io.load_image(path).shape == (16, 16, 3)
    if fmt in ("PPM", "ICO", "QOI", "PCX", "SGI", "DIB", "TIFF",
               "JPEG2000"):
        assert io.load_image(path).tobytes() == \
            jax_io.load_image(path).tobytes()
        return
    with pytest.raises(NotImplementedError, match=f"photo.{ext}"):
        io.load_image(path)


def test_identify_follows_pils_order():
    """A TGA of type 2 starts with CUR's magic bytes: PIL tries CUR, which
    finds no cursor, and reads it as a TGA; so does the port. A file that
    starts "BM" is a BMP for PIL, whatever follows."""
    px = _photo(5, 11, 21)
    buf = _bio.BytesIO()
    Image.fromarray(px).save(buf, "TGA")
    data = buf.getvalue()
    assert data.startswith(b"\0\0\2\0")
    assert Image.open(_bio.BytesIO(data)).format == identify(data) == "TGA"
    assert io.decode_image(data).tobytes() == px.tobytes()
    with pytest.raises(ValueError, match="bad.bmp"):
        io.decode_image(b"BM" + b"\0" * 12 + struct.pack("<I", 99)
                        + b"\0" * 120, "bad.bmp")


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


def _seeds():
    rng = np.random.RandomState(22)
    px = _photo(24, 20, 22)
    rgba = np.concatenate([px, np.full((24, 20, 1), 255, np.uint8)], -1)
    gif = _bio.BytesIO()
    Image.fromarray(px).quantize(32).save(gif, "GIF")
    dxt = _bio.BytesIO()
    Image.fromarray(rgba).save(dxt, "DDS", pixel_format="DXT5")
    lzw = _bio.BytesIO()
    Image.fromarray(px).save(lzw, "TIFF", compression="tiff_lzw")
    alpha = np.concatenate([px, np.random.RandomState(23).randint(
        0, 256, (24, 20, 1)).astype(np.uint8)], -1)
    return {
        "dds": [dxt.getvalue(), W.write_dds(
            20, 24, W.random_blocks(30, 16, 5, list(range(8))), dxgi=98)],
        "tiff": [lzw.getvalue(), W.write_tiff(
            px, 2, 8, compression=8, predictor=2, tile=(16, 16)),
            W.write_tiff(px, 2, 8, order=">", compression=32773, planar=2,
                         rows_per_strip=7)],
        "gif": [gif.getvalue(), W.write_gif(
            (24, 24), rng.randint(0, 16, (20, 18)), pos=(3, 2),
            lct=rng.randint(0, 256, (16, 3)), interlace=True)],
        "psd": [W.write_psd([px[..., c] for c in range(3)], 3, rle=True),
                W.write_psd([px[..., c] for c in range(3)], 3)],
        "webp_lossless": [_webp(px, lossless=True),
                          _webp(alpha, lossless=True, exact=True)],
        "webp_lossy": [_webp(px, quality=70),
                       _webp(alpha, quality=70, alpha_quality=80)],
    }


def _webp(img, **kw) -> bytes:
    buf = _bio.BytesIO()
    Image.fromarray(img).save(buf, "WEBP", **kw)
    return buf.getvalue()


@pytest.mark.parametrize("kind", ["dds", "tiff", "gif", "psd",
                                  "webp_lossless", "webp_lossy"])
@pytest.mark.parametrize("seed", [1, 2])
def test_mutations_never_decode_otherwise(kind, seed):
    """Bytes set, deleted or cut off in DDS, TIFF, GIF and PSD files, and
    in lossless and lossy WebP files (RGB, and RGBA: VP8L with alpha,
    VP8X with ALPH): the
    port decodes a mutated file to PIL's bits, or raises ValueError where
    PIL fails too; it raises NotImplementedError only where PIL reads the
    file (a mutation that lands on a variant the port leaves out). Since
    the fourth image slice no mutant here that PIL reads is refused: a
    TIFF field of a type PIL does not know is skipped as PIL and libtiff
    skip it. (The TIFFs PIL reads past other corrupt fields that the port
    still refuses: ROADMAP.md C6.)"""
    rng = np.random.RandomState(seed)
    both = refused = 0
    for data in _seeds()[kind]:
        for mutant in _mutants(data, rng, 60):
            want = _pil(mutant)
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
    assert both > 10
    assert refused == 0


# --- scenes ------------------------------------------------------------------

def _scene_maps(folder):
    """One map of each new format (name -> bytes) beside a PNG."""
    px = {i: _photo(16 + 4 * i, 12 + 4 * i, 30 + i) for i in range(8)}
    rgba = np.concatenate([px[0], np.full(px[0].shape[:2] + (1,), 255,
                                          np.uint8)], -1)
    out = {}
    buf = _bio.BytesIO()
    Image.fromarray(rgba).save(buf, "DDS", pixel_format="DXT1")
    out["a.dds"] = buf.getvalue()
    out["b.dds"] = W.write_dds(20, 20, W.random_blocks(25, 16, 31,
                                                       list(range(8))),
                               dxgi=98)
    out["c.tif"] = W.write_tiff(px[2], 2, 8, compression=5, predictor=2,
                                tile=(16, 16))
    buf = _bio.BytesIO()
    Image.fromarray(px[3]).quantize(48).save(buf, "GIF")
    out["d.gif"] = buf.getvalue()
    out["e.psd"] = W.write_psd([px[4][..., c] for c in range(3)], 3, rle=True)
    buf = _bio.BytesIO()
    Image.fromarray(px[5]).convert("CMYK").save(buf, "JPEG", quality=80)
    out["f.jpg"] = buf.getvalue()
    buf = _bio.BytesIO()
    Image.fromarray(px[6]).save(buf, "TGA", rle=True)
    out["g.tga"] = buf.getvalue()
    p16 = px[7][..., 0].astype(np.uint16) * 257
    out["h.bmp"] = _bmp(p16.shape[1], p16.shape[0], 16, _rows(
        p16.astype("<u2").view(np.uint8).reshape(p16.shape[0], -1), 8))
    for name, data in out.items():
        with open(os.path.join(str(folder), name), "wb") as f:
            f.write(data)
    io.save_png(os.path.join(str(folder), "z.png"), _photo(8, 8, 39))
    return sorted(out) + ["z.png"]


@pytest.mark.parametrize("levels", [1, 4])
def test_obj_with_maps_of_every_format(tmp_path, levels):
    """An OBJ whose map_Kd maps are one file of each new format (DXT1 and
    BC7 DDS, a tiled LZW TIFF, a GIF, an RLE PSD, a CMYK JPEG, an RLE TGA,
    a 16-bit BMP) and a PNG: build_atlas and load_scene's atlas tables
    and material rows bitwise JAX's."""
    maps = _scene_maps(tmp_path)
    got = textures.build_atlas(maps, str(tmp_path), mip_levels=levels)
    want = jax_textures.build_atlas(maps, str(tmp_path), mip_levels=levels)
    assert got[2] == want[2] and len(got[2]) == len(maps)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    _hold_atlas(dict(scene_path=_textured_obj(str(tmp_path), maps),
                     mip_levels=levels))


def test_cube_sky_of_dds_tiff_and_gif_faces(tmp_path):
    """A .txt cube sky whose six faces are DDS (BC1, uncompressed), TIFF
    (LZW, Deflate tiles), GIF and a 16-bit-colour TGA: the environment
    image bitwise the JAX package's."""
    names = []
    for i in range(6):
        px = _photo(16, 16, 40 + i)
        buf = _bio.BytesIO()
        im = Image.fromarray(px)
        if i == 0:
            im.convert("RGBA").save(buf, "DDS", pixel_format="DXT1")
            name = "px.dds"
        elif i == 1:
            im.save(buf, "DDS")
            name = "nx.dds"
        elif i == 2:
            im.save(buf, "TIFF", compression="tiff_lzw")
            name = "py.tif"
        elif i == 3:
            buf.write(W.write_tiff(px, 2, 8, compression=8, tile=(16, 16)))
            name = "ny.tiff"
        elif i == 4:
            im.quantize(40).save(buf, "GIF")
            name = "pz.gif"
        else:
            buf.write(_tga(2, 16, 16, 16, np.random.RandomState(i).randint(
                0, 65536, 256).astype("<u2").tobytes()))
            name = "nz.tga"
        (tmp_path / name).write_bytes(buf.getvalue())
        names.append(name)
    (tmp_path / "cube.txt").write_text("\n".join(names) + "\n")
    spec = str(tmp_path / "cube.txt")
    got = envmap.environment_image(spec)
    want = np.asarray(jax_envmap.load_environment(spec).image)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()


@pytest.mark.parametrize("levels", [1, 4])
def test_maps_no_reader_identifies_are_skipped(tmp_path, levels):
    """A text file named wood.png and 64 random bytes named noise.tex: PIL
    identifies neither, so the JAX atlas builder skips both; the port's
    raises ValueError for each and skips them too, and both packages'
    atlases, slots and scene tables are equal."""
    io.save_png(str(tmp_path / "good.png"), _photo(12, 16, 50))
    (tmp_path / "wood.png").write_text("wood texture goes here\n")
    (tmp_path / "noise.tex").write_bytes(np.random.RandomState(51).bytes(64))
    for name in ("wood.png", "noise.tex"):
        with pytest.raises(ValueError, match=name):
            io.load_image(str(tmp_path / name))
    maps = ["wood.png", "good.png", "noise.tex"]
    got = textures.build_atlas(maps, str(tmp_path), mip_levels=levels)
    want = jax_textures.build_atlas(maps, str(tmp_path), mip_levels=levels)
    assert got[2] == want[2] == {"good.png": 0}
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.tobytes() == w.tobytes()
    _hold_atlas(dict(scene_path=_textured_obj(str(tmp_path), maps),
                     mip_levels=levels))
