"""JPEG 2000 and ICNS as PIL reads them (ROADMAP.md C6, seventh part), held
bitwise to PIL's ``Image.open(path).convert("RGB")`` on the CPU, and the
open-time checks of the plugins the port does not read (ROADMAP.md C9).

- JPEG 2000 (utils/jpeg2000.py, utils/j2k_cpp/j2k.cpp): J2K codestreams
  and JP2 files of every save option PIL has and of each mode it opens
  (L, LA, RGB, RGBA, I;16; CMYK, sYCC, P and PA from JP2 boxes), the
  irreversible 9/7 files among them; the committed fixtures of
  tools/torch_image_fixtures.py (OpenJPEG's own encoder for each
  code-block style, ROI, SOP / EPH, tile-parts, TLM, POC, subsampling,
  12 bits; PPM / PPT; edits of PIL's files: COD's style byte and
  inserted RGN, POC, COC, QCC segments); colour boxes PIL reads or
  refuses.
- ICNS (utils/icns.py): every element kind (is32 / il32 / ih32 / it32
  with their masks, raw RGB, PNG and JPEG 2000 elements).
- C9: junk behind each unread plugin's magic bytes raises ValueError
  where PIL fails, as bytes PIL cannot open do.
- The mutation generator of tests/test_torch_simple_formats.py on J2K,
  JP2 and ICNS files, build_atlas, a cube sky of JP2 faces.

Every case writes a file and holds ``decode_image`` to PIL's decode of
that path and ``load_image`` to the JAX package's. The card's test at the
end runs where neither PIL nor the JAX package is:

    python -m pytest tests/test_torch_jpeg2000.py -m cuda --noconftest -q

The seeded fuzz behind ROADMAP.md C6's counts:

    python tests/test_torch_jpeg2000.py --fuzz 1-100
"""

import hashlib
import json
import os
import struct
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The repository and this folder, for the --fuzz run as a script.
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
from gpupathtracer_tpu_torch.utils import io  # noqa: E402
from gpupathtracer_tpu_torch.utils.identify import identify  # noqa: E402
from test_torch_simple_formats import (  # noqa: E402
    W, _hold, _mutants, _photo, _pil_path, _pil_save)

FIXTURES = os.path.join(REPO, "tests", "golden", "images")
FORMATS = ("JPEG2000", "ICNS")
# Phase 26b's town: each map's file, decoding to the map's PNG twin.
TOWN_JPEG2000 = {"checker": "checker.jp2", "bricks": "bricks.j2k",
                 "roof": "roof.icns", "foliage": "foliage.jp2"}


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return tmp_path_factory.mktemp("jpeg2000")


def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


def _names():
    return sorted(k for k, v in _manifest().items() if v["format"] in FORMATS)


# --- PIL's save options and modes --------------------------------------------

OPTIONS = {
    "default": {}, "irreversible": dict(irreversible=True),
    "rate": dict(irreversible=True, quality_layers=[40, 15]),
    "db": dict(quality_mode="dB", quality_layers=[28, 36]),
    "mct0": dict(mct=0), "offsets": dict(tile_offset=(2, 3), offset=(5, 4),
                                         tile_size=(9, 11)),
    "res1": dict(num_resolutions=1), "res5": dict(num_resolutions=5),
    "cb": dict(codeblock_size=(8, 32)),
    "rlcp": dict(progression="RLCP", quality_layers=[30, 0]),
    "rpcl": dict(progression="RPCL", precinct_size=(8, 8),
                 num_resolutions=3),
    "pcrl": dict(progression="PCRL", tile_size=(16, 16), num_resolutions=3),
    "cprl": dict(progression="CPRL", irreversible=True),
    "signed": dict(signed=True), "signed97": dict(signed=True,
                                                  irreversible=True),
    "comment_plt": dict(comment=b"x\ny", plt=True),
}


@pytest.mark.parametrize("container", ["j2k", "jp2"])
@pytest.mark.parametrize("option", sorted(OPTIONS))
def test_pil_save_options(folder, option, container):
    """Each of PIL's save options, as a codestream and as a JP2 file."""
    data = _pil_save(_photo(29, 34, 3), "JPEG2000",
                     no_jp2=container == "j2k", **OPTIONS[option])
    _hold(folder, f"{option}.{container}", data)


@pytest.mark.parametrize("mode", ["L", "LA", "RGBA", "I;16", "I;16s"])
@pytest.mark.parametrize("irreversible", [False, True])
def test_pil_modes(folder, mode, irreversible):
    """L, LA, RGBA and 12-bit grey (PIL's I;16, clipped at 255 by
    convert("RGB")), reversible and 9/7, and signed grey."""
    from PIL import Image
    px = _photo(23, 31, 4)
    if mode.startswith("I;16"):
        im = Image.fromarray(px[..., 0].astype(np.uint16) * 13)
    else:
        im = Image.fromarray(px).convert(mode)
    data = _pil_save(im, "JPEG2000", irreversible=irreversible,
                     signed=mode == "I;16s")
    _hold(folder, f"{mode.replace(';', '')}_{int(irreversible)}.jp2", data)


# Colour boxes: enumerated colour spaces (16 sRGB, 17 grey, 18 sYCC, 12
# CMYK, unknown ones and an ICC profile) on each mode PIL writes.
@pytest.mark.parametrize("mode", ["L", "LA", "RGB", "RGBA"])
@pytest.mark.parametrize("enumcs", [16, 17, 18, 12, 99, "icc"])
def test_colour_boxes(folder, mode, enumcs):
    """OpenJPEG's colour space from colr meets Pillow's unpackers: what
    PIL reads (sRGB, grey, sYCC through Pillow's YCbCr tables, CMYK, and
    any other colr read as unspecified) decodes bitwise, what it refuses
    (sRGB or sYCC on grey, grey on RGB, ...) raises ValueError."""
    from PIL import Image
    data = _pil_save(Image.fromarray(_photo(17, 21, 5)).convert(mode),
                     "JPEG2000")
    if enumcs == "icc":
        data = W.jp2_edit(data, header=lambda boxes: [
            [t, b"\2\0\0" + bytes(40)] if t == b"colr" else [t, b]
            for t, b in boxes])
    else:
        data = W.jp2_edit(data, colr=enumcs)
    _hold(folder, f"{mode}_{enumcs}.jp2", data, pil_reads=None)


def test_ycbcr_tables():
    """utils/ycbcr_rgb.bin is Pillow's YCbCr -> RGB: 200,000 random (Y, Cb,
    Cr) and every Cb and Cr at three Y, converted by PIL and by the
    tables."""
    from PIL import Image

    from gpupathtracer_tpu_torch.utils.jpeg2000 import ycbcr_tables
    rng = np.random.RandomState(7)
    c = np.arange(256)
    cb, cr = np.meshgrid(c, c)
    grid = np.concatenate([np.stack([np.full(65536, y), cb.ravel(),
                                     cr.ravel()], -1) for y in (0, 128, 255)])
    ycc = np.concatenate([rng.randint(0, 256, (200000, 3)), grid]).astype(
        np.uint8)
    want = np.asarray(Image.frombytes("YCbCr", (len(ycc), 1), ycc.tobytes())
                      .convert("RGB"))[0].astype(int)
    t = ycbcr_tables().astype(int)
    y, b, r = (ycc[:, k].astype(int) for k in range(3))
    got = np.clip(np.stack([y + (t[0][r] >> 6),
                            y + ((t[1][b] + t[2][r]) >> 6),
                            y + (t[3][b] >> 6)], -1), 0, 255)
    assert (got == want).all()


# --- the committed fixtures --------------------------------------------------

@pytest.mark.parametrize("name", _names())
def test_fixtures_bitwise(name):
    """Every committed JPEG 2000 and ICNS fixture (the card's machine reads
    them without PIL): bitwise its PNG twin and the manifest's sha256s,
    and PIL reads the file to the same pixels."""
    import warnings

    from PIL import Image
    e = _manifest()[name]
    with open(os.path.join(FIXTURES, e["file"]), "rb") as f:
        data = f.read()
    with open(os.path.join(FIXTURES, e["png"]), "rb") as f:
        png = f.read()
    assert hashlib.sha256(data).hexdigest() == e["file_sha256"]
    assert hashlib.sha256(png).hexdigest() == e["png_sha256"]
    assert identify(data, name) == e["format"]
    got = io.decode_image(data, name)
    assert got.tobytes() == io.decode_png(png, name).tobytes()
    assert hashlib.sha256(got.tobytes()).hexdigest() == e["pixels_sha256"]
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        im = Image.open(os.path.join(FIXTURES, e["file"]))
        assert im.format == e["format"]
        assert np.asarray(im.convert("RGB")).tobytes() == got.tobytes()


def test_town_maps_decode_to_their_twins():
    """Phase 26b's four maps (checker and foliage JP2, bricks J2K, roof an
    ICNS) decode to the town's own PNG twins."""
    manifest = _manifest()
    for name, fname in TOWN_JPEG2000.items():
        e = next(v for v in manifest.values() if v["file"] == fname)
        assert e["png"] == f"{name}.png"


# --- ICNS --------------------------------------------------------------------

def _icns(elems) -> bytes:
    body = b"".join(k + struct.pack(">I", len(d) + 8) + d for k, d in elems)
    return b"icns" + struct.pack(">I", len(body) + 8) + body


def _rgb32(px, t32=False):
    data = b"".join(W.icns_rle(px[..., c].tobytes()) for c in range(3))
    return b"\0\0\0\0" + data if t32 else data


ICNS_CASES = {
    "is32": lambda p: _icns([(b"is32", _rgb32(p(16))),
                             (b"s8mk", bytes(256))]),
    "il32_raw": lambda p: _icns([(b"il32", p(32).tobytes())]),
    "ih32": lambda p: _icns([(b"ih32", _rgb32(p(48)))]),
    "it32": lambda p: _icns([(b"it32", _rgb32(p(128), True)),
                             (b"t8mk", bytes(128 * 128))]),
    "it32_no_sig": lambda p: _icns([(b"it32", _rgb32(p(128)))]),
    "mask_only": lambda p: _icns([(b"s8mk", bytes(256))]),
    "mask_short": lambda p: _icns([(b"is32", _rgb32(p(16))),
                                   (b"s8mk", bytes(100))]),
    "rle_short": lambda p: _icns([(b"il32", _rgb32(p(32))[:-40])]),
    "icp4_png": lambda p: _icns([(b"icp4", _pil_save(p(16), "PNG"))]),
    "ic11_png_64": lambda p: _icns([(b"ic11", _pil_save(p(64), "PNG"))]),
    "ic12_png_16": lambda p: _icns([(b"ic12", _pil_save(p(16), "PNG")),
                                    (b"il32", p(32).tobytes())]),
    "icp5_j2k": lambda p: _icns([(b"icp5", _pil_save(p(32), "JPEG2000",
                                                      no_jp2=True)),
                                 (b"il32", _rgb32(p(32)))]),
    "ic07_jp2_i16": lambda p: _icns([(b"ic07", _pil_save(
        p(128)[..., 0].astype(np.uint16) * 7, "JPEG2000"))]),
    "unknown_element": lambda p: _icns([(b"icp6", b"GIF89a" + bytes(40))]),
    "pil_writer": lambda p: _pil_save(p(32), "ICNS"),
    "zero_block": lambda p: b"icns" + struct.pack(">I", 24) + b"is32" +
    struct.pack(">I", 0) + bytes(8),
    "no_sizes": lambda p: _icns([(b"abcd", bytes(16))]),
}


@pytest.mark.parametrize("case", sorted(ICNS_CASES))
def test_icns_elements(folder, case):
    """Each element kind, the one PIL picks among several, and what PIL
    refuses: a PNG of a size PIL does not allow, a mask or run-length
    band cut short, an it32 without its zero signature, a size with only
    its mask, an element neither PNG nor JPEG 2000, a block of size 0."""
    data = ICNS_CASES[case](lambda n: _photo(n, n, n))
    _hold(folder, f"{case}.icns", data, pil_reads=None)


# --- C9: the unread plugins' open-time checks --------------------------------

def _j2k_csiz(n):
    data = bytearray(_pil_save(_photo(8, 8, 1), "JPEG2000", no_jp2=True))
    data[40:42] = struct.pack(">H", n)      # SIZ's Csiz
    return bytes(data)


C9_JUNK = {
    "blp1": b"BLP1" + bytes(64), "blp2": b"BLP2" + bytes(64),
    "dcx": struct.pack("<I", 987654321) + bytes(64),
    "fits": b"SIMPLE" + bytes(64),
    "fli": bytes(4) + struct.pack("<H", 0xAF11) + bytes(64),
    "ftex": b"FTEX" + bytes(64),
    "mcidas": b"\0\0\0\0\0\0\0\4" + bytes(64),
    "msp": b"DanM" + bytes(64), "pixar": b"\200\350\000\000" + bytes(64),
    "sun": b"\x59\xa6\x6a\x95" + bytes(64), "xbm": b"#define" + bytes(64),
    "xpm": b"/* XPM */" + bytes(64), "xvthumb": b"P7 332" + bytes(64),
    "j2k_csiz5": None, "jp2_no_ihdr": None,
    "icns_zero_block": ICNS_CASES["zero_block"](None),
}


@pytest.mark.parametrize("case", sorted(C9_JUNK))
def test_unread_plugins_refuse_junk(folder, case):
    """Each unread plugin's magic bytes before junk, a J2K of 5 components,
    a JP2 without ihdr, an icns with a block of size 0: PIL fails (the
    plugin's _open refuses, or FTEX's assertion stops it), and the port
    raises ValueError naming the file, as it does for bytes PIL cannot
    read, so build_atlas skips the map as the JAX package does."""
    data = C9_JUNK[case]
    if case == "j2k_csiz5":
        data = _j2k_csiz(5)
    elif case == "jp2_no_ihdr":
        data = _pil_save(_photo(8, 8, 1), "JPEG2000").replace(b"ihdr",
                                                             b"xhdr", 1)
    _hold(folder, f"{case}.junk", data, pil_reads=False)


@pytest.mark.parametrize("fmt,ext", [("BLP", "blp"), ("MSP", "msp"),
                                     ("XBM", "xbm"), ("DCX", "dcx")])
def test_unread_plugins_still_open_what_pil_writes(folder, fmt, ext):
    """The checks let through what PIL writes: the format is PIL's and the
    port still raises NotImplementedError naming the file (C6)."""
    from PIL import Image
    im = Image.fromarray(_photo(16, 16, 9))
    if fmt in ("MSP", "XBM"):
        im = im.convert("1")
    elif fmt == "BLP":
        im = im.quantize(16)
    if fmt == "DCX":
        data = struct.pack("<II", 987654321, 12) + bytes(4) + _pil_save(
            im, "PCX")
    else:
        data = _pil_save(im, fmt)
    path = os.path.join(str(folder), f"photo.{ext}")
    with open(path, "wb") as f:
        f.write(data)
    assert _pil_path(path)[1] == fmt
    assert identify(data, path) == fmt
    with pytest.raises(NotImplementedError, match=f"photo.{ext}"):
        io.load_image(path)


# --- HT code-blocks over Part 1 data, the atlas, a sky ----------------------

def test_htj2k_raises_not_implemented(folder):
    """A codestream whose COD asks for HTJ2K code-blocks (style bit 0x40)
    over PIL's Part 1 code-block data: the port reads it as OpenJPEG reads
    HT code-blocks, bitwise PIL where PIL decodes it and ValueError naming
    the file where PIL fails (ROADMAP.md C6: no JPEG 2000 file raises
    NotImplementedError)."""
    data = W.j2k_cod_style(_pil_save(_photo(16, 16, 2), "JPEG2000",
                                     no_jp2=True), 0x40)
    _hold(folder, "ht.j2k", data, pil_reads=None)


def test_atlas_skips_what_pil_refuses_and_stops_on_htj2k(tmp_path):
    """An OBJ's maps: a JP2, an ICNS, a J2K PIL refuses (truncated), C9
    junk and an AVIF of junk behind its ftyp box (libavif refuses it at
    open): build_atlas's tables bitwise the JAX package's, the three
    skipped by both; a PIL-written AVIF, which the JAX package reads and
    the port does not yet (ROADMAP.md C6), stops the port's atlas."""
    from gpupathtracer_tpu.scene import textures as jax_textures

    from gpupathtracer_tpu_torch.scene import textures
    jp2 = _pil_save(_photo(8, 8, 3), "JPEG2000")
    (tmp_path / "a.jp2").write_bytes(jp2)
    (tmp_path / "b.icns").write_bytes(ICNS_CASES["is32"](
        lambda n: _photo(n, n, 4)))
    (tmp_path / "cut.j2k").write_bytes(_pil_save(
        _photo(8, 8, 5), "JPEG2000", no_jp2=True)[:-20])
    (tmp_path / "junk.xbm").write_bytes(C9_JUNK["xbm"])
    avif = _pil_save(_photo(8, 8, 6), "AVIF")
    (tmp_path / "junk.avif").write_bytes(avif[:32] + bytes(40))
    maps = ["a.jp2", "b.icns", "cut.j2k", "junk.xbm", "junk.avif"]
    got = textures.build_atlas(maps, str(tmp_path), mip_levels=2)
    want = jax_textures.build_atlas(maps, str(tmp_path), mip_levels=2)
    assert got[2] == want[2] and len(got[2]) == 2
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    (tmp_path / "photo.avif").write_bytes(avif)
    jax_textures.build_atlas(maps + ["photo.avif"], str(tmp_path),
                             mip_levels=2)
    with pytest.raises(NotImplementedError, match="photo.avif"):
        textures.build_atlas(maps + ["photo.avif"], str(tmp_path),
                             mip_levels=2)


def test_cube_sky_of_jp2_faces(tmp_path):
    """A .txt cube sky whose six faces are JP2 and J2K files (9/7 among
    them): the environment image bitwise the JAX package's."""
    from gpupathtracer_tpu.scene import envmap as jax_envmap

    from gpupathtracer_tpu_torch.scene import envmap
    names = ["px.jp2", "nx.j2k", "py.jp2", "ny.j2k", "pz.jp2", "nz.j2k"]
    for i, name in enumerate(names):
        (tmp_path / name).write_bytes(_pil_save(
            _photo(16, 16, 40 + i), "JPEG2000", no_jp2=name.endswith("k"),
            irreversible=i % 2 == 1))
    (tmp_path / "cube.txt").write_text("\n".join(names) + "\n")
    spec = str(tmp_path / "cube.txt")
    got = envmap.environment_image(spec)
    want = np.asarray(jax_envmap.load_environment(spec).image)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()


# --- mutations ---------------------------------------------------------------

def _mutation_seeds(kind: str) -> list:
    from PIL import Image
    im = Image.fromarray(_photo(12, 10, 20))
    if kind == "j2k":
        return [_pil_save(im, "JPEG2000", no_jp2=True),
                _pil_save(im, "JPEG2000", no_jp2=True, irreversible=True,
                          quality_layers=[20, 5])]
    if kind == "jp2":
        return [_pil_save(im, "JPEG2000"),
                _pil_save(im, "JPEG2000", tile_size=(8, 8),
                          num_resolutions=2, progression="RPCL"),
                _pil_save(im.convert("L"), "JPEG2000", quality_layers=[20,
                                                                       5])]
    return [ICNS_CASES["is32"](lambda n: _photo(n, n, 21)),
            ICNS_CASES["icp5_j2k"](lambda n: _photo(n, n, 22))]


def mutation_counts(kind: str, seed: int, count: int = 40) -> dict:
    """The generator's mutants of each seed file: both read alike, PIL
    reads and the port refuses, decodes otherwise, or raises
    NotImplementedError; the port decodes or raises NotImplementedError
    where PIL fails; both fail."""
    import tempfile
    rng = np.random.RandomState(seed)
    counts = dict(both=0, refused=0, otherwise=0, unread=0, extra=0,
                  unread_pil_fails=0, both_fail=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mutant")
        for data in _mutation_seeds(kind):
            for mutant in _mutants(data, rng, count):
                with open(path, "wb") as f:
                    f.write(mutant)
                want, _ = _pil_path(path)
                try:
                    got = io.decode_image(mutant, "mutant")
                except ValueError:
                    counts["refused" if want is not None else
                           "both_fail"] += 1
                    continue
                except NotImplementedError:
                    counts["unread" if want is not None else
                           "unread_pil_fails"] += 1
                    continue
                if want is None:
                    counts["extra"] += 1
                elif got.tobytes() == want.tobytes():
                    counts["both"] += 1
                else:
                    counts["otherwise"] += 1
    return counts


@pytest.mark.parametrize("kind", ["j2k", "jp2", "icns"])
@pytest.mark.parametrize("seed", [1, 2])
def test_mutations_never_decode_otherwise(kind, seed):
    """Bytes set, deleted or cut off in J2K, JP2 and ICNS files: the port
    decodes a mutant to the bits PIL reads from its path, or raises
    ValueError where PIL fails too; NotImplementedError only where PIL
    reads the mutant. No mutant PIL reads is refused."""
    c = mutation_counts(kind, seed)
    assert c["both"] > 5, c
    assert c["refused"] == c["otherwise"] == c["extra"] == 0, c
    assert c["unread_pil_fails"] == 0, c


# --- edits of the structure: marker segments, tile-part headers, boxes ------

def _segment(rng) -> bytes:
    """A marker segment of a random kind, with fields near valid ones."""
    r = lambda n: bytes(rng.randint(0, 256, n).tolist())  # noqa: E731
    pick = lambda *v: v[rng.randint(len(v))]  # noqa: E731
    m = pick(0xFF52, 0xFF53, 0xFF5C, 0xFF5D, 0xFF5E, 0xFF5F, 0xFF64, 0xFF57,
             0xFF55, 0xFF63, 0xFF58, 0xFF61, 0xFF30, 0xFF50)
    if m == 0xFF52:                     # COD
        b = bytes([pick(0, 2, 4, 6), rng.randint(6), 0, pick(1, 2),
                   rng.randint(2), rng.randint(7), rng.randint(5),
                   rng.randint(5), pick(0, 1, 8, 0x20, 0x3F), rng.randint(2)])
    elif m == 0xFF53:                   # COC
        b = bytes([rng.randint(4), rng.randint(2), rng.randint(6),
                   rng.randint(5), rng.randint(5), pick(0, 8, 0x20),
                   rng.randint(2)])
    elif m in (0xFF5C, 0xFF5D):         # QCD, QCC
        b = (bytes([rng.randint(4)]) if m == 0xFF5D else b"") + bytes(
            [pick(0x40, 0x41, 0x42, 0x22)]) + r(rng.randint(0, 20))
    elif m == 0xFF5E:                   # RGN
        b = bytes([rng.randint(4), 0, rng.randint(40)])
    elif m == 0xFF5F:                   # POC
        b = b"".join(bytes([rng.randint(4), rng.randint(3), 0,
                            rng.randint(4), rng.randint(7), rng.randint(5),
                            rng.randint(7)]) for _ in range(rng.randint(1, 4)))
    elif m == 0xFF55:                   # TLM
        b = bytes([0, pick(0, 0x10, 0x20, 0x30, 0x50, 0x60)]) + r(
            pick(0, 2, 4, 6, 8))
    else:
        b = r(rng.randint(0, 8))
    return struct.pack(">HH", m, len(b) + 2) + b


def _edit_main_header(cs: bytes, rng) -> bytes:
    """Marker segments of the main header (after SIZ) dropped, inserted or
    swapped."""
    pos, segs = 2, []
    while struct.unpack_from(">H", cs, pos)[0] != 0xFF90:
        n = struct.unpack_from(">H", cs, pos + 2)[0]
        segs.append(cs[pos:pos + 2 + n])
        pos += 2 + n
    for _ in range(rng.randint(1, 3)):
        op = rng.randint(4)
        if op == 0 and len(segs) > 1:
            segs.pop(rng.randint(1, len(segs)))
        elif op in (1, 2):
            segs.insert(rng.randint(1, len(segs) + 1), _segment(rng))
        elif len(segs) > 2:
            i, j = rng.randint(1, len(segs), 2)
            segs[i], segs[j] = segs[j], segs[i]
    return cs[:2] + b"".join(segs) + cs[pos:]


def _edit_tile_headers(cs: bytes, rng) -> bytes:
    """Segments dropped from or inserted into tile-part headers, Psot
    kept true."""
    pos = W.j2k_main_header(cs)
    out = bytearray(cs[:pos])
    while cs[pos:pos + 2] == b"\xff\x90":
        psot = struct.unpack_from(">I", cs, pos + 6)[0]
        end = pos + psot if psot else len(cs) - 2
        sod, segs = pos + 12, []
        while cs[sod:sod + 2] != b"\xff\x93":
            n = struct.unpack_from(">H", cs, sod + 2)[0]
            segs.append(cs[sod:sod + 2 + n])
            sod += 2 + n
        if rng.rand() < 0.5:
            for _ in range(rng.randint(1, 3)):
                if segs and rng.rand() < 0.3:
                    segs.pop(rng.randint(len(segs)))
                else:
                    segs.insert(rng.randint(len(segs) + 1), _segment(rng))
        body = b"".join(segs) + cs[sod:end]
        out += cs[pos:pos + 6] + struct.pack(">I", 12 + len(body)) + \
            cs[pos + 10:pos + 12] + body
        pos = end
    return bytes(out + cs[pos:])


def _box(rng) -> list:
    """A jp2h box of a random kind, with fields near valid ones."""
    pick = lambda *v: v[rng.randint(len(v))]  # noqa: E731
    t = pick(b"colr", b"pclr", b"cmap", b"cdef", b"bpcc", b"res ", b"ihdr",
             b"xxxx")
    if t == b"colr":
        return [t, bytes([pick(1, 1, 2, 3), 0, 0]) + struct.pack(
            ">I", pick(16, 17, 18, 12, 24, 14, 0, 99))]
    if t == b"pclr":
        ne, npc = pick(1, 4, 16, 300), pick(1, 2, 3, 4, 5)
        depths = [pick(7, 7, 15, 0x87) for _ in range(npc)]
        size = ne * sum(min(((d & 0x7F) + 8) >> 3, 4) for d in depths)
        return [t, struct.pack(">HB", ne, npc) + bytes(depths) + bytes(
            rng.randint(0, 256, size).tolist())]
    if t == b"cmap":
        return [t, b"".join(struct.pack(">HBB", rng.randint(3),
                                        rng.randint(2), rng.randint(3))
                            for _ in range(rng.randint(1, 4)))]
    if t == b"cdef":
        n = rng.randint(0, 5)
        return [t, struct.pack(">H", n) + b"".join(struct.pack(
            ">HHH", rng.randint(4), rng.randint(3), rng.randint(4))
            for _ in range(n))]
    if t == b"bpcc":
        return [t, bytes([7] * rng.randint(0, 5))]
    if t == b"res ":
        return [t, W._box(b"resc", struct.pack(
            ">HHHHBB", *rng.randint(0, 3, 6).tolist()))]
    if t == b"ihdr":
        return [t, struct.pack(">IIHBBBB", 11, 13, pick(1, 2, 3, 4),
                               pick(7, 15, 0x87, 255), 7, 0, 0)]
    return [t, b"abc"]


def _edit_boxes(jp2: bytes, rng) -> bytes:
    """jp2h's boxes dropped, inserted, swapped, or ihdr's count and depth
    changed."""
    def edit(boxes):
        for _ in range(rng.randint(1, 4)):
            op = rng.randint(5)
            if op == 0 and boxes:
                boxes.pop(rng.randint(len(boxes)))
            elif op in (1, 4):
                boxes.insert(rng.randint(len(boxes) + 1), _box(rng))
            elif op == 2 and len(boxes) > 1:
                i, j = rng.randint(len(boxes), size=2)
                boxes[i], boxes[j] = boxes[j], boxes[i]
            elif op == 3:
                for b in boxes:
                    if b[0] == b"ihdr":
                        b[1] = b[1][:8] + struct.pack(">HB", rng.randint(
                            1, 6), [7, 15, 0x87, 255][rng.randint(4)]) + \
                            b[1][11:]
        return boxes
    return W.jp2_edit(jp2, header=edit)


def _edit_seeds(kind: str) -> list:
    from PIL import Image
    px = _photo(19, 23, 23)
    if kind == "boxes":
        return [_pil_save(Image.fromarray(px).convert(m), "JPEG2000")
                for m in ("L", "LA", "RGB", "RGBA")]
    return [_pil_save(px, "JPEG2000", no_jp2=True, tile_size=(8, 8),
                      num_resolutions=2),
            _pil_save(px, "JPEG2000", no_jp2=True, tile_size=(16, 16),
                      num_resolutions=3, irreversible=True,
                      quality_layers=[30, 8]),
            _pil_save(px, "JPEG2000", no_jp2=True, progression="PCRL",
                      precinct_size=(8, 8), num_resolutions=3)]


_EDITS = {"markers": _edit_main_header, "tileparts": _edit_tile_headers,
          "boxes": _edit_boxes}


def edit_counts(kind: str, seed: int, count: int = 60) -> dict:
    """The counts of mutation_counts over files whose structure is edited
    (_EDITS) rather than their bytes."""
    import tempfile
    rng = np.random.RandomState(seed)
    seeds = _edit_seeds(kind)
    counts = dict(both=0, refused=0, otherwise=0, unread=0, extra=0,
                  unread_pil_fails=0, both_fail=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "edited")
        for _ in range(count):
            data = _EDITS[kind](seeds[rng.randint(len(seeds))], rng)
            with open(path, "wb") as f:
                f.write(data)
            want, _ = _pil_path(path)
            try:
                got = io.decode_image(data, "edited")
            except ValueError:
                counts["refused" if want is not None else "both_fail"] += 1
                continue
            except NotImplementedError:
                counts["unread" if want is not None else
                       "unread_pil_fails"] += 1
                continue
            if want is None:
                counts["extra"] += 1
            elif got.tobytes() == want.tobytes():
                counts["both"] += 1
            else:
                counts["otherwise"] += 1
    return counts


@pytest.mark.parametrize("kind", sorted(_EDITS))
def test_structure_edits_decode_as_pil(kind):
    """Marker segments of the main header and of tile-part headers, and
    jp2h's boxes, dropped, inserted (COD, COC, QCD, QCC, RGN, POC, TLM,
    PLM, PLT, PPT, CRG, COM and unknown ones, near valid) or swapped: the
    port reads each file as PIL does or fails where it fails."""
    c = edit_counts(kind, 1)
    assert c["both"] > 5 and c["both_fail"] > 5, c
    assert c["refused"] == c["otherwise"] == c["extra"] == 0, c
    assert c["unread_pil_fails"] == 0, c


def test_openjpeg_quirks(folder):
    """Three behaviours of OpenJPEG 2.5.4 found by probing: a missing EPH
    marker fails the decode (a missing SOP only warns); a TLM segment of
    a wrong size only warns; a tile whose packets reach no resolution (a
    tile-part POC that names none) is written at resolution 0, each
    component packed from the start of Pillow's zeroed buffer."""
    with open(os.path.join(FIXTURES, "sop_eph.j2k"), "rb") as f:
        sop_eph = f.read()
    no_eph = bytearray(sop_eph)
    at = no_eph.index(b"\xff\x92")
    no_eph[at + 1] = 0x93
    no_sop = bytearray(sop_eph)
    at = no_sop.index(b"\xff\x91", no_sop.index(b"\xff\x93"))
    no_sop[at + 1] = 0x90
    base = _pil_save(_photo(23, 29, 3), "JPEG2000", no_jp2=True,
                     tile_size=(16, 16), num_resolutions=3)
    tlm = W.j2k_insert(base, (0xFF55, bytes([0, 0x50, 1, 2, 3])))
    poc = bytearray(base)
    sot = [i for i in range(len(poc) - 1) if poc[i:i + 2] == b"\xff\x90"][2]
    seg = struct.pack(">HH", 0xFF5F, 9) + bytes([3, 1, 0, 1, 3, 1, 0])
    psot = struct.unpack_from(">I", poc, sot + 6)[0]
    poc[sot + 6:sot + 10] = struct.pack(">I", psot + len(seg))
    poc = bytes(poc[:sot + 12]) + seg + bytes(poc[sot + 12:])
    _hold(folder, "no_eph.j2k", bytes(no_eph), pil_reads=False)
    _hold(folder, "no_sop.j2k", bytes(no_sop), pil_reads=False)
    _hold(folder, "tlm.j2k", tlm, pil_reads=True)
    _hold(folder, "empty_tile.j2k", poc, pil_reads=True)


def _fuzz(argv) -> int:
    """``--fuzz A-B [kind ...]``: the mutation counts over seeds A..B (the
    kinds j2k, jp2, icns; markers, tileparts and boxes for the structure
    edits)."""
    i = argv.index("--fuzz")
    lo, hi = (int(v) for v in argv[i + 1].split("-"))
    for kind in argv[i + 2:] or ["j2k", "jp2", "icns", *_EDITS]:
        fn = edit_counts if kind in _EDITS else mutation_counts
        total = {}
        for seed in range(lo, hi + 1):
            for k, v in fn(kind, seed).items():
                total[k] = total.get(k, 0) + v
        print(f"{kind}: seeds {lo}-{hi}, {sum(total.values())} files: "
              f"{total}", flush=True)
    return 0


# --- the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_jpeg2000_fixtures_on_cuda():
    """Phase 26a where the card is: every JPEG 2000 and ICNS fixture
    decodes bitwise its PNG twin and the manifest's sha256 on the card's
    machine (no PIL there), and a JP2 map reaches the card as a
    texture."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase runs where the card is")
    manifest = _manifest()
    for name in _names():
        e = manifest[name]
        with open(os.path.join(FIXTURES, e["file"]), "rb") as f:
            got = io.decode_image(f.read(), name)
        with open(os.path.join(FIXTURES, e["png"]), "rb") as f:
            assert got.tobytes() == io.decode_png(f.read(), name).tobytes()
        assert hashlib.sha256(got.tobytes()).hexdigest() == \
            e["pixels_sha256"], name
    img = io.load_image(os.path.join(FIXTURES, TOWN_JPEG2000["checker"]))
    t = torch.from_numpy(img).to("cuda")
    assert t.shape == (128, 128, 3) and float(t.max()) > 0


if __name__ == "__main__":
    sys.exit(_fuzz(sys.argv))
