"""The rest of JPEG as PIL reads it (ROADMAP.md C6, fourth part), held
bitwise to PIL's ``Image.open(...).convert("RGB")`` on the CPU: arithmetic
coding (SOF9, SOF10 and their DAC conditioning), lossless SOF3 (predictors
1-7, the point transform, restarts, sampling, libjpeg's colour rules for
it), libjpeg's standard Huffman tables, block smoothing of progressive
files cut after any scan (Huffman and arithmetic), libjpeg's recovery from
a scan cut by a marker and from missing or out-of-order RST markers, the
64 KiB buffers PIL hands libjpeg, and the JPEGs PIL refuses (12- and
16-bit precision, hierarchical processes, PIL's open-time checks), which
raise ValueError and which both atlas builders skip.

The files come from the encoders of tools/torch_image_fixtures.py (T.81's
arithmetic coder and lossless predictors, written independently of the
port's decoder) and from PIL's own encoder. PIL and the JAX package are
imported inside the tests that use them: the card's test at the end runs
on the machine with the card, which has neither.

    python -m pytest tests/test_torch_jpeg_rest.py -m cuda --noconftest -q
"""

import importlib.util
import io as _bio
import os
import shutil
import struct

import numpy as np
import pytest

from gpupathtracer_tpu_torch.scene import textures
from gpupathtracer_tpu_torch.utils import io
from gpupathtracer_tpu_torch.utils.jpeg import decode_jpeg

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "golden", "images")

# The fixtures of tools/torch_image_fixtures.py jpeg_rest_fixtures.
NEW_FIXTURES = (
    "checker_arith", "roof_arith", "bricks_lossless", "foliage_lossless",
    "arith_grey", "arith_420", "arith_444_dac", "arith_prog",
    "arith_prog_cut", *(f"lossless_p{p}" for p in range(1, 8)), "nodht",
    "prog_cut1", "prog_cut3", "prog_cut7", "scan_cut", "rst_dropped")
# Phase 23b's town: each map's file, decoding to the map's PNG twin.
TOWN_REST = {"checker": "checker_arith.jpg", "roof": "roof_arith.jpg",
             "bricks": "bricks_lossless.jpg",
             "foliage": "foliage_lossless.jpg"}


def _tool():
    spec = importlib.util.spec_from_file_location(
        "torch_image_fixtures", os.path.join(REPO, "tools",
                                             "torch_image_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    return tool


def _pil(data: bytes):
    """PIL's convert("RGB") of the bytes, or None where PIL fails."""
    from PIL import Image
    try:
        return np.asarray(Image.open(_bio.BytesIO(data)).convert("RGB"))
    except Exception:
        return None


def _held(data: bytes, tag: str = ""):
    """decode_jpeg bitwise PIL where PIL reads the bytes, ValueError where
    it does not; returns PIL's image or None."""
    want = _pil(data)
    if want is None:
        with pytest.raises(ValueError):
            decode_jpeg(data, tag)
        return None
    got = decode_jpeg(data, tag)
    assert got.shape == want.shape, tag
    assert got.tobytes() == want.tobytes(), tag
    return want


def _pil_jpeg(pixels, **kw) -> bytes:
    from PIL import Image
    buf = _bio.BytesIO()
    Image.fromarray(pixels).save(buf, "JPEG", **kw)
    return buf.getvalue()


def _photo(h, w, seed):
    """Smooth colour with grain: what a texture map looks like."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


@pytest.fixture(scope="module")
def tool():
    return _tool()


@pytest.fixture(scope="module")
def files(tool):
    """The module's shared encodes: PIL Huffman files (sequential with
    restarts, progressive 4:2:0, 4:4:4 and grey) and their arithmetic and
    lossless counterparts."""
    px = _photo(40, 56, 3)
    out = {
        "huff_seq": _pil_jpeg(px, quality=80, subsampling=2,
                              restart_marker_blocks=1),
        "huff_prog_420": _pil_jpeg(px, quality=75, subsampling=2,
                                   progressive=True),
        "huff_prog_444": _pil_jpeg(px, quality=90, subsampling=0,
                                   progressive=True,
                                   restart_marker_blocks=3),
        "huff_prog_grey": _pil_jpeg(px[..., 1], quality=70,
                                    progressive=True),
    }
    seq = tool.read_huffman_jpeg(out["huff_seq"])
    grey = tool.read_huffman_jpeg(_pil_jpeg(px[..., 1], quality=70))
    out["arith_seq"] = tool.write_arith_jpeg(seq, restart=1)
    out["arith_prog_420"] = tool.write_arith_jpeg(seq, tool.PROGRESSION_3)
    out["arith_prog_grey"] = tool.write_arith_jpeg(grey, tool.PROGRESSION_1,
                                                   restart=4)
    out["lossless"] = tool.write_lossless_jpeg(
        [px[..., c] for c in range(3)], 6, 1, restart_rows=2)
    out["px"] = px
    return out


# --- the committed fixtures --------------------------------------------------

@pytest.mark.parametrize("name", NEW_FIXTURES)
def test_new_fixtures_decode_as_pil(tmp_path, name):
    """Each new fixture, through decode_jpeg and load_image, bitwise PIL's
    decode and the JAX package's load_image."""
    from gpupathtracer_tpu.utils import io as jax_io

    with open(os.path.join(FIXTURES, f"{name}.jpg"), "rb") as f:
        data = f.read()
    assert _held(data, name) is not None
    path = str(tmp_path / f"{name}.jpg")
    shutil.copy(os.path.join(FIXTURES, f"{name}.jpg"), path)
    assert io.load_image(path).tobytes() == jax_io.load_image(path).tobytes()


def test_town_maps_decode_to_their_twins():
    """Phase 23b's maps: the arithmetic transcodes of phase 20's checker
    and roof JPEGs and the lossless encodings of the bricks and foliage
    twins decode to phase 20's PNG twins."""
    for name, fname in TOWN_REST.items():
        with open(os.path.join(FIXTURES, fname), "rb") as f:
            got = io.decode_image(f.read(), fname)
        with open(os.path.join(FIXTURES, f"{name}.png"), "rb") as f:
            twin = io.decode_png(f.read(), name)
        assert got.tobytes() == twin.tobytes(), fname


# --- block smoothing: progressive files cut after any scan -----------------

@pytest.mark.parametrize("kind", ["huff_prog_420", "huff_prog_444",
                                  "huff_prog_grey", "arith_prog_420",
                                  "arith_prog_grey"])
def test_progressive_cut_sweep(files, kind):
    """A progressive file cut (EOI appended) after each of its scans and
    half way through each: libjpeg's block smoothing (5x5 DC
    neighbourhoods, DC-only estimates, the rows the last scan did not
    reach) bitwise PIL's."""
    data = files[kind]
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    assert len(sos) >= 6
    for k in range(1, len(sos)):
        _held(data[:sos[k]] + b"\xff\xd9", f"{kind} after scan {k}")
        mid = (sos[k - 1] + sos[k]) // 2
        _held(data[:mid] + b"\xff\xd9", f"{kind} inside scan {k}")
    _held(data, kind)


# --- lossless ------------------------------------------------------------------

@pytest.mark.parametrize("components", [1, 3])
@pytest.mark.parametrize("pt", [0, 2])
@pytest.mark.parametrize("predictor", [1, 2, 3, 4, 5, 6, 7])
def test_lossless_predictors(tool, files, predictor, pt, components):
    """SOF3 at each predictor and point transform, grey and three
    components (no marker, ids 1-3: RGB, libjpeg-turbo's guess for a
    lossless file): bitwise PIL's, and at Pt 0 the samples themselves."""
    px = files["px"]
    planes = [px[..., c] for c in range(components)]
    data = tool.write_lossless_jpeg(planes, predictor, pt)
    got = _held(data, f"p{predictor} pt{pt}")
    if pt == 0:
        want = np.stack(planes * 3 if components == 1 else planes, -1)
        assert got.tobytes() == want.tobytes()


LOSSLESS_CASES = ("jfif", "adobe-rgb", "adobe-ycc", "ids-rgb", "ids-other",
                  "h2v2", "h2v1", "h1v2", "chroma-2x2", "restarts-1",
                  "restarts-5", "restart-not-rows", "no-dht", "sof11")


@pytest.mark.parametrize("case", LOSSLESS_CASES)
def test_lossless_colour_sampling_and_restarts(tool, files, case):
    """Lossless files as libjpeg-turbo reads them: a JFIF or Adobe
    transform 1 marker names YCbCr, which it does not convert losslessly
    (PIL fails); Adobe transform 0 and any component ids are RGB; sampled
    components are upsampled by replication (no fancy upsampling);
    restarts every n MCU rows, but not inside one (refused); no DHT (no
    standard tables for lossless: refused); SOF11 (arithmetic lossless:
    refused)."""
    px = files["px"]
    rgb = [px[..., c] for c in range(3)]
    seg = tool.jpeg_segment
    kw, planes = {}, rgb
    if case == "jfif":
        kw["app"] = seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif case.startswith("adobe"):
        kw["app"] = seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00"
                        + bytes([case == "adobe-ycc"]))
    elif case == "ids-rgb":
        kw["ids"] = [82, 71, 66]
    elif case == "ids-other":
        kw["ids"] = [7, 8, 9]
    elif case in ("h2v2", "h2v1", "h1v2"):
        h, v = int(case[1]), int(case[3])
        kw["sampling"] = [(h, v), (1, 1), (1, 1)]
        planes = [px[..., 0], px[::v, ::h, 1], px[::v, ::h, 2]]
    elif case == "chroma-2x2":
        kw["sampling"] = [(1, 1), (2, 2), (1, 1)]
        planes = [px[::2, ::2, 0], px[..., 1], px[::2, ::2, 2]]
    elif case.startswith("restarts"):
        kw["restart_rows"] = int(case.split("-")[1])
    data = tool.write_lossless_jpeg(planes, 4, 1, **kw)
    if case == "restart-not-rows":
        data = tool.write_lossless_jpeg(rgb, 4, 1, restart_rows=2)
        i = data.find(b"\xff\xdd")
        data = data[:i + 4] + struct.pack(">H", 56 * 2 + 1) + data[i + 6:]
    elif case == "no-dht":
        i = data.find(b"\xff\xc4")
        while i >= 0:
            n = struct.unpack(">H", data[i + 2:i + 4])[0]
            data = data[:i] + data[i + 2 + n:]
            i = data.find(b"\xff\xc4")
    elif case == "sof11":
        data = data.replace(b"\xff\xc3", b"\xff\xcb", 1)
    got = _held(data, case)
    refused = ("jfif", "adobe-ycc", "restart-not-rows", "no-dht", "sof11")
    assert (got is None) == (case in refused), case


# --- standard tables, cut scans and restarts --------------------------------

def _without_dht(data: bytes) -> bytes:
    """The file with every DHT before its first SOS taken out."""
    out, pos = bytearray(data[:2]), 2
    while data[pos + 1] != 0xDA:
        n = struct.unpack(">H", data[pos + 2:pos + 4])[0]
        if data[pos + 1] != 0xC4:
            out += data[pos:pos + 2 + n]
        pos += 2 + n
    return bytes(out + data[pos:])


@pytest.mark.parametrize("sub", [0, 1, 2])
def test_standard_huffman_tables(files, sub):
    """A sequential file with no DHT decodes with T.81 K.3's tables, which
    libjpeg installs in slots 0 and 1 (PIL writes those tables, so the
    image is the file's own); a progressive file without its first DHTs is
    refused, as libjpeg's progressive decoder installs none."""
    px = files["px"]
    full = _pil_jpeg(px, quality=85, subsampling=sub)
    got = _held(_without_dht(full), "no DHT")
    assert got.tobytes() == _pil(full).tobytes()
    prog = _pil_jpeg(px, quality=85, subsampling=sub, progressive=True)
    assert _held(_without_dht(prog), "progressive, no DHT") is None
    # Table 2 of a scan is never standard: refused.
    three = bytearray(_without_dht(full))
    sos = three.find(b"\xff\xda")
    three[sos + 6] = 0x22
    assert _held(bytes(three), "table 2") is None


@pytest.mark.parametrize("kind", ["huff_seq", "huff_prog_444", "arith_seq",
                                  "lossless"])
def test_scan_cut_by_a_marker(files, kind):
    """A scan cut short by EOI (the file kept whole after it) or by another
    marker: the MCU in hand finished on zero bits, the rest of the
    interval left as libjpeg leaves it, decoding resumed at the next
    restart: bitwise PIL's at 40 cut points."""
    data = files[kind]
    first = data.find(b"\xff\xda")
    for k, cut in enumerate(np.linspace(first + 20, len(data) - 3,
                                        40).astype(int)):
        _held(data[:cut] + b"\xff\xd9", f"{kind} cut at {cut}")
        if k % 4 == 0:
            _held(data[:cut] + b"\xff\xfe\x00\x04ab" + data[cut:],
                  f"{kind} COM at {cut}")


RESYNC = ("drop", "drop-two", "prior-1", "prior-2", "ahead-3", "ahead-5",
          "invalid", "non-restart", "doubled")


@pytest.mark.parametrize("kind", ["huff_seq", "huff_prog_444", "arith_seq",
                                  "arith_prog_grey", "lossless"])
@pytest.mark.parametrize("case", RESYNC)
def test_restart_resync(files, case, kind):
    """jpeg_resync_to_restart's four actions, by the found marker's
    distance from the expected one: the next two RSTs (a dropped marker:
    an empty segment), the two before (scan on), any other (discard it and
    go on), an invalid marker (scan on), a marker that is no RST (an empty
    segment); at a marker early, in the middle and late in the scan."""
    data = files[kind]
    marks = [i for i in range(len(data) - 1)
             if data[i] == 0xFF and 0xD0 <= data[i + 1] <= 0xD7]
    assert len(marks) >= 6
    for j in (1, len(marks) // 2, len(marks) - 2):
        i, n = marks[j], data[marks[j] + 1] - 0xD0
        if case == "drop":
            x = data[:i] + data[i + 2:]
        elif case == "drop-two":
            x = data[:i] + data[i + 2:marks[j + 1]] + data[marks[j + 1] + 2:]
        elif case == "doubled":
            x = data[:i + 2] + data[i:]
        else:
            code = {"prior-1": 0xD0 + (n - 1) % 8,
                    "prior-2": 0xD0 + (n - 2) % 8,
                    "ahead-3": 0xD0 + (n + 3) % 8,
                    "ahead-5": 0xD0 + (n + 5) % 8, "invalid": 0x02,
                    "non-restart": 0xC8}[case]
            x = data[:i + 1] + bytes([code]) + data[i + 2:]
        _held(x, f"{kind} {case} at marker {j}")


# --- PIL's buffers, what PIL refuses, and the atlas ----------------------------

def test_arithmetic_data_past_pils_buffer(tool, files):
    """libjpeg's arithmetic decoder cannot suspend: where its data runs
    past the first 64 KiB buffer PIL hands libjpeg, PIL fails; where the
    whole scan lies in one buffer, PIL reads it. The same bytes decide
    both here."""
    small = files["arith_seq"]
    reads = set()
    for size in range(65536 - len(small) - 120, 65536 + 60, 37):
        pad = tool.jpeg_segment(0xE1, b"\0" * 30000) + tool.jpeg_segment(
            0xE1, b"\0" * (size - 30008))
        reads.add(_held(small[:2] + pad + small[2:], f"padded {size}")
                  is not None)
    assert reads == {True, False}


PIL_REFUSES = {
    "12-bit": lambda d: _set_sof(d, precision=12),
    "16-bit": lambda d: _set_sof(d, precision=16),
    "two layers": lambda d: _set_sof(d, layers=2),
    "SOF5": lambda d: _set_sof(d, marker=0xC5),
    "SOF6": lambda d: _set_sof(d, marker=0xC6),
    "SOF7": lambda d: _set_sof(d, marker=0xC7),
    "SOF13": lambda d: _set_sof(d, marker=0xCD),
    "SOF14": lambda d: _set_sof(d, marker=0xCE),
    "SOF15": lambda d: _set_sof(d, marker=0xCF),
    "TEM before SOS": lambda d: d[:2] + b"\xff\x01" + d[2:],
    "RES marker": lambda d: d[:2] + b"\xff\x02" + d[2:],
    "short DQT": lambda d: d.replace(b"\xff\xdb\x00\x43", b"\xff\xdb\x00\x42",
                                     1),
    "no SOS": lambda d: d[:d.find(b"\xff\xda")],
}


def _set_sof(data: bytes, precision=None, layers=None, marker=None):
    d = bytearray(data)
    i = d.find(b"\xff\xc0")
    if precision is not None:
        d[i + 4] = precision
    if layers is not None:
        d[i + 9] = layers
    if marker is not None:
        d[i + 1] = marker
    return bytes(d)


@pytest.mark.parametrize("case", sorted(PIL_REFUSES))
def test_what_pil_refuses_raises_value_error(tmp_path, files, case):
    """12- and 16-bit precision and layer counts other than 1, 3 and 4
    (PIL's SOF handler), hierarchical processes (libjpeg), and PIL's
    open-time walk of the markers (a marker it does not know, a short
    DQT, no SOS): PIL fails, and decode_image and load_image raise
    ValueError naming the file."""
    data = PIL_REFUSES[case](_pil_jpeg(files["px"], quality=80))
    assert _pil(data) is None
    path = tmp_path / "refused.jpg"
    path.write_bytes(data)
    with pytest.raises(ValueError, match="refused.jpg"):
        io.load_image(str(path))


def test_atlas_skips_what_pil_refuses(tmp_path, files):
    """A town-like folder holding a 12-bit and a SOF5 map beside maps PIL
    reads (an arithmetic-coded one among them): the port's build_atlas
    gives the JAX build_atlas's atlas bytes and slots (both skip the two
    refused maps)."""
    from gpupathtracer_tpu.scene import textures as jax_textures

    base = _pil_jpeg(files["px"], quality=80)
    maps = {"good.jpg": base, "deep.jpg": PIL_REFUSES["12-bit"](base),
            "hier.jpg": PIL_REFUSES["SOF5"](base),
            "arith.jpg": files["arith_seq"]}
    for name, data in maps.items():
        (tmp_path / name).write_bytes(data)
    names = ["good.jpg", "deep.jpg", "hier.jpg", "arith.jpg"]
    for levels in (1, 4):
        got = textures.build_atlas(names, str(tmp_path), mip_levels=levels)
        want = jax_textures.build_atlas(names, str(tmp_path),
                                        mip_levels=levels)
        assert got[2] == want[2] == {"good.jpg": 0, "arith.jpg": 1}
        for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
            assert g.dtype == w.dtype and g.shape == w.shape
            assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("marker", [0xC9, 0xCA, 0xCB, 0xC3])
def test_relabelled_frames(files, marker):
    """Huffman data under an arithmetic or lossless frame header: SOF9
    decodes (to garbage) as PIL does; SOF10 (a band of 0-63 is no
    progressive scan), SOF11 and SOF3 are refused."""
    data = _pil_jpeg(files["px"], quality=80)
    got = _held(data.replace(b"\xff\xc0", bytes([0xFF, marker]), 1))
    assert (got is None) == (marker != 0xC9)


# --- the card ------------------------------------------------------------------

@pytest.mark.cuda
def test_town_on_the_rest_of_jpeg_on_cuda(tmp_path):
    """Phase 23b in small: the generated town on the arithmetic and
    lossless JPEG maps renders on the card bitwise as on their PNG twins
    (B1 walks the rays)."""
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
    for kind in ("png", "rest"):
        folder = tmp_path / kind
        folder.mkdir()
        shutil.copy(town, folder)
        mtl = (tmp_path / "town" / "town.mtl").read_text()
        for name, fname in TOWN_REST.items():
            src = fname if kind == "rest" else f"{name}.png"
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
