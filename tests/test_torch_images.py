"""The port's image decoders against the JAX package on the CPU. Images are
made from a seed with numpy and written by PIL (or, where PIL writes no
such file, by the small encoders here); the port's load_image must be
bitwise the JAX package's (PIL's ``convert("RGB")`` / 255) on every JPEG,
PNG, TGA and BMP case; load_scene's atlas tables with JPEG maps (one of
them corrupt, which both packages skip), a JPEG equirect sky and JPEG cube
faces bitwise JAX's; the committed fixtures of tests/golden/images decode
to their PNGs in PIL and in the port; and what stays unread raises
NotImplementedError naming the file (ROADMAP.md C6)."""

import hashlib
import io as _bio
import json
import os
import struct

import numpy as np
import pytest
from PIL import Image

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.scene import envmap as jax_envmap
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu.scene import textures as jax_textures
from gpupathtracer_tpu.utils import io as jax_io
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.scene import envmap, load_scene, textures
from gpupathtracer_tpu_torch.utils import io
from gpupathtracer_tpu_torch.utils.jpeg import decode_jpeg
from test_torch_textures import encode_png

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "golden", "images")


def _same(path):
    """load_image bitwise the JAX package's; returns the port's image."""
    got = io.load_image(str(path))
    want = jax_io.load_image(str(path))
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes(), os.path.basename(str(path))
    return got


def _photo(h, w, seed):
    """Smooth colour with grain: what a texture map looks like."""
    rng = np.random.RandomState(seed)
    y, x = np.mgrid[0:h, 0:w].astype(np.float32)
    base = np.stack([128 + 100 * np.sin(x / 7.0 + c) * np.cos(y / 5.0 - c)
                     for c in range(3)], -1)
    return np.clip(base + rng.randn(h, w, 3) * 20, 0, 255).astype(np.uint8)


def _pil_jpeg(path, pixels, **kw):
    Image.fromarray(pixels).save(str(path), "JPEG", **kw)
    return path


# --- JPEG: PIL's encoder ----------------------------------------------------

SUBSAMPLING = {"444": 0, "422": 1, "420": 2}


@pytest.mark.parametrize("optimize", [False, True])
@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("sub", sorted(SUBSAMPLING))
@pytest.mark.parametrize("quality", [25, 50, 75, 95, 100])
def test_jpeg_matches_pil(tmp_path, quality, sub, progressive, optimize):
    """Baseline and progressive (successive approximation of DC and AC,
    EOB runs: PIL's jpeg_simple_progression script), optimized Huffman
    tables, at five qualities and three subsamplings (fancy upsampling:
    h2v1, h2v2), on a 127x65 image."""
    path = _pil_jpeg(tmp_path / "a.jpg", _photo(65, 127, quality),
                     quality=quality, subsampling=SUBSAMPLING[sub],
                     progressive=progressive, optimize=optimize)
    _same(path)


@pytest.mark.parametrize("sub", sorted(SUBSAMPLING))
@pytest.mark.parametrize("size", [(1, 1), (7, 13), (17, 33), (127, 65)])
def test_jpeg_sizes(tmp_path, size, sub):
    """Sizes that are not multiples of the MCU (the edge columns and rows
    of the fancy upsamplers, two-sample rows that fall back to the box
    upsampler), progressive too."""
    h, w = size
    for progressive in (False, True):
        path = _pil_jpeg(tmp_path / f"{progressive}.jpg", _photo(h, w, h * w),
                         quality=80, subsampling=SUBSAMPLING[sub],
                         progressive=progressive)
        _same(path)


@pytest.mark.parametrize("progressive", [False, True])
@pytest.mark.parametrize("kind", ["blocks", "rows"])
def test_jpeg_restart_markers(tmp_path, kind, progressive):
    """DRI and RST0-7: restart_marker_blocks=3 and restart_marker_rows=1
    (the prediction and EOB run reset at each marker)."""
    kw = ({"restart_marker_blocks": 3} if kind == "blocks"
          else {"restart_marker_rows": 1})
    path = _pil_jpeg(tmp_path / "r.jpg", _photo(67, 93, 4), quality=60,
                     subsampling=2, progressive=progressive, **kw)
    _same(path)


@pytest.mark.parametrize("progressive", [False, True])
def test_jpeg_grey(tmp_path, progressive):
    """One component: PIL's mode L, replicated by convert("RGB")."""
    path = _pil_jpeg(tmp_path / "g.jpg", _photo(41, 57, 5)[..., 1],
                     quality=85, progressive=progressive)
    img = _same(path)
    assert (img[..., 0] == img[..., 1]).all() and (img[..., 1] ==
                                                   img[..., 2]).all()


@pytest.mark.parametrize("case", ["qtables", "qtables-16bit", "noise-444",
                                  "noise-420"])
def test_jpeg_tables_and_range_limit(tmp_path, case):
    """Custom quantization tables (8-bit entries, and entries above 255,
    which PIL writes as 16-bit DQT tables), and uniform noise at quality
    100, whose reconstruction overshoots 0..255 (the output clamp)."""
    if case.startswith("qtables"):
        top = 400 if case.endswith("16bit") else 60
        kw = dict(qtables=[[i % 37 + 1 for i in range(64)],
                           [(i * 7) % top + 2 for i in range(64)]])
        pixels = _photo(50, 70, 6)
    else:
        kw = dict(quality=100, subsampling=0 if case == "noise-444" else 2)
        pixels = np.random.RandomState(7).randint(0, 256, (50, 70, 3)).astype(
            np.uint8)
    _same(_pil_jpeg(tmp_path / "q.jpg", pixels, **kw))


def test_progressive_needs_no_block_smoothing(tmp_path):
    """libjpeg's block smoothing (jdcoefct.c) only runs where a progressive
    file leaves a low coefficient unrefined: for every complete file PIL
    writes, the decode is PIL's without it. A file cut after its DC scans
    is smoothed (from its DC values alone) as PIL smooths it, bitwise the
    JAX package's (since the fourth image slice)."""
    pixels = _photo(64, 96, 8)
    for sub in (0, 2):
        path = _pil_jpeg(tmp_path / f"p{sub}.jpg", pixels, quality=70,
                         subsampling=sub, progressive=True)
        _same(path)
    data = (tmp_path / "p2.jpg").read_bytes()
    # Keep the scans up to the second SOS (the interleaved DC scan), then
    # end the file.
    sos = [i for i in range(len(data) - 1) if data[i:i + 2] == b"\xff\xda"]
    cut = tmp_path / "dc_only.jpg"
    cut.write_bytes(data[:sos[1]] + b"\xff\xd9")
    _same(cut)


# --- JPEG: files PIL does not write -------------------------------------------
# A baseline encoder of quantized coefficient blocks (no forward DCT): any
# sampling factors, any coefficients, several scans, restart intervals.

ZIGZAG = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63])


def _seg(marker, body):
    return bytes([0xFF, marker]) + struct.pack(">H", len(body) + 2) + body


class _Bits:
    def __init__(self):
        self.out, self.acc, self.n = bytearray(), 0, 0

    def put(self, code, length):
        for i in range(length - 1, -1, -1):
            self.acc = (self.acc << 1) | ((code >> i) & 1)
            self.n += 1
            if self.n == 8:
                self.out.append(self.acc)
                if self.acc == 0xFF:
                    self.out.append(0)             # byte stuffing
                self.acc, self.n = 0, 0

    def flush(self):
        if self.n:
            self.put((1 << (8 - self.n)) - 1, 8 - self.n)


def _table(symbols):
    """A canonical Huffman table giving every symbol one length (never the
    all-ones code): its DHT body and symbol -> (code, length)."""
    syms = sorted(set(symbols))
    length = 1
    while (1 << length) <= len(syms):
        length += 1
    counts = [0] * 16
    counts[length - 1] = len(syms)
    return (bytes(counts) + bytes(syms),
            {s: (i, length) for i, s in enumerate(syms)})


def _block_symbols(zz, pred):
    diff = int(zz[0]) - pred
    s = abs(diff).bit_length()
    dc = (s, diff if diff >= 0 else diff + (1 << s) - 1, s)
    ac, run = [], 0
    last = max([k for k in range(1, 64) if zz[k] != 0], default=0)
    for k in range(1, last + 1):
        v = int(zz[k])
        if v == 0:
            run += 1
            continue
        while run > 15:
            ac.append((0xF0, 0, 0))
            run -= 16
        s = abs(v).bit_length()
        ac.append(((run << 4) | s, v if v >= 0 else v + (1 << s) - 1, s))
        run = 0
    if last < 63:
        ac.append((0x00, 0, 0))
    return dc, ac


def encode_baseline_jpeg(comps, blocks, qtables, width, height, restart=0,
                         scans=None, marker="jfif"):
    """A baseline (SOF0) JPEG. comps: [(id, h, v, tq)]; blocks[c]: int
    [rows, cols, 64] in natural order (MCU-padded); qtables: {tq: 64
    values, natural order}; scans: lists of component indices (default one
    interleaved scan); marker: "jfif", "adobe-rgb" (APP14, transform 0) or
    None."""
    maxh = max(c[1] for c in comps)
    maxv = max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * maxh)), -(-height // (8 * maxv))
    out = b"\xff\xd8"
    if marker == "jfif":
        out += _seg(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01\x00\x00")
    elif marker == "adobe-rgb":
        out += _seg(0xEE, b"Adobe\x00\x64\x00\x00\x00\x00\x00")
    for t, q in qtables.items():
        q = np.asarray(q).reshape(64)[ZIGZAG]
        if q.max() > 255:
            out += _seg(0xDB, bytes([0x10 | t]) + b"".join(
                struct.pack(">H", int(v)) for v in q))
        else:
            out += _seg(0xDB, bytes([t]) + bytes(int(v) for v in q))
    out += _seg(0xC0, struct.pack(">BHHB", 8, height, width, len(comps))
                + b"".join(bytes([i, (h << 4) | v, tq])
                           for i, h, v, tq in comps))
    if restart:
        out += _seg(0xDD, struct.pack(">H", restart))
    for scan in scans or [list(range(len(comps)))]:
        if len(scan) == 1:      # non-interleaved: the component's own blocks
            c = scan[0]
            dw = -(-width * comps[c][1] // maxh)
            dh = -(-height * comps[c][2] // maxv)
            units = [[(c, by, bx)] for by in range(-(-dh // 8))
                     for bx in range(-(-dw // 8))]
        else:
            units = [[(c, my * comps[c][2] + y, mx * comps[c][1] + x)
                      for c in scan for y in range(comps[c][2])
                      for x in range(comps[c][1])]
                     for my in range(mcuy) for mx in range(mcux)]
        coded, pred = [], {}
        for i, mcu in enumerate(units):
            if i == 0 or (restart and i % restart == 0):
                pred = {c: 0 for c in scan}
            row = []
            for c, by, bx in mcu:
                zz = np.asarray(blocks[c][by, bx]).reshape(64)[ZIGZAG]
                row.append((c,) + _block_symbols(zz, pred[c]))
                pred[c] = int(zz[0])
            coded.append(row)
        tabs = {}
        for k, c in enumerate(scan):
            dcs = [dc[0] for row in coded for cc, dc, _ in row if cc == c]
            acs = [a[0] for row in coded for cc, _, ac in row if cc == c
                   for a in ac] or [0]
            tabs[c] = (_table(dcs), _table(acs))
            out += _seg(0xC4, bytes([k]) + tabs[c][0][0])
            out += _seg(0xC4, bytes([0x10 | k]) + tabs[c][1][0])
        out += _seg(0xDA, bytes([len(scan)]) + b"".join(
            bytes([comps[c][0], (k << 4) | k]) for k, c in enumerate(scan))
            + b"\x00\x3f\x00")
        w = _Bits()
        for i, row in enumerate(coded):
            if restart and i and i % restart == 0:
                w.flush()
                out += bytes(w.out) + bytes([0xFF, 0xD0 + (i // restart - 1)
                                             % 8])
                w = _Bits()
            for c, dc, ac in row:
                (_, dcodes), (_, acodes) = tabs[c]
                w.put(*dcodes[dc[0]])
                w.put(dc[1], dc[2])
                for sym, bits, s in ac:
                    w.put(*acodes[sym])
                    w.put(bits, s)
        w.flush()
        out += bytes(w.out)
    return out + b"\xff\xd9"


def random_blocks(comps, width, height, rng, extreme=False):
    """Quantized blocks for every MCU-padded block: decaying AC terms
    around a mid-grey DC, or (extreme) uniform in -1023..1023."""
    maxh = max(c[1] for c in comps)
    maxv = max(c[2] for c in comps)
    mcux, mcuy = -(-width // (8 * maxh)), -(-height // (8 * maxv))
    u, v = np.meshgrid(np.arange(8), np.arange(8))
    env = (60.0 / (1.0 + u + v) ** 1.5).reshape(64)
    out = []
    for _, h, vv, _ in comps:
        shape = (mcuy * vv, mcux * h, 64)
        if extreme:
            b = rng.randint(-1023, 1024, shape)
        else:
            b = np.round(rng.randn(*shape) * env).astype(np.int64)
            b[..., 0] = rng.randint(-60, 61, shape[:2])
            b[..., 20:] *= rng.rand(*shape[:2], 1) < 0.3
        out.append(b.astype(np.int64))
    return out


# (Y, Cb, Cr) sampling factors (h, v): every upsampler libjpeg picks
# (fullsize, h2v1, h1v2, h2v2 and int_upsample at 3:1 and 4:1 both ways),
# chroma sampled above luma, and chroma with factors of its own.
SAMPLINGS = {
    "4:4:0 (1x2)": ((1, 2), (1, 1), (1, 1)),
    "4:1:1 (4x1)": ((4, 1), (1, 1), (1, 1)),
    "1x4": ((1, 4), (1, 1), (1, 1)),
    "4x2": ((4, 2), (1, 1), (1, 1)),
    "2x4": ((2, 4), (1, 1), (1, 1)),
    "3x1": ((3, 1), (1, 1), (1, 1)),
    "3x2": ((3, 2), (1, 1), (1, 1)),
    "2x3": ((2, 3), (1, 1), (1, 1)),
    "Cb 1x2 Cr 2x1": ((2, 2), (1, 2), (2, 1)),
    "Cb 2x1": ((2, 2), (2, 1), (1, 1)),
    "Cb 2x2 over Y 1x1": ((1, 1), (2, 2), (1, 1)),
}


@pytest.mark.parametrize("name", list(SAMPLINGS))
def test_jpeg_sampling_factors(tmp_path, name):
    """Sampling factors PIL does not write (its "4:1:1" is 4:2:0), at sizes
    with partial MCUs and two-sample chroma rows, held to PIL's decode."""
    rng = np.random.RandomState(sorted(SAMPLINGS).index(name))
    comps = [(i + 1, h, v, min(i, 1))
             for i, (h, v) in enumerate(SAMPLINGS[name])]
    for k, (w, h) in enumerate([(3, 5), (17, 9), (71, 50)]):
        blocks = random_blocks(comps, w, h, rng)
        q = {0: rng.randint(1, 40, 64), 1: rng.randint(1, 60, 64)}
        path = tmp_path / f"{k}.jpg"
        path.write_bytes(encode_baseline_jpeg(comps, blocks, q, w, h))
        _same(path)


@pytest.mark.parametrize("case", ["extreme-444", "extreme-420",
                                  "dequant-wraps", "adobe-rgb", "rgb-ids",
                                  "unknown-ids", "scans-and-restarts",
                                  "grey-2x2"])
def test_jpeg_decoder_edges(tmp_path, case):
    """Coefficients far past any encoder's (the SIMD IDCT PIL runs: 16-bit
    lanes, saturation, the clamp before +128), 16-bit quantization entries
    whose products wrap at 16 bits, three components read as RGB (an Adobe
    marker with transform 0, or component ids 'R', 'G', 'B' without JFIF)
    and as YCbCr (other ids), one scan per component with restart
    intervals, and one component with 2x2 sampling."""
    rng = np.random.RandomState(len(case))
    w, h = 37, 29
    comps = [(1, 2, 2, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    if case == "extreme-444":
        comps = [(1, 1, 1, 0), (2, 1, 1, 1), (3, 1, 1, 1)]
    if case == "grey-2x2":
        comps = [(1, 2, 2, 0)]
    if case == "rgb-ids":
        comps = [(82, 1, 1, 0), (71, 1, 1, 0), (66, 1, 1, 0)]
    if case == "unknown-ids":
        comps = [(7, 2, 1, 0), (8, 1, 1, 1), (9, 1, 1, 1)]
    blocks = random_blocks(comps, w, h, rng,
                           extreme=case.startswith("extreme"))
    q = {0: rng.randint(1, 40, 64), 1: rng.randint(1, 60, 64)}
    if case.startswith("extreme"):
        q = {0: rng.randint(1, 256, 64), 1: rng.randint(100, 256, 64)}
    if case == "dequant-wraps":
        q = {0: rng.randint(200, 3000, 64), 1: rng.randint(1000, 40000, 64)}
    kw = {}
    if case == "adobe-rgb":
        kw["marker"] = "adobe-rgb"
    if case in ("rgb-ids", "unknown-ids"):
        kw["marker"] = None
    if case == "scans-and-restarts":
        kw.update(scans=[[0], [2], [1]], restart=3)
    path = tmp_path / "e.jpg"
    path.write_bytes(encode_baseline_jpeg(comps, blocks, q, w, h, **kw))
    _same(path)


def test_jpeg_corrupt_data_raises_value_error(tmp_path):
    """Truncated scan data, a missing EOI and a header with nothing behind
    it raise ValueError naming the file (PIL raises too, so the JAX atlas
    builder skips such a map, and so does the port's); the atlas builders
    agree."""
    data = _pil_jpeg(tmp_path / "ok.jpg", _photo(40, 48, 9),
                     quality=80).read_bytes()
    cases = {"cut.jpg": data[:len(data) // 2], "no_eoi.jpg": data[:-2],
             "header.jpg": b"\xff\xd8\xff\xe0" + b"\0" * 64}
    for name, body in cases.items():
        (tmp_path / name).write_bytes(body)
        with pytest.raises(ValueError, match=name):
            io.load_image(str(tmp_path / name))
        with pytest.raises(Exception):
            jax_io.load_image(str(tmp_path / name))
    paths = ["ok.jpg", *cases]
    got = textures.build_atlas(paths, str(tmp_path))
    want = jax_textures.build_atlas(paths, str(tmp_path))
    assert got[2] == want[2] == {"ok.jpg": 0}
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.tobytes() == w.tobytes()


@pytest.mark.parametrize("seed", [1, 2, 3])
def test_jpeg_mutations_never_decode_otherwise(seed):
    """Bytes set, deleted or cut off (an EOI appended) in PIL-written files:
    the port raises only ValueError, and only where PIL fails too (libjpeg
    decodes corrupt data with warnings: since the fourth image slice the
    port recovers as it does); wherever both decode a file, the images are
    bitwise equal."""
    rng = np.random.RandomState(seed)
    both = 0
    for _ in range(60):
        h, w = rng.randint(1, 40, 2)
        buf = _bio.BytesIO()
        Image.fromarray(rng.randint(0, 256, (h, w, 3)).astype(
            np.uint8)).save(buf, "JPEG", quality=int(rng.randint(10, 100)),
                            subsampling=int(rng.randint(0, 3)),
                            progressive=bool(rng.rand() < 0.5),
                            restart_marker_blocks=int(rng.randint(0, 4)))
        data = bytearray(buf.getvalue())
        for _ in range(rng.randint(1, 4)):
            k, r = rng.randint(0, len(data)), rng.rand()
            if r < 0.6:
                data[k] = rng.randint(0, 256)
            elif r < 0.8:
                del data[k]
            else:
                data = data[:k] + b"\xff\xd9"
        try:
            want = np.asarray(Image.open(_bio.BytesIO(bytes(data))).convert(
                "RGB"))
        except Exception:
            want = None
        try:
            got = decode_jpeg(bytes(data))
        except ValueError:
            got = None
        assert got is not None or want is None, "PIL reads a mutant the " \
            "port refuses"
        if want is not None and got is not None:
            both += 1
            assert got.tobytes() == want.tobytes()
    assert both > 5


# --- PNG ------------------------------------------------------------------------

@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("ctype", [0, 2, 4, 6])
def test_png_16_bit(tmp_path, ctype, interlace):
    """16-bit grey (PIL's I;16: convert("RGB") clips at 255), grey + alpha,
    RGB and RGBA (the high byte of each sample)."""
    ch = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    rng = np.random.RandomState(ctype + 10 * interlace)
    px = rng.randint(0, 65536, (19, 23, ch)).astype(np.uint16)
    px[:5] = rng.randint(0, 600, (5, 23, ch))          # around the clip
    path = tmp_path / "d.png"
    path.write_bytes(encode_png(px, ctype, [0, 1, 2, 3, 4], depth=16,
                                interlace=interlace))
    _same(path)


@pytest.mark.parametrize("interlace", [0, 1])
@pytest.mark.parametrize("depth", [1, 2, 4])
@pytest.mark.parametrize("ctype", [0, 3])
def test_png_low_depth(tmp_path, ctype, depth, interlace):
    """1-, 2- and 4-bit grey (scaled to 0..255) and palette images (an
    index past a short palette reads black), at a width whose rows end in
    a partial byte."""
    rng = np.random.RandomState(depth + 10 * ctype + 100 * interlace)
    px = rng.randint(0, 1 << depth, (13, 21, 1)).astype(np.uint8)
    pal = None
    if ctype == 3:
        n = max(1, (1 << depth) - 1)                   # one index short
        pal = rng.randint(0, 256, (n, 3)).astype(np.uint8)
    path = tmp_path / "l.png"
    path.write_bytes(encode_png(px, ctype, [0, 1, 2, 3, 4], depth=depth,
                                interlace=interlace, palette=pal))
    _same(path)


@pytest.mark.parametrize("size", [(1, 1), (2, 3), (5, 9), (9, 17), (33, 8)])
@pytest.mark.parametrize("ctype", [0, 2, 3, 6])
def test_png_adam7(tmp_path, ctype, size):
    """Real Adam7 passes (empty passes left out) at 8 bits, every filter,
    against PIL; and the same pixels non-interlaced decode alike."""
    h, w = size
    ch = {0: 1, 2: 3, 3: 1, 6: 4}[ctype]
    rng = np.random.RandomState(h * w + ctype)
    px = rng.randint(0, 20 if ctype == 3 else 256, (h, w, ch)).astype(
        np.uint8)
    pal = (rng.randint(0, 256, (20, 3)).astype(np.uint8) if ctype == 3
           else None)
    laced, flat = tmp_path / "i.png", tmp_path / "f.png"
    laced.write_bytes(encode_png(px, ctype, [0, 1, 2, 3, 4], interlace=1,
                                 palette=pal))
    flat.write_bytes(encode_png(px, ctype, [4, 3], palette=pal))
    assert _same(laced).tobytes() == _same(flat).tobytes()


# --- TGA and BMP --------------------------------------------------------------------

def encode_tga(itype, depth, px, flags=0, cmap=None, cm_start=0, rle=False):
    """A TGA of px [h, w, bytes a pixel] (stored bytes: BGR(A), grey
    (+ alpha) or indices), rows in the order the origin bit 0x20 says,
    mirrored under bit 0x10; a 3-byte identification field."""
    h, w = px.shape[:2]
    cm_len = 0 if cmap is None else len(cmap)
    cm_depth = 0 if cmap is None else cmap.shape[1] * 8
    head = struct.pack("<BBBHHBHHHHBB", 3, int(cmap is not None),
                       itype | (8 if rle else 0), cm_start, cm_len, cm_depth,
                       0, 0, w, h, depth, flags)
    body = b"id!" + (b"" if cmap is None else cmap.tobytes())
    rows = px if flags & 0x20 else px[::-1]
    if flags & 0x10:
        rows = rows[:, ::-1]
    flat = rows.reshape(h * w, -1)
    if not rle:
        return head + body + flat.tobytes()
    out, i = b"", 0
    while i < len(flat):     # runs of repeats, else literals (across rows)
        j = i
        while j + 1 < len(flat) and j - i < 127 and (flat[j + 1] ==
                                                     flat[i]).all():
            j += 1
        if j > i:
            out += bytes([0x80 | (j - i)]) + flat[i].tobytes()
            i = j + 1
        else:
            k = min(128, len(flat) - i)
            out += bytes([k - 1]) + flat[i:i + k].tobytes()
            i += k
    return head + body + out


TGA_KINDS = {"colormap-8": (1, 8, 1), "bgr-24": (2, 24, 3),
             "bgra-32": (2, 32, 4), "grey-8": (3, 8, 1),
             "grey-alpha-16": (3, 16, 2)}


@pytest.mark.parametrize("rle", [False, True])
@pytest.mark.parametrize("flags", [0x00, 0x20, 0x10, 0x30])
@pytest.mark.parametrize("kind", list(TGA_KINDS))
def test_tga(tmp_path, kind, flags, rle):
    """Types 1, 2, 3 and (run-length) 9, 10, 11 at 8, 16, 24 and 32 bits,
    bottom-up and top-down (the origin bit), mirrored or not."""
    itype, depth, nb = TGA_KINDS[kind]
    rng = np.random.RandomState(itype * depth + flags + rle)
    px = rng.randint(0, 40 if itype == 1 else 256, (11, 7, nb)).astype(
        np.uint8)
    px[3:6] = px[3:4, :1]                        # runs across rows
    cmap = (rng.randint(0, 256, (32, 3)).astype(np.uint8) if itype == 1
            else None)
    path = tmp_path / "t.tga"
    path.write_bytes(encode_tga(itype, depth, px, flags, cmap=cmap,
                                cm_start=4, rle=rle))
    _same(path)


@pytest.mark.parametrize("mode", ["RGB", "RGBA", "L", "P"])
def test_tga_written_by_pil(tmp_path, mode):
    rng = np.random.RandomState(len(mode))
    img = Image.fromarray(rng.randint(0, 256, (9, 11, 3)).astype(
        np.uint8)).convert(mode)
    for comp in (None, "tga_rle"):
        for orientation in (-1, 1):
            path = tmp_path / f"{comp}{orientation}.tga"
            img.save(str(path), "TGA", compression=comp,
                     orientation=orientation)
            _same(path)


def encode_bmp(bits, px, top_down=False, pal=None, colors=0, header=40):
    """An uncompressed BMP of px [h, w, 3 or 4] (RGB(A)) or [h, w, 1]
    indices; rows padded to 4 bytes; header 40 (BITMAPINFOHEADER) or 124
    (V5)."""
    h, w = px.shape[:2]
    stride = ((w * bits + 31) >> 3) & ~3
    data = b""
    for r in (px if top_down else px[::-1]):
        if bits >= 24:
            raw = np.concatenate([r[:, 2::-1], r[:, 3:]], 1).tobytes()
        else:
            per = 8 // bits
            v = np.concatenate([r[:, 0], np.zeros((-w) % per, np.uint8)])
            shifts = np.arange(8 - bits, -1, -bits, dtype=np.uint8)
            raw = (v.reshape(-1, per) << shifts).sum(-1).astype(
                np.uint8).tobytes()
        data += raw + b"\0" * (stride - len(raw))
    table = b""
    if pal is not None:
        table = np.concatenate([pal[:, ::-1], np.zeros((len(pal), 1),
                                                        np.uint8)], 1).tobytes()
    dib = struct.pack("<IiiHHIIiiII", header, w, -h if top_down else h, 1,
                      bits, 0, len(data), 2835, 2835, colors, 0)
    dib += b"\0" * (header - 40)
    off = 14 + len(dib) + len(table)
    return (b"BM" + struct.pack("<IHHI", off + len(data), 0, 0, off) + dib
            + table + data)


BMP_KINDS = ["24", "32", "8", "8-short-palette", "8-grey", "8-v5", "4", "1"]


@pytest.mark.parametrize("top_down", [False, True])
@pytest.mark.parametrize("kind", BMP_KINDS)
def test_bmp(tmp_path, kind, top_down):
    """BI_RGB at 24 and 32 bits (BGRX: alpha dropped), 8-bit palettes (a
    full one, one shorter than the indices reach, a grey ramp PIL reads as
    mode L, a V5 header), 4- and 1-bit palettes at widths whose rows end
    in a partial byte, bottom-up and top-down."""
    rng = np.random.RandomState(BMP_KINDS.index(kind) + 10 * top_down)
    h, w = 9, 13
    bits = int(kind.split("-")[0])
    pal, colors, header = None, 0, 40
    if bits >= 24:
        px = rng.randint(0, 256, (h, w, bits // 8)).astype(np.uint8)
    else:
        px = rng.randint(0, 1 << bits, (h, w, 1)).astype(np.uint8)
        pal = rng.randint(0, 256, (1 << bits, 3)).astype(np.uint8)
        if kind == "8-short-palette":
            pal, colors = pal[:100], 100
        if kind == "8-grey":
            pal = np.repeat(np.arange(256, dtype=np.uint8)[:, None], 3, 1)
        if kind == "8-v5":
            header = 124
    path = tmp_path / "b.bmp"
    path.write_bytes(encode_bmp(bits, px, top_down, pal, colors, header))
    _same(path)


@pytest.mark.parametrize("mode", ["RGB", "L", "P", "1"])
def test_bmp_written_by_pil(tmp_path, mode):
    rng = np.random.RandomState(len(mode) + 7)
    path = tmp_path / "p.bmp"
    Image.fromarray(rng.randint(0, 256, (9, 11, 3)).astype(
        np.uint8)).convert(mode).save(str(path), "BMP")
    _same(path)


# --- what stays unread ----------------------------------------------------------

def write_unread(folder) -> dict:
    """Files of formats or JPEG variants the port does not read (PIL reads
    most of them): name -> path."""
    folder = str(folder)
    out = {}
    rng = np.random.RandomState(12)
    rgb = rng.randint(0, 256, (8, 8, 3)).astype(np.uint8)
    out["cmyk.jpg"] = os.path.join(folder, "cmyk.jpg")
    Image.fromarray(rgb).convert("CMYK").save(out["cmyk.jpg"], "JPEG")
    buf = _bio.BytesIO()
    Image.fromarray(rgb).save(buf, "JPEG", quality=80)
    base = buf.getvalue()
    for name, sof in (("arith.jpg", 0xC9), ("lossless.jpg", 0xC3)):
        out[name] = os.path.join(folder, name)
        with open(out[name], "wb") as f:
            f.write(base.replace(b"\xff\xc0", bytes([0xFF, sof]), 1))
    out["sky.exr"] = os.path.join(folder, "sky.exr")
    with open(out["sky.exr"], "wb") as f:
        f.write(b"\x76\x2f\x31\x01" + b"\0" * 64)
    out["anim.gif"] = os.path.join(folder, "anim.gif")
    Image.fromarray(rgb).save(out["anim.gif"], "GIF")
    out["photo.tif"] = os.path.join(folder, "photo.tif")
    Image.fromarray(rgb).save(out["photo.tif"], "TIFF")
    out["photo.webp"] = os.path.join(folder, "photo.webp")
    with open(out["photo.webp"], "wb") as f:    # a RIFF/WEBP header
        f.write(b"RIFF\x24\0\0\0WEBPVP8 " + b"\0" * 32)
    out["photo.ppm"] = os.path.join(folder, "photo.ppm")
    Image.fromarray(rgb).save(out["photo.ppm"], "PPM")
    out["photo.xbm"] = os.path.join(folder, "photo.xbm")
    Image.fromarray(rgb).convert("1").save(out["photo.xbm"], "XBM")
    return out


# What each file of write_unread does in the port since the second image
# slice: "same" is read bitwise as the JAX package reads it (PIL), also
# through the atlas builder; "skip" is bytes PIL cannot read (PIL has no
# EXR reader; since the WebP slice, a RIFF/WEBP header with no VP8 frame
# behind it, which libwebp refuses; since the fourth image slice, DCT
# data under a lossless SOF3 header, whose scan libjpeg refuses),
# ValueError naming the file, skipped by both atlas builders; "raise"
# stays unread (ROADMAP.md C6: an XBM), NotImplementedError naming the
# file, which the atlas builder lets through. The SOF9 relabel of a
# baseline file is read as PIL reads it (Huffman data decoded as
# arithmetic) since the fourth image slice; the PPM is read since the
# fifth.
UNREAD = {"cmyk.jpg": "same", "arith.jpg": "same", "lossless.jpg": "skip",
          "sky.exr": "skip", "anim.gif": "same", "photo.tif": "same",
          "photo.webp": "skip", "photo.ppm": "same", "photo.xbm": "raise"}


@pytest.mark.parametrize("name", ["cmyk.jpg", "arith.jpg", "lossless.jpg",
                                  "sky.exr", "anim.gif", "photo.tif",
                                  "photo.webp", "photo.ppm", "photo.xbm"])
def test_unread_formats_raise(tmp_path, name):
    """A CMYK JPEG, an arithmetic-coded (SOF9) JPEG, a GIF, a TIFF and a
    PPM read bitwise as the JAX package reads them, also through the atlas
    builder; an EXR (no PIL plugin reads it), a WebP header without a
    frame and a lossless (SOF3) header over DCT data (PIL cannot load
    either) raise ValueError naming the file and both atlas builders skip
    them; an XBM still raises NotImplementedError naming the file, also
    through the atlas builder (which skips only what PIL cannot read)."""
    path = write_unread(tmp_path)[name]
    kind = UNREAD[name]
    if kind == "raise":
        with pytest.raises(NotImplementedError, match=name):
            io.load_image(path)
        with pytest.raises(NotImplementedError, match=name):
            textures.build_atlas([name], str(tmp_path))
        return
    if kind == "skip":
        with pytest.raises(ValueError, match=name):
            io.load_image(path)
        with pytest.raises(Exception):
            jax_io.load_image(path)
    else:
        _same(path)
    got = textures.build_atlas([name], str(tmp_path))
    want = jax_textures.build_atlas([name], str(tmp_path))
    assert got[2] == want[2] == ({} if kind == "skip" else {name: 0})
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()


# --- scenes ---------------------------------------------------------------------------

def _textured_obj(folder, maps):
    """One quad a material, each material's map_Kd one of ``maps``."""
    mtl, obj = [], ["mtllib m.mtl", "vt 0 0", "vt 1 0", "vt 1 1", "vt 0 1",
                    "vn 0 0 -1"]
    for i, name in enumerate(maps):
        mtl += [f"newmtl m{i}", "Kd 1 1 1", f"map_Kd {name}"]
        x = 1.2 * i
        obj += [f"v {x} 0 0", f"v {x + 1} 0 0", f"v {x + 1} 1 0",
                f"v {x} 1 0", f"usemtl m{i}",
                f"f {4 * i + 1}/1/1 {4 * i + 2}/2/1 {4 * i + 3}/3/1 "
                f"{4 * i + 4}/4/1"]
    with open(os.path.join(folder, "m.mtl"), "w") as f:
        f.write("\n".join(mtl) + "\n")
    path = os.path.join(folder, "scene.obj")
    with open(path, "w") as f:
        f.write("\n".join(obj) + "\n")
    return path


ATLAS = ("atlas_image", "atlas_rects", "atlas_mips", "mat_rows")


def _hold_atlas(cfg):
    scene, meta = load_scene(RenderConfig(**cfg), "cpu")
    jscene, jmeta = jax_load_scene(JaxRenderConfig(**cfg))
    assert meta.has_textures and jmeta.has_textures
    for f in ATLAS:
        g, w = getattr(scene, f).numpy(), np.asarray(getattr(jscene, f))
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f


@pytest.mark.parametrize("levels", [1, 4])
def test_obj_with_jpeg_maps_matches_jax(tmp_path, levels):
    """An OBJ whose map_Kd maps are JPEGs (baseline 4:2:0, progressive,
    grey, 4:2:2 with restarts), one of them truncated (both packages skip
    it), and a PNG: build_atlas's image, rects, slots and mips, and
    load_scene's atlas tables and material rows, bitwise JAX's."""
    rng = np.random.RandomState(levels)
    _pil_jpeg(tmp_path / "a.jpg", _photo(37, 53, 1), quality=75,
              subsampling=2)
    _pil_jpeg(tmp_path / "b.jpg", _photo(16, 16, 2), quality=90,
              progressive=True)
    _pil_jpeg(tmp_path / "c.jpg", _photo(24, 40, 3)[..., 0], quality=60)
    _pil_jpeg(tmp_path / "d.jpg", _photo(33, 9, 4), quality=50,
              subsampling=1, restart_marker_blocks=2)
    good = (tmp_path / "a.jpg").read_bytes()
    (tmp_path / "broken.jpg").write_bytes(good[:len(good) // 2])
    io.save_png(str(tmp_path / "e.png"), rng.rand(8, 12, 3))
    maps = ["a.jpg", "broken.jpg", "b.jpg", "c.jpg", "d.jpg", "e.png"]
    got = textures.build_atlas(maps, str(tmp_path), mip_levels=levels)
    want = jax_textures.build_atlas(maps, str(tmp_path), mip_levels=levels)
    assert got[2] == want[2] and "broken.jpg" not in got[2]
    assert len(got[2]) == 5
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    path = _textured_obj(str(tmp_path), maps)
    _hold_atlas(dict(scene_path=path, mip_levels=levels))


def test_jpeg_sky_and_cube_faces_match_jax(tmp_path):
    """A .jpg equirect sky (4:2:0, progressive) and a cubemap of JPEG faces
    (baseline 4:4:4, 4:2:2, grey and 4:2:0): the environment images bitwise
    JAX's."""
    sky = _pil_jpeg(tmp_path / "sky.jpg", _photo(32, 64, 11), quality=85,
                    subsampling=2, progressive=True)
    names = []
    for i in range(6):
        px = _photo(16, 16, 20 + i)
        kw = dict(quality=70 + 5 * i, subsampling=[0, 1, 2][i % 3])
        if i == 3:
            px = px[..., 2]
        names.append(f"face{i}.jpeg")
        _pil_jpeg(tmp_path / names[-1], px, **kw)
    (tmp_path / "cube.txt").write_text("\n".join(names) + "\n")
    for spec in (str(sky), str(tmp_path / "cube.txt")):
        got = envmap.environment_image(spec)
        want = np.asarray(jax_envmap.load_environment(spec).image)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes(), spec


# --- the committed fixtures -------------------------------------------------------------

def _manifest():
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("name", sorted(_manifest()))
def test_fixtures_decode_to_their_pngs(name):
    """Each committed image file (tools/torch_image_fixtures.py: the JPEGs,
    and since the second image slice the DDS, TIFF, GIF, PSD, BMP and
    CMYK / YCCK JPEG files) decodes to its PNG twin in PIL and in the
    port, and the manifest's sha256 values hold for the files and the
    pixels."""
    entry = _manifest()[name]
    path = os.path.join(FIXTURES, entry["file"])
    png = os.path.join(FIXTURES, entry["png"])
    for p, key in ((path, "file_sha256"), (png, "png_sha256")):
        with open(p, "rb") as f:
            assert hashlib.sha256(f.read()).hexdigest() == entry[key]
    with open(path, "rb") as f:
        got = io.decode_image(f.read(), path)
    with open(png, "rb") as f:
        twin = io.decode_png(f.read(), png)
    pil = np.asarray(Image.open(path).convert("RGB"))
    assert got.shape == (entry["height"], entry["width"], 3)
    assert hashlib.sha256(got.tobytes()).hexdigest() == entry["pixels_sha256"]
    assert got.tobytes() == twin.tobytes() == pil.tobytes()
    assert _same(path).tobytes() == _same(png).tobytes()


def test_fixture_tool_rewrites_the_fixtures(tmp_path):
    """tools/torch_image_fixtures.py, run again, writes the committed files
    byte for byte (PIL's encoder and the tool's PNG writer are
    deterministic)."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_image_fixtures", os.path.join(REPO, "tools",
                                             "torch_image_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--out", str(tmp_path)]) == 0
    for name in sorted(os.listdir(FIXTURES)):
        with open(os.path.join(FIXTURES, name), "rb") as f, \
                open(tmp_path / name, "rb") as g:
            assert f.read() == g.read(), name


def test_fixture_tool_times_the_decodes(capsys):
    """--time prints a line a fixture: the port's and PIL's decode of the
    same bytes and the PNG twin's, in ms and MPix/s."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_image_fixtures", os.path.join(REPO, "tools",
                                             "torch_image_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    assert tool.main(["--time", "--out", FIXTURES]) == 0
    lines = capsys.readouterr().out.strip().splitlines()
    assert sorted(ln.split()[0] for ln in lines) == sorted(_manifest())
    assert all("port " in ln and "PIL " in ln and "MPix/s" in ln
               for ln in lines)
