"""The rest of JPEG 2000 as PIL reads it (ROADMAP.md C6, eighth part): HTJ2K
code-blocks and Part 2's multiple component transform markers, held
bitwise to PIL's ``Image.open(path).convert("RGB")`` on the CPU.

- HTJ2K (utils/j2k_cpp/j2k.cpp, OpenJPEG 2.5.4's ht_dec.c): codestreams
  of tools/torch_htj2k.py of every size class, wavelet, code-block size,
  pass count, layer and tile layout, and files made for each check
  OpenJPEG makes of an HT code-block (the ones that fail the decode and
  the ones that warn and decode on), the VLC tables against the ones in
  Pillow's OpenJPEG.
- Part 2 (MCT, MCC, MCO, CBD): OpenJPEG's own encodings refused as
  OpenJPEG refuses their array transform, hand-made segments for each of
  its readers' early returns, and seeded edits of PIL's files.
- The mutation generators on HT code-block data and on Part 2 segments.

Every case writes a file and holds ``decode_image`` to PIL's decode of
that path and ``load_image`` to the JAX package's. The card's test at the
end runs where neither PIL nor the JAX package is:

    python -m pytest tests/test_torch_htj2k.py -m cuda --noconftest -q

The seeded fuzz behind ROADMAP.md C6's counts:

    python tests/test_torch_htj2k.py --fuzz 1-100 [ht] [part2]
"""

import importlib.util
import os
import shutil
import struct
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
from gpupathtracer_tpu_torch.utils import io  # noqa: E402
from test_torch_simple_formats import (  # noqa: E402
    W, _hold, _photo, _pil_path, _pil_save)

FIXTURES = os.path.join(REPO, "tests", "golden", "images")
# Phase 27b's town: each map's file, decoding to the map's PNG twin.
TOWN_HT_MCT = {"checker": "checker_ht.j2k", "bricks": "bricks_mct.j2k",
               "roof": "roof_ht.j2k", "foliage": "foliage_mct.j2k"}


def _writer():
    spec = importlib.util.spec_from_file_location(
        "torch_htj2k", os.path.join(REPO, "tools", "torch_htj2k.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


H = _writer()


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return tmp_path_factory.mktemp("htj2k")


def _planes(img):
    return [img[..., c] for c in range(img.shape[-1])]


def test_vlc_tables_are_openjpegs():
    """utils/ht_vlc.bin holds the two VLC tables of Pillow's OpenJPEG:
    found again in the library, each a prefix code over its 7-bit
    codewords in every context."""
    import glob

    import PIL

    from gpupathtracer_tpu_torch.utils.jpeg2000 import ht_vlc_tables
    lib = glob.glob(os.path.join(os.path.dirname(os.path.dirname(
        PIL.__file__)), "pillow.libs", "libopenjp2-*.so*"))[0]
    with open(lib, "rb") as f:
        found = np.frombuffer(H.find_vlc_tables(f.read()), "<u2")
    assert found.tobytes() == ht_vlc_tables().tobytes()


# --- HTJ2K codestreams -------------------------------------------------------

HT_CASES = {
    "1x1": (1, 1, 1, dict(levels=0, cblk=(2, 2))),
    "1x9": (1, 9, 3, dict(levels=0, cblk=(3, 2), p=2, passes=3)),
    "9x1": (9, 1, 3, dict(levels=0, cblk=(2, 3), p=2, passes=2)),
    "3x5": (3, 5, 3, dict(levels=1, cblk=(2, 2))),
    "5x3_97": (5, 3, 3, dict(levels=1, real=True, p=2, passes=3)),
    "17x33": (17, 33, 3, dict(levels=2, cblk=(4, 2), p=2, passes=3)),
    "33x17_vsc": (33, 17, 1, dict(levels=2, cblk=(2, 4), p=2, passes=3,
                                  style=0x48)),
    "odd_97": (29, 31, 3, dict(levels=3, cblk=(3, 4), real=True,
                               steps=[1] * 10)),
    "la": (21, 22, 2, dict(levels=2, p=2, passes=3)),
    "rgba_97": (19, 26, 4, dict(levels=2, real=True, p=2, passes=2)),
    "layers": (24, 30, 3, dict(levels=2, cblk=(2, 2), layers=4, late=True,
                               p=2, passes=3)),
    "tiles": (40, 36, 3, dict(levels=2, tile=(16, 24), p=2, passes=3)),
    "tiles_97": (36, 40, 3, dict(levels=1, tile=(12, 8), real=True)),
    "cb64": (70, 66, 1, dict(levels=1, cblk=(6, 6), p=2, passes=3)),
    "cb1024": (40, 70, 3, dict(levels=1, cblk=(10, 2))),
    "style_bits": (20, 20, 3, dict(levels=1, p=2, passes=3, style=0x7F)),
}


@pytest.mark.parametrize("case", sorted(HT_CASES))
def test_ht_codestreams(folder, case):
    """HTJ2K codestreams of every size class (1x1, one row, one column,
    odd sizes, code-blocks from 4x4 to 1024x4 and 64x64), 5/3 and 9/7,
    the cleanup pass alone or with SigProp (and MagRef), vertically causal
    contexts, 1-4 components, layers and tiles, and every other code-block
    style bit set beside HT's: bitwise PIL."""
    h, w, n, kw = HT_CASES[case]
    img = _photo(h, w, 60 + len(case))
    if n == 4:
        img = np.concatenate([img, img[..., :1]], -1)
    data = H.write_codestream(_planes(img[..., :n] if n < 4 else img), **kw)
    _hold(folder, f"{case}.j2k", data)


def _j2k_siz_width(cs: bytes, w: int) -> bytes:
    out = bytearray(cs)
    struct.pack_into(">I", out, 8, w)       # Xsiz
    struct.pack_into(">I", out, 24, w)      # XTsiz
    return bytes(out)


def _ht_check_cases() -> dict:
    """case -> (a function writing its file, whether PIL reads it)."""
    p = _planes(_photo(20, 24, 3))
    ramp = [np.arange(16).reshape(4, 4) * 13]
    return {
        # warns and decodes the cleanup pass alone
        "zero_planes_eq_mb": (lambda: H.write_codestream(
            p, levels=1, p=2, passes=3, zb_shift=1), True),
        "passes_without_bytes": (lambda: H.write_codestream(
            p, levels=1, extra_passes=2), True),
        # fails the decode
        "zero_planes_gt_mb": (lambda: H.write_codestream(
            p, levels=1, zb_shift=2), False),
        "u_q_too_large": (lambda: H.write_codestream(
            p, levels=1, zb_shift=-3), False),
        "four_passes": (lambda: H.write_codestream(
            p, levels=1, p=2, passes=3, extra_passes=1), False),
        "mb_31": (lambda: H.write_codestream(
            p, levels=1, real=True, steps=[22] * 4), False),
        "roi": (lambda: W.j2k_insert(H.write_codestream(p, levels=1), (
            0xFF5E, bytes([0, 0, 2]))), False),
        "mixed_style": (lambda: H.write_codestream(
            p, levels=1, style=0xC0), False),
        "outside_the_block": (lambda: _j2k_siz_width(H.write_codestream(
            ramp, levels=0, cblk=(2, 2)), 3), False),
        "split_layers": (lambda: H.write_codestream(
            p, levels=2, layers=2, split=True, p=2, passes=3), False),
        # decodes
        "mb_30": (lambda: H.write_codestream(
            p, levels=1, real=True, steps=[21] * 4), True),
        "inside_the_block": (lambda: _j2k_siz_width(H.write_codestream(
            ramp, levels=0, cblk=(2, 2)), 2), True),
    }


HT_CHECKS = sorted(_ht_check_cases())      # the writes run in the test


@pytest.mark.parametrize("case", HT_CHECKS)
def test_openjpeg_ht_checks(folder, case):
    """OpenJPEG's checks of an HT code-block, a file made for each (found
    by running Pillow's libopenjp2 through ctypes): zero bit-planes
    equal to the block's planes with refinement passes, and refinement
    passes of no bytes, warn and decode the cleanup pass alone; more zero
    bit-planes than planes, a U_q beyond them, four passes, Mb above 30,
    ROI, the mixed-mode style bit, significance outside the block and a
    cleanup pass split across layers fail the decode, as in PIL."""
    write, reads = _ht_check_cases()[case]
    _hold(folder, f"{case}.j2k", write(), pil_reads=reads)


def _ht_mutants(rng, count: int):
    """Codestreams of random size and options, then 0-2 bytes of their
    packet data set or flipped."""
    for _ in range(count):
        h, w = rng.randint(1, 40, 2)
        kw = dict(levels=int(rng.randint(0, 3)),
                  cblk=(int(rng.randint(2, 6)), int(rng.randint(2, 6))))
        if min(h, w) < (1 << kw["levels"]):
            kw["levels"] = 0
        if rng.rand() < 0.6:
            kw.update(p=2, passes=int(rng.randint(1, 4)))
        if rng.rand() < 0.3:
            kw["real"] = True
        if rng.rand() < 0.3:
            kw["style"] = 0x48
        px = _photo(int(h), int(w), int(rng.randint(100)))
        data = bytearray(H.write_codestream(_planes(px), **kw))
        sod = data.index(b"\xff\x93") + 2
        for _ in range(rng.randint(0, 3)):
            k = rng.randint(sod, len(data) - 2)
            data[k] = rng.randint(256) if rng.rand() < 0.7 else \
                data[k] ^ (1 << rng.randint(8))
        yield bytes(data)


# --- Part 2 ------------------------------------------------------------------

def test_openjpeg_array_transform_refused(folder):
    """OpenJPEG's own Part 2 encodings (opj_set_MCT) carry COD's array
    transform (SGcod 2), which its decoder refuses: the committed
    fixtures with that byte put back fail in PIL and in the port."""
    for name in ("mct3_rev_off", "mct4_irr_off", "bricks_mct"):
        with open(os.path.join(FIXTURES, f"{name}.j2k"), "rb") as f:
            data = W.j2k_cod_mct(f.read(), 2)
        _hold(folder, f"{name}_sgcod2.j2k", data, pil_reads=False)


def _mct(z=0, index=1, elem=0, y=0, body=b"\0\x80\0\x40\0\x20"):
    return (0xFF74, struct.pack(">HHH", z, index | 2 << 8 | elem << 10, y)
            + body)


def _mcc(z=0, index=7, y=0, count=1, kind=1, comps=3, order=None,
         tmcc=0x010100, extra=b""):
    order = bytes(range(comps)) if order is None else order
    return (0xFF75, struct.pack(">HBHHBH", z, index, y, count, kind, comps)
            + order + struct.pack(">H", comps) + order
            + tmcc.to_bytes(3, "big") + extra)


PART2_CASES = {
    "offsets": (_mct(), _mcc(), (0xFF77, b"\x01\x07")),
    "zmct_ignored": (_mct(z=1), _mcc(), (0xFF77, b"\x01\x07")),
    "ymct_no_data": (_mct(y=1), _mcc(), (0xFF77, b"\x01\x07")),
    "mct_too_short": ((0xFF74, b"\0\0\x02\x01\0\0"),),
    "mcc_unknown_record": (_mcc(tmcc=0x010200),),
    "mcc_shuffled": (_mct(), _mcc(order=b"\1\0\2"), (0xFF77, b"\x01\x07")),
    "mcc_two_collections": (_mct(), _mcc(count=2), (0xFF77, b"\x01\x07")),
    "mcc_not_array": (_mct(), _mcc(kind=3), (0xFF77, b"\x01\x07")),
    "mcc_trailing": (_mct(), _mcc(extra=b"\0"),),
    "mcc_two_comps": (_mct(body=b"\0\x80\0\x40"), _mcc(comps=2),
                      (0xFF77, b"\x01\x07")),
    "mco_two_stages": ((0xFF77, b"\x02\x07\x07"),),
    "mco_no_stage": ((0xFF77, b"\x00"),),
    "mco_wrong_size": ((0xFF77, b"\x01\x07\x07"),),
    "mco_unknown_mcc": (_mct(), _mcc(), (0xFF77, b"\x01\x09")),
    "offsets_wrong_size": (_mct(body=b"\0\x80\0\x40"), _mcc(),
                           (0xFF77, b"\x01\x07")),
    "offsets_unsigned": (_mct(body=b"\xff\xf0\0\x40\0\x20"), _mcc(),
                         (0xFF77, b"\x01\x07")),
    "offsets_int32": (_mct(elem=1, body=b"\xff\xff\xff\xf0" + bytes(4)
                           + b"\0\0\0\x80"), _mcc(), (0xFF77, b"\x01\x07")),
    "cbd": ((0xFF78, b"\0\x03\x88\x05\x07"),),
    "cbd_wrong_count": ((0xFF78, b"\0\x02\x07\x07\x07"),),
    "cbd_32_bits": ((0xFF78, b"\0\x03\x1f\x07\x07"),),
}


@pytest.mark.parametrize("case", sorted(PART2_CASES))
def test_part2_segments(folder, case):
    """OpenJPEG's MCT / MCC / MCO / CBD readers, a segment set for each
    early return (a warning that skips the rest: Zmct, Ymct, two
    collections, a non-array collection, a shuffled component order, two
    stages) and each failure (short segments, unknown records, trailing
    bytes, an offset array of the wrong size, a CBD of the wrong count or
    of 32 bits), and what decodes differently: MCO's DC level shifts
    (zeroed, then int16 read unsigned, int32) and CBD's signs and depths.
    The transform itself is never applied (COD refuses SGcod 2)."""
    base = _pil_save(_photo(18, 21, 44), "JPEG2000", no_jp2=True)
    _hold(folder, f"{case}.j2k", W.j2k_insert(base, *PART2_CASES[case]),
          pil_reads=None)


def _part2_segment(rng, nc: int) -> bytes:
    """An MCT, MCC, MCO or CBD segment with fields near valid ones."""
    pick = lambda *v: v[rng.randint(len(v))]  # noqa: E731
    m = pick(0xFF74, 0xFF74, 0xFF75, 0xFF77, 0xFF78)
    if m == 0xFF74:
        et = rng.randint(4)
        n = pick(nc, nc * nc, nc + 1, 0)
        fmt = ">" + "hifd"[et]
        vals = [pick(0, 128, 5, -7, 300) for _ in range(n)]
        if et >= 2 and n:
            vals[0] = pick(1e10, float("nan"), 130.7, -2.5)
        b = struct.pack(">HHH", pick(0, 0, 0, 1), pick(1, 2, 3) |
                        pick(1, 2) << 8 | et << 10, pick(0, 0, 0, 1)) + \
            b"".join(struct.pack(fmt, v) for v in vals)
    elif m == 0xFF75:
        n = pick(nc, nc, nc, 2, 4)
        b = struct.pack(">HBHHBH", pick(0, 0, 0, 1), pick(1, 2, 3),
                        pick(0, 0, 0, 1), pick(1, 1, 1, 0, 2),
                        pick(1, 1, 1, 0), n) + bytes(range(n)) + \
            struct.pack(">H", n) + bytes(range(n) if rng.rand() < 0.9
                                         else [1] * n) + \
            bytes([pick(0, 1), pick(0, 1, 2, 3), pick(0, 1, 2, 3)])
    elif m == 0xFF77:
        b = bytes([pick(1, 1, 1, 0, 2), pick(1, 2, 3, 4)])
    else:
        b = struct.pack(">H", pick(nc, nc, nc + 1)) + bytes(
            pick(7, 7, 0x87, 11, 0x8B, 3, 40) for _ in range(pick(
                nc, nc, nc - 1)))
    if rng.rand() < 0.1:
        b = b[:rng.randint(len(b) + 1)]
    return struct.pack(">HH", m, len(b) + 2) + b


def _part2_mutants(rng, count: int):
    """PIL's files (RGB, 9/7, grey, tiled RGBA, no RCT) with 1-5 Part 2
    segments inserted into the main header or the first tile-part header,
    and now and then COD's SGcod set to 0, 1 or 2."""
    px = _photo(24, 30, 3)
    seeds = [_pil_save(px, "JPEG2000", no_jp2=True),
             _pil_save(px, "JPEG2000", no_jp2=True, irreversible=True),
             _pil_save(px[..., 0], "JPEG2000", no_jp2=True),
             _pil_save(np.concatenate([px, px[..., :1]], -1), "JPEG2000",
                       no_jp2=True, tile_size=(16, 16)),
             _pil_save(px, "JPEG2000", no_jp2=True, mct=0)]
    for _ in range(count):
        s = seeds[rng.randint(len(seeds))]
        nc = struct.unpack_from(">H", s, 40)[0]
        segs = [_part2_segment(rng, nc) for _ in range(rng.randint(1, 6))]
        split = [(struct.unpack_from(">H", x)[0], x[4:]) for x in segs]
        data = W.j2k_insert(s, *split) if rng.rand() < 0.7 else \
            W.j2k_tile_insert(s, *split)
        if rng.rand() < 0.2:
            data = W.j2k_cod_mct(data, rng.randint(3))
        yield data


# --- the mutation counts -----------------------------------------------------

_MUTANTS = {"ht": (_ht_mutants, 40), "part2": (_part2_mutants, 60)}


def mutation_counts(kind: str, seed: int) -> dict:
    """The mutants of one seed: both read alike, PIL reads and the port
    refuses, decodes otherwise or raises NotImplementedError; the port
    decodes where PIL fails; both fail."""
    import tempfile
    gen, count = _MUTANTS[kind]
    rng = np.random.RandomState(seed)
    counts = dict(both=0, refused=0, otherwise=0, unread=0, extra=0,
                  both_fail=0)
    with tempfile.TemporaryDirectory() as tmp:
        path = os.path.join(tmp, "mutant.j2k")
        for data in gen(rng, count):
            with open(path, "wb") as f:
                f.write(data)
            want, _ = _pil_path(path)
            try:
                got = io.decode_image(data, "mutant")
            except ValueError:
                counts["refused" if want is not None else "both_fail"] += 1
                continue
            except NotImplementedError:
                counts["unread"] += 1
                continue
            if want is None:
                counts["extra"] += 1
            elif got.tobytes() == want.tobytes():
                counts["both"] += 1
            else:
                counts["otherwise"] += 1
    return counts


@pytest.mark.parametrize("kind", sorted(_MUTANTS))
@pytest.mark.parametrize("seed", [1, 2])
def test_mutations_decode_as_pil(kind, seed):
    """HT code-block data with bytes set or flipped, and Part 2 segments
    near valid ones in PIL's files: the port decodes each to PIL's bits or
    fails where PIL fails; none raises NotImplementedError."""
    c = mutation_counts(kind, seed)
    assert c["both"] > 5 and c["both_fail"] > 3, c
    assert c["refused"] == c["otherwise"] == c["extra"] == 0, c
    assert c["unread"] == 0, c


def _fuzz(argv) -> int:
    """``--fuzz A-B [ht] [part2]``: the mutation counts over seeds A..B."""
    i = argv.index("--fuzz")
    lo, hi = (int(v) for v in argv[i + 1].split("-"))
    for kind in argv[i + 2:] or sorted(_MUTANTS):
        total = {}
        for seed in range(lo, hi + 1):
            for k, v in mutation_counts(kind, seed).items():
                total[k] = total.get(k, 0) + v
        print(f"{kind}: seeds {lo}-{hi}, {sum(total.values())} files: "
              f"{total}", flush=True)
    return 0


# --- the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_town_on_htj2k_and_mct_maps_on_cuda(tmp_path):
    """Phase 27b in small: the generated town on its HTJ2K and Part 2
    re-encodings of the PNG twins renders on the card bitwise as on the
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
    for kind in ("png", "j2k"):
        sub = tmp_path / kind
        sub.mkdir()
        shutil.copy(town, sub)
        mtl = (tmp_path / "town" / "town.mtl").read_text()
        for name, fname in TOWN_HT_MCT.items():
            src = fname if kind == "j2k" else f"{name}.png"
            shutil.copy(os.path.join(FIXTURES, src), sub)
            mtl = mtl.replace(f"{name}.png", src)
        (sub / "town.mtl").write_text(mtl)
        cfg = RenderConfig(scene_path=str(sub / os.path.basename(town)),
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


if __name__ == "__main__":
    sys.exit(_fuzz(sys.argv))
