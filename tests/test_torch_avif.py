"""AVIF at open (ROADMAP.md C9, the AVIF part): the port's identify runs
libavif 1.3.0's avifDecoderParse as Pillow 12.1.0's AvifImagePlugin does
(utils/avif.py), so it names, refuses or passes on each file as
``Image.open`` does. A file libavif parses is AVIF and raises
NotImplementedError naming it (its AV1 payload is ROADMAP.md C6's next
AVIF step); one Pillow passes on goes to the next plugin; one it stops at
(a RuntimeError or ValueError of the plugin, the decompression-bomb check)
is ValueError, as are bytes no plugin opens.

- The committed set (tests/golden/avif, written by
  ``python tools/torch_image_fixtures.py --avif-set``): PIL-written still, alpha and animated
  files, each cut and each with junk behind its ftyp box, against the
  verdicts recorded there and against PIL here.
- PIL-written files of its other options (quality, 4:4:4, grey, Exif, XMP
  and ICC, sizes), and edits made for libavif's checks: the hdlr, the
  primary item, essential properties, the av1C and pixi depths, the colr
  boxes, the alpha auxC, Exif payloads, iloc versions and extents, grids,
  the sequence header read where no nclx colr gives the colours.
- The mutation generator of tests/test_torch_simple_formats.py and cuts
  on the PIL-written files, against ``Image.open``'s verdict.

The card's test at the end runs where PIL is not:

    python -m pytest tests/test_torch_avif.py -m cuda --noconftest -q

The seeded fuzz behind ROADMAP.md C9's counts:

    python tests/test_torch_avif.py --fuzz 1-100
"""

import hashlib
import json
import os
import struct
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path[:0] = [REPO, os.path.join(REPO, "tests")]
from gpupathtracer_tpu_torch.utils import io  # noqa: E402
from gpupathtracer_tpu_torch.utils.identify import identify  # noqa: E402
from test_torch_simple_formats import (  # noqa: E402
    _mutants, _photo, _pil_save)

AVIF = os.path.join(REPO, "tests", "golden", "avif")


def _verdicts() -> dict:
    with open(os.path.join(AVIF, "verdicts.json")) as f:
        return json.load(f)


def _pil_format(data: bytes):
    """The format ``Image.open`` gives the bytes, or None where it fails."""
    import io as _io
    import warnings

    from PIL import Image
    try:
        with warnings.catch_warnings():
            warnings.simplefilter("ignore")
            return Image.open(_io.BytesIO(data)).format
    except Exception:
        return None


def _port_format(data: bytes, name: str = "x"):
    try:
        return identify(data, name)
    except ValueError:
        return None


def _held(data: bytes, want, path=None) -> None:
    """identify gives PIL's format or ValueError; an AVIF load raises
    NotImplementedError naming the file, a refused one ValueError."""
    assert _port_format(data) == want
    if path is None:
        return
    if want == "AVIF":
        with pytest.raises(NotImplementedError, match=os.path.basename(path)):
            io.load_image(path)
    elif want is None:
        with pytest.raises(ValueError, match=os.path.basename(path)):
            io.load_image(path)


@pytest.mark.parametrize("name", sorted(_verdicts()))
def test_committed_set(name):
    """Each committed file: its sha256, PIL's verdict as recorded and as
    PIL gives it here, and the port's."""
    e = _verdicts()[name]
    path = os.path.join(AVIF, e["file"])
    with open(path, "rb") as f:
        data = f.read()
    assert hashlib.sha256(data).hexdigest() == e["sha256"]
    assert _pil_format(data) == e["pil"]
    _held(data, e["pil"], path)


def test_avif_set_rewrites(tmp_path):
    """``tools/torch_image_fixtures.py --avif-set``'s writer, run again,
    writes the committed set and its verdicts byte for byte."""
    import importlib.util
    spec = importlib.util.spec_from_file_location(
        "torch_image_fixtures", os.path.join(REPO, "tools",
                                             "torch_image_fixtures.py"))
    tool = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tool)
    tool.write_avif_set(str(tmp_path))
    names = sorted(os.listdir(AVIF))
    assert sorted(os.listdir(tmp_path)) == names
    for name in names:
        with open(os.path.join(AVIF, name), "rb") as f:
            assert f.read() == (tmp_path / name).read_bytes(), name


def _save(img, **kw) -> bytes:
    return _pil_save(img, "AVIF", **kw)


def _pil_written() -> dict:
    from PIL import Image
    px = _photo(24, 32, 1)
    a = Image.fromarray(px)
    ex = Image.Exif()
    ex[274] = 3
    ex[305] = "port"
    return {
        "still": lambda: _save(a),
        "alpha": lambda: _save(Image.fromarray(np.dstack([px, px[..., :1]]))),
        "anim": lambda: _save(a, save_all=True, append_images=[
            Image.fromarray(px[::-1].copy())]),
        "anim_rgba": lambda: _save(Image.fromarray(np.dstack(
            [px, px[..., :1]])), save_all=True, append_images=[
            Image.fromarray(np.dstack([px, px[..., 1:2]]))]),
        "s444": lambda: _save(a, subsampling="4:4:4", quality=90),
        "grey": lambda: _save(a.convert("L")),
        "meta": lambda: _save(a, exif=ex.tobytes(), icc_profile=bytes(64),
                              xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>"),
        "1x1": lambda: _save(Image.fromarray(px[:1, :1])),
        "odd": lambda: _save(Image.fromarray(_photo(13, 7, 2)), quality=30),
    }


@pytest.mark.parametrize("case", sorted(_pil_written()))
def test_pil_written(tmp_path, case):
    """Files of PIL's AVIF options: AVIF, and NotImplementedError naming
    the file on load."""
    data = _pil_written()[case]()
    path = tmp_path / f"{case}.avif"
    path.write_bytes(data)
    assert _pil_format(data) == "AVIF"
    _held(data, "AVIF", str(path))


# --- edits for libavif's checks ----------------------------------------------

def _at(data: bytes, tag: bytes, skip: int = 0) -> int:
    """The offset of the body of the (skip + 1)-th box of type `tag`."""
    at = -1
    for _ in range(skip + 1):
        at = data.index(tag, at + 1)
    return at + 4


def _tiff(data: bytes) -> int:
    """The offset of the Exif payload's TIFF header."""
    at = [data.find(h) for h in (b"II*\0", b"MM\0*")]
    return max(at)


def _set(data: bytes, at: int, new: bytes) -> bytes:
    return data[:at] + new + data[at + len(new):]


def _edits() -> dict:
    still = lambda: _pil_written()["still"]()  # noqa: E731
    alpha = lambda: _pil_written()["alpha"]()  # noqa: E731
    meta = lambda: _pil_written()["meta"]()  # noqa: E731
    anim = lambda: _pil_written()["anim"]()  # noqa: E731

    def ed(src, fn):
        return lambda: fn(src())

    def no_colr_moved(d):              # no nclx, the item's data moved
        d = _set(d, d.index(b"colr"), b"xolr")
        o = _at(d, b"iloc") + 14
        return _set(d, o, struct.pack(">I", len(d) - 30))
    return {
        "hdlr_not_pict": ed(still, lambda d: _set(d, _at(d, b"hdlr") + 8,
                                                  b"vide")),
        "hdlr_predefined": ed(still, lambda d: _set(d, _at(d, b"hdlr") + 4,
                                                    b"\1")),
        "no_pitm": ed(still, lambda d: _set(d, d.index(b"pitm"), b"xitm")),
        "pitm_other_item": ed(still, lambda d: _set(
            d, _at(d, b"pitm") + 4, b"\0\x09")),
        "av1c_marker": ed(still, lambda d: _set(d, _at(d, b"av1C"), b"\1")),
        "av1c_depth_vs_pixi": ed(still, lambda d: _set(
            d, _at(d, b"av1C") + 2, b"\x2c")),
        "av1c_reserved": ed(still, lambda d: _set(
            d, _at(d, b"av1C") + 3, b"\xff")),
        "no_av1c": ed(still, lambda d: _set(d, d.index(b"av1C"), b"xv1C")),
        "no_ispe": ed(still, lambda d: _set(d, d.index(b"ispe"), b"xspe")),
        "ispe_zero": ed(still, lambda d: _set(d, _at(d, b"ispe") + 4,
                                              bytes(4))),
        "ispe_huge": ed(still, lambda d: _set(d, _at(d, b"ispe") + 4,
                                              struct.pack(">I", 40000))),
        "pixi_planes": ed(still, lambda d: _set(d, _at(d, b"pixi") + 4,
                                                b"\x05")),
        "colr_reserved": ed(still, lambda d: _set(
            d, _at(d, b"colr") + 10, b"\x81")),
        "colr_other": ed(still, lambda d: _set(d, _at(d, b"colr"), b"abcd")),
        "no_colr_moved_item": ed(still, no_colr_moved),
        "essential_unknown": ed(still, lambda d: _set(
            _set(d, d.index(b"colr"), b"zzzz"), _at(d, b"ipma") + 12,
            b"\x84")),
        "essential_index_0": ed(still, lambda d: _set(
            d, _at(d, b"ipma") + 11, b"\x80")),
        "ipma_index_out": ed(still, lambda d: _set(
            d, _at(d, b"ipma") + 11, b"\x0f")),
        "iloc_version_3": ed(still, lambda d: _set(d, _at(d, b"iloc"),
                                                   b"\3")),
        "iloc_field_size": ed(still, lambda d: _set(
            d, _at(d, b"iloc") + 4, b"\x54")),
        "item_larger_than_file": ed(still, lambda d: _set(
            d, _at(d, b"iloc") + 18, struct.pack(">I", len(d) + 1))),
        "grid_type": ed(still, lambda d: _set(d, _at(d, b"infe") + 8,
                                              b"grid")),
        "alpha_urn": ed(alpha, lambda d: _set(d, d.index(b"alpha"), b"alphx")),
        "alpha_no_auxl": ed(alpha, lambda d: _set(d, d.index(b"auxl"),
                                                  b"xuxl")),
        "exif_prefix": ed(meta, lambda d: _set(d, _tiff(d) - 4,
                                               b"\0\0\0\x09")),
        "exif_no_tiff": ed(meta, lambda d: _set(d, _tiff(d), b"JJ")),
        "ftyp_no_avif": ed(still, lambda d: _set(
            _set(d, 8, b"mif1"), 16, b"mif1")),
        "ftyp_brands_odd": ed(still, lambda d: _set(d, 3, b"\x1e")),
        "moov_missing": ed(anim, lambda d: _set(d, d.index(b"moov"),
                                                b"xoov")),
        "stsc_zero": ed(anim, lambda d: _set(d, _at(d, b"stsc") + 12,
                                             bytes(4))),
        "stsz_short": ed(anim, lambda d: _set(d, _at(d, b"stsz") + 8,
                                              struct.pack(">I", 3))),
        "tkhd_zero_width": ed(anim, lambda d: _set(
            d, _at(d, b"tkhd") + 88, bytes(4))),
        "sample_past_end": ed(anim, lambda d: d[:-1]),
    }


EDITS = sorted(_edits())


@pytest.mark.parametrize("case", EDITS)
def test_libavif_checks(case):
    """Edits of PIL's files aimed at libavif's parse (and Pillow's Exif
    load): the port's verdict is ``Image.open``'s, PIL's verdicts found by
    running Pillow 12.1.0 (and, behind them, libavif's results)."""
    data = _edits()[case]()
    _held(data, _pil_format(data))


# --- mutations ---------------------------------------------------------------

def mutation_counts(seed: int, count: int = 40) -> dict:
    """The generator's mutants and 4 cuts of each PIL-written file: the
    same verdict (AVIF, another format, or none), or not."""
    rng = np.random.RandomState(seed)
    counts = dict(avif=0, other=0, none=0, differ=0)
    for make in _pil_written().values():
        data = make()
        cuts = [data[:k] for k in rng.randint(0, len(data), 4)]
        for m in list(_mutants(data, rng, count)) + cuts:
            want = _pil_format(m)
            if _port_format(m) != want:
                counts["differ"] += 1
            else:
                counts["avif" if want == "AVIF" else
                       "none" if want is None else "other"] += 1
    return counts


@pytest.mark.parametrize("seed", [1, 2])
def test_mutations_identify_as_pil(seed):
    """Bytes set, deleted or cut off in PIL-written AVIFs: the port names,
    refuses or passes on each as ``Image.open`` does."""
    c = mutation_counts(seed, 12)
    assert c["differ"] == 0, c
    assert c["avif"] > 5 and c["none"] > 5, c


def _fuzz(argv) -> int:
    """``--fuzz A-B``: the mutation counts over seeds A..B."""
    lo, hi = (int(v) for v in argv[argv.index("--fuzz") + 1].split("-"))
    total = {}
    for seed in range(lo, hi + 1):
        for k, v in mutation_counts(seed).items():
            total[k] = total.get(k, 0) + v
    print(f"avif: seeds {lo}-{hi}, {sum(total.values())} files: {total}",
          flush=True)
    return 0


# --- the card ----------------------------------------------------------------

@pytest.mark.cuda
def test_avif_verdicts_on_cuda():
    """Phase 27c where the card is (no PIL there): each committed file
    named, refused or passed on as the recorded verdicts say."""
    import torch

    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the phase runs where the card is")
    for name, e in sorted(_verdicts().items()):
        with open(os.path.join(AVIF, e["file"]), "rb") as f:
            data = f.read()
        assert hashlib.sha256(data).hexdigest() == e["sha256"], name
        assert _port_format(data) == e["pil"], name


if __name__ == "__main__":
    sys.exit(_fuzz(sys.argv))
