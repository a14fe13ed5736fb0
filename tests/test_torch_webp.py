"""WebP against the JAX package on the CPU: files written by PIL (and, for
the containers PIL does not write, by the WebP writers of
tools/torch_image_fixtures.py) from seeded data; the port's ``load_image``
must be bitwise the JAX package's (PIL's ``convert("RGB")`` / 255), and
the port's RGBA canvas (utils/webp.py ``decode_webp_rgba``) bitwise PIL's
``convert("RGBA")``, on every case; where PIL cannot open or load the
bytes, the port raises ValueError naming the file. Lossless (VP8L) at
every method, several qualities, sizes and palettes; lossy (VP8) at four
qualities and three methods, sizes off the macroblock grid, with ALPH;
animations' first frames; VP8X with metadata and unknown chunks, RIFF
sizes that disagree with the file; OBJ maps and a cube sky of WebP files
through both packages' loaders."""

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
from gpupathtracer_tpu_torch.utils.webp import decode_webp_rgba
from test_torch_image_formats import W
from test_torch_images import _hold_atlas, _photo, _textured_obj


@pytest.fixture(scope="module")
def folder(tmp_path_factory):
    return tmp_path_factory.mktemp("webp")


def _webp(img, **kw) -> bytes:
    """PIL's WebP encoding of an array (RGB or RGBA) or an Image."""
    buf = _bio.BytesIO()
    if isinstance(img, np.ndarray):
        img = Image.fromarray(img)
    img.save(buf, "WEBP", **kw)
    return buf.getvalue()


def _rgba(h, w, seed, zero_every=3):
    """A photo with a seeded alpha plane, every ``zero_every``-th row fully
    transparent (where an exact encoder keeps the RGB)."""
    a = np.random.RandomState(seed).randint(0, 256, (h, w)).astype(np.uint8)
    a[::zero_every] = 0
    return np.concatenate([_photo(h, w, seed), a[..., None]], -1)


def _hold(folder, name: str, data: bytes, pil_reads=True):
    """load_image bitwise the JAX package's and the port's RGBA canvas
    bitwise PIL's (PIL reads the file), or both fail and the port's error
    is ValueError naming the file."""
    path = os.path.join(str(folder), name)
    with open(path, "wb") as f:
        f.write(data)
    assert identify(data) == "WEBP"
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
    rgba = np.asarray(Image.open(path).convert("RGBA"))
    assert decode_webp_rgba(data, name).tobytes() == rgba.tobytes(), name
    return got


# --- lossless (VP8L) ---------------------------------------------------------

@pytest.mark.parametrize("h,w", [(1, 1), (1, 37), (29, 1), (17, 33),
                                 (256, 256)])
def test_lossless_sizes(folder, h, w):
    """1x1, a row, a column, odd sizes and 256x256, PIL's default method."""
    _hold(folder, f"ll_{h}x{w}.webp", _webp(_photo(h, w, h * w + 1),
                                            lossless=True))


@pytest.mark.parametrize("quality", [0, 50, 100])
@pytest.mark.parametrize("method", range(7))
def test_lossless_methods(folder, method, quality):
    """Every method at three qualities (efforts): the transforms, cache
    sizes and meta prefix codes the encoder picks on its way."""
    _hold(folder, f"ll_m{method}_q{quality}.webp", _webp(
        _photo(40, 45, method * 10 + quality), lossless=True, method=method,
        quality=quality))


@pytest.mark.parametrize("colours", [2, 4, 16, 256])
def test_lossless_palettes(folder, colours):
    """Colour indexing: 2, 4 and 16 colours bundle 8, 4 and 2 pixels a
    byte; 256 colours take a whole green byte."""
    img = Image.fromarray(_photo(37, 51, colours)).quantize(
        colours, dither=Image.Dither.NONE).convert("RGB")
    _hold(folder, f"ll_p{colours}.webp", _webp(img, lossless=True,
                                               method=colours % 7))


@pytest.mark.parametrize("method", [0, 6])
def test_lossless_rgba_exact(folder, method):
    """RGBA with exact=True keeps the RGB under alpha 0 bitwise: the RGB of
    a still image is the frame's RGB."""
    _hold(folder, f"ll_rgba_m{method}.webp", _webp(
        _rgba(33, 27, method), lossless=True, exact=True, method=method))


# --- lossy (VP8) -------------------------------------------------------------

@pytest.mark.parametrize("method", [0, 4, 6])
@pytest.mark.parametrize("quality", [0, 25, 75, 100])
def test_lossy_quality_and_method(folder, quality, method):
    """Four qualities by three methods on 67x81: segments, skip flags, the
    normal loop filter at the levels the encoder picks, every intra mode
    it tries, then libwebp's fancy upsampling and YUV -> RGB."""
    _hold(folder, f"ly_q{quality}_m{method}.webp", _webp(
        _photo(67, 81, quality + method), quality=quality, method=method))


@pytest.mark.parametrize("h,w", [(1, 1), (17, 33), (255, 3)])
def test_lossy_sizes_off_the_grid(folder, h, w):
    """Sizes that are not multiples of 16 (the macroblocks past the edge
    are decoded and filtered, then cropped; odd widths and heights end
    the chroma upsampling on a half pair)."""
    _hold(folder, f"ly_{h}x{w}.webp", _webp(_photo(h, w, h + w),
                                            quality=80))


@pytest.mark.parametrize("alpha_quality", [100, 30])
def test_lossy_rgba(folder, alpha_quality):
    """Lossy RGBA: VP8X with ALPH, lossless-compressed alpha (filtered,
    and quantized levels at alpha_quality 30); the alpha plane is held to
    PIL's too."""
    data = _webp(_rgba(45, 38, alpha_quality), quality=70,
                 alpha_quality=alpha_quality)
    assert b"VP8X" in data and b"ALPH" in data
    _hold(folder, f"ly_rgba_a{alpha_quality}.webp", data)


def test_alph_raw_and_every_filter(folder):
    """ALPH chunks PIL's options do not write: raw alpha under each of the
    four filters (none, horizontal, vertical, gradient), and the
    pre-processing bit, read and ignored."""
    rgb = _photo(21, 19, 5)
    alpha = np.random.RandomState(6).randint(0, 256, (21, 19)).astype(
        np.uint8)
    vp8 = dict(W.webp_chunks(_webp(rgb, quality=60)))[b"VP8 "]
    for filt in range(4):
        filtered = alpha.astype(np.int32)
        if filt == 1:
            filtered[:, 1:] -= alpha[:, :-1]
            filtered[1:, 0] -= alpha[:-1, 0]
        elif filt == 2:
            filtered[1:] -= alpha[:-1]
            filtered[0, 1:] -= alpha[0, :-1]
        elif filt == 3:
            a = alpha.astype(np.int32)
            pred = np.clip(a[1:, :-1] + a[:-1, 1:] - a[:-1, :-1], 0, 255)
            filtered[1:, 1:] -= pred
            filtered[1:, 0] -= a[:-1, 0]
            filtered[0, 1:] -= a[0, :-1]
        header = bytes([filt << 2 | (16 if filt == 3 else 0)])
        body = header + (filtered & 0xFF).astype(np.uint8).tobytes()
        data = W.webp_riff(W.webp_vp8x(0x10, 19, 21)
                           + W.webp_chunk(b"ALPH", body)
                           + W.webp_chunk(b"VP8 ", vp8))
        _hold(folder, f"alph_f{filt}.webp", data)
        got = decode_webp_rgba(data)
        assert got[..., 3].tobytes() == alpha.tobytes()


@pytest.mark.parametrize("seed", range(24))
def test_seeded_sweep(folder, seed):
    """Seeded sizes (1-160 a side), lossless or lossy, method, quality,
    alpha and exactness, and image content (a photo, or a few colours)."""
    rng = np.random.RandomState(1000 + seed)
    h, w = rng.randint(1, 161, 2)
    img = _rgba(h, w, seed) if rng.rand() < 0.4 else _photo(h, w, seed)
    if rng.rand() < 0.3:
        img = np.asarray(Image.fromarray(img).quantize(
            int(rng.choice([2, 3, 5, 9, 17, 70]))).convert(
                "RGBA" if img.shape[2] == 4 else "RGB"))
    kw = dict(method=int(rng.randint(0, 7)), quality=int(rng.randint(0, 101)))
    if rng.rand() < 0.5:
        kw.update(lossless=True, exact=bool(rng.rand() < 0.5))
    elif img.shape[2] == 4:
        kw.update(alpha_quality=int(rng.randint(0, 101)))
    _hold(folder, f"sweep{seed}.webp", _webp(img, **kw))


# Settings of libwebp's advanced encoder that PIL's options do not reach
# (WebPConfig fields; eight token partitions need a method of 0-2).
ENCODER = {
    "simple_filter": dict(filter_type=0, filter_strength=50),
    "simple_sharp": dict(filter_type=0, filter_strength=90,
                         filter_sharpness=6, quality=30.0),
    "normal_sharp": dict(filter_type=1, filter_strength=80,
                         filter_sharpness=7),
    "parts2": dict(partitions=1, method=2),
    "parts4_simple": dict(partitions=2, method=1, filter_type=0),
    "parts8": dict(partitions=3, method=0, segments=1),
    "one_segment_no_sns": dict(segments=1, sns_strength=0, quality=90.0),
    "autofilter_sharp_yuv": dict(autofilter=1, use_sharp_yuv=1,
                                 preprocessing=2),
}


@pytest.mark.parametrize("case", sorted(ENCODER))
def test_libwebp_encoder_settings(folder, case):
    """The simple loop filter, sharpness, 2, 4 and 8 token partitions, one
    segment, the encoder's auto filter on a 90x75 image."""
    data = W.libwebp_encode(_photo(75, 90, len(case)), **ENCODER[case])
    _hold(folder, f"enc_{case}.webp", data)


# --- animations --------------------------------------------------------------

def test_animation_first_frame(folder):
    """PIL's animation encoder (three frames, the later ones sub-frames):
    the first frame's canvas."""
    frames = [Image.fromarray(_photo(40, 50, k)) for k in range(3)]
    buf = _bio.BytesIO()
    frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                   duration=80, quality=70)
    _hold(folder, "anim.webp", buf.getvalue())


def test_animation_mixed_frames(folder):
    """Lossy and lossless frames mixed (allow_mixed), RGBA frames among
    them, and a lossless animation."""
    frames = [Image.fromarray(_photo(36, 44, 10 + k)) for k in range(2)]
    frames.append(Image.fromarray(_rgba(36, 44, 12)))
    for mixed in (True, False):
        buf = _bio.BytesIO()
        frames[0].save(buf, "WEBP", save_all=True, append_images=frames[1:],
                       duration=50, allow_mixed=mixed, lossless=not mixed,
                       minimize_size=True)
        _hold(folder, f"anim_mixed{int(mixed)}.webp", buf.getvalue())


@pytest.mark.parametrize("lossless", [False, True])
def test_animation_first_frame_at_an_offset(folder, lossless):
    """A first frame smaller than the canvas at an offset: PIL's canvas is
    black (and transparent) around it; a lossy RGBA frame with its ALPH,
    or a lossless one, then a whole-canvas frame."""
    first = _webp(_rgba(30, 26, 7), quality=60, lossless=lossless)
    second = _webp(_photo(48, 40, 8), quality=60)
    data = W.write_webp_anim((40, 48), [(6, 10, first, 70, 0),
                                        (0, 0, second, 70, 2)])
    got = _hold(folder, f"anim_off{int(lossless)}.webp", data)
    assert not got[:10].any() and not got[:, :6].any()
    assert got[10:40, 6:32].any()


# --- containers --------------------------------------------------------------

def test_vp8x_with_metadata(folder):
    """VP8X with ICC, EXIF and XMP chunks (PIL's writer), lossy and
    lossless: skipped, the image read."""
    rgb = _photo(23, 31, 30)
    meta = dict(icc_profile=b"\0" * 128, exif=b"Exif\0\0II*\0" + b"\0" * 8,
                xmp=b"<x:xmpmeta xmlns:x='adobe:ns:meta/'/>")
    for lossless in (False, True):
        data = _webp(rgb, lossless=lossless, **meta)
        tags = [t for t, _ in W.webp_chunks(data)]
        assert tags[0] == b"VP8X" and {b"ICCP", b"EXIF", b"XMP "} <= set(tags)
        _hold(folder, f"meta{int(lossless)}.webp", data)


def test_unknown_chunks(folder):
    """An unknown chunk (odd-sized: padded) after the image of a simple
    file and before the image of an extended one; an ALPH chunk that
    VP8X's flags do not announce is dropped, not decoded."""
    rgb = _photo(18, 22, 31)
    chunks = W.webp_chunks(_webp(rgb, quality=75))
    vp8 = W.webp_chunk(b"VP8 ", chunks[0][1])
    odd = W.webp_chunk(b"ZZZZ", b"abc")
    _hold(folder, "unknown_after.webp", W.webp_riff(vp8 + odd))
    _hold(folder, "unknown_before.webp", W.webp_riff(
        W.webp_vp8x(0, 22, 18) + odd + vp8))
    junk_alpha = W.webp_chunk(b"ALPH", b"\xff\x01")
    _hold(folder, "unflagged_alph.webp", W.webp_riff(
        W.webp_vp8x(0, 22, 18) + junk_alpha + vp8))
    _hold(folder, "flagged_bad_alph.webp", W.webp_riff(
        W.webp_vp8x(0x10, 22, 18) + junk_alpha + vp8), pil_reads=False)


@pytest.mark.parametrize("case", ["truncated", "riff_short", "riff_long",
                                  "riff_odd_tail", "trailing_bytes",
                                  "reserved_flag", "frame_too_big"])
def test_containers_pil_refuses_or_reads(folder, case):
    """A truncated file, a RIFF size shorter than the file (the tail is
    never read) or longer (truncated for libwebp), a short tail inside
    the RIFF after the last chunk, bytes after the RIFF, a reserved VP8X
    flag, a frame larger than its VP8X canvas: bitwise PIL's, or
    ValueError where PIL raises."""
    rgb = _photo(20, 24, 32)
    data = _webp(rgb, lossless=True)
    riff = struct.unpack_from("<I", data, 4)[0]
    pil_reads = True
    if case == "truncated":
        data, pil_reads = data[:len(data) - 7], False
    elif case == "riff_short":
        data = W.webp_riff(data[12:] + W.webp_chunk(b"ZZZZ", b"x" * 10),
                           riff_size=riff)
    elif case == "riff_long":
        data, pil_reads = W.webp_riff(data[12:], riff_size=riff + 6), False
    elif case == "riff_odd_tail":
        data, pil_reads = W.webp_riff(data[12:] + b"\0\0\0\0"), False
    elif case == "trailing_bytes":
        data = data + b"\0" * 5
    elif case == "reserved_flag":
        vp8l = W.webp_chunk(b"VP8L", W.webp_chunks(data)[0][1])
        data, pil_reads = W.webp_riff(W.webp_vp8x(0x01, 24, 20) + vp8l), False
    else:
        vp8l = W.webp_chunk(b"VP8L", W.webp_chunks(data)[0][1])
        data, pil_reads = W.webp_riff(W.webp_vp8x(0, 23, 20) + vp8l), False
    _hold(folder, f"c_{case}.webp", data, pil_reads=pil_reads)


# --- scenes ------------------------------------------------------------------

def _webp_maps(folder):
    """Maps of each WebP kind (name -> bytes) beside a PNG."""
    px = {i: _photo(16 + 4 * i, 12 + 4 * i, 60 + i) for i in range(5)}
    out = {"a.webp": _webp(px[0], lossless=True),
           "b.webp": _webp(px[1], quality=70),
           "c.webp": _webp(_rgba(20, 16, 62), quality=80, alpha_quality=50),
           "d.webp": W.write_webp_anim((24, 28), [
               (2, 4, _webp(px[3][:16, :20], quality=60), 40, 0),
               (0, 0, _webp(px[3], lossless=True), 40, 0)])}
    for name, data in out.items():
        with open(os.path.join(str(folder), name), "wb") as f:
            f.write(data)
    io.save_png(os.path.join(str(folder), "z.png"), _photo(8, 8, 69))
    return sorted(out) + ["z.png"]


@pytest.mark.parametrize("levels", [1, 4])
def test_obj_with_webp_maps(tmp_path, levels):
    """An OBJ whose map_Kd maps are lossless, lossy, lossy RGBA and
    animated WebP files and a PNG: build_atlas and load_scene's atlas
    tables and material rows bitwise JAX's."""
    maps = _webp_maps(tmp_path)
    got = textures.build_atlas(maps, str(tmp_path), mip_levels=levels)
    want = jax_textures.build_atlas(maps, str(tmp_path), mip_levels=levels)
    assert got[2] == want[2] and len(got[2]) == len(maps)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    _hold_atlas(dict(scene_path=_textured_obj(str(tmp_path), maps),
                     mip_levels=levels))


def test_cube_sky_of_webp_faces(tmp_path):
    """A .txt cube sky of six WebP faces (lossless, lossy, lossy RGBA):
    the environment image bitwise the JAX package's."""
    names = []
    for i in range(6):
        px = _photo(16, 16, 70 + i)
        if i % 3 == 0:
            data = _webp(px, lossless=True)
        elif i % 3 == 1:
            data = _webp(px, quality=50 + 10 * i)
        else:
            data = _webp(_rgba(16, 16, 70 + i), quality=60)
        name = f"face{i}.webp"
        (tmp_path / name).write_bytes(data)
        names.append(name)
    (tmp_path / "cube.txt").write_text("\n".join(names) + "\n")
    spec = str(tmp_path / "cube.txt")
    got = envmap.environment_image(spec)
    want = np.asarray(jax_envmap.load_environment(spec).image)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape
    assert got.tobytes() == want.tobytes()
