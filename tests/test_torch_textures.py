"""The port's textures against the JAX package on the CPU: its PNG decoder
against PIL (which the JAX package reads images with; the other decoders
are in tests/test_torch_images.py), the atlas builder,
atlas sampling (bilinear and trilinear), textured material instances, the
generated textured town, its scene tables and its renders (wavefront with
mips, reference at level 0, and the CLI with --mip-levels)."""

import math
import os
import struct
import zlib

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.models import materials as jmat
from gpupathtracer_tpu.ops import texture as jtex
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu.scene import samplegen as jax_samplegen
from gpupathtracer_tpu.scene import textures as jax_textures
from gpupathtracer_tpu.utils import io as jax_io
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.models import materials as tmat
from gpupathtracer_tpu_torch.ops import texture as ttex
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import load_scene, samplegen, textures
from gpupathtracer_tpu_torch.utils import io

# --- the PNG decoder --------------------------------------------------------

CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _chunk(tag, body):
    return (struct.pack(">I", len(body)) + tag + body
            + struct.pack(">I", zlib.crc32(tag + body) & 0xFFFFFFFF))


def _paeth(a, b, c):
    p = a + b - c
    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
    return a if pa <= pb and pa <= pc else (b if pb <= pc else c)


def _filter_row(ftype, row, prev, bpp):
    """PNG filter ``ftype`` (spec section 9) of one row of bytes."""
    out = bytearray(len(row))
    for x in range(len(row)):
        a = row[x - bpp] if x >= bpp else 0
        b = prev[x]
        c = prev[x - bpp] if x >= bpp else 0
        pred = (0, a, b, (a + b) >> 1, _paeth(a, b, c))[ftype]
        out[x] = (row[x] - pred) & 0xFF
    return bytes([ftype]) + bytes(out)


ADAM7 = ((0, 0, 8, 8), (4, 0, 8, 8), (0, 4, 4, 8), (2, 0, 4, 4),
         (0, 2, 2, 4), (1, 0, 2, 2), (0, 1, 1, 2))


def _pack_rows(pixels, depth):
    """[h, w, C] samples -> [h, stride] bytes: uint8 pixels at depth 8 or
    16 are the row bytes as given (16-bit samples big-endian pairs), uint16
    pixels at depth 16 are written big-endian, and 1-, 2- and 4-bit samples
    are packed most significant bits first."""
    h, w, c = pixels.shape
    if depth == 16 and pixels.dtype == np.uint16:
        return pixels.astype(">u2").view(np.uint8).reshape(h, w * c * 2)
    if depth >= 8:
        return pixels.reshape(h, w * c)
    per = 8 // depth
    vals = pixels.reshape(h, w * c).astype(np.uint8)
    vals = np.concatenate([vals, np.zeros((h, (-w * c) % per), np.uint8)], 1)
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return (vals.reshape(h, -1, per) << shifts).sum(-1).astype(np.uint8)


def encode_png(pixels, ctype, filters, depth=8, interlace=0, palette=None):
    """A PNG of ``pixels`` [H, W, C] (see _pack_rows for the sample
    layouts), row y filtered with ``filters[y % len(filters)]`` (PIL picks
    its own filters, so the test writes its files itself); interlace=1
    writes the seven Adam7 passes, each filtered from its own first row,
    the empty ones left out."""
    h, w = pixels.shape[:2]
    bpp = max(1, CHANNELS[ctype] * depth // 8)
    passes = ADAM7 if interlace else ((0, 0, 1, 1),)
    raw = b""
    for x0, y0, dx, dy in passes:
        sub = pixels[y0::dy, x0::dx]
        if sub.size == 0:
            continue
        rows = _pack_rows(sub, depth)
        prev = bytes(rows.shape[1])
        for y in range(rows.shape[0]):
            row = rows[y].tobytes()
            raw += _filter_row(filters[y % len(filters)], row, prev, bpp)
            prev = row
    png = b"\x89PNG\r\n\x1a\n" + _chunk(
        b"IHDR", struct.pack(">IIBBBBB", w, h, depth, ctype, 0, 0, interlace))
    if palette is not None:
        png += _chunk(b"PLTE", palette.tobytes())
    # The image data split over two IDAT chunks, as encoders may.
    data = zlib.compress(raw, 9)
    half = len(data) // 2
    return (png + _chunk(b"IDAT", data[:half]) + _chunk(b"IDAT", data[half:])
            + _chunk(b"IEND", b""))


def _pixels(ctype, seed):
    rng = np.random.RandomState(seed)
    h, w = 13, 11
    if ctype == 3:
        return rng.randint(0, 20, (h, w, 1)).astype(np.uint8)
    img = rng.randint(0, 256, (h, w, CHANNELS[ctype])).astype(np.uint8)
    img[4:8] = img[4:8] // 16 * 16          # runs, for the filters' sake
    return img


@pytest.mark.parametrize("ftype", [0, 1, 2, 3, 4])
@pytest.mark.parametrize("ctype", [0, 2, 3, 4, 6])
def test_png_decoder_matches_pil(tmp_path, ctype, ftype):
    """Grey, RGB, palette, grey + alpha and RGBA, each with every row under
    one filter and with the five filters mixed: load_image bitwise the JAX
    package's (PIL's convert("RGB") / 255)."""
    pixels = _pixels(ctype, 10 * ctype + ftype)
    palette = (np.random.RandomState(ctype).randint(0, 256, (20, 3))
               .astype(np.uint8) if ctype == 3 else None)
    for name, filters in (("one", [ftype]),
                          ("mixed", [ftype, 0, 1, 2, 3, 4])):
        path = str(tmp_path / f"{name}.png")
        with open(path, "wb") as f:
            f.write(encode_png(pixels, ctype, filters, palette=palette))
        got = io.load_image(path)
        want = jax_io.load_image(path)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape == (13, 11, 3)
        assert got.tobytes() == want.tobytes(), name


def test_png_decoder_reads_the_writer_and_pil(tmp_path):
    """The port's own PNGs and PIL's (its own filter choice, optimized)."""
    img = np.random.RandomState(1).rand(17, 23, 3).astype(np.float32)
    io.save_png(str(tmp_path / "w.png"), img)
    Image.fromarray((img * 255).astype(np.uint8)).save(
        str(tmp_path / "p.png"), optimize=True)
    for name in ("w.png", "p.png"):
        path = str(tmp_path / name)
        assert io.load_image(path).tobytes() == \
            jax_io.load_image(path).tobytes(), name


def test_unread_images_raise_and_name_the_file(tmp_path):
    """A JPEG, a 16-bit PNG and an interlaced PNG read bitwise as the JAX
    package reads them (PIL), also through the atlas builder; so do a CMYK
    JPEG and a GIF since the second image slice; an EXR, which no PIL
    plugin reads, raises ValueError naming the file and both atlas
    builders skip it, and so does DCT data under a lossless JPEG header
    (libjpeg refuses its scan); an arithmetic-coded JPEG reads bitwise
    since the fourth image slice, a PPM since the fifth; what stays unread
    (an XBM: ROADMAP.md C6) raises NotImplementedError naming the file,
    and build_atlas lets it through instead of skipping the map."""
    from test_torch_images import write_unread

    jpg = tmp_path / "a.jpg"
    Image.fromarray(np.zeros((4, 4, 3), np.uint8)).save(str(jpg))
    deep = tmp_path / "deep.png"
    deep.write_bytes(encode_png(np.zeros((4, 4, 6), np.uint8), 2, [0],
                                depth=16))
    laced = tmp_path / "laced.png"
    laced.write_bytes(encode_png(np.zeros((4, 4, 3), np.uint8), 2, [0],
                                 interlace=1))
    unread = write_unread(tmp_path)
    read = [jpg.name, deep.name, laced.name, "cmyk.jpg", "anim.gif",
            "arith.jpg", "photo.ppm"]
    for name in read:
        path = str(tmp_path / name)
        assert io.load_image(path).tobytes() == \
            jax_io.load_image(path).tobytes(), name
    skipped = ["sky.exr", "lossless.jpg"]
    got = textures.build_atlas(read + skipped, str(tmp_path))
    want = jax_textures.build_atlas(read + skipped, str(tmp_path))
    assert got[2] == want[2] and len(got[2]) == 7
    assert got[0].tobytes() == want[0].tobytes()
    for name in skipped:
        with pytest.raises(ValueError, match=name):
            io.load_image(unread[name])
    for name in ("photo.xbm",):
        with pytest.raises(NotImplementedError, match=name):
            io.load_image(unread[name])
        with pytest.raises(NotImplementedError, match=name):
            textures.build_atlas([name], str(tmp_path))


# --- the atlas ---------------------------------------------------------------

@pytest.fixture(scope="module")
def texture_dir(tmp_path_factory):
    """Maps of odd sizes (a pyramid level crops to even sides), a 1-pixel
    map, and a name with no file behind it."""
    td = tmp_path_factory.mktemp("maps")
    rng = np.random.RandomState(3)
    for name, (h, w) in (("a.png", (37, 53)), ("b.png", (16, 16)),
                         ("c.png", (5, 3)), ("d.png", (1, 1)),
                         ("e.png", (64, 24))):
        io.save_png(str(td / name), rng.rand(h, w, 3).astype(np.float32))
    return str(td), ["a.png", "b.png", "c.png", "d.png", "missing.png",
                     "e.png"]


@pytest.mark.parametrize("levels", [1, 4])
def test_build_atlas_matches_jax(texture_dir, levels):
    """Atlas image, rects, slots and mip table bitwise the JAX builder's
    (the shelf packing places every rect in the same order)."""
    base, paths = texture_dir
    got = textures.build_atlas(paths, base, mip_levels=levels)
    want = jax_textures.build_atlas(paths, base, mip_levels=levels)
    for g, w in zip(got[:2] + got[3:], want[:2] + want[3:]):
        assert g.dtype == w.dtype and g.shape == w.shape
        assert g.tobytes() == w.tobytes()
    assert got[2] == want[2] and "missing.png" not in got[2]
    assert got[3].shape == (5, levels)
    empty = textures.build_atlas([], base, mip_levels=levels)
    for g, w in zip(empty, jax_textures.build_atlas([], base,
                                                    mip_levels=levels)):
        assert (g == w) if isinstance(g, dict) else g.tobytes() == w.tobytes()


@pytest.fixture(scope="module")
def atlas4(texture_dir):
    base, paths = texture_dir
    return textures.build_atlas(paths, base, mip_levels=4)


def _lookups(seed, n=8192, slots=5, levels=4):
    rng = np.random.RandomState(seed)
    tex = rng.randint(-1, slots, n).astype(np.int32)
    uv = (rng.rand(n, 2) * 8 - 4).astype(np.float32)
    uv[:64] = np.round(uv[:64] * 4) / 4        # texel edges and corners
    lod = (rng.rand(n) * (levels + 1) - 0.5).astype(np.float32)
    return tex, uv, lod


def test_sample_atlas_bilinear_and_trilinear_bitwise(atlas4):
    """Against the JAX function jitted (XLA contracts the lerps and
    u * w - 0.5 into fused multiply-adds; the port writes them so):
    bitwise, bilinear and trilinear, with lod below 0 and past the last
    level, uv outside [0, 1) and on texel edges. Invalid slot ids are
    masked by the caller, as in the JAX package."""
    atlas, rects, _, mips = atlas4
    tex, uv, lod = _lookups(0)
    tex = np.maximum(tex, 0)
    jit = jax.jit(jtex.sample_atlas)
    args = (torch.from_numpy(atlas), torch.from_numpy(rects),
            torch.from_numpy(tex), torch.from_numpy(uv))
    got = ttex.sample_atlas(*args).numpy()
    want = np.asarray(jit(atlas, rects, tex, uv))
    assert got.tobytes() == want.tobytes()
    got = ttex.sample_atlas(*args, mips=torch.from_numpy(mips),
                            lod=torch.from_numpy(lod)).numpy()
    want = np.asarray(jit(atlas, rects, tex, uv, mips=mips, lod=lod))
    assert got.tobytes() == want.tobytes()
    assert np.ptp(got) > 0.5


def test_textured_material_instance_matches_jax(atlas4):
    """make_material_instance with albedo and metallic-roughness slots (and
    -1 for constants) at level 0 and trilinear, against the JAX function
    jitted. Albedo and emission are bitwise. Where a lerp's result feeds a
    multiply (the map's G and B scale roughness and metallic), XLA
    contracts it the other way round, fma(b, f, a * (1 - f)), and it
    contracts F0's mix into one multiply-add: measured 5.8e-7 relative on
    roughness and metallic, 1.1e-6 on roughness^2, 2.5e-7 on F0 (about 20%
    of lanes one ulp apart). Held: rtol 1e-6, 2e-6 on roughness^2."""
    atlas, rects, _, mips = atlas4
    tex, uv, lod = _lookups(1)
    n = tex.shape[0]
    rng = np.random.RandomState(2)
    rows = np.zeros((n, 16), np.float32)
    rows[:, 0:3] = rng.uniform(0, 1, (n, 3))
    rows[:, 3] = rng.uniform(0.05, 1.0, n)
    rows[:, 4] = rng.rand(n)
    rows[:, 8] = tex.view(np.float32)
    rows[:, 9] = rng.randint(-1, 5, n).astype(np.int32).view(np.float32)

    class Scene:
        atlas_image, atlas_rects, atlas_mips = (torch.from_numpy(atlas),
                                                torch.from_numpy(rects),
                                                torch.from_numpy(mips))

    class JaxScene:
        atlas_image, atlas_rects, atlas_mips = (jnp.asarray(atlas),
                                                jnp.asarray(rects),
                                                jnp.asarray(mips))

    for with_lod in (False, True):
        want = jax.jit(lambda r, u, l: jmat.make_material_instance(
            JaxScene, None, u, True, row=r, lod=l))(
                rows, uv, lod if with_lod else None)
        got = tmat.make_material_instance(
            torch.from_numpy(rows), Scene, torch.from_numpy(uv),
            torch.from_numpy(lod) if with_lod else None)
        for field in ("albedo", "emission"):
            assert getattr(got, field).numpy().tobytes() == \
                np.asarray(getattr(want, field)).tobytes(), field
        for field, rtol in (("roughness", 1e-6), ("metallic", 1e-6),
                            ("reflectance", 1e-6), ("roughness2", 2e-6)):
            np.testing.assert_allclose(getattr(got, field).numpy(),
                                       np.asarray(getattr(want, field)),
                                       rtol=rtol, err_msg=field)
        assert not np.array_equal(got.albedo.numpy(), rows[:, 0:3])


# --- the textured town ------------------------------------------------------

TOWN = dict(houses=3, trees=2, sphere_subdiv=2)


@pytest.fixture(scope="module")
def town(tmp_path_factory):
    port = samplegen.generate_textured_town(
        str(tmp_path_factory.mktemp("town")), **TOWN)
    jax_town = jax_samplegen.generate_textured_town(
        str(tmp_path_factory.mktemp("jax_town")), **TOWN)
    return port, jax_town


def test_generated_town_matches_jax(town):
    """The OBJ and MTL byte for byte, the PNGs pixel for pixel (the port
    writes them with its own encoder)."""
    port, jax_town = town
    pd, jd = os.path.dirname(port), os.path.dirname(jax_town)
    for name in ("town.obj", "town.mtl"):
        with open(os.path.join(pd, name), "rb") as a, \
                open(os.path.join(jd, name), "rb") as b:
            assert a.read() == b.read(), name
    for name in ("checker.png", "bricks.png", "roof.png", "foliage.png"):
        a = np.asarray(Image.open(os.path.join(pd, name)))
        b = np.asarray(Image.open(os.path.join(jd, name)))
        assert a.tobytes() == b.tobytes(), name


@pytest.mark.parametrize("levels", [1, 4])
def test_town_scene_tables_byte_equal(town, levels):
    """load_scene on the textured town: the shading, material, light and
    BVH tables, the atlas and the sun fields equal the JAX load_scene's
    byte for byte; the metadata agrees."""
    path = town[0]
    scene, meta = load_scene(RenderConfig(scene_path=path,
                                          mip_levels=levels), "cpu")
    jscene, jmeta = jax_load_scene(JaxRenderConfig(
        scene_path=path, mip_levels=levels, cache_enabled=False))
    for field in ("tri_shade", "mat_rows", "light_rows", "atlas_image",
                  "atlas_rects", "atlas_mips", "sun_dir", "sun_emission",
                  "sun_radius", "sun_max_dot"):
        got, want = getattr(scene, field).numpy(), np.asarray(
            getattr(jscene, field))
        assert got.dtype == want.dtype and got.shape == want.shape, field
        assert got.tobytes() == want.tobytes(), field
    assert scene.node_rows.numpy().tobytes() == \
        np.asarray(jscene.bvh.node_rows).tobytes()
    for attr in ("num_triangles", "num_materials", "num_lights",
                 "has_textures", "mip_levels", "has_delta"):
        assert getattr(meta, attr) == getattr(jmeta, attr), attr
    assert meta.has_textures and meta.mip_levels == levels


def _outside(img, ref, tol=2e-3):
    """Pixels with a channel outside rtol = atol = tol of the reference."""
    return (np.abs(img - ref) > tol + tol * np.abs(ref)).any(-1)


def _town_cfg(path, **kw):
    cfg = RenderConfig(scene_path=path, skybox="GENERATE COLOR BLACK",
                       width=24, height=24, max_bounces=4, **kw)
    cfg.camera = CameraConfig(position=(0.0, 9.0, -26.0), yaw=math.pi,
                              pitch=-0.28, fov=math.radians(55), aspect=1.0)
    return cfg


@pytest.mark.parametrize("integrator", ["wavefront", "reference"])
def test_town_renders_match_jax(town, integrator):
    """The town at 24x24, 4 bounces, two frames, mip_levels=4: the
    wavefront samples both maps trilinearly at its ray-cone level, the
    reference at level 0. Measured: 0 pixels outside rtol = atol = 2e-3,
    max |diff| 1.2e-5 (wavefront: log2 and the lobes' transcendentals) and
    1.9e-6 (reference), ray counts equal. Held: at most 1% of pixels
    outside, the means within 0.5%, the ray counts equal."""
    cfg = _town_cfg(town[0], mip_levels=4)
    jr = JaxRenderer(JaxRenderConfig.from_json(cfg.to_json()))
    r = Renderer(cfg, "cpu")
    assert r.meta.has_textures and r.meta.mip_levels == 4 and not r.use_mega
    for _ in range(2):
        jr.render_frame(integrator)
        r.render_frame(integrator)
    got, want = r.film_hdr(), np.asarray(jr.film_hdr())
    assert np.isfinite(got).all() and got.max() > 0
    assert _outside(got, want).mean() <= 0.01
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)),
                               rtol=5e-3)
    jr.stats.finalize()
    r.stats.finalize()
    assert r.stats.rays_traced == jr.stats.rays_traced


def test_cli_takes_mip_levels(town, tmp_path):
    """--mip-levels reaches the config, and the CLI renders the textured
    town with it (and the AO and reference integrators) on the CPU."""
    args = cli.parse_args([town[0], "--device", "cpu", "--mip-levels", "4"])
    assert cli.build_config(args).mip_levels == 4
    for integrator in ("wavefront", "reference", "ao"):
        hdr = tmp_path / f"{integrator}.npy"
        rc = cli.main([town[0], "--device", "cpu", "--spp", "1", "--width",
                       "16", "--height", "16", "--mip-levels", "4",
                       "--max-bounces", "2", "--integrator", integrator,
                       "--position", "0,9,-26", "--rotation",
                       f"{math.pi},-0.28",
                       "--out", str(tmp_path / f"{integrator}.png"),
                       "--hdr-out", str(hdr)])
        assert rc == 0
        film = np.load(hdr)
        assert film.shape == (16, 16, 3) and np.isfinite(film).all()
        assert film.max() > 0
