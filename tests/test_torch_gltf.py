"""The port's glTF ingest and image skies against the JAX package on the
CPU: load_gltf's meshes and materials byte for byte (.gltf with a data:
buffer, .gltf with a .bin, .glb, a PNG texture, transmission + ior, a node
hierarchy), the malformed-file error, merge_meshes, the demo glTF and its
scene tables; a JPEG texture's atlas byte for byte; PNG equirect and .txt
cubemap skies byte for byte, and the images the port's decoders do not
read (C6) raising with the file's name.
"""

import base64
import dataclasses
import json
import math
import os
import struct

import numpy as np
import pytest

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu.scene import envmap as jax_envmap
from gpupathtracer_tpu.scene import gltf as jax_gltf
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu.scene import mesh as jax_mesh
from gpupathtracer_tpu.scene import samplegen as jax_samplegen
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import envmap, gltf, load_scene, mesh
from gpupathtracer_tpu_torch.scene import samplegen
from gpupathtracer_tpu_torch.scene.materials import MATERIAL_REFRACTIVE
from gpupathtracer_tpu_torch.utils.io import save_png


def _quad_primitive(blob: bytearray, views, accessors, z: float):
    """Append a unit quad at depth z (positions, normals, uvs, u16
    indices) to the buffer; returns its attributes and indices accessor."""
    pos = np.asarray([[0, 0, z], [1, 0, z], [1, 1, z], [0, 1, z]], np.float32)
    nrm = np.tile(np.asarray([[0, 0, -1]], np.float32), (4, 1))
    uv = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
    idx = np.asarray([0, 1, 2, 0, 2, 3], np.uint16)
    out = []
    for arr, kind, ctype in ((pos, "VEC3", 5126), (nrm, "VEC3", 5126),
                             (uv, "VEC2", 5126), (idx, "SCALAR", 5123)):
        raw = arr.tobytes()
        views.append({"buffer": 0, "byteOffset": len(blob),
                      "byteLength": len(raw)})
        blob += raw + b"\0" * ((-len(raw)) % 4)
        accessors.append({"bufferView": len(views) - 1,
                          "componentType": ctype, "count": int(len(arr)),
                          "type": kind})
        out.append(len(accessors) - 1)
    return {"POSITION": out[0], "NORMAL": out[1], "TEXCOORD_0": out[2]}, out[3]


def _document(texture_uri="albedo.png"):
    """Four quads on a node hierarchy (translation, rotation, scale and a
    matrix), one without a material; a textured material (a file PNG and a
    metallic-roughness map), a data: image that is skipped, a glass one
    (KHR_materials_transmission 1, KHR_materials_ior 1.33), an emissive
    one. Returns (gltf dict without buffer uri, blob)."""
    blob, views, accessors = bytearray(), [], []
    prims = [_quad_primitive(blob, views, accessors, z) for z in range(4)]
    meshes = [{"primitives": [{"attributes": a, "indices": i,
                               "material": m}]}
              for (a, i), m in zip(prims, (0, 1, 2, None))]
    del meshes[3]["primitives"][0]["material"]
    s = math.sqrt(0.5)
    return {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": [0, 3]}],
        "nodes": [
            {"mesh": 0, "translation": [1, 2, 3], "children": [1, 2],
             "scale": [2, 2, 2]},
            {"mesh": 1, "rotation": [0, s, 0, s]},
            {"mesh": 2, "matrix": [1, 0, 0, 0, 0, 0, 1, 0, 0, -1, 0, 0,
                                   0.5, 0, 0, 1]},
            {"mesh": 3}],
        "meshes": meshes,
        "materials": [
            {"name": "tex", "pbrMetallicRoughness": {
                "baseColorTexture": {"index": 0},
                "metallicRoughnessTexture": {"index": 1},
                "metallicFactor": 0.3, "roughnessFactor": 0.6}},
            {"name": "glass", "pbrMetallicRoughness": {
                "baseColorFactor": [0.9, 0.95, 1.0, 1.0],
                "baseColorTexture": {"index": 2}},
             "extensions": {"KHR_materials_transmission":
                            {"transmissionFactor": 1.0},
                            "KHR_materials_ior": {"ior": 1.33}}},
            {"name": "lamp", "emissiveFactor": [1.0, 0.5, 0.25],
             "extensions": {"KHR_materials_emissive_strength":
                            {"emissiveStrength": 6.0}}}],
        "textures": [{"source": 0}, {"source": 1}, {"source": 2}],
        "images": [{"uri": texture_uri}, {"uri": "mr.png"},
                   {"uri": "data:image/png;base64,AAAA"}],
        "buffers": [{"byteLength": len(blob)}],
        "bufferViews": views, "accessors": accessors,
    }, bytes(blob)


def _write_maps(folder):
    rng = np.random.RandomState(2)
    save_png(os.path.join(folder, "albedo.png"),
             rng.uniform(0, 1, (8, 8, 3)).astype(np.float32))
    save_png(os.path.join(folder, "mr.png"),
             rng.uniform(0, 1, (4, 4, 3)).astype(np.float32))


def _write(folder, kind, **doc_kw):
    doc, blob = _document(**doc_kw)
    if kind == "data":
        doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                    + base64.b64encode(blob).decode())
        path = os.path.join(folder, "scene.gltf")
        with open(path, "w") as f:
            json.dump(doc, f)
    elif kind == "bin":
        doc["buffers"][0]["uri"] = "scene.bin"
        with open(os.path.join(folder, "scene.bin"), "wb") as f:
            f.write(blob)
        path = os.path.join(folder, "scene.gltf")
        with open(path, "w") as f:
            json.dump(doc, f)
    else:
        js = json.dumps(doc).encode()
        js += b" " * ((-len(js)) % 4)
        body = blob + b"\0" * ((-len(blob)) % 4)
        path = os.path.join(folder, "scene.glb")
        with open(path, "wb") as f:
            f.write(struct.pack("<III", 0x46546C67, 2, 28 + len(js)
                                + len(body)))
            f.write(struct.pack("<II", len(js), 0x4E4F534A) + js)
            f.write(struct.pack("<II", len(body), 0x004E4942) + body)
    return path


def _hold_loaded(got, want):
    """Meshes byte for byte; materials field for field."""
    (gm, gmats), (wm, wmats) = got, want
    for f in ("positions", "normals", "uvs", "mat_ids", "triangles"):
        g, w = getattr(gm, f), getattr(wm, f)
        assert g.dtype == w.dtype and g.shape == w.shape, f
        assert g.tobytes() == w.tobytes(), f
    assert [dataclasses.asdict(m) for m in gmats] == \
        [dataclasses.asdict(m) for m in wmats]


@pytest.mark.parametrize("kind", ["data", "bin", "glb"])
def test_load_gltf_matches_jax(tmp_path, kind):
    _write_maps(tmp_path)
    path = _write(str(tmp_path), kind)
    got = gltf.load_gltf(path)
    _hold_loaded(got, jax_gltf.load_gltf(path))
    m, mats = got
    assert m.triangles.shape == (8, 3)
    names = [x.name for x in mats]
    assert names == ["__env__", "tex", "glass", "lamp", "__default__"]
    assert mats[1].albedo_texture == "albedo.png"
    assert mats[1].mr_texture == "mr.png"
    assert mats[2].material_type == MATERIAL_REFRACTIVE
    assert mats[2].ior == pytest.approx(1.33)
    assert mats[2].albedo_texture is None     # its data: image is skipped
    assert mats[3].emission == (6.0, 3.0, 1.5)


def test_gltf_scene_tables_and_film_match_jax(tmp_path):
    """The textured and glass glTF through load_scene: every table byte for
    byte (the atlas of its PNG maps too), has_delta and has_textures set;
    then two frames through both Renderers (measured: the channel means
    equal, the ray counts equal), held as tests/test_torch_render.py holds
    the wavefront."""
    _write_maps(tmp_path)
    path = _write(str(tmp_path), "glb")
    cfg = RenderConfig(scene_path=path, skybox="GENERATE COLOR WHITE",
                       width=16, height=16, max_bounces=4)
    cfg.camera = CameraConfig(position=(2.0, 1.5, -6.0), yaw=math.pi,
                              fov=math.radians(60), aspect=1.0)
    scene, meta = load_scene(cfg, "cpu")
    jscene, jmeta = jax_load_scene(JaxRenderConfig.from_json(cfg.to_json()))
    assert meta.has_delta and jmeta.has_delta and meta.has_textures
    for f in ("tri_shade", "light_rows", "light_cdf", "mat_rows",
              "atlas_image", "atlas_rects", "atlas_mips"):
        assert getattr(scene, f).numpy().tobytes() == \
            np.asarray(getattr(jscene, f)).tobytes(), f
    assert scene.node_rows.numpy().tobytes() == \
        np.asarray(jscene.bvh.node_rows).tobytes()
    r = Renderer(cfg, "cpu", scene=scene, meta=meta)
    jr = JaxRenderer(JaxRenderConfig.from_json(cfg.to_json()), scene=jscene,
                     meta=jmeta)
    for _ in range(2):
        r.render_frame()
        jr.render_frame()
    got, want = r.film_hdr(), np.asarray(jr.film_hdr())
    assert np.isfinite(got).all() and got.max() > 0
    outside = (np.abs(got - want) > 2e-3 + 2e-3 * np.abs(want)).any(-1)
    assert outside.mean() <= 0.01
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)),
                               rtol=5e-3)
    r.stats.finalize()
    jr.stats.finalize()
    assert r.stats.rays_traced == jr.stats.rays_traced


def test_gltf_jpeg_texture_raises(tmp_path):
    """C6, now read: a JPEG base-colour map goes through load_scene into the
    same atlas, rects, mips and material rows as the JAX package's (PIL);
    a header with nothing behind it raises ValueError naming the file and
    is skipped by both packages; a CMYK JPEG map (four components, read
    since the second image slice) gives the JAX package's tables too."""
    from test_torch_images import write_unread

    from gpupathtracer_tpu_torch.utils.io import load_image

    _write_maps(tmp_path)
    rng = np.random.RandomState(4)
    from PIL import Image
    Image.fromarray(rng.randint(0, 256, (12, 20, 3)).astype(np.uint8)).save(
        str(tmp_path / "albedo.jpg"), quality=80)
    path = _write(str(tmp_path), "data", texture_uri="albedo.jpg")
    scene, meta = load_scene(RenderConfig(scene_path=path), "cpu")
    jscene, _ = jax_load_scene(JaxRenderConfig(scene_path=path))
    assert meta.has_textures
    for f in ("atlas_image", "atlas_rects", "atlas_mips", "mat_rows"):
        assert getattr(scene, f).numpy().tobytes() == \
            np.asarray(getattr(jscene, f)).tobytes(), f
    bad = tmp_path / "bad.jpg"
    bad.write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 64)
    with pytest.raises(ValueError, match="bad.jpg"):
        load_image(str(bad))
    path = _write(str(tmp_path), "data", texture_uri="bad.jpg")
    scene, _ = load_scene(RenderConfig(scene_path=path), "cpu")
    jscene, _ = jax_load_scene(JaxRenderConfig(scene_path=path))
    for f in ("atlas_image", "atlas_rects", "atlas_mips", "mat_rows"):
        assert getattr(scene, f).numpy().tobytes() == \
            np.asarray(getattr(jscene, f)).tobytes(), f
    write_unread(tmp_path)
    path = _write(str(tmp_path), "data", texture_uri="cmyk.jpg")
    scene, meta = load_scene(RenderConfig(scene_path=path), "cpu")
    jscene, _ = jax_load_scene(JaxRenderConfig(scene_path=path))
    assert meta.has_textures
    for f in ("atlas_image", "atlas_rects", "atlas_mips", "mat_rows"):
        assert getattr(scene, f).numpy().tobytes() == \
            np.asarray(getattr(jscene, f)).tobytes(), f


def test_demo_gltf_matches_jax(tmp_path):
    """write_demo_gltf writes the JAX package's file byte for byte, and
    load_scene builds the same tables from it; the CLI renders it."""
    got = samplegen.write_demo_gltf(str(tmp_path / "demo.gltf"))
    want = jax_samplegen.write_demo_gltf(str(tmp_path / "jdemo.gltf"))
    with open(got, "rb") as f, open(want, "rb") as g:
        assert f.read() == g.read()
    _hold_loaded(gltf.load_gltf(got), jax_gltf.load_gltf(got))
    scene, meta = load_scene(RenderConfig(scene_path=got), "cpu")
    jscene, jmeta = jax_load_scene(JaxRenderConfig(scene_path=got))
    for f in ("tri_shade", "light_rows", "light_cdf", "mat_rows"):
        assert getattr(scene, f).numpy().tobytes() == \
            np.asarray(getattr(jscene, f)).tobytes(), f
    assert scene.node_rows.numpy().tobytes() == \
        np.asarray(jscene.bvh.node_rows).tobytes()
    assert (meta.num_triangles, meta.num_lights) == (jmeta.num_triangles,
                                                     jmeta.num_lights)
    hdr = tmp_path / "demo.npy"
    assert cli.main([got, "--device", "cpu", "--spp", "1", "--width", "16",
                     "--height", "16", "--max-bounces", "2", "--position",
                     "0,2,-7", "--rotation", "3.14159,-0.2", "--out",
                     str(tmp_path / "demo.png"), "--hdr-out", str(hdr)]) == 0
    film = np.load(hdr)
    assert np.isfinite(film).all() and film.max() > 0


@pytest.mark.parametrize("case", ["not_json", "bad_magic", "no_meshes",
                                  "bad_accessor"])
def test_malformed_gltf_raises_value_error_with_path(tmp_path, case):
    """JAX's error wrapping: a ValueError whose message starts with the
    path, in both packages."""
    doc, blob = _document()
    doc["buffers"][0]["uri"] = ("data:application/octet-stream;base64,"
                                + base64.b64encode(blob).decode())
    path = str(tmp_path / ("s.glb" if case == "bad_magic" else "s.gltf"))
    if case == "not_json":
        body = b"{ not json"
    elif case == "bad_magic":
        body = struct.pack("<III", 0x12345678, 2, 12)
    elif case == "no_meshes":
        body = json.dumps(dict(doc, meshes=[], nodes=[],
                               scenes=[{"nodes": []}])).encode()
    else:
        doc["accessors"][0]["bufferView"] = 99
        body = json.dumps(doc).encode()
    with open(path, "wb") as f:
        f.write(body)
    for loader in (gltf.load_gltf, jax_gltf.load_gltf):
        with pytest.raises(ValueError) as exc:
            loader(path)
        assert str(exc.value).startswith(path)


def test_merge_meshes_matches_jax():
    rng = np.random.RandomState(4)
    parts = []
    for n in (3, 7, 5):
        parts.append(dict(
            positions=rng.normal(size=(n, 3)).astype(np.float32),
            normals=rng.normal(size=(n, 3)).astype(np.float32),
            uvs=rng.uniform(size=(n, 2)).astype(np.float32),
            mat_ids=rng.randint(0, 4, n).astype(np.int32),
            triangles=rng.randint(0, n, (n - 1, 3)).astype(np.int32)))
    got = mesh.merge_meshes([mesh.MeshData(**p) for p in parts])
    want = jax_mesh.merge_meshes([jax_mesh.MeshData(**p) for p in parts])
    _hold_loaded((got, []), (want, []))
    assert int(got.triangles.max()) < got.positions.shape[0]


# --- image skies ------------------------------------------------------------

def _faces(folder):
    """Six 8x8 PNG faces of distinct colours and a .txt list of them
    (tests/test_edge_cases.py::test_cubemap_face_list), plus a noisy face
    so the resampling is exercised off the axes."""
    colors = [(1, 0, 0), (0, 1, 0), (0, 0, 1), (1, 1, 0), (1, 0, 1), (0, 1, 1)]
    names = []
    rng = np.random.RandomState(6)
    for i, c in enumerate(colors):
        img = np.broadcast_to(np.asarray(c, np.float32), (8, 8, 3)).copy()
        if i == 4:
            img = rng.uniform(0, 1, (8, 8, 3)).astype(np.float32)
        names.append(f"face{i}.png")
        save_png(os.path.join(folder, names[-1]), img)
    with open(os.path.join(folder, "sky.txt"), "w") as f:
        f.write("\n".join(names) + "\n\nextra.png\n")
    return os.path.join(folder, "sky.txt"), colors


def test_png_equirect_and_cubemap_match_jax(tmp_path):
    rng = np.random.RandomState(5)
    sky = str(tmp_path / "sky.png")
    save_png(sky, rng.uniform(0, 1, (16, 32, 3)).astype(np.float32))
    txt, colors = _faces(str(tmp_path))
    for spec in (sky, txt):
        got = envmap.environment_image(spec)
        want = np.asarray(jax_envmap.load_environment(spec).image)
        assert got.dtype == want.dtype == np.float32
        assert got.shape == want.shape
        assert got.tobytes() == want.tobytes()
    # A relative spec is read from the scene's folder.
    assert envmap.environment_image("sky.png", str(tmp_path)).tobytes() == \
        envmap.environment_image(sky).tobytes()
    # The axis directions see their faces' colours (+X,-X,+Y,-Y,+Z,-Z).
    import torch
    env = envmap.EnvMap(image=torch.from_numpy(envmap.environment_image(txt)))
    d = torch.tensor([[1, 0, 0], [-1, 0, 0], [0, 1, 0], [0, -1, 0],
                      [0, 0, 1], [0, 0, -1]], dtype=torch.float32)
    out = envmap.sample_env(env, d).numpy()
    for i, c in enumerate(colors):
        if i != 4:
            assert np.argmax(out[i]) == np.argmax(c), (i, out[i], c)


def test_unread_skies_raise(tmp_path):
    """C6: a JPEG sky and JPEG cube faces are read now
    (tests/test_torch_images.py holds them to JAX's); a JPEG sky or face
    whose header has nothing behind it raises ValueError naming the file,
    as PIL raises on it; an EXR sky (no PIL plugin reads it) raises
    ValueError naming the file, as JAX's PIL raises; a CMYK JPEG sky and
    GIF cube faces read bitwise as the JAX package reads them; a missing
    file raises FileNotFoundError, as the JAX package's PIL loader does."""
    from test_torch_images import write_unread

    jpg = tmp_path / "sky.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 64)
    with pytest.raises(ValueError, match=str(jpg)):
        envmap.environment_image(str(jpg))
    (tmp_path / "faces.txt").write_text("sky.jpg\n" * 6)
    with pytest.raises(ValueError, match=str(jpg)):
        envmap.environment_image(str(tmp_path / "faces.txt"))
    unread = write_unread(tmp_path)
    with pytest.raises(ValueError, match=unread["sky.exr"]):
        envmap.environment_image(unread["sky.exr"])
    with pytest.raises(Exception):
        jax_envmap.load_environment(unread["sky.exr"])
    (tmp_path / "gif_faces.txt").write_text("anim.gif\n" * 6)
    for spec in (unread["cmyk.jpg"], str(tmp_path / "gif_faces.txt")):
        got = envmap.environment_image(spec)
        want = np.asarray(jax_envmap.load_environment(spec).image)
        assert got.dtype == want.dtype and got.shape == want.shape
        assert got.tobytes() == want.tobytes(), spec
    with pytest.raises(FileNotFoundError):
        envmap.environment_image(str(tmp_path / "missing.png"))
    with pytest.raises(FileNotFoundError):
        jax_envmap.load_environment(str(tmp_path / "missing.png"))


def test_cubemap_sky_renders_through_the_cli(tmp_path):
    txt, _ = _faces(str(tmp_path))
    hdr = tmp_path / "c.npy"
    assert cli.main(["proc:bunny", "--device", "cpu", "--spp", "1",
                     "--width", "16", "--height", "16", "--max-bounces", "2",
                     "--skybox", txt, "--out", str(tmp_path / "c.png"),
                     "--hdr-out", str(hdr)]) == 0
    film = np.load(hdr)
    assert np.isfinite(film).all() and film.max() > 0
