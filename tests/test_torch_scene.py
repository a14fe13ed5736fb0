"""Host ingest of the port against the JAX package: the device tables of
load_scene are byte-equal, and the numpy modules the port copies (mesh,
materials, procedural scenes, OBJ loader, Morton order, .hdr reader)
return what their originals return."""

import dataclasses
import os

import numpy as np
import pytest

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu.scene import envmap as jax_envmap
from gpupathtracer_tpu.scene import mesh as jax_mesh
from gpupathtracer_tpu.scene import objloader as jax_obj
from gpupathtracer_tpu.scene import procedural as jax_proc
from gpupathtracer_tpu.scene.materials import pack_materials as jax_pack
from gpupathtracer_tpu.utils import io as jax_io
from gpupathtracer_tpu.utils import morton as jax_morton
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.scene import load_scene, scene_from_numpy
from gpupathtracer_tpu_torch.scene import envmap, mesh, objloader, procedural
from gpupathtracer_tpu_torch.scene.materials import pack_materials
from gpupathtracer_tpu_torch.utils import io, morton

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_fields(scene):
    """The JAX SceneData's arrays the port carries, as numpy."""
    return dict(tri_shade=np.asarray(scene.tri_shade),
                light_rows=np.asarray(scene.light_rows),
                light_cdf=np.asarray(scene.light_cdf),
                total_light_area=np.asarray(scene.total_light_area),
                mat_rows=np.asarray(scene.mat_rows),
                env=np.asarray(scene.env.image),
                node_rows=np.asarray(scene.bvh.node_rows))


def _port_fields(scene):
    return dict(tri_shade=scene.tri_shade.numpy(),
                light_rows=scene.light_rows.numpy(),
                light_cdf=scene.light_cdf.numpy(),
                total_light_area=scene.total_light_area.numpy(),
                mat_rows=scene.mat_rows.numpy(),
                env=scene.env.image.numpy(),
                node_rows=scene.node_rows.numpy())


@pytest.mark.parametrize("name", ["cornell", "table", "bathroom"])
def test_load_scene_tables_byte_equal(name):
    jscene, jmeta = jax_load_scene(JaxRenderConfig(scene_path=f"proc:{name}"))
    scene, meta = load_scene(RenderConfig(scene_path=f"proc:{name}"), "cpu")
    want = _jax_fields(jscene)
    for field, got in _port_fields(scene).items():
        assert got.dtype == want[field].dtype, field
        assert got.shape == want[field].shape, field
        assert got.tobytes() == want[field].tobytes(), field
    for attr in ("num_triangles", "num_materials", "num_lights",
                 "stack_depth", "leaf_size", "has_delta"):
        assert getattr(meta, attr) == getattr(jmeta, attr), attr
    assert scene.cluster_rows is None and scene.cluster_refs is None
    # The JAX tables carried across give the same port SceneData.
    again = _port_fields(scene_from_numpy(want, "cpu"))
    for field, got in again.items():
        assert got.tobytes() == want[field].tobytes(), field


@pytest.mark.parametrize("name,tc", [("table", 128), ("table", 256),
                                     ("bathroom", 128)])
def test_cluster_scene_tables_byte_equal(name, tc):
    """cluster_tris > 0: the cluster top tree, the cluster blocks and their
    slot-to-triangle ids equal the JAX load_scene's byte for byte (two
    independent builds: the port's bvh/ copy and the JAX package's), and
    scene_from_numpy carries them across."""
    jscene, jmeta = jax_load_scene(JaxRenderConfig(scene_path=f"proc:{name}",
                                                   cluster_tris=tc))
    scene, meta = load_scene(RenderConfig(scene_path=f"proc:{name}",
                                          cluster_tris=tc), "cpu")
    want = dict(_jax_fields(jscene), **{
        f: np.asarray(getattr(jscene.bvh, f))
        for f in ("cluster_rows", "cluster_refs")})
    got = dict(_port_fields(scene), cluster_rows=scene.cluster_rows.numpy(),
               cluster_refs=scene.cluster_refs.numpy())
    for field, w in want.items():
        assert got[field].dtype == w.dtype, field
        assert got[field].shape == w.shape, field
        assert got[field].tobytes() == w.tobytes(), field
    assert want["cluster_rows"].shape[1] == 3 * tc
    assert meta.stack_depth == jmeta.stack_depth  # the full tree's
    again = scene_from_numpy(want, "cpu")
    assert again.cluster_rows.numpy().tobytes() == \
        want["cluster_rows"].tobytes()
    assert again.cluster_refs.numpy().tobytes() == \
        want["cluster_refs"].tobytes()


def _mesh_equal(a, b):
    for f in dataclasses.fields(a):
        np.testing.assert_array_equal(getattr(a, f.name), getattr(b, f.name))
        assert getattr(a, f.name).dtype == getattr(b, f.name).dtype


def _materials_equal(a, b):
    assert [dataclasses.asdict(m) for m in a] == \
        [dataclasses.asdict(m) for m in b]


def _soup_and_table_equal(mesh_a, mats_a, mesh_b, mats_b):
    for x, y in zip(mesh.build_triangle_soup(mesh_a),
                    jax_mesh.build_triangle_soup(mesh_b)):
        assert x.tobytes() == y.tobytes()
    for x, y in zip(pack_materials(mats_a), jax_pack(mats_b)):
        assert np.asarray(x).tobytes() == np.asarray(y).tobytes()


@pytest.mark.parametrize("name", sorted(procedural.PROCEDURAL_SCENES))
def test_procedural_scenes_match(name):
    m, mats = procedural.load_procedural(f"proc:{name}")
    jm, jmats = jax_proc.load_procedural(f"proc:{name}")
    _mesh_equal(m, jm)
    _materials_equal(mats, jmats)
    _soup_and_table_equal(m, mats, jm, jmats)
    assert procedural.default_camera(name) == jax_proc.default_camera(name)


def test_obj_loader_matches():
    path = os.path.join(REPO, "scenes", "demo.obj")
    m, mats = objloader.load_obj(path)
    jm, jmats = jax_obj.load_obj(path)
    _mesh_equal(m, jm)
    _materials_equal(mats, jmats)
    _soup_and_table_equal(m, mats, jm, jmats)


@pytest.mark.parametrize("kind", ["morton", "hilbert"])
def test_ray_order_matches(kind):
    for w, h in ((8, 8), (16, 8), (40, 24), (1920, 1080)):
        np.testing.assert_array_equal(morton.ray_order(w, h, kind),
                                      jax_morton.ray_order(w, h, kind))


def _write_hdr(path, rgbe, rle: bool):
    """A Radiance file: RLE scanlines (runs and literals) or flat ones."""
    h, w, _ = rgbe.shape
    out = bytearray(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
    out += f"-Y {h} +X {w}\n".encode()
    for y in range(h):
        if not rle:
            out += rgbe[y].tobytes()
            continue
        out += bytes([2, 2, w >> 8, w & 255])
        for c in range(4):
            row = rgbe[y, :, c]
            half = w // 2  # a run of one value, then literals
            out += bytes([128 + half, row[0]])
            out += bytes([w - half]) + row[half:].tobytes()
    with open(path, "wb") as f:
        f.write(bytes(out))


@pytest.mark.parametrize("rle", [True, False])
def test_load_hdr_and_environment_match(tmp_path, rle):
    rng = np.random.RandomState(3)
    w = 16 if rle else 4
    rgbe = rng.randint(0, 256, (5, w, 4)).astype(np.uint8)
    rgbe[:, : w // 2] = rgbe[:, :1]  # the run the RLE writer encodes
    rgbe[0, 0, 3] = 0                # a zero exponent is black
    path = str(tmp_path / "env.hdr")
    _write_hdr(path, rgbe, rle)
    got, want = io.load_hdr(path), jax_io.load_hdr(path)
    assert got.dtype == want.dtype == np.float32
    assert got.tobytes() == want.tobytes()
    env = envmap.environment_image(path)
    assert env.tobytes() == np.asarray(
        jax_envmap.load_environment(path).image).tobytes()


@pytest.mark.parametrize("spec", ["GENERATE COLOR WHITE",
                                  "GENERATE COLOR BLACK",
                                  "GENERATE COLOR 0.2 0.3 0.4",
                                  "GENERATE COLOR PURPLE",
                                  "GENERATE NOISE"])
def test_environment_specs_match(spec):
    got = envmap.environment_image(spec)
    want = np.asarray(jax_envmap.load_environment(spec).image)
    assert got.tobytes() == want.tobytes()


def test_unported_inputs_raise(tmp_path):
    # A JPEG sky whose header has nothing behind it: corrupt, ValueError
    # naming the file (JPEG skies read since C6's decoder); a
    # four-component (CMYK) JPEG sky reads bitwise as the JAX package's
    # since the second image slice; cube faces of a WebP header with no
    # frame behind it: ValueError naming the file since the WebP slice
    # (PIL cannot open it either); arithmetic-coded JPEG faces read
    # bitwise as the JAX package's since the fourth image slice, PPM
    # faces since the fifth, and faces of a format that stays unread
    # (XBM) raise NotImplementedError naming the file.
    from test_torch_images import write_unread

    jpg = tmp_path / "sky.jpg"
    jpg.write_bytes(b"\xff\xd8\xff\xe0" + b"\0" * 64)
    with pytest.raises(ValueError, match="sky.jpg"):
        envmap.environment_image(str(jpg))
    unread = write_unread(tmp_path)
    got = envmap.environment_image(unread["cmyk.jpg"])
    want = np.asarray(jax_envmap.load_environment(unread["cmyk.jpg"]).image)
    assert got.tobytes() == want.tobytes()
    (tmp_path / "webp_faces.txt").write_text("photo.webp\n" * 6)
    with pytest.raises(ValueError, match="photo.webp"):
        envmap.environment_image(str(tmp_path / "webp_faces.txt"))
    with pytest.raises(Exception):
        jax_envmap.load_environment(str(tmp_path / "webp_faces.txt"))
    (tmp_path / "arith_faces.txt").write_text("arith.jpg\n" * 6)
    spec = str(tmp_path / "arith_faces.txt")
    got = envmap.environment_image(spec)
    want = np.asarray(jax_envmap.load_environment(spec).image)
    assert got.tobytes() == want.tobytes()
    (tmp_path / "ppm_faces.txt").write_text("photo.ppm\n" * 6)
    spec = str(tmp_path / "ppm_faces.txt")
    got = envmap.environment_image(spec)
    want = np.asarray(jax_envmap.load_environment(spec).image)
    assert got.tobytes() == want.tobytes()
    (tmp_path / "xbm_faces.txt").write_text("photo.xbm\n" * 6)
    with pytest.raises(NotImplementedError, match="photo.xbm"):
        envmap.environment_image(str(tmp_path / "xbm_faces.txt"))
    # Node rows hold 2 to 16 children (wide_arity 16 loads since the
    # kernels take the table's arity).
    with pytest.raises(ValueError):
        load_scene(RenderConfig(scene_path="proc:cornell", wide_arity=17),
                   "cpu")
