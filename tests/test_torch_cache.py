"""The scene disk cache (scene/cache.py) against the JAX package's: the
same key for the same config (the port's copy of the C++ builder is byte
for byte the JAX package's, and the key hashes it), files read in either
direction, a cold and a warm ingest bitwise equal, a corrupt file rebuilt,
the film unchanged, and the CLI's cache on unless --no-cache."""

import dataclasses
import os

import numpy as np
import pytest
import torch

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.scene import cache as jax_cache
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import cache, load_scene, scenedata
from gpupathtracer_tpu_torch.scene.samplegen import generate_textured_town

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax(cfg):
    return JaxRenderConfig.from_json(cfg.to_json())


def _same_scene(a, b):
    """Every tensor field of two SceneData byte-equal, and their metas."""
    (sa, ma), (sb, mb) = a, b
    for f in sa._fields:
        x, y = getattr(sa, f), getattr(sb, f)
        if f == "env":
            x, y = x.image, y.image
        if isinstance(x, torch.Tensor):
            assert x.dtype == y.dtype and x.shape == y.shape, f
            assert x.numpy().tobytes() == y.numpy().tobytes(), f
        else:
            assert x == y, f
    for f in ("num_triangles", "num_materials", "num_lights", "stack_depth",
              "leaf_size", "has_textures", "has_delta", "mip_levels"):
        assert getattr(ma, f) == getattr(mb, f), f


def test_builder_copy_and_key_match_jax(tmp_path):
    """cache_path is the JAX package's string; every build knob gets its
    own entry (tests/test_scene_cache.py's list) and the other fields
    share one; a scene file's key follows its mtime and size."""
    with open(os.path.join(REPO, "gpupathtracer_tpu_torch", "bvh",
                           "builder_cpp", "sbvh.cpp"), "rb") as f, \
            open(os.path.join(REPO, "gpupathtracer_tpu", "bvh",
                              "builder_cpp", "sbvh.cpp"), "rb") as g:
        assert f.read() == g.read()
    base = RenderConfig(scene_path="proc:cornell", width=16, height=16,
                        cache_dir=str(tmp_path))
    seen = {cache.cache_path(base)}
    for field, value in [("leaf_size", 4), ("wide_arity", 16),
                         ("spatial_splits", False), ("force_leaf", False),
                         ("reinsert_rounds", 3), ("mip_levels", 4),
                         ("bvh_builder", "numpy")]:
        cfg = dataclasses.replace(base, **{field: value})
        assert cache.cache_path(cfg) == jax_cache.cache_path(_jax(cfg))
        assert cache.cache_path(cfg) not in seen, field
        seen.add(cache.cache_path(cfg))
    for field, value in [("width", 64), ("seed", 7), ("packet_size", 256),
                         ("max_bounces", 3), ("cluster_tris", 128)]:
        cfg = dataclasses.replace(base, **{field: value})
        assert cache.cache_path(cfg) == cache.cache_path(base), field
    obj = tmp_path / "one.obj"
    obj.write_text("v 0 0 0\nv 1 0 0\nv 0 1 0\nf 1 2 3\n")
    cfg = dataclasses.replace(base, scene_path=str(obj))
    key = cache.cache_path(cfg)
    assert key == jax_cache.cache_path(_jax(cfg))
    obj.write_text("v 0 0 0\nv 2 0 0\nv 0 1 0\nf 1 2 3\n")
    assert cache.cache_path(cfg) != key


@pytest.fixture(scope="module")
def town(tmp_path_factory):
    return generate_textured_town(str(tmp_path_factory.mktemp("town")),
                                  houses=2, trees=1, sphere_subdiv=1)


@pytest.fixture(scope="module")
def jpeg_town(tmp_path_factory):
    """The small town with its four maps swapped for the committed JPEG
    fixtures (tests/golden/images)."""
    import shutil

    path = generate_textured_town(str(tmp_path_factory.mktemp("jtown")),
                                  houses=2, trees=1, sphere_subdiv=1)
    folder = os.path.dirname(path)
    for name in ("checker", "bricks", "roof", "foliage"):
        shutil.copy(os.path.join(REPO, "tests", "golden", "images",
                                 name + ".jpg"), folder)
    mtl = os.path.join(folder, "town.mtl")
    with open(mtl) as f:
        text = f.read()
    with open(mtl, "w") as f:
        f.write(text.replace(".png", ".jpg"))
    return path


@pytest.mark.parametrize("scene,kw", [("proc:table", {}),
                                      ("proc:table", {"cluster_tris": 128}),
                                      ("town", {"mip_levels": 4}),
                                      ("jpeg_town", {"mip_levels": 4})])
def test_files_read_in_either_direction(scene, kw, town, jpeg_town, tmp_path,
                                        monkeypatch):
    """A file the JAX package's load_scene wrote gives the port a SceneData
    bitwise its cold ingest, without building anything (the cluster
    leaves and the treelet cut are packed after the cache); a file the
    port wrote gives the JAX package its own cold scene's arrays. The
    JPEG-textured town's atlas (PIL's decode in the JAX package, the port's
    own decoder) goes through the file in both directions too."""
    path = {"town": town, "jpeg_town": jpeg_town}.get(scene, scene)
    cfg = RenderConfig(scene_path=path,
                       cache_dir=str(tmp_path / "jax"), cache_enabled=True,
                       **kw)
    jax_load_scene(_jax(cfg))
    assert os.path.exists(cache.cache_path(cfg))
    cold = load_scene(dataclasses.replace(cfg, cache_enabled=False), "cpu")
    with monkeypatch.context() as m:
        def refuse(*a, **k):
            raise AssertionError("a cache hit built the scene")
        m.setattr(scenedata, "build_scene", refuse)
        warm = load_scene(cfg, "cpu")
    _same_scene(warm, cold)
    assert warm[0].child_bounds is not None and warm[0].refs is not None

    port_cfg = dataclasses.replace(cfg, cache_dir=str(tmp_path / "port"))
    load_scene(port_cfg, "cpu")
    z = jax_cache.load_scene_cache(_jax(port_cfg))
    with np.load(jax_cache.cache_path(_jax(cfg))) as w:
        assert sorted(z) == sorted(w.files)
        for k in w.files:
            assert z[k].dtype == w[k].dtype, k
            assert z[k].tobytes() == w[k].tobytes(), k
    jscene, _ = jax_load_scene(_jax(port_cfg))
    for f in ("node_rows", "child_bounds", "child_entry", "refs"):
        assert np.asarray(getattr(jscene.bvh, f)).tobytes() == \
            getattr(cold[0], f).numpy().tobytes(), f


def test_corrupt_file_is_rebuilt(tmp_path):
    cfg = RenderConfig(scene_path="proc:cornell", cache_dir=str(tmp_path),
                       cache_enabled=True)
    cold = load_scene(cfg, "cpu")
    path = cache.cache_path(cfg)
    with open(path, "wb") as f:
        f.write(b"not a npz")
    assert cache.load_scene_cache(cfg) is None
    _same_scene(load_scene(cfg, "cpu"), cold)
    assert cache.load_scene_cache(cfg) is not None  # written anew
    assert os.listdir(tmp_path) == [os.path.basename(path)]


def test_cache_leaves_the_film_bitwise(tmp_path, monkeypatch):
    """Renderers on a cold scene, a warm one (cache_enabled) and the CLI's
    default (cache on, under cache/ of the working folder) against
    --no-cache: the same film."""
    cfg = RenderConfig(scene_path="proc:cornell", width=16, height=16,
                       max_bounces=4, cache_dir=str(tmp_path / "c"))
    films = []
    for enabled in (False, True, True):
        r = Renderer(dataclasses.replace(cfg, cache_enabled=enabled), "cpu")
        r.render_frame()
        films.append(r.film_hdr().view(np.int32))
    assert len(os.listdir(tmp_path / "c")) == 1
    monkeypatch.chdir(tmp_path)
    base = ["proc:cornell", "--device", "cpu", "--width", "16", "--height",
            "16", "--spp", "1", "--max-bounces", "4"]
    for extra in (["--no-cache"], [], []):
        name = "none" if extra else "cached"
        assert cli.main(base + extra + ["--out", f"{name}.png", "--hdr-out",
                                        f"{name}.npy"]) == 0
        if extra:
            assert not os.path.exists("cache")
    assert len(os.listdir("cache")) == 1
    for f in films[1:]:
        np.testing.assert_array_equal(f, films[0])
    np.testing.assert_array_equal(np.load("cached.npy").view(np.int32),
                                  np.load("none.npy").view(np.int32))
