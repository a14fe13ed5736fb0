"""The port's delta materials (mirrors and glass) against the JAX package on
the CPU: render_sample_impl lane by lane against the jitted JAX function,
and the Renderer's films on the JAX package's own mirror recipe
(tests/test_integrator.py), with that file's asserts run on the port too
(its glass furnace: tests/test_torch_glass_furnace.py).

The delta bounce is written with the multiply-adds XLA contracts on the
CPU under jit (models/wavefront.py ``delta_bounce``), so a path through
mirrors and glass alone is the JAX package's bit for bit. A path that
meets a diffuse surface carries the last-place differences of the
microfacet shading (exp/log/pow and its multiply-adds, as in
tests/test_torch_render.py), which the bounds below state.
"""

import math
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.config import CameraConfig as JaxCameraConfig
from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.math import camera as jcam
from gpupathtracer_tpu.models.wavefront import render_sample as jax_render
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu.scene import pack_scene as jax_pack_scene
from gpupathtracer_tpu.scene.envmap import from_color
from gpupathtracer_tpu.scene.mesh import \
    build_triangle_soup as jax_triangle_soup
from gpupathtracer_tpu.scene.procedural import SceneBuilder as JaxBuilder
from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.math import camera as tcam
from gpupathtracer_tpu_torch.models import wavefront
from gpupathtracer_tpu_torch.models.wavefront import render_sample_impl
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import pack_scene
from gpupathtracer_tpu_torch.scene.materials import (MATERIAL_MIRROR,
                                                     MATERIAL_REFRACTIVE)
from gpupathtracer_tpu_torch.scene.mesh import build_triangle_soup
from gpupathtracer_tpu_torch.scene.objloader import load_obj
from gpupathtracer_tpu_torch.scene.procedural import SceneBuilder

W = H = 64
S = 5.5


def _box(builder, all_delta: bool):
    """A closed cornell box with a glass icosphere (ior 1.5) and a mirror
    back wall, built by either package's SceneBuilder. With ``all_delta``
    every wall is a mirror, so only the ceiling light is not a delta
    surface. The triangle count, and so the jitted function, is the same
    for both."""
    sb = builder()
    white = sb.add_material(name="white", albedo=(0.73, 0.73, 0.73))
    red = sb.add_material(name="red", albedo=(0.65, 0.05, 0.05))
    light = sb.add_material(name="light", albedo=(0.0, 0.0, 0.0),
                            emission=(15.0, 15.0, 15.0))
    mirror = sb.add_material(name="mirror", albedo=(0.9, 0.9, 0.9),
                             material_type=MATERIAL_MIRROR)
    glass = sb.add_material(name="glass", albedo=(1.0, 1.0, 1.0),
                            material_type=MATERIAL_REFRACTIVE, ior=1.5)
    wall, side = (mirror, mirror) if all_delta else (white, red)
    s = S
    sb.add_quad([0, 0, 0], [0, 0, s], [s, 0, s], [s, 0, 0], wall)     # floor
    sb.add_quad([0, s, 0], [s, s, 0], [s, s, s], [0, s, s], wall)     # ceiling
    sb.add_quad([0, 0, s], [0, s, s], [s, s, s], [s, 0, s], mirror)   # back
    sb.add_quad([0, 0, 0], [0, s, 0], [0, s, s], [0, 0, s], side)     # left
    sb.add_quad([s, 0, 0], [s, 0, s], [s, s, s], [s, s, 0], wall)     # right
    sb.add_quad([0, 0, 0], [s, 0, 0], [s, s, 0], [0, s, 0], wall)     # front
    c, hw = s / 2, s * 0.24
    sb.add_quad([c - hw, s - 0.01, c - hw], [c + hw, s - 0.01, c - hw],
                [c + hw, s - 0.01, c + hw], [c - hw, s - 0.01, c + hw],
                light)
    sb.add_icosphere([c, 1.3, c + 0.8], 1.2, glass, subdiv=2)
    return sb.build()


@pytest.fixture(scope="module")
def camera():
    """Inside the box near the front wall, looking +z (yaw pi)."""
    jcp = jcam.generate_image_plane(JaxCameraConfig(
        position=(2.75, 2.75, 0.4), yaw=math.pi, fov=math.radians(70),
        aspect=1.0))
    return jcp, tcam.camera_from_numpy(
        {k: np.asarray(v) for k, v in jcp._asdict().items()}, "cpu")


def _lanes(all_delta, camera, seed, counts=None):
    jcp, tcp = camera
    mesh, mats = _box(JaxBuilder, all_delta)
    jscene, jmeta = jax_pack_scene(jax_triangle_soup(mesh), mats,
                                   from_color((0.0, 0.0, 0.0)),
                                   JaxRenderConfig())
    mesh, mats = _box(SceneBuilder, all_delta)
    tscene, tmeta = pack_scene(build_triangle_soup(mesh), mats,
                               np.zeros((2, 4, 3), np.float32),
                               RenderConfig(), "cpu")
    assert jmeta.has_delta and tmeta.has_delta
    assert tmeta.stack_depth == jmeta.stack_depth
    px = (np.arange(W * H) % W).astype(np.float32)
    py = (np.arange(W * H) // W).astype(np.float32)
    kw = dict(width=W, height=H, max_bounces=8, delta=True)
    want, jrays = jax_render(jscene, jcp, jnp.asarray(px), jnp.asarray(py),
                             jax.random.PRNGKey(seed),
                             stack_depth=jmeta.stack_depth,
                             leaf_size=jmeta.leaf_size, **kw)
    wavefront.DELTA_LANES = counts
    try:
        got, rays = render_sample_impl(tscene, tcp, torch.from_numpy(px),
                                       torch.from_numpy(py),
                                       random.PRNGKey(seed),
                                       stack_depth=tmeta.stack_depth,
                                       leaf_size=tmeta.leaf_size, **kw)
    finally:
        wavefront.DELTA_LANES = None
    return (got.numpy(), int(rays)), (np.asarray(want), int(jrays))


@pytest.mark.parametrize("seed", [0, 1])
def test_all_delta_lanes_bitwise(camera, seed):
    """Every wall a mirror, a glass sphere, one light: a path meets no
    other surface, so each lane is bitwise the JAX package's (4096 lanes,
    8 bounces, the ray counts equal; measured: every lane). A mirror path
    is fixed by its camera ray, and about 9% of them find the light within
    8 bounces. With wavefront.DELTA_LANES set, the port counts the lanes
    that hit a surface, all but those on the light a mirror or glass."""
    counts = {"hits": 0, "delta": 0}
    (got, rays), (want, jrays) = _lanes(True, camera, seed, counts)
    assert 0 < counts["delta"] < counts["hits"]
    assert rays == jrays
    assert (want > 0).any(-1).mean() > 0.05
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("seed", [0, 1])
def test_delta_lanes_match_jax(camera, seed):
    """A white and red box with a mirror back wall and a glass sphere:
    the same paths (ray counts equal). Measured: 2,243 and 2,262 of 4,096
    lanes not bitwise (seeds 0 and 1), max |diff| 1.8e-5 and 5.9e-5, from
    the diffuse bounces' last-place differences (see the module
    docstring); the means equal in float32. Held: every lane within rtol
    2e-4 and atol 1e-6, the means within 1e-5 relative."""
    (got, rays), (want, jrays) = _lanes(False, camera, seed)
    assert rays == jrays
    assert (want > 0).any(-1).mean() > 0.5
    np.testing.assert_allclose(got, want, rtol=2e-4, atol=1e-6)
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-5)


# --- the Renderer's films on the JAX package's recipes ----------------------

def _outside(img, ref, tol=2e-3):
    """Pixels with a channel outside rtol = atol = tol of the reference."""
    return (np.abs(img - ref) > tol + tol * np.abs(ref)).any(-1)


def _hold_film(got, want, rays, jrays):
    """Held as tests/test_torch_render.py holds the wavefront films: at most
    1% of pixels outside rtol = atol = 2e-3, the means within 0.5%, the ray
    counts equal."""
    assert got.shape == want.shape and np.isfinite(got).all()
    assert _outside(got, want).mean() <= 0.01
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)),
                               rtol=5e-3)
    assert rays == jrays


def _render(r, frames):
    for _ in range(frames):
        r.render_frame()
    r.stats.finalize()
    return np.asarray(r.film_hdr()), r.stats.rays_traced


def test_mirror_material_matches_jax(tmp_path):
    """tests/test_integrator.py::test_mirror_material's scene (an illum 5
    mirror floor under a light), camera and 16 frames on both Renderers,
    at 16x16 where that test renders 32x32 (chip_smoke.py phase 15 runs it
    at 32x32 on the card); its asserts on the port's film (measured: max
    10.0, 20th percentile 0). Measured: the films bitwise equal, the ray
    counts equal."""
    with open(os.path.join(tmp_path, "m.mtl"), "w") as f:
        f.write("newmtl mirror\nKd 0.9 0.9 0.9\nNs 1000\nillum 5\n"
                "newmtl light\nKd 0 0 0\nKe 10 10 10\nNs 1\n")
    with open(os.path.join(tmp_path, "s.obj"), "w") as f:
        f.write("mtllib m.mtl\n"
                "v -5 0 -5\nv 5 0 -5\nv 5 0 5\nv -5 0 5\n"
                "v -1 4 -1\nv 1 4 -1\nv 1 4 1\nv -1 4 1\n"
                "vn 0 1 0\nvn 0 -1 0\n"
                "usemtl mirror\nf 1//1 4//1 3//1 2//1\n"
                "usemtl light\nf 5//2 6//2 7//2 8//2\n")
    path = os.path.join(tmp_path, "s.obj")
    _, mats = load_obj(path)
    assert any(m.material_type == MATERIAL_MIRROR for m in mats)
    cfg = RenderConfig(scene_path=path, skybox="GENERATE COLOR BLACK",
                       width=16, height=16, ray_chunk=256, max_bounces=4)
    cfg.camera = CameraConfig(position=(3.0, 2.5, 0.0), yaw=-math.pi / 2,
                              pitch=-0.8, fov=math.radians(60), aspect=1.0)
    r = Renderer(cfg, "cpu")
    assert r.meta.has_delta
    jr = JaxRenderer(JaxRenderConfig.from_json(cfg.to_json()))
    got, rays = _render(r, 16)
    want, jrays = _render(jr, 16)
    assert got.max() > 3.0, got.max()
    assert np.percentile(got, 20) < 0.5
    _hold_film(got, want, rays, jrays)
