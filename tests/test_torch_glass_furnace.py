"""tests/test_integrator.py::test_glass_furnace on the port against the JAX
Renderer on the CPU, with that test's bound run on the port too, at 4
frames where that test renders 16 (chip_smoke.py phase 15 runs its 16 on
the card). A file of its own: the tier runs files in parallel."""

import math

import numpy as np

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu.scene import pack_scene as jax_pack_scene
from gpupathtracer_tpu.scene.envmap import from_color
from gpupathtracer_tpu.scene.mesh import \
    build_triangle_soup as jax_triangle_soup
from gpupathtracer_tpu.scene.procedural import SceneBuilder as JaxBuilder
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import pack_scene
from gpupathtracer_tpu_torch.scene.materials import MATERIAL_REFRACTIVE
from gpupathtracer_tpu_torch.scene.mesh import build_triangle_soup
from gpupathtracer_tpu_torch.scene.procedural import SceneBuilder


def _hold_film(got, want, rays, jrays):
    """Held as tests/test_torch_render.py holds the wavefront films: at most
    1% of pixels outside rtol = atol = 2e-3, the means within 0.5%, the ray
    counts equal."""
    assert got.shape == want.shape and np.isfinite(got).all()
    outside = (np.abs(got - want) > 2e-3 + 2e-3 * np.abs(want)).any(-1)
    assert outside.mean() <= 0.01
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)),
                               rtol=5e-3)
    assert rays == jrays


def _render(r, frames):
    for _ in range(frames):
        r.render_frame()
    r.stats.finalize()
    return np.asarray(r.film_hdr()), r.stats.rays_traced


def test_glass_furnace_matches_jax():
    """tests/test_integrator.py::test_glass_furnace: a glass icosphere (ior
    1.5, albedo 1) in a white furnace, 24 bounces, 24x24, 4 frames (16
    there: the plain walk takes about 1.6 s a frame on the CPU); the mean
    stays within (0.80, 1.1) on the port (measured 0.829; 0.842 at 16
    frames). Measured against the JAX Renderer: the films bitwise equal
    (a glass path meets no diffuse surface), the ray counts equal."""
    cfg = RenderConfig(width=24, height=24, ray_chunk=576, max_bounces=24)
    cfg.camera = CameraConfig(position=(0, 0, -4), yaw=math.pi,
                              fov=math.radians(40), aspect=1.0)
    films = []
    for builder, pack, env, renderer, conf in (
            (SceneBuilder, lambda *a: pack_scene(*a, "cpu"),
             np.ones((2, 4, 3), np.float32),
             lambda c, s, m: Renderer(c, "cpu", scene=s, meta=m), cfg),
            (JaxBuilder, jax_pack_scene, from_color((1.0, 1.0, 1.0)),
             lambda c, s, m: JaxRenderer(c, scene=s, meta=m),
             JaxRenderConfig.from_json(cfg.to_json()))):
        sb = builder()
        glass = sb.add_material(name="glass", albedo=(1.0, 1.0, 1.0),
                                material_type=MATERIAL_REFRACTIVE, ior=1.5)
        sb.add_icosphere([0, 0, 0], 1.0, glass, subdiv=3)
        mesh, mats = sb.build()
        soup = (build_triangle_soup if builder is SceneBuilder
                else jax_triangle_soup)(mesh)
        scene, meta = pack(soup, mats, env, conf)
        assert meta.has_delta
        films.append(_render(renderer(conf, scene, meta), 4))
    (got, rays), (want, jrays) = films
    assert 0.80 < got.mean() < 1.1, got.mean()
    _hold_film(got, want, rays, jrays)
