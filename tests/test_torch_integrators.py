"""The port's reference and AO integrators and its sun NEE against the JAX
package on the CPU: the sampling warps, the sun's light samples, the
integrators lane by lane on the same keys, and the Renderer's films for
the reference, AO and both sun modes.

The JAX functions run jitted, as the JAX Renderer runs them: XLA then
contracts multiply-adds into fused ones, which the port writes out with
``fma32``. What remains is sin and cos, which XLA's and PyTorch's math
libraries round differently in the last place; each bound below is the
measured worst case, rounded up, with that reason.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.config import CameraConfig as JaxCameraConfig
from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.math import camera as jcam
from gpupathtracer_tpu.math import sampling as jsam
from gpupathtracer_tpu.models import interaction as jint
from gpupathtracer_tpu.models import materials as jmat
from gpupathtracer_tpu.models import nee as jnee
from gpupathtracer_tpu.models.ao import render_sample_ao as jax_ao
from gpupathtracer_tpu.models.reference import \
    render_sample_reference as jax_reference
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.math import camera as tcam
from gpupathtracer_tpu_torch.math import sampling as tsam
from gpupathtracer_tpu_torch.models import interaction as tint
from gpupathtracer_tpu_torch.models import materials as tmat
from gpupathtracer_tpu_torch.models import nee as tnee
from gpupathtracer_tpu_torch.models.ao import render_sample_ao
from gpupathtracer_tpu_torch.models.reference import render_sample_reference
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import load_scene

N = 4096
TINY = 1e-30


def _ulps(a, b):
    """The largest difference of [N, 3] vectors, in units in the last place
    of each vector's largest component (a component near 0 has a tiny ulp
    of its own, which says nothing of the vector's rounding)."""
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    scale = np.spacing(np.abs(b).max(axis=-1, keepdims=True))
    return float((np.abs(a.astype(np.float64) - b) / scale).max())


def _uniforms(seed, cols=2):
    return np.random.RandomState(seed).uniform(0, 1, (N, cols)).astype(
        np.float32)


@pytest.fixture(scope="module")
def sun_scenes():
    """proc:cornell with the sun on, loaded by each package."""
    jscene, _ = jax_load_scene(JaxRenderConfig(scene_path="proc:cornell",
                                               sun_enabled=True))
    tscene, _ = load_scene(RenderConfig(scene_path="proc:cornell",
                                        sun_enabled=True), "cpu")
    for f in ("sun_dir", "sun_emission", "sun_radius", "sun_max_dot"):
        assert getattr(tscene, f).numpy().tobytes() == \
            np.asarray(getattr(jscene, f)).tobytes(), f
    return jscene, tscene


def test_sample_uniform_hemisphere():
    """z is the uniform itself: bitwise. x and y are sqrt(fma(-z, z, 1))
    times cos and sin of 2 pi u1: measured at most 1 ulp apart, in about
    4% of lanes (without the fused multiply-add, 16%); held to 2 ulp."""
    u = _uniforms(0)
    want = np.asarray(jax.jit(jsam.sample_uniform_hemisphere)(u))
    got = tsam.sample_uniform_hemisphere(torch.from_numpy(u)).numpy()
    np.testing.assert_array_equal(got[:, 2], want[:, 2])
    assert _ulps(got, want) <= 2


def test_sample_sun_vertex_and_cone(sun_scenes):
    """The disk point and the cone direction carry cos and sin of 2 pi u1:
    measured at most 2 ulp (disk points, about 0.3% of components) and 1
    ulp (cone directions, 2%); held to 4 and 2. Normals and the cone's pdf
    are bitwise."""
    jscene, tscene = sun_scenes
    rng = np.random.RandomState(7)
    pos = rng.uniform(0.1, 5.4, (N, 3)).astype(np.float32)
    u = _uniforms(8)
    jp, jn = jax.jit(jnee.sample_sun_vertex)(jscene, pos, u)
    tp, tn = tnee.sample_sun_vertex(tscene, torch.from_numpy(pos),
                                    torch.from_numpy(u))
    assert _ulps(tp.numpy(), jp) <= 4
    np.testing.assert_array_equal(tn.numpy(), np.asarray(jn))
    jd, jpdf = jax.jit(lambda s, x: jnee.sample_sun_cone(s, (N, 3), x))(
        jscene, u)
    td, tpdf = tnee.sample_sun_cone(tscene, (N, 3), torch.from_numpy(u))
    assert _ulps(td.numpy(), jd) <= 2
    assert float(tpdf) == float(jpdf)
    # Every direction lies in the cone.
    cosines = td.numpy() @ tscene.sun_dir.numpy()
    assert (cosines >= float(tscene.sun_max_dot) - 1e-6).all()


def _material_and_interaction(seed):
    rng = np.random.RandomState(seed)
    rows = np.zeros((N, 16), np.float32)
    rows[:, 0:3] = rng.uniform(0, 1, (N, 3))
    rows[:, 3] = rng.uniform(0.05, 1.0, N)
    rows[:, 4] = rng.rand(N) < 0.4
    n = rng.normal(size=(N, 3)).astype(np.float32)
    n /= np.linalg.norm(n, axis=1, keepdims=True)
    wo = rng.normal(size=(N, 3)).astype(np.float32)
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    wo = np.where((wo * n).sum(1, keepdims=True) < 0, -wo, wo)
    n, wo = n.astype(np.float32), wo.astype(np.float32)
    jm = jmat.make_material_instance(None, None, row=jnp.asarray(rows))
    ji = jint.make_interaction(jnp.asarray(n), jnp.asarray(wo))
    tm = tmat.make_material_instance(torch.from_numpy(rows))
    ti = tint.make_interaction(torch.from_numpy(n), torch.from_numpy(wo))
    return (jm, ji), (tm, ti)


@pytest.mark.parametrize("mode", ["disk", "cone"])
def test_generate_light_sample_with_sun(sun_scenes, mode):
    """The 50/50 pick between the emitter CDF and the sun (u_pick > 0.5
    keeps the emitter point), against the JAX function jitted, as the JAX
    Renderer runs it, and eagerly.

    Jitted, XLA contracts the squared distance and the light point's
    multiply-adds besides the sun warps' (which the port writes out).
    Emission, and t_max 1e20 on every sun lane, are bitwise. Measured
    against the jitted function: shadow t_max 3.3e-7 relative (held 1e-6),
    shadow origins 0.12 ulp of a point (held 1), shadow directions 8 ulp
    of a direction (held 16), the MIS-weighted throughput, which carries
    the microfacet D (exp/log/pow) besides, 2.8e-5 relative (held 1e-4).
    Eagerly, op by op, nothing is contracted: on the emitter lanes the
    shadow ray and the emission are bitwise, as tests/test_torch_models.py
    holds them without the sun."""
    jscene, tscene = sun_scenes
    rng = np.random.RandomState(5)
    (jm, ji), (tm, ti) = _material_and_interaction(5)
    pos = rng.uniform(0.1, 5.4, (N, 3)).astype(np.float32)
    thr = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    u = _uniforms(9, 4)

    def jax_sample(scene, m, i, p, t, uu):
        return jnee.generate_light_sample(
            scene, p, i.normal, m, i, t, uu[:, 0], uu[:, 1:3], sun=True,
            sun_mode=mode, u_pick=uu[:, 3])

    tu = torch.from_numpy(u)
    ts = tnee.generate_light_sample(
        tscene, torch.from_numpy(pos), ti.normal, tm, ti,
        torch.from_numpy(thr), tu[:, 0], tu[:, 1:3], sun=True,
        sun_mode=mode, u_pick=tu[:, 3])
    sun_lanes = u[:, 3] <= 0.5
    assert 0.4 < sun_lanes.mean() < 0.6
    js = jax.jit(jax_sample)(jscene, jm, ji, pos, thr, u)
    np.testing.assert_array_equal(ts.emission.numpy(), np.asarray(js.emission))
    tmax = ts.shadow_tmax.numpy()
    assert (tmax[sun_lanes] == np.float32(1e20)).all()
    np.testing.assert_array_equal(tmax[sun_lanes],
                                  np.asarray(js.shadow_tmax)[sun_lanes])
    np.testing.assert_allclose(tmax, np.asarray(js.shadow_tmax), rtol=1e-6)
    assert _ulps(ts.shadow_origin.numpy(), js.shadow_origin) <= 1
    assert _ulps(ts.shadow_dir.numpy(), js.shadow_dir) <= 16
    np.testing.assert_allclose(ts.throughput.numpy(),
                               np.asarray(js.throughput), rtol=1e-4,
                               atol=TINY)
    assert (ts.throughput.numpy()[sun_lanes] > 0).any()
    eager = jax_sample(jscene, jm, ji, jnp.asarray(pos), jnp.asarray(thr),
                       jnp.asarray(u))
    for field in ("shadow_origin", "shadow_dir", "shadow_tmax", "emission"):
        np.testing.assert_array_equal(
            getattr(ts, field).numpy()[~sun_lanes],
            np.asarray(getattr(eager, field))[~sun_lanes])


# --- the integrators, lane by lane ----------------------------------------

CORNELL = dict(position=(2.75, 2.75, -7.0), yaw=math.pi,
               fov=math.radians(45), aspect=1.0)
BUNNY = dict(position=(0.0, 4.0, -12.0), yaw=math.pi, pitch=-0.25,
             fov=math.radians(45), aspect=1.0)
W = H = 16


@pytest.fixture(scope="module")
def cornell():
    jcfg = JaxRenderConfig(scene_path="proc:cornell")
    jscene, jmeta = jax_load_scene(jcfg)
    tscene, tmeta = load_scene(RenderConfig(scene_path="proc:cornell"), "cpu")
    jcp = jcam.generate_image_plane(JaxCameraConfig(**CORNELL))
    tcp = tcam.camera_from_numpy({k: np.asarray(v) for k, v in
                                  jcp._asdict().items()}, "cpu")
    px = (np.arange(W * H) % W).astype(np.float32)
    py = (np.arange(W * H) // W).astype(np.float32)
    return (jscene, jmeta, jcp), (tscene, tmeta, tcp), px, py


@pytest.mark.parametrize("seed", [0, 1])
def test_reference_lanes_match_jax(cornell, seed):
    """render_sample_reference on cornell at 16x16, 4 bounces: the same key
    draws the same numbers, so each lane follows the same path. Measured:
    every lane inside rtol = atol = 1e-4, 12 and 15 of 256 lanes not
    bitwise, max |diff| 4.8e-7 (the hemisphere's cos and sin, and
    multiply-adds of the shading that XLA contracts). Held: at least 99%
    of lanes inside rtol = atol = 1e-4, max |diff| under 1e-5, and the
    means within 1e-6 relative."""
    (jscene, jmeta, jcp), (tscene, tmeta, tcp), px, py = cornell
    kw = dict(width=W, height=H, max_bounces=4)
    want = np.asarray(jax_reference(
        jscene, jcp, jnp.asarray(px), jnp.asarray(py),
        jax.random.PRNGKey(seed), stack_depth=jmeta.stack_depth,
        leaf_size=jmeta.leaf_size, **kw))
    got = render_sample_reference(
        tscene, tcp, torch.from_numpy(px), torch.from_numpy(py),
        random.PRNGKey(seed), stack_depth=tmeta.stack_depth,
        leaf_size=tmeta.leaf_size, **kw).numpy()
    inside = ~(np.abs(got - want) > 1e-4 + 1e-4 * np.abs(want)).any(-1)
    assert inside.mean() >= 0.99, inside.mean()
    assert np.abs(got - want).max() < 1e-5
    assert want.max() > 0
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-6)


@pytest.mark.parametrize("seed", [0, 1])
def test_ao_lanes_match_jax(cornell, seed):
    """render_sample_ao: a visibility per lane, bitwise (measured: every
    lane), and the ray count exact."""
    (jscene, jmeta, jcp), (tscene, tmeta, tcp), px, py = cornell
    want, jrays = jax_ao(jscene, jcp, jnp.asarray(px), jnp.asarray(py),
                         jax.random.PRNGKey(seed), width=W, height=H,
                         stack_depth=jmeta.stack_depth,
                         leaf_size=jmeta.leaf_size)
    got, rays = render_sample_ao(tscene, tcp, torch.from_numpy(px),
                                 torch.from_numpy(py), random.PRNGKey(seed),
                                 width=W, height=H,
                                 stack_depth=tmeta.stack_depth,
                                 leaf_size=tmeta.leaf_size)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    assert int(rays) == int(jrays)
    assert 0 < got.numpy().mean() < 1


# --- the Renderer's films -------------------------------------------------

def _outside(img, ref, tol=2e-3):
    """Pixels with a channel outside rtol = atol = tol of the reference."""
    return (np.abs(img - ref) > tol + tol * np.abs(ref)).any(-1)


def _films(cfg, integrator, frames=2):
    jr = JaxRenderer(JaxRenderConfig.from_json(cfg.to_json()))
    r = Renderer(cfg, "cpu")
    for _ in range(frames):
        jr.render_frame(integrator)
        r.render_frame(integrator)
    jr.stats.finalize()
    r.stats.finalize()
    assert r.num_samples == jr.num_samples
    return (r.film_hdr(), r.stats.rays_traced), (np.asarray(jr.film_hdr()),
                                                 jr.stats.rays_traced)


FILMS = {
    # name: (scene, camera, config fields, integrator)
    "reference": ("proc:cornell", CORNELL, dict(frame_batch=2), "reference"),
    "ao": ("proc:cornell", CORNELL, dict(frame_batch=2), "ao"),
    "sun_disk": ("proc:bunny", BUNNY, dict(sun_enabled=True,
                                           sun_mode="disk"), "wavefront"),
    "sun_cone": ("proc:bunny", BUNNY, dict(sun_enabled=True,
                                           sun_mode="cone"), "wavefront"),
}


@pytest.mark.parametrize("name", sorted(FILMS))
def test_renderer_film_matches_jax(name):
    """Two frames through each Renderer at 16x16, 4 bounces, black sky.
    frame_batch=2 is ignored by the reference and AO integrators in both
    packages (one sample a frame). Measured: 0 pixels outside rtol = atol
    = 2e-3, max |diff| 4.8e-7 (reference), 0 (AO), 2.4e-7 and 1.2e-7 (the
    sun's disk and cone), ray counts equal. Held: at most 1% of pixels
    outside, the means within 0.5%, the ray counts equal."""
    scene, camera, fields, integrator = FILMS[name]
    cfg = RenderConfig(scene_path=scene, skybox="GENERATE COLOR BLACK",
                       width=W, height=H, max_bounces=4, **fields)
    cfg.camera = CameraConfig(**camera)
    (got, rays), (want, jrays) = _films(cfg, integrator)
    assert got.shape == want.shape and np.isfinite(got).all()
    assert got.max() > 0
    assert _outside(got, want).mean() <= 0.01
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)),
                               rtol=5e-3)
    assert rays == jrays
    if name == "ao":
        assert got.min() >= 0 and got.max() <= 1


def test_renderer_refuses_unknown_integrator():
    cfg = RenderConfig(scene_path="proc:cornell", width=8, height=8)
    with pytest.raises(ValueError):
        Renderer(cfg, "cpu").render_frame("photon")
