"""The port's shading, sampling and camera functions against their JAX
versions on the same seeded inputs.

Both run float32 on the CPU. Arithmetic ops and square roots round
identically; sin, cos, log, exp, pow, atan2 and asin come from different
math libraries (XLA's and PyTorch's) and may differ in the last place, and
XLA on the CPU flushes subnormal results to zero (hence atol=1e-30 where
a Beckmann or Blinn-Phong lobe underflows). Each tolerance below is the
measured worst case, rounded up, with its reason.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.config import CameraConfig, RenderConfig
from gpupathtracer_tpu.math import camera as jcam
from gpupathtracer_tpu.models import bsdf as jbsdf
from gpupathtracer_tpu.models import interaction as jint
from gpupathtracer_tpu.models import materials as jmat
from gpupathtracer_tpu.models import microfacet as jmf
from gpupathtracer_tpu.models import nee as jnee
from gpupathtracer_tpu.ops import tonemap as jtone
from gpupathtracer_tpu.scene import envmap as jenv
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch import config as tconfig
from gpupathtracer_tpu_torch.math import camera as tcam
from gpupathtracer_tpu_torch.models import bsdf as tbsdf
from gpupathtracer_tpu_torch.models import interaction as tint
from gpupathtracer_tpu_torch.models import materials as tmat
from gpupathtracer_tpu_torch.models import microfacet as tmf
from gpupathtracer_tpu_torch.models import nee as tnee
from gpupathtracer_tpu_torch.ops import tonemap as ttone
from gpupathtracer_tpu_torch.scene import envmap as tenv
from gpupathtracer_tpu_torch.scene import scene_from_numpy

MODELS = ["trowbridge_reitz", "beckmann", "blinn_phong"]
N = 4096
TINY = 1e-30


def _unit(rng, n):
    v = rng.normal(size=(n, 3)).astype(np.float32)
    return (v / np.linalg.norm(v, axis=1, keepdims=True)).astype(np.float32)


def _inputs(seed):
    """Material rows, normals, view and light directions, uniforms."""
    rng = np.random.RandomState(seed)
    rows = np.zeros((N, 16), np.float32)
    rows[:, 0:3] = rng.uniform(0, 1, (N, 3))
    rows[:, 3] = rng.uniform(0.05, 1.0, N)          # G-channel roughness
    rows[:, 4] = rng.rand(N) < 0.4                  # metallic
    rows[:, 5:8] = rng.uniform(0, 2, (N, 3)) * (rng.rand(N, 1) < 0.1)
    n = _unit(rng, N)
    wo = _unit(rng, N)
    wo = np.where((wo * n).sum(1, keepdims=True) < 0, -wo, wo)
    wi = _unit(rng, N)
    u = rng.uniform(0, 1, (N, 4)).astype(np.float32)
    return rows, n, wo, wi, u


def _close(got, want, rtol, atol=0.0):
    np.testing.assert_allclose(np.asarray(got), np.asarray(want), rtol=rtol,
                               atol=atol)


def _both(seed):
    rows, n, wo, wi, u = _inputs(seed)
    jm = jmat.make_material_instance(None, None, row=jnp.asarray(rows))
    tm = tmat.make_material_instance(torch.from_numpy(rows))
    ji = jint.set_incoming(jint.make_interaction(jnp.asarray(n),
                                                 jnp.asarray(wo)),
                           jnp.asarray(wi))
    ti = tint.set_incoming(tint.make_interaction(torch.from_numpy(n),
                                                 torch.from_numpy(wo)),
                           torch.from_numpy(wi))
    return (jm, ji), (tm, ti), u


def test_material_and_interaction_bitwise():
    (jm, ji), (tm, ti), _ = _both(0)
    for a, b in zip(tm, jm):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    for a, b in zip(ti, ji):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))


@pytest.mark.parametrize("model", MODELS)
def test_microfacet_functions(model):
    (jm, ji), (tm, ti), u = _both(1)
    # D: exp/log (Beckmann) and pow (Blinn-Phong), measured 3.8e-6.
    _close(tmf.distribution(tm, ti, model), jmf.distribution(jm, ji, model),
           rtol=4e-6, atol=TINY)
    _close(tmf.pdf_direction(tm, ti, model), jmf.pdf_direction(jm, ji, model),
           rtol=2e-6, atol=TINY)
    # Half vectors: sin/cos/log/pow of the uniforms, measured 4.6e-7.
    _close(tmf.sample_microfacet(tm, torch.from_numpy(u[:, :2]), model),
           jmf.sample_microfacet(jm, jnp.asarray(u[:, :2]), model),
           rtol=1e-6, atol=1e-6)
    ti_b, tp0, tp1 = tmf.generate_importance_sample(
        tm, ti, torch.from_numpy(u[:, 2]), torch.from_numpy(u[:, :2]), model)
    ji_b, jp0, jp1 = jmf.generate_importance_sample(
        jm, ji, jnp.asarray(u[:, 2]), jnp.asarray(u[:, :2]), model)
    _close(ti_b.incoming, ji_b.incoming, rtol=1e-6, atol=1e-6)
    # The pdfs at the sampled direction: its last-place difference, scaled
    # by the lobe's slope, which is steep for narrow lobes (measured 6.3e-4
    # relative for Beckmann, 6e-5 for Trowbridge-Reitz).
    _close(tp0, jp0, rtol=1e-3, atol=TINY)
    _close(tp1, jp1, rtol=1e-3, atol=TINY)


@pytest.mark.parametrize("model", MODELS)
def test_compute_bsdf(model):
    (jm, ji), (tm, ti), _ = _both(2)
    # D inside, as above: measured 5.5e-7.
    _close(tbsdf.compute_bsdf(tm, ti, model), jbsdf.compute_bsdf(jm, ji, model),
           rtol=1e-6, atol=TINY)


def test_gen_rays_with_depth_of_field():
    rng = np.random.RandomState(4)
    lens_cfg = dict(position=(0.0, 4.0, -7.2), yaw=math.pi, pitch=-0.18,
                    fov=math.radians(55), aspect=1.5, aperture=0.12,
                    focal_distance=7.5)
    cc = CameraConfig(**lens_cfg)
    interp = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    lens = rng.uniform(0, 1, (N, 2)).astype(np.float32)
    jcp = jcam.generate_image_plane(cc)
    jo, jd = jcam.gen_rays(jcp, jnp.asarray(interp), jnp.asarray(lens))
    cam = tcam.generate_image_plane(tconfig.CameraConfig(**lens_cfg), "cpu")
    for a, b in zip(cam, jcp):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    # The JAX camera carried across gives the same rays.
    cam = tcam.camera_from_numpy(
        {k: np.asarray(v) for k, v in jcp._asdict().items()}, "cpu")
    to, td = tcam.gen_rays(cam, torch.from_numpy(interp),
                           torch.from_numpy(lens))
    # The lens offset goes through sin/cos: a few ulp of the 0.06 radius.
    _close(to, jo, rtol=1e-6, atol=1e-7)
    _close(td, jd, rtol=1e-6, atol=1e-7)


def test_generate_light_sample():
    cfg = RenderConfig(scene_path="proc:cornell")
    jscene, _ = jax_load_scene(cfg)
    tscene = scene_from_numpy(dict(
        tri_shade=np.asarray(jscene.tri_shade),
        light_rows=np.asarray(jscene.light_rows),
        light_cdf=np.asarray(jscene.light_cdf),
        total_light_area=np.asarray(jscene.total_light_area),
        mat_rows=np.asarray(jscene.mat_rows),
        env=np.asarray(jscene.env.image),
        node_rows=np.asarray(jscene.bvh.node_rows)), "cpu")
    rng = np.random.RandomState(5)
    (jm, ji), (tm, ti), u = _both(5)
    pos = rng.uniform(0.1, 5.4, (N, 3)).astype(np.float32)
    thr = rng.uniform(0, 1, (N, 3)).astype(np.float32)
    for model in MODELS:
        js = jnee.generate_light_sample(
            jscene, jnp.asarray(pos), ji.normal, jm, ji, jnp.asarray(thr),
            jnp.asarray(u[:, 0]), jnp.asarray(u[:, 1:3]), model)
        ts = tnee.generate_light_sample(
            tscene, torch.from_numpy(pos), ti.normal, tm, ti,
            torch.from_numpy(thr), torch.from_numpy(u[:, 0]),
            torch.from_numpy(u[:, 1:3]), model)
        for field in ("shadow_origin", "shadow_dir", "shadow_tmax",
                      "emission"):
            np.testing.assert_array_equal(getattr(ts, field).numpy(),
                                          np.asarray(getattr(js, field)))
        # The MIS-weighted throughput carries D (exp/log/pow), as above.
        _close(ts.throughput, js.throughput, rtol=5e-6, atol=TINY)


@pytest.mark.parametrize("spec", ["GENERATE COLOR 0.2 0.5 0.9", "random"])
def test_sample_env(spec):
    rng = np.random.RandomState(6)
    if spec == "random":
        img = rng.uniform(0, 4, (8, 16, 3)).astype(np.float32)
        jmap = jenv.from_equirect(img)
        tmap = tenv.EnvMap(image=torch.from_numpy(img))
    else:
        jmap = jenv.load_environment(spec)
        tmap = tenv.EnvMap(image=torch.from_numpy(tenv.environment_image(spec)))
    d = _unit(rng, N)
    # atan2/asin place the bilinear weights; a few ulp of the radiance.
    _close(tenv.sample_env(tmap, torch.from_numpy(d)),
           jenv.sample_env(jmap, jnp.asarray(d)), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("tonemap", ["uncharted2", "none"])
def test_present(tonemap):
    rng = np.random.RandomState(7)
    acc = (rng.gamma(0.5, 2.0, (16, 24, 3)) * 8).astype(np.float32)
    got = ttone.present(torch.from_numpy(acc), 8, exposure=1.68,
                        tonemap=tonemap)
    want = jtone.present(jnp.asarray(acc), 8, exposure=1.68, tonemap=tonemap)
    # pow(x, 1/2.2) from the two math libraries: a few ulp.
    _close(got, want, rtol=1e-6, atol=1e-7)
