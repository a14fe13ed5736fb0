"""Light-end shadow rays (``shadow_rev``) and the bounce coherence sort
(``sort_rays``) against the JAX package on the CPU.

The sort reorders the rays of a trace and unpermutes the hits; the port's
walk takes each ray alone, so the film is bitwise the unsorted film. The
root's box, which keys the sort's origin cells, is read from node row 0 at
every arity. Reversed shadow rays start at so + sd * t_max, one multiply-add
as XLA contracts it under jit: bitwise the JAX expression.
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
from gpupathtracer_tpu.models.wavefront import render_sample as jax_render
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.math import camera as tcam
from gpupathtracer_tpu_torch.models.wavefront import (render_sample_impl,
                                                      reverse_segments,
                                                      root_box)
from gpupathtracer_tpu_torch.ops.tsort import SORTED
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import load_scene

CORNELL = dict(position=(2.75, 2.75, -7.0), yaw=math.pi,
               fov=math.radians(45), aspect=1.0)


@pytest.mark.parametrize("scene,arity", [("proc:cornell", 4),
                                         ("proc:table", 8),
                                         ("proc:table", 16),
                                         ("proc:bathroom", 4)])
def test_root_box_matches_jax(scene, arity):
    """The union of the root's children from node row 0, empty slots
    (+inf / -inf) widening nothing: bitwise the JAX package's min / max
    over bvh.child_bounds[0]."""
    jscene, _ = jax_load_scene(JaxRenderConfig(scene_path=scene,
                                               wide_arity=arity))
    tscene, _ = load_scene(RenderConfig(scene_path=scene, wide_arity=arity),
                           "cpu")
    cb = jscene.bvh.child_bounds
    assert cb.shape[1] == arity == tscene.arity
    lo, hi = root_box(tscene)
    np.testing.assert_array_equal(lo.numpy(),
                                  np.asarray(jnp.min(cb[0, :, 0:3], axis=0)))
    np.testing.assert_array_equal(hi.numpy(),
                                  np.asarray(jnp.max(cb[0, :, 3:6], axis=0)))
    assert np.isfinite(lo.numpy()).all() and (hi > lo).all()


def test_reverse_segments_bitwise():
    """so + sd * t_max and -sd on finite segments, the forward ray on sun
    rays (t_max 1e20), against the JAX expression
    (models/wavefront.py:353-362) jitted."""
    rng = np.random.RandomState(0)
    n = 100000
    so = rng.uniform(-50, 50, (n, 3)).astype(np.float32)
    sd = rng.normal(size=(n, 3)).astype(np.float32)
    sd /= np.linalg.norm(sd, axis=1, keepdims=True)
    st = rng.uniform(0, 80, n).astype(np.float32)
    st[::7] = np.float32(1e20)

    @jax.jit
    def jax_rev(so, sd, st_):
        finite = st_ < 1e19
        return (jnp.where(finite[:, None], so + sd * st_[:, None], so),
                jnp.where(finite[:, None], -sd, sd))

    want = [np.asarray(x) for x in jax_rev(so, sd, st)]
    got = [x.numpy() for x in reverse_segments(
        torch.from_numpy(so), torch.from_numpy(sd), torch.from_numpy(st))]
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
    np.testing.assert_array_equal(got[0][::7], so[::7])


@pytest.fixture(scope="module")
def cornell():
    jscene, jmeta = jax_load_scene(JaxRenderConfig(scene_path="proc:cornell",
                                                   sun_enabled=True))
    tscene, tmeta = load_scene(RenderConfig(scene_path="proc:cornell",
                                            sun_enabled=True), "cpu")
    jcp = jcam.generate_image_plane(JaxCameraConfig(**CORNELL))
    tcp = tcam.camera_from_numpy({k: np.asarray(v) for k, v in
                                  jcp._asdict().items()}, "cpu")
    return (jscene, jmeta, jcp), (tscene, tmeta, tcp)


@pytest.mark.parametrize("seed", [0, 1])
def test_shadow_rev_lanes_match_jax(cornell, seed):
    """render_sample_impl with shadow_rev on cornell with the sun (so both
    the reversed emitter segments and the forward sun rays run), 32x32, 4
    bounces, against the jitted JAX function: the same paths and shadow
    rays (ray counts equal). Measured: 367 and 379 of 1,024 lanes not
    bitwise (seeds 0 and 1), every lane within rtol 1e-4, max |diff|
    1.4e-5 (the shading's last-place differences, as
    tests/test_torch_integrators.py states them); the means equal in
    float32. Held: every lane within rtol 1e-3 and atol 1e-6, the means
    within 1e-5 relative."""
    (jscene, jmeta, jcp), (tscene, tmeta, tcp) = cornell
    w = h = 32
    px = (np.arange(w * h) % w).astype(np.float32)
    py = (np.arange(w * h) // w).astype(np.float32)
    kw = dict(width=w, height=h, max_bounces=4, shadow_rev=True, sun=True)
    want, jrays = jax_render(jscene, jcp, jnp.asarray(px), jnp.asarray(py),
                             jax.random.PRNGKey(seed),
                             stack_depth=jmeta.stack_depth,
                             leaf_size=jmeta.leaf_size, **kw)
    got, rays = render_sample_impl(tscene, tcp, torch.from_numpy(px),
                                   torch.from_numpy(py),
                                   random.PRNGKey(seed),
                                   stack_depth=tmeta.stack_depth,
                                   leaf_size=tmeta.leaf_size, **kw)
    got, want = got.numpy(), np.asarray(want)
    assert int(rays) == int(jrays)
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-5)


def _cfg(**kw):
    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=16, height=16, max_bounces=4, **kw)
    cfg.camera = CameraConfig(**CORNELL)
    return cfg


def _film(cfg, scene=None, meta=None, frames=2):
    r = Renderer(cfg, "cpu", scene=scene, meta=meta)
    for _ in range(frames):
        r.render_frame("wavefront")
    r.stats.finalize()
    return r.film_hdr(), r.stats.rays_traced, r


def _outside(img, ref, tol=2e-3):
    return (np.abs(img - ref) > tol + tol * np.abs(ref)).any(-1)


@pytest.fixture(scope="module")
def jax_sort_rev_film():
    """The JAX Renderer's film with sort_rays and shadow_rev both on, and its
    ray count: one configuration (one XLA compile) that both film tests
    hold the port to."""
    jr = JaxRenderer(JaxRenderConfig.from_json(
        _cfg(sort_rays=True, shadow_rev=True).to_json()))
    for _ in range(2):
        jr.render_frame("wavefront")
    jr.stats.finalize()
    return np.asarray(jr.film_hdr()), jr.stats.rays_traced


def _hold_to_jax(film, n, jax_film):
    """Held as tests/test_torch_render.py holds the wavefront films: at most
    1% of pixels outside rtol = atol = 2e-3, the channel means within
    0.5%, the ray counts equal."""
    want, jrays = jax_film
    assert _outside(film, want).mean() <= 0.01
    np.testing.assert_allclose(film.mean(axis=(0, 1)),
                               want.mean(axis=(0, 1)), rtol=5e-3)
    assert n == jrays


def test_sort_rays_film_bitwise_unsorted_and_matches_jax(jax_sort_rev_film):
    """sort_rays on the default traversal and on top of the treelet sort
    (which it takes precedence over for the closest trace, the shadow rays
    keeping the shared treelet permutation, as in JAX): every film bitwise
    the unsorted one, the ray counts equal; with shadow_rev too, bitwise
    the shadow_rev film. That film against the JAX Renderer's sort_rays +
    shadow_rev film (measured: 0 pixels outside rtol = atol = 2e-3, max
    |diff| 2.9e-4)."""
    ref, rays, r = _film(_cfg())
    assert ref.max() > 0
    for kw in (dict(sort_rays=True),
               dict(sort_rays=True, bounce_traversal="tsort", treelet_min=1)):
        for k in SORTED:
            SORTED[k] = 0
        film, n, _ = _film(_cfg(**kw), r.scene, r.meta)
        np.testing.assert_array_equal(film.view(np.int32), ref.view(np.int32))
        assert n == rays
        if "bounce_traversal" in kw:
            # The shadow rays rode the shared permutation; each closest
            # trace took the coherence order, then (as JAX's
            # trace_closest(traversal="tsort") does) a treelet sort of its
            # own: two sorts a bounce.
            assert SORTED["sorts"] == 2 * SORTED["occluded"] > 0
            assert SORTED["closest"] == SORTED["occluded"]
    rev, n_rev, _ = _film(_cfg(shadow_rev=True), r.scene, r.meta)
    film, n, _ = _film(_cfg(sort_rays=True, shadow_rev=True), r.scene, r.meta)
    np.testing.assert_array_equal(film.view(np.int32), rev.view(np.int32))
    assert n == n_rev
    _hold_to_jax(film, n, jax_sort_rev_film)


def test_shadow_rev_film_matches_default_and_jax(jax_sort_rev_film):
    """The light-end film against the default film (occlusion is symmetric
    in the segment: measured bitwise equal on this film, the ray counts
    equal) and against the JAX Renderer's film with shadow_rev (and
    sort_rays, which changes no bit of the port's film: the test above;
    measured: 0 pixels outside rtol = atol = 2e-3, max |diff| 2.9e-4),
    both held as the wavefront films are."""
    ref, rays, r = _film(_cfg())
    film, n, _ = _film(_cfg(shadow_rev=True), r.scene, r.meta)
    assert n == rays
    assert _outside(film, ref).mean() <= 0.01
    np.testing.assert_allclose(film.mean(axis=(0, 1)), ref.mean(axis=(0, 1)),
                               rtol=5e-3)
    _hold_to_jax(film, n, jax_sort_rev_film)
