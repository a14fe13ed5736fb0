"""The port's megakernel path against the JAX package's, lane by lane: the
port's ``render_sample_mega`` (on the CPU, ``trace_mega_plain``) against
the JAX ``render_sample_mega`` with the Pallas kernel in interpret mode,
on the same tables, camera and key, and the two Renderers with
``megakernel="on"``.

The random streams are equal bit for bit (threefry raygen, randint packet
seeds, the lowbias32 hash), so every lane traces the same path. What is
left are last-place differences: XLA on the CPU contracts multiply-adds in
the shading arithmetic, takes rsqrt from the x86 estimate and two Newton
steps (the port divides by a correctly rounded root), and has its own
sin/cos/log/exp. Measured per case (this file's inputs): the number of
lanes not bitwise equal, the largest relative difference among them, and
the ray counts, which were equal in every case (no path took another
turn). Each case runs one static configuration of the JAX function (one
XLA compile of about 8 s).
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.config import CameraConfig, RenderConfig
from gpupathtracer_tpu.math.camera import generate_image_plane
from gpupathtracer_tpu.ops import megakernel as jmega
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch import config as tconfig
from gpupathtracer_tpu_torch import random as trandom
from gpupathtracer_tpu_torch.math.camera import camera_from_numpy
from gpupathtracer_tpu_torch.ops import megakernel as mega
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import scene_from_numpy
from gpupathtracer_tpu_torch.scene.procedural import default_camera

W = H = 16
RTOL, ATOL = 1e-5, 1e-6


def _camera(name):
    if name == "cornell":  # tests/test_megakernel.py's camera
        return CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                            fov=math.radians(45), aspect=1.0)
    pos, yaw, pitch, fov, aperture, focus = default_camera(name)
    return CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                        fov=math.radians(fov), aspect=1.0, aperture=aperture,
                        focal_distance=focus)


def _cfg(name, **kw):
    cfg = RenderConfig(scene_path=f"proc:{name}",
                       skybox="GENERATE COLOR BLACK", width=W, height=H, **kw)
    cfg.camera = _camera(name)
    return cfg


_SCENES = {}


def _scene(name):
    """(JAX scene, meta, camera; the port's copies of the same tables)."""
    if name not in _SCENES:
        cfg = _cfg(name)
        js, jmeta = jax_load_scene(cfg)
        jcam = generate_image_plane(cfg.camera)
        ts = scene_from_numpy(dict(
            tri_shade=js.tri_shade, light_rows=js.light_rows,
            light_cdf=js.light_cdf, total_light_area=js.total_light_area,
            mat_rows=js.mat_rows, env=js.env.image,
            node_rows=js.bvh.node_rows), "cpu")
        tcam = camera_from_numpy(
            {k: np.asarray(v) for k, v in jcam._asdict().items()}, "cpu")
        _SCENES[name] = (js, jmeta, jcam, ts, tcam)
    return _SCENES[name]


def _statics(name, model, max_bounces, packet_size):
    """The keywords of the JAX Renderer's megakernel call, in its order
    (render/renderer.py:304-317), so that case (a) shares its compile."""
    js, jmeta = _scene(name)[:2]
    return dict(width=W, height=H, stack_depth=jmeta.stack_depth,
                leaf_size=jmeta.leaf_size, max_bounces=max_bounces, nee=True,
                model=model, n_mats=jmeta.num_materials,
                n_lights=int(js.light_rows.shape[0]),
                packet_size=packet_size)


def _both(name, model, max_bounces, packet_size, n, spp, seed, sample_idx,
          fused_nee=False):
    """Contributions and rays of both packages for the first n pixels."""
    js, _, jcam, ts, tcam = _scene(name)
    idx = np.arange(n)
    px = (idx % W).astype(np.float32)
    py = (idx // W).astype(np.float32)
    kw = _statics(name, model, max_bounces, packet_size)
    jkw = dict(kw, interpret=True, fused_nee=False)
    if spp > 1 or fused_nee:
        jkw.update(spp=spp, fused_nee=fused_nee)
    jc, jr = jmega.render_sample_mega(
        js, jmega.pack_mega_tables(js), jcam, jnp.asarray(px),
        jnp.asarray(py), jax.random.PRNGKey(seed), sample_idx=sample_idx,
        **jkw)
    tc, tr = mega.render_sample_mega(
        ts, mega.pack_mega_tables(ts), tcam, torch.from_numpy(px),
        torch.from_numpy(py), trandom.PRNGKey(seed), sample_idx=sample_idx,
        spp=spp, **kw)
    return np.asarray(jc), int(jr), tc.numpy(), int(tr)


def _lane_report(got, want):
    """(lanes not bitwise equal, largest relative difference among them,
    mask of lanes within RTOL / ATOL)."""
    differ = (got.view(np.int32) != want.view(np.int32)).any(1)
    rel = np.abs(got - want) / np.maximum(np.abs(want), 1e-30)
    worst = float(rel[differ].max()) if differ.any() else 0.0
    close = (np.abs(got - want) <= ATOL + RTOL * np.abs(want)).all(1)
    return int(differ.sum()), worst, close


# case -> (scene, model, max_bounces, packet_size, n, spp, least share of
# lanes within RTOL / ATOL). Measured on the CPU: lanes not bitwise
# equal; largest relative difference among them; lanes outside the bound.
CASES = {
    # 132 of 256; 1.1e-5; none (the 1.1e-5 lane is inside ATOL).
    "a_cornell_direct": ("cornell", "trowbridge_reitz", 0, 2048, 256, 1,
                         1.0),
    # 128 of 200; 3.9e-6; none. n = 200 pads to two packets of 128.
    "b_cornell_padded": ("cornell", "trowbridge_reitz", 6, 128, 200, 1,
                         0.99),
    # 254 of 256; 1.3e-5; one (lane 149: 1.3e-5 after eight Beckmann
    # bounces of rounding, on a contribution of 31.5).
    "c_bathroom_regen": ("bathroom", "beckmann", 8, 2048, 256, 4, 0.99),
    # 184 of 256; 3.2e-4 (on a small contribution: inside ATOL); none.
    "d_table_direct_regen": ("table", "trowbridge_reitz", 0, 2048, 256, 8,
                             0.99),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_lanes_match_jax(case):
    name, model, mb, packet, n, spp, share = CASES[case]
    jc, jr, tc, tr = _both(name, model, mb, packet, n, spp, seed=5,
                           sample_idx=3)
    assert tc.shape == jc.shape == (n, 3) and np.isfinite(tc).all()
    # Bounce rays plus live shadow rays: equal, as no path diverged.
    assert tr == jr
    _, _, close = _lane_report(tc, jc)
    assert close.mean() >= share, np.nonzero(~close)[0]
    assert jc.mean() > 0


def test_fused_nee_and_fori_match_jax():
    """Case (b) against the JAX kernel's deferred-shadow schedule
    (fused_nee=True), at tests/test_megakernel.py's own bound for it
    (rtol=2e-3, atol=1e-5; measured: 141 of 200 lanes not bitwise equal,
    the largest relative difference 1.7e-6, the same ray counts), and
    render_sample_mega_batch(fori=True)
    against the sum of two JAX single-sample calls with case (b)'s
    statics."""
    jc, jr, tc, tr = _both("cornell", "trowbridge_reitz", 6, 128, 200, 1,
                           seed=11, sample_idx=0, fused_nee=True)
    assert tr == jr
    np.testing.assert_allclose(tc, jc, rtol=2e-3, atol=1e-5)

    js, _, jcam, ts, tcam = _scene("cornell")
    kw = _statics("cornell", "trowbridge_reitz", 6, 128)
    idx = np.arange(200)
    px = (idx % W).astype(np.float32)
    py = (idx // W).astype(np.float32)
    tc, tr = mega.render_sample_mega_batch(
        ts, mega.pack_mega_tables(ts), tcam, torch.from_numpy(px),
        torch.from_numpy(py), trandom.PRNGKey(2), spp=2, sample_idx=4,
        fori=True, **kw)
    want, rays = 0.0, 0
    for i in range(2):
        c, r = jmega.render_sample_mega(
            js, jmega.pack_mega_tables(js), jcam, jnp.asarray(px),
            jnp.asarray(py), jax.random.fold_in(jax.random.PRNGKey(2), i),
            sample_idx=4 + i, **dict(kw, interpret=True, fused_nee=False))
        want, rays = want + np.asarray(c), rays + int(r)
    assert int(tr) == rays
    _, _, close = _lane_report(tc.numpy(), want)
    assert close.mean() >= 0.99


def test_renderer_matches_jax():
    """Both Renderers with megakernel='on' on cornell 16x16: a direct frame
    at frame_batch 1 (case (a)'s compile) and a path-traced frame at
    frame_batch 4 (in-kernel regeneration). Measured: films within
    rtol 1e-5 / atol 1e-6 at every pixel, the same ray counts."""
    for batch, integrator in ((1, "direct"), (4, "wavefront")):
        jcfg = _cfg("cornell", max_bounces=6, frame_batch=batch,
                    megakernel="on", traversal="pallas")
        js, jmeta = _scene("cornell")[:2]
        jr = JaxRenderer(jcfg, scene=js, meta=jmeta)
        tcfg = _cfg("cornell", max_bounces=6, frame_batch=batch,
                    megakernel="on")
        tr = Renderer(tconfig.RenderConfig.from_json(tcfg.to_json()), "cpu",
                      scene=_scene("cornell")[3], meta=jmeta)
        assert jr.use_mega and tr.use_mega
        jr.render_frame(integrator, sync=True)
        tr.render_frame(integrator)
        want, got = np.asarray(jr.film_hdr()), tr.film_hdr()
        assert got.shape == want.shape == (H, W, 3)
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
        assert got.mean() > 0
        jr.stats.finalize()
        tr.stats.finalize()
        assert tr.stats.rays_traced == jr.stats.rays_traced
