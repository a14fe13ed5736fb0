"""The megakernel's cluster walks (the JAX kernel's ``cluster=True``)
against the JAX package, lane by lane: the port's ``render_sample_mega``
on a cluster scene (on the CPU, ``trace_mega_plain`` with the plain
cluster walk) against the JAX ``render_sample_mega`` with the Pallas kernel
in interpret mode, on the same tables, camera and key.

Both walks find the same hits bit for bit (tests/test_torch_cluster.py),
and the random streams are equal, so every lane traces the same path. What
is left are the shading's last-place differences of
tests/test_torch_mega_render.py (XLA's contracted multiply-adds, its rsqrt,
its transcendentals). Measured per case on this file's inputs: lanes not
bitwise equal, the largest relative difference among them, lanes outside
rtol 1e-5 / atol 1e-6; the ray counts were equal in every case. Each case
is one XLA compile of the JAX function (about 7 s).
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
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch import config as tconfig
from gpupathtracer_tpu_torch import random as trandom
from gpupathtracer_tpu_torch.math.camera import camera_from_numpy
from gpupathtracer_tpu_torch.ops import megakernel as mega
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import load_scene, scene_from_numpy
from gpupathtracer_tpu_torch.scene.procedural import default_camera

W = H = 16
RTOL, ATOL = 1e-5, 1e-6
CLUSTER_FIELDS = ("node_rows", "cluster_rows", "cluster_refs")

_SCENE = {}


def _bathroom():
    """(JAX scene, meta, camera; the port's copies of the same tables):
    proc:bathroom at cluster_tris=128."""
    if not _SCENE:
        pos, yaw, pitch, fov, aperture, focus = default_camera("bathroom")
        cfg = RenderConfig(scene_path="proc:bathroom", cluster_tris=128,
                           skybox="GENERATE COLOR BLACK", width=W, height=H)
        cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                                  fov=math.radians(fov), aspect=1.0,
                                  aperture=aperture, focal_distance=focus)
        js, jmeta = jax_load_scene(cfg)
        jcam = generate_image_plane(cfg.camera)
        fields = dict(tri_shade=js.tri_shade, light_rows=js.light_rows,
                      light_cdf=js.light_cdf,
                      total_light_area=js.total_light_area,
                      mat_rows=js.mat_rows, env=js.env.image)
        fields.update({f: getattr(js.bvh, f) for f in CLUSTER_FIELDS})
        ts = scene_from_numpy(fields, "cpu")
        tcam = camera_from_numpy(
            {k: np.asarray(v) for k, v in jcam._asdict().items()}, "cpu")
        _SCENE.update(js=js, jmeta=jmeta, jcam=jcam, ts=ts, tcam=tcam)
    return _SCENE


# case -> (spp, seed, sample index, least share of lanes within RTOL /
# ATOL). Measured: lanes not bitwise equal; largest relative difference
# among them; lanes outside the bound.
CASES = {
    # 238 of 256; 2.5e-5; one (lane 222, after eight Beckmann bounces).
    "one_sample": (1, 5, 0, 0.99),
    # 249 of 256; 5.1e-6; none.
    "regen_4spp": (4, 5, 0, 0.99),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_cluster_lanes_match_jax(case):
    """Bathroom 16x16, Beckmann, 8 bounces; one sample from threefry
    raygen, and four with in-kernel regeneration."""
    spp, seed, sample_idx, share = CASES[case]
    s = _bathroom()
    js, jmeta = s["js"], s["jmeta"]
    idx = np.arange(W * H)
    px = (idx % W).astype(np.float32)
    py = (idx // W).astype(np.float32)
    kw = dict(width=W, height=H, stack_depth=jmeta.stack_depth,
              leaf_size=jmeta.leaf_size, max_bounces=8, nee=True,
              model="beckmann", n_mats=jmeta.num_materials,
              n_lights=int(js.light_rows.shape[0]), packet_size=2048)
    jc, jr = jmega.render_sample_mega(
        js, jmega.pack_mega_tables(js), s["jcam"], jnp.asarray(px),
        jnp.asarray(py), jax.random.PRNGKey(seed), sample_idx=sample_idx,
        interpret=True, spp=spp, **kw)
    before = dict(mega.LAUNCHES)
    tc, tr = mega.render_sample_mega(
        s["ts"], mega.pack_mega_tables(s["ts"]), s["tcam"],
        torch.from_numpy(px), torch.from_numpy(py), trandom.PRNGKey(seed),
        sample_idx=sample_idx, spp=spp, **kw)
    assert mega.LAUNCHES == before  # CPU: the plain version
    jc, tc = np.asarray(jc), tc.numpy()
    assert tc.shape == jc.shape == (W * H, 3) and np.isfinite(tc).all()
    assert int(tr) == int(jr)  # no path took another turn
    close = (np.abs(tc - jc) <= ATOL + RTOL * np.abs(jc)).all(1)
    assert close.mean() >= share, np.nonzero(~close)[0]
    assert jc.mean() > 0


def test_cluster_gate_and_fused_nee(monkeypatch):
    """mega_eligible counts the cluster table's bytes, as the JAX gate
    does; fused_nee and partition_chips are refused on cluster leaves, as
    in the JAX package; the port's own config drives the port's scene
    load."""
    cfg = RenderConfig(scene_path="proc:table", cluster_tris=128,
                       skybox="GENERATE COLOR BLACK")
    jscene, jmeta = jax_load_scene(cfg)
    scene, meta = load_scene(tconfig.RenderConfig(
        scene_path="proc:table", cluster_tris=128,
        skybox="GENERATE COLOR BLACK"), "cpu")
    flags = dict(textured=False, delta=False, sun=False)
    assert mega.mega_eligible(scene, meta, **flags)
    assert jmega.mega_eligible(jscene, jmeta, **flags)
    # A limit above the node rows' bytes, below node rows + cluster blocks.
    monkeypatch.setattr(mega, "TABLE_LIMIT", scene.node_rows.numel() * 4 + 4)
    assert not mega.mega_eligible(scene, meta, **flags)
    monkeypatch.undo()
    n = 128
    o = torch.zeros((n, 3))
    d = torch.zeros((n, 3))
    d[:, 2] = 1.0
    args = (scene.node_rows, *mega.pack_mega_tables(scene), o, d,
            torch.ones(n, dtype=torch.bool), torch.zeros(1, dtype=torch.int32))
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              max_bounces=2, nee=True, model="trowbridge_reitz",
              n_mats=meta.num_materials,
              n_lights=int(scene.light_rows.shape[0]), packet_size=n,
              cluster_rows=scene.cluster_rows)
    c, rays = mega.trace_mega(*args, **kw)
    assert c.shape == (n, 3) and int(rays) >= n
    with pytest.raises(ValueError):
        mega.trace_mega(*args, fused_nee=True, **kw)
    # The partitioned render builds its own tables (the JAX Renderer's
    # check): refused before any scene is loaded.
    with pytest.raises(ValueError):
        Renderer(tconfig.RenderConfig(scene_path="proc:cornell",
                                      cluster_tris=128, partition_chips=2),
                 "cpu")
