"""Dense cluster leaves (``cfg.cluster_tris``) in the port against the JAX
package: the port's own copy of ``pack_clusters`` builds byte-equal
tables, the plain version of the cluster traversal kernel
(ops/kernel_cluster.py) matches ``traverse_pallas(cluster_rows=...)`` in
interpret mode, and the wavefront Renderer on a cluster scene matches the
JAX Renderer that reaches the cluster kernel (``traversal="pallas"``).

The plain version writes every dot product of the cluster leaf in the
order of XLA's CPU dot and every multiply-add that LLVM contracts there as
one fused multiply-add (bvh_walk.cuh dot_k3 / dot_rc), so t, u, v and the
global prim are bit-identical to the interpret-mode kernel: measured in
every lane of every case below, no tie allowed.
"""

import math

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu import config as jax_config
from gpupathtracer_tpu.bvh import build_wide_bvh as jax_build_wide_bvh
from gpupathtracer_tpu.bvh.cluster import pack_clusters as jax_pack_clusters
from gpupathtracer_tpu.config import RenderConfig
from gpupathtracer_tpu.ops.pallas_traverse import traverse_pallas
from gpupathtracer_tpu.ops.traverse import remap_cluster_prims
from gpupathtracer_tpu.ops.traverse import trace_closest as jax_trace_closest
from gpupathtracer_tpu.ops.traverse import \
    trace_occluded as jax_trace_occluded
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch import config as tconfig
from gpupathtracer_tpu_torch.bvh import build_wide_bvh
from gpupathtracer_tpu_torch.bvh.cluster import pack_clusters
from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
from gpupathtracer_tpu_torch.ops.traverse import trace_closest, trace_occluded
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import load_scene
from gpupathtracer_tpu_torch.scene.mesh import build_triangle_soup
from gpupathtracer_tpu_torch.scene.procedural import (default_camera,
                                                      load_procedural)
from test_torch_kernel import cluster_soup_case, twin_slots

CLUSTER_FIELDS = ("node_rows", "cluster_rows", "cluster_refs", "cut_entry",
                  "cut_bounds")


def _soup(seed=7, n_tris=1500):
    """A random soup of small triangles (tests/test_pallas.py's recipe):
    p0, e1, e2 [T, 3], a material id and a normal sign per triangle."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-5, 5, (n_tris, 1, 3))
    tri = (base + rng.uniform(-0.6, 0.6, (n_tris, 3, 3))).astype(np.float32)
    mat = rng.randint(0, 5, n_tris).astype(np.int32)
    nsign = np.where(rng.rand(n_tris) < 0.5, -1.0, 1.0).astype(np.float32)
    return tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0], mat, nsign


def _table_tris():
    soup = build_triangle_soup(load_procedural("proc:table")[0])
    gn = np.cross(soup.e1, soup.e2)
    nsign = np.where(np.einsum("ij,ij->i", gn, soup.normal) < 0.0,
                     -1.0, 1.0).astype(np.float32)
    return soup.p0, soup.e1, soup.e2, soup.mat, nsign


@pytest.mark.parametrize("source,tc", [("soup", 128), ("soup", 256),
                                       ("table", 128)])
def test_pack_clusters_byte_equal(source, tc):
    """The port's bvh/ copy (C++ SBVH, collapse, cluster cut, inverse rows,
    treelet cut) against the JAX package's, from the same triangles."""
    p0, e1, e2, mat, nsign = _soup() if source == "soup" else _table_tris()
    packed = []
    for build, pack in ((build_wide_bvh, pack_clusters),
                        (jax_build_wide_bvh, jax_pack_clusters)):
        wide, _ = build(p0, p0 + e1, p0 + e2)
        packed.append(pack(wide, p0, e1, e2, tc=tc, tri_mat=mat,
                           tri_nsign=nsign))
    got, want = packed
    for field in CLUSTER_FIELDS:
        a, b = np.asarray(getattr(got, field)), np.asarray(getattr(want, field))
        assert a.dtype == b.dtype and a.shape == b.shape, field
        assert a.tobytes() == b.tobytes(), field
    assert want.cluster_rows.shape[1] == 3 * tc


def _case(source, tc, n_rays, seed):
    """(tables as numpy, stack depth, rays o, d [N, 3], t_max for closest
    and for occlusion, active mask with about 15% of lanes off)."""
    rng = np.random.RandomState(seed)
    if source == "table":
        cfg = RenderConfig(scene_path="proc:table", cluster_tris=tc)
        js, jmeta = jax_load_scene(cfg)
        tables = {f: np.asarray(getattr(js.bvh, f))
                  for f in ("node_rows", "cluster_rows", "cluster_refs")}
        depth = jmeta.stack_depth
        o = rng.uniform(-1, 1, (n_rays, 3)) * 2 + [0, 1, 0]
        d = rng.normal(size=(n_rays, 3))
    else:
        p0, e1, e2, mat, nsign = _soup()
        wide, stats = jax_build_wide_bvh(p0, p0 + e1, p0 + e2)
        wide = jax_pack_clusters(wide, p0, e1, e2, tc=tc, tri_mat=mat,
                                 tri_nsign=nsign)
        tables = {f: np.asarray(getattr(wide, f))
                  for f in ("node_rows", "cluster_rows", "cluster_refs")}
        depth = min(stats.max_depth * 7 + 2, 192)
        o = rng.uniform(-8, 8, (n_rays, 3))
        d = rng.uniform(-4, 4, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(tables=tables, depth=depth, o=o.astype(np.float32),
                d=d.astype(np.float32),
                far=np.full(n_rays, 1e20, np.float32),
                t_occ=rng.uniform(0.05, 6.0, n_rays).astype(np.float32),
                act=rng.rand(n_rays) < 0.85)


def _pallas(case, t_max, any_hit):
    """The JAX cluster kernel in interpret mode, packets of 128 rays."""
    P = case["o"].shape[0] // 128
    t, prim, u, v = traverse_pallas(
        jnp.asarray(case["tables"]["node_rows"]),
        jnp.asarray(case["o"]).reshape(P, 128, 3),
        jnp.asarray(case["d"]).reshape(P, 128, 3),
        jnp.asarray(t_max).reshape(P, 128),
        jnp.asarray(case["act"]).reshape(P, 128),
        stack_depth=case["depth"], any_hit=any_hit, ordered=not any_hit,
        interpret=True,
        cluster_rows=jnp.asarray(case["tables"]["cluster_rows"]))
    return [np.asarray(x).reshape(-1) for x in (t, prim, u, v)]


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("source,tc,n_rays", [("table", 128, 512),
                                              ("soup", 256, 256)])
def test_plain_matches_cluster_kernel(source, tc, n_rays):
    """B4 (_kernel_cluster): ordered closest hit and unordered any-hit."""
    case = _case(source, tc, n_rays, seed=3)
    tab = {k: torch.tensor(v) for k, v in case["tables"].items()}
    rays = [torch.from_numpy(case[k]) for k in ("o", "d")]
    act = torch.from_numpy(case["act"])
    t, prim_local, u, v = _pallas(case, case["far"], any_hit=False)
    refs = case["tables"]["cluster_refs"]
    prim = np.where(prim_local >= 0, refs[np.clip(prim_local, 0, None)], -1)
    got = kc.closest_cluster(tab["node_rows"], tab["cluster_rows"],
                             tab["cluster_refs"], *rays,
                             torch.from_numpy(case["far"]), act,
                             stack_depth=case["depth"])
    # Global prims, t, u, v: bitwise in every lane (no tie in these rays).
    for g, w in zip(got, (t, prim, u, v)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    hit = got[1].numpy() >= 0
    assert 0.2 < hit.mean() < 0.95
    # Inactive lanes are untouched: t_max, no prim, zero barycentrics.
    off = ~case["act"]
    assert (got[0].numpy()[off] == case["far"][off]).all()
    assert (got[1].numpy()[off] == -1).all()
    assert not got[2].numpy()[off].any() and not got[3].numpy()[off].any()

    occ_prim = _pallas(case, case["t_occ"], any_hit=True)[1]
    occ = kc.anyhit_cluster(tab["node_rows"], tab["cluster_rows"], *rays,
                            torch.from_numpy(case["t_occ"]), act,
                            stack_depth=case["depth"])
    np.testing.assert_array_equal(occ.numpy(), occ_prim >= 0)
    assert 0.05 < occ.numpy().mean() < 0.95
    assert not occ.numpy()[off].any()


def test_plain_cluster_ties_match_cluster_kernel():
    """B4 where equal t falls on different slots of one block: every
    triangle of a soup twice (cluster_soup_case). The twins share a block,
    and a ray that hits one ties with the other. The plain version keeps
    the lowest slot, as _kernel_cluster does (pallas_traverse.py:507-538):
    closest t, prim, u, v bitwise; any-hit occluded equal."""
    case = cluster_soup_case(n_tris=300, n_rays=256, duplicate=True)
    blk0, blk1, slot0, slot1 = twin_slots(case)
    assert (blk0 == blk1).all() and (slot0 != slot1).all()
    tab = {k: torch.tensor(v) for k, v in case["tables"].items()}
    rays = [torch.from_numpy(case[k]) for k in ("o", "d")]
    act = torch.from_numpy(case["act"])
    t, prim_local, u, v = _pallas(case, case["far"], any_hit=False)
    refs = case["tables"]["cluster_refs"]
    prim = np.where(prim_local >= 0, refs[np.clip(prim_local, 0, None)], -1)
    got = kc.closest_cluster(tab["node_rows"], tab["cluster_rows"],
                             tab["cluster_refs"], *rays,
                             torch.from_numpy(case["far"]), act,
                             stack_depth=case["depth"])
    for g, w in zip(got, (t, prim, u, v)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # Every hit is a tie with its twin; the twin in the lower slot won.
    won = got[1].numpy()
    hit = won >= 0
    assert hit.sum() >= 32
    lower = np.where(slot0 < slot1, 0, 1)
    assert (won[hit] % 2 == lower[won[hit] // 2]).all()
    occ_prim = _pallas(case, case["t_occ"], any_hit=True)[1]
    occ = kc.anyhit_cluster(tab["node_rows"], tab["cluster_rows"], *rays,
                            torch.from_numpy(case["t_occ"]), act,
                            stack_depth=case["depth"])
    np.testing.assert_array_equal(occ.numpy(), occ_prim >= 0)
    assert 0.05 < occ.numpy().mean() < 0.95


def test_wrapper_rejects_bad_cluster_tables():
    case = _case("table", 128, 128, seed=1)
    tab = {k: torch.tensor(v) for k, v in case["tables"].items()}
    rays = [torch.from_numpy(case[k]) for k in ("o", "d", "far", "act")]
    kw = dict(stack_depth=case["depth"])
    with pytest.raises(ValueError):  # tc not a multiple of 128
        kc.closest_cluster(tab["node_rows"], tab["cluster_rows"][:, :300],
                           tab["cluster_refs"], *rays, **kw)
    with pytest.raises(ValueError):
        kc.closest_cluster(tab["node_rows"], tab["cluster_rows"],
                           tab["cluster_refs"][:-1], *rays, **kw)
    with pytest.raises(ValueError):
        kc.anyhit_cluster(tab["node_rows"], tab["cluster_rows"].double(),
                          *rays, **kw)
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain path
        kc.anyhit_cluster(*(x.to("meta") for x in
                            (tab["node_rows"], tab["cluster_rows"], *rays)),
                          **kw)
    before = dict(kc.LAUNCHES)
    kc.anyhit_cluster(tab["node_rows"], tab["cluster_rows"], *rays, **kw)
    assert kc.LAUNCHES == before  # CPU: the plain version, not counted


def test_trace_queries_match_jax_pallas_hit():
    """ops/traverse.py dispatches cluster scenes to the cluster kernel;
    against the JAX trace_closest / trace_occluded with traversal="pallas"
    (``_pallas_hit``: padding to whole packets, the cluster kernel, the
    ``remap_cluster_prims`` gather)."""
    cfg = RenderConfig(scene_path="proc:table", cluster_tris=128)
    js, jmeta = jax_load_scene(cfg)
    scene, meta = load_scene(tconfig.RenderConfig(scene_path="proc:table",
                                                  cluster_tris=128), "cpu")
    assert scene.cluster_rows is not None
    case = _case("table", 128, 300, seed=9)  # 300: padded to 3 packets
    o, d = (jnp.asarray(case[k]) for k in ("o", "d"))
    act = jnp.asarray(case["act"])
    kw = dict(stack_depth=jmeta.stack_depth, leaf_size=jmeta.leaf_size)
    want = jax_trace_closest(js, o, d, jnp.asarray(case["far"]), act,
                             traversal="pallas", **kw)
    rays = [torch.from_numpy(case[k]) for k in ("o", "d")]
    got = trace_closest(scene, *rays, torch.from_numpy(case["far"]),
                        torch.from_numpy(case["act"]), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert (got.prim.numpy() < meta.num_triangles).all()
    # The remap is the JAX package's: prims are global triangle ids.
    local = _pallas(dict(case, tables={
        f: np.asarray(getattr(js.bvh, f))
        for f in ("node_rows", "cluster_rows", "cluster_refs")},
        o=case["o"][:256], d=case["d"][:256], act=case["act"][:256]),
        case["far"][:256], any_hit=False)[1]
    np.testing.assert_array_equal(
        np.asarray(remap_cluster_prims(js, jnp.asarray(local))),
        got.prim.numpy()[:256])
    occ_want = jax_trace_occluded(js, o, d, jnp.asarray(case["t_occ"]), act,
                                  traversal="pallas", **kw)
    occ = trace_occluded(scene, *rays, torch.from_numpy(case["t_occ"]),
                         torch.from_numpy(case["act"]), **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_want))


def _table_cfg(config_module, **kw):
    pos, yaw, pitch, fov, aperture, focus = default_camera("proc:table")
    cfg = config_module.RenderConfig(
        scene_path="proc:table", cluster_tris=128,
        skybox="GENERATE COLOR BLACK", width=16, height=16, max_bounces=8,
        **kw)
    cfg.camera = config_module.CameraConfig(
        position=pos, yaw=yaw, pitch=pitch, fov=math.radians(fov),
        aspect=1.0, aperture=aperture, focal_distance=focus)
    return cfg


def test_renderer_matches_jax_on_cluster_scene():
    """The slice as a whole: the port's Renderer with cluster_tris=128 on
    proc:table 16x16 at 2 spp against the JAX Renderer with
    traversal="pallas", which reaches the cluster kernel in interpret mode
    (its "auto" takes the per-lane MT traversal on the CPU). Same hits, so
    only the shading's last-place differences remain (ROADMAP.md C).
    Measured: max |diff| 1.5e-5 per pixel, the same ray counts; held at
    the golden's rtol = atol = 2e-3 per pixel."""
    jr = JaxRenderer(_table_cfg(jax_config, traversal="pallas"))
    r = Renderer(_table_cfg(tconfig), "cpu")
    assert r.scene.cluster_rows is not None
    for renderer in (jr, r):
        for _ in range(2):
            renderer.render_frame("wavefront")
        renderer.stats.finalize()
    got, want = r.film_hdr(), np.asarray(jr.film_hdr())
    assert got.shape == want.shape == (16, 16, 3) and want.mean() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert r.stats.rays_traced == jr.stats.rays_traced
