"""Treelet-sorted dispatch of the port (ops/tsort.py) against the JAX
package's ops/tsort.py and against the port's unsorted traversal.

The sort is a schedule: every ray walks the whole tree, so every field of
every hit is held bitwise to the unsorted traversal. The permutation is
held to the JAX package's array (both argsorts are stable); the float keys
are a subtract and a multiply, which XLA cannot contract, and no lane
differed on either scene. Against ``trace_closest_tsort(interpret=True)`` t
is bitwise equal and prim equal (no tie occurred in these rays).
"""

import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.bvh import WideBVH
from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.ops import tsort as jax_tsort
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch.bvh import build_wide_bvh
from gpupathtracer_tpu_torch.bvh.wide import pack_for_packets
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
from gpupathtracer_tpu_torch.ops import tsort
from gpupathtracer_tpu_torch.ops.traverse import (trace_closest,
                                                  trace_occluded)
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import load_scene
from test_torch_kernel import _soup_case


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _port_scene(wide):
    """What ops/tsort.py reads of a SceneData, from a packed WideBVH."""
    return SimpleNamespace(node_rows=torch.tensor(wide.node_rows),
                           cluster_rows=None, cluster_refs=None,
                           cut_entry=torch.tensor(wide.cut_entry),
                           cut_bounds=torch.tensor(wide.cut_bounds),
                           arity=wide.child_entry.shape[1])


def _jax_scene(wide):
    return SimpleNamespace(bvh=WideBVH(*((jnp.asarray(a) if a is not None
                                          else None) for a in wide)))


def _big_soup():
    """A table of 8192 rows or more (the JAX Renderer's tsort gate on its
    TPU kernel): 20,000 small triangles, leaf size 4."""
    rng = np.random.RandomState(3)
    n = 20000
    tri = (rng.uniform(-5, 5, (n, 1, 3))
           + rng.uniform(-0.15, 0.15, (n, 3, 3))).astype(np.float32)
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    wide, _ = build_wide_bvh(p0, p1, p2, leaf_size=4, builder="numpy")
    return pack_for_packets(wide, p0, p1 - p0, p2 - p0, 4)


def _box_rays(lo, hi, n, seed):
    """Rays from around the box [lo, hi] toward points inside it, a random
    t_max (a third of them short) and about 15% inactive lanes."""
    rng = np.random.RandomState(seed)
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    o = (mid + rng.uniform(-1.6, 1.6, (n, 3)) * half).astype(np.float32)
    d = (mid + rng.uniform(-0.8, 0.8, (n, 3)) * half).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.rand(n) < 0.33, rng.uniform(0.1, 3.0, n),
                     1e20).astype(np.float32)
    return o, d, t_max, rng.rand(n) > 0.15


@pytest.fixture(scope="module")
def scenes():
    """name -> (port scene, JAX bvh): the table scene as each package loads
    it, and the big soup."""
    cfg = RenderConfig(scene_path="proc:table")
    port_table, _ = load_scene(cfg, "cpu")
    jax_table, _ = jax_load_scene(JaxRenderConfig.from_json(cfg.to_json()))
    wide = _big_soup()
    assert wide.node_rows.shape[0] >= 8192
    return {"table": (port_table, jax_table.bvh),
            "big": (_port_scene(wide), _jax_scene(wide).bvh)}


@pytest.mark.parametrize("key_mode", ["top1", "top2", "deep"])
@pytest.mark.parametrize("name", ["table", "big"])
def test_sort_perm_matches_jax(scenes, name, key_mode):
    scene, bvh = scenes[name]
    cb = scene.cut_bounds.numpy()
    o, d, t_max, act = _box_rays(cb[:, 0:3].min(0), cb[:, 3:6].max(0), 3000,
                                 seed=5)
    want = np.asarray(jax_tsort._sort_perm(
        bvh.cut_bounds, jnp.asarray(o), jnp.asarray(d), jnp.asarray(t_max),
        jnp.asarray(act), key_mode=key_mode, bvh=bvh))
    got = tsort._sort_perm(scene.cut_bounds, torch.tensor(o), torch.tensor(d),
                           torch.tensor(t_max), torch.tensor(act),
                           key_mode=key_mode, scene=scene).numpy()
    # The same array: 0 of 3000 lanes differ on either scene in any mode.
    assert int((got != want).sum()) == 0
    # A permutation; dead rays sort after the first live one.
    assert sorted(got.tolist()) == list(range(3000))
    assert act[got[0]] and np.argsort(got)[~act].min() > 0


def _soup_rays(case, n):
    return [torch.tensor(case[k][:n]) for k in ("o", "d")]


def test_tsort_equals_unsorted_and_jax():
    """700 rays (not a multiple of any packet size) of the random soup,
    10% inactive: closest and occluded, default arguments, every key mode
    and two rays per thread."""
    n = 700
    case = _soup_case(7, leaf=4, n_rays=n)
    scene = _port_scene(case["wide"])
    o, d = _soup_rays(case, n)
    far, t_occ, act = (torch.tensor(case[k]) for k in ("far", "t_occ", "act"))
    kw = dict(stack_depth=case["depth"], leaf_size=4)
    base = kt.closest_plain(scene.node_rows, o, d, far, act, **kw)
    occ_base = kt.anyhit_plain(scene.node_rows, o, d, t_occ, act, **kw)
    for extra in (dict(), dict(key_mode="top1"), dict(key_mode="deep"),
                  dict(interleave=2), dict(fused_pair=True),
                  dict(packet_size=128)):
        hit = tsort.trace_closest_tsort(scene, o, d, far, act, **kw, **extra)
        for g, b in zip(hit, base):
            np.testing.assert_array_equal(_bits(g), _bits(b))
        occ = tsort.trace_occluded_tsort(scene, o, d, t_occ, act, **kw,
                                         **extra)
        assert occ.dtype == torch.bool
        np.testing.assert_array_equal(occ.numpy(), occ_base.numpy())
    assert 0.05 < occ_base.float().mean() < 0.95

    jscene = _jax_scene(case["wide"])
    jkw = dict(stack_depth=case["depth"], leaf_size=4, packet_size=128,
               interpret=True)
    want = jax_tsort.trace_closest_tsort(
        jscene, *(jnp.asarray(case[k]) for k in ("o", "d", "far", "act")),
        **jkw)
    # t bitwise in every lane; prim, u, v too (no exact tie in these rays).
    np.testing.assert_array_equal(_bits(base[0]), _bits(want.t))
    np.testing.assert_array_equal(base[1].numpy(), np.asarray(want.prim))
    np.testing.assert_array_equal(_bits(base[2]), _bits(want.u))
    np.testing.assert_array_equal(_bits(base[3]), _bits(want.v))
    occ_want = jax_tsort.trace_occluded_tsort(
        jscene, *(jnp.asarray(case[k]) for k in ("o", "d", "t_occ", "act")),
        **jkw)
    np.testing.assert_array_equal(occ_base.numpy(), np.asarray(occ_want))


def test_perm_and_inv_reuse():
    """A permutation passed in is used as it is (with or without its
    inverse): the sorted order changes no hit, so even a random one gives
    the unsorted results, and the key is not computed (cut_bounds unread)."""
    n = 300
    case = _soup_case(4, leaf=4, n_rays=n)
    scene = _port_scene(case["wide"])
    o, d = _soup_rays(case, n)
    far, t_occ, act = (torch.tensor(case[k]) for k in ("far", "t_occ", "act"))
    kw = dict(stack_depth=case["depth"], leaf_size=4)
    base = kt.closest_plain(scene.node_rows, o, d, far, act, **kw)
    occ_base = kt.anyhit_plain(scene.node_rows, o, d, t_occ, act, **kw)
    own = tsort._sort_perm(scene.cut_bounds, o, d, far, act, scene=scene)
    rand = torch.tensor(np.random.RandomState(0).permutation(n))
    for perm in (own, rand):
        for inv in (None, torch.argsort(perm)):
            hit = tsort.trace_closest_tsort(scene, o, d, far, act, perm=perm,
                                            inv=inv, **kw)
            for g, b in zip(hit, base):
                np.testing.assert_array_equal(_bits(g), _bits(b))
            # The bounce's permutation reused for its shadow rays.
            occ = tsort.trace_occluded_tsort(scene, o, d, t_occ, act,
                                             perm=perm, inv=inv, **kw)
            np.testing.assert_array_equal(occ.numpy(), occ_base.numpy())
    scene.cut_bounds = None
    with pytest.raises(ValueError):
        tsort.trace_closest_tsort(scene, o, d, far, act, **kw)


def test_tsort_subpacket_kernel():
    """kernel="subpacket": the sorted rays padded to whole packets with
    dead lanes go through the sub-packet walk; t bitwise equal to the
    unsorted per-ray walk, and prim, u, v (no tie in these rays)."""
    n = 300
    case = _soup_case(9, leaf=10, n_rays=n)
    scene = _port_scene(case["wide"])
    o, d = _soup_rays(case, n)
    far, t_occ, act = (torch.tensor(case[k]) for k in ("far", "t_occ", "act"))
    kw = dict(stack_depth=case["depth"], leaf_size=10)
    base = kt.closest_plain(scene.node_rows, o, d, far, act, **kw)
    occ_base = kt.anyhit_plain(scene.node_rows, o, d, t_occ, act, **kw)
    for K in (128, 256, 2048):
        hit = tsort.trace_closest_tsort(scene, o, d, far, act,
                                        kernel="subpacket", packet_size=K,
                                        **kw)
        for g, b in zip(hit, base):
            assert g.shape == (n,)
            np.testing.assert_array_equal(_bits(g), _bits(b))
        occ = tsort.trace_occluded_tsort(scene, o, d, t_occ, act,
                                         kernel="subpacket", packet_size=K,
                                         **kw)
        np.testing.assert_array_equal(occ.numpy(), occ_base.numpy())
    with pytest.raises(ValueError):
        tsort.trace_closest_tsort(scene, o, d, far, act, kernel="treelet",
                                  **kw)
    with pytest.raises(ValueError):
        tsort._sort_perm(scene.cut_bounds, o, d, far, act, key_mode="top3")


@pytest.mark.parametrize("cluster_tris", [0, 128])
def test_dispatch_takes_tsort(cluster_tris):
    """ops/traverse.py: traversal="tsort" beside "auto", on MT and on
    cluster leaves, the same hits; "pallas" is "auto"; "packet" and
    "perray" (plain torch walks with the MT kernels' arithmetic) give
    "auto"'s hits, on cluster leaves (where both walk per ray with
    Moller-Trumbore, ROADMAP.md C8) its prims and occlusion, t within
    rtol = atol = 1e-6; "treelet" on cluster leaves raises."""
    scene, meta = load_scene(RenderConfig(scene_path="proc:table",
                                          cluster_tris=cluster_tris), "cpu")
    cb = scene.cut_bounds.numpy()
    o, d, t_max, act = (torch.tensor(x) for x in _box_rays(
        cb[:, 0:3].min(0), cb[:, 3:6].max(0), 260, seed=2))
    far = torch.full_like(t_max, 1e20)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    base = trace_closest(scene, o, d, far, act, **kw)
    hit = trace_closest(scene, o, d, far, act, traversal="tsort", **kw)
    for g, b in zip(hit, base):
        np.testing.assert_array_equal(_bits(g), _bits(b))
    assert (base.prim >= 0).float().mean() > 0.3
    occ = trace_occluded(scene, o, d, t_max, act, traversal="tsort", **kw)
    np.testing.assert_array_equal(
        occ.numpy(), trace_occluded(scene, o, d, t_max, act, **kw).numpy())
    if not cluster_tris:
        hit = trace_closest(scene, o, d, far, act, traversal="tsort",
                            interleave=2, **kw)
        for g, b in zip(hit, base):
            np.testing.assert_array_equal(_bits(g), _bits(b))
    hit = trace_closest(scene, o, d, far, act, traversal="pallas", **kw)
    for g, b in zip(hit, base):
        np.testing.assert_array_equal(_bits(g), _bits(b))
    for name in ("packet", "perray"):
        hit = trace_closest(scene, o, d, far, act, traversal=name, **kw)
        if cluster_tris:
            np.testing.assert_array_equal(hit.prim.numpy(),
                                          base.prim.numpy())
            # The cluster leaf's t is a dot product of inverse-matrix rows
            # with the origin: its error scales with the scene (measured
            # 4.7e-7 at t = 1.9e-4), not with t.
            np.testing.assert_allclose(hit.t.numpy(), base.t.numpy(),
                                       rtol=1e-6, atol=1e-6)
        else:
            for g, b in zip(hit, base):
                np.testing.assert_array_equal(_bits(g), _bits(b))
        np.testing.assert_array_equal(
            trace_occluded(scene, o, d, t_max, act, traversal=name,
                           **kw).numpy(),
            trace_occluded(scene, o, d, t_max, act, **kw).numpy())
    if cluster_tris:
        with pytest.raises(ValueError):
            trace_closest(scene, o, d, far, act, traversal="treelet", **kw)


def test_tsort_alternate_bitwise_equals_default():
    """cfg.tsort_alternate only changes the grouping (odd bounces reuse the
    last bounce's permutation), so the film is bitwise the default's: the
    JAX package's own tests/test_tsort.py check, on the port."""
    def cfg(alt):
        c = RenderConfig(scene_path="proc:cornell",
                         skybox="GENERATE COLOR BLACK", width=24, height=24,
                         ray_chunk=24 * 24, bounce_traversal="tsort",
                         treelet_min=1, shadow_sort=True, tsort_alternate=alt,
                         max_bounces=4)
        c.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                                fov=math.radians(45), aspect=1.0)
        return c

    ra = Renderer(cfg(False), "cpu")
    ra.render_frame("wavefront")
    rb = Renderer(cfg(True), "cpu", scene=ra.scene, meta=ra.meta)
    rb.render_frame("wavefront")
    assert ra.bounce_traversal == rb.bounce_traversal == "tsort"
    np.testing.assert_array_equal(_bits(ra.accum), _bits(rb.accum))
    assert float(ra.accum.sum()) > 0
