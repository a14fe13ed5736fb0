"""The pop counters of the port's walks (``with_stats``: per ray in
ops/kernel_traverse.py and ops/kernel_cluster.py, per packet in
ops/megakernel.py) and the cluster walk's ``pop_skip`` schedule, on the
CPU, where every wrapper runs its plain version; and the megakernel's ray
counters against the JAX kernel's ``with_stats`` in interpret mode.

The TPU kernels count the pops of a packet's shared stack; the port counts
each ray's own walk, so only the ray counters of the megakernel, which
both count per lane, are held to the JAX package's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.config import CameraConfig as JaxCameraConfig
from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.math.camera import generate_image_plane
from gpupathtracer_tpu.ops import megakernel as jmega
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch import random as trandom
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.math.camera import camera_from_numpy
from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
from gpupathtracer_tpu_torch.ops import megakernel as mega
from gpupathtracer_tpu_torch.scene import load_scene, scene_from_numpy
from test_torch_kernel import _port, _rows, _soup_case, far_cluster_case


@pytest.fixture(scope="module")
def case():
    return _soup_case(3, leaf=10, n_tris=1500, n_rays=1024)


def _kw(case):
    return dict(stack_depth=case["depth"], leaf_size=10)


@pytest.mark.parametrize("any_hit", [False, True])
def test_per_ray_counts_sum_to_the_pop_totals(case, any_hit):
    """The per-ray counts of the plain walk sum to the totals ``count_pops``
    gathers for chip_smoke.py's bound, and the results are those without
    counters."""
    rows = _rows(case)
    rays = _port(case, case["t_occ"] if any_hit else case["far"])
    fn = kt.anyhit if any_hit else kt.closest
    pops = {}
    plain = kt.anyhit_plain if any_hit else kt.closest_plain
    out = plain(rows, *rays, pops=pops, with_stats=True, **_kw(case))
    st = out[-1]
    assert st.dtype == torch.int32 and st.shape == (1024, 2)
    assert int(st[:, 0].sum()) == pops["node"] > 0
    assert int(st[:, 1].sum()) == pops["leaf"] > 0
    assert (st[~rays[3]] == 0).all()  # inactive rays pop nothing
    bare = fn(rows, *rays, **_kw(case))
    got = fn(rows, *rays, with_stats=True, **_kw(case))
    if any_hit:
        assert torch.equal(got[0], bare)
    else:
        for a, b in zip(got[:4], bare):
            assert torch.equal(a, b)
    assert torch.equal(got[-1], st)


def test_interleave_counts_equal_the_single_walk(case):
    """B7 visits each ray's nodes in B1's order: the same counts, ray by
    ray, at W = 2 and 4."""
    rows = _rows(case)
    for any_hit, t_max in ((False, case["far"]), (True, case["t_occ"])):
        fn = kt.anyhit if any_hit else kt.closest
        b1 = fn(rows, *_port(case, t_max), with_stats=True, **_kw(case))[-1]
        for w in (2, 4):
            b7 = fn(rows, *_port(case, t_max), with_stats=True,
                    interleave=w, **_kw(case))[-1]
            assert torch.equal(b7, b1)


def test_multi_pop_counts_at_least_the_single_walk(case):
    """B8 prunes against a stale t, so it pops at least B1's nodes on every
    ray, more in all; its third column, the dropped pushes, reads 0 at a
    stack of stack_depth * Q and more with a stack made too small."""
    rows = _rows(case)
    rays = _port(case, case["far"])
    b1 = kt.closest(rows, *rays, with_stats=True, **_kw(case))[-1]
    for q in (2, 4):
        b8 = kt.closest(rows, *rays, with_stats=True, multi_pop=q,
                        **_kw(case))[-1]
        assert b8.shape == (1024, 3) and int(b8[:, 2].sum()) == 0
        assert (b8[:, 0] >= b1[:, 0]).all()
        assert int(b8[:, :2].sum()) > int(b1.sum())
    small = kt.closest(rows, *rays, with_stats=True, multi_pop=2,
                       stack_depth=2, leaf_size=10)[-1]
    assert int(small[:, 2].sum()) > 0


@pytest.fixture(scope="module")
def table_cluster():
    cfg = RenderConfig(scene_path="proc:table", width=16, height=16,
                       cluster_tris=128)
    scene, meta = load_scene(cfg, "cpu")
    rng = np.random.RandomState(0)
    n = 2048
    o = torch.tensor(rng.uniform(-1, 1, (n, 3)).astype(np.float32)) \
        + torch.tensor([0.0, 1.0, 0.0])
    d = torch.nn.functional.normalize(
        torch.tensor(rng.normal(size=(n, 3)).astype(np.float32)), dim=1)
    act = torch.tensor(rng.rand(n) < 0.9)
    return scene, meta, o.contiguous(), d, act


def test_pop_skip_leaves_the_hits(table_cluster):
    """pop_skip skips cluster pops (more than none on this table) and
    leaves t, prim, u and v bitwise; the counts add up: every cluster pop
    of the plain schedule is run or skipped under pop_skip."""
    scene, meta, o, d, act = table_cluster
    far = torch.full((o.shape[0],), 1e20)
    tabs = (scene.node_rows, scene.cluster_rows, scene.cluster_refs)
    kw = dict(stack_depth=meta.stack_depth)
    bare = kc.closest_cluster(*tabs, o, d, far, act, **kw)
    pops = {}
    got = kc.closest_cluster_plain(*tabs, o, d, far, act, pops=pops,
                                   with_stats=True, **kw)
    skip = kc.closest_cluster(*tabs, o, d, far, act, with_stats=True,
                              pop_skip=True, **kw)
    only = kc.closest_cluster(*tabs, o, d, far, act, pop_skip=True, **kw)
    for a, b, c in zip(bare, skip[:4], only):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    st, sk = got[4], skip[4]
    assert int(st[:, 0].sum()) == pops["node"]
    assert int(st[:, 1].sum()) == pops["leaf"]
    assert int(st[:, 2].sum()) == 0
    assert torch.equal(sk[:, 0], st[:, 0])
    assert int(sk[:, 2].sum()) > 0
    assert torch.equal(sk[:, 1] + sk[:, 2], st[:, 1])
    occ, ast = kc.anyhit_cluster(scene.node_rows, scene.cluster_rows, o, d,
                                 torch.full_like(far, 2.0), act,
                                 with_stats=True, **kw)
    assert ast.shape == (o.shape[0], 3) and int(ast[:, 2].sum()) == 0
    assert int(ast[:, 1].sum()) > 0 and occ.any()
    with pytest.raises(ValueError):  # closest walks only
        kt.walk_plain(scene.node_rows, o, d, far, act, meta.stack_depth,
                      True, lambda *a: None, pop_skip=True)


def test_pop_skip_leaves_the_hits_far_from_the_origin():
    """pop_skip on rays far from the world origin, half of which hit two
    clusters at about the same t (far_cluster_case): t, prim, u and v
    bitwise those without it, and pops skipped. Its margin scales with
    |o / d|; one relative to the key alone, key * (1 - 2^-12) >= t,
    changes the hit of about one ray in thirty here."""
    tabs, o, d, act, depth = far_cluster_case()
    assert tabs[1].shape[0] == 2 * 8  # the two sheets' clusters
    far = torch.full((o.shape[0],), 1e20)
    bare = kc.closest_cluster(*tabs, o, d, far, act, stack_depth=depth)
    skip = kc.closest_cluster(*tabs, o, d, far, act, stack_depth=depth,
                              with_stats=True, pop_skip=True)
    assert (bare[1] >= 0).float().mean() > 0.9
    for a, b in zip(bare, skip[:4]):
        assert torch.equal(a.view(torch.int32), b.view(torch.int32))
    assert int(skip[4][:, 2].sum()) > 0


def test_megakernel_counters_match_jax():
    """The plain megakernel's bounce and shadow rays per packet equal the
    JAX kernel's ``with_stats`` counters in interpret mode. Its loop
    iterations are the packet's longest lane's, at most the JAX kernel's
    loop count (which ran on to 8 with 7 closest walks in packet 1 here);
    pops are the lanes' own walks (node pops at least the walks, tail pops
    within the pops), the contribution that without counters."""
    w = h = 16
    kw = dict(skybox="GENERATE COLOR BLACK", width=w, height=h)
    jcfg = JaxRenderConfig(scene_path="proc:cornell", **kw)
    jcfg.camera = JaxCameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                                  fov=math.radians(45), aspect=1.0)
    js, jmeta = jax_load_scene(jcfg)
    jcam = generate_image_plane(jcfg.camera)
    ts = scene_from_numpy(dict(
        tri_shade=js.tri_shade, light_rows=js.light_rows,
        light_cdf=js.light_cdf, total_light_area=js.total_light_area,
        mat_rows=js.mat_rows, env=js.env.image,
        node_rows=js.bvh.node_rows), "cpu")
    tcam = camera_from_numpy(
        {k: np.asarray(v) for k, v in jcam._asdict().items()}, "cpu")
    n = 200  # pads to two packets of 128
    px = (np.arange(n) % w).astype(np.float32)
    py = (np.arange(n) // w).astype(np.float32)
    statics = dict(width=w, height=h, stack_depth=jmeta.stack_depth,
                   leaf_size=jmeta.leaf_size, max_bounces=6, nee=True,
                   model="trowbridge_reitz", n_mats=jmeta.num_materials,
                   n_lights=int(js.light_rows.shape[0]), packet_size=128)
    _, jrays, jst = jmega.render_sample_mega(
        js, jmega.pack_mega_tables(js), jcam, jnp.asarray(px),
        jnp.asarray(py), jax.random.PRNGKey(5), sample_idx=3,
        interpret=True, with_stats=True, **statics)
    args = (ts, mega.pack_mega_tables(ts), tcam, torch.from_numpy(px),
            torch.from_numpy(py), trandom.PRNGKey(5))
    c, rays, st = mega.render_sample_mega(*args, sample_idx=3,
                                          with_stats=True, **statics)
    bare, _ = mega.render_sample_mega(*args, sample_idx=3, **statics)
    jst = np.asarray(jst)
    assert st.dtype == torch.int32 and st.shape == jst.shape == (2, 9)
    np.testing.assert_array_equal(st[:, 0:2].numpy(), jst[:, 0:2])
    assert (st[:, 8].numpy() <= jst[:, 8]).all()
    assert st[0, 8] == jst[0, 8] == 8  # a lane of packet 0 ran 8 bounces
    assert int(rays) == int(jrays) == int(st[:, 0:2].sum())
    assert torch.equal(c.view(torch.int32), bare.view(torch.int32))
    assert (st[:, 2] >= st[:, 0]).all() and (st[:, 4] >= st[:, 1]).all()
    assert (st[:, 6] <= st[:, 2] + st[:, 3]).all()
    assert (st[:, 7] <= st[:, 4] + st[:, 5]).all()
    with pytest.raises(ValueError):  # the counters are built with NEE only
        mega.render_sample_mega(*args, with_stats=True,
                                **dict(statics, nee=False))
