"""The port's plain torch traversals "packet" (ops/packet_traverse.py) and
"perray" (ops/traverse.py ``closest_hit`` / ``any_hit``) and the debug
trails (ops/debug.py) against the JAX package's, on the CPU.

The walks are the JAX package's; the triangle test is the CUDA kernels'
(ops/intersect.py), so that every traversal of the port gives the same
hits. XLA contracts each JAX traversal's Moller-Trumbore into its own
fused multiply-adds (ROADMAP.md C8): the per-lane walk's sums as
fma(x2, y2, fma(x1, y1, x0 y0)), the packet walk's as fma(x2, y2, fma(x0,
y0, x1 y1)), the Pallas kernel's (and so the port's) as a mix of the two.
So each walk is held twice:

* with the JAX traversal's own contraction written out (``xla_mt``): every
  field of every lane bitwise, which holds the visit order, the stack, the
  packets' compaction and the counters to the JAX code;
* as it ships: prims, occlusion and the trail's counters bitwise, t, u and
  v within the bounds of tests/test_torch_traverse.py (t to 1e-6 relative,
  u and v to 1e-5), the lanes that differ counted; and every field bitwise
  the port's "auto" traversal (B1's plain version).
"""

import os
import types

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.bvh import WideBVH as JaxWideBVH
from gpupathtracer_tpu.bvh import build_wide_bvh as jax_build
from gpupathtracer_tpu.bvh.wide import pack_for_packets as jax_pack
from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.ops import debug as jax_debug
from gpupathtracer_tpu.ops import packet_traverse as jax_pt
from gpupathtracer_tpu.ops import traverse as jax_tr
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.ops import debug, packet_traverse, traverse
from gpupathtracer_tpu_torch.ops.intersect import fma32, pack_tri_geom
from gpupathtracer_tpu_torch.scene import load_scene

PACKETS = (64, 128, 512)


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def xla_mt(order: str):
    """ops/intersect.py ``mt_xyz`` with the fused multiply-adds XLA makes of
    the JAX traversal's Moller-Trumbore on the CPU: crosses as fma(a1, b2,
    -(a2 b1)); three-term sums fma(x2, y2, fma(x1, y1, x0 y0)) for the
    per-lane walk (``order`` "perray", jnp.sum) and fma(x2, y2, fma(x0, y0,
    x1 y1)) for the packet walk ("packet", written out)."""
    def dot(x, y):
        if order == "perray":
            return fma32(x[2], y[2], fma32(x[1], y[1], x[0] * y[0]))
        return fma32(x[2], y[2], fma32(x[0], y[0], x[1] * y[1]))

    def cross(a, b):
        return [fma32(a[1], b[2], -(a[2] * b[1])),
                fma32(a[2], b[0], -(a[0] * b[2])),
                fma32(a[0], b[1], -(a[1] * b[0]))]

    def mt_xyz(p0, e1, e2, o, d):
        p = cross(d, e2)
        det = dot(e1, p)
        idet = torch.ones_like(det) / det
        tv = [o[i] - p0[i] for i in range(3)]
        q = cross(tv, e1)
        u, v, t = dot(tv, p) * idet, dot(d, q) * idet, dot(e2, q) * idet
        return t, u, v, (u > 0.0) & (u < 1.0) & (v > 0.0) & (u + v < 1.0) \
            & (t > 0.0)

    return mt_xyz


@pytest.fixture
def xla_rounding(monkeypatch):
    monkeypatch.setattr(traverse, "mt_xyz", xla_mt("perray"))
    monkeypatch.setattr(packet_traverse, "mt_xyz", xla_mt("packet"))


def _soup():
    """tests/test_packet_traverse.py's scene: 700 random triangles, the
    numpy builder, 4 a leaf, 512 rays toward the middle."""
    rng = np.random.RandomState(7)
    base = rng.uniform(-5, 5, (700, 1, 3))
    tri = (base + rng.uniform(-0.6, 0.6, (700, 3, 3))).astype(np.float32)
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    wide, stats = jax_build(p0, p1, p2, leaf_size=4, builder="numpy")
    wide = jax_pack(wide, p0, (p1 - p0), (p2 - p0), leaf_size=4)
    geom = pack_tri_geom(p0, p1 - p0, p2 - p0)
    rng2 = np.random.RandomState(3)
    o = rng2.uniform(-8, 8, (512, 3)).astype(np.float32)
    d = rng2.uniform(-4, 4, (512, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng2.rand(512) < 0.33, rng2.uniform(0.5, 8.0, 512),
                     1e20).astype(np.float32)
    port = types.SimpleNamespace(
        child_bounds=torch.tensor(wide.child_bounds),
        child_entry=torch.tensor(wide.child_entry),
        refs=torch.tensor(wide.refs), tri_geom=torch.tensor(geom),
        node_rows=torch.tensor(wide.node_rows), arity=8, cluster_rows=None)
    jbvh = JaxWideBVH(*(jnp.asarray(a) if a is not None else None
                        for a in wide))
    return dict(port=port, bvh=jbvh, geom=jnp.asarray(geom),
                depth=stats.max_depth * 7 + 2, leaf=4, rays=(
                    o, d, t_max, rng2.rand(512) > 0.15))


def _table(**kw):
    """proc:table as each package loads it (byte-equal tables, tests/
    test_torch_scene.py), 512 rays from around its box (a third with a
    short t_max, about 15% inactive)."""
    cfg = RenderConfig(scene_path="proc:table", **kw)
    port, meta = load_scene(cfg, "cpu")
    jscene, _ = jax_load_scene(JaxRenderConfig.from_json(cfg.to_json()))
    cb = port.child_bounds.numpy()
    lo, hi = cb[0, :, 0:3].min(0), cb[0, :, 3:6].max(0)
    rng = np.random.RandomState(5)
    mid, half = (lo + hi) / 2, (hi - lo) / 2
    o = (mid + rng.uniform(-1.6, 1.6, (512, 3)) * half).astype(np.float32)
    d = (mid + rng.uniform(-0.8, 0.8, (512, 3)) * half).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    t_max = np.where(rng.rand(512) < 0.33, rng.uniform(0.1, 3.0, 512),
                     1e20).astype(np.float32)
    return dict(port=port, jscene=jscene, bvh=jscene.bvh,
                geom=jscene.tri_geom, depth=meta.stack_depth,
                leaf=meta.leaf_size, rays=(o, d, t_max, rng.rand(512) > 0.15))


@pytest.fixture(scope="module")
def cases():
    """name -> case, with the JAX package's answers: per-lane closest and
    any-hit, packet closest and any-hit at each of PACKETS, the trail."""
    out = {"soup": _soup(), "table": _table()}
    for c in out.values():
        o, d, t_max, act = (jnp.asarray(x) for x in c["rays"])
        far = jnp.full_like(t_max, 1e20)
        kw = dict(stack_depth=c["depth"], leaf_size=c["leaf"])
        c["jax"] = {
            "perray": jax_tr.closest_hit(c["bvh"], c["geom"], o, d, far, act,
                                         **kw),
            "perray_occ": jax_tr.any_hit(c["bvh"], c["geom"], o, d, t_max,
                                         act, **kw),
            "trail": jax_debug.closest_hit_trail(c["bvh"], c["geom"], o, d,
                                                 far, **kw)}
        for K in PACKETS:
            c["jax"][f"packet{K}"] = jax_pt.closest_hit_packets(
                c["bvh"], o, d, far, act, packet_size=K, **kw)
            c["jax"][f"packet{K}_occ"] = jax_pt.any_hit_packets(
                c["bvh"], o, d, t_max, act, packet_size=K, **kw)
    return out


def _port_answers(c, packets=PACKETS):
    o, d, t_max, act = (torch.tensor(x) for x in c["rays"])
    far = torch.full_like(t_max, 1e20)
    kw = dict(stack_depth=c["depth"], leaf_size=c["leaf"])
    s, rows = c["port"], c["port"].node_rows
    got = {"perray": traverse.closest_hit(s, o, d, far, act, **kw),
           "perray_occ": traverse.any_hit(s, o, d, t_max, act, **kw),
           "trail": debug.closest_hit_trail(s, o, d, far, **kw)}
    for K in packets:
        got[f"packet{K}"] = packet_traverse.closest_hit_packets(
            rows, o, d, far, act, packet_size=K, **kw)
        got[f"packet{K}_occ"] = packet_traverse.any_hit_packets(
            rows, o, d, t_max, act, packet_size=K, **kw)
    return got


@pytest.mark.parametrize("name", ["soup", "table"])
def test_walks_bitwise_jax_with_xla_rounding(cases, name, xla_rounding):
    """With XLA's contraction of each JAX traversal written out, the port's
    walks give the JAX package's every field bitwise: closest (t, prim, u,
    v) and any-hit, per ray and at packets of 64, 128 and 512 rays (512
    rays: one to eight packets), and the trail's five fields."""
    c = cases[name]
    got = _port_answers(c)
    assert set(got) == set(c["jax"])
    for key, want in c["jax"].items():
        for g, w in zip(got[key] if isinstance(want, tuple) else [got[key]],
                        want if isinstance(want, tuple) else [want]):
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=key)
    prim = got["perray"].prim.numpy()
    assert 0.2 < (prim >= 0).mean() < 0.95
    assert 0.05 < got["perray_occ"].numpy().mean() < 0.95


@pytest.mark.parametrize("name", ["soup", "table"])
def test_walks_against_jax_and_auto(cases, name):
    """As shipped: prims, occlusion and the trail's counters bitwise the
    JAX package's, t/u/v within the stated bounds (the differing lanes
    counted, all of them last-place rounding of the Moller-Trumbore); and
    every field bitwise the port's "auto" traversal on the same table (the
    soup's packets at 128 rays: the walk at each size is held above)."""
    c = cases[name]
    packets = PACKETS if name == "table" else (128,)
    got = _port_answers(c, packets)
    o, d, t_max, act = (torch.tensor(x) for x in c["rays"])
    far = torch.full_like(t_max, 1e20)
    kw = dict(stack_depth=c["depth"], leaf_size=c["leaf"])
    scene = c["port"] if name == "table" else types.SimpleNamespace(
        node_rows=c["port"].node_rows, cluster_rows=None, arity=8)
    auto = traverse.trace_closest(scene, o, d, far, act, **kw)
    auto_occ = traverse.trace_occluded(scene, o, d, t_max, act, **kw)
    differ = {}
    for key in ["perray"] + [f"packet{K}" for K in packets]:
        want = c["jax"][key]
        np.testing.assert_array_equal(got[key].prim.numpy(),
                                      np.asarray(want.prim), err_msg=key)
        np.testing.assert_allclose(got[key].t.numpy(), np.asarray(want.t),
                                   rtol=1e-6, err_msg=key)
        for g, w in ((got[key].u, want.u), (got[key].v, want.v)):
            np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                       atol=3e-5, err_msg=key)
        differ[key] = int((_bits(got[key].t) != _bits(want.t)).sum())
        for g, b in zip(got[key], auto):
            np.testing.assert_array_equal(_bits(g), _bits(b), err_msg=key)
        np.testing.assert_array_equal(got[key + "_occ"].numpy(),
                                      np.asarray(c["jax"][key + "_occ"]))
        np.testing.assert_array_equal(got[key + "_occ"].numpy(),
                                      auto_occ.numpy())
    trail, jtrail = got["trail"], c["jax"]["trail"]
    for f in ("pops", "node_visits", "leaf_tests", "prim"):
        np.testing.assert_array_equal(getattr(trail, f).numpy(),
                                      np.asarray(getattr(jtrail, f)))
    hits = int((got["perray"].prim >= 0).sum())
    print(f"{name}: lanes whose t is not bitwise JAX's, of {hits} hits: "
          f"{differ}")
    # The rounding moves t in some lanes, and never the hit.
    assert 0 < max(differ.values()) < hits


def test_dispatch_pads_and_falls_back(xla_rounding):
    """ops/traverse.py's "packet" against the JAX dispatch (ops/traverse.py
    trace_closest / trace_occluded), with XLA's rounding written out: 300
    rays (padded to whole 128-ray packets), and the fallbacks to the
    per-ray walk on a cluster table (tc 128; closest prims global) and on a
    4-wide table, bitwise; "perray" is the per-ray walk on each."""
    for kw in ({}, {"cluster_tris": 128}, {"wide_arity": 4}):
        c = _table(**kw)
        rays = [x[:300] for x in c["rays"]]
        port = [torch.tensor(x) for x in rays]
        depth = dict(stack_depth=c["depth"], leaf_size=c["leaf"],
                     packet_size=128)
        got = traverse.trace_closest(c["port"], *port, traversal="packet",
                                     **depth)
        want = jax_tr.trace_closest(c["jscene"], *map(jnp.asarray, rays),
                                    traversal="packet", **depth)
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=kw)
        occ = traverse.trace_occluded(c["port"], *port, traversal="packet",
                                      **depth)
        np.testing.assert_array_equal(occ.numpy(), np.asarray(
            jax_tr.trace_occluded(c["jscene"], *map(jnp.asarray, rays),
                                  traversal="packet", **depth)))
        assert got.t.shape == (300,) and (got.prim >= 0).any()
        perray = traverse.trace_closest(c["port"], *port,
                                        traversal="perray", **depth)
        for g, b in zip(perray, traverse.closest_hit(
                c["port"], *port, stack_depth=c["depth"],
                leaf_size=c["leaf"])):
            np.testing.assert_array_equal(_bits(g), _bits(b))


def test_dump_trails_byte_equal(cases, tmp_path, xla_rounding):
    """dump_trails writes the JAX package's bytes: [N, 3] int32 of pops,
    node visits and triangle tests."""
    c = cases["table"]
    o, d, _, _ = (torch.tensor(x) for x in c["rays"])
    trail = debug.closest_hit_trail(c["port"], o, d,
                                    torch.full((512,), 1e20),
                                    stack_depth=c["depth"],
                                    leaf_size=c["leaf"])
    p = debug.dump_trails(trail, str(tmp_path / "port" / "trails.bin"))
    q = jax_debug.dump_trails(c["jax"]["trail"], str(tmp_path / "jax.bin"))
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()
    assert os.path.getsize(p) == 512 * 3 * 4
    assert (trail.pops.numpy() > 0).all()


def test_unknown_traversal_raises():
    assert {"packet", "perray"} <= set(traverse.TRAVERSALS)
    with pytest.raises(ValueError):
        traverse.check_traversal("pallas2")
    bare = types.SimpleNamespace(child_bounds=None, child_entry=None,
                                 refs=None, tri_geom=None)
    with pytest.raises(ValueError):
        traverse.closest_hit(bare, torch.zeros((1, 3)), torch.ones((1, 3)),
                             torch.ones(1))


def test_steps_without_host_reads(cases):
    """On CUDA tensors the packet walk replays a captured step that runs
    both phases with no host read, GRAPH_STEPS steps between reads of the
    live count (ops/packet_traverse.py ``_run_graphed``): the same steps
    here, run past the walk's end, give the eager walk's state bitwise."""
    c = cases["table"]
    o, d, t_max, act = (torch.tensor(x) for x in c["rays"])
    rows, depth, leaf = c["port"].node_rows, c["depth"], c["leaf"]
    for any_hit in (False, True):
        args, _ = packet_traverse._packets(rows, o, d, t_max, act, leaf, 128)
        _, o3, d3, tm, ac = args
        st = (torch.zeros((4, depth + 1), dtype=torch.int64),
              ac.any(dim=1).to(torch.int64), tm.clone(),
              torch.full((4, 128), -1, dtype=torch.int32),
              torch.zeros((4, 128)), torch.zeros((4, 128)),
              torch.zeros((4, 128), dtype=torch.bool),
              o3.permute(0, 2, 1), d3.permute(0, 2, 1),
              traverse._safe_inv(d3.permute(0, 2, 1)), ac, torch.arange(4))
        eager, steps = st, 0
        while True:
            eager, live = packet_traverse._step(rows, eager, depth, leaf,
                                                any_hit)
            if not live:
                break
            steps += 1
        forced = st
        for _ in range(steps + packet_traverse.GRAPH_STEPS):
            forced, _ = packet_traverse._step(rows, forced, depth, leaf,
                                              any_hit, (True, True))
        assert steps > 10 and not (forced[1] > 0).any()
        # The stack's last column takes dropped pushes and is never read.
        forced = (forced[0][:, :depth],) + forced[1:]
        eager = (eager[0][:, :depth],) + eager[1:]
        for f, e in zip(forced, eager):
            np.testing.assert_array_equal(_bits(f), _bits(e))
