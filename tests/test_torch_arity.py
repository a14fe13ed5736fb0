"""The port's walks at every table arity and from per-packet start entries
(csrc/bvh_walk.cuh kArity and ``root``; ops/kernel_traverse.py and
ops/kernel_cluster.py ``arity``, ``roots``, ``packet``) against the JAX
package's Pallas kernels in interpret mode, which take the same two
parameters (pallas_traverse.py ``arity``, ``root_ref``).

One configuration a case: the 400-triangle soup of tests/test_pallas.py
(leaf 4) built at arity A by the JAX package and by the port (byte-equal
tables), 768 rays in six packets of 128 whose start entries are the whole
tree's root, two roots of the treelet cut, a leaf entry, INVALID and the
root again, about 10% of lanes inactive. t and occlusion must be bitwise
the JAX kernel's; prim, u and v too, except in lanes where another
triangle gives bitwise the same t (the JAX kernel visits a packet's union
in one order, the port each ray alone, ROADMAP.md C2), which are named
and checked to be such ties.
"""

import functools

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.bvh import build_wide_bvh as jax_build_wide_bvh
from gpupathtracer_tpu.bvh.cluster import pack_clusters as jax_pack_clusters
from gpupathtracer_tpu.bvh.wide import pack_for_packets as jax_pack
from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.ops.pallas_traverse import traverse_pallas
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch.bvh import build_wide_bvh
from gpupathtracer_tpu_torch.bvh.cluster import pack_clusters
from gpupathtracer_tpu_torch.bvh.wide import pack_for_packets
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
from gpupathtracer_tpu_torch.ops.intersect import mt_intersect, pack_tri_geom
from gpupathtracer_tpu_torch.scene import load_scene

K, P = 128, 6
INVALID = kt.INVALID_ENTRY
TABLE_FIELDS = ("node_rows", "cut_entry", "cut_bounds")


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _soup(seed=13, n=400):
    rng = np.random.RandomState(seed)
    base = rng.uniform(-5, 5, (n, 1, 3))
    tri = (base + rng.uniform(-0.6, 0.6, (n, 3, 3))).astype(np.float32)
    return tri[:, 0], tri[:, 1], tri[:, 2], rng


def _roots(cut_entry, leaf_ok=True):
    """Six packets' start entries: the root, two cut roots (node rows
    where there are), a leaf entry, INVALID, the root."""
    cut = [int(e) for e in cut_entry]
    nodes = [e for e in cut if e >= 0] or cut
    leaves = [e for e in cut if e < 0]
    leaf = leaves[0] if leaves and leaf_ok else nodes[-1]
    return np.int32([0, nodes[0], nodes[len(nodes) // 2], leaf, INVALID, 0])


def leaf_prims(node_rows, entry: int):
    """The triangle ids of leaf entry ``entry`` of an MT-leaf table."""
    packed = -(int(entry) + 1)
    first, count = packed >> 4, packed & 15
    slots = node_rows[first:first + 2, :120].reshape(-1, 12)[:count]
    return slots[:, 9].copy().view(np.int32)


def _aim_at_leaf(node_rows, entry, p0, p1, p2, o, d, rng):
    """Packet 3's rays, whose start entry is a leaf, aimed at points of
    its triangles (in place)."""
    if entry >= 0:
        return
    prims = leaf_prims(node_rows, entry)
    sl = slice(3 * K, 4 * K)
    pick = prims[rng.randint(0, len(prims), K)]
    w = rng.dirichlet((1.0, 1.0, 1.0), K).astype(np.float32)
    tgt = w[:, :1] * p0[pick] + w[:, 1:2] * p1[pick] + w[:, 2:] * p2[pick]
    dd = tgt - o[sl]
    d[sl] = dd / np.linalg.norm(dd, axis=1, keepdims=True)


@functools.lru_cache(maxsize=None)
def mt_case(arity: int):
    """The soup at ``arity``: JAX and port tables (byte-equal), rays,
    roots, and the JAX kernel's closest and any-hit outputs."""
    p0, p1, p2, rng = _soup()
    jw, stats = jax_build_wide_bvh(p0, p1, p2, leaf_size=4, builder="numpy",
                                   arity=arity)
    jw = jax_pack(jw, p0, p1 - p0, p2 - p0, 4)
    tw, _ = build_wide_bvh(p0, p1, p2, leaf_size=4, builder="numpy",
                           arity=arity)
    tw = pack_for_packets(tw, p0, p1 - p0, p2 - p0, 4)
    n = K * P
    o = rng.uniform(-8, 8, (n, 3)).astype(np.float32)
    d = rng.uniform(-4, 4, (n, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    roots = _roots(jw.cut_entry)
    _aim_at_leaf(jw.node_rows, roots[3], p0, p1, p2, o, d, rng)
    case = dict(jax=jw, port=tw, arity=arity, o=o, d=d,
                depth=min(stats.max_depth * (arity - 1) + 2, kt.MAX_STACK),
                far=np.full(n, 1e20, np.float32),
                t_occ=rng.uniform(0.5, 8.0, n).astype(np.float32),
                act=rng.rand(n) < 0.9, roots=roots,
                geom=pack_tri_geom(p0, p1 - p0, p2 - p0))
    case["closest"] = _pallas(case, case["far"])
    case["anyhit"] = _pallas(case, case["t_occ"], any_hit=True,
                             ordered=False)[1] >= 0
    return case


def _pallas(case, t_max, cluster=False, **kw):
    tables = case["jax"]
    out = traverse_pallas(
        jnp.asarray(tables.node_rows), jnp.asarray(case["o"]).reshape(P, K, 3),
        jnp.asarray(case["d"]).reshape(P, K, 3),
        jnp.asarray(t_max).reshape(P, K), jnp.asarray(case["act"]).reshape(P, K),
        roots=jnp.asarray(case["roots"]), stack_depth=case["depth"],
        leaf_size=4, arity=case["arity"], interpret=True,
        cluster_rows=jnp.asarray(tables.cluster_rows) if cluster else None,
        **kw)
    return [np.asarray(x).reshape(-1) for x in out]


def _rays(case, t_max):
    return [torch.from_numpy(case[k]) for k in ("o", "d")] + [
        torch.from_numpy(t_max), torch.from_numpy(case["act"])]


def _roots_kw(case):
    return dict(arity=case["arity"], roots=torch.from_numpy(case["roots"]),
                packet=K)


def _hold(got, want, case):
    """t bitwise; prim, u, v bitwise but in lanes where the port's triangle
    is hit at bitwise the same t as the JAX kernel's (a true tie). Returns
    the tie lanes."""
    t, prim, u, v = (x.numpy() for x in got)
    np.testing.assert_array_equal(_bits(t), _bits(want[0]))
    tie = np.nonzero(prim != want[1])[0]
    same = np.setdiff1d(np.arange(t.shape[0]), tie)
    for g, w in ((u, want[2]), (v, want[3])):
        np.testing.assert_array_equal(_bits(g[same]), _bits(w[same]))
    if len(tie):
        assert (prim[tie] >= 0).all() and (want[1][tie] >= 0).all()
        tt, _, _, ok = mt_intersect(torch.from_numpy(case["geom"][prim[tie]]),
                                    torch.from_numpy(case["o"][tie]),
                                    torch.from_numpy(case["d"][tie]))
        assert ok.all()
        np.testing.assert_array_equal(_bits(tt), _bits(t[tie]))
    return tie


@pytest.mark.parametrize("arity", [2, 4, 16])
def test_mt_tables_byte_equal(arity):
    """The soup's MT table and treelet cut at arity A, and proc:cornell's
    through load_scene, are the JAX package's byte for byte."""
    case = mt_case(arity)
    for f in TABLE_FIELDS:
        a, b = getattr(case["port"], f), getattr(case["jax"], f)
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), f
    js, jmeta = jax_load_scene(JaxRenderConfig(scene_path="proc:cornell",
                                               wide_arity=arity))
    ts, tmeta = load_scene(RenderConfig(scene_path="proc:cornell",
                                        wide_arity=arity), "cpu")
    assert ts.arity == arity == js.bvh.child_entry.shape[1]
    assert tmeta.stack_depth == jmeta.stack_depth
    for f in TABLE_FIELDS:
        assert getattr(ts, f).numpy().tobytes() == \
            np.asarray(getattr(js.bvh, f)).tobytes(), f


@pytest.mark.parametrize("arity", [2, 4, 16])
def test_plain_walks_match_pallas_at_arity_with_roots(arity):
    """B1 closest and any-hit at arity A from the six packets' start
    entries (a cut root, a leaf entry, INVALID among them), against the
    JAX kernel's; without roots the port's walks equal its walks from
    row 0."""
    case = mt_case(arity)
    rows = torch.from_numpy(case["port"].node_rows)
    kw = dict(stack_depth=case["depth"], leaf_size=4)
    rk = _roots_kw(case)
    got = kt.closest(rows, *_rays(case, case["far"]), **kw, **rk)
    _hold(got, case["closest"], case)
    occ = kt.anyhit(rows, *_rays(case, case["t_occ"]), **kw, **rk)
    np.testing.assert_array_equal(occ.numpy(), case["anyhit"])
    # The INVALID packet starts no walk: t_max, no hit, not occluded.
    dead = slice(4 * K, 5 * K)
    assert (got[0].numpy()[dead] == case["far"][dead]).all()
    assert (got[1].numpy()[dead] == -1).all() and not occ.numpy()[dead].any()
    # The leaf-root packet, aimed at its leaf, hits its triangles only.
    hit = got[1].numpy()[3 * K:4 * K]
    leaf = leaf_prims(case["port"].node_rows, case["roots"][3])
    assert (hit >= 0).mean() > 0.5 and set(hit[hit >= 0]) <= set(leaf)
    hits = (got[1].numpy() >= 0).mean()
    assert 0.1 < hits < 0.9 and 0.01 < occ.numpy().mean() < 0.9
    # roots=None is the walk from row 0 for every ray.
    zeros = dict(rk, roots=torch.zeros(P, dtype=torch.int32))
    plain = kt.closest(rows, *_rays(case, case["far"]), **kw, arity=arity)
    for g, w in zip(plain, kt.closest(rows, *_rays(case, case["far"]), **kw,
                                      **zeros)):
        assert torch.equal(g, w)


@pytest.mark.parametrize("sched", [dict(interleave=2), dict(multi_pop=2)])
def test_schedules_match_pallas_at_arity_16(sched):
    """B7 (W = 2) and B8 (Q = 2) at arity 16 with roots: the JAX kernels'
    hits (t and occlusion bitwise; prim, u, v but at true ties)."""
    case = mt_case(16)
    rows = torch.from_numpy(case["port"].node_rows)
    kw = dict(stack_depth=case["depth"], leaf_size=4, **sched)
    want = _pallas(case, case["far"], **sched)
    got = kt.closest(rows, *_rays(case, case["far"]), **kw, **_roots_kw(case))
    _hold(got, want, case)
    occ_want = _pallas(case, case["t_occ"], any_hit=True, ordered=False,
                       **sched)[1] >= 0
    occ = kt.anyhit(rows, *_rays(case, case["t_occ"]), **kw,
                    **_roots_kw(case))
    np.testing.assert_array_equal(occ.numpy(), occ_want)
    np.testing.assert_array_equal(occ.numpy(), case["anyhit"])


@functools.lru_cache(maxsize=None)
def cluster_case(arity: int, tc: int = 128):
    """mt_case's rays on a 1,500-triangle soup's cluster table at
    ``arity`` (JAX and port tables), cut roots of the cluster top tree."""
    rng = np.random.RandomState(7)
    base = rng.uniform(-5, 5, (1500, 1, 3))
    tri = (base + rng.uniform(-0.6, 0.6, (1500, 3, 3))).astype(np.float32)
    p0, e1, e2 = tri[:, 0], tri[:, 1] - tri[:, 0], tri[:, 2] - tri[:, 0]
    tables = []
    for build, pack in ((jax_build_wide_bvh, jax_pack_clusters),
                        (build_wide_bvh, pack_clusters)):
        wide, stats = build(p0, p0 + e1, p0 + e2, arity=arity)
        tables.append(pack(wide, p0, e1, e2, tc=tc, arity=arity))
    case = dict(mt_case(arity), jax=tables[0], port=tables[1],
                depth=min(stats.max_depth * (arity - 1) + 2, kt.MAX_STACK))
    case["roots"] = _roots(tables[0].cut_entry)
    case["geom"] = pack_tri_geom(p0, e1, e2)
    return case


def test_cluster_walk_matches_pallas_at_arity_16():
    """B4 at arity 16 with roots (cluster leaf entries among them): tables
    byte-equal, hits the JAX cluster kernel's (global prims)."""
    case = cluster_case(16)
    for f in TABLE_FIELDS + ("cluster_rows", "cluster_refs"):
        assert getattr(case["port"], f).tobytes() == \
            np.asarray(getattr(case["jax"], f)).tobytes(), f
    tab = {f: torch.from_numpy(np.asarray(getattr(case["port"], f)))
           for f in ("node_rows", "cluster_rows", "cluster_refs")}
    t, local, u, v = _pallas(case, case["far"], cluster=True)
    refs = case["port"].cluster_refs
    prim = np.where(local >= 0, refs[np.clip(local, 0, None)], -1)
    kw = dict(stack_depth=case["depth"], **_roots_kw(case))
    got = kc.closest_cluster(tab["node_rows"], tab["cluster_rows"],
                             tab["cluster_refs"], *_rays(case, case["far"]),
                             **kw)
    _hold(got, (t, prim, u, v), case)
    occ_want = _pallas(case, case["t_occ"], cluster=True, any_hit=True,
                       ordered=False)[1] >= 0
    occ = kc.anyhit_cluster(tab["node_rows"], tab["cluster_rows"],
                            *_rays(case, case["t_occ"]), **kw)
    np.testing.assert_array_equal(occ.numpy(), occ_want)
    assert 0.1 < (got[1].numpy() >= 0).mean() < 0.95
    assert (got[1].numpy()[4 * K:5 * K] == -1).all()


def test_wrappers_reject_bad_arity_and_roots():
    case = mt_case(4)
    rows = torch.from_numpy(case["port"].node_rows)
    rays = _rays(case, case["far"])
    kw = dict(stack_depth=case["depth"], leaf_size=4)
    for bad in (dict(arity=1), dict(arity=17),
                dict(arity=4, roots=torch.zeros(P, dtype=torch.int32)),
                dict(arity=4, roots=torch.zeros(P, dtype=torch.int32),
                     packet=64),
                dict(arity=4, roots=torch.zeros(P, dtype=torch.int64),
                     packet=K),
                dict(arity=4, packet=K)):
        with pytest.raises(ValueError):
            kt.closest(rows, *rays, **kw, **bad)
    with pytest.raises(ValueError):
        load_scene(RenderConfig(scene_path="proc:cornell", wide_arity=17),
                   "cpu")

