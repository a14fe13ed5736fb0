"""The port's copy of bvh/partition.py and the pilot-demand walk
(ops/traverse.py ``count_entry_visits``) against the JAX package's, on the
host: every output byte for byte on bunny at 2, 4 and 8 devices, with and
without replicated hot subtrees, with a given demand population and with
explicit hot entries, the cut, the node-bucket map, the group-cap repair
and its refusal; the bucket counts bitwise JAX's with XLA's contraction of
the JAX walk's Moller-Trumbore written out (tests/test_torch_packet_
traverse.py ``xla_mt``)."""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.bvh import partition as jpart
from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.ops import traverse as jax_tr
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch.bvh import partition as tpart
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.ops import traverse
from gpupathtracer_tpu_torch.scene import load_scene
from test_torch_packet_traverse import xla_mt


@pytest.fixture(scope="module")
def bunny():
    cfg = dict(scene_path="proc:bunny", skybox="GENERATE COLOR BLACK")
    jscene, jmeta = jax_load_scene(JaxRenderConfig(**cfg))
    tscene, tmeta = load_scene(RenderConfig(**cfg), "cpu")
    rows = np.asarray(jscene.bvh.node_rows)
    assert rows.tobytes() == tscene.node_rows.numpy().tobytes()
    return dict(jax=(jscene, jmeta), port=(tscene, tmeta), rows=rows,
                W=int(jscene.bvh.child_bounds.shape[0]))


def _rays(n, seed):
    rng = np.random.RandomState(seed)
    o = rng.uniform(-2, 2, (n, 3)).astype(np.float32)
    d = rng.normal(size=(n, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return o, d


def _same_partition(got, want):
    for field in want._fields:
        w = getattr(want, field)
        g = getattr(got, field)
        assert (g is None) == (w is None), field
        if w is not None:
            assert g.dtype == w.dtype and g.shape == w.shape, field
            assert g.tobytes() == w.tobytes(), field


@pytest.mark.parametrize("D,hot", [(2, 0), (2, 6), (4, 0), (4, 6), (8, 0),
                                   (8, 6)])
def test_build_partition_byte_equal(bunny, D, hot):
    """Tables, bounds, live rows, hop-0 bounds and steady roots byte for
    byte (the default spatial grouping and random-ray demand)."""
    got = tpart.build_partition(bunny["rows"], bunny["W"], D,
                                replicate_hot=hot)
    want = jpart.build_partition(bunny["rows"], bunny["W"], D,
                                 replicate_hot=hot)
    _same_partition(got, want)
    assert got.tables.shape[0] == D
    if hot:
        assert (got.steady_root > 0).all()


@pytest.mark.parametrize("grouping", ["lpt", "demand", "spatial-area"])
def test_build_partition_groupings_and_demand_rays(bunny, grouping):
    """The other groupings, and the demand estimate on a given ray
    population (camera rays stand-in), byte for byte."""
    rays = _rays(2048, 11)
    got = tpart.build_partition(bunny["rows"], bunny["W"], 4,
                                grouping=grouping, demand_rays=rays)
    want = jpart.build_partition(bunny["rows"], bunny["W"], 4,
                                 grouping=grouping, demand_rays=rays)
    _same_partition(got, want)


def test_cut_weights_and_hot_entries(bunny):
    """partition_cut, the demand weights (random and given rays), the
    spatial grouping and explicit (duplicated) hot entries: equal to the
    JAX package's."""
    rows, W = bunny["rows"], bunny["W"]
    for D in (2, 8):
        ge, gb = tpart.partition_cut(rows, W, D)
        we, wb = jpart.partition_cut(rows, W, D)
        assert ge.tobytes() == we.tobytes() and gb.tobytes() == wb.tobytes()
    rays = _rays(512, 3)
    for kw in ({}, dict(rays=rays)):
        np.testing.assert_array_equal(tpart._demand_weights(gb, **kw),
                                      jpart._demand_weights(wb, **kw))
    w = tpart._demand_weights(gb)
    assert tpart._group_spatial(gb, w, 8) == jpart._group_spatial(wb, w, 8)
    got = tpart.build_partition(rows, W, 4, hot_entries=[1, 1, 3, 2, 1])
    want = jpart.build_partition(rows, W, 4, hot_entries=[1, 1, 3, 2, 1])
    _same_partition(got, want)


def test_group_cap_repair_matches():
    """_repair_group_caps moves the smallest members to the emptiest
    groups exactly as the JAX package does, and refuses an infeasible
    cap."""
    sizes = {i: (i * 7) % 13 + 1 for i in range(80)}
    mk = lambda: [list(range(70)), list(range(70, 75)),  # noqa: E731
                  list(range(75, 80))]
    got, want = mk(), mk()
    tpart._repair_group_caps(got, sizes, cap=30)
    jpart._repair_group_caps(want, sizes, cap=30)
    assert got == want
    assert all(len(g) <= 30 for g in got)
    with pytest.raises(ValueError, match="exceed"):
        tpart._repair_group_caps([list(range(10)), []],
                                 {i: 1 for i in range(10)}, cap=4)


def test_node_bucket_map_matches(bunny):
    rows, W = bunny["rows"], bunny["W"]
    cut, _ = tpart.partition_cut(rows, W, 8)
    got = tpart.node_bucket_map(rows, W, cut)
    want = jpart.node_bucket_map(rows, W, cut)
    assert got.dtype == want.dtype and got.tobytes() == want.tobytes()
    assert int(got[0]) == len(cut) and (got < len(cut)).any()


def test_count_entry_visits_bitwise(bunny, monkeypatch):
    """The per-bucket node pops of 384 pilot rays (one in ten with a short
    t_max) bitwise JAX's: with XLA's contraction patched in, the walk
    visits what the JAX walk visits; as shipped the counts still sum to
    every node pop and the hits are closest_hit's."""
    rows, W = bunny["rows"], bunny["W"]
    jscene, jmeta = bunny["jax"]
    tscene, _ = bunny["port"]
    cut, _ = tpart.partition_cut(rows, W, 8)
    C = len(cut)
    bucket = tpart.node_bucket_map(rows, W, cut)
    o, d = _rays(384, 5)
    tm = np.full(384, 1e20, np.float32)
    tm[::10] = 0.7
    kw = dict(stack_depth=jmeta.stack_depth, leaf_size=jmeta.leaf_size)
    want = np.asarray(jax_tr.count_entry_visits(
        jscene.bvh, jscene.tri_geom, jnp.asarray(o), jnp.asarray(d),
        jnp.asarray(tm), bucket, C + 1, **kw))
    args = (torch.from_numpy(o), torch.from_numpy(d), torch.from_numpy(tm))
    shipped = traverse.count_entry_visits(tscene, *args, bucket, C + 1, **kw)
    # As shipped: every node pop lands in one bucket (the buckets cover the
    # tree), the hits are closest_hit's, and dropping the last bucket
    # drops only the nodes above the cut.
    active = torch.ones(384, dtype=torch.bool)
    out = traverse._traverse(tscene, *args, active, kw["stack_depth"],
                             kw["leaf_size"], False, counters=True,
                             visit_bucket=bucket, num_buckets=C + 1)
    assert int(out[5].sum()) == int(out[4][1].sum())
    assert torch.equal(out[5], shipped)
    hit = traverse.closest_hit(tscene, *args, **kw)
    assert all(torch.equal(a, b) for a, b in zip(out[:4], hit))
    below = traverse.count_entry_visits(tscene, *args, bucket, C, **kw)
    assert torch.equal(below, shipped[:C])
    monkeypatch.setattr(traverse, "mt_xyz", xla_mt("perray"))
    got = traverse.count_entry_visits(tscene, *args, bucket, C + 1, **kw)
    assert got.dtype == torch.int32 and got.shape == (C + 1,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert want[:C].sum() > 0 and want[C] > 0
