"""The port's partitioned traversal (parallel/partition.py) and its
collectives (parallel/comm.py) in gloo ranks on the CPU
(parallel/launch.py ``run_ranks``, rank functions in torch_dist_ranks.py),
against the JAX package.

Once directly: the ring at D = 2 on bunny against the JAX package's
``trace_closest_partitioned`` (its Pallas kernel in interpret mode): the
routed / improved counters bitwise; t bitwise but on lanes where the JAX
ring's own t is one ulp off the JAX whole-table trace's for the same
triangle (XLA contracts the kernel's Moller-Trumbore otherwise when it is
given start entries: 1 lane of 256 measured), where the port's t is the
whole-table trace's bitwise; prim, u and v bitwise but where two
triangles give the ray bitwise the same t (the JAX kernel walks a packet's
union, the port each ray alone), those lanes checked to be such ties. The
pop row counts each ray's own walk in the port and a packet's shared stack
in the JAX kernel, so it is held to the routed row (a routed ray pops), not
to the JAX numbers. Then, cheaper, the ring and the routed trace at D = 4
(hot subtrees replicated, so later hops start at the steady roots) against
the JAX package's whole-table trace: closest hits as above, occlusion
equal; the routed trace bitwise the ring; a round cap that truncates shows
in the routed counters' last row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.sharding import Mesh

from gpupathtracer_tpu.bvh.partition import build_partition as jax_build
from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.ops.traverse import trace_closest, trace_occluded
from gpupathtracer_tpu.parallel.partition import (
    shard_partition as jax_shard, trace_closest_partitioned as jax_tcp)
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch.bvh.partition import build_partition
from gpupathtracer_tpu_torch.ops.intersect import mt_intersect, pack_tri_geom
from gpupathtracer_tpu_torch.parallel.launch import run_ranks

import torch_dist_ranks as ranks

N = 256
DEADLINE = 120


def _bits(x):
    x = np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.fixture(scope="module")
def bunny():
    scene, meta = jax_load_scene(JaxRenderConfig(
        scene_path="proc:bunny", skybox="GENERATE COLOR BLACK"))
    rng = np.random.RandomState(7)
    o = rng.uniform(-2, 2, (N, 3)).astype(np.float32)
    d = rng.normal(size=(N, 3)).astype(np.float32)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = rng.rand(N) > 0.1
    tri = np.asarray(scene.tri_geom)
    return dict(scene=scene, rows=np.asarray(scene.bvh.node_rows),
                W=int(scene.bvh.child_bounds.shape[0]), o=o, d=d, act=act,
                far=np.full(N, 1e20, np.float32),
                near=np.full(N, 3.0, np.float32),
                geom=pack_tri_geom(tri[:, 0:3], tri[:, 3:6], tri[:, 6:9]),
                kw=dict(stack_depth=meta.stack_depth,
                        leaf_size=meta.leaf_size, packet_size=128))


def _hold_hits(got, want, b, skip=()):
    """t bitwise; prim, u, v bitwise but at true ties (the tie lanes' prim
    gives bitwise the same t), all but on the lanes ``skip``. Returns the
    tie lanes."""
    t, prim, u, v = got
    keep = np.setdiff1d(np.arange(N), skip)
    np.testing.assert_array_equal(_bits(t[keep]), _bits(want[0][keep]))
    tie = np.nonzero(prim != np.asarray(want[1]))[0]
    same = np.setdiff1d(keep, tie)
    for g, w in ((u, want[2]), (v, want[3])):
        np.testing.assert_array_equal(_bits(g[same]), _bits(np.asarray(w)[same]))
    if len(tie):
        assert (prim[tie] >= 0).all() and (np.asarray(want[1])[tie] >= 0).all()
        tt, _, _, ok = mt_intersect(torch.from_numpy(b["geom"][prim[tie]]),
                                    torch.from_numpy(b["o"][tie]),
                                    torch.from_numpy(b["d"][tie]))
        assert ok.all()
        np.testing.assert_array_equal(_bits(tt.numpy()), _bits(t[tie]))
    assert (prim[~b["act"]] == -1).all()
    assert (prim >= 0).sum() > N // 4
    return tie


@pytest.mark.parametrize("world", [2, 4])
def test_comm_primitives(world):
    """psum, pmax, all_gather, all_to_all and the ring shift (D = 2 too:
    one batch of sends and receives) on gloo ranks: each the collective of
    its JAX counterpart, the input left as it was, no host staging of CPU
    tensors."""
    res = run_ranks(ranks.comm_primitives, world, "gloo", "cpu",
                    timeout_s=DEADLINE)
    xs = [np.arange(6, dtype=np.float32) + 10 * r for r in range(world)]
    for r, got in enumerate(res):
        assert got["index"] == r and got["size"] == world
        assert got["backend"] == "gloo" and got["staged"]["calls"] == 0
        np.testing.assert_array_equal(got["psum"], sum(xs))
        np.testing.assert_array_equal(got["pmax"], xs[-1])
        assert got["psum_int"] == world * (world + 1) // 2
        np.testing.assert_array_equal(got["gather"], np.stack(xs))
        np.testing.assert_array_equal(
            got["a2a"], np.stack([np.arange(3) + 3 * r + 100 * s
                                  for s in range(world)]))
        prev = (r - 1) % world
        np.testing.assert_array_equal(got["shift"], xs[prev])
        np.testing.assert_array_equal(got["shift_pair"][0], xs[prev])
        assert got["shift_pair"][1].dtype == np.bool_
        np.testing.assert_array_equal(got["shift_pair"][1],
                                      [prev % 2 == 0, True])
        np.testing.assert_array_equal(got["x_after"], xs[r])


def test_run_ranks_deadline():
    """A rank that waits forever fails its caller at the deadline (every
    rank killed), and a rank that raises fails it with its log."""
    with pytest.raises(TimeoutError, match="did not finish within"):
        run_ranks(ranks.hang, 2, "gloo", "cpu", timeout_s=6)
    with pytest.raises(RuntimeError, match="rank 1 says no"):
        run_ranks(ranks.fail_on_rank1, 2, "gloo", "cpu", timeout_s=30)


@pytest.fixture(scope="module")
def whole(bunny):
    """The JAX package's whole-table traces (interpret mode): closest hits
    at t_max 1e20, occlusion at 3."""
    b = bunny
    o, d, act = (jnp.asarray(b[k]) for k in ("o", "d", "act"))
    ref = trace_closest(b["scene"], o, d, jnp.asarray(b["far"]), act,
                        traversal="pallas", **b["kw"])
    occ = trace_occluded(b["scene"], o, d, jnp.asarray(b["near"]), act,
                         traversal="pallas", **b["kw"])
    return [np.asarray(x) for x in ref], np.asarray(occ)


def test_ring_d2_bitwise_jax(bunny, whole):
    """The one direct comparison: JAX's ring at D = 2, closest, with_stats
    (replicate_hot 6, so hop 1 starts at the steady roots)."""
    b = bunny
    part = jax_build(b["rows"], b["W"], 2)
    mesh = Mesh(np.array(jax.devices()[:2]), axis_names=("chips",))
    tables, route = jax_shard(part, mesh)
    hit, stats = jax_tcp(mesh, tables, route, jnp.asarray(b["o"]),
                         jnp.asarray(b["d"]), jnp.asarray(b["far"]),
                         jnp.asarray(b["act"]), with_stats=True, **b["kw"])
    want = [np.asarray(x) for x in hit]
    stats = np.asarray(stats)
    port = build_partition(b["rows"], b["W"], 2)
    assert (port.steady_root > 0).all()
    rays = (b["o"], b["d"], b["far"], b["act"])
    res = run_ranks(ranks.partitioned_traces, 2, "gloo", "cpu",
                    args=(port, [(rays, dict(routing="ring", **b["kw"]))]),
                    timeout_s=DEADLINE)
    ref = whole[0]
    off = np.nonzero(_bits(want[0]) != _bits(ref[0]))[0]
    assert len(off) <= 2
    np.testing.assert_array_equal(want[1][off], ref[1][off])
    assert (np.abs(_bits(want[0][off]) - _bits(ref[0][off])) == 1).all()
    for (got, st), in res:
        _hold_hits(got, want, b, skip=off)
        np.testing.assert_array_equal(_bits(got[0][off]), _bits(ref[0][off]))
        assert st.shape == stats.shape == (2, 3, 2)
        np.testing.assert_array_equal(st[:, :2], stats[:, :2])
        assert ((st[:, 2] > 0) == (st[:, 0] > 0)).all()
        assert (st[:, 2] >= st[:, 0]).all()


RUNS = {
    "ring-closest": dict(routing="ring"),
    "ring-anyhit": dict(routing="ring", any_hit=True),
    "routed-closest": dict(routing="routed"),
    "routed-anyhit": dict(routing="routed", any_hit=True),
    "routed-truncated": dict(routing="routed", max_rounds=1, bucket_cap=8),
}


@pytest.fixture(scope="module")
def d4(bunny, whole):
    """Every D = 4 trace in one set of ranks, and the JAX whole-table
    references."""
    b = bunny
    part = build_partition(b["rows"], b["W"], 4)
    runs = []
    for kw in RUNS.values():
        tm = b["near"] if kw.get("any_hit") else b["far"]
        runs.append(((b["o"], b["d"], tm, b["act"]), dict(kw, **b["kw"])))
    res = run_ranks(ranks.partitioned_traces, 4, "gloo", "cpu",
                    args=(part, runs), timeout_s=DEADLINE)
    for r in res[1:]:  # every rank sees the same gathered results
        for (g, s), (g0, s0) in zip(r, res[0]):
            assert all(np.array_equal(x, y) for x, y in zip(g, g0))
            np.testing.assert_array_equal(s, s0)
    return dict(zip(RUNS, res[0]), ref=whole[0], occ=whole[1])


@pytest.mark.parametrize("routing", ["ring", "routed"])
def test_d4_closest_matches_whole_table(bunny, d4, routing):
    got, st = d4[f"{routing}-closest"]
    _hold_hits(got, d4["ref"], bunny)
    if routing == "ring":
        assert st.shape == (4, 3, 4)
        assert (st[:, 1] <= st[:, 0]).all() and st[:, 0].sum() > 0
    else:
        assert st.shape == (4, 4, 7)
        assert (st[:, 3, -1] == 0).all()  # nothing left in flight
        assert st[:, 2].sum() == bunny["act"].sum()  # every ray delivered


@pytest.mark.parametrize("routing", ["ring", "routed"])
def test_d4_occlusion_matches_whole_table(d4, routing):
    (occ,), st = d4[f"{routing}-anyhit"]
    np.testing.assert_array_equal(occ, d4["occ"])
    assert 0 < occ.sum() < occ.size


@pytest.mark.parametrize("query", ["closest", "anyhit"])
def test_routed_bitwise_ring(d4, query):
    ring, _ = d4[f"ring-{query}"]
    routed, _ = d4[f"routed-{query}"]
    for a, b in zip(ring, routed):
        np.testing.assert_array_equal(_bits(a), _bits(b))


def test_routed_truncation_is_counted(bunny, d4):
    """One round with 8-ray buckets cannot finish every ray: the rays
    still in flight show in the counters' last row, and the delivered ones
    carry the full trace's hits."""
    got, st = d4["routed-truncated"]
    full, _ = d4["routed-closest"]
    assert st.shape == (4, 4, 2)
    in_flight = int(st[:, 3, -1].sum())
    assert in_flight > 0
    differ = np.nonzero(_bits(got[0]) != _bits(full[0]))[0]
    assert len(differ) <= in_flight
