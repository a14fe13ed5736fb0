"""The port's treelet-binned traversal (ops/treelet.py) against the JAX
package's (ops/treelet.py, its kernel in interpret mode), the Renderer with
treelet-binned bounce rays against the JAX Renderer and against its own
"same" film, and the refusals of this slice: the megakernel and the
sub-packet kernel at an arity other than 8, the treelet traversal on
cluster tables.

The candidates, bins and rounds are the JAX package's, integer for
integer (the round counts are compared), and every slot's walk is the
per-ray walk from its treelet's root, so t and occlusion are bitwise the
JAX traversal's; prim, u and v too, except where two triangles give a ray
bitwise the same t (the JAX kernel visits a packet's union in one order,
the port each ray alone; and among a ray's winning slots of one round the
port keeps the lowest, the JAX package whichever its scatter writes), and
those lanes are checked to be such ties.
"""

import math
from types import SimpleNamespace

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.bvh import WideBVH
from gpupathtracer_tpu.bvh import build_wide_bvh as jax_build_wide_bvh
from gpupathtracer_tpu.bvh.wide import pack_for_packets as jax_pack
from gpupathtracer_tpu.config import CameraConfig as JaxCameraConfig
from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.ops import treelet as jax_treelet
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.ops import treelet
from gpupathtracer_tpu_torch.ops.intersect import mt_intersect, pack_tri_geom
from gpupathtracer_tpu_torch.ops.subpacket_traverse import traverse_subpacket
from gpupathtracer_tpu_torch.ops.tsort import trace_closest_tsort
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import load_scene

K = 128


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


def _case(n_rays, seed=7):
    """The 400-triangle soup of tests/test_treelet.py: the JAX scene, the
    port's (the same tables), rays, occlusion distances and an active mask
    with about 15% of lanes off."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-5, 5, (400, 1, 3))
    tri = (base + rng.uniform(-0.6, 0.6, (400, 3, 3))).astype(np.float32)
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    wide, stats = jax_build_wide_bvh(p0, p1, p2, leaf_size=4,
                                     builder="numpy")
    wide = jax_pack(wide, p0, p1 - p0, p2 - p0, 4)
    jscene = SimpleNamespace(bvh=WideBVH(*(
        jnp.asarray(a) if a is not None else None for a in wide)))
    tscene = SimpleNamespace(
        node_rows=torch.from_numpy(wide.node_rows),
        cut_entry=torch.from_numpy(wide.cut_entry),
        cut_bounds=torch.from_numpy(wide.cut_bounds), cluster_rows=None,
        arity=8)
    o = rng.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    d = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(jax=jscene, port=tscene, o=o, d=d,
                depth=min(stats.max_depth * 7 + 2, 192),
                far=np.full(n_rays, 1e20, np.float32),
                t_occ=rng.uniform(0.5, 8.0, n_rays).astype(np.float32),
                act=rng.rand(n_rays) < 0.85,
                geom=pack_tri_geom(p0, p1 - p0, p2 - p0))


def _traces(case, any_hit, **kw):
    """(port's (t, prim, u, v, occluded, rounds), JAX's the same)."""
    t_max = case["t_occ"] if any_hit else case["far"]
    n = case["o"].shape[0]
    args = dict(stack_depth=case["depth"], leaf_size=4, any_hit=any_hit,
                packet_size=K, max_rounds=kw.get("max_rounds", 64),
                fanout=4)
    cap = treelet._plan(case["port"], n, K, kw.get("cap_factor", 2.0))
    got = treelet._treelet_trace(
        case["port"], torch.from_numpy(case["o"]),
        torch.from_numpy(case["d"]), torch.from_numpy(t_max),
        torch.from_numpy(case["act"]), cap=cap, **args)
    jcap = jax_treelet._plan(case["jax"], n, K, kw.get("cap_factor", 2.0))[2]
    assert cap == jcap
    want = jax_treelet._treelet_trace(
        case["jax"].bvh.node_rows, case["jax"].bvh.cut_entry,
        case["jax"].bvh.cut_bounds, jnp.asarray(case["o"]),
        jnp.asarray(case["d"]), jnp.asarray(t_max), jnp.asarray(case["act"]),
        cap=cap, interpret=True, arity=case["port"].arity, **args)
    return got, [np.asarray(x) for x in want]


def _hold_closest(got, want, case):
    """t bitwise, prim / u / v bitwise but at true ties; the ties."""
    t, prim, u, v = (x.numpy() for x in got[:4])
    np.testing.assert_array_equal(_bits(t), _bits(want[0]))
    tie = np.nonzero(prim != want[1])[0]
    same = np.setdiff1d(np.arange(t.shape[0]), tie)
    for g, w in ((u, want[2]), (v, want[3])):
        np.testing.assert_array_equal(_bits(g[same]), _bits(w[same]))
    if len(tie):
        tt, _, _, ok = mt_intersect(torch.from_numpy(case["geom"][prim[tie]]),
                                    torch.from_numpy(case["o"][tie]),
                                    torch.from_numpy(case["d"][tie]))
        assert ok.all() and (want[1][tie] >= 0).all()
        np.testing.assert_array_equal(_bits(tt), _bits(t[tie]))
    off = ~case["act"]
    assert (t[off] == case["far"][off]).all() and (prim[off] == -1).all()
    return tie


def _rounds_match(got_rounds, want_rounds, max_rounds):
    """The JAX loop runs one more round, with no candidate left, before it
    stops; the port stops at that round's host read."""
    if got_rounds < max_rounds:
        assert want_rounds == got_rounds + 1
    else:
        assert want_rounds == max_rounds


@pytest.mark.parametrize("n_rays,kw", [
    (700, {}),
    (256, dict(cap_factor=0.01)),
    (256, dict(max_rounds=1)),
], ids=["default", "overflow", "fallback"])
def test_treelet_matches_jax(n_rays, kw):
    """trace_closest_treelet / trace_occluded_treelet's round loop against
    the JAX package's: 700 rays at its defaults; 256 rays with bins of one
    packet (cap_factor 0.01, so pairs overflow and retry); one round
    (max_rounds 1) and the whole-tree fallback for the rest."""
    case = _case(n_rays)
    before = dict(treelet.TRACES)
    got, want = _traces(case, any_hit=False, **kw)
    _hold_closest(got, want, case)
    _rounds_match(got[5], int(want[5]), kw.get("max_rounds", 64))
    occ, occ_want = _traces(case, any_hit=True, **kw)
    np.testing.assert_array_equal(occ[4].numpy(), occ_want[4])
    assert not occ[4].numpy()[~case["act"]].any()
    _rounds_match(occ[5], int(occ_want[5]), kw.get("max_rounds", 64))
    hits = (got[1].numpy() >= 0).mean()
    assert 0.1 < hits < 0.9 and 0.02 < occ[4].numpy().mean() < 0.9
    fallbacks = treelet.TRACES["fallbacks"] - before["fallbacks"]
    assert (fallbacks == 2) == ("max_rounds" in kw)
    if "cap_factor" in kw:
        assert got[5] > 1


def test_public_entry_points_are_the_round_loop():
    """trace_closest_treelet / trace_occluded_treelet return the loop's
    hits (ops/traverse.py dispatches "treelet" to them)."""
    from gpupathtracer_tpu_torch.ops.traverse import (trace_closest,
                                                      trace_occluded)
    case = _case(256, seed=5)
    rays = [torch.from_numpy(case[k]) for k in ("o", "d")]
    act = torch.from_numpy(case["act"])
    kw = dict(stack_depth=case["depth"], leaf_size=4)
    hit = trace_closest(case["port"], *rays, torch.from_numpy(case["far"]),
                        act, traversal="treelet", **kw)
    loop = treelet._treelet_trace(
        case["port"], *rays, torch.from_numpy(case["far"]), act,
        any_hit=False, packet_size=K, cap=treelet._plan(case["port"], 256,
                                                        K, 2.0),
        max_rounds=64, fanout=4, **kw)
    for g, w in zip(hit, loop[:4]):
        assert torch.equal(g, w)
    occ = trace_occluded(case["port"], *rays, torch.from_numpy(case["t_occ"]),
                         act, traversal="treelet", **kw)
    assert torch.equal(occ, treelet.trace_occluded_treelet(
        case["port"], *rays, torch.from_numpy(case["t_occ"]), act,
        packet_size=K, **kw))


def _cornell(module, bounce, **kw):
    c = module.RenderConfig(scene_path="proc:cornell",
                            skybox="GENERATE COLOR BLACK", width=24,
                            height=24, ray_chunk=576, max_bounces=4,
                            bounce_traversal=bounce, treelet_min=1, **kw)
    c.camera = module.CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                                   fov=math.radians(45), aspect=1.0)
    return c


def test_renderer_treelet_matches_jax_and_same():
    """The slice as a whole: Renderers with bounce_traversal="treelet" and
    treelet_min=1 on cornell 24x24 (tests/test_treelet.py's recipe), the
    port's with 128-ray packets as the JAX Renderer on the CPU packs them.
    Against the JAX Renderer: the golden's rtol = atol = 2e-3 a pixel and
    the same ray count; against the port's own "same" film: JAX
    test_treelet.py's rtol 1e-4, atol 1e-5 (the hits differ at most at
    true ties)."""
    ns = SimpleNamespace(RenderConfig=JaxRenderConfig,
                         CameraConfig=JaxCameraConfig)
    jr = JaxRenderer(_cornell(ns, "treelet", traversal="packet"))
    jr.render_frame("wavefront")
    ports = {}
    before = dict(treelet.TRACES)
    for bounce in ("treelet", "same"):
        tns = SimpleNamespace(RenderConfig=RenderConfig,
                              CameraConfig=CameraConfig)
        r = Renderer(_cornell(tns, bounce, pallas_packet_size=K), "cpu")
        assert r.packet_size == K
        r.render_frame("wavefront")
        ports[bounce] = r
    assert treelet.TRACES["closest"] > before["closest"]
    got = ports["treelet"].film_hdr()
    want = np.asarray(jr.film_hdr())
    assert want.mean() > 0
    np.testing.assert_allclose(got, want, rtol=2e-3, atol=2e-3)
    assert ports["treelet"].stats.rays_traced == jr.stats.rays_traced
    np.testing.assert_allclose(got, ports["same"].film_hdr(), rtol=1e-4,
                               atol=1e-5)


def test_refusals():
    """The megakernel and the sub-packet kernel read 8-wide rows only
    (NotImplementedError at 16); the treelet traversal reads MT leaves
    (ValueError on a cluster scene, in the Renderer and in ops/treelet.py);
    16-wide scenes still render through the wavefront."""
    cfg = RenderConfig(scene_path="proc:cornell", width=8, height=8,
                       wide_arity=16, megakernel="on", max_bounces=2)
    with pytest.raises(NotImplementedError, match="1351-1355"):
        Renderer(cfg, "cpu")
    cfg.megakernel = "off"
    r = Renderer(cfg, "cpu")
    r.render_frame()
    assert r.scene.arity == 16 and r.film_hdr().max() > 0
    scene, meta = r.scene, r.meta
    n = 256
    o = torch.zeros((1, n, 3))
    d = torch.zeros((1, n, 3))
    d[..., 2] = 1.0
    with pytest.raises(NotImplementedError, match="8-wide"):
        traverse_subpacket(scene.node_rows, o, d, torch.full((1, n), 1e20),
                           torch.ones((1, n), dtype=torch.bool),
                           stack_depth=meta.stack_depth, arity=16)
    with pytest.raises(NotImplementedError, match="8-wide"):
        trace_closest_tsort(scene, o[0], d[0], torch.full((n,), 1e20),
                            torch.ones(n, dtype=torch.bool),
                            stack_depth=meta.stack_depth, leaf_size=4,
                            kernel="subpacket")
    ccfg = RenderConfig(scene_path="proc:cornell", width=8, height=8,
                        cluster_tris=128, bounce_traversal="treelet")
    with pytest.raises(ValueError, match="cluster"):
        Renderer(ccfg, "cpu")
    cscene, cmeta = load_scene(ccfg, "cpu")
    with pytest.raises(ValueError, match="cluster"):
        treelet.trace_closest_treelet(
            cscene, o[0], d[0], torch.full((n,), 1e20),
            torch.ones(n, dtype=torch.bool), stack_depth=cmeta.stack_depth,
            leaf_size=4)
