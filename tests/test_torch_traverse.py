"""The port's traversal (ops/kernel_traverse.py) against the JAX package.

The plain torch version walks each ray with its own stack, in the CUDA
kernel's order and with its arithmetic. Against the Pallas kernel in
interpret mode (the JAX package's main-path traversal as its own tests run
it on the CPU) hits and t/u/v are bit-identical; against the JAX per-lane
traversal, whose Moller-Trumbore XLA contracts into other fused
multiply-adds, prims are equal, t agrees to 1e-6 relative and u/v to 1e-5.
"""

import math
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.bvh import WideBVH
from gpupathtracer_tpu.ops.pallas_traverse import traverse_pallas
from gpupathtracer_tpu.ops.traverse import any_hit, closest_hit
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.math.camera import gen_rays, generate_image_plane
from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
from gpupathtracer_tpu_torch.ops.intersect import mt_intersect
from gpupathtracer_tpu_torch.ops.traverse import trace_closest
from gpupathtracer_tpu_torch.scene import load_scene
from gpupathtracer_tpu_torch.scene.mesh import build_triangle_soup
from gpupathtracer_tpu_torch.scene.procedural import (default_camera,
                                                      load_procedural)
from test_torch_kernel import _port, _rows, _soup_case

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _bits(x):
    x = x.numpy() if isinstance(x, torch.Tensor) else np.asarray(x)
    return x.view(np.int32) if x.dtype == np.float32 else x


@pytest.mark.parametrize("leaf", [4, 10, 15])
def test_plain_matches_jax_per_lane(leaf):
    case = _soup_case(7, leaf=leaf)
    dev = WideBVH(*((jnp.asarray(a) if a is not None else None)
                    for a in case["wide"]))
    geom = jnp.asarray(case["geom"])
    o, d, act = (jnp.asarray(case[k]) for k in ("o", "d", "act"))
    kw = dict(stack_depth=case["depth"], leaf_size=leaf)
    want = closest_hit(dev, geom, o, d, jnp.asarray(case["far"]), act, **kw)
    got = kt.closest(_rows(case), *_port(case, case["far"]), **kw)
    np.testing.assert_array_equal(got[1].numpy(), np.asarray(want.prim))
    # XLA contracts the per-lane MT (jnp.cross, jnp.sum) into other fused
    # multiply-adds than the Pallas form: the same hits, t a few ulp apart;
    # the barycentrics, which cancel, to 1e-5 absolute (measured 4.5e-6).
    np.testing.assert_allclose(got[0].numpy(), np.asarray(want.t), rtol=1e-6)
    for g, w in ((got[2], want.u), (got[3], want.v)):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=0,
                                   atol=1e-5)
    occ_want = any_hit(dev, geom, o, d, jnp.asarray(case["t_occ"]), act, **kw)
    occ = kt.anyhit(_rows(case), *_port(case, case["t_occ"]), **kw)
    np.testing.assert_array_equal(occ.numpy(), np.asarray(occ_want))
    assert 0.05 < occ.numpy().mean() < 0.95


def _pallas(case, t_max, **kw):
    P = case["o"].shape[0] // 128
    shaped = [jnp.asarray(case["o"]).reshape(P, 128, 3),
              jnp.asarray(case["d"]).reshape(P, 128, 3),
              jnp.asarray(t_max).reshape(P, 128),
              jnp.asarray(case["act"]).reshape(P, 128)]
    out = traverse_pallas(jnp.asarray(case["wide"].node_rows), *shaped,
                          stack_depth=case["depth"], leaf_size=case["leaf"],
                          interpret=True, **kw)
    return [np.asarray(x).reshape(-1) for x in out]


def test_plain_matches_pallas_kernel_bitwise():
    """B1 (_kernel), ordered closest-hit and unordered any-hit."""
    case = _soup_case(11, leaf=10)
    kw = dict(stack_depth=case["depth"], leaf_size=case["leaf"])
    t, prim, u, v = _pallas(case, case["far"])
    got = kt.closest(_rows(case), *_port(case, case["far"]), **kw)
    for g, w in zip(got, (t, prim, u, v)):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    _, prim_a, _, _ = _pallas(case, case["t_occ"], any_hit=True,
                              ordered=False)
    occ = kt.anyhit(_rows(case), *_port(case, case["t_occ"]), **kw)
    np.testing.assert_array_equal(occ.numpy(), prim_a >= 0)


def test_plain_matches_fused_pair_kernel():
    """B3 (_kernel_pair): two packets per step, the shadow-ray default on
    small tables; 4 x 128 rays so that the packet count is even."""
    case = _soup_case(5, leaf=4, n_rays=512)
    _, prim, _, _ = _pallas(case, case["t_occ"], interleave=2,
                            fused_pair=True, any_hit=True, ordered=False)
    occ = kt.anyhit(_rows(case), *_port(case, case["t_occ"]),
                    stack_depth=case["depth"], leaf_size=case["leaf"])
    np.testing.assert_array_equal(occ.numpy(), prim >= 0)
    assert 0.05 < occ.numpy().mean() < 0.95


HIT_CORPUS = {"cornell_hits_32": "proc:cornell",
              "table_hits_32": "proc:table",
              "bathroom_hits_32": "proc:bathroom"}
# Lanes where the golden's prim is another triangle at an exact tie.
KNOWN_TIES = {"cornell_hits_32": [825]}


@pytest.mark.parametrize("name", sorted(HIT_CORPUS))
def test_exact_hit_goldens(name):
    """tests/test_golden_hits.py's recipe on the port, against the npz."""
    res = 32
    scene_path = HIT_CORPUS[name]
    cfg = RenderConfig(scene_path=scene_path, skybox="GENERATE COLOR BLACK",
                       width=res, height=res)
    if scene_path == "proc:cornell":
        cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                                  fov=math.radians(45), aspect=1.0)
    else:
        pos, yaw, pitch, fov, aperture, focus = default_camera(scene_path)
        cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                                  fov=math.radians(fov), aspect=1.0,
                                  aperture=aperture, focal_distance=focus)
    scene, meta = load_scene(cfg, "cpu")
    n = res * res
    idx = np.arange(n)
    interp = np.stack([(idx % res + 0.5) / res, (idx // res + 0.5) / res],
                      axis=-1).astype(np.float32)
    o, d = gen_rays(generate_image_plane(cfg.camera, "cpu"),
                    torch.from_numpy(interp), torch.full((n, 2), 0.5))
    hit = trace_closest(scene, o, d, torch.full((n,), 1e20),
                        torch.ones(n, dtype=torch.bool),
                        stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    gold = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))
    # t bitwise in every lane.
    np.testing.assert_array_equal(_bits(hit.t), _bits(gold["t"]))
    # prim equal in every lane but the known tie: two triangles hit at
    # bitwise the same t (the shared edge of cornell's ceiling and left
    # wall, lane 825), where the first visited wins. The JAX kernel visits
    # in packet order, the port in per-ray order.
    prim = hit.prim.numpy()
    tie = np.nonzero(prim != gold["prim"])[0]
    np.testing.assert_array_equal(tie, KNOWN_TIES.get(name, []))
    if len(tie):
        soup = build_triangle_soup(load_procedural(scene_path)[0])
        other = torch.from_numpy(np.concatenate(
            [soup.p0, soup.e1, soup.e2], axis=1)[gold["prim"][tie]])
        t_other, _, _, ok = mt_intersect(other, o[tie], d[tie])
        assert ok.all()
        np.testing.assert_array_equal(_bits(t_other), _bits(hit.t[tie]))
    assert (prim >= 0).mean() > 0.5
