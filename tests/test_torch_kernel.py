"""The CUDA kernels' wrappers (ops/kernel_traverse.py, ops/kernel_cluster.py,
ops/megakernel.py) and the exact arithmetic they share with their plain
versions.

This module imports no JAX, so its `cuda` tests also run on the machine
with the card, which has none (tests/conftest.py imports jax, hence
--noconftest there):

    python -m pytest tests/test_torch_kernel.py -m cuda --noconftest -q
"""

import math
import os
from fractions import Fraction

import numpy as np
import pytest
import torch

from gpupathtracer_tpu_torch.bvh import build_wide_bvh
from gpupathtracer_tpu_torch.bvh.wide import pack_for_packets
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
from gpupathtracer_tpu_torch.ops import megakernel as mk
from gpupathtracer_tpu_torch.ops.intersect import fma32, pack_tri_geom

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")


def _soup_case(seed, leaf=4, n_tris=400, n_rays=512):
    """The random-soup recipe of tests/test_pallas.py, with rays, a random
    occlusion distance and a random active mask."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-5, 5, (n_tris, 1, 3))
    offs = rng.uniform(-0.6, 0.6, (n_tris, 3, 3))
    tri = (base + offs).astype(np.float32)
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=leaf, builder="numpy",
                                 force_leaf=True)
    wide = pack_for_packets(wide, p0, p1 - p0, p2 - p0, leaf)
    o = rng.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    tgt = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32)
    d = tgt - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(
        wide=wide, geom=pack_tri_geom(p0, p1 - p0, p2 - p0),
        depth=min(stats.max_depth * 7 + 2, kt.MAX_STACK), leaf=leaf, o=o, d=d,
        far=np.full((n_rays,), 1e20, np.float32),
        t_occ=rng.uniform(0.5, 8.0, n_rays).astype(np.float32),
        act=rng.rand(n_rays) < 0.9)


def _port(case, t_max, device="cpu"):
    """Rays o, d, t_max, active as tensors on `device`."""
    return [torch.tensor(x, device=device)
            for x in (case["o"], case["d"], t_max, case["act"])]


def _rows(case, device="cpu"):
    return torch.tensor(case["wide"].node_rows, device=device)


def _nearest_f32(v: Fraction) -> np.float32:
    """The float32 nearest to v, ties to even."""
    f = np.float32(float(v))
    cands = [np.nextafter(f, np.float32(-np.inf)), f,
             np.nextafter(f, np.float32(np.inf))]
    err = [abs(Fraction(float(x)) - v) for x in cands]
    best = [x for x, e in zip(cands, err) if e == min(err)]
    return min(best, key=lambda x: int(np.float32(x).view(np.int32)) & 1)


def test_fma32_rounds_once():
    """fma32 equals the exactly rounded a*b + c, including products that
    nearly cancel c, where a float64 sum rounds twice."""
    rng = np.random.RandomState(1)
    n = 4000
    a = (rng.randn(n) * np.exp2(rng.randint(-20, 20, n))).astype(np.float32)
    b = (rng.randn(n) * np.exp2(rng.randint(-20, 20, n))).astype(np.float32)
    c = (rng.randn(n) * np.exp2(rng.randint(-60, 60, n))).astype(np.float32)
    c[: n // 2] = -(a[: n // 2].astype(np.float64) * b[: n // 2]).astype(
        np.float32)
    got = fma32(*(torch.from_numpy(x) for x in (a, b, c))).numpy()
    for i in range(n):
        want = _nearest_f32(Fraction(float(a[i])) * Fraction(float(b[i]))
                            + Fraction(float(c[i])))
        assert got[i] == want, (a[i], b[i], c[i])


def test_wrapper_rejects_bad_inputs():
    case = _soup_case(3, n_rays=128)
    rows = _rows(case)
    o, d, t, act = _port(case, case["far"])
    kw = dict(stack_depth=case["depth"], leaf_size=4)
    with pytest.raises(ValueError):
        kt.closest(rows, o.double(), d, t, act, **kw)
    with pytest.raises(ValueError):
        kt.closest(rows, o[:, :2], d, t, act, **kw)
    with pytest.raises(ValueError):
        kt.closest(rows, o.t().contiguous().t(), d, t, act, **kw)
    with pytest.raises(ValueError):
        kt.anyhit(rows, o, d, t, act, stack_depth=kt.MAX_STACK + 1,
                  leaf_size=4)
    # Neither a CPU nor a CUDA tensor: raise, never the plain path.
    with pytest.raises(ValueError):
        kt.closest(rows.to("meta"), o.to("meta"), d.to("meta"),
                   t.to("meta"), act.to("meta"), **kw)
    before = dict(kt.LAUNCHES)
    kt.closest(rows, o, d, t, act, **kw)  # CPU: the plain version
    assert kt.LAUNCHES == before


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the kernel has no CPU mode")


@pytest.mark.cuda
def test_kernel_matches_plain_on_cuda():
    _need_cuda()
    launches = dict(kt.LAUNCHES)
    for leaf in (4, 10, 15):
        case = _soup_case(7, leaf=leaf, n_tris=4000, n_rays=65536)
        kw = dict(stack_depth=case["depth"], leaf_size=leaf)
        rows = _rows(case, "cuda")
        rays = _port(case, case["far"], "cuda")
        got = kt.closest(rows, *rays, **kw)
        want = kt.closest_plain(rows, *rays, **kw)
        for g, w in zip(got, want):
            if g.dtype == torch.float32:
                g, w = g.view(torch.int32), w.view(torch.int32)
            assert torch.equal(g, w)
        occ_rays = _port(case, case["t_occ"], "cuda")
        assert torch.equal(kt.anyhit(rows, *occ_rays, **kw),
                           kt.anyhit_plain(rows, *occ_rays, **kw))
    assert kt.LAUNCHES["trace_closest"] == launches["trace_closest"] + 3
    assert kt.LAUNCHES["trace_anyhit"] == launches["trace_anyhit"] + 3


@pytest.mark.cuda
def test_render_on_cuda_matches_golden():
    """tests/test_golden.py's cornell recipe, rendered on the card."""
    _need_cuda()
    from gpupathtracer_tpu_torch.render import Renderer

    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=32, height=32, ray_chunk=1024, max_bounces=8)
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    r = Renderer(cfg, "cuda")
    for _ in range(8):
        r.render_frame()
    img = r.film_hdr()
    gold = np.load(os.path.join(GOLDEN_DIR, "cornell_32_8spp.npz"))["hdr"]
    # The golden's own tolerance; CUDA's sin/cos/log/exp differ from XLA's
    # in the last place (chip_smoke.py measured max |diff| 1.3e-5).
    np.testing.assert_allclose(img, gold, rtol=2e-3, atol=2e-3)


@pytest.mark.cuda
def test_megakernel_matches_plain_on_cuda():
    """trace_mega against trace_mega_plain on the card, cornell and
    bathroom: one sample, and four with in-kernel regeneration. Ray counts
    equal, contributions bitwise equal."""
    _need_cuda()
    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.math.camera import generate_image_plane
    from gpupathtracer_tpu_torch.scene import load_scene
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    launches = mk.LAUNCHES["trace_mega"]
    for name, model in (("cornell", "trowbridge_reitz"),
                        ("bathroom", "beckmann")):
        cfg = RenderConfig(scene_path=f"proc:{name}", width=64, height=48,
                           skybox="GENERATE COLOR BLACK")
        pos, yaw, pitch, fov, aperture, focus = default_camera(name)
        cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                                  fov=math.radians(fov), aspect=64 / 48,
                                  aperture=aperture, focal_distance=focus)
        scene, meta = load_scene(cfg, "cuda")
        lane = torch.arange(64 * 48, device="cuda")
        for spp in (1, 4):
            args, kw = mk.prepare_mega(
                scene, mk.pack_mega_tables(scene),
                generate_image_plane(cfg.camera, "cuda"),
                (lane % 64).float(), (lane // 64).float(),
                random.PRNGKey(3, "cuda"), width=64, height=48,
                stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
                max_bounces=16, model=model, n_mats=meta.num_materials,
                n_lights=int(scene.light_rows.shape[0]), spp=spp)
            got, rays = mk.trace_mega(*args, **kw)
            want, rays_plain = mk.trace_mega_plain(*args, **kw)
            assert int(rays) == int(rays_plain)
            assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert mk.LAUNCHES["trace_mega"] == launches + 4


@pytest.mark.cuda
def test_cluster_kernel_matches_plain_on_cuda():
    """The cluster traversal kernel (csrc/cluster_traverse.cu) against its
    plain version on the card, the table and bathroom cluster tables at
    tc = 128 and 256: t, prim, u, v and occluded bitwise equal."""
    _need_cuda()
    from gpupathtracer_tpu_torch.scene import load_scene

    launches = dict(kc.LAUNCHES)
    rng = np.random.RandomState(2)
    n = 16384
    for name in ("table", "bathroom"):
        for tc in (128, 256):
            scene, meta = load_scene(RenderConfig(scene_path=f"proc:{name}",
                                                  cluster_tris=tc), "cuda")
            o = rng.uniform(-1, 1, (n, 3)) * 2 + [0, 1, 0]
            d = rng.normal(size=(n, 3))
            d /= np.linalg.norm(d, axis=1, keepdims=True)
            o, d, far, t_occ = (
                torch.tensor(x.astype(np.float32), device="cuda")
                for x in (o, d, np.full(n, 1e20), rng.uniform(0.05, 6, n)))
            act = torch.tensor(rng.rand(n) < 0.9, device="cuda")
            tabs = (scene.node_rows, scene.cluster_rows)
            kw = dict(stack_depth=meta.stack_depth)
            got = kc.closest_cluster(*tabs, scene.cluster_refs, o, d, far,
                                     act, **kw)
            want = kc.closest_cluster_plain(*tabs, scene.cluster_refs, o, d,
                                            far, act, **kw)
            for g, w in zip(got, want):
                if g.dtype == torch.float32:
                    g, w = g.view(torch.int32), w.view(torch.int32)
                assert torch.equal(g, w)
            assert torch.equal(
                kc.anyhit_cluster(*tabs, o, d, t_occ, act, **kw),
                kc.anyhit_cluster_plain(*tabs, o, d, t_occ, act, **kw))
    assert kc.LAUNCHES["trace_cluster_closest"] == \
        launches["trace_cluster_closest"] + 4
    assert kc.LAUNCHES["trace_cluster_anyhit"] == \
        launches["trace_cluster_anyhit"] + 4


@pytest.mark.cuda
def test_cluster_megakernel_matches_plain_on_cuda():
    """The megakernel's cluster variant against trace_mega_plain on the
    card, bathroom 64x48 at cluster_tris = 128: one sample, and four with
    in-kernel regeneration. Ray counts equal, contributions bitwise
    equal."""
    _need_cuda()
    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.math.camera import generate_image_plane
    from gpupathtracer_tpu_torch.scene import load_scene
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    launches = mk.LAUNCHES["trace_mega_cluster"]
    cfg = RenderConfig(scene_path="proc:bathroom", width=64, height=48,
                       skybox="GENERATE COLOR BLACK", cluster_tris=128)
    pos, yaw, pitch, fov, aperture, focus = default_camera("bathroom")
    cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                              fov=math.radians(fov), aspect=64 / 48,
                              aperture=aperture, focal_distance=focus)
    scene, meta = load_scene(cfg, "cuda")
    lane = torch.arange(64 * 48, device="cuda")
    for spp in (1, 4):
        args, kw = mk.prepare_mega(
            scene, mk.pack_mega_tables(scene),
            generate_image_plane(cfg.camera, "cuda"), (lane % 64).float(),
            (lane // 64).float(), random.PRNGKey(3, "cuda"), width=64,
            height=48, stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
            max_bounces=16, model="beckmann", n_mats=meta.num_materials,
            n_lights=int(scene.light_rows.shape[0]), spp=spp)
        got, rays = mk.trace_mega(*args, **kw)
        want, rays_plain = mk.trace_mega_plain(*args, **kw)
        assert int(rays) == int(rays_plain)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert mk.LAUNCHES["trace_mega_cluster"] == launches + 2
