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
from gpupathtracer_tpu_torch.bvh.cluster import pack_clusters
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


def twin_soup_case(n_tris=300, n_rays=4096, seed=3):
    """_soup_case's soup with every triangle twice (prims 2k and 2k + 1),
    built with one triangle a leaf: twins become sibling leaves with
    bitwise equal boxes, so a ray that enters one enters both at the same
    t_near (the child order keeps the lower slot first) and hits both at
    the same t (the first visited keeps the hit). Rays, occlusion distances
    and about 10% inactive lanes as _soup_case's."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-5, 5, (n_tris, 1, 3))
    tri = np.repeat((base + rng.uniform(-0.6, 0.6, (n_tris, 3, 3)))
                    .astype(np.float32), 2, axis=0)
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=1, builder="numpy",
                                 force_leaf=True)
    wide = pack_for_packets(wide, p0, p1 - p0, p2 - p0, 1)
    o = rng.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    d = rng.uniform(-4, 4, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(
        wide=wide, depth=min(stats.max_depth * 7 + 2, kt.MAX_STACK), leaf=1,
        o=o, d=d.astype(np.float32), far=np.full((n_rays,), 1e20, np.float32),
        t_occ=rng.uniform(0.5, 8.0, n_rays).astype(np.float32),
        act=rng.rand(n_rays) < 0.9)


def tied_siblings(rows) -> int:
    """Children of the node rows of a merged row table (numpy) whose box
    equals an earlier sibling's: each such pair ties in t_near for every
    ray that enters them."""
    entry = rows[:, 6 * kt.ARITY:7 * kt.ARITY].view(np.int32)
    used = entry != kt.INVALID_ENTRY
    nodes = np.unique(np.concatenate([[0], entry[used & (entry >= 0)]]))
    ties = 0
    for r in nodes:
        boxes = rows[r, :6 * kt.ARITY].reshape(kt.ARITY, 6)[used[r]]
        ties += len(boxes) - len(np.unique(boxes, axis=0))
    return ties


def _leaf_trig_case(K=4096):
    """A soup at one triangle a leaf and one packet of K rays: the first
    128-ray sub-packet's rays active as the soup's mask has them, each
    other sub-packet with one active ray. The first leaf backlog reaches
    LEAF_TRIG while the others stay short, with nodes left, so the trigger
    alone chooses the leaf phase (B6's rule)."""
    case = _soup_case(5, leaf=1, n_tris=400, n_rays=K)
    act = np.zeros(K, bool)
    act[:128] = case["act"][:128]
    others = np.random.RandomState(0).randint(0, 128, K // 128 - 1)
    act[128 * np.arange(1, K // 128) + others] = True
    case["act"] = act
    return case


def _port(case, t_max, device="cpu"):
    """Rays o, d, t_max, active as tensors on `device`."""
    return [torch.tensor(x, device=device)
            for x in (case["o"], case["d"], t_max, case["act"])]


def _rows(case, device="cpu"):
    return torch.tensor(case["wide"].node_rows, device=device)


def _sheet(point, n=8, size=10.0):
    """A square sheet of 2 n^2 triangles: point(u, v) for u, v in [0,
    size], [T, 3, 3]."""
    xs = np.linspace(0.0, size, n + 1)
    tris = []
    for i in range(n):
        for j in range(n):
            a, b, c, e = xs[i], xs[i + 1], xs[j], xs[j + 1]
            for q in (((a, c), (b, c), (b, e)), ((a, c), (b, e), (a, e))):
                tris.append([point(u, v) for u, v in q])
    return np.asarray(tris)


def far_cluster_case(offset=(3000.0, -1500.0, 2000.0), n_rays=4096, seed=5):
    """Two crossing sheets of 128 triangles, a floor (y = 0) and a wall
    (z = 5), thousands of units from the world origin, one cluster each
    (tc = 128): both boxes are flat, so a ray enters each at the sheet it
    hits. Half the rays aim at the line where the sheets cross, the rest
    at random points of the sheets, from 10^-3 to 10^1.5 units before the
    point in random directions. At the line both clusters hit at about the
    same t, and the slab entries round by about 2^-24 |o / d|, which is
    not small against t - t' there; elsewhere a ray may enter the other
    cluster well beyond its hit. Returns (tables, o, d, active, stack
    depth) on the CPU."""
    off = np.asarray(offset)
    tri = (np.concatenate([_sheet(lambda u, v: (u, 0.0, v)),
                           _sheet(lambda u, v: (u, v - 5.0, 5.0))])
           + off).astype(np.float32)
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=10, builder="numpy")
    wide = pack_clusters(wide, p0, p1 - p0, p2 - p0, tc=128)
    rng = np.random.RandomState(seed)
    u, v = rng.uniform(0.5, 9.5, (2, n_rays))
    line = np.arange(n_rays) < n_rays // 2
    wall = rng.rand(n_rays) < 0.5
    tgt = off + np.stack([u, np.where(line, 0.0, np.where(wall, v - 5, 0.0)),
                          np.where(line | wall, 5.0, v)], 1)
    d = rng.normal(size=(n_rays, 3))
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    s = 10.0 ** rng.uniform(-3, 1.5, n_rays)
    o = (tgt - d * s[:, None]).astype(np.float32)
    tabs = tuple(torch.tensor(x) for x in (wide.node_rows, wide.cluster_rows,
                                           wide.cluster_refs))
    return (tabs, torch.tensor(o), torch.tensor(d.astype(np.float32)),
            torch.tensor(rng.rand(n_rays) < 0.95),
            min(stats.max_depth * 7 + 2, kt.MAX_STACK))


def cluster_soup_case(tc=128, n_tris=600, n_rays=4096, seed=11,
                      duplicate=False, materials=0):
    """A random soup of small triangles (tests/test_pallas.py's recipe) on
    cluster leaves of tc slots, built with the numpy builder. With
    ``duplicate`` every triangle appears twice (prims 2k and 2k + 1), so a
    ray that hits one hits its twin at bitwise the same t, u and v: a tie
    that the lowest slot of the block must win. Rays from a cube around
    the soup toward points inside it; a random occlusion distance and
    about 10% of lanes inactive. With ``materials`` > 0 each triangle
    (twins alike) gets a material id below it and a normal sign, drawn
    from a stream of their own, in the blocks' row 7 (the megakernel's
    capture). Returns a dict: tables (node_rows, cluster_rows,
    cluster_refs as numpy), depth, o, d, far, t_occ, act."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-5, 5, (n_tris, 1, 3))
    tri = (base + rng.uniform(-0.6, 0.6, (n_tris, 3, 3))).astype(np.float32)
    mat = sign = None
    if materials:
        mrng = np.random.RandomState(seed + 1)
        mat = mrng.randint(0, materials, n_tris)
        sign = np.where(mrng.rand(n_tris) < 0.5, -1.0, 1.0).astype(np.float32)
    if duplicate:
        tri = np.repeat(tri, 2, axis=0)
        mat, sign = (None if x is None else np.repeat(x, 2)
                     for x in (mat, sign))
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=10, builder="numpy")
    wide = pack_clusters(wide, p0, p1 - p0, p2 - p0, tc=tc, tri_mat=mat,
                         tri_nsign=sign)
    o = rng.uniform(-8, 8, (n_rays, 3))
    d = rng.uniform(-4, 4, (n_rays, 3)) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return dict(
        tables={f: np.asarray(getattr(wide, f))
                for f in ("node_rows", "cluster_rows", "cluster_refs")},
        depth=min(stats.max_depth * 7 + 2, kt.MAX_STACK),
        o=o.astype(np.float32), d=d.astype(np.float32),
        far=np.full(n_rays, 1e20, np.float32),
        t_occ=rng.uniform(0.5, 8.0, n_rays).astype(np.float32),
        act=rng.rand(n_rays) < 0.9)


# The soup megakernel's materials (rows of ops/megakernel.py's mats table:
# albedo, roughness, metallic, emission) and its one triangle light above
# the soup (p0, e1, e2, normal, emission), out of the soup's reach.
SOUP_MATS = np.float32([[0.8, 0.7, 0.6, 0.3, 0.0, 0, 0, 0],
                        [0.5, 0.6, 0.9, 0.6, 1.0, 0, 0, 0],
                        [0.9, 0.9, 0.9, 0.9, 0.0, 2.0, 1.5, 1.0]])
SOUP_LIGHT = np.float32([-4, 9, -4, 8, 0, 0, 0, 0, 8, 0, -1, 0, 6, 6, 5])


def soup_mega_case(tc, duplicate, width, height, spp, max_bounces, device,
                   n_tris=3000):
    """cluster_soup_case's soup (three materials, SOUP_MATS) through the
    megakernel: width x height lanes of a camera 15 units before the soup,
    one packet (width * height lanes: not a multiple of 32 where the film
    is not), NEE from SOUP_LIGHT, a grey sky; spp > 1 takes the in-kernel
    regeneration. Returns trace_mega's (args, kwargs)."""
    from types import SimpleNamespace

    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.math.camera import generate_image_plane

    case = cluster_soup_case(tc=tc, n_tris=n_tris, n_rays=1, seed=11,
                             duplicate=duplicate, materials=len(SOUP_MATS))
    tabs = {k: torch.tensor(v, device=device)
            for k, v in case["tables"].items()}
    mats = np.zeros((len(SOUP_MATS), 16), np.float32)
    mats[:, :8] = SOUP_MATS
    lights = np.zeros((1, 16), np.float32)
    lights[0, :15] = SOUP_LIGHT
    area = 0.5 * float(np.linalg.norm(np.cross(SOUP_LIGHT[3:6],
                                               SOUP_LIGHT[6:9])))
    params = np.float32([area, 0.5 / area, 0.2, 0.25, 0.3])
    tables = tuple(torch.tensor(x, device=device)
                   for x in (mats, lights, np.float32([area]), params))
    cam = CameraConfig(position=(0.5, 0.3, -15.0), yaw=math.pi,
                       fov=math.radians(50), aspect=width / height)
    lane = torch.arange(width * height, device=device)
    return mk.prepare_mega(
        SimpleNamespace(node_rows=tabs["node_rows"],
                        cluster_rows=tabs["cluster_rows"], arity=kt.ARITY),
        tables, generate_image_plane(cam, device),
        (lane % width).float(), (lane // width).float(),
        random.PRNGKey(5, device), width=width, height=height,
        stack_depth=case["depth"], leaf_size=10, max_bounces=max_bounces,
        model="beckmann", n_mats=len(SOUP_MATS), n_lights=1,
        packet_size=width * height, spp=spp)


def twin_slots(case):
    """For the duplicated soup: (block of prim 2k, of 2k + 1, slot of 2k,
    of 2k + 1) per triangle k, from cluster_refs."""
    refs = case["tables"]["cluster_refs"]
    rows = case["tables"]["cluster_rows"]
    tc = rows.shape[1] // 3
    # A padding slot's rows are all zero (its ref reads 0).
    live = np.flatnonzero(rows.reshape(-1, 8, 3, tc)[:, :7].any(axis=(1, 2))
                          .reshape(-1))
    pos = np.full(refs.max() + 1, -1)
    pos[refs[live]] = live
    pos = pos.reshape(-1, 2)
    return pos[:, 0] // tc, pos[:, 1] // tc, pos[:, 0] % tc, pos[:, 1] % tc


# dense_edge_case's tie triangles: A at two indices in different 128-wide
# quarters of the first 512-triangle tile, B at two indices in different
# tiles, C alone at the last index of the last tile.
DENSE_TIES = {"A": (40, 300), "B": (600, 1100), "C": (1535,)}


def dense_edge_case(seed=5, n_rays=512):
    """The dense intersection's ties and edges: 1,536 triangles (three
    512-triangle tiles) of small far-off fillers (x >= 20, never reached),
    with three large triangles facing the rays at DENSE_TIES: A (z = 5) and
    B (z = 7) twice each, so every ray at them hits two copies at bitwise
    the same t, u and v and the lower index must win; C (z = 9) only in the
    last tile. Rays from z = 0 along about +z: an eighth at A, B and C each
    in turn, the rest at nothing. Ray block 0 (rays 0-255) holds hits only,
    but ray 17, which misses: the one unoccluded ray of an any-hit block.
    Rays 256 and up: about 10% inactive. Returns a dict of numpy arrays:
    geom [1536, 9], o, d, far, t_occ (beyond every hit), act, and aim (0 A,
    1 B, 2 C, -1 none)."""
    rng = np.random.RandomState(seed)
    n_tris = 1536
    geom = np.zeros((n_tris, 9), np.float32)
    geom[:, 0:3] = rng.uniform([20, -10, 0], [40, 10, 20], (n_tris, 3))
    geom[:, 3:6] = rng.uniform(-0.5, 0.5, (n_tris, 3))
    geom[:, 6:9] = rng.uniform(-0.5, 0.5, (n_tris, 3))
    big = {"A": [-3, -2, 5, 3, 0, 0, 0, 4, 0],
           "B": [0.5, -2, 7, 3, 0, 0, 0, 4, 0],
           "C": [-1, 2.5, 9, 2, 0, 0, 0, 2, 0]}
    for name, idx in DENSE_TIES.items():
        geom[list(idx)] = big[name]
    # Points well inside each triangle's projection on the xy plane.
    boxes = [((-2.8, -1.8), (-2.0, -0.5)), ((0.7, -1.8), (1.5, -0.5)),
             ((-0.8, 2.7), (-0.2, 3.2))]
    aim = np.where(np.arange(n_rays) % 8 < 3, np.arange(n_rays) % 8, -1)
    aim[:256] = np.arange(256) % 3
    aim[17] = -1
    xy = rng.uniform(0, 1, (n_rays, 2))
    o = np.zeros((n_rays, 3), np.float32)
    for k, (lo, hi) in enumerate(boxes):
        sel = aim == k
        o[sel, :2] = np.asarray(lo) + xy[sel] * (np.asarray(hi) -
                                                  np.asarray(lo))
    o[aim < 0, :2] = [10.0, 10.0]
    d = np.concatenate([rng.uniform(-0.01, 0.01, (n_rays, 2)),
                        np.ones((n_rays, 1))], axis=1)
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    act = np.ones(n_rays, bool)
    act[256:] = rng.rand(n_rays - 256) < 0.9
    return dict(geom=geom, o=o, d=d.astype(np.float32),
                far=np.full(n_rays, 1e20, np.float32),
                t_occ=np.full(n_rays, 12.0, np.float32), act=act, aim=aim)


def cluster_tie_blocks(tc, seed=0):
    """Two blocks [16, 3 * tc] for the cluster probe in which slot j and
    every slot j + 32k (k >= 1, below tc) lie in one plane, for each
    j < 32: their C thirds (rows 0:7) are equal, so a ray meets all of
    them at bitwise the same t and the lowest slot must win; their A and
    B thirds are slot j's times 2^-k, so u and v halve with k (a valid
    slot's copies are valid) and show which slot won. Slot j's C origin
    rows and constant are scaled by 1e-5 so that t is small and u * 1e-9,
    v * 1e-9 show in the probe's t_state. Random coefficients otherwise
    (float32 numpy)."""
    blk = np.random.RandomState(seed).uniform(-1, 1, (16, 3 * tc)).astype(
        np.float32)
    for b in (0, 8):
        a, bb, c = (blk[b:b + 7, k * tc:(k + 1) * tc] for k in range(3))
        c[3:7, :32] *= np.float32(1e-5)
        for k in range(1, tc // 32):
            s = slice(32 * k, 32 * k + 32)
            c[:, s] = c[:, :32]
            a[:, s] = a[:, :32] * np.float32(2.0 ** -k)
            bb[:, s] = bb[:, :32] * np.float32(2.0 ** -k)
    return blk


def leaf_probe_case(g, seed=0):
    """Rows [64, 128] and rays o, d, inv [3, G, 128] (float32 numpy) for the
    leaf probe, with its edge cases in every row: slot 0 all zero (det = 0,
    so u is NaN), slot 3 a copy of slot 2 (equal t: the first keeps it),
    slot 1 in a plane z = const that the rays of lanes 0, 4, 8, ... run
    parallel to (d_z = 0: det = +-0); lanes 1, 5, 9, ... point away from
    the centre of the rows' unit box, so that most triangles lie behind
    them (t < 0). Random triangles in [0, 1) and rays from [-0.5, 1.5)
    otherwise."""
    rng = np.random.RandomState(seed)
    rows = rng.uniform(0, 1, (64, 128)).astype(np.float32)
    rows[:, 0:12] = 0.0
    rows[:, 36:48] = rows[:, 24:36]
    rows[:, 12 + 5] = 0.0   # e1z
    rows[:, 12 + 8] = 0.0   # e2z
    o = rng.uniform(-0.5, 1.5, (3, g, 128)).astype(np.float32)
    d = rng.normal(size=(3, g, 128)).astype(np.float32)
    lane = np.arange(g * 128).reshape(g, 128)
    d[2][lane % 4 == 0] = 0.0
    away = lane % 4 == 1
    d[:, away] = o[:, away] - 0.5
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    with np.errstate(divide="ignore"):
        return rows, o, d, (1.0 / d).astype(np.float32)


# Children of node_probe_case's rows, each with one edge of the slab test.
NODE_FLAT, NODE_POINT, NODE_INVERTED, NODE_UNBOUNDED, NODE_AROUND = range(5)


def node_probe_case(g, seed=0):
    """Rows [64, 128] and rays o, d, inv [3, G, 128] (float32 numpy) for the
    node probe, with its edge cases in every row: child NODE_FLAT has
    lo = hi on z (tmin = tmax where a ray crosses it), NODE_POINT lo = hi
    on every axis, NODE_INVERTED lo > hi on every axis (the slab test takes
    the min and max of its two planes, so it reads as its mirror),
    NODE_UNBOUNDED the wide rows' empty bounds (+inf, -inf) on x alone,
    NODE_AROUND a box [-1, 2]^3 around every origin (the rays start inside:
    tmin < 0, so the sum has terms of either sign); children 5-7 random
    boxes in [0, 1). Lanes 0, 4, 8, ... run with d_x = +0 (inv = +inf) and
    lanes 2, 6, 10, ... with d_y = -0 (inv = -inf); in lanes 0, 8, 16, ...
    and 2, 10, 18, ... the origin is 0 on that axis too, so o * inv is NaN
    and every child's slab is. Origins from [-0.5, 1.5) otherwise."""
    rng = np.random.RandomState(seed)
    rows = rng.uniform(0, 1, (64, 128)).astype(np.float32)
    box = rows[:, :48].reshape(64, 8, 6)
    box[:, NODE_FLAT, 5] = box[:, NODE_FLAT, 2]
    box[:, NODE_POINT, 3:] = box[:, NODE_POINT, :3]
    lo, hi = box[:, NODE_INVERTED, :3], box[:, NODE_INVERTED, 3:]
    box[:, NODE_INVERTED] = np.concatenate([np.maximum(lo, hi),
                                            np.minimum(lo, hi)], axis=1)
    box[:, NODE_UNBOUNDED, 0], box[:, NODE_UNBOUNDED, 3] = np.inf, -np.inf
    box[:, NODE_AROUND] = [-1, -1, -1, 2, 2, 2]
    rows[:, :48] = box.reshape(64, 48)
    o = rng.uniform(-0.5, 1.5, (3, g, 128)).astype(np.float32)
    d = rng.normal(size=(3, g, 128)).astype(np.float32)
    lane = np.arange(g * 128).reshape(g, 128)
    d[0][lane % 4 == 0] = 0.0
    d[1][lane % 4 == 2] = -0.0
    o[0][lane % 8 == 0] = 0.0
    o[1][lane % 8 == 2] = 0.0
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    with np.errstate(divide="ignore"):
        return rows, o, d, (1.0 / d).astype(np.float32)


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
    # B1's block sizes; the interleave and multi-pop kernels have one.
    with pytest.raises(ValueError):
        kt.closest(rows, o, d, t, act, threads=96, **kw)
    with pytest.raises(ValueError):
        kt.anyhit(rows, o, d, t, act, threads=128, interleave=2, **kw)
    # The walks read rows as 16-byte loads: a table one float off raises.
    kt.check_aligned(rows)
    with pytest.raises(ValueError):
        kt.check_aligned(rows.reshape(-1)[1:])
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
@pytest.mark.parametrize("depth", ["scene", 192])
def test_megakernel_stack_depths_on_cuda(depth):
    """The MT megakernel at bathroom's own stack bound and at the largest,
    192: lanes and ray counts bitwise the plain version's, one sample and
    four with regeneration, 64 bounces."""
    _need_cuda()
    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.math.camera import generate_image_plane
    from gpupathtracer_tpu_torch.scene import load_scene
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    w, h = 96, 64
    cfg = RenderConfig(scene_path="proc:bathroom", width=w, height=h,
                       skybox="GENERATE COLOR BLACK", microfacet="beckmann")
    pos, yaw, pitch, fov, aperture, focus = default_camera("bathroom")
    cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                              fov=math.radians(fov), aspect=w / h,
                              aperture=aperture, focal_distance=focus)
    scene, meta = load_scene(cfg, "cuda")
    lane = torch.arange(w * h, device="cuda")
    stack_depth = meta.stack_depth if depth == "scene" else depth
    launches = mk.LAUNCHES["trace_mega"]
    for spp in (1, 4):
        args, kw = mk.prepare_mega(
            scene, mk.pack_mega_tables(scene),
            generate_image_plane(cfg.camera, "cuda"), (lane % w).float(),
            (lane // w).float(), random.PRNGKey(5, "cuda"), width=w,
            height=h, stack_depth=stack_depth, leaf_size=meta.leaf_size,
            max_bounces=64, model="beckmann", n_mats=meta.num_materials,
            n_lights=int(scene.light_rows.shape[0]), spp=spp,
            packet_size=1024)
        got, rays = mk.trace_mega(*args, **kw)
        want, rays_plain = mk.trace_mega_plain(*args, **kw)
        assert int(rays) == int(rays_plain)
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))
    assert mk.LAUNCHES["trace_mega"] == launches + 2


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
@pytest.mark.parametrize("tc,duplicate", [(128, True), (256, False)])
def test_cluster_kernel_ties_and_soup_on_cuda(tc, duplicate):
    """The warp's cluster leaf on the tie case (every triangle twice: equal
    t on two slots of one block, the lowest slot must win) and on the
    tc = 256 soup: closest and any-hit, with and without counters and
    pop_skip, every output bitwise the plain version's."""
    _need_cuda()
    case = cluster_soup_case(tc=tc, n_tris=600, n_rays=65536,
                             duplicate=duplicate)
    tabs = [torch.tensor(case["tables"][k], device="cuda")
            for k in ("node_rows", "cluster_rows", "cluster_refs")]
    kw = dict(stack_depth=case["depth"])
    rays = _port(case, case["far"], "cuda")
    bare = kc.closest_cluster(*tabs, *rays, **kw)
    _equal_bits(bare, kc.closest_cluster_plain(*tabs, *rays, **kw))
    assert int((bare[1] >= 0).sum()) > 1000
    for skip in (False, True):
        got = kc.closest_cluster(*tabs, *rays, with_stats=True,
                                 pop_skip=skip, **kw)
        _equal_bits(got, kc.closest_cluster_plain(
            *tabs, *rays, with_stats=True, pop_skip=skip, **kw))
        _equal_bits(got[:4], bare)
        _equal_bits(kc.closest_cluster(*tabs, *rays, pop_skip=skip, **kw),
                    bare)
    occ_rays = _port(case, case["t_occ"], "cuda")
    occ = kc.anyhit_cluster(*tabs[:2], *occ_rays, **kw)
    assert torch.equal(occ, kc.anyhit_cluster_plain(*tabs[:2], *occ_rays,
                                                    **kw))
    st = kc.anyhit_cluster(*tabs[:2], *occ_rays, with_stats=True, **kw)
    _equal_bits(st, kc.anyhit_cluster_plain(*tabs[:2], *occ_rays,
                                            with_stats=True, **kw))
    assert torch.equal(st[0], occ)


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


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [1, 48, 192])
def test_b1_twin_table_and_depths_on_cuda(depth):
    """B1 closest and any-hit with counters, bitwise the plain version's,
    on the twin table (sibling boxes tie in t_near: the lower slot pops
    first) at stack depth 1, 48 and 192 (pushes dropped at the top of the
    shared stack at depth 1), at every block size, with 4,097 rays (not a
    multiple of any block); the hits with counters are those without."""
    _need_cuda()
    case = twin_soup_case(n_tris=300, n_rays=4097)
    assert tied_siblings(case["wide"].node_rows) > 0
    rows = _rows(case, "cuda")
    kw = dict(stack_depth=depth, leaf_size=case["leaf"])
    for threads in kt.BLOCK_SIZES:
        for fn, plain, t_max in ((kt.closest, kt.closest_plain, case["far"]),
                                 (kt.anyhit, kt.anyhit_plain,
                                  case["t_occ"])):
            rays = _port(case, t_max, "cuda")
            got = fn(rows, *rays, with_stats=True, threads=threads, **kw)
            _equal_bits(got, plain(rows, *rays, with_stats=True, **kw))
            bare = fn(rows, *rays, threads=threads, **kw)
            _equal_bits(got[:-1], bare if isinstance(bare, tuple)
                        else (bare,))


@pytest.mark.cuda
def test_b1_all_rays_inactive_on_cuda():
    """With every ray inactive B1 returns t_max, no hit and no pops."""
    _need_cuda()
    case = _soup_case(7, n_rays=1000)
    case["act"] = np.zeros_like(case["act"])
    rows = _rows(case, "cuda")
    kw = dict(stack_depth=case["depth"], leaf_size=case["leaf"])
    t, prim, u, v, st = kt.closest(rows, *_port(case, case["far"], "cuda"),
                                   with_stats=True, **kw)
    assert torch.equal(t.cpu(), torch.tensor(case["far"]))
    assert (prim == -1).all() and (st == 0).all()
    occ, st = kt.anyhit(rows, *_port(case, case["t_occ"], "cuda"),
                        with_stats=True, **kw)
    assert not occ.any() and (st == 0).all()


@pytest.mark.cuda
@pytest.mark.parametrize("tc,duplicate", [(128, True), (256, False)])
def test_cluster_megakernel_soups_on_cuda(tc, duplicate):
    """The cluster megakernel, whose walks run each cluster by the whole
    warp, on the twin-triangle tie case (tc 128) and a tc 256 soup: 165
    lanes (not a multiple of 32), one sample and four with regeneration
    (lanes end their samples at different bounces). Contributions, ray
    counts and the [P, 9] counters bitwise the plain version's."""
    _need_cuda()
    launches = mk.LAUNCHES["trace_mega_cluster"]
    for spp in (1, 4):
        args, kw = soup_mega_case(tc, duplicate, 15, 11, spp, 8, "cuda")
        got = mk.trace_mega(*args, with_stats=True, **kw)
        want = mk.trace_mega_plain(*args, with_stats=True, **kw)
        assert int(got[1]) == int(want[1])
        _equal_bits((got[0], got[2]), (want[0], want[2]))
        bare, rays = mk.trace_mega(*args, **kw)
        _equal_bits((bare,), (got[0],))
        assert int(rays) == int(want[1])
    assert mk.LAUNCHES["trace_mega_cluster"] == launches + 2


def _equal_bits(got, want):
    for g, w in zip(got, want):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)


@pytest.mark.cuda
def test_schedule_kernels_match_plain_on_cuda():
    """The interleave and multi-pop entry points of csrc/traverse.cu against
    their plain versions and against the plain schedule's kernel (t and
    occluded bitwise; another triangle may win an exact tie under
    multi-pop's visit order), with an odd ray count."""
    _need_cuda()
    launches = dict(kt.LAUNCHES)
    case = _soup_case(7, leaf=10, n_tris=4000, n_rays=65535)
    kw = dict(stack_depth=case["depth"], leaf_size=10)
    rows = _rows(case, "cuda")
    rays = _port(case, case["far"], "cuda")
    occ_rays = _port(case, case["t_occ"], "cuda")
    base = kt.closest(rows, *rays, **kw)
    occ_base = kt.anyhit(rows, *occ_rays, **kw)
    scheds = [dict(interleave=2), dict(interleave=4), dict(multi_pop=2)]
    if case["depth"] * 4 <= kt.MAX_STACK:
        scheds.append(dict(multi_pop=4))
    for sched in scheds:
        stats = "multi_pop" in sched
        got = kt.closest(rows, *rays, with_stats=stats, **sched, **kw)
        want = kt.closest_plain(rows, *rays, with_stats=stats, **sched, **kw)
        _equal_bits(got, want)
        assert torch.equal(got[0].view(torch.int32),
                           base[0].view(torch.int32))
        assert int((got[1] != base[1]).sum()) <= 4
        occ = kt.anyhit(rows, *occ_rays, with_stats=stats, **sched, **kw)
        if stats:
            assert int(got[4][:, 2].sum()) == 0 and int(occ[1][:, 2].sum()) == 0
            occ = occ[0]
            # The schedule's own kernel, without counters: the same hits.
            _equal_bits(kt.closest(rows, *rays, **sched, **kw), got[:4])
            assert torch.equal(kt.anyhit(rows, *occ_rays, **sched, **kw), occ)
        assert torch.equal(occ, occ_base)
    small = kt.closest(rows, *rays, stack_depth=2, leaf_size=10, multi_pop=2,
                       with_stats=True)
    small_plain = kt.closest_plain(rows, *rays, stack_depth=2, leaf_size=10,
                                   multi_pop=2, with_stats=True)
    assert torch.equal(small[4], small_plain[4])
    assert int(small[4][:, 2].sum()) > 0
    for k in ("trace_closest_ilv", "trace_anyhit_ilv"):
        assert kt.LAUNCHES[k] == launches[k] + 2
    multi = len(scheds) - 2
    assert kt.LAUNCHES["trace_closest_multi"] == \
        launches["trace_closest_multi"] + multi
    assert kt.LAUNCHES["trace_anyhit_multi"] == \
        launches["trace_anyhit_multi"] + multi
    assert kt.LAUNCHES["trace_closest_stats"] == \
        launches["trace_closest_stats"] + multi + 1
    assert kt.LAUNCHES["trace_anyhit_stats"] == \
        launches["trace_anyhit_stats"] + multi


@pytest.mark.cuda
@pytest.mark.parametrize("part", ["depths", "masks", "repeat"])
def test_multi_kernels_on_cuda(part):
    """B8 (Q = 2 and 4) with counters against its plain version, every
    field and the [N, 3] counts bitwise, on 65,535 rays: "depths" at stack
    bounds 2 (stacks of 2Q: pushes are dropped) and 4 and at
    the largest (stack_depth * Q = 192); "masks" with 2% of the rays active
    and with none (no pops, t_max, no hit); "repeat" two launches in a row
    on one stream, equal, each counted in LAUNCHES."""
    _need_cuda()
    case = _soup_case(7, leaf=10, n_tris=4000, n_rays=65535)
    rows = _rows(case, "cuda")
    act = case["act"]
    if part == "masks":
        masks = (act & (np.random.RandomState(2).rand(act.size) < 0.02),
                 np.zeros_like(act))
    else:
        masks = (act,)
    launches = dict(kt.LAUNCHES)
    calls = 0
    for q in kt.VARIANTS:
        depths = ((2, 4, kt.MAX_STACK // q) if part == "depths"
                  else (case["depth"],))
        for depth, mask in ((x, m) for x in depths for m in masks):
            case["act"] = mask
            kw = dict(stack_depth=depth, leaf_size=10, multi_pop=q,
                      with_stats=True)
            for fn, plain, t_max in ((kt.closest, kt.closest_plain,
                                      case["far"]),
                                     (kt.anyhit, kt.anyhit_plain,
                                      case["t_occ"])):
                rays = _port(case, t_max, "cuda")
                got = fn(rows, *rays, **kw)
                calls += 1
                _equal_bits(got, plain(rows, *rays, **kw))
                if depth == 2:
                    assert int(got[-1][:, 2].sum()) > 0
                if not mask.any():
                    assert int(got[-1].abs().sum()) == 0
                    assert not (got[0] if fn is kt.anyhit
                                else got[1] >= 0).any()
                if part == "repeat":
                    _equal_bits(fn(rows, *rays, **kw), got)
                    calls += 1
    case["act"] = act
    assert kt.LAUNCHES["trace_closest_stats"] + \
        kt.LAUNCHES["trace_anyhit_stats"] == \
        launches["trace_closest_stats"] + launches["trace_anyhit_stats"] + calls


@pytest.mark.cuda
@pytest.mark.parametrize("depth", [8, 58, 192])
def test_interleave_kernels_on_cuda(depth):
    """B7 (W = 2 and 4) with counters against its plain version and against
    B1's kernel, every field and the pop counts bitwise, at stack depths 8
    (pushes dropped at the top of each shared stack), 58 and 192 (the
    largest stacks: 64 threads a block at W = 4), on 65,535 rays; then on
    a set where 2% of the rays are active and one where none is (slots
    retire at once and take the next rays); two launches in a row on one
    stream give the same results (the ray counter is zeroed each time)."""
    _need_cuda()
    case = _soup_case(7, leaf=10, n_tris=4000, n_rays=65535)
    rows = _rows(case, "cuda")
    kw = dict(stack_depth=depth, leaf_size=10)
    act = case["act"]
    sparse = act & (np.random.RandomState(2).rand(act.size) < 0.02)
    for mask in (act, sparse, np.zeros_like(act)):
        case["act"] = mask
        for fn, plain, t_max in ((kt.closest, kt.closest_plain, case["far"]),
                                 (kt.anyhit, kt.anyhit_plain,
                                  case["t_occ"])):
            rays = _port(case, t_max, "cuda")
            b1 = fn(rows, *rays, with_stats=True, **kw)
            for w in kt.VARIANTS:
                got = fn(rows, *rays, with_stats=True, interleave=w, **kw)
                again = fn(rows, *rays, with_stats=True, interleave=w, **kw)
                _equal_bits(got, b1)
                _equal_bits(again, got)
                if mask is act:
                    _equal_bits(got, plain(rows, *rays, with_stats=True,
                                           interleave=w, **kw))
            if not mask.any():
                assert int(b1[-1].abs().sum()) == 0
    case["act"] = act


@pytest.mark.cuda
def test_subpacket_kernel_matches_plain_on_cuda():
    """csrc/subpacket_traverse.cu against its plain version (hits and pop
    counts bitwise) and against the per-ray kernel (t, occluded), at
    K = 128, 256, 2048 and 8192 (G = 64: each warp runs four sub-packets in
    turn)."""
    _need_cuda()
    from gpupathtracer_tpu_torch.ops import subpacket_traverse as sp

    launches = dict(sp.LAUNCHES)
    case = _soup_case(7, leaf=10, n_tris=4000, n_rays=16384)
    kw = dict(stack_depth=case["depth"], leaf_size=10)
    rows = _rows(case, "cuda")
    sizes = (128, 256, 2048, 8192)
    for K in sizes:
        P = 16384 // K
        for any_hit, t_max in ((False, case["far"]), (True, case["t_occ"])):
            o, d, tm, act = _port(case, t_max, "cuda")
            args = (rows, o.reshape(P, K, 3), d.reshape(P, K, 3),
                    tm.reshape(P, K), act.reshape(P, K))
            for ordered in (True, False):
                flags = dict(any_hit=any_hit, ordered=ordered,
                             with_stats=True, **kw)
                got = sp.traverse_subpacket(*args, **flags)
                _equal_bits(got, sp.traverse_subpacket_plain(*args, **flags))
            if any_hit:
                assert torch.equal(got[1].reshape(-1) >= 0,
                                   kt.anyhit(rows, o, d, tm, act, **kw))
            else:
                base = kt.closest(rows, o, d, tm, act, **kw)
                assert torch.equal(got[0].reshape(-1).view(torch.int32),
                                   base[0].view(torch.int32))
    # An odd stack bound (the shared memory's layout), K = 128 and 8192.
    for K in (128, 8192):
        P = 16384 // K
        o, d, tm, act = _port(case, case["far"], "cuda")
        args = (rows, o.reshape(P, K, 3), d.reshape(P, K, 3),
                tm.reshape(P, K), act.reshape(P, K))
        flags = dict(stack_depth=37, leaf_size=10, with_stats=True)
        _equal_bits(sp.traverse_subpacket(*args, **flags),
                    sp.traverse_subpacket_plain(*args, **flags))
    runs = 2 * len(sizes)
    assert sp.LAUNCHES["subpacket_closest"] == \
        launches["subpacket_closest"] + runs + 2
    assert sp.LAUNCHES["subpacket_anyhit"] == \
        launches["subpacket_anyhit"] + runs


@pytest.mark.cuda
def test_subpacket_leaf_trig_on_cuda():
    """_leaf_trig_case on the card: one packet of K = 4096 (G = 32, so each
    of the block's 16 warps runs two sub-packets in turn). The plain
    version counts the leaf phases that LEAF_TRIG alone chose (more than
    none), and the kernel is held to it bitwise, hits and pop counts,
    closest and any-hit, ordered and unordered."""
    _need_cuda()
    from gpupathtracer_tpu_torch.ops import subpacket_traverse as sp

    K = 4096
    case = _leaf_trig_case(K)
    rows = _rows(case, "cuda")
    for any_hit, t_max in ((False, case["far"]), (True, case["t_occ"])):
        o, d, tm, act = _port(case, t_max, "cuda")
        args = (rows, o.reshape(1, K, 3), d.reshape(1, K, 3),
                tm.reshape(1, K), act.reshape(1, K))
        for ordered in (True, False):
            flags = dict(any_hit=any_hit, ordered=ordered, with_stats=True,
                         stack_depth=case["depth"], leaf_size=1)
            pops = {}
            want = sp.traverse_subpacket_plain(*args, pops=pops, **flags)
            assert pops["trig"] > 0
            _equal_bits(sp.traverse_subpacket(*args, **flags), want)


@pytest.mark.cuda
def test_dense_kernel_matches_plain_on_cuda():
    """csrc/dense_intersect.cu against its plain version, closest and
    any-hit, both roundings, with a degenerate triangle in the table: on
    8,192 rays (too few ray blocks for the card, so the triangle range is
    split across blocks too) at two block and tile shapes and without
    early exit; on 2^19 rays against 40 triangles (enough ray blocks for
    two waves: one triangle range a block); on dense_edge_case's ties and
    edges (a split range); and at one tile of all 4,096 triangles. A
    table whose padded count is not a multiple of the kernel's
    128-triangle stage raises."""
    _need_cuda()
    from gpupathtracer_tpu_torch.ops import dense_intersect as pd

    launches = dict(pd.LAUNCHES)
    case = _soup_case(7, leaf=10, n_tris=4000, n_rays=8192)
    geom = case["geom"].copy()
    geom[5, 6:9] = geom[5, 3:6]
    wd, wo = (torch.tensor(x, device="cuda")
              for x in pd.pack_dense_tris(geom))
    big = _soup_case(7, leaf=10, n_tris=40, n_rays=1 << 19)
    edges = dense_edge_case()
    ewd, ewo = (torch.tensor(x, device="cuda")
                for x in pd.pack_dense_tris(edges["geom"]))
    runs = 0
    for any_hit in (False, True):
        t_key = "t_occ" if any_hit else "far"
        rays = _port(case, case[t_key], "cuda")
        for use_mxu in (True, False):
            kw = dict(any_hit=any_hit, use_mxu=use_mxu)
            for table, r, shape in (
                    ((wd, wo), rays, dict()),
                    ((wd, wo), rays, dict(block=256, tile=1024)),
                    ((wd, wo), rays, dict(early_exit=False)),
                    ((wd, wo), rays, dict(tile=4096)),
                    ((wd, wo), _port(big, big[t_key], "cuda"), dict()),
                    ((ewd, ewo), _port(edges, edges[t_key], "cuda"),
                     dict(block=256))):
                _equal_bits(pd.dense_intersect(*table, *r, **kw, **shape),
                            pd.dense_intersect_plain(*table, *r, **kw,
                                                     **shape))
                runs += 1
    assert pd.LAUNCHES["dense_closest"] == launches["dense_closest"] + runs // 2
    assert pd.LAUNCHES["dense_anyhit"] == launches["dense_anyhit"] + runs // 2
    odd = torch.zeros((3, 3 * 192), device="cuda")
    with pytest.raises(ValueError):
        pd.dense_intersect(odd, torch.zeros((4, 3 * 192), device="cuda"),
                           *rays, tile=64)


@pytest.mark.cuda
def test_roofline_probes_match_plain_on_cuda():
    """Every probe's kernel against its plain version on the card, every
    copy bitwise (bf16: within the bound above), and a launch counted for
    each."""
    _need_cuda()
    from gpupathtracer_tpu_torch.ops import roofline as rl

    dev = torch.device("cuda")
    rng = np.random.RandomState(1)
    launches = dict(rl.LAUNCHES)

    def t(x):
        return torch.as_tensor(x, device=dev)

    x = t(rng.uniform(0.1, 1, (64, 128)).astype(np.float32))
    for ilp in (1, 8):
        got = rl.vpu(x, iters=5, ilp=ilp, copies=3)
        want = rl.vpu_plain(x, iters=5, ilp=ilp)
        assert all(torch.equal(g.view(torch.int32), want.view(torch.int32))
                   for g in got)
    rows = t(rng.uniform(0, 1, (64, 128)).astype(np.float32))
    o = t(rng.uniform(-0.5, 1.5, (3, 16, 128)).astype(np.float32))
    d = torch.nn.functional.normalize(t(rng.normal(size=(3, 16, 128))
                                        .astype(np.float32)), dim=0)
    inv = 1.0 / d
    for probe, plain in ((rl.node_slab, rl.node_slab_plain),
                         (rl.leaf_mt, rl.leaf_mt_plain)):
        got = probe(rows, o, d, inv, iters=7, copies=3)
        want = plain(rows, o, d, inv, iters=7)
        assert all(torch.equal(g.view(torch.int32), want.view(torch.int32))
                   for g in got)
    # The leaf body on leaf_probe_case's edge rows (det = 0, equal t,
    # parallel rays, rays pointing away) and the node body on
    # node_probe_case's (flat, point, inverted and half-unbounded boxes, a
    # box around every origin; zero direction components, o * inv NaN),
    # each also on random rows, at G = 1 and 16, one copy and 33, at 70
    # pops (the rows wrap at 64).
    for probe, plain, case_of, hit in (
            (rl.leaf_mt, rl.leaf_mt_plain, leaf_probe_case,
             lambda x: x < 1e19),
            (rl.node_slab, rl.node_slab_plain, node_probe_case,
             lambda x: x != 0)):
        for g in (1, 16):
            edge = [t(x) for x in case_of(g, seed=g)]
            rand = [rows] + [x[:, :g].contiguous() for x in (o, d, inv)]
            for args in (edge, rand):
                want = plain(*args, iters=70).view(torch.int32)
                assert hit(want.view(torch.float32)).any()
                for copies in (1, 33):
                    got = probe(*args, iters=70, copies=copies)
                    assert got.shape == (copies, g, 128)
                    assert all(torch.equal(c.view(torch.int32), want)
                               for c in got)
    # The cluster body on random blocks, then on cluster_tie_blocks (equal
    # t at slots j, j + 32, ...: the lowest slot wins) at G = 16 and the
    # copies of tools/torch_roofline.py (four 128-lane blocks a SM).
    copies = -(-4 * torch.cuda.get_device_properties(dev)
               .multi_processor_count // 16)
    for tc, any_hit, tie in ((128, False, False), (128, True, False),
                             (256, False, False), (128, False, True),
                             (256, False, True), (128, True, True)):
        blk = t(cluster_tie_blocks(tc) if tie else
                rng.uniform(-1, 1, (16, 3 * tc)).astype(np.float32))
        got = rl.cluster_dense(blk, o, d, inv, iters=5, any_hit=any_hit,
                               copies=copies if tie else 3)
        want = rl.cluster_dense_plain(blk, o, d, inv, iters=5,
                                      any_hit=any_hit)
        assert all(torch.equal(g.view(torch.int32), want.view(torch.int32))
                   for g in got)
    # The f32 product at every shape tools/torch_roofline.py launches,
    # with the copies it launches (four 64 x 64 output tiles a SM): K = 3
    # and 7, N = 32 (four column threads) up to 2048 (the widest column
    # slab a block owns), several row bands a copy.
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    for m, kk, n in ((128, 128, 128), (384, 3, 128), (384, 3, 2048),
                     (2048, 128, 32), (2048, 3, 384), (768, 7, 1024)):
        a = t(rng.uniform(-1, 1, (m, kk)).astype(np.float32))
        b = t(rng.uniform(-1, 1, (kk, n)).astype(np.float32))
        copies = -(-4 * sms // (-(-m // 64) * -(-n // 64)))
        got = rl.mxu(a, b, iters=5, copies=copies)
        want = rl.mxu_plain(a, b, iters=5).view(torch.int32)
        assert all(torch.equal(g.view(torch.int32), want) for g in got)
    # The bf16 product (wgmma) at the edges of its tiling: M = 64 with a
    # slab of N = 8, a 64-column slab, N = 264 and 512 (several 128-column
    # slabs, each computing column 0 too; a last slab of 8), K = 16 (one k
    # step), then the timed shapes 128^3 and 512^3 (every slab a block).
    for m, kk, n in ((64, 16, 8), (128, 32, 64), (64, 16, 264),
                     (128, 64, 512), (128, 128, 128), (512, 512, 512)):
        ab = t(rng.uniform(-1, 1, (m, kk)).astype(np.float32)).bfloat16()
        bb = t(rng.uniform(-1, 1, (kk, n)).astype(np.float32)).bfloat16()
        got = rl.mxu(ab, bb, iters=3, copies=2)
        scale = float(ab.float().abs().sum(1).max() * bb.float().abs().max()
                      * 3)
        assert float((got[1] - rl.mxu_plain(ab, bb, iters=3)).abs().max()) \
            <= 1e-6 * scale
        assert torch.equal(got[0], got[1])
    for k in rl.LAUNCHES:
        assert rl.LAUNCHES[k] > launches[k]


@pytest.mark.cuda
def test_stats_kernels_match_plain_on_cuda():
    """The counting variants (every schedule, closest and any-hit; the
    cluster walk with and without pop_skip; the megakernel) against their
    plain versions on the card: counts and hits bitwise; hits those of the
    kernels without counters."""
    _need_cuda()
    case = _soup_case(7, leaf=10, n_tris=4000, n_rays=16384)
    kw = dict(stack_depth=case["depth"], leaf_size=10)
    rows = _rows(case, "cuda")
    for t_max, fn, plain in ((case["far"], kt.closest, kt.closest_plain),
                             (case["t_occ"], kt.anyhit, kt.anyhit_plain)):
        rays = _port(case, t_max, "cuda")
        b1 = None
        for sched in ({}, dict(interleave=2), dict(interleave=4),
                      dict(multi_pop=2)):
            got = fn(rows, *rays, with_stats=True, **sched, **kw)
            _equal_bits(got, plain(rows, *rays, with_stats=True, **sched,
                                   **kw))
            bare = fn(rows, *rays, **sched, **kw)
            _equal_bits(got[:-1], bare if isinstance(bare, tuple)
                        else (bare,))
            if b1 is None:
                b1 = got[-1]
            elif "interleave" in sched:
                assert torch.equal(got[-1], b1)
    cfg = RenderConfig(scene_path="proc:table", width=16, height=16,
                       cluster_tris=128)
    from gpupathtracer_tpu_torch.scene import load_scene

    scene, meta = load_scene(cfg, "cuda")
    rays = _port(case, case["far"], "cuda")
    tabs = (scene.node_rows, scene.cluster_rows, scene.cluster_refs)
    bare = kc.closest_cluster(*tabs, *rays, stack_depth=meta.stack_depth)
    for skip in (False, True):
        got = kc.closest_cluster(*tabs, *rays, stack_depth=meta.stack_depth,
                                 with_stats=True, pop_skip=skip)
        _equal_bits(got, kc.closest_cluster_plain(
            *tabs, *rays, stack_depth=meta.stack_depth, with_stats=True,
            pop_skip=skip))
        _equal_bits(got[:4], bare)
    occ = kc.anyhit_cluster(*tabs[:2], *_port(case, case["t_occ"], "cuda"),
                            stack_depth=meta.stack_depth, with_stats=True)
    _equal_bits(occ, kc.anyhit_cluster_plain(
        *tabs[:2], *_port(case, case["t_occ"], "cuda"),
        stack_depth=meta.stack_depth, with_stats=True))
    # pop_skip far from the world origin, at two clusters' common hits.
    tabs, o, d, act, depth = far_cluster_case()
    tabs, o, d, act = ([x.cuda() for x in tabs], o.cuda(), d.cuda(),
                       act.cuda())
    far = torch.full((o.shape[0],), 1e20, device="cuda")
    got = kc.closest_cluster(*tabs, o, d, far, act, stack_depth=depth,
                             with_stats=True, pop_skip=True)
    _equal_bits(got, kc.closest_cluster_plain(
        *tabs, o, d, far, act, stack_depth=depth, with_stats=True,
        pop_skip=True))
    _equal_bits(got[:4], kc.closest_cluster(*tabs, o, d, far, act,
                                            stack_depth=depth))
    assert int(got[4][:, 2].sum()) > 0


def arity_soup_case(arity, n_tris=4000, n_rays=65535, seed=7, tc=0,
                    packet=2048):
    """_soup_case's soup at ``arity`` children a node (MT leaves of 4, or
    with ``tc`` cluster leaves), its rays, and start entries for packets of
    ``packet`` rays: row 0, the cut's roots in turn, a leaf entry of the
    cut in packet 1 and INVALID in packet 2. Tensors on the card."""
    rng = np.random.RandomState(seed)
    base = rng.uniform(-5, 5, (n_tris, 1, 3))
    tri = (base + rng.uniform(-0.6, 0.6, (n_tris, 3, 3))).astype(np.float32)
    p0, p1, p2 = tri[:, 0], tri[:, 1], tri[:, 2]
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=4, builder="numpy",
                                 arity=arity)
    if tc:
        wide = pack_clusters(wide, p0, p1 - p0, p2 - p0, tc=tc, arity=arity)
    else:
        wide = pack_for_packets(wide, p0, p1 - p0, p2 - p0, 4)
    o = rng.uniform(-8, 8, (n_rays, 3)).astype(np.float32)
    d = rng.uniform(-4, 4, (n_rays, 3)).astype(np.float32) - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    cut = wide.cut_entry
    roots = cut[np.arange(-(-n_rays // packet)) % len(cut)].copy()
    roots[0] = 0
    if (cut < 0).any():
        roots[1] = cut[cut < 0][0]
    roots[2] = kt.INVALID_ENTRY

    def dev(x):
        return torch.tensor(x, device="cuda")
    tabs = {f: dev(np.asarray(getattr(wide, f))) for f in (
        "node_rows", "cluster_rows", "cluster_refs") if getattr(wide, f)
        is not None}
    return dict(tabs=tabs, o=dev(o), d=dev(d), cut_entry=dev(cut),
                cut_bounds=dev(wide.cut_bounds),
                depth=min(stats.max_depth * (arity - 1) + 2, kt.MAX_STACK),
                far=dev(np.full(n_rays, 1e20, np.float32)),
                t_occ=dev(rng.uniform(0.5, 8.0, n_rays).astype(np.float32)),
                act=dev(rng.rand(n_rays) < 0.9), roots=dev(roots),
                packet=packet)


@pytest.mark.cuda
@pytest.mark.parametrize("arity", [16, 4, 8, 3])
def test_arity_and_roots_match_plain_on_cuda(arity):
    """B1 closest and any-hit, B7 (W = 2) and B8 (Q = 2) on a table of
    ``arity`` children, from row 0 and from per-packet start entries (cut
    roots, a leaf, INVALID), each bitwise its plain version; launches
    counted under the arity's and the roots' keys. At 3, 7A is no multiple
    of 4: the row's last 16-byte word is partly read."""
    _need_cuda()
    case = arity_soup_case(arity)
    rows = case["tabs"]["node_rows"]
    rays = [case[k] for k in ("o", "d", "far", "act")]
    occ_rays = [case[k] for k in ("o", "d", "t_occ", "act")]
    launches = dict(kt.LAUNCHES)
    for roots in (None, case["roots"]):
        kw = dict(stack_depth=case["depth"], leaf_size=4, arity=arity,
                  roots=roots, packet=None if roots is None else
                  case["packet"])
        for sched in (dict(), dict(interleave=2), dict(multi_pop=2)):
            _equal_bits(kt.closest(rows, *rays, **sched, **kw),
                        kt.closest_plain(rows, *rays, **sched, **kw))
            assert torch.equal(kt.anyhit(rows, *occ_rays, **sched, **kw),
                               kt.anyhit_plain(rows, *occ_rays, **sched,
                                               **kw))
        if roots is not None:
            got = kt.closest(rows, *rays, **kw)
            dead = slice(2 * case["packet"], 3 * case["packet"])
            assert torch.equal(got[0][dead], case["far"][dead])
            assert bool((got[1][dead] == -1).all())
    # One launch a query and start, the closest one with roots twice.
    for name, with_roots in (("trace_closest", 2), ("trace_anyhit", 1)):
        for key, n in ((kt.launch_key(name, arity, None), 1),
                       (kt.launch_key(name, arity, case["roots"]),
                        with_roots)):
            assert kt.LAUNCHES[key] == launches.get(key, 0) + n


@pytest.mark.cuda
@pytest.mark.parametrize("arity", [16, 4, 3])
def test_cluster_arity_and_roots_match_plain_on_cuda(arity):
    """B4 closest and any-hit on a cluster table of ``arity`` children (tc
    128), from row 0 and from start entries (cluster leaf entries among
    them), bitwise its plain version."""
    _need_cuda()
    case = arity_soup_case(arity, n_rays=16384, tc=128)
    t = case["tabs"]
    rays = [case[k] for k in ("o", "d", "far", "act")]
    occ_rays = [case[k] for k in ("o", "d", "t_occ", "act")]
    for roots in (None, case["roots"]):
        kw = dict(stack_depth=case["depth"], arity=arity, roots=roots,
                  packet=None if roots is None else case["packet"])
        _equal_bits(kc.closest_cluster(t["node_rows"], t["cluster_rows"],
                                       t["cluster_refs"], *rays, **kw),
                    kc.closest_cluster_plain(t["node_rows"], t["cluster_rows"],
                                             t["cluster_refs"], *rays, **kw))
        assert torch.equal(
            kc.anyhit_cluster(t["node_rows"], t["cluster_rows"], *occ_rays,
                              **kw),
            kc.anyhit_cluster_plain(t["node_rows"], t["cluster_rows"],
                                    *occ_rays, **kw))


@pytest.mark.cuda
def test_treelet_on_cuda_matches_cpu():
    """The treelet traversal (ops/treelet.py) at arity 16 through the
    kernels on the card against the same loop through their plain versions
    on the CPU: every field bitwise (the loop's integer logic is the same
    on both devices, each launch bitwise its plain version)."""
    from types import SimpleNamespace

    from gpupathtracer_tpu_torch.ops import treelet
    _need_cuda()
    case = arity_soup_case(16, n_rays=8192)
    kw = dict(stack_depth=case["depth"], leaf_size=4, packet_size=128)
    out = []
    for dev in ("cuda", "cpu"):
        scene = SimpleNamespace(
            node_rows=case["tabs"]["node_rows"].to(dev),
            cut_entry=case["cut_entry"].to(dev),
            cut_bounds=case["cut_bounds"].to(dev), cluster_rows=None,
            arity=16)
        rays = [case[k].to(dev) for k in ("o", "d", "far", "act")]
        occ_rays = [case[k].to(dev) for k in ("o", "d", "t_occ", "act")]
        hit = treelet.trace_closest_treelet(scene, *rays, **kw)
        occ = treelet.trace_occluded_treelet(scene, *occ_rays, **kw)
        out.append([x.cpu() for x in (*hit, occ)])
    _equal_bits(out[0], out[1])
    assert float((out[0][1] >= 0).float().mean()) > 0.1


@pytest.mark.cuda
def test_packet_walk_on_cuda_matches_cpu():
    """ops/packet_traverse.py on CUDA tensors (its steps replayed as CUDA
    graphs, both packet counts of the compaction: 160 packets of 128 rays,
    a first pass over all, rounds of 5) against the same walk on the CPU,
    and the per-ray walk, every field bitwise."""
    _need_cuda()
    import types

    from gpupathtracer_tpu_torch.ops import packet_traverse, traverse

    case = _soup_case(7, leaf=10, n_tris=2000, n_rays=160 * 128)
    kw = dict(stack_depth=case["depth"], leaf_size=10)
    layout = dict(child_bounds=case["wide"].child_bounds,
                  child_entry=case["wide"].child_entry,
                  refs=case["wide"].refs, tri_geom=case["geom"])
    for dev in ("cuda", "cpu"):
        scene = types.SimpleNamespace(**{
            k: torch.tensor(v, device=dev) for k, v in layout.items()})
        rows = _rows(case, dev)
        rays = _port(case, case["far"], dev)
        occ_rays = _port(case, case["t_occ"], dev)
        got = (*packet_traverse.closest_hit_packets(rows, *rays, **kw),
               packet_traverse.any_hit_packets(rows, *occ_rays, **kw),
               *traverse.closest_hit(scene, *rays, **kw),
               traverse.any_hit(scene, *occ_rays, **kw))
        if dev == "cuda":
            on_card = [g.cpu() for g in got]
    for g, w in zip(on_card, got):
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        assert torch.equal(g, w)
