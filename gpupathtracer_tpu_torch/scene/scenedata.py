"""Scene ingest: loaders, the SBVH, the merged row table, the emitter CDF
and the packed shading tables, as torch tensors on an explicit device
(counterpart of the JAX package's scene/scenedata.py).

The BVH comes from the port's copy of the JAX package's builders
(``gpupathtracer_tpu_torch.bvh``: C++ SBVH through ctypes, the 8-wide
collapse, ``pack_for_packets`` and, with ``cfg.cluster_tris``, the dense
cluster leaves of ``pack_clusters``), so both packages trace identical
tables. The disk cache is not ported (ROADMAP.md, queue A); it changes no
output.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gpupathtracer_tpu_torch.bvh import BuildStats, build_wide_bvh
from gpupathtracer_tpu_torch.bvh.cluster import pack_clusters
from gpupathtracer_tpu_torch.bvh.wide import pack_for_packets
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.ops.intersect import pack_tri_geom
from gpupathtracer_tpu_torch.scene.envmap import EnvMap, environment_image
from gpupathtracer_tpu_torch.scene.materials import (MaterialDesc,
                                                     pack_materials)
from gpupathtracer_tpu_torch.scene.mesh import (TriangleSoup,
                                                build_triangle_soup)


class SceneData(NamedTuple):
    """The tables the wavefront integrator reads, as tensors on one device.
    Field names and layouts are those of the JAX package's SceneData."""

    # Per-triangle shading row: 0:3 normal, 3:9 uv (3 x 2), 9 mat-id bits,
    # 10 texel density, 16:32 the triangle's material row (pre-joined).
    tri_shade: torch.Tensor    # [T, 32] f32
    # Per-emitter row: 0:9 (p0, e1, e2), 9:12 normal, 12:15 emission.
    light_rows: torch.Tensor   # [L, 16] f32
    light_cdf: torch.Tensor    # [L] cumulative areas (ascending)
    total_light_area: torch.Tensor  # scalar f32 (0 => env-only lighting)
    # Per-material row: 0:3 albedo, 3 roughness, 4 metallic, 5:8 emission,
    # 8:11 texture ids and type bits, 11 ior (the megakernel's table).
    mat_rows: torch.Tensor     # [M, 16] f32
    env: EnvMap
    # Merged BVH table (bvh/wide.py pack_for_packets): node rows, then
    # leaf rows of 10 MT-ready triangle slots. On a cluster scene
    # (cfg.cluster_tris > 0), the cluster top tree's node rows alone.
    node_rows: torch.Tensor    # [W + L, 128] f32
    # Dense cluster leaves (bvh/cluster.py pack_clusters), None on MT-leaf
    # scenes: per cluster an [8, 3*tc] block of inverse-matrix rows, and
    # the global triangle id of each of its tc slots.
    cluster_rows: Optional[torch.Tensor] = None  # [Ncl*8, 3*tc] f32
    cluster_refs: Optional[torch.Tensor] = None  # [Ncl*tc] i32


@dataclass
class SceneMeta:
    """Static facts about a loaded scene."""

    num_triangles: int
    num_materials: int
    num_lights: int
    stack_depth: int           # traversal stack bound from the wide depth
    leaf_size: int
    has_delta: bool = False    # any mirror/refractive materials
    bvh_stats: Optional[BuildStats] = None


def scene_from_numpy(fields: dict, device) -> SceneData:
    """SceneData from arrays keyed by field name (``env`` is the lat-long
    image), e.g. the JAX package's SceneData converted with np.asarray."""
    def t(x):
        return None if x is None else torch.tensor(np.asarray(x),
                                                   device=device)
    return SceneData(
        tri_shade=t(fields["tri_shade"]),
        light_rows=t(fields["light_rows"]),
        light_cdf=t(fields["light_cdf"]),
        total_light_area=t(np.float32(fields["total_light_area"])),
        mat_rows=t(fields["mat_rows"]),
        env=EnvMap(image=t(fields["env"])),
        node_rows=t(fields["node_rows"]),
        cluster_rows=t(fields.get("cluster_rows")),
        cluster_refs=t(fields.get("cluster_refs")))


def build_emitter_cdf(soup: TriangleSoup, emissive_mask: np.ndarray):
    """Emitter CDF (Scene.cpp:296-331): Heron area per emissive triangle,
    sorted ascending, cumulative sum."""
    p0, p1, p2 = soup.vertices()
    emissive_tri = emissive_mask[soup.mat]
    idx = np.nonzero(emissive_tri)[0].astype(np.int32)
    if idx.size:
        a = np.linalg.norm(p0[idx] - p2[idx], axis=1)
        b = np.linalg.norm(p0[idx] - p1[idx], axis=1)
        c = np.linalg.norm(p2[idx] - p1[idx], axis=1)
        s = (a + b + c) / 2
        area = np.sqrt(np.maximum(s * (s - a) * (s - b) * (s - c), 0.0))
        order = np.argsort(area, kind="stable")
        idx = idx[order]
        cdf = np.cumsum(area[order]).astype(np.float32)
        total_area = float(cdf[-1])
    else:  # pad so gathers stay valid; inf pdf zeroes NEE (see integrator)
        idx = np.zeros(1, np.int32)
        cdf = np.zeros(1, np.float32)
        total_area = 0.0
    return idx, cdf, total_area


def _reject_textures(materials: List[MaterialDesc], base_dir: str) -> None:
    """Texture maps are not ported yet. A map file that does not exist is
    skipped, as the JAX package's atlas builder skips it."""
    paths = sorted({m.albedo_texture for m in materials if m.albedo_texture}
                   | {m.mr_texture for m in materials if m.mr_texture})
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(base_dir, p)
        if os.path.exists(full):
            raise NotImplementedError(
                f"texture {p!r}: textured scenes are not ported yet "
                f"(ROADMAP.md, queue A: textures and mips)")


def load_scene(cfg: RenderConfig, device) -> Tuple[SceneData, SceneMeta]:
    """Full ingest: dispatch on scene_path ("proc:<name>" or .obj), load the
    environment, build the BVH, pack the tables onto `device`."""
    if cfg.wide_arity != 8:
        raise NotImplementedError(
            "the port traverses 8-wide tables only (wide_arity=8)")
    path = cfg.scene_path
    base_dir = os.path.dirname(os.path.abspath(path)) if os.path.sep in path else "."
    env = environment_image(cfg.skybox, base_dir=base_dir)

    if path.startswith("proc:"):
        from gpupathtracer_tpu_torch.scene.procedural import load_procedural
        mesh, materials = load_procedural(path)
    elif path.lower().endswith(".obj"):
        from gpupathtracer_tpu_torch.scene.objloader import load_obj
        mesh, materials = load_obj(path)
    elif path.lower().endswith((".gltf", ".glb")):
        raise NotImplementedError(
            f"{path!r}: glTF is not ported yet (ROADMAP.md, queue A)")
    else:
        raise ValueError(f"unsupported scene format: {path!r}")

    _reject_textures(materials, base_dir)
    soup = build_triangle_soup(mesh)
    table = pack_materials(materials)
    idx, cdf, total_area = build_emitter_cdf(soup, table.emissive)
    p0, p1, p2 = soup.vertices()
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=cfg.leaf_size,
                                 arity=cfg.wide_arity, builder=cfg.bvh_builder,
                                 spatial_splits=cfg.spatial_splits,
                                 force_leaf=cfg.force_leaf,
                                 reinsert_rounds=cfg.reinsert_rounds)
    stack_depth = min(max(stats.max_depth * (cfg.wide_arity - 1) + 2, 8),
                      cfg.stack_depth * 4)
    # Shading-normal sign vs the geometric e1 x e2 (leaf slot 11).
    gn = np.cross(soup.e1, soup.e2)
    nsign = np.where(np.einsum("ij,ij->i", gn, soup.normal) < 0.0,
                     -1.0, 1.0).astype(np.float32)
    if cfg.cluster_tris:
        # Dense cluster leaves: node_rows becomes the cluster top tree
        # (the JAX package's scenedata.py:154-165).
        wide = pack_clusters(wide, soup.p0, soup.e1, soup.e2,
                             tc=cfg.cluster_tris, arity=cfg.wide_arity,
                             tri_mat=soup.mat, tri_nsign=nsign)
    else:
        wide = pack_for_packets(wide, soup.p0, soup.e1, soup.e2,
                                leaf_size=cfg.leaf_size,
                                tri_mat=soup.mat, tri_nsign=nsign)

    M = int(table.albedo.shape[0])
    mrows = np.zeros((max(M, 1), 16), np.float32)
    if M:
        mrows[:, 0:3] = table.albedo
        mrows[:, 3] = table.rough_g
        mrows[:, 4] = table.metallic
        mrows[:, 5:8] = table.emission
        mrows[:, 8] = np.asarray(table.albedo_tex, np.int32).view(np.float32)
        mrows[:, 9] = np.asarray(table.mr_tex, np.int32).view(np.float32)
        mrows[:, 10] = np.asarray(table.mtype, np.int32).view(np.float32)
        mrows[:, 11] = table.ior

    T = soup.num_triangles
    shade = np.zeros((max(T, 1), 32), np.float32)
    if T:
        shade[:, 0:3] = soup.normal
        shade[:, 3:9] = soup.uv.reshape(T, 6)
        shade[:, 9] = soup.mat.astype(np.int32).view(np.float32)
        # Col 10: texel density sqrt(uv_area / world_area), the mip-LOD input.
        wa = 0.5 * np.linalg.norm(np.cross(soup.e1, soup.e2), axis=1)
        duv1 = soup.uv[:, 1] - soup.uv[:, 0]
        duv2 = soup.uv[:, 2] - soup.uv[:, 0]
        ua = 0.5 * np.abs(duv1[:, 0] * duv2[:, 1] - duv1[:, 1] * duv2[:, 0])
        shade[:, 10] = np.sqrt(ua / np.maximum(wa, 1e-20))
        shade[:, 16:32] = mrows[soup.mat]

    L = int(idx.size)
    lrows = np.zeros((max(L, 1), 16), np.float32)
    if L:
        lrows[:, 0:9] = pack_tri_geom(soup.p0, soup.e1, soup.e2)[idx]
        lrows[:, 9:12] = soup.normal[idx]
        lrows[:, 12:15] = table.emission[soup.mat[idx]]

    data = scene_from_numpy(dict(tri_shade=shade, light_rows=lrows,
                                 light_cdf=cdf, total_light_area=total_area,
                                 mat_rows=mrows, env=env,
                                 node_rows=wide.node_rows,
                                 cluster_rows=wide.cluster_rows,
                                 cluster_refs=wide.cluster_refs), device)
    meta = SceneMeta(
        num_triangles=T,
        num_materials=M,
        num_lights=int(idx.size if total_area > 0 else 0),
        stack_depth=stack_depth,
        leaf_size=cfg.leaf_size,
        has_delta=bool((table.mtype != 1).any()),
        bvh_stats=stats,
    )
    return data, meta
