"""Scene ingest: loaders, the SBVH, the merged row table, the emitter CDF
and the packed shading tables, as torch tensors on an explicit device
(counterpart of the JAX package's scene/scenedata.py).

The BVH comes from the port's copy of the JAX package's builders
(``gpupathtracer_tpu_torch.bvh``: C++ SBVH through ctypes, the
``cfg.wide_arity``-wide collapse (2 to 16 children a node), ``pack_for_packets`` and, with ``cfg.cluster_tris``, the dense
cluster leaves of ``pack_clusters``), so both packages trace identical
tables, and the texture atlas comes from the port's copy of the atlas
builder (scene/textures.py). Scenes come from the procedural generators,
OBJ + MTL and glTF / GLB files.

Ingest is two steps, as in the JAX package: ``build_scene`` (the soup, the
material table, the emitter CDF, the atlas and the wide BVH) and
``upload_scene`` (the node-row packing, the cluster leaves and the treelet
cut, the packed tables, the tensors on the device). With
``cfg.cache_enabled`` the first step's arrays go through the disk cache of
scene/cache.py (``cfg.cache_dir``): a hit skips the loaders and the SBVH,
a miss writes the file; the upload is the same either way.
"""

from __future__ import annotations

import os
from dataclasses import dataclass
from typing import List, NamedTuple, Optional, Tuple

import numpy as np
import torch

from gpupathtracer_tpu_torch.bvh import BuildStats, build_wide_bvh
from gpupathtracer_tpu_torch.bvh.cluster import pack_clusters
from gpupathtracer_tpu_torch.bvh.types import WideBVH
from gpupathtracer_tpu_torch.bvh.wide import pack_for_packets
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.ops.intersect import pack_tri_geom
from gpupathtracer_tpu_torch.scene.envmap import EnvMap, environment_image
from gpupathtracer_tpu_torch.scene import cache as scache
from gpupathtracer_tpu_torch.scene.materials import (MaterialDesc,
                                                     MaterialTable,
                                                     pack_materials)
from gpupathtracer_tpu_torch.scene.mesh import (TriangleSoup,
                                                build_triangle_soup)
from gpupathtracer_tpu_torch.scene.textures import build_atlas


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
    # The treelet cut of node_rows (bvh/treelet.py): the root entry and the
    # bounds of each treelet, the sort keys of ops/tsort.py. None on tables
    # carried over without them (tsort then raises).
    cut_entry: Optional[torch.Tensor] = None     # [C] i32
    cut_bounds: Optional[torch.Tensor] = None    # [C, 6] f32
    # (p0, e1, e2) of every triangle, the input of the dense intersection's
    # table (ops/dense_intersect.py pack_dense_tris); the tree walks read
    # their triangles from node_rows.
    tri_geom: Optional[torch.Tensor] = None      # [T, 9] f32
    # The per-lane layout of the same tree (bvh/types.py WideBVH, kept on
    # cluster scenes too), which the per-ray walk reads (ops/traverse.py
    # "perray", and "packet" where it falls back to it): each node's
    # children's bounds and entries (leaves as -(first_ref << 4 | count)
    # - 1) and the triangle id of each leaf reference.
    child_bounds: Optional[torch.Tensor] = None  # [W, arity, 6] f32
    child_entry: Optional[torch.Tensor] = None   # [W, arity] i32
    refs: Optional[torch.Tensor] = None          # [R] i32
    # Texture atlas (role of bindless textures, Material.glsl:43-44): the
    # packed images, each rect (x, y, w, h; mip levels included), and each
    # texture slot's rect row per mip level (mat_rows cols 8 and 9 hold
    # the slots). Without textures a 4x4 zero atlas with one rect.
    atlas_image: Optional[torch.Tensor] = None   # [AH, AW, 3] f32
    atlas_rects: Optional[torch.Tensor] = None   # [R, 4] i32
    atlas_mips: Optional[torch.Tensor] = None    # [S, L] i32
    # Sun disk (Renderer.cpp:23-26; SUN_LIGHT, Iterative.comp:84-126).
    sun_dir: Optional[torch.Tensor] = None       # [3] unit, toward the sun
    sun_emission: Optional[torch.Tensor] = None  # [3]
    sun_radius: Optional[torch.Tensor] = None    # scalar: tan(angle)
    sun_max_dot: Optional[torch.Tensor] = None   # scalar: cos(angle)
    # Children per node row of node_rows (cfg.wide_arity, 2 to 16): a row
    # holds 6 * arity bounds and arity entries. The JAX SceneData reads it
    # from bvh.child_entry.shape[1].
    arity: int = 8


@dataclass
class SceneMeta:
    """Static facts about a loaded scene."""

    num_triangles: int
    num_materials: int
    num_lights: int
    stack_depth: int           # traversal stack bound from the wide depth
    leaf_size: int
    has_textures: bool = False
    has_delta: bool = False    # any mirror/refractive materials
    mip_levels: int = 1        # atlas pyramid depth (1 = level 0 only)
    bvh_stats: Optional[BuildStats] = None


def scene_from_numpy(fields: dict, device) -> SceneData:
    """SceneData from arrays keyed by field name (``env`` is the lat-long
    image), e.g. the JAX package's SceneData converted with np.asarray.
    Without atlas fields the scene gets the no-texture atlas; without
    ``arity`` (the nodes' width, the JAX scene's
    ``bvh.child_entry.shape[1]``) it is 8."""
    def t(x):
        return None if x is None else torch.tensor(np.asarray(x),
                                                   device=device)
    rects = fields.get("atlas_rects")
    if rects is None:
        rects = np.asarray([[0, 0, 4, 4]], np.int32)
    mips = fields.get("atlas_mips")
    if mips is None:
        mips = np.arange(np.asarray(rects).shape[0], dtype=np.int32)[:, None]
    image = fields.get("atlas_image")
    arity = int(fields.get("arity", 8))
    if image is None:
        image = np.zeros((4, 4, 3), np.float32)
    return SceneData(
        tri_shade=t(fields["tri_shade"]),
        light_rows=t(fields["light_rows"]),
        light_cdf=t(fields["light_cdf"]),
        total_light_area=t(np.float32(fields["total_light_area"])),
        mat_rows=t(fields["mat_rows"]),
        env=EnvMap(image=t(fields["env"])),
        node_rows=t(fields["node_rows"]),
        cluster_rows=t(fields.get("cluster_rows")),
        cluster_refs=t(fields.get("cluster_refs")),
        cut_entry=t(fields.get("cut_entry")),
        cut_bounds=t(fields.get("cut_bounds")),
        tri_geom=t(fields.get("tri_geom")),
        child_bounds=t(fields.get("child_bounds")),
        child_entry=t(fields.get("child_entry")),
        refs=t(fields.get("refs")),
        atlas_image=t(image), atlas_rects=t(rects), atlas_mips=t(mips),
        sun_dir=t(fields.get("sun_dir")),
        sun_emission=t(fields.get("sun_emission")),
        sun_radius=t(fields.get("sun_radius")),
        sun_max_dot=t(fields.get("sun_max_dot")), arity=arity)


def sun_fields(cfg: RenderConfig) -> dict:
    """The sun's scene fields from the config, rounded as the JAX package
    rounds them: the direction normalized in float64, tan and cos of the
    angle in float64, each then stored as float32."""
    direction = (np.asarray(cfg.sun_direction, np.float32)
                 / max(np.linalg.norm(cfg.sun_direction), 1e-9))
    return dict(sun_dir=direction.astype(np.float32),
                sun_emission=np.asarray(cfg.sun_emission, np.float32),
                sun_radius=np.float32(np.tan(cfg.sun_angle)),
                sun_max_dot=np.float32(np.cos(cfg.sun_angle)))


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


def build_atlas_for(materials: List[MaterialDesc], base_dir: str,
                    cfg: RenderConfig):
    """The atlas of every map the materials name (the JAX package's
    ``_build_atlas_for``): (image, rects, {path: slot}, mips)."""
    paths = sorted({m.albedo_texture for m in materials if m.albedo_texture}
                   | {m.mr_texture for m in materials if m.mr_texture})
    return build_atlas(paths, base_dir, mip_levels=cfg.mip_levels)


class BuiltScene(NamedTuple):
    """The arrays ingest builds before the upload: what the disk cache
    keeps (scene/cache.py)."""

    soup: TriangleSoup
    table: MaterialTable
    light_idx: np.ndarray      # [L] i32 emissive triangles, by area
    light_cdf: np.ndarray      # [L] f32 cumulative areas
    total_area: float
    wide: WideBVH              # child_bounds, child_entry, refs
    stats: BuildStats
    atlas_img: np.ndarray
    atlas_rects: np.ndarray
    atlas_mips: np.ndarray


def build_scene(soup: TriangleSoup, materials: List[MaterialDesc],
                cfg: RenderConfig, base_dir: str = ".") -> BuiltScene:
    """The atlas, the material table, the emitter CDF and the wide BVH of a
    triangle soup (texture paths read relative to ``base_dir``)."""
    if not 2 <= cfg.wide_arity <= 16:
        raise ValueError(f"wide_arity {cfg.wide_arity} outside 2..16 (a "
                         f"128-float node row holds 16 children at most)")
    atlas_img, atlas_rects, slots, atlas_mips = build_atlas_for(
        materials, base_dir, cfg)
    table = pack_materials(materials, atlas_slots=slots)
    idx, cdf, total_area = build_emitter_cdf(soup, table.emissive)
    p0, p1, p2 = soup.vertices()
    wide, stats = build_wide_bvh(p0, p1, p2, leaf_size=cfg.leaf_size,
                                 arity=cfg.wide_arity, builder=cfg.bvh_builder,
                                 spatial_splits=cfg.spatial_splits,
                                 force_leaf=cfg.force_leaf,
                                 reinsert_rounds=cfg.reinsert_rounds)
    return BuiltScene(soup, table, idx, cdf, total_area, wide, stats,
                      atlas_img, atlas_rects, atlas_mips)


def scene_from_cache(z: dict) -> BuiltScene:
    """A BuiltScene from a cache file's arrays (the JAX package's
    load_scene, scene/scenedata.py:303-329)."""
    soup = TriangleSoup(p0=z["p0"], e1=z["e1"], e2=z["e2"],
                        normal=z["normal"], uv=z["uv"], mat=z["mat"])
    table = MaterialTable(albedo=z["m_albedo"], rough_g=z["m_rough"],
                          metallic=z["m_metal"], emission=z["m_emission"],
                          emissive=z["m_emissive"], albedo_tex=z["m_tex"],
                          mtype=z["m_type"], ior=z["m_ior"],
                          mr_tex=z["m_mr_tex"])
    wide = WideBVH(child_bounds=z["child_bounds"],
                   child_entry=z["child_entry"], refs=z["refs"])
    st = z["stats"]
    stats = BuildStats(num_triangles=int(st[0]), num_refs=int(st[1]),
                       num_binary_nodes=int(st[2]), num_wide_nodes=int(st[3]),
                       num_leaves=int(st[4]), max_depth=int(st[5]),
                       spatial_splits=int(st[6]), sah_cost=float(z["sah"]))
    return BuiltScene(soup, table, z["light_idx"], z["light_cdf"],
                      float(z["total_area"]), wide, stats, z["atlas_img"],
                      z["atlas_rects"], z["atlas_mips"])


def load_scene(cfg: RenderConfig, device) -> Tuple[SceneData, SceneMeta]:
    """Full ingest: dispatch on scene_path ("proc:<name>", .obj, .gltf or
    .glb), load the environment, build the BVH (or read it from the disk
    cache), pack the tables onto `device`."""
    path = cfg.scene_path
    base_dir = os.path.dirname(os.path.abspath(path)) if os.path.sep in path else "."
    env = environment_image(cfg.skybox, base_dir=base_dir)

    cached = scache.load_scene_cache(cfg)
    if cached is not None:
        return upload_scene(scene_from_cache(cached), env, cfg, device)
    if path.startswith("proc:"):
        from gpupathtracer_tpu_torch.scene.procedural import load_procedural
        mesh, materials = load_procedural(path)
    elif path.lower().endswith(".obj"):
        from gpupathtracer_tpu_torch.scene.objloader import load_obj
        mesh, materials = load_obj(path)
    elif path.lower().endswith((".gltf", ".glb")):
        from gpupathtracer_tpu_torch.scene.gltf import load_gltf
        mesh, materials = load_gltf(path)
    else:
        raise ValueError(f"unsupported scene format: {path!r}")
    built = build_scene(build_triangle_soup(mesh), materials, cfg, base_dir)
    if cfg.cache_enabled:
        scache.save_scene_cache(cfg, *built)
    return upload_scene(built, env, cfg, device)


def pack_scene(soup: TriangleSoup, materials: List[MaterialDesc],
               env: np.ndarray, cfg: RenderConfig, device,
               base_dir: str = ".") -> Tuple[SceneData, SceneMeta]:
    """Pack a triangle soup, its materials and a lat-long environment image
    into tables on ``device`` and build the BVH: the funnel every loader
    goes through (the JAX package's ``pack_scene``; no disk cache). Texture
    paths are read relative to ``base_dir``."""
    return upload_scene(build_scene(soup, materials, cfg, base_dir), env,
                        cfg, device)


def upload_scene(built: BuiltScene, env: np.ndarray, cfg: RenderConfig,
                 device) -> Tuple[SceneData, SceneMeta]:
    """Pack a BuiltScene's node rows (MT leaves or, with cfg.cluster_tris,
    cluster leaves) and shading tables onto ``device`` (the JAX package's
    ``_upload``)."""
    (soup, table, idx, cdf, total_area, wide, stats, atlas_img, atlas_rects,
     atlas_mips) = built
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
                                 cluster_refs=wide.cluster_refs,
                                 cut_entry=wide.cut_entry,
                                 cut_bounds=wide.cut_bounds,
                                 tri_geom=pack_tri_geom(soup.p0, soup.e1,
                                                        soup.e2),
                                 child_bounds=wide.child_bounds,
                                 child_entry=wide.child_entry,
                                 refs=wide.refs,
                                 atlas_image=atlas_img,
                                 atlas_rects=atlas_rects,
                                 atlas_mips=atlas_mips,
                                 arity=cfg.wide_arity, **sun_fields(cfg)),
                            device)
    meta = SceneMeta(
        num_triangles=T,
        num_materials=M,
        num_lights=int(idx.size if total_area > 0 else 0),
        stack_depth=stack_depth,
        leaf_size=cfg.leaf_size,
        has_textures=bool((table.albedo_tex >= 0).any()
                          or (table.mr_tex >= 0).any()),
        has_delta=bool((table.mtype != 1).any()),
        mip_levels=int(atlas_mips.shape[1]),
        bvh_stats=stats,
    )
    return data, meta
