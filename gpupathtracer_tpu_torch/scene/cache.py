"""Scene + BVH disk cache (counterpart of the JAX package's
scene/cache.py, with its file format and key, so that either package reads
the other's files).

Role of the reference's decoded-texture byte cache (src/core/Texture.cpp:
35-88, `cache/<path>.BIN`): memoize the expensive part of startup across
runs. Here the startup bottleneck is SBVH construction (SURVEY.md §3.4), so
the packed triangle soup, material table, emitter CDF, texture atlas and
flattened wide BVH are cached, keyed by scene identity + build parameters
+ a hash of the C++ builder's source (the port's copy, byte for byte the
JAX package's). The node-row packing, the cluster leaves and the treelet
cut run after the cache, so it does not depend on their settings.
"""

from __future__ import annotations

import hashlib
import os
from typing import Optional, Tuple

import numpy as np

CACHE_VERSION = 8  # bump when array formats or builder behavior change


def _scene_fingerprint(cfg) -> str:
    ident = cfg.scene_path
    if not ident.startswith("proc:") and os.path.exists(ident):
        st = os.stat(ident)
        ident += f":{st.st_mtime_ns}:{st.st_size}"
    key = (f"v{CACHE_VERSION}|{ident}|leaf{cfg.leaf_size}|ar{cfg.wide_arity}"
           f"|b{cfg.bvh_builder}|ss{cfg.spatial_splits}|fl{cfg.force_leaf}"
           f"|mip{getattr(cfg, 'mip_levels', 1)}"
           f"|ri{getattr(cfg, 'reinsert_rounds', 0)}"
           f"|{_builder_fingerprint()}")
    return hashlib.sha1(key.encode()).hexdigest()[:20]


def _builder_fingerprint() -> str:
    """Hash of the C++ builder source, so builder changes invalidate caches."""
    try:
        src = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                           "bvh", "builder_cpp", "sbvh.cpp")
        with open(src, "rb") as f:
            return hashlib.sha1(f.read()).hexdigest()[:8]
    except OSError:
        return "nosrc"


def cache_path(cfg) -> str:
    return os.path.join(cfg.cache_dir, f"scene_{_scene_fingerprint(cfg)}.npz")


def save_scene_cache(cfg, soup, table, light_idx, light_cdf, total_area,
                     wide, stats, atlas_img=None, atlas_rects=None,
                     atlas_mips=None) -> None:
    path = cache_path(cfg)
    os.makedirs(os.path.dirname(path), exist_ok=True)
    if atlas_img is None:
        atlas_img = np.zeros((4, 4, 3), np.float32)
        atlas_rects = np.asarray([[0, 0, 4, 4]], np.int32)
    if atlas_mips is None:
        atlas_mips = np.arange(atlas_rects.shape[0], dtype=np.int32)[:, None]
    # Written beside the file and moved into place, so that a process
    # reading the cache never sees half a file.
    tmp = f"{path}.{os.getpid()}.tmp"
    with open(tmp, "wb") as f:
        np.savez_compressed(
            f, atlas_img=atlas_img, atlas_rects=atlas_rects,
            atlas_mips=atlas_mips,
            p0=soup.p0, e1=soup.e1, e2=soup.e2, normal=soup.normal,
            uv=soup.uv, mat=soup.mat,
            m_albedo=table.albedo, m_rough=table.rough_g,
            m_metal=table.metallic, m_emission=table.emission,
            m_emissive=table.emissive, m_tex=table.albedo_tex,
            m_type=table.mtype, m_ior=table.ior, m_mr_tex=table.mr_tex,
            light_idx=light_idx, light_cdf=light_cdf,
            total_area=np.float32(total_area),
            child_bounds=wide.child_bounds, child_entry=wide.child_entry,
            refs=wide.refs,
            stats=np.asarray([stats.num_triangles, stats.num_refs,
                              stats.num_binary_nodes, stats.num_wide_nodes,
                              stats.num_leaves, stats.max_depth,
                              stats.spatial_splits], np.int64),
            sah=np.float64(stats.sah_cost))
    os.replace(tmp, path)


def load_scene_cache(cfg) -> Optional[dict]:
    path = cache_path(cfg)
    if not (cfg.cache_enabled and os.path.exists(path)):
        return None
    try:
        with np.load(path) as z:
            return {k: z[k] for k in z.files}
    except Exception:
        return None
