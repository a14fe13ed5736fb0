"""Configuration for the renderer (a copy of the JAX package's config.py,
so that one set of names and defaults drives either package while the port
imports nothing of that package).

The reference spreads configuration over three tiers (see SURVEY.md §5):
a 4-line ``scene.txt`` runtime file (src/Program.cpp:71-84), compile-time
constants (resolution, camera speed/FoV/focus/aperture Program.cpp:22-34,
exposure Renderer.cpp:18, sun Renderer.cpp:23-26), and ``#define`` feature
flags. Here everything is one dataclass, serializable alongside results.
"""

from __future__ import annotations

import dataclasses
import json
import math
from dataclasses import dataclass, field
from typing import Optional, Tuple


@dataclass
class CameraConfig:
    """Thin-lens camera parameters (reference: src/math/Camera.cpp:4-22,58-69).

    Reference defaults: fov 45 deg, focal_distance 900*0.1=90, aperture 0
    (src/Program.cpp:26-34), position/rotation from scene.txt lines 3-4.
    """

    position: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    yaw: float = 0.0
    pitch: float = 0.0
    fov: float = math.radians(45.0)        # full vertical field of view, radians
    aspect: float = 16.0 / 9.0
    focal_distance: float = 90.0
    aperture: float = 0.0                  # lens diameter; lens_radius = aperture/2

    @property
    def lens_radius(self) -> float:
        return self.aperture / 2.0


@dataclass
class RenderConfig:
    """Full render configuration (one object replaces the reference's 3 tiers)."""

    # Scene ingest ------------------------------------------------------
    scene_path: str = ""                   # .obj / .gltf / .glb / "proc:<name>"
    skybox: str = "GENERATE COLOR WHITE"   # spec string, same grammar as scene.txt line 2
    # Film --------------------------------------------------------------
    width: int = 1280
    height: int = 720
    exposure: float = 1.68                 # Renderer.cpp:18
    tonemap: str = "uncharted2"            # "uncharted2" | "none"
    # Integrator ----------------------------------------------------------
    integrator: str = "wavefront"          # "wavefront" | "reference" | "direct" | "ao"
    max_bounces: int = 64                  # Iterative.comp:293 bounce cap
    microfacet: str = "trowbridge_reitz"   # "trowbridge_reitz" | "beckmann" | "blinn_phong"
    rr_enabled: bool = True
    nee_enabled: bool = True
    # Sun (compiled out in the reference: SUN_LIGHT never defined, Iterative.comp:116)
    sun_enabled: bool = False
    sun_direction: Tuple[float, float, float] = (2.0, 69.0, 12.0)   # Renderer.cpp:23
    sun_angle: float = math.radians(5.0)                            # Renderer.cpp:24
    sun_emission: Tuple[float, float, float] = (120.0, 110.0, 95.0)
    sun_mode: str = "disk"                 # "disk" (reference hack) | "cone" (solid angle)
    # Sampler -------------------------------------------------------------
    seed: int = 0
    # Performance ---------------------------------------------------------
    ray_chunk: int = 1 << 17               # rays per traversal chunk (memory/divergence knob)
    stack_depth: int = 48
    wide_arity: int = 8                    # children per wide-BVH node
    # Tree shape tuned for packet pops (PERF.md leaf-density sweep): fat
    # forced leaves beat the reference's GPU-optimal 1.01-tri leaves 2.8x
    # on TPU and shrink the merged table ~7x.
    leaf_size: int = 10                    # max triangles per wide-BVH leaf
    force_leaf: bool = True                # pack leaves to leaf_size unconditionally
    cluster_tris: int = 0                  # >0 (multiple of 128): dense cluster
    #                                        leaves — subtrees of <= this many tris
    #                                        become single MXU-intersected pops
    #                                        (bvh/cluster.py; pallas/tsort paths only)
    reinsert_rounds: int = 0               # Bittner-2013 insertion optimizer passes
    #                                        (the pass BVH.cpp:2303-2397 stubbed out)
    traversal: str = "auto"                # "auto" | "pallas" (on-core kernel) | "packet" | "perray"
    bounce_traversal: str = "auto"         # bounce-ray override: "auto" | "same" | "treelet" | any traversal name
    treelet_min: int = 1 << 15             # min wavefront width for treelet binning/sorting
    sort_rays: bool = False                # bounce-wavefront coherence sort (alive-first)
    shadow_rev: bool = False               # trace NEE shadow rays from the light end
    shadow_sort: bool = True               # reuse the bounce tsort perm for shadow rays
    fused_pair: bool = False               # co-schedule 2 packets per Pallas grid step
    #                                        (_kernel_pair; measured A/B knob)
    fused_pair_occl: bool = True           # fused-pair pops for UNGROUPED occlusion
    #                                        queries on SMALL tables (< 8192 rows —
    #                                        r5 paired A/Bs: bathroom any-hit -20%;
    #                                        big tables excluded: sponza coherent
    #                                        any-hit +12% loss, and its incoherent
    #                                        shadows ride the grouped tsort path)
    tsort_alternate: bool = False          # recompute the tsort perm on even bounces only
    frame_batch: int = 1                   # spp accumulated per dispatch (realtime knob)
    megakernel: str = "off"                # "off" | "on" | "auto": run eligible
    #                                        wavefront/direct frames through the
    #                                        all-on-core bounce loop (ops/megakernel.py)
    mega_fused_nee: bool = False           # deferred-shadow fused walk: each bounce's
    #                                        NEE shadow rays trace as the partner
    #                                        stream of the NEXT bounce's closest walk
    #                                        (walk_fused, _kernel_pair schedule);
    #                                        schedule-only, cluster-incompatible
    compaction: bool = True                # bounce-epoch live-path compaction
    compaction_divs: Tuple[int, ...] = (4, 16, 64)  # phase width schedule (PERF.md r3 sweep)
    sampler: str = "random"                # pixel jitter: "random" | "ld" (R2 + per-pixel rotation)
    mip_levels: int = 1                    # texture mip pyramid depth; >1 = trilinear
    #                                        sampling with ray-cone LOD (beyond the
    #                                        reference, which samples level 0 only)
    pixel_order: str = "morton"            # "morton" | "hilbert" (8x8 blocks)
    packet_size: int = 128                 # rays per XLA shared-stack packet
    pallas_packet_size: int = 2048         # rays per Pallas kernel packet (mult of 128)
    bvh_builder: str = "auto"              # "auto" | "cpp" | "numpy"
    spatial_splits: bool = True            # SBVH spatial splits (C++ builder)
    use_float32: bool = True
    # Parallelism -----------------------------------------------------------
    mesh_shape: Tuple[int, ...] = (1,)     # device mesh, samples sharded over axis "samples"
    partition_chips: int = 0               # >0: scene-PARTITIONED mesh — chips own BVH
    #                                        subtrees, rays ring via ppermute
    #                                        (parallel/partition.py); overrides mesh_shape
    partition_samples: int = 1             # sample replicas composed over the partition
    partition_routing: str = "ring"        # ray migration: "ring" (static ppermute) or
    #                                        "routed" (demand-routed all_to_all — rays hop
    #                                        only to the chips they need)
    # Camera ---------------------------------------------------------------
    camera: CameraConfig = field(default_factory=CameraConfig)
    # Caching ----------------------------------------------------------------
    cache_dir: str = "cache"               # scene/BVH disk cache (role of Texture.cpp:35-88)
    cache_enabled: bool = False            # opt-in (CLI/bench enable it)

    def to_json(self) -> str:
        d = dataclasses.asdict(self)
        return json.dumps(d, indent=2)

    @staticmethod
    def from_json(s: str) -> "RenderConfig":
        d = json.loads(s)
        cam = d.pop("camera", None)
        cfg = RenderConfig(**{k: v for k, v in d.items() if k in _RC_FIELDS})
        if cam is not None:
            cfg.camera = CameraConfig(**{k: _tup(k, v) for k, v in cam.items()
                                         if k in _CC_FIELDS})
        # JSON round-trips tuples as lists
        for k in ("sun_direction", "sun_emission", "mesh_shape",
                  "compaction_divs"):
            setattr(cfg, k, tuple(getattr(cfg, k)))
        return cfg


_RC_FIELDS = {f.name for f in dataclasses.fields(RenderConfig)}
_CC_FIELDS = {f.name for f in dataclasses.fields(CameraConfig)}


def _tup(k, v):
    return tuple(v) if isinstance(v, list) else v


def load_scene_txt(path: str, width: int = 1280, height: int = 720) -> RenderConfig:
    """Parse the reference's 4-line ``scene.txt`` format (Program.cpp:71-84).

    Line 1: model path; line 2: skybox spec; line 3: camera position xyz;
    line 4: camera rotation (yaw pitch [roll]).
    """
    with open(path) as f:
        lines = [ln.strip() for ln in f.read().splitlines() if ln.strip()]
    if len(lines) < 4:
        raise ValueError(f"scene file {path!r} needs 4 lines, got {len(lines)}")
    pos = tuple(float(x) for x in lines[2].split()[:3])
    rot = [float(x) for x in lines[3].split()]
    cam = CameraConfig(position=pos, yaw=rot[0], pitch=rot[1] if len(rot) > 1 else 0.0,
                       aspect=width / height)
    return RenderConfig(scene_path=lines[0], skybox=lines[1], width=width,
                        height=height, camera=cam)
