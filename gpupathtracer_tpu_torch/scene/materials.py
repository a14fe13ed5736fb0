"""Material model and ingest heuristics.

The reference's material pipeline (src/core/Scene.cpp:86-175 +
src/shaders/common/Material.glsl:39-54):

  - OBJ/MTL Blinn-Phong shininess Ns -> TR-GGX roughness 2/(Ns+2) -> stored
    as its sqrt ("Beckmann roughness") in the properties texture G channel
    (Scene.cpp:160-161).
  - metallic = 1 if max(Ks) > 0.3 else 0 (Scene.cpp:162-170).
  - At shading time: roughness = max(G^2, 1e-4), alpha^2 = roughness^2
    (Material.glsl:47-48); reflectance F0 = mix(0.04, albedo, metallic).
  - Material id 0 is the environment (Scene.cpp:158 `materialIndices[-1]=0`);
    emissive iff sum(emission) > 1e-5 (Scene.cpp:112).

Materials carry constant values plus optional indices into a packed
texture atlas (the JAX package's layout; a numpy copy of its
scene/materials.py).
"""

from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import List, NamedTuple, Optional, Tuple

import numpy as np


# MATERIAL_TYPE enum (Material.glsl:15-17 declares these but the reference
# BRDF never implements 2/3; we do).
MATERIAL_DIFFUSE_SPECULAR = 1
MATERIAL_REFRACTIVE = 2
MATERIAL_MIRROR = 3


@dataclass
class MaterialDesc:
    """Host-side material description (role of MaterialInstance, Scene.h:12-17)."""

    name: str = ""
    albedo: Tuple[float, float, float] = (0.8, 0.8, 0.8)
    albedo_texture: Optional[str] = None        # image path; atlas-resolved later
    mr_texture: Optional[str] = None            # metallic-roughness map (glTF: G=rough, B=metal)
    roughness_g: float = 1.0                    # stored "G channel" value
    metallic: float = 0.0
    emission: Tuple[float, float, float] = (0.0, 0.0, 0.0)
    material_type: int = MATERIAL_DIFFUSE_SPECULAR
    ior: float = 1.5

    @property
    def is_emissive(self) -> bool:
        return sum(self.emission) > 1e-5


def env_material() -> MaterialDesc:
    """Material 0: the environment pseudo-material."""
    return MaterialDesc(name="__env__", albedo=(0.0, 0.0, 0.0), roughness_g=1.0,
                        metallic=0.0, emission=(0.0, 0.0, 0.0))


def obj_material_heuristics(name: str,
                            diffuse: Tuple[float, float, float],
                            specular: Tuple[float, float, float],
                            emission: Tuple[float, float, float],
                            shininess: float,
                            illum: int,
                            diffuse_texname: str = "",
                            ior: float = 1.5) -> MaterialDesc:
    """MTL -> PBR conversion, matching Scene.cpp:156-175 exactly, extended
    with MTL's classic ray-tracing illumination modes the reference left
    unimplemented: illum 5 -> perfect mirror, illum 6/7 -> refractive with
    Ni as the index of refraction."""
    tr_ggx_roughness = 2.0 / (shininess + 2.0)
    beckmann_roughness = math.sqrt(tr_ggx_roughness)
    metallic = 1.0 if max(specular) > 0.3 else 0.0
    mtype = MATERIAL_DIFFUSE_SPECULAR
    if illum == 5:
        mtype = MATERIAL_MIRROR
    elif illum in (6, 7):
        mtype = MATERIAL_REFRACTIVE
    return MaterialDesc(
        name=name,
        albedo=tuple(diffuse),
        albedo_texture=diffuse_texname or None,
        roughness_g=beckmann_roughness,
        metallic=metallic,
        emission=tuple(emission),
        material_type=mtype,
        ior=ior,
    )


class MaterialTable(NamedTuple):
    """Packed per-material arrays (role of the materials SSBO, Material.glsl:10-12)."""

    albedo: np.ndarray      # [M, 3] f32
    rough_g: np.ndarray     # [M]    f32  (stored G-channel roughness)
    metallic: np.ndarray    # [M]    f32
    emission: np.ndarray    # [M, 3] f32
    emissive: np.ndarray    # [M]    bool
    albedo_tex: np.ndarray  # [M]    i32  atlas slot, -1 = constant color
    mtype: np.ndarray = None  # [M]  i32  MATERIAL_* enum
    ior: np.ndarray = None    # [M]  f32
    mr_tex: np.ndarray = None  # [M]  i32  metallic-roughness atlas slot, -1 = constants


def pack_materials(materials: List[MaterialDesc],
                   atlas_slots: Optional[dict] = None) -> MaterialTable:
    """Pack host materials into flat arrays. materials[0] must be the env."""
    m = len(materials)
    table = MaterialTable(
        albedo=np.zeros((m, 3), np.float32),
        rough_g=np.zeros((m,), np.float32),
        metallic=np.zeros((m,), np.float32),
        emission=np.zeros((m, 3), np.float32),
        emissive=np.zeros((m,), bool),
        albedo_tex=np.full((m,), -1, np.int32),
        mtype=np.full((m,), MATERIAL_DIFFUSE_SPECULAR, np.int32),
        ior=np.full((m,), 1.5, np.float32),
        mr_tex=np.full((m,), -1, np.int32),
    )
    for i, mat in enumerate(materials):
        table.albedo[i] = mat.albedo
        table.rough_g[i] = mat.roughness_g
        table.metallic[i] = mat.metallic
        table.emission[i] = mat.emission
        table.emissive[i] = mat.is_emissive
        table.mtype[i] = mat.material_type
        table.ior[i] = mat.ior
        if atlas_slots and mat.albedo_texture in atlas_slots:
            table.albedo_tex[i] = atlas_slots[mat.albedo_texture]
        if atlas_slots and mat.mr_texture in atlas_slots:
            table.mr_tex[i] = atlas_slots[mat.mr_texture]
    return table
