"""Per-lane material instances (counterpart of the JAX package's
models/materials.py; reference: ConstructMaterialInstance,
src/shaders/common/Material.glsl:39-54).

roughness = max(G^2, 1e-4) (the stored G channel is the sqrt of the
TR-GGX roughness), roughness2 = roughness^2, F0 = mix(0.04, albedo,
metallic).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpupathtracer_tpu_torch.ops.texture import sample_atlas


class MaterialInstance(NamedTuple):
    albedo: torch.Tensor       # [N, 3]
    roughness: torch.Tensor    # [N]  (= alpha)
    roughness2: torch.Tensor   # [N]  (= alpha^2)
    metallic: torch.Tensor     # [N]
    reflectance: torch.Tensor  # [N, 3] F0
    emission: torch.Tensor     # [N, 3]


def _bits(col: torch.Tensor) -> torch.Tensor:
    """A float32 column's bits as int32 (the tables store slot ids so)."""
    return col.contiguous().view(torch.int32)


def make_material_instance(row: torch.Tensor, scene=None, uv=None,
                           lod=None) -> MaterialInstance:
    """Material instances from gathered material rows [N, 16] (cols 0:3
    albedo, 3 G-channel roughness, 4 metallic, 5:8 emission, 8 albedo
    slot bits, 9 metallic-roughness slot bits).

    With ``scene`` and ``uv`` [N, 2] the maps are read from the scene's
    atlas: albedo where the row has an albedo slot, and the
    metallic-roughness map's G and B scale roughness and metallic (the glTF
    convention). ``lod`` [N] samples both trilinearly through the mip
    table; without it, level 0 only."""
    albedo = row[:, 0:3]
    g = row[:, 3]
    metallic = row[:, 4]
    if scene is not None and uv is not None:
        mips = scene.atlas_mips if lod is not None else None
        tex = _bits(row[:, 8])
        albedo = torch.where((tex >= 0)[:, None],
                             sample_atlas(scene.atlas_image, scene.atlas_rects,
                                          tex, uv, mips=mips, lod=lod),
                             albedo)
        mr = _bits(row[:, 9])
        mr_rgb = sample_atlas(scene.atlas_image, scene.atlas_rects, mr, uv,
                              mips=mips, lod=lod)
        has_mr = mr >= 0
        g = torch.where(has_mr, g * mr_rgb[:, 1], g)
        metallic = torch.where(has_mr, metallic * mr_rgb[:, 2], metallic)
    roughness = torch.clamp_min(g * g, 1e-4)
    reflectance = (0.04 * (1.0 - metallic[..., None])
                   + albedo * metallic[..., None])
    return MaterialInstance(
        albedo=albedo, roughness=roughness, roughness2=roughness * roughness,
        metallic=metallic, reflectance=reflectance, emission=row[:, 5:8])
