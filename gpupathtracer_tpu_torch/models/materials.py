"""Per-lane material instances (counterpart of the untextured ``row=``
path of the JAX package's models/materials.py; reference:
ConstructMaterialInstance, src/shaders/common/Material.glsl:39-54).

roughness = max(G^2, 1e-4) (the stored G channel is the sqrt of the
TR-GGX roughness), roughness2 = roughness^2, F0 = mix(0.04, albedo,
metallic).
"""

from __future__ import annotations

from typing import NamedTuple

import torch


class MaterialInstance(NamedTuple):
    albedo: torch.Tensor       # [N, 3]
    roughness: torch.Tensor    # [N]  (= alpha)
    roughness2: torch.Tensor   # [N]  (= alpha^2)
    metallic: torch.Tensor     # [N]
    reflectance: torch.Tensor  # [N, 3] F0
    emission: torch.Tensor     # [N, 3]


def make_material_instance(row: torch.Tensor) -> MaterialInstance:
    """Material instances from gathered material rows [N, 16] (cols 0:3
    albedo, 3 G-channel roughness, 4 metallic, 5:8 emission)."""
    albedo = row[:, 0:3]
    g = row[:, 3]
    metallic = row[:, 4]
    roughness = torch.clamp_min(g * g, 1e-4)
    reflectance = (0.04 * (1.0 - metallic[..., None])
                   + albedo * metallic[..., None])
    return MaterialInstance(
        albedo=albedo, roughness=roughness, roughness2=roughness * roughness,
        metallic=metallic, reflectance=reflectance, emission=row[:, 5:8])
