"""Cook-Torrance BSDF evaluation (counterpart of the JAX package's
models/bsdf.py; reference: src/shaders/common/BSDF.glsl:8-21).

specular = F(idm) * D * Vis; diffuse = albedo/pi * (1-metallic)(1-F(ndi))
(1-F(ndo)); zero when either direction dips below the hemisphere.
"""

from __future__ import annotations

import math

import torch

from gpupathtracer_tpu_torch.math.vecmath import dot
from gpupathtracer_tpu_torch.models.interaction import SurfaceInteraction
from gpupathtracer_tpu_torch.models.materials import MaterialInstance
from gpupathtracer_tpu_torch.models.microfacet import (
    diffuse_energy_conservation, distribution, fresnel_schlick,
    visibility_smith)


def compute_bsdf(mat: MaterialInstance, inter: SurfaceInteraction,
                 model: str = "trowbridge_reitz") -> torch.Tensor:
    below = ((dot(inter.normal, inter.incoming) < 0.0)
             | (dot(inter.normal, inter.outgoing) < 0.0))
    specular = (fresnel_schlick(mat.reflectance, inter.idm)
                * distribution(mat, inter, model)[..., None]
                * visibility_smith(mat, inter)[..., None])
    diffuse = mat.albedo / math.pi * diffuse_energy_conservation(mat, inter)
    return torch.where(below[..., None], 0.0, specular + diffuse)


def mis_weight(top, bottom):
    """Balance heuristic (src/shaders/common/MIS.glsl:6-8)."""
    return 1.0 / (1.0 + bottom / torch.clamp_min(top, 1e-30))
