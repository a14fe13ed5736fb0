"""Microfacet library: distributions, importance samplers, PDFs, Fresnel,
visibility and the two-lobe (diffuse/specular) sampling strategy
(counterpart of the JAX package's models/microfacet.py; reference:
src/shaders/common/Microfacet.glsl, idiosyncrasies replicated).

Models: Trowbridge-Reitz (GGX, default), Beckmann, Blinn-Phong.
"""

from __future__ import annotations

import math
from typing import Tuple

import numpy as np
import torch

from gpupathtracer_tpu_torch.math.sampling import (pdf_cosine_hemisphere,
                                                   sample_cosine_hemisphere)
from gpupathtracer_tpu_torch.math.vecmath import luminance, sqrt
from gpupathtracer_tpu_torch.models.interaction import (SurfaceInteraction,
                                                        set_incoming, to_world)
from gpupathtracer_tpu_torch.models.materials import MaterialInstance

PI = math.pi
# sqrt(pi) as the JAX package computes it: float32 sqrt of float32 pi.
SQRT_PI = float(np.sqrt(np.float32(PI)))


def _pow5(x):
    """x ** 5 by the squarings jax.lax.integer_pow uses: x * (x^2)^2."""
    x2 = x * x
    return x * (x2 * x2)


# --- Distributions (D) -------------------------------------------------------

def distribution_trowbridge_reitz(mat: MaterialInstance, inter: SurfaceInteraction):
    """Microfacet.glsl:13-16."""
    divisor = (mat.roughness2 - 1.0) * inter.ndm2 + 1.0
    return mat.roughness2 / torch.clamp_min(PI * divisor * divisor, 1e-20)


def distribution_beckmann(mat: MaterialInstance, inter: SurfaceInteraction):
    """Microfacet.glsl:35-39 (log-space normalization)."""
    sub = 2.0 * torch.log(SQRT_PI * mat.roughness
                          * torch.clamp_min(inter.ndm, 1e-8))
    add = (inter.ndm2 - 1.0) / torch.clamp_min(inter.ndm2 * mat.roughness2,
                                               1e-20)
    return torch.exp(add - sub)


def _blinn_phong_n(mat: MaterialInstance):
    """ConvertBeckmannToBlinnPhong (Microfacet.glsl:59-61)."""
    return 2.0 / mat.roughness - 2.0


def distribution_blinn_phong(mat: MaterialInstance, inter: SurfaceInteraction):
    n = _blinn_phong_n(mat)
    return (n + 1.0) / (2.0 * PI) * torch.clamp_min(inter.ndm, 0.0) ** n


# --- Importance samplers (return a half vector in tangent space) -------------

def _half_vector(z, z2, r1):
    phi = 2.0 * PI * r1
    radius = sqrt(torch.clamp_min(1.0 - z2, 0.0))
    return torch.stack([radius * torch.sin(phi), radius * torch.cos(phi), z],
                       dim=-1)


def sample_trowbridge_reitz(mat: MaterialInstance, u):
    """Microfacet.glsl:19-26."""
    r0, r1 = u[..., 0], u[..., 1]
    z2 = torch.clamp_min((1.0 - r0) / (r0 * (mat.roughness2 - 1.0) + 1.0), 0.0)
    return _half_vector(sqrt(z2), z2, r1)


def sample_beckmann(mat: MaterialInstance, u):
    """Microfacet.glsl:42-50 (Walter et al. eqs 28-29)."""
    r0, r1 = u[..., 0], u[..., 1]
    g = -mat.roughness2 * torch.log(torch.clamp_min(1.0 - r0, 1e-20))
    z2 = 1.0 / (1.0 + g)
    return _half_vector(sqrt(z2), z2, r1)


def sample_blinn_phong(mat: MaterialInstance, u):
    """Microfacet.glsl:72-80."""
    n = _blinn_phong_n(mat)
    r0, r1 = u[..., 0], u[..., 1]
    z = r0 ** (1.0 / (n + 1.0))
    return _half_vector(z, z * z, r1)


_MODELS = {
    "trowbridge_reitz": (distribution_trowbridge_reitz, sample_trowbridge_reitz),
    "beckmann": (distribution_beckmann, sample_beckmann),
    "blinn_phong": (distribution_blinn_phong, sample_blinn_phong),
}


def distribution(mat, inter, model: str = "trowbridge_reitz"):
    return _MODELS[model][0](mat, inter)


def sample_microfacet(mat, u, model: str = "trowbridge_reitz"):
    return _MODELS[model][1](mat, u)


def pdf_microfacet(mat, inter, model: str = "trowbridge_reitz"):
    """ProbabilityDensity* (Microfacet.glsl:29-31): D * ndm / (4 * idm)."""
    return torch.clamp_min(
        distribution(mat, inter, model) * inter.ndm
        / torch.clamp_min(4.0 * inter.idm, 1e-20), 1e-10)


# --- Fresnel / visibility / energy conservation ------------------------------

def fresnel_schlick(f0, cos_theta):
    """Microfacet.glsl:96-101. f0 [...,3], cos_theta [...]."""
    x = 1.0 - cos_theta[..., None]
    return f0 + (1.0 - f0) * _pow5(x)


def _visibility_ggx(mat: MaterialInstance, ndx):
    """Microfacet.glsl:117-119, verbatim (incl. the a2*(1-a2) term)."""
    return 1.0 / torch.clamp_min(
        ndx + sqrt(mat.roughness2 * (1.0 - mat.roughness2) * ndx * ndx),
        1e-5)


def visibility_smith(mat: MaterialInstance, inter: SurfaceInteraction):
    """Microfacet.glsl:121-123: V(ndi) * V(ndo) / 4."""
    return _visibility_ggx(mat, inter.ndi) * _visibility_ggx(mat, inter.ndo) / 4.0


def diffuse_energy_conservation(mat: MaterialInstance, inter: SurfaceInteraction):
    """(1-metallic)(1-F(ndi))(1-F(ndo)) (Microfacet.glsl:140-142)."""
    return ((1.0 - mat.metallic[..., None])
            * (1.0 - fresnel_schlick(mat.reflectance, inter.ndi))
            * (1.0 - fresnel_schlick(mat.reflectance, inter.ndo)))


def calc_diffuse_pmf(mat: MaterialInstance, inter: SurfaceInteraction):
    """CalcDiffusePmf (Microfacet.glsl:156-161): evaluated at ndi = 0.5;
    the reference returns the *unmixed* diffuse energy, replicated."""
    fake = inter._replace(ndi=torch.full_like(inter.ndo, 0.5))
    return torch.clamp(luminance(diffuse_energy_conservation(mat, fake)),
                       0.0, 1.0)


def pdf_direction(mat: MaterialInstance, inter: SurfaceInteraction,
                  model: str = "trowbridge_reitz"):
    """ProbabilityDensityDirection (Microfacet.glsl:163-170): lobe-mixture pdf."""
    diffuse_pmf = calc_diffuse_pmf(mat, inter)
    specular_pmf = 1.0 - diffuse_pmf
    return (diffuse_pmf * pdf_cosine_hemisphere(inter.ndi)
            + specular_pmf * pdf_microfacet(mat, inter, model))


def generate_importance_sample(
        mat: MaterialInstance, inter: SurfaceInteraction,
        u_choice, u_sample, model: str = "trowbridge_reitz",
) -> Tuple[SurfaceInteraction, torch.Tensor, torch.Tensor]:
    """GenerateImportanceSample (Microfacet.glsl:172-193).

    Picks the diffuse lobe with probability CalcDiffusePmf, else samples
    the microfacet distribution and reflects. Returns (interaction with
    incoming, pdf_sample, pdf_mis): the chosen lobe's weighted pdf and the
    other lobe's, both at the final direction.
    """
    diffuse_pmf = calc_diffuse_pmf(mat, inter)
    pick_diffuse = u_choice < diffuse_pmf

    dir_diffuse = to_world(inter, sample_cosine_hemisphere(u_sample))
    m = to_world(inter, sample_microfacet(mat, u_sample, model))
    # reflect(-outgoing, m) (Material.glsl:124)
    dir_specular = (2.0 * torch.sum(inter.outgoing * m, dim=-1, keepdim=True)
                    * m - inter.outgoing)

    incoming = torch.where(pick_diffuse[..., None], dir_diffuse, dir_specular)
    inter = set_incoming(inter, incoming)

    specular_pmf = 1.0 - diffuse_pmf
    pdf_diffuse = diffuse_pmf * pdf_cosine_hemisphere(inter.ndi)
    pdf_specular = specular_pmf * pdf_microfacet(mat, inter, model)
    pdf_sample = torch.where(pick_diffuse, pdf_diffuse, pdf_specular)
    pdf_mis = torch.where(pick_diffuse, pdf_specular, pdf_diffuse)
    return inter, pdf_sample, pdf_mis
