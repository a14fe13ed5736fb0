"""Sampling warps of the wavefront integrator (counterpart of the JAX
package's math/sampling.py).

  - cosine hemisphere: Microfacet.glsl:148-154
  - uniform triangle (sqrt warp): Iterative.comp:66-77
"""

from __future__ import annotations

import math

import torch

from gpupathtracer_tpu_torch.math.vecmath import sqrt

TWO_PI = 2.0 * math.pi


def sample_cosine_hemisphere(u):
    """[..., 2] uniforms -> [..., 3] cosine-weighted direction in the local
    (+z up) frame: radius = sqrt(u0), phi = 2*pi*u1, z = sqrt(1-u0)."""
    r0, r1 = u[..., 0], u[..., 1]
    radius = sqrt(r0)
    phi = TWO_PI * r1
    z = sqrt(torch.clamp_min(1.0 - r0, 0.0))
    return torch.stack([radius * torch.sin(phi), radius * torch.cos(phi), z],
                       dim=-1)


def pdf_cosine_hemisphere(ndi):
    return ndi / math.pi


def sample_triangle_barycentrics(u):
    """[..., 2] -> barycentric weights (u, v, t) via the sqrt warp:
    sr = sqrt(r0); u = 1-sr; v = r1*sr; t = 1-u-v."""
    sr = sqrt(u[..., 0])
    bu = 1.0 - sr
    bv = u[..., 1] * sr
    bt = 1.0 - bu - bv
    return bu, bv, bt
