"""Sampling warps of the integrators (counterpart of the JAX
package's math/sampling.py).

  - cosine hemisphere: Microfacet.glsl:148-154
  - uniform hemisphere: Renderer.cpp:1040-1043 (the reference integrator)
  - uniform triangle (sqrt warp): Iterative.comp:66-77
  - the low-discrepancy sequences of the ``ld`` sampler: R2, a per-pixel
    rotation, the golden-ratio and van der Corput sequences
    (Renderer.cpp:784-887)
"""

from __future__ import annotations

import math

import numpy as np
import torch

from gpupathtracer_tpu_torch.math.vecmath import sqrt
from gpupathtracer_tpu_torch.ops.intersect import fma32

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


def sample_uniform_hemisphere(u):
    """[..., 2] uniforms -> [..., 3] uniform direction in the local (+z up)
    hemisphere: z = u0, phi = 2*pi*u1. pdf = 1/(2*pi). 1 - z^2 is one
    fused multiply-add, as XLA contracts it on the CPU."""
    r0, r1 = u[..., 0], u[..., 1]
    z = r0
    radius = sqrt(torch.clamp_min(fma32(-z, z, torch.ones_like(z)), 0.0))
    phi = TWO_PI * r1
    return torch.stack([radius * torch.cos(phi), radius * torch.sin(phi), z],
                       dim=-1)


def sample_triangle_barycentrics(u):
    """[..., 2] -> barycentric weights (u, v, t) via the sqrt warp:
    sr = sqrt(r0); u = 1-sr; v = r1*sr; t = 1-u-v."""
    sr = sqrt(u[..., 0])
    bu = 1.0 - sr
    bv = u[..., 1] * sr
    bt = 1.0 - bu - bv
    return bu, bv, bt


# --- Low-discrepancy machinery (role of Renderer.cpp:784-887 experiments) ---
# torch has no uint32 arithmetic on the card, so the 32-bit integer steps
# run in int64: a product of two 32-bit values wraps past 2^63, and two's
# complement keeps its low 32 bits right; each product and xor is masked to
# 32 bits before the next shift.

GOLDEN_RATIO_CONJUGATE = 0.6180339887498949
_MASK32 = 0xFFFFFFFF
# 2^32 / g and 2^32 / g^2 of the generalized golden ratio g (Roberts 2018).
_R2_ALPHA = (3242174889, 2447445413)
# 2^-24: the top 24 bits of a 32-bit value, times this, are exact in
# float32 and lie in [0, 1).
_INV_2_24 = 1.0 / 16777216.0


def _u32(x, device=None):
    return torch.as_tensor(x, device=device).to(torch.int64) & _MASK32


def golden_ratio_sequence(n: int, offset: float = 0.0, device=None):
    """1D golden-ratio additive sequence (Renderer.cpp:784-812)."""
    i = torch.arange(n, dtype=torch.float32, device=device)
    return torch.remainder(offset + (i + 1) * GOLDEN_RATIO_CONJUGATE, 1.0)


def r2_sequence(sample_idx, device=None):
    """The 2D R2 additive low-discrepancy point of a sample index, [..., 2]
    in [0, 1): ((idx + 1) * alpha mod 2^32) >> 8, times 2^-24. The integer
    recurrence keeps every fractional bit where float32 multiply-mod loses
    them past ~10^4 samples, and the 24-bit truncation keeps values within
    128 of 2^32 from rounding up to 1.0."""
    s = (_u32(sample_idx, device) + 1) & _MASK32
    a = torch.tensor(_R2_ALPHA, dtype=torch.int64, device=s.device)
    v = (s[..., None] * a) & _MASK32
    return (v >> 8).to(torch.float32) * _INV_2_24


def _lowbias32(v):
    v = v ^ (v >> 16)
    v = (v * 0x7FEB352D) & _MASK32
    v = v ^ (v >> 15)
    v = (v * 0x846CA68B) & _MASK32
    return v ^ (v >> 16)


def pixel_rotation(pixel_ids):
    """Per-pixel Cranley-Patterson rotation [..., 2] in [0, 1) from a
    lowbias32-style integer hash of the pixel id (and of the id xor
    0x9E3779B9): decorrelates the shared LD point across pixels."""
    x = _u32(pixel_ids)
    h1 = _lowbias32(x)
    h2 = _lowbias32(x ^ 0x9E3779B9)
    return torch.stack([(h1 >> 8).to(torch.float32) * _INV_2_24,
                        (h2 >> 8).to(torch.float32) * _INV_2_24], dim=-1)


def van_der_corput(i, base: int = 2, bits: int = 24):
    """Radical inverse of the integers ``i`` in ``base``, float32
    (Renderer.cpp:848-871). Each digit's weight base^-k is carried in
    float64 and rounded to float32 where it is used."""
    i = _u32(i)
    result = torch.zeros(i.shape, dtype=torch.float32, device=i.device)
    inv_base = 1.0 / base
    digit_scale = inv_base
    for _ in range(bits):
        digit = (i % base).to(torch.float32)
        result = result + digit * float(np.float32(digit_scale))
        i = i // base
        digit_scale = digit_scale * inv_base
    return result
