"""Next-event estimation: emitter sampling from the cumulative-area CDF
(counterpart of the JAX package's models/nee.py; reference:
RandomLightVertex + GenerateLightSample, src/shaders/Iterative.comp:34-147).

Scenes with no emitters give totalLightArea = 0, an infinite light pdf and
zero NEE terms, as in the reference. With the sun (the reference's
SUN_LIGHT branch, compiled out there by default) a lane picks the emitter
CDF or the sun 50/50. The sun warps write out with ``fma32`` the fused
multiply-adds that XLA contracts on the CPU, so they round as the JAX
package's do; sin and cos may differ from XLA's in the last place.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from gpupathtracer_tpu_torch.math.sampling import sample_triangle_barycentrics
from gpupathtracer_tpu_torch.math.vecmath import (avdot, construct_tbn, dot,
                                                  normalize, sqrt)
from gpupathtracer_tpu_torch.models.bsdf import compute_bsdf, mis_weight
from gpupathtracer_tpu_torch.models.interaction import (SurfaceInteraction,
                                                        set_incoming)
from gpupathtracer_tpu_torch.models.materials import MaterialInstance
from gpupathtracer_tpu_torch.models.microfacet import pdf_direction
from gpupathtracer_tpu_torch.ops.intersect import fma32


class LightSample(NamedTuple):
    shadow_origin: torch.Tensor   # [N, 3]
    shadow_dir: torch.Tensor      # [N, 3]
    shadow_tmax: torch.Tensor     # [N]
    throughput: torch.Tensor      # [N, 3] (already MIS-weighted, / pdf)
    emission: torch.Tensor        # [N, 3] emitter radiance


def sample_light_vertex(scene, u_select, u_tri):
    """RandomLightVertex (Iterative.comp:34-82): CDF search + sqrt warp.
    Returns (position, normal, emission) from one light_rows gather."""
    selected = u_select * scene.total_light_area
    i = torch.searchsorted(scene.light_cdf, selected, right=True)
    i = torch.clamp(i, 0, scene.light_rows.shape[0] - 1)
    row = scene.light_rows[i]                   # [N, 16]
    p0, e1, e2 = row[..., 0:3], row[..., 3:6], row[..., 6:9]
    _, bv, bt = sample_triangle_barycentrics(u_tri)
    # p0*u + p1*v + p2*t with p1 = p0+e1, p2 = p0+e2 => p0 + e1*v + e2*t.
    pos = p0 + e1 * bv[..., None] + e2 * bt[..., None]
    return pos, row[..., 9:12], row[..., 12:15]


def sample_sun_vertex(scene, vertex_pos, u_disk):
    """RandomSunVertex (Iterative.comp:93-110): a point on a disk of radius
    tan(angular radius) centred one unit along sunDir from the vertex.
    Returns (position, normal), each [N, 3]."""
    n = (-scene.sun_dir).expand(vertex_pos.shape)
    t, b, _ = construct_tbn(n)
    radius = scene.sun_radius * sqrt(u_disk[..., 0])
    phi = 2.0 * math.pi * u_disk[..., 1]
    disk = fma32(b, (radius * torch.sin(phi))[..., None].expand_as(b),
                 t * (radius * torch.cos(phi))[..., None])
    pos = vertex_pos + scene.sun_dir[None, :] + disk
    return pos, n


def sample_sun_cone(scene, shape, u):
    """A uniform direction in the sun's solid-angle cone (half-angle =
    sun_angle): the principled form of the reference's unit-distance disk,
    which it calls "very hacky" (Iterative.comp:84-88). Returns (direction
    toward the sun [*shape], solid-angle pdf, a scalar)."""
    one = torch.ones_like(u[..., 0])
    cos_t = fma32(-u[..., 0], (1.0 - scene.sun_max_dot).expand_as(one), one)
    sin_t = sqrt(torch.clamp_min(fma32(-cos_t, cos_t, one), 0.0))
    phi = 2.0 * math.pi * u[..., 1]
    axis = normalize(scene.sun_dir).expand(shape)
    t, b, n = construct_tbn(axis)
    direction = fma32(n, cos_t[..., None].expand_as(n),
                      fma32(b, (sin_t * torch.sin(phi))[..., None].expand_as(b),
                            t * (sin_t * torch.cos(phi))[..., None]))
    pdf = 1.0 / (2.0 * math.pi
                 * torch.clamp_min(1.0 - scene.sun_max_dot, 1e-12))
    return direction, pdf


def generate_light_sample(scene, vertex_pos, vertex_normal,
                          mat: MaterialInstance, inter: SurfaceInteraction,
                          throughput, u_select, u_tri,
                          model: str = "trowbridge_reitz",
                          sun: bool = False, sun_mode: str = "disk",
                          u_pick=None) -> LightSample:
    """GenerateLightSample (Iterative.comp:113-147): an emitter point, its
    shadow ray, and the MIS-weighted contribution if unoccluded. With
    ``sun``, lanes with ``u_pick`` > 0.5 keep the emitter point (pdf
    0.5/totalLightArea) and the others take the sun: ``sun_mode="disk"``
    the reference's unit-distance disk (pdf 0.5/sunArea), ``"cone"`` the
    true solid angle (``sample_sun_cone``). Sun shadow rays are unbounded
    (t_max 1e20)."""
    if sun and sun_mode not in ("disk", "cone"):
        raise ValueError(f"unknown sun_mode {sun_mode!r}")
    light_pos, light_n, emission = sample_light_vertex(scene, u_select, u_tri)
    delta = light_pos - vertex_pos
    radius = sqrt(torch.clamp_min(dot(delta, delta), 1e-20))
    light_pdf = 1.0 / scene.total_light_area  # inf when no emitters -> NEE = 0
    shadow_tmax = radius - 0.005

    if sun:
        pick_area = u_pick > 0.5  # Iterative.comp:117-118
        if sun_mode == "cone":
            sun_dir, sun_pdf = sample_sun_cone(scene, vertex_pos.shape, u_tri)
            # A pseudo light vertex one unit away, facing back: radius = 1
            # and cos_light = 1, so the area-measure factors below reduce
            # to the solid-angle estimator on the sun lanes.
            sun_pos, sun_n = vertex_pos + sun_dir, -sun_dir
            sun_lane_pdf = 0.5 * sun_pdf
        else:
            sun_pos, sun_n = sample_sun_vertex(scene, vertex_pos, u_tri)
            sun_area = math.pi * scene.sun_radius * scene.sun_radius
            sun_lane_pdf = 0.5 / sun_area
        pick3 = pick_area[..., None]
        light_pos = torch.where(pick3, light_pos, sun_pos)
        light_n = torch.where(pick3, light_n, sun_n)
        emission = torch.where(pick3, emission, scene.sun_emission[None, :])
        delta = light_pos - vertex_pos
        radius = sqrt(torch.clamp_min(dot(delta, delta), 1e-20))
        if sun_mode == "cone":
            radius = torch.where(pick_area, radius, 1.0)
        light_pdf = torch.where(pick_area, 0.5 / scene.total_light_area,
                                sun_lane_pdf)
        shadow_tmax = torch.where(pick_area, radius - 0.005, 1e20)

    light_dir = delta / radius[..., None]
    inter_l = set_incoming(inter, light_dir)
    cos_light = avdot(light_n, -light_dir)
    r2 = radius * radius
    bounce_pdf = pdf_direction(mat, inter_l, model) * cos_light / r2  # Veach eq. 9
    weight = mis_weight(light_pdf, bounce_pdf)
    light_throughput = (throughput * compute_bsdf(mat, inter_l, model)
                        * (inter_l.ndi * cos_light * weight
                           / (light_pdf * r2))[..., None])

    return LightSample(
        shadow_origin=vertex_pos + 0.001 * inter.normal,
        shadow_dir=light_dir,
        shadow_tmax=shadow_tmax,
        throughput=light_throughput,
        emission=emission,
    )
