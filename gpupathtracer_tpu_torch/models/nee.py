"""Next-event estimation: emitter sampling from the cumulative-area CDF
(counterpart of the JAX package's models/nee.py; reference:
RandomLightVertex + GenerateLightSample, src/shaders/Iterative.comp:34-147).

Scenes with no emitters give totalLightArea = 0, an infinite light pdf and
zero NEE terms, as in the reference. The sun branch is not ported yet.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpupathtracer_tpu_torch.math.sampling import sample_triangle_barycentrics
from gpupathtracer_tpu_torch.math.vecmath import avdot, dot, sqrt
from gpupathtracer_tpu_torch.models.bsdf import compute_bsdf, mis_weight
from gpupathtracer_tpu_torch.models.interaction import (SurfaceInteraction,
                                                        set_incoming)
from gpupathtracer_tpu_torch.models.materials import MaterialInstance
from gpupathtracer_tpu_torch.models.microfacet import pdf_direction


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


def generate_light_sample(scene, vertex_pos, vertex_normal,
                          mat: MaterialInstance, inter: SurfaceInteraction,
                          throughput, u_select, u_tri,
                          model: str = "trowbridge_reitz",
                          sun: bool = False) -> LightSample:
    """GenerateLightSample (Iterative.comp:113-147): an emitter point, its
    shadow ray, and the MIS-weighted contribution if unoccluded."""
    if sun:
        raise NotImplementedError("sun NEE is not ported yet "
                                  "(ROADMAP.md, queue A: sun)")
    light_pos, light_n, emission = sample_light_vertex(scene, u_select, u_tri)
    delta = light_pos - vertex_pos
    radius = sqrt(torch.clamp_min(dot(delta, delta), 1e-20))
    light_pdf = 1.0 / scene.total_light_area  # inf when no emitters -> NEE = 0
    shadow_tmax = radius - 0.005

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
