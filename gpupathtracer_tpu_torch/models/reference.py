"""Ground-truth reference integrator (counterpart of the JAX package's
models/reference.py; reference: the multithreaded CPU renderer,
src/core/Renderer.cpp:996-1071).

Uniform-hemisphere sampling (no NEE, no MIS), the GGX Cook-Torrance BRDF,
termination on an emissive hit or a miss, the optional sun disk on a miss
(dot(dir, sunDir) > sunMaxDot, Renderer.cpp:1016-1021) and Russian
roulette. It converges to the wavefront integrator's image, more slowly,
through far simpler estimator algebra: the independent check the other
integrators are held to.

The JAX package's ``lax.while_loop`` is a host loop here: it runs while a
lane is alive and at most ``max_bounces + 1`` times, splitting the key once
an iteration, so both packages draw the same numbers.
"""

from __future__ import annotations

import math

import torch

from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.math.camera import CameraParams, gen_rays
from gpupathtracer_tpu_torch.math.sampling import sample_uniform_hemisphere
from gpupathtracer_tpu_torch.math.vecmath import construct_tbn, dot
from gpupathtracer_tpu_torch.models.bsdf import compute_bsdf
from gpupathtracer_tpu_torch.models.interaction import (make_interaction,
                                                        set_incoming)
from gpupathtracer_tpu_torch.models.materials import make_material_instance
from gpupathtracer_tpu_torch.models.wavefront import hit_uv
from gpupathtracer_tpu_torch.ops.traverse import trace_closest
from gpupathtracer_tpu_torch.scene.envmap import sample_env

T_MAX = 1e20


def render_sample_reference(scene, cam: CameraParams, pixel_x, pixel_y, key,
                            width: int, height: int,
                            max_bounces: int = 64,
                            stack_depth: int = 48,
                            leaf_size: int = 4,
                            model: str = "trowbridge_reitz",
                            traversal: str = "auto",
                            textured: bool = False,
                            sun: bool = False):
    """One uniform-hemisphere path per lane; returns [N, 3] radiance.
    ``textured`` reads albedo and metallic-roughness maps at level 0 (the
    reference integrator takes no mip level); ``sun`` adds the sun disk to
    the sky a path escapes to."""
    n = pixel_x.shape[0]
    dev = pixel_x.device
    key, k_jitter, k_lens = random.split(key, 3)
    jitter = random.uniform(k_jitter, (n, 2))
    interp = (torch.stack([pixel_x, pixel_y], dim=-1) + jitter) \
        / torch.tensor([width, height], dtype=torch.float32, device=dev)
    lens_u = random.uniform(k_lens, (n, 2))
    o, d = gen_rays(cam, interp, lens_u)

    throughput = torch.ones((n, 3), dtype=torch.float32, device=dev)
    radiance = torch.zeros((n, 3), dtype=torch.float32, device=dev)
    alive = torch.ones((n,), dtype=torch.bool, device=dev)
    emissive_mat = torch.sum(scene.mat_rows[:, 5:8], dim=-1) > 1e-5
    t_max = torch.full((n,), T_MAX, dtype=torch.float32, device=dev)

    i = 0
    while i <= max_bounces and bool(torch.any(alive)):
        key, k = random.split(key)
        rnd = random.uniform(k, (n, 3))

        hit = trace_closest(scene, o, d, t_max, alive,
                            stack_depth=stack_depth, leaf_size=leaf_size,
                            traversal=traversal)
        miss = hit.prim < 0
        shade = scene.tri_shade[torch.clamp_min(hit.prim, 0).long()]
        normal = shade[:, 0:3]
        mat_id = torch.where(miss, 0, shade[:, 9].contiguous().view(
            torch.int32)).long()
        row = scene.mat_rows[mat_id]

        # An emitter or the sky ends the path (Renderer.cpp:1014-1030).
        is_emitter = miss | emissive_mat[mat_id]
        env_emission = sample_env(scene.env, d)
        if sun:
            in_disk = torch.sum(d * scene.sun_dir[None, :], dim=-1) \
                > scene.sun_max_dot
            env_emission = env_emission + torch.where(
                in_disk[..., None], scene.sun_emission[None, :], 0.0)
        emission = torch.where(miss[..., None], env_emission, row[:, 5:8])
        radiance = radiance + torch.where((alive & is_emitter)[..., None],
                                          throughput * emission, 0.0)
        alive = alive & ~is_emitter

        # Bounce: uniform hemisphere (Renderer.cpp:1040-1043).
        pos = o + d * hit.t[..., None] + 0.001 * normal
        tangent, bitangent, nn = construct_tbn(normal)
        local = sample_uniform_hemisphere(rnd[:, 0:2])
        new_d = (tangent * local[..., 0:1] + bitangent * local[..., 1:2]
                 + nn * local[..., 2:3])
        if textured:
            mat = make_material_instance(row, scene, hit_uv(shade, hit))
        else:
            mat = make_material_instance(row)
        inter = set_incoming(make_interaction(normal, -d), new_d)
        # throughput *= BRDF * 2 pi * ndl (the uniform hemisphere's pdf is
        # 1/(2 pi), Renderer.cpp:1052).
        ndl = torch.clamp_min(dot(normal, new_d), 0.0)
        throughput = (throughput * compute_bsdf(mat, inter, model)
                      * (2.0 * math.pi * ndl)[..., None])

        rr = torch.clamp(torch.amax(throughput, dim=-1), 0.0, 1.0)
        kill = rnd[:, 2] > rr
        throughput = throughput / torch.clamp_min(rr, 1e-12)[..., None]
        alive = alive & ~kill
        o, d = pos, new_d
        i += 1
    return radiance
