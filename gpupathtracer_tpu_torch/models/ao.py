"""Ambient-occlusion integrator (counterpart of the JAX package's
models/ao.py).

Not in the reference (its debug modes were #define flips and SSBO dumps):
a fast geometry and BVH inspection mode. One closest hit, then one
cosine-sampled occlusion ray of finite radius: 1 where it escapes, 0 where
it is blocked, 1 where the camera ray misses.
"""

from __future__ import annotations

import torch

from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.math.camera import CameraParams, gen_rays
from gpupathtracer_tpu_torch.math.sampling import sample_cosine_hemisphere
from gpupathtracer_tpu_torch.math.vecmath import construct_tbn
from gpupathtracer_tpu_torch.ops.traverse import trace_closest, trace_occluded

T_MAX = 1e20


def render_sample_ao(scene, cam: CameraParams, pixel_x, pixel_y, key,
                     width: int, height: int,
                     stack_depth: int = 48, leaf_size: int = 4,
                     traversal: str = "auto", radius: float = 2.0):
    """One AO sample per pixel lane; returns ([N, 3] grey radiance, int64
    scalar rays traced: the camera rays and the occlusion rays)."""
    n = pixel_x.shape[0]
    dev = pixel_x.device
    key, k_jitter, k_dir = random.split(key, 3)
    jitter = random.uniform(k_jitter, (n, 2))
    interp = (torch.stack([pixel_x, pixel_y], dim=-1) + jitter) \
        / torch.tensor([width, height], dtype=torch.float32, device=dev)
    # A pinhole: no lens sample.
    o, d = gen_rays(cam, interp, torch.zeros((n, 2), dtype=torch.float32,
                                             device=dev))

    depth = dict(stack_depth=stack_depth, leaf_size=leaf_size,
                 traversal=traversal)
    active = torch.ones((n,), dtype=torch.bool, device=dev)
    hit = trace_closest(scene, o, d,
                        torch.full((n,), T_MAX, dtype=torch.float32,
                                   device=dev), active, **depth)
    surf = hit.prim >= 0
    normal = scene.tri_shade[torch.clamp_min(hit.prim, 0).long(), 0:3]
    # Flip toward the viewer so AO works from both sides.
    normal = torch.where(torch.sum(normal * d, dim=-1, keepdim=True) > 0,
                         -normal, normal)
    pos = o + d * hit.t[..., None] + 0.003 * normal

    u = random.uniform(k_dir, (n, 2))
    tangent, bitangent, nn = construct_tbn(normal)
    local = sample_cosine_hemisphere(u)
    ao_dir = (tangent * local[..., 0:1] + bitangent * local[..., 1:2]
              + nn * local[..., 2:3])
    occluded = trace_occluded(scene, pos + 0.001 * normal, ao_dir,
                              torch.full((n,), radius, dtype=torch.float32,
                                         device=dev), surf, **depth)
    # The sky for misses, visibility for surfaces.
    value = torch.where(surf, (~occluded).float(), 1.0)
    rays = torch.sum(active) + torch.sum(surf)
    return value[:, None].repeat(1, 3), rays
