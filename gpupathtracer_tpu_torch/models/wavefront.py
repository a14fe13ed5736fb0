"""Wavefront path-tracing integrator (counterpart of the JAX package's
models/wavefront.py; reference: the megakernel of
src/shaders/Iterative.comp:214-307).

The sample wavefront advances bounce by bounce in a host loop over [N]
tensors; dead lanes are masked, and bounce-epoch compaction gathers the
survivors into narrower wavefronts as paths die. Estimator semantics are
the JAX package's, term by term:

  - thin-lens primary rays with pixel jitter (InitRay, Iterative.comp:185-196)
  - emissive/env accumulation with the MIS throughput rewrite for i>0 hits
    (Iterative.comp:246-259, neePdf = 0.5/totalLightArea)
  - NEE shadow ray + balance-heuristic weight (GenerateLightSample)
  - two-lobe BSDF importance sampling (Iterative.comp:282-284)
  - Russian roulette with luminance clamp + bounce cap (291-300)

Random numbers are the JAX package's threefry streams (random.py), keyed
by (seed, sample, chunk, bounce) the same way, so both packages draw the
same numbers for the same pixel lanes.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.math.camera import CameraParams, gen_rays
from gpupathtracer_tpu_torch.math.vecmath import avdot, dot
from gpupathtracer_tpu_torch.models.bsdf import compute_bsdf, mis_weight
from gpupathtracer_tpu_torch.models.interaction import make_interaction
from gpupathtracer_tpu_torch.models.materials import make_material_instance
from gpupathtracer_tpu_torch.models.microfacet import generate_importance_sample
from gpupathtracer_tpu_torch.models.nee import generate_light_sample
from gpupathtracer_tpu_torch.ops.traverse import trace_closest, trace_occluded
from gpupathtracer_tpu_torch.scene.envmap import sample_env

T_MAX = 1e20


class Carry(NamedTuple):
    i: int
    key: torch.Tensor
    o: torch.Tensor
    d: torch.Tensor
    throughput: torch.Tensor
    contribution: torch.Tensor
    pdf0: torch.Tensor
    pdf1: torch.Tensor
    last_pos: torch.Tensor
    alive: torch.Tensor
    rays: torch.Tensor


def _reject_unported(**flags) -> None:
    for name, on in flags.items():
        if on:
            raise NotImplementedError(
                f"{name} is not ported yet (ROADMAP.md, queue A)")


def render_sample_impl(scene, cam: CameraParams, pixel_x, pixel_y, key,
                       width: int, height: int,
                       model: str = "trowbridge_reitz",
                       max_bounces: int = 64,
                       stack_depth: int = 48,
                       leaf_size: int = 4,
                       nee: bool = True,
                       traversal: str = "auto",
                       textured: bool = False,
                       mips: bool = False,
                       sun: bool = False,
                       sort_rays: bool = False,
                       shadow_rev: bool = False,
                       delta: bool = False,
                       compaction: bool = True,
                       compaction_divs: tuple = (2, 4, 8, 16, 32, 64, 128),
                       compaction_min: int = 2048,
                       sampler: str = "random",
                       partition=None):
    """Trace one sample for each pixel lane.

    Args:
      scene: SceneData (tensors on one device).
      cam: CameraParams on the same device.
      pixel_x, pixel_y: [N] float32 pixel coordinates of each lane.
      key: [2] threefry key for this (sample, chunk).
    Shadow rays all go to the one any-hit kernel: the JAX package's
    fused-pair schedule gives the same hits, so it has no option here.
    Returns ([N, 3] radiance contributions, int64 scalar rays traced).
    """
    _reject_unported(textured=textured, mips=mips, sun=sun,
                     sort_rays=sort_rays, shadow_rev=shadow_rev, delta=delta,
                     partition=partition is not None,
                     sampler_ld=sampler == "ld")
    if sampler != "random":
        raise ValueError(f"unknown sampler {sampler!r}")
    n = pixel_x.shape[0]
    dev = pixel_x.device
    trace = dict(stack_depth=stack_depth, leaf_size=leaf_size,
                 traversal=traversal)

    key, k_jitter, k_lens = random.split(key, 3)
    jitter = random.uniform(k_jitter, (n, 2))
    interp = (torch.stack([pixel_x, pixel_y], dim=-1) + jitter) \
        / torch.tensor([width, height], dtype=torch.float32, device=dev)
    lens_u = random.uniform(k_lens, (n, 2))
    ray_o, ray_d = gen_rays(cam, interp, lens_u)

    nee_pdf = 0.5 / scene.total_light_area  # InitRay, Iterative.comp:203

    def body(c: Carry) -> Carry:
        nw = c.o.shape[0]  # current (phase) wavefront width
        key, k = random.split(c.key)
        rnd = random.uniform(k, (nw, 9))
        rays = c.rays + torch.sum(c.alive)

        t_max_full = torch.full((nw,), T_MAX, dtype=torch.float32, device=dev)
        hit = trace_closest(scene, c.o, c.d, t_max_full, c.alive, **trace)
        miss = hit.prim < 0
        # Miss lanes read triangle 0's row; every use is masked below.
        shade = scene.tri_shade[torch.clamp_min(hit.prim, 0).long()]
        normal = shade[:, 0:3]
        pos = c.o + c.d * hit.t[..., None] + 0.003 * normal
        mat = make_material_instance(shade[:, 16:32])
        view_dir = -c.d
        inter = make_interaction(normal, view_dir)

        # --- L_e accumulation with MIS rewrite (Iterative.comp:246-259) ---
        emission = torch.where(miss[..., None], sample_env(scene.env, c.d),
                               mat.emission)
        dvec = c.last_pos - pos
        dist2 = torch.clamp_min(dot(dvec, dvec), 1e-12)
        old_mis = mis_weight(c.pdf0, c.pdf1)
        factor = 0.5 * avdot(normal, view_dir) / dist2
        p0n = c.pdf0 * factor
        p1n = c.pdf1 * factor
        idt_scale = p0n / (p0n + p1n + nee_pdf) / torch.clamp_min(old_mis, 1e-30)
        # Without NEE the carried throughput is already the full estimator.
        use_rewrite = (~miss) & (c.i != 0) & nee
        idt = c.throughput * torch.where(use_rewrite, idt_scale, 1.0)[..., None]
        contribution = c.contribution + torch.where(
            c.alive[..., None], idt * emission, 0.0)

        alive = c.alive & ~miss

        # --- NEE (Iterative.comp:272-280) ---
        if nee:
            ls = generate_light_sample(scene, pos, normal, mat, inter,
                                       c.throughput, rnd[:, 0], rnd[:, 1:3],
                                       model)
            # Lanes whose light sample is exactly zero read 0 whatever the
            # occlusion, so leaving them out of the trace is exact.
            light = ls.throughput * ls.emission
            shadow_live = alive & torch.any(light != 0.0, dim=-1)
            rays = rays + torch.sum(shadow_live)
            occluded = trace_occluded(scene, ls.shadow_origin, ls.shadow_dir,
                                      ls.shadow_tmax, shadow_live, **trace)
            contribution = contribution + torch.where(
                (shadow_live & ~occluded)[..., None], light, 0.0)

        if max_bounces == 0:
            # Pure direct lighting: no path continues past this bounce.
            return c._replace(i=c.i + 1, key=key, o=pos,
                              contribution=contribution, last_pos=pos,
                              alive=torch.zeros_like(alive), rays=rays)

        # --- BSDF sampling + throughput update (Iterative.comp:282-284) ---
        inter_b, pdf0, pdf1 = generate_importance_sample(
            mat, inter, rnd[:, 3], rnd[:, 4:6], model)
        throughput = (c.throughput * compute_bsdf(mat, inter_b, model)
                      * (inter_b.ndi * mis_weight(pdf0, pdf1)
                         / torch.clamp_min(pdf0, 1e-30))[..., None])

        # --- Russian roulette (Iterative.comp:291-300) ---
        continuation = torch.clamp(torch.amax(throughput, dim=-1), 0.0, 1.0)
        throughput = throughput / torch.clamp_min(continuation, 1e-12)[..., None]
        kill = (rnd[:, 6] > continuation) | (c.i > max_bounces)
        return Carry(i=c.i + 1, key=key, o=pos, d=inter_b.incoming,
                     throughput=throughput, contribution=contribution,
                     pdf0=pdf0, pdf1=pdf1, last_pos=pos, alive=alive & ~kill,
                     rays=rays)

    # --- Bounce-epoch live-path compaction --------------------------------
    # Run at full width while many paths live, then gather survivors into
    # narrower wavefronts. Unbiased: a phase ends only once the live count
    # fits the next width, and every survivor continues there.
    widths = [n]
    if compaction and max_bounces > 0:
        for div in compaction_divs:
            wn = max(n // div, compaction_min)
            if wn < widths[-1]:
                widths.append(wn)

    total = None
    src = None  # compacted lane -> film lane; None while at full width
    c = body(Carry(
        i=0, key=key, o=ray_o, d=ray_d,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        contribution=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        pdf0=torch.ones((n,), dtype=torch.float32, device=dev),
        pdf1=torch.ones((n,), dtype=torch.float32, device=dev),
        last_pos=ray_o, alive=torch.ones((n,), dtype=torch.bool, device=dev),
        rays=torch.zeros((), dtype=torch.int64, device=dev)))
    for j in range(len(widths)):
        nxt = widths[j + 1] if j + 1 < len(widths) else None
        while c.i <= max_bounces + 1:
            live = int(torch.sum(c.alive))
            if live == 0 or (nxt is not None and live <= nxt):
                break
            c = body(c)
        # Fold this phase's contributions back into film-lane space.
        if src is None:
            total = c.contribution
        else:
            total = total.index_add(0, src, c.contribution)
        if nxt is not None:
            # Alive lanes first, in lane order.
            order = torch.argsort((~c.alive).to(torch.uint8), stable=True)[:nxt]
            src = order if src is None else src[order]
            c = Carry(i=c.i, key=c.key, o=c.o[order], d=c.d[order],
                      throughput=c.throughput[order],
                      contribution=torch.zeros((nxt, 3), dtype=torch.float32,
                                               device=dev),
                      pdf0=c.pdf0[order], pdf1=c.pdf1[order],
                      last_pos=c.last_pos[order], alive=c.alive[order],
                      rays=c.rays)
    return total, c.rays


def render_sample_batch(scene, cam, pixel_x, pixel_y, key, spp: int = 1,
                        **statics):
    """spp samples per pixel in one call: sample i uses fold_in(key, i)."""
    n = pixel_x.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=pixel_x.device)
    rays = torch.zeros((), dtype=torch.int64, device=pixel_x.device)
    for i in range(spp):
        c, r = render_sample_impl(scene, cam, pixel_x, pixel_y,
                                  random.fold_in(key, i), **statics)
        acc = acc + c
        rays = rays + r
    return acc, rays
