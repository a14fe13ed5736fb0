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
  - optional sun NEE (disk or cone), and textured albedo and
    metallic-roughness maps, trilinear with a ray-cone mip level
  - delta materials: perfect mirrors and Snell + Schlick glass
  - options that change no hit: bounce rays sorted by direction octant and
    origin cell before their trace (``sort_rays``), and shadow rays traced
    from the light end (``shadow_rev``)
  - the ``ld`` sampler's pixel jitter: an R2 point per sample index, rotated
    per pixel

Random numbers are the JAX package's threefry streams (random.py), keyed
by (seed, sample, chunk, bounce) the same way, so both packages draw the
same numbers for the same pixel lanes.
"""

from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.math.camera import CameraParams, gen_rays
from gpupathtracer_tpu_torch.math.sampling import pixel_rotation, r2_sequence
from gpupathtracer_tpu_torch.math.vecmath import avdot, dot, length, sqrt
from gpupathtracer_tpu_torch.models.bsdf import compute_bsdf, mis_weight
from gpupathtracer_tpu_torch.models.interaction import make_interaction
from gpupathtracer_tpu_torch.models.materials import make_material_instance
from gpupathtracer_tpu_torch.models.microfacet import generate_importance_sample
from gpupathtracer_tpu_torch.models.nee import generate_light_sample
from gpupathtracer_tpu_torch.ops.intersect import fma32
from gpupathtracer_tpu_torch.ops.traverse import (Hit, trace_closest,
                                                  trace_occluded)
from gpupathtracer_tpu_torch.ops.tsort import (_sort_perm,
                                               trace_closest_tsort,
                                               trace_occluded_tsort)
from gpupathtracer_tpu_torch.scene.envmap import sample_env

T_MAX = 1e20

# None counts nothing. Set to {"hits": 0, "delta": 0} to have delta-material
# renders add, each bounce, the lanes that hit a surface and those of them on
# a mirror or glass (host integers: two host reads a bounce while it is set).
DELTA_LANES = None


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
    # The last bounce's treelet-sort permutation (tsort_alternate), else None.
    perm: Optional[torch.Tensor] = None


def hit_uv(shade, hit):
    """The hit's texture coordinate [N, 2] from the shading rows' three
    vertex uvs (cols 3:9) and the barycentrics, with the multiply-adds XLA
    contracts on the CPU: uv1 * u + uv2 * v + uv0 * (1 - u - v)."""
    w = (1.0 - hit.u - hit.v)[..., None].expand(-1, 2)
    return fma32(shade[:, 3:5], w,
                 fma32(shade[:, 7:9], hit.v[..., None].expand(-1, 2),
                       shade[:, 5:7] * hit.u[..., None]))


def pixel_cone_angle(cam: CameraParams, height: int):
    """The angular width of one pixel, the ray-cone LOD's input, recovered
    from the camera basis: |vertical| = 2 tan(fov/2) * focal_dist, and
    focal_dist = |lower_left + h/2 + v/2| since |direction| = 1."""
    fd = length(cam.lower_left + 0.5 * cam.horizontal + 0.5 * cam.vertical)
    return length(cam.vertical) / (torch.clamp_min(fd, 1e-6) * height)


def ld_jitter(pixel_x, pixel_y, width: int, sample_idx):
    """The ``ld`` sampler's [N, 2] pixel jitter (Cranley-Patterson): the R2
    point of ``sample_idx``, shared by every pixel, rotated by a hash of
    the pixel id py * width + px, mod 1."""
    rot = pixel_rotation(pixel_y.to(torch.int64) * width
                         + pixel_x.to(torch.int64))
    return torch.remainder(r2_sequence(sample_idx, pixel_x.device)[None]
                           + rot, 1.0)


def root_box(scene):
    """The union of the root's child boxes, (lo [3], hi [3]), from node row 0
    (``scene.arity`` children of 6 bounds each; empty slots hold +inf /
    -inf bounds and widen nothing)."""
    b = scene.node_rows[0, :6 * scene.arity].reshape(scene.arity, 6)
    return torch.amin(b[:, 0:3], dim=0), torch.amax(b[:, 3:6], dim=0)


def ray_sort_perm(o, d, alive, root_lo, inv_extent):
    """The bounce wavefront's coherence order: a stable argsort of dead
    lanes last (key 1 << 20), then the direction octant * 512, then an 8^3
    origin cell in the root's box."""
    octant = ((d[:, 0] > 0).to(torch.int32)
              + 2 * (d[:, 1] > 0).to(torch.int32)
              + 4 * (d[:, 2] > 0).to(torch.int32))
    cell_f = torch.clamp((o - root_lo) * inv_extent, 0.0, 0.999) * 8.0
    cell_i = cell_f.to(torch.int32)
    cell = cell_i[:, 0] * 64 + cell_i[:, 1] * 8 + cell_i[:, 2]
    key = torch.where(alive, octant * 512 + cell, 1 << 20)
    return torch.argsort(key, stable=True)


def reverse_segments(so, sd, st_):
    """Shadow rays from the light end: a finite segment (t_max < 1e19)
    starts at so + sd * t_max (one multiply-add, as XLA contracts it) and
    runs along -sd; sun rays keep the forward form. Occlusion is symmetric
    in the segment."""
    finite = (st_ < 1e19)[:, None]
    end = fma32(sd, st_[:, None].expand_as(sd), so)
    return torch.where(finite, end, so), torch.where(finite, -sd, sd)


def dot3(a, b):
    """[N] dot products of [N, 3] rows with XLA's CPU contraction under jit:
    fma(a2, b2, fma(a1, b1, a0 * b0))."""
    return fma32(a[:, 2], b[:, 2], fma32(a[:, 1], b[:, 1], a[:, 0] * b[:, 0]))


def delta_bounce(d, pos, normal, mrow, u_fresnel, is_mirror, is_glass,
                 delta_throughput, new_d, throughput, pdf0, pdf1):
    """Continue mirror and glass lanes (the others keep the sampled
    ``new_d``, ``throughput`` and pdfs): a mirror reflects d about the
    geometric normal; glass (ior in material column 11) reflects with
    Schlick's Fresnel probability, chosen by ``u_fresnel``, or on total
    internal reflection, and refracts otherwise. Delta lanes carry
    ``delta_throughput`` (throughput * albedo; the choice is one-sample with
    weight 1) and pdfs (1e8, 0), which make the next hit's emission MIS
    weight about 1. Transmitted lanes continue from pos - 0.006 * normal,
    the far side of the surface (pos carries +0.003 * normal). Returns
    (origin, direction, throughput, pdf0, pdf1).

    The multiply-adds are fused where XLA contracts them on the CPU under
    jit (n.d as fma(n2, d2, fma(n1, d1, n0 d0)), the reflections, 1 - eta^2
    (1 - ci^2), the refraction and the step across), so the lanes are the
    JAX package's bit for bit (tests/test_torch_delta.py)."""
    one = torch.ones_like(pdf0)
    ndd = dot3(normal, d)[:, None]
    mir_dir = fma32(-2.0 * ndd.expand_as(d), normal, d)
    ior = mrow[:, 11]
    cosi = -ndd[:, 0]
    entering = cosi >= 0.0
    n_eff = torch.where(entering[:, None], normal, -normal)
    ci = torch.abs(cosi)
    eta = torch.where(entering, 1.0 / ior, ior)
    k = fma32(-(eta * eta), fma32(-ci, ci, one), one)
    tir = k < 0.0
    # ((ior - 1) / (ior + 1))^2 and (1 - ci)^5 as the product chains of
    # XLA's integer powers (torch.pow rounds otherwise).
    r0 = (ior - 1.0) / (ior + 1.0)
    f0 = r0 * r0
    m = 1.0 - ci
    m2 = m * m
    fres = fma32(1.0 - f0, m * (m2 * m2), f0)
    choose_reflect = tir | (u_fresnel < fres)
    refl_dir = fma32((2.0 * ci)[:, None].expand_as(d), n_eff, d)
    a = fma32(eta, ci, -sqrt(torch.clamp_min(k, 0.0)))
    refr_dir = fma32(eta[:, None].expand_as(d), d, a[:, None] * n_eff)
    glass_dir = torch.where(choose_reflect[:, None], refl_dir, refr_dir)
    transmitted = is_glass & ~choose_reflect
    is_delta = is_mirror | is_glass
    new_d = torch.where(is_mirror[:, None], mir_dir,
                        torch.where(is_glass[:, None], glass_dir, new_d))
    throughput = torch.where(is_delta[:, None], delta_throughput, throughput)
    pdf0 = torch.where(is_delta, 1e8, pdf0)
    pdf1 = torch.where(is_delta, 0.0, pdf1)
    new_o = torch.where(transmitted[:, None],
                        fma32(torch.full_like(normal, -0.006), normal, pos),
                        pos)
    return new_o, new_d, throughput, pdf0, pdf1


def render_sample_impl(scene, cam: CameraParams, pixel_x, pixel_y, key,
                       width: int, height: int,
                       model: str = "trowbridge_reitz",
                       max_bounces: int = 64,
                       stack_depth: int = 48,
                       leaf_size: int = 4,
                       nee: bool = True,
                       traversal: str = "auto",
                       bounce_traversal: str = "same",
                       treelet_min: int = 1 << 15,
                       textured: bool = False,
                       mips: bool = False,
                       sun: bool = False,
                       sun_mode: str = "disk",
                       sort_rays: bool = False,
                       shadow_rev: bool = False,
                       shadow_sort: bool = False,
                       tsort_alternate: bool = False,
                       delta: bool = False,
                       compaction: bool = True,
                       compaction_divs: tuple = (2, 4, 8, 16, 32, 64, 128),
                       compaction_min: int = 2048,
                       sampler: str = "random",
                       partition=None,
                       partition_group=None,
                       partition_routing: str = "ring",
                       num_chips: int = 0,
                       packet_size: int = 128,
                       sample_idx: int = 0,
                       phases: Optional[list] = None):
    """Trace one sample for each pixel lane.

    Args:
      scene: SceneData (tensors on one device).
      cam: CameraParams on the same device.
      pixel_x, pixel_y: [N] float32 pixel coordinates of each lane.
      key: [2] threefry key for this (sample, chunk).
    Shadow rays all go to the one any-hit kernel: the JAX package's
    fused-pair schedule gives the same hits, so it has no option here.
    ``bounce_traversal`` names the traversal of the bounce rays (bounce 0,
    the coherent primaries, always takes ``traversal``) at wavefront
    widths of ``treelet_min`` or more; "same" keeps ``traversal``. With
    "tsort", NEE and ``shadow_sort``, one treelet sort per bounce serves
    the closest-hit and the shadow trace (shadow origins are the bounce
    rays' hit points, which the key already groups); ``tsort_alternate``
    sorts on even bounces only and reuses the permutation on odd ones.
    With "treelet" the bounce rays are binned by treelet (ops/treelet.py),
    ``packet_size`` rays (at least 128) a start entry; shadow rays keep
    ``traversal``. These are schedules: the hits, and so the film, do not
    depend on them (but for which of two triangles at bitwise the same t a
    ray takes).
    ``textured`` reads the scene's atlas at each hit's uv; with ``mips``
    both maps are sampled trilinearly at a ray-cone level of detail.
    ``sun`` adds the sun to NEE (``sun_mode`` "disk" or "cone").
    ``delta`` reads each hit's material type (mirror 3, glass 2) and
    continues those paths specularly. ``sort_rays`` traces each bounce's
    rays in coherence order (dead lanes last, then direction octant, then
    an 8^3 origin cell in the root's box) and unpermutes the hits;
    ``shadow_rev`` traces finite shadow segments from the light end.
    ``sampler="ld"`` jitters pixels by the R2 point of ``sample_idx``
    rotated per pixel (the jitter key is still split off, unused, so the
    lens draws stay the same).
    ``partition`` = (local table, RouteInfo or [D, 6] bounds) is the
    scene-partitioned mode (parallel/partition.py): every rank of
    ``partition_group`` (``num_chips`` ranks) calls this with its pixel
    shard, and every closest-hit and shadow query goes through the ring
    (``partition_routing`` "ring") or the routed trace ("routed") with
    packets of at least 128 rays; the traversal options and the ray sort
    are off. The loop conditions become collectives (the sum of "any ray
    alive", the maximum live count), so that every rank runs the same
    bounces: a rank that stopped early would leave the others' ring
    waiting. ``partition_group`` without ``partition`` keeps those
    collective conditions over the whole table: every rank of the group
    switches compaction phases at the same bounces as the partitioned
    frame, which makes it that frame's whole-table reference. Each phase
    run appends (its width, its first bounce) to ``phases`` when given.
    Returns ([N, 3] radiance contributions, int64 scalar rays traced).
    """
    if partition_group is not None:
        from gpupathtracer_tpu_torch.parallel import comm
    if partition is not None:
        from gpupathtracer_tpu_torch.parallel.partition import (
            trace_partitioned_local, trace_partitioned_routed)
        if partition_routing not in ("ring", "routed"):
            raise ValueError(f"partition_routing must be ring or routed, "
                             f"got {partition_routing!r}")
        traversal = "partition"
        bounce_traversal = "same"
        sort_rays = False
        part_table, part_bounds = partition
        _ptrace = (trace_partitioned_routed if partition_routing == "routed"
                   else trace_partitioned_local)
        part_kw = dict(group=partition_group, num_devices=num_chips,
                       stack_depth=stack_depth, leaf_size=leaf_size,
                       packet_size=max(packet_size, 128))
    if sampler not in ("random", "ld"):
        raise ValueError(f"unknown sampler {sampler!r}")
    n = pixel_x.shape[0]
    dev = pixel_x.device
    depth = dict(stack_depth=stack_depth, leaf_size=leaf_size)

    key, k_jitter, k_lens = random.split(key, 3)
    if sampler == "ld":
        jitter = ld_jitter(pixel_x, pixel_y, width, sample_idx)
    else:
        jitter = random.uniform(k_jitter, (n, 2))
    interp = (torch.stack([pixel_x, pixel_y], dim=-1) + jitter) \
        / torch.tensor([width, height], dtype=torch.float32, device=dev)
    lens_u = random.uniform(k_lens, (n, 2))
    ray_o, ray_d = gen_rays(cam, interp, lens_u)

    nee_pdf = 0.5 / scene.total_light_area  # InitRay, Iterative.comp:203
    pixel_cone = pixel_cone_angle(cam, height) if mips and textured else None
    if sort_rays:
        root_lo, root_hi = root_box(scene)
        inv_extent = 1.0 / torch.clamp_min(root_hi - root_lo, 1e-6)

    def body(c: Carry, trav: str = traversal) -> Carry:
        nw = c.o.shape[0]  # current (phase) wavefront width
        key, k = random.split(c.key)
        rnd = random.uniform(k, (nw, 9))
        rays = c.rays + torch.sum(c.alive)

        t_max_full = torch.full((nw,), T_MAX, dtype=torch.float32, device=dev)
        shared = None  # (perm, inv) shared by this bounce's two traces
        if trav == "tsort" and shadow_sort and nee:
            if tsort_alternate and c.i % 2:
                # Rays stay in their lanes between bounces, so the last
                # bounce's permutation is still a valid grouping.
                perm = c.perm
            else:
                perm = _sort_perm(scene.cut_bounds, c.o, c.d, t_max_full,
                                  c.alive, scene=scene)
            shared = dict(perm=perm, inv=torch.argsort(perm))
        trace = dict(traversal=trav, packet_size=packet_size, **depth)
        if partition is not None:
            hit = Hit(*_ptrace(part_table, part_bounds, c.o, c.d, t_max_full,
                               c.alive, **part_kw))
        elif sort_rays:
            # Takes precedence over a shared treelet permutation, as in the
            # JAX package (which still sorts the shadow rays by it).
            perm = ray_sort_perm(c.o, c.d, c.alive, root_lo, inv_extent)
            hit_s = trace_closest(scene, c.o[perm], c.d[perm], t_max_full,
                                  c.alive[perm], **trace)
            inv = torch.argsort(perm)
            hit = type(hit_s)(*(f[inv] for f in hit_s))
        elif shared is not None:
            hit = trace_closest_tsort(scene, c.o, c.d, t_max_full, c.alive,
                                      **depth, **shared)
        else:
            hit = trace_closest(scene, c.o, c.d, t_max_full, c.alive, **trace)
        next_perm = shared["perm"] if tsort_alternate and shared else c.perm
        miss = hit.prim < 0
        # Miss lanes read triangle 0's row; every use is masked below.
        shade = scene.tri_shade[torch.clamp_min(hit.prim, 0).long()]
        normal = shade[:, 0:3]
        pos = c.o + c.d * hit.t[..., None] + 0.003 * normal
        mrow = shade[:, 16:32]
        if textured:
            lod = None
            if mips:
                # Ray-cone mip level (a segment-length approximation; the
                # reference has no mips): the footprint t * pixel_cone,
                # stretched at grazing incidence, times the texel density
                # (shade col 10, uv per world unit) and the level-0 width.
                tex0 = mrow[:, 8].contiguous().view(torch.int32)
                rw = scene.atlas_rects[torch.clamp_min(tex0, 0).long(),
                                       2].float()
                ndv = torch.abs(dot(normal, c.d))
                foot = hit.t * pixel_cone / torch.clamp_min(ndv, 0.2)
                texels = foot * shade[:, 10] * rw
                lod = torch.log2(torch.clamp_min(texels, 1.0))
            mat = make_material_instance(mrow, scene, hit_uv(shade, hit), lod)
        else:
            mat = make_material_instance(mrow)
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

        # Delta materials (MATERIAL_TYPE, declared but unimplemented in the
        # reference, Material.glsl:15-17): mirror 3, refractive 2.
        if delta:
            mtype = mrow[:, 10].contiguous().view(torch.int32)
            is_mirror = mtype == 3
            is_glass = mtype == 2
            is_delta = is_mirror | is_glass
            if DELTA_LANES is not None:
                DELTA_LANES["hits"] += int(torch.sum(alive))
                DELTA_LANES["delta"] += int(torch.sum(alive & is_delta))

        # --- NEE (Iterative.comp:272-280) ---
        if nee:
            ls = generate_light_sample(scene, pos, normal, mat, inter,
                                       c.throughput, rnd[:, 0], rnd[:, 1:3],
                                       model, sun=sun, sun_mode=sun_mode,
                                       u_pick=rnd[:, 7])
            # Lanes whose light sample is exactly zero, and delta surfaces
            # (zero BSDF toward any sampled point), read 0 whatever the
            # occlusion, so leaving them out of the trace is exact.
            light = ls.throughput * ls.emission
            shadow_live = alive & torch.any(light != 0.0, dim=-1)
            if delta:
                shadow_live = shadow_live & ~is_delta
            rays = rays + torch.sum(shadow_live)
            so, sd, st_ = ls.shadow_origin, ls.shadow_dir, ls.shadow_tmax
            if shadow_rev:
                so, sd = reverse_segments(so, sd, st_)
            # Without a shared permutation shadow rays keep the primary
            # traversal even under a bounce override (the JAX package
            # measured a fresh sort for them as a loss).
            if partition is not None:
                occluded = _ptrace(part_table, part_bounds, so, sd, st_,
                                   shadow_live, any_hit=True,
                                   **part_kw)[1] >= 0
            elif shared is not None:
                occluded = trace_occluded_tsort(
                    scene, so, sd, st_, shadow_live, **depth, **shared)
            else:
                occluded = trace_occluded(
                    scene, so, sd, st_, shadow_live, traversal=traversal,
                    packet_size=packet_size, **depth)
            contribution = contribution + torch.where(
                (shadow_live & ~occluded)[..., None], light, 0.0)

        if max_bounces == 0:
            # Pure direct lighting: no path continues past this bounce.
            return c._replace(i=c.i + 1, key=key, o=pos,
                              contribution=contribution, last_pos=pos,
                              alive=torch.zeros_like(alive), rays=rays,
                              perm=next_perm)

        # --- BSDF sampling + throughput update (Iterative.comp:282-284) ---
        inter_b, pdf0, pdf1 = generate_importance_sample(
            mat, inter, rnd[:, 3], rnd[:, 4:6], model)
        throughput = (c.throughput * compute_bsdf(mat, inter_b, model)
                      * (inter_b.ndi * mis_weight(pdf0, pdf1)
                         / torch.clamp_min(pdf0, 1e-30))[..., None])
        new_o, new_d = pos, inter_b.incoming
        if delta:
            new_o, new_d, throughput, pdf0, pdf1 = delta_bounce(
                c.d, pos, normal, mrow, rnd[:, 8], is_mirror, is_glass,
                c.throughput * mat.albedo, new_d, throughput, pdf0, pdf1)

        # --- Russian roulette (Iterative.comp:291-300) ---
        continuation = torch.clamp(torch.amax(throughput, dim=-1), 0.0, 1.0)
        throughput = throughput / torch.clamp_min(continuation, 1e-12)[..., None]
        kill = (rnd[:, 6] > continuation) | (c.i > max_bounces)
        return Carry(i=c.i + 1, key=key, o=new_o, d=new_d,
                     throughput=throughput, contribution=contribution,
                     pdf0=pdf0, pdf1=pdf1, last_pos=pos, alive=alive & ~kill,
                     rays=rays, perm=next_perm)

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

    def trav_for(width: int) -> str:
        """The bounce rays' traversal at a phase width: the override only
        where its sort amortizes (>= treelet_min)."""
        if bounce_traversal == "same" or width < treelet_min:
            return traversal
        return bounce_traversal

    def identity(width: int):
        return (torch.arange(width, device=dev) if tsort_alternate else None)

    total = None
    src = None  # compacted lane -> film lane; None while at full width
    # Bounce 0 peeled: primary rays are coherent and take `traversal`.
    c = body(Carry(
        i=0, key=key, o=ray_o, d=ray_d,
        throughput=torch.ones((n, 3), dtype=torch.float32, device=dev),
        contribution=torch.zeros((n, 3), dtype=torch.float32, device=dev),
        pdf0=torch.ones((n,), dtype=torch.float32, device=dev),
        pdf1=torch.ones((n,), dtype=torch.float32, device=dev),
        last_pos=ray_o, alive=torch.ones((n,), dtype=torch.bool, device=dev),
        rays=torch.zeros((), dtype=torch.int64, device=dev),
        perm=identity(n)))
    def live_count(c: Carry, last: bool) -> int:
        """The live lanes of this wavefront; over ``partition_group``, the
        maximum over the ranks, or (the last phase) whether any rank has
        one."""
        live = torch.sum(c.alive)
        if partition_group is None:
            return int(live)
        if last:
            return int(comm.psum((live > 0).to(torch.int64),
                                 partition_group))
        return int(comm.pmax(live, partition_group))

    for j in range(len(widths)):
        nxt = widths[j + 1] if j + 1 < len(widths) else None
        trav = trav_for(widths[j])
        if phases is not None:
            phases.append((widths[j], int(c.i)))
        while c.i <= max_bounces + 1:
            live = live_count(c, nxt is None)
            if live == 0 or (nxt is not None and live <= nxt):
                break
            c = body(c, trav)
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
                      rays=c.rays,
                      # A carried permutation indexes the lanes before the
                      # gather: start over at the new width.
                      perm=identity(nxt))
    return total, c.rays


def render_sample_batch(scene, cam, pixel_x, pixel_y, key, spp: int = 1,
                        sample_idx: int = 0, **statics):
    """spp samples per pixel in one call: sample i uses fold_in(key, i) and
    the LD index sample_idx + i."""
    n = pixel_x.shape[0]
    acc = torch.zeros((n, 3), dtype=torch.float32, device=pixel_x.device)
    rays = torch.zeros((), dtype=torch.int64, device=pixel_x.device)
    for i in range(spp):
        c, r = render_sample_impl(scene, cam, pixel_x, pixel_y,
                                  random.fold_in(key, i),
                                  sample_idx=sample_idx + i, **statics)
        acc = acc + c
        rays = rays + r
    return acc, rays
