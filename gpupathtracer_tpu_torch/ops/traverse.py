"""Ray queries against the scene's BVH (counterpart of the JAX package's
ops/traverse.py ``trace_closest`` / ``trace_occluded``).

``"auto"`` goes through ops/kernel_traverse.py on MT-leaf scenes and
through ops/kernel_cluster.py on cluster scenes (``scene.cluster_rows``
set): the CUDA kernel for tensors on a CUDA device, its plain torch
version for tensors on the CPU. ``"pallas"``, the JAX name of its on-core
kernel, is the same. ``"tsort"`` sorts the rays by treelet first
(ops/tsort.py) and traces them with the same kernels; ``"treelet"`` bins
them by the subtree they enter and walks each bin from its root
(ops/treelet.py, MT leaves only), with ``packet_size`` rays a start entry
(at least 128, as the JAX package passes it). The kernels walk the scene's
node arity (``scene.arity``). Closest hits carry global triangle ids on
either table (the cluster kernel remaps its cluster-local ids).
``interleave`` is the kernel's rays per thread (MT leaves only; cluster
scenes have one kernel). The fused-pair schedule (``fused_pair`` /
``fused_pair_occl``) maps to the same any-hit kernel.

The JAX package's plain XLA traversals are plain torch here, on any
device: ``"perray"`` is the lockstep walk below (``closest_hit`` /
``any_hit``: every ray its own stack, over the per-lane layout
``child_bounds`` / ``child_entry`` / ``refs`` and ``tri_geom``, any
arity), ``"packet"`` the shared-stack packets of ops/packet_traverse.py
on ``packet_size``-ray packets. As in the JAX package, ``"packet"`` takes
the per-ray walk on cluster scenes, at another arity than 8 and for
leaves of more than 10 triangles. Both walk in the JAX package's order
with its slab test and intersect with the kernels' Moller-Trumbore
arithmetic (ops/intersect.py), so every traversal gives the kernels' hits
(but for which of two triangles at bitwise the same t a ray takes, and
for a triangle whose t rounds below its box's entry: ROADMAP.md C7).
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpupathtracer_tpu_torch.ops import kernel_cluster, kernel_traverse
from gpupathtracer_tpu_torch.ops.intersect import mt_xyz

_INVALID = kernel_traverse.INVALID_ENTRY


class Hit(NamedTuple):
    """Closest-hit record (role of HitInfo, src/math/Ray.h:7-21)."""

    t: torch.Tensor     # [N] f32; t_max on miss
    prim: torch.Tensor  # [N] i32 triangle id; -1 on miss
    u: torch.Tensor     # [N] f32 barycentric
    v: torch.Tensor     # [N] f32 barycentric


TRAVERSALS = ("auto", "pallas", "tsort", "treelet", "packet", "perray")


def check_traversal(name: str) -> None:
    if name not in TRAVERSALS:
        raise ValueError(
            f"traversal {name!r}: the port has {TRAVERSALS} ('auto' and "
            f"'pallas': the CUDA kernel on CUDA tensors, its plain version "
            f"on the CPU; 'tsort': the same on treelet-sorted rays; "
            f"'treelet': treelet-binned rounds; 'packet' and 'perray': the "
            f"JAX package's shared-stack packets and lockstep walk in plain "
            f"torch)")


def _safe_inv(d):
    """1/d with tiny components clamped (the reference relies on GLSL inf
    semantics, BVH.glsl:367-391; this avoids inf * 0 NaNs)."""
    eps = torch.tensor(1e-12, dtype=d.dtype, device=d.device)
    return torch.where(d >= 0, 1.0, -1.0) / torch.maximum(d.abs(), eps)


def _slab_test(bounds, o, inv_d, t_cur):
    """Slab test of rays o, inv_d [N, 3] against their nodes' children
    bounds [N, A, 6]: (t_near [N, A], hit [N, A]); t_near is inf where the
    child is missed. Empty slots carry inverted boxes and always miss."""
    t0 = (bounds[..., 0:3] - o[:, None, :]) * inv_d[:, None, :]
    t1 = (bounds[..., 3:6] - o[:, None, :]) * inv_d[:, None, :]
    tmin = torch.amax(torch.minimum(t0, t1), dim=-1)
    tmax = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tmin <= tmax) & (tmax > 0.0) & (tmin < t_cur[:, None])
    return torch.where(hit, torch.clamp_min(tmin, 0.0), torch.inf), hit


def _traverse(scene, o, d, t_max, active, stack_depth: int, leaf_size: int,
              any_hit_mode: bool, counters: bool = False,
              visit_bucket=None, num_buckets: int = 0):
    """The JAX package's per-lane lockstep walk (ops/traverse.py
    ``_traverse``): each step pops one entry of every live ray's stack; a
    node row's children are slab-tested and the entered ones pushed so
    that the nearest pops first (``argsort`` on t_near, stable; unsorted
    for any-hit); a leaf runs up to ``leaf_size`` Moller-Trumbore tests on
    its ``refs``. Pushes past ``stack_depth`` are dropped; an any-hit walk
    ends at its first hit. Each step visits only the live rays: a ray's
    walk does not depend on the others'. With ``counters`` also returns
    each ray's (pops, node expansions, triangle tests) [N] int32 (the
    JAX package's ops/debug.py trail). ``visit_bucket`` [W] int (wide
    node -> bucket) adds the node pops of every ray by bucket,
    [num_buckets] int32 (buckets at or past ``num_buckets`` are dropped):
    the pilot demand of bvh/partition.py (``count_entry_visits``).

    Returns (t, prim, u, v[, counts][, bucket counts])."""
    child_bounds, child_entry, refs, tri_geom = (
        scene.child_bounds, scene.child_entry, scene.refs, scene.tri_geom)
    if any(f is None for f in (child_bounds, child_entry, refs, tri_geom)):
        raise ValueError("the per-ray walk reads the scene's per-lane layout "
                         "(child_bounds, child_entry, refs, tri_geom), which "
                         "this SceneData lacks")
    n, dev = o.shape[0], o.device
    arity = child_entry.shape[1]
    inv_d = _safe_inv(d)
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)  # the root entry is node 0
    t = t_max.to(torch.float32).clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    counts = (torch.zeros((3, n), dtype=torch.int32, device=dev)
              if counters else None)
    slot = torch.arange(leaf_size, device=dev)
    if visit_bucket is not None:
        visit_bucket = torch.as_tensor(visit_bucket, device=dev).long()
        per_bucket = torch.zeros(num_buckets, dtype=torch.int64, device=dev)
    while True:
        ln = torch.nonzero(sp > 0).squeeze(1)
        if ln.numel() == 0:
            break
        sp[ln] -= 1
        entry = stack[ln, sp[ln]]
        node = entry >= 0
        if counters:
            counts[0, ln] += 1
            counts[1, ln[node]] += 1

        nl, ne = ln[node], entry[node]
        if visit_bucket is not None:
            b = visit_bucket[ne]
            per_bucket += torch.bincount(b[b < num_buckets],
                                         minlength=num_buckets)
        if nl.numel():
            centry = child_entry[ne].to(torch.int64)
            tnear, chit = _slab_test(child_bounds[ne], o[nl], inv_d[nl],
                                     t[nl])
            chit = chit & (centry != _INVALID)
            if not any_hit_mode:  # occlusion pushes in slot order
                order = torch.argsort(torch.where(chit, tnear, torch.inf),
                                      dim=1, stable=True)
                centry = torch.gather(centry, 1, order)
                chit = torch.gather(chit, 1, order)
            incl = torch.cumsum(chit.to(torch.int64), dim=1)
            total = incl[:, -1]
            # The nearest child ends up on top: position sp + total - incl.
            pos = sp[nl, None] + total[:, None] - incl
            keep = chit & (pos < stack_depth)
            lane = nl[:, None].expand(-1, arity)
            stack[lane[keep], pos[keep]] = centry[keep]
            sp[nl] = torch.clamp_max(sp[nl] + total, stack_depth)

        ll, le = ln[~node], entry[~node]
        if ll.numel():
            # The JAX walk tests the slots in turn, each against the t the
            # earlier ones left: that keeps the first of the nearest hits,
            # as the first argmin over all slots at once does.
            packed = -(le + 1)
            first, count = packed >> 4, packed & 15
            ok = slot < count[:, None]                   # [m, leaf_size]
            if counters:
                counts[2, ll] += ok.sum(dim=1, dtype=torch.int32)
            tidx = refs[torch.where(ok, first[:, None] + slot, 0)].long()
            tri = tri_geom[tidx]                         # [m, leaf_size, 9]
            o_l, d_l, t_l = o[ll], d[ll], t[ll]
            tt, tu, tv, th = mt_xyz(
                *([tri[..., a + i] for i in range(3)] for a in (0, 3, 6)),
                [o_l[:, i, None] for i in range(3)],
                [d_l[:, i, None] for i in range(3)])
            closer = ok & th & (tt < t_l[:, None])
            best = torch.argmin(torch.where(closer, tt, torch.inf), dim=1,
                                keepdim=True)
            win = closer.any(dim=1)
            lw = ll[win]
            t[lw] = tt.gather(1, best)[win, 0]
            prim[lw] = tidx.gather(1, best)[win, 0].to(torch.int32)
            u[lw] = tu.gather(1, best)[win, 0]
            v[lw] = tv.gather(1, best)[win, 0]
            if any_hit_mode:
                sp[lw] = 0  # the walk ends at its first hit
    out = (t, prim, u, v)
    if counters:
        out += (counts,)
    if visit_bucket is not None:
        out += (per_bucket.to(torch.int32),)
    return out


def closest_hit(scene, o, d, t_max, active=None, stack_depth: int = 48,
                leaf_size: int = 4) -> Hit:
    """Closest hit of each active ray within (0, t_max) by the per-ray
    walk (the JAX package's ``closest_hit``; role of IfIfClosestHit,
    BVH.glsl:634-767). ``scene`` is a SceneData, or anything with its
    per-lane fields."""
    if active is None:
        active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    return Hit(*_traverse(scene, o, d, t_max, active, stack_depth, leaf_size,
                          False))


def any_hit(scene, o, d, t_max, active=None, stack_depth: int = 48,
            leaf_size: int = 4) -> torch.Tensor:
    """[N] bool: something lies within (0, t_max) of the ray, by the
    per-ray walk (the JAX package's ``any_hit``; role of IfIfAnyHit,
    BVH.glsl:769-854)."""
    if active is None:
        active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    _, prim, _, _ = _traverse(scene, o, d, t_max, active, stack_depth,
                              leaf_size, True)
    return prim >= 0


def count_entry_visits(scene, o, d, t_max, bucket_map, num_buckets: int,
                       stack_depth: int = 48, leaf_size: int = 4):
    """Pilot demand: the per-ray closest-hit walk of every ray, its node
    pops summed by bucket through ``bucket_map`` ([W] wide node -> bucket,
    bvh/partition.py ``node_bucket_map``): [num_buckets] int32 (the JAX
    package's ``count_entry_visits``). Unlike the slab estimate of
    bvh/partition.py, it sees how deep rays walk in each subtree."""
    active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    return _traverse(scene, o, d, t_max, active, stack_depth, leaf_size,
                     False, visit_bucket=bucket_map,
                     num_buckets=num_buckets)[4]


def _pad_rays(o, d, t_max, active, multiple: int):
    """Pad a wavefront to a multiple of the packet size with dead rays
    (zero origin, direction +x, t_max 0); returns the rays and n."""
    n = o.shape[0]
    pad = (-n) % multiple
    if pad:
        o = torch.cat([o, o.new_zeros((pad, 3))])
        dpad = d.new_zeros((pad, 3))
        dpad[:, 0] = 1.0  # a unit direction keeps 1/d finite
        d = torch.cat([d, dpad])
        t_max = torch.cat([t_max, t_max.new_zeros(pad)])
        active = torch.cat([active, active.new_zeros(pad)])
    return o, d, t_max, active, n


def _takes_packets(scene, leaf_size: int) -> bool:
    """The packet walk reads 8-wide node rows and single-row MT leaves; the
    JAX package walks every other table per ray (ops/traverse.py:310-320)."""
    return (scene.arity == 8 and leaf_size <= 10
            and scene.cluster_rows is None)


def trace_closest(scene, o, d, t_max, active, *, stack_depth: int,
                  leaf_size: int, traversal: str = "auto",
                  interleave: int = 1, packet_size: int = 128) -> Hit:
    """Closest hit of each active ray within (0, t_max)."""
    check_traversal(traversal)
    if traversal == "packet" and _takes_packets(scene, leaf_size):
        from gpupathtracer_tpu_torch.ops.packet_traverse import \
            closest_hit_packets
        ps = max(min(packet_size, o.shape[0]), 1)
        o, d, t_max, active, n = _pad_rays(o, d, t_max, active, ps)
        hit = closest_hit_packets(scene.node_rows, o, d, t_max, active,
                                  stack_depth=stack_depth,
                                  leaf_size=leaf_size, packet_size=ps)
        return Hit(*(f[:n] for f in hit))
    if traversal in ("packet", "perray"):
        return closest_hit(scene, o, d, t_max, active,
                           stack_depth=stack_depth, leaf_size=leaf_size)
    if traversal == "treelet":
        from gpupathtracer_tpu_torch.ops.treelet import trace_closest_treelet
        return trace_closest_treelet(scene, o, d, t_max, active,
                                     stack_depth=stack_depth,
                                     leaf_size=leaf_size,
                                     packet_size=max(packet_size, 128))
    if traversal == "tsort":
        from gpupathtracer_tpu_torch.ops.tsort import trace_closest_tsort
        return trace_closest_tsort(scene, o, d, t_max, active,
                                   stack_depth=stack_depth,
                                   leaf_size=leaf_size, interleave=interleave)
    rays = (o.contiguous(), d.contiguous(), t_max.contiguous(),
            active.contiguous())
    if scene.cluster_rows is not None:
        t, prim, u, v = kernel_cluster.closest_cluster(
            scene.node_rows, scene.cluster_rows, scene.cluster_refs, *rays,
            stack_depth=stack_depth, arity=scene.arity)
    else:
        t, prim, u, v = kernel_traverse.closest(
            scene.node_rows, *rays, stack_depth=stack_depth,
            leaf_size=leaf_size, interleave=interleave, arity=scene.arity)
    return Hit(t=t, prim=prim, u=u, v=v)


def trace_occluded(scene, o, d, t_max, active, *, stack_depth: int,
                   leaf_size: int, traversal: str = "auto",
                   interleave: int = 1,
                   packet_size: int = 128) -> torch.Tensor:
    """[N] bool: True iff something lies within (0, t_max) of an active ray."""
    check_traversal(traversal)
    if traversal == "packet" and _takes_packets(scene, leaf_size):
        from gpupathtracer_tpu_torch.ops.packet_traverse import \
            any_hit_packets
        ps = max(min(packet_size, o.shape[0]), 1)
        o, d, t_max, active, n = _pad_rays(o, d, t_max, active, ps)
        return any_hit_packets(scene.node_rows, o, d, t_max, active,
                               stack_depth=stack_depth, leaf_size=leaf_size,
                               packet_size=ps)[:n]
    if traversal in ("packet", "perray"):
        return any_hit(scene, o, d, t_max, active, stack_depth=stack_depth,
                       leaf_size=leaf_size)
    if traversal == "treelet":
        from gpupathtracer_tpu_torch.ops.treelet import trace_occluded_treelet
        return trace_occluded_treelet(scene, o, d, t_max, active,
                                      stack_depth=stack_depth,
                                      leaf_size=leaf_size,
                                      packet_size=max(packet_size, 128))
    if traversal == "tsort":
        from gpupathtracer_tpu_torch.ops.tsort import trace_occluded_tsort
        return trace_occluded_tsort(scene, o, d, t_max, active,
                                    stack_depth=stack_depth,
                                    leaf_size=leaf_size,
                                    interleave=interleave)
    rays = (o.contiguous(), d.contiguous(), t_max.contiguous(),
            active.contiguous())
    if scene.cluster_rows is not None:
        return kernel_cluster.anyhit_cluster(
            scene.node_rows, scene.cluster_rows, *rays,
            stack_depth=stack_depth, arity=scene.arity)
    return kernel_traverse.anyhit(scene.node_rows, *rays,
                                  stack_depth=stack_depth,
                                  leaf_size=leaf_size, interleave=interleave,
                                  arity=scene.arity)
