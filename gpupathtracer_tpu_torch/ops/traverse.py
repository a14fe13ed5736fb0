"""Ray queries against the scene's merged BVH table (counterpart of the
JAX package's ops/traverse.py ``trace_closest`` / ``trace_occluded``).

``"auto"`` goes through ops/kernel_traverse.py on MT-leaf scenes and
through ops/kernel_cluster.py on cluster scenes (``scene.cluster_rows``
set): the CUDA kernel for tensors on a CUDA device, its plain torch
version for tensors on the CPU. ``"pallas"``, the JAX name of its on-core
kernel, is the same. ``"tsort"`` sorts the rays by treelet first
(ops/tsort.py) and traces them with the same kernels; ``"treelet"`` bins
them by the subtree they enter and walks each bin from its root
(ops/treelet.py, MT leaves only), with ``packet_size`` rays a start entry
(at least 128, as the JAX package passes it). Every traversal gives the
same hits. The kernels walk the scene's node arity (``scene.arity``).
Closest hits carry global triangle ids on either table (the cluster
kernel remaps its cluster-local ids). ``interleave`` is the kernel's rays
per thread (MT leaves only; cluster scenes have one kernel). The JAX
package's plain XLA traversals (``"packet"``, ``"perray"``) schedule the
same hits differently and are not ported. The fused-pair schedule
(``fused_pair`` / ``fused_pair_occl``) maps to the same any-hit kernel.
"""

from __future__ import annotations

from typing import NamedTuple

import torch

from gpupathtracer_tpu_torch.ops import kernel_cluster, kernel_traverse


class Hit(NamedTuple):
    """Closest-hit record (role of HitInfo, src/math/Ray.h:7-21)."""

    t: torch.Tensor     # [N] f32; t_max on miss
    prim: torch.Tensor  # [N] i32 triangle id; -1 on miss
    u: torch.Tensor     # [N] f32 barycentric
    v: torch.Tensor     # [N] f32 barycentric


TRAVERSALS = ("auto", "pallas", "tsort", "treelet")


def check_traversal(name: str) -> None:
    if name not in TRAVERSALS:
        raise NotImplementedError(
            f"traversal {name!r}: the port has {TRAVERSALS} ('auto' and "
            f"'pallas': the CUDA kernel on CUDA tensors, its plain version "
            f"on the CPU; 'tsort': the same on treelet-sorted rays; "
            f"'treelet': treelet-binned rounds); packet and perray are not "
            f"ported yet (ROADMAP.md, queue A)")


def trace_closest(scene, o, d, t_max, active, *, stack_depth: int,
                  leaf_size: int, traversal: str = "auto",
                  interleave: int = 1, packet_size: int = 128) -> Hit:
    """Closest hit of each active ray within (0, t_max)."""
    check_traversal(traversal)
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
