"""Ray queries against the scene's merged BVH table (counterpart of the
JAX package's ops/traverse.py ``trace_closest`` / ``trace_occluded``).

Both go through ops/kernel_traverse.py on MT-leaf scenes and through
ops/kernel_cluster.py on cluster scenes (``scene.cluster_rows`` set): the
CUDA kernel for tensors on a CUDA device, its plain torch version for
tensors on the CPU. Closest hits carry global triangle ids on either
table (the cluster kernel remaps its cluster-local ids). ``"auto"`` is
the one traversal name: the JAX package's other traversals (packet,
treelet, tsort, perray, dense) schedule the same hits differently and are
not ported. The fused-pair schedule (``fused_pair`` / ``fused_pair_occl``)
maps to the same any-hit kernel.
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


def check_traversal(name: str) -> None:
    if name != "auto":
        raise NotImplementedError(
            f"traversal {name!r}: the port has one traversal, 'auto' (the "
            f"CUDA kernel on CUDA tensors, its plain version on the CPU)")


def trace_closest(scene, o, d, t_max, active, *, stack_depth: int,
                  leaf_size: int, traversal: str = "auto") -> Hit:
    """Closest hit of each active ray within (0, t_max)."""
    check_traversal(traversal)
    rays = (o.contiguous(), d.contiguous(), t_max.contiguous(),
            active.contiguous())
    if scene.cluster_rows is not None:
        t, prim, u, v = kernel_cluster.closest_cluster(
            scene.node_rows, scene.cluster_rows, scene.cluster_refs, *rays,
            stack_depth=stack_depth)
    else:
        t, prim, u, v = kernel_traverse.closest(
            scene.node_rows, *rays, stack_depth=stack_depth,
            leaf_size=leaf_size)
    return Hit(t=t, prim=prim, u=u, v=v)


def trace_occluded(scene, o, d, t_max, active, *, stack_depth: int,
                   leaf_size: int, traversal: str = "auto") -> torch.Tensor:
    """[N] bool: True iff something lies within (0, t_max) of an active ray."""
    check_traversal(traversal)
    rays = (o.contiguous(), d.contiguous(), t_max.contiguous(),
            active.contiguous())
    if scene.cluster_rows is not None:
        return kernel_cluster.anyhit_cluster(
            scene.node_rows, scene.cluster_rows, *rays,
            stack_depth=stack_depth)
    return kernel_traverse.anyhit(scene.node_rows, *rays,
                                  stack_depth=stack_depth,
                                  leaf_size=leaf_size)
