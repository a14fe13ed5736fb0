"""Treelet-sorted dispatch (counterpart of the JAX package's ops/tsort.py).

Rays are sorted once by their nearest candidate treelet (the box of the
scene's treelet cut, bvh/treelet.py, with the smallest slab entry distance),
traced in sorted order by one of the traversal kernels, and the results
gathered back. It is a schedule: every ray walks the whole tree from the
root, so every hit is the unsorted traversal's. The JAX package sorts so
that a 2048-ray packet's shared stack collapses toward one subtree; here a
thread walks alone, and what the sorted order can buy is that the 32 rays
of a warp (or the 128 of a sub-packet) read the same rows.

This module has no kernel of its own: the key, ``torch.argsort`` (stable, as
``jnp.argsort`` is, so the permutation is the JAX package's array) and the
gathers are plain torch. The per-ray kernels need no padding; the
sub-packet kernel takes the rays padded to whole K-packets with dead lanes.
"""

from __future__ import annotations

import torch

from gpupathtracer_tpu_torch.ops import kernel_cluster, kernel_traverse
from gpupathtracer_tpu_torch.ops.subpacket_traverse import (LANES,
                                                            traverse_subpacket)
from gpupathtracer_tpu_torch.ops.traverse import Hit, _safe_inv

KEY_MODES = ("top1", "top2", "deep")
# What ran sorted since the counts were last set to 0: treelet sorts
# (_sort_perm) and traces of sorted rays (_trace) by query. A render that
# resolves to "tsort" but never reaches a width of treelet_min reads 0.
SORTED = {"sorts": 0, "closest": 0, "occluded": 0}


def _slab_keys(bounds, o, inv, t_max):
    """Entry distance of rays o, inv [N, 3] into boxes bounds [N or 1, B, 6]
    (+inf where the ray misses the box within t_max): [N, B]."""
    t0 = (bounds[..., 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (bounds[..., 3:6] - o[:, None, :]) * inv[:, None, :]
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tn <= tf) & (tf > 0.0) & (tn < t_max[:, None])
    return torch.where(hit, tn, torch.inf)


def _sort_perm(cut_bounds, o, d, t_max, active, key_mode: str = "top2",
               scene=None):
    """Permutation [N] int64 grouping rays by nearest candidate treelet(s).

    key_mode "top1" groups by the nearest candidate; "top2" by the
    (nearest, second-nearest) pair; "deep" refines top2's primary by the
    nearest child slot of the primary treelet's root (needs ``scene``: its
    ``cut_entry`` and the child boxes in ``node_rows``). Dead rays and rays
    with no candidate sort last."""
    if key_mode not in KEY_MODES:
        raise ValueError(f"key_mode must be one of {KEY_MODES}, got "
                         f"{key_mode!r}")
    SORTED["sorts"] += 1
    C = cut_bounds.shape[0]
    inv = _safe_inv(d)
    key = _slab_keys(cut_bounds[None], o, inv, t_max)
    key = torch.where(active[:, None], key, torch.inf)
    k1, t1 = torch.min(key, dim=1)
    # torch.min's index is not documented to be the first among equals.
    t1 = torch.argmax((key == k1[:, None]).to(torch.uint8), dim=1)
    has1 = torch.isfinite(k1)
    if key_mode == "top1":
        skey = torch.where(active & has1, t1, C)
        return torch.argsort(skey, stable=True)
    masked = key.scatter(1, t1[:, None], torch.inf)
    k2 = torch.amin(masked, dim=1)
    t2 = torch.argmax((masked == k2[:, None]).to(torch.uint8), dim=1)
    sec = torch.where(torch.isfinite(k2), t2, C)
    if key_mode == "deep":
        A = scene.arity
        ce = scene.cut_entry[t1].long()              # [N] treelet root entry
        node = torch.clamp_min(ce, 0)
        cb = scene.node_rows[node, :6 * A].reshape(-1, A, 6)
        sk = _slab_keys(cb, o, inv, t_max)           # [N, A]
        smin = torch.amin(sk, dim=1)
        sub = torch.argmax((sk == smin[:, None]).to(torch.uint8), dim=1)
        # Leaf-entry treelets have no children: one group (sub = A).
        sub = torch.where((ce >= 0) & torch.isfinite(smin), sub, A)
        prim_key = t1 * (A + 1) + sub
        skey = torch.where(active & has1, prim_key * (C + 1) + sec,
                           (A + 1) * C * (C + 1) + C)
    else:
        skey = torch.where(active & has1, t1 * (C + 1) + sec,
                           C * (C + 1) + C)
    return torch.argsort(skey, stable=True)


def _trace(scene, o, d, t_max, active, *, stack_depth: int, leaf_size: int,
           packet_size: int, any_hit: bool, interleave: int, fused_pair: bool,
           kernel: str, key_mode: str, perm, inv):
    """Sorts the rays, traces them and gathers the results back: (t, prim,
    u, v) of the closest hits, or with ``any_hit`` occluded [N]."""
    if kernel not in ("packet", "subpacket"):
        raise ValueError(f"kernel must be 'packet' or 'subpacket', got "
                         f"{kernel!r}")
    if scene.cut_bounds is None:
        raise ValueError("tsort needs the scene's treelet cut "
                         "(SceneData.cut_bounds)")
    SORTED["occluded" if any_hit else "closest"] += 1
    cluster = scene.cluster_rows is not None
    if cluster:  # cluster leaves have one kernel
        interleave, kernel = 1, "packet"
    if fused_pair:
        # The TPU's fused-pair schedule gives the plain kernel's hits.
        interleave = 1
    n = o.shape[0]
    if perm is None:
        perm = _sort_perm(scene.cut_bounds, o, d, t_max, active,
                          key_mode=key_mode, scene=scene)
    if inv is None:
        # The inverse permutation makes the unpermute a gather; callers
        # that share one permutation between the bounce and the shadow
        # trace pass it in and pay the argsort once.
        inv = torch.argsort(perm)
    rays = [o[perm].contiguous(), d[perm].contiguous(),
            t_max[perm].contiguous(), active[perm].contiguous()]
    depth = dict(stack_depth=stack_depth, arity=scene.arity)

    if kernel == "subpacket":
        K = max(LANES, (min(packet_size, n) // LANES) * LANES)
        pad = (-n) % K
        if pad:  # dead lanes: direction +x, t_max 0, inactive
            dead_d = torch.zeros((pad, 3), dtype=o.dtype, device=o.device)
            dead_d[:, 0] = 1.0
            rays = [torch.cat([x, e]) for x, e in zip(
                rays, (torch.zeros_like(dead_d), dead_d,
                       t_max.new_zeros(pad), active.new_zeros(pad)))]
        P = (n + pad) // K
        out = traverse_subpacket(
            scene.node_rows, rays[0].reshape(P, K, 3),
            rays[1].reshape(P, K, 3), rays[2].reshape(P, K),
            rays[3].reshape(P, K), leaf_size=leaf_size, any_hit=any_hit,
            **depth)
        out = tuple(x.reshape(-1)[:n] for x in out)
        if any_hit:
            return (out[1] >= 0)[inv]
    elif any_hit and cluster:
        return kernel_cluster.anyhit_cluster(
            scene.node_rows, scene.cluster_rows, *rays, **depth)[inv]
    elif any_hit:
        return kernel_traverse.anyhit(
            scene.node_rows, *rays, leaf_size=leaf_size,
            interleave=interleave, **depth)[inv]
    elif cluster:
        out = kernel_cluster.closest_cluster(
            scene.node_rows, scene.cluster_rows, scene.cluster_refs, *rays,
            **depth)
    else:
        out = kernel_traverse.closest(
            scene.node_rows, *rays, leaf_size=leaf_size,
            interleave=interleave, **depth)
    return tuple(x[inv] for x in out)


def trace_closest_tsort(scene, o, d, t_max, active, *, stack_depth: int,
                        leaf_size: int, packet_size: int = 2048,
                        interleave: int = 1, fused_pair: bool = False,
                        kernel: str = "packet", key_mode: str = "top2",
                        perm=None, inv=None) -> Hit:
    """Closest hit with treelet-sorted rays. Same contract as
    traverse.trace_closest. ``kernel`` "packet" traces with the per-ray
    kernel (``interleave`` rays a thread), "subpacket" with the sub-packet
    kernel on ``packet_size``-ray packets. perm/inv: optional precomputed
    permutation and its inverse (callers can reuse one bounce's sort for
    its shadow rays and pay the inverse argsort once)."""
    t, prim, u, v = _trace(
        scene, o, d, t_max, active, stack_depth=stack_depth,
        leaf_size=leaf_size, packet_size=packet_size, any_hit=False,
        interleave=interleave, fused_pair=fused_pair, kernel=kernel,
        key_mode=key_mode, perm=perm, inv=inv)
    return Hit(t=t, prim=prim, u=u, v=v)


def trace_occluded_tsort(scene, o, d, t_max, active, *, stack_depth: int,
                         leaf_size: int, packet_size: int = 2048,
                         interleave: int = 1, fused_pair: bool = False,
                         kernel: str = "packet", key_mode: str = "top2",
                         perm=None, inv=None):
    """Occlusion query with treelet-sorted rays. Returns occluded [N]."""
    return _trace(scene, o, d, t_max, active, stack_depth=stack_depth,
                  leaf_size=leaf_size, packet_size=packet_size, any_hit=True,
                  interleave=interleave, fused_pair=fused_pair,
                  kernel=kernel, key_mode=key_mode, perm=perm, inv=inv)
