"""Treelet-binned traversal (counterpart of the JAX package's
ops/treelet.py): bounce rays binned by the subtree of the scene's treelet
cut (bvh/treelet.py) they enter, each bin traced from that subtree's root.

Round loop (a host loop, one read of the candidate count a round):
  1. Every unresolved ray slab-tests the C cut boxes and picks its R =
     min(fanout, C) nearest treelets that it hits, has not visited yet and
     enters before its current hit.
  2. The (ray, treelet) pairs scatter into fixed-capacity per-treelet bins
     of ``cap`` slots (a stable sort by treelet id and the rank within its
     segment); pairs past a bin's capacity retry next round.
  3. One kernel launch walks all C * cap slots: ray slot s starts at the
     root entry of its bin's treelet (``roots`` of ops/kernel_traverse.py,
     one entry a packet of ``packet_size`` slots); empty slots are
     inactive rays.
  4. The results merge back per ray: t by a scatter-min (each slot's walk
     started from the ray's t, so a reported hit improves it), prim, u and
     v from the winning slot. A ray may win in several slots of a round at
     bitwise the same t; the JAX package keeps whichever its scatter
     writes last, the port the lowest slot (``_merge``). The visited
     bitmask gains the round's treelets.
The loop ends when no ray has a candidate left, or after ``max_rounds``;
then the rays that still have one are walked through the whole tree from
their current t (the JAX package's truncation fallback).

The candidates' order matches the JAX package's exactly: ``lax.top_k``
takes the R smallest keys, the lower treelet first among equal keys, in
the total order of floats (-0.0 before 0.0), which a stable sort of the
keys' order-preserving integer images gives; ``jnp.argsort`` of the bin ids
is stable, as ``torch.argsort(stable=True)`` is; the segment starts and
ranks are integer logic. Hits are then those of the per-ray walks, so t
and occlusion equal a whole-tree walk's and the JAX package's, and prim,
u and v differ only where two triangles give one ray bitwise the same t.

Cluster tables are refused (ValueError), as the JAX package refuses them:
its binning passes no cluster blocks to the kernel.
"""

from __future__ import annotations

import torch

from gpupathtracer_tpu_torch.ops import kernel_traverse
from gpupathtracer_tpu_torch.ops.traverse import Hit
from gpupathtracer_tpu_torch.ops.tsort import _safe_inv

# What ran since the counts were last set to 0: treelet traces by query,
# their rounds (kernel launches over the bins) and the traces that ended
# in the whole-tree fallback.
TRACES = {"closest": 0, "occluded": 0, "rounds": 0, "fallbacks": 0}


def _round_up(x: int, m: int) -> int:
    return -((-x) // m) * m


def _plan(scene, n: int, packet_size: int, cap_factor: float) -> int:
    """A bin's capacity: ``cap_factor`` times a treelet's even share of the
    n rays, in whole packets, at least one packet."""
    C = int(scene.cut_entry.shape[0])
    K = packet_size
    return max(K, _round_up(int(cap_factor * n / C), K))


def _total_order(key: torch.Tensor) -> torch.Tensor:
    """int32 images of float32 keys in their total order (-0.0 < 0.0)."""
    bits = key.view(torch.int32)
    return torch.where(bits < 0, bits ^ 0x7FFFFFFF, bits)


def _candidates(cut_bounds, o, inv, t, processed, live, word_of, bit_of,
                R: int):
    """The R nearest unvisited treelets each ray enters before t: (tid
    [N, R] int64, has [N, R] bool), as the JAX package's ``candidates``."""
    t0 = (cut_bounds[None, :, 0:3] - o[:, None, :]) * inv[:, None, :]
    t1 = (cut_bounds[None, :, 3:6] - o[:, None, :]) * inv[:, None, :]
    tn = torch.amax(torch.minimum(t0, t1), dim=-1)   # [N, C]
    tf = torch.amin(torch.maximum(t0, t1), dim=-1)
    hit = (tn <= tf) & (tf > 0.0) & (tn < t[:, None]) & live[:, None]
    seen = (processed[:, word_of] >> bit_of[None, :]) & 1
    key = torch.where(hit & (seen == 0), tn, torch.inf)
    tid = torch.argsort(_total_order(key), dim=1, stable=True)[:, :R]
    return tid, torch.isfinite(key.gather(1, tid))


def _merge(t, prim, u, v, slot_ray, tt, pp, uu, vv) -> None:
    """Closest hits of the round's slots into the rays' records, in place:
    t by a scatter-min, prim, u, v from the lowest slot whose hit has the
    ray's new t."""
    N, S = t.shape[0], slot_ray.shape[0]
    better = (pp >= 0) & (slot_ray >= 0)
    tgt = torch.where(better, slot_ray, N)
    t_pad = torch.cat([t, t.new_full((1,), torch.inf)])
    t_pad.scatter_reduce_(0, tgt, tt, reduce="amin")
    t.copy_(t_pad[:N])
    win = better & (tt == t[slot_ray.clamp_min(0)])
    first = torch.full((N + 1,), S, dtype=torch.int64, device=t.device)
    first.scatter_reduce_(0, torch.where(win, slot_ray, N),
                          torch.arange(S, device=t.device), reduce="amin")
    first = first[:N]
    won = first < S
    s = first[won]
    prim[won] = pp[s]
    u[won] = uu[s]
    v[won] = vv[s]


def _treelet_trace(scene, o, d, t_max, active, *, stack_depth: int,
                   leaf_size: int, any_hit: bool, packet_size: int, cap: int,
                   max_rounds: int, fanout: int):
    """The round loop and its fallback (module docstring). Returns (t,
    prim, u, v, occluded, rounds)."""
    if scene.cluster_rows is not None:
        raise ValueError("the treelet traversal reads MT leaf rows; cluster "
                         "scenes (cluster_tris > 0) bin nothing, as in the "
                         "JAX package: trace them with 'auto' or 'tsort'")
    if scene.cut_entry is None:
        raise ValueError("the treelet traversal needs the scene's treelet "
                         "cut (SceneData.cut_entry, cut_bounds)")
    rows, cut_entry, cut_bounds = (scene.node_rows, scene.cut_entry,
                                   scene.cut_bounds)
    N, dev = o.shape[0], o.device
    C = int(cut_entry.shape[0])
    K = packet_size
    R = max(1, min(fanout, C))
    S = C * cap
    roots = cut_entry.to(torch.int32).repeat_interleave(cap // K)
    word_of = torch.arange(C, device=dev) >> 5
    bit_of = (torch.arange(C, device=dev) & 31).to(torch.int32)
    inv = _safe_inv(d)
    pair_lane = torch.arange(N * R, device=dev)
    walk = dict(stack_depth=stack_depth, leaf_size=leaf_size,
                arity=scene.arity)

    t = t_max.to(torch.float32).clone()
    prim = torch.full((N,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(N, dtype=torch.float32, device=dev)
    v = torch.zeros(N, dtype=torch.float32, device=dev)
    occluded = torch.zeros(N, dtype=torch.bool, device=dev)
    processed = torch.zeros((N, (C + 31) // 32), dtype=torch.int32,
                            device=dev)

    def candidates():
        live = active & ~occluded if any_hit else active
        return _candidates(cut_bounds, o, inv, t, processed, live, word_of,
                           bit_of, R)

    rounds, left = 0, True
    while rounds < max_rounds:
        tid, has = candidates()
        if not bool(has.any()):
            left = False
            break
        rounds += 1
        # ---- bin (ray, treelet) pairs: stable sort + rank in segment -----
        tid_s = torch.where(has, tid, C).reshape(N * R)
        order = torch.argsort(tid_s, stable=True)
        sorted_tid = tid_s[order]
        ray_of = order // R
        seg_start = torch.searchsorted(sorted_tid,
                                       torch.arange(C, device=dev))
        tid_c = sorted_tid.clamp(0, C - 1)
        rank = pair_lane - seg_start[tid_c]
        valid = (sorted_tid < C) & (rank < cap)
        slot = torch.where(valid, sorted_tid * cap + rank, S)
        slot_ray = torch.full((S + 1,), -1, dtype=torch.int64, device=dev)
        slot_ray[slot] = ray_of
        slot_ray = slot_ray[:S]

        sact = slot_ray >= 0
        sridx = slot_ray.clamp_min(0)
        rays = (o[sridx].contiguous(), d[sridx].contiguous(),
                (t_max if any_hit else t)[sridx].contiguous(), sact)
        if any_hit:
            occ = kernel_traverse.anyhit(rows, *rays, roots=roots, packet=K,
                                         **walk)
            occluded[slot_ray[occ & sact]] = True
        else:
            tt, pp, uu, vv = kernel_traverse.closest(rows, *rays, roots=roots,
                                                     packet=K, **walk)
            _merge(t, prim, u, v, slot_ray, tt, pp, uu, vv)
        # ---- mark visited (bits distinct per round: add is or) -----------
        processed.index_put_(
            (ray_of[valid], word_of[tid_c[valid]]),
            torch.bitwise_left_shift(torch.ones_like(bit_of[tid_c[valid]]),
                                     bit_of[tid_c[valid]]),
            accumulate=True)

    TRACES["occluded" if any_hit else "closest"] += 1
    TRACES["rounds"] += rounds
    if left:
        # Cut by max_rounds: the rays that still have a candidate finish
        # with a whole-tree walk from their current t.
        leftover = candidates()[1].any(dim=1)
        if bool(leftover.any()):
            TRACES["fallbacks"] += 1
            if any_hit:
                occluded |= leftover & kernel_traverse.anyhit(
                    rows, o, d, t_max, leftover, **walk)
            else:
                ft, fp, fu, fv = kernel_traverse.closest(
                    rows, o, d, t.contiguous(), leftover, **walk)
                closer = leftover & (fp >= 0) & (ft < t)
                t = torch.where(closer, ft, t)
                prim = torch.where(closer, fp, prim)
                u = torch.where(closer, fu, u)
                v = torch.where(closer, fv, v)
    return t, prim, u, v, occluded, rounds


def trace_closest_treelet(scene, o, d, t_max, active, *, stack_depth: int,
                          leaf_size: int, packet_size: int = 2048,
                          cap_factor: float = 2.0, max_rounds: int = 64,
                          fanout: int = 4) -> Hit:
    """Closest hit via treelet binning. Same contract as
    traverse.trace_closest."""
    cap = _plan(scene, o.shape[0], packet_size, cap_factor)
    t, prim, u, v, _, _ = _treelet_trace(
        scene, o.contiguous(), d.contiguous(), t_max.contiguous(),
        active.contiguous(), stack_depth=stack_depth, leaf_size=leaf_size,
        any_hit=False, packet_size=packet_size, cap=cap,
        max_rounds=max_rounds, fanout=fanout)
    return Hit(t=t, prim=prim, u=u, v=v)


def trace_occluded_treelet(scene, o, d, t_max, active, *, stack_depth: int,
                           leaf_size: int, packet_size: int = 2048,
                           cap_factor: float = 2.0, max_rounds: int = 64,
                           fanout: int = 4) -> torch.Tensor:
    """Occlusion query via treelet binning. Returns occluded [N] bool."""
    cap = _plan(scene, o.shape[0], packet_size, cap_factor)
    return _treelet_trace(
        scene, o.contiguous(), d.contiguous(), t_max.contiguous(),
        active.contiguous(), stack_depth=stack_depth, leaf_size=leaf_size,
        any_hit=True, packet_size=packet_size, cap=cap,
        max_rounds=max_rounds, fanout=fanout)[4]
