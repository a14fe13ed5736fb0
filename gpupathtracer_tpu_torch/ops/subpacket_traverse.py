"""Sub-packet traversal: wrapper of the CUDA kernel
csrc/subpacket_traverse.cu and its plain torch version.

The kernel replaces the JAX package's Pallas kernel ``_kernel``
(ops/subpacket_traverse.py:58): a packet of K = G * 128 rays is G
sub-packets of 128 consecutive rays, each walking the merged row table
together on one node stack and one leaf backlog; a node pop pushes every
child that any of its rays enters (the nearest of them on top when
``ordered``), leaf children onto the backlog. Same hit set as
``kernel_traverse.closest`` / ``anyhit`` (the if-if traversal roles of
BVH.glsl:634-767 and 769-854).

Each iteration the packet runs one phase, chosen by the TPU kernel's rule
(:107-114): a leaf phase when the backlogs hold a leaf and either no node
is left, or they hold G leaves or more in sum, or one holds ``LEAF_TRIG``
or more; a node phase otherwise. In a leaf phase every sub-packet with a
backlog pops one leaf, in a node phase every sub-packet with a node pops
one node, and the others idle. So the port visits in the TPU kernel's
order at every K: every field and both pop counts equal the JAX kernel's.

The kernel reads 8-wide node rows only, as the JAX kernel does (its rows
are hard-coded 8 wide, ops/subpacket_traverse.py:241, 293, and the JAX
kernel bench refuses any other arity for it): ``arity`` other than 8
raises.

``traverse_subpacket`` launches the kernel for CUDA tensors and runs
``traverse_subpacket_plain`` for CPU tensors; the plain version steps all
packets in lockstep, in the kernel's visit order and with its arithmetic,
so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gpupathtracer_tpu_torch.ops import cuda_build
from gpupathtracer_tpu_torch.ops.intersect import fma32, mt_intersect
from gpupathtracer_tpu_torch.ops.kernel_traverse import (ARITY, INVALID_ENTRY,
                                                         MAX_STACK, ROW_WIDTH,
                                                         TRIS_PER_ROW,
                                                         count_pops, stream_of)

LANES = 128
# Leaf backlog depth and the drain trigger (kLeafDepth, kLeafTrig in the
# source): a node pop adds at most 8 leaves, and a backlog of LEAF_TRIG
# forces a leaf phase, so a backlog never overflows.
LEAF_DEPTH = 32
LEAF_TRIG = LEAF_DEPTH - 8

# Kernel launches since the last reset, by entry point. Each wrapper adds
# one where it launches its kernel and nowhere else.
LAUNCHES = {"subpacket_closest": 0, "subpacket_anyhit": 0}

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build("subpacket_traverse")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpt_subpacket_max_stack.argtypes = []
        lib.gpt_subpacket_max_stack.restype = i
        lib.gpt_trace_subpacket.argtypes = [p, p, p, p, p, i, i, i, i, i, i,
                                            p, p, p, p, p, p]
        lib.gpt_trace_subpacket.restype = i
        if lib.gpt_subpacket_max_stack() != MAX_STACK:
            raise RuntimeError("csrc/bvh_walk.cuh and kernel_traverse.py "
                               "disagree on the stack size")
        _lib = lib
    return _lib


def _check(rows, o, d, t_max, active, stack_depth: int, leaf_size: int,
           arity: int = ARITY):
    """Raises ValueError unless the arguments are what the kernel takes
    (NotImplementedError at an arity other than 8); returns (P, K)."""
    if arity != ARITY:
        raise NotImplementedError(
            f"the sub-packet kernel reads 8-wide node rows, as the JAX "
            f"kernel does (ops/subpacket_traverse.py:241, 293); this table "
            f"is {arity}-wide")
    if o.dim() != 3 or o.shape[2] != 3:
        raise ValueError(f"o must be [P, K, 3], got {tuple(o.shape)}")
    P, K, _ = o.shape
    if K < LANES or K % LANES:
        raise ValueError(f"packet size K={K} must be a multiple of {LANES}")
    if not 1 <= leaf_size <= TRIS_PER_ROW:
        raise ValueError("the sub-packet kernel reads single-row leaves "
                         f"only (leaf_size <= {TRIS_PER_ROW})")
    if rows.dim() != 2 or rows.shape[1] != ROW_WIDTH or rows.shape[0] < 1:
        raise ValueError(f"rows must be [M>=1, {ROW_WIDTH}], got "
                         f"{tuple(rows.shape)}")
    for name, x, shape, dtype in (("rows", rows, tuple(rows.shape),
                                   torch.float32),
                                  ("o", o, (P, K, 3), torch.float32),
                                  ("d", d, (P, K, 3), torch.float32),
                                  ("t_max", t_max, (P, K), torch.float32),
                                  ("active", active, (P, K), torch.bool)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, rays on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if not 1 <= stack_depth <= MAX_STACK:
        raise ValueError(f"stack_depth {stack_depth} outside 1..{MAX_STACK} "
                         f"(the kernel's stack)")
    return P, K


def traverse_subpacket(rows, o, d, t_max, active, *, stack_depth: int = 48,
                       leaf_size: int = 4, any_hit: bool = False,
                       ordered: bool = True, with_stats: bool = False,
                       arity: int = ARITY):
    """Closest hit (or, with ``any_hit``, any hit) of rays o, d [P, K, 3]
    within (0, t_max [P, K]) against rows [M, 128]; K = G * 128 is G
    independent 128-ray sub-packets. Returns (t, prim, u, v), each [P, K]:
    the ``kernel_traverse.closest`` contract; with ``any_hit`` a ray is
    occluded iff prim >= 0 (t, prim, u, v are then the nearest hit of the
    leaf that ended its walk). ``with_stats`` appends a [P, 2] int32
    tensor of (node pops, leaf pops) per K-packet. ``arity`` is the
    table's node width: 8 only (module docstring)."""
    P, K = _check(rows, o, d, t_max, active, stack_depth, leaf_size, arity)
    if o.device.type == "cpu":
        return traverse_subpacket_plain(
            rows, o, d, t_max, active, stack_depth=stack_depth,
            leaf_size=leaf_size, any_hit=any_hit, ordered=ordered,
            with_stats=with_stats)
    stream = stream_of(o)
    t = torch.empty((P, K), dtype=torch.float32, device=o.device)
    prim = torch.empty((P, K), dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    stats = (torch.zeros((P, 2), dtype=torch.int32, device=o.device)
             if with_stats else None)
    if P:
        with torch.cuda.device(o.device):
            err = _library().gpt_trace_subpacket(
                rows.data_ptr(), o.data_ptr(), d.data_ptr(),
                t_max.data_ptr(), active.data_ptr(), P * K, stack_depth,
                leaf_size, int(any_hit), int(ordered), K // LANES,
                t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                stats.data_ptr() if with_stats else None, stream)
        if err:
            raise RuntimeError(f"trace_subpacket launch failed: CUDA error "
                               f"{err}")
        LAUNCHES["subpacket_anyhit" if any_hit else "subpacket_closest"] += 1
    return (t, prim, u, v, stats) if with_stats else (t, prim, u, v)


def _push(stack, sp, subs, child, mask, limit: int) -> None:
    """Pushes child[mask] [m, 9], in column order, onto the stacks of
    sub-packets ``subs``; pushes past ``limit`` are dropped."""
    rank = torch.cumsum(mask.to(torch.int64), dim=1) - 1
    pos = sp[subs, None] + rank
    keep = mask & (pos < limit)
    sub = subs[:, None].expand_as(child)
    stack[sub[keep], pos[keep]] = child[keep]
    sp[subs] = torch.clamp_max(sp[subs] + mask.sum(dim=1), limit)


def traverse_subpacket_plain(rows, o, d, t_max, active, *,
                             stack_depth: int = 48, leaf_size: int = 4,
                             any_hit: bool = False, ordered: bool = True,
                             with_stats: bool = False,
                             pops: Optional[dict] = None):
    """Plain torch version of ``traverse_subpacket`` (same results, bit for
    bit): all packets step in lockstep, each running the leaf or the node
    phase that the module docstring's rule chooses for it. ``pops``, a
    dict, collects the walk's work (``kernel_traverse.count_pops``): the
    sub-packets' node and leaf pops and the distinct rows they read,
    ``slots`` the triangle tests, ``slabs`` the 8-child slab tests of the
    rays still walking, and ``trig`` the packet iterations whose leaf phase
    the LEAF_TRIG rule alone chose (nodes left, fewer than G leaves)."""
    P, K = _check(rows, o, d, t_max, active, stack_depth, leaf_size)
    dev = o.device
    G = K // LANES
    S = P * G
    o, d = o.reshape(S, LANES, 3), d.reshape(S, LANES, 3)
    act = active.reshape(S, LANES)
    eps = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    inv = torch.where(d >= 0, 1.0, -1.0) / torch.maximum(d.abs(), eps)
    oi = o * inv
    rows_i = rows.view(torch.int32)
    t = t_max.reshape(S, LANES).clone()
    prim = torch.full((S, LANES), -1, dtype=torch.int32, device=dev)
    u = torch.zeros((S, LANES), dtype=torch.float32, device=dev)
    v = torch.zeros_like(u)
    nstack = torch.zeros((S, stack_depth), dtype=torch.int64, device=dev)
    lstack = torch.zeros((S, LEAF_DEPTH), dtype=torch.int64, device=dev)
    nsp = act.any(dim=1).to(torch.int64)  # nstack[:, 0] = 0, the root row
    lsp = torch.zeros(S, dtype=torch.int64, device=dev)
    stats = torch.zeros((S, 2), dtype=torch.int32, device=dev)
    slot = torch.arange(leaf_size, device=dev)
    if pops is not None:
        pops.setdefault("trig", 0)

    while True:
        # ---- the phase, once a packet ------------------------------------
        tot_n = nsp.reshape(P, G).sum(dim=1)
        tot_l = lsp.reshape(P, G).sum(dim=1)
        if not bool((tot_n + tot_l).any()):
            break
        trig = (lsp.reshape(P, G) >= LEAF_TRIG).any(dim=1)
        leaf_phase = (tot_l > 0) & ((tot_n == 0) | (tot_l >= G) | trig)
        if pops is not None:
            pops["trig"] += int((leaf_phase & (tot_n > 0)
                                 & (tot_l < G)).sum())
        leaf_sub = leaf_phase.repeat_interleave(G)
        leafy = torch.nonzero(leaf_sub & (lsp > 0)).squeeze(1)
        nodal = torch.nonzero(~leaf_sub & (nsp > 0)).squeeze(1)

        # ---- leaf phases -------------------------------------------------
        if leafy.numel():
            m = leafy.numel()
            lsp[leafy] -= 1
            packed = -(lstack[leafy, lsp[leafy]] + 1)
            first, count = packed >> 4, packed & 15
            stats[leafy, 1] += 1
            tri = rows[first][:, :TRIS_PER_ROW * 12].reshape(
                m, TRIS_PER_ROW, 12)[:, :leaf_size]
            # [m, 128 rays, leaf_size slots]
            tri_x = tri[:, None].expand(m, LANES, leaf_size, 12)
            o_x = o[leafy][:, :, None].expand(m, LANES, leaf_size, 3)
            d_x = d[leafy][:, :, None].expand(m, LANES, leaf_size, 3)
            tt, uu, vv, ok = (x.reshape(m, LANES, leaf_size)
                              for x in mt_intersect(tri_x.reshape(-1, 12),
                                                    o_x.reshape(-1, 3),
                                                    d_x.reshape(-1, 3)))
            on = act[leafy]
            if any_hit:
                on = on & (prim[leafy] < 0)
            count_pops(pops, "leaf", packed, (on.sum(dim=1) * torch.clamp_max(
                count, leaf_size)).sum())
            ok = (ok & (tt < t[leafy][..., None]) & on[..., None]
                  & (slot < count[:, None, None]))
            # Testing the slots in order keeps the leaf's nearest hit, the
            # first slot among equals (for any-hit too: the ray stops
            # walking after this leaf).
            score = torch.where(ok, tt, torch.inf)
            best = torch.argmax(
                (score == score.amin(dim=2, keepdim=True))
                .to(torch.uint8), dim=2, keepdim=True)
            win = ok.any(dim=2)
            pid = tri[..., 9].view(torch.int32)[:, None].expand(
                m, LANES, leaf_size)
            for dst, src in ((t, tt), (prim, pid), (u, uu), (v, vv)):
                cur = dst[leafy]
                cur[win] = src.gather(2, best)[..., 0][win]
                dst[leafy] = cur
        if any_hit and bool(leaf_phase.any()):
            # In a leaf phase, a sub-packet whose active rays are all
            # occluded stops.
            done = leaf_sub & ~(act & (prim < 0)).any(dim=1)
            nsp[done] = 0
            lsp[done] = 0

        # ---- node phases -------------------------------------------------
        if nodal.numel():
            nsp[nodal] -= 1
            entry = nstack[nodal, nsp[nodal]]
            stats[nodal, 0] += 1
            row = rows[entry]
            bounds = row[:, None, :6 * ARITY].reshape(-1, 1, ARITY, 6)
            inv_l, oi_l = inv[nodal][:, :, None, :], oi[nodal][:, :, None, :]
            t0 = fma32(bounds[..., 0:3], inv_l, -oi_l)  # [m, 128, 8, 3]
            t1 = fma32(bounds[..., 3:6], inv_l, -oi_l)
            lo = torch.minimum(t0, t1)
            hi = torch.maximum(t0, t1)
            tmin = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]),
                                 lo[..., 2])
            tmax = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                                 hi[..., 2])
            child = rows_i[entry, 6 * ARITY:7 * ARITY].to(torch.int64)
            on = act[nodal]
            if any_hit:
                on = on & (prim[nodal] < 0)
            count_pops(pops, "node", entry)
            if pops is not None:
                pops["slabs"] = pops.get("slabs", 0) + int(on.sum())
            hit = ((tmin <= tmax) & (tmax > 0.0)
                   & (tmin < t[nodal][..., None]) & on[..., None]
                   & (child != INVALID_ENTRY)[:, None, :])
            pushed = hit.any(dim=1)                       # [m, 8]
            # Pushes in slot order, then (ordered) the nearest entered
            # child: the lowest slot at the smallest entry distance.
            last = torch.zeros_like(child[:, :1])
            last_on = torch.zeros_like(pushed[:, :1])
            if ordered:
                key = torch.where(hit, tmin, torch.inf).amin(dim=1)
                keymin = key.amin(dim=1, keepdim=True)
                near = torch.argmax(((key == keymin) & (keymin < torch.inf))
                                    .to(torch.uint8), dim=1, keepdim=True)
                last_on = pushed.any(dim=1, keepdim=True)
                last = child.gather(1, near)
                pushed = pushed.scatter(1, near, False)
            child = torch.cat([child, last], dim=1)       # [m, 9]
            pushed = torch.cat([pushed, last_on], dim=1)
            _push(nstack, nsp, nodal, child, pushed & (child >= 0),
                  stack_depth)
            _push(lstack, lsp, nodal, child, pushed & (child < 0),
                  LEAF_DEPTH)

    out = tuple(x.reshape(P, K) for x in (t, prim, u, v))
    if with_stats:
        return out + (stats.reshape(P, G, 2).sum(dim=1).to(torch.int32),)
    return out
