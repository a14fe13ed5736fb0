"""Packet BVH traversal (counterpart of the JAX package's
ops/packet_traverse.py, ``traversal="packet"``), in plain torch.

K rays share one traversal stack (a packet) and P packets advance in
lockstep: a step pops one entry of each live packet's stack and fetches
one merged 128-float row (bvh/wide.py ``pack_for_packets``: 8-wide node
rows, leaf rows of up to 10 MT-ready triangle slots). A node row is
slab-tested against every ray of the packet ([P, 8, K]); a child any
active ray enters is pushed, ordered by the nearest entry among the
packet's rays (unordered for any-hit). A leaf row's triangles are tested
against every ray of the packet. Pushes past ``stack_depth`` are dropped.

The JAX package's lockstep-tail compaction is kept with its caps: a first
pass of at most ``pass1_cap`` steps over all packets, then up to
``outer_cap`` rounds that move the live packets to the front (a stable
sort) and step the first P / ``prefix_div`` of them up to ``pass2_cap``
times; closest-hit only, and only from 4 * ``prefix_div`` packets up. An
any-hit packet stops once each of its active rays has a hit.

The slab test is the JAX package's; the triangle test has the CUDA
kernels' rounding (ops/intersect.py ``mt_xyz``), so the hits are those of
the other traversals (ops/traverse.py). Each step is a host loop
iteration that reads whether any packet is live. On CUDA tensors a walk
still live after GRAPH_AFTER steps replays its step as a CUDA graph,
reading the live count every GRAPH_STEPS steps: a step is some 200 small
kernels, which the device runs faster than Python launches them.

Layouts: rays [P, 3, K] in the loop, per-ray state [P, K], stacks [P, D],
rows [W + L, 128].
"""

from __future__ import annotations

import torch

from gpupathtracer_tpu_torch.ops.intersect import mt_xyz
from gpupathtracer_tpu_torch.ops.kernel_traverse import INVALID_ENTRY
from gpupathtracer_tpu_torch.ops.traverse import Hit, _safe_inv


def _mt_leaf(tri, oT, dT):
    """A leaf row's triangles against its packet's rays: tri [P, L, 12]
    (p0, e1, e2, ...); oT, dT [P, 3, K]. Returns (t, u, v, hit) [P, L,
    K]."""
    def tri_xyz(a):
        return [tri[:, :, a + i, None] for i in range(3)]
    return mt_xyz(tri_xyz(0), tri_xyz(3), tri_xyz(6),
                  [oT[:, None, i] for i in range(3)],
                  [dT[:, None, i] for i in range(3)])


def _step(rows, st, stack_depth: int, leaf_size: int, any_hit_mode: bool,
          phases=None):
    """One pop of every packet in ``st`` (the JAX ``step``). Returns the
    new state and whether any packet was live. ``phases`` None reads that,
    and whether a packet pops a node or a leaf, from the device (one host
    read) and runs only the phases some packet needs; (True, True) runs
    both without a read (a step on no live packet changes nothing)."""
    stack, sp, t, prim, uu, vv, found, oT, dT, invT, act, orig = st
    Pc, K = t.shape
    prow = torch.arange(Pc, device=sp.device)
    live = sp > 0
    entry = stack[prow, torch.clamp_min(sp - 1, 0)]
    is_leaf = live & (entry < 0)
    is_node = live & (entry >= 0)
    if phases is None:
        phases = torch.stack([is_node.any(), is_leaf.any()]).tolist()
    any_node, any_leaf = phases
    if not (any_node or any_leaf):
        return st, False
    sp = torch.where(live, sp - 1, sp)
    rays_on = act & ~found if any_hit_mode else act

    # One merged-row fetch per packet.
    lpacked = torch.where(is_leaf, -(entry + 1), 0)
    ridx = torch.where(is_leaf, lpacked >> 4, torch.where(is_node, entry, 0))
    row = rows[ridx]                                     # [Pc, 128]

    if any_node:
        # Per-ray slab tests over the 8 children, the three axes at once
        # (the JAX walk takes max / min over them in turn: the same).
        bounds = row[:, 0:48].reshape(Pc, 8, 6, 1)
        centry = row[:, 48:56].contiguous().view(torch.int32).to(torch.int64)
        t0 = (bounds[:, :, 0:3] - oT[:, None]) * invT[:, None]
        t1 = (bounds[:, :, 3:6] - oT[:, None]) * invT[:, None]
        tmin = torch.amax(torch.minimum(t0, t1), dim=2)  # [Pc, 8, K]
        tmx = torch.amin(torch.maximum(t0, t1), dim=2)
        rhit = ((tmin <= tmx) & (tmx > 0.0) & (tmin < t[:, None, :])
                & rays_on[:, None, :])
        chit = (rhit.any(dim=2) & (centry != INVALID_ENTRY)
                & is_node[:, None])
        if not any_hit_mode:  # any-hit pushes unordered
            near = torch.where(rhit, tmin, torch.inf).amin(dim=2)
            order = torch.argsort(torch.where(chit, near, torch.inf), dim=1,
                                  stable=True)
            centry = torch.gather(centry, 1, order)
            chit = torch.gather(chit, 1, order)
        incl = torch.cumsum(chit.to(torch.int64), dim=1)
        total = incl[:, -1]
        # The nearest ends up on top; pushes past the bound go to the
        # stack's spare last column, which no pop reads.
        pos = sp[:, None] + total[:, None] - incl
        stack = stack.scatter(1, torch.where(chit & (pos < stack_depth), pos,
                                             stack_depth), centry)
        sp = torch.where(is_node, torch.clamp_max(sp + total, stack_depth),
                         sp)

    if any_leaf:
        # The row's triangles against every ray of the packet. The JAX
        # walk tests the slots in turn, each against the t the earlier
        # ones left: that keeps the first of the nearest hits, as the
        # first argmin over all slots at once does.
        lcount = lpacked & 15
        tri = row[:, :12 * leaf_size].reshape(Pc, leaf_size, 12)
        tt, tu, tv, th = _mt_leaf(tri, oT, dT)
        slot = torch.arange(leaf_size, device=t.device)
        ok = (th & (tt < t[:, None, :]) & rays_on[:, None, :]
              & (is_leaf[:, None] & (slot < lcount[:, None]))[:, :, None])
        best = torch.argmin(torch.where(ok, tt, torch.inf), dim=1,
                            keepdim=True)
        win = ok.any(dim=1)
        pid = tri[:, :, 9].contiguous().view(torch.int32)
        t = torch.where(win, tt.gather(1, best)[:, 0], t)
        prim = torch.where(win, pid.gather(1, best[:, 0]), prim)
        uu = torch.where(win, tu.gather(1, best)[:, 0], uu)
        vv = torch.where(win, tv.gather(1, best)[:, 0], vv)
        if any_hit_mode:
            found = found | (prim >= 0)
            sp = torch.where((found | ~act).all(dim=1), 0, sp)
    return (stack, sp, t, prim, uu, vv, found, oT, dT, invT, act, orig), True


def _traverse_packets(rows, o, d, t_max, active, stack_depth: int,
                      leaf_size: int, any_hit_mode: bool,
                      pass1_cap: int = 48, prefix_div: int = 32,
                      pass2_cap: int = 8192, outer_cap: int = 64):
    """rows: merged [W + L, 128] table; o, d: [P, K, 3]; t_max, active:
    [P, K]. Returns (t, prim, u, v, hit-or-found), each [P, K]."""
    P, K = t_max.shape
    dev = o.device
    oT0 = o.permute(0, 2, 1)
    dT0 = d.permute(0, 2, 1)
    # The stack's last column takes the pushes that are dropped.
    stack = torch.zeros((P, stack_depth + 1), dtype=torch.int64, device=dev)
    sp = active.any(dim=1).to(torch.int64)  # the root entry is node 0
    state = (stack, sp, t_max.to(torch.float32).clone(),
             torch.full((P, K), -1, dtype=torch.int32, device=dev),
             torch.zeros((P, K), dtype=torch.float32, device=dev),
             torch.zeros((P, K), dtype=torch.float32, device=dev),
             torch.zeros((P, K), dtype=torch.bool, device=dev),
             oT0, dT0, _safe_inv(dT0), active,
             torch.arange(P, device=dev))  # each packet's original slot

    graphs = {}

    def run_capped(st, cap: int):
        """Steps while any packet is live, at most ``cap`` times (0: no
        cap). On CUDA a walk still live after GRAPH_AFTER steps goes on as
        a replayed graph (at once where this call has one of its packet
        count)."""
        it = 0
        while cap <= 0 or it < cap:
            if st[1].is_cuda and (it >= GRAPH_AFTER
                                  or st[1].shape[0] in graphs):
                return _run_graphed(graphs, rows, st,
                                    cap - it if cap > 0 else 0, stack_depth,
                                    leaf_size, any_hit_mode)
            st, live = _step(rows, st, stack_depth, leaf_size, any_hit_mode)
            if not live:
                break
            it += 1
        return st

    # Shadow / any-hit walks are shallow (early exit): compaction's sort
    # and permute cost more than the tail there.
    if any_hit_mode or P < 4 * prefix_div:
        st = run_capped(state, 0)
    else:
        st = run_capped(state, pass1_cap)
        pc2 = P // prefix_div
        rounds = 0
        while bool((st[1] > 0).any()) and rounds < outer_cap:
            order = torch.argsort((st[1] <= 0).to(torch.int32), stable=True)
            st = tuple(a[order] for a in st)
            sub = run_capped(tuple(a[:pc2] for a in st), pass2_cap)
            st = tuple(torch.cat([s, a[pc2:]]) for a, s in zip(st, sub))
            rounds += 1

    _, _, t, prim, uu, vv, found, _, _, _, _, orig = st
    inv = torch.argsort(orig)  # undo the compaction's permutation
    t, prim, uu, vv, found = (a[inv] for a in (t, prim, uu, vv, found))
    return t, prim, uu, vv, (found if any_hit_mode else prim >= 0)


# On CUDA: eager steps before a walk is captured as a graph (a short walk
# does not pay the capture), and steps replayed between two reads of
# whether any packet is live.
GRAPH_AFTER = 32
GRAPH_STEPS = 16


def _run_graphed(graphs: dict, rows, st, cap: int, stack_depth: int,
                 leaf_size: int, any_hit_mode: bool):
    """``run_capped`` on CUDA tensors: a step (both phases, no host read)
    is captured once per packet count (``graphs``, one traversal's) as a
    CUDA graph that writes the new state over its input; it is replayed
    up to GRAPH_STEPS times between reads of whether any packet is still
    live, never more than ``cap`` times in all (0: no cap)."""
    n = st[1].shape[0]
    if n not in graphs:
        static = tuple(a.clone() for a in st)
        args = (rows, static, stack_depth, leaf_size, any_hit_mode,
                (True, True))
        side = torch.cuda.Stream(device=rows.device)
        side.wait_stream(torch.cuda.current_stream(rows.device))
        with torch.cuda.stream(side):  # warm-up, as capture requires
            _step(*args)
        torch.cuda.current_stream(rows.device).wait_stream(side)
        graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(graph):
            out, _ = _step(*args)
            for a, b in zip(static, out):
                if a is not b:
                    a.copy_(b)
            live = (static[1] > 0).any()
        graphs[n] = (graph, static, live)
    graph, static, live = graphs[n]
    for a, b in zip(static, st):
        a.copy_(b)
    it = 0
    while cap <= 0 or it < cap:
        for _ in range(GRAPH_STEPS if cap <= 0 else min(GRAPH_STEPS,
                                                        cap - it)):
            graph.replay()
            it += 1
        if not bool(live):
            break
    return tuple(a.clone() for a in static)


def _packets(node_rows, o, d, t_max, active, leaf_size: int,
             packet_size: int):
    n = o.shape[0]
    if leaf_size > 10:
        raise ValueError("the packet walk reads single-row leaves "
                         "(leaf_size <= 10)")
    if n % packet_size:
        raise ValueError(f"{n} rays are not whole packets of {packet_size}")
    if active is None:
        active = torch.ones(n, dtype=torch.bool, device=o.device)
    P = n // packet_size
    return (node_rows, o.reshape(P, packet_size, 3),
            d.reshape(P, packet_size, 3), t_max.reshape(P, packet_size),
            active.reshape(P, packet_size)), active


def closest_hit_packets(node_rows, o, d, t_max, active=None,
                        stack_depth: int = 48, leaf_size: int = 4,
                        packet_size: int = 128) -> Hit:
    """Packet closest-hit on an 8-wide MT-leaf table. o, d: [N, 3]; N
    must divide by packet_size. Returns a Hit of flat [N] tensors."""
    args, _ = _packets(node_rows, o, d, t_max, active, leaf_size,
                       packet_size)
    t, prim, u, v, _ = _traverse_packets(*args, stack_depth, leaf_size,
                                         False)
    return Hit(t=t.reshape(-1), prim=prim.reshape(-1), u=u.reshape(-1),
               v=v.reshape(-1))


def any_hit_packets(node_rows, o, d, t_max, active=None,
                    stack_depth: int = 48, leaf_size: int = 4,
                    packet_size: int = 128) -> torch.Tensor:
    """Packet any-hit: occluded [N] bool."""
    args, active = _packets(node_rows, o, d, t_max, active, leaf_size,
                            packet_size)
    _, _, _, _, occ = _traverse_packets(*args, stack_depth, leaf_size, True)
    return occ.reshape(-1) & active
