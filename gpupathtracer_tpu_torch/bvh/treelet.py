"""Treelet cut of the merged packet table.

Incoherent (bounce) rays are the throughput wall of the packet traversal:
a 2048-ray diffuse packet's shared stack visits ~11x more rows per ray than
a coherent packet (PERF.md packet-size sweep), because the packet union
covers most of the tree. Ray *sorting* cannot fix that — diffuse unions
stay huge under any grouping (measured round 1+2). What fixes it is
*binning rays by subtree*: if every packet is built from rays that enter
the SAME small subtree, the union is bounded by that subtree.

This module computes the static "cut": a frontier of ~`target` child
entries (subtree roots, in merged-row encoding — internal rows or packed
leaf entries) covering the whole tree, chosen by greedily expanding the
frontier entry with the largest surface area (the one most rays hit, hence
the one most worth splitting finer). The cut is attached to the WideBVH at
pack time. In the JAX package, ops/treelet.py uses it at trace time to
route each ray to its nearest unvisited treelet and run subtree-rooted
packets; this package has no treelet schedule yet (ROADMAP), so nothing
here reads the cut: it is built to keep the packed tables equal to the
JAX package's.

Role in the reference: none — its per-thread GPU traversal tolerates
incoherence natively (BVH.glsl:634-767). This is the TPU-first replacement
for that hardware property.
"""

from __future__ import annotations

import heapq

import numpy as np

from gpupathtracer_tpu_torch.bvh.types import INVALID_ENTRY


def _half_area(bounds: np.ndarray) -> float:
    """bounds [6] = (min.xyz, max.xyz)."""
    e = np.maximum(bounds[3:6] - bounds[0:3], 0.0)
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def build_treelet_cut(node_rows: np.ndarray, num_wide_nodes: int,
                      target: int = 128, arity: int = 8):
    """Greedy surface-area cut of the merged table.

    Args:
      node_rows: [M, 128] f32 merged table (bvh/wide.py pack_for_packets).
      num_wide_nodes: W — rows 0..W-1 are internal nodes.
      target: stop expanding once the frontier holds >= target entries.

    Returns (cut_entry [C] i32, cut_bounds [C, 6] f32) with C in
    [target, target + 7] unless the tree runs out of internal nodes first.
    Entries use the kernel's stack encoding (>= 0 internal row index,
    < 0 packed leaf). Bounds of an entry are its bounding box as stored in
    its PARENT row (the same box the traversal slab-tests before pushing
    it), so routing a ray to a treelet iff it hits cut_bounds visits
    exactly the subtrees the whole-tree traversal would descend into.
    """
    W = int(num_wide_nodes)
    bounds_all = node_rows[:W, 0:6 * arity].reshape(W, arity, 6)
    entry_all = node_rows[:W, 6 * arity:7 * arity].copy().view(np.int32)

    # Frontier of (neg-area, tiebreak, entry, bounds). Root row 0's box is
    # not stored anywhere (the traversal starts inside it); seed with the
    # root's children instead.
    heap = []
    tiebreak = 0

    def push(entry: int, bb: np.ndarray):
        nonlocal tiebreak
        heapq.heappush(heap, (-_half_area(bb), tiebreak, int(entry), bb))
        tiebreak += 1

    for j in range(arity):
        e = int(entry_all[0, j])
        if e != INVALID_ENTRY:
            push(e, bounds_all[0, j])

    done = []  # leaves + anything we stop expanding
    while heap and len(heap) + len(done) < target:
        _, _, e, bb = heapq.heappop(heap)
        if e < 0:  # leaf entry: nothing to expand
            done.append((e, bb))
            continue
        for j in range(arity):
            c = int(entry_all[e, j])
            if c != INVALID_ENTRY:
                push(c, bounds_all[e, j])

    items = done + [(e, bb) for _, _, e, bb in heap]
    if not items:  # degenerate single-node scene: the root itself
        items = [(0, np.array([-np.inf] * 3 + [np.inf] * 3, np.float32))]
    cut_entry = np.asarray([e for e, _ in items], np.int32)
    cut_bounds = np.stack([bb for _, bb in items]).astype(np.float32)
    return cut_entry, cut_bounds
