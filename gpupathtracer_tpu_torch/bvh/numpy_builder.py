"""NumPy binned-SAH BVH builder (portable fallback; no spatial splits).

Mirrors the object-split half of the reference SBVH builder
(src/core/BVH.cpp:1619-1763): 8 bins per axis with Wald-2007 projection,
suffix/prefix AABB sweeps, SAH comparison with the reference's cost model
(costTraversal=1.23, costIntersection=5.33, BVH.cpp:1592-1593) and the same
subdivision test `costTraversal + sah/SA(parent) < costIntersection * n`
(BVH.cpp:2123-2126). Spatial splits (the "S" in SBVH) live in the C++
builder; this one never duplicates references.
"""

from __future__ import annotations

import time
from typing import List, Tuple

import numpy as np

from gpupathtracer_tpu_torch.bvh.types import BinaryBVH, BuildStats

COST_TRAVERSAL = 1.23
COST_INTERSECTION = 5.33
NUM_BINS = 8


def _half_area(bmin: np.ndarray, bmax: np.ndarray) -> np.ndarray:
    """Half surface area (the reference's SAH uses half-SA, AABB.cpp)."""
    d = np.maximum(bmax - bmin, 0.0)
    return d[..., 0] * d[..., 1] + d[..., 1] * d[..., 2] + d[..., 2] * d[..., 0]


def build_binary_bvh(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                     max_leaf: int = 4, min_leaf: int = 1,
                     force_leaf: bool = False) -> Tuple[BinaryBVH, BuildStats]:
    """Build a binary BVH over world-space triangles.

    Args: p0/p1/p2 [T,3] float32 triangle vertices. max_leaf caps leaf size
    (must fit the 4-bit wide-leaf encoding, so <= 15). force_leaf packs any
    node with <= max_leaf refs into a leaf unconditionally — fatter leaves
    for packet/Pallas trees where pops, not triangle tests, are the
    expensive unit (each pop already pays a full-width row of tests).
    """
    assert 1 <= max_leaf <= 15
    t_start = time.perf_counter()
    T = p0.shape[0]
    tri_min = np.minimum(np.minimum(p0, p1), p2).astype(np.float32)
    tri_max = np.maximum(np.maximum(p0, p1), p2).astype(np.float32)
    centroid = (tri_min + tri_max) * 0.5

    # Working reference array, partitioned in place as we recurse.
    refs = np.arange(T, dtype=np.int32)

    bmin_l: List[np.ndarray] = []
    bmax_l: List[np.ndarray] = []
    left_l: List[int] = []
    right_l: List[int] = []
    first_l: List[int] = []
    count_l: List[int] = []

    def alloc_node() -> int:
        bmin_l.append(None)  # type: ignore[arg-type]
        bmax_l.append(None)  # type: ignore[arg-type]
        left_l.append(-1)
        right_l.append(-1)
        first_l.append(-1)
        count_l.append(0)
        return len(bmin_l) - 1

    root = alloc_node()
    # Stack of (node_index, lo, hi) half-open ranges into `refs`.
    stack: List[Tuple[int, int, int]] = [(root, 0, T)]
    num_leaves = 0
    max_depth_seen = 0
    depth_stack: List[int] = [1]

    while stack:
        node, lo, hi = stack.pop()
        depth = depth_stack.pop()
        max_depth_seen = max(max_depth_seen, depth)
        idx = refs[lo:hi]
        n = hi - lo
        nb_min = tri_min[idx].min(axis=0)
        nb_max = tri_max[idx].max(axis=0)
        bmin_l[node] = nb_min
        bmax_l[node] = nb_max

        def make_leaf() -> None:
            nonlocal num_leaves
            first_l[node] = lo
            count_l[node] = n
            num_leaves += 1

        if n <= min_leaf or (force_leaf and n <= max_leaf):
            make_leaf()
            continue

        c = centroid[idx]
        cb_min = c.min(axis=0)
        cb_max = c.max(axis=0)
        extent = cb_max - cb_min
        parent_sa = _half_area(nb_min, nb_max)

        best_sah = np.inf
        best_axis = -1
        best_cut = -1  # split after bins [0..cut]
        for axis in range(3):
            if extent[axis] <= 1e-12:
                continue
            # Wald 2007 projection (BVH.cpp:1533-1537).
            k1 = NUM_BINS * (1.0 - 1e-6) / extent[axis]
            bin_id = np.clip((k1 * (c[:, axis] - cb_min[axis])).astype(np.int32),
                             0, NUM_BINS - 1)
            counts = np.bincount(bin_id, minlength=NUM_BINS)
            # Per-bin AABBs via sort + reduceat (ufunc.at is slow in numpy).
            order = np.argsort(bin_id, kind="stable")
            sorted_min = tri_min[idx[order]]
            sorted_max = tri_max[idx[order]]
            starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
            nonempty = counts > 0
            bb_min = np.full((NUM_BINS, 3), np.inf, np.float32)
            bb_max = np.full((NUM_BINS, 3), -np.inf, np.float32)
            ne_starts = starts[nonempty]
            bb_min[nonempty] = np.minimum.reduceat(sorted_min, ne_starts, axis=0)
            bb_max[nonempty] = np.maximum.reduceat(sorted_max, ne_starts, axis=0)
            # Prefix (left) and suffix (right) sweeps (BVH.cpp:1648-1681).
            lmin = np.minimum.accumulate(bb_min, axis=0)
            lmax = np.maximum.accumulate(bb_max, axis=0)
            rmin = np.minimum.accumulate(bb_min[::-1], axis=0)[::-1]
            rmax = np.maximum.accumulate(bb_max[::-1], axis=0)[::-1]
            lcount = np.cumsum(counts)
            rcount = n - lcount
            sah = COST_INTERSECTION * (
                _half_area(lmin[:-1], lmax[:-1]) * lcount[:-1]
                + _half_area(rmin[1:], rmax[1:]) * rcount[:-1])
            sah = np.where((lcount[:-1] == 0) | (rcount[:-1] == 0), np.inf, sah)
            cut = int(np.argmin(sah))
            if sah[cut] < best_sah:
                best_sah = float(sah[cut])
                best_axis = axis
                best_cut = cut

        # Subdivision test (BVH.cpp:2123-2126, 2156-2165). A node with no
        # viable SAH split (coincident centroids) may only become a leaf if
        # it fits the leaf cap; otherwise force a median split below.
        leaf_cost = COST_INTERSECTION * n
        split_cost = COST_TRAVERSAL + best_sah / max(parent_sa, 1e-20)
        if n <= max_leaf and (best_axis < 0 or split_cost >= leaf_cost):
            make_leaf()
            continue

        if best_axis < 0:  # degenerate: split by index (coincident centroids)
            n_left = n // 2
        else:
            # Partition refs by the chosen bin cut (re-binning,
            # BVH.cpp:1685-1710).
            k1 = NUM_BINS * (1.0 - 1e-6) / extent[best_axis]
            bin_id = np.clip(
                (k1 * (c[:, best_axis] - cb_min[best_axis])).astype(np.int32),
                0, NUM_BINS - 1)
            go_left = bin_id <= best_cut
            n_left = int(go_left.sum())
            if n_left == 0 or n_left == n:  # numeric fallback: median split
                order = np.argsort(c[:, best_axis], kind="stable")
                refs[lo:hi] = idx[order]
                n_left = n // 2
            else:
                refs[lo:hi] = np.concatenate([idx[go_left], idx[~go_left]])

        lchild = alloc_node()
        rchild = alloc_node()
        left_l[node] = lchild
        right_l[node] = rchild
        stack.append((lchild, lo, lo + n_left)); depth_stack.append(depth + 1)
        stack.append((rchild, lo + n_left, hi)); depth_stack.append(depth + 1)

    bvh = BinaryBVH(
        bmin=np.stack(bmin_l).astype(np.float32),
        bmax=np.stack(bmax_l).astype(np.float32),
        left=np.asarray(left_l, np.int32),
        right=np.asarray(right_l, np.int32),
        first=np.asarray(first_l, np.int32),
        count=np.asarray(count_l, np.int32),
        refs=refs,
    )
    stats = BuildStats(
        num_triangles=T,
        num_refs=int(refs.shape[0]),
        num_binary_nodes=bvh.num_nodes,
        num_leaves=num_leaves,
        max_depth=max_depth_seen,
        sah_cost=_tree_sah_cost(bvh),
        build_seconds=time.perf_counter() - t_start,
    )
    return bvh, stats


def _tree_sah_cost(bvh: BinaryBVH) -> float:
    """Whole-tree SAH cost (role of CalculateCost, BVH.cpp:2174-2195)."""
    sa = _half_area(bvh.bmin, bvh.bmax)
    root_sa = max(float(sa[0]), 1e-20)
    is_leaf = bvh.count > 0
    cost = np.where(is_leaf, COST_INTERSECTION * bvh.count, COST_TRAVERSAL) * sa
    return float(cost.sum() / root_sa)
