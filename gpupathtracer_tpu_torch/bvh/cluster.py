"""Dense cluster leaves: cut the wide BVH at ~Tc-triangle subtrees.

VERDICT r3 #3: leaf pops are 46% of incoherent closest-hit cost and the
per-pop latency chain (~460 ns) is the measured floor — the lever is to
change what a pop *is*. This module re-tunes the tree for FAT leaves:
maximal subtrees holding <= Tc triangle refs become single "cluster"
leaves, stored as pre-transposed inverse-matrix blocks so one pop
intersects the whole packet against the whole cluster as two MXU matmuls
per 128-ray tile plus a branch-free VPU epilogue (ops/pallas_traverse.py
_kernel_cluster). One cluster pop replaces the subtree's ~Tc/leaf_size
leaf pops AND all its internal-node pops.

The cut runs on the collapsed wide tree (which is what the scene cache
stores): subtree ref counts bottom-up, then a top-down descent that
first-fit-decreasing bin-packs small sibling subtrees into <= Tc groups
(a group's triangles are deduped across SBVH duplicates — safe for both
closest and any hit). The remaining top tree is re-widened to `arity`
children per node (greedy largest-area expansion, same policy as
bvh/wide.py collapse) and packed into the standard 128-lane node-row
layout; cluster leaf entries encode -(cluster_idx << 4 | 1) - 1.

Triangle data per cluster is the Arenberg/inverse-matrix form of
ops/dense_intersect.py (the idea behind the reference's unused
IntersectTriangleArenberg, src/shaders/common/Geometry.glsl:279-310),
laid out contraction-major for the MXU: block [8, 3*Tc] f32 where rows
0:3 = wd (A.d/B.d/C.d coefficients), rows 3:7 = wo4 (origin terms with
the per-triangle constants folded into the homogeneous row), row 7
spare. Lanes are [A | B | C] thirds; padding columns are all-zero and
can never produce a valid hit (0/0 = NaN fails every comparison).
"""

from __future__ import annotations

from typing import List, Tuple

import numpy as np

from gpupathtracer_tpu_torch.bvh.types import (INVALID_ENTRY, WideBVH,
                                         decode_leaf_entry,
                                         encode_leaf_entry)

ROW_WIDTH = 128


def _entry_size(e: int, size: np.ndarray) -> int:
    if e < 0:
        _, cnt = decode_leaf_entry(e)
        return int(cnt)
    return int(size[e])


def _subtree_sizes(child_entry: np.ndarray) -> np.ndarray:
    """Refs under each wide node (BFS order => reverse sweep sees kids)."""
    W = child_entry.shape[0]
    size = np.zeros(W, np.int64)
    for w in range(W - 1, -1, -1):
        s = 0
        for e in child_entry[w]:
            e = int(e)
            if e == INVALID_ENTRY:
                continue
            s += _entry_size(e, size)
        size[w] = s
    return size


def _collect_tris(e: int, child_entry: np.ndarray,
                  refs: np.ndarray) -> np.ndarray:
    """All triangle ids under entry e (deduped; SBVH may duplicate)."""
    out: List[np.ndarray] = []
    stack = [int(e)]
    while stack:
        cur = stack.pop()
        if cur < 0:
            first, cnt = decode_leaf_entry(cur)
            out.append(refs[first:first + cnt])
        else:
            for c in child_entry[cur]:
                c = int(c)
                if c != INVALID_ENTRY:
                    stack.append(c)
    return np.unique(np.concatenate(out)) if out else np.zeros(0, np.int64)


class _Node:
    __slots__ = ("children",)

    def __init__(self):
        # list of (child, bounds[6]); child = int cluster-leaf entry code
        # or a _Node.
        self.children: List[Tuple[object, np.ndarray]] = []


def _union(bbs: List[np.ndarray]) -> np.ndarray:
    bb = np.stack(bbs)
    return np.concatenate([bb[:, 0:3].min(0), bb[:, 3:6].max(0)])


def _half_area(bb: np.ndarray) -> float:
    e = np.maximum(bb[3:6] - bb[0:3], 0.0)
    return float(e[0] * e[1] + e[1] * e[2] + e[2] * e[0])


def build_cluster_cut(wide: WideBVH, tc: int):
    """Cut the wide tree into a cluster top tree.

    Returns (root _Node, clusters: list of int64 tri-id arrays). Every
    input triangle appears in >= 1 cluster; each cluster has <= tc tris.
    """
    ce = np.asarray(wide.child_entry)
    cb = np.asarray(wide.child_bounds)
    refs = np.asarray(wide.refs).astype(np.int64)
    size = _subtree_sizes(ce)
    clusters: List[np.ndarray] = []

    def make_cluster(entries: List[int], bbs: List[np.ndarray]):
        tri = np.unique(np.concatenate(
            [_collect_tris(e, ce, refs) for e in entries]))
        assert 0 < len(tri) <= tc, (len(tri), tc)
        cidx = len(clusters)
        clusters.append(tri)
        return encode_leaf_entry(cidx, 1), _union(bbs)

    def build(w: int) -> _Node:
        node = _Node()
        small: List[Tuple[int, np.ndarray, int]] = []
        for j in range(ce.shape[1]):
            e = int(ce[w, j])
            if e == INVALID_ENTRY:
                continue
            s = _entry_size(e, size)
            if s == 0:
                continue
            if s > tc:  # must be internal (leaves hold <= 15)
                node.children.append((build(e), cb[w, j].copy()))
            else:
                small.append((e, cb[w, j].copy(), s))
        # First-fit-decreasing packing of sibling subtrees into clusters.
        # Summed sizes are conservative (dedup only shrinks).
        small.sort(key=lambda x: -x[2])
        groups: List[List[Tuple[int, np.ndarray, int]]] = []
        for item in small:
            for grp in groups:
                if sum(g[2] for g in grp) + item[2] <= tc:
                    grp.append(item)
                    break
            else:
                groups.append([item])
        for grp in groups:
            code, bb = make_cluster([g[0] for g in grp],
                                    [g[1] for g in grp])
            node.children.append((code, bb))
        return node

    root_size = int(size[0]) if len(size) else 0
    if root_size == 0:
        # Degenerate empty scene: single empty node.
        return _Node(), clusters
    if root_size <= tc:
        node = _Node()
        rb = np.concatenate([cb[0, :, 0:3].min(0), cb[0, :, 3:6].max(0)])
        code, bb = make_cluster([0] if size[0] else [], [rb])
        node.children.append((code, bb))
        return node, clusters
    return build(0), clusters


def _rewiden(node: _Node, arity: int) -> None:
    """Greedy largest-area expansion so top-tree nodes carry up to `arity`
    children (hoisting grandchildren reduces pop count; same policy as
    bvh/wide.py collapse_to_wide)."""
    while len(node.children) < arity:
        best, best_a = -1, -1.0
        for i, (c, bb) in enumerate(node.children):
            if isinstance(c, _Node):
                a = _half_area(bb)
                if a > best_a and len(node.children) - 1 + \
                        len(c.children) <= arity:
                    best, best_a = i, a
        if best < 0:
            break
        c, _ = node.children.pop(best)
        node.children.extend(c.children)
    for c, _ in node.children:
        if isinstance(c, _Node):
            _rewiden(c, arity)


def pack_clusters(wide: WideBVH, tri_p0: np.ndarray, tri_e1: np.ndarray,
                  tri_e2: np.ndarray, tc: int = 128, arity: int = 8,
                  tri_mat: np.ndarray = None,
                  tri_nsign: np.ndarray = None) -> WideBVH:
    """Attach the cluster layout to a collapsed wide BVH.

    Replaces node_rows/packet_entry/cut_* with the CLUSTER top tree and
    fills cluster_rows [Ncl*8, 3*tc] + cluster_refs [Ncl*tc]. The
    per-lane layout (child_bounds/child_entry/refs) keeps the full tree
    so non-cluster paths (reference traversal, partition builder) still
    work off the same WideBVH.

    tri_mat/tri_nsign: optional per-triangle material id + shading-normal
    sign. Packed into spare row 7 lanes [0:tc] as ONE signed float,
    (mat_id + 1) * nsign (exact for mat < 2^23): the megakernel's cluster
    walk captures it — together with the winner's normal direction, which
    needs no storage at all (the stored C row is parallel to e1 x e2) —
    through a single one-hot [4, tc] x [tc, 128] matmul per ray tile.
    """
    assert tc % 128 == 0 and tc >= 128, "cluster capacity in 128 multiples"
    root, clusters = build_cluster_cut(wide, tc)
    _rewiden(root, arity)

    # --- BFS flatten ------------------------------------------------------
    order: List[_Node] = [root]
    index = {id(root): 0}
    q = [root]
    while q:
        n = q.pop(0)
        for c, _ in n.children:
            if isinstance(c, _Node):
                index[id(c)] = len(order)
                order.append(c)
                q.append(c)
    Wc = len(order)
    bounds = np.zeros((Wc, arity, 6), np.float32)
    bounds[..., 0:3] = np.float32(np.inf)
    bounds[..., 3:6] = np.float32(-np.inf)
    entries = np.full((Wc, arity), INVALID_ENTRY, np.int32)
    for w, n in enumerate(order):
        assert len(n.children) <= arity
        for j, (c, bb) in enumerate(n.children):
            bounds[w, j] = bb
            entries[w, j] = index[id(c)] if isinstance(c, _Node) else c

    node_rows = np.zeros((Wc, ROW_WIDTH), np.float32)
    node_rows[:, 0:6 * arity] = bounds.reshape(Wc, 6 * arity)
    node_rows[:, 6 * arity:7 * arity] = entries.view(np.float32)

    # --- cluster tables -----------------------------------------------------
    from gpupathtracer_tpu_torch.bvh.dense_intersect import inverse_rows
    Ncl = max(len(clusters), 1)
    crows = np.zeros((Ncl * 8, 3 * tc), np.float32)
    crefs = np.zeros((Ncl * tc,), np.int32)
    tg = np.concatenate([tri_p0, tri_e1, tri_e2], axis=1)
    for cidx, tri in enumerate(clusters):
        T = len(tri)
        A, B, C, p0 = inverse_rows(tg[tri])
        p64 = p0.astype(np.float64)  # fold constants at f64 (as dense does)
        blk = crows[cidx * 8:(cidx + 1) * 8]
        for k, M in enumerate((A, B, C)):
            blk[0:3, k * tc:k * tc + T] = M.T          # wd rows
        blk[3:6, 0 * tc:0 * tc + T] = A.T              # wo4 rows
        blk[6, 0 * tc:0 * tc + T] = -np.einsum("ij,ij->i",
                                               A.astype(np.float64), p64)
        blk[3:6, 1 * tc:1 * tc + T] = B.T
        blk[6, 1 * tc:1 * tc + T] = -np.einsum("ij,ij->i",
                                               B.astype(np.float64), p64)
        blk[3:6, 2 * tc:2 * tc + T] = -C.T             # negated: t = num/dc
        blk[6, 2 * tc:2 * tc + T] = np.einsum("ij,ij->i",
                                              C.astype(np.float64), p64)
        if tri_mat is not None:
            sgn = (tri_nsign[tri] if tri_nsign is not None
                   else np.ones(T, np.float32))
            blk[7, 0:T] = (tri_mat[tri].astype(np.float32) + 1.0) * sgn
        crefs[cidx * tc:cidx * tc + T] = tri

    from gpupathtracer_tpu_torch.bvh.treelet import build_treelet_cut
    cut_entry, cut_bounds = build_treelet_cut(node_rows, Wc, arity=arity)

    return wide._replace(node_rows=node_rows, packet_entry=entries,
                         cut_entry=cut_entry, cut_bounds=cut_bounds,
                         cluster_rows=crows, cluster_refs=crefs)
