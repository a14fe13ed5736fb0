"""BVH data formats.

Builders (C++ SBVH or numpy binned-SAH) emit a *binary* BVH; a shared
collapse pass flattens it to the 8-wide traversal layout consumed by the JAX
and Pallas traversal kernels.

Wide layout (TPU-first redesign of the reference's 2-texel binary node
stream, src/core/BVH.cpp:2261-2277): one node = 8 child AABBs gathered as a
single [8, 6] block (vectorized slab test on the VPU) plus 8 encoded child
entries. Entry encoding:

  - ``INVALID_ENTRY``       : empty slot
  - ``e >= 0``              : internal child, wide-node index e
  - ``e < 0``               : leaf; packed = -(e+1); first_ref = packed >> 4,
                              count = packed & 15 (the reference packs leaves
                              as offset<<4|size too, BVH.cpp:467)
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import NamedTuple

import numpy as np

INVALID_ENTRY = np.int32(0x7FFFFFFF)


def encode_leaf_entry(first_ref: int, count: int):
    """Pack a leaf reference range into a negative entry (4-bit count)."""
    return -((first_ref << 4) | count) - 1


def decode_leaf_entry(entry):
    packed = -(entry + 1)
    return packed >> 4, packed & 15


@dataclass
class BinaryBVH:
    """Flat binary BVH (builder output). count > 0 marks a leaf."""

    bmin: np.ndarray    # [M, 3] f32
    bmax: np.ndarray    # [M, 3] f32
    left: np.ndarray    # [M] i32 (internal only)
    right: np.ndarray   # [M] i32
    first: np.ndarray   # [M] i32 first index into refs (leaf only)
    count: np.ndarray   # [M] i32 number of refs (0 = internal)
    refs: np.ndarray    # [R] i32 triangle indices (duplicated by SBVH splits)

    @property
    def num_nodes(self) -> int:
        return int(self.bmin.shape[0])


class WideBVH(NamedTuple):
    """Flattened 8-wide BVH; numpy or jnp arrays (pytree-compatible).

    Two mirrored layouts:
      - per-lane layout (child_bounds/child_entry/refs) for the vectorized
        per-ray traversal;
      - packed row layout (node_rows) for the packet traversal: ONE merged
        table holding both node rows and leaf rows, so a traversal step
        fetches exactly ONE row per packet per pop (TPU gathers cost
        ~constant per row regardless of width, measured ~28 ns/row on v5e;
        everything a step needs lives in one row).

    node_rows [W + L, 128] f32. Rows 0..W-1 are nodes: cols 0:48 = 8 children
    x (min.xyz, max.xyz), cols 48:56 = child entries (int32 bit-cast), rest
    pad. Rows W..W+L-1 are leaves: per triangle slot k (k < leaf_size, up to
    5 slots), 12 cols = (p0.xyz, e1.xyz, e2.xyz, prim_id bitcast, pad, pad);
    empty slots carry degenerate triangles (e1 = e2 = 0 never hits).
    Packet-layout leaf entries encode -((W + leaf_row) << 4 | count) - 1;
    the per-lane layout keeps -(first_ref << 4 | count) - 1.
    """

    child_bounds: np.ndarray  # [W, 8, 6] f32: [...,0:3]=min, [...,3:6]=max
    child_entry: np.ndarray   # [W, 8] i32 encoded entries (first_ref form)
    refs: np.ndarray          # [R] i32 triangle indices
    node_rows: np.ndarray = None     # [W+L, 128] f32 merged packet table
    packet_entry: np.ndarray = None  # [W, 8] i32 entries (merged-row form)
    cut_entry: np.ndarray = None     # [C] i32 treelet roots (bvh/treelet.py)
    cut_bounds: np.ndarray = None    # [C, 6] f32 treelet root bounds
    # Dense cluster-leaf layout (bvh/cluster.py): when present, node_rows
    # is the CLUSTER top tree (leaf entries = -(cluster_idx << 4 | 1) - 1)
    # and the Pallas kernel's leaf phase runs the MXU dense intersector
    # over blocks of cluster_rows; prim ids come back cluster-LOCAL
    # (cidx * Tc + slot) and are remapped through cluster_refs.
    cluster_rows: np.ndarray = None  # [Ncl*8, 3*Tc] f32 inverse-matrix blocks
    cluster_refs: np.ndarray = None  # [Ncl*Tc] i32 slot -> global prim id

    @property
    def num_nodes(self) -> int:
        return int(self.child_bounds.shape[0])


@dataclass
class BuildStats:
    """Build-quality metrics, printed by the reference every run
    (BVH.cpp:2218-2222) and used as a regression signal."""

    num_triangles: int = 0
    num_refs: int = 0
    num_binary_nodes: int = 0
    num_wide_nodes: int = 0
    num_leaves: int = 0
    max_depth: int = 0          # wide-tree depth (stack sizing)
    sah_cost: float = 0.0
    build_seconds: float = 0.0
    spatial_splits: int = 0

    @property
    def duplication_pct(self) -> float:
        if self.num_triangles == 0:
            return 0.0
        return 100.0 * (self.num_refs - self.num_triangles) / self.num_triangles

    @property
    def avg_refs_per_leaf(self) -> float:
        return self.num_refs / max(self.num_leaves, 1)

    def report(self) -> str:
        return (f"BVH: tris={self.num_triangles} refs={self.num_refs} "
                f"(dup {self.duplication_pct:.3f}%) wide_nodes={self.num_wide_nodes} "
                f"leaves={self.num_leaves} avg_refs/leaf={self.avg_refs_per_leaf:.3f} "
                f"depth={self.max_depth} sah={self.sah_cost:.1f} "
                f"build={self.build_seconds:.2f}s spatial_splits={self.spatial_splits}")
