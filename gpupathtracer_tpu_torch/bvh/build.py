"""Builder façade: pick the C++ SBVH builder when available, else numpy.

Role of BoundingVolumeHierarchy::BuildBinnedSpatial (src/core/BVH.cpp:2197):
build + flatten + report stats.
"""

from __future__ import annotations

import warnings
from typing import Optional, Tuple

import numpy as np

from gpupathtracer_tpu_torch.bvh.types import BuildStats, WideBVH
from gpupathtracer_tpu_torch.bvh.wide import collapse_to_wide


def build_wide_bvh(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                   leaf_size: int = 4, arity: int = 8,
                   builder: str = "auto",
                   spatial_splits: bool = True,
                   force_leaf: bool = False,
                   reinsert_rounds: int = 0,
                   verbose: bool = False) -> Tuple[WideBVH, BuildStats]:
    """Build the flattened wide BVH over world-space triangles [T, 3] each.

    force_leaf packs leaves to leaf_size unconditionally (fewer, fatter
    leaves — tuned for packet pops; see PERF.md leaf-density sweep)."""
    binary = None
    stats: Optional[BuildStats] = None

    if builder in ("auto", "cpp"):
        try:
            from gpupathtracer_tpu_torch.bvh.cpp import build_sbvh_cpp
            binary, stats = build_sbvh_cpp(p0, p1, p2, max_leaf=leaf_size,
                                           spatial_splits=spatial_splits,
                                           force_leaf=force_leaf,
                                           reinsert_rounds=reinsert_rounds)
        except Exception as e:
            if builder == "cpp":
                raise
            # "auto" goes on with a different tree; say so.
            warnings.warn(f"the C++ SBVH builder failed ({e!r}); building "
                          f"the BVH with the numpy builder instead",
                          RuntimeWarning, stacklevel=2)

    if binary is None:
        from gpupathtracer_tpu_torch.bvh.numpy_builder import build_binary_bvh
        binary, stats = build_binary_bvh(p0, p1, p2, max_leaf=leaf_size,
                                         force_leaf=force_leaf)

    wide, max_depth = collapse_to_wide(binary, arity=arity)
    assert stats is not None
    stats.num_wide_nodes = wide.num_nodes
    stats.max_depth = max_depth
    if verbose:
        print(stats.report())
    return wide, stats
