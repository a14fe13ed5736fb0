"""Traversal debug trails (counterpart of the JAX package's ops/debug.py).

Role of the reference's 4 MB debug SSBO and P-key binary trail dump
(Renderer.cpp:594-595, 664-678): per-ray counters of traversal work,
dumpable to disk for offline analysis (visits a ray track SAH quality).
The counters are those of the per-ray walk (ops/traverse.py
``_traverse``): pops, node expansions and triangle tests of each ray.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from gpupathtracer_tpu_torch.ops.traverse import _traverse


class TraversalTrail(NamedTuple):
    pops: torch.Tensor         # [N] stack pops a ray
    node_visits: torch.Tensor  # [N] internal-node expansions
    leaf_tests: torch.Tensor   # [N] triangle tests
    t: torch.Tensor            # [N] closest hit distance
    prim: torch.Tensor         # [N]


def closest_hit_trail(scene, o, d, t_max, stack_depth: int = 48,
                      leaf_size: int = 4) -> TraversalTrail:
    """The per-ray closest-hit walk of every ray, with its counters.
    ``scene`` as ops/traverse.py ``closest_hit`` takes it."""
    active = torch.ones(o.shape[0], dtype=torch.bool, device=o.device)
    t, prim, _, _, counts = _traverse(scene, o, d, t_max, active,
                                      stack_depth, leaf_size, False,
                                      counters=True)
    return TraversalTrail(pops=counts[0], node_visits=counts[1],
                          leaf_tests=counts[2], t=t, prim=prim)


def dump_trails(trail: TraversalTrail, path: str) -> str:
    """Binary dump, [N, 3] int32 (pops, node visits, triangle tests) in C
    order (role of the P-key debugBuf dump, Renderer.cpp:664-678)."""
    os.makedirs(os.path.dirname(os.path.abspath(path)), exist_ok=True)
    arr = np.stack([trail.pops.cpu().numpy(), trail.node_visits.cpu().numpy(),
                    trail.leaf_tests.cpu().numpy()], axis=1).astype(np.int32)
    arr.tofile(path)
    return path
