"""The BVH builders and table layouts: a copy of the JAX package's jax-free
``bvh`` package (C++ SBVH through ctypes, the numpy builder, the 8-wide
collapse, ``pack_for_packets``, the treelet cut and the dense cluster
leaves), so that the port imports nothing of that package and both build
byte-identical tables (tests/test_torch_scene.py)."""

from gpupathtracer_tpu_torch.bvh.types import BinaryBVH, WideBVH, BuildStats, INVALID_ENTRY
from gpupathtracer_tpu_torch.bvh.build import build_wide_bvh

__all__ = ["BinaryBVH", "WideBVH", "BuildStats", "INVALID_ENTRY", "build_wide_bvh"]
