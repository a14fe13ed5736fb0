"""ctypes binding for the native SBVH builder (builder_cpp/sbvh.cpp).

Compiles on first use with g++ (-O3), cached by source hash under the
package's ``_build/`` directory, beside the CUDA libraries (no pip/pybind
dependency; C ABI + ctypes). A copy of the JAX package's bvh/cpp.py that
differs only in where it keeps the library.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import time
from typing import Optional, Tuple

import numpy as np

from gpupathtracer_tpu_torch.bvh.types import BinaryBVH, BuildStats

_SRC = os.path.join(os.path.dirname(__file__), "builder_cpp", "sbvh.cpp")
_lib: Optional[ctypes.CDLL] = None


def _cache_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def _compile() -> str:
    with open(_SRC, "rb") as f:
        digest = hashlib.sha1(f.read()).hexdigest()[:16]
    so_path = os.path.join(_cache_dir(), f"libsbvh-{digest}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"  # concurrent test workers
        cmd = ["g++", "-O3", "-march=native", "-std=c++17", "-shared",
               "-fPIC", _SRC, "-o", tmp]
        subprocess.run(cmd, check=True, capture_output=True)
        os.replace(tmp, so_path)
    return so_path


def _load() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(_compile())
        lib.sbvh_build.restype = ctypes.c_void_p
        lib.sbvh_build.argtypes = [
            ctypes.POINTER(ctypes.c_float), ctypes.c_int32, ctypes.c_int32,
            ctypes.c_int32, ctypes.c_int32, ctypes.c_float, ctypes.c_int32,
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_int32),
            ctypes.POINTER(ctypes.c_int32), ctypes.POINTER(ctypes.c_double)]
        lib.sbvh_copy.restype = None
        lib.sbvh_copy.argtypes = [ctypes.c_void_p] + \
            [ctypes.POINTER(ctypes.c_float)] * 2 + \
            [ctypes.POINTER(ctypes.c_int32)] * 5
        lib.sbvh_free.restype = None
        lib.sbvh_free.argtypes = [ctypes.c_void_p]
        _lib = lib
    return _lib


def build_sbvh_cpp(p0: np.ndarray, p1: np.ndarray, p2: np.ndarray,
                   max_leaf: int = 4, spatial_splits: bool = True,
                   force_leaf: bool = False,
                   alpha: float = 1e-5,
                   reinsert_rounds: int = 0) -> Tuple[BinaryBVH, BuildStats]:
    """Build a binary SBVH natively. alpha is the spatial-split trigger
    threshold (overlap area / root area), 1e-5 like BVH.cpp:2135.
    force_leaf packs leaves to max_leaf unconditionally (packet trees).
    reinsert_rounds > 0 runs the Bittner-2013 insertion-based optimizer
    (the pass the reference stubbed out, BVH.cpp:2303-2397)."""
    lib = _load()
    t0 = time.perf_counter()
    tris = np.ascontiguousarray(
        np.concatenate([p0, p1, p2], axis=1), dtype=np.float32)
    n = np.int32(tris.shape[0])

    o_nodes = ctypes.c_int32()
    o_refs = ctypes.c_int32()
    o_leaves = ctypes.c_int32()
    o_depth = ctypes.c_int32()
    o_spatial = ctypes.c_int32()
    o_sah = ctypes.c_double()
    handle = lib.sbvh_build(
        tris.ctypes.data_as(ctypes.POINTER(ctypes.c_float)), n,
        np.int32(max_leaf), np.int32(1 if spatial_splits else 0),
        np.int32(1 if force_leaf else 0), np.float32(alpha),
        np.int32(reinsert_rounds),
        ctypes.byref(o_nodes), ctypes.byref(o_refs), ctypes.byref(o_leaves),
        ctypes.byref(o_depth), ctypes.byref(o_spatial), ctypes.byref(o_sah))
    try:
        m, r = o_nodes.value, o_refs.value
        bmin = np.empty((m, 3), np.float32)
        bmax = np.empty((m, 3), np.float32)
        left = np.empty(m, np.int32)
        right = np.empty(m, np.int32)
        first = np.empty(m, np.int32)
        count = np.empty(m, np.int32)
        refs = np.empty(r, np.int32)
        lib.sbvh_copy(handle,
                      bmin.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      bmax.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
                      left.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                      right.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                      first.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                      count.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
                      refs.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)))
    finally:
        lib.sbvh_free(handle)

    bvh = BinaryBVH(bmin=bmin, bmax=bmax, left=left, right=right,
                    first=first, count=count, refs=refs)
    stats = BuildStats(
        num_triangles=int(n), num_refs=r, num_binary_nodes=m,
        num_leaves=o_leaves.value, max_depth=o_depth.value,
        sah_cost=float(o_sah.value), spatial_splits=o_spatial.value,
        build_seconds=time.perf_counter() - t0)
    return bvh, stats
