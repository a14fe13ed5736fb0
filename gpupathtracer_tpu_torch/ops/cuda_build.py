"""Build of the port's CUDA sources (``csrc/*.cu``) with nvcc into shared
libraries with a plain C interface, which the kernel wrappers load with
ctypes. A library is keyed by the hash of its source, every header of
``csrc/`` and the flags, and built once into ``_build/``.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
from typing import Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# --fmad=false: nvcc contracts nothing; the kernels write every fused
# multiply-add they mean as __fmaf_rn, as their plain versions do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ at first use")
    return path


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def build(name: str) -> Tuple[str, str]:
    """Compile csrc/<name>.cu unless a library for these sources and flags
    exists. Returns (library path, ptxas report of that build)."""
    digest = hashlib.sha1(" ".join(NVCC_FLAGS).encode())
    for path in [source(name)] + sorted(glob.glob(os.path.join(CSRC,
                                                               "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}")
    so_path, log_path = stem + ".so", stem + ".log"
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{stem}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *NVCC_FLAGS, "-o", tmp, source(name)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source(name)}:\n"
                               f"{proc.stderr}")
        with open(log_path, "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, so_path)
    with open(log_path) as f:
        return so_path, f.read()
