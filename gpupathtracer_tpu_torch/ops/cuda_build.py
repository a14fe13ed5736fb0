"""Build of the port's CUDA sources (``csrc/*.cu``) with nvcc into shared
libraries with a plain C interface, which the kernel wrappers load with
ctypes. A library is keyed by the hash of its source, every header of
``csrc/``, the flags and its defines, and built once into ``_build/``.
The walks are built once per node arity they are called at
(``arity_defines``: ``-DGPT_ARITY=A``); the default arity, 8, passes no
define, so its key and flags are those of a build without any.
"""

from __future__ import annotations

import glob
import hashlib
import os
import shutil
import subprocess
from typing import Sequence, Tuple

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC = os.path.join(_PKG, "csrc")
BUILD_DIR = os.path.join(_PKG, "_build")
# --fmad=false: nvcc contracts nothing; the kernels write every fused
# multiply-add they mean as __fmaf_rn, as their plain versions do.
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "--fmad=false",
              "-Xptxas", "-v")
# The node arity of a build without -DGPT_ARITY (csrc/bvh_walk.cuh).
DEFAULT_ARITY = 8


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the port's CUDA kernels are "
                           "built from csrc/ at first use")
    return path


def source(name: str) -> str:
    return os.path.join(CSRC, f"{name}.cu")


def arity_defines(arity: int) -> Tuple[str, ...]:
    """The defines of a walk source's build at a node arity (2-16): none
    at the default 8 (csrc/bvh_walk.cuh GPT_ARITY)."""
    if not 2 <= arity <= 16:
        raise ValueError(f"node arity {arity} outside 2..16")
    return () if arity == DEFAULT_ARITY else (f"-DGPT_ARITY={arity}",)


def build(name: str, defines: Sequence[str] = ()) -> Tuple[str, str]:
    """Compile csrc/<name>.cu with ``defines`` (nvcc -D flags) unless a
    library for these sources, flags and defines exists. Returns (library
    path, ptxas report of that build)."""
    flags = (*NVCC_FLAGS, *defines)
    digest = hashlib.sha1(" ".join(flags).encode())
    for path in [source(name)] + sorted(glob.glob(os.path.join(CSRC,
                                                               "*.cuh"))):
        with open(path, "rb") as f:
            digest.update(f.read())
    stem = os.path.join(BUILD_DIR, f"{name}-{digest.hexdigest()[:16]}")
    so_path, log_path = stem + ".so", stem + ".log"
    if not os.path.exists(so_path):
        os.makedirs(BUILD_DIR, exist_ok=True)
        tmp = f"{stem}.{os.getpid()}.tmp"
        proc = subprocess.run([_nvcc(), *flags, "-o", tmp, source(name)],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on {source(name)}:\n"
                               f"{proc.stderr}")
        with open(log_path, "w") as f:
            f.write(proc.stderr)
        os.replace(tmp, so_path)
    with open(log_path) as f:
        return so_path, f.read()
