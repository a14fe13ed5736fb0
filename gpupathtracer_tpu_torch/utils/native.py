"""Builds the image decoders' C++ sources (utils/jpeg_cpp/jpeg.cpp,
utils/codecs_cpp/codecs.cpp, utils/webp_cpp/webp.cpp, utils/fax_cpp/fax.cpp,
utils/zstd_cpp/zstd.cpp, utils/j2k_cpp/j2k.cpp) with g++ at first use into
the package's ``_build/`` directory, keyed by the source's and
the flags' hash, and loads them through ctypes. There is no fallback: a
failed build raises."""

from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess

# Integer code but for BC6H's half floats and JPEG 2000's 9/7 wavelet and
# ICT, which must round as PIL's compiled core and OpenJPEG's SSE code
# round them: no contraction of a multiply and an add.
FLAGS = ("-O3", "-march=native", "-std=c++17", "-shared", "-fPIC",
         "-ffp-contract=off")


def cache_dir() -> str:
    d = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(
        __file__))), "_build")
    os.makedirs(d, exist_ok=True)
    return d


def build(src: str, stem: str) -> str:
    """Compile ``src`` into _build/lib<stem>-<hash>.so unless it is there;
    returns its path."""
    with open(src, "rb") as f:
        digest = hashlib.sha1(f.read() + " ".join(FLAGS).encode())
    so_path = os.path.join(cache_dir(),
                           f"lib{stem}-{digest.hexdigest()[:16]}.so")
    if not os.path.exists(so_path):
        tmp = f"{so_path}.{os.getpid()}.tmp"  # concurrent test workers
        subprocess.run(["g++", *FLAGS, src, "-o", tmp], check=True,
                       capture_output=True)
        os.replace(tmp, so_path)
    return so_path


def load(src: str, stem: str) -> ctypes.CDLL:
    return ctypes.CDLL(build(src, stem))
