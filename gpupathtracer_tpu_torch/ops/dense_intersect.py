"""Dense (tree-less) ray x triangle intersection: wrapper of the CUDA
kernel csrc/dense_intersect.cu and its plain torch version.

The kernel replaces the JAX package's Pallas kernel ``_kernel``
(ops/dense_intersect.py:105): every ray against every triangle by the
precomputed inverse-matrix test (the idea of the reference's unused
IntersectTriangleArenberg, src/shaders/common/Geometry.glsl:279-310).
With M = [e1 e2 n] (columns), n = e1 x e2, and rows A, B, C of M^-1:

    t = (C.p0 - C.o) / (C.d)
    u = (A.o - A.p0) + t (A.d)
    v = (B.o - B.p0) + t (B.d)
    hit iff u > 0, v > 0, u + v < 1, 0 < t < t_cur   (strict, as MT)

Its cost does not depend on ray coherence, which is the point on small
tables; it is the same hit set as Moller-Trumbore in exact arithmetic,
with other rounding, so the tree kernels stay the default everywhere and
this path is opt-in (tools/torch_kernel_bench.py ``--mode dense``).

``dense_intersect`` launches the kernel for CUDA tensors and runs
``dense_intersect_plain`` for CPU tensors. The plain version computes
tile by tile what the kernel computes, with its arithmetic (``use_mxu``:
the six dot products rounded as XLA's CPU dot rounds them, else as XLA
contracts the broadcast-multiply chain; written out with ``fma32``, never
``torch.matmul``), so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import numpy as np
import torch

from gpupathtracer_tpu_torch.bvh.dense_intersect import inverse_rows
from gpupathtracer_tpu_torch.ops import cuda_build
from gpupathtracer_tpu_torch.ops.intersect import fma32
from gpupathtracer_tpu_torch.ops.kernel_traverse import stream_of

# Triangles are padded to a multiple of this many (pack_dense_tris).
PAD = 512
# Rays whose [rays, tile] float64 temporaries the plain version holds at once.
_PLAIN_RAY_CHUNK = 16384

# Kernel launches since the last reset, by entry point. Each wrapper adds
# one where it launches its kernel and nowhere else.
LAUNCHES = {"dense_closest": 0, "dense_anyhit": 0}

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build("dense_intersect")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpt_dense_intersect.argtypes = [p, p, i, p, p, p, p, i, i, i, i,
                                            i, p, p, p, p, p, p]
        lib.gpt_dense_intersect.restype = i
        lib.gpt_dense_stage.argtypes = []
        lib.gpt_dense_stage.restype = i
        _lib = lib
    return _lib


def pack_dense_tris(tri_geom) -> tuple:
    """Precompute the inverse-matrix operands from (p0, e1, e2) rows.

    Returns numpy (wd [3, 3*Tp], wo [4, 3*Tp]) with Tp = T padded to a 512
    multiple; the A/B/C blocks are laid out as [A | B | C] along the
    columns. Degenerate / padding triangles get all-zero columns => den =
    0, t = NaN, never valid.
    """
    T = np.asarray(tri_geom).shape[0]
    A, B, C, p0 = inverse_rows(tri_geom)
    A, B, C, p0 = (x.astype(np.float64) for x in (A, B, C, p0))

    Tp = -(-max(T, 1) // PAD) * PAD
    wd = np.zeros((3, 3 * Tp), np.float32)
    wo = np.zeros((4, 3 * Tp), np.float32)
    # Direction terms: A.d, B.d, C.d.
    wd[:, 0 * Tp:0 * Tp + T] = A.T
    wd[:, 1 * Tp:1 * Tp + T] = B.T
    wd[:, 2 * Tp:2 * Tp + T] = C.T
    # Origin terms with folded constants: (A.o - A.p0), (B.o - B.p0),
    # (C.p0 - C.o): the C block is negated so that t = num / den directly.
    wo[0:3, 0 * Tp:0 * Tp + T] = A.T
    wo[3, 0 * Tp:0 * Tp + T] = -np.einsum("ij,ij->i", A, p0)
    wo[0:3, 1 * Tp:1 * Tp + T] = B.T
    wo[3, 1 * Tp:1 * Tp + T] = -np.einsum("ij,ij->i", B, p0)
    wo[0:3, 2 * Tp:2 * Tp + T] = -C.T
    wo[3, 2 * Tp:2 * Tp + T] = np.einsum("ij,ij->i", C, p0)
    return wd, wo


def _check(wd, wo, o, d, t_max, active, block: int, tile: int) -> int:
    """Raises ValueError unless the arguments are what the kernel takes;
    returns Tp."""
    n = o.shape[0]
    if wd.dim() != 2 or wd.shape[0] != 3 or wd.shape[1] % 3:
        raise ValueError(f"wd must be [3, 3*Tp], got {tuple(wd.shape)}")
    tp = wd.shape[1] // 3
    for name, x, shape, dtype in (("wd", wd, (3, 3 * tp), torch.float32),
                                  ("wo", wo, (4, 3 * tp), torch.float32),
                                  ("o", o, (n, 3), torch.float32),
                                  ("d", d, (n, 3), torch.float32),
                                  ("t_max", t_max, (n,), torch.float32),
                                  ("active", active, (n,), torch.bool)):
        if tuple(x.shape) != shape or x.dtype != dtype:
            raise ValueError(f"{name} must be {dtype} {shape}, got "
                             f"{x.dtype} {tuple(x.shape)}")
        if x.device != o.device:
            raise ValueError(f"{name} is on {x.device}, rays on {o.device}")
        if not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if block < 1 or n % block:
        raise ValueError(f"N={n} must be a multiple of block={block}")
    if tile < 1 or tp < tile or tp % tile:
        raise ValueError(f"padded tris {tp} must be a multiple of "
                         f"tile={tile}")
    return tp


def dense_intersect(wd, wo, o, d, t_max, active, *, any_hit: bool = False,
                    use_mxu: bool = True, block: int = 1024,
                    tile: int = 512, early_exit: bool = True):
    """Brute-force closest/any-hit of [N] rays against the packed table.

    wd, wo: pack_dense_tris' arrays as tensors; o, d: [N, 3]; t_max,
    active: [N]. Returns (t, prim, u, v), each [N]. Closest: the
    trace_closest contract (prim = -1 on a miss, t = t_max there; the
    lowest triangle index among equal t). Any-hit: prim is the base index
    of the first ``tile`` triangles that hold a hit (-1 when none), t = 0
    on a hit, u = v = 0. ``use_mxu`` selects the rounding of the six dot
    products (module docstring); ``early_exit`` lets an any-hit query drop
    each ray once it has a hit (on the card: a block compacts its live
    rays after every stage of triangles). N must be a multiple of
    ``block`` and Tp of ``tile``, as the JAX kernel's grid needs; the CUDA
    kernel has its own layout (csrc/dense_intersect.cu: 128 threads and
    128-triangle stages a block), so there Tp must also be a multiple of
    128 (pack_dense_tris pads to 512).
    """
    tp = _check(wd, wo, o, d, t_max, active, block, tile)
    if o.device.type == "cpu":
        return dense_intersect_plain(wd, wo, o, d, t_max, active,
                                     any_hit=any_hit, use_mxu=use_mxu,
                                     block=block, tile=tile,
                                     early_exit=early_exit)
    stream = stream_of(o)
    lib = _library()
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    # Scratch: a 64-bit key a ray, the blocks' atomicMin of their best.
    keys = torch.empty(n, dtype=torch.int64, device=o.device)
    if n:
        with torch.cuda.device(o.device):
            err = lib.gpt_dense_intersect(
                wd.data_ptr(), wo.data_ptr(), tp, o.data_ptr(), d.data_ptr(),
                t_max.data_ptr(), active.data_ptr(), n, tile, int(any_hit),
                int(use_mxu), int(early_exit), t.data_ptr(), prim.data_ptr(),
                u.data_ptr(), v.data_ptr(), keys.data_ptr(), stream)
        if err == -1:
            raise ValueError(f"dense_intersect: the kernel stages "
                             f"{lib.gpt_dense_stage()} triangles at a time; "
                             f"padded tris {tp} are not a multiple")
        if err:
            raise RuntimeError(f"dense_intersect launch failed: CUDA error "
                               f"{err}")
        LAUNCHES["dense_anyhit" if any_hit else "dense_closest"] += 1
    return t, prim, u, v


def _dots(m, x, const, use_mxu: bool):
    """The three-term products of one third of a tile, m [3, tile], with
    rays x [R, 3], plus ``const`` [tile] (None for the direction terms):
    csrc/bvh_walk.cuh dot_k3 (use_mxu) or dot_rc."""
    x0, x1, x2 = (x[:, k:k + 1] for k in range(3))
    if use_mxu:
        acc = fma32(m[2], x2, fma32(m[1], x1, m[0] * x0))
    else:
        acc = fma32(m[2], x2, fma32(m[0], x0, m[1] * x1))
    return acc if const is None else acc + const


def dense_intersect_plain(wd, wo, o, d, t_max, active, *,
                          any_hit: bool = False, use_mxu: bool = True,
                          block: int = 1024, tile: int = 512,
                          early_exit: bool = True,
                          counts: Optional[dict] = None):
    """Plain torch version of ``dense_intersect`` (same results, bit for
    bit; ``block`` and ``early_exit`` change the kernel's schedule only).
    ``counts``, a dict, receives ``pairs``: the ray x triangle tests these
    inputs need (a ray of an any-hit query stops at its first hit)."""
    tp = _check(wd, wo, o, d, t_max, active, block, tile)
    n, dev = o.shape[0], o.device
    t_out = t_max.clone()
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u_out = torch.zeros(n, dtype=torch.float32, device=dev)
    v_out = torch.zeros(n, dtype=torch.float32, device=dev)
    pairs = 0
    for r0 in range(0, n, _PLAIN_RAY_CHUNK):
        sl = slice(r0, min(r0 + _PLAIN_RAY_CHUNK, n))
        oo, dd, act = o[sl], d[sl], active[sl]
        t_best, pr, ub, vb = t_out[sl], prim[sl], u_out[sl], v_out[sl]
        for base in range(0, tp, tile):
            live = act & (pr < 0) if any_hit else act
            if not bool(live.any()):
                break
            cols = [slice(k * tp + base, k * tp + base + tile)
                    for k in range(3)]
            da, db, dc = (_dots(wd[:, c], dd, None, use_mxu) for c in cols)
            oa, ob, num = (_dots(wo[0:3, c], oo, wo[3, c], use_mxu)
                           for c in cols)
            tt = num / dc
            uu = fma32(tt, da, oa)
            vv = fma32(tt, db, ob)
            valid = ((uu > 0.0) & (vv > 0.0) & (uu + vv < 1.0) & (tt > 0.0)
                     & (tt < t_best[:, None]) & live[:, None])
            if any_hit:
                hit = valid.any(dim=1)
                first = torch.argmax(valid.to(torch.uint8), dim=1)
                pairs += int(torch.where(hit, first + 1,
                                         tile * live.long()).sum())
                pr[hit] = base
                continue
            pairs += tile * int(live.sum())
            score = torch.where(valid, tt, torch.inf)
            tmin = score.amin(dim=1)
            # The first triangle among those at the smallest t.
            idx = torch.argmax((score == tmin[:, None]).to(torch.uint8),
                               dim=1, keepdim=True)
            better = tmin < t_best
            t_best[better] = tmin[better]
            pr[better] = (base + idx[better, 0]).to(torch.int32)
            ub[better] = uu.gather(1, idx)[better, 0]
            vb[better] = vv.gather(1, idx)[better, 0]
        if any_hit:
            t_best[pr >= 0] = 0.0
    if counts is not None:
        counts["pairs"] = counts.get("pairs", 0) + pairs
    return t_out, prim, u_out, v_out
