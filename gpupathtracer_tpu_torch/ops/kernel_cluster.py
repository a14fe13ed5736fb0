"""Wrapper of the CUDA cluster-leaf traversal kernel (csrc/cluster_traverse.cu)
and its plain torch version.

The kernel replaces the JAX package's Pallas kernel ``_kernel_cluster``
(ops/pallas_traverse.py:307): on a cluster scene (``cfg.cluster_tris``,
bvh/cluster.py) the node rows hold the cluster top tree and a leaf is one
[8, 3*tc] block of inverse-matrix rows whose tc triangles a pop intersects
all at once. It is built with nvcc on first use (ops/cuda_build.py) and
bound through a plain C interface with ctypes; the node phase is
csrc/bvh_walk.cuh's, shared with the MT-leaf kernel and the megakernel.

``closest_cluster`` / ``anyhit_cluster`` launch the kernel for CUDA
tensors and run ``closest_cluster_plain`` / ``anyhit_cluster_plain`` for
CPU tensors. The plain versions walk every ray in lockstep with the
kernel's visit order and arithmetic (the dot products in the order of
XLA's CPU dot, written out with ``fma32``, never ``torch.matmul``), so the
two agree bit for bit. Closest hits come back as global triangle ids,
remapped through ``cluster_refs``.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gpupathtracer_tpu_torch.ops import cuda_build, kernel_traverse
from gpupathtracer_tpu_torch.ops.intersect import fma32

LANES = 128
# Leaf lanes whose blocks the plain version intersects at once (bounds its
# [m, tc] float64 temporaries).
_PLAIN_LEAF_CHUNK = 8192

# Kernel launches since the last reset, by entry point. Each wrapper adds
# one where it launches its kernel and nowhere else.
LAUNCHES = {"trace_cluster_closest": 0, "trace_cluster_anyhit": 0}

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build("cluster_traverse")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpt_cluster_max_stack.argtypes = []
        lib.gpt_cluster_max_stack.restype = i
        lib.gpt_trace_cluster_closest.argtypes = [p, p, p, i, p, p, p, p, i,
                                                  i, p, p, p, p, p]
        lib.gpt_trace_cluster_closest.restype = i
        lib.gpt_trace_cluster_anyhit.argtypes = [p, p, i, p, p, p, p, i, i,
                                                 p, p]
        lib.gpt_trace_cluster_anyhit.restype = i
        if lib.gpt_cluster_max_stack() != kernel_traverse.MAX_STACK:
            raise RuntimeError("csrc/bvh_walk.cuh and kernel_traverse.py "
                               "disagree on the stack size")
        _lib = lib
    return _lib


def cluster_width(cluster_rows) -> int:
    """tc, the triangles per cluster, of a [Ncl*8, 3*tc] table."""
    w = cluster_rows.shape[-1]
    if (cluster_rows.dim() != 2 or w % (3 * LANES) or cluster_rows.shape[0] < 8
            or cluster_rows.shape[0] % 8):
        raise ValueError(f"cluster_rows must be [Ncl*8, 3*tc] with tc a "
                         f"multiple of {LANES}, got {tuple(cluster_rows.shape)}")
    return w // 3


def _check(rows, cluster_rows, cluster_refs, o, d, t_max, active,
           stack_depth: int) -> int:
    tc = cluster_width(cluster_rows)
    kernel_traverse.check_rays(rows, o, d, t_max, active, stack_depth)
    tables = [("cluster_rows", cluster_rows, torch.float32)]
    if cluster_refs is not None:
        ncl = cluster_rows.shape[0] // 8
        if tuple(cluster_refs.shape) != (ncl * tc,):
            raise ValueError(f"cluster_refs must be [{ncl * tc}], got "
                             f"{tuple(cluster_refs.shape)}")
        tables.append(("cluster_refs", cluster_refs, torch.int32))
    for name, x, dtype in tables:
        if x.dtype != dtype or x.device != o.device or not x.is_contiguous():
            raise ValueError(f"{name} must be contiguous {dtype} on "
                             f"{o.device}, got {x.dtype} on {x.device}")
    return tc


def closest_cluster(rows, cluster_rows, cluster_refs, o, d, t_max, active,
                    *, stack_depth: int):
    """Closest hit of rays o, d [N, 3] within (0, t_max) against the
    cluster top tree ``rows`` [W, 128] and its blocks ``cluster_rows``.
    Returns (t, prim, u, v), each [N], prim the global triangle id; t =
    t_max and prim = -1 on a miss or an inactive ray."""
    tc = _check(rows, cluster_rows, cluster_refs, o, d, t_max, active,
                stack_depth)
    if o.device.type == "cpu":
        return closest_cluster_plain(rows, cluster_rows, cluster_refs, o, d,
                                     t_max, active, stack_depth=stack_depth)
    stream = kernel_traverse.stream_of(o)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        with torch.cuda.device(o.device):
            err = _library().gpt_trace_cluster_closest(
                rows.data_ptr(), cluster_rows.data_ptr(),
                cluster_refs.data_ptr(), tc, o.data_ptr(), d.data_ptr(),
                t_max.data_ptr(), active.data_ptr(), n, stack_depth,
                t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                stream)
        if err:
            raise RuntimeError(f"trace_cluster_closest launch failed: CUDA "
                               f"error {err}")
        LAUNCHES["trace_cluster_closest"] += 1
    return t, prim, u, v


def anyhit_cluster(rows, cluster_rows, o, d, t_max, active, *,
                   stack_depth: int):
    """Occlusion of rays o, d [N, 3] within (0, t_max) on a cluster scene:
    [N] bool. Inactive rays are never occluded."""
    tc = _check(rows, cluster_rows, None, o, d, t_max, active, stack_depth)
    if o.device.type == "cpu":
        return anyhit_cluster_plain(rows, cluster_rows, o, d, t_max, active,
                                    stack_depth=stack_depth)
    stream = kernel_traverse.stream_of(o)
    n = o.shape[0]
    occluded = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        with torch.cuda.device(o.device):
            err = _library().gpt_trace_cluster_anyhit(
                rows.data_ptr(), cluster_rows.data_ptr(), tc, o.data_ptr(),
                d.data_ptr(), t_max.data_ptr(), active.data_ptr(), n,
                stack_depth, occluded.data_ptr(), stream)
        if err:
            raise RuntimeError(f"trace_cluster_anyhit launch failed: CUDA "
                               f"error {err}")
        LAUNCHES["trace_cluster_anyhit"] += 1
    return occluded


# --- the plain version ---------------------------------------------------------

def _dot_k3(m, x):
    """bvh_walk.cuh dot_k3: fma(m2, x2, fma(m1, x1, m0 * x0)), m [.., 3, k]
    rows, x [.., 3] broadcast over k."""
    x = x[..., None]
    return fma32(m[..., 2, :], x[..., 2, :],
                 fma32(m[..., 1, :], x[..., 1, :], m[..., 0, :] * x[..., 0, :]))


def _dot_rc(m, x):
    """bvh_walk.cuh dot_rc: fma(m2, x2, fma(m0, x0, m1 * x1)), m, x [.., 3]."""
    return fma32(m[..., 2], x[..., 2],
                 fma32(m[..., 0], x[..., 0], m[..., 1] * x[..., 1]))


def _cluster_min(blk, o, d, t_cur, any_hit: bool):
    """bvh_walk.cuh cluster_min for m leaf lanes at once: blk [m, 8, 3*tc],
    o, d [m, 3], t_cur [m]. Returns (tmin, slot) [m]: the smallest valid t
    (+inf when none) and the lowest slot that has it; with any_hit only
    slots below t_cur count, as the kernel's early exit counts them."""
    tc = blk.shape[2] // 3
    wd, wo, c = blk[:, 0:3], blk[:, 3:6], blk[:, 6]
    da, db, dc = (_dot_k3(wd[..., k * tc:(k + 1) * tc], d) for k in range(3))
    oa, ob, num = (_dot_k3(wo[..., k * tc:(k + 1) * tc], o)
                   + c[:, k * tc:(k + 1) * tc] for k in range(3))
    t = num / dc
    uu = fma32(t, da, oa)
    vv = fma32(t, db, ob)
    valid = (uu > 0.0) & (vv > 0.0) & (uu + vv < 1.0) & (t > 0.0)
    if any_hit:
        valid &= t < t_cur[:, None]
    score = torch.where(valid, t, torch.inf)
    tmin, slot = torch.min(score, dim=1)
    # torch.min's index is not documented to be the first among equals.
    slot = torch.argmax((score == tmin[:, None]).to(torch.uint8), dim=1)
    return tmin, slot


def walk_cluster_plain(rows, cluster_rows, o, d, t_max, active, *,
                       stack_depth: int, any_hit: bool,
                       pops: Optional[dict] = None):
    """``kernel_traverse.walk_plain`` with the cluster leaf. Returns (t,
    win): win [N] int64 is the winner's cluster-local id cidx * tc + slot
    (the JAX kernel's prim), -1 on a miss; with any_hit, win >= 0 iff
    occluded."""
    tc = cluster_width(cluster_rows)
    blocks = cluster_rows.view(-1, 8, 3 * tc)
    win = torch.full((o.shape[0],), -1, dtype=torch.int64, device=o.device)

    def leaf(ll, el, t):
        cidx = (-(el + 1)) >> 4
        kernel_traverse.count_pops(pops, "leaf", cidx, cidx.numel() * tc)
        hit = []
        for c0 in range(0, ll.numel(), _PLAIN_LEAF_CHUNK):
            lc = ll[c0:c0 + _PLAIN_LEAF_CHUNK]
            cc = cidx[c0:c0 + _PLAIN_LEAF_CHUNK]
            tmin, slot = _cluster_min(blocks[cc], o[lc], d[lc], t[lc],
                                      any_hit)
            better = tmin < t[lc]
            lw = lc[better]
            t[lw] = tmin[better]
            win[lw] = cc[better] * tc + slot[better]
            hit.append(lw)
        return torch.cat(hit)

    t = kernel_traverse.walk_plain(rows, o, d, t_max, active, stack_depth,
                                   any_hit, leaf, pops)
    return t, win


def slot_values(cluster_rows, win, rows, col0: int):
    """cluster_rows[cidx * 8 + r, col0 + slot] for each r in ``rows``, for
    every lane's winner win = cidx * tc + slot >= 0: [N, len(rows)]."""
    tc = cluster_width(cluster_rows)
    w = win.clamp_min(0)
    r = (w // tc * 8)[:, None] + torch.tensor(rows, device=w.device)
    return cluster_rows[r, (col0 + w % tc)[:, None]]


def cluster_uv(cluster_rows, win, o, d, t):
    """bvh_walk.cuh cluster_uv for lanes with win >= 0: u, v of the winning
    slot at t, recomputed from its A and B origin rows; 0 elsewhere."""
    tc = cluster_width(cluster_rows)
    out = []
    for k in range(2):  # the A and B thirds of rows 3:7
        cap = slot_values(cluster_rows, win, (3, 4, 5, 6), k * tc)
        uv = fma32(t, _dot_rc(cap[:, 0:3], d), _dot_rc(cap[:, 0:3], o)
                   + cap[:, 3])
        out.append(torch.where(win >= 0, uv, 0.0))
    return out


def closest_cluster_plain(rows, cluster_rows, cluster_refs, o, d, t_max,
                          active, *, stack_depth: int,
                          pops: Optional[dict] = None):
    """Plain torch version of ``closest_cluster`` (same results, bit for
    bit). ``pops``, a dict, collects the walk's pop counts."""
    t, win = walk_cluster_plain(rows, cluster_rows, o, d, t_max, active,
                                stack_depth=stack_depth, any_hit=False,
                                pops=pops)
    u, v = cluster_uv(cluster_rows, win, o, d, t)
    prim = torch.where(win >= 0, cluster_refs[win.clamp_min(0)], -1)
    return t, prim.to(torch.int32), u, v


def anyhit_cluster_plain(rows, cluster_rows, o, d, t_max, active, *,
                         stack_depth: int, pops: Optional[dict] = None):
    """Plain torch version of ``anyhit_cluster`` (same results)."""
    return walk_cluster_plain(rows, cluster_rows, o, d, t_max, active,
                              stack_depth=stack_depth, any_hit=True,
                              pops=pops)[1] >= 0
