"""Wrapper of the CUDA cluster-leaf traversal kernel (csrc/cluster_traverse.cu)
and its plain torch version.

The kernel replaces the JAX package's Pallas kernel ``_kernel_cluster``
(ops/pallas_traverse.py:307): on a cluster scene (``cfg.cluster_tris``,
bvh/cluster.py) the node rows hold the cluster top tree and a leaf is one
[8, 3*tc] block of inverse-matrix rows whose tc triangles a pop intersects
all at once. It is built with nvcc on first use (ops/cuda_build.py) and
bound through a plain C interface with ctypes; the node phase is
csrc/bvh_walk.cuh's, shared with the MT-leaf kernel and the megakernel,
one ray a thread, and each cluster pop is run by the whole warp (lane L
tests slots L, L + 32, ...; a warp reduction keeps the lowest slot among
equal t), which leaves every ray's visit order and results those of a
walk by one thread.

``closest_cluster`` / ``anyhit_cluster`` launch the kernel for CUDA
tensors and run ``closest_cluster_plain`` / ``anyhit_cluster_plain`` for
CPU tensors. The plain versions walk every ray in lockstep with the
kernel's visit order and arithmetic (the dot products in the order of
XLA's CPU dot, written out with ``fma32``, never ``torch.matmul``), so the
two agree bit for bit. Closest hits come back as global triangle ids,
remapped through ``cluster_refs``.

Both take the top tree's node ``arity`` (2-16) and optional start
entries ``roots`` / ``packet`` (a node row, a cluster leaf entry or
INVALID_ENTRY per packet of rays), as ops/kernel_traverse.py's entry
points do; the kernel is built once per arity.

``with_stats=True`` adds the TPU kernel's pop counters per ray, [N, 3]
int32: node pops, cluster pops run, cluster pops skipped. ``pop_skip=True``
(closest only, as in the JAX kernel) skips a cluster pop whose entry
distance, kept on a parallel key stack at its push, is beyond the ray's
current t by more than a margin: 2^-12 of the key's size plus the ray's
largest |o_a / d_a|, the scale of the key's rounding
(kernel_traverse.walk_plain; the bound is in ROADMAP.md section C). The
results are those without it. The JAX kernel keys on the packet's nearest
entry and compares with its farthest ray; here key and t are the ray's
own. Both launch the kernels' kStats / kSkip instantiations
(csrc/cluster_traverse.cu).
"""

from __future__ import annotations

import ctypes
from typing import Dict, Optional

import torch

from gpupathtracer_tpu_torch.ops import cuda_build, kernel_traverse
from gpupathtracer_tpu_torch.ops.intersect import fma32

LANES = 128
# Leaf lanes whose blocks the plain version intersects at once (bounds its
# [m, tc] float64 temporaries).
_PLAIN_LEAF_CHUNK = 8192

# Kernel launches since the last reset, by entry point. Each wrapper adds
# one where it launches its kernel and nowhere else (keyed as
# kernel_traverse.launch_key: by arity, and with roots).
LAUNCHES = {"trace_cluster_closest": 0, "trace_cluster_anyhit": 0,
            "trace_cluster_closest_stats": 0, "trace_cluster_anyhit_stats": 0,
            "trace_cluster_closest_roots": 0, "trace_cluster_anyhit_roots": 0}

# The built libraries, by node arity.
_libs: Dict[int, ctypes.CDLL] = {}


def _library(arity: int = kernel_traverse.ARITY) -> ctypes.CDLL:
    if arity not in _libs:
        lib = ctypes.CDLL(cuda_build.build(
            "cluster_traverse", cuda_build.arity_defines(arity))[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpt_cluster_max_stack.argtypes = []
        lib.gpt_cluster_max_stack.restype = i
        lib.gpt_cluster_arity.argtypes = []
        lib.gpt_cluster_arity.restype = i
        lib.gpt_trace_cluster_closest.argtypes = [p, p, p, i, p, p, p, p, i,
                                                  i, p, p, p, p, i, p, p, i,
                                                  p]
        lib.gpt_trace_cluster_closest.restype = i
        lib.gpt_trace_cluster_anyhit.argtypes = [p, p, i, p, p, p, p, i, i,
                                                 p, p, p, i, p]
        lib.gpt_trace_cluster_anyhit.restype = i
        if lib.gpt_cluster_max_stack() != kernel_traverse.MAX_STACK:
            raise RuntimeError("csrc/bvh_walk.cuh and kernel_traverse.py "
                               "disagree on the stack size")
        if lib.gpt_cluster_arity() != arity:
            raise RuntimeError(f"the arity-{arity} build of "
                               f"csrc/cluster_traverse.cu walks "
                               f"{lib.gpt_cluster_arity()}-wide rows")
        _libs[arity] = lib
    return _libs[arity]


def cluster_width(cluster_rows) -> int:
    """tc, the triangles per cluster, of a [Ncl*8, 3*tc] table."""
    w = cluster_rows.shape[-1]
    if (cluster_rows.dim() != 2 or w % (3 * LANES) or cluster_rows.shape[0] < 8
            or cluster_rows.shape[0] % 8):
        raise ValueError(f"cluster_rows must be [Ncl*8, 3*tc] with tc a "
                         f"multiple of {LANES}, got {tuple(cluster_rows.shape)}")
    return w // 3


def _check(rows, cluster_rows, cluster_refs, o, d, t_max, active,
           stack_depth: int, arity: int = kernel_traverse.ARITY, roots=None,
           packet=None) -> int:
    tc = cluster_width(cluster_rows)
    kernel_traverse.check_rays(rows, o, d, t_max, active, stack_depth, arity,
                               roots, packet)
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


def _stats(n: int, device, with_stats: bool):
    """Zeroed [n, 3] int32 pop counts for the kernel, or None."""
    return (torch.zeros((n, 3), dtype=torch.int32, device=device)
            if with_stats else None)


def _launched(entry: str, err: int, arity: int, roots) -> None:
    entry = kernel_traverse.launch_key(entry, arity, roots)
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    kernel_traverse.count_launch(LAUNCHES, entry)


def closest_cluster(rows, cluster_rows, cluster_refs, o, d, t_max, active,
                    *, stack_depth: int, with_stats: bool = False,
                    pop_skip: bool = False, arity: int = kernel_traverse.ARITY,
                    roots=None, packet=None):
    """Closest hit of rays o, d [N, 3] within (0, t_max) against the
    cluster top tree ``rows`` [W, 128] and its blocks ``cluster_rows``.
    Returns (t, prim, u, v), each [N], prim the global triangle id; t =
    t_max and prim = -1 on a miss or an inactive ray. ``with_stats``
    appends the per-ray pop counts [N, 3] int32 (node, cluster run, cluster
    skipped); ``pop_skip`` takes the skipping schedule, ``arity`` and
    ``roots`` / ``packet`` the table's width and the start entries (module
    docstring)."""
    tc = _check(rows, cluster_rows, cluster_refs, o, d, t_max, active,
                stack_depth, arity, roots, packet)
    if o.device.type == "cpu":
        return closest_cluster_plain(rows, cluster_rows, cluster_refs, o, d,
                                     t_max, active, stack_depth=stack_depth,
                                     with_stats=with_stats, pop_skip=pop_skip,
                                     arity=arity, roots=roots, packet=packet)
    stream = kernel_traverse.stream_of(o)
    kernel_traverse.check_aligned(rows)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    stats = _stats(n, o.device, with_stats)
    if n:
        with torch.cuda.device(o.device):
            err = _library(arity).gpt_trace_cluster_closest(
                rows.data_ptr(), cluster_rows.data_ptr(),
                cluster_refs.data_ptr(), tc, o.data_ptr(), d.data_ptr(),
                t_max.data_ptr(), active.data_ptr(), n, stack_depth,
                t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                int(pop_skip), None if stats is None else stats.data_ptr(),
                None if roots is None else roots.data_ptr(), packet or 1,
                stream)
        _launched("trace_cluster_closest_stats" if with_stats or pop_skip
                  else "trace_cluster_closest", err, arity, roots)
    return (t, prim, u, v, stats) if with_stats else (t, prim, u, v)


def anyhit_cluster(rows, cluster_rows, o, d, t_max, active, *,
                   stack_depth: int, with_stats: bool = False,
                   arity: int = kernel_traverse.ARITY, roots=None,
                   packet=None):
    """Occlusion of rays o, d [N, 3] within (0, t_max) on a cluster scene:
    [N] bool. Inactive rays are never occluded. ``with_stats`` returns
    (occluded, [N, 3] pop counts); the skip column stays 0. ``arity`` and
    the roots are ``closest_cluster``'s."""
    tc = _check(rows, cluster_rows, None, o, d, t_max, active, stack_depth,
                arity, roots, packet)
    if o.device.type == "cpu":
        return anyhit_cluster_plain(rows, cluster_rows, o, d, t_max, active,
                                    stack_depth=stack_depth,
                                    with_stats=with_stats, arity=arity,
                                    roots=roots, packet=packet)
    stream = kernel_traverse.stream_of(o)
    kernel_traverse.check_aligned(rows)
    n = o.shape[0]
    occluded = torch.empty(n, dtype=torch.bool, device=o.device)
    stats = _stats(n, o.device, with_stats)
    if n:
        with torch.cuda.device(o.device):
            err = _library(arity).gpt_trace_cluster_anyhit(
                rows.data_ptr(), cluster_rows.data_ptr(), tc, o.data_ptr(),
                d.data_ptr(), t_max.data_ptr(), active.data_ptr(), n,
                stack_depth, occluded.data_ptr(),
                None if stats is None else stats.data_ptr(),
                None if roots is None else roots.data_ptr(), packet or 1,
                stream)
        _launched("trace_cluster_anyhit_stats" if with_stats
                  else "trace_cluster_anyhit", err, arity, roots)
    return (occluded, stats) if with_stats else occluded


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
                       pops: Optional[dict] = None,
                       tally: Optional[torch.Tensor] = None,
                       pop_skip: bool = False,
                       arity: int = kernel_traverse.ARITY, roots=None,
                       packet=None):
    """``kernel_traverse.walk_plain`` with the cluster leaf (``tally``,
    ``pop_skip``, ``arity`` and the roots as there). Returns (t, win): win [N] int64 is the winner's
    cluster-local id cidx * tc + slot (the JAX kernel's prim), -1 on a
    miss; with any_hit, win >= 0 iff occluded."""
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
                                   any_hit, leaf, pops, tally=tally,
                                   pop_skip=pop_skip, arity=arity,
                                   roots=roots, packet=packet)
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


def _cluster_stats(tally) -> torch.Tensor:
    cols = [kernel_traverse.POP_COLUMNS[k] for k in ("node", "leaf", "skip")]
    return tally[:, cols].to(torch.int32)


def closest_cluster_plain(rows, cluster_rows, cluster_refs, o, d, t_max,
                          active, *, stack_depth: int,
                          pops: Optional[dict] = None,
                          with_stats: bool = False, pop_skip: bool = False,
                          arity: int = kernel_traverse.ARITY, roots=None,
                          packet=None):
    """Plain torch version of ``closest_cluster`` (same results, bit for
    bit, pop counts too). ``pops``, a dict, collects the walk's pop totals
    and the table entries they read."""
    kernel_traverse.check_roots(o.shape[0], o.device, arity, roots, packet)
    tally = (kernel_traverse.new_tally(o.shape[0], o.device) if with_stats
             else None)
    t, win = walk_cluster_plain(rows, cluster_rows, o, d, t_max, active,
                                stack_depth=stack_depth, any_hit=False,
                                pops=pops, tally=tally, pop_skip=pop_skip,
                                arity=arity, roots=roots, packet=packet)
    u, v = cluster_uv(cluster_rows, win, o, d, t)
    prim = torch.where(win >= 0, cluster_refs[win.clamp_min(0)], -1)
    out = (t, prim.to(torch.int32), u, v)
    return out + (_cluster_stats(tally),) if with_stats else out


def anyhit_cluster_plain(rows, cluster_rows, o, d, t_max, active, *,
                         stack_depth: int, pops: Optional[dict] = None,
                         with_stats: bool = False,
                         arity: int = kernel_traverse.ARITY, roots=None,
                         packet=None):
    """Plain torch version of ``anyhit_cluster`` (same results)."""
    kernel_traverse.check_roots(o.shape[0], o.device, arity, roots, packet)
    tally = (kernel_traverse.new_tally(o.shape[0], o.device) if with_stats
             else None)
    occ = walk_cluster_plain(rows, cluster_rows, o, d, t_max, active,
                             stack_depth=stack_depth, any_hit=True,
                             pops=pops, tally=tally, arity=arity, roots=roots,
                             packet=packet)[1] >= 0
    return (occ, _cluster_stats(tally)) if with_stats else occ
