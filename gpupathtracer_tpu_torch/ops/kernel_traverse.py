"""Wrapper of the CUDA traversal kernel (csrc/traverse.cu) and its plain
torch version.

The kernel replaces the JAX package's Pallas kernels ``_kernel`` and
``_kernel_pair`` (ops/pallas_traverse.py): closest-hit for camera and
bounce rays, any-hit for shadow rays, over the merged 128-float row table
of bvh/wide.py. It is built with nvcc on first use (ops/cuda_build.py) and
bound through a plain C interface with ctypes. The walk itself lives in
csrc/bvh_walk.cuh, which the megakernel (csrc/megakernel.cu) shares.

``closest`` / ``anyhit`` launch the kernel for CUDA tensors and run
``closest_plain`` / ``anyhit_plain`` for CPU tensors. The plain versions
walk every ray in lockstep with its own stack, in the kernel's visit order
and with its arithmetic, so the two agree bit for bit.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gpupathtracer_tpu_torch.ops import cuda_build
from gpupathtracer_tpu_torch.ops.intersect import fma32, mt_intersect

ROW_WIDTH = 128
ARITY = 8
TRIS_PER_ROW = ROW_WIDTH // 12
MAX_STACK = 192  # kMaxStack in csrc/bvh_walk.cuh
INVALID_ENTRY = 0x7FFFFFFF

# Kernel launches since the last reset, by entry point. Each wrapper adds
# one where it launches its kernel and nowhere else.
LAUNCHES = {"trace_closest": 0, "trace_anyhit": 0}

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build("traverse")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpt_max_stack.argtypes = []
        lib.gpt_max_stack.restype = i
        lib.gpt_trace_closest.argtypes = [p, p, p, p, p, i, i, p, p, p, p, p]
        lib.gpt_trace_closest.restype = i
        lib.gpt_trace_anyhit.argtypes = [p, p, p, p, p, i, i, p, p]
        lib.gpt_trace_anyhit.restype = i
        if lib.gpt_max_stack() != MAX_STACK:
            raise RuntimeError("csrc/bvh_walk.cuh and kernel_traverse.py "
                               "disagree on the stack size")
        _lib = lib
    return _lib


def check_rays(rows, o, d, t_max, active, stack_depth: int) -> None:
    """Raises ValueError unless the wrappers' table and ray arguments are
    what the kernels take."""
    n = o.shape[0]
    if rows.dim() != 2 or rows.shape[1] != ROW_WIDTH or rows.shape[0] < 1:
        raise ValueError(f"rows must be [M>=1, {ROW_WIDTH}], got "
                         f"{tuple(rows.shape)}")
    for name, x, shape, dtype in (("rows", rows, tuple(rows.shape),
                                   torch.float32),
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
    if not 1 <= stack_depth <= MAX_STACK:
        raise ValueError(f"stack_depth {stack_depth} outside 1..{MAX_STACK} "
                         f"(the kernel's stack)")


def stream_of(o: torch.Tensor):
    """The current CUDA stream of o's device; raises for any other device."""
    if o.device.type != "cuda":
        raise ValueError(f"the traversal kernels take CUDA or CPU tensors, "
                         f"got {o.device}")
    return torch.cuda.current_stream(o.device).cuda_stream


def closest(rows, o, d, t_max, active, *, stack_depth: int, leaf_size: int):
    """Closest hit of rays o, d [N, 3] within (0, t_max) against the merged
    row table rows [M, 128]. Returns (t, prim, u, v), each [N]; t = t_max
    and prim = -1 on a miss or an inactive ray."""
    check_rays(rows, o, d, t_max, active, stack_depth)
    if o.device.type == "cpu":
        return closest_plain(rows, o, d, t_max, active,
                             stack_depth=stack_depth, leaf_size=leaf_size)
    stream = stream_of(o)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    if n:
        with torch.cuda.device(o.device):
            err = _library().gpt_trace_closest(
                rows.data_ptr(), o.data_ptr(), d.data_ptr(),
                t_max.data_ptr(), active.data_ptr(), n, stack_depth,
                t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr(),
                stream)
        if err:
            raise RuntimeError(f"trace_closest launch failed: CUDA error {err}")
        LAUNCHES["trace_closest"] += 1
    return t, prim, u, v


def anyhit(rows, o, d, t_max, active, *, stack_depth: int, leaf_size: int):
    """Occlusion of rays o, d [N, 3] within (0, t_max): [N] bool, True iff
    some triangle is hit. Inactive rays are never occluded."""
    check_rays(rows, o, d, t_max, active, stack_depth)
    if o.device.type == "cpu":
        return anyhit_plain(rows, o, d, t_max, active,
                            stack_depth=stack_depth, leaf_size=leaf_size)
    stream = stream_of(o)
    n = o.shape[0]
    occluded = torch.empty(n, dtype=torch.bool, device=o.device)
    if n:
        with torch.cuda.device(o.device):
            err = _library().gpt_trace_anyhit(
                rows.data_ptr(), o.data_ptr(), d.data_ptr(),
                t_max.data_ptr(), active.data_ptr(), n, stack_depth,
                occluded.data_ptr(), stream)
        if err:
            raise RuntimeError(f"trace_anyhit launch failed: CUDA error {err}")
        LAUNCHES["trace_anyhit"] += 1
    return occluded


def count_pops(pops: Optional[dict], kind: str, ids: torch.Tensor,
               slots=None) -> None:
    """Adds a step's pops of one kind ("node" or "leaf") to ``pops``, the
    node rows, leaf entries or clusters they read to its set
    ``kind + "_ids"`` and, for leaves, the triangle slots they test to
    ``"slots"``: the work and the distinct table bytes a run needs
    (chip_smoke.py's bound). ``pops`` None counts nothing."""
    if pops is None or not ids.numel():
        return
    pops[kind] = pops.get(kind, 0) + ids.numel()
    pops.setdefault(kind + "_ids", set()).update(torch.unique(ids).tolist())
    if slots is not None:
        pops["slots"] = pops.get("slots", 0) + int(slots)


def walk_plain(rows, o, d, t_max, active, stack_depth: int, any_hit: bool,
               leaf, pops: Optional[dict] = None) -> torch.Tensor:
    """The node phase of csrc/bvh_walk.cuh ``walk``, for every ray in
    lockstep with its own stack: each step pops one entry per live ray.
    Node pops push the entered children so that they pop in ascending
    (t_near, slot) order (slot order for any-hit). Leaf pops go to
    ``leaf(lanes, entries, t)``, which intersects them, lowers ``t`` in
    place where it finds a closer hit, records what its caller needs and
    returns the lanes that hit; with ``any_hit`` those walks end. Returns
    t."""
    n, dev = o.shape[0], o.device
    eps = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    inv = torch.where(d >= 0, 1.0, -1.0) / torch.maximum(d.abs(), eps)
    oi = o * inv
    rows_i = rows.view(torch.int32)
    t = t_max.clone()
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)  # stack[:, 0] = 0, the root row
    while True:
        live = torch.nonzero(sp > 0).squeeze(1)
        if live.numel() == 0:
            break
        sp[live] -= 1
        entry = stack[live, sp[live]]
        is_node = entry >= 0

        ln, en = live[is_node], entry[is_node]
        count_pops(pops, "node", en)
        if ln.numel():
            row = rows[en]
            bounds = row[:, :6 * ARITY].reshape(-1, ARITY, 6)
            inv_l, oi_l = inv[ln][:, None, :], oi[ln][:, None, :]
            t0 = fma32(bounds[..., 0:3], inv_l, -oi_l)
            t1 = fma32(bounds[..., 3:6], inv_l, -oi_l)
            lo = torch.minimum(t0, t1)
            hi = torch.maximum(t0, t1)
            tmin = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]),
                                 lo[..., 2])
            tmax = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                                 hi[..., 2])
            child = rows_i[en, 6 * ARITY:7 * ARITY].to(torch.int64)
            hit = ((tmin <= tmax) & (tmax > 0.0) & (tmin < t[ln, None])
                   & (child != INVALID_ENTRY))
            if not any_hit:
                key = torch.where(hit, tmin, torch.inf)
                order = torch.argsort(key, dim=1, stable=True)
                child = torch.gather(child, 1, order)
                hit = torch.gather(hit, 1, order)
            # The k-th pushed child (in pop order) sits k below the top.
            rank = torch.cumsum(hit.to(torch.int64), dim=1) - 1
            total = hit.sum(dim=1)
            pos = sp[ln, None] + total[:, None] - 1 - rank
            keep = hit & (pos < stack_depth)
            lane = ln[:, None].expand(-1, ARITY)
            stack[lane[keep], pos[keep]] = child[keep]
            sp[ln] = torch.clamp_max(sp[ln] + total, stack_depth)

        ll, el = live[~is_node], entry[~is_node]
        if ll.numel():
            lw = leaf(ll, el, t)
            if any_hit:
                sp[lw] = 0
    return t


def _walk_plain(rows, o, d, t_max, active, stack_depth: int, leaf_size: int,
                any_hit: bool, pops: Optional[dict] = None):
    """``walk_plain`` over the MT-leaf table: leaf pops run Moller-Trumbore
    on the block's slots.

    Returns (t, prim, u, v, at): ``at`` [N] int64 is the flat index into
    ``rows`` of the winning triangle's 12-float slot (-1 on a miss), whose
    floats 3:9 are e1, e2, 10 the material id bits and 11 the normal sign
    (the kernel's hit slot pointer)."""
    n, dev = o.shape[0], o.device
    prim = torch.full((n,), -1, dtype=torch.int32, device=dev)
    u = torch.zeros(n, dtype=torch.float32, device=dev)
    v = torch.zeros(n, dtype=torch.float32, device=dev)
    at = torch.full((n,), -1, dtype=torch.int64, device=dev)
    nrow = -(-leaf_size // TRIS_PER_ROW)

    def leaf(ll, el, t):
        # All slots of each leaf block at once: [m, K, 12].
        packed = -(el + 1)
        first, count = packed >> 4, packed & 15
        count_pops(pops, "leaf", packed, count.sum())
        block = rows[first[:, None] + torch.arange(nrow, device=dev)]
        m = ll.numel()
        tri = block[..., :TRIS_PER_ROW * 12].reshape(
            m, nrow * TRIS_PER_ROW, 12)[:, :leaf_size]
        tt, uu, vv, ok = mt_intersect(
            tri.reshape(-1, 12),
            o[ll].repeat_interleave(leaf_size, dim=0),
            d[ll].repeat_interleave(leaf_size, dim=0))
        tt, uu, vv = (x.reshape(m, leaf_size) for x in (tt, uu, vv))
        slot = torch.arange(leaf_size, device=dev)
        ok = (ok.reshape(m, leaf_size) & (tt < t[ll, None])
              & (slot < count[:, None]))
        # Testing the slots in order keeps the nearest hit, the first
        # slot among equals: the first minimum of t over the hits.
        best = torch.argmin(torch.where(ok, tt, torch.inf), dim=1,
                            keepdim=True)
        win = ok.any(dim=1)
        lw = ll[win]
        t[lw] = tt.gather(1, best)[win, 0]
        prim[lw] = tri[..., 9].view(torch.int32).gather(1, best)[win, 0]
        u[lw] = uu.gather(1, best)[win, 0]
        v[lw] = vv.gather(1, best)[win, 0]
        k = best[win, 0]
        at[lw] = ((first[win] + k // TRIS_PER_ROW) * ROW_WIDTH
                  + k % TRIS_PER_ROW * 12)
        return lw

    t = walk_plain(rows, o, d, t_max, active, stack_depth, any_hit, leaf,
                   pops)
    return t, prim, u, v, at


def closest_plain(rows, o, d, t_max, active, *, stack_depth: int,
                  leaf_size: int, pops: Optional[dict] = None):
    """Plain torch version of ``closest`` (same results, bit for bit).
    ``pops``, a dict, collects the walk's pop counts (``count_pops``)."""
    return _walk_plain(rows, o, d, t_max, active, stack_depth, leaf_size,
                       any_hit=False, pops=pops)[:4]


def anyhit_plain(rows, o, d, t_max, active, *, stack_depth: int,
                 leaf_size: int, pops: Optional[dict] = None):
    """Plain torch version of ``anyhit`` (same results)."""
    prim = _walk_plain(rows, o, d, t_max, active, stack_depth, leaf_size,
                       any_hit=True, pops=pops)[1]
    return prim >= 0
