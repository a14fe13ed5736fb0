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

Two more schedules of the same walk are further entry points of the same
source, replacing ``_kernel_ilv`` (``interleave=W``: a thread carries W
rays) and ``_kernel_multi`` (``multi_pop=Q``: up to Q pops of a ray's stack
per iteration, node pruning against the t the iteration began with). Both
give the hits of the plain schedule; multi-pop visits in another order, so
among triangles at bitwise-equal t another one may win.
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
LAUNCHES = {"trace_closest": 0, "trace_anyhit": 0,
            "trace_closest_ilv": 0, "trace_anyhit_ilv": 0,
            "trace_closest_multi": 0, "trace_anyhit_multi": 0}
# Rays per thread of the interleave schedule and pops per iteration of the
# multi-pop schedule for which csrc/traverse.cu holds a kernel.
VARIANTS = (2, 4)

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
        lib.gpt_trace_closest_ilv.argtypes = [p, p, p, p, p, i, i, i, p, p, p,
                                              p, p]
        lib.gpt_trace_closest_ilv.restype = i
        lib.gpt_trace_anyhit_ilv.argtypes = [p, p, p, p, p, i, i, i, p, p]
        lib.gpt_trace_anyhit_ilv.restype = i
        lib.gpt_trace_closest_multi.argtypes = [p, p, p, p, p, i, i, i, p, p,
                                                p, p, p, p]
        lib.gpt_trace_closest_multi.restype = i
        lib.gpt_trace_anyhit_multi.argtypes = [p, p, p, p, p, i, i, i, p, p,
                                               p]
        lib.gpt_trace_anyhit_multi.restype = i
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


def check_schedule(stack_depth: int, interleave: int, multi_pop: int,
                   with_stats: bool) -> int:
    """Raises unless the schedule arguments name a kernel; returns the
    stack bound the walk runs with (``stack_depth * multi_pop``: Q pops at
    once keep up to Q subtrees open, so the depth-first bound scales)."""
    if interleave != 1 and multi_pop != 1:
        raise ValueError("interleave and multi_pop are two schedules: pass "
                         "one of them")
    for name, x in (("interleave", interleave), ("multi_pop", multi_pop)):
        if x != 1 and x not in VARIANTS:
            raise ValueError(f"{name} must be 1 or one of {VARIANTS}, "
                             f"got {x}")
    if with_stats and multi_pop == 1:
        raise NotImplementedError(
            "with_stats reports the multi-pop schedule's overflow latch "
            "only; the pop counters are not ported yet (ROADMAP.md, A19)")
    if stack_depth * multi_pop > MAX_STACK:
        raise ValueError(
            f"multi_pop={multi_pop} needs a stack of stack_depth * "
            f"multi_pop = {stack_depth * multi_pop} entries; the kernel's "
            f"holds {MAX_STACK}")
    return stack_depth * multi_pop


def _launch(entry: str, fn, *args) -> None:
    err = fn(*args)
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1


def closest(rows, o, d, t_max, active, *, stack_depth: int, leaf_size: int,
            interleave: int = 1, multi_pop: int = 1,
            with_stats: bool = False):
    """Closest hit of rays o, d [N, 3] within (0, t_max) against the merged
    row table rows [M, 128]. Returns (t, prim, u, v), each [N]; t = t_max
    and prim = -1 on a miss or an inactive ray. ``interleave`` / ``multi_pop``
    choose a schedule (module docstring); ``with_stats`` (multi-pop only)
    appends the launch's count of pushes dropped at the top of the stack, a
    0-dim int32 tensor: nonzero means hits may have been lost."""
    check_rays(rows, o, d, t_max, active, stack_depth)
    depth = check_schedule(stack_depth, interleave, multi_pop, with_stats)
    if o.device.type == "cpu":
        return closest_plain(rows, o, d, t_max, active,
                             stack_depth=stack_depth, leaf_size=leaf_size,
                             interleave=interleave, multi_pop=multi_pop,
                             with_stats=with_stats)
    stream = stream_of(o)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    overflow = (torch.zeros((), dtype=torch.int32, device=o.device)
                if with_stats else None)
    if n:
        lib = _library()
        rays = (rows.data_ptr(), o.data_ptr(), d.data_ptr(),
                t_max.data_ptr(), active.data_ptr(), n, depth)
        out = (t.data_ptr(), prim.data_ptr(), u.data_ptr(), v.data_ptr())
        with torch.cuda.device(o.device):
            if interleave > 1:
                _launch("trace_closest_ilv", lib.gpt_trace_closest_ilv, *rays,
                        interleave, *out, stream)
            elif multi_pop > 1:
                _launch("trace_closest_multi", lib.gpt_trace_closest_multi,
                        *rays, multi_pop, *out,
                        overflow.data_ptr() if with_stats else None, stream)
            else:
                _launch("trace_closest", lib.gpt_trace_closest, *rays, *out,
                        stream)
    return (t, prim, u, v, overflow) if with_stats else (t, prim, u, v)


def anyhit(rows, o, d, t_max, active, *, stack_depth: int, leaf_size: int,
           interleave: int = 1, multi_pop: int = 1, with_stats: bool = False):
    """Occlusion of rays o, d [N, 3] within (0, t_max): [N] bool, True iff
    some triangle is hit. Inactive rays are never occluded. The schedule
    arguments are ``closest``'s; with ``with_stats`` returns (occluded,
    overflow)."""
    check_rays(rows, o, d, t_max, active, stack_depth)
    depth = check_schedule(stack_depth, interleave, multi_pop, with_stats)
    if o.device.type == "cpu":
        return anyhit_plain(rows, o, d, t_max, active,
                            stack_depth=stack_depth, leaf_size=leaf_size,
                            interleave=interleave, multi_pop=multi_pop,
                            with_stats=with_stats)
    stream = stream_of(o)
    n = o.shape[0]
    occluded = torch.empty(n, dtype=torch.bool, device=o.device)
    overflow = (torch.zeros((), dtype=torch.int32, device=o.device)
                if with_stats else None)
    if n:
        lib = _library()
        rays = (rows.data_ptr(), o.data_ptr(), d.data_ptr(),
                t_max.data_ptr(), active.data_ptr(), n, depth)
        with torch.cuda.device(o.device):
            if interleave > 1:
                _launch("trace_anyhit_ilv", lib.gpt_trace_anyhit_ilv, *rays,
                        interleave, occluded.data_ptr(), stream)
            elif multi_pop > 1:
                _launch("trace_anyhit_multi", lib.gpt_trace_anyhit_multi,
                        *rays, multi_pop, occluded.data_ptr(),
                        overflow.data_ptr() if with_stats else None, stream)
            else:
                _launch("trace_anyhit", lib.gpt_trace_anyhit, *rays,
                        occluded.data_ptr(), stream)
    return (occluded, overflow) if with_stats else occluded


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
               leaf, pops: Optional[dict] = None,
               multi_pop: int = 1) -> torch.Tensor:
    """The node phase of csrc/bvh_walk.cuh ``walk`` (``walk_multi`` with
    ``multi_pop`` > 1), for every ray in lockstep with its own stack: each
    step pops one entry per live ray (up to ``multi_pop``). Node pops push
    the entered children so that they pop in ascending (t_near, slot)
    order (slot order for any-hit); with several pops a step, every node
    is pruned against the t its ray held when the step began, and the
    nodes are expanded, in pop order, before the leaves. Leaf pops go to
    ``leaf(lanes, entries, t)``, which intersects them, lowers ``t`` in
    place where it finds a closer hit, records what its caller needs and
    returns the lanes that hit; with ``any_hit`` those walks end.
    ``stack_depth`` is the bound the walk runs with (already scaled by
    ``multi_pop``); ``pops["overflow"]`` counts the pushes dropped at it.
    Returns t."""
    n, dev = o.shape[0], o.device
    eps = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    inv = torch.where(d >= 0, 1.0, -1.0) / torch.maximum(d.abs(), eps)
    oi = o * inv
    rows_i = rows.view(torch.int32)
    t = t_max.clone()
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)  # stack[:, 0] = 0, the root row

    def expand(ln, en, t_entry):
        count_pops(pops, "node", en)
        if not ln.numel():
            return
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
        hit = ((tmin <= tmax) & (tmax > 0.0) & (tmin < t_entry[ln, None])
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
        if pops is not None:
            pops["overflow"] = pops.get("overflow", 0) + int(
                (hit & ~keep).sum())
        lane = ln[:, None].expand(-1, ARITY)
        stack[lane[keep], pos[keep]] = child[keep]
        sp[ln] = torch.clamp_max(sp[ln] + total, stack_depth)

    while True:
        live = torch.nonzero(sp > 0).squeeze(1)
        if live.numel() == 0:
            break
        popped = []
        for _ in range(multi_pop):
            sp[live] -= 1
            popped.append((live, stack[live, sp[live]]))
            live = live[sp[live] > 0]
            if not live.numel():
                break
        t_entry = t.clone() if multi_pop > 1 else t
        for lanes, entry in popped:
            is_node = entry >= 0
            expand(lanes[is_node], entry[is_node], t_entry)
        for lanes, entry in popped:
            # A walk that an earlier leaf of this step ended pops no more.
            is_leaf = (entry < 0) & (sp[lanes] >= 0)
            ll, el = lanes[is_leaf], entry[is_leaf]
            if ll.numel():
                lw = leaf(ll, el, t)
                if any_hit:
                    sp[lw] = -1
    return t


def _walk_plain(rows, o, d, t_max, active, stack_depth: int, leaf_size: int,
                any_hit: bool, pops: Optional[dict] = None,
                multi_pop: int = 1):
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
                   pops, multi_pop)
    return t, prim, u, v, at


def _scheduled_plain(rows, o, d, t_max, active, stack_depth, leaf_size,
                     any_hit, pops, interleave, multi_pop, with_stats):
    """``_walk_plain`` under a schedule. Interleave: the rays split as the
    kernel's threads carry them (slot w of the T = ceil(N / W) threads
    holds rays w*T ... w*T + T - 1), one walk per slot; a ray's walk does
    not depend on its thread, so the results are the plain schedule's.
    Returns (t, prim, u, v, at, overflow)."""
    depth = check_schedule(stack_depth, interleave, multi_pop, with_stats)
    n = o.shape[0]
    if with_stats and pops is None:
        pops = {}
    per = -(-n // interleave) if n else 1
    parts = [_walk_plain(rows, o[a:a + per], d[a:a + per], t_max[a:a + per],
                         active[a:a + per], depth, leaf_size, any_hit, pops,
                         multi_pop)
             for a in range(0, max(n, 1), per)]
    out = tuple(torch.cat(x) for x in zip(*parts))
    overflow = None
    if with_stats:
        overflow = torch.tensor(pops.get("overflow", 0), dtype=torch.int32,
                                device=o.device)
    return out + (overflow,)


def closest_plain(rows, o, d, t_max, active, *, stack_depth: int,
                  leaf_size: int, pops: Optional[dict] = None,
                  interleave: int = 1, multi_pop: int = 1,
                  with_stats: bool = False):
    """Plain torch version of ``closest`` (same results, bit for bit).
    ``pops``, a dict, collects the walk's pop counts (``count_pops``)."""
    t, prim, u, v, _, overflow = _scheduled_plain(
        rows, o, d, t_max, active, stack_depth, leaf_size, False, pops,
        interleave, multi_pop, with_stats)
    return (t, prim, u, v, overflow) if with_stats else (t, prim, u, v)


def anyhit_plain(rows, o, d, t_max, active, *, stack_depth: int,
                 leaf_size: int, pops: Optional[dict] = None,
                 interleave: int = 1, multi_pop: int = 1,
                 with_stats: bool = False):
    """Plain torch version of ``anyhit`` (same results)."""
    out = _scheduled_plain(rows, o, d, t_max, active, stack_depth, leaf_size,
                           True, pops, interleave, multi_pop, with_stats)
    occluded = out[1] >= 0
    return (occluded, out[5]) if with_stats else occluded
