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

``with_stats=True`` (every schedule) adds the pop counters of the TPU
kernels' ``with_stats``, counted per ray: [N, 2] int32 node and leaf pops,
[N, 3] under multi-pop, whose third column is the ray's pushes dropped at
the top of its stack (the overflow latch: nonzero means hits may have been
lost). The TPU kernels count the pops of a packet's shared stack; summed
over a packet's rays these per-ray counts are what a walk of each ray
alone costs, not those pops. The kernel side is each entry point's
kStats instantiation (csrc/traverse.cu), launched when a stats array is
passed; the plain side counts the same pops lane by lane
(``count_pops``).
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
SKIP_MARGIN = 2.0 ** -12  # kSkipMargin in csrc/bvh_walk.cuh

# Kernel launches since the last reset, by entry point. Each wrapper adds
# one where it launches its kernel and nowhere else.
LAUNCHES = {"trace_closest": 0, "trace_anyhit": 0,
            "trace_closest_ilv": 0, "trace_anyhit_ilv": 0,
            "trace_closest_multi": 0, "trace_anyhit_multi": 0,
            "trace_closest_stats": 0, "trace_anyhit_stats": 0}
# Columns of a per-ray pop tally (count_pops): node pops, leaf (or cluster)
# pops run, cluster pops skipped (pop_skip), pushes dropped at the top of
# the stack.
POP_COLUMNS = {"node": 0, "leaf": 1, "skip": 2, "dropped": 3}
# Rays per thread of the interleave schedule and pops per iteration of the
# multi-pop schedule for which csrc/traverse.cu holds a kernel.
VARIANTS = (2, 4)
# Threads a block of the plain schedule's kernels (csrc/traverse.cu keeps
# their stacks in shared memory, depth * threads * 4 bytes a block), and
# the block size they run at unless told otherwise: the fastest of the
# three on sponza (PERF.md section 6).
BLOCK_SIZES = (64, 128, 256)
THREADS = 64

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build("traverse")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpt_max_stack.argtypes = []
        lib.gpt_max_stack.restype = i
        # rows, o, d, t_max, active, n, depth, threads (B1) or w or q,
        # results..., stats, stream
        rays = [p, p, p, p, p, i, i]
        for name, sched, res in (("closest", [i], 4), ("anyhit", [i], 1),
                                 ("closest_ilv", [i], 4),
                                 ("anyhit_ilv", [i], 1),
                                 ("closest_multi", [i], 4),
                                 ("anyhit_multi", [i], 1)):
            fn = getattr(lib, "gpt_trace_" + name)
            fn.argtypes = rays + sched + [p] * (res + 2)
            fn.restype = i
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


def check_aligned(rows) -> None:
    """Raises ValueError unless the row table starts on a 16-byte boundary:
    the walks read node rows and leaf slots as 16-byte loads."""
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary (the "
                         "kernels read them as 16-byte loads)")


def stream_of(o: torch.Tensor):
    """The current CUDA stream of o's device; raises for any other device."""
    if o.device.type != "cuda":
        raise ValueError(f"the traversal kernels take CUDA or CPU tensors, "
                         f"got {o.device}")
    return torch.cuda.current_stream(o.device).cuda_stream


def check_schedule(stack_depth: int, interleave: int, multi_pop: int) -> int:
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
    if stack_depth * multi_pop > MAX_STACK:
        raise ValueError(
            f"multi_pop={multi_pop} needs a stack of stack_depth * "
            f"multi_pop = {stack_depth * multi_pop} entries; the kernel's "
            f"holds {MAX_STACK}")
    return stack_depth * multi_pop


def _launch(rows, o, d, t_max, active, depth: int, any_hit: bool,
            interleave: int, multi_pop: int, out, with_stats: bool,
            threads: int):
    """The kernel of a query and schedule; ``out`` its result tensors (t,
    prim, u, v for closest, occluded for any-hit). Returns the per-ray pop
    counts of its kStats instantiation with ``with_stats``, else None."""
    stream = stream_of(o)
    check_aligned(rows)
    n = o.shape[0]
    stats = (torch.zeros((n, 3 if multi_pop > 1 else 2), dtype=torch.int32,
                         device=o.device) if with_stats else None)
    if not n:
        return stats
    query = "anyhit" if any_hit else "closest"
    name = query + ("_ilv" if interleave > 1 else
                    "_multi" if multi_pop > 1 else "")
    sched = ((interleave,) if interleave > 1 else
             (multi_pop,) if multi_pop > 1 else (threads,))
    with torch.cuda.device(o.device):
        err = getattr(_library(), "gpt_trace_" + name)(
            rows.data_ptr(), o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
            active.data_ptr(), n, depth, *sched,
            *(x.data_ptr() for x in out),
            None if stats is None else stats.data_ptr(), stream)
    entry = f"trace_{query}_stats" if with_stats else "trace_" + name
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1
    return stats


def check_threads(threads: int, interleave: int, multi_pop: int) -> None:
    if threads not in BLOCK_SIZES:
        raise ValueError(f"threads must be one of {BLOCK_SIZES}, got "
                         f"{threads}")
    if threads != THREADS and (interleave > 1 or multi_pop > 1):
        raise ValueError("threads is the plain schedule's block size; the "
                         "interleave and multi-pop kernels have their own")


def closest(rows, o, d, t_max, active, *, stack_depth: int, leaf_size: int,
            interleave: int = 1, multi_pop: int = 1,
            with_stats: bool = False, threads: int = THREADS):
    """Closest hit of rays o, d [N, 3] within (0, t_max) against the merged
    row table rows [M, 128]. Returns (t, prim, u, v), each [N]; t = t_max
    and prim = -1 on a miss or an inactive ray. ``interleave`` / ``multi_pop``
    choose a schedule (module docstring); ``with_stats`` appends the per-ray
    pop counts [N, 2] (node, leaf) int32, [N, 3] under multi-pop (and the
    pushes dropped at the top of the stack). ``threads`` is the plain
    schedule's block size on the card (``BLOCK_SIZES``); the results do
    not depend on it."""
    check_rays(rows, o, d, t_max, active, stack_depth)
    depth = check_schedule(stack_depth, interleave, multi_pop)
    check_threads(threads, interleave, multi_pop)
    if o.device.type == "cpu":
        return closest_plain(rows, o, d, t_max, active,
                             stack_depth=stack_depth, leaf_size=leaf_size,
                             interleave=interleave, multi_pop=multi_pop,
                             with_stats=with_stats)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    stats = _launch(rows, o, d, t_max, active, depth, False, interleave,
                    multi_pop, (t, prim, u, v), with_stats, threads)
    return (t, prim, u, v, stats) if with_stats else (t, prim, u, v)


def anyhit(rows, o, d, t_max, active, *, stack_depth: int, leaf_size: int,
           interleave: int = 1, multi_pop: int = 1, with_stats: bool = False,
           threads: int = THREADS):
    """Occlusion of rays o, d [N, 3] within (0, t_max): [N] bool, True iff
    some triangle is hit. Inactive rays are never occluded. The schedule
    and block arguments are ``closest``'s; with ``with_stats`` returns
    (occluded, stats)."""
    check_rays(rows, o, d, t_max, active, stack_depth)
    depth = check_schedule(stack_depth, interleave, multi_pop)
    check_threads(threads, interleave, multi_pop)
    if o.device.type == "cpu":
        return anyhit_plain(rows, o, d, t_max, active,
                            stack_depth=stack_depth, leaf_size=leaf_size,
                            interleave=interleave, multi_pop=multi_pop,
                            with_stats=with_stats)
    occluded = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    stats = _launch(rows, o, d, t_max, active, depth, True, interleave,
                    multi_pop, (occluded,), with_stats, threads)
    return (occluded, stats) if with_stats else occluded


def count_pops(pops: Optional[dict], kind: str, ids: torch.Tensor,
               slots=None, tally: Optional[torch.Tensor] = None,
               lanes: Optional[torch.Tensor] = None) -> None:
    """Adds a step's pops of one kind ("node" or "leaf") to ``pops``, the
    node rows, leaf entries or clusters they read to its set
    ``kind + "_ids"`` and, for leaves, the triangle slots they test to
    ``"slots"``: the work and the distinct table bytes a run needs
    (chip_smoke.py's bound). ``pops`` None counts nothing there. ``tally``
    [N, 4] int64, the per-ray counters, gains one in column
    ``POP_COLUMNS[kind]`` for each lane in ``lanes`` (each pop's ray)."""
    if tally is not None and lanes.numel():
        tally[:, POP_COLUMNS[kind]].index_add_(0, lanes,
                                               torch.ones_like(lanes))
    if pops is None or not ids.numel():
        return
    pops[kind] = pops.get(kind, 0) + ids.numel()
    pops.setdefault(kind + "_ids", set()).update(torch.unique(ids).tolist())
    if slots is not None:
        pops["slots"] = pops.get("slots", 0) + int(slots)


def walk_plain(rows, o, d, t_max, active, stack_depth: int, any_hit: bool,
               leaf, pops: Optional[dict] = None, multi_pop: int = 1,
               tally: Optional[torch.Tensor] = None,
               pop_skip: bool = False) -> torch.Tensor:
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
    ``multi_pop``); ``pops["overflow"]`` counts the pushes dropped at it,
    and ``tally`` [N, 4] (``count_pops``), if given, the pops of each ray:
    every popped node (all are expanded) and every intersected leaf, the
    leaf pops that ``pop_skip`` skips and the ray's dropped pushes.
    ``pop_skip`` (closest, single pop) keeps a key for each pushed entry on
    a parallel stack, as csrc/bvh_walk.cuh ``walk`` with kSkip does: its
    t_near less SKIP_MARGIN (|t_near| + |oi_a|), a the axis whose slab
    entry is t_near (``skip_key`` there: the margin covers the entry's
    rounding, which grows with the origin's distance, and a triangle's t
    rounding below its box's entry). A leaf pop whose key is not below its
    ray's t is skipped. Returns t."""
    if pop_skip and (any_hit or multi_pop > 1):
        raise ValueError("pop_skip orders pops by t_near: closest walks of "
                         "one pop a step only")
    n, dev = o.shape[0], o.device
    eps = torch.tensor(1e-12, dtype=torch.float32, device=dev)
    inv = torch.where(d >= 0, 1.0, -1.0) / torch.maximum(d.abs(), eps)
    oi = o * inv
    rows_i = rows.view(torch.int32)
    t = t_max.clone()
    stack = torch.zeros((n, stack_depth), dtype=torch.int64, device=dev)
    sp = active.to(torch.int64)  # stack[:, 0] = 0, the root row
    keys = (torch.full((n, stack_depth), -torch.inf, device=dev)
            if pop_skip else None)

    def expand(ln, en, t_entry):
        count_pops(pops, "node", en, tally=tally, lanes=ln)
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
        key = torch.where(hit, tmin, torch.inf)
        if keys is not None:  # csrc/bvh_walk.cuh skip_key
            scale = torch.where(lo == tmin[..., None], oi_l.abs(),
                                0.0).amax(dim=2)
            skey = tmin - SKIP_MARGIN * (tmin.abs() + scale)
        if not any_hit:
            order = torch.argsort(key, dim=1, stable=True)
            child = torch.gather(child, 1, order)
            hit = torch.gather(hit, 1, order)
            if keys is not None:
                skey = torch.gather(skey, 1, order)
        # The k-th pushed child (in pop order) sits k below the top.
        rank = torch.cumsum(hit.to(torch.int64), dim=1) - 1
        total = hit.sum(dim=1)
        pos = sp[ln, None] + total[:, None] - 1 - rank
        keep = hit & (pos < stack_depth)
        if pops is not None:
            pops["overflow"] = pops.get("overflow", 0) + int(
                (hit & ~keep).sum())
        if tally is not None:
            tally[:, POP_COLUMNS["dropped"]].index_add_(
                0, ln, (hit & ~keep).sum(dim=1))
        lane = ln[:, None].expand(-1, ARITY)
        stack[lane[keep], pos[keep]] = child[keep]
        if keys is not None:
            keys[lane[keep], pos[keep]] = skey[keep]
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
            if keys is not None:
                skip = is_leaf & (keys[lanes, sp[lanes]] >= t[lanes])
                count_pops(None, "skip", lanes[skip], tally=tally,
                           lanes=lanes[skip])
                is_leaf &= ~skip
            ll, el = lanes[is_leaf], entry[is_leaf]
            count_pops(None, "leaf", el, tally=tally, lanes=ll)
            if ll.numel():
                lw = leaf(ll, el, t)
                if any_hit:
                    sp[lw] = -1
    return t


def _walk_plain(rows, o, d, t_max, active, stack_depth: int, leaf_size: int,
                any_hit: bool, pops: Optional[dict] = None,
                multi_pop: int = 1, tally: Optional[torch.Tensor] = None):
    """``walk_plain`` over the MT-leaf table: leaf pops run Moller-Trumbore
    on the block's slots; ``tally`` as there.

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
                   pops, multi_pop, tally)
    return t, prim, u, v, at


def new_tally(n: int, device) -> torch.Tensor:
    """Zeroed per-ray pop counters for ``count_pops``: [n, 4] int64."""
    return torch.zeros((n, len(POP_COLUMNS)), dtype=torch.int64,
                       device=device)


def stats_of(tally: torch.Tensor, multi_pop: int = 1) -> torch.Tensor:
    """The kernels' per-ray stats from a tally: [N, 2] int32 (node, leaf),
    [N, 3] under multi-pop (and dropped pushes)."""
    cols = [POP_COLUMNS["node"], POP_COLUMNS["leaf"]]
    if multi_pop > 1:
        cols.append(POP_COLUMNS["dropped"])
    return tally[:, cols].to(torch.int32)


def _scheduled_plain(rows, o, d, t_max, active, stack_depth, leaf_size,
                     any_hit, pops, interleave, multi_pop, with_stats):
    """``_walk_plain`` under a schedule. Interleave: which thread and slot
    walk a ray, and when, does not change its walk, so the results are the
    plain schedule's, and so are its pop counts. Returns (t, prim, u, v, at,
    stats or None)."""
    depth = check_schedule(stack_depth, interleave, multi_pop)
    tally = new_tally(o.shape[0], o.device) if with_stats else None
    out = _walk_plain(rows, o, d, t_max, active, depth, leaf_size, any_hit,
                      pops, multi_pop, tally)
    return out + (stats_of(tally, multi_pop) if with_stats else None,)


def closest_plain(rows, o, d, t_max, active, *, stack_depth: int,
                  leaf_size: int, pops: Optional[dict] = None,
                  interleave: int = 1, multi_pop: int = 1,
                  with_stats: bool = False):
    """Plain torch version of ``closest`` (same results, bit for bit, pop
    counts too). ``pops``, a dict, collects the walk's pop totals and
    the table rows they read (``count_pops``)."""
    t, prim, u, v, _, stats = _scheduled_plain(
        rows, o, d, t_max, active, stack_depth, leaf_size, False, pops,
        interleave, multi_pop, with_stats)
    return (t, prim, u, v, stats) if with_stats else (t, prim, u, v)


def anyhit_plain(rows, o, d, t_max, active, *, stack_depth: int,
                 leaf_size: int, pops: Optional[dict] = None,
                 interleave: int = 1, multi_pop: int = 1,
                 with_stats: bool = False):
    """Plain torch version of ``anyhit`` (same results)."""
    out = _scheduled_plain(rows, o, d, t_max, active, stack_depth, leaf_size,
                           True, pops, interleave, multi_pop, with_stats)
    occluded = out[1] >= 0
    return (occluded, out[5]) if with_stats else occluded
