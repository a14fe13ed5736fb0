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

Every entry point takes the table's node ``arity`` (2-16; the row holds
``6 * arity`` bounds and ``arity`` entries) and, optionally, a start entry
per packet: ``roots`` [ceil(N / packet)] int32, ray i walking from
``roots[i // packet]`` (the TPU kernels' ``root_ref``; the treelet
traversal, ops/treelet.py, passes its bins' subtree roots). A root may be
a node row, a leaf entry (the walk starts with that leaf) or
INVALID_ENTRY (no walk: the ray keeps t_max and misses). The kernels are
built once per arity (ops/cuda_build.py); a library that fails to build
raises.

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
from typing import Dict, Optional

import torch

from gpupathtracer_tpu_torch.ops import cuda_build
from gpupathtracer_tpu_torch.ops.intersect import fma32, mt_intersect

ROW_WIDTH = 128
ARITY = 8  # the default node arity (the kernels' build without a define)
TRIS_PER_ROW = ROW_WIDTH // 12
MAX_STACK = 192  # kMaxStack in csrc/bvh_walk.cuh
INVALID_ENTRY = 0x7FFFFFFF
SKIP_MARGIN = 2.0 ** -12  # kSkipMargin in csrc/bvh_walk.cuh

# Kernel launches since the last reset, by entry point. Each wrapper adds
# one where it launches its kernel and nowhere else: at another arity than
# 8 under the entry point's name + "_a<arity>", with roots + "_roots"
# (launch_key).
LAUNCHES = {"trace_closest": 0, "trace_anyhit": 0,
            "trace_closest_ilv": 0, "trace_anyhit_ilv": 0,
            "trace_closest_multi": 0, "trace_anyhit_multi": 0,
            "trace_closest_stats": 0, "trace_anyhit_stats": 0,
            "trace_closest_roots": 0, "trace_anyhit_roots": 0}
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

# The built libraries, by node arity.
_libs: Dict[int, ctypes.CDLL] = {}


def launch_key(entry: str, arity: int, roots) -> str:
    """The LAUNCHES key of a launch of ``entry``: + "_a<arity>" at another
    arity than 8, + "_roots" with start entries. Keys are made at their
    first launch."""
    return (entry + (f"_a{arity}" if arity != ARITY else "")
            + ("_roots" if roots is not None else ""))


def count_launch(launches: dict, key: str) -> None:
    launches[key] = launches.get(key, 0) + 1


def _library(arity: int = ARITY) -> ctypes.CDLL:
    if arity not in _libs:
        lib = ctypes.CDLL(cuda_build.build(
            "traverse", cuda_build.arity_defines(arity))[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpt_max_stack.argtypes = []
        lib.gpt_max_stack.restype = i
        lib.gpt_arity.argtypes = []
        lib.gpt_arity.restype = i
        # rows, o, d, t_max, active, n, depth, threads (B1) or w or q,
        # results..., stats, roots, packet, stream
        rays = [p, p, p, p, p, i, i]
        for name, sched, res in (("closest", [i], 4), ("anyhit", [i], 1),
                                 ("closest_ilv", [i], 4),
                                 ("anyhit_ilv", [i], 1),
                                 ("closest_multi", [i], 4),
                                 ("anyhit_multi", [i], 1)):
            fn = getattr(lib, "gpt_trace_" + name)
            fn.argtypes = rays + sched + [p] * (res + 2) + [i, p]
            fn.restype = i
        if lib.gpt_max_stack() != MAX_STACK:
            raise RuntimeError("csrc/bvh_walk.cuh and kernel_traverse.py "
                               "disagree on the stack size")
        if lib.gpt_arity() != arity:
            raise RuntimeError(f"the arity-{arity} build of csrc/traverse.cu "
                               f"walks {lib.gpt_arity()}-wide rows")
        _libs[arity] = lib
    return _libs[arity]


def check_rays(rows, o, d, t_max, active, stack_depth: int,
               arity: int = ARITY, roots=None, packet=None) -> None:
    """Raises ValueError unless the wrappers' table and ray arguments are
    what the kernels take (``check_roots`` for the arity and roots)."""
    n = o.shape[0]
    check_roots(n, o.device, arity, roots, packet)
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


def check_roots(n: int, device, arity: int, roots, packet) -> None:
    """Raises ValueError unless ``arity`` is 2-16 and ``roots`` is None
    (with ``packet`` None) or [ceil(n / packet)] int32 on ``device``."""
    if not 2 <= arity <= 16:
        raise ValueError(f"arity {arity} outside 2..16 (a node row holds "
                         f"6 * arity bounds and arity entries)")
    if roots is None:
        if packet is not None:
            raise ValueError("packet is the rays a start entry serves: pass "
                             "it with roots")
        return
    if packet is None or packet < 1:
        raise ValueError(f"roots need packet >= 1, got {packet}")
    want = (-(-n // packet),)
    if (tuple(roots.shape) != want or roots.dtype != torch.int32
            or roots.device != device or not roots.is_contiguous()):
        raise ValueError(f"roots must be contiguous int32 {want} on "
                         f"{device}, got {roots.dtype} "
                         f"{tuple(roots.shape)} on {roots.device}")


def ray_roots(n: int, device, roots, packet) -> torch.Tensor:
    """Each ray's start entry [n] int64: roots[i // packet], 0 (the root
    node row) without roots."""
    if roots is None:
        return torch.zeros(n, dtype=torch.int64, device=device)
    return roots.to(torch.int64).repeat_interleave(packet)[:n]


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
            threads: int, arity: int, roots, packet):
    """The kernel of a query and schedule at ``arity``; ``out`` its result
    tensors (t, prim, u, v for closest, occluded for any-hit). Returns the
    per-ray pop counts of its kStats instantiation with ``with_stats``,
    else None."""
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
        err = getattr(_library(arity), "gpt_trace_" + name)(
            rows.data_ptr(), o.data_ptr(), d.data_ptr(), t_max.data_ptr(),
            active.data_ptr(), n, depth, *sched,
            *(x.data_ptr() for x in out),
            None if stats is None else stats.data_ptr(),
            None if roots is None else roots.data_ptr(), packet or 1, stream)
    entry = launch_key(f"trace_{query}_stats" if with_stats
                       else "trace_" + name, arity, roots)
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    count_launch(LAUNCHES, entry)
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
            with_stats: bool = False, threads: int = THREADS,
            arity: int = ARITY, roots=None, packet=None):
    """Closest hit of rays o, d [N, 3] within (0, t_max) against the merged
    row table rows [M, 128] of ``arity``-wide nodes. Returns (t, prim, u,
    v), each [N]; t = t_max and prim = -1 on a miss or an inactive ray.
    ``interleave`` / ``multi_pop`` choose a schedule (module docstring);
    ``with_stats`` appends the per-ray pop counts [N, 2] (node, leaf)
    int32, [N, 3] under multi-pop (and the pushes dropped at the top of the
    stack). ``threads`` is the plain schedule's block size on the card
    (``BLOCK_SIZES``); the results do not depend on it. ``roots`` /
    ``packet``: the start entries (module docstring)."""
    check_rays(rows, o, d, t_max, active, stack_depth, arity, roots, packet)
    depth = check_schedule(stack_depth, interleave, multi_pop)
    check_threads(threads, interleave, multi_pop)
    if o.device.type == "cpu":
        return closest_plain(rows, o, d, t_max, active,
                             stack_depth=stack_depth, leaf_size=leaf_size,
                             interleave=interleave, multi_pop=multi_pop,
                             with_stats=with_stats, arity=arity, roots=roots,
                             packet=packet)
    n = o.shape[0]
    t = torch.empty(n, dtype=torch.float32, device=o.device)
    prim = torch.empty(n, dtype=torch.int32, device=o.device)
    u = torch.empty_like(t)
    v = torch.empty_like(t)
    stats = _launch(rows, o, d, t_max, active, depth, False, interleave,
                    multi_pop, (t, prim, u, v), with_stats, threads, arity,
                    roots, packet)
    return (t, prim, u, v, stats) if with_stats else (t, prim, u, v)


def anyhit(rows, o, d, t_max, active, *, stack_depth: int, leaf_size: int,
           interleave: int = 1, multi_pop: int = 1, with_stats: bool = False,
           threads: int = THREADS, arity: int = ARITY, roots=None,
           packet=None):
    """Occlusion of rays o, d [N, 3] within (0, t_max): [N] bool, True iff
    some triangle is hit. Inactive rays are never occluded. The schedule,
    block, arity and roots arguments are ``closest``'s; with
    ``with_stats`` returns (occluded, stats)."""
    check_rays(rows, o, d, t_max, active, stack_depth, arity, roots, packet)
    depth = check_schedule(stack_depth, interleave, multi_pop)
    check_threads(threads, interleave, multi_pop)
    if o.device.type == "cpu":
        return anyhit_plain(rows, o, d, t_max, active,
                            stack_depth=stack_depth, leaf_size=leaf_size,
                            interleave=interleave, multi_pop=multi_pop,
                            with_stats=with_stats, arity=arity, roots=roots,
                            packet=packet)
    occluded = torch.empty(o.shape[0], dtype=torch.bool, device=o.device)
    stats = _launch(rows, o, d, t_max, active, depth, True, interleave,
                    multi_pop, (occluded,), with_stats, threads, arity,
                    roots, packet)
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
               pop_skip: bool = False, arity: int = ARITY, roots=None,
               packet=None) -> torch.Tensor:
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
    ray's t is skipped. Node rows are ``arity`` wide; each ray starts at
    its entry of ``roots`` (``ray_roots``; none for INVALID_ENTRY).
    Returns t."""
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
    stack[:, 0] = ray_roots(n, dev, roots, packet)
    sp = (active & (stack[:, 0] != INVALID_ENTRY)).to(torch.int64)
    keys = (torch.full((n, stack_depth), -torch.inf, device=dev)
            if pop_skip else None)

    def expand(ln, en, t_entry):
        count_pops(pops, "node", en, tally=tally, lanes=ln)
        if not ln.numel():
            return
        row = rows[en]
        bounds = row[:, :6 * arity].reshape(-1, arity, 6)
        inv_l, oi_l = inv[ln][:, None, :], oi[ln][:, None, :]
        t0 = fma32(bounds[..., 0:3], inv_l, -oi_l)
        t1 = fma32(bounds[..., 3:6], inv_l, -oi_l)
        lo = torch.minimum(t0, t1)
        hi = torch.maximum(t0, t1)
        tmin = torch.maximum(torch.maximum(lo[..., 0], lo[..., 1]),
                             lo[..., 2])
        tmax = torch.minimum(torch.minimum(hi[..., 0], hi[..., 1]),
                             hi[..., 2])
        child = rows_i[en, 6 * arity:7 * arity].to(torch.int64)
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
        lane = ln[:, None].expand(-1, arity)
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
                multi_pop: int = 1, tally: Optional[torch.Tensor] = None,
                arity: int = ARITY, roots=None, packet=None):
    """``walk_plain`` over the MT-leaf table: leaf pops run Moller-Trumbore
    on the block's slots; ``tally``, ``arity`` and the roots as there.

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
                   pops, multi_pop, tally, arity=arity, roots=roots,
                   packet=packet)
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
                     any_hit, pops, interleave, multi_pop, with_stats,
                     arity=ARITY, roots=None, packet=None):
    """``_walk_plain`` under a schedule. Interleave: which thread and slot
    walk a ray, and when, does not change its walk, so the results are the
    plain schedule's, and so are its pop counts. Returns (t, prim, u, v, at,
    stats or None)."""
    depth = check_schedule(stack_depth, interleave, multi_pop)
    tally = new_tally(o.shape[0], o.device) if with_stats else None
    out = _walk_plain(rows, o, d, t_max, active, depth, leaf_size, any_hit,
                      pops, multi_pop, tally, arity, roots, packet)
    return out + (stats_of(tally, multi_pop) if with_stats else None,)


def closest_plain(rows, o, d, t_max, active, *, stack_depth: int,
                  leaf_size: int, pops: Optional[dict] = None,
                  interleave: int = 1, multi_pop: int = 1,
                  with_stats: bool = False, arity: int = ARITY, roots=None,
                  packet=None):
    """Plain torch version of ``closest`` (same results, bit for bit, pop
    counts too). ``pops``, a dict, collects the walk's pop totals and
    the table rows they read (``count_pops``)."""
    check_roots(o.shape[0], o.device, arity, roots, packet)
    t, prim, u, v, _, stats = _scheduled_plain(
        rows, o, d, t_max, active, stack_depth, leaf_size, False, pops,
        interleave, multi_pop, with_stats, arity, roots, packet)
    return (t, prim, u, v, stats) if with_stats else (t, prim, u, v)


def anyhit_plain(rows, o, d, t_max, active, *, stack_depth: int,
                 leaf_size: int, pops: Optional[dict] = None,
                 interleave: int = 1, multi_pop: int = 1,
                 with_stats: bool = False, arity: int = ARITY, roots=None,
                 packet=None):
    """Plain torch version of ``anyhit`` (same results)."""
    check_roots(o.shape[0], o.device, arity, roots, packet)
    out = _scheduled_plain(rows, o, d, t_max, active, stack_depth, leaf_size,
                           True, pops, interleave, multi_pop, with_stats,
                           arity, roots, packet)
    occluded = out[1] >= 0
    return (occluded, out[5]) if with_stats else occluded
