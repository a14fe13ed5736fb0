"""The roofline probes: wrappers of csrc/roofline.cu and their plain torch
versions.

They replace the JAX package's Pallas probes of tools/roofline.py, which
measure what the chip can do with no memory traffic and what each phase
of a tree walk costs without the stack machinery:

  vpu           ``vpu_kernel`` (:129): ``ilp`` independent chains of
                ``a = max((a * scale + 0.25) * 0.9998, 0.125)`` on a tile
  mxu           ``mxu_kernel`` (:177): ``acc += dot(a + acc[:, :1] * 1e-30,
                b)``, f32 or bf16 in, f32 out
  node_slab     ``node_slab_kernel`` (:253): the 8-child slab test of a node
                pop against rows that rotate ``i % 64``
  leaf_mt       ``leaf_mt_kernel`` (:289): the Moller-Trumbore test of a
                10-triangle leaf
  cluster_dense ``cluster_dense_kernel`` (:332): a dense cluster pop of tc
                triangles and its winner's u, v (any-hit: the minimum only)

Layouts are the JAX probes' (x [R, 128]; rays o, d, inv [3, G, 128]; rows
[64, 128]; cluster blocks [16, 3 * tc]). A TPU probe runs one tile on one
core; an H100 needs some 500 blocks in flight, so every wrapper takes
``copies``: the same tile's work is done ``copies`` times over and the
result is [copies, *tile], every copy equal to the plain version of the
one tile. On CPU tensors each wrapper runs its plain version; on CUDA
tensors it launches its kernel (built with nvcc on first use,
ops/cuda_build.py) and nothing else.

Rounding: the plain versions make the fused multiply-adds XLA makes when
it compiles the JAX probe for the CPU (interpret mode), with ``fma32``,
and ``bvh_walk.cuh``'s cluster dot products; the kernels write the same
``__fmaf_rn`` (the build has --fmad=false), so kernel and plain version
agree bit for bit, and the plain versions agree with the JAX probes bit
for bit (tests/test_torch_roofline.py). ``leaf_mt`` takes the JAX
probe's rounding of the determinant, which differs from the traversal
kernel's (``leaf_mt_plain``); its instructions are the traversal's. The
exception is ``mxu``: the plain version sums each product in k order with
fused multiply-adds as the f32 kernel does (bitwise), while XLA's CPU dot
and the bf16 tensor cores sum in their own orders (a stated tolerance).
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

from gpupathtracer_tpu_torch.ops import cuda_build, kernel_cluster
from gpupathtracer_tpu_torch.ops.intersect import fma32

LANES = 128
ROWS = 64          # the node / leaf probes' resident rows
LEAF_SIZE = 10     # triangles of the leaf probe's row
THREADS = 128      # csrc/roofline.cu kThreads: blocks are whole tiles of it

# FP32 instructions a lane issues per step of each probe body (the bound:
# these at the card's FP32 issue rate). An IEEE division is counted as one,
# so the bound stays a least time; compares and selects count one each.
VPU_STEP = 3               # FFMA, FMUL, FMNMX per chain
NODE_CHILD = 6 + 6 + 4 + 3 + 1 + 1  # slab FMAs, min/max, running min/max,
#                                     compares, select, accumulate
NODE_POP = 8 * NODE_CHILD + 1       # + t_cur
# NODE_POP is the JAX probe's count (tools/roofline.py), kept for parity
# with it; csrc/roofline.cu's body adds under the hit predicate and issues
# no select, 161 instructions a pop (PERF.md section 6 gives both shares).
MT_SLOT = 40               # csrc/bvh_walk.cuh intersect_leaf, per triangle
CLUSTER_SLOT = 31          # cluster_min per slot: 6 dots (18), 3 adds, a
#                            division, 2 FMAs, u + v, 4 compares, the min
CLUSTER_EPILOGUE = 22      # cluster_uv and the output of a closest pop

# Kernel launches since the last reset, by probe. Each wrapper adds one
# where it launches its kernel and nowhere else.
LAUNCHES = {"roofline_vpu": 0, "roofline_mxu_f32": 0, "roofline_mxu_bf16": 0,
            "roofline_node_slab": 0, "roofline_leaf_mt": 0,
            "roofline_cluster_dense": 0}

_lib: Optional[ctypes.CDLL] = None


def _library() -> ctypes.CDLL:
    global _lib
    if _lib is None:
        lib = ctypes.CDLL(cuda_build.build("roofline")[0])
        p, i = ctypes.c_void_p, ctypes.c_int
        lib.gpt_roofline_vpu.argtypes = [p, i, i, i, i, p, p]
        lib.gpt_roofline_mxu.argtypes = [i, p, p, i, i, i, i, i, p, p]
        lib.gpt_roofline_node_slab.argtypes = [p, p, p, i, i, i, p, p]
        lib.gpt_roofline_leaf_mt.argtypes = [p, p, p, i, i, i, p, p]
        lib.gpt_roofline_cluster.argtypes = [p, p, p, p, i, i, i, i, i, p, p]
        for fn in (lib.gpt_roofline_vpu, lib.gpt_roofline_mxu,
                   lib.gpt_roofline_node_slab, lib.gpt_roofline_leaf_mt,
                   lib.gpt_roofline_cluster):
            fn.restype = i
        _lib = lib
    return _lib


def _launch(entry: str, fn, *args) -> None:
    err = fn(*args)
    if err == -1:
        raise ValueError(f"{entry}: no kernel takes these arguments")
    if err:
        raise RuntimeError(f"{entry} launch failed: CUDA error {err}")
    LAUNCHES[entry] += 1


def _check(name: str, x, shape, dtype, device) -> None:
    if (tuple(x.shape) != tuple(shape) or x.dtype != dtype
            or x.device != device or not x.is_contiguous()):
        raise ValueError(f"{name} must be contiguous {dtype} {tuple(shape)} "
                         f"on {device}, got {x.dtype} {tuple(x.shape)} on "
                         f"{x.device}")


def _stream(device):
    if device.type != "cuda":
        raise ValueError(f"the roofline probes take CUDA or CPU tensors, got "
                         f"{device}")
    return torch.cuda.current_stream(device).cuda_stream


def _copies(out: torch.Tensor, copies: int) -> torch.Tensor:
    return out.unsqueeze(0).expand(copies, *out.shape).clone()


def _positive(**kw) -> None:
    for k, v in kw.items():
        if v < 1:
            raise ValueError(f"{k} must be >= 1, got {v}")


# --- 1. the VPU probe ----------------------------------------------------------

def vpu(x, *, iters: int, ilp: int, copies: int = 1) -> torch.Tensor:
    """``vpu_kernel`` on x [R, 128] f32 (any R >= 1): [copies, R, 128].
    ilp is 1 or 8 (the probes JAX runs)."""
    _positive(iters=iters, copies=copies)
    if ilp not in (1, 8):
        raise ValueError(f"ilp must be 1 or 8, got {ilp}")
    _check("x", x, (x.shape[0], LANES), torch.float32, x.device)
    if x.device.type == "cpu":
        return _copies(vpu_plain(x, iters=iters, ilp=ilp), copies)
    out = torch.empty((copies,) + tuple(x.shape), dtype=torch.float32,
                      device=x.device)
    with torch.cuda.device(x.device):
        _launch("roofline_vpu", _library().gpt_roofline_vpu, x.data_ptr(),
                x.shape[0], iters, ilp, copies, out.data_ptr(),
                _stream(x.device))
    return out


def vpu_plain(x, *, iters: int, ilp: int) -> torch.Tensor:
    """Plain version of one tile: [R, 128]. XLA contracts the scale row and
    ``a * scale + 0.25`` into fused multiply-adds; ``a * 0.9998`` is a
    multiply (its sum is a max)."""
    def f32(v):
        return torch.tensor(v, dtype=torch.float32, device=x.device)

    accs = [x * f32(1.0 + 1e-4 * k) for k in range(ilp)]
    scale = fma32(x[0:1, :], f32(1e-6), f32(0.9999)).expand_as(x)
    quarter = torch.full_like(x, 0.25)
    for _ in range(iters):
        accs = [torch.clamp_min(fma32(a, scale, quarter) * 0.9998, 0.125)
                for a in accs]
    r = accs[0]
    for a in accs[1:]:
        r = r + a
    return r


# --- 2. the MXU probe ----------------------------------------------------------

def mxu(a, b, *, iters: int, copies: int = 1) -> torch.Tensor:
    """``mxu_kernel``: a [M, K], b [K, N], both f32 or both bf16; returns
    acc [copies, M, N] f32. f32 runs FP32 fused multiply-adds on the CUDA
    cores (H100 tensor cores have no full-f32 mode), its operands staged
    in shared memory once: a block's band of at least 8 rows of a (twice)
    and b's columns must fit a block's shared memory, or it raises. bf16
    runs the tensor cores (wgmma on operands staged in shared memory once;
    K a multiple of 16, M of 64, N of 8; a 64-row band of a and a column
    slab of b must fit a block's shared memory, K up to 512 on an H100, or
    it raises)."""
    _positive(iters=iters, copies=copies)
    m, k = a.shape
    n = b.shape[1]
    if a.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"mxu takes f32 or bf16, got {a.dtype}")
    _check("a", a, (m, k), a.dtype, a.device)
    _check("b", b, (k, n), a.dtype, a.device)
    bf16 = a.dtype == torch.bfloat16
    if bf16 and (k % 16 or m % 64 or n % 8):
        raise ValueError(f"bf16 needs K % 16, M % 64 and N % 8 == 0, got "
                         f"[{m}, {k}] x [{k}, {n}]")
    if a.device.type == "cpu":
        return _copies(mxu_plain(a, b, iters=iters), copies)
    out = torch.empty((copies, m, n), dtype=torch.float32, device=a.device)
    with torch.cuda.device(a.device):
        _launch("roofline_mxu_bf16" if bf16 else "roofline_mxu_f32",
                _library().gpt_roofline_mxu, int(bf16), a.data_ptr(),
                b.data_ptr(), m, k, n, iters, copies, out.data_ptr(),
                _stream(a.device))
    return out


def mxu_plain(a, b, *, iters: int) -> torch.Tensor:
    """Plain version: acc [M, N] f32. f32: each product of a row and a
    column summed in k order with fused multiply-adds, as the f32 kernel
    sums it; bf16: the feedback rounded to bf16 as JAX rounds it, the
    products summed in float64 (the tensor cores' order is their own)."""
    m, n = a.shape[0], b.shape[1]
    acc = torch.zeros((m, n), dtype=torch.float32, device=a.device)
    tiny = torch.tensor(1e-30, dtype=torch.float32, device=a.device)
    for _ in range(iters):
        f = (acc[:, 0:1] * tiny).to(a.dtype)
        a2 = (a.float() + f.float()).to(a.dtype)
        if a.dtype == torch.bfloat16:
            acc = (acc.double() + a2.double() @ b.double()).float()
            continue
        s = torch.zeros_like(acc)
        for kk in range(a.shape[1]):
            s = fma32(a2[:, kk:kk + 1].expand(m, n),
                      b[kk:kk + 1, :].expand(m, n), s)
        acc = acc + s
    return acc


# --- 4. the traversal-phase floors --------------------------------------------

def _check_rays(rows, o, d, inv, n_rows: int, width: int):
    g = o.shape[1]
    _check("rows", rows, (n_rows, width), torch.float32, o.device)
    for name, x in (("o", o), ("d", d), ("inv", inv)):
        _check(name, x, (3, g, LANES), torch.float32, o.device)
    return g


def node_slab(rows, o, d, inv, *, iters: int, copies: int = 1):
    """``node_slab_kernel``: rows [64, 128], rays o, d, inv [3, G, 128];
    returns [copies, G, 128], each lane's sum of the entry distances of
    the children it enters, over ``iters`` pops of row i % 64, a pop's
    terms added in child order (the sum is not order-free)."""
    _positive(iters=iters, copies=copies)
    g = _check_rays(rows, o, d, inv, ROWS, LANES)
    if o.device.type == "cpu":
        return _copies(node_slab_plain(rows, o, d, inv, iters=iters), copies)
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary (the kernel "
                         "stages them as 16-byte loads)")
    out = torch.empty((copies, g, LANES), dtype=torch.float32,
                      device=o.device)
    with torch.cuda.device(o.device):
        _launch("roofline_node_slab", _library().gpt_roofline_node_slab,
                rows.data_ptr(), o.data_ptr(), inv.data_ptr(), g, iters,
                copies, out.data_ptr(), _stream(o.device))
    return out


def node_slab_plain(rows, o, d, inv, *, iters: int):
    """Plain version: [G, 128]. The slab test of bvh_walk.cuh ``slab``:
    fma(bound, inv, -o * inv), NaN-propagating min / max."""
    oi = o * inv
    acc = torch.zeros(o.shape[1:], dtype=torch.float32, device=o.device)
    for i in range(iters):
        row = rows[i % ROWS]
        t_cur = acc + 1e20
        for j in range(8):
            lo = [fma32(row[j * 6 + a].expand_as(acc), inv[a], -oi[a])
                  for a in range(3)]
            hi = [fma32(row[j * 6 + 3 + a].expand_as(acc), inv[a], -oi[a])
                  for a in range(3)]
            tmin = tmax = None
            for a in range(3):
                lo_t = torch.minimum(lo[a], hi[a])
                hi_t = torch.maximum(lo[a], hi[a])
                tmin = lo_t if tmin is None else torch.maximum(tmin, lo_t)
                tmax = hi_t if tmax is None else torch.minimum(tmax, hi_t)
            hit = (tmin <= tmax) & (tmax > 0.0) & (tmin < t_cur)
            acc = acc + torch.where(hit, tmin, 0.0)
    return acc


def leaf_mt(rows, o, d, inv, *, iters: int, copies: int = 1):
    """``leaf_mt_kernel`` (leaf_size 10): returns [copies, G, 128], each
    lane's closest t (1e20 if none) over ``iters`` leaf pops of row
    i % 64. ``inv`` is unused, as in the JAX probe."""
    _positive(iters=iters, copies=copies)
    g = _check_rays(rows, o, d, inv, ROWS, LANES)
    if o.device.type == "cpu":
        return _copies(leaf_mt_plain(rows, o, d, inv, iters=iters), copies)
    if rows.data_ptr() % 16:
        raise ValueError("rows must start on a 16-byte boundary (the kernel "
                         "stages them as 16-byte loads)")
    out = torch.empty((copies, g, LANES), dtype=torch.float32,
                      device=o.device)
    with torch.cuda.device(o.device):
        _launch("roofline_leaf_mt", _library().gpt_roofline_leaf_mt,
                rows.data_ptr(), o.data_ptr(), d.data_ptr(), g, iters, copies,
                out.data_ptr(), _stream(o.device))
    return out


def leaf_mt_plain(rows, o, d, inv, *, iters: int):
    """Plain version: [G, 128]. The Moller-Trumbore test of ops/intersect.py
    ``mt_intersect`` but for the determinant: XLA fuses the JAX probe's body
    otherwise than the traversal kernel's and contracts it as
    fma(e1z, pz, fma(e1x, px, e1y * py)) (the CUDA probe does the same, for
    the same instructions as bvh_walk.cuh ``intersect_leaf``)."""
    shape = o.shape[1:]
    t_c = torch.full((o[0].numel(),), 1e20, dtype=torch.float32,
                     device=o.device)
    for i in range(iters):
        for k in range(LEAF_SIZE):
            t, valid = leaf_mt_slot(rows[i % ROWS], k, o, d)
            t_c = torch.where(valid & (t < t_c), t, t_c)
    return t_c.reshape(shape)


def leaf_mt_slot(row, k: int, o, d):
    """Slot k of one leaf row against every lane of rays o, d [3, G, 128]:
    (t, valid) flat [G * 128], valid the probe's test but for t < t_c (which
    alone depends on the lane's running t_c)."""
    ox, oy, oz = (o[a].reshape(-1) for a in range(3))
    dx, dy, dz = (d[a].reshape(-1) for a in range(3))
    p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z = (
        row[k * 12 + j].expand_as(ox) for j in range(9))
    px = fma32(dy, e2z, -(dz * e2y))
    py = fma32(dz, e2x, -(dx * e2z))
    pz = fma32(dx, e2y, -(dy * e2x))
    idet = torch.ones_like(ox) / fma32(e1z, pz, fma32(e1x, px, e1y * py))
    tx, ty, tz = ox - p0x, oy - p0y, oz - p0z
    u = fma32(tz, pz, fma32(tx, px, ty * py)) * idet
    qx = fma32(ty, e1z, -(tz * e1y))
    qy = fma32(tz, e1x, -(tx * e1z))
    qz = fma32(tx, e1y, -(ty * e1x))
    v = fma32(dz, qz, fma32(dx, qx, dy * qy)) * idet
    t = fma32(e2z, qz, fma32(e2x, qx, e2y * qy)) * idet
    return t, ((u > 0.0) & (u < 1.0) & (v > 0.0) & (u + v < 1.0)
               & (t > 0.0))


def cluster_dense(blk, o, d, inv, *, iters: int, any_hit: bool = False,
                  copies: int = 1):
    """``cluster_dense_kernel``: blk [16, 3 * tc] (two cluster blocks the
    pops alternate between), rays [3, G, 128]; returns [copies, G, 128]:
    per lane, over ``iters`` pops, t_state = tmin * 0.999 + u * 1e-9 +
    v * 1e-9 where a pop's nearest valid slot tmin is below it (any-hit:
    tmin * 0.999, no u, v). ``inv`` is unused, as in the JAX probe. The
    kernel stages both blocks in shared memory (192 * tc bytes), so on
    the card a tc whose blocks do not fit a block's shared memory raises
    (above 1,152 on an H100)."""
    _positive(iters=iters, copies=copies)
    tc = blk.shape[1] // 3
    if tc < 1 or tc % LANES:
        raise ValueError(f"blk must be [16, 3 * tc], tc a multiple of "
                         f"{LANES}, got {tuple(blk.shape)}")
    g = _check_rays(blk, o, d, inv, 16, 3 * tc)
    if o.device.type == "cpu":
        return _copies(cluster_dense_plain(blk, o, d, inv, iters=iters,
                                           any_hit=any_hit), copies)
    out = torch.empty((copies, g, LANES), dtype=torch.float32,
                      device=o.device)
    with torch.cuda.device(o.device):
        _launch("roofline_cluster_dense", _library().gpt_roofline_cluster,
                blk.data_ptr(), o.data_ptr(), d.data_ptr(), inv.data_ptr(),
                tc, g, iters, int(any_hit), copies, out.data_ptr(),
                _stream(o.device))
    return out


def cluster_dense_plain(blk, o, d, inv, *, iters: int, any_hit: bool = False):
    """Plain version: [G, 128], through ops/kernel_cluster.py's cluster
    leaf (``_cluster_min``, the winner's u, v as ``cluster_uv`` recomputes
    them: the one-hot capture matmul of the JAX probe is exact, a gather of
    the winner's coefficients)."""
    tc = blk.shape[1] // 3
    shape = o.shape[1:]
    of = o.reshape(3, -1).t().contiguous()
    df = d.reshape(3, -1).t().contiguous()
    m = of.shape[0]
    t_state = torch.full((m,), 1e20, dtype=torch.float32, device=o.device)
    never = torch.full((m,), torch.inf, dtype=torch.float32, device=o.device)
    nano, keep = (torch.tensor(x, dtype=torch.float32, device=o.device)
                  for x in (1e-9, 0.999))
    for i in range(iters):
        start = (i % 2) * 8
        block = blk[start:start + 8]
        tmin, slot = kernel_cluster._cluster_min(
            block.expand(m, 8, 3 * tc), of, df, never, False)
        improved = tmin < t_state
        if any_hit:
            t_state = torch.where(improved, tmin * 0.999, t_state)
            continue
        win = slot + (start // 8) * tc
        u, v = kernel_cluster.cluster_uv(blk, win, of, df, tmin)
        # tmin * 0.999 + u * 1e-9 + v * 1e-9 as XLA contracts it.
        out = fma32(v, nano, fma32(tmin, keep, u * nano))
        t_state = torch.where(improved, out, t_state)
    return t_state.reshape(shape)
