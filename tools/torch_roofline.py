#!/usr/bin/env python3
"""Roofline probes of the PyTorch/CUDA port on one CUDA card (the
counterpart of tools/roofline.py).

    python3 tools/torch_roofline.py [--reps 5] [--quick] [--device cuda]

Measures the card's rates with the port's own kernels
(gpupathtracer_tpu_torch/ops/roofline.py, csrc/roofline.cu) instead of
spec-sheet numbers, and the compute floor of each phase of a tree walk
without the stack machinery:

  1. FP32 elementwise rate: ilp = 8 (and 1, the dependent-chain floor)
     chains of max((a * s + 0.25) * 0.9998, 0.125) on a [64, 128] (and
     [16, 128]) tile held in registers; JAX's unit, el-ops/s (4 a step),
     and beside it FP32 instructions/s (3 a step: FFMA, FMUL, FMNMX)
     against the card's issue rate, 67 TFLOP/s / 2 on an H100 SXM;
  2. matrix products: acc += dot(a + acc[:, :1] * 1e-30, b) at the JAX
     probe's shapes, f32 on the CUDA cores (fused multiply-adds on
     operands staged in shared memory once; the tensor cores have no
     full-f32 mode) and bf16 on the tensor cores (wgmma);
  3. device-memory bandwidth: 512 MB elementwise passes in plain torch,
     each pass one read and one write (torch runs every op as its own pass);
  4. traversal-phase floors: the node pop's slab test, the leaf pop's
     Moller-Trumbore test and the cluster pop's dense test iterated on
     their own; ns per pop of a G x 128 tile at the card's throughput, and
     per ray-pop (what chip_smoke.py's pop account divides by).

A TPU probe is one tile on one core. Every probe here runs ``copies`` of
its tile, enough for four blocks on every SM; the rates count every copy.

Protocol (tools/roofline.py's): each probe's iteration count is scaled
until one call takes >= 0.2 s, then the median of --reps calls is taken,
its spread printed. Calls are timed with CUDA events, so no dispatch floor
is subtracted; ``rtt_ms`` reports the host's launch-and-synchronize
latency instead. ``run_compact`` returns the keys of tools/roofline.py's
``run_compact`` (plus per-ray-pop times).

--device cpu runs the plain versions at a tiny size as a rehearsal: its
rates are host rates of torch's CPU ops and say nothing about a card.
Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

# NVIDIA's H100 SXM data sheet at 700 W: FP32 outside the tensor cores (an
# FMA counts as two operations, so instructions issue at half this rate),
# bf16 on the tensor cores (dense), HBM3.
SPEC_FP32_FLOPS = 67e12
SPEC_BF16_FLOPS = 989e12
SPEC_HBM_BYTES = 3.35e12
TARGET_S = [0.2]          # one timed call at least this long
BLOCKS_PER_SM = 4
# What run_compact launches (chip_smoke.py holds each case to its plain
# version): the FP32 chain's tile (ilp 8); the products as (key, M, K, N,
# dtype, log2 of the base iterations, label); the node, leaf and cluster
# floors' G; the cluster body's (tc, any_hit).
COMPACT_VPU = (64, 128)
COMPACT_MXU = (("mxu_128_f32_tflops_s", 128, 128, 128, "float32", 8, ""),
               ("mxu_128_bf16_tflops_s", 128, 128, 128, "bfloat16", 8, ""),
               ("mxu_512_bf16_tflops_s", 512, 512, 512, "bfloat16", 4, ""),
               ("mxu_cluster_shape_tflops_s", 384, 3, 128, "float32", 10,
                "(cluster per-g)"))
COMPACT_G = 16
COMPACT_CLUSTER = ((128, False), (256, False), (128, True))
# The products main() measures: (M, K, N, dtype, label).
MAIN_MXU = ((128, 128, 128, "float32", ""),
            (128, 128, 128, "bfloat16", ""),
            (512, 512, 512, "bfloat16", ""),
            (2048, 3, 384, "float32", "(ray K=3 shape)"),
            (2048, 128, 32, "float32", "(one-hot gather shape)"),
            (384, 3, 128, "float32", "(cluster per-g)"),
            (384, 3, 2048, "float32", "(cluster whole-packet)"),
            (768, 7, 1024, "float32", "(cluster merged K=7)"))

_OUT = [sys.stdout]  # run_compact(to_stderr=True) prints to stderr
_DEVICE = [None]


def _p(*args, **kw):
    print(*args, file=_OUT[0], **{k: v for k, v in kw.items()
                                  if k != "file"})


def _sync():
    import torch
    if _DEVICE[0].type == "cuda":
        torch.cuda.synchronize(_DEVICE[0])


def _call_s(fn) -> float:
    """Seconds of one fn() call: CUDA events on a card, else the host
    clock."""
    import torch
    if _DEVICE[0].type != "cuda":
        t0 = time.perf_counter()
        fn()
        return time.perf_counter() - t0
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(_DEVICE[0])
    return start.elapsed_time(end) / 1e3


def timed(fn, reps, label, work, unit="Top/s"):
    """Median seconds of fn() over reps calls after a warm-up; prints the
    achieved work/s. Returns (rate, seconds)."""
    fn()
    _sync()
    ts = [_call_s(fn) for _ in range(reps)]
    med = statistics.median(ts)
    spread = (max(ts) - min(ts)) / med if med > 0 else 0.0
    rate = work / max(med, 1e-12)
    _p(f"{label:52s} {med * 1e3:9.3f} ms  {rate / 1e12:8.3f} {unit} "
       f"(spread {spread:.0%})", flush=True)
    return rate, med


def timed_autoscale(build, base_iters, reps, label, work_per_iter,
                    unit="Top/s", max_iters=1 << 26):
    """timed() with the iteration count scaled until one call takes at
    least ``target`` seconds. build(iters) returns a zero-argument callable
    that launches the work. Returns (rate, seconds, iters)."""
    iters = max(int(base_iters), 1)
    target = TARGET_S[0]
    fn = build(iters)
    wall = 0.0
    for _ in range(8 if target > 0 else 0):  # no target: no scaling calls
        fn()
        wall = min(_call_s(fn) for _ in range(2))
        if wall >= target or iters >= max_iters:
            break
        scale = min(max(int(target / max(wall, 1e-6)) + 1, 2), 256)
        iters = min(iters * scale, max_iters)
        fn = build(iters)
    if wall < target:
        _p(f"  [autoscale: final call {wall * 1e3:.1f} ms < target "
           f"{target * 1e3:.0f} ms; treat {label!r} as noisy]", flush=True)
    rate, med = timed(fn, reps, label, work_per_iter * iters, unit=unit)
    return rate, med, iters


def copies_for(blocks_per_copy: int) -> int:
    """Copies of a tile that give every SM BLOCKS_PER_SM blocks (1 on the
    CPU)."""
    import torch
    if _DEVICE[0].type != "cuda":
        return 1
    sms = torch.cuda.get_device_properties(_DEVICE[0]).multi_processor_count
    return max(1, -(-BLOCKS_PER_SM * sms // blocks_per_copy))


def _rays(g: int):
    """The JAX probes' rays on a [3, G, 128] tile: o = 0.5, d = 0.577,
    inv = 1 / d."""
    import torch
    f = dict(dtype=torch.float32, device=_DEVICE[0])
    o = torch.full((3, g, 128), 0.5, **f)
    d = torch.full((3, g, 128), 0.577, **f)
    return o, d, 1.0 / d


# ---------------------------------------------------------------------------
# 1. FP32 elementwise rate
# ---------------------------------------------------------------------------

def run_vpu(reps, iters=4096, ilp=8, shape=(64, 128)):
    """Returns el-ops/s in JAX's unit (4 a chain step)."""
    import torch
    from gpupathtracer_tpu_torch.ops import roofline as rl

    x = torch.full(shape, 0.5, dtype=torch.float32, device=_DEVICE[0])
    copies = copies_for(shape[0] * shape[1] // rl.THREADS)

    def build(it):
        return lambda: rl.vpu(x, iters=it, ilp=ilp, copies=copies)

    lanes = shape[0] * shape[1] * copies
    rate, med, it = timed_autoscale(
        build, iters, reps, f"FP32 chain ilp={ilp} {shape} x{copies}",
        lanes * ilp * 4, unit="Tel-op/s")
    instr = lanes * ilp * rl.VPU_STEP * it / med
    _p(f"    -> {instr / 1e12:.3f} T FP32 instructions/s, "
       f"{instr / (SPEC_FP32_FLOPS / 2):.1%} of the issue rate", flush=True)
    return rate


# ---------------------------------------------------------------------------
# 2. matrix products
# ---------------------------------------------------------------------------

def run_mxu(reps, M, K, N, dtype, iters=512, label=""):
    """Returns FLOP/s (2 M K N an iteration, every copy)."""
    import torch
    from gpupathtracer_tpu_torch.ops import roofline as rl

    f = dict(dtype=dtype, device=_DEVICE[0])
    a = torch.full((M, K), 0.01, **f)
    b = torch.full((K, N), 0.01, **f)
    # Copies stay a function of the shape, four 64 x 64 output tiles a SM
    # (the f32 kernel's own blocks are larger): every version of the probe
    # measures the same work.
    tiles = -(-M // 64) * -(-N // 64)
    copies = copies_for(tiles)

    def build(it):
        return lambda: rl.mxu(a, b, iters=it, copies=copies)

    name = str(dtype).replace("torch.", "")
    rate, _, _ = timed_autoscale(
        build, iters, reps,
        f"dot [{M},{K}]x[{K},{N}] {name} {label} x{copies}",
        2 * M * K * N * copies, unit="TFLOP/s")
    peak = SPEC_BF16_FLOPS if dtype == torch.bfloat16 else SPEC_FP32_FLOPS
    _p(f"    -> {rate / peak:.1%} of the data sheet's "
       f"{peak / 1e12:.0f} TFLOP/s", flush=True)
    return rate


# ---------------------------------------------------------------------------
# 3. device-memory bandwidth (plain torch)
# ---------------------------------------------------------------------------

def run_hbm(reps, n_bytes=512 * 1024 * 1024, passes=8):
    """Returns bytes/s: each pass reads one 512 MB buffer and writes the
    other (torch materialises every op, so a pass is one read and one
    write)."""
    import torch

    n = n_bytes // 4
    bufs = [torch.ones(n, dtype=torch.float32, device=_DEVICE[0]),
            torch.empty(n, dtype=torch.float32, device=_DEVICE[0])]

    def build(p):
        def go():
            for i in range(p):
                torch.mul(bufs[i % 2], 1.0001, out=bufs[(i + 1) % 2])
        return go

    bw, _, p = timed_autoscale(build, passes, reps,
                               "memory sweeps (512 MB, read+write)",
                               2 * n_bytes, unit="TB/s")
    _p(f"    -> x{p} passes, {bw / 1e9:.1f} GB/s, {bw / SPEC_HBM_BYTES:.1%} "
       f"of the data sheet's {SPEC_HBM_BYTES / 1e12:.2f} TB/s", flush=True)
    return bw


# ---------------------------------------------------------------------------
# 4. traversal-phase floors
# ---------------------------------------------------------------------------

def _floor(reps, label, probe, iters, g, copies, el_ops):
    """One floor probe: returns (el-ops/s, s per tile pop, s per ray
    pop)."""
    rate, med, it = timed_autoscale(
        lambda i: (lambda: probe(i)), iters, reps, label,
        el_ops * g * 128 * copies)
    per_tile = med / it / copies
    return rate, per_tile, per_tile / (g * 128)


def run_phase_floors(reps, G=16, iters=8192):
    """The node and leaf pop bodies. Returns ((el-ops/s, s a tile pop,
    s a ray pop) of the node body, the same of the leaf body). El-ops are
    JAX's counts: 184 a lane for a node pop, 52 a triangle."""
    import numpy as np
    import torch
    from gpupathtracer_tpu_torch.ops import roofline as rl

    rows = torch.as_tensor(np.random.RandomState(0).uniform(
        0, 1, (64, 128)).astype(np.float32), device=_DEVICE[0])
    o, d, inv = _rays(G)
    copies = copies_for(G * 128 // rl.THREADS)
    node = _floor(reps, f"node slab body (G={G}) x{copies}",
                  lambda i: rl.node_slab(rows, o, d, inv, iters=i,
                                         copies=copies),
                  iters, G, copies, 184)
    _p(f"    -> {node[1] * 1e9:.2f} ns per node pop of a tile, "
       f"{node[2] * 1e12:.2f} ps per ray", flush=True)
    leaf = _floor(reps, f"leaf MT body (G={G}, 10 tris) x{copies}",
                  lambda i: rl.leaf_mt(rows, o, d, inv, iters=i,
                                       copies=copies),
                  iters, G, copies, 10 * 52)
    _p(f"    -> {leaf[1] * 1e9:.2f} ns per leaf pop of a tile, "
       f"{leaf[2] * 1e12:.2f} ps per ray", flush=True)
    return node, leaf


def run_cluster_floor(reps, G=16, tc=128, iters=2048, label="",
                      any_hit=False):
    """The cluster pop body at capacity tc. Returns (el-ops/s, s a tile
    pop, s a ray pop); JAX's count, 16 a (ray, triangle) pair."""
    import numpy as np
    import torch
    from gpupathtracer_tpu_torch.ops import roofline as rl

    blk = torch.as_tensor(np.random.RandomState(0).uniform(
        -1, 1, (16, 3 * tc)).astype(np.float32), device=_DEVICE[0])
    o, d, inv = _rays(G)
    copies = copies_for(G * 128 // rl.THREADS)
    mode = ", any-hit" if any_hit else ""
    out = _floor(reps, f"cluster dense body (G={G}, tc={tc}{mode}{label}) "
                       f"x{copies}",
                 lambda i: rl.cluster_dense(blk, o, d, inv, iters=i,
                                            any_hit=any_hit, copies=copies),
                 iters, G, copies, 16 * tc)
    _p(f"    -> {out[1] * 1e9:.1f} ns per cluster pop of a tile, "
       f"{out[2] * 1e12:.1f} ps per ray ({out[2] / tc * 1e12:.3f} ps a "
       f"pair)", flush=True)
    return out


def _rtt_ms() -> float:
    """Median host time of a one-element op and a synchronize."""
    import torch
    x = torch.ones(8, device=_DEVICE[0])
    ts = []
    for _ in range(10):
        t0 = time.perf_counter()
        (x + 1).sum()
        _sync()
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts) * 1e3


def set_device(device) -> None:
    import torch
    _DEVICE[0] = torch.device(device)
    if _DEVICE[0].type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("torch.cuda.is_available() is false; --device cpu "
                           "rehearses the plain versions")


def run_compact(reps=3, to_stderr=True, quick=False, device="cuda",
                strict=False):
    """The compact probe set of tools/roofline.py run_compact: a flat dict
    of measured rates under the same keys (and per-ray-pop times). A
    failing probe reads None and the rest go on, unless ``strict``, when
    it raises. ``quick`` sizes the probes for a CPU rehearsal."""
    import torch

    if to_stderr:
        _OUT[0] = sys.stderr
    set_device(device)
    TARGET_S[0] = 0.0 if quick else 0.2
    res = {"rtt_ms": round(_rtt_ms(), 3)}
    q = 8 if quick else 0
    rows_g = 2 if quick else COMPACT_G

    def row(key, scale, digits, fn, *a, **kw):
        try:
            res[key] = round(fn(*a, **kw) / scale, digits)
        except Exception as e:
            if strict:
                raise
            res[key] = None
            _p(f"PROBE FAILED {key}: {type(e).__name__}: {str(e)[:200]}",
               flush=True)

    row("vpu_ilp8_teops_s", 1e12, 3, run_vpu, reps, iters=1 << (12 - q),
        ilp=8, shape=COMPACT_VPU)
    for key, m, k, n, dtype, log_iters, label in COMPACT_MXU:
        square = m == k == n  # --quick cuts the others' iterations more
        row(key, 1e12, 2 if square else 3, run_mxu, reps, m, k, n,
            getattr(torch, dtype),
            iters=1 << (log_iters - (q // 2 if square else q)), label=label)
    if _DEVICE[0].type == "cuda":
        row("hbm_gb_s", 1e9, 1, run_hbm, reps)
    try:
        node, leaf = run_phase_floors(reps, G=rows_g, iters=1 << (12 - q))
        res["node_pop_body_ns"] = round(node[1] * 1e9, 3)
        res["node_body_vpu_teops_s"] = round(node[0] / 1e12, 3)
        res["leaf_pop_body_ns"] = round(leaf[1] * 1e9, 3)
        res["leaf_body_vpu_teops_s"] = round(leaf[0] / 1e12, 3)
        res["node_pop_ray_ps"] = round(node[2] * 1e12, 4)
        res["leaf_pop_ray_ps"] = round(leaf[2] * 1e12, 4)
    except Exception as e:
        if strict:
            raise
        _p(f"PROBE FAILED phase_floors: {type(e).__name__}: {str(e)[:200]}",
           flush=True)
    for tc, any_hit in COMPACT_CLUSTER:
        key = (f"cluster_anyhit_body_ns_tc{tc}" if any_hit
               else f"cluster_body_ns_tc{tc}")
        try:
            _, tile_s, ray_s = run_cluster_floor(
                reps, G=rows_g, tc=tc, iters=1 << max(9 - q, 1),
                any_hit=any_hit)
            res[key] = round(tile_s * 1e9, 2)
            res[key.replace("body_ns", "pop_ray_ps")] = round(ray_s * 1e12,
                                                              3)
        except Exception as e:
            if strict:
                raise
            _p(f"PROBE FAILED {key}: {type(e).__name__}: {str(e)[:200]}",
               flush=True)
    return res


def _safe(fn, *args, **kw):
    """One failing probe must not end the command line's run."""
    try:
        return fn(*args, **kw)
    except Exception as e:
        _p(f"PROBE FAILED {getattr(fn, '__name__', fn)}: "
           f"{type(e).__name__}: {str(e)[:200]}", flush=True)
        return None


def main(argv=None):
    import torch

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--quick", action="store_true",
                    help="small iteration counts (a wiring check)")
    args = ap.parse_args(argv)
    set_device(args.device)
    quick = args.quick or _DEVICE[0].type == "cpu"
    TARGET_S[0] = 0.0 if quick else 0.2
    if _DEVICE[0].type == "cuda":
        print("# " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    else:
        print("# cpu rehearsal: plain versions, host times, not a card's")
    print(f"# launch + synchronize {_rtt_ms():.3f} ms (host clock); probes "
          f"are timed with CUDA events, no floor subtracted", flush=True)
    reps = args.reps
    it = 16 if quick else 1 << 12
    mit = 2 if quick else 256
    g = 2 if quick else 16

    print("\n== 1. FP32 elementwise rate ==")
    _safe(run_vpu, reps, iters=it, ilp=8)
    _safe(run_vpu, reps, iters=it, ilp=1)
    _safe(run_vpu, reps, iters=it, ilp=8, shape=(16, 128))

    print("\n== 2. matrix products ==")
    for m, k, n, dtype, label in MAIN_MXU:
        _safe(run_mxu, reps, m, k, n, getattr(torch, dtype), iters=mit,
              label=label)

    if _DEVICE[0].type == "cuda":
        print("\n== 3. device-memory bandwidth ==")
        _safe(run_hbm, reps)

    print("\n== 4. traversal-phase floors ==")
    _safe(run_phase_floors, reps, G=g, iters=it)
    for tc in (128, 256):
        _safe(run_cluster_floor, reps, G=g, tc=tc, iters=max(it // 8, 2))
    _safe(run_cluster_floor, reps, G=g, tc=128, iters=max(it // 8, 2),
          any_hit=True)

    print("\nInterpretation: a walk's kernel time over its pops (the "
          "counters, with_stats) against these per-ray floors gives the "
          "share of its time that is compute it cannot avoid; the rest is "
          "latency, divergence and stack traffic.")


if __name__ == "__main__":
    main()
