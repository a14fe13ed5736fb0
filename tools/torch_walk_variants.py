#!/usr/bin/env python3
"""Design variants of the port's walks, timed on the card against the
tree's own kernels (the experiments behind PERF.md section 6).

    python3 tools/torch_walk_variants.py [--variants a,b] [--reps 2]

Each variant is the tree's csrc/ with a few text edits (VARIANTS), built
with ops/cuda_build.py's nvcc flags into _build/variants/<name>/ and
swapped into the wrappers in turn. On chip_smoke.py phase 3's rays
(131,072 a scene, sponza 1920x1080 and bathroom 1280x720) it times B1
closest and any-hit at 64 and 128 threads a block and B4 closest and
any-hit on the scenes' cluster tables (tc 128); on bathroom 256x144, 64
bounces, 4 spp the MT and cluster megakernels. Every variant runs beside
the tree's build, in turns, and its outputs must be bitwise the tree's.
Prints the ptxas line of each kernel a variant changes. Needs the card
and nvcc; nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import os
import shutil
import subprocess
import sys
from concurrent.futures import ThreadPoolExecutor

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

_ORDER = """  if (ordered && total == 2) {
    order_two<kKeys>(hits, key, entry, skey);
  } else if (ordered && total > 2) {
    sort_children<kKeys>(key, slot, entry, skey);
  }
  if (ordered && total > 1) {"""
_WALK = """  int sp = 1;
  stack[0] = 0;  // root node row
  while (sp > 0) {
    const int entry = stack[--sp * stride];
    if (entry >= 0) {
      if constexpr (kStats) ++pops->node;
      expand_node(rows + (size_t)entry * kRow, r, t, !kAnyHit, stack, stride,
                  sp, depth);"""
_HELD_WALK = """  int sp = 0, next = 0;  // the root node row, held
  while (next != kInvalid || sp > 0) {
    const int entry = next != kInvalid ? next : stack[--sp * stride];
    next = kInvalid;
    if (entry >= 0) {
      if constexpr (kStats) ++pops->node;
      expand_node(rows + (size_t)entry * kRow, r, t, !kAnyHit, stack, stride,
                  sp, depth, nullptr, &next);"""

# name -> (what it changes, sources it rebuilds, {file: [(old, new)]}).
VARIANTS = {
    "unbounded": (
        "B1 without its register cap (kMinBlocks)", ("traverse",),
        {"traverse.cu": [("__launch_bounds__(kMaxThreads, kMinBlocks)",
                          "__launch_bounds__(kMaxThreads)")]}),
    "local-stack": (
        "B1's stack in a local array, not shared memory", ("traverse",),
        {"traverse.cu": [("extern __shared__ int stack[];",
                          "int stack[bvh::kMaxStack];"),
                         ("stack + threadIdx.x, blockDim.x", "stack, 1")]}),
    "network-only": (
        "every node with two or more entered children ordered by the "
        "network (no two-child compare)",
        ("traverse", "cluster_traverse", "megakernel"),
        {"bvh_walk.cuh": [(_ORDER, """  if (ordered && total > 1) {
    sort_children<kKeys>(key, slot, entry, skey);""")]}),
    "network-always": (
        "every ordered node through the network, one child or none too",
        ("traverse", "cluster_traverse", "megakernel"),
        {"bvh_walk.cuh": [(_ORDER, """  if (ordered) {
    sort_children<kKeys>(key, slot, entry, skey);""")]}),
    "held-child": (
        "the walk keeps the child it pops next in a register, unpushed",
        ("traverse", "megakernel"),
        {"bvh_walk.cuh": [
            ("""                                           float* keys = nullptr) {
  NodeRow n;""", """                                           float* keys = nullptr,
                                           int* next = nullptr) {
  NodeRow n;"""),
            ("""      if (k < total && pos < depth) {
        stack[pos * stride] = entry[k];""", """      if (k < total && pos < depth && next && k == 0) {
        *next = entry[k];
      } else if (k < total && pos < depth) {
        stack[pos * stride] = entry[k];"""),
            ("""      if (((hits >> j) & 1u) && pos < depth) {
        stack[pos * stride] = entry[j];""", """      if (((hits >> j) & 1u) && pos < depth && next &&
          pos == sp + total - 1) {
        *next = entry[j];
      } else if (((hits >> j) & 1u) && pos < depth) {
        stack[pos * stride] = entry[j];"""),
            ("""  sp = min(sp + total, depth);
  return dropped;""", """  sp = min(sp + total, depth) - (next && *next != kInvalid ? 1 : 0);
  return dropped;"""),
            (_WALK, _HELD_WALK)]}),
    "b4-four-blocks": (
        "B4 closest with 48 KB of idle shared memory a block (four blocks "
        "an SM)", ("cluster_traverse",),
        {"cluster_traverse.cu": [(
            """  kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      rows, cl, refs,""",
            """  kernel<<<blocks, kThreads, 48 * 1024, (cudaStream_t)stream>>>(
      rows, cl, refs,""")]}),
}
# The kernels whose ptxas lines a variant's build prints.
KERNELS = ("trace_closest_kernel<0>", "trace_anyhit_kernel<0>",
           "trace_cluster_closest_kernel<0, 0>",
           "trace_cluster_anyhit_kernel<0>",
           "mega_kernel<beckmann, nee=1, regen=1, cluster=0, stats=0>",
           "mega_kernel<beckmann, nee=1, regen=1, cluster=1, stats=0>")


def build_variant(name: str) -> dict:
    """nvcc builds of one variant: {source: library path}."""
    import chip_smoke
    from gpupathtracer_tpu_torch.ops import cuda_build

    _, sources, edits = VARIANTS[name]
    d = os.path.join(cuda_build.BUILD_DIR, "variants", name)
    shutil.rmtree(d, ignore_errors=True)
    shutil.copytree(cuda_build.CSRC, d)
    for f, reps in edits.items():
        path = os.path.join(d, f)
        text = open(path).read()
        for old, new in reps:
            if old not in text:
                raise RuntimeError(f"variant {name}: {f} has no {old!r}")
            text = text.replace(old, new)
        open(path, "w").write(text)
    libs = {}
    for s in sources:
        so = os.path.join(d, s + ".so")
        proc = subprocess.run([cuda_build._nvcc(), *cuda_build.NVCC_FLAGS,
                               "-o", so, os.path.join(d, s + ".cu")],
                              capture_output=True, text=True)
        if proc.returncode:
            raise RuntimeError(f"variant {name}: nvcc failed on {s}:\n"
                               f"{proc.stderr}")
        for line in chip_smoke._ptxas_summary(proc.stderr):
            if line.split(":")[0] in KERNELS:
                print(f"[{name}] ptxas {line}", flush=True)
        libs[s] = so
    return libs


class Swapped:
    """A wrapper module running a variant's library for the duration."""

    def __init__(self, module, so):
        self.module, self.so = module, so

    def __enter__(self):
        from gpupathtracer_tpu_torch.ops import cuda_build
        self.saved, build = self.module._lib, cuda_build.build
        cuda_build.build = lambda name: (self.so, "")
        try:
            self.module._lib = None
            self.module._library()
        finally:
            cuda_build.build = build

    def __exit__(self, *exc):
        self.module._lib = self.saved


def runs(libs: dict, source: str, module):
    """(label, context) for the tree's build and each variant that
    rebuilt ``source``."""
    import contextlib
    out = [("tree", contextlib.nullcontext())]
    for name, built in libs.items():
        if source in built:
            out.append((name, Swapped(module, built[source])))
    return out


def time_walks(libs: dict, reps: int, device) -> None:
    """B1 and B4 on phase 3's rays of sponza and bathroom."""
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.scene import load_scene

    for name, w, h in (("sponza", 1920, 1080), ("bathroom", 1280, 720)):
        cfg = cs._scene_cfg(name, w, h)
        scene, meta = load_scene(cfg, device)
        o, d, t_occ, on = cs._test_rays(scene, meta, cfg, device)
        far = torch.full((o.shape[0],), 1e20, device=device)
        rows = scene.node_rows
        kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
        ref = (kt.closest(rows, o, d, far, on, **kw),
               kt.anyhit(rows, o, d, t_occ, on, **kw))
        for rep in range(reps):
            for label, ctx in runs(libs, "traverse", kt):
                with ctx:
                    for th in (64, 128):
                        cs._hold_hits(f"{label} B1", kt.closest(
                            rows, o, d, far, on, threads=th, **kw), ref[0])
                        cs._hold_occluded(f"{label} B1", kt.anyhit(
                            rows, o, d, t_occ, on, threads=th, **kw), ref[1])
                        ms_c = cs._events_ms(lambda: kt.closest(
                            rows, o, d, far, on, threads=th, **kw), 20)
                        ms_a = cs._events_ms(lambda: kt.anyhit(
                            rows, o, d, t_occ, on, threads=th, **kw), 20)
                        print(f"[{name}] B1 {label}, {th} threads, rep {rep}:"
                              f" closest {ms_c:.4f} ms, any-hit {ms_a:.4f} ms",
                              flush=True)
        cfg = cs._scene_cfg(name, w, h, cluster_tris=128)
        cscene, cmeta = load_scene(cfg, device)
        tabs = (cscene.node_rows, cscene.cluster_rows)
        refs = cscene.cluster_refs
        kw = dict(stack_depth=cmeta.stack_depth)
        ref = (kc.closest_cluster(*tabs, refs, o, d, far, on, **kw),
               kc.anyhit_cluster(*tabs, o, d, t_occ, on, **kw))
        for rep in range(reps):
            for label, ctx in runs(libs, "cluster_traverse", kc):
                with ctx:
                    cs._hold_hits(f"{label} B4", kc.closest_cluster(
                        *tabs, refs, o, d, far, on, **kw), ref[0])
                    cs._hold_occluded(f"{label} B4", kc.anyhit_cluster(
                        *tabs, o, d, t_occ, on, **kw), ref[1])
                    ms_c = cs._events_ms(lambda: kc.closest_cluster(
                        *tabs, refs, o, d, far, on, **kw), 10)
                    ms_a = cs._events_ms(lambda: kc.anyhit_cluster(
                        *tabs, o, d, t_occ, on, **kw), 10)
                print(f"[{name}] B4 {label}, rep {rep}: closest {ms_c:.4f} "
                      f"ms, any-hit {ms_a:.4f} ms", flush=True)


def time_mega(libs: dict, reps: int, device) -> None:
    """The MT and cluster megakernels on bathroom 256x144, 64 bounces,
    4 spp (chip_smoke.py phase 8's regenerating case)."""
    import torch

    import chip_smoke as cs
    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.math.camera import generate_image_plane
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.scene import load_scene

    w, h = 256, 144
    for ct in (0, 128):
        cfg = cs._scene_cfg("bathroom", w, h, skybox="GENERATE COLOR BLACK",
                            microfacet="beckmann", cluster_tris=ct)
        scene, meta = load_scene(cfg, device)
        lane = torch.arange(w * h, device=device)
        args, kw = mk.prepare_mega(
            scene, mk.pack_mega_tables(scene),
            generate_image_plane(cfg.camera, device), (lane % w).float(),
            (lane // w).float(), random.PRNGKey(7, device), width=w,
            height=h, stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
            max_bounces=64, nee=True, model="beckmann",
            n_mats=meta.num_materials,
            n_lights=int(scene.light_rows.shape[0]),
            packet_size=cfg.pallas_packet_size, spp=4)
        ref = mk.trace_mega(*args, **kw)[0]
        leaf = "cluster" if ct else "MT"
        for rep in range(reps):
            for label, ctx in runs(libs, "megakernel", mk):
                with ctx:
                    got = mk.trace_mega(*args, **kw)[0]
                    torch.cuda.synchronize()
                    if not torch.equal(got.view(torch.int32),
                                       ref.view(torch.int32)):
                        raise AssertionError(f"{label}: megakernel lanes "
                                             f"differ from the tree's")
                    ms = cs._events_ms(lambda: mk.trace_mega(*args, **kw), 5)
                print(f"[bathroom 256x144] {leaf} megakernel {label}, rep "
                      f"{rep}: {ms:.3f} ms", flush=True)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--variants", default=",".join(VARIANTS),
                    help="comma-separated names of VARIANTS")
    ap.add_argument("--reps", type=int, default=2)
    args = ap.parse_args(argv)
    import torch

    if not torch.cuda.is_available():
        print("torch_walk_variants.py: needs a CUDA device", file=sys.stderr)
        return 1
    names = [v for v in args.variants.split(",") if v]
    for v in names:
        if v not in VARIANTS:
            raise SystemExit(f"unknown variant {v!r}; known: "
                             f"{', '.join(VARIANTS)}")
    from gpupathtracer_tpu_torch.ops import cuda_build
    device = torch.device("cuda", 0)
    with ThreadPoolExecutor(len(names) + 3) as pool:
        tree = pool.map(cuda_build.build,
                        ("traverse", "cluster_traverse", "megakernel"))
        built = dict(zip(names, pool.map(build_variant, names)))
        list(tree)
    for v in names:
        print(f"[{v}] {VARIANTS[v][0]}")
    time_walks(built, args.reps, device)
    time_mega(built, args.reps, device)
    return 0


if __name__ == "__main__":
    sys.exit(main())
