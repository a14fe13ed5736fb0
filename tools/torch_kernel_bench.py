#!/usr/bin/env python3
"""Traversal-kernel A/B harness of the PyTorch/CUDA port (the counterpart
of tools/kernel_bench.py for the kernels the port has).

    python3 tools/torch_kernel_bench.py --scene proc:sponza \
        --mode packet,tsort,subpacket --interleave 1,2

Run from the root of a checkout on a machine with one CUDA card. Every
variant traces the same two ray sets and is timed with CUDA events over
--reps runs after a warm-up; compare variants only within one run (one
card, one power limit: both are printed).

Ray sets (tools/kernel_bench.py's):
  coherent    Morton-tiled camera primaries on the scene's default view.
  incoherent  random-direction rays from the primaries' hit points,
              randomly permuted (the diffuse-bounce worst case).

Modes:
  packet      the per-ray walk (csrc/traverse.cu); --interleave W carries W
              rays a thread, --multi-pop Q pops Q entries an iteration
  subpacket   128-ray sub-packets on shared stacks, --k rays a packet
  tsort, tsort2, tsort3   treelet-sorted rays (key top1, top2, deep) through
              the per-ray walk; the time includes the sort and the gathers
  tsort-sub   treelet-sorted rays (top1) through the sub-packet kernel
  dense       every ray against every triangle, rounding of the matrix
              form (--k rays a block, at most 1024; small scenes only)
  dense-vpu   the same with the multiply chain's rounding
  treelet     not a mode here: raises (its t can differ from the per-ray
              walk's at triangles whose t rounds below their box's entry,
              so it cannot be held bitwise to it; chip_smoke.py phase T
              times it)

--arity A builds the scene's tables A children wide (2 to 16; the kernels
are built at that arity, tools/kernel_bench.py's --arity); the sub-packet
modes (subpacket, tsort-sub) read 8-wide rows only and refuse another.

--cluster-tc TC adds, for each TC of a comma-separated list, the cluster
leaf walk (csrc/cluster_traverse.cu) on the scene cut into clusters of TC
triangles, and --pop-skip (closest) a variant of it that skips cluster
pops whose entry distance is not below the ray's t: tools/cluster_pops.py's
A/B, on the card.

--stats prints each variant's pop counters (the kernels' with_stats) after
its time: pops per ray, node and leaf (cluster), p50 and mean, their sums
per --k-ray packet (the TPU kernels count the pops of a packet's shared
stack; these sums are of per-ray walks, what each ray costs alone) and ns
per pop (the variant's time over all its pops); skipped pops under
--pop-skip, dropped pushes under --multi-pop. The sub-packet mode counts
the pops of its 128-ray shared stacks. Only the per-ray walks (packet, W,
Q, cluster) and the sub-packet mode count.

--check N also holds every variant's result on the first N rays of each set
against the plain PyTorch version of its kernel on the same rays (the
per-ray walk's plain version for the tree modes, the dense intersection's in
the variant's rounding for the dense modes), bitwise, and raises if any lane
differs. The plain versions are slow: keep N in the thousands.

--device cpu runs the plain versions at a small --n as a rehearsal; its
times are host times of torch's CPU ops and say nothing about the card.
Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import math
import os
import statistics
import subprocess
import sys
import time

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

TSORT_KEYS = {"tsort": "top1", "tsort2": "top2", "tsort3": "deep",
              "tsort-sub": "top1"}
MODES = ("packet", "subpacket", "dense", "dense-vpu") + tuple(TSORT_KEYS)
MAX_DENSE_BLOCK = 1024


def mode_of(key: str) -> str:
    """The mode of a variant key "mode@..."."""
    return key.split("@")[0]


def time_ms(fn, reps: int, device):
    """(median, spread) of fn()'s milliseconds over reps runs after one
    warm-up: CUDA events on a card, the host clock on the CPU."""
    import torch

    fn()
    times = []
    for _ in range(reps):
        if device.type == "cuda":
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            fn()
            end.record()
            torch.cuda.synchronize(device)
            times.append(start.elapsed_time(end))
        else:
            t0 = time.perf_counter()
            fn()
            times.append(1e3 * (time.perf_counter() - t0))
    med = statistics.median(times)
    return med, (max(times) - min(times)) / med if med > 0 else 0.0


def load(scene_path: str, device, cluster_tris: int = 0, arity: int = 8):
    """(scene, meta) of a scene at its default settings (C++ SBVH where a
    compiler is present), ``arity`` children a node, cut into clusters of
    ``cluster_tris`` triangles when that is not 0."""
    from gpupathtracer_tpu_torch.config import RenderConfig
    from gpupathtracer_tpu_torch.scene import load_scene

    return load_scene(RenderConfig(scene_path=scene_path, width=64,
                                   height=64, skybox="GENERATE COLOR BLACK",
                                   cluster_tris=cluster_tris,
                                   wide_arity=arity), device)


def make_rays(scene_path: str, scene, meta, n: int, device):
    """The two ray sets, each (o, d) [n, 3]: "coherent" and "incoherent"
    (module docstring)."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.config import CameraConfig
    from gpupathtracer_tpu_torch.math.camera import (gen_rays,
                                                     generate_image_plane)
    from gpupathtracer_tpu_torch.ops.traverse import trace_closest
    from gpupathtracer_tpu_torch.scene.procedural import default_camera
    from gpupathtracer_tpu_torch.utils.morton import ray_order

    # Morton-tiled primaries at a resolution that covers n rays.
    w = 1 << math.ceil(math.log2(math.sqrt(n * 16 / 9)))
    h = max(-(-n // w), 1)
    pos, yaw, pitch, fov, _, _ = default_camera(scene_path)
    cam = generate_image_plane(
        CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                     fov=math.radians(fov), aspect=w / h), device)
    order = ray_order(w, h, "morton")[:n]
    interp = np.stack([(order % w).astype(np.float32) / w,
                       (order // w).astype(np.float32) / h], axis=-1)
    o_coh, d_coh = gen_rays(cam, torch.as_tensor(interp, device=device),
                            torch.full((n, 2), 0.5, device=device))
    o_coh, d_coh = o_coh.contiguous(), d_coh.contiguous()
    hit = trace_closest(scene, o_coh, d_coh,
                        torch.full((n,), 1e20, device=device),
                        torch.ones(n, dtype=torch.bool, device=device),
                        stack_depth=meta.stack_depth,
                        leaf_size=meta.leaf_size)
    hitp = torch.where((hit.prim >= 0)[:, None],
                       o_coh + d_coh * (hit.t[:, None] * 0.999), o_coh)
    rng = np.random.RandomState(11)
    dirs = rng.normal(size=(n, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    perm = torch.as_tensor(rng.permutation(n), device=device)
    return {"coherent": (o_coh, d_coh),
            "incoherent": (hitp[perm].contiguous(),
                           torch.as_tensor(dirs, device=device))}


def make_run(mode: str, scene, meta, *, any_hit: bool = False,
             multi_pop: int = 1, pop_skip: bool = False):
    """run(o, d, K, ilv, stats=False) -> a tensor of the variant's results
    (t, or occluded with any_hit) for rays o, d [n, 3], all active, t_max
    1e20; with ``stats`` its pop counters instead (per ray for the per-ray
    walks, per packet for the sub-packet mode, None where a mode has
    none). Mode "cluster" is the per-ray walk of a cluster scene, with
    ``pop_skip`` its skipping schedule."""
    import torch

    from gpupathtracer_tpu_torch.ops import (dense_intersect, kernel_cluster,
                                             kernel_traverse,
                                             subpacket_traverse, tsort)

    if mode == "treelet":
        raise NotImplementedError(
            "mode 'treelet': not a mode of the A/B tool (module docstring); "
            "chip_smoke.py phase T times the treelet traversal")
    if mode not in MODES + ("cluster",):
        raise ValueError(f"mode must be one of {MODES}, got {mode!r}")
    if mode in ("subpacket", "tsort-sub") and scene.arity != 8:
        raise SystemExit(f"mode {mode!r}: the sub-packet kernel reads 8-wide "
                         f"rows only (--arity {scene.arity})")
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    if (mode == "cluster") != (scene.cluster_rows is not None):
        raise ValueError("mode 'cluster' runs on a cluster scene and only "
                         "there (--cluster-tc)")
    rows = scene.node_rows

    def full(o):
        n = o.shape[0]
        return (torch.full((n,), 1e20, device=o.device),
                torch.ones(n, dtype=torch.bool, device=o.device))

    if mode in ("dense", "dense-vpu"):
        wd, wo = (torch.as_tensor(x, device=rows.device)
                  for x in dense_intersect.pack_dense_tris(
                      scene.tri_geom.cpu().numpy()))

        def run(o, d, K, ilv=1, stats=False):
            if stats:
                return None
            out = dense_intersect.dense_intersect(
                wd, wo, o, d, *full(o), any_hit=any_hit,
                use_mxu=(mode == "dense"), block=min(K, MAX_DENSE_BLOCK))
            return out[1] >= 0 if any_hit else out[0]
    elif mode in TSORT_KEYS:
        inner = "subpacket" if mode == "tsort-sub" else "packet"
        fn = tsort.trace_occluded_tsort if any_hit else \
            tsort.trace_closest_tsort

        def run(o, d, K, ilv=1, stats=False):
            if stats:
                return None
            out = fn(scene, o, d, *full(o), packet_size=K, interleave=ilv,
                     kernel=inner, key_mode=TSORT_KEYS[mode], **kw)
            return out if any_hit else out.t
    elif mode == "subpacket":
        def run(o, d, K, ilv=1, stats=False):
            P = o.shape[0] // K
            tm, act = full(o)
            out = subpacket_traverse.traverse_subpacket(
                rows, o.reshape(P, K, 3), d.reshape(P, K, 3),
                tm.reshape(P, K), act.reshape(P, K), any_hit=any_hit,
                with_stats=stats, **kw)
            if stats:
                return out[4]
            return (out[1] >= 0 if any_hit else out[0]).reshape(-1)
    elif mode == "cluster":
        tabs = (rows, scene.cluster_rows)
        sd = dict(stack_depth=meta.stack_depth, arity=scene.arity)

        def run(o, d, K, ilv=1, stats=False):
            if any_hit:
                out = kernel_cluster.anyhit_cluster(*tabs, o, d, *full(o),
                                                    with_stats=stats, **sd)
                return out[1] if stats else out
            out = kernel_cluster.closest_cluster(
                *tabs, scene.cluster_refs, o, d, *full(o), with_stats=stats,
                pop_skip=pop_skip, **sd)
            return out[4] if stats else out[0]
    else:
        fn = kernel_traverse.anyhit if any_hit else kernel_traverse.closest

        def run(o, d, K, ilv=1, stats=False):
            out = fn(rows, o, d, *full(o), interleave=ilv,
                     multi_pop=multi_pop if ilv == 1 else 1,
                     with_stats=stats, arity=scene.arity, **kw)
            if stats:
                return out[-1]
            return out if any_hit else out[0]
    return run


def make_plain(mode: str, scene, meta, *, any_hit: bool = False):
    """plain(o, d) -> what make_run's variants of ``mode`` must return on
    rays o, d, from the kernel's plain version: t (occluded with any_hit).
    Every tree mode is a schedule of the per-ray walk, whose t and occlusion
    do not depend on the schedule; "cluster" (on a cluster scene) is the
    cluster walk's, with or without pop_skip."""
    import torch

    from gpupathtracer_tpu_torch.ops import (dense_intersect, kernel_cluster,
                                             kernel_traverse)

    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              arity=scene.arity)
    rows = scene.node_rows

    def full(o):
        n = o.shape[0]
        return (torch.full((n,), 1e20, device=o.device),
                torch.ones(n, dtype=torch.bool, device=o.device))

    if mode == "cluster":
        tabs = (rows, scene.cluster_rows)
        sd = dict(stack_depth=meta.stack_depth, arity=scene.arity)

        def plain(o, d):
            if any_hit:
                return kernel_cluster.anyhit_cluster_plain(*tabs, o, d,
                                                           *full(o), **sd)
            return kernel_cluster.closest_cluster_plain(
                *tabs, scene.cluster_refs, o, d, *full(o), **sd)[0]
    elif mode in ("dense", "dense-vpu"):
        wd, wo = (torch.as_tensor(x, device=rows.device)
                  for x in dense_intersect.pack_dense_tris(
                      scene.tri_geom.cpu().numpy()))

        def plain(o, d):
            out = dense_intersect.dense_intersect_plain(
                wd, wo, o, d, *full(o), any_hit=any_hit,
                use_mxu=(mode == "dense"),
                block=math.gcd(o.shape[0], MAX_DENSE_BLOCK))
            return out[1] >= 0 if any_hit else out[0]
    elif any_hit:
        def plain(o, d):
            return kernel_traverse.anyhit_plain(rows, o, d, *full(o), **kw)
    else:
        def plain(o, d):
            return kernel_traverse.closest_plain(rows, o, d, *full(o),
                                                 **kw)[0]
    return plain


def main(argv=None, loaded=None) -> dict:
    """Runs the sweep the arguments name and prints a line per variant and
    ray set. ``loaded``, a (scene, meta) of --scene already on --device,
    saves the ingest. Returns {variant: {"ms", "mrays_per_s", "equal",
    "plain_equal"}} (plain_equal None without --check)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="proc:sponza")
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--n", type=int, default=1 << 19, help="rays per set")
    ap.add_argument("--k", default="2048",
                    help="rays per packet (subpacket, tsort-sub; a multiple "
                         "of 128) or per block (dense, at most "
                         f"{MAX_DENSE_BLOCK}); comma-separated list to sweep")
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--sets", default="coherent,incoherent")
    ap.add_argument("--any-hit", action="store_true")
    ap.add_argument("--mode", default="packet",
                    help="comma-separated sweep over: " + ", ".join(MODES))
    ap.add_argument("--multi-pop", type=int, default=1,
                    help="packet mode: a further variant that pops this "
                         "many entries an iteration (2 or 4)")
    ap.add_argument("--interleave", default="1",
                    help="packet and tsort modes: rays a thread (1, 2 or 4); "
                         "comma-separated list to sweep")
    ap.add_argument("--check", type=int, default=0,
                    help="hold every variant on the first N rays of each "
                         "set against its kernel's plain version")
    ap.add_argument("--stats", action="store_true",
                    help="print each variant's pop counters (module "
                         "docstring)")
    ap.add_argument("--cluster-tc", default="",
                    help="comma-separated cluster sizes: the cluster walk "
                         "on the scene cut into clusters of that many "
                         "triangles")
    ap.add_argument("--pop-skip", action="store_true",
                    help="with --cluster-tc, closest: also the pop-skipping "
                         "schedule")
    ap.add_argument("--arity", type=int, default=8,
                    help="children per node of the scene's tables (2-16)")
    args = ap.parse_args(argv)

    import torch

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false; "
                               "--device cpu rehearses the plain versions")
        print("# " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    else:
        print("# cpu rehearsal: plain versions, host times, not the card's")
    modes = args.mode.split(",")
    k_list = [int(s) for s in args.k.split(",")]
    ilv_list = [int(s) for s in args.interleave.split(",")]
    scene, meta = loaded or load(args.scene, device, arity=args.arity)
    if scene.arity != args.arity:
        raise ValueError(f"the loaded scene is {scene.arity}-wide, "
                         f"--arity {args.arity}")
    rows = scene.node_rows
    print(f"# {args.scene} arity={scene.arity} leaf={meta.leaf_size}: "
          f"rows={tuple(rows.shape)} "
          f"({rows.numel() * 4 / 1e6:.1f} MB) stack={meta.stack_depth} "
          f"K={k_list} N={args.n}")
    runs = {m: make_run(m, scene, meta, any_hit=args.any_hit) for m in modes}
    rays = make_rays(args.scene, scene, meta, args.n, device)
    plain_of = {m: (scene, meta) for m in modes}

    # (tag, key, run, K, ilv)
    variants = []
    for mode in modes:
        uses_k = mode in ("subpacket", "tsort-sub", "dense", "dense-vpu")
        uses_ilv = mode == "packet" or (mode in TSORT_KEYS
                                        and mode != "tsort-sub")
        for K in (k_list if uses_k else k_list[:1]):
            for ilv in (ilv_list if uses_ilv else [1]):
                tag = mode + (f" K={K}" if uses_k else "") \
                    + (f" W={ilv}" if uses_ilv and len(ilv_list) > 1 else "")
                variants.append((tag, f"{mode}@{K}w{ilv}", runs[mode], K,
                                 ilv))
        if mode == "packet" and args.multi_pop > 1:
            variants.append((f"packet Q={args.multi_pop}",
                             f"packet@q{args.multi_pop}",
                             make_run("packet", scene, meta,
                                      any_hit=args.any_hit,
                                      multi_pop=args.multi_pop), k_list[0], 1))
    for tc in (int(x) for x in args.cluster_tc.split(",") if x):
        cscene, cmeta = load(args.scene, device, cluster_tris=tc,
                             arity=args.arity)
        skips = (False, True) if args.pop_skip and not args.any_hit else \
            (False,)
        for skip in skips:
            mode = f"cluster{tc}" + ("s" if skip else "")
            plain_of[mode] = (cscene, cmeta)
            variants.append((f"cluster tc={tc}" + (" pop_skip" if skip
                                                   else ""),
                             f"{mode}@{k_list[0]}w1",
                             make_run("cluster", cscene, cmeta,
                                      any_hit=args.any_hit, pop_skip=skip),
                             k_list[0], 1))

    out, first, wanted = {}, {}, {}
    for tag, key, run, K, ilv in variants:
        # Every variant of a family computes the same hits: the tree walks'
        # schedules, a cluster size's walks; the dense test rounds otherwise.
        mode = mode_of(key)
        family = (mode if "dense" in key
                  else mode.rstrip("s") if mode.startswith("cluster")
                  else "tree")
        for name in args.sets.split(","):
            o, d = rays[name]
            res = run(o, d, K, ilv)
            # The share of lanes bitwise equal to the family's first
            # variant's.
            ref = first.setdefault((family if family.startswith("cluster")
                                    else "tree", name), res)
            if res.dtype != torch.bool:
                res, ref = res.view(torch.int32), ref.view(torch.int32)
            same = float((res == ref).float().mean())
            held = None
            if args.check:
                if (family, name) not in wanted:
                    plain = make_plain("cluster" if family.startswith(
                        "cluster") else mode, *plain_of[mode],
                        any_hit=args.any_hit)
                    want = plain(o[:args.check], d[:args.check])
                    if want.dtype != torch.bool:
                        want = want.view(torch.int32)
                    wanted[family, name] = want
                want = wanted[family, name]
                held = float((res[:args.check] == want).float().mean())
                if held != 1.0:
                    raise AssertionError(
                        f"{tag} {name}: {int((res[:args.check] != want).sum())}"
                        f" of {want.shape[0]} lanes differ from the plain "
                        f"version")
            med, spread = time_ms(lambda: run(o, d, K, ilv), args.reps,
                                  device)
            mrays = args.n / med / 1e3
            entry = {"ms": med, "mrays_per_s": mrays, "equal": same,
                     "plain_equal": held}
            suffix = ""
            if args.stats:
                st = run(o, d, K, ilv, stats=True)
                if st is not None:
                    entry["pops"], suffix = pop_summary(st, med, K, mode)
            print(f"{tag} {name}: {mrays:.2f} Mrays/s ({med:.3f} ms, spread "
                  f"{spread:.1%}; {same:.4%} of lanes equal to the first "
                  f"variant's"
                  + (f"; first {args.check} bitwise equal to the plain "
                     f"version" if args.check else "") + ")" + suffix,
                  flush=True)
            out[f"{key}:{name}"] = entry
    return out


def pop_summary(st, ms: float, K: int, mode: str):
    """({"node", "leaf", "skip", "dropped", "ns_per_pop"}, the line's
    suffix) of a variant's pop counters ``st``: [N, 2 or 3] per ray, or
    [P, 2] per sub-packet stack for the sub-packet mode. Means are per ray
    (per packet for the sub-packet mode)."""
    import torch

    st = st.to(torch.int64).cpu()
    node, leaf = st[:, 0].double(), st[:, 1].double()
    total = int(node.sum() + leaf.sum())
    ns = ms * 1e6 / max(total, 1)
    pops = {"node": float(node.mean()), "leaf": float(leaf.mean()),
            "ns_per_pop": ns}
    leaf_name = "cluster" if mode.startswith("cluster") else "leaf"
    if mode == "subpacket":
        line = (f" | pops per packet (its 128-ray stacks): node p50="
                f"{float(node.median()):.0f} mean={float(node.mean()):.1f}, "
                f"leaf p50={float(leaf.median()):.0f} "
                f"mean={float(leaf.mean()):.1f}; ns/pop={ns:.3f}")
        return pops, line
    n = st.shape[0]
    per_k = st[:n - n % K].reshape(-1, K, st.shape[1]).sum(dim=1).double()
    line = (f" | pops per ray: node p50={float(node.median()):.0f} "
            f"mean={float(node.mean()):.2f}, {leaf_name} "
            f"p50={float(leaf.median()):.0f} mean={float(leaf.mean()):.2f}; "
            f"per {K}-ray packet, sums of per-ray walks (not a shared "
            f"stack's pops): node p50={float(per_k[:, 0].median()):.0f}, "
            f"{leaf_name} p50={float(per_k[:, 1].median()):.0f}; "
            f"ns/pop={ns:.4f}")
    if st.shape[1] > 2:
        extra = int(st[:, 2].sum())
        key = "skip" if mode.startswith("cluster") else "dropped"
        pops[key] = float(st[:, 2].double().mean())
        if key == "skip":
            line += (f"; skipped per ray mean={pops['skip']:.2f} "
                     f"({extra} in all)")
        elif extra:
            line += f"; STACK OVERFLOWS={extra}"
    return pops, line


if __name__ == "__main__":
    main()
