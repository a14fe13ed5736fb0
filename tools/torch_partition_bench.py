#!/usr/bin/env python3
"""Routing statistics of the port's partitioned traversal (the counterpart
of tools/partition_bench.py): the scene's BVH split over --chips ranks
(bvh/partition.py), rays traced through the ring or the routed trace
(parallel/partition.py) in ranks of their own (parallel/launch.py).

    python3 tools/torch_partition_bench.py --scene proc:sponza --chips 4 \
        --routing ring --baseline
    python3 tools/torch_partition_bench.py --device cpu --scene proc:bunny \
        --n 4096 --chips 4 --routing routed

Populations (tools/partition_bench.py's):
  coherent    camera rays of the scene's view, pixel centres of a square grid
  deal        the same rays dealt to the ranks every D-th ray, in raster and
              in Morton order
  incoherent  random origins inside the scene's box, random directions
              (numpy RandomState(7): the JAX tool draws its own with jax)
  anyhit      the incoherent rays as occlusion queries, t_max 20

For each, the ring reports hops a ray V (rays routed into a rank's
subtree, summed, per ray), improved hits a ray, the ranks' load max/mean,
the barrier cost (the slowest rank's routed rays summed over hops, over
the balanced share) and B1's pops a ray; the routed trace its pops a ray,
rounds used, rays transported a ray and undelivered. Pops are each ray's
own walk (the TPU kernel counts a packet's shared stack, so the JAX tool's
pops are not these). --baseline adds the whole table's pops a ray
(B1 on one table, the same rays).

--hardware adds host-clock times of each trace (median of --reps after a
warm-up, the ranks meeting at a barrier before each) and the all-dead-rays
floor: a ring trace whose rays are all inactive routes and pops nothing,
so its time is the D - 1 rotations and the dispatch alone. With --device
cuda the backend follows the host: NCCL with rank r on cuda:r where it
has --chips GPUs or more, else gloo with every rank on cuda:0, the
collectives through the host (parallel/comm.py counts the bytes): on one
card that floor is gloo through the host, not NVLink. The tool prints
which ran.

--json PATH writes the numbers. Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import sys
import time

import numpy as np

TOOLS = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(TOOLS)
# The ranks import this module by name (bench_rank) from the path they
# are given, which is this process's.
for _p in (ROOT, TOOLS):
    if _p not in sys.path:
        sys.path.insert(0, _p)


def _rays(scene_name: str, n: int, chips: int, cfg):
    """(coherent o, d, incoherent o, d) as numpy, the coherent set trimmed
    to a multiple of the ranks."""
    import torch

    from gpupathtracer_tpu_torch.math.camera import (gen_rays,
                                                     generate_image_plane)
    side = int(math.isqrt(n))
    idx = np.arange(side * side)
    interp = np.stack([(idx % side) / side, (idx // side) / side],
                      1).astype(np.float32)
    cam = generate_image_plane(cfg.camera, "cpu")
    o_c, d_c = gen_rays(cam, torch.from_numpy(interp),
                        torch.full((side * side, 2), 0.5))
    nc = side * side // chips * chips
    return o_c.numpy()[:nc], d_c.numpy()[:nc], side


def _config(scene_name: str):
    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.scene.procedural import default_camera
    cfg = RenderConfig(scene_path=scene_name, skybox="GENERATE COLOR BLACK",
                       width=256, height=256, bvh_builder="cpp")
    if scene_name == "proc:sponza":
        cfg.camera = CameraConfig(position=(-18.0, 4.5, 0.0),
                                  yaw=math.pi / 2, pitch=-0.05,
                                  fov=math.radians(60), aspect=1.0)
    else:
        pos, yaw, pitch, fov, aperture, focus = default_camera(scene_name)
        cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                                  fov=math.radians(fov), aspect=1.0,
                                  aperture=aperture, focal_distance=focus)
    return cfg


def bench_rank(device, part, runs, opts):
    """In each rank: every population through trace_closest_partitioned
    with its counters, timed with --hardware; then the all-dead floor.
    Returns the counters, the times and the host staging."""
    import torch
    import torch.distributed as dist

    from gpupathtracer_tpu_torch.parallel import comm
    from gpupathtracer_tpu_torch.parallel.partition import (
        shard_partition, trace_closest_partitioned)
    table, route = shard_partition(part, None, device)
    kw = dict(stack_depth=opts["stack_depth"], leaf_size=opts["leaf_size"],
              routing=opts["routing"], max_rounds=opts["rounds"],
              bucket_cap=opts["bucket_cap"],
              packet_size=opts["packet_size"])

    def sync():
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        dist.barrier()

    out = {}
    for tag, o, d, tmax, any_hit in runs:
        o, d = (torch.as_tensor(a, device=device) for a in (o, d))
        m = o.shape[0]
        tm = torch.full((m,), tmax, device=device)
        act = torch.ones(m, dtype=torch.bool, device=device)

        def call():
            return trace_closest_partitioned(table, route, o, d, tm, act,
                                             any_hit=any_hit,
                                             with_stats=True, **kw)
        comm.reset_staged()
        _, stats = call()
        res = dict(stats=stats.cpu().numpy(), m=m,
                   staged=dict(comm.STAGED))
        if opts["hardware"]:
            res["ms"] = _timed(call, sync, opts["reps"])
        out[tag] = res
    if opts["hardware"]:
        m = max(opts["n"] // opts["chips"] * opts["chips"], opts["chips"])
        o = torch.zeros((m, 3), device=device)
        d = torch.zeros((m, 3), device=device)
        d[:, 0] = 1.0
        z = torch.zeros(m, device=device)
        off = torch.zeros(m, dtype=torch.bool, device=device)
        floor = dict(kw, routing="ring")
        out["floor_ms"] = _timed(lambda: trace_closest_partitioned(
            table, route, o, d, z, off, **floor), sync, opts["reps"])
    out["backend"] = comm.backend()
    return out


def _timed(call, sync, reps: int) -> list:
    call()
    times = []
    for _ in range(max(reps, 1)):
        sync()
        t0 = time.perf_counter()
        call()
        sync()
        times.append(1e3 * (time.perf_counter() - t0))
    return times


def _report_ring(tag, s, m):
    routed, improved, pops = s[:, 0, :], s[:, 1, :], s[:, 2, :]
    per_chip = routed.sum(1)
    v = routed.sum() / m
    imb = per_chip.max() / max(per_chip.mean(), 1e-9)
    barrier = routed.max(0).sum() / max(routed.sum() / routed.shape[0], 1e-9)
    pbar = pops.max(0).sum()
    pideal = pops.sum() / pops.shape[0]
    print(f"{tag}: hops/ray V = {v:.2f} of {routed.shape[1]}, improved/ray "
          f"= {improved.sum() / m:.2f}, chip load max/mean = {imb:.2f}, "
          f"barrier cost/ideal = {barrier:.2f}")
    print(f"   pops/ray = {pops.sum() / m:.2f}, pops/hop = "
          f"{pops.sum() / routed.shape[1]:.0f}, pops barrier/ideal = "
          f"{pbar / max(pideal, 1e-9):.2f}")
    print(f"   per-chip routed: {per_chip.tolist()}")
    print(f"   per-chip pops  : {pops.sum(1).tolist()}")
    print(f"   per-hop routed : {routed.sum(0).tolist()}")
    return dict(V=float(v), improved_per_ray=float(improved.sum() / m),
                load_max_over_mean=float(imb),
                pops_per_ray=float(pops.sum() / m),
                pops_per_hop=float(pops.sum() / routed.shape[1]))


def _report_routed(tag, s, m):
    pops, sent, dlvr, live = s[:, 0, :], s[:, 1, :], s[:, 2, :], s[:, 3, :]
    used = int(max(np.nonzero(pops.sum(0) + sent.sum(0))[0], default=0)) + 1
    pbar = pops.max(0).sum()
    pideal = pops.sum() / pops.shape[0]
    print(f"{tag}: pops/ray = {pops.sum() / m:.2f}, pops barrier/ideal = "
          f"{pbar / max(pideal, 1e-9):.2f}, rounds used = {used - 1} of "
          f"{pops.shape[1] - 1}, transported/ray = {sent.sum() / m:.2f}, "
          f"undelivered = {int(live[:, -1].sum())}")
    print(f"   per-chip pops  : {pops.sum(1).tolist()}")
    print(f"   per-round pops : {pops.sum(0).tolist()}")
    print(f"   per-round sent : {sent.sum(0).tolist()}")
    print(f"   per-round dlvr : {dlvr.sum(0).tolist()}")
    return dict(pops_per_ray=float(pops.sum() / m), rounds_used=used - 1,
                transported_per_ray=float(sent.sum() / m),
                pops_per_round=float(pops.sum() / max(used, 1)),
                undelivered=int(live[:, -1].sum()))


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", default="proc:sponza")
    ap.add_argument("--n", type=int, default=65536)
    ap.add_argument("--chips", type=int, default=4)
    ap.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    ap.add_argument("--grouping", default="spatial",
                    choices=["spatial", "spatial-area", "demand", "lpt"])
    ap.add_argument("--replicate-hot", type=int, default=6)
    ap.add_argument("--hot-demand", default="random",
                    choices=["random", "camera", "mixed", "pilot"])
    ap.add_argument("--routing", default="ring", choices=["ring", "routed"])
    ap.add_argument("--rounds", type=int, default=None)
    ap.add_argument("--bucket-cap", type=int, default=None)
    ap.add_argument("--packet-size", type=int, default=2048)
    ap.add_argument("--populations", default="all")
    ap.add_argument("--baseline", action="store_true")
    ap.add_argument("--hardware", action="store_true")
    ap.add_argument("--reps", type=int, default=3)
    ap.add_argument("--timeout", type=float, default=900.0)
    ap.add_argument("--json", default=None)
    args = ap.parse_args(argv)

    import torch

    import torch_partition_bench as me
    from gpupathtracer_tpu_torch.bvh.partition import (build_partition,
                                                       node_bucket_map,
                                                       partition_cut)
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops.traverse import count_entry_visits
    from gpupathtracer_tpu_torch.parallel.launch import run_ranks
    from gpupathtracer_tpu_torch.scene import load_scene
    from gpupathtracer_tpu_torch.utils.morton import ray_order

    D = args.chips
    cfg = _config(args.scene)
    scene, meta = load_scene(cfg, "cpu")
    rows = scene.node_rows.numpy()
    W = scene.child_bounds.shape[0]
    root_b = rows[0, 0:48].reshape(8, 6)
    valid = root_b[:, 0] <= root_b[:, 3]
    lo, hi = root_b[valid, 0:3].min(0), root_b[valid, 3:6].max(0)
    o_c, d_c, side = _rays(args.scene, args.n, D, cfg)
    nc = o_c.shape[0]
    rng = np.random.RandomState(7)
    o_i = rng.uniform(lo, hi, (args.n, 3)).astype(np.float32)
    d_i = rng.normal(size=(args.n, 3)).astype(np.float32)
    d_i /= np.linalg.norm(d_i, axis=1, keepdims=True)
    n_i = args.n // D * D
    o_i, d_i = o_i[:n_i], d_i[:n_i]

    demand_rays, hot_entries = None, None
    h = min(nc, n_i) // 2
    if args.hot_demand == "camera":
        demand_rays = (o_c, d_c)
    elif args.hot_demand == "mixed":
        demand_rays = (np.concatenate([o_c[:h], o_i[:h]]),
                       np.concatenate([d_c[:h], d_i[:h]]))
    elif args.hot_demand == "pilot" and args.replicate_hot > 0:
        cut, _ = partition_cut(rows, W, D)
        counts = count_entry_visits(
            scene, torch.from_numpy(np.concatenate([o_c[:h], o_i[:h]])),
            torch.from_numpy(np.concatenate([d_c[:h], d_i[:h]])),
            torch.full((2 * h,), 1e20), node_bucket_map(rows, W, cut),
            len(cut) + 1, stack_depth=meta.stack_depth,
            leaf_size=meta.leaf_size).numpy()[:len(cut)]
        hot_entries = np.argsort(-counts)[:args.replicate_hot]
        print(f"# pilot demand: top entries {hot_entries.tolist()}")
    part = build_partition(rows, W, D, grouping=args.grouping,
                           replicate_hot=args.replicate_hot,
                           demand_rays=demand_rays, hot_entries=hot_entries)
    print(f"# {args.scene}: whole table {rows.shape[0]} rows; live rows a "
          f"rank {part.num_rows.tolist()}; grouping={args.grouping}; "
          f"replicate_hot={args.replicate_hot}; routing={args.routing}")

    sel = (set(args.populations.split(",")) if args.populations != "all"
           else {"coherent", "deal", "incoherent", "anyhit"})
    runs = []
    if "coherent" in sel:
        runs.append(("coherent closest", o_c, d_c, 1e20, False))
    if "deal" in sel:
        deal = np.argsort(np.arange(nc) % D, kind="stable")
        runs.append(("coherent closest [deal]", o_c[deal], d_c[deal], 1e20,
                     False))
        mdeal = ray_order(side, side, "morton")[deal]
        runs.append(("coherent closest [morton-deal]", o_c[mdeal],
                      d_c[mdeal], 1e20, False))
    if "incoherent" in sel:
        runs.append(("incoherent closest", o_i, d_i, 1e20, False))
    if "anyhit" in sel:
        runs.append(("incoherent any-hit (tmax=20)", o_i, d_i, 20.0, True))

    backend, rank_device = "gloo", "cpu"
    if args.device == "cuda":
        # NCCL takes one GPU a rank; ranks that share a card take gloo.
        backend, rank_device = (("nccl", "cuda")
                                if torch.cuda.device_count() >= D
                                else ("gloo", "cuda:0"))
    opts = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
                routing=args.routing, rounds=args.rounds,
                bucket_cap=args.bucket_cap, packet_size=args.packet_size,
                hardware=args.hardware, reps=args.reps, n=args.n, chips=D)
    res = run_ranks(me.bench_rank, D, backend, rank_device,
                    args=(part, runs, opts), timeout_s=args.timeout)[0]
    print(f"# {D} ranks, backend {res['backend']} on {rank_device}")
    report = {"scene": args.scene, "chips": D, "routing": args.routing,
              "backend": res["backend"], "device": rank_device,
              "populations": {}}
    for tag, *_ in runs:
        r = res[tag]
        rep = (_report_routed if args.routing == "routed" else
               _report_ring)(tag, r["stats"], r["m"])
        rep["staged_bytes"] = r["staged"]["bytes"]
        if args.hardware:
            rep["ms"] = statistics.median(r["ms"])
            print(f"   host clock: {rep['ms']:.2f} ms a trace (median of "
                  f"{len(r['ms'])}: {[round(t, 2) for t in r['ms']]})")
        print(f"   staged through the host: {r['staged']['bytes']} bytes "
              f"({r['staged']['calls']} copies)")
        report["populations"][tag] = rep
    if args.hardware:
        fl = statistics.median(res["floor_ms"])
        hops = max(D - 1, 1)
        report["floor_ms"] = fl
        print(f"# all-dead floor: {fl:.2f} ms a trace, {fl / hops:.2f} ms a "
              f"rotation over {hops}; with gloo on one card the rotations "
              f"go through the host, not NVLink")
    if args.baseline:
        dev = torch.device("cuda" if args.device == "cuda" else "cpu")
        whole = scene.node_rows.to(dev)
        for tag, o, d, tmax, any_hit in runs:
            m = o.shape[0]
            fn = kt.anyhit if any_hit else kt.closest
            st = fn(whole, torch.from_numpy(o).to(dev),
                    torch.from_numpy(d).to(dev),
                    torch.full((m,), tmax, device=dev),
                    torch.ones(m, dtype=torch.bool, device=dev),
                    stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
                    with_stats=True)[-1]
            ppr = float(st.sum()) / m
            report["populations"][tag]["whole_pops_per_ray"] = ppr
            print(f"{tag} WHOLE TABLE: pops/ray = {ppr:.2f} ({m} rays, "
                  f"{rows.shape[0]} rows)")
    if args.json:
        with open(args.json, "w") as f:
            json.dump(report, f, indent=2)
    return report


if __name__ == "__main__":
    main()
