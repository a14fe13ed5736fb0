"""Command-line renderer (counterpart of the JAX package's cli.py; role of
src/Program.cpp + scene.txt): load a scene, render progressively, save a
tonemapped PNG, report seconds per frame and Mrays/s.

Usage:
  python -m gpupathtracer_tpu_torch.cli proc:cornell --spp 16 --out c.png
  python -m gpupathtracer_tpu_torch.cli scene.txt --spp 64 --device cuda
  python -m gpupathtracer_tpu_torch.cli proc:sponza --spp 8 --checkpoint s.ck
  python -m gpupathtracer_tpu_torch.cli proc:sponza --spp 8 --resume s.ck
  python -m gpupathtracer_tpu_torch.cli proc:table --interactive

The flags are the JAX CLI's, plus --device (default cuda; the CLI raises if
that device is absent, and never falls back), --wide-arity (children per
BVH node, 2 to 16: cfg.wide_arity, which the JAX CLI leaves at 8) and
--cache-dir (cfg.cache_dir). The scene disk cache (scene/cache.py) is on
unless --no-cache is given, as in the JAX CLI. --platform (JAX platforms)
raises: use --device.

Multi-device: run one process a device under torchrun, e.g.

  torchrun --standalone --nproc-per-node 4 -m gpupathtracer_tpu_torch.cli \
      proc:sponza --partition-chips 4 --spp 8 --out s.png

With WORLD_SIZE > 1 the CLI joins the default process group: NCCL with
rank r on cuda:LOCAL_RANK for --device cuda (it raises when the host has
fewer GPUs than local ranks), gloo for --device cpu. Every rank renders
its share; rank 0 writes the PNG, the checkpoint, --hdr-out and
--stats-json. The interactive viewer and its bench run in one process.
"""

from __future__ import annotations

import argparse
import dataclasses
import io
import json
import math
import os
import sys
import time


def build_config(args):
    from gpupathtracer_tpu_torch.config import (CameraConfig, RenderConfig,
                                                load_scene_txt)

    if args.scene.endswith(".txt"):
        cfg = load_scene_txt(args.scene, args.width, args.height)
    else:
        cfg = RenderConfig(scene_path=args.scene, skybox=args.skybox,
                           width=args.width, height=args.height)
        cfg.camera = CameraConfig(aspect=args.width / args.height)
    if args.scene.startswith("proc:") and not args.position:
        # Procedural scenes ship a framing (overridable with flags).
        from gpupathtracer_tpu_torch.scene.procedural import default_camera
        dc = default_camera(args.scene)
        if dc:
            pos, yaw, pitch, fov, aperture, focus = dc
            cfg.camera.position = pos
            cfg.camera.yaw, cfg.camera.pitch = yaw, pitch
            args.fov = fov if args.fov == 45.0 else args.fov
            args.aperture = aperture if args.aperture == 0.0 else args.aperture
            args.focus = focus if args.focus == 90.0 else args.focus
    if args.position:
        cfg.camera.position = tuple(float(x) for x in args.position.split(","))
    if args.rotation:
        rot = [float(x) for x in args.rotation.split(",")]
        cfg.camera.yaw = rot[0]
        cfg.camera.pitch = rot[1] if len(rot) > 1 else 0.0
    cfg.camera.fov = math.radians(args.fov)
    cfg.camera.focal_distance = args.focus
    cfg.camera.aperture = args.aperture
    cfg.integrator = args.integrator
    cfg.microfacet = args.microfacet
    cfg.max_bounces = args.max_bounces
    cfg.nee_enabled = not args.no_nee
    cfg.seed = args.seed
    cfg.exposure = args.exposure
    cfg.tonemap = "none" if args.no_tonemap else "uncharted2"
    cfg.cache_enabled = not args.no_cache
    cfg.cache_dir = args.cache_dir
    cfg.bvh_builder = args.bvh_builder
    cfg.sampler = args.sampler
    cfg.frame_batch = args.frame_batch
    cfg.megakernel = args.megakernel
    cfg.mega_fused_nee = args.mega_fused_nee
    cfg.shadow_rev = args.shadow_rev
    cfg.bounce_traversal = args.bounce_traversal
    cfg.mip_levels = args.mip_levels
    cfg.cluster_tris = args.cluster_tris
    cfg.wide_arity = args.wide_arity
    cfg.partition_chips = args.partition_chips
    cfg.partition_samples = args.partition_samples
    cfg.partition_routing = args.partition_routing
    if args.chunk:
        cfg.ray_chunk = args.chunk
    return cfg


# Flags of the JAX CLI whose features the port does not have:
# (attribute, value that is fine, what to say).
_UNPORTED = (
    ("platform", (None,), "JAX platforms (use --device)"),
)


def parse_args(argv=None):
    """The CLI's arguments; flags of unported features exit with an
    error."""
    p = argparse.ArgumentParser(
        prog="gpupathtracer_tpu_torch",
        description="Progressive path tracer on PyTorch and CUDA")
    p.add_argument("scene", help="scene.txt, .obj, .gltf/.glb, or proc:<name>")
    p.add_argument("--device", default="cuda",
                   help="torch device to render on (default cuda)")
    p.add_argument("--spp", type=int, default=16, help="samples per pixel")
    p.add_argument("--out", default=None, help="output PNG path")
    p.add_argument("--width", type=int, default=1280)
    p.add_argument("--height", type=int, default=720)
    p.add_argument("--skybox", default="GENERATE COLOR WHITE")
    p.add_argument("--position", default=None, help="camera x,y,z")
    p.add_argument("--rotation", default=None, help="camera yaw,pitch (radians)")
    p.add_argument("--fov", type=float, default=45.0, help="vertical FoV, degrees")
    p.add_argument("--focus", type=float, default=90.0, help="focal distance")
    p.add_argument("--aperture", type=float, default=0.0)
    p.add_argument("--integrator", default="wavefront",
                   choices=["wavefront", "direct", "reference", "ao"])
    p.add_argument("--microfacet", default="trowbridge_reitz",
                   choices=["trowbridge_reitz", "beckmann", "blinn_phong"])
    p.add_argument("--max-bounces", type=int, default=64)
    p.add_argument("--no-nee", action="store_true")
    p.add_argument("--no-tonemap", action="store_true")
    p.add_argument("--no-cache", action="store_true",
                   help="build the scene's BVH without the disk cache")
    p.add_argument("--cache-dir", default="cache",
                   help="folder of the scene disk cache (default cache)")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frame-batch", type=int, default=1,
                   help="samples accumulated per frame")
    p.add_argument("--shadow-rev", action="store_true",
                   help="trace NEE shadow rays from the light end")
    p.add_argument("--bounce-traversal", default="auto",
                   help="bounce-ray traversal override: auto|same|tsort|"
                        "treelet|pallas|packet|perray (auto = same; tsort "
                        "sorts by treelet, treelet bins by treelet, when "
                        "named; packet and perray are plain torch walks)")
    p.add_argument("--wide-arity", type=int, default=8,
                   help="children per BVH node, 2 to 16")
    p.add_argument("--mip-levels", type=int, default=1)
    p.add_argument("--cluster-tris", type=int, default=0)
    p.add_argument("--sampler", default="random", choices=["random", "ld"],
                   help="pixel jitter: threefry or R2 low-discrepancy")
    p.add_argument("--megakernel", default="off", choices=["off", "on", "auto"])
    p.add_argument("--mega-fused-nee", action="store_true")
    p.add_argument("--exposure", type=float, default=1.68)
    p.add_argument("--bvh-builder", default="auto",
                   choices=["auto", "cpp", "numpy"])
    p.add_argument("--chunk", type=int, default=0, help="rays per chunk")
    p.add_argument("--partition-chips", type=int, default=0,
                   help="scene-partitioned render: that many ranks own BVH "
                        "subtrees and rays migrate between them "
                        "(parallel/partition.py)")
    p.add_argument("--partition-samples", type=int, default=1,
                   help="sample replicas composed over the partition")
    p.add_argument("--partition-routing", default="ring",
                   choices=["ring", "routed"],
                   help="partitioned ray migration: the ring (default) or "
                        "demand-routed all-to-all rounds")
    p.add_argument("--hdr-out", default=None,
                   help="also dump the raw mean-radiance film as .npy")
    p.add_argument("--stats-json", default=None,
                   help="write render stats JSON here")
    p.add_argument("--save-every", type=int, default=0,
                   help="save a progressive screenshot every N samples")
    p.add_argument("--platform", default=None)
    p.add_argument("--checkpoint", default=None,
                   help="save a resumable checkpoint here when done")
    p.add_argument("--resume", default=None,
                   help="resume a progressive render from this checkpoint "
                        "(its config; the scene flags are ignored)")
    p.add_argument("--interactive", action="store_true",
                   help="live WASD camera loop in the terminal (ANSI "
                        "half-block frames)")
    p.add_argument("--viewer-bench", type=int, default=0, metavar="N",
                   help="run N scripted navigation frames of the viewer "
                        "loop headless and report fps (no tty needed)")
    p.add_argument("--move-speed", type=float, default=1.0,
                   help="interactive camera move step (world units)")
    p.add_argument("--orbit", type=int, default=0, metavar="N",
                   help="render N frames orbiting the camera about the "
                        "vertical axis; writes out-000.png ...")
    args = p.parse_args(argv)
    for attr, fine, what in _UNPORTED:
        if getattr(args, attr) not in fine:
            p.error(f"--{attr.replace('_', '-')}={getattr(args, attr)}: "
                    f"{what} is not ported yet (see ROADMAP.md)")
    return args


def join_ranks(device: str):
    """Under torchrun (WORLD_SIZE > 1): joins the default process group and
    returns this rank's device (NCCL and cuda:LOCAL_RANK for a CUDA
    device, gloo for the CPU); otherwise returns ``device``."""
    import torch
    import torch.distributed as dist

    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or dist.is_initialized():
        return torch.device(device)
    dev = torch.device(device)
    if dev.type == "cuda":
        local = int(os.environ.get("LOCAL_RANK", "0"))
        local_world = int(os.environ.get("LOCAL_WORLD_SIZE", str(world)))
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if have < local_world:
            raise RuntimeError(
                f"{local_world} ranks on this host need as many GPUs for "
                f"NCCL (one a rank), the host has {have}")
        dev = torch.device("cuda", local)
        torch.cuda.set_device(dev)
        dist.init_process_group("nccl")
    else:
        dist.init_process_group("gloo")
    return dev


def main(argv=None) -> int:
    args = parse_args(argv)
    import torch
    import torch.distributed as dist

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")
    device = join_ranks(args.device)
    try:
        return _run(args, device)
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


def _run(args, device) -> int:
    import numpy as np
    import torch.distributed as dist

    from gpupathtracer_tpu_torch.ops.treelet import TRACES
    from gpupathtracer_tpu_torch.ops.tsort import SORTED
    from gpupathtracer_tpu_torch.render import Renderer
    from gpupathtracer_tpu_torch.render.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
    from gpupathtracer_tpu_torch.utils.io import timestamped_name

    ranks = dist.get_world_size() if dist.is_initialized() else 1
    if ranks > 1 and (args.interactive or args.viewer_bench):
        raise ValueError("the viewer runs in one process, not under "
                         f"{ranks} ranks")
    writer = not dist.is_initialized() or dist.get_rank() == 0
    # Rank 0 speaks for the ranks.
    log = sys.stderr if writer else io.StringIO()
    cfg = build_config(args)
    if cfg.partition_samples > 1 and cfg.partition_chips <= 0:
        raise SystemExit("--partition-samples composes sample replicas over "
                         "--partition-chips: give both")
    need = (cfg.partition_chips * max(cfg.partition_samples, 1)
            if cfg.partition_chips > 0 else 1)
    if not args.resume and need != ranks:
        raise SystemExit(f"--partition-chips {cfg.partition_chips} x "
                         f"--partition-samples {cfg.partition_samples} "
                         f"needs {need} ranks (torchrun --nproc-per-node "
                         f"{need}); this run has {ranks}")

    t0 = time.time()
    if args.resume:
        r = load_checkpoint(args.resume, device)
        cfg = r.cfg
        print(f"resumed at {r.num_samples} spp", file=log)
    else:
        r = Renderer(cfg, device)
    print(f"scene: {r.meta.num_triangles} tris, {r.meta.num_materials} "
          f"materials, {r.meta.num_lights} lights "
          f"({time.time() - t0:.1f}s)", file=log)
    if r.meta.bvh_stats:
        print(r.meta.bvh_stats.report(), file=log)

    out = args.out or timestamped_name(
        os.path.splitext(os.path.basename(args.scene))[0].replace(":", "_"))

    if args.viewer_bench:
        from gpupathtracer_tpu_torch.render.viewer import bench_viewer
        fps, enc_ms = bench_viewer(r, frames=args.viewer_bench,
                                   move_speed=args.move_speed)
        print(f"viewer loop: {fps:.1f} fps over {args.viewer_bench} "
              f"navigation frames ({cfg.width}x{cfg.height}, "
              f"{cfg.integrator}; ANSI encode {enc_ms:.1f} ms/frame)")
        return 0

    if args.interactive:
        from gpupathtracer_tpu_torch.render.viewer import run_viewer
        run_viewer(r, move_speed=args.move_speed)
        print(r.save_screenshot(out))
        return 0

    if args.orbit:
        # Turntable: the camera position rotated about the vertical axis,
        # accumulation reset a frame (Program.cpp camera-move semantics).
        base = r.cfg.camera
        px, py, pz = (float(x) for x in base.position)
        stem, ext = os.path.splitext(out)
        for f in range(args.orbit):
            ang = 2.0 * math.pi * f / args.orbit
            c, sn = math.cos(ang), math.sin(ang)
            r.set_camera(dataclasses.replace(
                base, position=(px * c - pz * sn, py, px * sn + pz * c),
                yaw=base.yaw + ang))
            for _ in range(args.spp):
                r.render_frame()
            frame_path = f"{stem}-{f:03d}{ext}"
            r.save_screenshot(frame_path)
            print(f"orbit frame {f + 1}/{args.orbit} -> {frame_path}",
                  file=log)
        print(f"{args.orbit} frames | {r.stats.report()}", file=log)
        if writer:
            print(out)
        return 0

    sorted_before, binned_before = dict(SORTED), dict(TRACES)
    for s in range(args.spp):
        r.render_frame(sync=True)
        if args.save_every and (s + 1) % args.save_every == 0:
            r.save_screenshot(out)
            print(f"  {s + 1}/{args.spp} spp -> {out} "
                  f"({r.stats.mrays_per_sec:.1f} Mrays/s)", file=log)

    path = r.save_screenshot(out)
    if args.checkpoint:
        save_checkpoint(r, args.checkpoint)
        print(f"checkpoint -> {args.checkpoint}", file=log)
    elapsed = time.time() - t0
    print(f"{args.spp} spp in {sum(r.stats.frame_times):.1f}s render "
          f"({elapsed:.1f}s total) | {r.stats.report()}", file=log)
    if args.hdr_out:
        film = r.film_hdr()
        if writer:
            np.save(args.hdr_out, film)
    if not writer:
        return 0
    print(path)
    if args.stats_json:
        with open(args.stats_json, "w") as f:
            json.dump({
                "spp": args.spp,
                "frame_seconds": r.stats.frame_times,
                "render_seconds": sum(r.stats.frame_times),
                "avg_fps": r.stats.avg_fps,
                "mrays_per_sec": r.stats.mrays_per_sec,
                "rays": r.stats.rays_traced,
                "triangles": r.meta.num_triangles,
                "has_delta": r.meta.has_delta,
                "device": str(device),
                "ranks": ranks,
                "bounce_traversal": r.bounce_traversal,
                # Treelet sorts and traces of sorted rays in this render.
                "sorted": {k: SORTED[k] - sorted_before[k] for k in SORTED},
                # Treelet-binned traces, their rounds and fallbacks.
                "treelet": {k: TRACES[k] - binned_before[k] for k in TRACES},
                "arity": r.scene.arity,
                "config": json.loads(cfg.to_json()),
            }, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
