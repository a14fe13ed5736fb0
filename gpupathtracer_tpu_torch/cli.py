"""Command-line renderer (counterpart of the JAX package's cli.py; role of
src/Program.cpp + scene.txt): load a scene, render progressively, save a
tonemapped PNG, report seconds per frame and Mrays/s.

Usage:
  python -m gpupathtracer_tpu_torch.cli proc:cornell --spp 16 --out c.png
  python -m gpupathtracer_tpu_torch.cli scene.txt --spp 64 --device cuda

The flags are the JAX CLI's, plus --device (default cuda; the CLI raises if
that device is absent, and never falls back). Flags for features the port
does not have yet raise with a pointer to ROADMAP.md.
"""

from __future__ import annotations

import argparse
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
    cfg.bvh_builder = args.bvh_builder
    cfg.sampler = args.sampler
    cfg.frame_batch = args.frame_batch
    cfg.megakernel = args.megakernel
    cfg.mega_fused_nee = args.mega_fused_nee
    cfg.shadow_rev = args.shadow_rev
    cfg.bounce_traversal = args.bounce_traversal
    cfg.mip_levels = args.mip_levels
    cfg.cluster_tris = args.cluster_tris
    if args.chunk:
        cfg.ray_chunk = args.chunk
    return cfg


# Flags of the JAX CLI whose features the port does not have yet:
# (attribute, value that is fine, what to say).
_UNPORTED = (
    ("integrator", ("wavefront", "direct"),
     "the reference and AO integrators"),
    ("shadow_rev", (False,), "light-end shadow rays"),
    ("bounce_traversal", ("auto", "same"), "tsort bounce traversal"),
    ("sampler", ("random",), "the ld sampler"),
    ("partition_chips", (0,), "multi-device rendering"),
    ("partition_samples", (1,), "multi-device rendering"),
    ("partition_routing", ("ring",), "multi-device rendering"),
    ("platform", (None,), "JAX platforms (use --device)"),
    ("checkpoint", (None,), "checkpoints"),
    ("resume", (None,), "checkpoints"),
    ("interactive", (False,), "the viewer"),
    ("viewer_bench", (0,), "the viewer"),
    ("orbit", (0,), "orbit renders (the viewer's camera loop)"),
)


def parse_args(argv=None):
    """The CLI's arguments; flags of unported features exit with an
    error."""
    p = argparse.ArgumentParser(
        prog="gpupathtracer_tpu_torch",
        description="Progressive path tracer on PyTorch and CUDA")
    p.add_argument("scene", help="scene.txt, .obj, or proc:<name>")
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
                   help="accepted for parity: the port keeps no scene cache")
    p.add_argument("--seed", type=int, default=0)
    p.add_argument("--frame-batch", type=int, default=1,
                   help="samples accumulated per frame")
    p.add_argument("--shadow-rev", action="store_true")
    p.add_argument("--bounce-traversal", default="auto")
    p.add_argument("--mip-levels", type=int, default=1)
    p.add_argument("--cluster-tris", type=int, default=0)
    p.add_argument("--sampler", default="random", choices=["random", "ld"])
    p.add_argument("--megakernel", default="off", choices=["off", "on", "auto"])
    p.add_argument("--mega-fused-nee", action="store_true")
    p.add_argument("--exposure", type=float, default=1.68)
    p.add_argument("--bvh-builder", default="auto",
                   choices=["auto", "cpp", "numpy"])
    p.add_argument("--chunk", type=int, default=0, help="rays per chunk")
    p.add_argument("--partition-chips", type=int, default=0)
    p.add_argument("--partition-samples", type=int, default=1)
    p.add_argument("--partition-routing", default="ring",
                   choices=["ring", "routed"])
    p.add_argument("--hdr-out", default=None,
                   help="also dump the raw mean-radiance film as .npy")
    p.add_argument("--stats-json", default=None,
                   help="write render stats JSON here")
    p.add_argument("--save-every", type=int, default=0,
                   help="save a progressive screenshot every N samples")
    p.add_argument("--platform", default=None)
    p.add_argument("--checkpoint", default=None)
    p.add_argument("--resume", default=None)
    p.add_argument("--interactive", action="store_true")
    p.add_argument("--viewer-bench", type=int, default=0)
    p.add_argument("--move-speed", type=float, default=1.0)
    p.add_argument("--orbit", type=int, default=0)
    args = p.parse_args(argv)
    for attr, fine, what in _UNPORTED:
        if getattr(args, attr) not in fine:
            p.error(f"--{attr.replace('_', '-')}={getattr(args, attr)}: "
                    f"{what} is not ported yet (see ROADMAP.md)")
    return args


def main(argv=None) -> int:
    args = parse_args(argv)
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.render import Renderer
    from gpupathtracer_tpu_torch.utils.io import timestamped_name

    device = torch.device(args.device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("--device cuda: no CUDA device is available "
                           "(pass --device cpu to run the plain versions)")
    cfg = build_config(args)

    t0 = time.time()
    r = Renderer(cfg, device)
    print(f"scene: {r.meta.num_triangles} tris, {r.meta.num_materials} "
          f"materials, {r.meta.num_lights} lights "
          f"({time.time() - t0:.1f}s)", file=sys.stderr)
    if r.meta.bvh_stats:
        print(r.meta.bvh_stats.report(), file=sys.stderr)

    out = args.out or timestamped_name(
        os.path.splitext(os.path.basename(args.scene))[0].replace(":", "_"))
    for s in range(args.spp):
        r.render_frame(sync=True)
        if args.save_every and (s + 1) % args.save_every == 0:
            r.save_screenshot(out)
            print(f"  {s + 1}/{args.spp} spp -> {out} "
                  f"({r.stats.mrays_per_sec:.1f} Mrays/s)", file=sys.stderr)

    path = r.save_screenshot(out)
    elapsed = time.time() - t0
    print(f"{args.spp} spp in {sum(r.stats.frame_times):.1f}s render "
          f"({elapsed:.1f}s total) | {r.stats.report()}", file=sys.stderr)
    print(path)

    if args.hdr_out:
        np.save(args.hdr_out, r.film_hdr())
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
                "device": str(device),
                "config": json.loads(cfg.to_json()),
            }, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
