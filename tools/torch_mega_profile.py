#!/usr/bin/env python3
"""Megakernel frame decomposition of the PyTorch/CUDA port (the
counterpart of tools/mega_profile.py).

    python3 tools/torch_mega_profile.py [--scene proc:bathroom]
        [--width 1280 --height 720] [--max-bounces 64] [--cluster-tris N]
        [--spp N] [--time --frames 3] [--device cuda]

Runs one megakernel launch over the whole film with its counters on
(ops/megakernel.py trace_mega with_stats=True, the JAX kernel's layout)
and breaks the frame into closest and any-hit node and leaf pops, the
tail share (pops of walks at bounce >= 8, where Russian roulette has
thinned the paths) and the bounce-loop iterations per packet. The TPU
kernel counts the pops of a packet's shared stack; here each lane walks
alone, so a packet's counts are sums of its lanes' own walks, and its
iterations the largest lane's. Counts are exact and deterministic: they do
not depend on the card's speed. --time also times --frames launches
without counters (CUDA events), so pops turn into ns per pop; with
--spp > 1 (in-kernel regeneration) it times that and the loop of one
launch per sample in turns, as the JAX tool's paired A/B does.

--device cpu runs the plain version (a rehearsal at a tiny --width and
--height); its times are host times. Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import math
import os
import statistics
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _ms(fn, device) -> float:
    import time

    import torch

    if device.type != "cuda":
        t0 = time.perf_counter()
        fn()
        return 1e3 * (time.perf_counter() - t0)
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    fn()
    end.record()
    torch.cuda.synchronize(device)
    return start.elapsed_time(end)


def main(argv=None) -> dict:
    """Prints the decomposition; returns its numbers (per sample)."""
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scene", default="proc:bathroom")
    ap.add_argument("--width", type=int, default=1280)
    ap.add_argument("--height", type=int, default=720)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--max-bounces", type=int, default=64)
    ap.add_argument("--cluster-tris", type=int, default=0)
    ap.add_argument("--spp", type=int, default=1,
                    help="samples a launch: > 1 regenerates paths in the "
                         "kernel, and --time pairs it with one launch a "
                         "sample")
    ap.add_argument("--time", action="store_true",
                    help="also time --frames launches without counters")
    ap.add_argument("--frames", type=int, default=3)
    args = ap.parse_args(argv)

    import numpy as np
    import torch

    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.ops.megakernel import (
        render_sample_mega, render_sample_mega_batch)
    from gpupathtracer_tpu_torch.render import Renderer
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    device = torch.device(args.device)
    if device.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("torch.cuda.is_available() is false; --device "
                               "cpu rehearses the plain version")
        print("# " + subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            check=True).stdout.strip())
    else:
        print("# cpu rehearsal: the plain version, host times")
    w, h = args.width, args.height
    cfg = RenderConfig(scene_path=args.scene, skybox="GENERATE COLOR BLACK",
                       width=w, height=h, integrator="wavefront",
                       microfacet="beckmann", max_bounces=args.max_bounces,
                       ray_chunk=1 << 21, megakernel="on",
                       cluster_tris=args.cluster_tris,
                       bvh_builder="cpp" if device.type == "cuda" else "auto")
    pos, yaw, pitch, fov, aperture, focus = default_camera(args.scene)
    cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                              fov=math.radians(fov), aspect=w / h,
                              aperture=aperture, focal_distance=focus)
    r = Renderer(cfg, device)
    if not r.use_mega:
        raise SystemExit("scene / configuration is not mega-eligible")
    mk = r.mega_statics(cfg.integrator)
    key = random.PRNGKey(7, device)
    spp = args.spp
    _, rays, stats = render_sample_mega(
        r.scene, r.mega_tables, r.camera, r.pixel_x, r.pixel_y, key,
        sample_idx=0, with_stats=True, spp=spp, **mk)
    st = stats.cpu().numpy().astype(np.int64) / spp  # [P, 9], per sample
    P, K = st.shape[0], min(mk["packet_size"], max(r.n_rays, 128))
    n = r.pad_w * r.pad_h
    bounce_rays, shadow_rays = st[:, 0].sum(), st[:, 1].sum()
    cn, cl, an, al = (st[:, k].sum() for k in (2, 3, 4, 5))
    ctail, atail = st[:, 6].sum(), st[:, 7].sum()
    iters = st[:, 8] * spp
    tot = cn + cl + an + al
    leaf = "cluster" if args.cluster_tris else "leaf"
    print(f"# {args.scene} {w}x{h} max_bounces={cfg.max_bounces} P={P} "
          f"K={K} rays/frame={n} spp/launch={spp} cluster_tris="
          f"{args.cluster_tris} (counts below are PER SAMPLE)")
    print(f"segments: bounce {bounce_rays:.0f} ({bounce_rays / n:.2f}/px) + "
          f"live shadow {shadow_rays:.0f} ({shadow_rays / n:.2f}/px) = "
          f"{(bounce_rays + shadow_rays) / n:.2f}/px/spp")
    print(f"pops per packet, sums of its lanes' own walks (not a shared "
          f"stack's pops): closest node {cn / P:.0f} {leaf} {cl / P:.0f} | "
          f"anyhit node {an / P:.0f} {leaf} {al / P:.0f} | total "
          f"{tot / P:.0f}")
    print(f"pops per ray: closest {(cn + cl) / max(bounce_rays, 1):.2f} "
          f"(node {cn / max(bounce_rays, 1):.2f}), any-hit "
          f"{(an + al) / max(shadow_rays, 1):.2f} (node "
          f"{an / max(shadow_rays, 1):.2f})")
    print(f"bounce iterations per packet (its longest lane, whole launch): "
          f"p50={np.median(iters):.0f} mean={iters.mean():.1f} "
          f"max={iters.max():.0f}")
    print(f"tail share (pops at bounce >= 8): closest "
          f"{ctail / max(cn + cl, 1):.1%}  anyhit "
          f"{atail / max(an + al, 1):.1%}  all "
          f"{(ctail + atail) / max(tot, 1):.1%}")
    out = {"bounce_rays": float(bounce_rays), "shadow_rays": float(shadow_rays),
           "closest_node": float(cn), "closest_leaf": float(cl),
           "anyhit_node": float(an), "anyhit_leaf": float(al),
           "tail_share": float((ctail + atail) / max(tot, 1)),
           "iters_p50": float(np.median(iters)), "rays": int(rays)}

    if args.time:
        def launch(fori):
            if spp == 1:
                return lambda: render_sample_mega(
                    r.scene, r.mega_tables, r.camera, r.pixel_x, r.pixel_y,
                    key, sample_idx=0, **mk)
            return lambda: render_sample_mega_batch(
                r.scene, r.mega_tables, r.camera, r.pixel_x, r.pixel_y, key,
                spp=spp, sample_idx=0, fori=fori, **mk)

        variants = ([("regen", launch(False)), ("loop", launch(True))]
                    if spp > 1 else [("mega", launch(False))])
        for _, f in variants:
            f()  # warm-up
        times = {nm: [] for nm, _ in variants}
        for _ in range(args.frames):
            for nm, f in variants:  # in turns: drift is shared
                times[nm].append(_ms(f, device))
        for i, (nm, _) in enumerate(variants):
            ts = times[nm]
            med = statistics.median(ts)
            spread = (max(ts) - min(ts)) / med if med > 0 else 0.0
            line = (f"{nm}: {med / spp:.2f} ms/sample (launch {med:.2f} ms, "
                    f"spread {spread:.0%})")
            if i == 0:
                ns = med / spp * 1e6 / max(tot, 1)
                out.update(ms_per_sample=med / spp, ns_per_pop=ns)
                line += (f" | ns/pop {ns:.4f} | sustained "
                         f"{(bounce_rays + shadow_rays) * spp / med / 1e3:.1f}"
                         f" Mrays/s")
            else:
                ratios = [a / b for a, b in zip(ts, times[variants[0][0]])]
                line += (f" | paired ratio vs {variants[0][0]} "
                         f"{statistics.median(ratios):.3f}x")
            print(line, flush=True)
    return out


if __name__ == "__main__":
    main()
