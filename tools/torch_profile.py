#!/usr/bin/env python3
"""Frame profile of the PyTorch/CUDA port (PERF.md section 5).

    python3 tools/torch_profile.py [--out report.json] [--trace-dir DIR]

Run from the root of a checkout on a machine with one CUDA card. For the
smoke check's two configurations (proc:sponza 1920x1080, proc:bathroom
1280x720 with Beckmann), it times three frames after a warm-up at the
default ray_chunk and with one chunk for the whole film, counts traversal
launches per frame, and runs torch.profiler over one default-chunk frame:
device self time by op, host self time by op, and the cudaLaunchKernel
count. --out writes every number as JSON; --trace-dir writes a Chrome trace
per scene. Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = (("sponza", 1920, 1080, "trowbridge_reitz"),
        ("bathroom", 1280, 720, "beckmann"))


def _config(name, width, height, microfacet, chunk=None):
    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    cfg = RenderConfig(scene_path=f"proc:{name}", width=width, height=height,
                       bvh_builder="cpp", microfacet=microfacet)
    pos, yaw, pitch, fov, aperture, focus = default_camera(name)
    cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                              fov=math.radians(fov), aspect=width / height,
                              aperture=aperture, focal_distance=focus)
    if chunk:
        cfg.ray_chunk = chunk
    return cfg


def _timed_frames(renderer, n: int):
    """Seconds of n frames after one warm-up, and launches per frame."""
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    renderer.render_frame(sync=True)
    for k in kt.LAUNCHES:
        kt.LAUNCHES[k] = 0
    times = []
    for _ in range(n):
        t0 = time.perf_counter()
        renderer.render_frame(sync=True)
        times.append(time.perf_counter() - t0)
    return times, {k: v / n for k, v in kt.LAUNCHES.items()}


def _profile_frame(renderer, trace_path):
    import torch
    from torch.profiler import ProfilerActivity, profile

    renderer.render_frame(sync=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        renderer.render_frame(sync=True)
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    by_dev = sorted(ka, key=lambda e: -e.self_device_time_total)[:25]
    by_host = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:12]
    launch = [e for e in ka if e.key == "cudaLaunchKernel"]
    if trace_path:
        prof.export_chrome_trace(trace_path)
    torch.cuda.synchronize()
    return {
        "wall_s": wall,
        "device_self_ms": sum(e.self_device_time_total for e in ka) / 1e3,
        "launch_calls": launch[0].count if launch else 0,
        "launch_host_ms": launch[0].self_cpu_time_total / 1e3 if launch
        else 0.0,
        "top_device": [(e.key, e.self_device_time_total / 1e3, e.count)
                       for e in by_dev],
        "top_host": [(e.key, e.self_cpu_time_total / 1e3, e.count)
                     for e in by_host],
    }


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--frames", type=int, default=3)
    p.add_argument("--out", default=None, help="write the report as JSON")
    p.add_argument("--trace-dir", default=None,
                   help="write a Chrome trace per scene here")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    os.environ.setdefault("GPT_TPU_CACHE", os.path.join(
        ROOT, "gpupathtracer_tpu_torch", "_build", "sbvh"))
    import torch

    from gpupathtracer_tpu_torch.render import Renderer

    if not torch.cuda.is_available():
        print("torch_profile.py: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    report = {"card": smi}
    for name, w, h, mf in RUNS:
        base = Renderer(_config(name, w, h, mf), "cuda")
        entry = {}
        for label, chunk in (("default_chunk", None), ("one_chunk", w * h)):
            r = Renderer(_config(name, w, h, mf, chunk), "cuda",
                         scene=base.scene, meta=base.meta)
            times, launches = _timed_frames(r, args.frames)
            entry[label] = {"chunk": r.chunk, "s_per_frame": times,
                            "launches_per_frame": launches}
            print(f"[{name}] {label} ({r.chunk} rays per chunk): s/frame "
                  f"{', '.join(f'{t:.3f}' for t in times)}; launches per "
                  f"frame {launches}")
        r = Renderer(_config(name, w, h, mf), "cuda", scene=base.scene,
                     meta=base.meta)
        trace = (os.path.join(args.trace_dir, f"{name}_frame_trace.json")
                 if args.trace_dir else None)
        if trace:
            os.makedirs(args.trace_dir, exist_ok=True)
        prof = _profile_frame(r, trace)
        entry["profile"] = prof
        print(f"[{name}] profiled frame: wall {prof['wall_s']:.2f} s, device "
              f"self time {prof['device_self_ms']:.1f} ms, "
              f"{prof['launch_calls']} cudaLaunchKernel calls taking "
              f"{prof['launch_host_ms']:.1f} ms of host time")
        for key, ms, count in prof["top_device"]:
            print(f"   dev  {key[:64]:64s} {ms:9.2f} ms  n={count}")
        for key, ms, count in prof["top_host"]:
            print(f"   host {key[:64]:64s} {ms:9.2f} ms  n={count}")
        report[name] = entry
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
