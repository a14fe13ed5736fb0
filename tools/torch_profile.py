#!/usr/bin/env python3
"""Frame profile of the PyTorch/CUDA port (PERF.md section 5).

    python3 tools/torch_profile.py [--megakernel | --bench]
                                   [--out report.json] [--trace-dir DIR]

Run from the root of a checkout on a machine with one CUDA card. For the
smoke check's two wavefront configurations (proc:sponza 1920x1080,
proc:bathroom 1280x720 with Beckmann), it times three frames after a
warm-up at the default ray_chunk and with one chunk for the whole film,
counts traversal launches per frame, and runs torch.profiler over one
default-chunk frame: its device time by kind (the port's kernels, torch's
kernels, copies and sets) and busy time (the union of their spans), the
device kernels and host ops that take most, and the cudaLaunchKernel
count.

With --megakernel it does the same for the megakernel rows of the smoke
check (bathroom 1280x720 Beckmann at frame batch 64, table 800x600 with 64
bounces at 128, table 800x600 direct at 8) and for sponza 1920x1080 with
64 bounces at frame batch 8, all with a black sky and one chunk: wall
seconds per frame, the megakernel's own seconds per launch (CUDA events
around each launch) and its share of the wall time, and the profile of one
frame.

With --bench it profiles the wavefront rows of tools/torch_bench.py at
their configurations (ray_chunk 2^21, black sky, 64 bounces): table
800x600, sponza 1920x1080 (the default traversal) and bathroom 1280x720
with Beckmann: wall seconds per frame over --frames frames after a
warm-up, launches per frame, and the device's busy share: the busy time of one profiled frame (the union of its kernels', copies' and
sets' spans on the device) over the median unprofiled frame, and over
the profiled frame's own wall, which the profiler lengthens.

--out writes every number as JSON; --trace-dir writes a Chrome trace per
scene. Nothing here imports JAX.
"""

from __future__ import annotations

import argparse
import json
import math
import os
import statistics
import subprocess
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
RUNS = (("sponza", 1920, 1080, "trowbridge_reitz"),
        ("bathroom", 1280, 720, "beckmann"))
# (label, scene, width, height, integrator, RenderConfig fields, frames)
MEGA_RUNS = (
    ("bathroom_fb64", "bathroom", 1280, 720, "wavefront",
     dict(microfacet="beckmann", frame_batch=64), 4),
    ("table_fb128", "table", 800, 600, "wavefront",
     dict(max_bounces=64, frame_batch=128), 4),
    ("table_direct_fb8", "table", 800, 600, "direct",
     dict(frame_batch=8), 16),
    ("sponza_fb8", "sponza", 1920, 1080, "wavefront",
     dict(max_bounces=64, frame_batch=8), 4),
)


def _config(name, width, height, microfacet="trowbridge_reitz", chunk=None,
            **fields):
    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    cfg = RenderConfig(scene_path=f"proc:{name}", width=width, height=height,
                       bvh_builder="cpp", microfacet=microfacet, **fields)
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


def _device_spans(prof):
    """The profiled frame's device-side events (kernels, copies, sets):
    their summed time in ms by kind (the port's kernels, torch's, copies
    and sets), and the ms during which any ran (the union of their
    spans). key_averages() lists a kernel twice, once under its own name
    and once as the self device time of the op that launched it, so only
    device-side events are summed."""
    from torch.autograd import DeviceType

    by_kind = {"port": 0.0, "torch": 0.0, "copy": 0.0}
    spans = []
    for e in prof.events():
        if e.device_type != DeviceType.CUDA:
            continue
        kind = ("copy" if e.name.startswith(("Memcpy", "Memset")) else
                "torch" if "at::" in e.name else "port")
        by_kind[kind] += e.time_range.elapsed_us() / 1e3
        spans.append((e.time_range.start, e.time_range.end))
    busy, end = 0.0, None
    for a, b in sorted(spans):
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return by_kind, busy / 1e3


def _profile_frame(renderer, trace_path, integrator=None):
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    renderer.render_frame(integrator, sync=True)
    t0 = time.perf_counter()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        renderer.render_frame(integrator, sync=True)
    wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev = [e for e in ka if e.device_type == DeviceType.CUDA]
    by_dev = sorted(dev, key=lambda e: -e.self_device_time_total)[:25]
    by_host = sorted(ka, key=lambda e: -e.self_cpu_time_total)[:12]
    launch = [e for e in ka if e.key == "cudaLaunchKernel"]
    if trace_path:
        prof.export_chrome_trace(trace_path)
    torch.cuda.synchronize()
    by_kind, busy_ms = _device_spans(prof)
    return {
        "wall_s": wall,
        "device_ms": sum(by_kind.values()),
        "device_ms_by_kind": by_kind,
        "device_busy_ms": busy_ms,
        "launch_calls": launch[0].count if launch else 0,
        "launch_host_ms": launch[0].self_cpu_time_total / 1e3 if launch
        else 0.0,
        "top_device": [(e.key, e.self_device_time_total / 1e3, e.count)
                       for e in by_dev],
        "top_host": [(e.key, e.self_cpu_time_total / 1e3, e.count)
                     for e in by_host],
    }


def _trace_path(trace_dir, name):
    if not trace_dir:
        return None
    os.makedirs(trace_dir, exist_ok=True)
    return os.path.join(trace_dir, f"{name}_frame_trace.json")


def _print_profile(name, prof) -> None:
    kinds = ", ".join(f"{k} {v:.1f}" for k, v in
                      prof["device_ms_by_kind"].items())
    print(f"[{name}] profiled frame: wall {prof['wall_s']:.2f} s, device "
          f"time {prof['device_ms']:.1f} ms ({kinds}), busy "
          f"{prof['device_busy_ms']:.1f} ms, "
          f"{prof['launch_calls']} cudaLaunchKernel calls taking "
          f"{prof['launch_host_ms']:.1f} ms of host time")
    for key, ms, count in prof["top_device"]:
        print(f"   dev  {key[:64]:64s} {ms:9.2f} ms  n={count}")
    for key, ms, count in prof["top_host"]:
        print(f"   host {key[:64]:64s} {ms:9.2f} ms  n={count}")


def _wavefront(args, report) -> None:
    from gpupathtracer_tpu_torch.render import Renderer

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
        entry["profile"] = _profile_frame(r, _trace_path(args.trace_dir,
                                                         name))
        _print_profile(name, entry["profile"])
        report[name] = entry


def _megakernel(args, report) -> None:
    """The megakernel rows: wall time per frame against the kernel's own
    time, read by CUDA events around each trace_mega call."""
    import torch

    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.render import Renderer

    events = []
    trace_mega = mk.trace_mega

    def timed(*a, **kw):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        out = trace_mega(*a, **kw)
        end.record()
        events.append((start, end))
        return out

    mk.trace_mega = timed
    try:
        for label, name, w, h, integrator, fields, frames in MEGA_RUNS:
            r = Renderer(_config(name, w, h, chunk=2097152,
                                 skybox="GENERATE COLOR BLACK",
                                 megakernel="on", **fields), "cuda")
            if not r.use_mega:
                raise AssertionError(f"[{label}] not mega-eligible")
            r.render_frame(integrator, sync=True)
            events.clear()
            walls = []
            for _ in range(frames):
                t0 = time.perf_counter()
                r.render_frame(integrator, sync=True)
                walls.append(time.perf_counter() - t0)
            kernel = [s.elapsed_time(e) / 1e3 for s, e in events]
            share = sum(kernel) / sum(walls)
            batch = r.cfg.frame_batch
            print(f"[{label}] {w}x{h} {integrator}, frame batch {batch}: "
                  f"wall s/frame {', '.join(f'{t:.4f}' for t in walls)}; "
                  f"megakernel s/launch "
                  f"{', '.join(f'{t:.4f}' for t in kernel)}; kernel share "
                  f"of wall {share:.3f}; wall s/sample "
                  f"{sum(walls) / frames / batch:.5f}")
            prof = _profile_frame(r, _trace_path(args.trace_dir, label),
                                  integrator)
            _print_profile(label, prof)
            report[label] = {"frame_batch": batch, "s_per_frame": walls,
                             "kernel_s_per_launch": kernel,
                             "kernel_share": share, "profile": prof}
    finally:
        mk.trace_mega = trace_mega


def _bench(args, report) -> None:
    """The bench's wavefront rows: wall per frame and the busy share."""
    import torch

    sys.path.insert(0, os.path.join(ROOT, "tools"))
    import torch_bench as tb

    b = tb.Bench(torch.device("cuda"), tb.Protocol())
    rows = (("table_pt_wavefront",
             b.cfg("proc:table", 800, 600, integrator="wavefront",
                   max_bounces=64)),
            ("sponza_default",
             b.cfg("proc:sponza", 1920, 1080, camera=tb._sponza_camera(),
                   integrator="wavefront", max_bounces=64)),
            ("bathroom_wavefront",
             b.cfg("proc:bathroom", 1280, 720, integrator="wavefront",
                   microfacet="beckmann", max_bounces=64)))
    for label, cfg in rows:
        r = b.renderer(cfg)
        times, launches = _timed_frames(r, args.frames)
        prof = _profile_frame(r, _trace_path(args.trace_dir, label))
        wall = statistics.median(times)
        entry = {"chunk": r.chunk, "s_per_frame": times,
                 "launches_per_frame": launches, "profile": prof,
                 "busy_share": prof["device_busy_ms"] / 1e3 / wall,
                 "busy_share_profiled": prof["device_busy_ms"] / 1e3 /
                 prof["wall_s"]}
        print(f"[{label}] {r.width}x{r.height}, {r.chunk} rays per chunk: "
              f"s/frame {', '.join(f'{t:.4f}' for t in times)}; launches "
              f"per frame {launches}; device busy share "
              f"{entry['busy_share']:.4f} of the median frame, "
              f"{entry['busy_share_profiled']:.4f} of the profiled one")
        _print_profile(label, prof)
        report[label] = entry
        del r


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    p.add_argument("--megakernel", action="store_true",
                   help="profile the megakernel rows instead")
    p.add_argument("--bench", action="store_true",
                   help="profile the bench's wavefront rows instead")
    p.add_argument("--frames", type=int, default=3,
                   help="timed wavefront frames per configuration")
    p.add_argument("--out", default=None, help="write the report as JSON")
    p.add_argument("--trace-dir", default=None,
                   help="write a Chrome trace per scene here")
    args = p.parse_args(argv)
    sys.path.insert(0, ROOT)
    import torch

    if not torch.cuda.is_available():
        print("torch_profile.py: no CUDA device", file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    report = {"card": smi}
    if args.megakernel and args.bench:
        p.error("--megakernel and --bench are exclusive")
    (_megakernel if args.megakernel else _bench if args.bench
     else _wavefront)(args, report)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(report, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
