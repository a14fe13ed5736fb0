#!/usr/bin/env python3
"""Smoke check of gpupathtracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and g++. Phases, each of which raises on failure:

  1. versions and the card's name and power limit; CUDA must be present;
  2. build the traversal kernel (csrc/traverse.cu) and the megakernel
     (csrc/megakernel.cu) with nvcc, both at once; ptxas registers, stack
     frame and spills of every instantiation;
  3. each kernel entry point against its plain torch version on the card,
     on the sponza and bathroom tables, with 65,536 camera rays plus
     65,536 random-direction rays from surface points, about 10% of lanes
     inactive: prim and occluded equal, t/u/v bitwise equal; kernel and
     plain times by CUDA events;
  4. the golden recipe of tests/test_golden.py (cornell, 32x32, 8 spp) on
     the card against tests/golden/cornell_32_8spp.npz;
  5. the main path through the CLI: proc:sponza 1920x1080 with 64 bounces
     and proc:bathroom 1280x720 (Beckmann, default DoF camera), 4 spp
     each, with the C++ SBVH; films finite and nonzero, PNGs written, and
     both kernel entry points launched by these renders;
  6. the megakernel against its plain torch version on the card: bathroom
     256x144 (Beckmann, default DoF camera, 64 bounces) at 1 spp and with
     in-kernel regeneration at 4 spp, table 200x150 direct at 8 spp: ray
     counts equal, contributions bitwise equal (at most 0.1% of lanes
     may differ, and those are printed); kernel and plain times;
  7. the megakernel against its plain version at the arguments of phase
     8's rows: the first chunk of each row's first frame, built as the
     Renderer builds it, runs through the kernel on all its lanes; its
     first two packets run through the kernel alone (the same lanes must
     come out) and through the plain version (held as in phase 6);
  8. the megakernel path through the CLI, the JAX bench's megakernel rows
     at their published sizes: bathroom 1280x720 Beckmann DoF (frame batch
     64), table 800x600 with 64 bounces (frame batch 128) and table
     800x600 direct (frame batch 8), black sky, one chunk; films finite
     and nonzero, PNGs written, the megakernel launched and the traversal
     kernel not;
  9. the megakernel against the wavefront integrator on the card: table
     200x150, 64 bounces, 64 spp, film means within 2%.

The second-to-last line of stdout is a JSON object with one entry per
kernel; the last line is {"ok": true, "device": {...}}. Any failure exits
nonzero before that line. Nothing here imports JAX.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import tempfile
import time

ROOT = os.path.dirname(os.path.abspath(__file__))
N_RAYS = 65536
SOURCES = {"trace_closest": "gpupathtracer_tpu_torch/csrc/traverse.cu",
           "trace_anyhit": "gpupathtracer_tpu_torch/csrc/traverse.cu",
           "trace_mega": "gpupathtracer_tpu_torch/csrc/megakernel.cu"}
REPLACES = {"trace_closest": "gpupathtracer_tpu/ops/pallas_traverse.py:72",
            "trace_anyhit": "gpupathtracer_tpu/ops/pallas_traverse.py:72 "
                            "(any-hit mode), "
                            "gpupathtracer_tpu/ops/pallas_traverse.py:1036",
            "trace_mega": "gpupathtracer_tpu/ops/megakernel.py:188"}
# At most this share of lanes may differ between the megakernel and its
# plain version (exact ties or a last-place difference of a libdevice
# function can turn one path); every other lane must be bitwise equal.
MEGA_LANE_BOUND = 1e-3


def _events_ms(fn, reps: int) -> float:
    """Mean milliseconds of fn() over reps runs, after one warm-up run."""
    import torch
    fn()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / reps


def _test_rays(scene, meta, cfg, device):
    """65,536 camera rays of the scene's default camera at cfg's film size,
    then 65,536 rays from the surface points they hit, in random
    directions. Returns o, d [2N, 3], a random t_max [2N] for the
    occlusion queries, and a random active mask [2N], about 90% true, as
    the integrator's masks are after rays die."""
    import numpy as np
    import torch

    from gpupathtracer_tpu_torch.math.camera import (gen_rays,
                                                     generate_image_plane)
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt

    rng = np.random.RandomState(1234)
    pix = rng.randint(0, cfg.width * cfg.height, N_RAYS)
    interp = np.stack([(pix % cfg.width + rng.rand(N_RAYS)) / cfg.width,
                       (pix // cfg.width + rng.rand(N_RAYS)) / cfg.height],
                      axis=-1).astype(np.float32)
    lens = rng.rand(N_RAYS, 2).astype(np.float32)
    cam = generate_image_plane(cfg.camera, device)
    o, d = gen_rays(cam, torch.as_tensor(interp, device=device),
                    torch.as_tensor(lens, device=device))
    far = torch.full((N_RAYS,), 1e20, device=device)
    on = torch.ones(N_RAYS, dtype=torch.bool, device=device)
    t, prim, _, _ = kt.closest_plain(scene.node_rows, o, d, far, on,
                                     stack_depth=meta.stack_depth,
                                     leaf_size=meta.leaf_size)
    normal = scene.tri_shade[prim.clamp_min(0).long(), 0:3]
    hit = (prim >= 0)[:, None]
    o2 = torch.where(hit, o + d * t[:, None] + 0.003 * normal, o)
    d2 = torch.as_tensor(rng.normal(size=(N_RAYS, 3)).astype(np.float32),
                         device=device)
    d2 = d2 / torch.linalg.vector_norm(d2, dim=1, keepdim=True)
    o_all = torch.cat([o, o2]).contiguous()
    d_all = torch.cat([d, d2]).contiguous()
    t_occ = torch.as_tensor(rng.uniform(0.05, 20.0, 2 * N_RAYS)
                            .astype(np.float32), device=device)
    active = torch.as_tensor(rng.rand(2 * N_RAYS) < 0.9, device=device)
    return o_all, d_all, t_occ, active


def _bits(x):
    import torch
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def compare_kernels(name: str, width: int, height: int, device, results):
    """Phase 3 for one scene: each entry point against its plain version."""
    import torch

    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.scene import load_scene
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    cfg = RenderConfig(scene_path=f"proc:{name}", width=width, height=height,
                       bvh_builder="cpp")
    pos, yaw, pitch, fov, aperture, focus = default_camera(name)
    cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                              fov=math.radians(fov), aspect=width / height,
                              aperture=aperture, focal_distance=focus)
    t0 = time.perf_counter()
    scene, meta = load_scene(cfg, device)
    print(f"[{name}] ingest {time.perf_counter() - t0:.2f} s: "
          f"{meta.num_triangles} triangles, {scene.node_rows.shape[0]} rows "
          f"({scene.node_rows.numel() * 4 / 1e6:.1f} MB), stack depth "
          f"{meta.stack_depth}")
    o, d, t_occ, on = _test_rays(scene, meta, cfg, device)
    far = torch.full((o.shape[0],), 1e20, device=device)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    rows = scene.node_rows

    got = kt.closest(rows, o, d, far, on, **kw)
    want = kt.closest_plain(rows, o, d, far, on, **kw)
    torch.cuda.synchronize()
    for field, a, b in zip("t prim u v".split(), got, want):
        if not torch.equal(_bits(a), _bits(b)):
            bad = int((_bits(a) != _bits(b)).sum())
            raise AssertionError(f"[{name}] trace_closest {field} differs "
                                 f"from closest_plain in {bad} lanes")
    hit = want[1] >= 0
    err_c = max(float((a - b)[hit].abs().max()) if hit.any() else 0.0
                for a, b in (zip((got[0], got[2], got[3]),
                                 (want[0], want[2], want[3]))))
    occ = kt.anyhit(rows, o, d, t_occ, on, **kw)
    occ_want = kt.anyhit_plain(rows, o, d, t_occ, on, **kw)
    torch.cuda.synchronize()
    if not torch.equal(occ, occ_want):
        raise AssertionError(f"[{name}] trace_anyhit differs from "
                             f"anyhit_plain in {int((occ != occ_want).sum())} "
                             f"lanes")
    err_a = float((occ.float() - occ_want.float()).abs().max())

    ms_c = _events_ms(lambda: kt.closest(rows, o, d, far, on, **kw), 10)
    plain_c = _events_ms(lambda: kt.closest_plain(rows, o, d, far, on, **kw),
                         1)
    ms_a = _events_ms(lambda: kt.anyhit(rows, o, d, t_occ, on, **kw), 10)
    plain_a = _events_ms(lambda: kt.anyhit_plain(rows, o, d, t_occ, on, **kw),
                         1)
    n = o.shape[0]
    print(f"[{name}] {n} rays, {float(on.float().mean()):.3f} active: hit "
          f"rate {float(hit.float().mean()):.3f}, occluded "
          f"{float(occ.float().mean()):.3f}; bitwise equal to the plain "
          f"versions")
    print(f"[{name}] trace_closest {ms_c:.3f} ms ({n / ms_c / 1e3:.1f} "
          f"Mrays/s), closest_plain {plain_c:.1f} ms")
    print(f"[{name}] trace_anyhit  {ms_a:.3f} ms ({n / ms_a / 1e3:.1f} "
          f"Mrays/s), anyhit_plain  {plain_a:.1f} ms")
    results[name] = {"trace_closest": (err_c, ms_c, plain_c),
                     "trace_anyhit": (err_a, ms_a, plain_a)}


def golden_check(device) -> None:
    """Phase 4: tests/test_golden.py's cornell recipe on the card."""
    import numpy as np

    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.render import Renderer

    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=32, height=32, ray_chunk=1024, max_bounces=8)
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    r = Renderer(cfg, device)
    for _ in range(8):
        r.render_frame()
    img = r.film_hdr()
    gold = np.load(os.path.join(ROOT, "tests", "golden",
                                "cornell_32_8spp.npz"))["hdr"]
    # The golden's own tolerance (tests/test_golden.py): rtol = atol = 2e-3.
    outside = (np.abs(img - gold) > 2e-3 + 2e-3 * np.abs(gold)).any(-1)
    print(f"[golden] cornell 32x32 8 spp on the card: max |diff| "
          f"{float(np.abs(img - gold).max()):.3g}, {int(outside.sum())} of "
          f"{outside.size} pixels outside rtol=atol=2e-3")
    if outside.mean() > 0.01:
        raise AssertionError("cornell golden: more than 1% of pixels differ")


def render_main_path(tmp: str):
    """Phase 5: the CLI on sponza and bathroom. Returns per-scene stats."""
    import numpy as np

    from gpupathtracer_tpu_torch import cli

    runs = {
        "sponza": ["proc:sponza", "--width", "1920", "--height", "1080",
                   "--max-bounces", "64"],
        "bathroom": ["proc:bathroom", "--width", "1280", "--height", "720",
                     "--microfacet", "beckmann"],
    }
    stats = {}
    for name, args in runs.items():
        png = os.path.join(tmp, f"{name}.png")
        hdr = os.path.join(tmp, f"{name}.npy")
        sj = os.path.join(tmp, f"{name}.json")
        rc = cli.main(args + ["--device", "cuda", "--spp", "4",
                              "--bvh-builder", "cpp", "--out", png,
                              "--hdr-out", hdr, "--stats-json", sj])
        if rc != 0:
            raise AssertionError(f"[{name}] CLI returned {rc}")
        with open(png, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"[{name}] {png} is not a PNG")
        film = np.load(hdr)
        h, w = int(args[4]), int(args[2])
        if film.shape != (h, w, 3):
            raise AssertionError(f"[{name}] film shape {film.shape}")
        if not np.isfinite(film).all() or not (film > 0).any():
            raise AssertionError(f"[{name}] film is not finite and nonzero")
        with open(sj) as f:
            s = json.load(f)
        spf = s["render_seconds"] / s["spp"]
        print(f"[{name}] {w}x{h}, 4 spp: {spf:.3f} s/frame (frames "
              f"{', '.join(f'{x:.3f}' for x in s['frame_seconds'])} s), "
              f"{s['mrays_per_sec']:.1f} Mrays/s, {s['rays']} rays, film "
              f"mean {float(film.mean()):.4f}")
        stats[name] = s
    return stats


def _scene_cfg(name: str, width: int, height: int, **kw):
    """RenderConfig of a procedural scene at its default camera, C++ SBVH."""
    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.scene.procedural import default_camera

    cfg = RenderConfig(scene_path=f"proc:{name}", width=width, height=height,
                       bvh_builder="cpp", **kw)
    pos, yaw, pitch, fov, aperture, focus = default_camera(name)
    cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                              fov=math.radians(fov), aspect=width / height,
                              aperture=aperture, focal_distance=focus)
    return cfg


def _ptxas_summary(log: str):
    """One line per compiled kernel: registers, stack frame and spills."""
    import re

    from gpupathtracer_tpu_torch.ops.megakernel import MODELS

    out, name = [], None
    for line in log.splitlines():
        if "Function properties for" in line:
            name = line.split("Function properties for")[-1].strip()
            m = re.search(r"mega_kernelILi(\d)ELb(\d)ELb(\d)E", name)
            t = re.search(r"(trace_\w+?_kernel)", name)
            if m:
                name = (f"mega_kernel<{MODELS[int(m.group(1))]}, "
                        f"nee={m.group(2)}, regen={m.group(3)}>")
            elif t:
                name = t.group(1)
        elif "stack frame" in line and name:
            frame = line.strip()
        elif "Used" in line and "registers" in line and name:
            regs = line.split("Used")[-1].split(",")[0].strip()
            out.append(f"{name}: {regs}, {frame}")
            name = None
    return out


def build_kernels() -> None:
    """Phase 2: one nvcc per source, started together."""
    from concurrent.futures import ThreadPoolExecutor

    from gpupathtracer_tpu_torch.ops import cuda_build

    def one(name):
        t0 = time.perf_counter()
        _, log = cuda_build.build(name)
        return time.perf_counter() - t0, log

    names = ("traverse", "megakernel")
    with ThreadPoolExecutor(len(names)) as pool:
        for name, (secs, log) in zip(names, pool.map(one, names)):
            print(f"[build] {os.path.relpath(cuda_build.source(name), ROOT)}: "
                  f"{secs:.2f} s")
            for line in _ptxas_summary(log):
                print(f"[build]   {line}")


def compare_mega(device, results) -> None:
    """Phase 6: trace_mega against trace_mega_plain on the same inputs."""
    import torch

    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.math.camera import generate_image_plane
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.scene import load_scene

    cases = [("bathroom", 256, 144, "beckmann", 64, 1),
             ("bathroom", 256, 144, "beckmann", 64, 4),
             ("table", 200, 150, "trowbridge_reitz", 0, 8)]
    scenes, errs = {}, []
    for name, w, h, model, mb, spp in cases:
        cfg = _scene_cfg(name, w, h, skybox="GENERATE COLOR BLACK",
                         microfacet=model)
        if name not in scenes:
            scenes[name] = load_scene(cfg, device)
        scene, meta = scenes[name]
        lane = torch.arange(w * h, device=device)
        args, kw = mk.prepare_mega(
            scene, mk.pack_mega_tables(scene),
            generate_image_plane(cfg.camera, device),
            (lane % w).float(), (lane // w).float(), random.PRNGKey(7, device),
            width=w, height=h, stack_depth=meta.stack_depth,
            leaf_size=meta.leaf_size, max_bounces=mb, nee=True, model=model,
            n_mats=meta.num_materials,
            n_lights=int(scene.light_rows.shape[0]),
            packet_size=cfg.pallas_packet_size, spp=spp)
        label = f"[mega {name} {w}x{h} {model} max_bounces={mb} spp={spp}]"
        got, rays = mk.trace_mega(*args, **kw)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want, rays_plain = mk.trace_mega_plain(*args, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        errs.append(_hold_mega(label, got, want, rays, rays_plain))
        ms = _events_ms(lambda: mk.trace_mega(*args, **kw), 3)
        print(f"{label} trace_mega {ms:.2f} ms ({int(rays) / ms / 1e3:.1f} "
              f"Mrays/s), trace_mega_plain {plain_ms:.1f} ms")
        if (name, spp) == ("bathroom", 4):  # the regenerating path's case
            timed = (ms, plain_ms)
    results["mega"] = {"trace_mega": (max(errs), *timed)}


def _hold_mega(label, got, want, rays, rays_plain) -> float:
    """The kernel's lanes against the plain version's on the same inputs:
    ray counts equal, and every lane bitwise equal but at most
    MEGA_LANE_BOUND of them, which are printed. Returns the max |diff|."""
    import torch

    if int(rays) != int(rays_plain):
        raise AssertionError(f"{label} rays: kernel {int(rays)}, plain "
                             f"{int(rays_plain)}")
    differ = (got.view(torch.int32) != want.view(torch.int32)).any(1)
    bad = torch.nonzero(differ).squeeze(1)
    err = float((got - want).abs().max())
    n = got.shape[0]
    if bad.numel():
        for i in bad[:10].tolist():
            print(f"{label} lane {i}: kernel {got[i].tolist()}, plain "
                  f"{want[i].tolist()}")
        print(f"{label} {bad.numel()} of {n} lanes differ, max |diff| "
              f"{err:.3g} (bound: {MEGA_LANE_BOUND:.1%} of lanes)")
        if bad.numel() > MEGA_LANE_BOUND * n:
            raise AssertionError(f"{label} {bad.numel()} lanes differ")
    print(f"{label} {n} lanes, {int(rays)} rays equal, {n - bad.numel()} "
          f"lanes bitwise equal")
    return err


def _first_packets(args, kw, packets: int):
    """The trace_mega arguments of the first ``packets`` packets alone. A
    lane depends only on its packet's seed and its index in the packet, so
    these lanes compute what they compute in the whole launch."""
    m = packets * kw["packet_size"]
    rows, mats, lights, cdf, params, o, d, act, seeds = args

    def cut(x):
        return None if x is None else x[:m]
    return ((rows, mats, lights, cdf, params, cut(o), cut(d), act[:m],
             seeds[:packets]),
            dict(kw, pxn=cut(kw.get("pxn")), pyn=cut(kw.get("pyn"))))


def compare_mega_rows(device, results) -> None:
    """Phase 7: for each row of phase 8, the first chunk of its first frame
    as the Renderer builds it (same configuration, lanes, key and
    arguments). The kernel runs on all the chunk's lanes, and on its first
    MEGA_PACKETS packets alone, which must give the same lanes; the plain
    version runs on those packets."""
    import torch

    from gpupathtracer_tpu_torch import cli
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.render import Renderer

    for name, args, batch, frames in MEGA_RUNS:
        cfg = cli.build_config(cli.parse_args(
            _mega_argv(args, batch, frames)))
        r = Renderer(cfg, device)
        if not r.use_mega:
            raise AssertionError(f"[{name}] the scene is not mega-eligible")
        sl = slice(0, r.chunk)
        statics = r.mega_statics(cfg.integrator)
        margs, kw = mk.prepare_mega(
            r.scene, r.mega_tables, r.camera, r.pixel_x[sl], r.pixel_y[sl],
            r.chunk_key(0), sample_idx=0, spp=batch, **statics)
        n = margs[7].shape[0]
        full, rays_full = mk.trace_mega(*margs, **kw)
        ms = _events_ms(lambda: mk.trace_mega(*margs, **kw), 2)
        sargs, skw = _first_packets(margs, kw, MEGA_PACKETS)
        m = sargs[7].shape[0]
        got, rays = mk.trace_mega(*sargs, **skw)
        label = (f"[mega {name} first chunk, {statics['model']}, "
                 f"max_bounces={statics['max_bounces']}, spp={batch}]")
        if not torch.equal(got.view(torch.int32),
                           full[:m].view(torch.int32)):
            raise AssertionError(f"{label} the first {MEGA_PACKETS} packets "
                                 f"alone differ from the whole launch")
        t0 = time.perf_counter()
        want, rays_plain = mk.trace_mega_plain(*sargs, **skw)
        torch.cuda.synchronize()
        plain_s = time.perf_counter() - t0
        err = _hold_mega(f"{label} packets 0-{MEGA_PACKETS - 1}", got, want,
                         rays, rays_plain)
        worst, ms_case, plain_case = results["mega"]["trace_mega"]
        results["mega"]["trace_mega"] = (max(worst, err), ms_case,
                                         plain_case)
        print(f"{label} trace_mega on all {n} lanes: {ms:.1f} ms, "
              f"{int(rays_full)} rays ({int(rays_full) / ms / 1e3:.1f} "
              f"Mrays/s); trace_mega_plain on {m} lanes: {plain_s:.1f} s")


# The megakernel rows of the JAX bench (bench.py:186-225, 352-371) at their
# published sizes: (name, CLI arguments, frame batch, frames).
MEGA_RUNS = (
    ("bathroom_mega", ["proc:bathroom", "--width", "1280", "--height", "720",
                       "--microfacet", "beckmann"], 64, 128),
    ("table_mega", ["proc:table", "--width", "800", "--height", "600",
                    "--max-bounces", "64"], 128, 128),
    ("table_direct_mega", ["proc:table", "--width", "800", "--height", "600",
                           "--integrator", "direct"], 8, 16),
)
# Phase 7 holds the kernel to its plain version on this many packets of
# each row's first chunk.
MEGA_PACKETS = 2


def _mega_argv(args, batch: int, frames: int):
    """The CLI arguments of a MEGA_RUNS row: black sky, one chunk."""
    return args + ["--device", "cuda", "--megakernel", "on", "--frame-batch",
                   str(batch), "--spp", str(frames), "--skybox",
                   "GENERATE COLOR BLACK", "--bvh-builder", "cpp", "--chunk",
                   "2097152"]


def render_mega_path(tmp: str):
    """Phase 8: the megakernel path through the CLI. Returns per-run stats."""
    import numpy as np

    from gpupathtracer_tpu_torch import cli
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops import megakernel as mk

    stats = {}
    for name, args, batch, frames in MEGA_RUNS:
        png = os.path.join(tmp, f"{name}.png")
        hdr = os.path.join(tmp, f"{name}.npy")
        sj = os.path.join(tmp, f"{name}.json")
        before = mk.LAUNCHES["trace_mega"]
        rc = cli.main(_mega_argv(args, batch, frames) + [
            "--out", png, "--hdr-out", hdr, "--stats-json", sj])
        if rc != 0:
            raise AssertionError(f"[{name}] CLI returned {rc}")
        with open(png, "rb") as f:
            if f.read(8) != b"\x89PNG\r\n\x1a\n":
                raise AssertionError(f"[{name}] {png} is not a PNG")
        film = np.load(hdr)
        w, h = int(args[2]), int(args[4])
        if film.shape != (h, w, 3):
            raise AssertionError(f"[{name}] film shape {film.shape}")
        if not np.isfinite(film).all() or not (film > 0).any():
            raise AssertionError(f"[{name}] film is not finite and nonzero")
        if mk.LAUNCHES["trace_mega"] <= before:
            raise AssertionError(f"[{name}] never launched the megakernel")
        if any(kt.LAUNCHES.values()):
            raise AssertionError(f"[{name}] fell back to the wavefront: "
                                 f"{kt.LAUNCHES}")
        with open(sj) as f:
            s = json.load(f)
        samples = frames * batch
        print(f"[{name}] {w}x{h}, {frames} frames x {batch} samples: "
              f"{s['render_seconds'] / samples:.5f} s/sample, "
              f"{s['render_seconds'] / frames:.3f} s/frame, "
              f"{s['mrays_per_sec']:.1f} Mrays/s, {s['rays']} rays, "
              f"{mk.LAUNCHES['trace_mega'] - before} megakernel launches, "
              f"film mean {float(film.mean()):.4f}")
        stats[name] = s
    return stats


def mega_vs_wavefront(device) -> None:
    """Phase 9: the two integrators' films agree in the mean (the random
    streams differ, so the agreement is statistical)."""
    from gpupathtracer_tpu_torch.render import Renderer

    means = {}
    for mode in ("on", "off"):
        cfg = _scene_cfg("table", 200, 150, skybox="GENERATE COLOR BLACK",
                         max_bounces=64, frame_batch=64, megakernel=mode)
        r = Renderer(cfg, device)
        if r.use_mega != (mode == "on"):
            raise AssertionError(f"megakernel={mode}: use_mega={r.use_mega}")
        r.render_frame(sync=True)
        means[mode] = float(r.film_hdr().mean())
    rel = abs(means["on"] - means["off"]) / means["off"]
    print(f"[mega vs wavefront] table 200x150, 64 bounces, 64 spp: film "
          f"mean {means['on']:.5f} (megakernel) vs {means['off']:.5f} "
          f"(wavefront), {rel:.2%} apart (bound 2%)")
    if rel > 0.02:
        raise AssertionError("megakernel and wavefront means differ by more "
                             "than 2%")


def _reset_launches() -> None:
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops import megakernel as mk

    for counts in (kt.LAUNCHES, mk.LAUNCHES):
        for k in counts:
            counts[k] = 0


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "gpupathtracer_tpu_torch")):
        print("chip_smoke.py: gpupathtracer_tpu_torch/ is missing; run this "
              "from the root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
    # The C++ SBVH builder caches its library here, inside the checkout.
    os.environ.setdefault("GPT_TPU_CACHE", os.path.join(
        ROOT, "gpupathtracer_tpu_torch", "_build", "sbvh"))
    import torch

    print(f"python {sys.version.split()[0]}, torch {torch.__version__}, "
          f"CUDA {torch.version.cuda}")
    if not torch.cuda.is_available():
        print("chip_smoke.py: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    print(smi)
    device = torch.device("cuda", 0)

    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops import megakernel as mk

    build_kernels()

    results = {}
    compare_kernels("sponza", 1920, 1080, device, results)
    compare_kernels("bathroom", 1280, 720, device, results)
    golden_check(device)

    with tempfile.TemporaryDirectory() as tmp:
        _reset_launches()
        render_main_path(tmp)
        launches = dict(kt.LAUNCHES)
    print(f"[main path] kernel launches: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {k}")

    compare_mega(device, results)
    compare_mega_rows(device, results)
    with tempfile.TemporaryDirectory() as tmp:
        _reset_launches()
        render_mega_path(tmp)
        launches["trace_mega"] = mk.LAUNCHES["trace_mega"]
        print(f"[megakernel path] kernel launches: "
              f"{dict(kt.LAUNCHES, **mk.LAUNCHES)}")
    mega_vs_wavefront(device)

    kernels = []
    for case, k in (("sponza", "trace_closest"), ("sponza", "trace_anyhit"),
                    ("mega", "trace_mega")):
        err, ms, plain_ms = results[case][k]
        kernels.append({"name": k, "route": "cuda", "source": SOURCES[k],
                        "replaces": REPLACES[k], "launches": launches[k],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms})
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
