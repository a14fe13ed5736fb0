#!/usr/bin/env python3
"""Smoke check of gpupathtracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and g++. Phases, each of which raises on failure:

  1. versions and the card's name and power limit; CUDA must be present;
  2. build the MT-leaf traversal kernel (csrc/traverse.cu), the cluster
     traversal kernel (csrc/cluster_traverse.cu) and the megakernel
     (csrc/megakernel.cu) with nvcc, all at once; ptxas registers, stack
     frame and spills of every instantiation;
  3. each MT-leaf entry point against its plain torch version on the
     card, on the sponza and bathroom tables, with 65,536 camera rays plus
     65,536 random-direction rays from surface points, about 10% of lanes
     inactive: prim and occluded equal, t/u/v bitwise equal; kernel and
     plain times by CUDA events;
  4. each cluster entry point against its plain version on the sponza and
     bathroom cluster tables (cluster_tris = 128) with phase 3's rays:
     t/prim/u/v and occluded bitwise equal; times beside phase 3's;
  5. the golden recipe of tests/test_golden.py (cornell, 32x32, 8 spp) on
     the card against tests/golden/cornell_32_8spp.npz;
  6. the main path through the CLI: proc:sponza 1920x1080 with 64 bounces
     and proc:bathroom 1280x720 (Beckmann, default DoF camera), 4 spp
     each, with the C++ SBVH; films finite and nonzero, PNGs written, and
     both MT entry points launched by these renders;
  7. the cluster path through the CLI, the JAX bench's cluster rows:
     bathroom 1280x720 (Beckmann, DoF) at 4 spp and sponza 1920x1080 with
     64 bounces at 1 spp, --cluster-tris 128; both cluster entry points
     launched and neither MT entry point;
  8. the megakernel against its plain torch version on the card: bathroom
     256x144 (Beckmann, default DoF camera, 64 bounces) at 1 spp and with
     in-kernel regeneration at 4 spp, table 200x150 direct at 8 spp, on
     MT leaves and on cluster leaves (cluster_tris = 128): ray counts
     equal, contributions bitwise equal (at most 0.1% of lanes may
     differ, and those are printed); kernel and plain times;
  9. the megakernel against its plain version at the arguments of the
     rows of phases 10 and 11: the first chunk of each row's first frame,
     built as the Renderer builds it, runs through the kernel on all its
     lanes; its first two packets run through the kernel alone (the same
     lanes must come out) and through the plain version (held as in
     phase 8);
 10. the megakernel path through the CLI, the JAX bench's megakernel rows
     at their published sizes: bathroom 1280x720 Beckmann DoF (frame batch
     64), table 800x600 with 64 bounces (frame batch 128) and table
     800x600 direct (frame batch 8), black sky, one chunk; films finite
     and nonzero, PNGs written, the megakernel launched and no traversal
     kernel;
 11. the megakernel's cluster walks through the CLI, the bench's
     megacluster rows: bathroom 1280x720 Beckmann DoF and table 800x600
     with 64 bounces, --cluster-tris 128, at frame batch 1 and at 64 / 128;
     the cluster megakernel launched and no other kernel;
 12. the megakernel against the wavefront integrator on the card: table
     200x150, 64 bounces, 64 spp, film means within 2%;
 13. cluster leaves against MT leaves through the megakernel, the same
     render: film means within 2% (in exact arithmetic both trace the
     same hits).

The second-to-last line of stdout is a JSON object with one entry per
kernel entry point; the last line is {"ok": true, "device": {...}}. Any
failure exits nonzero before that line. Nothing here imports JAX.
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
CSRC = "gpupathtracer_tpu_torch/csrc/"
SOURCES = {"trace_closest": CSRC + "traverse.cu",
           "trace_anyhit": CSRC + "traverse.cu",
           "trace_mega": CSRC + "megakernel.cu",
           "trace_cluster_closest": CSRC + "cluster_traverse.cu",
           "trace_cluster_anyhit": CSRC + "cluster_traverse.cu",
           "trace_mega_cluster": CSRC + "megakernel.cu"}
REPLACES = {"trace_closest": "gpupathtracer_tpu/ops/pallas_traverse.py:72",
            "trace_anyhit": "gpupathtracer_tpu/ops/pallas_traverse.py:72 "
                            "(any-hit mode), "
                            "gpupathtracer_tpu/ops/pallas_traverse.py:1036",
            "trace_mega": "gpupathtracer_tpu/ops/megakernel.py:188",
            "trace_cluster_closest":
                "gpupathtracer_tpu/ops/pallas_traverse.py:307",
            "trace_cluster_anyhit":
                "gpupathtracer_tpu/ops/pallas_traverse.py:307 (any-hit mode)",
            "trace_mega_cluster": "gpupathtracer_tpu/ops/megakernel.py:188 "
                                  "(cluster=True: :416-482, :609-645, "
                                  ":1098-1104)"}
# The least time the card could take for a kernel's work (its bound): the
# larger of the FP32 operations this run's rays need over the H100's 67
# TFLOP/s outside the tensor cores and the bytes they must move over its
# 3.35 TB/s of HBM (NVIDIA's SXM data sheet, at 700 W). Operations are
# counted from the plain versions' pops (kernel_traverse.count_pops): a
# node pop slab-tests 8 children (6 FMAs, counted as 2 operations each, and
# 6 min/max per child); a Moller-Trumbore slot is about 50 operations, a
# cluster slot about 40 (6 three-term dot products, 3 adds, a division,
# 2 FMAs, the compares); the megakernel adds about 400 operations of
# shading per traced ray. Bytes, each once: of each distinct node row the
# 56 floats the walk reads (8 children's bounds and entries, 224 B; the
# rest of the 128-float row is padding), of each distinct MT leaf its used
# 48-byte slots (mt_leaf_bytes), of each distinct cluster block the 7 rows
# the leaf reads (84 * tc B), the rays in (29 B) and the results out (16 B
# closest, 1 B any-hit, 12 B per megakernel lane).
PEAK_FLOPS, PEAK_BYTES = 67e12, 3.35e12
NODE_OPS, MT_SLOT_OPS, CLUSTER_SLOT_OPS, SHADE_OPS = 8 * 18, 50, 40, 400
NODE_ROW_BYTES = 7 * 8 * 4
SECTOR = 32
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


def mt_leaf_bytes(packed: int) -> int:
    """Bytes an MT leaf's walk reads: its used 12-float slots (packed & 15
    of them, 10 to a 512-byte row), rounded up to 32-byte sectors per
    row."""
    count, nbytes = packed & 15, 0
    for first in range(0, count, 10):
        nbytes += -(-min(10, count - first) * 48 // SECTOR) * SECTOR
    return nbytes


def leaf_bytes_of(cluster_tris: int):
    """The bytes a leaf's pops read, by leaf id: mt_leaf_bytes on MT
    leaves, the 7 rows of a cluster block (84 * tc B) on cluster leaves."""
    if cluster_tris:
        return lambda _: 84 * cluster_tris
    return mt_leaf_bytes


def bound(pops: dict, *, leaf_bytes, slot_ops: int, io_bytes: int,
          extra_ops: int = 0):
    """(bound in ms, "bytes" or "operations") of a kernel's work from its
    plain version's pop counts (see PEAK_FLOPS); ``leaf_bytes`` maps a
    distinct leaf id of the counts to the bytes its pops read."""
    ops = (pops.get("node", 0) * NODE_OPS + pops.get("slots", 0) * slot_ops
           + extra_ops)
    nbytes = (len(pops.get("node_ids", ())) * NODE_ROW_BYTES
              + sum(map(leaf_bytes, pops.get("leaf_ids", ()))) + io_bytes)
    t_ops, t_bytes = ops / PEAK_FLOPS, nbytes / PEAK_BYTES
    return (1e3 * max(t_ops, t_bytes),
            "operations" if t_ops >= t_bytes else "bytes")


def compare_kernels(name: str, width: int, height: int, device, results):
    """Phase 3 for one scene: each entry point against its plain version.
    Returns the rays (o, d, t_occ, active) for phase 4."""
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

    pops_c, pops_a = {}, {}
    got = kt.closest(rows, o, d, far, on, **kw)
    want = kt.closest_plain(rows, o, d, far, on, pops=pops_c, **kw)
    err_c = _hold_hits(f"[{name}] trace_closest", got, want)
    hit = want[1] >= 0
    occ = kt.anyhit(rows, o, d, t_occ, on, **kw)
    occ_want = kt.anyhit_plain(rows, o, d, t_occ, on, pops=pops_a, **kw)
    err_a = _hold_occluded(f"[{name}] trace_anyhit", occ, occ_want)

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
    results[name] = {
        "trace_closest": (err_c, ms_c, plain_c, *bound(
            pops_c, leaf_bytes=mt_leaf_bytes, slot_ops=MT_SLOT_OPS,
            io_bytes=n * 45)),
        "trace_anyhit": (err_a, ms_a, plain_a, *bound(
            pops_a, leaf_bytes=mt_leaf_bytes, slot_ops=MT_SLOT_OPS,
            io_bytes=n * 30))}
    _print_bounds(name, results[name])
    return o, d, t_occ, on


def _print_bounds(name, entries):
    for k, (_, ms, _, b_ms, by) in entries.items():
        print(f"[{name}] {k} bound {b_ms:.4f} ms ({by}), kernel at "
              f"{b_ms / ms:.1%} of it")


def _hold_hits(label, got, want) -> float:
    """Closest-hit results (t, prim, u, v) bitwise equal; returns the max
    |diff| of t, u, v over the hits."""
    import torch

    torch.cuda.synchronize()
    for field, a, b in zip("t prim u v".split(), got, want):
        if not torch.equal(_bits(a), _bits(b)):
            bad = int((_bits(a) != _bits(b)).sum())
            raise AssertionError(f"{label} {field} differs from the plain "
                                 f"version in {bad} lanes")
    hit = want[1] >= 0
    return max(float((a - b)[hit].abs().max()) if hit.any() else 0.0
               for a, b in zip((got[0], got[2], got[3]),
                               (want[0], want[2], want[3])))


def _hold_occluded(label, occ, want) -> float:
    import torch

    torch.cuda.synchronize()
    if not torch.equal(occ, want):
        raise AssertionError(f"{label} differs from the plain version in "
                             f"{int((occ != want).sum())} lanes")
    return float((occ.float() - want.float()).abs().max())


def compare_cluster(name: str, width: int, height: int, rays, device,
                    results):
    """Phase 4 for one scene: the cluster entry points against their plain
    versions on the scene's cluster table, with phase 3's rays."""
    import torch

    from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
    from gpupathtracer_tpu_torch.scene import load_scene

    cfg = _scene_cfg(name, width, height, cluster_tris=128)
    t0 = time.perf_counter()
    scene, meta = load_scene(cfg, device)
    tc = scene.cluster_rows.shape[1] // 3
    print(f"[{name} cluster] ingest {time.perf_counter() - t0:.2f} s: "
          f"{scene.cluster_rows.shape[0] // 8} clusters of {tc} "
          f"({scene.cluster_rows.numel() * 4 / 1e6:.1f} MB), "
          f"{scene.node_rows.shape[0]} top-tree rows, stack depth "
          f"{meta.stack_depth}")
    o, d, t_occ, on = rays
    far = torch.full((o.shape[0],), 1e20, device=device)
    tabs = (scene.node_rows, scene.cluster_rows)
    refs = scene.cluster_refs
    kw = dict(stack_depth=meta.stack_depth)
    pops_c, pops_a = {}, {}
    got = kc.closest_cluster(*tabs, refs, o, d, far, on, **kw)
    want = kc.closest_cluster_plain(*tabs, refs, o, d, far, on, pops=pops_c,
                                    **kw)
    err_c = _hold_hits(f"[{name} cluster] trace_cluster_closest", got, want)
    occ = kc.anyhit_cluster(*tabs, o, d, t_occ, on, **kw)
    occ_want = kc.anyhit_cluster_plain(*tabs, o, d, t_occ, on, pops=pops_a,
                                       **kw)
    err_a = _hold_occluded(f"[{name} cluster] trace_cluster_anyhit", occ,
                           occ_want)
    ms_c = _events_ms(lambda: kc.closest_cluster(*tabs, refs, o, d, far, on,
                                                 **kw), 10)
    plain_c = _events_ms(lambda: kc.closest_cluster_plain(
        *tabs, refs, o, d, far, on, **kw), 1)
    ms_a = _events_ms(lambda: kc.anyhit_cluster(*tabs, o, d, t_occ, on, **kw),
                      10)
    plain_a = _events_ms(lambda: kc.anyhit_cluster_plain(
        *tabs, o, d, t_occ, on, **kw), 1)
    n = o.shape[0]
    mt = results[name]
    print(f"[{name} cluster] {n} rays: bitwise equal to the plain versions; "
          f"hit rate {float((want[1] >= 0).float().mean()):.3f}, occluded "
          f"{float(occ.float().mean()):.3f}; pops per ray: closest "
          f"{pops_c.get('node', 0) / n:.2f} node, "
          f"{pops_c.get('leaf', 0) / n:.2f} cluster")
    print(f"[{name} cluster] trace_cluster_closest {ms_c:.3f} ms "
          f"({n / ms_c / 1e3:.1f} Mrays/s; MT trace_closest "
          f"{mt['trace_closest'][1]:.3f} ms), plain {plain_c:.1f} ms")
    print(f"[{name} cluster] trace_cluster_anyhit  {ms_a:.3f} ms "
          f"({n / ms_a / 1e3:.1f} Mrays/s; MT trace_anyhit "
          f"{mt['trace_anyhit'][1]:.3f} ms), plain {plain_a:.1f} ms")
    leaf = leaf_bytes_of(tc)
    results[name + "_cluster"] = {
        "trace_cluster_closest": (err_c, ms_c, plain_c, *bound(
            pops_c, leaf_bytes=leaf, slot_ops=CLUSTER_SLOT_OPS,
            io_bytes=n * 45)),
        "trace_cluster_anyhit": (err_a, ms_a, plain_a, *bound(
            pops_a, leaf_bytes=leaf, slot_ops=CLUSTER_SLOT_OPS,
            io_bytes=n * 30))}
    _print_bounds(name + " cluster", results[name + "_cluster"])


def golden_check(device) -> None:
    """Phase 5: tests/test_golden.py's cornell recipe on the card."""
    import numpy as np

    from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
    from gpupathtracer_tpu_torch.render import Renderer

    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=32, height=32, ray_chunk=1024, max_bounces=8,
                       bvh_builder="cpp")
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


# The wavefront rows (phase 6) and the cluster rows (phase 7): name ->
# CLI arguments, spp.
MAIN_RUNS = {
    "sponza": (["proc:sponza", "--width", "1920", "--height", "1080",
                "--max-bounces", "64"], 4),
    "bathroom": (["proc:bathroom", "--width", "1280", "--height", "720",
                  "--microfacet", "beckmann"], 4),
}
CLUSTER_RUNS = {
    "bathroom_cluster": (["proc:bathroom", "--width", "1280", "--height",
                          "720", "--microfacet", "beckmann",
                          "--cluster-tris", "128"], 4),
    "sponza_cluster": (["proc:sponza", "--width", "1920", "--height", "1080",
                        "--max-bounces", "64", "--cluster-tris", "128"], 1),
}


def render_main_path(tmp: str, runs):
    """Phases 6 and 7: the wavefront CLI on each run. Returns per-run
    stats."""
    import numpy as np

    from gpupathtracer_tpu_torch import cli

    stats = {}
    for name, (args, spp) in runs.items():
        png = os.path.join(tmp, f"{name}.png")
        hdr = os.path.join(tmp, f"{name}.npy")
        sj = os.path.join(tmp, f"{name}.json")
        rc = cli.main(args + ["--device", "cuda", "--spp", str(spp),
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
        print(f"[{name}] {w}x{h}, {spp} spp: {spf:.3f} s/frame (frames "
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
            m = re.search(r"mega_kernelILi(\d)ELb(\d)ELb(\d)ELb(\d)E",
                          name)
            t = re.search(r"(trace_\w+?_kernel)", name)
            if m:
                name = (f"mega_kernel<{MODELS[int(m.group(1))]}, "
                        f"nee={m.group(2)}, regen={m.group(3)}, "
                        f"cluster={m.group(4)}>")
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

    names = ("traverse", "cluster_traverse", "megakernel")
    with ThreadPoolExecutor(len(names)) as pool:
        for name, (secs, log) in zip(names, pool.map(one, names)):
            print(f"[build] {os.path.relpath(cuda_build.source(name), ROOT)}: "
                  f"{secs:.2f} s")
            for line in _ptxas_summary(log):
                print(f"[build]   {line}")


def _mega_bound(pops: dict, rays: int, lanes: int, leaf_bytes: int,
                slot_ops: int):
    """The megakernel's bound from its plain version's pops over both walks,
    plus SHADE_OPS per traced ray; in/out about 21 bytes per lane."""
    return bound(pops, leaf_bytes=leaf_bytes, slot_ops=slot_ops,
                 io_bytes=lanes * 21, extra_ops=rays * SHADE_OPS)


def compare_mega(device, results, cluster_tris: int = 0) -> None:
    """Phase 8: trace_mega against trace_mega_plain on the same inputs, on
    MT leaves or (cluster_tris > 0) on cluster leaves."""
    import torch

    from gpupathtracer_tpu_torch import random
    from gpupathtracer_tpu_torch.math.camera import generate_image_plane
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.scene import load_scene

    entry = "trace_mega_cluster" if cluster_tris else "trace_mega"
    cases = [("bathroom", 256, 144, "beckmann", 64, 1),
             ("bathroom", 256, 144, "beckmann", 64, 4),
             ("table", 200, 150, "trowbridge_reitz", 0, 8)]
    scenes, errs = {}, []
    for name, w, h, model, mb, spp in cases:
        cfg = _scene_cfg(name, w, h, skybox="GENERATE COLOR BLACK",
                         microfacet=model, cluster_tris=cluster_tris)
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
        label = (f"[{entry} {name} {w}x{h} {model} max_bounces={mb} "
                 f"spp={spp}]")
        got, rays = mk.trace_mega(*args, **kw)
        pops = {}
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        want, rays_plain = mk.trace_mega_plain(*args, pops=pops, **kw)
        end.record()
        torch.cuda.synchronize()
        plain_ms = start.elapsed_time(end)
        errs.append(_hold_mega(label, got, want, rays, rays_plain))
        ms = _events_ms(lambda: mk.trace_mega(*args, **kw), 3)
        slot_ops = CLUSTER_SLOT_OPS if cluster_tris else MT_SLOT_OPS
        b_ms, by = _mega_bound(pops, int(rays), args[7].shape[0],
                               leaf_bytes_of(cluster_tris), slot_ops)
        print(f"{label} {entry} {ms:.2f} ms ({int(rays) / ms / 1e3:.1f} "
              f"Mrays/s), trace_mega_plain {plain_ms:.1f} ms (with pop "
              f"counting); bound {b_ms:.4f} ms ({by}), kernel at "
              f"{b_ms / ms:.1%} of it")
        if (name, spp) == ("bathroom", 4):  # the regenerating path's case
            timed = (ms, plain_ms, b_ms, by)
    results["mega"][entry] = (max(errs), *timed)


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


def compare_mega_rows(device, results, runs) -> None:
    """Phase 9: for each row of ``runs`` (phase 10's or 11's), the first
    chunk of its first frame as the Renderer builds it (same
    configuration, lanes, key and arguments). The kernel runs on all the
    chunk's lanes, and on its first MEGA_PACKETS packets alone, which must
    give the same lanes; the plain version runs on those packets."""
    import torch

    from gpupathtracer_tpu_torch import cli
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    from gpupathtracer_tpu_torch.render import Renderer

    for name, args, batch, frames in runs:
        cfg = cli.build_config(cli.parse_args(
            _mega_argv(args, batch, frames)))
        r = Renderer(cfg, device)
        if not r.use_mega:
            raise AssertionError(f"[{name}] the scene is not mega-eligible")
        entry = "trace_mega_cluster" if cfg.cluster_tris else "trace_mega"
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
        label = (f"[{entry} {name} first chunk, {statics['model']}, "
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
        worst, *rest = results["mega"][entry]
        results["mega"][entry] = (max(worst, err), *rest)
        print(f"{label} {entry} on all {n} lanes: {ms:.1f} ms, "
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
# The bench's megacluster rows (bathroom, bench.py:382-387, frame batch 1)
# with their frame-batched counterparts, and table's (bench.py:219-221).
MEGACLUSTER_RUNS = (
    ("bathroom_megacluster", ["proc:bathroom", "--width", "1280", "--height",
                              "720", "--microfacet", "beckmann",
                              "--cluster-tris", "128"], 1, 32),
    ("bathroom_megacluster64", ["proc:bathroom", "--width", "1280",
                                "--height", "720", "--microfacet",
                                "beckmann", "--cluster-tris", "128"], 64, 16),
    ("table_megacluster", ["proc:table", "--width", "800", "--height", "600",
                           "--max-bounces", "64", "--cluster-tris", "128"],
     1, 32),
    ("table_megacluster128", ["proc:table", "--width", "800", "--height",
                              "600", "--max-bounces", "64", "--cluster-tris",
                              "128"], 128, 16),
)
# Phase 9 holds the kernel to its plain version on this many packets of
# each row's first chunk.
MEGA_PACKETS = 2


def _mega_argv(args, batch: int, frames: int):
    """The CLI arguments of a megakernel row: black sky, one chunk."""
    return args + ["--device", "cuda", "--megakernel", "on", "--frame-batch",
                   str(batch), "--spp", str(frames), "--skybox",
                   "GENERATE COLOR BLACK", "--bvh-builder", "cpp", "--chunk",
                   "2097152"]


def render_mega_path(tmp: str, runs, entry: str):
    """Phases 10 and 11: the megakernel path through the CLI; ``entry``
    must launch and no other kernel. Returns per-run stats."""
    import numpy as np

    from gpupathtracer_tpu_torch import cli

    stats = {}
    for name, args, batch, frames in runs:
        png = os.path.join(tmp, f"{name}.png")
        hdr = os.path.join(tmp, f"{name}.npy")
        sj = os.path.join(tmp, f"{name}.json")
        before = _launches()[entry]
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
        counts = _launches()
        if counts[entry] <= before:
            raise AssertionError(f"[{name}] never launched {entry}")
        others = {k: v for k, v in counts.items() if k != entry and v}
        if others:
            raise AssertionError(f"[{name}] launched other kernels: {others}")
        with open(sj) as f:
            s = json.load(f)
        samples = frames * batch
        print(f"[{name}] {w}x{h}, {frames} frames x {batch} samples: "
              f"{s['render_seconds'] / samples:.5f} s/sample, "
              f"{s['render_seconds'] / frames:.4f} s/frame, "
              f"{s['mrays_per_sec']:.1f} Mrays/s, {s['rays']} rays, "
              f"{counts[entry] - before} {entry} launches, "
              f"film mean {float(film.mean()):.4f}")
        stats[name] = s
    return stats


def mega_vs_wavefront(device) -> None:
    """Phase 12: the two integrators' films agree in the mean (the random
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


def cluster_vs_mt(device) -> None:
    """Phase 13: the same megakernel render on cluster and on MT leaves.
    Both trace the same hits in exact arithmetic and draw the same random
    numbers; the films' means must agree within 2%."""
    from gpupathtracer_tpu_torch.render import Renderer

    means = {}
    for tc in (128, 0):
        cfg = _scene_cfg("table", 200, 150, skybox="GENERATE COLOR BLACK",
                         max_bounces=64, frame_batch=64, megakernel="on",
                         cluster_tris=tc)
        r = Renderer(cfg, device)
        if not r.use_mega or (r.scene.cluster_rows is not None) != bool(tc):
            raise AssertionError(f"cluster_tris={tc}: not the megakernel "
                                 f"on the expected leaves")
        r.render_frame(sync=True)
        means[tc] = float(r.film_hdr().mean())
    rel = abs(means[128] - means[0]) / means[0]
    print(f"[cluster vs MT] table 200x150, 64 bounces, 64 spp, megakernel: "
          f"film mean {means[128]:.6f} (cluster leaves) vs {means[0]:.6f} "
          f"(MT leaves), {rel:.4%} apart (bound 2%)")
    if rel > 0.02:
        raise AssertionError("cluster and MT means differ by more than 2%")


def _counters():
    from gpupathtracer_tpu_torch.ops import kernel_cluster as kc
    from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
    from gpupathtracer_tpu_torch.ops import megakernel as mk
    return kt.LAUNCHES, kc.LAUNCHES, mk.LAUNCHES


def _launches() -> dict:
    """Every kernel entry point's launch count since the last reset."""
    out = {}
    for counts in _counters():
        out.update(counts)
    return out


def _reset_launches() -> None:
    for counts in _counters():
        for k in counts:
            counts[k] = 0


def _drive(label: str, want, fn):
    """Sets every launch count to 0, runs fn (one path), reads the counts:
    each entry point in ``want`` must have launched and no other."""
    _reset_launches()
    fn()
    counts = _launches()
    print(f"[{label}] kernel launches: {counts}")
    for k in want:
        if counts[k] <= 0:
            raise AssertionError(f"the {label} never launched {k}")
    others = {k: v for k, v in counts.items() if k not in want and v}
    if others:
        raise AssertionError(f"the {label} launched {others}")
    return {k: counts[k] for k in want}


def main() -> int:
    if not os.path.isdir(os.path.join(ROOT, "gpupathtracer_tpu_torch")):
        print("chip_smoke.py: gpupathtracer_tpu_torch/ is missing; run this "
              "from the root of a checkout of the repository", file=sys.stderr)
        return 2
    sys.path.insert(0, ROOT)
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
    t_start = time.perf_counter()

    build_kernels()

    results = {"mega": {}}
    for name, w, h in (("sponza", 1920, 1080), ("bathroom", 1280, 720)):
        rays = compare_kernels(name, w, h, device, results)
        compare_cluster(name, w, h, rays, device, results)
        del rays
    golden_check(device)

    launches = {}
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(_drive(
            "main path", ("trace_closest", "trace_anyhit"),
            lambda: render_main_path(tmp, MAIN_RUNS)))
        launches.update(_drive(
            "cluster path", ("trace_cluster_closest", "trace_cluster_anyhit"),
            lambda: render_main_path(tmp, CLUSTER_RUNS)))

    compare_mega(device, results)
    compare_mega(device, results, cluster_tris=128)
    compare_mega_rows(device, results, MEGA_RUNS + MEGACLUSTER_RUNS)
    with tempfile.TemporaryDirectory() as tmp:
        launches.update(_drive(
            "megakernel path", ("trace_mega",),
            lambda: render_mega_path(tmp, MEGA_RUNS, "trace_mega")))
        launches.update(_drive(
            "megacluster path", ("trace_mega_cluster",),
            lambda: render_mega_path(tmp, MEGACLUSTER_RUNS,
                                     "trace_mega_cluster")))
    mega_vs_wavefront(device)
    cluster_vs_mt(device)

    kernels = []
    for case, k in (("sponza", "trace_closest"), ("sponza", "trace_anyhit"),
                    ("mega", "trace_mega"),
                    ("sponza_cluster", "trace_cluster_closest"),
                    ("sponza_cluster", "trace_cluster_anyhit"),
                    ("mega", "trace_mega_cluster")):
        err, ms, plain_ms, bound_ms, bound_by = results[case][k]
        kernels.append({"name": k, "route": "cuda", "source": SOURCES[k],
                        "replaces": REPLACES[k], "launches": launches[k],
                        "max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
                        "bound_ms": bound_ms, "bound_by": bound_by,
                        "library_ms": None})
    print(f"[smoke] {time.perf_counter() - t_start:.1f} s")
    print(smi)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
