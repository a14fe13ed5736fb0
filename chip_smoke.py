#!/usr/bin/env python3
"""Smoke check of gpupathtracer_tpu_torch on one CUDA card.

    python3 chip_smoke.py

Run from the root of a checkout on a machine with an NVIDIA H100 (sm_90a),
nvcc and g++. Phases, each of which raises on failure:

  1. versions and the card's name and power limit; CUDA must be present;
  2. build the traversal kernel (csrc/traverse.cu) with nvcc;
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
     both kernel entry points launched by these renders.

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
SOURCE = "gpupathtracer_tpu_torch/csrc/traverse.cu"
REPLACES = {"trace_closest": "gpupathtracer_tpu/ops/pallas_traverse.py:72",
            "trace_anyhit": "gpupathtracer_tpu/ops/pallas_traverse.py:72 "
                            "(any-hit mode), "
                            "gpupathtracer_tpu/ops/pallas_traverse.py:1036"}


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

    t0 = time.perf_counter()
    _, ptxas = kt.build()
    print(f"[build] {SOURCE}: {time.perf_counter() - t0:.2f} s")
    for line in ptxas.splitlines():
        if "registers" in line or "stack frame" in line:
            print(f"[build] {line.strip()}")

    results = {}
    compare_kernels("sponza", 1920, 1080, device, results)
    compare_kernels("bathroom", 1280, 720, device, results)
    golden_check(device)

    with tempfile.TemporaryDirectory() as tmp:
        for k in kt.LAUNCHES:
            kt.LAUNCHES[k] = 0
        render_main_path(tmp)
        launches = dict(kt.LAUNCHES)
    print(f"[main path] kernel launches: {launches}")
    for k, n in launches.items():
        if n <= 0:
            raise AssertionError(f"the main path never launched {k}")

    kernels = []
    for k in ("trace_closest", "trace_anyhit"):
        err, ms, plain_ms = results["sponza"][k]
        kernels.append({"name": k, "route": "cuda", "source": SOURCE,
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
