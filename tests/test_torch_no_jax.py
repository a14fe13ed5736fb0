"""The port runs where neither JAX nor Pillow nor the JAX package is
installed: a subprocess that refuses jax, PIL and ``gpupathtracer_tpu``
renders proc:cornell on the CPU to a PNG, with the wavefront integrator,
with the megakernel, on cluster leaves, with treelet-sorted bounce rays,
with the reference and AO integrators, a 16-wide table with treelet-binned
bounce rays, a generated textured town with mips (its maps written and
read by the port's own PNG code, then swapped for the committed JPEG
fixtures, read by its own JPEG decoder; the WebP fixtures decode to their
manifest's pixels), and a mirror and glass OBJ with the ld
sampler and light-end shadow rays (and it loads the demo glTF and plots a
sampler's points), and the PNGs are decoded here with zlib alone; it also
saves and resumes a checkpoint, reads a scene warm from a temporary disk
cache, runs the viewer's bench and renders with the packet and per-ray
traversals, and two gloo ranks render it through the scene partition
(the ranks refuse jax and the JAX package on their own:
parallel/launch.py); a rank cannot import jax. No module of the port,
not chip_smoke.py, not a tool of the port and not the ranks' helper
(tests/torch_dist_ranks.py) names the JAX package in an import."""

import ast
import glob
import os
import struct
import subprocess
import sys
import zlib

import numpy as np

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

SCRIPT = r"""
import importlib.abc
import sys


BLOCKED = ("jax", "jaxlib", "PIL", "gpupathtracer_tpu")


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Refuse())
sys.path.insert(0, sys.argv[1])
from gpupathtracer_tpu_torch import cli

rc = cli.main(["proc:cornell", "--device", "cpu", "--spp", "1",
               "--width", "16", "--height", "16", "--out", sys.argv[2]])
rc = rc or cli.main(["proc:cornell", "--device", "cpu", "--spp", "1",
                     "--width", "16", "--height", "16", "--megakernel", "on",
                     "--frame-batch", "4", "--out", sys.argv[3]])
rc = rc or cli.main(["proc:cornell", "--device", "cpu", "--spp", "1",
                     "--width", "16", "--height", "16", "--cluster-tris",
                     "128", "--out", sys.argv[4]])
for integrator, out in (("reference", sys.argv[5]), ("ao", sys.argv[6])):
    rc = rc or cli.main(["proc:cornell", "--device", "cpu", "--spp", "1",
                         "--width", "16", "--height", "16", "--max-bounces",
                         "4", "--integrator", integrator, "--out", out])
from gpupathtracer_tpu_torch.scene.samplegen import generate_textured_town
town = generate_textured_town(sys.argv[8], houses=2, trees=1,
                              sphere_subdiv=1)
rc = rc or cli.main([town, "--device", "cpu", "--spp", "1", "--width", "16",
                     "--height", "16", "--max-bounces", "2", "--mip-levels",
                     "4", "--position", "0,9,-26", "--rotation",
                     "3.14159,-0.28", "--out", sys.argv[7]])
# The town again, its maps the committed JPEG fixtures (the port's own JPEG
# decoder; PIL is refused).
import os
import shutil
fixtures = os.path.join(sys.argv[1], "tests", "golden", "images")
for name in ("checker", "bricks", "roof", "foliage"):
    shutil.copy(os.path.join(fixtures, name + ".jpg"), sys.argv[8])
with open(os.path.join(sys.argv[8], "town.mtl")) as f:
    mtl = f.read()
with open(os.path.join(sys.argv[8], "town.mtl"), "w") as f:
    f.write(mtl.replace(".png", ".jpg"))
from gpupathtracer_tpu_torch.scene import textures
_, _, jslots, _ = textures.build_atlas(
    ["checker.jpg", "bricks.jpg", "roof.jpg", "foliage.jpg"], sys.argv[8])
rc = rc or cli.main([town, "--device", "cpu", "--spp", "1", "--width", "16",
                     "--height", "16", "--max-bounces", "2", "--mip-levels",
                     "4", "--position", "0,9,-26", "--rotation",
                     "3.14159,-0.28", "--out",
                     os.path.join(sys.argv[8], "town_jpeg.png")])
print("JPEGTOWN", sorted(jslots))
# The committed WebP fixtures through the port's WebP decoder (PIL refused).
import hashlib
import json
from gpupathtracer_tpu_torch.utils import io as port_io
with open(os.path.join(fixtures, "manifest.json")) as f:
    manifest = json.load(f)
webp = [k for k, e in sorted(manifest.items()) if e["format"] == "WEBP"]
held = 0
for k in webp:
    with open(os.path.join(fixtures, manifest[k]["file"]), "rb") as f:
        px = port_io.decode_image(f.read(), k)
    held += (hashlib.sha256(px.tobytes()).hexdigest()
             == manifest[k]["pixels_sha256"])
print("WEBP", len(webp), held)
# The simple formats' fixtures (PNM, QOI, ICO, CUR, SGI, PCX, DIB) too.
simple = [k for k, e in sorted(manifest.items()) if e["format"] in (
    "PPM", "QOI", "ICO", "CUR", "SGI", "PCX", "DIB")]
held = 0
for k in simple:
    with open(os.path.join(fixtures, manifest[k]["file"]), "rb") as f:
        px = port_io.decode_image(f.read(), k)
    held += (hashlib.sha256(px.tobytes()).hexdigest()
             == manifest[k]["pixels_sha256"])
print("SIMPLE", len(simple) > 20, len(simple) - held)
# The treelet-sorted bounce traversal, with the sort forced on at 16x16.
import math
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.render import Renderer
cfg = RenderConfig(scene_path="proc:cornell", width=16, height=16,
                   max_bounces=4, bounce_traversal="tsort", treelet_min=1)
cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                          fov=math.radians(45), aspect=1.0)
r = Renderer(cfg, "cpu")
r.render_frame()
print("TSORT", r.bounce_traversal, bool(r.film_hdr().max() > 0))
# A 16-wide table, bounce rays binned by treelet from the first bounce.
from gpupathtracer_tpu_torch.ops import treelet
cfg = RenderConfig(scene_path="proc:cornell", width=16, height=16,
                   max_bounces=4, bounce_traversal="treelet", treelet_min=1,
                   wide_arity=16)
cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                          fov=math.radians(45), aspect=1.0)
r = Renderer(cfg, "cpu")
r.render_frame()
r.save_screenshot(sys.argv[9])
print("TREELET", r.scene.arity, treelet.TRACES["closest"] > 0,
      treelet.TRACES["rounds"] > 0)
# A mirror floor (illum 5) and a glass pane (illum 7) under a light, with
# the ld sampler and light-end shadow rays; the glTF loader on the demo
# scene; the sampler plots.
import os
folder = os.path.dirname(sys.argv[10])
with open(os.path.join(folder, "m.mtl"), "w") as f:
    f.write("newmtl mirror\nKd 0.9 0.9 0.9\nillum 5\n"
            "newmtl glass\nKd 1 1 1\nNi 1.5\nillum 7\n"
            "newmtl light\nKd 0 0 0\nKe 10 10 10\n")
with open(os.path.join(folder, "d.obj"), "w") as f:
    f.write("mtllib m.mtl\n"
            "v -5 0 -5\nv 5 0 -5\nv 5 0 5\nv -5 0 5\n"
            "v -1 4 -1\nv 1 4 -1\nv 1 4 1\nv -1 4 1\n"
            "v -2 0 1\nv 2 0 1\nv 2 3 1\nv -2 3 1\n"
            "vn 0 1 0\nvn 0 -1 0\nvn 0 0 -1\n"
            "usemtl mirror\nf 1//1 4//1 3//1 2//1\n"
            "usemtl light\nf 5//2 6//2 7//2 8//2\n"
            "usemtl glass\nf 9//3 10//3 11//3 12//3\n")
rc = rc or cli.main([os.path.join(folder, "d.obj"), "--device", "cpu",
                     "--spp", "1", "--width", "16", "--height", "16",
                     "--max-bounces", "4", "--sampler", "ld", "--shadow-rev",
                     "--position", "0,2.5,-7", "--rotation", "3.14159,-0.3",
                     "--skybox", "GENERATE COLOR BLACK",
                     "--out", sys.argv[10]])
from gpupathtracer_tpu_torch.scene import gltf, load_scene
from gpupathtracer_tpu_torch.scene.samplegen import write_demo_gltf
from gpupathtracer_tpu_torch.utils import sampler_viz
mesh, mats = gltf.load_gltf(write_demo_gltf(os.path.join(folder, "demo.gltf")))
_, meta = load_scene(RenderConfig(scene_path=os.path.join(folder, "d.obj")),
                     "cpu")
sampler_viz.plot_points(sampler_viz.halton_set(64), size=16,
                        path=os.path.join(folder, "halton.png"))
print("DELTA", meta.has_delta, mesh.triangles.shape[0])
# A checkpoint saved and resumed, the scene warm from a temporary disk
# cache (the checkpoint's config enables it), the viewer's bench, and the
# films of the packet and per-ray traversals against the default one.
from gpupathtracer_tpu_torch.render.checkpoint import (load_checkpoint,
                                                       save_checkpoint)
from gpupathtracer_tpu_torch.render.viewer import bench_viewer
cfg = RenderConfig(scene_path="proc:cornell", width=16, height=16,
                   max_bounces=4, cache_enabled=True,
                   cache_dir=os.path.join(folder, "cache"))
r = Renderer(cfg, "cpu")
r.render_frame()
r2 = load_checkpoint(save_checkpoint(r, os.path.join(folder, "r.ckpt")),
                     "cpu")
r.render_frame()
r2.render_frame()
resumed = bool((r2.accum == r.accum).all())
fps, _ = bench_viewer(r2, frames=2, warmup=1)
films = []
for trav in ("auto", "packet", "perray"):
    cfg.traversal = trav
    rt = Renderer(cfg, "cpu", scene=r.scene, meta=r.meta)
    rt.render_frame()
    films.append(rt.film_hdr())
print("A15", resumed, fps > 0, os.listdir(cfg.cache_dir)[0][:6],
      all((f == films[0]).all() for f in films))
# Two gloo ranks (processes of their own, which refuse jax and the JAX
# package themselves) render cornell through the scene partition.
sys.path.insert(0, os.path.join(sys.argv[1], "tests"))
import torch_dist_ranks
from gpupathtracer_tpu_torch.parallel.launch import run_ranks
ranks = run_ranks(torch_dist_ranks.renderer_frames, 2, "gloo", "cpu",
                  args=(torch_dist_ranks.cornell_config(
                      partition_chips=2).to_json(), 1), timeout_s=240)
print("A18", len(ranks), all(r["film"].max() > 0 for r in ranks),
      bool((ranks[0]["film"] == ranks[1]["film"]).all()))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", loaded)
sys.exit(rc)
"""


def _read_png(path):
    with open(path, "rb") as f:
        data = f.read()
    assert data[:8] == b"\x89PNG\r\n\x1a\n"
    pos, chunks = 8, {}
    while pos < len(data):
        (n,) = struct.unpack(">I", data[pos:pos + 4])
        tag = data[pos + 4:pos + 8]
        body = data[pos + 8:pos + 8 + n]
        (crc,) = struct.unpack(">I", data[pos + 8 + n:pos + 12 + n])
        assert zlib.crc32(tag + body) & 0xFFFFFFFF == crc
        chunks[tag] = chunks.get(tag, b"") + body
        pos += 12 + n
    w, h, depth, ctype = struct.unpack(">IIBB", chunks[b"IHDR"][:10])
    assert (depth, ctype) == (8, 2)
    raw = np.frombuffer(zlib.decompress(chunks[b"IDAT"]), np.uint8)
    raw = raw.reshape(h, 1 + 3 * w)
    assert (raw[:, 0] == 0).all()  # filter type "none" on every row
    return raw[:, 1:].reshape(h, w, 3)


def test_port_renders_without_jax_or_pil(tmp_path):
    outs = [str(tmp_path / f"{name}.png")
            for name in ("cornell", "mega", "cluster", "reference", "ao",
                         "town")]
    wide = str(tmp_path / "wide16_treelet.png")
    delta = str(tmp_path / "delta" / "delta_ld_rev.png")
    os.makedirs(os.path.dirname(delta))
    proc = subprocess.run([sys.executable, "-c", SCRIPT, REPO, *outs,
                           str(tmp_path / "town"), wide, delta],
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout
    assert "TSORT tsort True" in proc.stdout
    assert "TREELET 16 True True" in proc.stdout
    assert "DELTA True 24" in proc.stdout
    assert "A15 True True scene_ True" in proc.stdout
    assert "A18 2 True True" in proc.stdout
    assert ("JPEGTOWN ['bricks.jpg', 'checker.jpg', 'foliage.jpg', "
            "'roof.jpg']") in proc.stdout
    assert "WEBP 9 9" in proc.stdout
    assert "SIMPLE True 0" in proc.stdout
    for out in outs + [wide, delta, str(tmp_path / "town" /
                                        "town_jpeg.png")]:
        img = _read_png(out)
        assert img.shape == (16, 16, 3)
        assert img.max() > 0


def _imported_modules(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (alias.name for alias in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module


def test_port_sources_never_import_the_jax_package():
    paths = sorted(glob.glob(os.path.join(REPO, "gpupathtracer_tpu_torch",
                                          "**", "*.py"), recursive=True))
    paths.append(os.path.join(REPO, "chip_smoke.py"))
    paths += sorted(glob.glob(os.path.join(REPO, "tools", "torch_*.py")))
    paths.append(os.path.join(REPO, "tests", "torch_dist_ranks.py"))
    names = {os.path.basename(p) for p in paths}
    assert {"tsort.py", "dense_intersect.py", "subpacket_traverse.py",
            "torch_kernel_bench.py", "roofline.py", "torch_roofline.py",
            "torch_mega_profile.py", "torch_bench.py", "reference.py",
            "ao.py", "texture.py", "textures.py", "samplegen.py",
            "gltf.py", "sampler_viz.py", "checkpoint.py", "viewer.py",
            "debug.py", "cache.py", "packet_traverse.py", "comm.py",
            "mesh.py", "partition.py", "launch.py",
            "torch_partition_bench.py", "torch_dist_ranks.py",
            "webp.py", "pnm.py", "qoi.py", "ico.py", "sgi.py",
            "pcx.py"} <= names
    assert len(paths) > 30
    bad = [(os.path.relpath(p, REPO), m) for p in paths
           for m in _imported_modules(p)
           if m.split(".")[0] in ("gpupathtracer_tpu", "jax", "jaxlib")]
    assert not bad
    # Nor PIL (the card's machine has none), but in the tool that writes
    # the JPEG fixtures with it, which runs beside the JAX package only.
    no_pil = [p for p in paths
              if os.path.basename(p) != "torch_image_fixtures.py"]
    assert not [(os.path.relpath(p, REPO), m) for p in no_pil
                for m in _imported_modules(p) if m.split(".")[0] == "PIL"]


TOOLS = r"""
import importlib.abc
import importlib.util
import os
import sys


BLOCKED = ("jax", "jaxlib", "PIL", "gpupathtracer_tpu")


class _Refuse(importlib.abc.MetaPathFinder):
    def find_spec(self, name, path=None, target=None):
        if name.split(".")[0] in BLOCKED:
            raise ImportError(f"{name} is blocked")
        return None


sys.meta_path.insert(0, _Refuse())
sys.path.insert(0, sys.argv[1])


def tool(name):
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(sys.argv[1], "tools", name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


rates = tool("torch_roofline").run_compact(reps=1, quick=True, device="cpu")
print("RATES", sorted(k for k, v in rates.items() if v is not None))
out = tool("torch_kernel_bench").main(
    ["--device", "cpu", "--scene", "proc:cornell", "--n", "256", "--k", "128",
     "--mode", "packet,subpacket", "--multi-pop", "2", "--reps", "1",
     "--stats", "--cluster-tc", "128", "--pop-skip"])
print("STATS", sorted(k for k, v in out.items() if "pops" in v))
prof = tool("torch_mega_profile").main(
    ["--device", "cpu", "--width", "16", "--height", "16", "--max-bounces",
     "4", "--time", "--frames", "1"])
print("PROFILE", prof["rays"] > 0, prof["ns_per_pop"] > 0)
bench = tool("torch_bench").main(["--device", "cpu", "--quick"])
print("BENCH", sorted(bench["extra"]["rows"]), bench["value"] > 0)
part = tool("torch_partition_bench").main(
    ["--device", "cpu", "--scene", "proc:cornell", "--n", "256", "--chips",
     "2", "--routing", "routed", "--populations", "incoherent,anyhit",
     "--hardware", "--reps", "1", "--baseline", "--timeout", "240"])
print("PARTITION", sorted(part["populations"]), part["floor_ms"] > 0,
      all(p["whole_pops_per_ray"] > 0 for p in part["populations"].values()))
loaded = sorted(m for m in sys.modules if m.split(".")[0] in BLOCKED)
print("LOADED", loaded)
"""


def test_accounting_tools_run_without_jax():
    """tools/torch_roofline.py (run_compact), tools/torch_kernel_bench.py
    --stats --cluster-tc --pop-skip, tools/torch_mega_profile.py --time and
    tools/torch_bench.py --quick rehearse on the CPU, at a tiny size, with
    jax, PIL and the JAX package refused; run_compact returns
    tools/roofline.py's keys (but the memory sweep, which needs a card),
    the bench its quick rows."""
    proc = subprocess.run([sys.executable, "-c", TOOLS, REPO],
                          capture_output=True, text=True, timeout=600)
    assert proc.returncode == 0, proc.stderr
    assert "LOADED []" in proc.stdout
    rates = eval(proc.stdout.split("RATES ")[1].splitlines()[0])
    assert {"rtt_ms", "vpu_ilp8_teops_s", "mxu_128_f32_tflops_s",
            "mxu_128_bf16_tflops_s", "mxu_512_bf16_tflops_s",
            "mxu_cluster_shape_tflops_s", "node_pop_body_ns",
            "node_body_vpu_teops_s", "leaf_pop_body_ns",
            "leaf_body_vpu_teops_s", "cluster_body_ns_tc128",
            "cluster_body_ns_tc256", "cluster_anyhit_body_ns_tc128"} \
        <= set(rates)
    stats = eval(proc.stdout.split("STATS ")[1].splitlines()[0])
    assert {"packet@128w1:coherent", "packet@q2:incoherent",
            "subpacket@128w1:coherent", "cluster128@128w1:incoherent",
            "cluster128s@128w1:incoherent"} <= set(stats)
    assert "PROFILE True True" in proc.stdout
    rows, positive = proc.stdout.split("BENCH ")[1].splitlines()[0].rsplit(
        " ", 1)
    assert eval(rows) == sorted(["realtime_direct", "sponza_probe_default",
                                 "sponza_probe_fpair", "sponza_probe_tsort",
                                 "sponza"])
    assert positive == "True"
    assert ("PARTITION ['incoherent any-hit (tmax=20)', 'incoherent "
            "closest'] True True") in proc.stdout


def test_a_rank_refuses_jax():
    """parallel/launch.py's ranks refuse jax and the JAX package: a rank
    that imports jax fails its run, with the refusal in its log."""
    import pytest

    import torch_dist_ranks
    from gpupathtracer_tpu_torch.parallel.launch import run_ranks
    for name in ("jax", "gpupathtracer_tpu.config"):
        with pytest.raises(RuntimeError, match="is not imported by a rank"):
            run_ranks(torch_dist_ranks.import_module, 1, "gloo", "cpu",
                      args=(name,), timeout_s=60)
    assert run_ranks(torch_dist_ranks.import_module, 1, "gloo", "cpu",
                     args=("gpupathtracer_tpu_torch.parallel",),
                     timeout_s=60) == [[]]
