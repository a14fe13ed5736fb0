"""The port's wavefront render against the JAX package: the HDR golden
corpus, the JAX Renderer on a film wide enough for bounce-epoch
compaction, and the port's CLI end to end (all on the CPU, where the
traversal runs its plain torch version)."""

import json
import math
import os

import numpy as np
import pytest

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.ops.tsort import SORTED
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene.procedural import default_camera

GOLDEN_DIR = os.path.join(os.path.dirname(__file__), "golden")

# name -> (scene, microfacet, spp): tests/test_golden.py's corpus.
CORPUS = {
    "cornell_32_8spp": ("proc:cornell", "trowbridge_reitz", 8),
    "table_32_8spp": ("proc:table", "trowbridge_reitz", 8),
    "bathroom_32_8spp": ("proc:bathroom", "beckmann", 8),
}


def _cornell_camera():
    return CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                        fov=math.radians(45), aspect=1.0)


def _jax_cfg(cfg):
    """The JAX package's RenderConfig with the same fields as the port's."""
    return JaxRenderConfig.from_json(cfg.to_json())


def _outside(img, ref, tol=2e-3):
    """Pixels with a channel outside rtol = atol = tol of the reference."""
    return (np.abs(img - ref) > tol + tol * np.abs(ref)).any(-1)


@pytest.mark.parametrize("name", sorted(CORPUS))
def test_matches_hdr_golden(name):
    """tests/test_golden.py's recipe (render_golden) on the port."""
    scene, microfacet, spp = CORPUS[name]
    cfg = RenderConfig(scene_path=scene, skybox="GENERATE COLOR BLACK",
                       width=32, height=32, ray_chunk=1024, max_bounces=8,
                       microfacet=microfacet)
    if scene == "proc:cornell":
        cfg.camera = _cornell_camera()
    else:
        pos, yaw, pitch, fov, aperture, focus = default_camera(scene)
        cfg.camera = CameraConfig(position=pos, yaw=yaw, pitch=pitch,
                                  fov=math.radians(fov), aspect=1.0,
                                  aperture=aperture, focal_distance=focus)
    r = Renderer(cfg, "cpu")
    for _ in range(spp):
        r.render_frame("wavefront")
    img = r.film_hdr()
    gold = np.load(os.path.join(GOLDEN_DIR, name + ".npz"))["hdr"]
    assert img.shape == gold.shape and np.isfinite(img).all()
    # Same random streams, so the same paths: only last-place differences
    # of sin/cos/log/exp/pow remain, and these could flip a rare Russian
    # roulette decision. Measured: 0 pixels outside the golden's own
    # rtol = atol = 2e-3, max |diff| 5e-5. Held: >= 99% of pixels inside,
    # every channel mean within 0.5%.
    assert _outside(img, gold).mean() <= 0.01
    np.testing.assert_allclose(img.mean(axis=(0, 1)), gold.mean(axis=(0, 1)),
                               rtol=5e-3)


def test_matches_jax_renderer_with_compaction():
    """96x96 is the smallest film at which the compaction phases run
    (wavefront widths 9216 -> 2304 -> 2048)."""
    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=96, height=96, max_bounces=8)
    cfg.camera = _cornell_camera()
    jr = JaxRenderer(_jax_cfg(cfg))
    jr.render_frame("wavefront")
    want = np.asarray(jr.film_hdr())
    r = Renderer(cfg, "cpu")
    r.render_frame("wavefront")
    got = r.film_hdr()
    # Measured: 0 pixels outside rtol = atol = 2e-3, max |diff| 1e-4, and
    # the same number of rays traced (every path took the same bounces).
    assert _outside(got, want).mean() <= 0.01
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)),
                               rtol=5e-3)
    jr.stats.finalize()
    r.stats.finalize()
    assert r.stats.rays_traced == jr.stats.rays_traced


def test_frame_batch_and_set_camera_match_jax():
    """frame_batch=2 draws sample i of a frame from fold_in(key, i), as the
    JAX package's render_sample_batch does; set_camera starts over."""
    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=16, height=16, max_bounces=4, frame_batch=2)
    cfg.camera = _cornell_camera()
    jr = JaxRenderer(_jax_cfg(cfg))
    jr.render_frame()
    r = Renderer(cfg, "cpu")
    r.render_frame()
    assert r.num_samples == jr.num_samples == 2
    # Measured max |diff| 2.1e-6 (last-place differences, as above).
    np.testing.assert_allclose(r.film_hdr(), np.asarray(jr.film_hdr()),
                               rtol=2e-3, atol=2e-3)
    r.set_camera(CameraConfig(position=(2.0, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0))
    assert r.num_samples == 0 and not r.accum.any()
    r.render_frame()
    assert r.num_samples == 2 and np.isfinite(r.film_hdr()).all()


def test_cli_writes_png(tmp_path):
    out = tmp_path / "cornell.png"
    hdr = tmp_path / "cornell.npy"
    rc = cli.main(["proc:cornell", "--device", "cpu", "--spp", "2",
                   "--width", "24", "--height", "16", "--out", str(out),
                   "--hdr-out", str(hdr)])
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    film = np.load(hdr)
    assert film.shape == (16, 24, 3)
    assert np.isfinite(film).all() and film.max() > 0


@pytest.mark.parametrize("flag", [["--partition-samples", "2"],
                                  ["--platform", "cpu"],
                                  ["--partition-chips", "2"]])
def test_cli_rejects_unported_flags(flag):
    """--platform is not ported (use --device); the --partition-* flags
    are, but one process cannot run them: the partition needs
    as many ranks as it names (torchrun), and --partition-samples alone
    composes over nothing. Each exits with an error."""
    with pytest.raises(SystemExit) as exc:
        cli.main(["proc:cornell", "--device", "cpu", *flag])
    assert exc.value.code != 0


def _tsort_cfg(bounce_traversal, **kw):
    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=16, height=16, max_bounces=4,
                       bounce_traversal=bounce_traversal, treelet_min=1, **kw)
    cfg.camera = _cornell_camera()
    return cfg


def test_tsort_bounces_bitwise_equal_same_and_match_jax():
    """bounce_traversal="tsort" with treelet_min lowered so that the sort
    runs at 16x16 (one permutation per bounce, reused by the shadow rays):
    a schedule, so the film is bitwise the film of "same"; with
    shadow_sort off (a fresh sort through the dispatch, shadow rays
    unsorted) too. Against the JAX Renderer on the Pallas path with the
    same override: measured max |diff| 3e-6, held to the file's bound."""
    films = {}
    for name, cfg in (("same", _tsort_cfg("same")),
                      ("tsort", _tsort_cfg("tsort")),
                      ("fresh", _tsort_cfg("tsort", shadow_sort=False))):
        r = Renderer(cfg, "cpu")
        assert r.bounce_traversal == ("same" if name == "same" else "tsort")
        for k in SORTED:
            SORTED[k] = 0
        r.render_frame("wavefront")
        r.render_frame("wavefront")
        films[name] = r.film_hdr()
        # The sorted branch ran where it should and nowhere else: never
        # under "same"; one sort a bounce serving both traces; without
        # shadow_sort a fresh sort a closest trace, shadow rays unsorted.
        if name == "same":
            assert SORTED == {"sorts": 0, "closest": 0, "occluded": 0}
        elif name == "tsort":
            assert SORTED["sorts"] == SORTED["closest"] == \
                SORTED["occluded"] > 0
        else:
            assert SORTED["sorts"] == SORTED["closest"] > 0
            assert SORTED["occluded"] == 0
        r.stats.finalize()
        films[name + "_rays"] = r.stats.rays_traced
    assert films["same"].max() > 0
    for name in ("tsort", "fresh"):
        np.testing.assert_array_equal(films[name].view(np.int32),
                                      films["same"].view(np.int32))
        assert films[name + "_rays"] == films["same_rays"]
    jcfg = _jax_cfg(_tsort_cfg("tsort"))
    jcfg.traversal = "pallas"
    jr = JaxRenderer(jcfg)
    assert jr.bounce_traversal == "tsort"
    jr.render_frame("wavefront")
    jr.render_frame("wavefront")
    want = np.asarray(jr.film_hdr())
    assert _outside(films["tsort"], want).mean() <= 0.01
    np.testing.assert_allclose(films["tsort"].mean(axis=(0, 1)),
                               want.mean(axis=(0, 1)), rtol=5e-3)
    jr.stats.finalize()
    assert films["tsort_rays"] == jr.stats.rays_traced


@pytest.mark.parametrize("rows,want", [(563, "same"), (8191, "same"),
                                       (8192, "tsort"), (49863, "tsort")])
def test_auto_gate_resolves_as_jax(rows, want):
    """bounce_traversal="auto" resolves as the JAX Renderer resolves it for
    every traversal that is not its TPU kernel: "same", whatever the table.
    The JAX gate takes "tsort" (``want``) on tables of 8192 rows or more
    only on its Pallas path, which the port does not have (no render
    needed: the table is a stand-in of the wanted height). Named
    explicitly, either schedule is taken."""
    import jax.numpy as jnp
    import torch

    cfg = RenderConfig(scene_path="proc:cornell", width=16, height=16)
    small = Renderer(cfg, "cpu")
    assert small.bounce_traversal == "same"
    scene = small.scene._replace(node_rows=torch.zeros((rows, 128)))
    r = Renderer(cfg, "cpu", scene=scene, meta=small.meta)
    assert r.bounce_traversal == "same"
    for explicit in ("same", "tsort"):
        cfg_e = RenderConfig(scene_path="proc:cornell", width=16, height=16,
                             bounce_traversal=explicit)
        assert Renderer(cfg_e, "cpu", scene=scene,
                        meta=small.meta).bounce_traversal == explicit
    jcfg = _jax_cfg(cfg)
    jsmall = JaxRenderer(jcfg)
    jscene = jsmall.scene._replace(bvh=jsmall.scene.bvh._replace(
        node_rows=jnp.zeros((rows, 128), jnp.float32)))
    assert JaxRenderer(jcfg, scene=jscene,
                       meta=jsmall.meta).bounce_traversal == "same"
    jcfg.traversal = "pallas"
    assert JaxRenderer(jcfg, scene=jscene,
                       meta=jsmall.meta).bounce_traversal == want


def test_auto_gate_on_cluster_scene_counts_the_full_tree():
    """On a cluster scene the JAX gate keys on the tree the clusters
    replaced (wide nodes + references / leaf_size) and only for its Pallas
    path; the port has no such path and needs no count of that tree: its
    "auto" is "same" on every scene, and "tsort" runs when named."""
    cfg = RenderConfig(scene_path="proc:table", width=16, height=16,
                       cluster_tris=128)
    r = Renderer(cfg, "cpu")
    jcfg = _jax_cfg(cfg)
    jcfg.traversal = "pallas"
    jr = JaxRenderer(jcfg)
    assert r.bounce_traversal == jr.bounce_traversal == "same"
    named = RenderConfig(scene_path="proc:table", width=16, height=16,
                         cluster_tris=128, bounce_traversal="tsort")
    assert Renderer(named, "cpu", scene=r.scene,
                    meta=r.meta).bounce_traversal == "tsort"


def test_cli_takes_bounce_traversal(tmp_path):
    hdr = {}
    for mode in ("same", "tsort", "treelet", "auto", "packet", "perray"):
        out = tmp_path / f"{mode}.npy"
        rc = cli.main(["proc:cornell", "--device", "cpu", "--spp", "1",
                       "--width", "16", "--height", "16", "--bounce-traversal",
                       mode, "--out", str(tmp_path / f"{mode}.png"),
                       "--hdr-out", str(out), "--stats-json",
                       str(tmp_path / f"{mode}.json")])
        assert rc == 0
        # 256 lanes are below treelet_min: nothing runs sorted, and the
        # stats say so.
        with open(tmp_path / f"{mode}.json") as f:
            assert json.load(f)["sorted"] == {"sorts": 0, "closest": 0,
                                              "occluded": 0}
        hdr[mode] = np.load(out)
    np.testing.assert_array_equal(hdr["tsort"], hdr["same"])
    np.testing.assert_array_equal(hdr["treelet"], hdr["same"])
    np.testing.assert_array_equal(hdr["auto"], hdr["same"])
    np.testing.assert_array_equal(hdr["packet"], hdr["same"])
    np.testing.assert_array_equal(hdr["perray"], hdr["same"])
    with pytest.raises(ValueError):
        cli.main(["proc:cornell", "--device", "cpu", "--bounce-traversal",
                  "packet2"])
