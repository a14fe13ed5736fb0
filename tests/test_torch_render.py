"""The port's wavefront render against the JAX package: the HDR golden
corpus, the JAX Renderer on a film wide enough for bounce-epoch
compaction, and the port's CLI end to end (all on the CPU, where the
traversal runs its plain torch version)."""

import math
import os

import numpy as np
import pytest

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
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


@pytest.mark.parametrize("flag", [["--integrator", "ao"],
                                  ["--shadow-rev"],
                                  ["--sampler", "ld"]])
def test_cli_rejects_unported_flags(flag):
    with pytest.raises(SystemExit) as exc:
        cli.main(["proc:cornell", "--device", "cpu", *flag])
    assert exc.value.code != 0
