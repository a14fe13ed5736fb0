"""Checkpoints (render/checkpoint.py) against the JAX package's: a resumed
render is bitwise an uninterrupted one, and either package resumes the
other's file (the same .npz keys, the accumulator in Morton ray order and
the config's JSON; the two RenderConfigs are field for field the same)."""

import math

import numpy as np
import pytest

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu.render import checkpoint as jax_ckpt
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.render.checkpoint import (load_checkpoint,
                                                       save_checkpoint)


def _cfg():
    """tests/test_checkpoint.py's configuration."""
    c = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                     width=16, height=16, ray_chunk=256, max_bounces=4)
    c.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                            fov=math.radians(45), aspect=1.0)
    return c


def _bits(x):
    return np.asarray(x).view(np.int32)


def test_resume_is_bitwise_uninterrupted(tmp_path):
    """2 + 2 samples through a checkpoint against 4 in one go; the path
    keeps its name without an extension; a film of another size raises."""
    r1 = Renderer(_cfg(), "cpu")
    for _ in range(4):
        r1.render_frame()
    r2 = Renderer(_cfg(), "cpu", scene=r1.scene, meta=r1.meta)
    for _ in range(2):
        r2.render_frame()
    path = save_checkpoint(r2, str(tmp_path / "sub" / "render"))
    assert path == str(tmp_path / "sub" / "render")
    r3 = load_checkpoint(path, "cpu")
    assert r3.num_samples == 2 and r3.cfg.seed == r2.cfg.seed
    for _ in range(2):
        r3.render_frame()
    np.testing.assert_array_equal(_bits(r3.accum.numpy()),
                                  _bits(r1.accum.numpy()))
    np.testing.assert_array_equal(_bits(r3.film_hdr()), _bits(r1.film_hdr()))

    with np.load(path) as z:
        fields = {k: z[k] for k in z.files}
    fields["accum"] = fields["accum"][:-8]
    with open(tmp_path / "short.npz", "wb") as f:
        np.savez_compressed(f, **fields)
    with pytest.raises(ValueError):
        load_checkpoint(str(tmp_path / "short.npz"), "cpu")


def test_checkpoints_cross_packages(tmp_path):
    """A checkpoint the JAX package wrote after 2 samples resumes in the
    port: its accumulator and sample count bitwise, and after 2 more
    samples the film within tests/test_torch_render.py's rtol = atol =
    2e-3 of the JAX package's uninterrupted 4 (last-place differences of
    the shading's transcendentals, ROADMAP.md C). The JAX package's
    load_checkpoint reads a file the port wrote, bitwise."""
    jr = JaxRenderer(JaxRenderConfig.from_json(_cfg().to_json()))
    for _ in range(2):
        jr.render_frame()
    jpath = jax_ckpt.save_checkpoint(jr, str(tmp_path / "jax.ckpt"))
    r = load_checkpoint(jpath, "cpu")
    assert r.num_samples == 2
    np.testing.assert_array_equal(_bits(r.accum.numpy()), _bits(jr.accum))
    for _ in range(2):
        r.render_frame()
        jr.render_frame()
    # Measured: 376 of 768 values not bitwise, max |diff| 5.7e-6.
    np.testing.assert_allclose(r.film_hdr(), np.asarray(jr.film_hdr()),
                               rtol=2e-3, atol=2e-3)
    assert r.film_hdr().max() > 0

    ppath = save_checkpoint(r, str(tmp_path / "port.ckpt"))
    back = jax_ckpt.load_checkpoint(ppath)
    assert back.num_samples == 4
    assert back.cfg.to_json() == r.cfg.to_json()
    np.testing.assert_array_equal(_bits(back.accum), _bits(r.accum.numpy()))


def test_cli_checkpoint_then_resume(tmp_path):
    """The CLI's --checkpoint and --resume (its config from the file):
    1 + 1 samples give the film of --spp 2 bitwise."""
    base = ["proc:cornell", "--device", "cpu", "--width", "16", "--height",
            "12", "--max-bounces", "4", "--no-cache"]
    ckpt = str(tmp_path / "c.ckpt")
    assert cli.main(base + ["--spp", "1", "--checkpoint", ckpt, "--out",
                            str(tmp_path / "a.png")]) == 0
    assert cli.main(base + ["--spp", "1", "--resume", ckpt, "--out",
                            str(tmp_path / "b.png"), "--hdr-out",
                            str(tmp_path / "resumed.npy")]) == 0
    assert cli.main(base + ["--spp", "2", "--out", str(tmp_path / "c.png"),
                            "--hdr-out", str(tmp_path / "full.npy")]) == 0
    resumed, full = (np.load(tmp_path / f"{k}.npy") for k in ("resumed",
                                                              "full"))
    np.testing.assert_array_equal(_bits(resumed), _bits(full))
    assert full.max() > 0
