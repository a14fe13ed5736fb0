"""The port's ``ld`` sampler against the JAX package on the CPU: the four
low-discrepancy sequences bitwise (the R2 point at the wrap boundaries of
tests/test_ld_sampler.py, the pixel hash over ids that wrap 32 bits), the
jitter the wavefront integrator draws from them, the Renderer's ``ld``
film, and utils/sampler_viz.py.

The port computes the 32-bit integer steps in int64, masked to 32 bits
after every product and xor (torch has no uint32 arithmetic on the card);
tests/test_torch_features_cuda.py holds the card's sequences to the CPU's.
"""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.math import sampling as jsam
from gpupathtracer_tpu.render import Renderer as JaxRenderer
from gpupathtracer_tpu.utils import sampler_viz as jviz
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.math import sampling as tsam
from gpupathtracer_tpu_torch.models.wavefront import ld_jitter
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.utils import io, sampler_viz

ALPHA = 3242174889


def _wrap_indices():
    """Sample indices whose (idx + 1) * alpha lands within 128 of 2^32
    (tests/test_ld_sampler.py's targets), the ends of the 32-bit range
    and of float32's exact integers, and a run from 0."""
    inv = pow(ALPHA, -1, 1 << 32)
    wrap = [((inv * t) % (1 << 32)) - 1 for t in
            (0xFFFFFFFF, 0xFFFFFF80, 0xFFFFFFC0)]
    ends = [0, 1, (1 << 24) - 1, 1 << 24, (1 << 31) - 1, 1 << 31,
            (1 << 32) - 2, (1 << 32) - 1]
    return np.asarray(wrap + ends + list(range(2, 200)), np.uint64)


def test_r2_sequence_bitwise():
    idx = _wrap_indices()
    want = np.stack([np.asarray(jsam.r2_sequence(jnp.uint32(i)))
                     for i in idx])
    got = tsam.r2_sequence(torch.from_numpy(idx.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < 1)).all()
    # A Python int and a 0-d tensor give the [2] point of one index.
    assert tsam.r2_sequence(3).shape == (2,)
    np.testing.assert_array_equal(tsam.r2_sequence(int(idx[0])).numpy(),
                                  want[0])


def test_pixel_rotation_bitwise():
    """Every id of a 1080p film, and ids near 2^32 and 0x9E3779B9 (the
    second hash's xor), where the products and the xor wrap."""
    ids = np.concatenate([
        np.arange(1920 * 1080, dtype=np.uint64),
        np.asarray([0x9E3779B9, 0x9E3779B8, 0x61C88646, 0xFFFFFFFF,
                    0xFFFFFFFE, 0x80000000, 0x7FFFFFFF], np.uint64)])
    want = np.asarray(jax.jit(jsam.pixel_rotation)(
        jnp.asarray(ids.astype(np.uint32))))
    got = tsam.pixel_rotation(torch.from_numpy(ids.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want)
    assert ((got >= 0) & (got < 1)).all()


@pytest.mark.parametrize("base", [2, 3, 5])
def test_van_der_corput_bitwise(base):
    i = np.concatenate([np.arange(4096), [1 << 20, (1 << 24) - 1,
                                          (1 << 32) - 1]]).astype(np.uint64)
    want = np.asarray(jsam.van_der_corput(jnp.asarray(i.astype(np.uint32)),
                                          base))
    got = tsam.van_der_corput(torch.from_numpy(i.astype(np.int64)),
                              base).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("offset", [0.0, 0.3])
def test_golden_ratio_sequence_bitwise(offset):
    want = np.asarray(jsam.golden_ratio_sequence(5000, offset))
    np.testing.assert_array_equal(
        tsam.golden_ratio_sequence(5000, offset).numpy(), want)


@pytest.mark.parametrize("sample_idx", [0, 1, 77, (1 << 24) - 1])
def test_ld_jitter_bitwise(sample_idx):
    """The wavefront integrator's jitter, against the JAX expression
    (models/wavefront.py:132-145) jitted, on a 37 x 29 film."""
    w, h = 37, 29
    px = (np.arange(w * h) % w).astype(np.float32)
    py = (np.arange(w * h) // w).astype(np.float32)

    def jax_jitter(px, py, idx):
        rot = jsam.pixel_rotation(py.astype(jnp.int32) * w
                                  + px.astype(jnp.int32))
        return jnp.mod(jsam.r2_sequence(idx)[None, :] + rot, 1.0)

    want = np.asarray(jax.jit(jax_jitter)(px, py, jnp.int32(sample_idx)))
    got = ld_jitter(torch.from_numpy(px), torch.from_numpy(py), w,
                    sample_idx).numpy()
    np.testing.assert_array_equal(got, want)


def _ld_cfg(sampler, **kw):
    """tests/test_ld_sampler.py's configuration, at 16x16 where that file
    renders 24x24 (chip_smoke.py phase 15 runs its 24x24 on the card)."""
    cfg = RenderConfig(scene_path="proc:cornell",
                       skybox="GENERATE COLOR BLACK", width=16, height=16,
                       ray_chunk=256, max_bounces=3, sampler=sampler, **kw)
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    return cfg


def _outside(img, ref, tol=2e-3):
    return (np.abs(img - ref) > tol + tol * np.abs(ref)).any(-1)


@pytest.mark.parametrize("frame_batch", [1, 2])
def test_ld_renderer_matches_jax(frame_batch):
    """Two frames of tests/test_ld_sampler.py's cornell, one sample a frame
    and frame-batched (LD index num_samples + i). The port's film is
    deterministic and differs from the random sampler's, as that file
    asserts; against the JAX Renderer held as tests/test_torch_render.py
    holds the wavefront (measured: 0 pixels outside rtol = atol = 2e-3,
    max |diff| 6.6e-6 and 2.1e-6, the ray counts equal)."""
    cfg = _ld_cfg("ld", frame_batch=frame_batch)
    ra = Renderer(cfg, "cpu")
    jr = JaxRenderer(JaxRenderConfig.from_json(cfg.to_json()))
    for _ in range(2):
        ra.render_frame("wavefront")
        jr.render_frame("wavefront")
    assert ra.num_samples == jr.num_samples == 2 * frame_batch
    got, want = ra.film_hdr(), np.asarray(jr.film_hdr())
    assert np.isfinite(got).all() and got.max() > 0
    assert _outside(got, want).mean() <= 0.01
    np.testing.assert_allclose(got.mean(axis=(0, 1)), want.mean(axis=(0, 1)),
                               rtol=5e-3)
    ra.stats.finalize()
    jr.stats.finalize()
    assert ra.stats.rays_traced == jr.stats.rays_traced
    if frame_batch == 1:
        rb = Renderer(cfg, "cpu", scene=ra.scene, meta=ra.meta)
        rb.render_frame("wavefront")
        rb.render_frame("wavefront")
        np.testing.assert_array_equal(ra.accum.numpy(), rb.accum.numpy())
        rc = Renderer(_ld_cfg("random"), "cpu", scene=ra.scene, meta=ra.meta)
        rc.render_frame("wavefront")
        rc.render_frame("wavefront")
        assert not np.array_equal(ra.accum.numpy(), rc.accum.numpy())


def test_cli_takes_sampler_ld(tmp_path):
    hdr = tmp_path / "ld.npy"
    assert cli.main(["proc:cornell", "--device", "cpu", "--spp", "1",
                     "--width", "16", "--height", "16", "--sampler", "ld",
                     "--max-bounces", "2", "--out", str(tmp_path / "ld.png"),
                     "--hdr-out", str(hdr)]) == 0
    film = np.load(hdr)
    assert np.isfinite(film).all() and film.max() > 0


def test_sampler_viz_matches_jax(tmp_path):
    """The point sets bitwise; the plots' pixels equal (the JAX package
    writes through PIL, the port through its own PNG writer)."""
    np.testing.assert_array_equal(sampler_viz.halton_set(3000),
                                  jviz.halton_set(3000))
    np.testing.assert_array_equal(sampler_viz.golden_ratio_set(500, seed=4),
                                  jviz.golden_ratio_set(500, seed=4))
    pts = sampler_viz.halton_set(700)
    got = sampler_viz.plot_points(pts, size=64, path=str(tmp_path / "p.png"))
    want = jviz.plot_points(pts, size=64, path=str(tmp_path / "j.png"))
    np.testing.assert_array_equal(io.load_image(got), io.load_image(want))
    assert io.load_image(got).max() == 1.0
