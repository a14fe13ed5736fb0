"""The bitwise checks of the ``ld`` sampler and the bounce coherence sort on
the card: the R2 point and the pixel rotation computed by CUDA tensors
against the CPU's (int64 steps masked to 32 bits; torch has no uint32
arithmetic on the card), and the ``sort_rays`` film bitwise the unsorted
film of the same Renderer configuration (B1 walks each ray alone).

This module imports no JAX, so its tests also run on the machine with the
card (tests/conftest.py imports jax, hence --noconftest there):

    python -m pytest tests/test_torch_features_cuda.py -m cuda --noconftest -q
"""

import math

import numpy as np
import pytest
import torch

from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.math import sampling
from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
from gpupathtracer_tpu_torch.render import Renderer

# Sample indices at the ends of float32's exact integers and of 32 bits.
LD_INDICES = (0, 1, (1 << 24) - 1, (1 << 32) - 2)


def _need_cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device: the paths run the port's kernels")


@pytest.mark.cuda
def test_ld_sequences_on_cuda_bitwise_cpu():
    _need_cuda()
    ids = torch.arange(1920 * 1080, dtype=torch.int64)
    np.testing.assert_array_equal(
        sampling.pixel_rotation(ids.cuda()).cpu().numpy(),
        sampling.pixel_rotation(ids).numpy())
    idx = torch.tensor(LD_INDICES, dtype=torch.int64)
    np.testing.assert_array_equal(
        sampling.r2_sequence(idx.cuda()).cpu().numpy(),
        sampling.r2_sequence(idx).numpy())


@pytest.mark.cuda
def test_sort_rays_film_on_cuda_bitwise_unsorted():
    _need_cuda()
    films = {}
    for sort_rays in (False, True):
        cfg = RenderConfig(scene_path="proc:cornell", width=64, height=64,
                           max_bounces=8, sort_rays=sort_rays,
                           bvh_builder="cpp")
        cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                                  fov=math.radians(45), aspect=1.0)
        before = kt.LAUNCHES["trace_closest"]
        r = Renderer(cfg, "cuda")
        r.render_frame()
        r.stats.finalize()
        assert kt.LAUNCHES["trace_closest"] > before
        films[sort_rays] = (r.film_hdr(), r.stats.rays_traced)
    (ref, rays), (film, n) = films[False], films[True]
    assert ref.max() > 0 and n == rays
    np.testing.assert_array_equal(film.view(np.int32), ref.view(np.int32))
