"""Low-discrepancy sampler visualization (counterpart of the JAX package's
utils/sampler_viz.py).

Role of TestGoldenRatio (src/core/Renderer.cpp:889-918): scatter-plot a 2D
point set into a PNG for eyeballing stratification quality.
"""

from __future__ import annotations

import numpy as np
import torch

from gpupathtracer_tpu_torch.math.sampling import (GOLDEN_RATIO_CONJUGATE,
                                                   van_der_corput)
from gpupathtracer_tpu_torch.utils.io import save_png


def plot_points(points: np.ndarray, size: int = 256,
                path: str = "sampler.png") -> str:
    """points: [N, 2] in [0,1)^2 -> white dots on black, saved to path."""
    img = np.zeros((size, size, 3), np.float32)
    xy = np.clip((points * size).astype(np.int64), 0, size - 1)
    img[xy[:, 1], xy[:, 0]] = 1.0
    return save_png(path, img, flip_y=True)


def golden_ratio_set(n: int, seed: int = 0) -> np.ndarray:
    """2D golden-ratio lattice (Renderer.cpp:784-846 role)."""
    i = np.arange(n)
    rng = np.random.RandomState(seed)
    off = rng.rand(2)
    x = (off[0] + (i + 1) * GOLDEN_RATIO_CONJUGATE) % 1.0
    y = (i + 0.5) / n
    # Fibonacci-style shuffle pairing (cheap stand-in for the reference's
    # permutation table)
    order = np.argsort(x)
    return np.stack([x[order], y], axis=1)


def halton_set(n: int) -> np.ndarray:
    """2D Halton (bases 2, 3) set (Renderer.cpp:848-887 role)."""
    i = torch.arange(n)
    return np.stack([van_der_corput(i, 2).numpy(),
                     van_der_corput(i, 3).numpy()], axis=1)
