"""Morton (Z-order) pixel ordering.

The reference maps the atomic ray counter to Morton-ordered pixels inside 8x8
blocks for warp coherence (Iterative.comp:154-172, Renderer.cpp:568-592
Hilbert/Morton A/B: 22.601 vs 22.597 FPS). The wavefront is laid out in
this order, so neighbouring threads of a warp trace neighbouring pixels and
walk nearby BVH nodes. Precomputed once per resolution as a static
permutation (a copy of the JAX package's utils/morton.py).
"""

from __future__ import annotations

import numpy as np


def _compact1by1(x: np.ndarray) -> np.ndarray:
    """Inverse of part1by1: extract even bits (Iterative.comp:154-161)."""
    x = x & 0x55555555
    x = (x ^ (x >> 1)) & 0x33333333
    x = (x ^ (x >> 2)) & 0x0F0F0F0F
    x = (x ^ (x >> 4)) & 0x00FF00FF
    x = (x ^ (x >> 8)) & 0x0000FFFF
    return x


def ray_index_to_pixel(width: int, height: int) -> np.ndarray:
    """Permutation: ray index -> linear pixel index (y*width + x), Morton in
    8x8 blocks, blocks in row-major order (Iterative.comp:163-172).

    Requires width % 8 == 0 and height % 8 == 0 (pad the film otherwise).
    """
    assert width % 8 == 0 and height % 8 == 0, "film must be 8x8 aligned"
    idx = np.arange(width * height, dtype=np.int64)
    i = idx % 64
    mx = _compact1by1(i)
    my = _compact1by1(i >> 1)
    j = idx // 64
    bx = j % (width // 8)
    by = j // (width // 8)
    px = mx + 8 * bx
    py = my + 8 * by
    return (py * width + px).astype(np.int32)


def _hilbert_d2xy(order: int, d: np.ndarray):
    """Vectorized Hilbert curve index -> (x, y) for a 2^order square.

    Role of the reference's Hilbert pixel-pool generator (Renderer.cpp:
    373-446; A/B'd against Morton at 22.597 vs 22.601 FPS)."""
    n = 1 << order
    x = np.zeros_like(d)
    y = np.zeros_like(d)
    t = d.copy()
    s = 1
    while s < n:
        rx = 1 & (t // 2)
        ry = 1 & (t ^ rx)
        # rotate quadrant
        swap = ry == 0
        flip = swap & (rx == 1)
        x_f, y_f = x.copy(), y.copy()
        x = np.where(swap, y_f, x)
        y = np.where(swap, x_f, y)
        x = np.where(flip, s - 1 - x, x)
        y = np.where(flip, s - 1 - y, y)
        x = x + s * rx
        y = y + s * ry
        t //= 4
        s *= 2
    return x, y


def ray_index_to_pixel_hilbert(width: int, height: int) -> np.ndarray:
    """Like ray_index_to_pixel but with Hilbert-ordered 8x8 blocks."""
    assert width % 8 == 0 and height % 8 == 0, "film must be 8x8 aligned"
    idx = np.arange(width * height, dtype=np.int64)
    i = idx % 64
    hx, hy = _hilbert_d2xy(3, i)
    j = idx // 64
    bx = j % (width // 8)
    by = j // (width // 8)
    px = hx + 8 * bx
    py = hy + 8 * by
    return (py * width + px).astype(np.int32)


def ray_order(width: int, height: int, kind: str = "morton") -> np.ndarray:
    if kind == "hilbert":
        return ray_index_to_pixel_hilbert(width, height)
    return ray_index_to_pixel(width, height)
