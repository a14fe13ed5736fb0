"""Moller-Trumbore triangle intersection.

Semantics match the reference's IntersectTriangleMT
(src/shaders/common/Geometry.glsl:198-225): precomputed edge vectors,
strict inequalities u > 0, u < 1, v > 0, u + v < 1, t in (0, t_closest).

The rounding is that of the JAX package's traversal as XLA compiles it
for the CPU, where the tests and the goldens run it: XLA lets LLVM
contract a*b + c into fused multiply-adds. The contraction pattern below
was read off the outputs of ``traverse_pallas(interpret=True)`` (it
matches them bit for bit) and is written out with ``fma32``; the CUDA
kernel uses ``__fmaf_rn`` at the same places.
"""

from __future__ import annotations

import numpy as np
import torch


def pack_tri_geom(p0: np.ndarray, e1: np.ndarray, e2: np.ndarray) -> np.ndarray:
    """Pack triangle geometry as [T, 9] = (p0, e1, e2)."""
    return np.concatenate([p0, e1, e2], axis=1).astype(np.float32)


def fma32(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    """a * b + c on float32 tensors with one rounding, as a fused
    multiply-add gives it. a * b is exact in float64; the float64 sum is
    rounded to odd (TwoSum gives its exact error), after which the
    rounding to float32 is correct (53 >= 2 * 24 + 2 bits)."""
    p = a.double() * b.double()
    c64 = c.double()
    s = p + c64
    bb = s - p
    err = (p - (s - bb)) + (c64 - bb)
    even = (s.view(torch.int64) & 1) == 0
    fix = (err != 0) & even & torch.isfinite(s)
    toward = torch.where(err > 0, torch.inf, -torch.inf).to(s.dtype)
    s = torch.where(fix, torch.nextafter(s, toward), s)
    return s.float()


def mt_intersect(tri: torch.Tensor, o: torch.Tensor, d: torch.Tensor):
    """Intersect rays with one triangle per lane.

    Args: tri [N, >=9] packed (p0, e1, e2, ...); o, d [N, 3].
    Returns (t, u, v, hit): hit is the parametric-validity mask only;
    callers compare t against their current closest.
    """
    p0x, p0y, p0z = tri[:, 0], tri[:, 1], tri[:, 2]
    e1x, e1y, e1z = tri[:, 3], tri[:, 4], tri[:, 5]
    e2x, e2y, e2z = tri[:, 6], tri[:, 7], tri[:, 8]
    dx, dy, dz = d[:, 0], d[:, 1], d[:, 2]
    px = fma32(dy, e2z, -(dz * e2y))
    py = fma32(dz, e2x, -(dx * e2z))
    pz = fma32(dx, e2y, -(dy * e2x))
    det = fma32(e1z, pz, fma32(e1y, py, e1x * px))
    idet = torch.ones_like(det) / det  # may be inf; comparisons then fail
    tx = o[:, 0] - p0x
    ty = o[:, 1] - p0y
    tz = o[:, 2] - p0z
    u = fma32(tz, pz, fma32(tx, px, ty * py)) * idet
    qx = fma32(ty, e1z, -(tz * e1y))
    qy = fma32(tz, e1x, -(tx * e1z))
    qz = fma32(tx, e1y, -(ty * e1x))
    v = fma32(dz, qz, fma32(dx, qx, dy * qy)) * idet
    t = fma32(e2z, qz, fma32(e2x, qx, e2y * qy)) * idet
    hit = (u > 0.0) & (u < 1.0) & (v > 0.0) & (u + v < 1.0) & (t > 0.0)
    return t, u, v, hit
