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
    return mt_xyz([tri[:, i] for i in range(0, 3)],
                  [tri[:, i] for i in range(3, 6)],
                  [tri[:, i] for i in range(6, 9)],
                  [o[:, i] for i in range(3)], [d[:, i] for i in range(3)])


def mt_xyz(p0, e1, e2, o, d):
    """``mt_intersect`` on components: each argument is the (x, y, z) of
    its vector as tensors that broadcast against one another (a triangle
    a packet against the packet's rays, ops/packet_traverse.py). The six
    cross-product terms share one ``fma32`` call and the four dot products
    two (each element rounded as alone)."""
    (p0x, p0y, p0z, e1x, e1y, e1z, e2x, e2y, e2z, ox, oy, oz, dx, dy,
     dz) = torch.broadcast_tensors(*p0, *e1, *e2, *o, *d)
    tx, ty, tz = ox - p0x, oy - p0y, oz - p0z
    # p = d x e2 and q = t x e1: component k is fma(a_k1, b_k2, -(a_k2 b_k1)).
    px, py, pz, qx, qy, qz = fma32(
        torch.stack([dy, dz, dx, ty, tz, tx]),
        torch.stack([e2z, e2x, e2y, e1z, e1x, e1y]),
        -(torch.stack([dz, dx, dy, tz, tx, ty])
          * torch.stack([e2y, e2z, e2x, e1y, e1z, e1x])))
    # det = e1.p, u = t.p, v = d.q, t = e2.q as fma(z, z, fma(a, a, b b)).
    det, uu, vv, tt = fma32(
        torch.stack([e1z, tz, dz, e2z]), torch.stack([pz, pz, qz, qz]),
        fma32(torch.stack([e1y, tx, dx, e2x]), torch.stack([py, px, qx, qx]),
              torch.stack([e1x, ty, dy, e2y]) * torch.stack([px, py, qy,
                                                             qy])))
    idet = torch.ones_like(det) / det  # may be inf; comparisons then fail
    u = uu * idet
    v = vv * idet
    t = tt * idet
    hit = (u > 0.0) & (u < 1.0) & (v > 0.0) & (u + v < 1.0) & (t > 0.0)
    return t, u, v, hit
