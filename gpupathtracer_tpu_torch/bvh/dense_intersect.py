"""The inverse-matrix triangle rows that dense cluster leaves store
(bvh/cluster.py): the numpy ``inverse_rows`` of the JAX package's
ops/dense_intersect.py, kept here so that the port's BVH builder imports
nothing of that package (its ops module imports jax)."""

from __future__ import annotations

import numpy as np


def inverse_rows(tri_geom):
    """Rows A/B/C of M^-1 (M = [e1 e2 n]) per triangle, f32.

    Returns (A, B, C, p0) each [T, 3]; degenerate triangles get all-zero
    rows (den = 0 => 0/0 = NaN fails every hit comparison).
    """
    tg = np.asarray(tri_geom, np.float64)  # f64 inverse for stability
    p0, e1, e2 = tg[:, 0:3], tg[:, 3:6], tg[:, 6:9]
    n = np.cross(e1, e2)
    # M columns = (e1, e2, n); det(M) = |n|^2 (n orthogonal to e1, e2).
    det = np.einsum("ij,ij->i", n, n)
    ok = det > 1e-30
    inv_det = np.where(ok, 1.0 / np.maximum(det, 1e-300), 0.0)
    # Rows of M^-1 via the adjugate: A = (e2 x n)/det, B = (n x e1)/det,
    # C = (e1 x e2)/det = n/det.
    A = np.cross(e2, n) * inv_det[:, None]
    B = np.cross(n, e1) * inv_det[:, None]
    C = n * inv_det[:, None]
    A[~ok] = 0.0
    B[~ok] = 0.0
    C[~ok] = 0.0
    return (A.astype(np.float32), B.astype(np.float32),
            C.astype(np.float32), p0.astype(np.float32))
