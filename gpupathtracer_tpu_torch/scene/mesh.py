"""Host mesh representation and compact-triangle assembly.

Role of the reference's Vertex/TriangleIndexData/CompactTriangle assembly
(src/core/Scene.cpp:263-337): per triangle, store vertex 0 plus the two
Moller-Trumbore edge vectors, a *geometric* face normal flipped to match the
average vertex normal, per-corner texcoords, and the material id taken from
corner 0.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, NamedTuple

import numpy as np


@dataclass
class MeshData:
    """Indexed mesh straight out of a loader."""

    positions: np.ndarray   # [V, 3] f32
    normals: np.ndarray     # [V, 3] f32 (zero rows = missing, computed later)
    uvs: np.ndarray         # [V, 2] f32
    mat_ids: np.ndarray     # [V]    i32 per-corner material (corner 0 wins)
    triangles: np.ndarray   # [T, 3] i32 indices into the arrays above


class TriangleSoup(NamedTuple):
    """Flat triangle arrays, SoA, ready for the BVH builder and the device.

    p1/p2 are stored as *edges* from p0 (MT precompute, Scene.cpp:334-337).
    """

    p0: np.ndarray       # [T, 3] f32
    e1: np.ndarray       # [T, 3] f32 = p1 - p0
    e2: np.ndarray       # [T, 3] f32 = p2 - p0
    normal: np.ndarray   # [T, 3] f32 geometric, vertex-normal aligned
    uv: np.ndarray       # [T, 3, 2] f32 per-corner texcoords
    mat: np.ndarray      # [T] i32 material index

    @property
    def num_triangles(self) -> int:
        return int(self.p0.shape[0])

    def vertices(self):
        """Recover world-space (p0, p1, p2) for builders/tests."""
        return self.p0, self.p0 + self.e1, self.p0 + self.e2


def compute_vertex_normals(positions: np.ndarray,
                           triangles: np.ndarray) -> np.ndarray:
    """Area-weighted smooth vertex normals for meshes that ship without them."""
    v0 = positions[triangles[:, 0]]
    v1 = positions[triangles[:, 1]]
    v2 = positions[triangles[:, 2]]
    fn = np.cross(v1 - v0, v2 - v0)  # area-weighted
    normals = np.zeros_like(positions)
    for c in range(3):
        np.add.at(normals, triangles[:, c], fn)
    lens = np.linalg.norm(normals, axis=1, keepdims=True)
    return (normals / np.maximum(lens, 1e-20)).astype(np.float32)


def build_triangle_soup(mesh: MeshData) -> TriangleSoup:
    """Assemble CompactTriangle-equivalent arrays (Scene.cpp:263-292, 334-337)."""
    tris = mesh.triangles
    normals = mesh.normals
    if normals is None or not normals.any():
        normals = compute_vertex_normals(mesh.positions, tris)

    p0 = mesh.positions[tris[:, 0]].astype(np.float32)
    p1 = mesh.positions[tris[:, 1]].astype(np.float32)
    p2 = mesh.positions[tris[:, 2]].astype(np.float32)

    # Geometric normal from *normalized* edges (Scene.cpp:279-281) ...
    def _norm(v):
        return v / np.maximum(np.linalg.norm(v, axis=1, keepdims=True), 1e-20)

    gn = np.cross(_norm(p1 - p0), _norm(p2 - p0))
    gn = _norm(gn)
    # ... flipped to agree with the average vertex normal (Scene.cpp:284-287).
    avg = (normals[tris[:, 0]] + normals[tris[:, 1]] + normals[tris[:, 2]]) / 3.0
    flip = np.sum(gn * avg, axis=1) < 0.0
    gn[flip] = -gn[flip]

    uv = np.stack([mesh.uvs[tris[:, 0]], mesh.uvs[tris[:, 1]],
                   mesh.uvs[tris[:, 2]]], axis=1).astype(np.float32)
    mat = mesh.mat_ids[tris[:, 0]].astype(np.int32)

    return TriangleSoup(p0=p0, e1=(p1 - p0), e2=(p2 - p0),
                        normal=gn.astype(np.float32), uv=uv, mat=mat)



def merge_meshes(meshes: List[MeshData]) -> MeshData:
    """Concatenate indexed meshes into one (glTF multi-primitive scenes)."""
    offs, pos, nrm, uv, mid, tri = 0, [], [], [], [], []
    for m in meshes:
        pos.append(m.positions); nrm.append(m.normals); uv.append(m.uvs)
        mid.append(m.mat_ids); tri.append(m.triangles + offs)
        offs += m.positions.shape[0]
    return MeshData(
        positions=np.concatenate(pos).astype(np.float32),
        normals=np.concatenate(nrm).astype(np.float32),
        uvs=np.concatenate(uv).astype(np.float32),
        mat_ids=np.concatenate(mid).astype(np.int32),
        triangles=np.concatenate(tri).astype(np.int32),
    )
