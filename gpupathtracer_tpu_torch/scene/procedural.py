"""Procedural benchmark scenes.

The reference renders downloaded assets (bunny, conference, Sponza, Salle de
Bain — README.md:10-46). This environment has no network egress, so each
BASELINE.md config gets a deterministic procedural stand-in of comparable
triangle count and lighting character:

  - ``proc:cornell``  : Cornell box, area light, 2 boxes (statistical tests)
  - ``proc:bunny``    : icosphere "bunny" on a ground plane, white env
                        (config 1: ~5k tris, 512x512)
  - ``proc:table``    : table + objects + light panel (config 2: 800x600 DoF)
  - ``proc:sponza``   : colonnade atrium, ~260k tris, NEE-heavy (config 3)
  - ``proc:bathroom`` : room + tub + metallic mirror + window light (config 4)

All geometry is generated with pure numpy; scenes are reproducible builds
(same arrays every run) so renders are bitwise-reproducible end to end.
"""

from __future__ import annotations

import math
from typing import List, Tuple

import numpy as np

from gpupathtracer_tpu_torch.scene.materials import MaterialDesc, env_material
from gpupathtracer_tpu_torch.scene.mesh import MeshData


class SceneBuilder:
    """Accumulates triangles + materials into a MeshData."""

    def __init__(self) -> None:
        self.positions: List[np.ndarray] = []
        self.triangles: List[np.ndarray] = []
        self.mat_of_tri: List[np.ndarray] = []
        self.materials: List[MaterialDesc] = [env_material()]
        self._voffset = 0

    def add_material(self, **kw) -> int:
        self.materials.append(MaterialDesc(**kw))
        return len(self.materials) - 1

    def add_mesh(self, verts: np.ndarray, tris: np.ndarray, mat: int) -> None:
        self.positions.append(np.asarray(verts, np.float32))
        self.triangles.append(np.asarray(tris, np.int64) + self._voffset)
        self.mat_of_tri.append(np.full(len(tris), mat, np.int32))
        self._voffset += len(verts)

    def add_quad(self, a, b, c, d, mat: int) -> None:
        """Quad with corners a,b,c,d; normal = cross(b-a, c-a)."""
        v = np.asarray([a, b, c, d], np.float32)
        self.add_mesh(v, np.asarray([[0, 1, 2], [0, 2, 3]]), mat)

    def add_box(self, lo, hi, mat: int, inside: bool = False) -> None:
        l, h = np.asarray(lo, np.float32), np.asarray(hi, np.float32)
        x0, y0, z0 = l; x1, y1, z1 = h
        v = np.asarray([[x0, y0, z0], [x1, y0, z0], [x1, y1, z0], [x0, y1, z0],
                        [x0, y0, z1], [x1, y0, z1], [x1, y1, z1], [x0, y1, z1]],
                       np.float32)
        faces = np.asarray([[0, 2, 1], [0, 3, 2],   # z0
                            [4, 5, 6], [4, 6, 7],   # z1
                            [0, 1, 5], [0, 5, 4],   # y0
                            [3, 6, 2], [3, 7, 6],   # y1
                            [0, 4, 7], [0, 7, 3],   # x0
                            [1, 2, 6], [1, 6, 5]])  # x1
        if inside:
            faces = faces[:, ::-1]
        self.add_mesh(v, faces, mat)

    def add_cylinder(self, center, radius: float, height: float, mat: int,
                     segments: int = 16, cap: bool = True) -> None:
        cx, cy, cz = center
        ang = np.linspace(0, 2 * np.pi, segments, endpoint=False)
        ring = np.stack([cx + radius * np.cos(ang),
                         np.full(segments, cy),
                         cz + radius * np.sin(ang)], axis=1)
        bot = ring.copy()
        top = ring.copy(); top[:, 1] += height
        verts = np.concatenate([bot, top])
        tris = []
        for i in range(segments):
            j = (i + 1) % segments
            # Outward-facing sides: cross(up, tangential) points radially out.
            tris += [[i, segments + i, segments + j], [i, segments + j, j]]
        if cap:
            verts = np.concatenate([verts, [[cx, cy + height, cz]], [[cx, cy, cz]]])
            tc, bc = 2 * segments, 2 * segments + 1
            for i in range(segments):
                j = (i + 1) % segments
                tris += [[segments + j, segments + i, tc], [i, j, bc]]
        self.add_mesh(np.asarray(verts, np.float32), np.asarray(tris), mat)

    def add_icosphere(self, center, radius: float, mat: int, subdiv: int = 3) -> None:
        verts, tris = icosphere(subdiv)
        self.add_mesh(verts * radius + np.asarray(center, np.float32), tris, mat)

    def build(self) -> Tuple[MeshData, List[MaterialDesc]]:
        pos = np.concatenate(self.positions).astype(np.float32)
        tris = np.concatenate(self.triangles).astype(np.int32)
        mat_tri = np.concatenate(self.mat_of_tri)
        # Expand to per-corner vertices so each corner carries its material id
        # (matching the reference's per-vertex matId, Vertex.h:5-18). Vertices
        # are duplicated per triangle, giving flat shading normals, which is
        # what the path tracer uses anyway (geometric normals).
        flat_pos = pos[tris.reshape(-1)]
        flat_tris = np.arange(tris.size, dtype=np.int32).reshape(-1, 3)
        flat_mid = np.repeat(mat_tri, 3).astype(np.int32)
        mesh = MeshData(
            positions=flat_pos,
            normals=np.zeros_like(flat_pos),
            uvs=np.zeros((len(flat_pos), 2), np.float32),
            mat_ids=flat_mid,
            triangles=flat_tris,
        )
        return mesh, self.materials


def icosphere(subdiv: int) -> Tuple[np.ndarray, np.ndarray]:
    """Unit icosphere: 20 * 4^subdiv triangles."""
    t = (1.0 + math.sqrt(5.0)) / 2.0
    verts = np.asarray([
        [-1, t, 0], [1, t, 0], [-1, -t, 0], [1, -t, 0],
        [0, -1, t], [0, 1, t], [0, -1, -t], [0, 1, -t],
        [t, 0, -1], [t, 0, 1], [-t, 0, -1], [-t, 0, 1]], np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    tris = np.asarray([
        [0, 11, 5], [0, 5, 1], [0, 1, 7], [0, 7, 10], [0, 10, 11],
        [1, 5, 9], [5, 11, 4], [11, 10, 2], [10, 7, 6], [7, 1, 8],
        [3, 9, 4], [3, 4, 2], [3, 2, 6], [3, 6, 8], [3, 8, 9],
        [4, 9, 5], [2, 4, 11], [6, 2, 10], [8, 6, 7], [9, 8, 1]], np.int64)
    for _ in range(subdiv):
        cache = {}
        vlist = list(verts)

        def midpoint(a, b):
            key = (min(a, b), max(a, b))
            if key not in cache:
                m = (vlist[a] + vlist[b]) / 2.0
                m = m / np.linalg.norm(m)
                cache[key] = len(vlist)
                vlist.append(m)
            return cache[key]

        new_tris = []
        for a, b, c in tris:
            ab, bc, ca = midpoint(a, b), midpoint(b, c), midpoint(c, a)
            new_tris += [[a, ab, ca], [b, bc, ab], [c, ca, bc], [ab, bc, ca]]
        verts = np.asarray(vlist)
        tris = np.asarray(new_tris, np.int64)
    return verts.astype(np.float32), tris


# ----------------------------------------------------------------------------
# Scenes
# ----------------------------------------------------------------------------

def cornell_box():
    sb = SceneBuilder()
    white = sb.add_material(name="white", albedo=(0.73, 0.73, 0.73))
    red = sb.add_material(name="red", albedo=(0.65, 0.05, 0.05))
    green = sb.add_material(name="green", albedo=(0.12, 0.45, 0.15))
    light = sb.add_material(name="light", albedo=(0.0, 0.0, 0.0),
                            emission=(15.0, 15.0, 15.0))
    s = 5.5  # box scale (x: 0..s, y: 0..s, z: 0..s); normals face inward
    sb.add_quad([0, 0, 0], [0, 0, s], [s, 0, s], [s, 0, 0], white)        # floor +y
    sb.add_quad([0, s, 0], [s, s, 0], [s, s, s], [0, s, s], white)        # ceiling -y
    sb.add_quad([0, 0, s], [0, s, s], [s, s, s], [s, 0, s], white)        # back -z
    sb.add_quad([0, 0, 0], [0, s, 0], [0, s, s], [0, 0, s], red)          # left +x
    sb.add_quad([s, 0, 0], [s, 0, s], [s, s, s], [s, s, 0], green)        # right -x
    c, hw = s / 2, s * 0.24
    eps = 0.01
    sb.add_quad([c - hw, s - eps, c - hw], [c + hw, s - eps, c - hw],
                [c + hw, s - eps, c + hw], [c - hw, s - eps, c + hw], light)
    sb.add_box([c - 2.0, 0, c + 0.3], [c - 0.4, 3.3, c + 1.9], white)     # tall
    sb.add_box([c + 0.2, 0, c - 1.9], [c + 1.8, 1.65, c - 0.3], white)    # short
    return sb.build()


def bunny_scene(subdiv: int = 4):
    """Config 1 stand-in: ~5k-tri sphere 'bunny' on a plane, white env."""
    sb = SceneBuilder()
    grey = sb.add_material(name="ground", albedo=(0.55, 0.55, 0.55))
    body = sb.add_material(name="bunny", albedo=(0.75, 0.71, 0.68),
                           roughness_g=0.6)
    g = 50.0
    sb.add_quad([-g, 0, -g], [-g, 0, g], [g, 0, g], [g, 0, -g], grey)  # +y up
    sb.add_icosphere([0.0, 1.0, 0.0], 1.0, body, subdiv=subdiv)
    sb.add_icosphere([0.45, 2.1, 0.0], 0.45, body, subdiv=max(subdiv - 1, 1))
    return sb.build()


def table_scene():
    """Config 2 stand-in: room, table with legs, objects, light panel."""
    sb = SceneBuilder()
    wall = sb.add_material(name="wall", albedo=(0.7, 0.68, 0.64))
    wood = sb.add_material(name="wood", albedo=(0.42, 0.26, 0.13),
                           roughness_g=0.5)
    metal = sb.add_material(name="metal", albedo=(0.9, 0.9, 0.92),
                            roughness_g=0.3, metallic=1.0)
    cloth = sb.add_material(name="cloth", albedo=(0.2, 0.3, 0.6))
    light = sb.add_material(name="light", emission=(22.0, 21.0, 19.0),
                            albedo=(0.0, 0.0, 0.0))
    sb.add_box([-8, 0, -8], [8, 7, 8], wall, inside=True)               # room
    sb.add_box([-2.5, 2.2, -1.5], [2.5, 2.5, 1.5], wood)                # top
    for dx, dz in [(-2.2, -1.2), (2.2, -1.2), (-2.2, 1.2), (2.2, 1.2)]:
        sb.add_box([dx - 0.15, 0, dz - 0.15], [dx + 0.15, 2.2, dz + 0.15], wood)
    sb.add_icosphere([-1.0, 3.1, 0.0], 0.6, metal, subdiv=4)
    sb.add_box([0.8, 2.5, -0.6], [1.8, 3.3, 0.4], cloth)
    sb.add_cylinder([0.0, 2.5, 0.9], 0.25, 1.0, wood, segments=24)
    eps = 0.02
    sb.add_quad([-2, 7 - eps, -2], [2, 7 - eps, -2], [2, 7 - eps, 2],
                [-2, 7 - eps, 2], light)  # -y, shines down
    return sb.build()


def sponza_like(target_tris: int = 260_000):
    """Config 3 stand-in: colonnade atrium at ~target_tris triangles.

    Two floors of columns around a courtyard, coffered ceiling, and a dense
    field of deterministic ornamental spheres to reach Sponza-scale geometry
    with real BVH depth variation. Lit by a bright ceiling aperture (area
    light) => NEE-heavy, like the Sponza config.
    """
    sb = SceneBuilder()
    stone = sb.add_material(name="stone", albedo=(0.62, 0.58, 0.52))
    stone2 = sb.add_material(name="stone2", albedo=(0.5, 0.46, 0.42),
                             roughness_g=0.8)
    cloth = sb.add_material(name="banner", albedo=(0.55, 0.12, 0.1))
    light = sb.add_material(name="skylight", emission=(18.0, 17.5, 16.0),
                            albedo=(0.0, 0.0, 0.0))
    L, W_, H = 24.0, 10.0, 12.0
    sb.add_box([-L, 0, -W_], [L, H, W_], stone, inside=True)
    # Column rows (two floors).
    n_cols = 12
    seg = 48
    for i in range(n_cols):
        x = -L + (2 * L) * (i + 0.5) / n_cols
        for z in (-W_ * 0.55, W_ * 0.55):
            sb.add_cylinder([x, 0.0, z], 0.45, 4.8, stone2, segments=seg)
            sb.add_box([x - 0.7, 4.8, z - 0.7], [x + 0.7, 5.3, z + 0.7], stone)
            sb.add_cylinder([x, 5.3, z], 0.38, 4.2, stone2, segments=seg)
            sb.add_box([x - 0.6, 9.5, z - 0.6], [x + 0.6, 10.0, z + 0.6], stone)
    # Upper-floor walkway slabs.
    for z0, z1 in [(-W_, -W_ * 0.45), (W_ * 0.45, W_)]:
        sb.add_box([-L, 5.3, z0], [L, 5.55, z1], stone)
    # Hanging banners.
    for i in range(6):
        x = -L + (2 * L) * (i + 0.5) / 6
        sb.add_quad([x - 1.2, 8.5, 0.0], [x + 1.2, 8.5, 0.0],
                    [x + 1.2, 5.5, 0.3], [x - 1.2, 5.5, 0.3], cloth)
    # Ceiling aperture light (-y, shines down).
    sb.add_quad([-L * 0.5, H - 0.02, -W_ * 0.3], [L * 0.5, H - 0.02, -W_ * 0.3],
                [L * 0.5, H - 0.02, W_ * 0.3], [-L * 0.5, H - 0.02, W_ * 0.3],
                light)
    # Ornamental sphere field to reach target triangle count.
    count_so_far = sum(len(t) for t in sb.triangles)
    per_sphere = 20 * 4 ** 2  # subdiv 2 = 320 tris
    n_spheres = max((target_tris - count_so_far) // per_sphere, 0)
    rng = np.random.RandomState(1234)  # deterministic scene build
    for _ in range(n_spheres):
        x = rng.uniform(-L * 0.92, L * 0.92)
        z = rng.uniform(-W_ * 0.92, W_ * 0.92)
        y = rng.uniform(0.25, 1.2)
        r = rng.uniform(0.12, 0.3)
        sb.add_icosphere([x, y, z], r, stone2 if rng.rand() < 0.7 else cloth,
                         subdiv=2)
    return sb.build()


def bathroom_like():
    """Config 4 stand-in: 'Salle de Bain' — tiled room, tub, metallic mirror,
    window light; rendered with Beckmann microfacets + DoF."""
    sb = SceneBuilder()
    tile = sb.add_material(name="tile", albedo=(0.8, 0.8, 0.78),
                           roughness_g=0.35)
    porcelain = sb.add_material(name="porcelain", albedo=(0.9, 0.9, 0.88),
                                roughness_g=0.25)
    mirror = sb.add_material(name="mirror", albedo=(0.95, 0.95, 0.95),
                             roughness_g=0.05, metallic=1.0)
    wood = sb.add_material(name="wood", albedo=(0.35, 0.22, 0.12),
                           roughness_g=0.55)
    light = sb.add_material(name="window", emission=(30.0, 29.0, 26.0),
                            albedo=(0.0, 0.0, 0.0))
    sb.add_box([-6, 0, -5], [6, 6, 5], tile, inside=True)
    # Tub: outer shell minus inner cavity (5 slabs).
    sb.add_box([-4.5, 0, -3.5], [-0.5, 1.4, -0.5], porcelain)
    sb.add_box([-4.3, 0.5, -3.3], [-0.7, 1.45, -0.7], tile)
    # Vanity + mirror.
    sb.add_box([1.5, 0, -4.9], [5.5, 1.6, -3.9], wood)
    sb.add_quad([1.8, 2.2, -4.98], [5.2, 2.2, -4.98],
                [5.2, 4.6, -4.98], [1.8, 4.6, -4.98], mirror)
    # Props.
    sb.add_icosphere([2.2, 1.9, -4.3], 0.3, porcelain, subdiv=3)
    sb.add_cylinder([4.5, 1.6, -4.4], 0.2, 0.6, porcelain, segments=24)
    sb.add_icosphere([-2.5, 0.8, -2.0], 0.35, porcelain, subdiv=3)
    # Window (area light) on +x wall.
    eps = 0.02
    sb.add_quad([6 - eps, 2.0, -2.0], [6 - eps, 2.0, 2.0],
                [6 - eps, 5.0, 2.0], [6 - eps, 5.0, -2.0], light)
    return sb.build()


PROCEDURAL_SCENES = {
    "cornell": cornell_box,
    "bunny": bunny_scene,
    "table": table_scene,
    "sponza": sponza_like,
    "bathroom": bathroom_like,
}

# Default cameras per scene (position, yaw, pitch, fov_deg, aperture, focus).
DEFAULT_CAMERAS = {
    "cornell": ((2.75, 2.75, -7.0), math.pi, 0.0, 45.0, 0.0, 90.0),
    "bunny": ((0.0, 2.2, -6.5), math.pi, -0.12, 45.0, 0.0, 90.0),
    "table": ((0.0, 4.0, -7.2), math.pi, -0.18, 55.0, 0.12, 7.5),
    "sponza": ((-18.0, 4.5, 0.0), math.pi / 2, -0.05, 60.0, 0.0, 90.0),
    "bathroom": ((4.0, 3.5, 3.5), -0.58, -0.27, 55.0, 0.1, 8.0),
}


def default_camera(name: str):
    key = name.split(":", 1)[-1]
    return DEFAULT_CAMERAS.get(key)


def load_procedural(name: str):
    key = name.split(":", 1)[-1]
    if key not in PROCEDURAL_SCENES:
        raise KeyError(f"unknown procedural scene {name!r}; "
                       f"have {sorted(PROCEDURAL_SCENES)}")
    return PROCEDURAL_SCENES[key]()
