"""Generated multi-material textured OBJ scene ("textured town") and the
demo glTF: copies of generate_textured_town (with its helpers) and
write_demo_gltf from the JAX package's scene/samplegen.py, which
tests/test_torch_textures.py and tests/test_torch_gltf.py hold them to
byte for byte.

The reference's bread and butter is multi-material textured OBJ scenes
(src/core/Scene.cpp:120-231 + Material.glsl:43-44); the repo's checked-in
demo is only 12 triangles. This generator writes a deterministic ~55k-tri
OBJ + MTL + PNG-texture set to exercise loader -> atlas -> wavefront under
realistic load (several albedo maps, per-face materials, UV seams) without
bloating the repo with binary assets. The PNGs are written by the port's
own writer (utils/io.py save_png).
"""

from __future__ import annotations

import os

import numpy as np

from gpupathtracer_tpu_torch.utils.io import save_png


# ---------------------------------------------------------------------------
# texture painters (deterministic, 128x128 RGB in [0,1])

def _checker(n=128, a=(0.9, 0.9, 0.85), b=(0.12, 0.12, 0.15), cells=8):
    yy, xx = np.mgrid[0:n, 0:n]
    m = ((xx * cells // n + yy * cells // n) % 2).astype(np.float32)
    img = np.where(m[..., None] > 0, np.float32(a), np.float32(b))
    return img


def _bricks(n=128, mortar=(0.75, 0.72, 0.68), brick=(0.55, 0.2, 0.15)):
    img = np.full((n, n, 3), np.float32(brick))
    rows = 8
    rh = n // rows
    for r in range(rows):
        y = r * rh
        img[y:y + 2] = mortar
        offset = (r % 2) * (n // 8)
        for c in range(0, n, n // 4):
            x = (c + offset) % n
            img[y:y + rh, x:x + 2] = mortar
    # slight per-pixel variation so filtering is visible
    rng = np.random.RandomState(7)
    img *= (0.9 + 0.2 * rng.rand(n, n, 1)).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


def _stripes(n=128, a=(0.75, 0.45, 0.2), b=(0.5, 0.28, 0.12), period=16):
    yy = np.mgrid[0:n, 0:n][0]
    m = ((yy // period) % 2).astype(np.float32)
    return np.where(m[..., None] > 0, np.float32(a), np.float32(b))


def _foliage(n=128):
    rng = np.random.RandomState(11)
    base = np.float32([0.15, 0.45, 0.18])
    img = base * (0.6 + 0.8 * rng.rand(n, n, 1)).astype(np.float32)
    return np.clip(img, 0.0, 1.0)


# ---------------------------------------------------------------------------
# geometry emitters (append to shared vertex/uv lists; faces carry usemtl)

class _ObjWriter:
    def __init__(self):
        self.v, self.vt, self.vn = [], [], []
        self.faces = []  # (mtl, [(vi, ti, ni) x 3])

    def add_tri(self, mtl, pts, uvs, nrm):
        base_v = len(self.v)
        base_t = len(self.vt)
        base_n = len(self.vn)
        self.v.extend(pts)
        self.vt.extend(uvs)
        self.vn.append(nrm)
        self.faces.append((mtl, [(base_v + k, base_t + k, base_n)
                                 for k in range(3)]))

    def add_quad(self, mtl, p0, p1, p2, p3, uv_scale=1.0):
        n = np.cross(np.subtract(p1, p0), np.subtract(p3, p0))
        ln = np.linalg.norm(n)
        n = tuple(n / ln) if ln > 0 else (0.0, 1.0, 0.0)
        u = uv_scale
        self.add_tri(mtl, [p0, p1, p2], [(0, 0), (u, 0), (u, u)], n)
        self.add_tri(mtl, [p0, p2, p3], [(0, 0), (u, u), (0, u)], n)

    def write(self, path, mtl_name):
        with open(path, "w") as f:
            f.write(f"mtllib {mtl_name}\n")
            for p in self.v:
                f.write(f"v {p[0]:.5g} {p[1]:.5g} {p[2]:.5g}\n")
            for t in self.vt:
                f.write(f"vt {t[0]:.5g} {t[1]:.5g}\n")
            for nr in self.vn:
                f.write(f"vn {nr[0]:.5g} {nr[1]:.5g} {nr[2]:.5g}\n")
            cur = None
            for mtl, corners in self.faces:
                if mtl != cur:
                    f.write(f"usemtl {mtl}\n")
                    cur = mtl
                f.write("f " + " ".join(
                    f"{vi + 1}/{ti + 1}/{ni + 1}" for vi, ti, ni in corners)
                    + "\n")


def _box(w, base, size, wall_mtl):
    x, y, z = base
    sx, sy, sz = size
    a = (x, y, z); b = (x + sx, y, z); c = (x + sx, y, z + sz)
    d = (x, y, z + sz)
    A = (x, y + sy, z); B = (x + sx, y + sy, z)
    C = (x + sx, y + sy, z + sz); D = (x, y + sy, z + sz)
    # Corner order chosen so cross(p1-p0, p3-p0) points OUT of the box.
    w.add_quad(wall_mtl, a, A, B, b)          # -z wall
    w.add_quad(wall_mtl, c, C, D, d)          # +z wall
    w.add_quad(wall_mtl, b, B, C, c)          # +x wall
    w.add_quad(wall_mtl, d, D, A, a)          # -x wall
    w.add_quad(wall_mtl, A, D, C, B)          # top (capped by roof usually)


def _roof(w, base, size, mtl):
    x, y, z = base
    sx, sy, sz = size
    ridge_y = y + sy
    r0 = (x + sx / 2, ridge_y, z)
    r1 = (x + sx / 2, ridge_y, z + sz)
    A = (x, y, z); B = (x + sx, y, z)
    C = (x + sx, y, z + sz); D = (x, y, z + sz)
    w.add_quad(mtl, A, D, r1, r0)   # -x slope, normal (-x, +y)
    w.add_quad(mtl, r0, r1, C, B)   # +x slope, normal (+x, +y)
    n = (0.0, 0.0, -1.0)
    w.add_tri(mtl, [A, B, r0], [(0, 0), (1, 0), (0.5, 1)], n)
    w.add_tri(mtl, [D, r1, C], [(0, 0), (0.5, 1), (1, 0)], (0.0, 0.0, 1.0))


def _icosphere(w, center, radius, mtl, subdiv=3):
    t = (1.0 + 5 ** 0.5) / 2.0
    verts = np.array([(-1, t, 0), (1, t, 0), (-1, -t, 0), (1, -t, 0),
                      (0, -1, t), (0, 1, t), (0, -1, -t), (0, 1, -t),
                      (t, 0, -1), (t, 0, 1), (-t, 0, -1), (-t, 0, 1)],
                     np.float64)
    verts /= np.linalg.norm(verts, axis=1, keepdims=True)
    faces = [(0, 11, 5), (0, 5, 1), (0, 1, 7), (0, 7, 10), (0, 10, 11),
             (1, 5, 9), (5, 11, 4), (11, 10, 2), (10, 7, 6), (7, 1, 8),
             (3, 9, 4), (3, 4, 2), (3, 2, 6), (3, 6, 8), (3, 8, 9),
             (4, 9, 5), (2, 4, 11), (6, 2, 10), (8, 6, 7), (9, 8, 1)]
    vlist = [tuple(v) for v in verts]
    cache = {}

    def mid(i, j):
        key = (min(i, j), max(i, j))
        if key not in cache:
            m = np.add(vlist[i], vlist[j]) / 2.0
            m /= np.linalg.norm(m)
            cache[key] = len(vlist)
            vlist.append(tuple(m))
        return cache[key]

    for _ in range(subdiv):
        nf = []
        for i, j, k in faces:
            a, b, c = mid(i, j), mid(j, k), mid(k, i)
            nf += [(i, a, c), (a, j, b), (a, b, c), (c, b, k)]
        faces = nf

    def uv(p):
        return (0.5 + np.arctan2(p[2], p[0]) / (2 * np.pi),
                0.5 - np.arcsin(np.clip(p[1], -1, 1)) / np.pi)

    cx, cy, cz = center
    for i, j, k in faces:
        pts = [(cx + radius * vlist[q][0], cy + radius * vlist[q][1],
                cz + radius * vlist[q][2]) for q in (i, j, k)]
        n = tuple(np.mean([vlist[q] for q in (i, j, k)], axis=0))
        w.add_tri(mtl, pts, [uv(vlist[q]) for q in (i, j, k)], n)


def write_demo_gltf(path: str) -> str:
    """Write a small self-contained .gltf (base64 buffer): a grey ground
    quad, a rough red box, a metallic box, and an emissive ceiling quad —
    enough materials/nodes to exercise the full glTF pipeline (BASELINE
    config 5) in multi-chip dryruns without binary assets."""
    import base64
    import json

    def quad(x0, y, z0, x1, z1, up=True):
        p = np.asarray([[x0, y, z0], [x1, y, z0], [x1, y, z1], [x0, y, z1]],
                       np.float32)
        n = np.tile(np.asarray([[0, 1 if up else -1, 0]], np.float32), (4, 1))
        t = np.asarray([[0, 0], [1, 0], [1, 1], [0, 1]], np.float32)
        idx = [0, 1, 2, 0, 2, 3] if up else [0, 2, 1, 0, 3, 2]
        return p, n, t, np.asarray(idx, np.uint16)

    def box(cx, cz, s, h):
        pts, nrm, uv, idx = [], [], [], []
        faces = [((0, 1, 0), [(-s, h, -s), (s, h, -s), (s, h, s), (-s, h, s)]),
                 ((0, 0, -1), [(-s, 0, -s), (-s, h, -s), (s, h, -s), (s, 0, -s)]),
                 ((0, 0, 1), [(s, 0, s), (s, h, s), (-s, h, s), (-s, 0, s)]),
                 ((-1, 0, 0), [(-s, 0, s), (-s, h, s), (-s, h, -s), (-s, 0, -s)]),
                 ((1, 0, 0), [(s, 0, -s), (s, h, -s), (s, h, s), (s, 0, s)])]
        for n, corners in faces:
            b = len(pts)
            pts += [(cx + a, y, cz + c) for a, y, c in corners]
            nrm += [n] * 4
            uv += [(0, 0), (0, 1), (1, 1), (1, 0)]
            idx += [b, b + 1, b + 2, b, b + 2, b + 3]
        return (np.asarray(pts, np.float32), np.asarray(nrm, np.float32),
                np.asarray(uv, np.float32), np.asarray(idx, np.uint16))

    prims = [quad(-4, 0, -4, 4, 4), box(-1.4, 0.2, 0.8, 1.6),
             box(1.5, -0.8, 0.7, 2.4), quad(-1.5, 3.9, -1.5, 1.5, 1.5,
                                            up=False)]
    mats = [
        {"name": "floor", "pbrMetallicRoughness": {
            "baseColorFactor": [0.7, 0.7, 0.7, 1], "metallicFactor": 0.0,
            "roughnessFactor": 0.9}},
        {"name": "red", "pbrMetallicRoughness": {
            "baseColorFactor": [0.7, 0.15, 0.1, 1], "metallicFactor": 0.0,
            "roughnessFactor": 0.5}},
        {"name": "chrome", "pbrMetallicRoughness": {
            "baseColorFactor": [0.9, 0.9, 0.95, 1], "metallicFactor": 1.0,
            "roughnessFactor": 0.15}},
        {"name": "lamp", "pbrMetallicRoughness": {
            "baseColorFactor": [0, 0, 0, 1]},
         "emissiveFactor": [1.0, 0.95, 0.8],
         "extensions": {"KHR_materials_emissive_strength":
                        {"emissiveStrength": 12.0}}},
    ]
    blob = b""
    views, accessors, meshes = [], [], []
    for mi, (p, n, t, idx) in enumerate(prims):
        attrs = {}
        for arr, kind, ctype, aname in [(p, "VEC3", 5126, "POSITION"),
                                        (n, "VEC3", 5126, "NORMAL"),
                                        (t, "VEC2", 5126, "TEXCOORD_0"),
                                        (idx, "SCALAR", 5123, None)]:
            off = len(blob)
            raw = arr.tobytes()
            blob += raw + b"\0" * ((-len(raw)) % 4)
            views.append({"buffer": 0, "byteOffset": off,
                          "byteLength": len(raw)})
            acc = {"bufferView": len(views) - 1, "componentType": ctype,
                   "count": int(len(arr)), "type": kind}
            if aname == "POSITION":
                acc["min"] = [float(x) for x in arr.min(axis=0)]
                acc["max"] = [float(x) for x in arr.max(axis=0)]
            accessors.append(acc)
            if aname:
                attrs[aname] = len(accessors) - 1
        meshes.append({"primitives": [{"attributes": attrs,
                                       "indices": len(accessors) - 1,
                                       "material": mi}]})
    gltf = {
        "asset": {"version": "2.0"}, "scene": 0,
        "scenes": [{"nodes": list(range(len(meshes)))}],
        "nodes": [{"mesh": i} for i in range(len(meshes))],
        "meshes": meshes, "materials": mats,
        "buffers": [{"byteLength": len(blob),
                     "uri": "data:application/octet-stream;base64,"
                            + base64.b64encode(blob).decode()}],
        "bufferViews": views, "accessors": accessors,
    }
    with open(path, "w") as f:
        json.dump(gltf, f)
    return path


def generate_textured_town(out_dir: str, houses: int = 24,
                           trees: int = 10, sphere_subdiv: int = 4) -> str:
    """Write town.obj/.mtl + 4 PNG textures; returns the OBJ path.

    Defaults produce ~55k triangles across 6 materials (4 textured)."""
    os.makedirs(out_dir, exist_ok=True)
    tex = {"checker.png": _checker(), "bricks.png": _bricks(),
           "roof.png": _stripes(), "foliage.png": _foliage()}
    for name, img in tex.items():
        save_png(os.path.join(out_dir, name), img, flip_y=False)

    with open(os.path.join(out_dir, "town.mtl"), "w") as f:
        f.write("""newmtl ground
Kd 1 1 1
map_Kd checker.png
newmtl wall
Kd 1 1 1
map_Kd bricks.png
newmtl roof
Kd 1 1 1
map_Kd roof.png
newmtl tree
Kd 1 1 1
map_Kd foliage.png
newmtl lamp
Kd 0 0 0
Ke 18 16 12
newmtl metal
Kd 0.9 0.9 0.95
Ns 600
illum 3
""")

    w = _ObjWriter()
    S = 40.0
    # Corner order makes the normal face +y (cross(p1-p0, p3-p0) up).
    w.add_quad("ground", (-S, 0, -S), (-S, 0, S), (S, 0, S), (S, 0, -S),
               uv_scale=8.0)

    rng = np.random.RandomState(3)
    grid = int(np.ceil(np.sqrt(houses)))
    for h in range(houses):
        gx, gz = h % grid, h // grid
        x = -30.0 + gx * 60.0 / max(grid - 1, 1) + rng.uniform(-2, 2)
        z = -30.0 + gz * 60.0 / max(grid - 1, 1) + rng.uniform(-2, 2)
        sx, sy, sz = rng.uniform(3, 6), rng.uniform(2.5, 5), rng.uniform(3, 6)
        _box(w, (x, 0, z), (sx, sy, sz), "wall")
        _roof(w, (x, sy, z), (sx, rng.uniform(1, 2.5), sz), "roof")

    for t in range(trees):
        x, z = rng.uniform(-34, 34, 2)
        _icosphere(w, (x, 2.5, z), rng.uniform(1.2, 2.2), "tree",
                   subdiv=sphere_subdiv)
    _icosphere(w, (0.0, 1.6, 0.0), 1.6, "metal", subdiv=sphere_subdiv)

    # Light panel overhead (area light; the env can stay black).
    w.add_quad("lamp", (-6, 14, -6), (6, 14, -6), (6, 14, 6), (-6, 14, 6))

    path = os.path.join(out_dir, "town.obj")
    w.write(path, "town.mtl")
    return path
