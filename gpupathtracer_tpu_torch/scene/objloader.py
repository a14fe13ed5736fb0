"""Pure-Python Wavefront OBJ/MTL loader.

Role of tinyobjloader in the reference (src/core/Scene.cpp:120-231). Supports
v/vt/vn/f (all index forms incl. negatives), polygon fan triangulation,
usemtl/mtllib, and the MTL keys the reference consumes (Kd, Ks, Ke, Ns,
illum, map_Kd). Material conversion heuristics live in materials.py and
match Scene.cpp:156-175.
"""

from __future__ import annotations

import os
from typing import Dict, List, Optional, Tuple

import numpy as np

from gpupathtracer_tpu_torch.scene.materials import (
    MaterialDesc, env_material, obj_material_heuristics)
from gpupathtracer_tpu_torch.scene.mesh import MeshData


def load_mtl(path: str) -> Dict[str, MaterialDesc]:
    """Parse a .mtl file into MaterialDescs keyed by material name."""
    mats: Dict[str, MaterialDesc] = {}
    cur: Optional[dict] = None

    def _flush():
        if cur is not None:
            mats[cur["name"]] = obj_material_heuristics(
                name=cur["name"], diffuse=cur["Kd"], specular=cur["Ks"],
                emission=cur["Ke"], shininess=cur["Ns"], illum=cur["illum"],
                diffuse_texname=cur["map_Kd"], ior=cur["Ni"])

    with open(path, errors="replace") as f:
        for raw in f:
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            if key == "newmtl":
                _flush()
                cur = dict(name=" ".join(parts[1:]), Kd=(0.8, 0.8, 0.8),
                           Ks=(0.0, 0.0, 0.0), Ke=(0.0, 0.0, 0.0),
                           Ns=0.0, illum=2, map_Kd="", Ni=1.5)
            elif cur is None:
                continue
            elif key in ("Kd", "Ks", "Ke"):
                cur[key] = tuple(float(x) for x in parts[1:4])
            elif key == "Ns":
                cur["Ns"] = float(parts[1])
            elif key == "illum":
                cur["illum"] = int(float(parts[1]))
            elif key == "Ni":
                cur["Ni"] = float(parts[1])
            elif key == "map_Kd":
                cur["map_Kd"] = parts[-1]
    _flush()
    return mats


def _parse_face_vert(token: str, nv: int, nt: int, nn: int) -> Tuple[int, int, int]:
    """'v', 'v/vt', 'v//vn', 'v/vt/vn' -> 0-based (v, vt, vn); -1 = missing."""
    fields = token.split("/")
    def fix(s: str, n: int) -> int:
        if not s:
            return -1
        i = int(s)
        return i - 1 if i > 0 else n + i
    v = fix(fields[0], nv)
    vt = fix(fields[1], nt) if len(fields) > 1 else -1
    vn = fix(fields[2], nn) if len(fields) > 2 else -1
    return v, vt, vn


def load_obj(path: str) -> Tuple[MeshData, List[MaterialDesc]]:
    """Load an OBJ (+MTL) file.

    Returns (mesh, materials) where materials[0] is the environment
    pseudo-material (Scene.cpp:158) and faces with no usemtl get a default
    material. Corners are deduplicated on (v, vt, vn, material) so the
    per-corner material id survives (the reference stores matId per Vertex,
    src/math/Vertex.h:5-18).
    """
    folder = os.path.dirname(os.path.abspath(path))
    positions: List[Tuple[float, float, float]] = []
    texcoords: List[Tuple[float, float]] = []
    normals: List[Tuple[float, float, float]] = []

    materials: List[MaterialDesc] = [env_material()]
    mat_index_by_name: Dict[str, int] = {}
    mtl_lib: Dict[str, MaterialDesc] = {}
    default_mat_index: Optional[int] = None
    cur_mat = -1  # -1 -> lazily create the default material

    corner_cache: Dict[Tuple[int, int, int, int], int] = {}
    out_pos: List[Tuple[float, float, float]] = []
    out_uv: List[Tuple[float, float]] = []
    out_nrm: List[Tuple[float, float, float]] = []
    out_mid: List[int] = []
    out_tris: List[Tuple[int, int, int]] = []

    def get_default_mat() -> int:
        nonlocal default_mat_index
        if default_mat_index is None:
            materials.append(MaterialDesc(name="__default__"))
            default_mat_index = len(materials) - 1
        return default_mat_index

    def corner(tok: str, mat: int) -> int:
        v, vt, vn = _parse_face_vert(tok, len(positions), len(texcoords),
                                     len(normals))
        key = (v, vt, vn, mat)
        idx = corner_cache.get(key)
        if idx is None:
            idx = len(out_pos)
            corner_cache[key] = idx
            out_pos.append(positions[v])
            out_uv.append(texcoords[vt] if vt >= 0 else (0.0, 0.0))
            out_nrm.append(normals[vn] if vn >= 0 else (0.0, 0.0, 0.0))
            out_mid.append(mat)
        return idx

    with open(path, errors="replace") as f:
        for lineno, raw in enumerate(f, 1):
            line = raw.strip()
            if not line or line.startswith("#"):
                continue
            parts = line.split()
            key = parts[0]
            try:
                if key == "v":
                    positions.append((float(parts[1]), float(parts[2]),
                                      float(parts[3])))
                elif key == "vt":
                    texcoords.append((float(parts[1]), float(parts[2])))
                elif key == "vn":
                    normals.append((float(parts[1]), float(parts[2]),
                                    float(parts[3])))
                elif key == "mtllib":
                    mtl_path = os.path.join(folder, " ".join(parts[1:]))
                    if os.path.exists(mtl_path):
                        mtl_lib.update(load_mtl(mtl_path))
                elif key == "usemtl":
                    name = " ".join(parts[1:])
                    if name not in mat_index_by_name:
                        desc = mtl_lib.get(name, MaterialDesc(name=name))
                        materials.append(desc)
                        mat_index_by_name[name] = len(materials) - 1
                    cur_mat = mat_index_by_name[name]
                elif key == "f":
                    mat = cur_mat if cur_mat >= 0 else get_default_mat()
                    ids = [corner(tok, mat) for tok in parts[1:]]
                    # Fan triangulation (the reference earcuts concave
                    # polygons, Scene.cpp:28; fans match for the convex
                    # faces in our corpus).
                    for i in range(1, len(ids) - 1):
                        out_tris.append((ids[0], ids[i], ids[i + 1]))
            except (ValueError, IndexError) as e:
                raise ValueError(
                    f"{path}:{lineno}: malformed OBJ statement "
                    f"{line!r} ({e})") from e

    mesh = MeshData(
        positions=np.asarray(out_pos, np.float32).reshape(-1, 3),
        normals=np.asarray(out_nrm, np.float32).reshape(-1, 3),
        uvs=np.asarray(out_uv, np.float32).reshape(-1, 2),
        mat_ids=np.asarray(out_mid, np.int32),
        triangles=np.asarray(out_tris, np.int32).reshape(-1, 3),
    )
    return mesh, materials
