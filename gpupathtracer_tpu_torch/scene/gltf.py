"""Pure-Python glTF 2.0 loader (.gltf + .bin, .glb, base64 data URIs): a
copy of the JAX package's scene/gltf.py on the port's own material and
mesh modules, which tests/test_torch_gltf.py holds to it byte for byte.

Role of tinygltf in the reference (linked but its loader path is commented
out, Scene.cpp:22-24; BASELINE.json config 5 nonetheless requires glTF
ingest, so this implements it). Supports: node hierarchy with TRS/matrix
transforms, triangle primitives (mode 4), POSITION/NORMAL/TEXCOORD_0,
u8/u16/u32 indices, pbrMetallicRoughness materials;
KHR_materials_transmission above 0.5 gives a refractive material with
KHR_materials_ior's index. File textures go to the atlas, where a map the
port's decoder does not read (a JPEG) raises (ROADMAP.md C6); data: image
URIs are skipped.

Material mapping to our shading convention (Material.glsl:47-48: shading
alpha = G^2 where G is the stored roughness channel): glTF defines
alpha = roughness^2, so stored roughness_g = glTF roughness directly.
"""

from __future__ import annotations

import base64
import json
import os
import struct
from typing import Dict, List, Optional, Tuple

import numpy as np

from gpupathtracer_tpu_torch.scene.materials import MaterialDesc, env_material
from gpupathtracer_tpu_torch.scene.mesh import MeshData, merge_meshes

_COMPONENT_DTYPES = {
    5120: np.int8, 5121: np.uint8, 5122: np.int16,
    5123: np.uint16, 5125: np.uint32, 5126: np.float32,
}
_TYPE_COUNTS = {"SCALAR": 1, "VEC2": 2, "VEC3": 3, "VEC4": 4,
                "MAT4": 16}


def _load_glb(path: str) -> Tuple[dict, bytes]:
    with open(path, "rb") as f:
        data = f.read()
    magic, version, _length = struct.unpack_from("<III", data, 0)
    if magic != 0x46546C67:
        raise ValueError(f"{path}: not a GLB file")
    offset = 12
    gltf_json: Optional[dict] = None
    bin_chunk = b""
    while offset < len(data):
        clen, ctype = struct.unpack_from("<II", data, offset)
        chunk = data[offset + 8:offset + 8 + clen]
        if ctype == 0x4E4F534A:   # 'JSON'
            gltf_json = json.loads(chunk)
        elif ctype == 0x004E4942:  # 'BIN'
            bin_chunk = chunk
        offset += 8 + clen
    assert gltf_json is not None, "GLB missing JSON chunk"
    return gltf_json, bin_chunk


def _resolve_buffer(buf: dict, folder: str, glb_bin: bytes) -> bytes:
    uri = buf.get("uri")
    if uri is None:
        return glb_bin
    if uri.startswith("data:"):
        return base64.b64decode(uri.split(",", 1)[1])
    with open(os.path.join(folder, uri), "rb") as f:
        return f.read()


class _Accessors:
    def __init__(self, gltf: dict, buffers: List[bytes]):
        self.gltf = gltf
        self.buffers = buffers

    def read(self, idx: int) -> np.ndarray:
        acc = self.gltf["accessors"][idx]
        view = self.gltf["bufferViews"][acc["bufferView"]]
        buf = self.buffers[view["buffer"]]
        dtype = _COMPONENT_DTYPES[acc["componentType"]]
        ncomp = _TYPE_COUNTS[acc["type"]]
        count = acc["count"]
        start = view.get("byteOffset", 0) + acc.get("byteOffset", 0)
        stride = view.get("byteStride") or np.dtype(dtype).itemsize * ncomp
        itemsize = np.dtype(dtype).itemsize
        if stride == itemsize * ncomp:
            arr = np.frombuffer(buf, dtype=dtype, count=count * ncomp,
                                offset=start).reshape(count, ncomp)
        else:  # interleaved
            raw = np.frombuffer(buf, dtype=np.uint8)
            out = np.empty((count, ncomp), dtype)
            for i in range(count):
                o = start + i * stride
                out[i] = np.frombuffer(raw[o:o + itemsize * ncomp],
                                       dtype=dtype)
            arr = out
        return arr.squeeze(-1) if ncomp == 1 else arr


def _node_matrix(node: dict) -> np.ndarray:
    if "matrix" in node:
        return np.asarray(node["matrix"], np.float64).reshape(4, 4).T
    m = np.eye(4)
    if "translation" in node:
        m[:3, 3] = node["translation"]
    if "rotation" in node:
        x, y, z, w = node["rotation"]
        r = np.array([
            [1 - 2 * (y * y + z * z), 2 * (x * y - z * w), 2 * (x * z + y * w)],
            [2 * (x * y + z * w), 1 - 2 * (x * x + z * z), 2 * (y * z - x * w)],
            [2 * (x * z - y * w), 2 * (y * z + x * w), 1 - 2 * (x * x + y * y)],
        ])
        m[:3, :3] = m[:3, :3] @ r
    if "scale" in node:
        m[:3, :3] = m[:3, :3] @ np.diag(node["scale"])
    return m


def load_gltf(path: str) -> Tuple[MeshData, List[MaterialDesc]]:
    try:
        return _load_gltf_impl(path)
    except (KeyError, IndexError, ValueError, struct.error,
            json.JSONDecodeError) as e:
        if isinstance(e, ValueError) and str(e).startswith(path):
            raise  # already contextual
        raise ValueError(
            f"{path}: invalid or unsupported glTF ({type(e).__name__}: "
            f"{e})") from e


def _load_gltf_impl(path: str) -> Tuple[MeshData, List[MaterialDesc]]:
    folder = os.path.dirname(os.path.abspath(path))
    if path.lower().endswith(".glb"):
        gltf, glb_bin = _load_glb(path)
    else:
        with open(path) as f:
            gltf = json.load(f)
        glb_bin = b""
    buffers = [_resolve_buffer(b, folder, glb_bin)
               for b in gltf.get("buffers", [])]
    acc = _Accessors(gltf, buffers)

    # Materials -> MaterialDescs (index shifted by 1: slot 0 = env).
    materials: List[MaterialDesc] = [env_material()]
    for m in gltf.get("materials", []):
        pbr = m.get("pbrMetallicRoughness", {})
        base = pbr.get("baseColorFactor", [1, 1, 1, 1])
        tex = None
        if "baseColorTexture" in pbr:
            ti = pbr["baseColorTexture"]["index"]
            src = gltf["textures"][ti].get("source")
            if src is not None:
                img = gltf["images"][src]
                if "uri" in img and not img["uri"].startswith("data:"):
                    tex = img["uri"]
        mr_tex = None
        if "metallicRoughnessTexture" in pbr:
            ti = pbr["metallicRoughnessTexture"]["index"]
            src = gltf["textures"][ti].get("source")
            if src is not None:
                img = gltf["images"][src]
                if "uri" in img and not img["uri"].startswith("data:"):
                    mr_tex = img["uri"]
        emissive = m.get("emissiveFactor", [0, 0, 0])
        strength = (m.get("extensions", {})
                    .get("KHR_materials_emissive_strength", {})
                    .get("emissiveStrength", 1.0))
        from gpupathtracer_tpu_torch.scene.materials import (
            MATERIAL_DIFFUSE_SPECULAR, MATERIAL_REFRACTIVE)
        exts = m.get("extensions", {})
        transmission = exts.get("KHR_materials_transmission", {}) \
            .get("transmissionFactor", 0.0)
        ior = exts.get("KHR_materials_ior", {}).get("ior", 1.5)
        mtype = (MATERIAL_REFRACTIVE if transmission > 0.5
                 else MATERIAL_DIFFUSE_SPECULAR)
        materials.append(MaterialDesc(
            name=m.get("name", ""),
            albedo=tuple(base[:3]),
            albedo_texture=tex,
            mr_texture=mr_tex,
            roughness_g=float(pbr.get("roughnessFactor", 1.0)),
            metallic=float(pbr.get("metallicFactor", 1.0)),
            emission=tuple(float(e) * strength for e in emissive),
            material_type=mtype,
            ior=float(ior),
        ))

    # Walk the scene graph, collecting transformed primitives.
    meshes: List[MeshData] = []

    def emit(mesh_idx: int, world: np.ndarray) -> None:
        normal_mat = np.linalg.inv(world[:3, :3]).T
        for prim in gltf["meshes"][mesh_idx]["primitives"]:
            if prim.get("mode", 4) != 4:
                continue
            attrs = prim["attributes"]
            pos = acc.read(attrs["POSITION"]).astype(np.float64)
            pos = pos @ world[:3, :3].T + world[:3, 3]
            n = len(pos)
            if "NORMAL" in attrs:
                nrm = acc.read(attrs["NORMAL"]).astype(np.float64) @ normal_mat.T
                lens = np.linalg.norm(nrm, axis=1, keepdims=True)
                nrm = nrm / np.maximum(lens, 1e-20)
            else:
                nrm = np.zeros((n, 3))
            uv = (acc.read(attrs["TEXCOORD_0"]).astype(np.float32)
                  if "TEXCOORD_0" in attrs else np.zeros((n, 2), np.float32))
            if "indices" in prim:
                idx = acc.read(prim["indices"]).astype(np.int64)
            else:
                idx = np.arange(n, dtype=np.int64)
            tris = idx.reshape(-1, 3)
            mat = prim.get("material")
            mat_id = (mat + 1) if mat is not None else 0
            if mat_id == 0:
                # primitives without material get a default (not the env)
                materials.append(MaterialDesc(name="__default__"))
                mat_id = len(materials) - 1
            meshes.append(MeshData(
                positions=pos.astype(np.float32),
                normals=nrm.astype(np.float32),
                uvs=uv,
                mat_ids=np.full(n, mat_id, np.int32),
                triangles=tris.astype(np.int32),
            ))

    def walk(node_idx: int, parent: np.ndarray) -> None:
        node = gltf["nodes"][node_idx]
        world = parent @ _node_matrix(node)
        if "mesh" in node:
            emit(node["mesh"], world)
        for child in node.get("children", []):
            walk(child, world)

    scene_idx = gltf.get("scene", 0)
    scenes = gltf.get("scenes", [])
    roots = scenes[scene_idx]["nodes"] if scenes else range(len(gltf.get("nodes", [])))
    for r in roots:
        walk(r, np.eye(4))
    if not meshes:  # no scene graph: flatten all meshes
        for i in range(len(gltf.get("meshes", []))):
            emit(i, np.eye(4))
    if not meshes:
        raise ValueError(f"{path}: glTF document contains no mesh "
                         "primitives")

    return merge_meshes(meshes), materials
