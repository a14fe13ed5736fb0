"""Environment maps as lat-long radiance images (counterpart of the JAX
package's scene/envmap.py).

Supported skybox specs (Renderer.cpp:236-325 grammar): "GENERATE COLOR
WHITE|BLACK|r g b", equirectangular .hdr maps and image maps, and a .txt
list of six cube faces (GL +X, -X, +Y, -Y, +Z, -Z), resampled to a
lat-long image once at load. Images go through the port's decoders
(utils/io.py ``load_image``: PNG, JPEG, BMP, TGA, GIF, TIFF, DDS, PSD,
WebP, JPEG 2000, ICNS and the simple formats, bitwise PIL's); a sky or face
in a format PIL reads and the port does not (AVIF, HTJ2K, ...: ROADMAP.md
C6) raises NotImplementedError naming the file, and bytes PIL cannot read
(an EXR: PIL has no EXR reader) raise ValueError naming it, as the JAX
package's PIL raises.
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from gpupathtracer_tpu_torch.utils.io import load_image


class EnvMap(NamedTuple):
    """Lat-long radiance map."""

    image: torch.Tensor  # [H, W, 3] float32, linear radiance


def dir_to_equirect_uv(d):
    """Direction -> lat-long uv (EquirectangularConverter.frag:9-16):
    uv = (atan(z, x) * 0.1591, asin(y) * 0.3183) + 0.5."""
    u = torch.atan2(d[..., 2], d[..., 0]) * 0.15915494 + 0.5
    v = torch.asin(torch.clamp(d[..., 1], -1.0, 1.0)) * 0.31830987 + 0.5
    return u, v


def sample_env(env: EnvMap, directions) -> torch.Tensor:
    """Bilinear lat-long lookup for unit `directions` [..., 3] -> [..., 3]."""
    img = env.image
    h, w = img.shape[0], img.shape[1]
    if h == 1 and w == 1:
        return img[0, 0].expand(directions.shape)
    u, v = dir_to_equirect_uv(directions)
    # v=0 is the bottom (asin(-1)); image row 0 is stored as the bottom row.
    x = u * w - 0.5
    y = v * h - 0.5
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[..., None]
    fy = (y - y0)[..., None]
    xi0 = torch.remainder(x0.to(torch.int64), w)        # wrap in longitude
    xi1 = torch.remainder(xi0 + 1, w)
    yi = y0.to(torch.int64)
    yi0 = torch.clamp(yi, 0, h - 1)                     # clamp in latitude
    yi1 = torch.clamp(yi + 1, 0, h - 1)
    c00 = img[yi0, xi0]
    c01 = img[yi0, xi1]
    c10 = img[yi1, xi0]
    c11 = img[yi1, xi1]
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy)
            + (c10 * (1 - fx) + c11 * fx) * fy)


def _cubemap_to_equirect(faces: np.ndarray, out_h: int = 512) -> np.ndarray:
    """Resample 6 cube faces [6, S, S, 3] (GL +X,-X,+Y,-Y,+Z,-Z order) to a
    lat-long image (nearest; done once at load)."""
    out_w = out_h * 2
    v = (np.arange(out_h) + 0.5) / out_h
    u = (np.arange(out_w) + 0.5) / out_w
    uu, vv = np.meshgrid(u, v)
    phi = (uu - 0.5) / 0.15915494
    theta = (vv - 0.5) / 0.31830987
    d = np.stack([np.cos(theta) * np.cos(phi), np.sin(theta),
                  np.cos(theta) * np.sin(phi)], axis=-1)
    ax, ay, az = np.abs(d[..., 0]), np.abs(d[..., 1]), np.abs(d[..., 2])
    # Standard GL cubemap face selection + (s,t) derivation.
    face = np.where(ax >= np.maximum(ay, az),
                    np.where(d[..., 0] > 0, 0, 1),
                    np.where(ay >= az, np.where(d[..., 1] > 0, 2, 3),
                             np.where(d[..., 2] > 0, 4, 5)))
    x, y, z = d[..., 0], d[..., 1], d[..., 2]
    sc = np.choose(face, [-z, z, x, x, x, -x])
    tc = np.choose(face, [-y, -y, z, -z, -y, -y])
    ma = np.choose(face, [ax, ax, ay, ay, az, az])
    s = (sc / np.maximum(ma, 1e-9) + 1.0) / 2.0
    t = (tc / np.maximum(ma, 1e-9) + 1.0) / 2.0
    size = faces.shape[1]
    si = np.clip((s * size).astype(np.int64), 0, size - 1)
    ti = np.clip((t * size).astype(np.int64), 0, size - 1)
    return faces[face, ti, si].astype(np.float32)


def _color(rgb) -> np.ndarray:
    return np.broadcast_to(np.asarray(rgb, np.float32), (2, 4, 3)).copy()


def environment_image(spec: str, base_dir: str = ".") -> np.ndarray:
    """The [H, W, 3] float32 lat-long image of a skybox spec string
    (Renderer.cpp:238-318 grammar)."""
    spec = spec.strip()
    if spec.startswith("GENERATE"):
        parts = spec.split()
        if len(parts) >= 3 and parts[1] == "COLOR":
            if len(parts) >= 5:
                try:  # numeric "GENERATE COLOR r g b" (beyond the reference)
                    return _color(tuple(float(x) for x in parts[2:5]))
                except ValueError:
                    pass
            return _color({"WHITE": (1.0, 1.0, 1.0),
                           "BLACK": (0.0, 0.0, 0.0)}.get(
                parts[2], (1.0, 0.0, 0.0)))  # RED for error, like the reference
        return _color((1.0, 0.0, 0.0))
    path = spec if os.path.isabs(spec) else os.path.join(base_dir, spec)
    ext = os.path.splitext(path)[1].lower()
    if ext in (".hdr", ".jpg", ".jpeg", ".png", ".exr"):
        # Image files store row 0 at the top; the lat-long convention keeps
        # row 0 at the bottom (v=0 <-> y=-1), so flip.
        return np.ascontiguousarray(load_image(path)[::-1], np.float32)
    if ext == ".txt":
        with open(path) as f:
            names = [ln.strip() for ln in f if ln.strip()]
        folder = os.path.dirname(path)
        faces = np.stack([load_image(os.path.join(folder, n))
                          for n in names[:6]])
        return _cubemap_to_equirect(faces)
    raise ValueError(f"unrecognized skybox spec {spec!r}")
