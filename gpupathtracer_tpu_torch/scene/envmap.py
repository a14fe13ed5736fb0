"""Environment maps as lat-long radiance images (counterpart of the JAX
package's scene/envmap.py).

Supported skybox specs (Renderer.cpp:236-325 grammar): "GENERATE COLOR
WHITE|BLACK|r g b" and Radiance .hdr equirectangular maps. Cubemap lists
and LDR (.jpg/.png) maps are not ported yet (ROADMAP.md, queue A).
"""

from __future__ import annotations

import os
from typing import NamedTuple

import numpy as np
import torch

from gpupathtracer_tpu_torch.utils.io import load_hdr


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
    if ext == ".hdr":
        # Image files store row 0 at the top; the lat-long convention keeps
        # row 0 at the bottom (v=0 <-> y=-1), so flip.
        return np.ascontiguousarray(load_hdr(path)[::-1])
    if ext in (".jpg", ".jpeg", ".png", ".exr", ".txt"):
        raise NotImplementedError(
            f"skybox {spec!r}: LDR and cubemap environments are not ported "
            f"yet (ROADMAP.md, queue A: image environment maps)")
    raise ValueError(f"unrecognized skybox spec {spec!r}")
