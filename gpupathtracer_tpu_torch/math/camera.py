"""Thin-lens camera: image-plane generation and ray generation.

Counterpart of the JAX package's math/camera.py (reference:
src/math/Camera.cpp:6-22 image plane, Camera.cpp:58-69 lens ray). The
basis is built in float64 numpy, then stored as float32 tensors.
"""

from __future__ import annotations

from typing import NamedTuple, Tuple

import numpy as np
import torch

from gpupathtracer_tpu_torch.config import CameraConfig
from gpupathtracer_tpu_torch.math.vecmath import normalize, sqrt


class CameraParams(NamedTuple):
    """Precomputed image-plane basis (cf. Shader::LoadCamera)."""

    position: torch.Tensor     # [3]
    lower_left: torch.Tensor   # [3]
    horizontal: torch.Tensor   # [3]
    vertical: torch.Tensor     # [3]
    u: torch.Tensor            # [3] right basis
    v: torch.Tensor            # [3] up basis
    lens_radius: torch.Tensor  # scalar


def camera_from_numpy(fields: dict, device) -> CameraParams:
    """CameraParams from arrays keyed by field name (e.g. the JAX
    package's CameraParams as numpy), as float32 tensors on `device`."""
    return CameraParams(**{
        k: torch.tensor(np.asarray(fields[k], np.float32), device=device)
        for k in CameraParams._fields})


def generate_image_plane(cfg: CameraConfig, device) -> CameraParams:
    """Build the camera basis from pitch/yaw (Camera.cpp:6-22)."""
    pitch, yaw = cfg.pitch, cfg.yaw
    d = np.array([
        np.cos(pitch) * np.sin(yaw),
        np.sin(pitch),
        np.cos(pitch) * -np.cos(yaw),
    ], dtype=np.float64)
    direction = -d / np.linalg.norm(d)

    image_height = 2.0 * np.tan(cfg.fov / 2.0)
    image_width = cfg.aspect * image_height

    up = np.array([0.0, 1.0, 0.0])
    u = np.cross(up, direction)
    u = u / np.linalg.norm(u)
    v = np.cross(direction, u)

    horizontal = image_width * u * cfg.focal_distance
    vertical = image_height * v * cfg.focal_distance
    lower_left = -horizontal / 2.0 - vertical / 2.0 - direction * cfg.focal_distance
    return camera_from_numpy(dict(
        position=cfg.position, lower_left=lower_left, horizontal=horizontal,
        vertical=vertical, u=u, v=v, lens_radius=cfg.lens_radius), device)


def gen_rays(cam: CameraParams, interp: torch.Tensor,
             lens_u: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    """Thin-lens primary rays (Camera::GenRay, Camera.cpp:58-69).

    interp [N, 2]: image-plane position in [0,1)^2; lens_u [N, 2]: uniforms
    for the lens disk (phi = 2*pi*u0, r = sqrt(u1)). Returns (origins,
    directions), each [N, 3].
    """
    phi = 2.0 * torch.pi * lens_u[..., 0]
    r = sqrt(lens_u[..., 1])
    rd = cam.lens_radius * r
    offset = (cam.u[None, :] * (rd * torch.cos(phi))[..., None]
              + cam.v[None, :] * (rd * torch.sin(phi))[..., None])
    origin = cam.position[None, :] + offset
    target = (cam.lower_left[None, :]
              + interp[..., 0:1] * cam.horizontal[None, :]
              + interp[..., 1:2] * cam.vertical[None, :])
    direction = normalize(target - offset)
    return origin, direction
