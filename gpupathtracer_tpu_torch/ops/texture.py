"""Texture atlas sampling (counterpart of the JAX package's
ops/texture.py).

The reference samples per-material bindless textures (Material.glsl:43-44);
here every material image lives in ONE atlas (scene/textures.py) and is
sampled with bilinear gathers, REPEAT-wrapped within its sub-rectangle
(Texture.cpp:127-130). Trilinear sampling blends two mip levels.

Two roundings follow XLA's CPU code, where the JAX package's tests run:
``jnp.mod`` on floats is a truncated remainder with a sign fix (``_mod``),
and XLA contracts the multiply-adds of the lerps into fused multiply-adds,
written out here with ``fma32``.
"""

from __future__ import annotations

import torch

from gpupathtracer_tpu_torch.ops.intersect import fma32


def sample_atlas(atlas_image, atlas_rects, tex_id, uv, mips=None, lod=None):
    """Bilinear atlas lookup; trilinear when a mip table and lod are given.

    atlas_image: [H, W, 3] f32; atlas_rects: [R, 4] i32 (x, y, w, h);
    tex_id: [N] i32 (invalid ids must be masked by the caller); uv: [N, 2]
    f32. mips: [S, L] i32 level -> rect row of each texture slot; lod: [N]
    f32 mip level. Returns [N, 3]."""
    if mips is not None and lod is not None and mips.shape[1] > 1:
        levels = mips.shape[1]
        lod = torch.clamp(lod, 0.0, float(levels - 1))
        l0 = torch.floor(lod)
        f = (lod - l0)[:, None]
        row = mips[torch.clamp_min(tex_id, 0).long()]        # [N, L]
        l0i = l0.long()
        r0 = torch.gather(row, 1, l0i[:, None])[:, 0]
        r1 = torch.gather(row, 1, torch.clamp_max(l0i + 1,
                                                  levels - 1)[:, None])[:, 0]
        c0 = _bilinear(atlas_image, atlas_rects, r0, uv)
        c1 = _bilinear(atlas_image, atlas_rects, r1, uv)
        return _lerp(c0, c1, f)
    return _bilinear(atlas_image, atlas_rects, torch.clamp_min(tex_id, 0), uv)


def _lerp(a, b, f):
    """a * (1 - f) + b * f [N, 3] with f [N, 1], as XLA contracts it:
    fma(a, 1 - f, b * f)."""
    g = (1.0 - f).expand_as(a)
    return fma32(a, g, b * f)


def _mod(x, y):
    """``jnp.mod`` on floats: the truncated remainder, moved into y's sign
    where it is nonzero and of the other sign."""
    r = torch.fmod(x, y)
    return torch.where((r != 0) & ((r < 0) != (y < 0)), r + y, r)


def _bilinear(atlas_image, atlas_rects, rect_id, uv):
    """Bilinear lookup of rect rows ``rect_id`` [N] (REPEAT wrap)."""
    rect = atlas_rects[rect_id.long()]                       # [N, 4]
    rx = rect[:, 0].float()
    ry = rect[:, 1].float()
    rw = rect[:, 2].float()
    rh = rect[:, 3].float()

    u = uv[:, 0] - torch.floor(uv[:, 0])                     # REPEAT
    v = uv[:, 1] - torch.floor(uv[:, 1])
    x = fma32(u, rw, torch.full_like(u, -0.5))
    y = fma32(v, rh, torch.full_like(v, -0.5))
    x0 = torch.floor(x)
    y0 = torch.floor(y)
    fx = (x - x0)[:, None]
    fy = (y - y0)[:, None]
    wrap_w = torch.clamp_min(rw, 1.0)
    wrap_h = torch.clamp_min(rh, 1.0)

    def texel(xi, yi):
        # Wrap the bilinear neighbours within the sub-rect.
        gx = (rx + _mod(xi, wrap_w)).to(torch.int32).long()
        gy = (ry + _mod(yi, wrap_h)).to(torch.int32).long()
        return atlas_image[gy, gx]

    c00 = texel(x0, y0)
    c01 = texel(x0 + 1.0, y0)
    c10 = texel(x0, y0 + 1.0)
    c11 = texel(x0 + 1.0, y0 + 1.0)
    return _lerp(_lerp(c00, c01, fx), _lerp(c10, c11, fx), fy)
