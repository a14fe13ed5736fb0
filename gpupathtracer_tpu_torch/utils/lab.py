"""PIL's ``convert("RGB")`` of a LAB image, bit for bit: Pillow converts
LAB through LittleCMS (ImageCms: a built-in Lab profile, D50, to sRGB,
perceptual intent, 8 bits in and out). LittleCMS 2.17 optimizes that
transform into a 33 x 33 x 33 table of 16-bit RGB, sampled from its
floating-point pipeline, and evaluates it with its 16-bit tetrahedral
interpolation; lab_srgb.bin holds that table (zlib, little-endian uint16,
as tools/torch_image_fixtures.py --lab-table reads it out of the
LittleCMS the sandbox's Pillow bundles), and lab_to_rgb interpolates it as
LittleCMS does."""

from __future__ import annotations

import os
import zlib

import numpy as np

_TABLE = os.path.join(os.path.dirname(__file__), "lab_srgb.bin")
_clut = None
GRID = 33
# The table's strides: L, a, b, then R, G, B.
_OPTA = (3 * GRID * GRID, 3 * GRID, 3)


def _table() -> np.ndarray:
    global _clut
    if _clut is None:
        with open(_TABLE, "rb") as f:
            t = np.frombuffer(zlib.decompress(f.read()), "<u2")
        if t.size != GRID ** 3 * 3:
            raise ValueError(f"{_TABLE}: {t.size} entries, not {GRID ** 3 * 3}")
        _clut = t.astype(np.int64)
    return _clut


def lab_to_rgb(lab: np.ndarray) -> np.ndarray:
    """PIL's LAB pixels (uint8 [..., 3]: L, and a and b as PIL stores them)
    -> uint8 [..., 3] RGB. PIL hands LittleCMS a and b with their top bit
    flipped (its Lab profile reads 128 as 0); each byte x enters as the
    16-bit x * 257, and each 16-bit result v leaves as
    (v * 65281 + 2^23) >> 24."""
    clut = _table()
    lab = np.asarray(lab, np.uint8)
    words = lab.astype(np.int64) ^ np.array([0, 128, 128])
    words = words * 257
    fixed = words * (GRID - 1)
    fixed = fixed + (fixed + 0x7FFF) // 0xFFFF        # _cmsToFixedDomain
    node, rest = fixed >> 16, fixed & 0xFFFF
    rx, ry, rz = rest[..., 0], rest[..., 1], rest[..., 2]
    base = (node * np.array(_OPTA)).sum(-1)
    # A step to the next node in each input, none past the last one.
    step = np.where(words == 0xFFFF, 0, np.array(_OPTA))
    sx, sy, sz = step[..., 0], step[..., 1], step[..., 2]
    # TetrahedralInterp16: the six tetrahedra by the order of the rests,
    # each as the offsets of its three further corners, and the signs
    # that turn the corners' values into c1, c2 and c3.
    cases = [
        ((rx >= ry) & (ry >= rz), (sx, sx + sy, sx + sy + sz)),
        ((rx >= ry) & (ry < rz) & (rz >= rx), (sx + sz, sx + sy + sz, sz)),
        ((rx >= ry) & (ry < rz) & (rz < rx), (sx, sx + sy + sz, sx + sz)),
        ((rx < ry) & (rx >= rz), (sx + sy, sy, sx + sy + sz)),
        ((rx < ry) & (rx < rz) & (ry >= rz), (sx + sy + sz, sy, sy + sz)),
        ((rx < ry) & (rx < rz) & (ry < rz), (sx + sy + sz, sy + sz, sz))]
    out = np.zeros(lab.shape, np.int64)
    for ch in range(3):
        c0 = clut[base + ch]
        res = np.zeros_like(c0)
        for k, (mask, (o1, o2, o3)) in enumerate(cases):
            v1, v2, v3 = (clut[base + o + ch] for o in (o1, o2, o3))
            if k == 0:
                c1, c2, c3 = v1 - c0, v2 - v1, v3 - v2
            elif k == 1:
                c1, c2, c3 = v1 - v3, v2 - v1, v3 - c0
            elif k == 2:
                c1, c2, c3 = v1 - c0, v2 - v3, v3 - v1
            elif k == 3:
                c1, c2, c3 = v1 - v2, v2 - c0, v3 - v1
            elif k == 4:
                c1, c2, c3 = v1 - v3, v2 - c0, v3 - v2
            else:
                c1, c2, c3 = v1 - v2, v2 - v3, v3 - c0
            t = c1 * rx + c2 * ry + c3 * rz + 0x8001
            t = ((t + 2 ** 31) % 2 ** 32) - 2 ** 31     # int32
            res = np.where(mask, (c0 + ((t + (t >> 16)) >> 16)) & 0xFFFF,
                           res)
        out[..., ch] = res
    return ((out * 65281 + 8388608) >> 24).astype(np.uint8)
