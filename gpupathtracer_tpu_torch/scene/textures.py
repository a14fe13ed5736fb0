"""Texture atlas construction (host side; a copy of the JAX package's
scene/textures.py, which tests/test_torch_textures.py holds it to byte for
byte).

Packs all referenced material images into one atlas with simple shelf
packing. Returns the atlas image, per-slot rectangles, and the path->slot
mapping consumed by pack_materials. Images are read by the port's own
decoders (utils/io.py load_image: PNG, JPEG, BMP, TGA, GIF, TIFF, DDS,
PSD and .hdr, each bitwise PIL's).
"""

from __future__ import annotations

import os
from typing import Dict, List, Tuple

import numpy as np

from gpupathtracer_tpu_torch.utils.io import load_image


def _downsample2(img: np.ndarray) -> np.ndarray:
    """2x box filter (even-cropped — fine for mip purposes)."""
    h, w = img.shape[:2]
    h2, w2 = h - h % 2, w - w % 2
    c = img[:h2, :w2]
    return 0.25 * (c[0::2, 0::2] + c[1::2, 0::2]
                   + c[0::2, 1::2] + c[1::2, 1::2])


def build_atlas(paths: List[str], base_dir: str = ".",
                max_side: int = 4096, mip_levels: int = 1
                ) -> Tuple[np.ndarray, np.ndarray, Dict[str, int],
                           np.ndarray]:
    """Load images and shelf-pack them.

    Returns (atlas [H, W, 3] f32, rects [R, 4] i32 (x, y, w, h),
    slots {path: slot}, mips [S, L] i32). Missing files are skipped
    (their materials keep constant albedo). With no textures, returns a
    4x4 dummy atlas.

    mip_levels > 1 packs a box-filtered pyramid per image into the same
    atlas (the reference has no mipmaps — Texture.cpp loads level 0
    only; this is the port's answer to its absent trilinear path).
    Texture slot ids keep indexing level 0; `mips[s, l]` is the rect row
    of level l (clamped at the deepest level generated), consumed by
    ops/texture.py sample_atlas(lod=...)."""
    L = max(int(mip_levels), 1)
    images = []          # all rects to pack (levels appended at the end)
    slots: Dict[str, int] = {}
    for p in paths:
        full = p if os.path.isabs(p) else os.path.join(base_dir, p)
        if not os.path.exists(full):
            continue
        try:
            img = load_image(full)
        except NotImplementedError:
            # A format PIL reads and the port does not yet (old-style JPEG
            # TIFF, HTJ2K, AVIF, ...: ROADMAP.md C6) raises: skipping it
            # would render what the JAX package, which reads it through
            # PIL, does not. Bytes PIL cannot read (LERC, WebP or SGILog
            # TIFFs among them) raise ValueError and are skipped below, as
            # JAX skips them.
            raise
        except Exception:
            continue
        if img.shape[0] > max_side // 2 or img.shape[1] > max_side // 2:
            stride = max(img.shape[0] // (max_side // 2),
                         img.shape[1] // (max_side // 2)) + 1
            img = img[::stride, ::stride]
        slots[p] = len(images)
        images.append(np.ascontiguousarray(img[..., :3], np.float32))

    if not images:
        return (np.zeros((4, 4, 3), np.float32),
                np.asarray([[0, 0, 4, 4]], np.int32), {},
                np.zeros((1, L), np.int32))

    S = len(images)
    mips = np.zeros((S, L), np.int32)
    mips[:, 0] = np.arange(S)
    for s in range(S):
        lv = images[s]
        for level in range(1, L):
            if min(lv.shape[0], lv.shape[1]) >= 2:
                lv = _downsample2(lv)
                mips[s, level] = len(images)
                images.append(np.ascontiguousarray(lv, np.float32))
            else:
                mips[s, level] = mips[s, level - 1]

    # Shelf packing: sort by height, fill rows.
    order = sorted(range(len(images)), key=lambda i: -images[i].shape[0])
    atlas_w = min(max_side,
                  max(int(np.ceil(np.sqrt(sum(i.shape[0] * i.shape[1]
                                              for i in images)))),
                      max(i.shape[1] for i in images)))
    rects = [None] * len(images)
    x = y = shelf_h = 0
    for i in order:
        h, w = images[i].shape[:2]
        if x + w > atlas_w:
            y += shelf_h
            x = shelf_h = 0
        rects[i] = (x, y, w, h)
        x += w
        shelf_h = max(shelf_h, h)
    atlas_h = y + shelf_h

    atlas = np.zeros((atlas_h, atlas_w, 3), np.float32)
    for i, img in enumerate(images):
        rx, ry, w, h = rects[i]
        atlas[ry:ry + h, rx:rx + w] = img
    return atlas, np.asarray(rects, np.int32), slots, mips
