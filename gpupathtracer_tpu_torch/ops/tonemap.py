"""Present pass: accumulation -> tonemapped LDR image (counterpart of the
JAX package's ops/tonemap.py; reference: src/shaders/Present.frag:13-37).

Divide by the sample count, multiply by the exposure, Uncharted2 filmic
curve (internal exposure 2.0, white point 11.2), then gamma 1/2.2.
"""

from __future__ import annotations

import torch


def tonemap_uncharted2(color):
    a, b, c, d, e, f = 0.15, 0.50, 0.10, 0.20, 0.02, 0.30
    w = 11.2
    color = color * 2.0

    def curve(x):
        return ((x * (a * x + c * b) + d * e) / (x * (a * x + b) + d * f)) - e / f

    white = curve(w)
    return curve(color) / white


def present(accum, num_samples: int, exposure: float = 1.68,
            tonemap: str = "uncharted2"):
    """accum [H, W, 3] radiance sum over num_samples -> [H, W, 3] in [0, 1]."""
    color = accum / max(num_samples, 1)
    if tonemap == "uncharted2":
        color = tonemap_uncharted2(exposure * color)
    return torch.clamp(color, 0.0, 1.0) ** (1.0 / 2.2)
