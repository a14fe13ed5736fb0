"""Small vector-math helpers on [..., 3] tensors (counterpart of the JAX
package's math/vecmath.py; Util.glsl nndot/avdot/luminance roles)."""

from __future__ import annotations

import math

import torch


def sqrt(x):
    """Correctly rounded float32 square root, as XLA and CUDA give it.
    torch's float32 sqrt on the CPU is one ulp off for about 0.7% of
    inputs. The float64 root rounded to float32 is exact where both steps
    round correctly (53 >= 2*24 + 2 bits), as they do on CUDA. On the CPU,
    in about one process of 40 that also runs jax, torch gave roots one
    ulp off there, for inputs whose root lies within 1e-4 ulp of a
    rounding midpoint (ROADMAP.md C1), so on the CPU the root is settled
    exactly (``round_root``)."""
    r = torch.sqrt(x.double()).to(x.dtype)
    return round_root(x, r) if x.device.type == "cpu" else r


def round_root(x, r):
    """The correctly rounded float32 square root of x [..] from an
    estimate r within one ulp of it: r's neighbour where x lies beyond the
    square of the midpoint between them. A midpoint of two float32 values
    has 25 significant bits, so its square, and the comparison with x,
    are exact in float64. NaN, zero and negative x keep r."""
    xd, rd = x.double(), r.double()
    up = torch.nextafter(r, torch.full_like(r, math.inf))
    down = torch.nextafter(r, torch.zeros_like(r))
    hi = (rd + up.double()) * 0.5
    lo = (rd + down.double()) * 0.5
    pos = x > 0.0
    return torch.where(pos & (xd > hi * hi), up,
                       torch.where(pos & (xd < lo * lo), down, r))


def dot(a, b, keepdim: bool = False):
    return torch.sum(a * b, dim=-1, keepdim=keepdim)


def nndot(a, b, keepdim: bool = False):
    """Non-negative dot (Util.glsl `nndot`)."""
    return torch.clamp_min(dot(a, b, keepdim), 0.0)


def avdot(a, b, keepdim: bool = False):
    """Absolute-value dot (Util.glsl `avdot`)."""
    return torch.abs(dot(a, b, keepdim))


def cross(a, b):
    return torch.linalg.cross(a, b, dim=-1)


def length(a, keepdim: bool = False):
    return sqrt(torch.clamp_min(dot(a, a, keepdim), 0.0))


def normalize(a, eps: float = 1e-20):
    return a / torch.clamp_min(length(a, keepdim=True), eps)


def luminance(c):
    """Average luminance (Util.glsl AverageLuminance: the mean of RGB)."""
    return torch.mean(c, dim=-1)


def construct_tbn(n):
    """Orthonormal tangent frame from a normal (Material.glsl:71-76).

    Returns (tangent, bitangent, normal), each [..., 3]; the helper axis is
    +X when |n.y| > 0.99, else +Y.
    """
    use_x = torch.abs(n[..., 1:2]) > 0.99
    ex = torch.tensor([1.0, 0.0, 0.0], dtype=n.dtype, device=n.device)
    ey = torch.tensor([0.0, 1.0, 0.0], dtype=n.dtype, device=n.device)
    helper = torch.where(use_x, ex, ey)
    t = normalize(cross(helper, n))
    b = cross(t, n)
    return t, b, n
