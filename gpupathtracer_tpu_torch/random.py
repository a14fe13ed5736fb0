"""Counter-based threefry2x32 random numbers as torch tensor ops.

Counterpart of the ``jax.random`` calls the JAX package makes (``PRNGKey``,
``split``, ``fold_in``, ``uniform``), in JAX's partitionable mode
(``jax_threefry_partitionable=True``, the default of jax 0.9). Derived from
``jax/_src/prng.py`` (``_threefry2x32_lowering``, ``_threefry_split_foldlike``,
``_threefry_fold_in``, ``_threefry_random_bits_partitionable``) and
``jax/_src/random.py`` (``_uniform``): the same keys give bit-identical
draws, so the port reproduces the JAX renderer's sample streams.

A key is a ``[2]`` int64 tensor holding two uint32 words; it is generator
state passed explicitly, never a hidden global. Words are carried in int64
and masked to 32 bits after every add and shift, which keeps every op a
plain integer op on CPU and CUDA alike.
"""

from __future__ import annotations

import math
from typing import Sequence

import torch

_MASK = 0xFFFFFFFF
_ROTATIONS = ((13, 15, 26, 6), (17, 29, 16, 24))


def _threefry2x32(k1, k2, x1, x2):
    """The threefry2x32 hash (20 rounds) of count pairs (x1, x2) under the
    key (k1, k2); every argument holds uint32 values in int64."""
    ks = (k1, k2, k1 ^ k2 ^ 0x1BD11BDA)
    x1 = (x1 + ks[0]) & _MASK
    x2 = (x2 + ks[1]) & _MASK
    for i in range(5):
        for r in _ROTATIONS[i % 2]:
            x1 = (x1 + x2) & _MASK
            x2 = ((x2 << r) | (x2 >> (32 - r))) & _MASK
            x2 = x1 ^ x2
        x1 = (x1 + ks[(i + 1) % 3]) & _MASK
        x2 = (x2 + ks[(i + 2) % 3] + (i + 1)) & _MASK
    return x1, x2


def PRNGKey(seed: int, device="cpu") -> torch.Tensor:
    """``jax.random.PRNGKey(seed)`` with 32-bit seeds (JAX's default mode):
    the key is (0, seed mod 2**32)."""
    return torch.tensor([0, int(seed) & _MASK], dtype=torch.int64,
                        device=device)


def split(key: torch.Tensor, num: int = 2) -> torch.Tensor:
    """``jax.random.split(key, num)`` -> [num, 2] keys."""
    lo = torch.arange(num, dtype=torch.int64, device=key.device)
    b1, b2 = _threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return torch.stack([b1, b2], dim=-1)


def fold_in(key: torch.Tensor, data: int) -> torch.Tensor:
    """``jax.random.fold_in(key, data)`` for a 32-bit integer ``data``."""
    x2 = torch.tensor(int(data) & _MASK, dtype=torch.int64, device=key.device)
    b1, b2 = _threefry2x32(key[0], key[1], torch.zeros_like(x2), x2)
    return torch.stack([b1, b2])


def _random_bits(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """32 random bits per element (``_threefry_random_bits_partitionable``):
    the XOR of the two hash words of the flat element index."""
    n = math.prod(shape)
    if n >= 1 << 32:
        raise ValueError(f"{n} draws exceed the 32-bit counter")
    lo = torch.arange(n, dtype=torch.int64, device=key.device)
    b1, b2 = _threefry2x32(key[0], key[1], torch.zeros_like(lo), lo)
    return (b1 ^ b2).reshape(tuple(shape))


def mul32(a, b):
    """a * b mod 2**32 for uint32 values carried in int64 (tensors or
    ints): the product is split so that no partial product overflows."""
    return (a * (b & 0xFFFF) + (((a * (b >> 16)) & 0xFFFF) << 16)) & _MASK


def uniform(key: torch.Tensor, shape: Sequence[int]) -> torch.Tensor:
    """``jax.random.uniform(key, shape)``: float32 in [0, 1).

    The top 23 random bits become the mantissa of a float in [1, 2)."""
    bits = (_random_bits(key, shape) >> 9) | 0x3F800000
    floats = bits.to(torch.int32).view(torch.float32) - 1.0
    return torch.clamp_min(floats, 0.0)


def randint(key: torch.Tensor, shape: Sequence[int], minval: int,
            maxval: int) -> torch.Tensor:
    """``jax.random.randint(key, shape, minval, maxval, dtype=int32)``:
    int32 in [minval, maxval), bit for bit (``jax/_src/random.py``
    ``_randint``). Two 32-bit draws from the halves of ``split(key)`` are
    folded into the span with uint32 arithmetic; ``maxval <= minval`` gives
    minval. Both bounds are int32 values, as JAX requires without x64."""
    minval, maxval = int(minval), int(maxval)
    for bound in (minval, maxval):
        if not -(1 << 31) <= bound < (1 << 31):
            raise ValueError(f"randint bound {bound} is not an int32")
    k1, k2 = split(key)
    higher, lower = _random_bits(k1, shape), _random_bits(k2, shape)
    span = (maxval - minval) if maxval > minval else 1
    multiplier = (1 << 16) % span
    multiplier = ((multiplier * multiplier) & _MASK) % span
    offset = ((mul32(higher % span, multiplier) + lower % span) & _MASK) % span
    value = (minval + offset) & _MASK
    return (value - ((value >> 31) << 32)).to(torch.int32)
