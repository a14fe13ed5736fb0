"""The child order of the port's node expansion (csrc/bvh_walk.cuh
sort_children): a fixed compare-exchange network over the 8 (t_near,
slot) pairs of a node row, read here from the source.

The walk pushes a node's entered children so that they pop in ascending
(t_near, slot) order, misses keyed last (+inf): the order of a stable sort
by t_near, which the plain walk (ops/kernel_traverse.py walk_plain) takes
with torch.argsort(stable=True). The JAX kernel runs the same 19 pairs
(pallas_traverse.py _NET8) on keys alone, which is not stable among equal
keys (ROADMAP.md C2); the port compares (key, slot) lexicographically, so
any sorting network gives the stable order.
"""

import itertools
import os
import re

import numpy as np

from gpupathtracer_tpu.ops.pallas_traverse import _NET8

WALK = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "gpupathtracer_tpu_torch", "csrc", "bvh_walk.cuh")


def network_pairs():
    """The pairs of the array that follows the `child-order network`
    comment of csrc/bvh_walk.cuh."""
    src = open(WALK).read()
    m = re.search(r"// child-order network\s*\n\s*constexpr int kNet\[(\d+)\]"
                  r"\[2\] = \{(.*?)\};", src, re.S)
    assert m, "csrc/bvh_walk.cuh has no marked child-order network"
    pairs = [(int(a), int(b)) for a, b in
             re.findall(r"\{\s*(\d+)\s*,\s*(\d+)\s*\}", m.group(2))]
    assert len(pairs) == int(m.group(1))
    return pairs


def apply(pairs, key, slot):
    """sort_children: compare-exchange (key, slot) pairs lexicographically,
    ascending. Returns the slots in their sorted order."""
    key, slot = list(key), list(slot)
    for a, b in pairs:
        if key[a] > key[b] or (key[a] == key[b] and slot[a] > slot[b]):
            key[a], key[b] = key[b], key[a]
            slot[a], slot[b] = slot[b], slot[a]
    return slot, key


def test_network_sorts_all_zero_one_inputs():
    """The 0-1 principle: a comparator network that sorts all 2^8 inputs
    of zeros and ones sorts every input."""
    pairs = network_pairs()
    assert all(0 <= a < b < 8 for a, b in pairs)
    for bits in itertools.product((0, 1), repeat=8):
        _, key = apply(pairs, bits, range(8))
        assert key == sorted(bits), bits


def test_network_gives_the_stable_sort_by_key():
    """Applied to (key, slot), the network gives np.argsort(kind="stable")
    of the keys: random keys with many ties (a few distinct values, some
    -0.0 beside 0.0) and misses (+inf), as a node's entered children and
    its misses are keyed."""
    pairs = network_pairs()
    rng = np.random.RandomState(0)
    values = np.float32([-1.5, -0.0, 0.0, 0.25, 0.25, 3.0, np.inf])
    for _ in range(5000):
        key = values[rng.randint(0, len(values), 8)]
        key[rng.rand(8) < 0.3] = np.inf
        slots, _ = apply(pairs, key.tolist(), range(8))
        assert slots == np.argsort(key, kind="stable").tolist(), key


def test_network_is_the_jax_kernels():
    """The port keeps its own copy of the JAX kernel's 19 pairs."""
    assert network_pairs() == [tuple(p) for p in _NET8]
