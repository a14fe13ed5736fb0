"""The child order of the port's node expansion (csrc/bvh_walk.cuh
sort_children): a fixed compare-exchange network over the A (t_near, slot)
pairs of an A-wide node row, one network per arity 2-16, read here from
csrc/sort_net.cuh.

The walk pushes a node's entered children so that they pop in ascending
(t_near, slot) order, misses keyed last (+inf): the order of a stable sort
by t_near, which the plain walk (ops/kernel_traverse.py walk_plain) takes
with torch.argsort(stable=True). The JAX kernel runs the same pairs
(pallas_traverse.py _sort_net, the hand-kept _NET8 at 8) on keys alone,
which is not stable among equal keys (ROADMAP.md C2); the port compares
(key, slot) lexicographically, so any sorting network gives the stable
order. _sort_net is written for powers of two; the 0-1 principle shows
that it sorts every arity from 2 to 16.
"""

import itertools
import os
import re

import numpy as np
import pytest

from gpupathtracer_tpu.ops.pallas_traverse import _NET8, _sort_net

NETS = os.path.join(os.path.dirname(os.path.dirname(__file__)),
                    "gpupathtracer_tpu_torch", "csrc", "sort_net.cuh")
ARITIES = range(2, 17)


def network_pairs(arity: int = 8):
    """The pairs of the network that follows the `child-order network,
    arity A` comment of csrc/sort_net.cuh."""
    src = open(NETS).read()
    m = re.search(rf"// child-order network, arity {arity}\n"
                  rf"#define GPT_CHILD_NET_SIZE (\d+)\n"
                  rf"#define GPT_CHILD_NET \\\n(.*?)\n#(?:elif|endif)",
                  src, re.S)
    assert m, f"csrc/sort_net.cuh has no marked network for arity {arity}"
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


@pytest.mark.parametrize("arity", ARITIES)
def test_network_sorts_all_zero_one_inputs(arity):
    """The 0-1 principle: a comparator network that sorts all 2^A inputs
    of zeros and ones sorts every input."""
    pairs = network_pairs(arity)
    assert all(0 <= a < b < arity for a, b in pairs)
    for bits in itertools.product((0, 1), repeat=arity):
        _, key = apply(pairs, bits, range(arity))
        assert key == sorted(bits), bits


@pytest.mark.parametrize("arity", ARITIES)
def test_network_gives_the_stable_sort_by_key(arity):
    """Applied to (key, slot), the network gives np.argsort(kind="stable")
    of the keys: random keys with many ties (a few distinct values, some
    -0.0 beside 0.0) and misses (+inf), as a node's entered children and
    its misses are keyed: 5000 cases at 8 (seed 0), 2000 at the other
    arities."""
    pairs = network_pairs(arity)
    rng = np.random.RandomState(0 if arity == 8 else arity)
    values = np.float32([-1.5, -0.0, 0.0, 0.25, 0.25, 3.0, np.inf])
    for _ in range(5000 if arity == 8 else 2000):
        key = values[rng.randint(0, len(values), arity)]
        key[rng.rand(arity) < 0.3] = np.inf
        slots, _ = apply(pairs, key.tolist(), range(arity))
        assert slots == np.argsort(key, kind="stable").tolist(), key


@pytest.mark.parametrize("arity", ARITIES)
def test_network_is_the_jax_kernels(arity):
    """The port keeps its own copy of the JAX kernel's pairs at every
    arity: _NET8's 19 at 8, Batcher's (63 at 16) elsewhere."""
    assert network_pairs(arity) == [tuple(p) for p in _sort_net(arity)]
    if arity == 8:
        assert network_pairs(8) == [tuple(p) for p in _NET8]
