"""The interleave (B7) and multi-pop (B8) schedules of the port's per-ray
walk (ops/kernel_traverse.py ``interleave=W`` / ``multi_pop=Q``) against
the plain schedule (B1) and against the JAX package's ``_kernel_ilv`` /
``_kernel_multi`` in interpret mode.

Both are schedules of one walk: every field of every lane is held bitwise
to B1's plain version (no tie lane occurred under multi-pop's other visit
order), and to the Pallas kernels as tests/test_torch_traverse.py holds
B1: t, prim, u, v bitwise, occlusion equal.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.ops.pallas_traverse import traverse_pallas
from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
from test_torch_kernel import _port, _rows, _soup_case
from test_torch_tsort import _bits

SCHEDULES = [dict(interleave=2), dict(interleave=4), dict(multi_pop=2),
             dict(multi_pop=4)]


@pytest.fixture(scope="module")
def case():
    return _soup_case(11, leaf=10, n_rays=512)


def _ids(s):
    return "-".join(f"{k}{v}" for k, v in s.items())


@pytest.mark.parametrize("n", [512, 509])
@pytest.mark.parametrize("schedule", SCHEDULES, ids=_ids)
def test_schedule_equals_plain_walk(case, schedule, n):
    """Closest and any-hit, 10% inactive lanes, an even and an odd N (the
    interleave's last thread then carries fewer rays)."""
    rows = _rows(case)
    kw = dict(stack_depth=case["depth"], leaf_size=10)
    for t_max, fn in ((case["far"], kt.closest), (case["t_occ"], kt.anyhit)):
        rays = [x[:n].contiguous() for x in _port(case, t_max)]
        base = fn(rows, *rays, **kw)
        got = fn(rows, *rays, **kw, **schedule)
        if fn is kt.anyhit:
            base, got = (base,), (got,)
            assert 0.05 < base[0].float().mean() < 0.95
        for g, b in zip(got, base):
            assert g.shape == (n,)
            np.testing.assert_array_equal(_bits(g), _bits(b))


def _pallas(case, t_max, depth=None, **kw):
    P = 512 // 128
    shaped = [jnp.asarray(case["o"]).reshape(P, 128, 3),
              jnp.asarray(case["d"]).reshape(P, 128, 3),
              jnp.asarray(t_max).reshape(P, 128),
              jnp.asarray(case["act"]).reshape(P, 128)]
    out = traverse_pallas(jnp.asarray(case["wide"].node_rows), *shaped,
                          stack_depth=depth or case["depth"], leaf_size=10,
                          interpret=True, **kw)
    return [np.asarray(x) for x in out]


@pytest.mark.parametrize("schedule", SCHEDULES, ids=_ids)
def test_schedule_matches_pallas_kernel(case, schedule):
    """_kernel_ilv (W = 2, 4) and _kernel_multi (Q = 2, 4): t, prim, u, v
    bitwise equal in all 512 lanes; the TPU kernel's overflow column and
    the port's latch both read 0 at a stack of stack_depth * Q."""
    stats = "multi_pop" in schedule
    want = _pallas(case, case["far"], with_stats=stats, **schedule)
    got = kt.closest(_rows(case), *_port(case, case["far"]),
                     stack_depth=case["depth"], leaf_size=10,
                     with_stats=stats, **schedule)
    for g, w in zip(got[:4], want[:4]):
        np.testing.assert_array_equal(_bits(g), _bits(w.reshape(-1)))
    if stats:
        # The overflow lane: the TPU kernel's per packet, the port's per ray.
        assert want[4].shape[1] == 3 and int(want[4][:, 2].sum()) == 0
        assert got[4].dtype == torch.int32 and got[4].shape == (512, 3)
        assert int(got[4][:, 2].sum()) == 0


@pytest.mark.parametrize("schedule", SCHEDULES[0:1] + SCHEDULES[2:], ids=_ids)
def test_schedule_anyhit_matches_pallas_kernel(case, schedule):
    want = _pallas(case, case["t_occ"], any_hit=True, ordered=False,
                   **schedule)
    occ = kt.anyhit(_rows(case), *_port(case, case["t_occ"]),
                    stack_depth=case["depth"], leaf_size=10, **schedule)
    np.testing.assert_array_equal(occ.numpy(), want[1].reshape(-1) >= 0)


@pytest.mark.parametrize("depth", [8, 192])
@pytest.mark.parametrize("w", [2, 4])
def test_interleave_depths_and_pop_counts(case, w, depth):
    """B7 at stack depth 8 (the tree needs 16: pushes are dropped at the
    top of a ray's stack, and a hit moves) and 192 (the kernel's largest
    shared stacks), closest and any-hit, on 509 rays (the last thread's
    slots partly empty): every field and the per-ray pop counts bitwise
    the per-ray walk's (B1) at the same depth. At 192, t, prim, u, v on all
    512 rays also bitwise _kernel_ilv's in interpret mode, occlusion equal
    (at 8 the TPU kernel's packet stack overflows by its own rule)."""
    rows = _rows(case)
    kw = dict(stack_depth=depth, leaf_size=10)
    for t_max, fn in ((case["far"], kt.closest), (case["t_occ"], kt.anyhit)):
        rays = [x[:509].contiguous() for x in _port(case, t_max)]
        base = fn(rows, *rays, with_stats=True, **kw)
        got = fn(rows, *rays, with_stats=True, interleave=w, **kw)
        assert got[-1].shape == (509, 2) and int(got[-1].sum()) > 0
        for g, b in zip(got, base):
            np.testing.assert_array_equal(_bits(g), _bits(b))
    if depth == 8:
        deep = kt.closest(rows, *_port(case, case["far"]),
                          stack_depth=case["depth"], leaf_size=10)
        shallow = kt.closest(rows, *_port(case, case["far"]), interleave=w,
                             **kw)
        assert not np.array_equal(_bits(shallow[0]), _bits(deep[0]))
        return
    want = _pallas(case, case["far"], depth, interleave=w)
    got = kt.closest(rows, *_port(case, case["far"]), interleave=w, **kw)
    for g, x in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(x.reshape(-1)))
    want = _pallas(case, case["t_occ"], depth, any_hit=True, ordered=False,
                   interleave=w)
    occ = kt.anyhit(rows, *_port(case, case["t_occ"]), interleave=w, **kw)
    np.testing.assert_array_equal(occ.numpy(), want[1].reshape(-1) >= 0)


def test_overflow_latch_and_stack_bound(case):
    """The latch (the third column of the multi-pop schedule's per-ray
    counters) counts the pushes dropped at the top of the stack: 0 at
    stack_depth * Q, more than 0 with a stack made too small on purpose. A
    Q whose stack exceeds the kernel's raises; it is never clamped."""
    rows = _rows(case)
    rays = _port(case, case["far"])
    out = kt.closest(rows, *rays, stack_depth=case["depth"], leaf_size=10,
                     multi_pop=2, with_stats=True)
    assert int(out[4][:, 2].sum()) == 0
    small = kt.closest(rows, *rays, stack_depth=2, leaf_size=10, multi_pop=2,
                       with_stats=True)
    assert int(small[4][:, 2].sum()) > 0
    occ, latch = kt.anyhit(rows, *_port(case, case["t_occ"]), stack_depth=2,
                           leaf_size=10, multi_pop=2, with_stats=True)
    assert occ.dtype == torch.bool and int(latch[:, 2].sum()) > 0
    assert case["depth"] * 4 <= kt.MAX_STACK < 58 * 4
    for bad in (dict(stack_depth=58, multi_pop=4),        # 232 > 192
                dict(stack_depth=kt.MAX_STACK // 2 + 1, multi_pop=2),
                dict(stack_depth=8, multi_pop=3),         # no such kernel
                dict(stack_depth=8, interleave=3),
                dict(stack_depth=8, interleave=2, multi_pop=2)):
        with pytest.raises(ValueError):
            kt.closest(rows, *rays, leaf_size=10, **bad)
    # The single-pop schedule's counters have no overflow column.
    assert kt.closest(rows, *rays, stack_depth=case["depth"], leaf_size=10,
                      with_stats=True)[4].shape == (512, 2)
