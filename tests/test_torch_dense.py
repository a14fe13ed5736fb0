"""The port's dense ray x triangle intersection (ops/dense_intersect.py, B5)
against the JAX package's Pallas kernel in interpret mode.

Both dot-product forms are matched bitwise: on XLA:CPU ``use_mxu=True``
(two ``dot_general(HIGHEST)`` with K = 3 and K = 4, the homogeneous column
inside the K = 4 product) rounds as fma(m2, x2, fma(m1, x1, m0 * x0)) + m3,
and ``use_mxu=False`` (the broadcast-multiply chain) as
fma(m2, x2, fma(m0, x0, m1 * x1)) + m3; adding m3 * 1 last is a plain add
either way. t, prim, u, v are bit-identical in every lane of every case
here, so no tolerance and no tie lane is allowed.

One configuration (block 256, tile 512, 512 rays, 1,024 padded triangles)
serves every case: the interpreter is slow on [block, tile] tiles.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.ops import dense_intersect as jd
from gpupathtracer_tpu_torch.ops import dense_intersect as pd
from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
from test_torch_kernel import (DENSE_TIES, _port, _rows, _soup_case,
                               dense_edge_case)
from test_torch_tsort import _bits

SHAPE = dict(block=256, tile=512)


@pytest.fixture(scope="module")
def case():
    """900 random triangles (1,024 padded; triangle 5 degenerate), 512
    rays, 10% of lanes inactive."""
    c = _soup_case(11, leaf=10, n_tris=900, n_rays=512)
    geom = c["geom"].copy()
    geom[5, 6:9] = geom[5, 3:6]  # e2 = e1: zero area
    c["geom"] = geom
    return c


def test_pack_dense_tris_byte_equal(case):
    wdj, woj = jd.pack_dense_tris(case["geom"])
    wd, wo = pd.pack_dense_tris(case["geom"])
    assert isinstance(wd, np.ndarray) and wd.shape == (3, 3 * 1024)
    assert wo.shape == (4, 3 * 1024) and wd.dtype == wo.dtype == np.float32
    assert wd.tobytes() == np.asarray(wdj).tobytes()
    assert wo.tobytes() == np.asarray(woj).tobytes()
    assert not wd[:, 5::1024].any()  # the degenerate triangle: all zero


@pytest.mark.parametrize("use_mxu", [True, False])
@pytest.mark.parametrize("any_hit", [False, True])
def test_dense_matches_jax_kernel_bitwise(case, any_hit, use_mxu):
    wd, wo = pd.pack_dense_tris(case["geom"])
    t_max = case["t_occ"] if any_hit else case["far"]
    want = jd.dense_intersect(
        jnp.asarray(wd), jnp.asarray(wo), jnp.asarray(case["o"]),
        jnp.asarray(case["d"]), jnp.asarray(t_max), jnp.asarray(case["act"]),
        any_hit=any_hit, use_mxu=use_mxu, interpret=True, **SHAPE)
    counts = {}
    got = pd.dense_intersect_plain(
        torch.tensor(wd), torch.tensor(wo), *_port(case, t_max),
        any_hit=any_hit, use_mxu=use_mxu, counts=counts, **SHAPE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    prim = got[1].numpy()
    assert 0.05 < (prim >= 0).mean() < 0.95
    assert (prim[~case["act"]] == -1).all()
    if any_hit:
        # The base of the first tile with a hit, t = 0 there.
        assert set(np.unique(prim)) <= {-1, 0, 512}
        assert (got[0].numpy()[prim >= 0] == 0).all()
        assert 0 < counts["pairs"] < case["act"].sum() * 1024
    else:
        assert counts["pairs"] == case["act"].sum() * 1024
    # early_exit and block only change the kernel's schedule.
    again = pd.dense_intersect(
        torch.tensor(wd), torch.tensor(wo), *_port(case, t_max),
        any_hit=any_hit, use_mxu=use_mxu, block=512, tile=512,
        early_exit=False)
    for g, w in zip(again, got):
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.fixture(scope="module")
def edges():
    return dense_edge_case()


@pytest.mark.parametrize("use_mxu", [True, False])
@pytest.mark.parametrize("any_hit", [False, True])
def test_dense_ties_and_edges_match_jax_kernel_bitwise(edges, any_hit,
                                                       use_mxu):
    """test_torch_kernel.dense_edge_case against the JAX kernel: a triangle
    at two indices in different quarters of one 512-tile (A) and in two
    tiles (B), each ray at them meeting both copies at the same t (the
    lower index wins; any-hit reports the first tile's base), rays whose
    only hit is in the last tile (C), and an any-hit block (rays 0-255)
    with one unoccluded ray among occluded ones."""
    c = edges
    wd, wo = pd.pack_dense_tris(c["geom"])
    assert wd.shape == (3, 3 * 1536)
    t_max = c["t_occ"] if any_hit else c["far"]
    want = jd.dense_intersect(
        jnp.asarray(wd), jnp.asarray(wo), jnp.asarray(c["o"]),
        jnp.asarray(c["d"]), jnp.asarray(t_max), jnp.asarray(c["act"]),
        any_hit=any_hit, use_mxu=use_mxu, interpret=True, **SHAPE)
    got = pd.dense_intersect_plain(
        torch.tensor(wd), torch.tensor(wo), *_port(c, t_max),
        any_hit=any_hit, use_mxu=use_mxu, **SHAPE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    prim = got[1].numpy()
    for k, name in enumerate(DENSE_TIES):
        first = DENSE_TIES[name][0]
        expect = first // 512 * 512 if any_hit else first
        assert (prim[(c["aim"] == k) & c["act"]] == expect).all()
    assert (prim[(c["aim"] < 0) | ~c["act"]] == -1).all()
    assert prim[17] == -1 and (prim[:256] >= 0).sum() == 255


def test_dense_agrees_with_tree_walk(case):
    """The same hit set as Moller-Trumbore in exact arithmetic, other
    rounding: against the per-ray walk on the same triangles (none made
    degenerate) 512 of 512 prims are equal and t is within 2.4e-6 relative;
    held: 99.5% of prims, t to 1e-5."""
    geom = _soup_case(11, leaf=10, n_tris=900, n_rays=512)["geom"]
    wd, wo = (torch.tensor(x) for x in pd.pack_dense_tris(geom))
    t, prim, _, _ = pd.dense_intersect(wd, wo, *_port(case, case["far"]),
                                       **SHAPE)
    base = kt.closest_plain(_rows(case), *_port(case, case["far"]),
                            stack_depth=case["depth"], leaf_size=10)
    same = prim.numpy() == base[1].numpy()
    assert same.mean() > 0.995
    np.testing.assert_allclose(t.numpy()[same], base[0].numpy()[same],
                               rtol=1e-5)


def test_dense_degenerate_and_padding():
    """tests/test_dense.py's case: zero-area triangles and the 512-padding
    never hit (0/0 = NaN fails every comparison); bitwise against the JAX
    kernel."""
    tg = np.zeros((3, 9), np.float32)
    tg[0] = [0, 0, 5, 1, 0, 0, 0, 1, 0]        # valid unit tri at z=5
    tg[1] = [0, 0, 2, 1, 0, 0, 2, 0, 0]        # degenerate (parallel edges)
    tg[2, 0:3] = [0, 0, 1]                      # zero edges
    wd, wo = pd.pack_dense_tris(tg)
    assert wd.shape == (3, 3 * 512)
    o = np.tile([[0.2, 0.2, 0.0]], (256, 1)).astype(np.float32)
    d = np.tile([[0.0, 0.0, 1.0]], (256, 1)).astype(np.float32)
    far = np.full(256, 1e20, np.float32)
    act = np.ones(256, bool)
    got = pd.dense_intersect(torch.tensor(wd), torch.tensor(wo),
                             torch.tensor(o), torch.tensor(d),
                             torch.tensor(far), torch.tensor(act), **SHAPE)
    assert (got[1].numpy() == 0).all()
    np.testing.assert_allclose(got[0].numpy(), 5.0, rtol=1e-5)
    np.testing.assert_allclose(got[2].numpy(), 0.2, rtol=1e-4)
    np.testing.assert_allclose(got[3].numpy(), 0.2, rtol=1e-4)
    want = jd.dense_intersect(*(jnp.asarray(x)
                                for x in (wd, wo, o, d, far, act)),
                              interpret=True, **SHAPE)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


def test_dense_wrapper_checks():
    wd, wo = (torch.tensor(x) for x in pd.pack_dense_tris(
        np.zeros((3, 9), np.float32)))
    o = torch.zeros((256, 3))
    d = torch.ones((256, 3))
    far = torch.full((256,), 1e20)
    act = torch.ones(256, dtype=torch.bool)
    with pytest.raises(ValueError):  # N not a multiple of block
        pd.dense_intersect(wd, wo, o, d, far, act, block=100)
    with pytest.raises(ValueError):  # Tp not a multiple of tile
        pd.dense_intersect(wd, wo, o, d, far, act, block=256, tile=384)
    with pytest.raises(ValueError):
        pd.dense_intersect(wd, wo[:3], o, d, far, act, block=256)
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        pd.dense_intersect(*(x.to("meta") for x in (wd, wo, o, d, far, act)),
                           block=256)
    before = dict(pd.LAUNCHES)
    pd.dense_intersect(wd, wo, o, d, far, act, block=256)  # CPU: plain
    assert pd.LAUNCHES == before
