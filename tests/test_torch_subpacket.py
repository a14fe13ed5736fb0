"""The port's sub-packet traversal (ops/subpacket_traverse.py, B6) against
the JAX package's Pallas kernel in interpret mode and against the port's
per-ray walk (B1's plain version).

At K = 128 (one sub-packet per kernel instance) the plain version visits in
the TPU kernel's order: every field and both pop counts are bitwise equal.
At K = 256 the TPU kernel chooses its phase once for both sub-packets while
the port's sub-packets choose for themselves; what that changes is stated
in each test.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.ops.subpacket_traverse import \
    traverse_subpacket as jax_subpacket
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.ops import kernel_traverse as kt
from gpupathtracer_tpu_torch.ops import subpacket_traverse as sp
from gpupathtracer_tpu_torch.scene import load_scene
from test_torch_kernel import _soup_case
from test_torch_tsort import _bits, _box_rays

N = 512


@pytest.fixture(scope="module")
def table():
    """The table scene's rows and 512 rays around it: o, d, far, a random
    occlusion distance, about 15% inactive lanes."""
    scene, meta = load_scene(RenderConfig(scene_path="proc:table"), "cpu")
    cb = scene.cut_bounds.numpy()
    o, d, _, act = _box_rays(cb[:, 0:3].min(0), cb[:, 3:6].max(0), N, seed=8)
    t_occ = np.random.RandomState(1).uniform(0.1, 3.0, N).astype(np.float32)
    return dict(rows=scene.node_rows, o=o, d=d, act=act, t_occ=t_occ,
                far=np.full(N, 1e20, np.float32),
                kw=dict(stack_depth=meta.stack_depth,
                        leaf_size=meta.leaf_size))


def _both(c, t_max, K, **flags):
    """(port plain, JAX interpret) results on the case's rays as [P, K]."""
    P = N // K
    shape = lambda x: x.reshape(P, K, *x.shape[1:])
    args = [shape(x) for x in (c["o"], c["d"], t_max, c["act"])]
    want = jax_subpacket(jnp.asarray(c["rows"].numpy()),
                         *(jnp.asarray(x) for x in args), interpret=True,
                         with_stats=True, **flags, **c["kw"])
    got = sp.traverse_subpacket(c["rows"], *(torch.tensor(x) for x in args),
                                with_stats=True, **flags, **c["kw"])
    return got, [np.asarray(x) for x in want]


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("K", [128, 256])
def test_closest_matches_jax_kernel(table, K, ordered):
    """Table scene: t, prim, u, v bitwise equal in every lane (no tie lane)
    and the (node pops, leaf pops) per packet equal, at K = 256 too: on
    these rays the phase choice changed no count."""
    got, want = _both(table, table["far"], K, ordered=ordered)
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))
    # Inactive lanes untouched.
    off = ~table["act"].reshape(got[1].shape)
    assert (got[1].numpy()[off] == -1).all()
    np.testing.assert_array_equal(got[0].numpy()[off], np.float32(1e20))
    assert (got[1].numpy() >= 0).mean() > 0.5
    # And the per-ray walk's hits.
    base = kt.closest_plain(*(torch.tensor(table[k]) if k != "rows"
                              else table[k]
                              for k in ("rows", "o", "d", "far", "act")),
                            **table["kw"])
    for g, b in zip(got, base):
        np.testing.assert_array_equal(_bits(g.reshape(-1)), _bits(b))


@pytest.mark.parametrize("K", [128, 256])
def test_anyhit_matches_jax_kernel(table, K):
    """Occlusion equal in every lane. K = 128: t, prim, u, v (the nearest
    hit of the leaf that ended the walk) and the pop counts bitwise equal.
    K = 256: a leaf iteration of the TPU kernel runs when both backlogs hold
    a leaf, so a sub-packet may expand another node first and end on
    another leaf: 1 of 72 occluded lanes records another hit, and the
    first packet's leaf pops are 8 against the TPU kernel's 9."""
    got, want = _both(table, table["t_occ"], K, any_hit=True)
    occ = got[1].numpy() >= 0
    np.testing.assert_array_equal(occ, want[1] >= 0)
    assert 0.05 < occ.mean() < 0.95
    assert not occ[~table["act"].reshape(occ.shape)].any()
    base = kt.anyhit_plain(table["rows"], *(torch.tensor(table[k]) for k in
                                            ("o", "d", "t_occ", "act")),
                           **table["kw"])
    np.testing.assert_array_equal(occ.reshape(-1), base.numpy())
    other = int((got[1].numpy() != want[1]).sum())
    pops = np.abs(got[4].numpy().astype(np.int64) - want[4]).sum()
    if K == 128:
        for g, w in zip(got, want):
            np.testing.assert_array_equal(_bits(g), _bits(w))
    else:
        assert other <= 1 and pops <= 1
        same = got[1].numpy() == want[1]
        np.testing.assert_array_equal(_bits(got[0])[same],
                                      _bits(want[0])[same])


def test_soup_leaf10_bounds():
    """Random soup, leaf size 10. K = 128: bitwise. K = 256: prim equal in
    every lane; t, u, v of the JAX kernel itself move by up to 3 ulp (24,
    25, 24 of 168 hits; relative 3.2e-7) against its own K = 128 run,
    because XLA contracts the [2, 128] Moller-Trumbore into other fused
    multiply-adds than the [1, 128] one. The port's rounding does not
    depend on K (it stays B1's); held here: prim equal, 4 ulp."""
    case = _soup_case(11, leaf=10, n_rays=N)
    c = dict(rows=torch.tensor(case["wide"].node_rows), o=case["o"],
             d=case["d"], act=case["act"],
             kw=dict(stack_depth=case["depth"], leaf_size=10))
    got, want = _both(c, case["far"], 128)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    got2, want2 = _both(c, case["far"], 256)
    np.testing.assert_array_equal(got2[1].numpy(), want2[1])
    hit = got2[1].numpy() >= 0
    for g, w, g1 in zip((got2[0], got2[2], got2[3]),
                        (want2[0], want2[2], want2[3]),
                        (got[0], got[2], got[3])):
        ulp = np.abs(_bits(g)[hit].astype(np.int64) - _bits(w)[hit])
        assert ulp.max() <= 4
        np.testing.assert_array_equal(_bits(g).reshape(-1),
                                      _bits(g1).reshape(-1))
    np.testing.assert_array_equal(got2[4].numpy(), want2[4])


def test_wrapper_checks_and_plain_route():
    case = _soup_case(3, leaf=4, n_rays=256)
    rows = torch.tensor(case["wide"].node_rows)
    o, d = (torch.tensor(case[k]).reshape(2, 128, 3) for k in ("o", "d"))
    far, act = (torch.tensor(case[k]).reshape(2, 128) for k in ("far", "act"))
    kw = dict(stack_depth=case["depth"], leaf_size=4)
    with pytest.raises(ValueError):  # K not a multiple of 128
        sp.traverse_subpacket(rows, o.reshape(4, 64, 3), d.reshape(4, 64, 3),
                              far.reshape(4, 64), act.reshape(4, 64), **kw)
    with pytest.raises(ValueError):  # multi-row leaves
        sp.traverse_subpacket(rows, o, d, far, act,
                              stack_depth=case["depth"], leaf_size=11)
    with pytest.raises(ValueError):  # neither a CPU nor a CUDA tensor
        sp.traverse_subpacket(*(x.to("meta") for x in (rows, o, d, far, act)),
                              **kw)
    before = dict(sp.LAUNCHES)
    out = sp.traverse_subpacket(rows, o, d, far, act, **kw)  # CPU: plain
    assert sp.LAUNCHES == before and len(out) == 4
    # A stack too small drops pushes and never writes outside it.
    sp.traverse_subpacket(rows, o, d, far, act, stack_depth=2, leaf_size=4)
