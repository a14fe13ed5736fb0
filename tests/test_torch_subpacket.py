"""The port's sub-packet traversal (ops/subpacket_traverse.py, B6) against
the JAX package's Pallas kernel in interpret mode and against the port's
per-ray walk (B1's plain version).

The plain version chooses the node or the leaf phase once a packet of
G = K / 128 sub-packets, by the TPU kernel's rule, so it visits in the TPU
kernel's order at every K: on the table scene every field and both pop
counts are bitwise equal at K = 128, 256 and 512. What the JAX kernel
rounds otherwise at larger K (XLA contracts its [G, 128] Moller-Trumbore
into other fused multiply-adds as G grows) is stated where it shows.
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
from test_torch_kernel import _leaf_trig_case, _soup_case
from test_torch_tsort import _bits, _box_rays

LANES = sp.LANES

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
    P = len(c["o"]) // K
    shape = lambda x: x.reshape(P, K, *x.shape[1:])
    args = [shape(x) for x in (c["o"], c["d"], t_max, c["act"])]
    want = jax_subpacket(jnp.asarray(c["rows"].numpy()),
                         *(jnp.asarray(x) for x in args), interpret=True,
                         with_stats=True, **flags, **c["kw"])
    got = sp.traverse_subpacket(c["rows"], *(torch.tensor(x) for x in args),
                                with_stats=True, **flags, **c["kw"])
    return got, [np.asarray(x) for x in want]


@pytest.mark.parametrize("ordered", [True, False])
@pytest.mark.parametrize("K", [128, 256, 512])
def test_closest_matches_jax_kernel(table, K, ordered):
    """Table scene: t, prim, u, v bitwise equal in every lane and the
    (node pops, leaf pops) per packet equal, at every K (the phase chosen
    once a packet, as the TPU kernel chooses it)."""
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


@pytest.mark.parametrize("K", [128, 256, 512])
def test_anyhit_matches_jax_kernel(table, K):
    """Occlusion equal in every lane; t, prim, u, v (the nearest hit of the
    leaf that ended the walk) and the pop counts bitwise equal to the TPU
    kernel's at every K, no lane excepted: which leaf ends a walk depends
    on the visit order, and the packet's phase rule is the TPU kernel's."""
    got, want = _both(table, table["t_occ"], K, any_hit=True)
    occ = got[1].numpy() >= 0
    np.testing.assert_array_equal(occ, want[1] >= 0)
    assert 0.05 < occ.mean() < 0.95
    assert not occ[~table["act"].reshape(occ.shape)].any()
    base = kt.anyhit_plain(table["rows"], *(torch.tensor(table[k]) for k in
                                            ("o", "d", "t_occ", "act")),
                           **table["kw"])
    np.testing.assert_array_equal(occ.reshape(-1), base.numpy())
    for g, w in zip(got, want):
        assert g.shape == w.shape
        np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.parametrize("any_hit", [False, True])
def test_leaf_trig_matches_jax_kernel(any_hit):
    """The LEAF_TRIG branch: a soup at one triangle a leaf, one packet of
    K = 4096 (G = 32) whose first sub-packet's rays are active and each of
    the other 31 sub-packets holds one active ray. The first backlog
    reaches 24 while the others are short (fewer than G leaves in all)
    with nodes left, so the trigger alone chooses the leaf phase, many
    times. prim (which leaf ends an any-hit walk depends on the order)
    and both pop counts bitwise equal to the TPU kernel's. t, u, v: the
    JAX kernel's own rounding moves at this G (up to 3 ulp in 11 of 56
    closest hits), so they are held to it within 4 ulp and, closest,
    bitwise to the JAX kernel's K = 128 run on the same rays."""
    K = 4096
    case = _leaf_trig_case(K)
    act = case["act"]
    c = dict(rows=torch.tensor(case["wide"].node_rows), o=case["o"],
             d=case["d"], act=act,
             kw=dict(stack_depth=case["depth"], leaf_size=1))
    t_max = case["t_occ"] if any_hit else case["far"]
    pops = {}
    sp.traverse_subpacket_plain(
        c["rows"], *(torch.tensor(x).reshape(1, K, *x.shape[1:])
                     for x in (c["o"], c["d"], t_max, act)),
        any_hit=any_hit, pops=pops, **c["kw"])
    assert pops["trig"] > 0
    got, want = _both(c, t_max, K, any_hit=any_hit)
    np.testing.assert_array_equal(got[1].numpy(), want[1])
    np.testing.assert_array_equal(got[4].numpy(), want[4])
    hit = got[1].numpy() >= 0
    assert hit.sum() > 10
    for g, w in zip((got[0], got[2], got[3]), (want[0], want[2], want[3])):
        ulp = np.abs(_bits(g).astype(np.int64) - _bits(w))
        assert ulp[hit].max() <= 4
        np.testing.assert_array_equal(_bits(g)[~hit], _bits(w)[~hit])
    if not any_hit:
        _, want128 = _both(c, t_max, LANES)
        for g, w in zip(got[:4], want128[:4]):
            np.testing.assert_array_equal(_bits(g).reshape(-1),
                                          _bits(w).reshape(-1))


def test_soup_leaf10_bounds():
    """Random soup, leaf size 10. K = 128: bitwise. K = 256: prim and both
    pop counts equal in every lane and packet (the visit order is the TPU
    kernel's). The 4-ulp bound on t, u, v is for the JAX kernel's own
    K-dependent rounding alone: its t, u, v move by up to 3 ulp (24, 25,
    24 of 168 hits; relative 3.2e-7) against its own K = 128 run, because
    XLA contracts the [2, 128] Moller-Trumbore into other fused
    multiply-adds than the [1, 128] one. The port's rounding does not
    depend on K (it stays B1's): its K = 256 run is bitwise its K = 128
    run."""
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
