"""The roofline probes of the port (ops/roofline.py, csrc/roofline.cu)
against the JAX package's Pallas probes (tools/roofline.py) run in
interpret mode, as the JAX package runs its kernels on the CPU.

Inputs are made from a seed with numpy: random origins and unit directions
per lane (the JAX tool's own rays are constant), random rows, blocks and
matrices. Tolerance: bitwise for every probe but the bf16 product, whose
sums the tensor cores and XLA round each their own way: within 1e-6 of
max_i sum_k |a_ik| max |b| * iters (measured on the CPU: 1.9e-6 absolute
at a scale of 60-70, 3e-8 of it). The f32 product is bitwise at depth 3
(widths 128 and 384) and at 128^3: there XLA's CPU dot sums each output
in k order with fused multiply-adds, as the port does. At depth 7, and at
width 32 with depth 128, it sums in another order and is held to the bf16
bound (width 32: measured 1.04e-7 of the scale).

tools/roofline.py enables the JAX compile cache when it is imported; it is
loaded by path here with that cache switched off.
"""

import functools
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from gpupathtracer_tpu_torch.ops import roofline as rl
from test_torch_kernel import (NODE_AROUND, NODE_FLAT, NODE_UNBOUNDED,
                               cluster_tie_blocks, leaf_probe_case,
                               node_probe_case)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
G, ITERS = 2, 4
BF16_BOUND = 1e-6


@pytest.fixture(scope="module")
def jroof():
    """tools/roofline.py as a module, without its compile cache."""
    env = os.environ.get("GPT_TPU_COMPILE_CACHE")
    os.environ["GPT_TPU_COMPILE_CACHE"] = "off"
    try:
        spec = importlib.util.spec_from_file_location(
            "jax_roofline", os.path.join(REPO, "tools", "roofline.py"))
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
    finally:
        if env is None:
            del os.environ["GPT_TPU_COMPILE_CACHE"]
        else:
            os.environ["GPT_TPU_COMPILE_CACHE"] = env
    return mod


def _pallas(kernel, out_shape, *inputs, **kw):
    """A probe kernel under pl.pallas_call in interpret mode."""
    return np.asarray(pl.pallas_call(
        functools.partial(kernel, **kw),
        out_shape=jax.ShapeDtypeStruct(out_shape, jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * len(inputs),
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(*inputs))


def _bits(x):
    return np.ascontiguousarray(x, np.float32).view(np.int32)


@pytest.fixture(scope="module")
def rays():
    """Rows [64, 128] in [0, 1), origins in [-0.5, 1.5), unit directions
    and inv = 1 / d, [3, G, 128]; numpy arrays."""
    rng = np.random.RandomState(9)
    rows = rng.uniform(0, 1, (64, 128)).astype(np.float32)
    o = rng.uniform(-0.5, 1.5, (3, G, 128)).astype(np.float32)
    d = rng.normal(size=(3, G, 128)).astype(np.float32)
    d /= np.linalg.norm(d, axis=0, keepdims=True)
    return rows, o, d, (1.0 / d).astype(np.float32)


@pytest.mark.parametrize("ilp,shape", [(1, (64, 128)), (8, (64, 128)),
                                       (8, (16, 128))])
def test_vpu_probe_matches_jax(jroof, ilp, shape):
    x = np.random.RandomState(3).uniform(0.1, 1.0, shape).astype(np.float32)
    want = _pallas(jroof.vpu_kernel, shape, jnp.asarray(x), iters=ITERS,
                   ilp=ilp)
    got = rl.vpu(torch.from_numpy(x), iters=ITERS, ilp=ilp, copies=2)
    assert got.shape == (2,) + shape
    for c in range(2):
        np.testing.assert_array_equal(_bits(got[c].numpy()), _bits(want))


@pytest.mark.parametrize("m,k,n,dtype", [(128, 128, 128, "f32"),
                                         (384, 3, 128, "f32"),
                                         (64, 7, 40, "f32 depth 7"),
                                         (256, 128, 32, "f32 width 32"),
                                         (64, 3, 384, "f32"),
                                         (64, 16, 8, "bf16"),
                                         (128, 32, 64, "bf16"),
                                         (64, 16, 264, "bf16"),
                                         (128, 64, 512, "bf16")])
def test_mxu_probe_matches_jax(jroof, m, k, n, dtype):
    rng = np.random.RandomState(m + k + n)
    a = rng.uniform(-1, 1, (m, k)).astype(np.float32)
    b = rng.uniform(-1, 1, (k, n)).astype(np.float32)
    a, b = np.ascontiguousarray(a), np.ascontiguousarray(b)
    jdt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    ja, jb = jnp.asarray(a).astype(jdt), jnp.asarray(b).astype(jdt)
    want = np.asarray(pl.pallas_call(
        functools.partial(jroof.mxu_kernel, iters=ITERS,
                          out_dtype=jnp.float32,
                          precision=jax.lax.Precision.HIGHEST),
        out_shape=jax.ShapeDtypeStruct((m, n), jnp.float32),
        in_specs=[pl.BlockSpec(memory_space=pltpu.VMEM)] * 2,
        out_specs=pl.BlockSpec(memory_space=pltpu.VMEM),
        interpret=True)(ja, jb))
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    ta = torch.tensor(np.asarray(ja.astype(jnp.float32))).to(tdt)
    tb = torch.tensor(np.asarray(jb.astype(jnp.float32))).to(tdt)
    got = rl.mxu(ta, tb, iters=ITERS)[0].numpy()
    if dtype == "f32":
        np.testing.assert_array_equal(_bits(got), _bits(want))
    else:
        scale = float(ta.float().abs().sum(1).max() * tb.float().abs().max()
                      * ITERS)
        assert np.abs(got - want).max() <= BF16_BOUND * scale


def test_node_slab_probe_matches_jax(jroof, rays):
    want = _pallas(jroof.node_slab_kernel, (G, 128),
                   *map(jnp.asarray, rays), iters=ITERS, G=G)
    got = rl.node_slab(*map(torch.from_numpy, rays), iters=ITERS, copies=3)
    assert (want != 0).mean() > 0.2  # the rays enter boxes
    for c in range(3):
        np.testing.assert_array_equal(_bits(got[c].numpy()), _bits(want))


def _only(rows, child):
    """rows with every child but ``child`` given NaN bounds (never hit)."""
    out = rows.clone()
    for j in range(8):
        if j != child:
            out[:, j * 6:j * 6 + 6] = torch.nan
    return out


@pytest.mark.parametrize("iters", [70, 130])
def test_node_slab_probe_edge_rows_match_jax(jroof, iters):
    """test_torch_kernel.node_probe_case (flat, point and inverted boxes, a
    box unbounded on one axis, a box around every origin; directions with a
    +0 or -0 component, and o * inv NaN where the origin is 0 there too)
    and the stock random rows, at iteration counts that wrap the 64 rows:
    every copy bitwise the JAX probe's."""
    edge = node_probe_case(G, seed=iters)
    stock = (np.random.RandomState(iters).uniform(0, 1, (64, 128))
             .astype(np.float32), *edge[1:])
    for case in (edge, stock):
        want = _pallas(jroof.node_slab_kernel, (G, 128),
                       *map(jnp.asarray, case), iters=iters, G=G)
        got = rl.node_slab(*map(torch.from_numpy, case), iters=iters,
                           copies=2)
        for c in range(2):
            np.testing.assert_array_equal(_bits(got[c].numpy()),
                                          _bits(want))
        lane = np.arange(G * 128).reshape(G, 128)
        nan_lanes = (lane % 8 == 0) | (lane % 8 == 2)
        assert (want[nan_lanes] == 0).all()  # every slab NaN: no hit
        assert (want[lane % 2 == 1] != 0).mean() > 0.2  # rays enter boxes
    # The edges are there (a pop of each row through the plain version).
    rows, o, d, inv = map(torch.from_numpy, edge)
    finite = torch.from_numpy(lane % 2 == 1)

    def one(child):
        return rl.node_slab_plain(_only(rows, child), o, d, inv, iters=64)

    assert (one(NODE_AROUND)[finite] < 0).all()  # rays inside: tmin < 0
    assert (one(NODE_FLAT)[finite] != 0).any()   # tmin = tmax on z
    assert (one(NODE_UNBOUNDED)[finite] != 0).any()
    # A pop's terms summed in another child order round otherwise: the
    # probe's sum is not order-free, so its kernel keeps child order.
    rev = torch.cat([rows[:, (7 - j) * 6:(8 - j) * 6] for j in range(8)]
                    + [rows[:, 48:]], dim=1)
    want = rl.node_slab_plain(rows, o, d, inv, iters=iters)
    other = rl.node_slab_plain(rev, o, d, inv, iters=iters)
    assert not torch.equal(other.view(torch.int32), want.view(torch.int32))


def test_leaf_mt_probe_matches_jax(jroof, rays):
    want = _pallas(functools.partial(jroof.leaf_mt_kernel, leaf_size=10),
                   (G, 128), *map(jnp.asarray, rays), iters=ITERS, G=G)
    got = rl.leaf_mt(*map(torch.from_numpy, rays), iters=ITERS)
    assert (want < 1e19).mean() > 0.1  # the rays hit triangles
    np.testing.assert_array_equal(_bits(got[0].numpy()), _bits(want))


@pytest.mark.parametrize("iters", [70, 130])
def test_leaf_mt_probe_edge_rows_match_jax(jroof, iters):
    """test_torch_kernel.leaf_probe_case (a zeroed triangle, det = 0; a
    duplicated one, equal t; rays parallel to a triangle's plane or
    pointing away from the triangles) at iteration counts that wrap the 64
    rows: every copy bitwise the JAX probe's."""
    case = leaf_probe_case(G)
    want = _pallas(functools.partial(jroof.leaf_mt_kernel, leaf_size=10),
                   (G, 128), *map(jnp.asarray, case), iters=iters, G=G)
    rows, o, d, inv = map(torch.from_numpy, case)
    got = rl.leaf_mt(rows, o, d, inv, iters=iters, copies=2)
    for c in range(2):
        np.testing.assert_array_equal(_bits(got[c].numpy()), _bits(want))
    assert 0.1 < (want < 1e19).mean() < 0.99
    # The edges are there: slot 0 fails everywhere, slot 1 on the parallel
    # lanes, slots 2 and 3 give equal t.
    parallel = (np.arange(G * 128) % 4 == 0)
    for i in range(64):
        assert not rl.leaf_mt_slot(rows[i], 0, o, d)[1].any()
        assert not rl.leaf_mt_slot(rows[i], 1, o, d)[1][parallel].any()
        t2, t3 = (rl.leaf_mt_slot(rows[i], k, o, d)[0] for k in (2, 3))
        np.testing.assert_array_equal(_bits(t2.numpy()), _bits(t3.numpy()))


@pytest.mark.parametrize("split", [2, 4])
def test_leaf_mt_probe_is_order_free(split):
    """The property the leaf probe's kernel leans on: a lane's answer is the
    smallest valid t over every (pop, slot) it tests, whatever the order.
    leaf_mt_plain against the slots split into ``split`` interleaved sets
    (slots q, q + split, ...), each run with its own t_c over the pops in
    reverse, combined by a strict minimum: bitwise, on the edge rows of
    leaf_probe_case at 130 pops."""
    rows, o, d, inv = map(torch.from_numpy, leaf_probe_case(G, seed=3))
    iters = 130
    want = rl.leaf_mt_plain(rows, o, d, inv, iters=iters)
    got = None
    for q in range(split):
        t_c = torch.full((G * 128,), 1e20, dtype=torch.float32)
        for i in reversed(range(iters)):
            for k in range(q, rl.LEAF_SIZE, split):
                t, valid = rl.leaf_mt_slot(rows[i % rl.ROWS], k, o, d)
                t_c = torch.where(valid & (t < t_c), t, t_c)
        got = t_c if got is None else torch.where(t_c < got, t_c, got)
    np.testing.assert_array_equal(_bits(got.reshape(G, 128).numpy()),
                                  _bits(want.numpy()))
    assert 0.1 < (want < 1e19).float().mean() < 0.99


@pytest.mark.parametrize("tc", [128, 256])
@pytest.mark.parametrize("any_hit", [False, True])
def test_cluster_probe_matches_jax(jroof, rays, tc, any_hit):
    blk = np.random.RandomState(tc).uniform(-1, 1, (16, 3 * tc)).astype(
        np.float32)
    _, o, d, inv = rays
    want = _pallas(jroof.cluster_dense_kernel, (G, 128), jnp.asarray(blk),
                   *map(jnp.asarray, (o, d, inv)), iters=ITERS, G=G, tc=tc,
                   precision=jax.lax.Precision.HIGHEST, any_hit=any_hit)
    got = rl.cluster_dense(*map(torch.from_numpy, (blk, o, d, inv)),
                           iters=ITERS, any_hit=any_hit, copies=2)
    assert (want < 1e19).mean() > 0.5
    for c in range(2):
        np.testing.assert_array_equal(_bits(got[c].numpy()), _bits(want))


@pytest.mark.parametrize("tc", [128, 256])
def test_cluster_probe_ties_match_jax(jroof, rays, tc):
    """test_torch_kernel.cluster_tie_blocks: slots j, j + 32, j + 64, ...
    in one plane (equal t), their u, v halving with each copy: the lowest
    slot must win, and the winner shows in t_state (a block without the
    base slots, whose first copies then win, reads otherwise in a quarter
    of the lanes at least)."""
    blk = cluster_tie_blocks(tc)
    _, o, d, inv = rays
    want = _pallas(jroof.cluster_dense_kernel, (G, 128), jnp.asarray(blk),
                   *map(jnp.asarray, (o, d, inv)), iters=ITERS, G=G, tc=tc,
                   precision=jax.lax.Precision.HIGHEST)
    got = rl.cluster_dense(*map(torch.from_numpy, (blk, o, d, inv)),
                           iters=ITERS, copies=2)
    for c in range(2):
        np.testing.assert_array_equal(_bits(got[c].numpy()), _bits(want))
    lost = blk.copy()
    for b in (0, 8):
        lost[b:b + 7, 0:32] = 0
        lost[b:b + 7, tc:tc + 32] = 0
    other = rl.cluster_dense_plain(*map(torch.from_numpy, (lost, o, d, inv)),
                                   iters=ITERS).numpy()
    assert (other != want).mean() > 0.25


def test_probes_check_their_arguments():
    x = torch.zeros((64, 128))
    with pytest.raises(ValueError):
        rl.vpu(x, iters=4, ilp=4)
    with pytest.raises(ValueError):
        rl.vpu(x.double(), iters=4, ilp=8)
    with pytest.raises(ValueError):
        rl.vpu(x, iters=0, ilp=8)
    with pytest.raises(ValueError):  # bf16 needs k % 16 == 0
        rl.mxu(torch.zeros((64, 3), dtype=torch.bfloat16),
               torch.zeros((3, 8), dtype=torch.bfloat16), iters=1)
    with pytest.raises(ValueError):
        rl.mxu(torch.zeros((64, 16)), torch.zeros((8, 8)), iters=1)
    ray = torch.zeros((3, 2, 128))
    with pytest.raises(ValueError):
        rl.node_slab(torch.zeros((32, 128)), ray, ray, ray, iters=1)
    with pytest.raises(ValueError):
        rl.cluster_dense(torch.zeros((16, 300)), ray, ray, ray, iters=1)
    with pytest.raises(ValueError):  # neither CPU nor CUDA
        rl.vpu(x.to("meta"), iters=1, ilp=1)
    assert all(v == 0 for v in rl.LAUNCHES.values())  # the CPU launches none
