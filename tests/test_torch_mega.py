"""The port's megakernel module (ops/megakernel.py) piece by piece: the
int32 ``randint`` that seeds its packets, its lowbias32 random stream, its
tables and eligibility gate against the JAX package's, the checks of its
wrapper, and the Renderer and CLI switches (all on the CPU, where the
kernel runs its plain torch version)."""

import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.ops import megakernel as jmega
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch import cli
from gpupathtracer_tpu_torch import random as trandom
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.ops import megakernel as mega
from gpupathtracer_tpu_torch.render import Renderer
from gpupathtracer_tpu_torch.scene import load_scene

INT32_MAX = 2**31 - 1


@pytest.mark.parametrize("seed", [0, 5, 123456, INT32_MAX, -1])
@pytest.mark.parametrize("shape", [(1,), (7,), (450,)])
def test_randint_bitwise(seed, shape):
    """jax.random.randint with int32 bounds: the packet seeds of
    megakernel.py:1469 and :1496 (0, int32 max), and other spans, including
    maxval <= minval (always minval) and the whole int32 range."""
    jk = jax.random.fold_in(jax.random.split(jax.random.PRNGKey(seed), 3)[0],
                            9)
    tk = trandom.fold_in(trandom.split(trandom.PRNGKey(seed), 3)[0], 9)
    for lo, hi in ((0, INT32_MAX), (0, 10), (-5, 7), (3, 3), (9, 2),
                   (-2**31, INT32_MAX), (0, 1 << 16)):
        want = np.asarray(jax.random.randint(jk, shape, lo, hi,
                                             dtype=jnp.int32))
        got = trandom.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want, err_msg=f"{lo},{hi}")
    with pytest.raises(ValueError):
        trandom.randint(tk, shape, 0, 2**31)


def _uni_numpy(seed, sample, bounce, slot, lane32):
    """megakernel.py:272-286 transcribed to numpy uint32 (which wraps)."""
    u32 = np.uint32
    s = (seed.astype(u32) + (bounce + 1).astype(u32) * u32(0x9E3779B9)
         + sample.astype(u32) * u32(0xC2B2AE35)
         + u32((slot * 0x85EBCA6B) & 0xFFFFFFFF))
    x = lane32.astype(u32) ^ s
    x = x ^ (x >> u32(16))
    x = x * u32(0x7FEB352D)
    x = x ^ (x >> u32(15))
    x = x * u32(0x846CA68B)
    x = x ^ (x >> u32(16))
    return (x >> u32(8)).astype(np.int32).astype(np.float32) \
        * np.float32(1.0 / 16777216.0)


def test_uni_hash_bitwise():
    """Seeds up to 2**31 - 1, samples -1 (a lane before its first sample)
    to 130, bounces 0 to 66, every slot, lanes 0 to 2047: bitwise."""
    rng = np.random.RandomState(0)
    seeds = np.array([0, 1, 2**31 - 2, 2**31 - 1, 977_000_123], np.int32)
    samples = np.array([-1, 0, 1, 2, 63, 64, 127, 128, 129, 130], np.int32)
    bounces = np.array([0, 1, 2, 7, 33, 64, 65, 66], np.int32)
    lanes = np.concatenate([[0, 1, 127, 128, 2046, 2047],
                            rng.randint(0, 2048, 58)]).astype(np.int32)
    grid = np.meshgrid(seeds, samples, bounces, lanes, indexing="ij")
    seed, sample, bounce, lane = (g.reshape(-1) for g in grid)
    mask = 0xFFFFFFFF
    with np.errstate(over="ignore"):
        for slot in range(20):
            want = _uni_numpy(seed, sample, bounce, slot, lane)
            got = mega.uni(torch.from_numpy(seed).long() & mask,
                           torch.from_numpy(sample).long(),
                           torch.from_numpy(bounce).long(), slot,
                           torch.from_numpy(lane).long())
            assert got.dtype == torch.float32
            assert got.numpy().tobytes() == want.tobytes(), slot
            assert (want >= 0).all() and (want < 1).all()


@pytest.mark.parametrize("name", ["cornell", "table", "bathroom"])
def test_tables_and_gate_match_jax(name):
    kw = dict(scene_path=f"proc:{name}", skybox="GENERATE COLOR BLACK")
    jscene, jmeta = jax_load_scene(JaxRenderConfig(**kw))
    scene, meta = load_scene(RenderConfig(**kw), "cpu")
    want = [np.asarray(x) for x in jmega.pack_mega_tables(jscene)]
    got = [x.numpy() for x in mega.pack_mega_tables(scene)]
    # The JAX rows are padded to 128 lanes for VMEM; the values are the
    # first 16 columns.
    want[0], want[1] = want[0][:, :16], want[1][:, :16]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and g.tobytes() == w.tobytes()
    flags = dict(textured=False, delta=meta.has_delta, sun=False)
    assert mega.mega_eligible(scene, meta, **flags)
    assert jmega.mega_eligible(jscene, jmeta, **flags)
    for flag in ("textured", "delta", "sun"):
        off = dict(flags, **{flag: True})
        assert not mega.mega_eligible(scene, meta, **off)
        assert not jmega.mega_eligible(jscene, jmeta, **off)
    assert not mega.mega_eligible(scene, meta, **flags, sampler="ld")


def _cornell_cfg(**kw):
    cfg = RenderConfig(scene_path="proc:cornell", skybox="GENERATE COLOR BLACK",
                       width=16, height=16, max_bounces=4, **kw)
    cfg.camera = CameraConfig(position=(2.75, 2.75, -7.0), yaw=math.pi,
                              fov=math.radians(45), aspect=1.0)
    return cfg


def test_trace_mega_checks_its_inputs():
    cfg = _cornell_cfg()
    scene, meta = load_scene(cfg, "cpu")
    tables = mega.pack_mega_tables(scene)
    n = 256
    o = torch.zeros((n, 3))
    d = torch.zeros((n, 3))
    d[:, 2] = 1.0
    act = torch.ones(n, dtype=torch.bool)
    seeds = torch.zeros(1, dtype=torch.int32)
    kw = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size,
              max_bounces=2, nee=True, model="trowbridge_reitz",
              n_mats=meta.num_materials,
              n_lights=int(scene.light_rows.shape[0]), packet_size=256)
    args = (scene.node_rows, *tables)
    before = dict(mega.LAUNCHES)
    c, rays = mega.trace_mega(*args, o, d, act, seeds, **kw)
    assert c.shape == (n, 3) and int(rays) >= n
    assert mega.LAUNCHES == before  # CPU: the plain version, not counted
    bad = [dict(packet_size=100), dict(model="phong"),
           dict(stack_depth=10_000), dict(n_mats=99)]
    for change in bad:
        with pytest.raises(ValueError):
            mega.trace_mega(*args, o, d, act, seeds, **{**kw, **change})
    with pytest.raises(ValueError):
        mega.trace_mega(*args, o.double(), d, act, seeds, **kw)
    with pytest.raises(ValueError):  # regeneration needs pxn, pyn
        mega.trace_mega(*args, o, d, act, seeds, **{**kw, "spp": 4})
    with pytest.raises(ValueError):  # neither CPU nor CUDA: no plain path
        mega.trace_mega(*(x.to("meta") for x in args), o.to("meta"),
                        d.to("meta"), act.to("meta"), seeds.to("meta"), **kw)
    with pytest.raises(NotImplementedError):
        mega.trace_mega(*args, o, d, act, seeds, with_stats=True, **kw)
    # Cluster leaves run (tests/test_torch_cluster_mega.py holds their
    # lanes to the JAX package's); a table that is not [Ncl*8, 3*tc] is
    # refused.
    cscene, cmeta = load_scene(_cornell_cfg(cluster_tris=128), "cpu")
    c, rays = mega.trace_mega(
        cscene.node_rows, *mega.pack_mega_tables(cscene), o, d, act, seeds,
        cluster_rows=cscene.cluster_rows,
        **dict(kw, stack_depth=cmeta.stack_depth))
    assert c.shape == (n, 3) and int(rays) >= n
    # The same hits as the MT-leaf table; the normal comes from the C row.
    np.testing.assert_allclose(
        c.numpy(), mega.trace_mega(*args, o, d, act, seeds, **kw)[0].numpy(),
        rtol=1e-5, atol=1e-6)
    with pytest.raises(ValueError):
        mega.trace_mega(*args, o, d, act, seeds, cluster_rows=scene.node_rows,
                        **kw)


def test_renderer_switch(tmp_path):
    """megakernel='on' takes eligible scenes; mega_fused_nee (a schedule of
    the TPU kernel) renders the same film; 'auto' and an ineligible scene
    (an .hdr sky of more than one colour) take the wavefront integrator."""
    films = []
    for fused in (False, True):
        r = Renderer(_cornell_cfg(megakernel="on", mega_fused_nee=fused,
                                  frame_batch=2), "cpu")
        assert r.use_mega
        r.render_frame()
        r.render_frame("direct")
        assert r.num_samples == 4
        films.append(r.film_hdr())
    assert np.isfinite(films[0]).all() and films[0].mean() > 0
    assert films[0].tobytes() == films[1].tobytes()
    assert not Renderer(_cornell_cfg(megakernel="auto"), "cpu").use_mega
    sky = tmp_path / "sky.hdr"
    rgbe = np.random.RandomState(2).randint(100, 200, (2, 4, 4))
    rgbe[..., 3] = 128
    sky.write_bytes(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n-Y 2 +X 4\n"
                    + rgbe.astype(np.uint8).tobytes())
    cfg = _cornell_cfg(megakernel="on")
    cfg.skybox = str(sky)
    r = Renderer(cfg, "cpu")
    assert not r.use_mega
    r.render_frame()
    assert np.isfinite(r.film_hdr()).all()


def test_renderer_chunk_arguments_and_packets():
    """prepare_mega with Renderer.chunk_key and Renderer.mega_statics gives
    the lanes render_frame accumulates, and the first packet run alone
    gives the same lanes as in the whole launch (bitwise)."""
    r = Renderer(_cornell_cfg(megakernel="on", frame_batch=2,
                              pallas_packet_size=128), "cpu")
    assert r.use_mega and r.chunk == 256
    args, kw = mega.prepare_mega(
        r.scene, r.mega_tables, r.camera, r.pixel_x, r.pixel_y,
        r.chunk_key(0), sample_idx=0, spp=2, **r.mega_statics("wavefront"))
    full, _ = mega.trace_mega(*args, **kw)
    r.render_frame()
    assert r.accum.numpy().tobytes() == full.numpy().tobytes()
    rows, mats, lights, cdf, params, o, d, act, seeds = args
    assert o is None and seeds.shape == (2,)
    first, rays = mega.trace_mega(
        rows, mats, lights, cdf, params, None, None, act[:128], seeds[:1],
        **dict(kw, pxn=kw["pxn"][:128], pyn=kw["pyn"][:128]))
    assert first.numpy().tobytes() == full[:128].numpy().tobytes()
    assert int(rays) > 128


def test_cli_megakernel_writes_png(tmp_path):
    out = tmp_path / "mega.png"
    hdr = tmp_path / "mega.npy"
    rc = cli.main(["proc:cornell", "--device", "cpu", "--megakernel", "on",
                   "--frame-batch", "4", "--mega-fused-nee", "--spp", "1",
                   "--width", "24", "--height", "16", "--out", str(out),
                   "--hdr-out", str(hdr)])
    assert rc == 0
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    film = np.load(hdr)
    assert film.shape == (16, 24, 3)
    assert np.isfinite(film).all() and film.max() > 0
