"""The port's multi-device rendering (parallel/mesh.py, the partitioned
frame of parallel/partition.py, the Renderer's scaling modes and their
checkpoints, the CLI under torchrun) in gloo ranks on the CPU, against the
JAX package and against the port's own single-process calls.

Each rank's shard is held to the JAX package's ``render_sample`` of that
shard with the key folded as the JAX ``shard_map`` folds it (the samples
index, then the pixels index + 1311, or the chips index + 7177 under the
partition), as the JAX package's tests/test_sharding.py builds its
reference. The bound is tests/test_torch_shadow_rev_sort.py's for the
port's wavefront against the jitted JAX one, and for the same reason (the
shading's last-place differences): every lane within rtol 1e-3 and atol
1e-6, the means within 1e-5 relative, the ray counts equal. Against the
port's own calls (the megakernel's sample axis, the Renderer's frames, a
checkpoint resumed) the results are bitwise, and so is the partitioned
frame against the port's whole-table render (a lane could differ only
where two triangles give a ray bitwise the same t: these films have none).

With compaction on, the partitioned frame switches to a narrower
wavefront once the largest live count over the ranks fits it, and a
phase's random numbers depend on its width: JAX's ``render_sample`` of a
shard, whose phases follow that shard's own count, is no reference there
(JAX's partitioned render is, but takes minutes in interpret mode). That
frame is held bitwise to the port's whole-table render over the same
collective loop conditions (``partition_group`` without ``partition``),
which the compaction-free frames tie to JAX.
"""

import json
import os
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from gpupathtracer_tpu.config import CameraConfig as JaxCameraConfig
from gpupathtracer_tpu.config import RenderConfig as JaxRenderConfig
from gpupathtracer_tpu.math import camera as jcam
from gpupathtracer_tpu.models.wavefront import render_sample as jax_render
from gpupathtracer_tpu.scene import load_scene as jax_load_scene
from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.config import RenderConfig
from gpupathtracer_tpu_torch.math import camera as tcam
from gpupathtracer_tpu_torch.models.wavefront import render_sample_impl
from gpupathtracer_tpu_torch.ops.megakernel import (pack_mega_tables,
                                                    render_sample_mega)
from gpupathtracer_tpu_torch.parallel.launch import run_ranks
from gpupathtracer_tpu_torch.scene import load_scene
from gpupathtracer_tpu_torch.utils.morton import ray_order

import torch_dist_ranks as ranks

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
W = H = 16
N = W * H
SEED = 4
STATIC = dict(width=W, height=H, max_bounces=4)
MEGA = dict(width=W, height=H, max_bounces=4, packet_size=128)
MESHES = [(1, 4), (2, 2), (4,)]
DEADLINE = 240


@pytest.fixture(scope="module")
def cornell():
    jscene, jmeta = jax_load_scene(JaxRenderConfig(
        scene_path="proc:cornell", skybox="GENERATE COLOR BLACK"))
    tscene, tmeta = load_scene(RenderConfig(
        scene_path="proc:cornell", skybox="GENERATE COLOR BLACK"), "cpu")
    jc = jcam.generate_image_plane(JaxCameraConfig(**ranks.CORNELL_CAMERA))
    cam = {k: np.asarray(v) for k, v in jc._asdict().items()}
    px = (np.arange(N) % W).astype(np.float32)
    py = (np.arange(N) // W).astype(np.float32)
    return dict(jax=(jscene, jmeta, jc), port=(tscene, tmeta,
                                               tcam.camera_from_numpy(cam,
                                                                      "cpu")),
                cam=cam, px=px, py=py)


@pytest.fixture(scope="module")
def suite(cornell, tmp_path_factory):
    """Every 4-rank run in one set of ranks; the 3-rank Renderer with a
    pixels axis that leaves sentinel rays."""
    tmp = tmp_path_factory.mktemp("sharding")
    cfgs = {
        "mesh": (ranks.cornell_config(mesh_shape=(2, 2)).to_json(), 2,
                 str(tmp / "mesh.ckpt")),
        "partition ring": (ranks.cornell_config(
            partition_chips=4).to_json(), 1, None),
        "partition routed": (ranks.cornell_config(
            partition_chips=4, partition_routing="routed").to_json(), 1,
            None),
        "partition samples": (ranks.cornell_config(
            partition_chips=2, partition_samples=2).to_json(), 2,
            str(tmp / "part.ckpt")),
    }
    four = run_ranks(ranks.sharding_suite, 4, "gloo", "cpu", args=(
        cornell["cam"], cornell["px"], cornell["py"], SEED, STATIC, MEGA,
        cfgs), timeout_s=DEADLINE)
    three = run_ranks(ranks.renderer_frames, 3, "gloo", "cpu", args=(
        ranks.cornell_config(mesh_shape=(3,)).to_json(), 1),
        timeout_s=DEADLINE)
    return dict(four=four, three=three, tmp=tmp)


def _jax_shard(cornell, sl, key, **kw):
    jscene, jmeta, jc = cornell["jax"]
    c, rays = jax_render(jscene, jc, jnp.asarray(cornell["px"][sl]),
                         jnp.asarray(cornell["py"][sl]), key,
                         stack_depth=jmeta.stack_depth,
                         leaf_size=jmeta.leaf_size, **STATIC, **kw)
    return np.asarray(c), int(rays)


def _hold(got, want):
    assert want.max() > 0
    np.testing.assert_allclose(got, want, rtol=1e-3, atol=1e-6)
    np.testing.assert_allclose(got.mean(), want.mean(), rtol=1e-5)


@pytest.mark.parametrize("shape", MESHES, ids=str)
def test_sharded_wavefront_matches_jax_per_shard(cornell, suite, shape):
    """render_sample_sharded: each rank's pixel shard, summed over the
    samples axis, against JAX render_sample of the shard with its folded
    keys and sample indices; the mesh's rays the JAX calls' sum."""
    sizes = dict(zip(("samples", "pixels")[-len(shape):], shape))
    S, P = sizes.get("samples", 1), sizes.get("pixels", 1)
    base = jax.random.PRNGKey(SEED)
    total_rays = 0
    for p in range(P):
        sl = slice(p * N // P, (p + 1) * N // P)
        want = 0.0
        for s in range(S):
            key, kw = base, {}
            if "samples" in sizes:
                key = jax.random.fold_in(key, s)
                kw = dict(sample_idx=3 + s)
            key = jax.random.fold_in(key, p + 1311)
            c, r = _jax_shard(cornell, sl, key, **kw)
            want = want + c
            total_rays += r
        for rank_out in suite["four"]:
            got, rays, coords = rank_out[shape]
            if coords.get("pixels", 0) == p:
                _hold(got, want)
    for rank_out in suite["four"]:
        assert rank_out[shape][1] == total_rays


def _whole_table(cornell, sl, key):
    tscene, tmeta, tc = cornell["port"]
    c, _ = render_sample_impl(tscene, tc, torch.from_numpy(cornell["px"][sl]),
                              torch.from_numpy(cornell["py"][sl]), key,
                              stack_depth=tmeta.stack_depth,
                              leaf_size=tmeta.leaf_size, compaction=False,
                              **STATIC)
    return c.numpy()


def test_partitioned_frame_matches_jax_and_whole_table(cornell, suite):
    """render_sample_partitioned at D = 4, compaction off: each rank's
    shard against JAX render_sample with fold_in(key, c + 7177), and
    bitwise the port's whole-table render with that key; the ring bitwise
    the routed trace and bitwise itself run again; the ranks' scene keeps
    one row of the tree."""
    D = 4
    base = jax.random.PRNGKey(SEED)
    total_rays, ties = 0, 0
    for c in range(D):
        sl = slice(c * N // D, (c + 1) * N // D)
        want, r = _jax_shard(cornell, sl, jax.random.fold_in(base, c + 7177),
                             compaction=False)
        total_rays += r
        got = suite["four"][c]["ring"][0]
        _hold(got, want)
        port = _whole_table(cornell, sl, random.fold_in(
            random.PRNGKey(SEED), c + 7177))
        ties += int((got != port).any(axis=1).sum())
        for other in ("routed", "ring again"):
            np.testing.assert_array_equal(suite["four"][c][other][0], got)
    assert ties == 0
    for out in suite["four"]:
        assert out["ring"][1] == out["routed"][1] == total_rays
        assert out["stripped rows"] == 1 and out["table rows"] > 1


def test_partitioned_frame_compaction(suite):
    """render_sample_partitioned at D = 4 with compaction on and phases
    of 64, 32 and 16 lanes: the ring bitwise the routed trace and the
    whole-table render over the same loop conditions, every rank through
    the same phases, and a narrower phase among them."""
    phases = suite["four"][0]["compacted ring"][2]
    assert len(phases) > 1 and [w for w, _ in phases] == [64, 32, 16][
        :len(phases)]
    assert phases[1][1] > 1
    for out in suite["four"]:
        ring, rays, ring_phases = out["compacted ring"]
        routed = out["compacted routed"]
        whole, whole_phases = out["compacted whole table"]
        assert ring_phases == routed[2] == whole_phases == phases
        assert ring.max() > 0 and rays == routed[1]
        np.testing.assert_array_equal(routed[0], ring)
        np.testing.assert_array_equal(whole, ring)


def test_partitioned_samples_axis_matches_jax_per_shard(cornell, suite):
    """render_sample_partitioned on a ("samples", "chips") mesh of 2 x 2:
    each rank's shard, summed over the samples axis, against JAX
    render_sample of the shard with fold_in(fold_in(key, s), c + 7177) and
    sample index 3 + s; the rays the JAX calls' sum."""
    base = jax.random.PRNGKey(SEED)
    total_rays = 0
    for c in range(2):
        sl = slice(c * N // 2, (c + 1) * N // 2)
        want = 0.0
        for s in range(2):
            key = jax.random.fold_in(jax.random.fold_in(base, s), c + 7177)
            got, r = _jax_shard(cornell, sl, key, sample_idx=3 + s,
                                compaction=False)
            want = want + got
            total_rays += r
        for out in suite["four"]:
            got, _, coords = out["samples x chips"]
            if coords["chips"] == c:
                _hold(got, want)
    for out in suite["four"]:
        assert out["samples x chips"][1] == total_rays


def test_mega_sample_axis_bitwise(cornell, suite):
    """render_sample_mega_sharded on (2, 2), 2 samples a rank: bitwise the
    sum of the single-process megakernel calls with fold_in(key, s) and
    sample index 5 + 2 s; the rays their sum (the max over "pixels" of
    equal counts)."""
    tscene, tmeta, tc = cornell["port"]
    key = random.PRNGKey(SEED)
    want, rays = 0.0, 0
    for s in range(2):
        c, r = render_sample_mega(
            tscene, pack_mega_tables(tscene), tc,
            torch.from_numpy(cornell["px"]), torch.from_numpy(cornell["py"]),
            random.fold_in(key, s), sample_idx=5 + 2 * s, spp=2,
            stack_depth=tmeta.stack_depth, leaf_size=tmeta.leaf_size,
            n_mats=tmeta.num_materials,
            n_lights=int(tscene.light_rows.shape[0]), **MEGA)
        want = want + c.numpy()
        rays += int(r)
    for out in suite["four"]:
        got, r, _ = out["mega"]
        np.testing.assert_array_equal(got, want)
        assert r == rays
    assert want.max() > 0


def _expected_frames(cornell, renderer_cfg, frames, S, P, n_rays,
                     fold=1311):
    """The accumulator a mesh Renderer must hold after ``frames`` frames,
    from the port's single-process render_sample_impl: frame key
    fold_in(seed key, samples so far), folded by the samples index and
    the pixels index + ``fold`` (+ 7177: the chips index of a partition);
    sentinel rays render pixel (0, 0)."""
    tscene, tmeta, _ = cornell["port"]
    tc = tcam.generate_image_plane(renderer_cfg.camera, "cpu")
    fwd = ray_order(W, H, renderer_cfg.pixel_order)
    fwd = np.concatenate([fwd, np.full(n_rays - N, N, fwd.dtype)])
    px = torch.from_numpy(np.where(fwd < N, fwd % W, 0).astype(np.float32))
    py = torch.from_numpy(np.where(fwd < N, fwd // W, 0).astype(np.float32))
    accum = torch.zeros((n_rays, 3))
    base = random.PRNGKey(renderer_cfg.seed)
    for f in range(frames):
        key = random.fold_in(base, f * S)
        frame = torch.zeros((n_rays, 3))
        for p in range(P):
            sl = slice(p * n_rays // P, (p + 1) * n_rays // P)
            acc = None
            for s in range(S):
                k = random.fold_in(key, s) if S > 1 else key
                k = random.fold_in(k, p + fold)
                c, _ = render_sample_impl(
                    tscene, tc, px[sl], py[sl], k, sample_idx=f * S + s,
                    stack_depth=tmeta.stack_depth,
                    leaf_size=tmeta.leaf_size, **STATIC)
                acc = c if acc is None else acc + c
            frame[sl] = acc
        accum = accum + frame
    return accum.numpy(), fwd


def _film(accum, fwd, samples):
    flat = np.zeros((N + 1, 3), np.float32)
    flat[fwd] = accum
    return flat[:N].reshape(H, W, 3) / samples


def test_renderer_mesh_frames_and_checkpoint(cornell, suite):
    """A (2, 2) mesh Renderer: 2 samples a frame, each rank's shard of the
    accumulator bitwise the single-process frames with the folded keys,
    the gathered film on every rank; the checkpoint saved after frame 1 and
    resumed (each rank its shard, the samples a frame from the config)
    gives the uninterrupted accumulator bitwise."""
    cfg = ranks.cornell_config(mesh_shape=(2, 2))
    want, fwd = _expected_frames(cornell, cfg, 2, 2, 2, N)
    film = _film(want, fwd, 4)
    for out in suite["four"]:
        run, resumed = out["mesh"], out["mesh resumed"]
        assert run["spf"] == resumed["spf"] == 2
        assert run["num_samples"] == resumed["num_samples"] == 4
        np.testing.assert_array_equal(run["accum"], want[run["shard"]])
        np.testing.assert_array_equal(run["film"], film)
        np.testing.assert_array_equal(resumed["accum"], run["accum"])
        np.testing.assert_array_equal(resumed["film"], run["film"])
    saved = np.load(suite["tmp"] / "mesh.ckpt")
    assert saved["accum"].shape == (N, 3) and int(saved["num_samples"]) == 2


def test_renderer_sentinel_padding(cornell, suite):
    """A pixels axis of 3 on a 256-pixel film: 2 sentinel rays pad the
    rays to 258; their slot is dropped; every rank holds its 86 rays and
    sees the whole film, bitwise the single-process frame."""
    cfg = ranks.cornell_config(mesh_shape=(3,))
    want, fwd = _expected_frames(cornell, cfg, 1, 1, 3, 258)
    for r, out in enumerate(suite["three"]):
        assert out["n_rays"] == 258 and out["shard"] == slice(86 * r,
                                                               86 * (r + 1))
        np.testing.assert_array_equal(out["accum"], want[out["shard"]])
        np.testing.assert_array_equal(out["film"], _film(want, fwd, 1))
        assert out["present"].shape == (H, W, 3)


def test_renderer_partition(cornell, suite):
    """Partitioned Renderers: the ring's film bitwise the routed trace's on
    every rank; with 2 sample replicas over 2 chips a frame holds 2
    samples, and its checkpoint resumes bitwise; each rank's shard of the
    accumulator bitwise the single-process frames with the keys folded by
    the samples index and the chips index + 7177 (shards of 64 and 128
    lanes, below compaction_min: one phase)."""
    ring_want, _ = _expected_frames(
        cornell, ranks.cornell_config(partition_chips=4), 1, 1, 4, N,
        fold=7177)
    both_want, _ = _expected_frames(
        cornell, ranks.cornell_config(partition_chips=2,
                                      partition_samples=2), 2, 2, 2, N,
        fold=7177)
    for out in suite["four"]:
        ring = out["partition ring"]
        np.testing.assert_array_equal(ring["accum"], ring_want[ring["shard"]])
        both = out["partition samples"]
        np.testing.assert_array_equal(both["accum"], both_want[both["shard"]])
        ring, routed = out["partition ring"], out["partition routed"]
        assert ring["spf"] == 1 and ring["film"].max() > 0
        np.testing.assert_array_equal(ring["film"], routed["film"])
        assert ring["rays"] == routed["rays"] > N
        both, resumed = out["partition samples"], \
            out["partition samples resumed"]
        assert both["spf"] == 2 and both["num_samples"] == 4
        np.testing.assert_array_equal(resumed["accum"], both["accum"])
        assert np.isfinite(both["film"]).all() and both["film"].max() > 0
    np.testing.assert_array_equal(suite["four"][0]["partition ring"]["film"],
                                  suite["four"][3]["partition ring"]["film"])


def test_cli_under_torchrun(tmp_path):
    """python -m torch.distributed.run --standalone --nproc-per-node 2 on the
    CLI with --partition-chips 2: rank 0 writes the PNG and the stats (the
    mesh's rays), the other rank nothing."""
    out, stats = tmp_path / "p.png", tmp_path / "p.json"
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="1")
    proc = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone",
         "--nproc-per-node", "2", "-m", "gpupathtracer_tpu_torch.cli",
         "proc:cornell", "--device", "cpu", "--partition-chips", "2",
         "--spp", "1", "--width", "16", "--height", "16", "--max-bounces",
         "2", "--no-cache", "--out", str(out), "--stats-json", str(stats)],
        capture_output=True, text=True, timeout=DEADLINE, env=env,
        cwd=str(tmp_path))
    assert proc.returncode == 0, proc.stderr[-4000:]
    assert out.read_bytes()[:8] == b"\x89PNG\r\n\x1a\n"
    st = json.loads(stats.read_text())
    assert st["ranks"] == 2 and st["rays"] > N
    assert st["config"]["partition_chips"] == 2
    assert proc.stdout.strip().splitlines() == [str(out)]
