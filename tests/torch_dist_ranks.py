"""Rank functions of the port's multi-device tests (tests/test_torch_
partition_trace.py, tests/test_torch_sharding.py), run in fresh processes
by gpupathtracer_tpu_torch/parallel/launch.py ``run_ranks``.

This module imports neither jax nor the JAX package (the ranks refuse
both): the tests pass what the JAX side computed in as numpy arrays and
hold what comes back. Every function takes the rank's device first and
returns host objects.
"""

import math

import torch
import torch.distributed as dist

from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.config import CameraConfig, RenderConfig
from gpupathtracer_tpu_torch.math.camera import camera_from_numpy
from gpupathtracer_tpu_torch.models.wavefront import render_sample_impl
from gpupathtracer_tpu_torch.parallel import comm
from gpupathtracer_tpu_torch.parallel.mesh import (
    make_device_mesh, pixel_shard, render_sample_mega_sharded,
    render_sample_sharded)
from gpupathtracer_tpu_torch.parallel.partition import (
    render_sample_partitioned, shard_partition, strip_scene_bvh,
    trace_closest_partitioned)
from gpupathtracer_tpu_torch.scene import load_scene

CORNELL_CAMERA = dict(position=(2.75, 2.75, -7.0), yaw=math.pi,
                      fov=math.radians(45), aspect=1.0)


def _np(x):
    return x.detach().cpu().numpy()


def comm_primitives(device):
    """Every collective of parallel/comm.py on this rank's tensors: the
    results, for the test to hold against what each must be."""
    me, D = comm.axis_index(), comm.axis_size()
    x = torch.arange(6, dtype=torch.float32, device=device) + 10 * me
    blocks = (torch.arange(D * 3, device=device).reshape(D, 3) + 100 * me)
    flags = torch.tensor([me % 2 == 0, True], device=device)
    shifted = comm.ring_shift((x, flags), None)
    return dict(
        index=me, size=D,
        psum=_np(comm.psum(x)), pmax=_np(comm.pmax(x)),
        psum_int=int(comm.psum(torch.tensor(me + 1, device=device))),
        gather=_np(comm.all_gather(x)),
        a2a=_np(comm.all_to_all(blocks)),
        shift=_np(comm.ring_shift(x)), shift_pair=[_np(t) for t in shifted],
        x_after=_np(x), staged=dict(comm.STAGED), backend=comm.backend())


def hang(device):
    """Each rank waits for a message from the other, which never comes."""
    buf = torch.zeros(1)
    dist.recv(buf, src=1 - dist.get_rank())
    return None


def import_module(device, name):
    """Imports ``name`` in the rank; the modules of jax and the JAX package
    the rank then holds."""
    import importlib
    import sys
    importlib.import_module(name)
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "jaxlib", "gpupathtracer_tpu"))


def fail_on_rank1(device):
    if dist.get_rank() == 1:
        raise RuntimeError("rank 1 says no")
    return None


def partitioned_traces(device, part, runs):
    """trace_closest_partitioned on the partition ``part`` for each
    (rays, keywords) of ``runs``, rays the full (o, d, t_max, active):
    every rank's view of each result (t, prim, u, v, or the occlusion) and
    the gathered counters."""
    table, route = shard_partition(part, None, device)
    out = []
    for rays, kw in runs:
        o, d, t_max, active = (torch.as_tensor(a, device=device)
                               for a in rays)
        res, stats = trace_closest_partitioned(table, route, o, d, t_max,
                                               active, with_stats=True, **kw)
        res = [_np(res)] if kw.get("any_hit") else [_np(f) for f in res]
        out.append((res, _np(stats)))
    return out


def _cornell(device, **kw):
    cfg = RenderConfig(scene_path="proc:cornell",
                       skybox="GENERATE COLOR BLACK", **kw)
    return load_scene(cfg, device)


def sharding_suite(device, cam, px, py, seed, static, mega_static, cfgs):
    """tests/test_torch_sharding.py's runs at 4 ranks, in one group:
    render_sample_sharded on the meshes (1, 4), (2, 2) and (4,); the
    partitioned frame at D = 4, ring, routed and the ring again, and with
    compaction on (ring, routed, and the whole-table frame over the same
    collective loop conditions); a ("samples", "chips") partitioned frame
    of 2 x 2; render_sample_mega_sharded on (2, 2); and a Renderer for
    each config
    of ``cfgs`` (name -> (config JSON, frames, checkpoint path or None)),
    and the resume of each saved checkpoint for one more frame."""
    from gpupathtracer_tpu_torch.bvh.partition import build_partition
    from gpupathtracer_tpu_torch.ops.megakernel import pack_mega_tables
    scene, meta = _cornell(device)
    camera = camera_from_numpy(cam, device)
    px, py = (torch.as_tensor(a, device=device) for a in (px, py))
    key = random.PRNGKey(seed, device)
    depth = dict(stack_depth=meta.stack_depth, leaf_size=meta.leaf_size)
    out = {}
    for shape in ((1, 4), (2, 2), (4,)):
        mesh = make_device_mesh(shape)
        c, rays = render_sample_sharded(mesh, scene, camera, px, py, key,
                                        sample_base=3, **depth, **static)
        out[shape] = (_np(c), int(rays), mesh.coords)

    D = dist.get_world_size()
    mesh = make_device_mesh((D,), ("chips",))
    part = build_partition(scene.node_rows.cpu().numpy(),
                           scene.child_bounds.shape[0], D)
    table, route = shard_partition(part, mesh.groups["chips"], device)
    stripped = strip_scene_bvh(scene)
    for name, routing in (("ring", "ring"), ("routed", "routed"),
                          ("ring again", "ring")):
        c, rays = render_sample_partitioned(
            mesh, table, route, stripped, camera, px, py, key,
            partition_routing=routing, compaction=False, **depth, **static)
        out[name] = (_np(c), int(rays))
    out["stripped rows"] = int(stripped.node_rows.shape[0])
    out["table rows"] = int(table.shape[0])
    # Compaction on, at widths this film reaches: the partitioned frame
    # (ring and routed) and the whole table with the same collective loop
    # conditions, each with the phases it ran.
    sl = pixel_shard(mesh, px.shape[0], "chips")
    narrow = dict(compaction=True, compaction_divs=(2, 4), compaction_min=8)
    for routing in ("ring", "routed"):
        phases = []
        c, rays = render_sample_partitioned(
            mesh, table, route, stripped, camera, px, py, key,
            partition_routing=routing, phases=phases, **narrow, **depth,
            **static)
        out["compacted " + routing] = (_np(c), int(rays), phases)
    phases = []
    c, _ = render_sample_impl(
        scene, camera, px[sl], py[sl],
        random.fold_in(key, mesh.coords["chips"] + 7177),
        partition_group=mesh.groups["chips"], phases=phases, **narrow,
        **depth, **static)
    out["compacted whole table"] = (_np(c), phases)

    # The samples axis over the chips axis: 2 samples of 2 chips' shards.
    mesh = make_device_mesh((2, 2), ("samples", "chips"))
    part = build_partition(scene.node_rows.cpu().numpy(),
                           scene.child_bounds.shape[0], 2)
    table, route = shard_partition(part, mesh.groups["chips"], device)
    c, rays = render_sample_partitioned(
        mesh, table, route, stripped, camera, px, py, key, sample_base=3,
        compaction=False, **depth, **static)
    out["samples x chips"] = (_np(c), int(rays), mesh.coords)

    mesh = make_device_mesh((2, 2))
    c, rays = render_sample_mega_sharded(
        mesh, scene, pack_mega_tables(scene), camera, px, py, key,
        spp_per_chip=2, sample_base=5, n_mats=meta.num_materials,
        n_lights=int(scene.light_rows.shape[0]), **depth, **mega_static)
    out["mega"] = (_np(c), int(rays), mesh.coords)

    for name, (cfg_json, frames, ckpt) in cfgs.items():
        out[name] = renderer_frames(device, cfg_json, frames, ckpt)
        if ckpt:
            out[name + " resumed"] = renderer_frames(device, None,
                                                     frames - 1,
                                                     resume=ckpt)
    return out


def renderer_frames(device, cfg_json, frames, ckpt=None, resume=None):
    """A Renderer of the config on this rank: ``frames`` wavefront frames
    (after resuming ``resume``; saving ``ckpt`` after the first). Returns
    the gathered film, the rank's shard, samples per frame and count, the
    rays and the presented frame."""
    from gpupathtracer_tpu_torch.render import Renderer
    from gpupathtracer_tpu_torch.render.checkpoint import (load_checkpoint,
                                                           save_checkpoint)
    if resume:
        r = load_checkpoint(resume, device)
    else:
        r = Renderer(RenderConfig.from_json(cfg_json), device)
    for f in range(frames):
        r.render_frame()
        if ckpt and f == 0:
            save_checkpoint(r, ckpt)
    r.stats.finalize()
    return dict(film=r.film_hdr(), accum=_np(r.accum), shard=r.shard,
                spf=r.samples_per_frame, num_samples=r.num_samples,
                rays=r.stats.rays_traced, n_rays=r.n_rays,
                present=_np(r.present_device()))


def cornell_config(width=16, height=16, **kw) -> RenderConfig:
    cfg = RenderConfig(scene_path="proc:cornell",
                       skybox="GENERATE COLOR BLACK", width=width,
                       height=height, max_bounces=4, **kw)
    cfg.camera = CameraConfig(**CORNELL_CAMERA)
    return cfg

