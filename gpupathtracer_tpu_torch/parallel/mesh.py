"""Multi-device rendering over a mesh of ranks (counterpart of the JAX
package's parallel/mesh.py).

One process renders on one device; ``torch.distributed`` joins them. The
JAX package's ``Mesh`` becomes ``Mesh`` below: the shape, the axis names,
this rank's index on each axis and a process group for each axis (the
ranks that differ on that axis alone). The code that JAX runs in every
device of a ``shard_map`` runs here in every rank:

  - the scene is replicated on every rank;
  - the pixel space is sharded over the axis "pixels" (rank p holds the
    p-th contiguous slice of the Morton-ordered rays);
  - the sample space is sharded over the axis "samples" (each rank renders
    its own threefry stream of the same pixels);
  - radiance is summed over "samples"; the ray counter over the whole
    mesh.

One sharded frame therefore accumulates ``samples`` spp. The ranks of a
mesh are the default group's, laid out row-major: rank r sits at samples
index r // P and pixels index r % P for a (S, P) mesh. A 1-D shape is a
"pixels" axis, as in the JAX package.
"""

from __future__ import annotations

from typing import Dict, NamedTuple, Sequence, Tuple

import numpy as np
import torch.distributed as dist

from gpupathtracer_tpu_torch import random
from gpupathtracer_tpu_torch.parallel import comm

AXES = ("samples", "pixels")


class Mesh(NamedTuple):
    shape: Tuple[int, ...]
    axis_names: Tuple[str, ...]
    coords: Dict[str, int]      # this rank's index on each axis
    groups: Dict[str, object]   # the process group of each axis

    def size(self, axis: str) -> int:
        return self.shape[self.axis_names.index(axis)] \
            if axis in self.axis_names else 1


def make_device_mesh(shape: Sequence[int], axis_names=None) -> Mesh:
    """A mesh of ``shape`` over the ranks of the default group, whose size
    must be prod(shape); axes ("samples", "pixels")[-len(shape):] unless
    named. Every rank must call it (it creates every axis group, in the
    same order on every rank)."""
    shape = tuple(int(s) for s in shape)
    names = tuple(axis_names or AXES[-len(shape):])
    if len(names) != len(shape) or not 1 <= len(shape) <= 2:
        raise ValueError(f"mesh shape {shape} with axes {names}: one or two "
                         f"axes, one name each")
    n = int(np.prod(shape))
    if not dist.is_initialized():
        raise RuntimeError(
            f"mesh {shape} needs {n} ranks: multi-device rendering runs one "
            f"process a device (torchrun, or parallel/launch.py run_ranks) "
            f"with torch.distributed initialised")
    world = dist.get_world_size()
    if world != n:
        raise ValueError(f"mesh shape {shape} needs {n} ranks, the group "
                         f"has {world}")
    rank = dist.get_rank()
    grid = np.arange(n).reshape(shape)
    idx = np.unravel_index(rank, shape)
    coords = {a: int(i) for a, i in zip(names, idx)}
    groups = {}
    if len(shape) == 1:
        groups[names[0]] = dist.group.WORLD
    else:
        for a, axis in enumerate(names):
            # The groups along ``axis``: one for each index on the other.
            lines = np.moveaxis(grid, a, -1).reshape(-1, shape[a])
            for line in lines:
                g = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[axis] = g
    return Mesh(shape, names, coords, groups)


def pixel_shard(mesh: Mesh, n: int, axis: str = "pixels") -> slice:
    """This rank's slice of n ray-ordered pixels on ``axis`` (all of them
    when the mesh has no such axis)."""
    size = mesh.size(axis)
    if n % size:
        raise ValueError(f"{n} rays do not divide over the {size}-rank "
                         f"{axis} axis")
    p = mesh.coords.get(axis, 0)
    return slice(p * n // size, (p + 1) * n // size)


def render_sample_sharded(mesh: Mesh, scene, cam, pixel_x, pixel_y, key,
                          sample_base: int = 0, **static):
    """One multi-device frame on this rank.

    pixel_x / pixel_y are the full ray-ordered arrays [N]; N must divide by
    the "pixels" axis. The samples rank s renders sample sample_base + s
    with key fold_in(key, s); the pixels rank p folds p + 1311 into that.
    Returns (this rank's [N / P, 3] radiance summed over "samples", rays
    traced over the mesh). Callers count the frame as ``samples`` spp."""
    from gpupathtracer_tpu_torch.models.wavefront import render_sample_impl

    sl = pixel_shard(mesh, pixel_x.shape[0])
    sidx = sample_base
    if "samples" in mesh.axis_names:
        s = mesh.coords["samples"]
        key = random.fold_in(key, s)
        sidx = sample_base + s
    if "pixels" in mesh.axis_names:
        key = random.fold_in(key, mesh.coords["pixels"] + 1311)
    contribution, rays = render_sample_impl(scene, cam, pixel_x[sl],
                                            pixel_y[sl], key,
                                            sample_idx=sidx, **static)
    if "samples" in mesh.axis_names:
        contribution = comm.psum(contribution, mesh.groups["samples"])
        rays = comm.psum(rays, mesh.groups["samples"])
    if "pixels" in mesh.axis_names:
        rays = comm.psum(rays, mesh.groups["pixels"])
    return contribution, rays


def render_sample_mega_sharded(mesh: Mesh, scene, mega_tables, cam, pixel_x,
                               pixel_y, key, spp_per_chip: int = 1,
                               sample_base: int = 0, **static):
    """The megakernel (B2) sharded over the "samples" axis: every rank
    renders every pixel, spp_per_chip samples in one launch, from
    fold_in(key, s) and sample index sample_base + s * spp_per_chip; the
    radiance and rays are summed over "samples". As in the JAX package, the
    rays then take the maximum over "pixels" (its ranks render the same
    pixels). Returns ([N, 3] radiance of samples * spp_per_chip samples,
    rays)."""
    from gpupathtracer_tpu_torch.ops.megakernel import render_sample_mega

    sidx = sample_base
    if "samples" in mesh.axis_names:
        s = mesh.coords["samples"]
        key = random.fold_in(key, s)
        sidx = sample_base + s * spp_per_chip
    contribution, rays = render_sample_mega(
        scene, mega_tables, cam, pixel_x, pixel_y, key, sample_idx=sidx,
        spp=spp_per_chip, **static)
    if "samples" in mesh.axis_names:
        contribution = comm.psum(contribution, mesh.groups["samples"])
        rays = comm.psum(rays, mesh.groups["samples"])
    if "pixels" in mesh.axis_names:
        rays = comm.pmax(rays, mesh.groups["pixels"])
    return contribution, rays
